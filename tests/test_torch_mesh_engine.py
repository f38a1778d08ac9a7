"""CPU parity of the port's sharded fused CG engine: the block kernels' plain
versions D5 and D6 (``parallel/cg_fused_sharded.py``), the engine and its
solve, the engine ladder (``solvers/refine.engine_refined_solve``) and the
facade's engine routes, against the JAX package.

The JAX block calls (``_k1_call``, ``_k2_call``) run in interpret mode on
block (1, 1) of a (2, 2) partition of the 64² Г grid (16-row bands), with
its halos cut from seeded masked fields; each compiles once. They zero the
wrapped lane of their lane rolls, and the JAX engine adds the neighbour
columns' terms at the jit level (``cg_fused_sharded.py:299-345``); the
port's kernels read the neighbour columns as operands. So the JAX side
gets its own fix-up terms here, computed from the same halos, before the
comparison. The port's side of the solves runs once per module in a 4-rank
``gloo`` world (``tests/_torch_mesh_cases.py: world_engine``); the JAX
references are its single-device ``fused_cg_solve`` and
``fused_refined_solve(ff=False)`` on the same 64² problem, and its own
``sharded_fused_cg_solve`` on a (2, 2) mesh of 4 virtual devices.

Tolerances (f32 fields): 64 eps32 · max|ref| for fields, 64 eps32 · the
sum of the terms' magnitudes for the sums (for (A z_k, z_k) that sum is
bounded by (|cd| + 2|cx| + 2|cy|) Σ z_k²), the maxima to 64 eps32 of
their value; the block kernels' side rows, x', r' and z_k of stitched
blocks equal the single-device plain K1 / K2 / K2-pcg bit for bit. Solves:
MSG CG JAX's iteration count exactly, PCG within 1, x within 2e-5 (the
JAX engine tests' tolerance); the cold ladder converged to rel 1e-8 and
the warm one in no more inner iterations.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.core.problem import PoissonProblem as JProblem
from iterative_solvers_tpu.kernels.cg_fused import fused_cg_solve as j_fused_cg_solve
from iterative_solvers_tpu.kernels.stencil_pallas import PallasStencilOperator
from iterative_solvers_tpu.parallel import ShardedPallasStencilOperator as JPallas
from iterative_solvers_tpu.parallel import make_solver_mesh as j_mesh
from iterative_solvers_tpu.parallel.cg_fused_sharded import _k1_call, _k2_call
from iterative_solvers_tpu.parallel.cg_fused_sharded import (
    sharded_fused_cg_solve as j_sharded_fused_cg_solve,
)
from iterative_solvers_tpu.parallel.halo_pallas import _embed_row
from iterative_solvers_tpu.solvers import precond as jprecond
from iterative_solvers_tpu.solvers.cg import CGOptions as JCGOptions
from iterative_solvers_tpu.solvers.multigrid import MultigridPreconditioner as JMG
from iterative_solvers_tpu.solvers.multigrid import PaddedPreconditioner as JPadded
from iterative_solvers_tpu.solvers.refine import fused_refined_solve as j_fused_refined_solve
from iterative_solvers_tpu.solvers.stopping import StopConfig as JStop

from _torch_mesh_cases import ENGINE_FACADE, MESHES, REL8, masked_noise, world_engine
from iterative_solvers_tpu_torch import DirichletSolver, Domain2D, PoissonProblem
from iterative_solvers_tpu_torch.kernels import cg_fused
from iterative_solvers_tpu_torch.kernels.cg_fused import FusedCGEngine, fused_cg_solve
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.parallel import (
    ShardedPallasStencilOperator,
    SolverMesh,
    make_solver_mesh,
    run_world,
)
from iterative_solvers_tpu_torch.parallel import cg_fused_sharded as S
from iterative_solvers_tpu_torch.parallel.mg_sharded import ShardedFusedMultigrid
from iterative_solvers_tpu_torch.solvers.cg import CGOptions
from iterative_solvers_tpu_torch.solvers.refine import (
    _padded_hi_operator,
    engine_refined_solve,
)
from iterative_solvers_tpu_torch.solvers.stopping import StopConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 64 * float(np.finfo(np.float32).eps)
BY = 16
BETA, ALPHA = 0.37, -2e-5


@pytest.fixture(scope="module")
def world():
    """Every rank's results of the module's cases (one world, 4 ranks)."""
    return run_world(world_engine, 4, timeout=300)


@functools.lru_cache(maxsize=None)
def _jax_refs():
    """JAX's single-device fused solves on the 64² problem: MSG CG, PCG
    with the fused V-cycle (one fused level, as the port's mesh hierarchy)
    and with Jacobi, and the f64-outer ladder cold and warm."""
    jd = JDomain2D(nx=64, ny=64)
    prob = JProblem.manufactured(jd)
    pop = PallasStencilOperator.from_domain(jd, interpret=True)
    M = JMG.from_domain(jd, fuse=True, fuse_min_extent=33, interpret=True)
    b, u = prob.rhs_field(jnp.float32), prob.true_solution_field(jnp.float32)
    out = {"msg": j_fused_cg_solve(pop, b, u_true=u),
           "pcg": j_fused_cg_solve(pop, b, u_true=u, options=JCGOptions(
               preconditioner=JPadded(inner=M, padded_op=pop))),
           "jacobi": j_fused_cg_solve(pop, b, u_true=u, options=JCGOptions(
               preconditioner=jprecond.make_preconditioner("jacobi", pop, jd)))}
    Mf = JPadded(inner=M.with_fmg(prob), padded_op=pop)
    for fmg in (False, True):
        out[("ladder", fmg)] = j_fused_refined_solve(pop, Mf, prob.rhs_field(jnp.float64),
                                                     stop=JStop(**REL8), fmg=fmg, ff=False)
    return out


def _close(got, ref, atol_scale=None):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max() if atol_scale is None else atol_scale
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)


# --- D5, D6 on one block against the JAX block calls --------------------------


def _block():
    """Block (1, 1) of a (2, 2) partition of the 64² Г grid and seeded
    masked f32 fields on the padded canvas (d, z_prev, x, r, u)."""
    dom = Domain2D(nx=64, ny=64)
    op = ShardedPallasStencilOperator.from_domain(dom, SolverMesh(("y", "x"), (2, 2), rank=3),
                                                  block_rows=BY)
    interior = op.interior_padded()
    fields = [torch.from_numpy(masked_noise(interior, seed)) for seed in range(5)]
    return op, fields


def _jax_fixups(op, up, left, right, beta):
    """The JAX engine's jit-level terms at the block's edge columns: its
    own edge columns of z_k and its neighbours' (zkL, zkR), each masked by
    its column's interior (``cg_fused_sharded.py:299-306``)."""
    hb, wb = op.block_shape
    r0, c0 = op.origin
    ext = op.block_spec((hb, wb + 2), (r0, c0 - 1)).build_host()
    zk_l = np.where(ext[:, 0], left[0] + beta * left[1], 0.0)
    zk_r = np.where(ext[:, -1], right[0] + beta * right[1], 0.0)
    return ext[:, 1], ext[:, -2], zk_l, zk_r


@pytest.mark.parametrize("pcg,with_u", [(False, False), (False, True), (True, False),
                                        (True, True)])
def test_k1_k2_block_plain_match_jax(pcg, with_u):
    """D5 and D6 (MSG or PCG, with or without u) on block (1, 1) against
    ``_k1_call`` / ``_k2_call``: side rows, (d, z_k), ‖z_k‖∞, x' and z_k
    directly; (A z_k, z_k), r' at the edge lanes, ‖r'‖² and ‖r'‖∞ after
    the JAX engine's edge-column fix-up."""
    op, (d, z, x, r, u) = _block()
    hb, wb = op.block_shape
    r0, c0 = op.origin
    cd, cx, cy = op.coeffs
    if not pcg:  # d is the direction's field: w for PCG, r itself for MSG
        r = d
    beta = torch.tensor(BETA, dtype=torch.float32)
    db, zb, up, dn, left, right = S.halos_from_global(op, d, z)
    side, rz_p, azz_p, zmax_p = S.k1_block_plain(db, zb, beta, up, dn, left, right, op)
    kw = dict(nx=64, ny=64, cd=cd, cx=cx, cy=cy, by=BY, mask_mode="gamma", interpret=True)
    offs = jnp.asarray([r0, c0], jnp.int32)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jside, jdz, jazz, jzmax = _k1_call(
        offs, j(db), _embed_row(j(up[:1]), wb, 7), _embed_row(j(dn[:1]), wb, 0), j(zb),
        _embed_row(j(up[1:]), wb, 7), _embed_row(j(dn[1:]), wb, 0), np.float32(BETA), **kw)
    _close(side.numpy(), np.asarray(jside)[:, :2])
    zk = (db + beta * zb).double().numpy()
    _close(rz_p.sum(), np.asarray(jdz)[:, 0, 0].sum(), np.abs(db.double().numpy() * zk).sum())
    _close(zmax_p.max(), np.asarray(jzmax)[:, 0, 0].max())
    m0, mw, zk_l, zk_r = _jax_fixups(op, up.double().numpy(), left.double().numpy(),
                                     right.double().numpy(), BETA)
    zk_c0, zk_cw = np.where(m0, zk[:, 0], 0.0), np.where(mw, zk[:, -1], 0.0)
    j_azz = np.asarray(jazz)[:, 0, 0].sum(dtype=np.float64) + cx * np.sum(
        zk_l * zk_c0 + zk_r * zk_cw)
    _close(azz_p.sum(), j_azz, (abs(cd) + 2 * abs(cx) + 2 * abs(cy)) * np.sum(zk * zk))

    blk = lambda f: f[r0:r0 + hb, c0:c0 + wb].contiguous()  # noqa: E731
    ub = blk(u) if with_u else None
    scal = torch.tensor([ALPHA, BETA], dtype=torch.float32)
    if pcg:
        outs = S.k2_pcg_block(blk(x), blk(r), zb, db, side, left, right, scal, op, ub)
    else:
        outs = S.k2_block(blk(x), db, zb, side, left, right, scal, op, ub)
    jside8 = jnp.concatenate([j(side), jnp.zeros((hb // BY, 6, wb), jnp.float32)], axis=1)
    jouts = _k2_call(offs, j(blk(x)), j(blk(r) if pcg else db), j(zb), j(db), jside8,
                     j(ub) if with_u else None, np.float32(ALPHA), np.float32(BETA), pcg=pcg,
                     has_u=with_u, **kw)
    jx, jr, jz = (np.asarray(t, np.float64) for t in jouts[:3])
    # the JAX engine's edge strips: a z_k(m, ∓1) term missing at the edge lanes
    jr[:, 0] += np.where(m0, -ALPHA * cx * zk_l, 0.0)
    jr[:, -1] += np.where(mw, -ALPHA * cx * zk_r, 0.0)
    _close(outs[0].numpy(), jx)
    _close(outs[1].numpy(), jr)
    _close(outs[2].numpy(), jz)
    e = np.concatenate([jr[:, :1], jr[:, -1:]], axis=1)
    j_r2 = np.asarray(jouts[3])[:, 0, 0].sum(dtype=np.float64) + np.sum(e * e)
    j_rmax = max(float(np.asarray(jouts[4])[:, 0, 0].max()), float(np.abs(e).max()))
    _close(outs[3].sum(), j_r2)
    _close(outs[4].max(), j_rmax)
    if with_u:
        _close(outs[5].max(), np.asarray(jouts[5])[:, 0, 0].max())


# --- stitched blocks against the single-device plain kernels -----------------


@pytest.mark.parametrize("shape", MESHES)
def test_stitched_blocks_equal_single_device(shape):
    """Every block of a partition, its halos cut from the global fields as
    the engine's exchange delivers them: the stitched side rows, x', r' and
    z_k of D5 + D6 (MSG and PCG, with u) equal the single-device plain K1 +
    K2 / K2-pcg bit for bit, edges included."""
    meshes = [SolverMesh(("y", "x"), shape, rank=k) for k in range(4)]
    dom = Domain2D(nx=64, ny=64)
    ops = [ShardedPallasStencilOperator.from_domain(dom, m, block_rows=BY) for m in meshes]
    hp, wp = ops[0].padded_shape
    lay = PaddedStencilOperator(64, 64, ops[0].coeffs, (65, 65), (hp, wp), BY, "gamma")
    x, r, z, w, u = (torch.from_numpy(masked_noise(lay.mask_spec.build_host(), 10 + k))
                     for k in range(5))
    beta = torch.tensor(BETA, dtype=torch.float32)
    scal = torch.tensor([ALPHA, BETA], dtype=torch.float32)

    def stitch(parts):
        rows = [[p for m, p in zip(meshes, parts) if m.coords[0] == i]
                for i in range(meshes[0].rows)]
        return torch.cat([torch.cat(row, dim=-1) for row in rows], dim=0)

    for pcg in (False, True):
        d = w if pcg else r
        side_ref = cg_fused.k1_plain(d, z, beta, lay)[0]
        ref = (cg_fused.k2_pcg_plain(x, r, z, w, side_ref, scal, lay, u=u) if pcg
               else cg_fused.k2_plain(x, r, z, side_ref, scal, lay, u=u))
        sides, outs = [], []
        for op in ops:
            (hb, wb), (r0, c0) = op.block_shape, op.origin
            db, zb, up, dn, left, right = S.halos_from_global(op, d, z)
            side = S.k1_block(db, zb, beta, up, dn, left, right, op)[0]
            blk = [f[r0:r0 + hb, c0:c0 + wb].contiguous() for f in (x, r, w, u)]
            sides.append(side)
            outs.append(S.k2_pcg_block(blk[0], blk[1], zb, blk[2], side, left, right, scal, op,
                                       blk[3]) if pcg else
                        S.k2_block(blk[0], blk[1], zb, side, left, right, scal, op, blk[3]))
        assert torch.equal(stitch(sides), side_ref)
        for i in range(3):
            assert torch.equal(stitch([o[i] for o in outs]), ref[i])


# --- the engine on a 1x1 mesh against the single-device engine ----------------


@pytest.mark.parametrize("kind", ["msg", "pcg", "ladder"])
def test_engine_on_one_rank_reproduces_single_device(kind):
    """On a 1x1 mesh whose layout is the single-device engine's, the
    sharded engine takes the single-device trajectory exactly: the same
    counts and stop reason, x bit-equal (MSG CG; PCG and the warm f64-outer
    ladder with one shard-fused V-cycle shared by both engines)."""
    dom = Domain2D(nx=64, ny=64)
    prob = PoissonProblem.manufactured(dom)
    op = ShardedPallasStencilOperator.from_domain(dom, make_solver_mesh(1), block_rows=BY)
    lay = PaddedStencilOperator(64, 64, op.coeffs, dom.grid_shape, op.padded_shape, BY, "gamma")
    M = ShardedFusedMultigrid.from_operator(op, dom, fuse_min_extent=33, device="cpu")
    b, u = prob.rhs_field(torch.float32, "cpu"), prob.true_solution_field(torch.float32, "cpu")
    if kind == "ladder":
        Mf = M.with_fmg(prob)
        b64 = op.pad(prob.rhs_field(torch.float64, "cpu"))
        stop = StopConfig(**REL8)
        got = engine_refined_solve(S.ShardedFusedCGEngine(op, Mf),
                                   DirichletSolver._hi_operator(op), b64, stop=stop, fmg=True)
        ref = engine_refined_solve(FusedCGEngine(lay, Mf), _padded_hi_operator(lay), b64,
                                   stop=stop, fmg=True)
        assert got.outer_iterations == ref.outer_iterations
        np.testing.assert_array_equal(got.history, ref.history)
    else:
        opts = CGOptions(preconditioner=M if kind == "pcg" else None)
        got = S.sharded_fused_cg_solve(op, b, u_true=u, options=opts)
        ref = fused_cg_solve(lay, b, u_true=u, options=opts)
    assert (got.reason, got.iterations) == (ref.reason, ref.iterations)
    assert torch.equal(got.x, ref.x)


def test_sharded_fused_cg_solve_rejects_fr():
    op = ShardedPallasStencilOperator.from_domain(Domain2D(nx=16, ny=16), make_solver_mesh(1))
    with pytest.raises(ValueError, match="MSG"):
        S.sharded_fused_cg_solve(op, torch.zeros(17, 17), options=CGOptions(beta_kind="fr"))


# --- the 4-rank world against the JAX package ---------------------------------


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("kind", ["msg", "pcg", "jacobi"])
def test_sharded_fused_cg_solve_matches_jax(world, shape, kind):
    """MSG CG (D5, D6) and PCG (D5, D6-pcg; the shard-fused V-cycle with one
    fused level, or Jacobi, which has no fused dot) over 4 ranks: JAX's
    single-device fused engine's stop reason, its count (PCG within 1) and
    x within 2e-5; every rank agrees."""
    got = world[0][(kind, shape)]
    ref = _jax_refs()[kind]
    assert all(w[(kind, shape)]["iterations"] == got["iterations"] for w in world)
    assert got["converged"] and got["reason"] == int(ref.reason)
    slack = 0 if kind == "msg" else 1
    assert abs(got["iterations"] - ref.iterations) <= slack
    if kind == "pcg":
        assert got["levels"] == 1
    np.testing.assert_allclose(got["x"], np.asarray(ref.x), rtol=0, atol=2e-5)


def test_jax_sharded_engine_agrees(world):
    """JAX's own sharded fused engine on a (2, 2) mesh of 4 virtual devices
    (its kernels in interpret mode): the port's 4-rank MSG CG takes its
    count, and x within 2e-5."""
    jd = JDomain2D(nx=64, ny=64)
    prob = JProblem.manufactured(jd)
    pop = JPallas.from_domain(jd, j_mesh(4, (2, 2), devices=jax.devices()[:4]), block_rows=BY,
                              interpret=True)
    ref = j_sharded_fused_cg_solve(pop, prob.rhs_field(jnp.float32),
                                   u_true=prob.true_solution_field(jnp.float32))
    got = world[0][("msg", (2, 2))]
    assert (got["reason"], got["iterations"]) == (int(ref.reason), ref.iterations)
    np.testing.assert_allclose(got["x"], np.asarray(ref.x), rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_engine_refined_solve_matches_jax(world, shape):
    """The engine ladder over 4 ranks (f64 halo twin outside, D5 + D6-pcg
    and the shard-fused V-cycle inside): cold, converged to rel 1e-8 in
    JAX's outer count and within 1 of its inner count; warm (FMG) the same,
    in no more inner iterations than cold; x within 2e-5."""
    refs = _jax_refs()
    for fmg in (False, True):
        got, ref = world[0][("ladder", shape, fmg)], refs[("ladder", fmg)]
        assert got["converged"] and got["reason"] == int(ref.reason) and got["rel"] < 1e-8
        assert got["outers"] == ref.outer_iterations
        assert abs(got["iterations"] - ref.iterations) <= 1
        np.testing.assert_allclose(got["x"], np.asarray(ref.x), rtol=0, atol=2e-5)
    cold, warm = (world[0][("ladder", shape, f)] for f in (False, True))
    assert warm["iterations"] <= cold["iterations"]


@pytest.mark.parametrize("route", list(ENGINE_FACADE))
def test_facade_engine_routes(world, route):
    """The facade's engine routes on (2, 2): ``fused`` (MSG; PCG with the
    shard-fused V-cycle, which fuses no level at 64²) against JAX's fused
    engine, the engine ladder (``fused`` or ``pallas`` with ``mg`` and
    ``mixed``, no callback; the FMG warm start) against JAX's warm f64
    ladder: stop reason, counts (PCG and ladder inners within 1), the
    solution within 2e-5."""
    got = world[0][("facade", route)]
    mixed = "mixed" in route
    refs = _jax_refs()
    ref = refs[("ladder", True)] if mixed else refs["pcg" if "mg" in route else "msg"]
    assert got["reason"] == int(ref.reason)
    assert got["outers"] == (ref.outer_iterations if mixed else 0)
    assert abs(got["iterations"] - ref.iterations) <= (0 if route == "fused" else 1)
    jd = JDomain2D(nx=64, ny=64)
    x = np.asarray(ref.x)[np.asarray(jd.interior)]  # compacted, row-major interior
    np.testing.assert_allclose(got["solution"], x, rtol=0, atol=2e-5)

"""CPU parity of the port's shard-fused V-cycle (D3, D4), the mesh FMG, the
sharded fast path and the facade's mesh routes against the JAX package
(ROADMAP item 14b).

The port's side runs once per module in one 4-rank ``gloo`` world
(``tests/_torch_mesh_cases.py: world_multigrid``, with its deadline). The
JAX side runs here on 4 virtual CPU devices. A JAX sharded Pallas program
in interpret mode costs 10-40 s of compilation per mesh, shape and route,
so the sharded fast path (which runs JAX's shard-fused V-cycle) is held
against JAX's on the (2, 2) mesh; the V-cycles against the port's
single-device fused V-cycle (bit for bit: the block legs take its
arithmetic at every node) and JAX's V-cycle, to which the JAX package's
own tests hold its shard-fused one; the facade routes against the JAX
facade's counts (see that test). Tolerances:

- V-cycle and FMG fields (f32): 1e-5 of max|z|, as the JAX tests; the fused
  (r, M r) dot to 1e-5 relative.
- The fast path: JAX's stop reason, outer and inner counts and history
  inner column exactly.
- Facade routes: JAX's stop reason and iteration count (the host ladder's
  callbacks at the same inner counts), the solution to 1e-4 (the JAX mesh
  tests' tolerance).
- The plain V-cycle and FMG on blocks (``parallel/mg_blocks.py``): the same
  hierarchy on the gathered field bit for bit, on every rank, in f32 and
  f64; JAX's ``ShardedMultigridPreconditioner`` to 1e-5 of max|z|. JAX's
  programs (f64) run once per domain on the (2, 2) mesh: GSPMD's result
  does not depend on the mesh, and the port's equals the gathered field's
  on every mesh.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iterative_solvers_tpu.api import DirichletSolver as JSolver
from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.core.domain import Domain3D as JDomain3D
from iterative_solvers_tpu.core.problem import PoissonProblem as JProblem
from iterative_solvers_tpu.parallel import ShardedPallasStencilOperator as JPallas
from iterative_solvers_tpu.parallel import crop_field as j_crop
from iterative_solvers_tpu.parallel import make_solver_mesh as j_mesh
from iterative_solvers_tpu.parallel import shard_field as j_shard
from iterative_solvers_tpu.parallel.halo import ShardedStencilOperator as JHalo
from iterative_solvers_tpu.parallel.mg_sharded import ShardedFusedMultigrid as JFusedMG
from iterative_solvers_tpu.solvers.cg import CGOptions as JCGOptions
from iterative_solvers_tpu.solvers.cg import cg_solve as j_cg_solve
from iterative_solvers_tpu.ops.stencil import StencilOperator as JStencil
from iterative_solvers_tpu.solvers.multigrid import MultigridPreconditioner as JMG
from iterative_solvers_tpu.solvers.multigrid import ShardedMultigridPreconditioner as JShardedMG
from iterative_solvers_tpu.solvers.refine import device_refined_solve as j_device_refined_solve
from iterative_solvers_tpu.solvers.stopping import StopConfig as JStop

from _torch_mesh_cases import BLOCK_DOMAINS, BOX, FACADE, MESHES, masked_noise, world_multigrid
from iterative_solvers_tpu_torch.parallel import run_world
from iterative_solvers_tpu_torch.parallel.mg_blocks import MIN_BLOCK_NODES
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL8 = dict(eps_precision=-1.0, eps_residual=-1.0, eps_exact_error=-1.0, eps_relative=1e-8,
            max_iterations=10000)


@pytest.fixture(scope="module")
def world():
    """Every rank's results of the module's cases (one world, 4 ranks)."""
    return run_world(world_multigrid, 4, timeout=300)


@pytest.fixture(scope="module")
def jm():
    return j_mesh(4, (2, 2), devices=jax.devices()[:4])


@functools.lru_cache(maxsize=None)
def _jax_vcycle(kind, n):
    """JAX's V-cycle on the masked noise of an n² domain (compiled once per
    domain, shared by every mesh shape)."""
    jd = JDomain2D(nx=n, ny=n, shape=kind)
    r = masked_noise(np.asarray(jd.interior))
    return r, np.asarray(jax.jit(JMG.from_domain(jd, fuse=False))(jnp.asarray(r)))


def _scaled_close(got, ref, tol=1e-5):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol)


@pytest.mark.parametrize("shape,kind", [(s, k) for s in MESHES for k in ("gamma", "rect")]
                         + [((2, 1, 2), "gamma")])
def test_shard_fused_vcycle(world, jm, shape, kind):
    """One V(1,1) cycle with one shard-fused level (fuse_min_extent 33);
    (2, 1, 2) is the hybrid (slice, y, x) mesh."""
    got = world[0][("vcycle", shape, kind)]
    assert got["levels"] == 1
    r, ref = _jax_vcycle(kind, 64)
    np.testing.assert_array_equal(got["z"], got["single"])  # the single-device fused cycle
    _scaled_close(got["z"], ref)
    # call_with_dot: the same w, and (r, w) fused into the finest K_up
    assert got["w_equal"]
    dot = float(np.sum(r.astype(np.float64) * got["z"]))
    assert abs(got["rz"] - dot) <= 1e-5 * abs(dot)


def _transfer_bound(rows, wb, cwb, cols):
    """Bytes (f32) one lane transfer may receive: the coarse block
    [ci cwb, (ci + 1) cwb) reads fine [2 ci cwb - 1, 2 (ci + 1) cwb], the fine
    block [ci wb, (ci + 1) wb) coarse [ci wb / 2, (ci + 1) wb / 2], so the
    window leaves its own range by at most (cols - 1) |2 cwb - wb| + 2
    columns (|2 cwb - wb| + 2 on two mesh columns)."""
    return 4 * rows * ((cols - 1) * abs(2 * cwb - wb) + 2)


def test_shard_fused_lane_transfers_fetch_only_their_windows(world):
    """Every rank's shard-fused V-cycles (each mesh shape and domain, the
    hybrid mesh, two fused levels at 128², one at 256²), with the mesh's
    collectives recorded: no all-gather runs between fused levels (the
    only ones gather the coarse remainder's threshold field over the whole
    mesh, at most once a cycle), and each lane transfer, two a fused
    level, receives at most Hb/2 x ((cols - 1) |2 cwb - wb| + 2) nodes."""
    cases = [rank[k] for rank in world for k in rank if k[0] == "vcycle"]
    cases += [rank["two_levels"] for rank in world]
    cases += [rank["block_extras"]["fused"] for rank in world]
    moved = 0
    for case in cases:
        rec = case["transfers"]
        bounds = [_transfer_bound(hb // 2, wb, cwb, cols) for hb, wb, cwb, cols in rec["levels"]]
        assert len(rec["fetched"]) == 2 * len(bounds)
        for got, bound in zip(rec["fetched"], bounds + bounds[::-1]):
            assert got <= bound, (rec["levels"], rec["fetched"])
        assert len(rec["all_gathers"]) <= 1, rec
        for world_wide, nodes in rec["all_gathers"]:
            assert world_wide and nodes == math.prod(rec["gathered_shape"]), rec
        moved += sum(rec["fetched"])
    assert moved > 0  # the windows do cross blocks


@pytest.mark.parametrize("shape", MESHES + [(2, 1, 2)])
def test_lane_transfers_on_blocks(world, shape):
    """``lane_restrict_block`` / ``lane_prolong_block`` on every rank's block
    of seeded noise (padding columns too, an odd nx, windows over several
    blocks) equal the slices of the single-device ``lane_restrict`` /
    ``lane_prolong`` on the block row bit for bit, gather nothing and
    receive at most their windows' bound; a rank whose restriction window
    lies wholly past nx receives nothing and gives zeros."""
    padding = moved = 0
    for rank in world:
        for case in rank[("lanes", shape)]:
            assert case["equal"] and case["all_gathers"] == 0, case
            bound = _transfer_bound(case["rows"], case["wb"], case["cwb"], case["cols"])
            assert len(case["fetched"]) == 2 and max(case["fetched"]) <= bound, case
            if case["padding"]:
                assert case["zero"] and case["fetched"][0] == 0, case
            padding += case["padding"]
            moved += sum(case["fetched"])
    assert (padding > 0) == (shape[-1] > 1) and (moved > 0) == (shape[-1] > 1)


def test_shard_fused_vcycle_two_levels_and_symmetry(world):
    got = world[0]["two_levels"]
    assert got["levels"] == 2
    _scaled_close(got["z"], _jax_vcycle("gamma", 128)[1])
    assert abs(got["d1"] - got["d2"]) / abs(got["d1"]) < 1e-5  # PCG-safe


def test_sharded_fmg_stepwise_matches_monolithic(world):
    got = world[0]["fmg"]
    _scaled_close(got["step"], got["mono"])
    jd = JDomain2D(nx=64, ny=64)
    prob = JProblem.manufactured(jd)
    b = prob.rhs_field(jnp.float32)
    fmg = jax.jit(JMG.from_domain(jd, fuse=False).with_fmg(prob).fmg)
    _scaled_close(got["mono"], np.asarray(fmg(b)))
    A = JStencil.from_domain(jd)
    bb = np.asarray(b)
    rel = np.linalg.norm(bb - np.asarray(A(jnp.asarray(got["smooth"])))) / np.linalg.norm(bb)
    assert rel < 5e-3, rel


def test_shard_fused_pcg_iteration_count(world):
    """As the JAX test: within one iteration of the single-device jnp MG-PCG."""
    got = world[0]["fused_pcg"]
    jd = JDomain2D(nx=64, ny=64)
    stop = JStop(eps_precision=-1, eps_residual=1e-4, max_iterations=100)
    ref = j_cg_solve(JStencil.from_domain(jd), JProblem.manufactured(jd).rhs_field(jnp.float32),
                     options=JCGOptions(stop=stop, preconditioner=JMG.from_domain(jd, fuse=False)))
    assert got["converged"] and abs(got["iterations"] - ref.iterations) <= 1
    np.testing.assert_allclose(got["x"], np.asarray(ref.x), atol=2e-5)


def _jax_fast_path(jm, fmg):
    jd = JDomain2D(nx=64, ny=64)
    prob = JProblem.manufactured(jd)
    pop = JPallas.from_domain(jd, jm, block_rows=16)
    M = JFusedMG.from_operator(pop, jd, fuse_min_extent=33)
    A_hi = JHalo(mesh=jm, coeffs=pop.coeffs, grid_shape=pop.grid_shape,
                 padded_shape=pop.padded_shape, mask_kind=pop.mask_mode, dims=(jd.nx, jd.ny))
    return j_device_refined_solve(A_hi, pop, pop.shard(prob.rhs_field(jnp.float64)),
                                  preconditioner=M.with_fmg(prob) if fmg else M,
                                  stop=JStop(**REL8), fmg=fmg), pop


def test_sharded_fast_path_matches_jax(world, jm):
    """``device_refined_solve`` with the f64 halo twin outside and D1 with
    the shard-fused V-cycle and its FMG warm start inside, on (2, 2) at
    64²: JAX's outer and inner counts, stop reason and history rows."""
    got = world[0]["fast_path"]
    ref, pop = _jax_fast_path(jm, True)
    assert (got["reason"], got["converged"], got["outers"], got["iterations"]) == (
        int(ref.reason), bool(ref.converged), ref.outer_iterations, ref.iterations)
    np.testing.assert_array_equal(got["history"][:, 0], np.asarray(ref.history)[:, 0])
    assert got["rel"] < 1e-8
    _scaled_close(got["x"], np.asarray(pop.crop(ref.x)), 1e-7)


def test_sharded_fast_path_cold_start(world):
    """The same ladder from zero (the JAX package's own mesh test): it
    converges to the criterion, in no fewer inner iterations than warm."""
    got, warm = world[0]["fast_path_cold"], world[0]["fast_path"]
    assert got["converged"] and got["reason"] == 5
    assert got["iterations"] >= warm["iterations"]


@pytest.mark.parametrize("route", list(FACADE))
def test_facade_mesh_routes(world, route):
    """Each mesh route of the facade on (2, 2); the mixed ones with a
    callback (the host ladder, which the JAX facade runs on a CPU). Held to
    the JAX facade's counts: JAX's mesh routes take its single-device
    facade's iterations on all eight (measured), and a JAX facade on a mesh
    compiles its sharded programs for 10-25 s a route, so the reference is
    the single-device JAX facade (the mixed ladder's on the stencil, which
    is its only single-device form; ``pallas`` + ``mg`` as the f32 stencil,
    whose jnp V-cycle its mesh route runs below the fuse extent)."""
    got = world[0]["facade"][route]
    kw = dict(FACADE[route])
    mixed = kw.get("precision") == "mixed"
    calls = []
    callback = (lambda *a: calls.append(a[0])) if mixed else None
    s = kw["stop"]
    kw["stop"] = JStop(eps_precision=s.eps_precision, eps_residual=s.eps_residual,
                       max_iterations=s.max_iterations)
    if "domain" in kw:
        kw["domain"] = JDomain3D(nx=16, ny=16, nz=16)
    if mixed:
        kw.pop("operator", None)
    elif route == "pallas_mg":
        kw.update(operator="stencil", dtype=jnp.float32)
    ref = JSolver(**kw).solve(callback=callback)
    assert (got["reason"], got["iterations"], got["calls"]) == (
        int(ref.stop_reason), ref.iterations, calls)
    np.testing.assert_allclose(got["solution"], ref.solution, atol=1e-4)
    if mixed:
        assert got["residual_norm"] < FACADE[route]["stop"].eps_residual


def test_facade_device_ladder(world):
    """precision='mixed' over the mesh without a callback: the device
    ladder (f64 outer through the halo stencil, the gathered V-cycle)."""
    got = world[0]["facade_device_ladder"]
    assert got["reason"] == 2 and got["residual_norm"] < 1e-6


@functools.lru_cache(maxsize=None)
def _jax_blocks(kind):
    """JAX's ShardedMultigridPreconditioner (f64) on the (2, 2) mesh of 4
    virtual CPU devices: the V-cycle of the block cases' noise, the FMG and
    the stepwise FMG of the manufactured RHS, cropped to the grid."""
    jd = JDomain3D(**BOX) if kind == "box" else JDomain2D(**BLOCK_DOMAINS[kind])
    m = j_mesh(4, (2, 2), devices=jax.devices()[:4])
    prob = JProblem.manufactured(jd)
    M = JShardedMG.from_domain(jd, m)
    Mf = JShardedMG(inner=M.inner.with_fmg(prob), grid_shape=M.grid_shape)
    r = j_shard(jnp.asarray(masked_noise(np.asarray(jd.interior)).astype(np.float64)), m)
    b = j_shard(prob.rhs_field(jnp.float64), m)
    return tuple(np.asarray(j_crop(z, jd.grid_shape))
                 for z in (jax.jit(M)(r), jax.jit(Mf.fmg)(b), Mf.fmg_stepwise(b)))


@pytest.mark.parametrize("shape,kind", [(s, k) for s in MESHES for k in BLOCK_DOMAINS])
def test_block_multigrid_matches_gathered_and_jax(world, shape, kind):
    """``ShardedMultigridPreconditioner`` on blocks: its V-cycle, FMG and
    stepwise FMG, f32 and f64, equal the same hierarchy on the gathered
    field bit for bit on every rank, with the fine level on blocks, and
    match JAX's ShardedMultigridPreconditioner."""
    for rank in world:
        rec = rank[("blocks", shape)][kind]
        assert rec["stop"] >= 1
        for dtype in ("torch.float32", "torch.float64"):
            assert rec[dtype]["equal"] == [True, True, True], (rank, dtype)
    rec = world[0][("blocks", shape)][kind]
    for dtype in ("torch.float32", "torch.float64"):
        for got, ref in zip(rec[dtype]["fields"], _jax_blocks(kind)):
            _scaled_close(got, ref)


def test_block_multigrid_gathers_only_the_coarse_field(world):
    """Every field gathered during the block V-cycles and FMGs
    (``SolverMesh.gather`` wrapped in the rank function) is the gathered
    level's: the dense coarsest level, or the first with fewer than
    ``MIN_BLOCK_NODES`` nodes a rank along a split axis; never a level that
    runs on blocks. The shard-fused V-cycle's remainder and FMG likewise;
    the custom-mask and Chebyshev-coarsest hierarchies, and the 3D block
    kernel's layout (a rank of padding only; also with its messages staged
    through host memory), equal the gathered field bit for bit."""
    for shape in MESHES:
        parts = {0: shape[0], -1: shape[1]}
        for kind, rec in world[0][("blocks", shape)].items():
            levels, stop, g = rec["levels"], rec["stop"], rec["gathered_shape"]
            below = any(levels[stop][d] < MIN_BLOCK_NODES * p for d, p in parts.items() if p > 1)
            assert below or (rec["dense"] and stop == len(levels) - 1), (shape, kind)
            assert rec["gathered"] and set(rec["gathered"]) == {g}, (shape, kind)
            for d, p in parts.items():  # level stop's blocks, each padded to the largest
                assert levels[stop][d] <= g[d] < levels[stop][d] + 2 * p, (shape, kind)
            assert math.prod(g) < math.prod(levels[stop - 1]), (shape, kind)
    extras = world[0]["block_extras"]
    for kind in ("custom", "chebyshev"):
        for dtype in ("torch.float32", "torch.float64"):
            assert extras[(kind, dtype)] == [True, True, True], (kind, dtype)
    assert extras["chebyshev"] == (2, 2)  # every level on blocks, Chebyshev steps included
    assert extras["pallas3d"] == dict(equal=True, padding_only=True, staged_equal=True)
    fused = extras["fused"]
    assert fused["levels"] >= 1 and fused["remainder_equal"] and fused["finite"]
    assert fused["gathered"] and set(fused["gathered"]) <= {fused["gathered_shape"],
                                                             fused["fmg_gathered_shape"]}
    assert max(map(math.prod, fused["gathered"])) * 16 < math.prod(fused["fine"])

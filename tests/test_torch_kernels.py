"""CPU parity of the port's kernel modules (plain versions of K1, K2-pcg,
K_down, K_up with the lane transfers folded in, the lane transfers and the
V-cycle) against the JAX package's
Pallas kernels in interpret mode, with state carried across by
``iterative_solvers_tpu_torch.interop``.

Tolerances: both sides compute the same f32 formulas, but the in-kernel sums
run in different orders, so element fields are held to a few f32 ulps of
the field's max (1e-6 · max|ref|) and reductions to 1e-5 relative; V-cycle
outputs chain ~10 f32 sweeps and a coarse solve, so 1e-5 · max|ref|."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.kernels import mg_fused as jmg
from iterative_solvers_tpu.kernels.cg_fused import FusedCGEngine as JEngine
from iterative_solvers_tpu.kernels.stencil_pallas import PallasStencilOperator
from iterative_solvers_tpu.solvers.cg import CGState as JCGState
from iterative_solvers_tpu.solvers.multigrid import (
    MultigridPreconditioner as JMG,
    PaddedPreconditioner as JPadded,
)

from iterative_solvers_tpu_torch import Domain2D
from iterative_solvers_tpu_torch.core.domain import notched_disk
from iterative_solvers_tpu_torch.interop import cg_state_from_arrays, multigrid_from_state
from iterative_solvers_tpu_torch.kernels import cg_fused, mg_fused
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.solvers.multigrid import (
    MultigridPreconditioner,
    PaddedPreconditioner,
    _FusedLevel,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# small ragged shapes: a gamma grid, and a rect grid whose height is not a
# multiple of the block rows; block_rows=16 gives several bands (halo paths).
# The custom case is the notched disk (the JAX package's custom-mask test
# domain at 64²) on 32-row bands, the custom floor, with the int8 mask
# operand; its kernel inputs are pre-masked, the JAX custom kernels' contract.
SHAPES = [("gamma", 64, 64), ("rect", 40, 50), ("custom", 64, 64)]


def _domains(shape, nx, ny):
    fn = notched_disk if shape == "custom" else None
    return (JDomain2D(nx=nx, ny=ny, shape=shape, inside_fn=fn),
            Domain2D(nx=nx, ny=ny, shape=shape, inside_fn=fn))


def _close(got, ref, frac=1e-6):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=frac * max(np.abs(ref).max(), 1e-30))


def _masked_field(rng, pop):
    f = rng.standard_normal(pop.padded_shape).astype(np.float32)
    return f * pop.interior_padded()


def _layouts(shape, nx, ny, by=16):
    jd, pd = _domains(shape, nx, ny)
    pop = PallasStencilOperator.from_domain(jd, block_rows=by, interpret=True)
    lay = PaddedStencilOperator.from_domain(pd, block_rows=by)
    return jd, pop, lay


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape,nx,ny", SHAPES)
def test_k1_plain_matches_pallas(shape, nx, ny):
    jd, pop, lay = _layouts(shape, nx, ny)
    rng = np.random.default_rng(11)
    d, z = _masked_field(rng, pop), _masked_field(rng, pop)
    beta = np.float32(0.37)
    side, rz_p, azz_p, zmax_p = JEngine(pop)._call_k1(jnp.asarray(d), jnp.asarray(z), beta)
    p_side, p_rz, p_azz, p_zmax = cg_fused.k1(_t(d), _t(z), torch.tensor(beta), lay)
    _close(p_side, np.asarray(side)[:, :2])
    for got, ref in ((p_rz, rz_p), (p_azz, azz_p)):
        ref = np.asarray(ref)[:, 0, 0]
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(p_zmax.numpy(), np.asarray(zmax_p)[:, 0, 0])


# the ‖x − u‖∞ variant (a true solution u) adds the "-u" cases
@pytest.mark.parametrize("shape,nx,ny,with_u", [
    pytest.param(*s, False, id="-".join(map(str, s))) for s in SHAPES
] + [pytest.param(*s, True, id="-".join(map(str, s)) + "-u") for s in SHAPES])
def test_k2_pcg_plain_matches_pallas(shape, nx, ny, with_u):
    jd, pop, lay = _layouts(shape, nx, ny)
    rng = np.random.default_rng(12)
    x, r, z, w, u = (_masked_field(rng, pop) for _ in range(5))
    beta, alpha = np.float32(0.21), np.float32(-3.1e-5)
    eng = JEngine(pop)
    side = eng._call_k1(jnp.asarray(w), jnp.asarray(z), beta)[0]
    ju = jnp.asarray(u) if with_u else None
    outs = eng._call_k2_pcg(*(jnp.asarray(a) for a in (x, r, z, w)), side, ju, alpha, beta)
    x_in = _t(x)
    got = cg_fused.k2_pcg(
        x_in, _t(r), _t(z), _t(w), _t(np.asarray(side)[:, :2]), torch.tensor([alpha, beta]), lay,
        u=_t(u) if with_u else None,
    )
    assert len(got) == len(outs) == (6 if with_u else 5)
    for g, ref in zip(got[:3], outs[:3]):
        _close(g, ref)
    np.testing.assert_allclose(
        got[3].sum().item(), float(np.asarray(outs[3])[:, 0, 0].sum()), rtol=1e-5
    )
    for g, ref in zip(got[4:], outs[4:]):  # ‖r‖∞ [and ‖x − u‖∞] partials
        np.testing.assert_allclose(g.numpy(), np.asarray(ref)[:, 0, 0], rtol=1e-6)
    np.testing.assert_array_equal(x_in.numpy(), x)  # inputs untouched


@functools.lru_cache(maxsize=None)
def _jax_mg(shape, nx, ny):
    """The JAX hierarchy, built once per domain: the tests that read it
    share its compiled kernel programs."""
    jd = _domains(shape, nx, ny)[0]
    return jd, JMG.from_domain(jd, fuse=True, fuse_min_extent=16, interpret=True)


def _carry_mg(M):
    """The JAX hierarchy as plain values, through interop (a custom level
    as its interior array, and a fused one with its padded int8 mask)."""
    levels = []
    for lev in M.levels:
        base = getattr(lev, "jnp_level", lev)
        spec = base.mask_spec
        if spec is None:
            d = dict(shape="custom", nx=0, ny=0, interior=np.asarray(base.interior_arr))
        else:
            d = dict(shape=spec.kind, nx=spec.nx, ny=spec.ny)
        d.update(coeffs=base.coeffs, omega_over_diag=base.omega_over_diag)
        if hasattr(lev, "kernels"):
            k = lev.kernels
            d.update(nx=k.nx, ny=k.ny, padded_shape=k.padded_shape, block_rows=k.block_rows)
            if k.mask8 is not None:
                d["mask8"] = np.asarray(k.mask8)
        levels.append(d)
    return multigrid_from_state(
        levels, np.asarray(M.coarse_solve.idx), np.asarray(M.coarse_solve.a_inv), nu=M.nu_pre
    )


@pytest.mark.parametrize("shape,nx,ny", SHAPES)
def test_hierarchy_from_domain_matches_jax(shape, nx, ny):
    # structure and the coarse inverse are built the same way: exact
    _, M = _jax_mg(shape, nx, ny)
    P = MultigridPreconditioner.from_domain(
        _domains(shape, nx, ny)[1], fuse=True, fuse_min_extent=16, device="cpu"
    )
    assert len(P.levels) == len(M.levels)
    for a, b in zip(P.levels, M.levels):
        assert isinstance(a, _FusedLevel) == hasattr(b, "kernels")
        if hasattr(b, "kernels"):
            ka, kb = a.kernels, b.kernels
            assert (ka.padded_shape, ka.block_rows, ka.coeffs, ka.cs) == (
                kb.padded_shape, kb.block_rows, kb.coeffs, kb.cs)
            assert (a.h, a.w, a.ch, a.cw) == (b.h, b.w, b.ch, b.cw)
    np.testing.assert_array_equal(P.coarse_solve.idx, np.asarray(M.coarse_solve.idx))
    np.testing.assert_allclose(P.coarse_solve.a_inv, np.asarray(M.coarse_solve.a_inv),
                               rtol=1e-12)


@pytest.mark.parametrize("shape,nx,ny", SHAPES)
@pytest.mark.parametrize("with_dot", [False, True])
def test_k_down_k_up_plain_match_pallas(shape, nx, ny, with_dot):
    """The legs take and give the coarse field on the child's input layout
    (the lane transfers and the child mask folded in): JAX's K_down and K_up
    composed as its V-cycle composes them, with lane_restrict_mm /
    lane_prolong_mm and the child mask. The banded matmuls sum in another
    order: 1e-6 · max|ref|, as for every element field here."""
    _, M = _jax_mg(shape, nx, ny)
    jlev = M.levels[0]
    jk = jlev.kernels
    pk = _carry_mg(M).levels[0].kernels
    hp, wp = jk.padded_shape
    ch, cw = jlev.ch, jlev.cw
    rng = np.random.default_rng(13)
    b = rng.standard_normal((hp, wp)).astype(np.float32)  # unmasked: the kernels mask b
    if shape == "custom":
        b *= pk.mask_spec.build_host()  # the JAX custom kernels trust b's halo rows
    rc = jmg.lane_restrict_mm(jk.down(jnp.asarray(b))[:ch], nx, cw)
    got = pk.down(_t(b))
    child = M.levels[1]
    assert pk.coarse_shape == (child.kernels.padded_shape if hasattr(child, "kernels")
                               else (ch, cw)) == tuple(got.shape)
    _close(got[:ch, :cw], jnp.where(jlev.child_interior, rc, 0.0))
    assert not got[ch:].any() and not got[:, cw:].any()  # the child's padding
    ec = rng.standard_normal((ch, cw)).astype(np.float32)
    ecl = jnp.pad(jmg.lane_prolong_mm(jnp.asarray(ec), nx // 2, wp), ((0, hp // 2 - ch), (0, 0)))
    ref = jk.up(jnp.asarray(b), ecl, with_dot=with_dot)
    ecp = torch.zeros(pk.coarse_shape)
    ecp[:ch, :cw] = _t(ec)
    got = pk.up(_t(b), ecp, with_dot=with_dot)
    if with_dot:
        (ref, ref_dot), (got, got_dot) = ref, got
        np.testing.assert_allclose(got_dot.item(), float(ref_dot), rtol=1e-5)
    _close(got, ref)


@pytest.mark.parametrize("nx", [64, 40, 254])
def test_lane_transfers(nx):
    rng = np.random.default_rng(14)
    w, wc = nx + 1, nx // 2 + 1
    wp = -(-w // 128) * 128
    rr = np.zeros((9, wp), np.float32)
    rr[:, :w] = rng.standard_normal((9, w))
    # strided forms are the same ops in both libraries
    _close(mg_fused.lane_restrict(_t(rr), nx, wc), jmg.lane_restrict(jnp.asarray(rr), nx, wc))
    # the TPU's banded-matmul form sums in another order
    _close(mg_fused.lane_restrict(_t(rr), nx, wc),
           jmg.lane_restrict_mm(jnp.asarray(rr), nx, wc), frac=1e-6)
    ec = np.zeros((9, wc), np.float32)
    ec[:, : nx // 2 + 1] = rng.standard_normal((9, nx // 2 + 1))
    # (the matmul form leaves values past the active width nx+1, where the
    # kernels' interior mask discards them)
    _close(mg_fused.lane_prolong(_t(ec), nx // 2, wp)[:, :w],
           np.asarray(jmg.lane_prolong_mm(jnp.asarray(ec), nx // 2, wp))[:, :w], frac=1e-6)
    _close(mg_fused.lane_prolong(_t(ec), nx // 2, wp),
           jmg.lane_prolong(jnp.asarray(ec), nx // 2, wp))
    # P = 2 R^T exactly (weights are powers of two)
    Rt = mg_fused.lane_restrict(torch.eye(w, dtype=torch.float64), nx, wc)  # (w, wc)
    Pt = mg_fused.lane_prolong(torch.eye(wc, dtype=torch.float64), nx // 2, w)  # (wc, w)
    assert torch.equal(Pt, 2.0 * Rt.T)


@pytest.mark.parametrize("shape,nx,ny", SHAPES)
def test_vcycle_and_call_with_dot_match_jax(shape, nx, ny):
    # the port's fused levels run the legs with the lane transfers folded in,
    # JAX's its kernels with lane_restrict_mm / lane_prolong_mm between them
    jd, M = _jax_mg(shape, nx, ny)
    P = _carry_mg(M)
    rng = np.random.default_rng(15)
    r = (rng.standard_normal(jd.grid_shape) * np.asarray(jd.interior)).astype(np.float32)
    jM = jax.jit(M)  # one compiled program per input type, not op-by-op dispatch
    _close(P(_t(r)), jM(jnp.asarray(r)), frac=1e-5)
    # padded pass-through: the fused fine level's own layout, dot fused in K_up
    hp, wp = M.levels[0].kernels.padded_shape
    rp = np.zeros((hp, wp), np.float32)
    rp[: r.shape[0], : r.shape[1]] = r
    z_ref, dot_ref = jax.jit(M.call_with_dot)(jnp.asarray(rp))
    z, dot = P.call_with_dot(_t(rp))
    _close(z, z_ref, frac=1e-5)
    np.testing.assert_allclose(dot.item(), float(dot_ref), rtol=1e-5)
    # symmetric operator: (u, M v) == (v, M u) to f32 round-off
    u, v = (_t((rng.standard_normal(jd.grid_shape) * jd.interior).astype(np.float32))
            for _ in range(2))
    s1, s2 = float(torch.sum(u * P(v))), float(torch.sum(v * P(u)))
    assert abs(s1 - s2) <= 2e-5 * abs(s1)
    # f64 fields take the plain leg of every level
    r64 = _t(r.astype(np.float64))
    _close(P(r64), jM(jnp.asarray(r64)), frac=1e-12)


@pytest.mark.parametrize("shape,nx,ny", SHAPES)
def test_pcg_iteration_from_carried_state(shape, nx, ny):
    jd, M = _jax_mg(shape, nx, ny)
    pop = PallasStencilOperator.from_domain(jd, interpret=True)
    Mj = JPadded(inner=M, padded_op=pop)
    lay = PaddedStencilOperator.from_domain(_domains(shape, nx, ny)[1])
    Mt = PaddedPreconditioner(inner=_carry_mg(M), padded_op=lay)
    eng_j, eng_t = JEngine(pop, Mj), cg_fused.FusedCGEngine(lay, Mt)
    rng = np.random.default_rng(16)
    r = jnp.asarray(_masked_field(rng, pop))
    w0, rz0 = Mj.call_with_dot(r)
    f32 = jnp.float32
    s = JCGState(
        x=jnp.zeros_like(r), r=r, z=jnp.zeros_like(r), k=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False), reason=jnp.asarray(0, jnp.int32), rz=rz0,
        r_norm2=jnp.sum(r * r), prec_max=jnp.asarray(jnp.inf, f32),
        r_max=jnp.max(jnp.abs(r)), err_max=jnp.asarray(jnp.inf, f32),
        r0_norm=jnp.sqrt(jnp.sum(r * r)), w=w0, rz_prev=jnp.asarray(1.0, f32),
    )
    s = eng_j.iteration(s, None)  # k = 1: the next step has beta != 0
    st = cg_state_from_arrays({k: np.asarray(v) for k, v in s._asdict().items()})
    s2, st2 = eng_j.iteration(s, None), eng_t.iteration(st)
    assert st2.k == int(s2.k) == 2
    for name in ("x", "r", "z", "w"):
        _close(getattr(st2, name), getattr(s2, name), frac=1e-5)
    for name in ("rz", "rz_prev", "r_norm2", "prec_max", "r_max"):
        np.testing.assert_allclose(getattr(st2, name).item(), float(getattr(s2, name)),
                                   rtol=1e-5)

"""CPU parity of the port's 3D kernel modules against the JAX package's
Pallas kernels (interpret mode): the 7-point apply S7 (TPU bodies B1, B2),
the V-cycle legs D3 (B3 + B4, B6) and U3 (B5, B7), the Jacobi sweep J3
(B8, B9) and the double-f32 residual R3 (B10, B11). On CPU tensors each
wrapper runs its plain torch version.

Sizes reach every TPU body: at 16³ (D = 17) the JAX package runs its
per-plane bodies, at 32³ (D = 33) its z-chunked ones with a ragged last
chunk; the box 16 × 24 × 8 has unequal extents and spacings (coefficients
256, 576, 64 — a swapped coefficient would show, and 576 takes R3's Dekker
branch).

Tolerances:
- S7, D3, U3, J3: the same f32 formulas; sums may associate differently in
  JAX's interpret mode, so 64 eps32 · max|ref| (S7) and the JAX suite's own
  rtol 1e-5 with atol 2e-6 · max|ref| (legs, V-cycle) or 1e-5 · max|ref|
  (Jacobi).
- R3: rh bit-equal, rl within 32 · max|bh| · 2⁻⁴⁸, the
  tests/test_resid_ff.py contract.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solvers_tpu.core.domain import Domain3D as JDomain3D
from iterative_solvers_tpu.kernels.resid_ff import (
    pallas_residual_ff_3d,
    pallas_residual_ff_3d_chunked,
)
from iterative_solvers_tpu.kernels.stencil3d_pallas import Pallas3DStencilOperator
from iterative_solvers_tpu.ops.ddf32 import split_f64 as j_split_f64
from iterative_solvers_tpu.solvers.multigrid import MultigridPreconditioner as JMG
from iterative_solvers_tpu.solvers.multigrid import _prolong1d as _j_prolong1d
from iterative_solvers_tpu.solvers.multigrid import _restrict1d as _j_restrict1d

from iterative_solvers_tpu_torch import Domain3D
from iterative_solvers_tpu_torch.kernels import _build, resid_ff
from iterative_solvers_tpu_torch.kernels.mg_fused3d import FusedLevelKernels3D
from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
from iterative_solvers_tpu_torch.ops import ddf32
from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner, _FusedLevel3D
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EPS32 = float(np.finfo(np.float32).eps)
# (nx, ny, nz): per-plane bodies, z-chunked ragged bodies, the unequal box
DIMS = [(16, 16, 16), (32, 32, 32), (16, 24, 8)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _doms(dims):
    nx, ny, nz = dims
    return JDomain3D(nx=nx, ny=ny, nz=nz), Domain3D(nx=nx, ny=ny, nz=nz)


@functools.lru_cache(maxsize=None)
def _levels(dims):
    """Both hierarchies, built once per box: the tests that read them share
    the JAX programs they compile."""
    jd, td = _doms(dims)
    Mj = JMG.from_domain(jd, fuse=True, fuse_min_extent=16, interpret=True)
    Mt = MultigridPreconditioner.from_domain(td, fuse=True, fuse_min_extent=16, device="cpu")
    return Mj, Mt


@pytest.mark.parametrize("dims", DIMS)
def test_stencil3d_plain_matches_pallas(dims):
    jd, td = _doms(dims)
    pop = Pallas3DStencilOperator.from_domain(jd, interpret=True)
    lay = Padded3DStencilOperator.from_domain(td)
    assert lay.padded_shape == pop.padded_shape and lay.block_rows == pop.block_rows
    assert lay.coeffs == pop.coeffs
    # the body JAX runs: B2 (chunked) when its z-chunk divides D, else B1;
    # the port's kernel takes any depth
    assert pop.block_z == {17: 1, 33: 11, 9: 9}[pop.padded_shape[0]]  # 17 is prime
    rng = np.random.default_rng(31)
    x = rng.standard_normal(pop.padded_shape).astype(np.float32)  # reads are masked
    ref = np.asarray(pop(jnp.asarray(x)))
    got = lay(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=64 * EPS32 * np.abs(ref).max())
    assert lay.nnz() == pop.nnz()
    np.testing.assert_array_equal(lay.interior_padded(), pop.interior_padded())
    np.testing.assert_array_equal(lay.diagonal(device="cpu").numpy(), np.asarray(pop.diagonal()))


def test_stencil3d_layout_pad_crop():
    jd, td = _doms((16, 24, 8))
    pop = Pallas3DStencilOperator.from_domain(jd, interpret=True)
    lay = Padded3DStencilOperator.from_domain(td)
    f = np.random.default_rng(2).standard_normal(jd.grid_shape)
    np.testing.assert_array_equal(lay.pad(_t(f)).numpy(), np.asarray(pop.pad(jnp.asarray(f))))
    np.testing.assert_array_equal(lay.crop(lay.pad(_t(f))).numpy(), f)
    np.testing.assert_array_equal(lay.mask(lay.pad(_t(f))).numpy(),
                                  np.asarray(pop.mask(pop.pad(jnp.asarray(f)))))


# (box, level): level 0 of each box, whose child is plain at 16³ and
# 16 × 24 × 8 and fused at 32³, and level 1 of 32³, whose child is plain
LEGS = [((16, 16, 16), 0), ((32, 32, 32), 0), ((32, 32, 32), 1), ((16, 24, 8), 0)]


def _jax_child_layout(Mj, li, rc):
    """The child's input layout as the JAX V-cycle hands it the field: its
    padded canvas when the child is fused, else its grid."""
    child = Mj.levels[li + 1]
    return child.pad_in(rc) if hasattr(child, "pad_in") else rc


@pytest.mark.parametrize("dims,li", LEGS)
def test_down_up_legs_match_pallas(dims, li):
    """D3 and U3 against the JAX legs composed as the JAX V-cycle composes
    them (iterative_solvers_tpu/solvers/multigrid.py:592-611): the
    z-restricting kernel, the level's y/x restriction, the child mask and
    the child's pad; the child's correction cropped, prolonged along y/x
    and handed to the z-prolonging kernel."""
    Mj, Mt = _levels(dims)
    jl, tl = Mj.levels[li], Mt.levels[li]
    jk, tk = jl.kernels, tl.kernels
    assert isinstance(tl, _FusedLevel3D)
    assert tk.padded_shape == jk.padded_shape
    assert tk.coeffs == tuple(jk.coeffs) and tk.cs == jk.cs
    rng = np.random.default_rng(17)
    b = rng.standard_normal(jk.padded_shape).astype(np.float32)  # unmasked: reads masked
    rr = jk.down(jnp.asarray(b))
    if jl._matmul_transfers:
        rc = jl.restrict_yx(rr)
    else:
        rc = _j_restrict1d(_j_restrict1d(rr[:, : jl.h, : jl.w], 1), 2)
    rc = jnp.where(jl.child_interior, rc, 0.0)
    ref = np.asarray(_jax_child_layout(Mj, li, rc))
    got = tk.down(_t(b)).numpy()
    assert got.shape == ref.shape == tk.child_shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-6 * np.abs(ref).max())
    ec = rng.standard_normal(tk.child_shape).astype(np.float32)
    dc, hp, wp = (tk.dc,) + jk.padded_shape[1:]
    ecg = jnp.asarray(ec[:, : tk.ny // 2 + 1, : tk.nx // 2 + 1])
    if jl._matmul_transfers:
        ecl = jl.prolong_yx(ecg)
    else:
        ecl = _j_prolong1d(_j_prolong1d(ecg, 1), 2)
        ecl = jnp.pad(ecl, ((0, 0), (0, hp - jl.h), (0, wp - jl.w)))
    ref = np.asarray(jk.up(jnp.asarray(b), ecl))
    got = tk.up(_t(b), _t(ec)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-6 * np.abs(ref).max())


def test_fused_leg_3d_runs_no_op_between_kernels(monkeypatch):
    """A fused 3D leg is D3 → the child's cycle → U3 with no torch op in
    between, as in 2D: D3's output is the very tensor the child's cycle
    receives, on the child's padded canvas (so the child pads and crops
    nothing), and the child's return is the very tensor U3 takes."""
    _, Mt = _levels((32, 32, 32))
    seen = []
    down, up, vcycle = FusedLevelKernels3D.down, FusedLevelKernels3D.up, MultigridPreconditioner._vcycle

    def spy_down(k, b):
        seen.append(("down", down(k, b)))
        return seen[-1][1]

    def spy_up(k, b, ec):
        seen.append(("up", ec))
        return up(k, b, ec)

    def spy_vcycle(M, li, b):
        seen.append((f"in {li}", b))
        out = vcycle(M, li, b)
        seen.append((f"out {li}", out))
        return out

    monkeypatch.setattr(FusedLevelKernels3D, "down", spy_down)
    monkeypatch.setattr(FusedLevelKernels3D, "up", spy_up)
    monkeypatch.setattr(MultigridPreconditioner, "_vcycle", spy_vcycle)
    k0, k1 = Mt.levels[0].kernels, Mt.levels[1].kernels
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(k0.padded_shape)
                         .astype(np.float32))
    Mt(r)
    names = [n for n, _ in seen]
    assert names == ["in 0", "down", "in 1", "down", "in 2", "out 2", "up", "out 1", "up",
                     "out 0"]
    t = dict(zip(names, (v for _, v in seen)))
    d0, d1 = (v for n, v in seen if n == "down")
    u0, u1 = (v for n, v in seen if n == "up")  # level 1's up, then level 0's
    assert d0 is t["in 1"] and tuple(d0.shape) == k0.child_shape == k1.padded_shape
    assert d1 is t["in 2"] and tuple(d1.shape) == k1.child_shape == Mt.domains[2].grid_shape
    assert u0 is t["out 2"] and u1 is t["out 1"]


def test_legs_body_choice_follows_jax():
    """At 32³ the JAX package runs its chunked legs (B6/B7, bz 8) on level 0
    and its per-plane ones (B3+B4/B5) on level 1, so the parity cases reach
    both bodies; the port fuses the same levels on the same layouts, with
    one kernel for either body."""
    Mj, Mt = _levels((32, 32, 32))
    assert [lv.kernels.block_z for lv in Mj.levels[:-1]] == [8, 1]
    assert [type(lv).__name__ for lv in Mt.levels] == [type(lv).__name__ for lv in Mj.levels] == [
        "_FusedLevel3D", "_FusedLevel3D", "_Level"]
    assert [lv.kernels.padded_shape for lv in Mt.levels[:-1]] == [
        lv.kernels.padded_shape for lv in Mj.levels[:-1]]


@pytest.mark.parametrize("dims", DIMS)
def test_vcycle_matches_jax_fused(dims):
    Mj, Mt = _levels(dims)
    jd, _ = _doms(dims)
    rng = np.random.default_rng(8)
    r = np.where(jd.interior, rng.standard_normal(jd.grid_shape), 0.0).astype(np.float32)
    ref = np.asarray(jax.jit(Mj)(jnp.asarray(r)))  # one compiled program
    got = Mt(_t(r)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-6 * np.abs(ref).max())
    # padded pass-through: the level-0 layout in, the level-0 layout out
    k = Mt.levels[0].kernels
    _, hp, wp = k.padded_shape
    assert Mt.accepts_padded(k.padded_shape)
    zp = Mt(torch.nn.functional.pad(_t(r), (0, wp - r.shape[2], 0, hp - r.shape[1])))
    assert tuple(zp.shape) == k.padded_shape
    torch.testing.assert_close(zp[:, : r.shape[1], : r.shape[2]], _t(got), rtol=0, atol=0)


def test_vcycle_f64_fields_take_the_plain_legs():
    """f64 fields on a fused 3D hierarchy run the plain torch legs (the
    kernels are f32-only) and match the JAX package's jnp V-cycle in f64."""
    jd, td = _doms((16, 24, 8))
    Mj = JMG.from_domain(jd, fuse=False)
    _, Mt = _levels((16, 24, 8))
    r = np.where(jd.interior, np.random.default_rng(1).standard_normal(jd.grid_shape), 0.0)
    ref = np.asarray(jax.jit(Mj)(jnp.asarray(r)))
    got = Mt(_t(r))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-14 * np.abs(ref).max())


def test_transfers_are_adjoint():
    """y/x transfers of a fused 3D level: P = 2 Rᵀ per axis, so
    <R a, c> = <a, P c> / 4 exactly on the cropped canvas."""
    _, Mt = _levels((16, 24, 8))
    lev = Mt.levels[0]
    dc, hp, wp = (lev.kernels.dc,) + lev.kernels.padded_shape[1:]
    rng = np.random.default_rng(4)
    a = torch.zeros((dc, hp, wp), dtype=torch.float64)
    a[:, : lev.h, : lev.w] = torch.from_numpy(rng.standard_normal((dc, lev.h, lev.w)))
    c = torch.from_numpy(rng.standard_normal((dc, 13, 9)))
    lhs = float(torch.sum(lev.restrict_yx(a) * c))
    rhs = float(torch.sum(a * lev.prolong_yx(c))) / 4
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)
    p = lev.prolong_yx(c)
    assert float(p[:, lev.h:].abs().max()) == 0.0 and float(p[:, :, lev.w:].abs().max()) == 0.0


@pytest.mark.parametrize("dims", [(16, 16, 16), (32, 32, 32)])
def test_jacobi3d_plain_matches_pallas(dims):
    Mj, Mt = _levels(dims)
    jk, tk = Mj.levels[0].kernels, Mt.levels[0].kernels
    # 16³: per-plane B8; 32³: chunked B9 (bz 8, 40-row panels)
    assert (jk.block_z > 1 and jk._jacobi_block_rows() >= 24) == (dims[0] == 32)
    rng = np.random.default_rng(21)
    x, b = (rng.standard_normal(jk.padded_shape).astype(np.float32) for _ in range(2))
    ref = np.asarray(jk.jacobi(jnp.asarray(x), jnp.asarray(b)))
    got = tk.jacobi(_t(x), _t(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _ff_inputs(pop, seed):
    m = pop.interior_padded()
    rng = np.random.default_rng(seed)
    b64 = rng.standard_normal(pop.padded_shape) * 1e4 * m
    x64 = rng.standard_normal(pop.padded_shape) * m
    return j_split_f64(jnp.asarray(b64)), j_split_f64(jnp.asarray(x64))


@pytest.mark.parametrize("dims", DIMS)
def test_resid_ff3d_plain_matches_pallas(dims):
    jd, td = _doms(dims)
    pop = Pallas3DStencilOperator.from_domain(jd, interpret=True)
    lay = Padded3DStencilOperator.from_domain(td)
    jb, jx = _ff_inputs(pop, 7)
    cd, cx, cy, cz = pop.coeffs
    kw = dict(nx=pop.nx, ny=pop.ny, nz=pop.nz, cd=cd, cx=cx, cy=cy, cz=cz, interpret=True)
    if dims == (32, 32, 32):
        # the body the JAX device loop picks at D >= 32 (B11): bz 4, 40-row panels
        want = pallas_residual_ff_3d_chunked(jx[0], jx[1], jb[0], jb[1], block_z=4,
                                             block_rows=40, **kw)
    else:
        want = pallas_residual_ff_3d(jx[0], jx[1], jb[0], jb[1], block_rows=pop.block_rows, **kw)
    want_h, want_l = (np.asarray(a) for a in want)
    tb, tx = (_t(jb[0]), _t(jb[1])), (_t(jx[0]), _t(jx[1]))
    got_h, got_l = resid_ff.resid_ff(tx[0], tx[1], tb[0], tb[1], lay)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    scale = float(np.abs(np.asarray(jb[0])).max())
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0, atol=32 * scale * 2.0**-48)
    # the pair reproduces the true f64 residual to pair precision
    b64 = ddf32.pair_to_f64(tb)
    x64 = ddf32.pair_to_f64(tx)
    r64 = torch.where(lay.mask_spec.build("cpu"), b64 - lay.apply_plain(x64), 0.0)
    got = ddf32.pair_to_f64((got_h, got_l))
    assert float((got - r64).abs().max()) <= 2e-12 * float(r64.abs().max())


def test_wrappers_count_plain_only_on_cuda_tensors():
    """On CPU tensors the wrappers run their plain versions and count
    nothing: neither a launch nor a plain version on the card."""
    _build.reset_counts()
    _, Mt = _levels((16, 16, 16))
    k = Mt.levels[0].kernels
    b = torch.zeros(k.padded_shape)
    k.up(b, k.down(b))
    k.jacobi(b, b)
    lay = Padded3DStencilOperator.from_domain(Domain3D(16, 16, 16))
    lay(b)
    resid_ff.resid_ff(b, b, b, b, lay)
    assert not _build.launches and not _build.plain_on_cuda
    with pytest.raises(ValueError):
        k.up(b, b)  # ec must be on the child's layout
    with pytest.raises(TypeError):
        k.jacobi(b.double(), b)
    with pytest.raises(ValueError):
        resid_ff.resid_ff(b[:, :-8], b, b, b, lay)
    with pytest.raises(ValueError):
        lay(dataclasses.replace(lay, padded_shape=(17, 24, 256)).pad(torch.zeros(17, 17, 17)))

"""CPU parity of the port's JAX default solve against the JAX package: the
FMG warm start (Jacobi kernel A7 at the fused levels), the double-f32 outer
(ff residual kernel A8, ops/ddf32.py) and the whole path through
``fused_refined_solve(fmg=1, ff=True)`` and the facade.

The JAX side runs its Pallas kernels in interpret mode. Tolerances:

- A7: the same f32 formula as the Pallas kernel; sums may associate
  differently, so 1e-6 · max|ref| (a few f32 ulps).
- A8: rh bit-equal, rl within 32 · max|bh| · 2⁻⁴⁸ (a few pair ulps), as
  tests/test_resid_ff.py holds the Pallas kernel to the jnp reference; the
  pair against the f64 residual to 2e-12 of its scale.
- FMG x0: about ten chained f32 sweeps and a coarse solve: 1e-5 · max|x0|.
- Solves: stop reason, outer and inner counts and the history's inner
  column exact. x and the history's float columns follow f32 round-off of
  the solution and right-hand side scales (the warm start's residuals are
  b − A x0 with x0 in f32): ‖d‖∞ and err∞ within 1e-6 · max|u|, ‖r‖∞ within
  1e-6 · max|b|, ‖r‖₂ within 1e-6 · ‖b‖₂; x within 1e-5 · max|x|.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solvers_tpu import api as japi
from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.core.problem import PoissonProblem as JProblem
from iterative_solvers_tpu.kernels.stencil_pallas import PallasStencilOperator
from iterative_solvers_tpu.ops.ddf32 import residual_ff as j_residual_ff
from iterative_solvers_tpu.ops.ddf32 import split_f64 as j_split_f64
from iterative_solvers_tpu.ops.stencil import stencil_apply as j_stencil_apply
from iterative_solvers_tpu.solvers.multigrid import (
    MultigridPreconditioner as JMG,
    PaddedPreconditioner as JPadded,
)
from iterative_solvers_tpu.solvers.refine import fused_refined_solve as j_fused_refined_solve
from iterative_solvers_tpu.solvers.stopping import StopConfig as JStop

from iterative_solvers_tpu_torch import DirichletSolver, Domain2D, PoissonProblem, StopConfig
from iterative_solvers_tpu_torch.api import _attach_fmg
from iterative_solvers_tpu_torch.kernels import resid_ff
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.ops import ddf32
from iterative_solvers_tpu_torch.solvers.multigrid import (
    MultigridPreconditioner,
    PaddedPreconditioner,
)
from iterative_solvers_tpu_torch.solvers.refine import fused_refined_solve
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL = dict(eps_precision=-1, eps_residual=-1, eps_relative=1e-6, max_iterations=100000)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_mg(shape, n, fuse_min_extent=16):
    """Built once per domain: the tests that read it share its programs."""
    jd = JDomain2D(nx=n, ny=n, shape=shape)
    prob = JProblem.manufactured(jd)
    pop = PallasStencilOperator.from_domain(jd, interpret=True)
    M = JMG.from_domain(jd, fuse=True, fuse_min_extent=fuse_min_extent, interpret=True)
    return prob, pop, japi._attach_fmg(JPadded(inner=M, padded_op=pop), prob)


def _port_mg(shape, n, fuse_min_extent=16):
    dom = Domain2D(nx=n, ny=n, shape=shape)
    prob = PoissonProblem.manufactured(dom)
    lay = PaddedStencilOperator.from_domain(dom)
    M = MultigridPreconditioner.from_domain(dom, fuse=True, fuse_min_extent=fuse_min_extent,
                                            device="cpu")
    return prob, lay, _attach_fmg(PaddedPreconditioner(inner=M, padded_op=lay), prob)


@pytest.mark.parametrize("shape,n", [("gamma", 64), ("rect", 40)])
def test_jacobi_plain_matches_pallas(shape, n):
    _, _, Mj = _jax_mg(shape, n)
    _, _, Mt = _port_mg(shape, n)
    jk, pk = Mj.inner.levels[0].kernels, Mt.inner.levels[0].kernels
    rng = np.random.default_rng(21)
    # unmasked inputs: the kernel masks its reads of x and b
    x, b = (rng.standard_normal(jk.padded_shape).astype(np.float32) for _ in range(2))
    ref = np.asarray(jk.jacobi(jnp.asarray(x), jnp.asarray(b)))
    got = pk.jacobi(_t(x), _t(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def _pairs(shape, n, seed):
    jd = JDomain2D(nx=n, ny=n, shape=shape)
    pop = PallasStencilOperator.from_domain(jd, interpret=True)
    m = pop.interior_padded()
    rng = np.random.default_rng(seed)
    b64 = rng.standard_normal(pop.padded_shape) * 1e4 * m
    x64 = rng.standard_normal(pop.padded_shape) * m
    lay = PaddedStencilOperator.from_domain(Domain2D(nx=n, ny=n, shape=shape))
    return pop, lay, m, b64, x64


@pytest.mark.parametrize("shape,n", [("gamma", 64), ("rect", 48)])  # pow2 / Dekker coefficients
def test_residual_ff_matches_jax(shape, n):
    pop, lay, m, b64, x64 = _pairs(shape, n, 7)
    jb, jx = j_split_f64(jnp.asarray(b64)), j_split_f64(jnp.asarray(x64))
    want_h, want_l = (np.asarray(a) for a in j_residual_ff(jnp.asarray(m), pop.coeffs, jb, jx))
    tb, tx = ddf32.split_f64(_t(b64)), ddf32.split_f64(_t(x64))
    np.testing.assert_array_equal(tb[0].numpy(), np.asarray(jb[0]))
    np.testing.assert_array_equal(tb[1].numpy(), np.asarray(jb[1]))
    got_h, got_l = ddf32.residual_ff(torch.from_numpy(m), lay.coeffs, tb, tx)
    # both sides run the same f32 ops one at a time (no contraction): rh is
    # bit-equal on both coefficient branches
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    scale = float(np.abs(np.asarray(jb[0])).max())
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0, atol=32 * scale * 2.0**-48)
    # the kernel wrapper on CPU tensors is this plain version
    wh, wl = resid_ff.resid_ff(tx[0], tx[1], tb[0], tb[1], lay)
    assert torch.equal(wh, got_h) and torch.equal(wl, got_l)
    # and the pair reproduces the true f64 residual to pair precision
    r64 = np.where(m, b64 - np.asarray(j_stencil_apply(jnp.asarray(x64), jnp.asarray(m),
                                                        *pop.coeffs)), 0.0)
    got = got_h.double().numpy() + got_l.double().numpy()
    np.testing.assert_allclose(got, r64, rtol=0, atol=2e-12 * np.abs(r64).max())


def test_ff_residual_fn_layouts():
    """The residual kernel takes fields on its operator's padded layout only,
    all on one device; pair_add_f32 keeps the pair's precision."""
    pop, lay, m, b64, x64 = _pairs("gamma", 32, 3)
    tb, tx = ddf32.split_f64(_t(b64)), ddf32.split_f64(_t(x64))
    crop = [lay.crop(t) for t in (*tx, *tb)]
    with pytest.raises(ValueError):
        resid_ff.resid_ff(*crop, lay)
    with pytest.raises(TypeError):
        resid_ff.resid_ff(tx[0], tx[1], tb[0].double(), tb[1], lay)
    two = ddf32.pair_add_f32(ddf32.split_f64(_t(x64)), _t(b64.astype(np.float32)))
    ref = _t(x64) + _t(b64.astype(np.float32)).double()
    assert float((ddf32.pair_to_f64(two) - ref).abs().max()) <= 2.0**-44 * float(ref.abs().max())


@pytest.mark.parametrize("shape,n", [("gamma", 64), ("rect", 48)])
def test_fmg_stepwise_matches_jax(shape, n):
    """The padded-flow Jacobi polish runs at every fused level (extent > 16)."""
    jprob, pop, Mj = _jax_mg(shape, n)
    prob, lay, Mt = _port_mg(shape, n)
    kw = dict(polish_max_extent=16, smooth_sweeps=1)
    ref = np.asarray(Mj.fmg_stepwise(pop.pad(jprob.rhs_field(jnp.float64)), 1, combine=True,
                                     **kw))
    got = Mt.fmg_stepwise(lay.pad(prob.rhs_field(device="cpu")), 1, **kw).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # without the cutoff the stepwise ladder is fmg() op for op (as in JAX)
    b32 = prob.rhs_field(torch.float32, "cpu")
    assert torch.equal(Mt.inner.fmg_stepwise(b32, 1, smooth_sweeps=1), Mt.inner.fmg(b32, 1))


def _compare_warm(ref, res, b, x_full):
    assert (int(res.reason), res.converged, res.outer_iterations, res.iterations) == (
        int(ref.reason), ref.converged, ref.outer_iterations, ref.iterations)
    h, hr = np.asarray(res.history, np.float64), np.asarray(ref.history, np.float64)
    assert h.shape == hr.shape
    np.testing.assert_array_equal(h[:, 0], hr[:, 0])
    assert np.isinf(h[0, 1]) and np.isinf(hr[0, 1])
    b = np.asarray(b)
    u_max = hr[0, 3]
    scale = np.array([u_max, np.abs(b).max(), u_max, np.linalg.norm(b)])
    with np.errstate(invalid="ignore"):
        gap = np.abs(h[:, 1:] - hr[:, 1:])
    gap[0, 0] = 0.0  # inf on both sides
    assert np.all(gap <= 1e-6 * scale), (gap / scale).max(axis=0)
    xr = np.asarray(ref.x)
    np.testing.assert_allclose(x_full, xr, rtol=0, atol=1e-5 * np.abs(xr).max())


@pytest.mark.parametrize("shape,n", [("gamma", 64), ("rect", 48)])
def test_fused_refined_solve_fmg_ff_matches_jax(shape, n):
    jprob, pop, Mj = _jax_mg(shape, n)
    ref = j_fused_refined_solve(
        pop, Mj, jprob.rhs_field(jnp.float64), u_true=jprob.true_solution_field(jnp.float64),
        stop=JStop(**REL), fmg=1, ff=True,
    )
    prob, lay, Mt = _port_mg(shape, n)
    b = prob.rhs_field(device="cpu")
    res = fused_refined_solve(lay, Mt, b, u_true=prob.true_solution_field(device="cpu"),
                              stop=StopConfig(**REL), fmg=1, ff=True)
    _compare_warm(ref, res, b, res.x.numpy())


def test_dirichlet_solver_default_solve_matches_jax():
    """The facade with its default fmg_cycles=1 and outer='ff' at 64²: no
    level fuses at this size on either side, so the warm start polishes
    with V-cycles. (On a CPU the JAX facade runs its device ladder only for
    outer='ff'; with 'f64' it takes its host ladder, another algorithm.)"""
    ref = japi.DirichletSolver(nx=64, ny=64, preconditioner="mg", precision="mixed",
                               outer="ff", stop=JStop(**REL)).solve()
    s = DirichletSolver(nx=64, ny=64, preconditioner="mg", precision="mixed", outer="ff",
                        device="cpu", stop=StopConfig(**REL))
    res = s.solve()
    assert s.fmg_cycles == 1
    assert (int(res.stop_reason), res.converged, res.iterations) == (
        int(ref.stop_reason), ref.converged, ref.iterations)
    dom = s.domain
    b = PoissonProblem.manufactured(dom).rhs_field(device="cpu").numpy()
    h, hr = np.asarray(res.history, np.float64), np.asarray(ref.history, np.float64)
    np.testing.assert_array_equal(h[:, 0], hr[:, 0])
    scale = np.array([hr[0, 3], np.abs(b).max(), hr[0, 3], np.linalg.norm(b)])
    with np.errstate(invalid="ignore"):
        gap = np.abs(h[:, 1:] - hr[:, 1:])
    gap[0, 0] = 0.0  # inf on both sides
    assert np.all(gap <= 1e-6 * scale)
    np.testing.assert_allclose(res.solution, ref.solution, rtol=0,
                               atol=1e-5 * np.abs(ref.solution).max())
    assert res.converged and res.residual_norm <= 1e-6 * np.abs(b).max() * 10

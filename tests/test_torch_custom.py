"""CPU parity of the port's custom-mask domain path against the JAX package:
``Domain2D(shape="custom", inside_fn=...)``, its fields, the padded operator
with the int8 mask (C1), the masked ff residual, and the two facade paths —
path C (FMG + refinement around the masked fused PCG engine and the masked
V-cycle legs C2, C3) and path C-B (plain or preconditioned fused CG, its
final residual through C1).

Two shapes: the JAX package's own test domain (a notched disk at fixed
n = 64, whose coarse levels see other indices) and the normalised notched
disk (the same at 64², and the same shape on every level). The JAX side runs
its Pallas kernels in interpret mode; every kernel input is pre-masked, the
JAX custom kernels' contract. Tolerances:

- masks and node counts exact; f64 boundary and exact-solution fields
  exact; the f64 RHS to 1e-14 · max (the JAX host assembly subtracts the x
  terms first, the port the y terms, as the JAX in-trace assembly does); the
  f32 FMG level fields to 1e-6 relative;
- C1: 64 eps32 · max|y| (the products may contract or associate
  differently);
- the ff residual: rh bit-equal, rl within 32 · max|bh| · 2⁻⁴⁸;
- solves: stop reason, outer and inner counts and the history's inner
  column exact; x within 1e-5 · max|x| (as tests/test_torch_ff_fmg.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solvers_tpu import api as japi
from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.core.problem import PoissonProblem as JProblem
from iterative_solvers_tpu.kernels.cg_fused import fused_cg_solve as j_fused_cg_solve
from iterative_solvers_tpu.kernels.stencil_pallas import (
    PallasStencilOperator,
    pallas_stencil_apply_custom,
)
from iterative_solvers_tpu.ops.ddf32 import residual_ff as j_residual_ff
from iterative_solvers_tpu.ops.ddf32 import split_f64 as j_split_f64
from iterative_solvers_tpu.solvers import refine as jrefine
from iterative_solvers_tpu.solvers.cg import CGOptions as JCGOptions
from iterative_solvers_tpu.solvers.multigrid import (
    MultigridPreconditioner as JMG,
    PaddedPreconditioner as JPadded,
)
from iterative_solvers_tpu.solvers.multigrid import _coarsen_domain as j_coarsen
from iterative_solvers_tpu.solvers.stopping import StopConfig as JStop

from iterative_solvers_tpu_torch import DirichletSolver, Domain2D, PoissonProblem, StopConfig
from iterative_solvers_tpu_torch.api import _attach_fmg
from iterative_solvers_tpu_torch.core.domain import ArrayMask, notched_disk
from iterative_solvers_tpu_torch.kernels import _build, resid_ff
from iterative_solvers_tpu_torch.kernels.cg_fused import fused_cg_solve
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.ops import ddf32
from iterative_solvers_tpu_torch.solvers import refine
from iterative_solvers_tpu_torch.solvers.cg import CGOptions
from iterative_solvers_tpu_torch.solvers.multigrid import (
    MultigridPreconditioner,
    PaddedPreconditioner,
    _coarsen_domain,
    _FusedLevel,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EPS32 = float(np.finfo(np.float32).eps)
REL = dict(eps_precision=-1, eps_residual=-1, eps_relative=1e-6, max_iterations=100000)


def fixed_disk(n):
    """The JAX package's custom-mask test domain (fixed centre and radius
    in index units, so coarse levels see another shape)."""
    def inside(ix, iy):
        return ((ix - n / 2) ** 2 + (iy - n / 2) ** 2 <= (0.45 * n) ** 2) & ~(
            (ix > n / 2) & (np.abs(iy - n / 2) < n / 10))
    return inside


def normalised_disk(ix, iy):
    s, t = ix / ix.max() - 0.5, iy / iy.max() - 0.5
    return (s * s + t * t <= 0.45**2) & ~((s > 0) & (np.abs(t) < 0.1))


SHAPES = {"fixed": fixed_disk(64), "normalised": normalised_disk}


def _t(a):
    return torch.from_numpy(np.array(a))


def _domains(fn, n=64):
    return (JDomain2D(nx=n, ny=n, shape="custom", inside_fn=fn),
            Domain2D(nx=n, ny=n, shape="custom", inside_fn=fn))


@pytest.mark.parametrize("name", list(SHAPES))
def test_custom_masks_and_fields_match_jax(name):
    jd, pd = _domains(SHAPES[name])
    levels = 0
    while jd is not None:
        for attr in ("inside", "boundary", "interior"):
            np.testing.assert_array_equal(getattr(pd, attr), np.asarray(getattr(jd, attr)))
        assert pd.num_unknowns == jd.num_unknowns > 0
        np.testing.assert_array_equal(pd.interior_on("cpu").numpy(), jd.interior)
        np.testing.assert_array_equal(pd.boundary_on("cpu").numpy(), jd.boundary)
        jp, pp = JProblem.manufactured(jd), PoissonProblem.manufactured(pd)
        np.testing.assert_array_equal(pp.boundary_field(device="cpu").numpy(),
                                      np.asarray(jp.boundary_field(jnp.float64)))
        np.testing.assert_array_equal(pp.true_solution_field(device="cpu").numpy(),
                                      np.asarray(jp.true_solution_field(jnp.float64)))
        ref = np.asarray(jp.rhs_field(jnp.float64))
        np.testing.assert_allclose(pp.rhs_field(device="cpu").numpy(), ref, rtol=0,
                                   atol=1e-14 * np.abs(ref).max())
        # the FMG payload's level fields (the JAX in-trace assembly), f32
        for got, want in ((pp.rhs_field(torch.float32, "cpu"), jp.rhs_field_traced(jnp.float32)),
                          (pp.boundary_field(torch.float32, "cpu"),
                           jp.boundary_field_traced(jnp.float32))):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
        jd, pd = j_coarsen(jd), _coarsen_domain(pd)
        assert (jd is None) == (pd is None)
        levels += 1
    assert levels == {"fixed": 3, "normalised": 4}[name]


def test_custom_domain_contract():
    with pytest.raises(ValueError, match="requires inside_fn"):
        Domain2D(nx=8, ny=8, shape="custom")
    with pytest.raises(ValueError, match="even"):
        Domain2D(nx=9, ny=8)
    dom = Domain2D(nx=32, ny=32, shape="custom", inside_fn=normalised_disk)
    # one mask object per domain, its device copies made once
    assert dom.mask_spec is dom.mask_spec and isinstance(dom.mask_spec, ArrayMask)
    assert dom.interior_on("cpu") is dom.interior_on("cpu")
    assert dom.with_resolution(16, 16).inside_fn is normalised_disk
    m8 = dom.mask_spec.padded((64, 128)).int8("cpu")
    assert m8.dtype == torch.int8 and int(m8.sum()) == dom.num_unknowns
    # the port's notched_disk is this shape
    np.testing.assert_array_equal(
        Domain2D(nx=64, ny=64, shape="custom", inside_fn=notched_disk).interior,
        _domains(normalised_disk)[1].interior)


@pytest.mark.parametrize("block_rows", [None, 16, 32])
def test_custom_layout_and_stencil_c1_match_pallas(block_rows):
    jd, pd = _domains(SHAPES["fixed"])
    pop = PallasStencilOperator.from_domain(jd, block_rows=block_rows, interpret=True)
    lay = PaddedStencilOperator.from_domain(pd, block_rows=block_rows)
    assert (lay.padded_shape, lay.block_rows, lay.coeffs) == (
        pop.padded_shape, pop.block_rows, pop.coeffs)
    assert lay.mask_mode == pop.mask_mode == "custom" and lay.block_rows >= 32
    m = pop.interior_padded()
    np.testing.assert_array_equal(lay.interior_padded(), m)
    np.testing.assert_array_equal(lay.mask8.int8("cpu").numpy(), np.asarray(pop.mask8))
    assert lay.nnz() == pop.nnz()
    np.testing.assert_array_equal(lay.diagonal("cpu").numpy(), np.asarray(pop.diagonal()))
    x = (np.random.default_rng(41).standard_normal(pop.padded_shape) * m).astype(np.float32)
    cd, cx, cy = pop.coeffs
    ref = np.asarray(pallas_stencil_apply_custom(jnp.asarray(x), pop.mask8, cd=cd, cx=cx, cy=cy,
                                                 block_rows=pop.block_rows, interpret=True))
    got = lay(_t(x)).numpy()  # pre-masked input: the JAX kernel's contract
    np.testing.assert_allclose(got, ref, rtol=0, atol=64 * EPS32 * np.abs(ref).max())
    np.testing.assert_array_equal(lay.mask(_t(x)).numpy(), x)


@pytest.mark.parametrize("name", list(SHAPES))
def test_custom_residual_ff_matches_jax(name):
    jd, pd = _domains(SHAPES[name])
    pop = PallasStencilOperator.from_domain(jd, interpret=True)
    lay = PaddedStencilOperator.from_domain(pd)
    m = pop.interior_padded()
    rng = np.random.default_rng(42)
    b64 = rng.standard_normal(pop.padded_shape) * 1e4 * m
    x64 = rng.standard_normal(pop.padded_shape) * m
    jb, jx = j_split_f64(jnp.asarray(b64)), j_split_f64(jnp.asarray(x64))
    want_h, want_l = (np.asarray(a) for a in j_residual_ff(jnp.asarray(m), pop.coeffs, jb, jx))
    tb, tx = ddf32.split_f64(_t(b64)), ddf32.split_f64(_t(x64))
    got_h, got_l = resid_ff.resid_ff(tx[0], tx[1], tb[0], tb[1], lay)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    scale = float(np.abs(np.asarray(jb[0])).max())
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0, atol=32 * scale * 2.0**-48)


@functools.lru_cache(maxsize=None)
def _jax_mg(jd, fuse_min_extent=16):
    """Built once per domain: the tests that read it share its programs."""
    prob = JProblem.manufactured(jd)
    pop = PallasStencilOperator.from_domain(jd, interpret=True)
    M = JMG.from_domain(jd, fuse=True, fuse_min_extent=fuse_min_extent, interpret=True)
    return prob, pop, japi._attach_fmg(JPadded(inner=M, padded_op=pop), prob)


def _port_mg(pd, fuse_min_extent=16):
    prob = PoissonProblem.manufactured(pd)
    lay = PaddedStencilOperator.from_domain(pd)
    M = MultigridPreconditioner.from_domain(pd, fuse=True, fuse_min_extent=fuse_min_extent,
                                            device="cpu")
    return prob, lay, _attach_fmg(PaddedPreconditioner(inner=M, padded_op=lay), prob)


def test_custom_fused_level_matches_jax():
    """A fused custom level takes 32-row bands (gamma takes 16 at this size)
    and the padded int8 mask; the Jacobi kernel refuses it, as JAX's does.
    (The hierarchy, C2/C3 and the V-cycle with JAX's hierarchy carried
    across are the custom cases of tests/test_torch_kernels.py.)"""
    jd, pd = _domains(normalised_disk)
    M = JMG.from_domain(jd, fuse=True, fuse_min_extent=16, interpret=True)
    P = MultigridPreconditioner.from_domain(pd, fuse=True, fuse_min_extent=16, device="cpu")
    assert isinstance(P.levels[0], _FusedLevel)
    ka, kb = P.levels[0].kernels, M.levels[0].kernels
    assert ka.block_rows == kb.block_rows == 32 and ka.mask_mode == "custom"
    np.testing.assert_array_equal(ka.mask8.int8("cpu").numpy(), np.asarray(kb.mask8))
    hp, wp = ka.padded_shape
    with pytest.raises(NotImplementedError, match="algebraic masks only"):
        ka.jacobi(torch.zeros(hp, wp), torch.zeros(hp, wp))


def _compare(ref, reason, converged, outer, inner, history, x, xr):
    assert (int(reason), converged, outer, inner) == (
        int(ref.reason), ref.converged, ref.outer_iterations, ref.iterations)
    np.testing.assert_array_equal(np.asarray(history)[:, 0], np.asarray(ref.history)[:, 0])
    xr = np.asarray(xr)
    np.testing.assert_allclose(x, xr, rtol=0, atol=1e-5 * np.abs(xr).max())


@pytest.mark.parametrize("ff", [True, False], ids=["ff", "f64"])
def test_path_c_fused_refined_solve_matches_jax(monkeypatch, ff):
    """Path C at 64²: the FMG warm start (level 0 fused and custom, so with
    the polish cutoff at 16 it takes the plain Jacobi polish, as in JAX),
    then the ff or f64 outer around the masked fused PCG engine."""
    monkeypatch.setattr(jrefine, "_FMG_POLISH_MAX_EXTENT", 16)
    monkeypatch.setattr(refine, "_FMG_POLISH_MAX_EXTENT", 16)
    jd, pd = _domains(normalised_disk)
    jprob, pop, Mj = _jax_mg(jd)
    ref = jrefine.fused_refined_solve(
        pop, Mj, jprob.rhs_field(jnp.float64), u_true=jprob.true_solution_field(jnp.float64),
        stop=JStop(**REL), fmg=1, ff=ff)
    prob, lay, Mt = _port_mg(pd)
    _build.reset_counts()
    res = refine.fused_refined_solve(lay, Mt, prob.rhs_field(device="cpu"),
                                     u_true=prob.true_solution_field(device="cpu"),
                                     stop=StopConfig(**REL), fmg=1, ff=ff)
    assert res.reason.name == "RELATIVE_RESIDUAL"
    _compare(ref, res.reason, res.converged, res.outer_iterations, res.iterations, res.history,
             res.x.numpy(), ref.x)
    # the masked plain versions ran (a CPU run counts no launches)
    assert not _build.launches and not _build.plain_on_cuda


def test_path_c_facade_matches_jax():
    """The facade's default solve on a custom domain with outer='ff' (on a
    CPU, JAX's 'auto' takes its host ladder, another algorithm)."""
    jd, pd = _domains(SHAPES["fixed"])
    ref = japi.DirichletSolver(domain=jd, preconditioner="mg", precision="mixed", outer="ff",
                               stop=JStop(**REL)).solve()
    res = DirichletSolver(domain=pd, preconditioner="mg", precision="mixed", outer="ff",
                          device="cpu", stop=StopConfig(**REL)).solve()
    assert (int(res.stop_reason), res.converged, res.iterations) == (
        int(ref.stop_reason), ref.converged, ref.iterations)
    np.testing.assert_array_equal(np.asarray(res.history)[:, 0], np.asarray(ref.history)[:, 0])
    np.testing.assert_allclose(res.solution, ref.solution, rtol=0,
                               atol=1e-5 * np.abs(ref.solution).max())
    np.testing.assert_array_equal(res.interior_mask, ref.interior_mask)
    assert res.shape == "custom" and res.solution.size == pd.num_unknowns


@pytest.mark.parametrize("name,mg", [("fixed", False), ("normalised", False),
                                     ("normalised", True)])
def test_path_cb_fused_cg_solve_matches_jax(name, mg):
    """Path C-B's engine: plain MSG CG (K1 + K2 with the mask) or PCG with
    the fused custom V-cycle (K2-pcg, C2, C3). PCG runs on the normalised
    disk: on the JAX test's domain the coarse level is another shape (its
    ``inside_fn`` at coarse indices), PCG needs ~100 iterations, and the
    two packages' f32 sums in other orders move the count (106 against 108
    at this tolerance; the V-cycles agree to 1.8e-7 relative)."""
    jd, pd = _domains(SHAPES[name])
    jprob, pop, Mj = _jax_mg(jd)
    prob, lay, Mt = _port_mg(pd)
    stop = dict(eps_precision=-1, eps_residual=1e-3, max_iterations=2000)
    ref = j_fused_cg_solve(pop, jprob.rhs_field(jnp.float32), u_true=jprob.true_solution_field(
        jnp.float32), options=JCGOptions(stop=JStop(**stop), preconditioner=Mj if mg else None))
    res = fused_cg_solve(lay, prob.rhs_field(torch.float32, "cpu"),
                         u_true=prob.true_solution_field(torch.float32, "cpu"),
                         options=CGOptions(stop=StopConfig(**stop),
                                           preconditioner=Mt if mg else None))
    assert res.converged and (int(res.reason), res.iterations) == (
        int(ref.reason), ref.iterations)
    xr = np.asarray(ref.x)
    np.testing.assert_allclose(res.x.numpy(), xr, rtol=0, atol=1e-5 * np.abs(xr).max())


@pytest.mark.parametrize("preconditioner", [None, "mg"])
def test_path_cb_facade_matches_jax(preconditioner):
    """``operator='fused'`` on a custom domain: the final residual through
    C1 (the padded operator's masked stencil), as the JAX facade's."""
    jd, pd = _domains(SHAPES["fixed"])
    ref = japi.DirichletSolver(domain=jd, operator="fused",
                               preconditioner=preconditioner).solve()
    s = DirichletSolver(domain=pd, operator="fused", preconditioner=preconditioner, device="cpu")
    res = s.solve()
    assert (int(res.stop_reason), res.converged, res.iterations) == (
        int(ref.stop_reason), ref.converged, ref.iterations)
    np.testing.assert_allclose(res.solution, ref.solution, rtol=0,
                               atol=1e-5 * np.abs(ref.solution).max())
    lay = s._parts[0]
    assert lay.mask8 is not None
    b = PoissonProblem.manufactured(pd).rhs_field(device="cpu")
    x = torch.from_numpy(res.solution_field(pd)).float()
    r = (b - lay.crop(lay(lay.pad(x))).double())[pd.interior_on("cpu")]
    np.testing.assert_array_equal(res.residual, r.numpy())
    np.testing.assert_allclose(res.residual, ref.residual, rtol=0,
                               atol=64 * EPS32 * float(b.abs().max()))

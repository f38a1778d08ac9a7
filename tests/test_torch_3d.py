"""CPU parity of the port's 3D single-device solve against the JAX package:
the box domain and its fields, the plain f32 CG baseline on the padded
7-point operator, ``device_refined_solve`` called as the JAX bench's 3D mode
calls it (padded operator, ``PaddedPreconditioner`` around the fused V-cycle
with the FMG payload, ``fmg=True``, f64 or ff outer), the facade and the
interop of a JAX 3D hierarchy.

The JAX side runs its Pallas kernels in interpret mode, both sides fuse the
fine levels from ``fuse_min_extent=16``, and the FMG polish cutoff is set to
16 on both sides so the Jacobi polish (J3 / B8, B9) runs on level 0.
Tolerances:

- Fields: f64 assembly in the same term order; exp may round differently in
  the last place: 1e-14 relative to each field's max.
- Plain CG: the f32 recurrences round alike but reduce in another order:
  the iteration count exact, x within 1e-5 · max|x|.
- Solves: stop reason, outer and inner counts and the history's inner
  column exact; the FMG x0 within 1e-5 · max|x0| (a few chained f32 sweeps
  and a dense coarse solve); the final x within 1e-6 · max|x| (the outers
  carry x in f64 or f32 pairs, so the f32 inner rounding averages out).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iterative_solvers_tpu.solvers.refine as jrefine
from iterative_solvers_tpu import api as japi
from iterative_solvers_tpu.core.domain import Domain3D as JDomain3D
from iterative_solvers_tpu.core.problem import PoissonProblem as JProblem
from iterative_solvers_tpu.kernels.stencil3d_pallas import Pallas3DStencilOperator
from iterative_solvers_tpu.solvers.cg import CGOptions as JCGOptions
from iterative_solvers_tpu.solvers.cg import cg_solve as j_cg_solve
from iterative_solvers_tpu.solvers.multigrid import (
    MultigridPreconditioner as JMG,
    PaddedPreconditioner as JPadded,
)
from iterative_solvers_tpu.solvers.stopping import StopConfig as JStop

import iterative_solvers_tpu_torch.solvers.refine as trefine
from iterative_solvers_tpu_torch import DirichletSolver, Domain3D, PoissonProblem, StopConfig
from iterative_solvers_tpu_torch.api import _attach_fmg
from iterative_solvers_tpu_torch.interop import multigrid_from_state
from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
from iterative_solvers_tpu_torch.parallel import make_solver_mesh
from iterative_solvers_tpu_torch.solvers.cg import CGOptions, cg_solve
from iterative_solvers_tpu_torch.solvers.multigrid import (
    MultigridPreconditioner,
    PaddedPreconditioner,
    _FusedLevel3D,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL = dict(eps_precision=-1, eps_residual=-1, eps_relative=1e-6, max_iterations=100000)
BOXES = [dict(nx=16, ny=16, nz=16), dict(nx=16, ny=24, nz=8),
         dict(nx=8, ny=8, nz=8, x0=1, x1=2, y0=1, y1=2, z0=1, z1=2)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kw", BOXES)
def test_box_fields_match_jax(kw):
    jd, td = JDomain3D(**kw), Domain3D(**kw)
    for name in ("hx", "hy", "hz", "coeff_diag", "coeff_x", "coeff_y", "coeff_z",
                 "grid_shape", "num_unknowns"):
        assert getattr(td, name) == getattr(jd, name), name
    np.testing.assert_array_equal(td.interior, jd.interior)
    np.testing.assert_array_equal(td.interior_on("cpu").numpy(), jd.interior)
    jp, tp = JProblem.manufactured(jd), PoissonProblem.manufactured(td)
    X, Y, Z = jd.coords()
    pairs = [
        (tp.f(*(_t(a) for a in (X, Y, Z))), jp.f(X, Y, Z)),
        (tp.rhs_field(torch.float64, "cpu"), jp.rhs_field(jnp.float64)),
        (tp.boundary_field(torch.float64, "cpu"), jp.boundary_field(jnp.float64)),
        (tp.true_solution_field(torch.float64, "cpu"), jp.true_solution_field(jnp.float64)),
        (tp.true_solution_field(torch.float64, "cpu", masked=False),
         jp.true_solution_field(jnp.float64, masked=False)),
    ]
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-14 * np.abs(ref).max())
    # the level recipes the FMG payload evaluates (JAX: in-trace assembly)
    np.testing.assert_allclose(tp.rhs_field(torch.float32, "cpu").numpy(),
                               np.asarray(jp.rhs_field_traced(jnp.float32)), rtol=1e-6, atol=0)


def test_plain_cg_on_padded_operator_matches_jax():
    """The JAX bench's baseline: f32 CG on the padded 7-point operator."""
    kw = dict(nx=16, ny=16, nz=16)
    jd, td = JDomain3D(**kw), Domain3D(**kw)
    pop = Pallas3DStencilOperator.from_domain(jd, interpret=True)
    lay = Padded3DStencilOperator.from_domain(td)
    jb = pop.pad(JProblem.manufactured(jd).rhs_field(jnp.float32))
    ref = j_cg_solve(pop, jb, options=JCGOptions(stop=JStop(**REL)))
    res = cg_solve(lay, lay.pad(PoissonProblem.manufactured(td).rhs_field(torch.float32, "cpu")),
                   options=CGOptions(stop=StopConfig(**REL)))
    assert (int(res.reason), res.iterations) == (int(ref.reason), ref.iterations)
    xr = np.asarray(ref.x)
    np.testing.assert_allclose(res.x.numpy(), xr, rtol=0, atol=1e-5 * np.abs(xr).max())


@functools.lru_cache(maxsize=None)
def _bench_route_jax(jd):
    """(operator, preconditioner, padded RHS) of the JAX bench's 3D mode;
    cached per domain so both outers share the JAX programs it compiles."""
    prob = JProblem.manufactured(jd)
    pop = Pallas3DStencilOperator.from_domain(jd, interpret=True)
    M = JMG.from_domain(jd, fuse=True, fuse_min_extent=16, interpret=True)
    Mp = JPadded(inner=M.with_fmg(prob), padded_op=pop)
    return pop, Mp, pop.pad(prob.rhs_field(jnp.float64))


def _bench_route_port(td):
    prob = PoissonProblem.manufactured(td)
    lay = Padded3DStencilOperator.from_domain(td)
    M = MultigridPreconditioner.from_domain(td, fuse=True, fuse_min_extent=16, device="cpu")
    Mp = _attach_fmg(PaddedPreconditioner(inner=M, padded_op=lay), prob)
    return lay, Mp, lay.pad(prob.rhs_field(torch.float64, "cpu"))


@pytest.fixture
def polish_cutoff_16(monkeypatch):
    monkeypatch.setattr(jrefine, "_FMG_POLISH_MAX_EXTENT", 16)
    monkeypatch.setattr(trefine, "_FMG_POLISH_MAX_EXTENT", 16)


@pytest.mark.parametrize("n", [16, 32])
def test_fmg_warm_start_matches_jax(n, polish_cutoff_16):
    jd, td = JDomain3D(nx=n, ny=n, nz=n), Domain3D(nx=n, ny=n, nz=n)
    _, Mj, jb = _bench_route_jax(jd)
    lay, Mt, tb = _bench_route_port(td)
    ref = np.asarray(jrefine._maybe_fmg_x0(Mj, True, jb))
    got = trefine._maybe_fmg_x0(Mt, True, tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == lay.padded_shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("ff", [False, True])
def test_device_refined_solve_bench_route_matches_jax(n, ff, polish_cutoff_16):
    jd, td = JDomain3D(nx=n, ny=n, nz=n), Domain3D(nx=n, ny=n, nz=n)
    pop, Mj, jb = _bench_route_jax(jd)
    ref = jrefine.device_refined_solve(jrefine._padded_hi_operator(pop), pop, jb,
                                       stop=JStop(**REL), preconditioner=Mj, fmg=True, ff=ff)
    lay, Mt, tb = _bench_route_port(td)
    assert isinstance(Mt.inner.levels[0], _FusedLevel3D)
    assert Mt.inner.accepts_padded(lay.padded_shape)  # the V-cycle skips pad/crop
    res = trefine.device_refined_solve(trefine._padded_hi_operator(lay), lay, tb,
                                       stop=StopConfig(**REL), preconditioner=Mt, fmg=True,
                                       ff=ff)
    assert (int(res.reason), res.converged, res.outer_iterations, res.iterations) == (
        int(ref.reason), ref.converged, ref.outer_iterations, ref.iterations)
    assert (res.reason.name, res.outer_iterations, res.iterations) == ("RELATIVE_RESIDUAL", 1, 5)
    np.testing.assert_array_equal(np.asarray(res.history)[:, 0], np.asarray(ref.history)[:, 0])
    xr = np.asarray(ref.x)
    assert res.x.dtype == torch.float64
    np.testing.assert_allclose(res.x.numpy(), xr, rtol=0, atol=1e-6 * np.abs(xr).max())
    # the true f64 residual of the port's answer, with the plain 7-point operator
    r = tb - trefine._padded_hi_operator(lay)(res.x)
    assert float(torch.linalg.norm(r) / torch.linalg.norm(tb)) < 1e-6


def test_dirichlet_solver_3d():
    stop = StopConfig(**REL)
    s = DirichletSolver(domain=Domain3D(16, 16, 16), precision="mixed", preconditioner="mg",
                        outer="f64", device="cpu", stop=stop)
    res = s.solve()
    assert res.converged and res.stop_reason.name == "RELATIVE_RESIDUAL"
    dom = s.domain
    b = PoissonProblem.manufactured(dom).rhs_field(torch.float64, "cpu")
    x = torch.from_numpy(res.solution_field(dom))
    rel = float(torch.linalg.norm(b - StencilOperator.from_domain(dom)(x)) / torch.linalg.norm(b))
    assert rel < 1e-6
    assert res.nz == 16 and res.bounds == (0.0, 1.0, 0.0, 1.0, 0.0, 1.0)
    assert res.solution.shape == res.z_coords.shape == (15**3,)
    # the coordinates of each unknown, in the JAX package's compacted order
    from iterative_solvers_tpu.core.ordering import node_coordinates

    for got, ref in zip((res.x_coords, res.y_coords, res.z_coords),
                        node_coordinates(JDomain3D(16, 16, 16))):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
    assert res.error_norm < 1e-3  # discretisation error of exp(xyz) at h = 1/16
    # outer='auto' is the ff outer in 3D (f64 in 2D): same trajectory, and
    # the JAX facade's (which runs its unpadded operator; its outer='ff'
    # takes the device ladder on a CPU too)
    s_ff = DirichletSolver(domain=Domain3D(16, 16, 16), precision="mixed", preconditioner="mg",
                           device="cpu", stop=stop)
    assert s_ff.outer_kind == "ff"
    assert DirichletSolver(nx=16, ny=16, precision="mixed", preconditioner="mg",
                           device="cpu").outer_kind == "f64"
    res_ff = s_ff.solve()
    assert (res_ff.stop_reason, res_ff.outer_iterations, res_ff.iterations) == (
        res.stop_reason, res.outer_iterations, res.iterations)
    ref = japi.DirichletSolver(domain=JDomain3D(16, 16, 16), precision="mixed",
                               preconditioner="mg", outer="ff", stop=JStop(**REL)).solve()
    assert (int(ref.stop_reason), ref.iterations) == (int(res_ff.stop_reason), res_ff.iterations)
    np.testing.assert_allclose(res_ff.solution, ref.solution, rtol=0,
                               atol=1e-6 * np.abs(ref.solution).max())


def test_dirichlet_solver_3d_rejects_unported():
    """What a 3D solve still refuses: the 2D-only fused engine (with a mesh
    too), f64 on the f32 kernels, the ff outer on a mesh, and an ff outer
    whose operator is not on b's layout."""
    dom = Domain3D(8, 8, 8)
    mesh = make_solver_mesh(1)
    with pytest.raises(ValueError):
        DirichletSolver(domain=dom, operator="fused", device="cpu")
    with pytest.raises(ValueError):
        DirichletSolver(domain=dom, operator="pallas", dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="2D-only"):
        DirichletSolver(domain=dom, operator="fused", mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="single-chip"):
        DirichletSolver(domain=dom, precision="mixed", preconditioner="jacobi", outer="ff",
                        mesh=mesh, device="cpu")
    lay = Padded3DStencilOperator.from_domain(Domain3D(16, 16, 16))
    b = torch.zeros(lay.padded_shape, dtype=torch.float64)
    with pytest.raises(ValueError):  # the plain operator is not on the padded layout
        trefine.device_refined_solve(StencilOperator.from_domain(Domain3D(16, 16, 16)),
                                     StencilOperator.from_domain(Domain3D(16, 16, 16)),
                                     b, ff=True)


def test_multigrid_from_state_3d():
    jd = JDomain3D(nx=16, ny=24, nz=16)
    Mj = JMG.from_domain(jd, fuse=True, fuse_min_extent=16, interpret=True)
    levels = []
    for lv, d in zip(Mj.levels, Mj.domains):
        plain = getattr(lv, "jnp_level", lv)
        desc = dict(shape="box", nx=d.nx, ny=d.ny, nz=d.nz, coeffs=plain.coeffs,
                    omega_over_diag=plain.omega_over_diag)
        if hasattr(lv, "kernels"):
            desc.update(padded_shape=lv.kernels.padded_shape)
        levels.append(desc)
    Mt = multigrid_from_state(levels, np.asarray(Mj.coarse_solve.idx),
                              np.asarray(Mj.coarse_solve.a_inv))
    own = MultigridPreconditioner.from_domain(Domain3D(16, 24, 16), fuse=True,
                                              fuse_min_extent=16, device="cpu")
    assert [type(lv) for lv in Mt.levels] == [type(lv) for lv in own.levels]
    np.testing.assert_array_equal(Mt.coarse_solve.idx, own.coarse_solve.idx)
    np.testing.assert_allclose(Mt.coarse_solve.a_inv, own.coarse_solve.a_inv, rtol=0,
                               atol=1e-12 * np.abs(own.coarse_solve.a_inv).max())
    rng = np.random.default_rng(5)
    r = np.where(jd.interior, rng.standard_normal(jd.grid_shape), 0.0).astype(np.float32)
    ref = np.asarray(Mj(jnp.asarray(r)))
    got = Mt(_t(r)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-6 * np.abs(ref).max())
    torch.testing.assert_close(Mt(_t(r)), own(_t(r)), rtol=0, atol=1e-6 * float(np.abs(ref).max()))

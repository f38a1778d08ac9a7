"""The port's slice as a whole against the JAX package: the f64-outer,
cold-start mixed-precision MG-PCG solve.

The JAX side runs ``fused_refined_solve`` (its fused device path; the JAX
facade takes the host ladder on a CPU) with Pallas in interpret mode. Stop
reason, outer count, total inner count and the history's inner-count column
must match exactly. The float history columns and x follow the f32 inner
solves, whose round-off is about eps32 of the solution's scale on the
corrections and of the initial residual on the residuals. So ‖d‖∞ and
err∞ are held to 1e-6·max|u| and ‖r‖∞, ‖r‖₂ to 1e-6 of their initial
values (about 8 eps32; both scales are history row 0), and x to
1e-5·max|x|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.core.problem import PoissonProblem as JProblem
from iterative_solvers_tpu.kernels.stencil_pallas import PallasStencilOperator
from iterative_solvers_tpu.solvers.multigrid import (
    MultigridPreconditioner as JMG,
    PaddedPreconditioner as JPadded,
)
from iterative_solvers_tpu.solvers.refine import fused_refined_solve as j_fused_refined_solve
from iterative_solvers_tpu.solvers.stopping import StopConfig as JStop

from iterative_solvers_tpu_torch import DirichletSolver, Domain2D, PoissonProblem, StopConfig
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
from iterative_solvers_tpu_torch.solvers.multigrid import (
    MultigridPreconditioner,
    PaddedPreconditioner,
)
from iterative_solvers_tpu_torch.solvers.refine import fused_refined_solve
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

STOPS = {
    "rel1e-6": dict(eps_precision=-1, eps_residual=-1, eps_relative=1e-6, max_iterations=100000),
    "rel1e-9": dict(eps_precision=-1, eps_residual=-1, eps_relative=1e-9, max_iterations=100000),
    "default": dict(),  # precision + max-norm residual 1e-6
}


def _jax_solve(shape, n, stop, fuse_min_extent, max_outer=8):
    jd = JDomain2D(nx=n, ny=n, shape=shape)
    prob = JProblem.manufactured(jd)
    pop = PallasStencilOperator.from_domain(jd, interpret=True)
    M = JMG.from_domain(jd, fuse=True, fuse_min_extent=fuse_min_extent, interpret=True)
    return j_fused_refined_solve(
        pop, JPadded(inner=M, padded_op=pop), prob.rhs_field(jnp.float64),
        u_true=prob.true_solution_field(jnp.float64), stop=JStop(**stop),
        max_outer=max_outer, fmg=False, ff=False,
    )


def _compare(ref, reason, converged, outer, inner, history, x_full):
    assert (int(reason), converged, outer, inner) == (
        int(ref.reason), ref.converged, ref.outer_iterations, ref.iterations)
    h, hr = np.asarray(history), np.asarray(ref.history)
    assert h.shape == hr.shape
    np.testing.assert_array_equal(h[:, 0], hr[:, 0])
    assert np.isinf(h[0, 1]) and np.isinf(hr[0, 1])
    scale = hr[0, [3, 2, 3, 4]]  # max|u|, ‖r0‖∞, max|u|, ‖r0‖₂
    gap = np.abs(h[1:, 1:] - hr[1:, 1:])
    assert np.all(gap <= 1e-6 * scale), (gap / scale).max(axis=0)
    np.testing.assert_allclose(h[0, 2:], hr[0, 2:], rtol=1e-12)
    xr = np.asarray(ref.x)
    np.testing.assert_allclose(x_full, xr, rtol=0, atol=1e-5 * np.abs(xr).max())


@pytest.mark.parametrize("stop", ["rel1e-6", "default"])
def test_dirichlet_solver_matches_jax(stop):
    """The facade at 64²: with the default fuse_min_extent no level fuses,
    on either side, as on an accelerator at this size."""
    ref = _jax_solve("gamma", 64, STOPS[stop], 512)
    s = DirichletSolver(nx=64, ny=64, preconditioner="mg", precision="mixed", outer="f64",
                        fmg_cycles=0, device="cpu", stop=StopConfig(**STOPS[stop]))
    res = s.solve()
    dom = s.domain
    _compare(ref, res.stop_reason, res.converged, res.outer_iterations, res.iterations,
             res.history, res.solution_field(dom))
    # the true f64 residual, recomputed with the plain stencil
    b = PoissonProblem.manufactured(dom).rhs_field(device="cpu")
    x = torch.from_numpy(res.solution_field(dom))
    rel = float(torch.linalg.norm(b - StencilOperator.from_domain(dom)(x)) / torch.linalg.norm(b))
    if stop == "rel1e-6":
        assert res.converged and rel < 1e-6


@pytest.mark.parametrize("shape,n,stop,max_outer", [
    ("gamma", 64, "rel1e-9", 8), ("rect", 48, "rel1e-6", 8), ("gamma", 32, "default", 8),
    ("gamma", 32, "rel1e-9", 1),  # outer budget spent: the escalated f64 polish runs
])
def test_fused_slice_matches_jax(shape, n, stop, max_outer):
    """fused_refined_solve with fused fine levels (fuse_min_extent=16), so the
    plain K_down/K_up run inside the whole solve."""
    ref = _jax_solve(shape, n, STOPS[stop], 16, max_outer)
    dom = Domain2D(nx=n, ny=n, shape=shape)
    prob = PoissonProblem.manufactured(dom)
    lay = PaddedStencilOperator.from_domain(dom)
    M = MultigridPreconditioner.from_domain(dom, fuse=True, fuse_min_extent=16, device="cpu")
    res = fused_refined_solve(
        lay, PaddedPreconditioner(inner=M, padded_op=lay), prob.rhs_field(device="cpu"),
        u_true=prob.true_solution_field(device="cpu"), stop=StopConfig(**STOPS[stop]),
        max_outer=max_outer,
    )
    assert res.escalated == ref.escalated == (max_outer == 1)
    _compare(ref, res.reason, res.converged, res.outer_iterations, res.iterations,
             res.history, res.x.numpy())

"""High-level facade for the mixed-precision multigrid path (counterpart of
iterative_solvers_tpu/api.py).

``DirichletSolver(..., preconditioner="mg", precision="mixed")`` assembles
the manufactured problem on ``device`` in f64 and runs
:func:`~iterative_solvers_tpu_torch.solvers.refine.fused_refined_solve`:
the f64 refinement outer around the fused f32 PCG engine and its fused
V-cycle. ``device="cuda"`` (the default) launches the hand-written kernels
and raises if there is no card; ``device="cpu"`` runs their plain torch
versions. Nothing falls back from one to the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from iterative_solvers_tpu_torch.core.domain import Domain2D
from iterative_solvers_tpu_torch.core.problem import PoissonProblem
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
from iterative_solvers_tpu_torch.solvers.multigrid import PaddedPreconditioner
from iterative_solvers_tpu_torch.solvers.precond import (
    make_preconditioner,
    parse_preconditioner,
)
from iterative_solvers_tpu_torch.solvers.refine import fused_refined_solve
from iterative_solvers_tpu_torch.solvers.stopping import StopConfig, StopReason


@dataclass
class SolverResults:
    """What a solve produces, in compacted (row-major interior) ordering."""

    solution: np.ndarray
    true_solution: np.ndarray
    residual: np.ndarray  # b − A x
    error: np.ndarray  # x − u_exact
    x_coords: np.ndarray
    y_coords: np.ndarray
    iterations: int  # total inner PCG iterations
    converged: bool
    stop_reason: StopReason
    residual_norm: float  # ‖r‖∞
    error_norm: float  # ‖x−u‖∞
    precision_norm: float  # ‖d‖∞ of the last outer step
    elapsed_s: float
    nx: int = 0
    ny: int = 0
    bounds: tuple = (0.0, 1.0, 0.0, 1.0)
    eps: float = 1e-6
    max_iterations: int = 10000
    history: Optional[np.ndarray] = None
    shape: str = ""
    outer_iterations: int = 0  # refinement steps (not in the JAX results)

    def solution_field(self, domain: Domain2D) -> np.ndarray:
        """Scatter the compacted solution back onto the full grid."""
        out = np.zeros(domain.grid_shape)
        out[domain.interior] = self.solution
        return out


class DirichletSolver:
    """Gamma-domain Dirichlet–Poisson solved by mixed-precision MG-PCG.

    Ported options: ``preconditioner='mg[:nu]'``, ``precision='mixed'``,
    ``fmg_cycles=0``, ``outer='f64'`` or ``'auto'`` — which means f64 here,
    because f64 is native on the card (the JAX package's 'auto' picks the
    double-f32 outer on a TPU). ``fmg_cycles`` keeps the JAX default of 1, so
    leaving it out raises rather than silently starting cold.
    """

    def __init__(
        self,
        nx: int = 30,
        ny: int = 30,
        x0: float = 1.0,
        x1: float = 2.0,
        y0: float = 1.0,
        y1: float = 2.0,
        *,
        domain: Optional[Domain2D] = None,
        problem: Optional[PoissonProblem] = None,
        stop: Optional[StopConfig] = None,
        preconditioner: Optional[str] = None,
        precision: Optional[str] = None,
        fmg_cycles: int = 1,
        outer: str = "auto",
        device="cuda",
    ) -> None:
        if problem is not None:
            self.problem = problem
        else:
            dom = domain or Domain2D(nx=nx, ny=ny, x0=x0, x1=x1, y0=y0, y1=y1)
            self.problem = PoissonProblem.manufactured(dom)
        self.stop = stop or StopConfig()
        self.preconditioner = preconditioner
        self.precision = precision
        self.fmg_cycles = fmg_cycles
        self.outer = outer
        self.device = torch.device(device)
        self._validate_config()
        self._parts = None  # (layout, padded M), built on first solve

    @property
    def domain(self) -> Domain2D:
        return self.problem.domain

    def _validate_config(self) -> None:
        kind = None
        if self.preconditioner is not None:
            kind, _ = parse_preconditioner(self.preconditioner)
        if self.precision not in (None, "mixed"):
            raise ValueError(f"unknown precision {self.precision!r} (use None or 'mixed')")
        if self.outer not in ("auto", "f64", "ff"):
            raise ValueError(f"unknown outer {self.outer!r} (use 'auto', 'f64' or 'ff')")
        if self.outer == "ff" and self.precision != "mixed":
            raise ValueError("outer='ff' needs precision='mixed'")
        if not (isinstance(self.fmg_cycles, int) and self.fmg_cycles >= 0):
            raise ValueError(f"fmg_cycles must be an int >= 0, got {self.fmg_cycles!r}")
        # --- what the port does not run yet ---
        if self.precision != "mixed" or kind != "mg":
            raise NotImplementedError(
                "only precision='mixed' with preconditioner='mg[:nu]' is ported "
                "(ROADMAP Queue 1 items 4, 12 and 13)"
            )
        if self.outer == "ff":
            raise NotImplementedError(
                "outer='ff' (double-f32 outer) is not ported yet (ROADMAP Queue 1 item 7)"
            )
        if self.fmg_cycles > 0:
            raise NotImplementedError(
                "the FMG warm start (fmg_cycles > 0) is not ported yet "
                "(ROADMAP Queue 1 item 5, FMG); pass fmg_cycles=0"
            )
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")

    def solve(self) -> SolverResults:
        dom = self.domain
        if self._parts is None:
            M = make_preconditioner(self.preconditioner, dom, device=self.device)
            pop = PaddedStencilOperator.from_domain(dom)
            self._parts = (pop, PaddedPreconditioner(inner=M, padded_op=pop))
        pop, Mp = self._parts
        b = self.problem.rhs_field(torch.float64, self.device)
        u = (
            self.problem.true_solution_field(torch.float64, self.device)
            if self.problem.u_exact is not None
            else None
        )
        res = fused_refined_solve(pop, Mp, b, u_true=u, stop=self.stop)
        x = res.x
        r = b - StencilOperator.from_domain(dom)(x)
        interior = dom.interior_on(self.device)
        sol = x[interior].cpu().numpy()
        resid = r[interior].cpu().numpy()
        if u is not None:
            tru = u[interior].cpu().numpy()
            err = sol - tru
        else:
            tru = err = np.zeros(0)
        X = dom.x0 + np.arange(dom.nx + 1) * dom.hx
        Y = dom.y0 + np.arange(dom.ny + 1) * dom.hy
        iy, ix = np.nonzero(dom.interior)
        eps_active = [
            e
            for e in (self.stop.eps_precision, self.stop.eps_residual,
                      self.stop.eps_exact_error, self.stop.eps_relative)
            if e > 0
        ]
        return SolverResults(
            solution=sol,
            true_solution=tru,
            residual=resid,
            error=err,
            x_coords=X[ix],
            y_coords=Y[iy],
            iterations=res.iterations,
            converged=res.converged,
            stop_reason=res.reason,
            residual_norm=float(np.max(np.abs(resid))) if resid.size else 0.0,
            error_norm=float(np.max(np.abs(err))) if err.size else float("inf"),
            precision_norm=res.precision_max,
            elapsed_s=res.elapsed_s,
            nx=dom.nx,
            ny=dom.ny,
            bounds=(dom.x0, dom.x1, dom.y0, dom.y1),
            eps=min(eps_active) if eps_active else -1.0,
            max_iterations=self.stop.max_iterations,
            history=res.history,
            shape=dom.shape,
            outer_iterations=res.outer_iterations,
        )

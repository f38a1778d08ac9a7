"""High-level facade (counterpart of iterative_solvers_tpu/api.py).

Two paths are ported:

- ``DirichletSolver(..., preconditioner="mg", precision="mixed")``, the JAX
  package's default solve: the manufactured problem assembled on ``device``
  in f64, then :func:`~iterative_solvers_tpu_torch.solvers.refine.fused_refined_solve`
  — the FMG warm start (``fmg_cycles``, default 1), the refinement outer
  (``outer``: f64 or double-f32) around the fused f32 PCG engine and its
  fused V-cycle. ``operator`` stays ``"stencil"`` here, as in the JAX facade,
  whose mixed path runs the fused engine whatever the operator.
- ``DirichletSolver(..., operator="fused")``: f32 MSG CG (or, with
  ``preconditioner="mg"``, PCG) on the fused engine through
  :func:`~iterative_solvers_tpu_torch.kernels.cg_fused.fused_cg_solve`, the
  reference algorithm; the final residual goes through the padded
  operator's stencil kernel, as in the JAX facade.
- ``DirichletSolver(domain=Domain3D(...), preconditioner="mg",
  precision="mixed")``, the 3D box:
  :func:`~iterative_solvers_tpu_torch.solvers.refine.device_refined_solve`
  on the padded 7-point operator (kernel S7) with the fused 3D V-cycle
  behind a ``PaddedPreconditioner``, the FMG warm start and the f64 or ff
  outer (kernel R3) — the route the JAX package's bench takes. The JAX
  facade runs its 3D mixed solve on the *unpadded* plain operator; the port
  takes the padded one so the kernels carry it (ROADMAP Queue 3).
  ``operator="fused"`` with a 3D domain raises ValueError, as in JAX.

A custom-mask domain (``Domain2D(shape="custom", inside_fn=...)``) runs the
two 2D paths with the same modules, its kernels taking the int8 mask
operand; its results carry ``interior_mask``, as the JAX package's do.

``device="cuda"`` (the default) launches the hand-written kernels and raises
if there is no card; ``device="cpu"`` runs their plain torch versions.
Nothing falls back from one to the other. Every other option combination of
the JAX facade raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from iterative_solvers_tpu_torch.core.domain import Domain2D, Domain3D, resolve_device
from iterative_solvers_tpu_torch.core.problem import PoissonProblem
from iterative_solvers_tpu_torch.kernels.cg_fused import fused_cg_solve
from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
from iterative_solvers_tpu_torch.solvers.cg import CGOptions
from iterative_solvers_tpu_torch.solvers.multigrid import (
    MultigridPreconditioner,
    PaddedPreconditioner,
)
from iterative_solvers_tpu_torch.solvers.precond import (
    make_preconditioner,
    parse_preconditioner,
)
from iterative_solvers_tpu_torch.solvers.refine import (
    _padded_hi_operator,
    device_refined_solve,
    fused_refined_solve,
)
from iterative_solvers_tpu_torch.solvers.stopping import StopConfig, StopReason

# What outer='auto' means on the card, by the domain's dimension (PERF.md
# has the A/Bs behind it: 8192² in 2D, 512³ in 3D).
AUTO_OUTER = {2: "f64", 3: "ff"}


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
    # 3D (None/0 for 2D problems)
    z_coords: Optional[np.ndarray] = None
    nz: int = 0
    # the full-grid interior of a custom domain (None for the others)
    interior_mask: Optional[np.ndarray] = None

    def solution_field(self, domain) -> np.ndarray:
        """Scatter the compacted solution back onto the full grid."""
        out = np.zeros(domain.grid_shape)
        out[domain.interior] = self.solution
        return out


def _attach_fmg(M, problem):
    """Attach the FMG payload (:meth:`MultigridPreconditioner.with_fmg`) to
    the multigrid inside adapter ``M``; anything else passes through."""
    if isinstance(M, PaddedPreconditioner):
        return dataclasses.replace(M, inner=_attach_fmg(M.inner, problem))
    if isinstance(M, MultigridPreconditioner) and M.domains:
        return M.with_fmg(problem)
    return M


class DirichletSolver:
    """Dirichlet–Poisson solver on a gamma/rect/custom 2D domain or a 3D box.

    Ported options: ``precision='mixed'`` with ``preconditioner='mg[:nu]'``,
    any ``fmg_cycles >= 0`` and ``outer`` in ``'f64'``, ``'ff'`` (double-f32)
    or ``'auto'`` — which means :data:`AUTO_OUTER` of the domain's
    dimension, chosen by measurement on the card (the JAX package's 'auto'
    picks ff on a TPU); and, 2D
    only, ``operator='fused'`` with ``precision=None``, with or without
    ``preconditioner='mg[:nu]'``.
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
        domain=None,
        problem: Optional[PoissonProblem] = None,
        operator: str = "stencil",
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
        self.operator_kind = operator
        self.stop = stop or StopConfig()
        self.preconditioner = preconditioner
        self.precision = precision
        self.fmg_cycles = fmg_cycles
        self.outer = outer
        self._validate_config()
        self.device = resolve_device(device)
        self._parts = None  # (layout, padded M or None), built on first solve

    @property
    def domain(self):
        return self.problem.domain

    @property
    def is3d(self) -> bool:
        return isinstance(self.domain, Domain3D)

    def _validate_config(self) -> None:
        operator = self.operator_kind
        if operator not in ("stencil", "sparse", "pallas", "fused"):
            raise ValueError(
                f"unknown operator {operator!r} (use 'stencil', 'sparse', 'pallas' or 'fused')"
            )
        if operator == "fused" and self.is3d:
            raise ValueError("operator='fused' is 2D-only; a 3D domain runs with "
                             "precision='mixed', preconditioner='mg'")
        kind = None
        if self.preconditioner is not None:
            kind, _ = parse_preconditioner(self.preconditioner)
            if kind == "mg" and operator == "sparse":
                raise ValueError("preconditioner='mg' needs grid-shaped fields, "
                                 "which operator='sparse' does not have")
            if operator == "fused" and kind != "mg":
                raise ValueError("operator='fused' supports preconditioner='mg[:nu]' only")
        if self.precision not in (None, "mixed"):
            raise ValueError(f"unknown precision {self.precision!r} (use None or 'mixed')")
        if self.outer not in ("auto", "f64", "ff"):
            raise ValueError(f"unknown outer {self.outer!r} (use 'auto', 'f64' or 'ff')")
        if self.outer == "ff" and self.precision != "mixed":
            raise ValueError("outer='ff' needs precision='mixed'")
        if self.precision == "mixed" and operator != "stencil":
            # the JAX facade's rule without a mesh (no mesh is ported)
            raise ValueError("precision='mixed' requires operator='stencil'")
        if not (isinstance(self.fmg_cycles, int) and self.fmg_cycles >= 0):
            raise ValueError(f"fmg_cycles must be an int >= 0, got {self.fmg_cycles!r}")
        # --- what the port does not run yet ---
        if self.precision == "mixed" and kind != "mg":
            raise NotImplementedError(
                "precision='mixed' runs with preconditioner='mg[:nu]' only; the generic "
                "ladder and the other preconditioners are not ported yet "
                "(ROADMAP Queue 1 item 12)"
            )
        if self.precision is None and operator != "fused":
            raise NotImplementedError(
                f"operator={operator!r} with precision=None is not ported yet "
                "(ROADMAP Queue 1 items 12 and 13); use operator='fused'"
                + (" (2D) or precision='mixed' (3D)" if self.is3d else "")
            )

    @property
    def outer_kind(self) -> str:
        """The outer this solver runs: 'f64' or 'ff'."""
        return AUTO_OUTER[3 if self.is3d else 2] if self.outer == "auto" else self.outer

    def _build_parts(self):
        dom = self.domain
        layout = Padded3DStencilOperator if self.is3d else PaddedStencilOperator
        pop = layout.from_domain(dom)
        Mp = None
        if self.preconditioner is not None:
            M = make_preconditioner(self.preconditioner, dom, device=self.device)
            Mp = PaddedPreconditioner(inner=M, padded_op=pop)
            if self.precision == "mixed":
                # FMG payload: the problem rediscretised on each coarse level
                Mp = _attach_fmg(Mp, self.problem)
        return pop, Mp

    def solve(self) -> SolverResults:
        dom = self.domain
        if self._parts is None:
            self._parts = self._build_parts()
        pop, Mp = self._parts
        b = self.problem.rhs_field(torch.float64, self.device)
        u = (
            self.problem.true_solution_field(torch.float64, self.device)
            if self.problem.u_exact is not None
            else None
        )
        if self.precision == "mixed" and self.is3d:
            res = device_refined_solve(
                _padded_hi_operator(pop), pop, pop.pad(b), preconditioner=Mp,
                u_true=None if u is None else pop.pad(u), stop=self.stop, fmg=self.fmg_cycles,
                ff=self.outer_kind == "ff",
            )
            x = pop.crop(res.x)
            r = b - StencilOperator.from_domain(dom)(x)
        elif self.precision == "mixed":
            res = fused_refined_solve(pop, Mp, b, u_true=u, stop=self.stop,
                                      fmg=self.fmg_cycles, ff=self.outer_kind == "ff")
            x = res.x
            r = b - StencilOperator.from_domain(dom)(x)
        else:
            opts = CGOptions(stop=self.stop, preconditioner=Mp, record_history=True)
            res = fused_cg_solve(pop, b, u_true=u, options=opts)
            x = res.x.to(torch.float64)
            # final residual through the stencil kernel, as the JAX facade does
            r = b - pop.crop(pop(pop.pad(res.x))).to(torch.float64)
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
        idx = np.nonzero(dom.interior)  # ([iz,] iy, ix), row-major as the solution
        iy, ix = idx[-2], idx[-1]
        zs = dom.z0 + idx[0] * dom.hz if self.is3d else None
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
            bounds=(dom.x0, dom.x1, dom.y0, dom.y1)
            + ((dom.z0, dom.z1) if self.is3d else ()),
            eps=min(eps_active) if eps_active else -1.0,
            max_iterations=self.stop.max_iterations,
            history=res.history,
            shape=getattr(dom, "shape", ""),
            outer_iterations=getattr(res, "outer_iterations", 0),
            z_coords=zs,
            nz=getattr(dom, "nz", 0),
            interior_mask=dom.interior if getattr(dom, "shape", "") == "custom" else None,
        )

"""High-level facade (counterpart of iterative_solvers_tpu/api.py).

``DirichletSolver`` configures a Dirichlet–Poisson problem on a 2D domain
(gamma, rect, custom) or a 3D box, solves it and returns
:class:`SolverResults` in the compacted unknown ordering. Every option
combination of the JAX facade without a mesh runs, with the JAX facade's
validation messages:

- ``precision=None``: (preconditioned) CG in ``dtype`` on the operator
  ``operator`` names — ``"stencil"`` (the plain masked stencil, full-grid
  fields), ``"sparse"`` (a CSR matrix over compacted vectors), ``"pallas"``
  (the padded layout on the stencil kernel: A1/C1 in 2D, S7 in 3D) or
  ``"fused"`` (2D: the fused f32 engine, K1 + K2/K2-pcg, the reference
  algorithm) — with ``preconditioner`` none, ``"jacobi"``,
  ``"chebyshev[:m]"`` or ``"mg[:nu]"`` (on ``"pallas"`` the V-cycle runs
  behind a ``PaddedPreconditioner``, its fused legs on the card).
- ``precision="mixed"`` (``operator="stencil"``): iterative refinement, an
  f64 or double-f32 outer (``outer``) around f32 inner PCG. With
  ``preconditioner="mg"`` the JAX package's default solve: in 2D
  :func:`~iterative_solvers_tpu_torch.solvers.refine.fused_refined_solve`
  (the FMG warm start, the fused engine and V-cycle), in 3D
  :func:`~iterative_solvers_tpu_torch.solvers.refine.device_refined_solve`
  on the padded 7-point operator (the JAX facade runs its 3D solve on the
  unpadded operator; the port takes the bench's route so the kernels carry
  it). With any other preconditioner or none, ``device_refined_solve`` on
  the plain stencil, as the JAX facade's device ladder. With a
  ``callback``, any preconditioner runs the host ladder
  :func:`~iterative_solvers_tpu_torch.solvers.refine.refined_solve`, as in
  JAX.

A custom-mask domain (``Domain2D(shape="custom", inside_fn=...)``) runs
every path with the same modules, its kernels taking the int8 mask operand;
its results carry ``interior_mask``, as the JAX package's do.

``solve(callback=...)`` receives ``(k, prec∞, r∞, err∞)`` at the JAX
driver's cadence; :meth:`DirichletSolver.request_stop` interrupts a
chunked solve at its next chunk (INTERRUPTED). ``device="cuda"`` (the
default) launches the hand-written kernels and raises if there is no card;
``device="cpu"`` runs their plain torch versions. Nothing falls back from
one to the other.

With a mesh (``mesh=``, a :class:`~iterative_solvers_tpu_torch.parallel.
mesh.SolverMesh` over the ranks of a ``torch.distributed`` group; every
rank constructs the same solver and calls ``solve``) each rank holds one
block of every field, on the JAX facade's mesh routes:

- ``precision=None``: CG on ``operator="stencil"`` (the halo stencil,
  any domain, f64 by default) or ``"pallas"`` (the block kernels: D1 on a
  Г/rect domain, D2 on the box; f32), with no preconditioner, Jacobi,
  Chebyshev or ``"mg"`` — on ``"pallas"`` in 2D the shard-fused V-cycle
  (D3, D4), otherwise the plain V-cycle on the gathered field; and
  ``operator="fused"`` (2D), the sharded fused engine (D5, D6:
  :class:`~iterative_solvers_tpu_torch.parallel.cg_fused_sharded.
  ShardedFusedCGEngine`, driven as ``sharded_fused_cg_solve`` drives it
  but with x kept as this rank's block), plain or with the shard-fused
  V-cycle;
- ``precision="mixed"``: the f64 outer (``outer="ff"`` is rejected with a
  mesh, as in JAX) through the halo stencil, around f32 inners on the mesh
  operator. ``operator="pallas"`` or ``"fused"`` with ``"mg"`` in 2D is
  the engine ladder, :func:`~iterative_solvers_tpu_torch.solvers.refine.
  engine_refined_solve` on the sharded fused engine and the shard-fused
  V-cycle with its FMG warm start; the other routes run
  ``device_refined_solve``. With a ``callback``, any route runs the host
  ladder ``refined_solve``.

The results are gathered: every rank returns the whole solution.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from iterative_solvers_tpu_torch.core import ordering
from iterative_solvers_tpu_torch.core.domain import Domain2D, Domain3D, resolve_device
from iterative_solvers_tpu_torch.core.problem import PoissonProblem
from iterative_solvers_tpu_torch.kernels.cg_fused import fused_cg_solve, run_fused_solve
from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.ops.sparse import SparseOperator
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
from iterative_solvers_tpu_torch.parallel import mesh as mesh_lib
from iterative_solvers_tpu_torch.parallel.cg_fused_sharded import ShardedFusedCGEngine
from iterative_solvers_tpu_torch.parallel.halo import ShardedStencilOperator
from iterative_solvers_tpu_torch.parallel.halo_pallas import (
    ShardedPallas3DStencilOperator,
    ShardedPallasStencilOperator,
)
from iterative_solvers_tpu_torch.parallel.mg_sharded import ShardedFusedMultigrid
from iterative_solvers_tpu_torch.solvers.cg import CGOptions, cg_solve
from iterative_solvers_tpu_torch.solvers.multigrid import (
    MultigridPreconditioner,
    PaddedPreconditioner,
    ShardedMultigridPreconditioner,
)
from iterative_solvers_tpu_torch.solvers.precond import (
    make_preconditioner,
    parse_preconditioner,
)
from iterative_solvers_tpu_torch.solvers.refine import (
    _maybe_fmg_x0,
    _padded_hi_operator,
    device_refined_solve,
    engine_refined_solve,
    fused_refined_solve,
    refined_solve,
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
    iterations: int  # total (inner) CG iterations
    converged: bool
    stop_reason: StopReason
    residual_norm: float  # ‖r‖∞
    error_norm: float  # ‖x−u‖∞
    precision_norm: float  # ‖x_k − x_{k−1}‖∞ at the last step
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
        return ordering.unpack(np.asarray(self.solution, np.float64), domain)


def _attach_fmg(M, problem):
    """Attach the FMG payload (:meth:`MultigridPreconditioner.with_fmg`) to
    the multigrid inside adapter ``M`` (padded, sharded or shard-fused);
    anything else passes through."""
    if isinstance(M, (PaddedPreconditioner, ShardedMultigridPreconditioner)):
        return dataclasses.replace(M, inner=_attach_fmg(M.inner, problem))
    if isinstance(M, MultigridPreconditioner) and M.domains:
        return M.with_fmg(problem)
    if isinstance(M, ShardedFusedMultigrid):
        return M.with_fmg(problem)
    return M


class DirichletSolver:
    """Dirichlet–Poisson solver on a gamma/rect/custom 2D domain or a 3D box.

    ``DirichletSolver(nx=30, ny=30, device=...)`` is the reference's GUI
    default: the Г-domain on [1,2]², eps 1e-6 on precision and residual,
    at most 10000 iterations, CG on the plain stencil in f64.

    ``dtype``: the field type of a ``precision=None`` solve. ``None`` means
    what the JAX package picks under x64 (its tests' and its mixed path's
    setting): f64 for ``"stencil"``, ``"sparse"`` and ``"fused"`` (whose
    engine computes in f32 whatever ``b`` is), f32 for ``"pallas"``, whose
    kernels take f32 only — ``"pallas"`` with f64 raises. ``outer='auto'``
    means :data:`AUTO_OUTER` of the domain's dimension, chosen by
    measurement on the card (the JAX package's 'auto' picks ff on a TPU).
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
        dtype: Optional[torch.dtype] = None,
        stop: Optional[StopConfig] = None,
        beta_kind: str = "msg",
        preconditioner: Optional[str] = None,
        precision: Optional[str] = None,
        mesh=None,
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
        self.dtype = dtype
        self.stop = stop or StopConfig()
        self.beta_kind = beta_kind
        self.preconditioner = preconditioner
        self.precision = precision
        self.mesh = mesh
        self.fmg_cycles = fmg_cycles
        self.outer = outer
        self._validate_config()
        self.device = resolve_device(device)
        self._stop_event = threading.Event()
        self._routes = {}  # route -> (operator, preconditioner), built on first use
        self._parts = None  # the (operator, preconditioner) of the last solve

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
        if self.beta_kind not in ("msg", "fr"):
            raise ValueError(f"unknown beta_kind {self.beta_kind!r} (use 'msg' or 'fr')")
        if operator == "fused":
            if self.is3d:
                raise ValueError("operator='fused' is 2D-only; use operator='pallas' for 3D")
            if self.beta_kind != "msg":
                raise ValueError(
                    "the fused engine implements the MSG recurrence only (beta_kind='msg')"
                )
        if self.preconditioner is not None:
            kind, _ = parse_preconditioner(self.preconditioner)
            if kind == "mg" and operator == "sparse":
                raise ValueError(
                    "preconditioner='mg' needs grid-shaped fields, but operator='sparse' works "
                    "on compacted vectors — use operator='stencil' or 'pallas'"
                )
            if operator == "fused" and kind != "mg":
                raise ValueError(
                    "operator='fused' supports preconditioner='mg[:nu]' only (the fused PCG "
                    "engine folds the V-cycle between its two kernels; use operator='pallas' "
                    "for jacobi/chebyshev PCG)"
                )
        if self.precision not in (None, "mixed"):
            raise ValueError(f"unknown precision {self.precision!r} (use None or 'mixed')")
        if self.outer not in ("auto", "f64", "ff"):
            raise ValueError(f"unknown outer {self.outer!r} (use 'auto', 'f64' or 'ff')")
        if self.outer == "ff" and self.precision != "mixed":
            raise ValueError(
                "outer='ff' selects the mixed ladder's outer arithmetic — it needs "
                "precision='mixed'"
            )
        if self.outer == "ff" and self.mesh is not None:
            raise ValueError(
                "outer='ff' is single-chip only: the sharded outer loops evaluate the true "
                "residual through the halo-exchange operator, which the double-f32 "
                "evaluation does not partition — use outer='auto' (ff where supported) or 'f64'"
            )
        if self.precision == "mixed" and operator != "stencil" and not (
                operator in ("pallas", "fused") and self.mesh is not None):
            raise ValueError(
                "precision='mixed' requires the matrix-free stencil operator (or "
                "operator='pallas'/'fused' with a mesh for the sharded fast path)"
            )
        if self.mesh is not None:
            if operator not in ("stencil", "pallas", "fused"):
                raise ValueError(
                    "mesh (distributed solve) requires operator='stencil' (halo exchange), "
                    "'pallas' (sharded kernel fast path) or 'fused' (sharded fused CG engine)"
                )
            if operator in ("pallas", "fused") and not self.is3d and self.domain.shape not in (
                    "gamma", "rect"):
                raise ValueError(
                    f"operator={operator!r} with a mesh needs a gamma/rect domain (algebraic "
                    "masks); use operator='stencil' for custom masks"
                )
        if not (isinstance(self.fmg_cycles, int) and self.fmg_cycles >= 0):
            raise ValueError(f"fmg_cycles must be an int >= 0, got {self.fmg_cycles!r}")
        if self.dtype not in (None, torch.float32, torch.float64):
            raise ValueError(f"dtype must be None, torch.float32 or torch.float64, got "
                             f"{self.dtype!r}")
        if operator == "pallas" and self.dtype == torch.float64:
            raise ValueError("operator='pallas' runs the f32 stencil kernels; use dtype=None or "
                             "torch.float32 (or operator='stencil' for f64)")

    @property
    def outer_kind(self) -> str:
        """The outer a mixed solve runs: 'f64' or 'ff' (a mesh's is f64)."""
        if self.outer == "auto":
            return "f64" if self.mesh is not None else AUTO_OUTER[3 if self.is3d else 2]
        return self.outer

    @property
    def field_dtype(self) -> torch.dtype:
        """The field type of a ``precision=None`` solve (the dtype rule)."""
        if self.dtype is not None:
            return self.dtype
        return torch.float32 if self.operator_kind == "pallas" else torch.float64

    def request_stop(self) -> None:
        """Cooperative interrupt: a chunked solve stops at its next chunk
        boundary with INTERRUPTED (a solve with a ``callback`` polls every
        ``callback_every`` iterations, the mixed ladder before each outer
        step). A mixed solve without a callback runs its ladder to the end,
        as the JAX package's one-dispatch ladder does."""
        self._stop_event.set()

    def _route(self, callback) -> str:
        if self.mesh is not None:
            if self.precision != "mixed":
                return "mesh"
            return "mesh_ladder" if callback is not None else "mesh_ir"
        if self.precision == "mixed":
            kind = parse_preconditioner(self.preconditioner)[0] if self.preconditioner else None
            if callback is not None:
                return "ladder"  # the host ladder, any preconditioner
            if kind == "mg":
                return "padded3d" if self.is3d else "fused_ir"
            return "generic_ir"
        return self.operator_kind

    def _build(self, route: str):
        """(operator, preconditioner) of one route."""
        if route.startswith("mesh"):
            return self._build_mesh()
        dom = self.domain
        layout = Padded3DStencilOperator if self.is3d else PaddedStencilOperator
        if route in ("fused_ir", "padded3d", "pallas", "fused"):
            A = layout.from_domain(dom)
        elif route == "sparse":
            A = SparseOperator.from_domain(dom, self.field_dtype, self.device)
        else:
            A = StencilOperator.from_domain(dom)
        if self.preconditioner is None:
            return A, None
        M = make_preconditioner(self.preconditioner, A, dom, device=self.device)
        if isinstance(M, MultigridPreconditioner) and route not in ("stencil", "ladder"):
            # the multigrid works on unpadded grids: adapt it to the padded layout
            M = PaddedPreconditioner(inner=M, padded_op=A)
        if self.precision == "mixed":
            # FMG payload: the problem rediscretised on each coarse level
            M = _attach_fmg(M, self.problem)
        return A, M

    def _build_mesh(self):
        """(operator, preconditioner) on the mesh, as the JAX facade builds
        them: the shard-fused V-cycle behind ``operator="pallas"`` in 2D,
        the plain V-cycle on the gathered field otherwise."""
        dom, mesh = self.domain, self.mesh
        if self.operator_kind in ("pallas", "fused"):
            layout = ShardedPallas3DStencilOperator if self.is3d else ShardedPallasStencilOperator
            A = layout.from_domain(dom, mesh)
        else:
            A = ShardedStencilOperator.from_domain(dom, mesh)
        M = None
        if self.preconditioner is not None:
            kind, param = parse_preconditioner(self.preconditioner)
            if kind != "mg":
                M = make_preconditioner(self.preconditioner, A, dom, device=self.device)
            elif self.operator_kind in ("pallas", "fused") and not self.is3d:
                M = ShardedFusedMultigrid.from_operator(A, dom, nu_pre=param or 1,
                                                        nu_post=param or 1, device=self.device)
            else:
                M = ShardedMultigridPreconditioner.from_domain(
                    dom, mesh, nu_pre=param or 1, nu_post=param or 1, device=self.device)
            if self.precision == "mixed":
                M = _attach_fmg(M, self.problem)
        return A, M

    @staticmethod
    def _hi_operator(A):
        """The f64 twin of a mesh operator on its own layout (the halo
        stencil); the halo stencil is its own twin."""
        if isinstance(A, ShardedPallasStencilOperator):
            kind, dims = A.mask_mode, (A.nx, A.ny)
        elif isinstance(A, ShardedPallas3DStencilOperator):
            kind, dims = "box3", (A.nx, A.ny, A.nz)
        else:
            return A
        return ShardedStencilOperator(A.mesh, A.coeffs, A.grid_shape, A.padded_shape, kind,
                                      dims)

    def _solve_mesh(self, route, A, M, callback, opts_kw):
        """One solve over the mesh; returns (result, global x, global r, u)."""
        mesh, dev = self.mesh, self.device
        dom = self.domain
        has_u = self.problem.u_exact is not None

        def shard(f):
            return A.shard(f) if hasattr(A, "shard") else mesh_lib.shard_field(f, mesh)

        if self.precision == "mixed":
            dtype = torch.float64
            b = self.problem.rhs_field(dtype, dev)
            u = self.problem.true_solution_field(dtype, dev) if has_u else None
            bs, us = shard(b), (shard(u) if has_u else None)
            A_hi = self._hi_operator(A)
            if route == "mesh_ladder":
                res = refined_solve(A_hi, A, bs, u_true=us, stop=self.stop, preconditioner=M,
                                    callback=callback, stop_requested=self._stop_event.is_set,
                                    x0=_maybe_fmg_x0(M, self.fmg_cycles, bs))
            elif isinstance(M, ShardedFusedMultigrid):
                # the engine ladder: the sharded fused engine (D5, D6) inside
                res = engine_refined_solve(ShardedFusedCGEngine(A, M), A_hi, bs, u_true=us,
                                           stop=self.stop, fmg=self.fmg_cycles)
            else:
                res = device_refined_solve(A_hi, A, bs, preconditioner=M, u_true=us,
                                           stop=self.stop, fmg=self.fmg_cycles)
            r = bs - A_hi(res.x)
        else:
            dtype = self.field_dtype
            b = self.problem.rhs_field(dtype, dev)
            u = self.problem.true_solution_field(dtype, dev) if has_u else None
            opts = CGOptions(preconditioner=M, **opts_kw)
            bs, us = shard(b), (shard(u) if has_u else None)
            if self.operator_kind == "fused":
                # the sharded fused engine (D5, D6); x stays this rank's block
                res = run_fused_solve(ShardedFusedCGEngine(A, M), b, u, opts, lay=A.shard,
                                      unlay=lambda x: x)
            else:
                res = cg_solve(A, bs, u_true=us, options=opts)
            r = bs - A(res.x)

        def gathered(block):
            return mesh_lib.crop_field(mesh.gather(block), dom.grid_shape)

        return res, gathered(res.x), gathered(r), u

    def solve(
        self,
        callback: Optional[Callable[[int, float, float, float], None]] = None,
        completion_callback: Optional[Callable[[bool, str], None]] = None,
        record_history: bool = True,
        callback_every: int = 100,
        state_callback: Optional[Callable] = None,
    ) -> SolverResults:
        self._stop_event.clear()
        if self.outer == "ff" and callback is not None:
            raise RuntimeError(
                "outer='ff' runs the whole ladder as one device program — live iteration "
                "callbacks need the host-chunked loop; use outer='auto'/'f64' with callbacks"
            )
        route = self._route(callback)
        if route not in self._routes:
            self._routes[route] = self._build(route)
        A, M = self._parts = self._routes[route]
        dev, f64 = self.device, torch.float64
        has_u = self.problem.u_exact is not None
        if route.startswith("mesh"):
            res, x, r, u = self._solve_mesh(route, A, M, callback, dict(
                stop=self.stop, beta_kind=self.beta_kind, callback=callback,
                callback_every=callback_every, stop_requested=self._stop_event.is_set,
                record_history=record_history, state_callback=state_callback,
            ))
        elif self.precision == "mixed":
            b = self.problem.rhs_field(f64, dev)
            u = self.problem.true_solution_field(f64, dev) if has_u else None
            ff = self.outer_kind == "ff"
            if route == "fused_ir":
                res = fused_refined_solve(A, M, b, u_true=u, stop=self.stop,
                                          fmg=self.fmg_cycles, ff=ff)
                x = res.x
            elif route == "padded3d":
                res = device_refined_solve(
                    _padded_hi_operator(A), A, A.pad(b), preconditioner=M,
                    u_true=None if u is None else A.pad(u), stop=self.stop,
                    fmg=self.fmg_cycles, ff=ff,
                )
                x = A.crop(res.x)
            elif route == "ladder":
                res = refined_solve(A, A, b, u_true=u, stop=self.stop, preconditioner=M,
                                    callback=callback, stop_requested=self._stop_event.is_set,
                                    x0=_maybe_fmg_x0(M, self.fmg_cycles, b))
                x = res.x
            else:
                res = device_refined_solve(A, A, b, preconditioner=M, u_true=u, stop=self.stop,
                                           fmg=self.fmg_cycles, ff=ff)
                x = res.x
            r = b - StencilOperator.from_domain(self.domain)(x)
        else:
            b = self.problem.rhs_field(self.field_dtype, dev)
            u = self.problem.true_solution_field(self.field_dtype, dev) if has_u else None
            opts = CGOptions(
                stop=self.stop, beta_kind=self.beta_kind, preconditioner=M, callback=callback,
                callback_every=callback_every, stop_requested=self._stop_event.is_set,
                record_history=record_history, state_callback=state_callback,
            )
            if route == "fused":
                res = fused_cg_solve(A, b, u_true=u, options=opts)
                x = res.x
                # the final residual through the stencil kernel, as the JAX facade does
                r = b - A.crop(A(A.pad(x))).to(b.dtype)
            elif route == "pallas":
                bp = A.pad(b)
                res = cg_solve(A, bp, u_true=None if u is None else A.pad(u), options=opts)
                x, r = A.crop(res.x), A.crop(bp - A(res.x))
            elif route == "sparse":
                b, u = ordering.pack(b, self.domain), (ordering.pack(u, self.domain)
                                                       if has_u else None)
                res = cg_solve(A, b, u_true=u, options=opts)
                x = res.x
                r = b - A(x)
            else:
                res = cg_solve(A, b, u_true=u, options=opts)
                x = res.x
                r = b - A(x)
        results = self._assemble_results(res, x, r, u)
        if completion_callback is not None:
            completion_callback(results.converged, results.stop_reason.text())
        return results

    def _assemble_results(self, res, x, r, u) -> SolverResults:
        dom = self.domain
        if self.operator_kind != "sparse" or self.precision == "mixed":
            x, r = ordering.pack(x, dom), ordering.pack(r, dom)
            u = ordering.pack(u, dom) if u is not None else None
        sol = x.cpu().numpy().astype(np.float64)
        resid = r.cpu().numpy().astype(np.float64)
        if u is not None:
            tru = u.cpu().numpy().astype(np.float64)
            err = sol - tru
        else:
            tru = err = np.zeros(0)
        coords = ordering.node_coordinates(dom)
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
            x_coords=coords[0],
            y_coords=coords[1],
            iterations=res.iterations,
            converged=res.converged,
            stop_reason=res.reason,
            residual_norm=float(np.max(np.abs(resid))) if resid.size else 0.0,
            error_norm=float(np.max(np.abs(err))) if err.size else float("inf"),
            precision_norm=res.precision_max,
            elapsed_s=res.elapsed_s,
            nx=dom.nx,
            ny=dom.ny,
            bounds=(dom.x0, dom.x1, dom.y0, dom.y1) + ((dom.z0, dom.z1) if self.is3d else ()),
            eps=min(eps_active) if eps_active else -1.0,
            max_iterations=self.stop.max_iterations,
            history=res.history,
            shape=getattr(dom, "shape", ""),
            outer_iterations=getattr(res, "outer_iterations", 0),
            z_coords=coords[2] if self.is3d else None,
            nz=getattr(dom, "nz", 0),
            interior_mask=dom.interior if getattr(dom, "shape", "") == "custom" else None,
        )

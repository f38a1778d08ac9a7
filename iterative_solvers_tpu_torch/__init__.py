"""PyTorch/CUDA port of iterative_solvers_tpu: the Dirichlet–Poisson
solvers on hand-written Hopper kernels, with the JAX package's front-ends.

Exports the JAX package's top-level names: the domains and the problem
(``Domain2D``, ``Domain3D``, ``PoissonProblem``), the matrix-free stencil
(``StencilOperator``, ``stencil_apply``), the stop criteria (``StopReason``,
``StopConfig``), conjugate gradients (``CGOptions``, ``CGResult``,
``cg_solve``), the multigrid preconditioner (``MultigridPreconditioner``),
mixed-precision refinement (``RefinedResult``, ``refined_solve``), the
facade (``DirichletSolver``, ``SolverResults``), the threaded driver
(``AsyncSolver``), the configuration (``SolveConfig``) and the profiler
(``Profiler``); besides them ``MaskSpec`` and ``__version__``. The CLI is
``python -m iterative_solvers_tpu_torch``.

Imports torch and numpy only — never jax or the JAX package, which stays the
reference the port is tested against.
"""

from iterative_solvers_tpu_torch.api import DirichletSolver, SolverResults
from iterative_solvers_tpu_torch.async_driver import AsyncSolver
from iterative_solvers_tpu_torch.config import SolveConfig
from iterative_solvers_tpu_torch.core.domain import Domain2D, Domain3D, MaskSpec
from iterative_solvers_tpu_torch.core.problem import PoissonProblem
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator, stencil_apply
from iterative_solvers_tpu_torch.profiling import Profiler
from iterative_solvers_tpu_torch.solvers.cg import CGOptions, CGResult, cg_solve
from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner
from iterative_solvers_tpu_torch.solvers.refine import RefinedResult, refined_solve
from iterative_solvers_tpu_torch.solvers.stopping import StopConfig, StopReason

__version__ = "0.1.0"

__all__ = [
    "Domain2D",
    "Domain3D",
    "PoissonProblem",
    "StencilOperator",
    "stencil_apply",
    "StopReason",
    "StopConfig",
    "CGOptions",
    "CGResult",
    "cg_solve",
    "MultigridPreconditioner",
    "RefinedResult",
    "refined_solve",
    "DirichletSolver",
    "SolverResults",
    "AsyncSolver",
    "SolveConfig",
    "Profiler",
    "MaskSpec",
    "__version__",
]

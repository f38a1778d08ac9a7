"""PyTorch/CUDA port of iterative_solvers_tpu: the mixed-precision multigrid
PCG solve on hand-written Hopper kernels.

Imports torch and numpy only — never jax or the JAX package, which stays the
reference the port is tested against.
"""

from iterative_solvers_tpu_torch.api import DirichletSolver, SolverResults
from iterative_solvers_tpu_torch.core.domain import Domain2D, Domain3D, MaskSpec
from iterative_solvers_tpu_torch.core.problem import PoissonProblem
from iterative_solvers_tpu_torch.solvers.stopping import StopConfig, StopReason

__all__ = [
    "DirichletSolver",
    "Domain2D",
    "Domain3D",
    "MaskSpec",
    "PoissonProblem",
    "SolverResults",
    "StopConfig",
    "StopReason",
]

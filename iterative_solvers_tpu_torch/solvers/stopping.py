"""Stop criteria (counterpart of iterative_solvers_tpu/solvers/stopping.py).

Same enum values and the same eps <= 0 disables convention, so reasons
compare by integer code across the two packages."""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class StopReason(IntEnum):
    ITERATIONS = 0
    PRECISION = 1
    RESIDUAL = 2
    EXACT_ERROR = 3
    INTERRUPTED = 4
    RELATIVE_RESIDUAL = 5
    DIVERGED = 6  # non-finite residual

    @property
    def converged(self) -> bool:
        """Only criterion-met stops count as converged."""
        return self in (
            StopReason.PRECISION,
            StopReason.RESIDUAL,
            StopReason.EXACT_ERROR,
            StopReason.RELATIVE_RESIDUAL,
        )


@dataclass(frozen=True)
class StopConfig:
    """Epsilons <= 0 disable a criterion; defaults as in the JAX package."""

    eps_precision: float = 1e-6
    eps_residual: float = 1e-6
    eps_exact_error: float = -1.0
    eps_relative: float = -1.0
    max_iterations: int = 10000

    def __post_init__(self) -> None:
        if self.max_iterations < 1:
            raise ValueError("max_iterations must be >= 1")

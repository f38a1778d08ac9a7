"""Stop criteria (counterpart of the JAX package's solvers/stopping.py).

Same enum values and the same eps <= 0 disables convention, so reasons
compare by integer code across the two packages."""

from __future__ import annotations

from dataclasses import dataclass, replace
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

    def text(self) -> str:
        """The stop reason in words, as the JAX package gives it."""
        return {
            StopReason.ITERATIONS: "iteration limit reached",
            StopReason.PRECISION: "step precision ||x(n)-x(n-1)||_inf below eps",
            StopReason.RESIDUAL: "residual ||Ax-b||_inf below eps",
            StopReason.EXACT_ERROR: "exact error ||x-u||_inf below eps",
            StopReason.INTERRUPTED: "interrupted by user",
            StopReason.RELATIVE_RESIDUAL: "relative residual ||r||_2/||r0||_2 below eps",
            StopReason.DIVERGED: "diverged: residual became non-finite",
        }[self]


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

    @property
    def any_enabled(self) -> bool:
        """Whether any eps criterion is on (else only max_iterations stops)."""
        return (self.eps_precision > 0 or self.eps_residual > 0 or self.eps_exact_error > 0
                or self.eps_relative > 0)

    def disable_all_but_iterations(self) -> "StopConfig":
        return replace(self, eps_precision=-1.0, eps_residual=-1.0, eps_exact_error=-1.0,
                       eps_relative=-1.0)

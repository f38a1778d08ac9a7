"""Preconditioners for CG (counterpart of iterative_solvers_tpu/solvers/precond.py).

Each is a callable from a residual field to a preconditioned field, on
whatever layout its operator works on (full grid, padded canvas or
compacted vector):

- :class:`JacobiPreconditioner`: ``z = r / diag(A)``. The Laplacian's
  diagonal is constant, so with a domain it is one scaling, which leaves
  the CG iterates unchanged; without one it divides by ``A.diagonal()``.
- :class:`ChebyshevPreconditioner`: ``z = p_m(A) r``, m steps of Chebyshev
  iteration on ``A z = r`` from zero over the interval of
  :func:`spectral_bounds` — a fixed polynomial in ``A``, so symmetric. It
  applies ``A`` itself, whatever operator that is: on the padded layout on a
  card, the stencil kernel.
- the multigrid V-cycle (``"mg[:nu]"``,
  :class:`~iterative_solvers_tpu_torch.solvers.multigrid.MultigridPreconditioner`).

The axpys are torch ops, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from iterative_solvers_tpu_torch.core.domain import Domain3D


@dataclass(frozen=True, eq=False)
class JacobiPreconditioner:
    A: Callable
    inv_diag: Optional[float]  # the constant-diagonal fast path

    @staticmethod
    def from_operator(A, domain=None) -> "JacobiPreconditioner":
        return JacobiPreconditioner(A, 1.0 / domain.coeff_diag if domain is not None else None)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if self.inv_diag is not None:
            return r * self.inv_diag
        d = self.A.diagonal(r.device).to(r.dtype)
        nz = d != 0
        return torch.where(nz, r / torch.where(nz, d, 1.0), 0.0)


def spectral_bounds(domain) -> Tuple[float, float]:
    """An interval [lam_lo, lam_hi] (both negative) enclosing the spectrum
    of the assembled operator: Gershgorin's 2·diag, and the continuous
    fundamental Dirichlet eigenvalue of the enclosing box, ``−π²·Σ 1/L²``;
    on the square Г-shape the L-shaped domain's 9.6397/(L/2)², times 0.98."""
    lam_lo = 2.0 * domain.coeff_diag
    lx = domain.x1 - domain.x0
    ly = domain.y1 - domain.y0
    if isinstance(domain, Domain3D):
        lz = domain.z1 - domain.z0
        return lam_lo, -(math.pi**2) * (1 / lx**2 + 1 / ly**2 + 1 / lz**2)
    if getattr(domain, "shape", "rect") == "gamma" and abs(lx - ly) < 1e-12:
        return lam_lo, -0.98 * 9.6397 / (lx / 2.0) ** 2
    return lam_lo, -(math.pi**2) * (1 / lx**2 + 1 / ly**2)


def chebyshev_apply(A: Callable, r: torch.Tensor, lam_lo: float, lam_hi: float,
                    degree: int) -> torch.Tensor:
    """``degree`` Chebyshev steps on ``A z = r`` from ``z = 0``."""
    theta = 0.5 * (lam_hi + lam_lo)  # interval centre
    delta = 0.5 * (lam_hi - lam_lo)  # half-width
    sigma1 = theta / delta
    z = r / theta
    d = z
    rho_prev = 1.0 / sigma1
    for _ in range(degree):
        rho = 1.0 / (2.0 * sigma1 - rho_prev)
        resid = r - A(z)
        d = (rho * rho_prev) * d + (2.0 * rho / delta) * resid
        z = z + d
        rho_prev = rho
    return z


@dataclass(frozen=True, eq=False)
class ChebyshevPreconditioner:
    """``z = p_m(A) r``: m Chebyshev steps on ``A z = r`` from zero."""

    A: Callable
    lam_lo: float
    lam_hi: float
    degree: int = 4

    @staticmethod
    def from_domain(A, domain, degree: int = 4) -> "ChebyshevPreconditioner":
        lo, hi = spectral_bounds(domain)
        return ChebyshevPreconditioner(A, lo, hi, degree)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return chebyshev_apply(self.A, r, self.lam_lo, self.lam_hi, self.degree)


def parse_preconditioner(name: str) -> Tuple[str, int]:
    """Validate a spec string and return (kind, param); param 0 = default."""
    base, _, arg = name.partition(":")
    try:
        param = int(arg) if arg else 0
    except ValueError:
        raise ValueError(f"non-integer parameter in preconditioner spec {name!r}")
    if param < 0:
        raise ValueError(f"negative parameter in preconditioner spec {name!r}")
    if base in ("jacobi", "diag"):
        if arg:
            raise ValueError(f"'jacobi' takes no parameter (got {name!r})")
        return "jacobi", 0
    if base == "chebyshev":
        return "chebyshev", param
    if base in ("mg", "multigrid"):
        return "mg", param
    raise ValueError(
        f"unknown preconditioner {name!r} (use 'jacobi', 'chebyshev[:m]' or 'mg[:nu]')"
    )


def make_preconditioner(name: str, A, domain, device="cuda"):
    """The preconditioner a spec names, for operator ``A`` on ``domain``
    (a :class:`Domain2D` or :class:`Domain3D`): Jacobi and Chebyshev (degree
    ``m``, default 4) on ``A``'s own layout; the multigrid (``nu`` sweeps,
    default 1) on the unpadded grid, built for ``device`` (``"cuda"``
    raises without a card)."""
    kind, param = parse_preconditioner(name)
    if kind == "jacobi":
        return JacobiPreconditioner.from_operator(A, domain)
    if kind == "chebyshev":
        return ChebyshevPreconditioner.from_domain(A, domain, param or 4)
    from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner

    nu = param or 1
    return MultigridPreconditioner.from_domain(domain, nu_pre=nu, nu_post=nu, device=device)

"""Poisson problem and RHS assembly (counterpart of iterative_solvers_tpu/core/problem.py).

The system is the discrete Laplacian itself, ``A u = f``, with Dirichlet
values eliminated into the RHS: for an interior node next to a boundary node,
``rhs -= coeff * g(neighbor)``. Fields are assembled with torch on the
requested device, in f64, then cast — at 8192² that is a few element-wise
sweeps on the card instead of a host sweep plus a 0.5 GB copy. ``device``
defaults to ``"cuda"`` (raising without a card); pass ``"cpu"`` for the CPU.

The RHS subtracts the Dirichlet terms axis by axis, y then x, as the JAX
package's in-trace assembly (``rhs_field_traced``) does: that is what it
runs on an accelerator and for its FMG payload's coarse levels, so the
rounded f32 level fields match it bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from iterative_solvers_tpu_torch.core.domain import Domain2D, resolve_device


def _reference_f(x, y):
    """Manufactured source f = 4(x²+y²)·exp(x²−y²)."""
    return 4.0 * (x * x + y * y) * torch.exp(x * x - y * y)


def _reference_u(x, y):
    """Manufactured exact solution u = exp(x²−y²)."""
    return torch.exp(x * x - y * y)


def _coords(dom: Domain2D, device):
    """Full-grid (X, Y) coordinate tensors in f64, ``x0 + i·hx`` as in the
    JAX package (so both sides sample the same points)."""
    f64 = torch.float64
    x = dom.x0 + torch.arange(dom.nx + 1, dtype=f64, device=device) * dom.hx
    y = dom.y0 + torch.arange(dom.ny + 1, dtype=f64, device=device) * dom.hy
    shape = dom.grid_shape
    return x[None, :].expand(shape), y[:, None].expand(shape)


@dataclass(frozen=True)
class PoissonProblem:
    """``Δu = f`` on ``domain`` with Dirichlet data ``g`` (default: u_exact)."""

    domain: Domain2D
    f: Callable = _reference_f
    g: Optional[Callable] = None
    u_exact: Optional[Callable] = _reference_u

    @staticmethod
    def manufactured(domain: Domain2D) -> "PoissonProblem":
        """u = exp(x²−y²) on the domain (the reference's canonical problem)."""
        return PoissonProblem(domain)

    @property
    def dirichlet(self) -> Callable:
        if self.g is not None:
            return self.g
        if self.u_exact is None:
            raise ValueError("no Dirichlet data: provide g or u_exact")
        return self.u_exact

    def boundary_field(self, dtype=torch.float64, device="cuda") -> torch.Tensor:
        """Dirichlet data on boundary nodes, zero elsewhere."""
        device = resolve_device(device)
        X, Y = _coords(self.domain, device)
        G = torch.where(self.domain.boundary_on(device), self.dirichlet(X, Y), 0.0)
        return G.to(dtype)

    def rhs_field(self, dtype=torch.float64, device="cuda") -> torch.Tensor:
        """Full-grid RHS with the boundary eliminated, zero off the interior."""
        device = resolve_device(device)
        dom = self.domain
        X, Y = _coords(dom, device)
        G = self.boundary_field(torch.float64, device)
        p = torch.nn.functional.pad(G, (1, 1, 1, 1))
        rhs = self.f(X, Y)
        rhs = rhs - dom.coeff_y * (p[:-2, 1:-1] + p[2:, 1:-1])
        rhs = rhs - dom.coeff_x * (p[1:-1, :-2] + p[1:-1, 2:])
        return torch.where(dom.interior_on(device), rhs, 0.0).to(dtype)

    def true_solution_field(
        self, dtype=torch.float64, device="cuda", masked: bool = True
    ) -> torch.Tensor:
        """u_exact on the grid, interior-masked by default."""
        if self.u_exact is None:
            raise ValueError("problem has no exact solution")
        device = resolve_device(device)
        X, Y = _coords(self.domain, device)
        U = self.u_exact(X, Y)
        if masked:
            U = torch.where(self.domain.interior_on(device), U, 0.0)
        return U.to(dtype)

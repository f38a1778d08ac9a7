"""Poisson problem and RHS assembly (counterpart of the JAX package's core/problem.py).

The system is the discrete Laplacian itself, ``A u = f``, with Dirichlet
values eliminated into the RHS: for an interior node next to a boundary node,
``rhs -= coeff * g(neighbor)``. Fields are assembled with torch on the
requested device, in f64, then cast — at 8192² that is a few element-wise
sweeps on the card instead of a host sweep plus a 0.5 GB copy. ``device``
defaults to ``"cuda"`` (raising without a card); pass ``"cpu"`` for the CPU.

The 2D RHS subtracts the Dirichlet terms axis by axis, y then x, as the JAX
package's in-trace assembly (``rhs_field_traced``) does: that is what it
runs on an accelerator and for its FMG payload's coarse levels, so the
rounded f32 level fields match it bit for bit. The 3D RHS (:class:`Domain3D`,
u = exp(xyz)) keeps the f64 term order of the JAX package's host assembly
(``_rhs_field_3d``): x, then y, then z.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

from iterative_solvers_tpu_torch.core.domain import Domain2D, Domain3D, resolve_device


def _reference_f(x, y):
    """Manufactured source f = 4(x²+y²)·exp(x²−y²)."""
    return 4.0 * (x * x + y * y) * torch.exp(x * x - y * y)


def _reference_u(x, y):
    """Manufactured exact solution u = exp(x²−y²)."""
    return torch.exp(x * x - y * y)


def _reference_f3(x, y, z):
    """3D manufactured source for u = exp(xyz): Δu = ((yz)²+(xz)²+(xy)²)·u."""
    return ((y * z) ** 2 + (x * z) ** 2 + (x * y) ** 2) * _reference_u3(x, y, z)


def _reference_u3(x, y, z):
    """3D manufactured exact solution u = exp(xyz)."""
    return torch.exp(x * y * z)


Domain = Union[Domain2D, Domain3D]


def _whole(dom: Domain, box):
    """``box`` (per field dim a ``(start, stop)`` range of node indices),
    the whole grid when None."""
    return tuple(box) if box is not None else tuple((0, s) for s in dom.grid_shape)


def _coords(dom: Domain, device, box=None):
    """Coordinate tensors (X, Y[, Z]) in f64 on ``box`` (the full grid by
    default), ``x0 + i·hx`` as in the JAX package (so both sides sample the
    same points)."""
    f64 = torch.float64
    axes = [(dom.x0, dom.hx), (dom.y0, dom.hy)]
    if isinstance(dom, Domain3D):
        axes.append((dom.z0, dom.hz))
    box = _whole(dom, box)
    shape = tuple(b - a for a, b in box)
    nd = len(shape)
    out = []
    for k, (o, h) in enumerate(axes):
        # axis k of the coordinate list is field axis nd-1-k (x is the last)
        a, b = box[nd - 1 - k]
        c = o + torch.arange(a, b, dtype=f64, device=device) * h
        out.append(c.view([-1 if i == nd - 1 - k else 1 for i in range(nd)]).expand(shape))
    return tuple(out)


@dataclass(frozen=True)
class PoissonProblem:
    """``Δu = f`` on ``domain`` with Dirichlet data ``g`` (default: u_exact)."""

    domain: Domain
    f: Callable = _reference_f
    g: Optional[Callable] = None
    u_exact: Optional[Callable] = _reference_u

    @staticmethod
    def manufactured(domain: Domain) -> "PoissonProblem":
        """u = exp(x²−y²) on a 2D domain (the reference's canonical problem);
        u = exp(xyz) on a 3D box, as in the JAX package."""
        if isinstance(domain, Domain3D):
            return PoissonProblem(domain, f=_reference_f3, u_exact=_reference_u3)
        return PoissonProblem(domain)

    @property
    def dirichlet(self) -> Callable:
        if self.g is not None:
            return self.g
        if self.u_exact is None:
            raise ValueError("no Dirichlet data: provide g or u_exact")
        return self.u_exact

    def boundary_field(self, dtype=torch.float64, device="cuda", box=None) -> torch.Tensor:
        """Dirichlet data on boundary nodes, zero elsewhere; on ``box`` (per
        field dim a ``(start, stop)`` range of node indices inside the grid:
        a mesh block's own nodes) or the full grid."""
        device = resolve_device(device)
        G = torch.where(self.domain.boundary_on(device, box),
                        self.dirichlet(*_coords(self.domain, device, box)), 0.0)
        return G.to(dtype)

    def rhs_field(self, dtype=torch.float64, device="cuda", box=None) -> torch.Tensor:
        """RHS with the boundary eliminated, zero off the interior, on the
        full grid or on ``box`` (as :meth:`boundary_field`): a box reads the
        Dirichlet data one node past its faces, zero off the grid, so every
        node gets the whole grid's value bit for bit."""
        device = resolve_device(device)
        dom = self.domain
        box = _whole(dom, box)
        grown = tuple((max(a - 1, 0), min(b + 1, n)) for (a, b), n in zip(box, dom.grid_shape))
        G = self.boundary_field(torch.float64, device, grown)
        # one zero node a side where the grown box met the grid's edge
        pad = [w for (a, b), (ga, gb) in zip(reversed(box), reversed(grown))
               for w in (1 - (a - ga), 1 - (gb - b))]
        rhs = self.f(*_coords(dom, device, box))
        if isinstance(dom, Domain3D):
            p = torch.nn.functional.pad(G, pad)
            rhs = rhs - dom.coeff_x * (p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])
            rhs = rhs - dom.coeff_y * (p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1])
            rhs = rhs - dom.coeff_z * (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1])
        else:
            p = torch.nn.functional.pad(G, pad)
            rhs = rhs - dom.coeff_y * (p[:-2, 1:-1] + p[2:, 1:-1])
            rhs = rhs - dom.coeff_x * (p[1:-1, :-2] + p[1:-1, 2:])
        return torch.where(dom.interior_on(device, box), rhs, 0.0).to(dtype)

    def true_solution_field(
        self, dtype=torch.float64, device="cuda", masked: bool = True
    ) -> torch.Tensor:
        """u_exact on the grid, interior-masked by default."""
        if self.u_exact is None:
            raise ValueError("problem has no exact solution")
        device = resolve_device(device)
        U = self.u_exact(*_coords(self.domain, device))
        if masked:
            U = torch.where(self.domain.interior_on(device), U, 0.0)
        return U.to(dtype)

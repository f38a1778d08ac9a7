"""Grid domains with node masks (counterpart of iterative_solvers_tpu/core/domain.py).

A 2D field is a dense tensor over the full rectangular node grid, shape
``(ny + 1, nx + 1)`` indexed ``[iy, ix]``; a 3D field (:class:`Domain3D`, the
box) has shape ``(nz + 1, ny + 1, nx + 1)`` indexed ``[iz, iy, ix]``. The
masks are numpy arrays built on the host (they describe geometry, not data);
:class:`MaskSpec` rebuilds the gamma/rect/box interior mask from index
predicates on any device and canvas, so full-size masks never have to cross
from host to card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device the port runs on. The entry points
    default to ``"cuda"``: that raises without a card, and ``"cpu"`` must be
    asked for. Nothing falls back from one to the other."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available")
    return device


def interior_pred(kind: str, nx: int, ny: int, ri, ci):
    """Gamma/rect interior predicate on global (row, col) index arrays.

    Works on numpy arrays and torch tensors alike; the same closed form as
    the JAX kernels' ``_interior_pred``."""
    inside = (ri > 0) & (ri < ny) & (ci > 0) & (ci < nx)
    if kind == "gamma":
        inside = inside & ~((ci <= nx // 2) & (ri <= ny // 2))
    return inside


@dataclass(frozen=True)
class MaskSpec:
    """Closed-form gamma/rect/box interior mask evaluated on a canvas
    ``shape`` that may be larger than the node grid (padded layouts): padding
    rows and columns fall outside the strict inequalities and are False.
    ``box`` is the 3D kind: 0 < z < nz ∧ 0 < y < ny ∧ 0 < x < nx."""

    kind: str  # 'gamma' | 'rect' | 'box'
    nx: int
    ny: int
    shape: Tuple[int, ...]
    nz: int = 0

    def _pred(self, grids):
        if self.kind == "box":
            zi, ri, ci = grids
            return (zi > 0) & (zi < self.nz) & interior_pred("rect", self.nx, self.ny, ri, ci)
        return interior_pred(self.kind, self.nx, self.ny, *grids)

    def build(self, device="cpu") -> torch.Tensor:
        """The interior mask as a bool tensor on ``device``."""
        n = len(self.shape)
        grids = [
            torch.arange(s, device=device).view([-1 if a == i else 1 for a in range(n)])
            for i, s in enumerate(self.shape)
        ]
        return self._pred(grids).expand(self.shape)

    def build_host(self) -> np.ndarray:
        grids = np.ogrid[tuple(slice(0, s) for s in self.shape)]
        return np.broadcast_to(self._pred(grids), self.shape).copy()


@dataclass(frozen=True)
class Domain2D:
    """A 2D finite-difference node grid over ``[x0, x1] x [y0, y1]``.

    ``nx``/``ny`` are interval counts; ``shape`` is ``"gamma"`` (the
    L-shaped domain) or ``"rect"``."""

    nx: int
    ny: int
    x0: float = 1.0
    x1: float = 2.0
    y0: float = 1.0
    y1: float = 2.0
    shape: str = "gamma"

    def __post_init__(self) -> None:
        if self.shape == "custom":
            raise NotImplementedError(
                "shape='custom' is not ported yet (ROADMAP Queue 1 item 11)"
            )
        if self.nx < 2 or self.ny < 2:
            raise ValueError(f"grid too small: nx={self.nx}, ny={self.ny}")
        if self.shape not in ("gamma", "rect"):
            raise ValueError(f"unknown shape {self.shape!r}")
        if self.shape == "gamma" and (self.nx % 2 or self.ny % 2):
            raise ValueError("gamma domain requires even nx and ny")

    @property
    def hx(self) -> float:
        return (self.x1 - self.x0) / self.nx

    @property
    def hy(self) -> float:
        return (self.y1 - self.y0) / self.ny

    @property
    def coeff_diag(self) -> float:
        """Stencil diagonal -2(1/hx² + 1/hy²)."""
        return -2.0 * (1.0 / self.hx**2 + 1.0 / self.hy**2)

    @property
    def coeff_x(self) -> float:
        return 1.0 / self.hx**2

    @property
    def coeff_y(self) -> float:
        return 1.0 / self.hy**2

    @property
    def grid_shape(self) -> Tuple[int, int]:
        """Full node-grid shape ``(ny+1, nx+1)``."""
        return (self.ny + 1, self.nx + 1)

    @property
    def mask_spec(self) -> MaskSpec:
        return MaskSpec(self.shape, self.nx, self.ny, self.grid_shape)

    # --- host masks -----------------------------------------------------------

    @cached_property
    def inside(self) -> np.ndarray:
        """Nodes inside or on the closure of the domain."""
        if self.shape == "rect":
            return np.ones(self.grid_shape, dtype=bool)
        iy, ix = np.mgrid[0 : self.ny + 1, 0 : self.nx + 1]
        return ~((ix < self.nx // 2) & (iy < self.ny // 2))

    @cached_property
    def interior(self) -> np.ndarray:
        """Unknown nodes of the linear system."""
        return self.mask_spec.build_host()

    @cached_property
    def boundary(self) -> np.ndarray:
        """Dirichlet nodes: inside the closure but not unknowns."""
        return self.inside & ~self.interior

    @property
    def num_unknowns(self) -> int:
        return int(self.interior.sum())

    def interior_on(self, device) -> torch.Tensor:
        return self.mask_spec.build(device)

    def boundary_on(self, device) -> torch.Tensor:
        h, w = self.grid_shape
        ri = torch.arange(h, device=device)[:, None]
        ci = torch.arange(w, device=device)[None, :]
        inside = torch.ones(h, w, dtype=torch.bool, device=device)
        if self.shape == "gamma":
            inside = ~((ci < self.nx // 2) & (ri < self.ny // 2))
        return inside & ~self.interior_on(device)

    def with_resolution(self, nx: int, ny: int) -> "Domain2D":
        return dataclasses.replace(self, nx=nx, ny=ny)


@dataclass(frozen=True)
class Domain3D:
    """A 3D box node grid over ``[x0,x1]x[y0,y1]x[z0,z1]`` (7-point stencil).
    Fields have shape ``(nz+1, ny+1, nx+1)`` indexed ``[iz, iy, ix]``; every
    node off the box's faces is an unknown, every face node is Dirichlet."""

    nx: int
    ny: int
    nz: int
    x0: float = 0.0
    x1: float = 1.0
    y0: float = 0.0
    y1: float = 1.0
    z0: float = 0.0
    z1: float = 1.0

    def __post_init__(self) -> None:
        if min(self.nx, self.ny, self.nz) < 2:
            raise ValueError("grid too small")

    @property
    def hx(self) -> float:
        return (self.x1 - self.x0) / self.nx

    @property
    def hy(self) -> float:
        return (self.y1 - self.y0) / self.ny

    @property
    def hz(self) -> float:
        return (self.z1 - self.z0) / self.nz

    @property
    def coeff_diag(self) -> float:
        return -2.0 * (1.0 / self.hx**2 + 1.0 / self.hy**2 + 1.0 / self.hz**2)

    @property
    def coeff_x(self) -> float:
        return 1.0 / self.hx**2

    @property
    def coeff_y(self) -> float:
        return 1.0 / self.hy**2

    @property
    def coeff_z(self) -> float:
        return 1.0 / self.hz**2

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return (self.nz + 1, self.ny + 1, self.nx + 1)

    @property
    def mask_spec(self) -> MaskSpec:
        return MaskSpec("box", self.nx, self.ny, self.grid_shape, nz=self.nz)

    @cached_property
    def interior(self) -> np.ndarray:
        return self.mask_spec.build_host()

    @cached_property
    def boundary(self) -> np.ndarray:
        return ~self.interior

    @property
    def num_unknowns(self) -> int:
        return (self.nx - 1) * (self.ny - 1) * (self.nz - 1)

    def interior_on(self, device) -> torch.Tensor:
        return self.mask_spec.build(device)

    def boundary_on(self, device) -> torch.Tensor:
        return ~self.interior_on(device)

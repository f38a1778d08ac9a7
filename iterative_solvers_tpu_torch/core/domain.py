"""Grid domains with node masks (counterpart of iterative_solvers_tpu/core/domain.py).

A field is a dense tensor over the full rectangular node grid, shape
``(ny + 1, nx + 1)`` indexed ``[iy, ix]``. The masks are numpy arrays built on
the host (they describe geometry, not data); :class:`MaskSpec` rebuilds the
gamma/rect interior mask from index predicates on any device and canvas, so
full-size masks never have to cross from host to card.
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
    """Closed-form gamma/rect interior mask evaluated on a canvas ``shape``
    that may be larger than the node grid (padded layouts): padding rows and
    columns fall outside the strict inequalities and are False."""

    kind: str  # 'gamma' | 'rect'
    nx: int
    ny: int
    shape: Tuple[int, int]

    def build(self, device="cpu") -> torch.Tensor:
        """The interior mask as a bool tensor on ``device``."""
        h, w = self.shape
        ri = torch.arange(h, device=device)[:, None]
        ci = torch.arange(w, device=device)[None, :]
        return interior_pred(self.kind, self.nx, self.ny, ri, ci).expand(h, w)

    def build_host(self) -> np.ndarray:
        ri, ci = np.ogrid[0 : self.shape[0], 0 : self.shape[1]]
        return np.broadcast_to(
            interior_pred(self.kind, self.nx, self.ny, ri, ci), self.shape
        ).copy()


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

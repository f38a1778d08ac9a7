"""Grid domains with node masks (counterpart of iterative_solvers_tpu/core/domain.py).

A 2D field is a dense tensor over the full rectangular node grid, shape
``(ny + 1, nx + 1)`` indexed ``[iy, ix]``; a 3D field (:class:`Domain3D`, the
box) has shape ``(nz + 1, ny + 1, nx + 1)`` indexed ``[iz, iy, ix]``. The
masks are numpy arrays built on the host (they describe geometry, not data);
:class:`MaskSpec` rebuilds the gamma/rect/box interior mask from index
predicates on any device and canvas, so full-size masks never have to cross
from host to card. A custom domain's mask has no closed form:
:class:`ArrayMask` holds it as an array with the same interface and uploads
it once per device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Dict, Optional, Tuple

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
    # global index of the canvas's first node per axis: a mesh block's mask
    # is the predicate at its own global indices (parallel/mesh.py)
    origin: Tuple[int, ...] = ()

    def _pred(self, grids):
        if self.kind == "box":
            zi, ri, ci = grids
            return (zi > 0) & (zi < self.nz) & interior_pred("rect", self.nx, self.ny, ri, ci)
        return interior_pred(self.kind, self.nx, self.ny, *grids)

    def build(self, device="cpu") -> torch.Tensor:
        """The interior mask as a bool tensor on ``device``."""
        n = len(self.shape)
        org = self.origin or (0,) * n
        grids = [
            torch.arange(o, o + s, device=device).view([-1 if a == i else 1 for a in range(n)])
            for i, (o, s) in enumerate(zip(org, self.shape))
        ]
        return self._pred(grids).expand(self.shape)

    def build_host(self) -> np.ndarray:
        org = self.origin or (0,) * len(self.shape)
        grids = np.ogrid[tuple(slice(o, o + s) for o, s in zip(org, self.shape))]
        return np.broadcast_to(self._pred(grids), self.shape).copy()


class ArrayMask:
    """A custom domain's interior mask held as a host bool array, with
    :class:`MaskSpec`'s interface (``shape``, ``build``, ``build_host``), so
    every consumer of a mask spec takes it unchanged. Device copies are
    made once per device and cached: ``build`` (bool, for the torch glue)
    and ``int8`` (the kernels' mask operand on a padded canvas)."""

    kind = "custom"

    def __init__(self, mask: np.ndarray):
        self._host = np.array(mask, dtype=bool)  # an owned, writable copy
        self.shape: Tuple[int, ...] = self._host.shape
        self._bool: Dict[torch.device, torch.Tensor] = {}
        self._int8: Dict[torch.device, torch.Tensor] = {}

    def build(self, device="cpu") -> torch.Tensor:
        device = torch.device(device)
        m = self._bool.get(device)
        if m is None:
            m = self._bool[device] = torch.from_numpy(self._host).to(device)
        return m

    def build_host(self) -> np.ndarray:
        return self._host.copy()

    def int8(self, device) -> torch.Tensor:
        device = torch.device(device)
        m = self._int8.get(device)
        if m is None:
            m = self._int8[device] = torch.from_numpy(self._host.view(np.int8)).to(device)
        return m

    def padded(self, shape) -> "ArrayMask":
        """The mask on a larger canvas ``shape``; padding is never interior."""
        out = np.zeros(shape, dtype=bool)
        out[tuple(slice(0, s) for s in self.shape)] = self._host
        return ArrayMask(out)


def notched_disk(ix: np.ndarray, iy: np.ndarray) -> np.ndarray:
    """A custom ``inside_fn``: the disk of radius 0.45 with a notch cut
    from its centre along +x (half-height 0.1), in coordinates normalised to
    the index grid, so every multigrid level sees the same shape. On a 64²
    grid it is the notched disk of the JAX package's custom-mask tests."""
    s, t = ix / ix.max() - 0.5, iy / iy.max() - 0.5
    return (s * s + t * t <= 0.45**2) & ~((s > 0) & (np.abs(t) < 0.1))


@dataclass(frozen=True)
class Domain2D:
    """A 2D finite-difference node grid over ``[x0, x1] x [y0, y1]``.

    ``nx``/``ny`` are interval counts; ``shape`` is ``"gamma"`` (the
    L-shaped domain), ``"rect"``, or ``"custom"``, whose closure is
    ``inside_fn(ix, iy)`` on the full index grids (``np.mgrid``)."""

    nx: int
    ny: int
    x0: float = 1.0
    x1: float = 2.0
    y0: float = 1.0
    y1: float = 2.0
    shape: str = "gamma"
    inside_fn: Optional[Callable] = None

    def __post_init__(self) -> None:
        if self.nx < 2 or self.ny < 2:
            raise ValueError(f"grid too small: nx={self.nx}, ny={self.ny}")
        if self.shape == "gamma" and (self.nx % 2 or self.ny % 2):
            raise ValueError("gamma domain requires even nx and ny")
        if self.shape not in ("gamma", "rect", "custom"):
            raise ValueError(f"unknown shape {self.shape!r}")
        if self.shape == "custom" and self.inside_fn is None:
            raise ValueError("shape='custom' requires inside_fn")

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
    def mask_spec(self):
        """The interior as a :class:`MaskSpec` (gamma/rect) or, for a custom
        domain, as the cached :class:`ArrayMask` of :attr:`interior`."""
        if self.shape == "custom":
            return self._array_masks[0]
        return MaskSpec(self.shape, self.nx, self.ny, self.grid_shape)

    # --- host masks -----------------------------------------------------------

    @cached_property
    def inside(self) -> np.ndarray:
        """Nodes inside or on the closure of the domain."""
        if self.shape == "rect":
            return np.ones(self.grid_shape, dtype=bool)
        iy, ix = np.mgrid[0 : self.ny + 1, 0 : self.nx + 1]
        if self.shape == "custom":
            return np.asarray(self.inside_fn(ix, iy), dtype=bool)
        return ~((ix < self.nx // 2) & (iy < self.ny // 2))

    @cached_property
    def interior(self) -> np.ndarray:
        """Unknown nodes of the linear system."""
        if self.shape == "custom":
            return self.inside & ~self.boundary
        return self.mask_spec.build_host()

    @cached_property
    def boundary(self) -> np.ndarray:
        """Dirichlet nodes: inside the closure but not unknowns. A custom
        domain's are its inside nodes on the rectangle's edge or with an
        exterior node in their 8-neighbourhood, as in the JAX package."""
        if self.shape != "custom":
            return self.inside & ~self.interior
        inside = self.inside
        ext = np.pad(~inside, 1)
        h, w = self.grid_shape
        edge = np.zeros(self.grid_shape, dtype=bool)
        edge[[0, -1], :] = edge[:, [0, -1]] = True
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    edge |= ext[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        return inside & edge

    @cached_property
    def _array_masks(self) -> Tuple[ArrayMask, ArrayMask]:
        """A custom domain's (interior, boundary) masks, uploaded once per
        device."""
        return ArrayMask(self.interior), ArrayMask(self.boundary)

    @property
    def num_unknowns(self) -> int:
        return int(self.interior.sum())

    def interior_on(self, device) -> torch.Tensor:
        return self.mask_spec.build(device)

    def boundary_on(self, device) -> torch.Tensor:
        if self.shape == "custom":
            return self._array_masks[1].build(device)
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

"""Halo-exchanging stencil operator over mesh blocks (counterpart of
the JAX package's parallel/halo.py).

Each rank owns one block of the padded node grid (``parallel/mesh.py``).
An apply masks the block, exchanges one row and one column of halo with
each ring neighbour (:meth:`SolverMesh.exchange`, the counterpart of the
four ``lax.ppermute`` of the JAX operator), and runs the local stencil on
the block extended by its halos. A halo that wraps around the global grid
only ever reaches output nodes on the grid's edge, which the interior mask
zeroes. The per-node arithmetic is the single-device stencil's
(``ops/stencil.py``: the 5-point sum, and ``combine7`` in 3D), so the
sharded apply equals the single-device one node for node; the JAX operator
adds its halo terms after the bulk sum, a rounding apart.

The operator runs in any dtype: it is the f64 operator of the mesh's
mixed-precision outer loop, the twin of the sharded stencil kernels
(``halo_pallas.py``) on their padded layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from iterative_solvers_tpu_torch.core.domain import ArrayMask, MaskSpec, resolve_device
from iterative_solvers_tpu_torch.ops.stencil import combine7, mask_nnz
from iterative_solvers_tpu_torch.parallel import mesh as mesh_lib
from iterative_solvers_tpu_torch.parallel.mesh import SolverMesh


def extend_2d(xm: torch.Tensor, up, dn, left, right) -> torch.Tensor:
    """The (hb+2, wb+2) block with its halo rows above/below and halo
    columns left/right (corners 0)."""
    hb, wb = xm.shape
    xe = xm.new_zeros((hb + 2, wb + 2))
    xe[1:-1, 1:-1] = xm
    xe[0, 1:-1] = up
    xe[-1, 1:-1] = dn
    xe[1:-1, 0] = left
    xe[1:-1, -1] = right
    return xe


def extend_3d(xm: torch.Tensor, zup, zdn, left, right) -> torch.Tensor:
    """The (dzb+2, hp+2, wb+2) block with its halo planes (z) and halo
    columns (x); the y extent is local, zero beyond it."""
    dz, hp, wb = xm.shape
    xe = xm.new_zeros((dz + 2, hp + 2, wb + 2))
    xe[1:-1, 1:-1, 1:-1] = xm
    xe[0, 1:-1, 1:-1] = zup
    xe[-1, 1:-1, 1:-1] = zdn
    xe[1:-1, 1:-1, 0] = left
    xe[1:-1, 1:-1, -1] = right
    return xe


def apply5(xe: torch.Tensor, cd: float, cx: float, cy: float) -> torch.Tensor:
    """The 5-point sum on the interior of an extended block, in the
    single-device stencil's order."""
    return (cd * xe[1:-1, 1:-1] + cx * (xe[1:-1, :-2] + xe[1:-1, 2:])
            + cy * (xe[:-2, 1:-1] + xe[2:, 1:-1]))


def apply7(xe: torch.Tensor, cd: float, cx: float, cy: float, cz: float) -> torch.Tensor:
    """The 7-point sum on the interior of an extended block (``combine7``)."""
    c = xe[1:-1, 1:-1, 1:-1]
    return combine7(
        c,
        xe[1:-1, 1:-1, :-2] + xe[1:-1, 1:-1, 2:],
        xe[1:-1, :-2, 1:-1] + xe[1:-1, 2:, 1:-1],
        xe[:-2, 1:-1, 1:-1] + xe[2:, 1:-1, 1:-1],
        cd, cx, cy, cz,
    )


def edge_messages(xm: torch.Tensor):
    """The ring messages of a one-deep halo: last row (plane) forward,
    first backward along the rows; last column forward, first backward
    along the columns. Received: the row above, the row below, the column
    to the left, the column to the right."""
    return [(xm[-1], 0, 1), (xm[0], 0, -1), (xm[..., -1], 1, 1), (xm[..., 0], 1, -1)]


@dataclass(frozen=True, eq=False)
class ShardedStencilOperator:
    """Matrix-free masked 5-point (7-point) operator over block-sharded
    fields: call it on this rank's block of a :func:`mesh.shard_field`
    field. ``mask_kind``: 'gamma' | 'rect' | 'box3' | 'custom'; a custom
    mask is held as the padded global host array."""

    mesh: SolverMesh
    coeffs: Tuple[float, ...]  # (cd, cx, cy[, cz])
    grid_shape: Tuple[int, ...]  # unpadded shape, for cropping
    padded_shape: Tuple[int, ...]  # mesh-divisible
    mask_kind: str
    dims: Tuple[int, ...]  # (nx, ny) or (nx, ny, nz) interval counts
    interior_host: Optional[np.ndarray] = None  # padded; custom masks only
    _masks: Dict[torch.device, torch.Tensor] = field(default_factory=dict, repr=False)

    @staticmethod
    def from_domain(domain, mesh: SolverMesh, dtype=None) -> "ShardedStencilOperator":
        padded = mesh_lib.padded_grid_shape(domain.grid_shape, mesh)
        coeffs = (domain.coeff_diag, domain.coeff_x, domain.coeff_y)
        host = None
        if hasattr(domain, "coeff_z"):
            coeffs = coeffs + (domain.coeff_z,)
            kind, dims = "box3", (domain.nx, domain.ny, domain.nz)
        elif domain.shape in ("gamma", "rect"):
            kind, dims = domain.shape, (domain.nx, domain.ny)
        else:
            kind, dims = "custom", (domain.nx, domain.ny)
            host = np.asarray(mesh_lib.pad_field(np.asarray(domain.interior), mesh))
        return ShardedStencilOperator(mesh, tuple(float(c) for c in coeffs),
                                      tuple(domain.grid_shape), padded, kind, dims, host)

    @property
    def block_shape(self) -> Tuple[int, ...]:
        return self.mesh.block_shape(self.padded_shape)

    @property
    def shape(self):
        return self.padded_shape

    def _mask_spec(self, shape, origin):
        if self.mask_kind == "custom":
            sl = tuple(slice(o, o + s) for o, s in zip(origin, shape))
            return ArrayMask(self.interior_host[sl])
        if self.mask_kind == "box3":
            nx, ny, nz = self.dims
            return MaskSpec("box", nx, ny, tuple(shape), nz=nz, origin=tuple(origin))
        nx, ny = self.dims
        return MaskSpec(self.mask_kind, nx, ny, tuple(shape), origin=tuple(origin))

    def block_mask(self, device) -> torch.Tensor:
        """This rank's block of the interior mask, cached per device."""
        device = torch.device(device)
        m = self._masks.get(device)
        if m is None:
            bs = self.block_shape
            spec = self._mask_spec(bs, self.mesh.block_origin(bs))
            m = self._masks[device] = spec.build(device).contiguous()
        return m

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        m = self.block_mask(x.device)
        xm = torch.where(m, x, 0.0)
        halos = self.mesh.exchange(edge_messages(xm))
        if len(self.coeffs) == 4:
            y = apply7(extend_3d(xm, *halos), *self.coeffs)
        else:
            y = apply5(extend_2d(xm, *halos), *self.coeffs)
        return torch.where(m, y, 0.0)

    @property
    def interior(self) -> np.ndarray:
        """The padded global interior mask (host)."""
        if self.mask_kind == "custom":
            return self.interior_host.copy()
        return self._mask_spec(self.padded_shape, (0,) * len(self.padded_shape)).build_host()

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.block_mask(x.device), x, 0.0)

    def diagonal(self, device="cuda", dtype=torch.float64) -> torch.Tensor:
        """This rank's block of the operator's diagonal (0 off the interior)."""
        m = self.block_mask(resolve_device(device))
        return torch.where(m, self.coeffs[0], 0.0).to(dtype)

    def nnz(self) -> int:
        return mask_nnz(self.interior)

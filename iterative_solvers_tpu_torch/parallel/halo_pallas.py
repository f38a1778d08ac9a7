"""Sharded stencil kernels: the padded-layout stencils per mesh block
(counterpart of iterative_solvers_tpu/parallel/halo_pallas.py).

- :class:`ShardedPallasStencilOperator` (2D Г/rect) runs the CUDA kernel
  ``ist_stencil_block`` (``csrc/halo_pallas.cu``), which replaces the TPU
  kernel D1, ``halo_pallas._make_block_kernel`` / ``_block_stencil_call``.
- :class:`ShardedPallas3DStencilOperator` (the 3D box, z over the row axes,
  x over the column axis, y local) runs ``ist_stencil3d_block``, which
  replaces D2, ``_make_block_kernel_3d`` / ``_block_stencil_call_3d``: S7's
  arithmetic on the staged z-march of ``csrc/zstream3d.cuh``, its chunk
  depth from ``stencil3d_layout.zstream_chunk``.

Each block kernel is its single-device kernel (A1, S7) with three
additions: the block's global origin offsets the algebraic mask, the
exchanged neighbour rows (planes) are operands, and so are the exchanged
neighbour columns. The TPU kernels zero the wrapped lane of their lane
rolls and add the neighbour columns afterwards as edge strips; a CUDA
thread reads its neighbour column as an operand instead, so every node,
edge or not, takes the single-device kernel's expression and the stitched
blocks equal the single-device apply bit for bit. Every read is masked by
its node's global position, so the senders ship raw values and a halo
that wraps around the grid is zeroed where it lands.

Layouts are the JAX package's: ``Wb % 128 == 0`` and ``Hb % block_rows ==
0`` in 2D; ``(Dz_b, Hp, Wb)`` blocks in 3D, so padded shapes, block shapes
and origins compare like for like with the JAX operators on the same mesh.
On a CPU tensor each wrapper runs its plain torch version; on a CUDA tensor
it launches its kernel (f32) or raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch.core.domain import MaskSpec, resolve_device
from iterative_solvers_tpu_torch.kernels import _build
from iterative_solvers_tpu_torch.kernels.stencil3d_layout import (
    auto_block_rows_3d,
    zstream_chunk,
)
from iterative_solvers_tpu_torch.kernels.stencil_layout import (
    auto_block_rows,
    check_aligned,
    check_field,
    round_up,
)
from iterative_solvers_tpu_torch.ops.stencil import mask_nnz
from iterative_solvers_tpu_torch.parallel.halo import (
    apply5,
    apply7,
    edge_messages,
    extend_2d,
    extend_3d,
)
from iterative_solvers_tpu_torch.parallel.mesh import SolverMesh, ring_take


def _check_halos(x: torch.Tensor, halos, shapes) -> None:
    for name, t, shape in zip(("up", "down", "left", "right"), halos, shapes):
        check_field(name, t, shape)
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, the block on {x.device}")


def block_stencil_plain(x, up, dn, left, right, spec: MaskSpec, coeffs) -> torch.Tensor:
    """D1's plain version: the extended block masked at its global
    positions, the 5-point sum, the block's mask on the output."""
    _build.note_plain("stencil_block", x)
    me = extended_mask(spec, x.device)
    y = apply5(torch.where(me, extend_2d(x, up, dn, left, right), 0.0), *coeffs)
    return torch.where(me[1:-1, 1:-1], y, 0.0)


def block_stencil3d_plain(x, zup, zdn, left, right, spec: MaskSpec, coeffs) -> torch.Tensor:
    """D2's plain version (``combine7``'s order, S7's)."""
    _build.note_plain("stencil3d_block", x)
    me = extended_mask(spec, x.device)
    y = apply7(torch.where(me, extend_3d(x, zup, zdn, left, right), 0.0), *coeffs)
    return torch.where(me[1:-1, 1:-1, 1:-1], y, 0.0)


def extended_mask(spec: MaskSpec, device) -> torch.Tensor:
    """The block's mask with one node more on each side of every axis."""
    return MaskSpec(spec.kind, spec.nx, spec.ny, tuple(s + 2 for s in spec.shape), nz=spec.nz,
                    origin=tuple(o - 1 for o in spec.origin)).build(device)


@dataclass(frozen=True, eq=False)
class ShardedPallasStencilOperator:
    """The masked 5-point stencil on mesh blocks of its own padded layout
    (``pad``/``crop``/``shard``), one D1 launch per apply. 2D gamma/rect
    domains; f32 on the card (any dtype in the plain version)."""

    mesh: SolverMesh
    nx: int
    ny: int
    coeffs: Tuple[float, float, float]
    grid_shape: Tuple[int, int]
    padded_shape: Tuple[int, int]
    block_shape: Tuple[int, int]  # (Hb, Wb) per rank
    block_rows: int
    mask_mode: str

    @staticmethod
    def from_domain(domain, mesh: SolverMesh, dtype=None,
                    block_rows: Optional[int] = None) -> "ShardedPallasStencilOperator":
        if getattr(domain, "shape", None) not in ("gamma", "rect"):
            raise ValueError(
                "ShardedPallasStencilOperator supports 2D gamma/rect domains "
                "(algebraic masks); use ShardedStencilOperator otherwise"
            )
        h, w = domain.grid_shape
        my, mx = mesh.rows, mesh.cols
        wp = round_up(w, mx * 128)
        wb = wp // mx
        by = block_rows or min(auto_block_rows(wb), 128)
        hp = round_up(h, my * by)
        return ShardedPallasStencilOperator(
            mesh=mesh, nx=domain.nx, ny=domain.ny,
            coeffs=(domain.coeff_diag, domain.coeff_x, domain.coeff_y),
            grid_shape=(h, w), padded_shape=(hp, wp), block_shape=(hp // my, wb),
            block_rows=by, mask_mode=domain.shape,
        )

    @property
    def shape(self):
        return self.padded_shape

    @property
    def origin(self) -> Tuple[int, int]:
        return self.mesh.block_origin(self.block_shape)

    def block_spec(self, shape=None, origin=None) -> MaskSpec:
        """The interior of a block (this rank's by default) as a MaskSpec."""
        return MaskSpec(self.mask_mode, self.nx, self.ny, tuple(shape or self.block_shape),
                        origin=tuple(self.origin if origin is None else origin))

    def apply_block(self, x, up, dn, left, right, origin=None) -> torch.Tensor:
        """D1 on one block with its halos: the row above and below (Wb),
        the column left and right (Hb), raw values; ``origin`` (row, col)
        defaults to this rank's block."""
        hb, wb = self.block_shape
        spec = self.block_spec(origin=origin)
        if x.device.type == "cpu":
            return block_stencil_plain(x, up, dn, left, right, spec, self.coeffs)
        check_field("x", x, self.block_shape)
        up, dn, left, right = (t.contiguous() for t in (up, dn, left, right))
        _check_halos(x, (up, dn, left, right), ((wb,), (wb,), (hb,), (hb,)))
        y = torch.empty_like(x)
        _build.launch(
            "ist_stencil_block", *map(_build.ptr, (x, up, dn, left, right, y)),
            self.nx, self.ny, int(self.mask_mode == "gamma"), hb, wb, self.block_rows,
            spec.origin[0], spec.origin[1], *self.coeffs,
        )
        return y

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_block(x, *self.mesh.exchange(edge_messages(x)))

    def halos_from_global(self, field: torch.Tensor, origin):
        """(block, up, dn, left, right) of the block at ``origin`` of a
        padded global field, as the ring exchange delivers them."""
        (hb, wb), (r0, c0) = self.block_shape, origin
        rows, cols = range(r0, r0 + hb), range(c0, c0 + wb)
        band = ring_take(field, rows, 0)
        x = ring_take(band, cols, 1)
        return (x, ring_take(field, [r0 - 1], 0)[0, c0:c0 + wb],
                ring_take(field, [r0 + hb], 0)[0, c0:c0 + wb],
                ring_take(band, [c0 - 1], 1)[:, 0], ring_take(band, [c0 + wb], 1)[:, 0])

    # --- layout helpers -----------------------------------------------------------

    def pad(self, field: torch.Tensor) -> torch.Tensor:
        h, w = self.grid_shape
        hp, wp = self.padded_shape
        return F.pad(field, (0, wp - w, 0, hp - h))

    def crop(self, field: torch.Tensor) -> torch.Tensor:
        h, w = self.grid_shape
        return field[:h, :w]

    def shard(self, field) -> torch.Tensor:
        """This rank's block of a full-grid field padded to this layout."""
        return self.mesh.take_block(self.pad(torch.as_tensor(field)), self.block_shape)

    def interior_padded(self) -> np.ndarray:
        return self.block_spec(self.padded_shape, (0, 0)).build_host()

    @property
    def interior(self) -> np.ndarray:
        return self.interior_padded()

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.block_spec().build(x.device), x, 0.0)

    def diagonal(self, device="cuda", dtype=torch.float32) -> torch.Tensor:
        m = self.block_spec().build(resolve_device(device))
        return torch.where(m, self.coeffs[0], 0.0).to(dtype)

    def nnz(self) -> int:
        return mask_nnz(self.interior_padded())


@dataclass(frozen=True, eq=False)
class ShardedPallas3DStencilOperator:
    """The masked 7-point stencil on mesh blocks ``(Dz_b, Hp, Wb)``: z over
    the row axes, x over the column axis, y local; one D2 launch per
    apply."""

    mesh: SolverMesh
    nx: int
    ny: int
    nz: int
    coeffs: Tuple[float, float, float, float]
    grid_shape: Tuple[int, int, int]
    padded_shape: Tuple[int, int, int]
    block_shape: Tuple[int, int, int]
    block_rows: int

    @staticmethod
    def from_domain(domain, mesh: SolverMesh, dtype=None,
                    block_rows: Optional[int] = None) -> "ShardedPallas3DStencilOperator":
        d, h, w = domain.grid_shape
        my, mx = mesh.rows, mesh.cols
        wp = round_up(w, mx * 128)
        by = block_rows or auto_block_rows_3d(h)
        hp = round_up(h, by)
        dp = round_up(d, my)
        return ShardedPallas3DStencilOperator(
            mesh=mesh, nx=domain.nx, ny=domain.ny, nz=domain.nz,
            coeffs=(domain.coeff_diag, domain.coeff_x, domain.coeff_y, domain.coeff_z),
            grid_shape=(d, h, w), padded_shape=(dp, hp, wp),
            block_shape=(dp // my, hp, wp // mx), block_rows=by,
        )

    @property
    def shape(self):
        return self.padded_shape

    @property
    def origin(self) -> Tuple[int, int, int]:
        return self.mesh.block_origin(self.block_shape)

    def block_spec(self, shape=None, origin=None) -> MaskSpec:
        return MaskSpec("box", self.nx, self.ny, tuple(shape or self.block_shape), nz=self.nz,
                        origin=tuple(self.origin if origin is None else origin))

    def apply_block(self, x, zup, zdn, left, right, origin=None) -> torch.Tensor:
        """D2 on one block with its halos: the plane above and below
        (Hp, Wb), the column left and right (Dz_b, Hp), raw values."""
        dzb, hp, wb = self.block_shape
        spec = self.block_spec(origin=origin)
        if x.device.type == "cpu":
            return block_stencil3d_plain(x, zup, zdn, left, right, spec, self.coeffs)
        check_field("x", x, self.block_shape)
        zup, zdn, left, right = (t.contiguous() for t in (zup, zdn, left, right))
        _check_halos(x, (zup, zdn, left, right), ((hp, wb), (hp, wb), (dzb, hp), (dzb, hp)))
        check_aligned(x=x, zup=zup, zdn=zdn)  # staged in 16-byte pieces
        y = torch.empty_like(x)
        _build.launch(
            "ist_stencil3d_block", *map(_build.ptr, (x, zup, zdn, left, right, y)),
            self.nx, self.ny, self.nz, dzb, hp, wb,
            zstream_chunk(dzb, hp, wb, _build.sm_count(x.device)),
            spec.origin[0], spec.origin[2], *self.coeffs,
        )
        return y

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_block(x, *self.mesh.exchange(edge_messages(x)))

    def halos_from_global(self, field: torch.Tensor, origin):
        """(block, zup, zdn, left, right) of the block at ``origin``."""
        (dzb, _, wb), (z0, _, c0) = self.block_shape, origin
        slab = ring_take(field, range(z0, z0 + dzb), 0)
        x = ring_take(slab, range(c0, c0 + wb), 2)
        return (x, ring_take(field, [z0 - 1], 0)[0, :, c0:c0 + wb],
                ring_take(field, [z0 + dzb], 0)[0, :, c0:c0 + wb],
                ring_take(slab, [c0 - 1], 2)[..., 0], ring_take(slab, [c0 + wb], 2)[..., 0])

    def pad(self, field: torch.Tensor) -> torch.Tensor:
        d, h, w = self.grid_shape
        dp, hp, wp = self.padded_shape
        return F.pad(field, (0, wp - w, 0, hp - h, 0, dp - d))

    def crop(self, field: torch.Tensor) -> torch.Tensor:
        d, h, w = self.grid_shape
        return field[:d, :h, :w]

    def shard(self, field) -> torch.Tensor:
        return self.mesh.take_block(self.pad(torch.as_tensor(field)), self.block_shape)

    def interior_padded(self) -> np.ndarray:
        return self.block_spec(self.padded_shape, (0, 0, 0)).build_host()

    @property
    def interior(self) -> np.ndarray:
        return self.interior_padded()

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.block_spec().build(x.device), x, 0.0)

    def diagonal(self, device="cuda", dtype=torch.float32) -> torch.Tensor:
        m = self.block_spec().build(resolve_device(device))
        return torch.where(m, self.coeffs[0], 0.0).to(dtype)

    def nnz(self) -> int:
        return mask_nnz(self.interior_padded())

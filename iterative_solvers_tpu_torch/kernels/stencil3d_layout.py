"""Padded 3D box operator (counterpart of ``Pallas3DStencilOperator`` in
the JAX package's kernels/stencil3d_pallas.py).

Volumes live on a ``(D, Hp, Wp)`` canvas, ``D = nz + 1`` exact, ``Wp % 128
== 0`` and ``Hp`` a multiple of the JAX package's panel height
(``_auto_block_rows_3d``, itself a multiple of 8), so padded fields compare
like for like with the JAX layout. Padding is never interior, so zero
padding is inert. At 512³ the layout is (513, 520, 640), the same canvas the
fused multigrid level 0 uses, so the V-cycle takes the operator's fields with
no pad/crop copies.

Calling the operator applies the masked 7-point stencil ``y = A x`` to an
f32 padded volume: the CUDA kernel ``csrc/stencil3d.cu`` (S7, which
replaces both TPU kernels ``stencil3d_pallas._make_kernel_3d`` and
``_make_kernel_3d_chunked``) on a CUDA tensor, its plain torch version
:meth:`Padded3DStencilOperator.apply_plain` on a CPU tensor. S7 runs on the
staged z-march of ``csrc/zstream3d.cuh``, as every 3D kernel of the port
does: 8 x 128 tiles (``ZSTREAM_TILE``, so the canvas is whole tiles), each
block marching z over a chunk of planes whose depth :func:`zstream_chunk`
picks from the canvas and the card's SM count. A 512³ apply is a memory-bound
sweep, 8 bytes a node.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch.core.domain import MaskSpec, resolve_device
from iterative_solvers_tpu_torch.kernels import _build
from iterative_solvers_tpu_torch.kernels.stencil_layout import (
    check_aligned,
    check_field,
    round_up,
)
from iterative_solvers_tpu_torch.ops.stencil import mask_nnz, stencil_apply_3d

# the staged z-march (csrc/zstream3d.cuh: S7, J3, D2, R3): tiles of 8 rows x 128
# columns, the blocks per SM its planner aims for, its chunks' least and
# greatest depth
ZSTREAM_TILE = (8, 128)
ZSTREAM_BLOCKS_PER_SM = 16
ZSTREAM_DEPTH = (8, 32)


def auto_block_rows_3d(h: int) -> int:
    """The JAX package's panel height: the largest multiple of 8 that
    divides round_up(h, 8) and is <= 128."""
    hp = round_up(h, 8)
    return max(by for by in range(8, 129, 8) if hp % by == 0)


def zstream_chunk(planes: int, hp: int, wp: int, sm_count: int) -> int:
    """Planes per block of the staged z-march on a ``(planes, hp, wp)``
    canvas, for a card of ``sm_count`` SMs: chunks of one depth (the last
    shorter by less than the number of chunks), 8 to 32 deep
    (``ZSTREAM_DEPTH``), so that the grid of ``(hp / 8) (wp / 128)`` tiles
    per chunk holds at least ``ZSTREAM_BLOCKS_PER_SM`` blocks on every SM
    unless the chunks are already 8 planes deep. Each chunk stages two
    planes more than it writes; at 512³ chunks of 31 planes (17 chunks) ran
    D2 ~4 % faster than chunks of 57 (9 chunks) on an NVIDIA H100 80GB HBM3
    at 700 W (``chip_smoke.py --zstream``), hence at most 32."""
    ty, tx = ZSTREAM_TILE
    lo, hi = ZSTREAM_DEPTH
    tiles = -(-hp // ty) * -(-wp // tx)
    bz = max(lo, min(hi, planes * tiles // (ZSTREAM_BLOCKS_PER_SM * sm_count)))
    n = -(-planes // bz)
    return -(-planes // n)


def zstream_chunks(planes: int, bz: int):
    """The ``(z0, z1)`` plane ranges of the staged march's chunks."""
    return [(z0, min(z0 + bz, planes)) for z0 in range(0, planes, bz)]


@dataclass(frozen=True, eq=False)
class Padded3DStencilOperator:
    nx: int
    ny: int
    nz: int
    coeffs: Tuple[float, float, float, float]  # (cd, cx, cy, cz)
    grid_shape: Tuple[int, int, int]  # unpadded (D, H, W)
    padded_shape: Tuple[int, int, int]
    block_rows: int  # the JAX package's panel height: it sets hp

    @staticmethod
    def from_domain(domain) -> "Padded3DStencilOperator":
        d, h, w = domain.grid_shape
        by = auto_block_rows_3d(h)
        return Padded3DStencilOperator(
            nx=domain.nx,
            ny=domain.ny,
            nz=domain.nz,
            coeffs=(domain.coeff_diag, domain.coeff_x, domain.coeff_y, domain.coeff_z),
            grid_shape=(d, h, w),
            padded_shape=(d, round_up(h, by), round_up(w, 128)),
            block_rows=by,
        )

    @property
    def shape(self):
        return self.padded_shape

    def pad(self, field: torch.Tensor) -> torch.Tensor:
        _, h, w = self.grid_shape
        _, hp, wp = self.padded_shape
        return F.pad(field, (0, wp - w, 0, hp - h))

    def crop(self, field: torch.Tensor) -> torch.Tensor:
        _, h, w = self.grid_shape
        return field[:, :h, :w]

    @property
    def mask_spec(self) -> MaskSpec:
        return MaskSpec("box", self.nx, self.ny, tuple(self.padded_shape), nz=self.nz)

    def interior_padded(self) -> np.ndarray:
        return self.mask_spec.build_host()

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.mask_spec.build(x.device), x, 0.0)

    def diagonal(self, device="cuda") -> torch.Tensor:
        return torch.where(self.mask_spec.build(resolve_device(device)), self.coeffs[0], 0.0)

    def apply_plain(self, x: torch.Tensor) -> torch.Tensor:
        """S7's plain torch version: masked reads, masked output."""
        _build.note_plain("stencil3d", x)
        return stencil_apply_3d(x, self.mask_spec.build(x.device), *self.coeffs)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A x`` on a contiguous f32 volume of the padded shape."""
        check_field("x", x, self.padded_shape)
        if x.device.type == "cpu":
            return self.apply_plain(x)
        check_aligned(x=x)  # staged in 16-byte pieces
        y = torch.empty_like(x)
        d, hp, wp = self.padded_shape
        _build.launch("ist_stencil3d", _build.ptr(x), _build.ptr(y), self.nx, self.ny, self.nz,
                      d, hp, wp, zstream_chunk(d, hp, wp, _build.sm_count(x.device)),
                      *self.coeffs)
        return y

    def nnz(self) -> int:
        """Stored-matrix-equivalent nonzero count (:func:`mask_nnz`)."""
        return mask_nnz(self.interior_padded())

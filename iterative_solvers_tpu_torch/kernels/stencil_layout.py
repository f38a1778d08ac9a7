"""Padded field layout of the fused engine (counterpart of the layout half of
``PallasStencilOperator`` in iterative_solvers_tpu/kernels/stencil_pallas.py).

Fields live on an ``(hp, wp)`` canvas with ``wp % 128 == 0`` and
``hp % block_rows == 0``; the rule that picks ``block_rows`` and the padding
is the JAX package's own, so padded fields compare like for like. Padding is
never interior, so zero padding is inert.

The operator's own apply is the TPU kernel A1 (``pallas_stencil_apply``),
which this slice does not run; it is ported with A1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch.core.domain import MaskSpec


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def auto_block_rows(wp: int, dtype_bytes: int = 4, budget: int = 12 * 2**20) -> int:
    """The JAX package's panel-height rule: the largest power of two <= 256
    whose four (by, wp) f32 buffers fit a 12 MiB budget."""
    by = 256
    while by > 8 and 4 * by * wp * dtype_bytes > budget:
        by //= 2
    return by


@dataclass(frozen=True, eq=False)
class PaddedStencilOperator:
    nx: int
    ny: int
    coeffs: Tuple[float, float, float]  # (cd, cx, cy)
    grid_shape: Tuple[int, int]  # unpadded
    padded_shape: Tuple[int, int]
    block_rows: int
    mask_mode: str  # 'gamma' | 'rect'

    @staticmethod
    def from_domain(domain, block_rows: Optional[int] = None) -> "PaddedStencilOperator":
        h, w = domain.grid_shape
        wp = round_up(w, 128)
        by = block_rows or auto_block_rows(wp)
        return PaddedStencilOperator(
            nx=domain.nx,
            ny=domain.ny,
            coeffs=(domain.coeff_diag, domain.coeff_x, domain.coeff_y),
            grid_shape=(h, w),
            padded_shape=(round_up(h, by), wp),
            block_rows=by,
            mask_mode=domain.shape,
        )

    @property
    def shape(self):
        return self.padded_shape

    def pad(self, field: torch.Tensor) -> torch.Tensor:
        h, w = self.grid_shape
        hp, wp = self.padded_shape
        return F.pad(field, (0, wp - w, 0, hp - h))

    def crop(self, field: torch.Tensor) -> torch.Tensor:
        h, w = self.grid_shape
        return field[:h, :w]

    @property
    def mask_spec(self) -> MaskSpec:
        return MaskSpec(self.mask_mode, self.nx, self.ny, tuple(self.padded_shape))

    def interior_padded(self) -> np.ndarray:
        return self.mask_spec.build_host()

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.mask_spec.build(x.device), x, 0.0)

"""Padded stencil operator (counterpart of ``PallasStencilOperator`` in
the JAX package's kernels/stencil_pallas.py).

Fields live on an ``(hp, wp)`` canvas with ``wp % 128 == 0`` and
``hp % block_rows == 0``; the rule that picks ``block_rows`` and the padding
is the JAX package's own, so padded fields compare like for like. Padding is
never interior, so zero padding is inert.

Calling the operator applies the masked 5-point stencil ``y = A x`` to an
f32 padded field: the CUDA kernel ``csrc/stencil.cu`` (which replaces the
TPU kernel ``stencil_pallas._make_kernel``, and on a custom domain
``_make_kernel_custom``) on a CUDA tensor, its plain torch version
:meth:`PaddedStencilOperator.apply_plain` on a CPU tensor. The kernel tiles
the canvas as K1 does (:meth:`PaddedStencilOperator.tile_grid`) and equals
the plain version bit for bit.

A custom domain's layout carries its padded interior as an
:class:`~iterative_solvers_tpu_torch.core.domain.ArrayMask` (``mask8``), and
its bands are at least 32 rows, the JAX package's rule for its int8 mask
stream. Its kernels take the int8 mask as an operand (the ``*_custom``
launchers) where the gamma/rect ones evaluate the predicate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch.core.domain import ArrayMask, MaskSpec
from iterative_solvers_tpu_torch.kernels import _build
from iterative_solvers_tpu_torch.ops.stencil import mask_nnz


def check_field(name: str, t: torch.Tensor, shape) -> None:
    """The kernels take contiguous f32 fields of the layout's padded shape."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def check_aligned(**ts) -> None:
    """Kernels that read every operand in 16-byte pieces (the CG tiles, the
    3D legs): raise on a tensor whose storage does not start on a 16-byte
    boundary (a view at an odd offset; ``.clone()`` it first)."""
    for name, t in ts.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels need 16-byte aligned storage")


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def auto_block_rows(wp: int, dtype_bytes: int = 4, budget: int = 12 * 2**20) -> int:
    """The JAX package's panel-height rule: the largest power of two <= 256
    whose four (by, wp) f32 buffers fit a 12 MiB budget."""
    by = 256
    while by > 8 and 4 * by * wp * dtype_bytes > budget:
        by //= 2
    return by


def kernel_name(base: str, mask8: Optional[ArrayMask]) -> str:
    """A 2D kernel's name (launcher, launch and plain counts): ``*_custom``
    for the instantiation that takes a custom layout's int8 mask."""
    return base if mask8 is None else base + "_custom"


def kernel_geometry(launcher: str, nx: int, ny: int, mask_mode: str, hp: int, wp: int,
                    by: int, mask8: Optional[ArrayMask], device):
    """(launcher name, geometry arguments) of a 2D kernel on one layout:
    ``(nx, ny, gamma, hp, wp, by)`` for the gamma/rect instantiation, and
    for a custom layout the ``*_custom`` launcher with the int8 mask operand
    in the predicate's place, ``(mask, nx, ny, hp, wp, by)``."""
    if mask8 is None:
        return launcher, (nx, ny, int(mask_mode == "gamma"), hp, wp, by)
    if mask8.shape != (hp, wp):
        raise ValueError(f"mask8: expected shape {(hp, wp)}, got {mask8.shape}")
    return kernel_name(launcher, mask8), (_build.ptr(mask8.int8(device)), nx, ny, hp, wp, by)


TW = 128  # columns per CUDA block (csrc/common.cuh)
K1_TILE_ROWS = (32, 16, 8)  # K1's and A1's tile rows (csrc/cg_fused.cu, csrc/stencil.cu)
K2_TILE_ROWS = 8  # K2's and K2-pcg's
BLOCKS_PER_SM = 4  # K1's rule: the tallest tile that still gives this many blocks per SM


def tile_grid(kernel: str, padded_shape, block_rows: int, sm_count: int):
    """``(tile rows TJ, CUDA blocks)`` of K1 (``kernel="k1"``) or K2 / K2-pcg
    (``"k2"``) on a layout, for a card of ``sm_count`` SMs. A block owns a
    tile of TJ rows by ``TW`` columns, TJ a divisor of the band height
    ``block_rows``, and emits one partial. K2 always takes ``K2_TILE_ROWS``;
    K1, whose 8 B/node make the tile's two halo rows dear, the tallest of
    ``K1_TILE_ROWS`` that dividing ``block_rows`` still gives
    ``BLOCKS_PER_SM`` blocks per SM, else the shortest that divides it (a
    grid too small to fill the card)."""
    hp, wp = padded_shape
    fits = [tj for tj in (K1_TILE_ROWS if kernel == "k1" else (K2_TILE_ROWS,))
            if block_rows % tj == 0]
    if not fits:
        raise ValueError(f"block_rows {block_rows}: K1/K2 need a multiple of {K2_TILE_ROWS}")
    tj = next((t for t in fits if (hp // t) * (wp // TW) >= BLOCKS_PER_SM * sm_count), fits[-1])
    return tj, (hp // tj) * (wp // TW)


@dataclass(frozen=True, eq=False)
class PaddedStencilOperator:
    nx: int
    ny: int
    coeffs: Tuple[float, float, float]  # (cd, cx, cy)
    grid_shape: Tuple[int, int]  # unpadded
    padded_shape: Tuple[int, int]
    block_rows: int
    mask_mode: str  # 'gamma' | 'rect' | 'custom'
    mask8: Optional[ArrayMask] = None  # custom: the padded interior

    @staticmethod
    def from_domain(domain, block_rows: Optional[int] = None) -> "PaddedStencilOperator":
        h, w = domain.grid_shape
        wp = round_up(w, 128)
        by = block_rows or auto_block_rows(wp)
        custom = domain.shape == "custom"
        if custom:
            by = max(by, 32)  # the JAX package's int8 mask tiling
        hp = round_up(h, by)
        return PaddedStencilOperator(
            nx=domain.nx,
            ny=domain.ny,
            coeffs=(domain.coeff_diag, domain.coeff_x, domain.coeff_y),
            grid_shape=(h, w),
            padded_shape=(hp, wp),
            block_rows=by,
            mask_mode=domain.shape,
            mask8=domain.mask_spec.padded((hp, wp)) if custom else None,
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
    def mask_spec(self):
        """The padded interior: a :class:`MaskSpec`, or the custom ``mask8``."""
        if self.mask8 is not None:
            return self.mask8
        return MaskSpec(self.mask_mode, self.nx, self.ny, tuple(self.padded_shape))

    def interior_padded(self) -> np.ndarray:
        return self.mask_spec.build_host()

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.mask_spec.build(x.device), x, 0.0)

    def diagonal(self, device="cuda") -> torch.Tensor:
        """The stencil's diagonal on the padded layout (0 off the interior)."""
        return torch.where(self.mask_spec.build(device), self.coeffs[0], 0.0)

    def apply_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel's plain torch version: masked reads, masked output.
        (The JAX package's custom kernel masks only its panel and trusts its
        halo rows to be pre-masked; on pre-masked input, as every solver
        field is, the two agree.)"""
        _build.note_plain(kernel_name("stencil", self.mask8), x)
        cd, cx, cy = self.coeffs
        m = self.mask_spec.build(x.device)
        p = F.pad(torch.where(m, x, 0.0), (1, 1, 1, 1))
        y = cd * p[1:-1, 1:-1] + cx * (p[1:-1, :-2] + p[1:-1, 2:]) + cy * (p[:-2, 1:-1] + p[2:, 1:-1])
        return torch.where(m, y, 0.0)

    def tile_grid(self, sm_count: int):
        """``(tile rows TJ, CUDA blocks)`` of the kernel on this layout for a
        card of ``sm_count`` SMs: K1's rule (:func:`tile_grid`), a tile of TJ
        rows by 128 columns a block, TJ the tallest of 32, 16 and 8 that
        divides the canvas's rows and still puts four blocks on every SM.
        The tile reads its halo rows from x, so it need not keep to the
        bands."""
        hp = self.padded_shape[0]
        if hp % K1_TILE_ROWS[-1]:
            raise ValueError(f"padded rows {hp}: the stencil's tiles need a multiple of "
                             f"{K1_TILE_ROWS[-1]}")
        return tile_grid("k1", self.padded_shape, hp, sm_count)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A x`` on a contiguous f32 field of the padded shape."""
        check_field("x", x, self.padded_shape)
        if x.device.type == "cpu":
            return self.apply_plain(x)
        check_aligned(x=x)  # staged in 16-byte pieces
        hp, wp = self.padded_shape
        y = torch.empty_like(x)
        tj, _ = self.tile_grid(_build.sm_count(x.device))
        # the launchers take the tile rows in the band height's place
        name, geom = kernel_geometry("ist_stencil", self.nx, self.ny, self.mask_mode, hp, wp,
                                     tj, self.mask8, x.device)
        _build.launch(name, _build.ptr(x), _build.ptr(y), *geom, *self.coeffs)
        return y

    def nnz(self) -> int:
        """Stored-matrix-equivalent nonzero count (:func:`mask_nnz`)."""
        return mask_nnz(self.interior_padded())

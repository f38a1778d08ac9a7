"""Fused V-cycle legs of the multigrid fine levels (counterpart of iterative_solvers_tpu/kernels/mg_fused.py).

- **K_down** (:meth:`FusedLevelKernels.down`, CUDA ``csrc/mg_fused.cu``):
  pre-smoothing from zero (x = (ω/d)·b, never stored), the residual, the
  [1,2,1]/4 row and lane restrictions and the child's interior mask,
  written onto the child's input layout (``child_shape``: its padded
  canvas when the child is a fused level, else its grid).
- **K_up** (:meth:`FusedLevelKernels.up`): the child's correction as the
  child returns it (on ``child_shape``), prolonged along lanes then rows,
  the corrected iterate, one post-smoothing sweep; ``with_dot`` also
  returns (b, out), the PCG's rz.
- **K_jacobi** (:meth:`FusedLevelKernels.jacobi`): one weighted-Jacobi sweep
  ``x + (ω/d)(b − A x)`` with masked reads and output — the FMG warm
  start's fine-level polish.

A custom level (``mask8``, its padded interior; ``child_mask8``, the
child's interior on ``child_shape``) runs K_down and K_up as their
``*_custom`` instantiations, which replace the JAX package's
``_make_k_down_custom`` (C2) and ``_make_k_up_custom`` (C3): the int8 mask
is read where the gamma/rect kernels evaluate the predicate. The JAX bodies
trust the level RHS to be pre-masked (it is a masked restriction) and mask
by float multiplies; the port masks every read, which agrees on such input.
K_jacobi raises on a custom level, as the JAX package's does: its FMG
polishes custom levels with plain level ops.

The JAX package runs the lane (column) half of each transfer outside its
kernels, as banded MXU matmuls (``lane_restrict_mm``/``lane_prolong_mm``),
because Mosaic has no stride-2 lanes; here the legs do it. The plain torch
forms :func:`lane_restrict` and :func:`lane_prolong` (P = 2 Rᵀ exactly)
stay for the plain legs, the mesh (``parallel/mg_sharded.py``) and the FMG.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch.core.domain import ArrayMask, MaskSpec
from iterative_solvers_tpu_torch.kernels import _build
from iterative_solvers_tpu_torch.kernels.cg_fused import TW
from iterative_solvers_tpu_torch.kernels.stencil_layout import (
    check_field,
    kernel_geometry,
    kernel_name,
)

TILE_COLS = 64  # K_down's coarse columns per tile (K_up: TW fine columns)


def _stencil(x, cd, cx, cy):
    """Unmasked 5-point combination with zero outside the canvas."""
    p = F.pad(x, (1, 1, 1, 1))
    return cd * x + cx * (p[1:-1, :-2] + p[1:-1, 2:]) + cy * (p[:-2, 1:-1] + p[2:, 1:-1])


def tile_rows(rows: int, col_tiles: int, fine_rows_per_row: int, largest: int,
              sm_count: int) -> int:
    """The legs' coarse rows per tile, TJ in (16, 8, 4) up to ``largest``:
    the largest that still puts two blocks on every SM of a card of
    ``sm_count`` SMs, else 4 (one device's legs and the mesh blocks')."""
    want = 2 * sm_count
    for tj in (16, 8):
        if tj <= largest and -(-rows // (fine_rows_per_row * tj)) * col_tiles >= want:
            return tj
    return 4


@dataclass(frozen=True, eq=False)
class FusedLevelKernels:
    """Down/up legs of one V-cycle level on its padded layout."""

    nx: int
    ny: int
    coeffs: Tuple[float, float, float]  # (cd, cx, cy)
    cs: float  # ω / diag
    mask_mode: str
    padded_shape: Tuple[int, int]  # (hp, wp), hp % by == 0, wp % 128 == 0
    block_rows: int  # 32 at least on a custom level
    # the child's input layout: its padded canvas when it is a fused level,
    # else its grid (ny/2 + 1, nx/2 + 1)
    child_shape: Tuple[int, int]
    mask8: Optional[ArrayMask] = None  # custom: the padded interior
    child_mask8: Optional[ArrayMask] = None  # custom: the child's interior there

    def __post_init__(self):
        ch, cw = self.ny // 2 + 1, self.nx // 2 + 1
        ho, wo = self.coarse_shape
        if ho < ch or wo < cw:
            raise ValueError(f"child_shape {(ho, wo)} is smaller than the child grid {(ch, cw)}")
        if (self.mask8 is None) != (self.child_mask8 is None):
            raise ValueError("a custom level needs mask8 and child_mask8, others neither")
        if self.child_mask8 is not None and self.child_mask8.shape != (ho, wo):
            raise ValueError(f"child_mask8: expected shape {(ho, wo)}, "
                             f"got {self.child_mask8.shape}")

    @property
    def coarse_shape(self) -> Tuple[int, int]:
        """The layout of the coarse field K_down writes and K_up reads."""
        return tuple(self.child_shape)

    @property
    def mask_spec(self):
        if self.mask8 is not None:
            return self.mask8
        return MaskSpec(self.mask_mode, self.nx, self.ny, tuple(self.padded_shape))

    @property
    def child_spec(self):
        """The child's interior on :attr:`coarse_shape`."""
        if self.child_mask8 is not None:
            return self.child_mask8
        return MaskSpec(self.mask_mode, self.nx // 2, self.ny // 2, self.coarse_shape)

    def _geom(self, launcher: str, device, rows: Optional[int] = None):
        hp, wp = self.padded_shape
        return kernel_geometry(launcher, self.nx, self.ny, self.mask_mode, hp, wp,
                               rows or self.block_rows, self.mask8, device)

    # the tallest tiles, measured on an H100 at 8192² and 4096² (PERF.md
    # §6): K_down stages through registers, whose count caps the blocks
    # per SM of its masked form above TJ 4; K_up's two staged tiles cap
    # its blocks above TJ 8
    def down_tile_rows(self, device) -> int:
        ho, wo = self.coarse_shape
        return tile_rows(ho, -(-wo // TILE_COLS), 1, 16 if self.mask8 is None else 4,
                         _build.sm_count(device))

    def up_tile_rows(self, device) -> int:
        hp, wp = self.padded_shape
        return tile_rows(hp, wp // TW, 2, 8, _build.sm_count(device))

    # --- K_down ---------------------------------------------------------------

    def down_plain(self, b: torch.Tensor) -> torch.Tensor:
        _build.note_plain(kernel_name("k_down", self.mask8), b)
        cd, cx, cy = self.coeffs
        m = self.mask_spec.build(b.device)
        bm = torch.where(m, b, 0.0)
        R = torch.where(m, bm - _stencil(self.cs * bm, cd, cx, cy), 0.0)
        Rp = F.pad(R, (0, 0, 1, 0))  # row -1 is never interior
        rr = 0.25 * Rp[0:-1:2] + 0.5 * Rp[1::2] + 0.25 * Rp[2::2]
        ch, cw = self.ny // 2 + 1, self.nx // 2 + 1
        ho, wo = self.coarse_shape
        rc = F.pad(lane_restrict(rr[:ch], self.nx, cw), (0, wo - cw, 0, ho - ch))
        return torch.where(self.child_spec.build(b.device), rc, 0.0)

    def down(self, b: torch.Tensor) -> torch.Tensor:
        """The restricted residual of the pre-smoothed iterate, masked by the
        child's interior, on :attr:`coarse_shape`."""
        check_field("b", b, self.padded_shape)
        if b.device.type == "cpu":
            return self.down_plain(b)
        ho, wo = self.coarse_shape
        out = torch.empty((ho, wo), dtype=b.dtype, device=b.device)
        name, geom = self._geom("ist_k_down", b.device, self.down_tile_rows(b.device))
        cmask = () if self.mask8 is None else (_build.ptr(self.child_mask8.int8(b.device)),)
        _build.launch(name, _build.ptr(b), _build.ptr(out), *cmask, *geom, ho, wo,
                      *self.coeffs, self.cs)
        return out

    # --- K_up -----------------------------------------------------------------

    def up_plain(self, b, ec, with_dot=False):
        _build.note_plain(kernel_name("k_up", self.mask8), b)
        cd, cx, cy = self.coeffs
        hp, wp = self.padded_shape
        ch = self.ny // 2 + 1
        m = self.mask_spec.build(b.device)
        ecl = F.pad(lane_prolong(ec[:ch], self.nx // 2, wp), (0, 0, 0, hp // 2 - ch))
        nxt = torch.cat([ecl[1:], torch.zeros_like(ecl[:1])])
        p = torch.stack([ecl, 0.5 * (ecl + nxt)], dim=1).reshape(hp, wp)
        bm = torch.where(m, b, 0.0)
        xc = torch.where(m, self.cs * b + p, 0.0)
        R = torch.where(m, bm - _stencil(xc, cd, cx, cy), 0.0)
        out = torch.where(m, xc + self.cs * R, 0.0)
        if with_dot:
            g = hp // self.block_rows
            return out, torch.sum((bm * out).view(g, -1).sum(1))
        return out

    def up(self, b: torch.Tensor, ec: torch.Tensor, with_dot: bool = False):
        """Post-smoothed corrected iterate; ``ec`` is the child's correction
        on :attr:`coarse_shape`. With ``with_dot`` returns ``(out, (b, out))``
        (the block partials summed by one ``torch.sum``)."""
        hp, wp = self.padded_shape
        check_field("b", b, self.padded_shape)
        check_field("ec", ec, self.coarse_shape)
        if b.device != ec.device:
            raise ValueError("b and ec must be on one device")
        if b.device.type == "cpu":
            return self.up_plain(b, ec, with_dot)
        out = torch.empty_like(b)
        tj = self.up_tile_rows(b.device)
        dot_p = (
            torch.empty((-(-hp // (2 * tj)), wp // TW), dtype=b.dtype, device=b.device)
            if with_dot else None
        )
        name, geom = self._geom("ist_k_up", b.device, tj)
        _build.launch(
            name, _build.ptr(b), _build.ptr(ec), _build.ptr(out), _build.ptr(dot_p),
            *geom, self.coarse_shape[1], self.ny // 2 + 1, *self.coeffs, self.cs,
        )
        if with_dot:
            return out, torch.sum(dot_p)
        return out

    # --- K_jacobi -------------------------------------------------------------

    def jacobi_plain(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        _build.note_plain("k_jacobi", x)
        cd, cx, cy = self.coeffs
        m = self.mask_spec.build(x.device)
        xm = torch.where(m, x, 0.0)
        R = torch.where(m, torch.where(m, b, 0.0) - _stencil(xm, cd, cx, cy), 0.0)
        return torch.where(m, xm + self.cs * R, 0.0)

    def jacobi(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One weighted-Jacobi sweep on this level's padded layout
        (gamma/rect levels only, as in the JAX package)."""
        if self.mask8 is not None:
            raise NotImplementedError("jacobi kernel: algebraic masks only")
        check_field("x", x, self.padded_shape)
        check_field("b", b, self.padded_shape)
        if x.device != b.device:
            raise ValueError("x and b must be on one device")
        if x.device.type == "cpu":
            return self.jacobi_plain(x, b)
        out = torch.empty_like(x)
        name, geom = self._geom("ist_k_jacobi", x.device)
        _build.launch(name, _build.ptr(x), _build.ptr(b), _build.ptr(out), *geom,
                      *self.coeffs, self.cs)
        return out


def lane_restrict(rr: torch.Tensor, nx: int, wc_pad: int) -> torch.Tensor:
    """Lane-axis full weighting: coarse col c <- fine cols (2c-1, 2c, 2c+1)
    with weights [1,2,1]/4; output padded to ``wc_pad`` columns."""
    w = nx + 1
    wc = nx // 2 + 1
    p = F.pad(rr[:, :w], (1, 1))
    lo = p[:, 0 : 2 * wc - 1 : 2]
    mid = p[:, 1 : 2 * wc : 2]
    hi = p[:, 2 : 2 * wc + 1 : 2]
    return F.pad(0.25 * (lo + hi) + 0.5 * mid, (0, wc_pad - wc))


def lane_prolong(ec: torch.Tensor, cnx: int, w_pad: int) -> torch.Tensor:
    """Lane-axis linear interpolation, coarse width cnx+1 -> fine 2cnx+1,
    padded to ``w_pad``: even fine columns copy, odd ones average."""
    wc = cnx + 1
    a = ec[:, :wc]
    left, right = a[:, :-1], a[:, 1:]
    inter = torch.stack([left, 0.5 * (left + right)], dim=-1).reshape(a.shape[0], 2 * (wc - 1))
    out = torch.cat([inter, a[:, wc - 1 : wc]], dim=1)
    return F.pad(out, (0, w_pad - out.shape[1]))

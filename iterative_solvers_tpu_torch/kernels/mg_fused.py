"""Fused V-cycle legs of the multigrid fine levels (counterpart of iterative_solvers_tpu/kernels/mg_fused.py).

- **K_down** (:meth:`FusedLevelKernels.down`, CUDA ``csrc/mg_fused.cu``):
  pre-smoothing from zero (x = (ω/d)·b, never stored), the residual, and the
  [1,2,1]/4 row restriction, written as the ``(hp/2, wp)`` intermediate.
- **K_up** (:meth:`FusedLevelKernels.up`): row prolongation of the
  lane-prolonged coarse correction, the corrected iterate, one
  post-smoothing sweep; ``with_dot`` also returns (b, out), the PCG's rz.
- **K_jacobi** (:meth:`FusedLevelKernels.jacobi`): one weighted-Jacobi sweep
  ``x + (ω/d)(b − A x)`` with masked reads and output — the FMG warm
  start's fine-level polish.

A custom level (``mask8``, its padded interior) runs K_down and K_up as
their ``*_custom`` instantiations, which replace the JAX package's
``_make_k_down_custom`` (C2) and ``_make_k_up_custom`` (C3): the int8 mask
is read where the gamma/rect kernels evaluate the predicate. The JAX bodies
trust the level RHS to be pre-masked (it is a masked restriction) and mask
by float multiplies; the port masks every read, which agrees on such input.
K_jacobi raises on a custom level, as the JAX package's does: its FMG
polishes custom levels with plain level ops.

The lane (column) half of each transfer runs in plain torch as strided
slices (:func:`lane_restrict`, :func:`lane_prolong`), P = 2 Rᵀ exactly.
The JAX package's banded-matmul forms of these transfers exist only for the
TPU's matrix unit and are not ported.
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


def _stencil(x, cd, cx, cy):
    """Unmasked 5-point combination with zero outside the canvas."""
    p = F.pad(x, (1, 1, 1, 1))
    return cd * x + cx * (p[1:-1, :-2] + p[1:-1, 2:]) + cy * (p[:-2, 1:-1] + p[2:, 1:-1])


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
    mask8: Optional[ArrayMask] = None  # custom: the padded interior

    @property
    def mask_spec(self):
        if self.mask8 is not None:
            return self.mask8
        return MaskSpec(self.mask_mode, self.nx, self.ny, tuple(self.padded_shape))

    def _geom(self, launcher: str, device):
        hp, wp = self.padded_shape
        return kernel_geometry(launcher, self.nx, self.ny, self.mask_mode, hp, wp,
                               self.block_rows, self.mask8, device)

    # --- K_down ---------------------------------------------------------------

    def down_plain(self, b: torch.Tensor) -> torch.Tensor:
        _build.note_plain(kernel_name("k_down", self.mask8), b)
        cd, cx, cy = self.coeffs
        m = self.mask_spec.build(b.device)
        bm = torch.where(m, b, 0.0)
        R = torch.where(m, bm - _stencil(self.cs * bm, cd, cx, cy), 0.0)
        Rp = F.pad(R, (0, 0, 1, 0))  # row -1 is never interior
        return 0.25 * Rp[0:-1:2] + 0.5 * Rp[1::2] + 0.25 * Rp[2::2]

    def down(self, b: torch.Tensor) -> torch.Tensor:
        """Row-restricted residual of the pre-smoothed iterate, (hp/2, wp)."""
        check_field("b", b, self.padded_shape)
        if b.device.type == "cpu":
            return self.down_plain(b)
        hp, wp = self.padded_shape
        rr = torch.empty((hp // 2, wp), dtype=b.dtype, device=b.device)
        name, geom = self._geom("ist_k_down", b.device)
        _build.launch(name, _build.ptr(b), _build.ptr(rr), *geom, *self.coeffs, self.cs)
        return rr

    # --- K_up -----------------------------------------------------------------

    def up_plain(self, b, ec_lanes, with_dot=False):
        _build.note_plain(kernel_name("k_up", self.mask8), b)
        cd, cx, cy = self.coeffs
        hp, wp = self.padded_shape
        ch = self.ny // 2 + 1
        m = self.mask_spec.build(b.device)
        ec = ec_lanes.clone()
        ec[ch:] = 0.0  # rows outside the coarse grid
        nxt = torch.cat([ec[1:], torch.zeros_like(ec[:1])])
        p = torch.stack([ec, 0.5 * (ec + nxt)], dim=1).reshape(hp, wp)
        bm = torch.where(m, b, 0.0)
        xc = torch.where(m, self.cs * b + p, 0.0)
        R = torch.where(m, bm - _stencil(xc, cd, cx, cy), 0.0)
        out = torch.where(m, xc + self.cs * R, 0.0)
        if with_dot:
            g = hp // self.block_rows
            return out, torch.sum((bm * out).view(g, -1).sum(1))
        return out

    def up(self, b: torch.Tensor, ec_lanes: torch.Tensor, with_dot: bool = False):
        """Post-smoothed corrected iterate; ``ec_lanes`` is the lane-prolonged
        coarse correction on this level's (hp/2, wp) row layout. With
        ``with_dot`` returns ``(out, (b, out))``."""
        hp, wp = self.padded_shape
        check_field("b", b, self.padded_shape)
        check_field("ec_lanes", ec_lanes, (hp // 2, wp))
        if b.device != ec_lanes.device:
            raise ValueError("b and ec_lanes must be on one device")
        if b.device.type == "cpu":
            return self.up_plain(b, ec_lanes, with_dot)
        out = torch.empty_like(b)
        dot_p = (
            torch.empty((hp // self.block_rows, wp // TW), dtype=b.dtype, device=b.device)
            if with_dot else None
        )
        name, geom = self._geom("ist_k_up", b.device)
        _build.launch(
            name, _build.ptr(b), _build.ptr(ec_lanes), _build.ptr(out), _build.ptr(dot_p),
            *geom, self.ny // 2 + 1, *self.coeffs, self.cs,
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

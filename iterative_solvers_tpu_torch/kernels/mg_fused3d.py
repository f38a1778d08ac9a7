"""Fused legs of the 3D V-cycle's fine levels (counterpart of iterative_solvers_tpu/kernels/mg_fused3d.py).

- **D3** (:meth:`FusedLevelKernels3D.down`, CUDA ``csrc/mg_fused3d.cu``):
  pre-smoothing from zero (x = (ω/d)·b, never stored), the residual, and the
  [1,2,1]/4 z-restriction, written as the half-depth ``(dc, hp, wp)``
  intermediate, ``dc = nz/2 + 1``.
- **U3** (:meth:`FusedLevelKernels3D.up`): z-prolongation of the y/x-prolonged
  coarse correction, the corrected iterate and one post-smoothing sweep.
- **J3** (:meth:`FusedLevelKernels3D.jacobi`): one weighted-Jacobi sweep
  ``x + (ω/d)(b − A x)`` with masked reads and output — the FMG warm start's
  fine-level polish.

The JAX package splits each leg into a per-plane and a z-chunked Pallas body
(plus a separate z-restriction pass) to fit VMEM; the port's kernels march z
and take any depth, so one kernel serves both bodies. The y/x half of each transfer runs in plain torch
(``solvers/multigrid._FusedLevel3D``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch.core.domain import MaskSpec
from iterative_solvers_tpu_torch.kernels import _build
from iterative_solvers_tpu_torch.kernels.stencil3d_layout import zmarch_depth
from iterative_solvers_tpu_torch.kernels.stencil_layout import check_field
from iterative_solvers_tpu_torch.ops.stencil import stencil_apply_3d


@dataclass(frozen=True, eq=False)
class FusedLevelKernels3D:
    """Down/up legs and the Jacobi sweep of one 3D level on its padded layout."""

    nx: int
    ny: int
    nz: int
    coeffs: Tuple[float, float, float, float]  # (cd, cx, cy, cz)
    cs: float  # ω / diag
    padded_shape: Tuple[int, int, int]  # (d, hp, wp); d = nz + 1 exact

    @property
    def mask_spec(self) -> MaskSpec:
        return MaskSpec("box", self.nx, self.ny, tuple(self.padded_shape), nz=self.nz)

    @property
    def dc(self) -> int:
        return self.nz // 2 + 1

    def _geom(self, planes: int):
        """(nx, ny, nz, d, hp, wp, bz): ``bz`` planes per block of a launch
        whose grid covers ``planes`` z-planes."""
        d, hp, wp = self.padded_shape
        return (self.nx, self.ny, self.nz, d, hp, wp, zmarch_depth(planes, hp, wp))

    # --- D3 ---------------------------------------------------------------------

    def down_plain(self, b: torch.Tensor) -> torch.Tensor:
        _build.note_plain("k_down3d", b)
        m = self.mask_spec.build(b.device)
        bm = torch.where(m, b, 0.0)
        R = torch.where(m, bm - stencil_apply_3d(self.cs * bm, m, *self.coeffs), 0.0)
        Rp = F.pad(R, (0, 0, 0, 0, 1, 1))  # planes -1 and d are never interior
        n = 2 * self.dc
        return 0.25 * Rp[0 : n - 1 : 2] + 0.5 * Rp[1:n:2] + 0.25 * Rp[2 : n + 1 : 2]

    def down(self, b: torch.Tensor) -> torch.Tensor:
        """z-restricted residual of the pre-smoothed iterate, (dc, hp, wp)."""
        check_field("b", b, self.padded_shape)
        if b.device.type == "cpu":
            return self.down_plain(b)
        _, hp, wp = self.padded_shape
        rr = torch.empty((self.dc, hp, wp), dtype=b.dtype, device=b.device)
        _build.launch("ist_k_down3d", _build.ptr(b), _build.ptr(rr), *self._geom(self.dc),
                      self.dc, *self.coeffs, self.cs)
        return rr

    # --- U3 ---------------------------------------------------------------------

    def up_plain(self, b: torch.Tensor, ec_yx: torch.Tensor) -> torch.Tensor:
        _build.note_plain("k_up3d", b)
        m = self.mask_spec.build(b.device)
        lo, hi = ec_yx[:-1], ec_yx[1:]
        d, hp, wp = self.padded_shape
        inter = torch.stack([lo, 0.5 * (lo + hi)], dim=1).reshape(d - 1, hp, wp)
        pz = torch.cat([inter, ec_yx[-1:]])  # even planes copy, odd ones average
        bm = torch.where(m, b, 0.0)
        xc = torch.where(m, self.cs * bm + pz, 0.0)
        R = torch.where(m, bm - stencil_apply_3d(xc, m, *self.coeffs), 0.0)
        return torch.where(m, xc + self.cs * R, 0.0)

    def up(self, b: torch.Tensor, ec_yx: torch.Tensor) -> torch.Tensor:
        """Post-smoothed corrected iterate; ``ec_yx`` is the y/x-prolonged
        coarse correction on this level's (dc, hp, wp) layout."""
        _, hp, wp = self.padded_shape
        check_field("b", b, self.padded_shape)
        check_field("ec_yx", ec_yx, (self.dc, hp, wp))
        if b.device != ec_yx.device:
            raise ValueError("b and ec_yx must be on one device")
        if b.device.type == "cpu":
            return self.up_plain(b, ec_yx)
        out = torch.empty_like(b)
        _build.launch("ist_k_up3d", _build.ptr(b), _build.ptr(ec_yx), _build.ptr(out),
                      *self._geom(self.padded_shape[0]), self.dc, *self.coeffs, self.cs)
        return out

    # --- J3 ---------------------------------------------------------------------

    def jacobi_plain(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        _build.note_plain("k_jacobi3d", x)
        m = self.mask_spec.build(x.device)
        xm = torch.where(m, x, 0.0)
        R = torch.where(m, torch.where(m, b, 0.0) - stencil_apply_3d(xm, m, *self.coeffs), 0.0)
        return torch.where(m, xm + self.cs * R, 0.0)

    def jacobi(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One weighted-Jacobi sweep on this level's padded layout."""
        check_field("x", x, self.padded_shape)
        check_field("b", b, self.padded_shape)
        if x.device != b.device:
            raise ValueError("x and b must be on one device")
        if x.device.type == "cpu":
            return self.jacobi_plain(x, b)
        out = torch.empty_like(x)
        _build.launch("ist_k_jacobi3d", _build.ptr(x), _build.ptr(b), _build.ptr(out),
                      *self._geom(self.padded_shape[0]), *self.coeffs, self.cs)
        return out

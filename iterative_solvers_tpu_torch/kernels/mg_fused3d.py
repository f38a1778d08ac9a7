"""Fused legs of the 3D V-cycle's fine levels (counterpart of iterative_solvers_tpu/kernels/mg_fused3d.py).

- **D3** (:meth:`FusedLevelKernels3D.down`, CUDA ``csrc/mg_fused3d.cu``):
  pre-smoothing from zero (x = (ω/d)·b, never stored), the residual, the
  [1,2,1]/4 restriction along z, then y, then x, and the child's interior
  mask, written onto the child's input layout (``child_shape``: its padded
  canvas when the child is a fused level, else its grid).
- **U3** (:meth:`FusedLevelKernels3D.up`): the child's correction as the
  child returns it (on ``child_shape``), prolonged along y, then x, then z,
  the corrected iterate and one post-smoothing sweep.
- **J3** (:meth:`FusedLevelKernels3D.jacobi`): one weighted-Jacobi sweep
  ``x + (ω/d)(b − A x)`` with masked reads and output — the FMG warm start's
  fine-level polish. It is S7's staged z-march (``csrc/zstream3d.cuh``) with
  ``b`` read at the node, chunked by
  :func:`~iterative_solvers_tpu_torch.kernels.stencil3d_layout.zstream_chunk`.

The JAX package splits each leg into a per-plane and a z-chunked Pallas body
(plus a separate z-restriction pass) to fit VMEM, and runs the y/x half of
each transfer outside its kernels as banded MXU matmuls; the port's legs
march z, take any depth and do the y/x transfers themselves, so a fused
level's leg is ``down → child → up`` with nothing in between. The plain
torch forms :func:`restrict_yx` and :func:`prolong_yx` (P = 2 Rᵀ per axis)
define the legs' transfers in their plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch.core.domain import MaskSpec
from iterative_solvers_tpu_torch.kernels import _build
from iterative_solvers_tpu_torch.kernels.stencil3d_layout import zstream_chunk
from iterative_solvers_tpu_torch.kernels.stencil_layout import check_aligned, check_field
from iterative_solvers_tpu_torch.ops.stencil import stencil_apply_3d

# the legs' tiles (csrc/mg_fused3d.cu): D3 4 coarse rows x 64 coarse
# columns, U3 8 fine rows x 128 fine columns
DOWN_TILE = (4, 64)
UP_TILE = (8, 128)


def restrict_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Full weighting along one axis: fine extent 2nc+1 -> nc+1, [1,2,1]/4."""
    nc1 = (a.shape[axis] - 1) // 2 + 1
    pad = [0, 0] * a.ndim
    pad[2 * (a.ndim - 1 - axis)] = pad[2 * (a.ndim - 1 - axis) + 1] = 1
    p = F.pad(a, pad)
    lo = p.narrow(axis, 0, 2 * nc1 - 1)[(slice(None),) * axis + (slice(None, None, 2),)]
    mid = p.narrow(axis, 1, 2 * nc1 - 1)[(slice(None),) * axis + (slice(None, None, 2),)]
    hi = p.narrow(axis, 2, 2 * nc1 - 1)[(slice(None),) * axis + (slice(None, None, 2),)]
    return 0.25 * (lo + hi) + 0.5 * mid


def restrict_yx(rr: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(dc, ≥h, ≥w) z-restricted residual -> (dc, hc, wc) child field: full
    weighting along y, then x, on the (h, w) grid (no crop copy)."""
    return restrict_axis(restrict_axis(rr[:, :h, :w], 1), 2)


def prolong_yx(ec: torch.Tensor, h: int, w: int, hp: int, wp: int) -> torch.Tensor:
    """(dc, hc, wc) child correction -> (dc, hp, wp): linear interpolation
    along y, then x, written by stride-2 slices straight into the
    zero-padded layout (P = 2 Rᵀ per axis, every weight a power of two)."""
    dc = ec.shape[0]
    t = ec.new_empty((dc, h, ec.shape[2]))
    t[:, 0::2] = ec
    t[:, 1::2] = 0.5 * (ec[:, :-1] + ec[:, 1:])
    out = ec.new_zeros((dc, hp, wp))
    out[:, :h, 0:w:2] = t
    out[:, :h, 1:w:2] = 0.5 * (t[:, :, :-1] + t[:, :, 1:])
    return out


def leg_chunk(planes: int, tiles: int, device, lo: int, hi: int, even: bool = False) -> int:
    """Planes per block of a leg whose grid has ``tiles`` (y, x) tiles over
    ``planes`` planes: enough z-chunks for ~16 blocks per SM of ``device``,
    each chunk ``lo`` to ``hi`` planes deep (even when ``even``), so the
    chunks' warm-up planes stay a small share and every level fills the card."""
    want = 16 * _build.sm_count(device)
    bz = max(lo, min(hi, -(-planes * tiles // want)))
    return bz + (bz & 1) if even else bz


@dataclass(frozen=True, eq=False)
class FusedLevelKernels3D:
    """Down/up legs and the Jacobi sweep of one 3D level on its padded layout."""

    nx: int
    ny: int
    nz: int
    coeffs: Tuple[float, float, float, float]  # (cd, cx, cy, cz)
    cs: float  # ω / diag
    padded_shape: Tuple[int, int, int]  # (d, hp, wp); d = nz + 1 exact
    # the child's input layout: its padded canvas (dc, hcp, wcp) when it is
    # a fused level, else its grid (dc, hc, wc)
    child_shape: Tuple[int, int, int]

    def __post_init__(self):
        dc, ho, wo = self.coarse_shape
        if dc != self.dc or ho < self.ny // 2 + 1 or wo < self.nx // 2 + 1:
            raise ValueError(f"child_shape {self.coarse_shape} does not hold the child grid "
                             f"{(self.dc, self.ny // 2 + 1, self.nx // 2 + 1)}")

    @property
    def coarse_shape(self) -> Tuple[int, int, int]:
        """The layout of the coarse field D3 writes and U3 reads."""
        return tuple(self.child_shape)

    @property
    def mask_spec(self) -> MaskSpec:
        return MaskSpec("box", self.nx, self.ny, tuple(self.padded_shape), nz=self.nz)

    @property
    def child_spec(self) -> MaskSpec:
        """The child's interior on :attr:`coarse_shape`."""
        return MaskSpec("box", self.nx // 2, self.ny // 2, self.coarse_shape, nz=self.nz // 2)

    @property
    def dc(self) -> int:
        return self.nz // 2 + 1

    # --- D3 ---------------------------------------------------------------------

    def down_plain(self, b: torch.Tensor) -> torch.Tensor:
        _build.note_plain("k_down3d", b)
        m = self.mask_spec.build(b.device)
        bm = torch.where(m, b, 0.0)
        R = torch.where(m, bm - stencil_apply_3d(self.cs * bm, m, *self.coeffs), 0.0)
        Rp = F.pad(R, (0, 0, 0, 0, 1, 1))  # planes -1 and d are never interior
        n = 2 * self.dc
        rr = 0.25 * Rp[0 : n - 1 : 2] + 0.5 * Rp[1:n:2] + 0.25 * Rp[2 : n + 1 : 2]
        rc = restrict_yx(rr, self.ny + 1, self.nx + 1)
        _, ho, wo = self.coarse_shape
        rc = F.pad(rc, (0, wo - rc.shape[2], 0, ho - rc.shape[1]))
        return torch.where(self.child_spec.build(b.device), rc, 0.0)

    def down(self, b: torch.Tensor) -> torch.Tensor:
        """The restricted residual of the pre-smoothed iterate, masked by the
        child's interior, on :attr:`coarse_shape`."""
        check_field("b", b, self.padded_shape)
        if b.device.type == "cpu":
            return self.down_plain(b)
        check_aligned(b=b)
        dc, ho, wo = self.coarse_shape
        out = torch.empty((dc, ho, wo), dtype=b.dtype, device=b.device)
        tiles = -(-ho // DOWN_TILE[0]) * -(-wo // DOWN_TILE[1])
        d, hp, wp = self.padded_shape
        _build.launch("ist_k_down3d", _build.ptr(b), _build.ptr(out), self.nx, self.ny,
                      self.nz, d, hp, wp, leg_chunk(dc, tiles, b.device, 4, 32), dc, ho, wo,
                      *self.coeffs, self.cs)
        return out

    # --- U3 ---------------------------------------------------------------------

    def up_plain(self, b: torch.Tensor, ec: torch.Tensor) -> torch.Tensor:
        _build.note_plain("k_up3d", b)
        m = self.mask_spec.build(b.device)
        d, hp, wp = self.padded_shape
        ec_yx = prolong_yx(ec[:, : self.ny // 2 + 1, : self.nx // 2 + 1], self.ny + 1,
                           self.nx + 1, hp, wp)
        lo, hi = ec_yx[:-1], ec_yx[1:]
        inter = torch.stack([lo, 0.5 * (lo + hi)], dim=1).reshape(d - 1, hp, wp)
        pz = torch.cat([inter, ec_yx[-1:]])  # even planes copy, odd ones average
        bm = torch.where(m, b, 0.0)
        xc = torch.where(m, self.cs * bm + pz, 0.0)
        R = torch.where(m, bm - stencil_apply_3d(xc, m, *self.coeffs), 0.0)
        return torch.where(m, xc + self.cs * R, 0.0)

    def up(self, b: torch.Tensor, ec: torch.Tensor) -> torch.Tensor:
        """Post-smoothed corrected iterate; ``ec`` is the child's correction
        on :attr:`coarse_shape`."""
        check_field("b", b, self.padded_shape)
        check_field("ec", ec, self.coarse_shape)
        if b.device != ec.device:
            raise ValueError("b and ec must be on one device")
        if b.device.type == "cpu":
            return self.up_plain(b, ec)
        check_aligned(b=b, ec=ec)
        out = torch.empty_like(b)
        d, hp, wp = self.padded_shape
        tiles = (hp // UP_TILE[0]) * (wp // UP_TILE[1])
        _build.launch("ist_k_up3d", _build.ptr(b), _build.ptr(ec), _build.ptr(out), self.nx,
                      self.ny, self.nz, d, hp, wp, leg_chunk(d, tiles, b.device, 8, 64, True),
                      *self.coarse_shape, *self.coeffs, self.cs)
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
        check_aligned(x=x, b=b)
        out = torch.empty_like(x)
        d, hp, wp = self.padded_shape
        bz = zstream_chunk(d, hp, wp, _build.sm_count(x.device))
        _build.launch("ist_k_jacobi3d", _build.ptr(x), _build.ptr(b), _build.ptr(out), self.nx,
                      self.ny, self.nz, d, hp, wp, bz, *self.coeffs, self.cs)
        return out

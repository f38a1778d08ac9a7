"""Fused two-kernel PCG iteration (counterpart of iterative_solvers_tpu/kernels/cg_fused.py).

- **K1** (:func:`k1`, CUDA ``csrc/cg_fused.cu``): forms ``z_k = d + β·z_prev``
  and ``A z_k`` in registers and emits per-block partials of (d, z_k),
  (A z_k, z_k), ‖z_k‖∞, plus each band's two z_k halo rows into a side buffer
  ``(g, 2, wp)``. Read-only on the fields; Az is never stored.
- **K2-pcg** (:func:`k2_pcg`): recomputes z_k = w + β·z_prev and A z_k, using
  K1's side rows at the band edges, and writes ``x + α z_k``, ``r − α A z_k``
  and z_k to fresh buffers, with partials of ‖r‖² and ‖r‖∞.

Each wrapper launches its kernel on a CUDA tensor and runs its plain torch
version (``*_plain``, the same arithmetic on the whole canvas at once) on a
CPU tensor; any other device raises. Partial sums are reduced afterwards in
a fixed order with ``torch.sum``/``torch.amax`` — no float atomics, so a
trajectory repeats bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch.kernels import _build
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.solvers.cg import CGState

TW = 128  # columns per CUDA block (csrc/common.cuh)


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


def _scalar(name: str, t: torch.Tensor, device) -> None:
    if t.dtype != torch.float32 or t.device != device:
        raise TypeError(f"{name}: expected a float32 tensor on {device}")


def stencil_banded(zk, up_rows, dn_rows, mask, coeffs, by):
    """Masked ``A z_k`` where the rows just outside each band of ``by`` rows
    come from ``up_rows``/``dn_rows`` (g, wp) instead of the neighbouring band
    — the plain form of the kernels' band-local stencil."""
    cd, cx, cy = coeffs
    hp, wp = zk.shape
    g = hp // by
    up = torch.cat([zk[:1], zk[:-1]]).view(g, by, wp).clone()
    up[:, 0] = up_rows
    dn = torch.cat([zk[1:], zk[-1:]]).view(g, by, wp).clone()
    dn[:, -1] = dn_rows
    lr = F.pad(zk, (1, 1))
    y = cd * zk + cx * (lr[:, :-2] + lr[:, 2:]) + cy * (up.view(hp, wp) + dn.view(hp, wp))
    return torch.where(mask, y, 0.0)


def k1_plain(d, zp, beta, op: PaddedStencilOperator):
    _build.note_plain("k1", d)
    hp, wp = op.padded_shape
    by = op.block_rows
    g = hp // by
    mask = op.mask_spec.build(d.device)
    zk = d + beta * zp
    # halo rows row0-1 and row0+by of each band, masked by their own row
    zpad = F.pad(torch.where(mask, zk, 0.0), (0, 0, 1, 1))
    up, dn = zpad[0:hp:by], zpad[by + 1 :: by]
    side = torch.stack([up, dn], dim=1)
    az = stencil_banded(zk, up, dn, mask, op.coeffs, by)
    rz_p = (d * zk).view(g, -1).sum(1)
    azz_p = (az * zk).view(g, -1).sum(1)
    zmax_p = zk.abs().view(g, -1).amax(1)
    return side, rz_p, azz_p, zmax_p


def k1(d, zp, beta, op: PaddedStencilOperator):
    """K1: ``(side, rz_p, azz_p, zmax_p)`` for ``z_k = d + β z_prev``; ``beta``
    is a 0-dim float32 tensor on the fields' device."""
    shape = op.padded_shape
    check_field("d", d, shape)
    check_field("z_prev", zp, shape)
    _scalar("beta", beta, d.device)
    if d.device.type == "cpu":
        return k1_plain(d, zp, beta, op)
    hp, wp = shape
    by = op.block_rows
    g = hp // by
    side = torch.empty((g, 2, wp), dtype=d.dtype, device=d.device)
    parts = torch.empty((3, g, wp // TW), dtype=d.dtype, device=d.device)
    beta = beta.contiguous()
    p = _build.ptr
    _build.launch(
        "ist_k1", p(d), p(zp), p(beta), p(side), p(parts[0]), p(parts[1]), p(parts[2]),
        op.nx, op.ny, int(op.mask_mode == "gamma"), hp, wp, by, *op.coeffs,
    )
    return side, parts[0], parts[1], parts[2]


def k2_pcg_plain(x, r, zp, w, side, scal, op: PaddedStencilOperator):
    _build.note_plain("k2_pcg", x)
    hp, _ = op.padded_shape
    g = hp // op.block_rows
    alpha, beta = scal[0], scal[1]
    mask = op.mask_spec.build(x.device)
    zk = w + beta * zp
    az = stencil_banded(zk, side[:, 0], side[:, 1], mask, op.coeffs, op.block_rows)
    xn = x + alpha * zk
    rn = r - alpha * az
    return xn, rn, zk, (rn * rn).view(g, -1).sum(1), rn.abs().view(g, -1).amax(1)


def k2_pcg(x, r, zp, w, side, scal, op: PaddedStencilOperator):
    """K2-pcg: ``(x', r', z_k, r2_p, rmax_p)``; ``scal`` = [α, β] (float32,
    on the fields' device). Inputs are left untouched."""
    shape = op.padded_shape
    for name, t in (("x", x), ("r", r), ("z_prev", zp), ("w", w)):
        check_field(name, t, shape)
    hp, wp = shape
    by = op.block_rows
    g = hp // by
    check_field("side", side, (g, 2, wp))
    if scal.dtype != torch.float32 or scal.shape != (2,) or scal.device != x.device:
        raise TypeError("scal: expected float32 [alpha, beta] on the fields' device")
    if x.device.type == "cpu":
        return k2_pcg_plain(x, r, zp, w, side, scal, op)
    xo, ro, zo = (torch.empty_like(x) for _ in range(3))
    parts = torch.empty((2, g, wp // TW), dtype=x.dtype, device=x.device)
    scal = scal.contiguous()
    p = _build.ptr
    _build.launch(
        "ist_k2_pcg", p(x), p(r), p(zp), p(w), p(side), p(scal), p(xo), p(ro), p(zo),
        p(parts[0]), p(parts[1]),
        op.nx, op.ny, int(op.mask_mode == "gamma"), hp, wp, by, *op.coeffs,
    )
    return xo, ro, zo, parts[0], parts[1]


@dataclass(frozen=True, eq=False)
class FusedCGEngine:
    """Fused PCG iteration for one padded layout: K1, K2-pcg and one
    preconditioner application (``M.call_with_dot``) per iteration. β is
    deferred as in the JAX engine: β_k = (r_k, w_k)/(r_{k−1}, w_{k−1})."""

    op: PaddedStencilOperator
    M: Optional[object] = None

    def iteration(self, state: CGState, u_true=None) -> CGState:
        if self.M is None or u_true is not None:
            raise NotImplementedError(
                "the plain-CG fused iteration and its error norm run on kernel A3, "
                "not ported yet (ROADMAP Queue 1 item 4)"
            )
        if state.k == 0:
            beta = torch.zeros((), dtype=state.r.dtype, device=state.r.device)
        else:
            beta = (state.rz / state.rz_prev).to(state.r.dtype)
        # K1 forms z_k from w (in d's slot); its (w, z_k) dot is not the PCG rz
        side, _, azz_p, zmax_p = k1(state.w, state.z, beta, self.op)
        azz = torch.sum(azz_p)
        zmax = torch.amax(zmax_p)
        alpha = state.rz / azz
        xn, rn, zk, r2_p, rmax_p = k2_pcg(
            state.x, state.r, state.z, state.w, side, torch.stack([alpha, beta]), self.op
        )
        wn, rz_new = self.M.call_with_dot(rn)
        return state._replace(
            x=xn,
            r=rn,
            z=zk,
            w=wn,
            k=state.k + 1,
            rz=rz_new,
            rz_prev=state.rz,
            r_norm2=torch.sum(r2_p),
            prec_max=torch.abs(alpha) * zmax,
            r_max=torch.amax(rmax_p),
            err_max=torch.full((), float("inf"), dtype=rn.dtype, device=rn.device),
        )


def _engine_for(op: PaddedStencilOperator, M) -> FusedCGEngine:
    """The engine for an (operator, preconditioner) pair. The JAX package
    memoises this to hit its compile cache; eager PyTorch has none to hit."""
    return FusedCGEngine(op, M)

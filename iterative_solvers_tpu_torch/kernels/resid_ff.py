"""Fused double-f32 true residual (counterpart of iterative_solvers_tpu/kernels/resid_ff.py, 2D).

:func:`resid_ff` computes ``(rh, rl) = (bh + bl) − A·(xh + xl)`` on the
padded layout in one pass: the CUDA kernel ``csrc/resid_ff.cu`` on CUDA
tensors, its plain version (:func:`~iterative_solvers_tpu_torch.ops.ddf32.residual_ff`
on the padded mask) on CPU tensors. The double-f32 outer loop
(solvers/refine.py) takes every true residual through it.
"""

from __future__ import annotations

import torch

from iterative_solvers_tpu_torch.kernels import _build
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator, check_field
from iterative_solvers_tpu_torch.ops.ddf32 import Pair, coeff_delta, coeff_split, is_pow2, residual_ff


def resid_ff_plain(xh, xl, bh, bl, op: PaddedStencilOperator) -> Pair:
    _build.note_plain("k_resid_ff", xh)
    return residual_ff(op.mask_spec.build(xh.device), op.coeffs, (bh, bl), (xh, xl))


def resid_ff(xh, xl, bh, bl, op: PaddedStencilOperator) -> Pair:
    """``(rh, rl)`` for f32 pairs on ``op``'s padded layout, masked to the
    interior; inputs are left untouched."""
    for name, t in (("xh", xh), ("xl", xl), ("bh", bh), ("bl", bl)):
        check_field(name, t, op.padded_shape)
        if t.device != xh.device:
            raise ValueError(f"{name}: expected a tensor on {xh.device}")
    if xh.device.type == "cpu":
        return resid_ff_plain(xh, xl, bh, bl, op)
    hp, wp = op.padded_shape
    cd, cx, cy = op.coeffs
    _, cx_hi, cx_lo, cx_res = coeff_split(cx)
    _, cy_hi, cy_lo, cy_res = coeff_split(cy)
    delta = coeff_delta(op.coeffs)
    rh, rl = torch.empty_like(xh), torch.empty_like(xh)
    p = _build.ptr
    _build.launch(
        "ist_k_resid_ff", p(xh), p(xl), p(bh), p(bl), p(rh), p(rl),
        op.nx, op.ny, int(op.mask_mode == "gamma"), hp, wp, op.block_rows,
        int(is_pow2(cx)), int(is_pow2(cy)), int(delta != 0.0),
        cd, cx, cy, cx_hi, cx_lo, cx_res, cy_hi, cy_lo, cy_res, delta,
    )
    return rh, rl

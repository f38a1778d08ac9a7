"""Fused double-f32 true residual (counterpart of iterative_solvers_tpu/kernels/resid_ff.py).

:func:`resid_ff` computes ``(rh, rl) = (bh + bl) − A·(xh + xl)`` on the
padded layout in one pass: the CUDA kernels of ``csrc/resid_ff.cu`` on CUDA
tensors (A8 on a 2D :class:`PaddedStencilOperator`, R3 on a 3D
:class:`Padded3DStencilOperator`, on the staged z-march of
``csrc/zstream3d.cuh``, its chunk depth from :func:`zstream_chunk`), their plain version
(:func:`~iterative_solvers_tpu_torch.ops.ddf32.residual_ff` on the padded
mask) on CPU tensors. The double-f32 outer loop (solvers/refine.py) takes
every true residual through it.

On a custom 2D layout it launches A8's ``k_resid_ff_custom`` instantiation,
which reads the int8 mask where A8 evaluates the gamma/rect predicate and
computes exactly ``residual_ff`` on that interior (the JAX package runs the
jnp ``ops/ddf32.residual_ff`` there; the port keeps the kernel).
"""

from __future__ import annotations

import torch

from iterative_solvers_tpu_torch.kernels import _build
from iterative_solvers_tpu_torch.kernels.stencil3d_layout import zstream_chunk
from iterative_solvers_tpu_torch.kernels.stencil_layout import (
    check_aligned,
    check_field,
    kernel_geometry,
    kernel_name,
)
from iterative_solvers_tpu_torch.ops.ddf32 import Pair, coeff_delta, coeff_split, is_pow2, residual_ff


def resid_ff_plain(xh, xl, bh, bl, op) -> Pair:
    is3d = len(op.padded_shape) == 3
    _build.note_plain("k_resid_ff3d" if is3d else kernel_name("k_resid_ff", op.mask8), xh)
    return residual_ff(op.mask_spec.build(xh.device), op.coeffs, (bh, bl), (xh, xl))


def resid_ff(xh, xl, bh, bl, op) -> Pair:
    """``(rh, rl)`` for f32 pairs on ``op``'s padded layout (2D or 3D),
    masked to the interior; inputs are left untouched."""
    for name, t in (("xh", xh), ("xl", xl), ("bh", bh), ("bl", bl)):
        check_field(name, t, op.padded_shape)
        if t.device != xh.device:
            raise ValueError(f"{name}: expected a tensor on {xh.device}")
    if xh.device.type == "cpu":
        return resid_ff_plain(xh, xl, bh, bl, op)
    splits = [coeff_split(c) for c in op.coeffs[1:]]  # per axis, x first
    delta = coeff_delta(op.coeffs)
    rh, rl = torch.empty_like(xh), torch.empty_like(xh)
    p = _build.ptr
    ptrs = (p(xh), p(xl), p(bh), p(bl), p(rh), p(rl))
    pow2 = [int(is_pow2(c)) for c in op.coeffs[1:]]
    split_args = [v for s in splits for v in s[1:]]  # (hi, lo, residue) per axis
    if len(op.padded_shape) == 3:
        # R3 stages xh and xl and reads bh, bl in 16-byte pieces
        check_aligned(xh=xh, xl=xl, bh=bh, bl=bl)
        d, hp, wp = op.padded_shape
        _build.launch(
            "ist_k_resid_ff3d", *ptrs, op.nx, op.ny, op.nz, d, hp, wp,
            zstream_chunk(d, hp, wp, _build.sm_count(xh.device)),
            *pow2, int(delta != 0.0), *op.coeffs, *split_args, delta,
        )
        return rh, rl
    hp, wp = op.padded_shape
    name, geom = kernel_geometry("ist_k_resid_ff", op.nx, op.ny, op.mask_mode, hp, wp,
                                 op.block_rows, op.mask8, xh.device)
    _build.launch(name, *ptrs, *geom, *pow2, int(delta != 0.0), *op.coeffs, *split_args, delta)
    return rh, rl

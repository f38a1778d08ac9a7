"""The in-place and the pipelined stencil, and the SpMV chain (counterpart of
the JAX package's kernels/stencil_pipelined.py and of the chain that
``bench.py``'s ``nnz`` mode times).

Both kernels apply the masked 5-point stencil of a
:class:`~iterative_solvers_tpu_torch.kernels.stencil_layout.PaddedStencilOperator`
to an f32 field on its padded layout, masking every read (an input need not
be pre-masked) and the output:

- :func:`stencil_apply_inplace` (kernel C4) computes ``scale · (A x)`` and
  writes it over ``x``: the port's counterpart of the JAX function's donated
  input.
- :func:`stencil_apply_pipelined` (kernel C5) computes ``A x`` (times an
  optional ``scale``) out of place or in place, with ``lookahead`` row
  copies in flight.

Both launch one streaming body (``csrc/stencil_pipelined.cu``
``stencil_stream_kernel``). Its grid follows the card, not the TPU's panel
height: :func:`plan_ranges` cuts the canvas into one contiguous range of
full-width rows per SM, whatever ``block_rows`` is (``block_rows`` stays the
layout's padding rule). A block streams its range through a ring of
``depth + 2`` shared-memory rows filled by bulk copies, ``depth`` of them in
flight: C5's ``lookahead``, and for C4 the deepest ring that fits
(:func:`inplace_depth`). In place, the two rows bordering each range are
first copied into a ``(ranges, 2, wp)`` side buffer (by a copy kernel in
the same launcher, as JAX stages them in XLA; :func:`stage_rows` is its
plain version), so no block reads a row another block writes.

On a CPU tensor each runs its plain torch version (:func:`inplace_plain`,
:func:`pipelined_plain`: the masked stencil, written into ``x`` where the
kernel writes in place); on a CUDA tensor it launches its kernel or raises.
A custom layout (``op.mask8``) runs the ``*_custom`` instantiations, which
read the int8 interior as C1 does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from iterative_solvers_tpu_torch.kernels import _build
from iterative_solvers_tpu_torch.kernels.stencil_layout import (
    PaddedStencilOperator,
    check_field,
    kernel_geometry,
    kernel_name,
)
from iterative_solvers_tpu_torch.ops.stencil import stencil_apply

# the most dynamic shared memory one block may opt into on an H100 (227 KB),
# less the ring's mbarriers
SMEM_LIMIT = 232448 - 64
MAX_LOOKAHEAD = 4  # the deepest ring csrc/stencil_pipelined.cu takes (6 stages)
# rows a range holds at least: its two side rows stay within 1/16 of the field
MIN_RANGE_ROWS = 32


def _check(x: torch.Tensor, op: PaddedStencilOperator) -> None:
    check_field("x", x, op.padded_shape)
    hp, wp = op.padded_shape
    if hp % op.block_rows or wp % 128:
        raise ValueError(f"layout {op.padded_shape} needs hp % {op.block_rows} == 0 and "
                         "wp % 128 == 0")


def _check_ring(rows: int, wp: int) -> None:
    need = rows * wp * 4
    if need > SMEM_LIMIT:
        raise ValueError(f"a ring of {rows} rows of {wp} floats needs {need} bytes of shared "
                         f"memory; a block holds at most {SMEM_LIMIT} (width <= "
                         f"{SMEM_LIMIT // (4 * rows)} columns)")


def inplace_depth(wp: int) -> int:
    """C4's copies in flight: the deepest ring of ``depth + 2`` rows of
    ``wp`` floats that fits a block's shared memory, at most
    :data:`MAX_LOOKAHEAD` (raises where not even three rows fit)."""
    _check_ring(3, wp)
    return min(MAX_LOOKAHEAD, SMEM_LIMIT // (4 * wp) - 2)


def plan_ranges(hp: int, sm_count: int) -> Tuple[int, int]:
    """``(rows, ranges)``: the canvas's ``hp`` rows cut into ``ranges``
    contiguous ranges of ``rows`` rows (the last one shorter where ``rows``
    does not divide ``hp``), one CUDA block each: one range per SM, as few
    as keep every range at least :data:`MIN_RANGE_ROWS` rows (at least one
    range). The panel height plays no part: at 8448 rows and 132 SMs, 132
    ranges of 64 rows; at 8256, 132 of 63 (the last 3)."""
    ranges = max(1, min(sm_count, hp // MIN_RANGE_ROWS))
    rows = -(-hp // ranges)
    return rows, -(-hp // rows)


def stage_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``(n, 2, wp)``: for each range of ``rows`` rows of ``x`` (the last
    one shorter where ``rows`` does not divide ``hp``), the row just above
    it and the row just below it (zeros off the canvas, which no interior
    node reads): the plain version of the side buffer that the C4/C5
    launchers stage on the card."""
    hp, wp = x.shape
    n = -(-hp // rows)
    side = x.new_zeros((n, 2, wp))
    side[1:, 0] = x[rows - 1 : (n - 1) * rows : rows]
    side[:-1, 1] = x[rows : (n - 1) * rows + 1 : rows]
    return side


def _masked_apply(x: torch.Tensor, op: PaddedStencilOperator, scale: float) -> torch.Tensor:
    y = stencil_apply(x, op.mask_spec.build(x.device), *op.coeffs)
    return y * scale if scale != 1.0 else y


def inplace_plain(x: torch.Tensor, op: PaddedStencilOperator, scale: float = 1.0) -> torch.Tensor:
    """C4's plain version: ``scale · (A x)`` written into ``x``."""
    _build.note_plain(kernel_name("stencil_inplace", op.mask8), x)
    return x.copy_(_masked_apply(x, op, scale))


def pipelined_plain(x: torch.Tensor, op: PaddedStencilOperator, in_place: bool = True,
                    scale: float = 1.0) -> torch.Tensor:
    """C5's plain version: ``scale · (A x)``, written into ``x`` in place."""
    _build.note_plain(kernel_name("stencil_pipelined", op.mask8), x)
    y = _masked_apply(x, op, scale)
    return x.copy_(y) if in_place else y


def _launch(launcher: str, fields, op: PaddedStencilOperator, depth: int, scale: float) -> None:
    """Launch C4 or C5 on ``fields`` (the launcher's field operands: ``(x,)``
    for C4, ``(x, y)`` for C5, in place where ``y`` is ``x``) over
    :func:`plan_ranges`' ranges; in place the launcher first stages the side
    rows (a copy kernel; :func:`stage_rows` is its plain version)."""
    x = fields[0]
    if x.data_ptr() % 16:  # the bulk copies and the float4 stores
        raise ValueError("x: the kernels need 16-byte aligned storage (.clone() it first)")
    hp, wp = op.padded_shape
    rows, ranges = plan_ranges(hp, _build.sm_count(x.device))
    # in place, the launcher stages the side rows into it (stage_rows' function)
    side = x.new_empty((ranges, 2, wp)) if fields[-1] is x else None
    name, geom = kernel_geometry(launcher, op.nx, op.ny, op.mask_mode, hp, wp, rows, op.mask8,
                                 x.device)
    _build.launch(name, *map(_build.ptr, fields), _build.ptr(side), *geom, *op.coeffs,
                  float(scale), depth)


def stencil_apply_inplace(x: torch.Tensor, op: PaddedStencilOperator,
                          scale: float = 1.0) -> torch.Tensor:
    """``scale · (A x)`` written over ``x``, which is returned: the caller's
    tensor is overwritten. ``x``: a contiguous, 16-byte aligned f32 field of
    ``op``'s padded shape (``hp % block_rows == 0``, ``wp % 128 == 0``, at
    most 19,365 columns: a ring of three rows)."""
    _check(x, op)
    if x.device.type == "cpu":
        return inplace_plain(x, op, scale)
    _launch("ist_stencil_inplace", (x,), op, inplace_depth(op.padded_shape[1]), scale)
    return x


def stencil_apply_pipelined(x: torch.Tensor, op: PaddedStencilOperator, in_place: bool = True,
                            lookahead: int = 2, n_out: int = 2,
                            scale: float = 1.0) -> torch.Tensor:
    """``scale · (A x)`` streamed through a ring of ``lookahead + 2`` row
    stages, ``lookahead`` row copies in flight; ``in_place`` writes it over
    ``x`` (the caller's tensor is overwritten) and returns ``x``, else a new
    tensor. ``n_out`` is the TPU kernel's write-back ring depth: checked and
    accepted, but stores leave from registers here, so it changes nothing.
    ``scale`` multiplies the result as in :func:`stencil_apply_inplace` (the
    TPU kernel has none; the SpMV chain needs it to keep iterates finite).
    ``lookahead`` 1 to :data:`MAX_LOOKAHEAD`, with the ring within a block's
    shared memory."""
    _check(x, op)
    if not 1 <= lookahead <= MAX_LOOKAHEAD:
        raise ValueError(f"lookahead must be 1..{MAX_LOOKAHEAD}, got {lookahead}")
    if n_out < 1:
        raise ValueError(f"n_out must be >= 1, got {n_out}")
    if x.device.type == "cpu":
        return pipelined_plain(x, op, in_place, scale)
    _check_ring(lookahead + 2, op.padded_shape[1])
    y = x if in_place else torch.empty_like(x)
    _launch("ist_stencil_pipelined", (x, y), op, lookahead, scale)
    return y


def spmv_chain(op: PaddedStencilOperator, x: torch.Tensor, k: int, scale: float = 7e-6,
               kernel: str = "inplace") -> torch.Tensor:
    """``sum((scale · A)^k x)`` as a 0-dim tensor: ``k`` applies of C4
    (``"inplace"``), C5 (``"pipelined"``, in place) or A1 (``"stencil"``, out
    of place, then times ``scale``), the function ``bench.py``'s ``nnz`` mode
    times (its per-apply ``scale`` keeps the iterates finite). ``x`` is not
    modified: the chain runs on one copy of it."""
    if kernel not in ("inplace", "pipelined", "stencil"):
        raise ValueError(f"unknown kernel {kernel!r} (use 'inplace', 'pipelined' or 'stencil')")
    v = x.clone()
    for _ in range(k):
        if kernel == "inplace":
            stencil_apply_inplace(v, op, scale)
        elif kernel == "pipelined":
            stencil_apply_pipelined(v, op, in_place=True, scale=scale)
        else:
            v = op(v) * scale
    return torch.sum(v)

"""The in-place and the pipelined stencil, and the SpMV chain (counterpart of
iterative_solvers_tpu/kernels/stencil_pipelined.py and of the chain that
``bench.py``'s ``nnz`` mode times).

Both kernels apply the masked 5-point stencil of a
:class:`~iterative_solvers_tpu_torch.kernels.stencil_layout.PaddedStencilOperator`
to an f32 field on its padded layout, masking every read (an input need not
be pre-masked) and the output:

- :func:`stencil_apply_inplace` (kernel C4, ``csrc/stencil_pipelined.cu``
  ``stencil_inplace_kernel``) computes ``scale · (A x)`` and writes it over
  ``x``: the port's counterpart of the JAX function's donated input. The two
  rows bordering each panel are staged into a ``(g, 2, wp)`` side buffer
  first (torch indexing, as JAX stages them in XLA), so no block reads a
  row another block writes.
- :func:`stencil_apply_pipelined` (kernel C5, ``stencil_pipelined_kernel``)
  computes ``A x`` (times an optional ``scale``) out of place or in place,
  each block streaming its range of panels through a ring of
  ``lookahead + 2`` shared-memory row stages filled by ``cp.async``; in
  place, the rows bordering each block's range are staged as C4's are.

On a CPU tensor each runs its plain torch version (:func:`inplace_plain`,
:func:`pipelined_plain`: the masked stencil, written into ``x`` where the
kernel writes in place); on a CUDA tensor it launches its kernel or raises.
A custom layout (``op.mask8``) runs the ``*_custom`` instantiations, which
read the int8 interior as C1 does.
"""

from __future__ import annotations

import torch

from iterative_solvers_tpu_torch.kernels import _build
from iterative_solvers_tpu_torch.kernels.stencil_layout import (
    PaddedStencilOperator,
    check_field,
    kernel_geometry,
    kernel_name,
)
from iterative_solvers_tpu_torch.ops.stencil import stencil_apply

# the most dynamic shared memory one block may opt into on an H100 (227 KB)
SMEM_LIMIT = 232448
MAX_LOOKAHEAD = 4  # the ring depths csrc/stencil_pipelined.cu instantiates


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


def stage_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``(n, 2, wp)``: for each block of ``rows`` rows of ``x``, the row just
    above it and the row just below it (zeros off the canvas, which no
    interior node reads)."""
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


def stencil_apply_inplace(x: torch.Tensor, op: PaddedStencilOperator,
                          scale: float = 1.0) -> torch.Tensor:
    """``scale · (A x)`` written over ``x``, which is returned: the caller's
    tensor is overwritten. ``x``: a contiguous f32 field of ``op``'s padded
    shape (``hp % block_rows == 0``, ``wp % 128 == 0``)."""
    _check(x, op)
    if x.device.type == "cpu":
        return inplace_plain(x, op, scale)
    hp, wp = op.padded_shape
    _check_ring(3, wp)
    side = stage_rows(x, op.block_rows)
    name, geom = kernel_geometry("ist_stencil_inplace", op.nx, op.ny, op.mask_mode, hp, wp,
                                 op.block_rows, op.mask8, x.device)
    _build.launch(name, _build.ptr(x), _build.ptr(side), *geom, *op.coeffs, float(scale))
    return x


def stencil_apply_pipelined(x: torch.Tensor, op: PaddedStencilOperator, in_place: bool = True,
                            lookahead: int = 2, n_out: int = 2,
                            scale: float = 1.0) -> torch.Tensor:
    """``scale · (A x)`` streamed through a ring of ``lookahead + 2`` row
    stages; ``in_place`` writes it over ``x`` (the caller's tensor is
    overwritten) and returns ``x``, else a new tensor. ``n_out`` is the TPU kernel's
    write-back ring depth: checked and accepted, but stores leave from
    registers here, so it changes nothing. ``scale`` folds into the epilogue
    as in :func:`stencil_apply_inplace` (the TPU kernel has none; the SpMV
    chain needs it to keep iterates finite). ``lookahead`` 1 to
    :data:`MAX_LOOKAHEAD`, with the ring within a block's shared memory."""
    _check(x, op)
    if not 1 <= lookahead <= MAX_LOOKAHEAD:
        raise ValueError(f"lookahead must be 1..{MAX_LOOKAHEAD}, got {lookahead}")
    if n_out < 1:
        raise ValueError(f"n_out must be >= 1, got {n_out}")
    if x.device.type == "cpu":
        return pipelined_plain(x, op, in_place, scale)
    hp, wp = op.padded_shape
    _check_ring(lookahead + 2, wp)
    # each block walks a contiguous range of panels, about one range per SM
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    panels = hp // op.block_rows
    rows = -(-panels // sms) * op.block_rows
    side = stage_rows(x, rows) if in_place else None
    y = x if in_place else torch.empty_like(x)
    name, geom = kernel_geometry("ist_stencil_pipelined", op.nx, op.ny, op.mask_mode, hp, wp,
                                 op.block_rows, op.mask8, x.device)
    _build.launch(name, _build.ptr(x), _build.ptr(y), _build.ptr(side), *geom, *op.coeffs,
                  float(scale), rows, lookahead)
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

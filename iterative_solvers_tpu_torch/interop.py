"""Carry the JAX package's solver state into the port's objects.

The JAX side is handed over as plain values and numpy arrays (``np.asarray``
of each JAX array), so this module needs numpy and torch only:

- :func:`multigrid_from_state` rebuilds a :class:`MultigridPreconditioner`
  hierarchy from per-level descriptions plus the dense coarse solve's index
  set and inverse;
- :func:`cg_state_from_arrays` rebuilds a :class:`CGState` — a fused PCG
  state, or a plain-CG one whose ``w`` and ``rz_prev`` are None;
- :func:`sparse_operator_from_csr` wraps a CSR matrix the JAX package
  assembled (``ops.sparse.assemble_csr``, its native engine included) as a
  :class:`SparseOperator`;
- :func:`block_from_global` and :func:`global_from_blocks` carry a mesh
  field across: a JAX mesh field as numpy (``np.asarray`` of a sharded
  array: the padded global field) to this rank's block, and the port's
  blocks back to that padded global field. The port's mesh layouts are
  the JAX package's (``parallel/mesh.py``, ``parallel/halo_pallas.py``),
  so the two compare like for like.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from iterative_solvers_tpu_torch.core.domain import ArrayMask, MaskSpec
from iterative_solvers_tpu_torch.kernels.mg_fused import FusedLevelKernels
from iterative_solvers_tpu_torch.kernels.mg_fused3d import FusedLevelKernels3D
from iterative_solvers_tpu_torch.ops.sparse import SparseOperator
from iterative_solvers_tpu_torch.solvers.cg import CGState
from iterative_solvers_tpu_torch.solvers.multigrid import (
    MultigridPreconditioner,
    _CoarseSolveDense,
    _FusedLevel,
    _FusedLevel3D,
    _Level,
)


def _mask_spec(lv: Mapping):
    if lv["shape"] == "custom":
        return ArrayMask(np.asarray(lv["interior"]))
    nx, ny = int(lv["nx"]), int(lv["ny"])
    if lv["shape"] == "box":
        nz = int(lv["nz"])
        return MaskSpec("box", nx, ny, (nz + 1, ny + 1, nx + 1), nz=nz)
    return MaskSpec(lv["shape"], nx, ny, (ny + 1, nx + 1))


def multigrid_from_state(
    levels: Sequence[Mapping],
    coarse_idx: np.ndarray,
    coarse_a_inv: np.ndarray,
    nu: int = 1,
) -> MultigridPreconditioner:
    """Hierarchy from one mapping per level, finest first. Keys of every
    level: ``shape`` ('gamma'|'rect'|'custom', or 'box' for a 3D level,
    which also has ``nz``), ``nx``, ``ny``, ``coeffs`` (the JAX level's (cd,
    c_y, c_x), in 3D (cd, c_z, c_y, c_x)), ``omega_over_diag``; a custom
    level also its bool ``interior`` array. A fused level also has
    ``padded_shape``, and ``block_rows`` in 2D (a 3D level's kernels take
    any depth, so its ``block_z`` is not needed); a fused custom level its
    padded int8 ``mask8``. The
    coarsest level's solve is ``coarse_a_inv`` applied on the flat interior
    indices ``coarse_idx``."""
    plain = [
        _Level(_mask_spec(lv), tuple(float(c) for c in lv["coeffs"]),
               float(lv["omega_over_diag"]))
        for lv in levels
    ]
    out = []
    for i, lv in enumerate(levels):
        if "padded_shape" not in lv:
            out.append(plain[i])
            continue
        nx, ny = int(lv["nx"]), int(lv["ny"])
        if lv["shape"] == "box":
            cd, cz, cy, cx = plain[i].coeffs
            child = levels[i + 1]
            kernels3 = FusedLevelKernels3D(
                nx=nx, ny=ny, nz=int(lv["nz"]), coeffs=(cd, cx, cy, cz),
                cs=plain[i].omega_over_diag,
                padded_shape=tuple(int(s) for s in lv["padded_shape"]),
                # a fused child's padded canvas, else its grid
                child_shape=tuple(int(s) for s in child["padded_shape"]) if "padded_shape"
                in child else plain[i + 1].mask_spec.shape,
            )
            out.append(_FusedLevel3D(kernels3, ny + 1, nx + 1, plain[i]))
            continue
        cd, cy, cx = plain[i].coeffs
        custom = lv["shape"] == "custom"
        child = levels[i + 1]
        if "padded_shape" in child:  # a fused child: its padded canvas
            child_shape = tuple(int(s) for s in child["padded_shape"])
            child_mask8 = ArrayMask(np.asarray(child["mask8"]) != 0) if custom else None
        else:  # a plain child: its grid
            child_shape = plain[i + 1].mask_spec.shape
            child_mask8 = plain[i + 1].mask_spec if custom else None
        kernels = FusedLevelKernels(
            nx=nx, ny=ny, coeffs=(cd, cx, cy), cs=plain[i].omega_over_diag,
            mask_mode=lv["shape"], padded_shape=tuple(int(s) for s in lv["padded_shape"]),
            block_rows=int(lv["block_rows"]),
            mask8=ArrayMask(np.asarray(lv["mask8"]) != 0) if custom else None,
            child_shape=child_shape, child_mask8=child_mask8,
        )
        out.append(_FusedLevel(kernels, ny + 1, nx + 1, plain[i]))
    return MultigridPreconditioner(
        levels=tuple(out), coarse_solve=_CoarseSolveDense(coarse_idx, coarse_a_inv),
        nu_pre=nu, nu_post=nu,
    )


_FIELDS = ("x", "r", "z", "w")
_SCALARS = ("rz", "r_norm2", "prec_max", "r_max", "err_max", "r0_norm", "rz_prev")


def cg_state_from_arrays(arrays: Mapping[str, object], device="cpu") -> CGState:
    """CGState from numpy arrays/scalars keyed by field name (``x``, ``r``,
    ``z``, ``k``, ``done``, ``reason``, ``rz``, ``r_norm2``, ``prec_max``,
    ``r_max``, ``err_max``, ``r0_norm``, and the fused-PCG ``w``,
    ``rz_prev``). Missing or None entries (``np.asarray(None)`` included)
    stay None, as ``w``/``rz_prev`` do in a plain-CG state."""
    def t(name):
        v = np.array(arrays.get(name), dtype=None)
        if v.dtype == object:
            return None
        return torch.tensor(v, device=device)

    vals = {n: t(n) for n in _FIELDS + _SCALARS}
    return CGState(
        k=int(np.asarray(arrays["k"])),
        done=torch.as_tensor(bool(np.asarray(arrays["done"])), device=device),
        reason=torch.as_tensor(int(np.asarray(arrays["reason"])), dtype=torch.int32,
                               device=device),
        **vals,
    )


def sparse_operator_from_csr(row_map, entries, values, n: int, dtype=torch.float64,
                             device="cuda") -> SparseOperator:
    """The ``n``-by-``n`` CSR matrix (row pointers ``row_map``, column
    indices ``entries``, ``values``) as a :class:`SparseOperator` on
    ``device`` (``"cuda"`` raises without a card)."""
    return SparseOperator.from_csr(row_map, entries, values, n, dtype, device)


def block_from_global(field, mesh, device="cpu") -> torch.Tensor:
    """This rank's block of a padded global field given as numpy (a JAX
    mesh field, ``np.asarray`` of its sharded array)."""
    t = torch.as_tensor(np.array(field), device=device)  # a writable copy
    return mesh.take_block(t, mesh.block_shape(tuple(t.shape)))


def global_from_blocks(block: torch.Tensor, mesh) -> np.ndarray:
    """The padded global field of every rank's block, as numpy — what
    ``np.asarray`` gives of the JAX mesh field on the same mesh shape."""
    return mesh.gather(block).cpu().numpy()

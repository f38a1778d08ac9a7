"""Explicit sparse (CSR) assembly and SpMV (counterpart of
iterative_solvers_tpu/ops/sparse.py).

Assembly is the JAX package's vectorised NumPy builder: rank the interior
nodes in compacted order (:mod:`~iterative_solvers_tpu_torch.core.ordering`),
emit one entry block per stencil offset, drop the neighbours off the
interior, sort by (row, col). :class:`SparseOperator` holds the result as a
``torch.sparse_csr_tensor`` over compacted unknown vectors; its SpMV is
PyTorch's CSR product, a library call outside any kernel, as the JAX
package's is XLA's BCOO product. The matrix-free stencil operators are the
performance path; this one is for parity with the reference's explicit
matrix and for operators that are not pure stencils.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from iterative_solvers_tpu_torch.core.domain import resolve_device
from iterative_solvers_tpu_torch.core.ordering import interior_indices


def _offsets(domain):
    """Stencil offsets as (shift per field axis, coefficient), diagonal first."""
    if hasattr(domain, "nz"):
        return [
            ((0, 0, 0), domain.coeff_diag),
            ((0, 0, -1), domain.coeff_x),
            ((0, 0, 1), domain.coeff_x),
            ((0, -1, 0), domain.coeff_y),
            ((0, 1, 0), domain.coeff_y),
            ((-1, 0, 0), domain.coeff_z),
            ((1, 0, 0), domain.coeff_z),
        ]
    return [
        ((0, 0), domain.coeff_diag),
        ((0, -1), domain.coeff_x),
        ((0, 1), domain.coeff_x),
        ((-1, 0), domain.coeff_y),
        ((1, 0), domain.coeff_y),
    ]


def assemble_coo(domain, dtype=np.float64) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, vals) of the compacted system matrix, sorted by (row, col)."""
    interior = domain.interior
    shape = interior.shape
    rank = -np.ones(interior.size, dtype=np.int64)
    idx = interior_indices(domain)
    rank[idx] = np.arange(idx.size)
    rank = rank.reshape(shape)
    rows_list, cols_list, vals_list = [], [], []
    grids = np.indices(shape)
    for offset, coeff in _offsets(domain):
        nb_ok = np.ones(shape, dtype=bool)
        nb_index = []
        for ax, d in enumerate(offset):
            pos = grids[ax] + d
            nb_ok &= (pos >= 0) & (pos < shape[ax])
            nb_index.append(np.clip(pos, 0, shape[ax] - 1))
        sel = interior & interior[tuple(nb_index)] & nb_ok
        rows_list.append(rank[sel])
        cols_list.append(rank[tuple(nb_index)][sel])
        vals_list.append(np.full(int(sel.sum()), coeff, dtype=dtype))
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    vals = np.concatenate(vals_list)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]


def assemble_csr(domain, dtype=np.float64,
                 backend: str = "auto") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR (row_map, entries, values) of the compacted system matrix: the
    reference's ``finalize_matrix`` content up to within-row entry order.
    ``backend``: ``"auto"`` and ``"numpy"`` take the vectorised builder;
    the JAX package's native C++ engine (``"native"``) is not ported."""
    if backend == "native":
        raise NotImplementedError(
            "the native C++ assembly engine is not ported yet (ROADMAP Queue 1 item 15); "
            "use backend='numpy' or 'auto'"
        )
    if backend not in ("auto", "numpy"):
        raise ValueError(f"unknown backend {backend!r} (use 'auto', 'numpy' or 'native')")
    rows, cols, vals = assemble_coo(domain, dtype)
    row_map = np.zeros(domain.num_unknowns + 1, dtype=np.int64)
    np.add.at(row_map, rows + 1, 1)
    return np.cumsum(row_map), cols.astype(np.int64), vals


def assemble_dense(domain, dtype=np.float64) -> np.ndarray:
    """Dense system matrix (small grids and parity tests only)."""
    rows, cols, vals = assemble_coo(domain, dtype)
    n = domain.num_unknowns
    A = np.zeros((n, n), dtype=dtype)
    A[rows, cols] = vals
    return A


class SparseOperator:
    """``y = A x`` over compacted unknown vectors with a CSR matrix on the
    operator's device."""

    def __init__(self, mat: torch.Tensor):
        if mat.layout != torch.sparse_csr:
            raise ValueError("SparseOperator needs a torch.sparse_csr_tensor")
        self.mat = mat

    @staticmethod
    def from_csr(row_map, entries, values, n: int, dtype=torch.float64,
                 device="cuda") -> "SparseOperator":
        """From CSR arrays (row pointers, column indices, values) of an
        ``n``-by-``n`` matrix."""
        device = resolve_device(device)
        # the structure is checked once, here; PyTorch marks CSR support as beta
        with warnings.catch_warnings(), torch.sparse.check_sparse_tensor_invariants():
            warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
            mat = torch.sparse_csr_tensor(
                torch.as_tensor(np.asarray(row_map, np.int64), device=device),
                torch.as_tensor(np.asarray(entries, np.int64), device=device),
                torch.as_tensor(np.asarray(values), device=device).to(dtype),
                size=(n, n),
            )
        return SparseOperator(mat)

    @staticmethod
    def from_domain(domain, dtype=torch.float64, device="cuda") -> "SparseOperator":
        row_map, entries, values = assemble_csr(domain, backend="numpy")
        return SparseOperator.from_csr(row_map, entries, values, domain.num_unknowns, dtype,
                                       device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.mat @ x

    @property
    def shape(self):
        return (self.mat.shape[0],)

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def diagonal(self, device=None) -> torch.Tensor:
        """The matrix diagonal as a compacted vector (on ``device``, by
        default the matrix's)."""
        crow, col = self.mat.crow_indices(), self.mat.col_indices()
        rows = torch.repeat_interleave(torch.arange(self.mat.shape[0], device=crow.device),
                                       crow[1:] - crow[:-1])
        vals = self.mat.values()
        diag = torch.zeros(self.mat.shape[0], dtype=vals.dtype, device=vals.device)
        diag = diag.index_add_(0, rows, torch.where(rows == col, vals, 0.0))
        return diag if device is None else diag.to(device)

    def nnz(self) -> int:
        return int(self.mat.values().numel())

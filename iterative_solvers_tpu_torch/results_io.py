"""Results persistence (counterpart of the JAX package's results_io.py).

Text formats follow the reference's ResultsIO section layout
(reference solver/dirichlet_solver.cpp:255-313 saveResults sections
PARAMETERS/CONVERGENCE/SOLUTION/TRUE_SOLUTION/RESIDUAL/ERROR/X_COORDS/
Y_COORDS; :407-457 saveMatrixAndRhs MATRIX_INFO/MATRIX/RHS; and the gnuplot
``x y z`` 3D export of dirichlet_solver.hpp:44-76). Our loader is robust to
the actual vector length (the reference's own loader wrongly resizes to
``n*m``, dirichlet_solver.cpp:354 — not replicated). An ``.npz`` format is
added for lossless round-trips.

Files are interchangeable with the JAX package's: the text format is written
byte for byte as it writes it (the solver-name line aside, which names this
package by default), the bulk ``%.17e`` lines by the native engine
(``native/textio.cpp``; a failed build raises); an npz carries the same keys
plus ``outer_iterations``, which the JAX loader ignores and this loader reads
as 0 when a file lacks it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from iterative_solvers_tpu_torch.native import loader
from iterative_solvers_tpu_torch.solvers.stopping import StopReason

_SECTIONS = [
    "SOLUTION",
    "TRUE_SOLUTION",
    "RESIDUAL",
    "ERROR",
    "X_COORDS",
    "Y_COORDS",
]


def _format_block(values) -> str:
    """Bulk '%.17e' lines through the native engine (native/textio.cpp; the
    hot loop of results IO at large grids)."""
    return loader.format_doubles(values).decode("ascii")


def _parse_block(text: str, cap: int) -> Tuple[np.ndarray, int]:
    """(values, chars consumed) from the head of ``text``; stops at the first
    non-numeric token (the next section header)."""
    return loader.parse_doubles(text.encode("ascii"), cap)


def save_results(path: str, results, solver_name: str = "MSG (conjugate gradient, CUDA)") -> None:
    with open(path, "w") as f:
        f.write("PARAMETERS\n")
        dims = f"{results.nx} {results.ny}"
        if getattr(results, "nz", 0):
            dims += f" {results.nz}"
        f.write(dims + "\n")
        f.write(" ".join(str(v) for v in results.bounds) + "\n")
        f.write(f"{solver_name}\n")
        shape = getattr(results, "shape", "")
        if shape and shape != "gamma":
            # optional extension line. Written ONLY for geometries the
            # reference cannot represent (its loader expects CONVERGENCE
            # right after the solver name, dirichlet_solver.cpp:315-405, so
            # gamma saves must stay byte-compatible with it); the loader's
            # missing-SHAPE fallback is gamma, keeping the round trip exact.
            f.write(f"SHAPE {shape}\n")
        f.write("CONVERGENCE\n")
        f.write(f"{results.iterations}\n")
        f.write(f"{1 if results.converged else 0}\n")
        f.write(f"{results.stop_reason.name}\n")
        f.write(f"{results.residual_norm:.17e} {results.error_norm:.17e}\n")
        vectors = [
            results.solution,
            results.true_solution,
            results.residual,
            results.error,
            results.x_coords,
            results.y_coords,
        ]
        names = list(_SECTIONS)
        if getattr(results, "z_coords", None) is not None:
            names.append("Z_COORDS")
            vectors.append(results.z_coords)
        for name, vec in zip(names, vectors):
            f.write(f"{name}\n")
            f.write(_format_block(vec))


def load_results(path: str):
    """Load a sectioned-text results file back into a SolverResults."""
    from iterative_solvers_tpu_torch.api import SolverResults

    with open(path) as f:
        text = f.read()

    pos = 0

    def next_line() -> str:
        nonlocal pos
        e = text.find("\n", pos)
        if e == -1:
            e = len(text)
        s = text[pos:e]
        pos = min(e + 1, len(text))
        return s

    def expect(line, name):
        if line != name:
            raise ValueError(f"{path}: expected section {name!r}, got {line!r}")

    expect(next_line(), "PARAMETERS")
    dims = [int(v) for v in next_line().split()]
    nx, ny = dims[0], dims[1]
    nz = dims[2] if len(dims) > 2 else 0
    bounds = tuple(float(v) for v in next_line().split())
    solver_name = next_line()
    shape = ""
    line = next_line()
    if line.startswith("SHAPE "):
        shape = line.split(None, 1)[1].strip()
        line = next_line()
    expect(line, "CONVERGENCE")
    iterations = int(next_line())
    converged = next_line().strip() == "1"
    reason_txt = next_line().strip()
    try:
        reason = StopReason[reason_txt]
    except KeyError:
        reason = StopReason.ITERATIONS
    residual_norm, error_norm = (float(v) for v in next_line().split())

    all_sections = _SECTIONS + ["Z_COORDS"]
    vecs = {}
    while pos < len(text):
        name = next_line().strip()
        if not name:
            continue
        if name not in all_sections:
            raise ValueError(f"{path}: unknown section {name!r}")
        cap = text.count("\n", pos) + 1
        vals, consumed = _parse_block(text[pos:], cap)
        vecs[name] = vals
        pos += consumed

    def get(name):
        return vecs.get(name, np.zeros(0))

    return SolverResults(
        solution=get("SOLUTION"),
        true_solution=get("TRUE_SOLUTION"),
        residual=get("RESIDUAL"),
        error=get("ERROR"),
        x_coords=get("X_COORDS"),
        y_coords=get("Y_COORDS"),
        iterations=iterations,
        converged=converged,
        stop_reason=reason,
        residual_norm=residual_norm,
        error_norm=error_norm,
        precision_norm=float("nan"),
        elapsed_s=0.0,
        nx=nx,
        ny=ny,
        nz=nz,
        bounds=bounds,
        z_coords=vecs.get("Z_COORDS"),
        shape=shape,
    ), solver_name


def save_results_npz(path: str, results) -> None:
    np.savez_compressed(
        path,
        solution=results.solution,
        true_solution=results.true_solution,
        residual=results.residual,
        error=results.error,
        x_coords=results.x_coords,
        y_coords=results.y_coords,
        iterations=results.iterations,
        converged=results.converged,
        stop_reason=int(results.stop_reason),
        residual_norm=results.residual_norm,
        error_norm=results.error_norm,
        precision_norm=results.precision_norm,
        elapsed_s=results.elapsed_s,
        nx=results.nx,
        ny=results.ny,
        nz=getattr(results, "nz", 0),
        bounds=np.asarray(results.bounds),
        history=results.history if results.history is not None else np.zeros((0, 5)),
        outer_iterations=getattr(results, "outer_iterations", 0),
        z_coords=(
            results.z_coords
            if getattr(results, "z_coords", None) is not None
            else np.zeros(0)
        ),
        shape=getattr(results, "shape", ""),
        interior_mask=(
            results.interior_mask
            if getattr(results, "interior_mask", None) is not None
            else np.zeros((0, 0), dtype=bool)
        ),
    )


def load_results_npz(path: str):
    from iterative_solvers_tpu_torch.api import SolverResults

    z = np.load(path)
    hist = z["history"]
    return SolverResults(
        solution=z["solution"],
        true_solution=z["true_solution"],
        residual=z["residual"],
        error=z["error"],
        x_coords=z["x_coords"],
        y_coords=z["y_coords"],
        iterations=int(z["iterations"]),
        converged=bool(z["converged"]),
        stop_reason=StopReason(int(z["stop_reason"])),
        residual_norm=float(z["residual_norm"]),
        error_norm=float(z["error_norm"]),
        precision_norm=float(z["precision_norm"]),
        elapsed_s=float(z["elapsed_s"]),
        nx=int(z["nx"]),
        ny=int(z["ny"]),
        nz=int(z["nz"]) if "nz" in z else 0,
        bounds=tuple(z["bounds"]),
        history=hist if hist.size else None,
        outer_iterations=int(z["outer_iterations"]) if "outer_iterations" in z else 0,
        z_coords=(
            z["z_coords"] if "z_coords" in z and z["z_coords"].size else None
        ),
        shape=str(z["shape"]) if "shape" in z else "",
        interior_mask=(
            z["interior_mask"]
            if "interior_mask" in z and z["interior_mask"].size
            else None
        ),
    )


def save_matrix_and_rhs(path: str, domain, rhs_compact: np.ndarray) -> None:
    """CSR + RHS dump in the reference's MATRIX_INFO/MATRIX/RHS layout
    (reference solver/dirichlet_solver.cpp:407-457)."""
    from iterative_solvers_tpu_torch.ops.sparse import assemble_csr

    row_map, entries, values = assemble_csr(domain)
    n_rows = len(row_map) - 1
    with open(path, "w") as f:
        f.write("MATRIX_INFO\n")
        f.write(f"{domain.nx} {domain.ny}\n")
        f.write(f"{n_rows} {len(entries)}\n")
        f.write("MATRIX\n")
        for v in row_map:
            f.write(f"{v}\n")
        for v in entries:
            f.write(f"{v}\n")
        f.write(_format_block(values))
        f.write("RHS\n")
        f.write(_format_block(rhs_compact))


def load_matrix_and_rhs(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(row_map, entries, values, rhs) from a MATRIX_INFO dump.

    Malformed files raise ``ValueError`` naming the offending section
    (``assert``-based validation would vanish under ``python -O``)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if not lines or lines[0] != "MATRIX_INFO":
        raise ValueError(f"{path}: not a MATRIX_INFO dump (bad header)")
    try:
        n_rows, nnz = (int(v) for v in lines[2].split())
    except (IndexError, ValueError) as e:
        raise ValueError(f"{path}: malformed MATRIX_INFO size line") from e
    if n_rows < 0 or nnz < 0:
        raise ValueError(f"{path}: negative sizes in MATRIX_INFO ({n_rows}, {nnz})")
    if len(lines) < 4 or lines[3] != "MATRIX":
        raise ValueError(f"{path}: missing MATRIX section")
    i = 4
    if len(lines) < i + (n_rows + 1) + 2 * nnz + 1 + n_rows:
        raise ValueError(
            f"{path}: truncated dump ({len(lines)} lines for "
            f"{n_rows} rows / {nnz} nonzeros)"
        )
    try:
        row_map = np.asarray([int(v) for v in lines[i : i + n_rows + 1]])
        i += n_rows + 1
        entries = np.asarray([int(v) for v in lines[i : i + nnz]])
        i += nnz
        values = np.asarray([float(v) for v in lines[i : i + nnz]])
        i += nnz
    except ValueError as e:
        raise ValueError(f"{path}: non-numeric data in MATRIX section") from e
    if lines[i] != "RHS":
        raise ValueError(f"{path}: missing RHS section (found {lines[i]!r})")
    try:
        rhs = np.asarray([float(v) for v in lines[i + 1 : i + 1 + n_rows]])
    except ValueError as e:
        raise ValueError(f"{path}: non-numeric data in RHS section") from e
    if row_map[0] != 0 or row_map[-1] != nnz or np.any(np.diff(row_map) < 0):
        raise ValueError(f"{path}: inconsistent CSR row_map")
    return row_map, entries, values, rhs


def save_solution_3d(path: str, results) -> None:
    """gnuplot/pm3d ``x y z`` export (reference dirichlet_solver.hpp:44-76)."""
    with open(path, "w") as f:
        f.write("# X Y Z (numeric solution on the Dirichlet domain)\n")
        f.write(loader.format_xyz(results.x_coords, results.y_coords,
                                  results.solution).decode("ascii"))

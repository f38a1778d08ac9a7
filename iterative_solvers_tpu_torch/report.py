"""Text report generation (counterpart of the JAX package's report.py).

English equivalents of the reference's report templates
(reference solver/msg_solver.cpp:261-304 ``generateReport`` and the GUI
template at qt_gui/src/mainwindow.cpp:751-793).
"""

from __future__ import annotations

import numpy as np


def cg_report(res) -> str:
    """Report for a raw CG solve (reference msg_solver.cpp:261-304)."""
    lines = [
        "=== Conjugate Gradient (MSG) solver report ===",
        f"Iterations performed:      {res.iterations}",
        f"Wall time:                 {res.elapsed_s * 1e3:.3f} ms",
        f"Initial residual |r0|_2:   {res.initial_residual_norm:.6e}",
        f"Final residual |r|_2:      {res.residual_norm:.6e}",
        f"Final residual |r|_inf:    {res.residual_max:.6e}",
        f"Final step |dx|_inf:       {res.precision_max:.6e}",
        f"Final error |x-u|_inf:     {res.error_max:.6e}",
        f"Converged:                 {'yes' if res.converged else 'no'}",
        f"Stop reason:               {res.reason.text()}",
    ]
    return "\n".join(lines)


def results_report(results) -> str:
    """Report for a full DirichletSolver run (reference
    qt_gui/src/mainwindow.cpp:751-793 content)."""
    b = results.bounds
    domain_str = " x ".join(f"[{b[i]}, {b[i + 1]}]" for i in range(0, len(b), 2))
    grid_str = f"{results.nx} x {results.ny}" + (
        f" x {results.nz}" if getattr(results, "nz", 0) else ""
    )
    lines = [
        "=== Dirichlet-Poisson solve report ===",
        "",
        "Problem:",
        f"  Grid:                    {grid_str} intervals",
        f"  Domain:                  {domain_str}",
        f"  Unknowns:                {results.solution.size}",
        "",
        "Solver:",
        f"  Epsilon:                 {results.eps:.3e}",
        f"  Max iterations:          {results.max_iterations}",
        "",
        "Outcome:",
        f"  Iterations:              {results.iterations}",
        f"  Converged:               {'yes' if results.converged else 'no'}",
        f"  Stop reason:             {results.stop_reason.text()}",
        f"  Residual |Ax-b|_inf:     {results.residual_norm:.6e}",
        f"  Error |x-u|_inf:         {results.error_norm:.6e}",
        f"  Step |dx|_inf:           {results.precision_norm:.6e}",
        f"  Wall time:               {results.elapsed_s * 1e3:.3f} ms",
    ]
    return "\n".join(lines)


# --- console pretty-printers (reference solver/main.cpp:468-594) -----------


def vector_table(results, quantity: str = "solution", limit: int = 0) -> str:
    """``#  x  y [z]  value`` table of a result vector in compacted ordering
    (the console equivalents of the reference's residual/error printers,
    solver/main.cpp:112-156 and print_rhs :551-594). ``limit`` > 0 truncates
    to the first N rows (big grids would print millions of lines)."""
    vec = {
        "solution": results.solution,
        "true_solution": results.true_solution,
        "residual": results.residual,
        "error": results.error,
    }.get(quantity)
    if vec is None:
        raise ValueError(f"unknown quantity {quantity!r}")
    if vec.size == 0:
        return f"({quantity}: empty)"
    has_z = getattr(results, "z_coords", None) is not None
    n = vec.size if limit <= 0 else min(vec.size, limit)
    head = "     #             x             y"
    if has_z:
        head += "             z"
    head += f"  {quantity:>22}"
    lines = [head]
    xs, ys = results.x_coords, results.y_coords
    zs = results.z_coords if has_z else None
    for i in range(n):
        row = f"{i:>6}  {xs[i]:>12.6g}  {ys[i]:>12.6g}"
        if has_z:
            row += f"  {zs[i]:>12.6g}"
        lines.append(row + f"  {vec[i]:>22.15e}")
    if n < vec.size:
        lines.append(f"... ({vec.size - n} more rows)")
    return "\n".join(lines)


def matrix_table(domain, max_unknowns: int = 400) -> str:
    """Dense-formatted console dump of the assembled system matrix
    (reference print_matrix, solver/main.cpp:468-549). Refuses huge systems —
    the table is quadratic in the unknown count."""
    from iterative_solvers_tpu_torch.ops.sparse import assemble_csr

    row_map, entries, values = assemble_csr(domain)
    n = len(row_map) - 1
    if n > max_unknowns:
        return (
            f"(matrix is {n}x{n} — too large for a console table; "
            "use --save-matrix for the CSR dump)"
        )
    dense = np.zeros((n, n))
    for i in range(n):
        for k in range(row_map[i], row_map[i + 1]):
            dense[i, entries[k]] = values[k]
    lines = [f"System matrix ({n} x {n}, {len(entries)} nonzeros):"]
    for i in range(n):
        lines.append(" ".join(f"{v:>10.4g}" for v in dense[i]))
    return "\n".join(lines)


def rhs_table(domain, rhs_compact) -> str:
    """Console dump of the right-hand side in compacted ordering
    (reference print_rhs, solver/main.cpp:551-594)."""
    rhs = np.asarray(rhs_compact).ravel()
    lines = [f"Right-hand side ({rhs.size} unknowns):"]
    lines += [f"{i:>6}  {v:>22.15e}" for i, v in enumerate(rhs)]
    return "\n".join(lines)

"""``precond_ms_per_solve``: the host's wall time inside ``precond`` spans
(each preconditioner application: the V-cycle, or the Chebyshev polynomial),
ms per solve, over the traced window's solves."""

from portbench.spans import span_ms_per_solve


def read(rec):
    return span_ms_per_solve(rec, "precond")

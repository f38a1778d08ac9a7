"""``outer_ms_per_solve``: the host's wall time inside ``outer_residual``
spans (each outer step's correction, true residual and norms, read on the
host), ms per solve, over the traced window's solves."""

from portbench.spans import span_ms_per_solve


def read(rec):
    return span_ms_per_solve(rec, "outer_residual")

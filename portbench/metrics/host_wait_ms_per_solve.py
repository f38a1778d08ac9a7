"""``host_wait_ms_per_solve``: the host's wall time inside ``host_read``
spans (a read waits there for the work queued before it, then copies the
value), ms per solve, over the traced window's solves."""

from portbench.spans import span_ms_per_solve


def read(rec):
    return span_ms_per_solve(rec, "host_read")

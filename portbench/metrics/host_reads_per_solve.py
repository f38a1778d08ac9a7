"""``host_reads_per_solve``: blocking reads of a device value on the host
(the program's ``host_reads`` counter: every read in the solve path goes
through ``profiling.host_read``, and each drains the device's queue), per
solve, over the traced window's solves."""

from portbench.spans import window


def read(rec):
    got = window(rec)
    if got is None:
        return None
    return sum(s.counters["host_reads"] for s in got[0]) / rec.n_solves

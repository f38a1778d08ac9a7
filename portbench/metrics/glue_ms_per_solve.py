"""``glue_ms_per_solve``: device time of every device operation that is
not one of the port's kernels (torch glue: elementwise ops, reductions,
copies), ms per solve, from the traced window."""

from portbench.yardstick import OWN_KERNEL


def read(rec):
    dev = rec.trace["device"] if rec.trace else []
    if not dev:
        return None
    return sum(e - s for n, s, e in dev if not OWN_KERNEL.search(n)) / 1e3 / rec.n_solves

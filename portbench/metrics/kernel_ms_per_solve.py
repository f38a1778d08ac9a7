"""``kernel_ms_per_solve``: device time of the port's own kernels
(``csrc/*.cu``), ms per solve, from the traced window."""

from portbench.yardstick import OWN_KERNEL


def read(rec):
    dev = rec.trace["device"] if rec.trace else []
    own = [e - s for n, s, e in dev if OWN_KERNEL.search(n)]
    if not own:
        return None
    return sum(own) / 1e3 / rec.n_solves

"""``device_ops_per_solve``: device operations (kernels, copies, sets)
per solve in the traced window: what the host issues for a solve."""


def read(rec):
    dev = rec.trace["device"] if rec.trace else []
    if not dev:
        return None
    return len(dev) / rec.n_solves

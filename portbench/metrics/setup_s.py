"""``setup_s``: seconds from the start of the process to the first timed
solve (kernel library build or load, the pool's assembly, warm-up)."""


def read(rec):
    return rec.setup_s

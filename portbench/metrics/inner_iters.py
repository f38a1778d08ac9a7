"""``inner_iters``: inner (P)CG iterations (the results' ``iterations``)
per solve, mean over the traced window's solves."""


def read(rec):
    return sum(s["inner"] for s in rec.solves) / rec.n_solves

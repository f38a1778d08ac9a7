"""``solve_s``: the window's length over its solves, the seconds of one
solve of a pooled problem, whole solves back to back (each ending in a
device synchronisation)."""


def read(rec):
    return rec.window_s / rec.n_solves

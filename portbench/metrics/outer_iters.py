"""``outer_iters``: refinement steps (``outer_iterations``) per solve,
mean over the traced window's solves (``solvers/refine.py``)."""


def read(rec):
    outer = [s["outer"] for s in rec.solves]
    if any(o is None for o in outer):
        return None
    return sum(outer) / len(outer)

"""``fmg_ms_per_solve``: the host's wall time inside ``fmg`` spans (the FMG
warm start: each coarse level's right-hand side and boundary field, the
coarse solve, the rungs' prolongations and polish), ms per solve, over the
traced window's solves."""

from portbench.spans import span_ms_per_solve


def read(rec):
    return span_ms_per_solve(rec, "fmg")

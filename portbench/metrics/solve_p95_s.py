"""``solve_p95_s``: the 95th percentile (nearest rank) of every solve's
wall time in the window."""

import math


def read(rec):
    walls = sorted(s["wall_s"] for s in rec.solves)
    return walls[max(0, math.ceil(0.95 * len(walls)) - 1)]

"""Г: the square with its bottom-left quadrant taken away (the upstream's
domain). A node is an unknown when it lies strictly inside the square and
not in the closed quadrant ``ix <= n/2, iy <= n/2``, whose edges are
boundary."""

AXES = ("y", "x")


def interior(n, idx):
    iy, ix = idx
    inside = (iy > 0) & (iy < n) & (ix > 0) & (ix < n)
    return inside & ~((ix <= n // 2) & (iy <= n // 2))

"""The box: every node strictly inside the cube is an unknown."""

AXES = ("z", "y", "x")


def interior(n, idx):
    iz, iy, ix = idx
    return (iz > 0) & (iz < n) & (iy > 0) & (iy < n) & (ix > 0) & (ix < n)

"""The traffic's generator: the seeded pool of problems a cell solves.

A cell's pool holds ``rhs_pool`` members of its configuration's
manufactured family (``families/<family>.py``), one value of the family's
parameter α in each of as many equal strata of the workload's ``alpha``
range, each moved from its stratum's centre by a small amount drawn from
the run's seed (at most ``alpha_jitter``/2 of a stratum's width), in an
order drawn from the seed. Every seed so gets problems of its own whose
solves take the same work (the solvers' counts change with α by steps).
"""

from __future__ import annotations

import numpy as np


def draw_alphas(seed: int, count: int, lo: float, hi: float, jitter: float) -> list:
    """``count`` values of α from ``seed`` (any non-negative whole number):
    the centres of ``count`` equal strata of [lo, hi], each moved by up to
    ``jitter``/2 of a stratum's width either way, in a drawn order."""
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    width = (hi - lo) / count
    moves = rng.uniform(-0.5, 0.5, size=count)
    alphas = [lo + (k + 0.5 + jitter * moves[k]) * width for k in range(count)]
    return [float(alphas[i]) for i in rng.permutation(count)]


def pool(family, seed: int, cell: dict) -> list:
    """The cell's pool for ``seed``: ``family(α)`` for each drawn α."""
    return [family(a) for a in draw_alphas(seed, cell["rhs_pool"], *cell["alpha"],
                                            cell["alpha_jitter"])]

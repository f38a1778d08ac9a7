"""Each route solves its pool at a small size on the CPU (the kernels'
plain versions) to the cell's limit, with the counts its route reports."""

import pytest

from portbench.tests._cells import SMALL, run_small


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_route_solves_its_pool(cell):
    res, checks = run_small(cell, trace=True, seconds=0.0)
    assert res["correct"]
    assert checks["rel_residual"]["value"] <= checks["rel_residual"]["limit"]
    assert res["metrics"]["inner_iters"]["value"] >= 1
    if cell != "gamma2d.cheb8_4096":
        assert res["metrics"]["outer_iters"]["value"] >= 1

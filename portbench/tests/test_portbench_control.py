"""Each cell's control, at a size a test run holds, reads above the cell's
limit, and the program's own reading below it: the control is the
program's own f32 path for the mixed cells, the plain reference's
Chebyshev CG in bfloat16 for the f32 cell."""

import pytest

from portbench import control, run

SIZES = {"gamma2d.mg_8192": 256, "box3d.mg_512": 32, "gamma2d.cheb8_4096": 128}


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_fails_and_program_passes(cell):
    limit = run.load_json(run.ROOT, "workloads", cell)["limits"]["rel_residual"]
    overrides = {"n": SIZES[cell]}
    if cell != "gamma2d.cheb8_4096":
        overrides["mg_options"] = {"fuse": True, "fuse_min_extent": 16}
    rows = control.readings(cell, [2**31 + 3], device="cpu", overrides=overrides)
    assert max(r["rel"] for r in rows) <= limit
    assert min(r["control_rel"] for r in rows) > limit

"""Small sizes at which the tests run each cell on the CPU, with the fused
multigrid levels' plain versions (``fuse_min_extent`` 16)."""

import time

MG = {"fuse": True, "fuse_min_extent": 16}
SMALL = {
    "gamma2d.mg_8192": {"n": 64, "mg_options": MG},
    "box3d.mg_512": {"n": 32, "mg_options": MG},
    "gamma2d.cheb8_4096": {"n": 64},
}


def run_small(name, seed=2**31 + 17, trace=False, seconds=0.2, **kw):
    from portbench import run

    return run.run_cell(name, seed, seconds, trace, device="cpu", overrides=SMALL[name],
                        t0=time.perf_counter(), **kw)

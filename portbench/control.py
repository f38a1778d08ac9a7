"""Readings for a cell's correctness limit: the program's and its control's.

    python -m portbench.control --workload <cell> --seeds 1,2,3 [--alphas a,b,...] [--no-control]

For each seed, the cell's pool is drawn and built as a run builds it; each
problem is solved once by the cell's route (the program's reading: the
plain reference's true relative residual of its answer, with the solve's
counts and wall time) and once by the route's control (the reference in
the program's place in the precision below the configuration's, or the
program's own path in that precision). ``--alphas`` replaces the drawn
pool by the given values (one pool: how the counts step with α, which
the strata must not straddle). The last line of standard output is a JSON
object with every reading, the largest program reading (``lower``) and
the smallest control reading (``upper``). Not run by the benchmark's
runs; needs a CUDA device (tests call :func:`readings` on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench import guard
from portbench.run import CACHE_DIRS, ROOT, Spec, log


def readings(name, seeds, *, alphas=None, control=True, device="cuda", overrides=None):
    """[{seed, alpha, outer, inner, wall_s, rel, control_rel}] over the
    pools of ``seeds`` (or the one pool ``alphas``)."""
    import torch

    spec = Spec(ROOT, name, overrides)
    cell, config, ref = spec.cell, spec.config, spec.reference
    pools = [(None, [spec.family(a) for a in alphas])] if alphas else [
        (s, spec.pool(s)) for s in seeds]
    out = []
    for seed, fams in pools:
        route = spec.Route(cell, config, fams, device)
        route.warmup()
        for p, fam in enumerate(fams):
            if device == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            x, res = route.solve(p)
            if device == "cuda":
                torch.cuda.synchronize()
            row = {"seed": seed, "alpha": fam.alpha,
                   "outer": getattr(res, "outer_iterations", None), "inner": res.iterations,
                   "converged": bool(res.converged), "wall_s": time.perf_counter() - t,
                   "rel": ref.rel_residual(x, config["domain"], cell["n"], fam)}
            del x, res
            if control:
                row["control_rel"] = ref.rel_residual(route.control(p, ref),
                                                      config["domain"], cell["n"], fam)
            log(json.dumps(row))
            out.append(row)
        del route
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--alphas", default="")
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    guard.check("before the readings")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    alphas = [float(a) for a in args.alphas.split(",") if a]
    rows = readings(args.workload, seeds, alphas=alphas or None, control=not args.no_control)
    guard.check("after the readings")
    summary = {"workload": args.workload, "rows": rows,
               "lower": max(r["rel"] for r in rows)}
    if not args.no_control:
        summary["upper"] = min(r["control_rel"] for r in rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

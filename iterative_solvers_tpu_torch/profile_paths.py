"""Where the time of a solve goes on the card: ``torch.profiler`` over one
solve of each main path, after a warm-up solve.

    python -m iterative_solvers_tpu_torch.profile_paths [--n 8192] [--nb 1024] [--out DIR]

Paths: A, the default solve (FMG warm start, double-f32 outer) at ``n``²;
the cold f64-outer solve at ``n``²; B, plain f32 CG on the fused engine
(``operator='fused'``) at ``nb``². For each it prints the facade's
``solve()`` wall time, then profiles the solver core alone (the refinement,
or the CG solve, on fields assembled beforehand): its time without and with
the profiler, the device-busy time (the union of the device events'
intervals), the idle share of the profiled window and the device ops with
the most self time; with ``--out``, also a Chrome trace per path. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from iterative_solvers_tpu_torch.api import DirichletSolver
from iterative_solvers_tpu_torch.kernels.cg_fused import fused_cg_solve
from iterative_solvers_tpu_torch.solvers.cg import CGOptions
from iterative_solvers_tpu_torch.solvers.refine import fused_refined_solve
from iterative_solvers_tpu_torch.solvers.stopping import StopConfig


def _busy_us(prof):
    """(union of device-event intervals, first start, last end), µs."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, (spans[0][0] if spans else 0.0), (spans[-1][1] if spans else 0.0)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def profile_path(name: str, solver: DirichletSolver, out_dir=None) -> None:
    solver.solve()  # warm-up: allocator pools, coarse inverse, masks, FMG payload
    _, wall = _timed(solver.solve)
    pop, Mp = solver._parts
    b = solver.problem.rhs_field(device="cuda")
    u = solver.problem.true_solution_field(device="cuda")
    if solver.precision == "mixed":
        def core():
            return fused_refined_solve(pop, Mp, b, u_true=u, stop=solver.stop,
                                       fmg=solver.fmg_cycles, ff=solver.outer_kind == "ff")
    else:
        def core():
            return fused_cg_solve(pop, b, u_true=u,
                                  options=CGOptions(stop=solver.stop, preconditioner=Mp))
    res, t_core = _timed(core)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t_prof = _timed(core)
    busy, first, last = _busy_us(prof)
    window = max(last - first, 1e-9)
    print(f"== path {name}: {res.reason.name} outer {getattr(res, 'outer_iterations', 0)} "
          f"inner {res.iterations}; facade solve() wall {wall:.3f} s; core {t_core:.4f} s "
          f"(profiled {t_prof:.4f} s)")
    print(f"   device busy {busy / 1e3:.3f} ms over a {window / 1e3:.3f} ms window of device "
          f"events: idle share {100 * (1 - busy / window):.1f} %")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=18), flush=True)
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--nb", type=int, default=1024)
    ap.add_argument("--out", default=None, help="directory for Chrome traces")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    rel6 = StopConfig(eps_precision=-1, eps_residual=-1, eps_relative=1e-6, max_iterations=100000)
    mixed = dict(preconditioner="mg", precision="mixed", device="cuda", stop=rel6)
    profile_path("A", DirichletSolver(nx=args.n, ny=args.n, outer="ff", **mixed), args.out)
    torch.cuda.empty_cache()
    profile_path("f64", DirichletSolver(nx=args.n, ny=args.n, outer="f64", fmg_cycles=0, **mixed),
                 args.out)
    torch.cuda.empty_cache()
    profile_path("B", DirichletSolver(nx=args.nb, ny=args.nb, operator="fused", device="cuda",
                                      stop=rel6), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

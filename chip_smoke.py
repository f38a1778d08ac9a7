#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
final ``ok`` line:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the hand-written kernels from ``iterative_solvers_tpu_torch/csrc``;
3. kernels: each kernel against its plain torch version on the card, at a
   small gamma grid, a ragged rect grid and the 8192² level-0 layout, with
   the max abs difference, the tolerance and CUDA-event timings;
4. solve: a 64² solve on the card against the same solve on the CPU (plain
   versions), then the 8192² ``outer='f64', fmg_cycles=0`` solve through
   ``DirichletSolver``: converged, true f64 relative residual < 1e-6, and
   every kernel launched by the timed run;
5. one JSON line per kernel summary, then the ``ok`` line.

Imports nothing of JAX. Needs one card; fails without one.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N = 8192
EPS32 = 1.1920929e-07
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "k1": ("iterative_solvers_tpu_torch/csrc/cg_fused.cu",
           "iterative_solvers_tpu/kernels/cg_fused.py:89"),
    "k2_pcg": ("iterative_solvers_tpu_torch/csrc/cg_fused.cu",
               "iterative_solvers_tpu/kernels/cg_fused.py:177"),
    "k_down": ("iterative_solvers_tpu_torch/csrc/mg_fused.cu",
               "iterative_solvers_tpu/kernels/mg_fused.py:65"),
    "k_up": ("iterative_solvers_tpu_torch/csrc/mg_fused.cu",
             "iterative_solvers_tpu/kernels/mg_fused.py:183"),
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=15):
    """Median of per-call CUDA-event times after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(name, outs, refs, kinds, sum_scales=None):
    """Check each output against the plain version's. ``kinds``: 'field'
    (tolerance 64 eps32 · max|ref|), 'sum' (partial sums reduced to one
    scalar; 64 eps32 · the sum of |terms|, ``sum_scales[i]``, else |ref|) or
    'max' (64 eps32 · |ref| after the max). Returns the worst field error
    and its tolerance."""
    worst, worst_tol = 0.0, 0.0
    for i, (o, r, kind) in enumerate(zip(outs, refs, kinds)):
        if kind == "field":
            err = float((o.double() - r.double()).abs().max())
            tol = 64 * EPS32 * float(r.double().abs().max())
        else:
            red = (lambda t: t.double().sum()) if kind == "sum" else (lambda t: t.double().max())
            ro = float(red(r))
            err = abs(float(red(o)) - ro)
            tol = 64 * EPS32 * (sum_scales or {}).get(i, abs(ro))
        if not err <= tol:
            raise AssertionError(f"{name}: {kind} output differs by {err:.3e} > tol {tol:.3e}")
        if kind == "field" and err * max(worst_tol, 1e-300) >= worst * max(tol, 1e-300):
            worst, worst_tol = err, tol
    return worst, worst_tol


def check_kernels(dom, gen, label, timed, block_rows=None):
    """Each kernel against its plain version on one layout (the solver's own,
    or ``block_rows``-row bands); returns {name: (max_abs_err, tol, ms,
    plain_ms)}."""
    import torch

    from iterative_solvers_tpu_torch.kernels import cg_fused
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner

    lay = PaddedStencilOperator.from_domain(dom, block_rows=block_rows)
    M = MultigridPreconditioner.from_domain(dom, fuse=True, fuse_min_extent=16, device="cuda")
    kl = M.levels[0].kernels
    mask = lay.mask_spec.build("cuda")

    def field(shape, masked=True):
        t = torch.randn(shape, device="cuda", generator=gen)
        return torch.where(mask, t, 0.0) if masked else t

    d, z, x, r, w = (field(lay.padded_shape) for _ in range(5))
    beta = torch.tensor(0.37, device="cuda")
    scal = torch.tensor([-1.3e-4, 0.37], device="cuda")
    b = field(kl.padded_shape, masked=False)
    ec = torch.randn(kl.padded_shape[0] // 2, kl.padded_shape[1], device="cuda", generator=gen)
    side = cg_fused.k1_plain(w, z, beta, lay)[0]
    bm = torch.where(kl.mask_spec.build("cuda"), b, 0.0)
    # sums that may cancel are held to the sum of their terms' magnitudes
    scales = {
        "k1": lambda ref: {1: float((d * (d + beta * z)).abs().double().sum())},
        "k_up": lambda ref: {1: float((bm * ref[0]).abs().double().sum())},
    }
    cases = {
        "k1": (lambda: cg_fused.k1(d, z, beta, lay), lambda: cg_fused.k1_plain(d, z, beta, lay),
               ("field", "sum", "sum", "max")),
        "k2_pcg": (lambda: cg_fused.k2_pcg(x, r, z, w, side, scal, lay),
                   lambda: cg_fused.k2_pcg_plain(x, r, z, w, side, scal, lay),
                   ("field", "field", "field", "sum", "max")),
        "k_down": (lambda: (kl.down(b),), lambda: (kl.down_plain(b),), ("field",)),
        "k_up": (lambda: kl.up(b, ec, with_dot=True), lambda: kl.up_plain(b, ec, with_dot=True),
                 ("field", "sum")),
    }
    out = {}
    for name, (kern, plain, kinds) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        sc = scales[name](ref) if name in scales else None
        err, tol = compare(f"{name} @ {label}", got, ref, kinds, sc)
        ms = cuda_ms(kern) if timed else float("nan")
        pms = cuda_ms(plain) if timed else float("nan")
        log(f"kernel {name:7s} @ {label}: max_abs_err {err:.3e} tol {tol:.3e}"
            + (f"  kernel {ms:.4f} ms  plain {pms:.4f} ms" if timed else ""))
        out[name] = (err, tol, ms, pms)
    return out


def small_solve_agrees():
    """A 64² solve on the card (kernels) against the CPU (plain versions):
    same stop reason and iteration counts, x within f32 round-off."""
    import torch

    from iterative_solvers_tpu_torch import Domain2D, PoissonProblem, StopConfig
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.solvers.multigrid import (
        MultigridPreconditioner,
        PaddedPreconditioner,
    )
    from iterative_solvers_tpu_torch.solvers.refine import fused_refined_solve

    dom = Domain2D(nx=64, ny=64)
    stop = StopConfig(eps_precision=-1, eps_residual=-1, eps_relative=1e-9)
    res = {}
    for dev in ("cpu", "cuda"):
        prob = PoissonProblem.manufactured(dom)
        lay = PaddedStencilOperator.from_domain(dom)
        M = MultigridPreconditioner.from_domain(dom, fuse=True, fuse_min_extent=16, device=dev)
        res[dev] = fused_refined_solve(
            lay, PaddedPreconditioner(inner=M, padded_op=lay), prob.rhs_field(device=dev),
            u_true=prob.true_solution_field(device=dev), stop=stop,
        )
    a, b = res["cpu"], res["cuda"]
    xa, xb = a.x, b.x.cpu()
    gap = float((xa - xb).abs().max() / xa.abs().max())
    log(f"solve 64^2 cuda vs cpu: reason {int(b.reason)}/{int(a.reason)} outer "
        f"{b.outer_iterations}/{a.outer_iterations} inner {b.iterations}/{a.iterations} "
        f"x rel gap {gap:.2e} (tol 1e-5)")
    if (b.reason, b.outer_iterations, b.iterations) != (a.reason, a.outer_iterations,
                                                         a.iterations):
        raise AssertionError("64^2 trajectory differs between the card and the CPU")
    if not (b.converged and gap < 1e-5):
        raise AssertionError("64^2 solve on the card disagrees with the CPU")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "iterative_solvers_tpu_torch")):
        print("chip_smoke: the iterative_solvers_tpu_torch package is missing", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build
    from iterative_solvers_tpu_torch import DirichletSolver, PoissonProblem, StopConfig
    from iterative_solvers_tpu_torch.core.domain import Domain2D
    from iterative_solvers_tpu_torch.kernels import _build
    from iterative_solvers_tpu_torch.ops.stencil import StencilOperator

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib, REPO)}")

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    # 16-row bands: several bands, and their halos, even on small grids
    check_kernels(Domain2D(nx=64, ny=64), gen, "gamma 64^2", timed=False, block_rows=16)
    check_kernels(Domain2D(nx=40, ny=50, shape="rect"), gen, "rect 40x50", timed=False,
                  block_rows=16)
    stats = check_kernels(Domain2D(nx=N, ny=N), gen, "8192^2 level 0", timed=True)
    torch.cuda.empty_cache()

    # 4. solves
    small_solve_agrees()
    stop = StopConfig(eps_precision=-1, eps_residual=-1, eps_relative=1e-6,
                      max_iterations=100000)
    solver = DirichletSolver(nx=N, ny=N, preconditioner="mg", precision="mixed", outer="f64",
                             fmg_cycles=0, device="cuda", stop=stop)
    solver.solve()  # warm: allocator pools, coarse inverse, masks
    _build.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    plain_on_cuda = dict(_build.plain_on_cuda)
    peak = torch.cuda.max_memory_allocated()
    dom = solver.domain
    b = PoissonProblem.manufactured(dom).rhs_field(device="cuda")
    x = torch.as_tensor(res.solution_field(dom), device="cuda")
    rel = float(torch.linalg.norm(b - StencilOperator.from_domain(dom)(x)) / torch.linalg.norm(b))
    log(f"solve {N}^2: converged {res.converged} reason {res.stop_reason.name} "
        f"outer {res.outer_iterations} inner {res.iterations} true_rel {rel:.3e} "
        f"refine {res.elapsed_s:.3f} s wall {wall:.3f} s peak_mem {peak / 2**30:.2f} GiB")
    log(f"launches {launches} plain_on_cuda {plain_on_cuda}")
    if not res.converged or not rel < 1e-6:
        raise AssertionError(f"{N}^2 solve failed: converged={res.converged} rel={rel:.3e}")
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing or plain_on_cuda:
        raise AssertionError(f"kernels not launched {missing}; plain on CUDA {plain_on_cuda}")

    # 5. summary
    log(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": stats[k][0], "ms": stats[k][2],
         "plain_ms": stats[k][3]}
        for k, (src, rep) in KERNELS.items()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

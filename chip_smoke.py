#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
final ``ok`` line:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the hand-written kernels from ``iterative_solvers_tpu_torch/csrc``
   (one nvcc per source, all started together);
3. kernels: each kernel against its plain torch version on the card, at a
   small gamma grid, a ragged rect grid, path B's 1024² layout and the
   8192² level-0 layout, with
   the max abs difference, the tolerance and CUDA-event timings of the
   kernel, its plain version and, for the stencil, one ``F.conv2d``;
4. solves, each main path run with the launch counts set to 0 just before
   it and read just after:
   - 64²: the cold f64-outer solve, the default solve (FMG warm start,
     double-f32 outer), path B plain and with the multigrid, and the FMG
     warm start with its Jacobi polish, each on the card against the CPU
     (plain versions);
   - path A, the JAX package's default solve, at 8192² through
     ``DirichletSolver`` (FMG, outer='ff'): converged, true f64 relative
     residual < 1e-6, its kernels launched;
   - the cold f64-outer 8192² solve of the first slice, as before;
   - the ff-vs-f64 A/B of path A's refinement (10 interleaved pairs);
   - path B, plain f32 CG on the fused engine (``operator='fused'``), at
     1024² to the relative criterion, and its ms per iteration at 8192²;
5. one JSON line with every kernel's numbers, the card line, then ``ok``.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
PKG = "iterative_solvers_tpu_torch/csrc/"
TPU = "iterative_solvers_tpu/kernels/"
# name -> (source, TPU kernel it replaces, f32 operations per node counted
# from its formula, the main path whose run gives its launch count)
KERNELS = {
    "k1": (PKG + "cg_fused.cu", TPU + "cg_fused.py:89", 14, "A"),
    "k2": (PKG + "cg_fused.cu", TPU + "cg_fused.py:133", 16, "B"),
    "k2_pcg": (PKG + "cg_fused.cu", TPU + "cg_fused.py:177", 16, "A"),
    "k_down": (PKG + "mg_fused.cu", TPU + "mg_fused.py:65", 22, "A"),
    "k_up": (PKG + "mg_fused.cu", TPU + "mg_fused.py:183", 26, "A"),
    "k_jacobi": (PKG + "mg_fused.cu", TPU + "mg_fused.py:238", 10, "A"),
    "stencil": (PKG + "stencil.cu", TPU + "stencil_pallas.py:124", 7, "B"),
    "k_resid_ff": (PKG + "resid_ff.cu", TPU + "resid_ff.py:111", 70, "A"),
}
PATH_KERNELS = {
    "A": ("k1", "k2_pcg", "k_down", "k_up", "k_jacobi", "k_resid_ff"),
    "f64": ("k1", "k2_pcg", "k_down", "k_up"),
    "B": ("k1", "k2", "stencil"),
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


def nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def compare(name, outs, refs, kinds, scales=None):
    """Check each output against the plain version's. ``kinds``: 'field'
    (64 eps32 · max|ref|), 'exact' (bit-equal), 'pair' (the low word of a
    double-f32 pair: 32 · max|bh| · 2⁻⁴⁸, ``scales[i]`` = max|bh|), 'sum'
    (partials reduced to one scalar: 64 eps32 · the sum of |terms|,
    ``scales[i]``, else |ref|) or 'max' (64 eps32 · |ref| after the max).
    Returns the worst field (field, exact or pair) error and its tolerance."""
    worst, worst_tol = 0.0, 0.0
    scales = scales or {}
    for i, (o, r, kind) in enumerate(zip(outs, refs, kinds)):
        if kind in ("field", "exact", "pair"):
            err = float((o.double() - r.double()).abs().max())
            tol = {"field": 64 * EPS32 * float(r.double().abs().max()), "exact": 0.0,
                   "pair": 32 * scales.get(i, 0.0) * 2.0**-48}[kind]
        else:
            red = (lambda t: t.double().sum()) if kind == "sum" else (lambda t: t.double().max())
            ro = float(red(r))
            err = abs(float(red(o)) - ro)
            tol = 64 * EPS32 * scales.get(i, abs(ro))
        if not err <= tol:
            raise AssertionError(f"{name}: {kind} output {i} differs by {err:.3e} > tol {tol:.3e}")
        if kind != "sum" and kind != "max" and err * max(worst_tol, 1e-300) >= worst * max(tol, 1e-300):
            worst, worst_tol = err, tol
    return worst, worst_tol


def check_kernels(dom, gen, label, timed, block_rows=None):
    """Each kernel against its plain version on one layout (the solver's own,
    or ``block_rows``-row bands); returns {name: dict of max_abs_err, ms,
    plain_ms, library_ms, bytes, nodes}."""
    import torch
    import torch.nn.functional as F

    from iterative_solvers_tpu_torch.kernels import cg_fused, resid_ff
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.ops.ddf32 import split_f64
    from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner

    lay = PaddedStencilOperator.from_domain(dom, block_rows=block_rows)
    M = MultigridPreconditioner.from_domain(dom, fuse=True, fuse_min_extent=16, device="cuda")
    kl = M.levels[0].kernels
    mask = lay.mask_spec.build("cuda")

    def field(shape, masked=True):
        t = torch.randn(shape, device="cuda", generator=gen)
        return torch.where(mask, t, 0.0) if masked else t

    d, z, x, r, w, u = (field(lay.padded_shape) for _ in range(6))
    beta = torch.tensor(0.37, device="cuda")
    scal = torch.tensor([-1.3e-4, 0.37], device="cuda")
    b = field(kl.padded_shape, masked=False)
    xj = field(kl.padded_shape, masked=False)
    ec = torch.randn(kl.padded_shape[0] // 2, kl.padded_shape[1], device="cuda", generator=gen)
    side = cg_fused.k1_plain(w, z, beta, lay)[0]
    side_r = cg_fused.k1_plain(r, z, beta, lay)[0]
    bm = torch.where(kl.mask_spec.build("cuda"), b, 0.0)
    # a double-f32 pair problem at the solver's scales: b ~ 1e4, x ~ 1
    bh, bl = split_f64(torch.where(mask, torch.randn(lay.padded_shape, device="cuda",
                                                     dtype=torch.float64, generator=gen), 0.0) * 1e4)
    xh, xl = split_f64(torch.where(mask, torch.randn(lay.padded_shape, device="cuda",
                                                     dtype=torch.float64, generator=gen), 0.0))
    bh_max = float(bh.abs().max())
    # sums that may cancel are held to the sum of their terms' magnitudes
    scales = {
        "k1": lambda ref: {1: float((d * (d + beta * z)).abs().double().sum())},
        "k_up": lambda ref: {1: float((bm * ref[0]).abs().double().sum())},
        "k_resid_ff": lambda ref: {1: bh_max},
    }
    # name: (kernel, plain, output kinds, inputs for the byte count)
    cases = {
        "k1": (lambda: cg_fused.k1(d, z, beta, lay), lambda: cg_fused.k1_plain(d, z, beta, lay),
               ("field", "sum", "sum", "max"), (d, z)),
        "k2": (lambda: cg_fused.k2(x, r, z, side_r, scal, lay),
               lambda: cg_fused.k2_plain(x, r, z, side_r, scal, lay),
               ("field", "field", "field", "sum", "max"), (x, r, z, side_r)),
        "k2_pcg": (lambda: cg_fused.k2_pcg(x, r, z, w, side, scal, lay),
                   lambda: cg_fused.k2_pcg_plain(x, r, z, w, side, scal, lay),
                   ("field", "field", "field", "sum", "max"), (x, r, z, w, side)),
        "k_down": (lambda: (kl.down(b),), lambda: (kl.down_plain(b),), ("field",), (b,)),
        "k_up": (lambda: kl.up(b, ec, with_dot=True), lambda: kl.up_plain(b, ec, with_dot=True),
                 ("field", "sum"), (b, ec)),
        "k_jacobi": (lambda: (kl.jacobi(xj, b),), lambda: (kl.jacobi_plain(xj, b),),
                     ("field",), (xj, b)),
        "stencil": (lambda: (lay(x),), lambda: (lay.apply_plain(x),), ("field",), (x,)),
        "k_resid_ff": (lambda: resid_ff.resid_ff(xh, xl, bh, bl, lay),
                       lambda: resid_ff.resid_ff_plain(xh, xl, bh, bl, lay),
                       ("exact", "pair"), (xh, xl, bh, bl)),
    }
    # the true-solution variants of K2 and K2-pcg (the ‖x − u‖∞ partials)
    extra = {
        "k2+u": (lambda: cg_fused.k2(x, r, z, side_r, scal, lay, u=u),
                 lambda: cg_fused.k2_plain(x, r, z, side_r, scal, lay, u=u),
                 ("field", "field", "field", "sum", "max", "max")),
        "k2_pcg+u": (lambda: cg_fused.k2_pcg(x, r, z, w, side, scal, lay, u=u),
                     lambda: cg_fused.k2_pcg_plain(x, r, z, w, side, scal, lay, u=u),
                     ("field", "field", "field", "sum", "max", "max")),
    }
    for name, (kern, plain, kinds) in extra.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err, tol = compare(f"{name} @ {label}", got, ref, kinds)
        log(f"kernel {name:10s} @ {label}: max_abs_err {err:.3e} tol {tol:.3e}")
    out = {}
    for name, (kern, plain, kinds, ins) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        sc = scales[name](ref) if name in scales else None
        err, tol = compare(f"{name} @ {label}", got, ref, kinds, sc)
        rec = {"max_abs_err": err, "bytes": nbytes(ins) + nbytes(got),
               "nodes": lay.padded_shape[0] * lay.padded_shape[1], "library_ms": None}
        line = f"kernel {name:10s} @ {label}: max_abs_err {err:.3e} tol {tol:.3e}"
        if timed:
            rec["ms"], rec["plain_ms"] = cuda_ms(kern), cuda_ms(plain)
            line += f"  kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms"
            if name == "stencil":
                # yardstick: one cuDNN convolution with the 5-point cross
                cd, cx, cy = lay.coeffs
                wt = torch.tensor([[0.0, cy, 0.0], [cx, cd, cx], [0.0, cy, 0.0]],
                                  device="cuda").view(1, 1, 3, 3)
                xin = x.view(1, 1, *x.shape)
                rec["library_ms"] = cuda_ms(lambda: F.conv2d(xin, wt, padding=1))
                line += f"  conv2d {rec['library_ms']:.4f} ms"
        log(line)
        out[name] = rec
    return out


def solve_64_agrees(label, run):
    """``run(device)`` -> (stop reason, outer count, inner count, converged,
    x on the CPU) at 64²: the card against the CPU — same stop reason and
    iteration counts, x within f32 round-off."""
    res = {dev: run(dev) for dev in ("cpu", "cuda")}
    a, b = res["cpu"], res["cuda"]
    gap = float((a[4] - b[4]).abs().max() / a[4].abs().max())
    log(f"{label} cuda vs cpu: reason {int(b[0])}/{int(a[0])} outer {b[1]}/{a[1]} "
        f"inner {b[2]}/{a[2]} x rel gap {gap:.2e} (tol 1e-5)")
    if b[:3] != a[:3]:
        raise AssertionError(f"{label}: trajectory differs between the card and the CPU")
    if not (b[3] and gap < 1e-5):
        raise AssertionError(f"{label}: the solve on the card disagrees with the CPU")


def small_checks():
    """64² checks of both refinement paths, of the FMG warm start and of
    path B (plain and preconditioned fused CG through the facade)."""
    import torch

    from iterative_solvers_tpu_torch import DirichletSolver, Domain2D, PoissonProblem, StopConfig
    from iterative_solvers_tpu_torch.api import _attach_fmg
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.solvers.multigrid import (
        MultigridPreconditioner,
        PaddedPreconditioner,
    )
    from iterative_solvers_tpu_torch.solvers.refine import fused_refined_solve

    dom = Domain2D(nx=64, ny=64)
    prob = PoissonProblem.manufactured(dom)
    lay = PaddedStencilOperator.from_domain(dom)

    def padded_mg(dev):
        M = MultigridPreconditioner.from_domain(dom, fuse=True, fuse_min_extent=16, device=dev)
        return _attach_fmg(PaddedPreconditioner(inner=M, padded_op=lay), prob)

    def run(dev, stop, **kw):
        r = fused_refined_solve(lay, padded_mg(dev), prob.rhs_field(device=dev),
                                u_true=prob.true_solution_field(device=dev), stop=stop, **kw)
        return r.reason, r.outer_iterations, r.iterations, r.converged, r.x.cpu()

    def run_b(dev, preconditioner):
        r = DirichletSolver(nx=64, ny=64, operator="fused", preconditioner=preconditioner,
                            device=dev).solve()
        return (r.stop_reason, r.outer_iterations, r.iterations, r.converged,
                torch.from_numpy(r.solution))

    solve_64_agrees("solve 64^2 cold f64", lambda dev: run(
        dev, StopConfig(eps_precision=-1, eps_residual=-1, eps_relative=1e-9)))
    solve_64_agrees("solve 64^2 fmg ff", lambda dev: run(
        dev, StopConfig(eps_precision=-1, eps_residual=-1, eps_relative=1e-6), fmg=1, ff=True))
    solve_64_agrees("path B 64^2 plain CG", lambda dev: run_b(dev, None))
    solve_64_agrees("path B 64^2 mg PCG", lambda dev: run_b(dev, "mg"))
    # the warm start with the Jacobi polish at every fused level (cutoff 16)
    kw = dict(polish_max_extent=16, smooth_sweeps=1)
    x0 = {dev: padded_mg(dev).fmg_stepwise(lay.pad(prob.rhs_field(device=dev)), 1, **kw)
          for dev in ("cpu", "cuda")}
    ref = x0["cpu"]
    gap = float((x0["cuda"].cpu() - ref).abs().max() / ref.abs().max())
    log(f"fmg_stepwise 64^2 cutoff 16 cuda vs cpu: x0 rel gap {gap:.2e} (tol 1e-5)")
    if not gap < 1e-5:
        raise AssertionError("FMG warm start on the card disagrees with the CPU")
    torch.cuda.synchronize()


def true_rel(solver, res):
    import torch

    from iterative_solvers_tpu_torch import PoissonProblem
    from iterative_solvers_tpu_torch.ops.stencil import StencilOperator

    dom = solver.domain
    b = PoissonProblem.manufactured(dom).rhs_field(device="cuda")
    x = torch.as_tensor(res.solution_field(dom), device="cuda")
    return float(torch.linalg.norm(b - StencilOperator.from_domain(dom)(x)) / torch.linalg.norm(b))


def timed_solve(solver, path):
    """Warm solve, then one solve with the launch counts set to 0 just before
    it and read just after. Returns (results, wall s, launches)."""
    import torch

    from iterative_solvers_tpu_torch.kernels import _build

    solver.solve()  # warm: allocator pools, coarse inverse, masks, FMG payload
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_build.launches), dict(_build.plain_on_cuda)
    peak = torch.cuda.max_memory_allocated()
    log(f"path {path} launches {launches} plain_on_cuda {plain} peak_mem {peak / 2**30:.2f} GiB")
    missing = [k for k in PATH_KERNELS[path] if launches.get(k, 0) <= 0]
    if missing or plain:
        raise AssertionError(f"path {path}: kernels not launched {missing}; plain on CUDA {plain}")
    return res, wall, launches


def refine_ab(solver, pairs=10):
    """ff vs f64 outer on path A's refinement (FMG warm start included):
    ``pairs`` pairs, alternating which runs first. Returns the medians, the
    pairs ff won, the quartiles of each side and the trajectories."""
    import torch

    from iterative_solvers_tpu_torch.solvers.refine import fused_refined_solve

    pop, Mp = solver._parts
    b = solver.problem.rhs_field(device="cuda")
    u = solver.problem.true_solution_field(device="cuda")
    times, traj = {"ff": [], "f64": []}, {}
    for i in range(pairs):
        for outer in (("ff", "f64") if i % 2 == 0 else ("f64", "ff")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fused_refined_solve(pop, Mp, b, u_true=u, stop=solver.stop, fmg=1,
                                      ff=outer == "ff")
            torch.cuda.synchronize()
            times[outer].append(time.perf_counter() - t0)
            traj[outer] = (int(res.reason), res.outer_iterations, res.iterations)
    med = {k: statistics.median(v) for k, v in times.items()}
    quart = {k: statistics.quantiles(v, n=4) for k, v in times.items()}
    wins = sum(f < g for f, g in zip(times["ff"], times["f64"]))
    log(f"A/B refine {N}^2 path A, {pairs} pairs: ff median {med['ff']:.4f} s quartiles "
        f"{quart['ff'][0]:.4f}/{quart['ff'][2]:.4f} traj {traj['ff']}; f64 median "
        f"{med['f64']:.4f} s quartiles {quart['f64'][0]:.4f}/{quart['f64'][2]:.4f} traj "
        f"{traj['f64']}; ff faster in {wins}/{pairs} pairs")
    log(f"A/B times ff {[round(t, 4) for t in times['ff']]} f64 {[round(t, 4) for t in times['f64']]}")
    return med, traj


def plain_cg_ms_per_iter():
    """Plain fused CG at 8192² with every criterion off: (t(105) − t(5)) / 100,
    each the median of 3 wall times of ``fused_cg_solve`` ending in a sync."""
    import torch

    from iterative_solvers_tpu_torch import Domain2D, PoissonProblem, StopConfig
    from iterative_solvers_tpu_torch.kernels.cg_fused import fused_cg_solve
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.solvers.cg import CGOptions

    dom = Domain2D(nx=N, ny=N)
    pop = PaddedStencilOperator.from_domain(dom)
    b = PoissonProblem.manufactured(dom).rhs_field(device="cuda")
    t = {}
    for n_it in (5, 105, 5, 105, 5, 105):
        opts = CGOptions(stop=StopConfig(eps_precision=-1, eps_residual=-1, max_iterations=n_it))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fused_cg_solve(pop, b, options=opts)
        torch.cuda.synchronize()
        t.setdefault(n_it, []).append(time.perf_counter() - t0)
        assert res.iterations == n_it
    ms = (statistics.median(t[105]) - statistics.median(t[5])) / 100 * 1e3
    log(f"plain CG {N}^2: {ms:.4f} ms/iteration (105-it {t[105]} s, 5-it {t[5]} s)")
    return ms


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
    from iterative_solvers_tpu_torch import DirichletSolver, StopConfig
    from iterative_solvers_tpu_torch.core.domain import Domain2D
    from iterative_solvers_tpu_torch.kernels import _build

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
    # path B's own layout (256-row bands)
    check_kernels(Domain2D(nx=1024, ny=1024), gen, "1024^2 path B", timed=False)
    stats = check_kernels(Domain2D(nx=N, ny=N), gen, "8192^2 level 0", timed=True)
    torch.cuda.empty_cache()

    # 4. solves
    small_checks()
    rel6 = StopConfig(eps_precision=-1, eps_residual=-1, eps_relative=1e-6,
                      max_iterations=100000)
    launches = {}
    # path A: the JAX package's default solve (fmg_cycles=1 by default)
    solver = DirichletSolver(nx=N, ny=N, preconditioner="mg", precision="mixed", outer="ff",
                             device="cuda", stop=rel6)
    res, wall, launches["A"] = timed_solve(solver, "A")
    rel = true_rel(solver, res)
    log(f"path A {N}^2 fmg ff: converged {res.converged} reason {res.stop_reason.name} "
        f"outer {res.outer_iterations} inner {res.iterations} true_rel {rel:.3e} "
        f"refine {res.elapsed_s:.4f} s wall {wall:.3f} s")
    if not res.converged or not rel < 1e-6:
        raise AssertionError(f"path A failed: converged={res.converged} rel={rel:.3e}")
    ab_med, ab_traj = refine_ab(solver)
    if ab_traj["ff"] != ab_traj["f64"]:
        log("A/B: the ff and f64 trajectories differ")
    del solver, res
    torch.cuda.empty_cache()
    # the first slice's cold f64-outer solve, unchanged
    solver = DirichletSolver(nx=N, ny=N, preconditioner="mg", precision="mixed", outer="f64",
                             fmg_cycles=0, device="cuda", stop=rel6)
    res, wall, launches["f64"] = timed_solve(solver, "f64")
    rel = true_rel(solver, res)
    log(f"cold f64 {N}^2: converged {res.converged} reason {res.stop_reason.name} "
        f"outer {res.outer_iterations} inner {res.iterations} true_rel {rel:.3e} "
        f"refine {res.elapsed_s:.4f} s wall {wall:.3f} s")
    if not res.converged or not rel < 1e-6:
        raise AssertionError(f"cold f64 solve failed: converged={res.converged} rel={rel:.3e}")
    del solver, res
    torch.cuda.empty_cache()
    # path B: plain f32 CG on the fused engine (f32 bounds its true residual)
    nb = 1024
    solver = DirichletSolver(nx=nb, ny=nb, operator="fused", device="cuda", stop=rel6)
    res, wall, launches["B"] = timed_solve(solver, "B")
    rel = true_rel(solver, res)
    log(f"path B {nb}^2 plain CG: converged {res.converged} reason {res.stop_reason.name} "
        f"iterations {res.iterations} true_rel {rel:.3e} solve {res.elapsed_s:.4f} s "
        f"wall {wall:.3f} s")
    if not (res.converged and res.stop_reason.name == "RELATIVE_RESIDUAL" and rel < 1e-3):
        raise AssertionError(f"path B failed: converged={res.converged} rel={rel:.3e}")
    del solver, res
    torch.cuda.empty_cache()
    plain_cg_ms_per_iter()

    # 5. summary
    kernels = []
    for k, (src, rep, ops, path) in KERNELS.items():
        s = stats[k]
        t_bytes = s["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = ops * s["nodes"] / F32_OPS_PER_S * 1e3
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[path].get(k, 0), "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": s["library_ms"], "path": path,
        })
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the time of a solve goes on the card: ``torch.profiler`` over one
solve of each main path, after a warm-up solve.

    python -m iterative_solvers_tpu_torch.profile_paths [--n 8192] [--nb 1024] [--n3 512]
        [--ns 128] [--paths A,f64,B,3D,C,C-B,mesh-a,mesh-B,mesh-3D,S,precond] [--out DIR]

Paths: A, the default solve (FMG warm start, double-f32 outer) at ``n``²;
the cold f64-outer solve at ``n``²; B, plain f32 CG on the fused engine
(``operator='fused'``) at ``nb``²; 3D, the box at ``n3``³ (FMG warm start,
double-f32 outer, ``device_refined_solve`` on the padded 7-point operator,
as the JAX package's bench runs it); C, the default solve (double-f32
outer) on the custom-mask notched disk at ``n``²; C-B, plain f32 CG on the
fused engine on the notched disk at ``nb``²; mesh-a ("mesh a"), the JAX
package's sharded fast path at ``n``² on a 1x1 mesh (``device_refined_solve``
on the halo stencil D1 with the shard-fused V-cycle's D3 and D4 and its FMG,
called directly: no facade route runs it), then D3 and D4 alone on each
shard-fused level; mesh-B ("mesh fused B"), path
B on a 1x1 mesh (``operator='fused'``, ``mesh=make_solver_mesh(1)``: the
sharded fused engine's D5 and D6 on the mesh's own layout) at ``nb``²;
mesh-3D, the 3D facade with a mesh at ``n3``³ on a 1x1 mesh
(``operator='pallas'``, ``mg``, ``mixed``: the f64 outer around inners on the
halo stencil D2, the plain V-cycle, whole on the one block). For
each it prints the facade's ``solve()`` wall time, then profiles the solver
core alone (the refinement, or the CG solve, on fields assembled
beforehand): its time without and with the profiler, the device-busy time
(the union of the device events' intervals), the idle share of the
profiled window, the device time of the port's own kernels against all
other device ops (torch glue), the device ops with the most self time (on
the CG paths B, C-B and mesh-B also the core time and the device-busy time
per iteration: the first well above the second means the host loop sets
the pace), and the profiled solve's host time by span name
(``profiling.py``'s recorder: each span's self time, i.e. its duration less
its child spans', so the layers' shares of the solve's wall); with
``--out``, also a Chrome trace per path. For mesh-3D it then times D2 alone
and the operator's apply (its halo exchange, then D2) with CUDA events;
precond, ``bench.py``'s ``precond`` race at ``PRECOND_N``² (4096²): plain
CG and Chebyshev-8 PCG on the padded operator (A1 once an iteration, eight
more in each Chebyshev apply), each profiled as a CG path, after a
20-iteration warm-up. S is not profiled but timed: the 3D
``operator="stencil"`` route's plain f32 7-point apply at ``n3``³ (CUDA
events), then its mixed Jacobi solve at ``ns``³ with its spans' self times.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from iterative_solvers_tpu_torch.api import DirichletSolver
from iterative_solvers_tpu_torch.core.domain import Domain2D, Domain3D, notched_disk
from iterative_solvers_tpu_torch.core.problem import PoissonProblem
from iterative_solvers_tpu_torch.kernels.cg_fused import fused_cg_solve
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
from iterative_solvers_tpu_torch.parallel import ShardedPallasStencilOperator, make_solver_mesh
from iterative_solvers_tpu_torch.parallel.cg_fused_sharded import sharded_fused_cg_solve
from iterative_solvers_tpu_torch.parallel.mg_sharded import ShardedFusedMultigrid
from iterative_solvers_tpu_torch.profiling import RECORDER, Profiler, self_times
from iterative_solvers_tpu_torch.solvers.cg import CGOptions, cg_solve
from iterative_solvers_tpu_torch.solvers.precond import ChebyshevPreconditioner
from iterative_solvers_tpu_torch.solvers.refine import (
    _padded_hi_operator,
    device_refined_solve,
    fused_refined_solve,
)
from iterative_solvers_tpu_torch.solvers.stopping import StopConfig

PRECOND_N = 4096  # bench.py's precond race

# the port's hand-written kernels (csrc/*.cu), as the profiler names them
# (the mesh blocks' as *_block_kernel)
_OWN_KERNEL = re.compile(
    r"(?<![A-Za-z_])(k1|k2|k_down3?d?|k_up3?d?|k_jacobi3?d?|stencil3?d?|k_resid_ff3?d?)"
    r"(_block)?_kernel"
)


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


def _own_kernel_us(prof):
    """(µs of the port's kernels, µs of every other kernel) summed over the
    device events (the ops' own rows would count each kernel twice)."""
    own = other = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.time_range.end - e.time_range.start
        if _OWN_KERNEL.search(e.name):
            own += t
        else:
            other += t
    return own, other


def _event_ms(fn, reps=5):
    """Median CUDA-event time of ``fn`` (ms) after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def print_self_times(t0_ns: int) -> None:
    """The host time of the solves recorded since ``t0_ns`` (Unix-epoch ns)
    by span name: each span's self time, largest first, with its share of
    the solves' wall."""
    solves = [s for s in RECORDER.solves if s.t0 >= t0_ns]
    ids = {s.sid for s in solves}
    st = self_times(sp for sp in RECORDER.spans if sp.solve in ids)
    total = max(sum(s.t1 - s.t0 for s in solves), 1)
    reads = sum(s.counters["host_reads"] for s in solves)
    print(f"   spans: {len(solves)} solve(s), {total / 1e6:.3f} ms, {reads} host reads; "
          "self time by span:")
    for name, ns in sorted(st.items(), key=lambda kv: -kv[1]):
        print(f"     {name:24s} {ns / 1e6:10.3f} ms  {100 * ns / total:5.1f} %")


def breakdown_mesh_3d(solver: DirichletSolver) -> None:
    """The mesh 3D route's halo stencil, CUDA events: D2 on the block with
    its halos cut beforehand, and the operator's apply (the halo exchange,
    then D2)."""
    pop, _ = solver._parts
    x = torch.randn(pop.block_shape, device="cuda")
    halos = pop.halos_from_global(x, pop.origin)
    t = {"D2 on the block, halos cut beforehand": _event_ms(lambda: pop.apply_block(*halos)),
         "the operator's apply (halo exchange + D2)": _event_ms(lambda: pop(x))}
    for name, ms in t.items():
        print(f"   {name:52s} {ms:9.3f} ms")


def stencil_route_3d(n3: int, ns: int, stop: StopConfig) -> None:
    """The 3D ``operator="stencil"`` route: the plain f32 7-point apply
    (``ops/stencil.py``, which also runs the 3D V-cycle's plain coarse
    levels and the mesh's plain V-cycle) at ``n3``³, CUDA events; then the
    facade's mixed Jacobi solve at ``ns``³ (warm), its counts, wall and
    spans' self times."""
    dom = Domain3D(n3, n3, n3)
    A = StencilOperator.from_domain(dom)
    x = torch.randn(dom.grid_shape, device="cuda")
    print(f"== path S: 3D operator='stencil' at {n3}^3: plain f32 7-point apply "
          f"{_event_ms(lambda: A(x)):.3f} ms")
    del x
    solver = DirichletSolver(domain=Domain3D(ns, ns, ns), operator="stencil",
                             preconditioner="jacobi", precision="mixed", device="cuda", stop=stop)
    solver.solve()
    t0 = time.time_ns()
    res, wall = _timed(lambda: solver.solve(profiler=Profiler()))
    print(f"   mixed Jacobi solve {ns}^3: {res.stop_reason.name} outer {res.outer_iterations} "
          f"inner {res.iterations}, wall {wall:.3f} s")
    print_self_times(t0)


def profile_path(name: str, solver: DirichletSolver, out_dir=None) -> None:
    solver.solve()  # warm-up: allocator pools, coarse inverse, masks, FMG payload
    _, wall = _timed(solver.solve)
    pop, Mp = solver._parts
    b = solver.problem.rhs_field(device="cuda")
    u = solver.problem.true_solution_field(device="cuda")
    if solver.precision == "mixed" and solver.mesh is not None:
        # the facade's mesh route (its f64 outer) on the mesh's own layout
        A_hi, bs, us = DirichletSolver._hi_operator(pop), pop.shard(b), pop.shard(u)

        def core():
            return device_refined_solve(A_hi, pop, bs, preconditioner=Mp, u_true=us,
                                        stop=solver.stop, fmg=solver.fmg_cycles)
    elif solver.precision == "mixed" and solver.is3d:
        A_hi, bp, up = _padded_hi_operator(pop), pop.pad(b), pop.pad(u)

        def core():
            return device_refined_solve(A_hi, pop, bp, preconditioner=Mp, u_true=up,
                                        stop=solver.stop, fmg=solver.fmg_cycles,
                                        ff=solver.outer_kind == "ff")
    elif solver.precision == "mixed":
        def core():
            return fused_refined_solve(pop, Mp, b, u_true=u, stop=solver.stop,
                                       fmg=solver.fmg_cycles, ff=solver.outer_kind == "ff")
    else:
        solve = fused_cg_solve if solver.mesh is None else sharded_fused_cg_solve

        def core():
            return solve(pop, b, u_true=u, options=CGOptions(stop=solver.stop, preconditioner=Mp))
    profile_core(name, core, f"facade solve() wall {wall:.3f} s",
                 per_iteration=solver.precision != "mixed", out_dir=out_dir)
    if solver.is3d and solver.mesh is not None:
        breakdown_mesh_3d(solver)


def profile_core(name: str, core, note: str, per_iteration=False, out_dir=None) -> None:
    """Profile one call of the solver core ``core`` (after one untimed and
    one timed call): its time without and with the profiler, device busy,
    idle share, the port's kernels against the glue, the top device ops,
    the profiled call's span self times; ``per_iteration`` (a CG loop) also
    per iteration, to show which side sets its pace."""
    res, t_core = _timed(core)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t_prof = _timed(core)  # the capture turns the spans on
    busy, first, last = _busy_us(prof)
    own, other = _own_kernel_us(prof)
    window = max(last - first, 1e-9)
    print(f"== path {name}: {res.reason.name} outer {getattr(res, 'outer_iterations', 0)} "
          f"inner {res.iterations}; {note}; core {t_core:.4f} s (profiled {t_prof:.4f} s)")
    print(f"   device busy {busy / 1e3:.3f} ms over a {window / 1e3:.3f} ms window of device "
          f"events: idle share {100 * (1 - busy / window):.1f} %")
    print(f"   device time: the port's kernels {own / 1e3:.3f} ms, other device kernels "
          f"and copies (torch glue) {other / 1e3:.3f} ms")
    if per_iteration:
        print(f"   per iteration: core {1e3 * t_core / res.iterations:.4f} ms, device busy "
              f"{busy / 1e3 / res.iterations:.4f} ms")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=18), flush=True)
    print_self_times(t0)
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))


def profile_mesh_a(n: int, stop: StopConfig, out_dir=None) -> None:
    """Path "mesh a", the JAX package's sharded fast path, at ``n``² on a
    1x1 mesh: ``device_refined_solve`` with the f64 halo twin outside and
    the halo stencil D1 and the shard-fused V-cycle (D3, D4 on every
    shard-fused level) with its FMG warm start inside, called directly (no
    facade route runs it). Then D3 and D4 alone on each shard-fused level's
    block (CUDA events)."""
    dom = Domain2D(nx=n, ny=n)
    prob = PoissonProblem.manufactured(dom)
    pop = ShardedPallasStencilOperator.from_domain(dom, make_solver_mesh(1))
    M = ShardedFusedMultigrid.from_operator(pop, dom, device="cuda").with_fmg(prob)
    A_hi = DirichletSolver._hi_operator(pop)
    b = pop.shard(prob.rhs_field(torch.float64, "cuda"))

    def core():
        return device_refined_solve(A_hi, pop, b, preconditioner=M, stop=stop, fmg=True)

    core()  # warm-up: allocator pools, coarse inverse, masks, FMG payload
    profile_core("mesh-a", core, "no facade (the fast path is called directly)",
                 out_dir=out_dir)
    for li, lev in enumerate(M.levels):
        hb, wb = lev.block_shape
        x = torch.randn((hb, wb), device="cuda")
        ec = torch.randn((hb // 2, wb), device="cuda")
        dh = lev.down_halos_from_global(x, (0, 0))
        uh = lev.up_halos_from_global(x, ec, (0, 0))
        print(f"   level {li} {(hb, wb)}: D3 {_event_ms(lambda: lev.down_block(*dh, (0, 0))):.4f}"
              f" ms, D4 with the dot "
              f"{_event_ms(lambda: lev.up_block(*uh, (0, 0), with_dot=True)):.4f} ms")


def profile_precond(n: int, stop: StopConfig, out_dir=None) -> None:
    """``bench.py``'s ``precond`` race at ``n``², as ``chip_smoke.py`` runs
    it: plain CG and Chebyshev-8 PCG (``solvers/cg.cg_solve``) on the padded
    operator, on the padded f32 right-hand side, to ``stop``; each after a
    20-iteration warm-up."""
    dom = Domain2D(nx=n, ny=n)
    op = PaddedStencilOperator.from_domain(dom)
    b = op.pad(PoissonProblem.manufactured(dom).rhs_field(torch.float64, "cuda").float())
    warm = StopConfig(max_iterations=20).disable_all_but_iterations()
    for name, pc in (("precond-plain", None),
                     ("precond-cheb8", ChebyshevPreconditioner.from_domain(op, dom, degree=8))):
        def core(pc=pc, stop=stop):
            return cg_solve(op, b, options=CGOptions(stop=stop, preconditioner=pc))

        core(stop=warm)
        profile_core(name, core, f"A1 on {op.padded_shape}, {op.block_rows}-row bands, no facade",
                     per_iteration=True, out_dir=out_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--nb", type=int, default=1024)
    ap.add_argument("--n3", type=int, default=512)
    ap.add_argument("--ns", type=int, default=128)
    ap.add_argument("--paths", default="A,f64,B,3D,C",
                    help="comma-separated subset of "
                         "A,f64,B,3D,C,C-B,mesh-a,mesh-B,mesh-3D,S,precond")
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
    solvers = {
        "A": lambda: DirichletSolver(nx=args.n, ny=args.n, outer="ff", **mixed),
        "f64": lambda: DirichletSolver(nx=args.n, ny=args.n, outer="f64", fmg_cycles=0, **mixed),
        "B": lambda: DirichletSolver(nx=args.nb, ny=args.nb, operator="fused", device="cuda",
                                     stop=rel6),
        "3D": lambda: DirichletSolver(domain=Domain3D(args.n3, args.n3, args.n3), outer="ff",
                                      **mixed),
        "C": lambda: DirichletSolver(
            domain=Domain2D(args.n, args.n, shape="custom", inside_fn=notched_disk), outer="ff",
            **mixed),
        "C-B": lambda: DirichletSolver(
            domain=Domain2D(args.nb, args.nb, shape="custom", inside_fn=notched_disk),
            operator="fused", device="cuda", stop=rel6),
        "mesh-B": lambda: DirichletSolver(nx=args.nb, ny=args.nb, operator="fused",
                                          mesh=make_solver_mesh(1), device="cuda", stop=rel6),
        "mesh-3D": lambda: DirichletSolver(domain=Domain3D(args.n3, args.n3, args.n3),
                                           operator="pallas", mesh=make_solver_mesh(1),
                                           **mixed),
    }
    for name in args.paths.split(","):
        if name == "S":
            stencil_route_3d(args.n3, args.ns, rel6)
        elif name == "mesh-a":
            profile_mesh_a(args.n, rel6, args.out)
        elif name == "precond":
            profile_precond(PRECOND_N, rel6, args.out)
        else:
            profile_path(name, solvers[name](), args.out)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

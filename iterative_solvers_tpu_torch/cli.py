"""Command-line front-end (counterpart of the JAX package's cli.py).

Flag-based, non-interactive replacement for the reference's stdin CLI
(reference solver/main.cpp:596-712: prompts for n, m on stdin, fixed [1,2]²
domain, then prints residual/error summaries and optional result/matrix
dumps). Everything the reference CLI and GUI expose is a flag here: grid,
bounds, per-criterion epsilons, operator choice, preconditioner, saves,
plots, and a live progress trace at the reference's cadence
(msg_solver.cpp:172-183).

The sub-commands, flags and exit codes are the JAX package's, with two
changes: ``--device {cuda,cpu}`` (default ``cuda``, which raises without a
card — nothing falls back to the CPU) takes the place of ``--platform``,
and ``--trace-dir`` writes a ``torch.profiler`` Chrome trace. Exit codes:
0 converged (or no stop criterion enabled), 2 not converged, 1 a usage or
configuration error.

Usage examples::

    python -m iterative_solvers_tpu_torch solve --nx 30 --ny 30
    python -m iterative_solvers_tpu_torch solve --nx 8192 --ny 8192 --precond mg \
        --precision mixed --outer ff --eps-precision -1 --eps-residual -1 \
        --eps-relative 1e-6 --profile --report --html out.html
    python -m iterative_solvers_tpu_torch solve --nx 64 --ny 64 --shape rect \
        --precond chebyshev:8 --save-npz out.npz --save-matrix mat.txt --device cpu
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="iterative_solvers_tpu_torch",
        description="Dirichlet-Poisson iterative solver on PyTorch and CUDA",
    )
    sub = p.add_subparsers(dest="command")

    s = sub.add_parser("solve", help="solve a Dirichlet-Poisson problem")
    s.add_argument("--config", metavar="FILE",
                   help="JSON/TOML SolveConfig; explicit flags override it")
    s.add_argument("--save-config", metavar="FILE",
                   help="write the effective config as JSON and continue")
    s.add_argument("--nx", type=int, default=30, help="x intervals (reference n)")
    s.add_argument("--ny", type=int, default=30, help="y intervals (reference m)")
    s.add_argument("--nz", type=int, default=0,
                   help="z intervals; > 0 selects the 3D box problem")
    s.add_argument("--x0", type=float, default=1.0)
    s.add_argument("--x1", type=float, default=2.0)
    s.add_argument("--y0", type=float, default=1.0)
    s.add_argument("--y1", type=float, default=2.0)
    s.add_argument("--z0", type=float, default=0.0)
    s.add_argument("--z1", type=float, default=1.0)
    s.add_argument("--shape", choices=["gamma", "rect"], default="gamma")
    s.add_argument("--mask", metavar="FILE", default=None,
                   help="boolean full-grid 'inside' mask (.npy, or .npz with "
                   "key 'inside'/'mask'), shape (ny+1, nx+1) — selects a "
                   "custom 2D domain (overrides --shape)")
    s.add_argument(
        "--operator",
        choices=["stencil", "sparse", "pallas", "fused"],
        default="stencil",
        help="stencil: torch matrix-free; sparse: CSR; pallas: the padded stencil kernel + "
        "standard CG (f32); fused: the fused CG kernels (f32)",
    )
    s.add_argument(
        "--precond", default=None, help="jacobi | chebyshev[:degree] | mg[:nu]"
    )
    s.add_argument("--beta", choices=["msg", "fr"], default="msg", help="CG beta recurrence")
    s.add_argument("--eps-precision", type=float, default=1e-6,
                   help="max-norm step criterion; <=0 disables")
    s.add_argument("--eps-residual", type=float, default=1e-6,
                   help="max-norm residual criterion; <=0 disables")
    s.add_argument("--eps-error", type=float, default=-1.0,
                   help="max-norm exact-error criterion; <=0 disables")
    s.add_argument("--eps-relative", type=float, default=-1.0,
                   help="relative l2 residual criterion; <=0 disables")
    s.add_argument("--max-iter", type=int, default=10000)
    s.add_argument("--dtype", choices=["f32", "f64"], default=None,
                   help="default: f64 (f32 for --operator pallas)")
    s.add_argument("--precision", choices=["mixed"], default=None,
                   help="mixed: f64 outer iterative refinement over f32 inner "
                   "MG-PCG — reference-grade accuracy at f32 speed")
    s.add_argument("--fmg-cycles", type=int, default=1, metavar="N",
                   help="FMG warm-start polish V-cycles per level for "
                   "--precision mixed (0 disables; 2-3 for sharp problems)")
    s.add_argument("--outer", choices=["auto", "f64", "ff"], default="auto",
                   help="mixed ladder's outer arithmetic: f64 | ff double-f32 pairs "
                   "(no f64 ops, same trajectory) | auto = f64 in 2D, ff in 3D")
    s.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the solve runs (default cuda; raises without a card)")
    s.add_argument("--progress-every", type=int, default=100,
                   help="live trace cadence (0 silences it)")
    s.add_argument("--live", action="store_true",
                   help="live TUI: in-place progress panel with log10 residual "
                   "sparkline; press q to cancel (reference GUI live view)")
    s.add_argument("--save", metavar="PATH", help="sectioned-text results file")
    s.add_argument("--save-npz", metavar="PATH", help="npz results file")
    s.add_argument("--save-matrix", metavar="PATH", help="CSR matrix + RHS dump")
    s.add_argument("--save-3d", metavar="PATH", help="gnuplot x y z export")
    s.add_argument("--plots", metavar="DIR", help="write convergence/scatter/heatmap/surface PNGs")
    s.add_argument("--html", metavar="PATH",
                   help="write a standalone interactive HTML explorer "
                   "(rotatable 3D surface, hover heatmap, convergence chart)")
    s.add_argument("--report", action="store_true", help="print the full text report")
    s.add_argument("--profile", action="store_true",
                   help="print per-phase timings + throughput to stderr")
    s.add_argument("--trace-dir", metavar="DIR",
                   help="capture a torch.profiler trace (DIR/trace.json, Chrome format)")
    s.add_argument("--quiet", action="store_true")
    s.add_argument("--print-matrix", action="store_true",
                   help="print the assembled system matrix as a console table "
                   "(small systems only)")
    s.add_argument("--print-rhs", action="store_true",
                   help="print the right-hand side to the console")
    s.add_argument("--print-vectors", metavar="Q", action="append", default=[],
                   choices=["solution", "true_solution", "residual", "error"],
                   help="print a result vector as an '# x y value' console "
                   "table (repeatable)")
    s.add_argument("--limit", type=int, default=0,
                   help="truncate printed tables to N rows (0 = all)")

    v = sub.add_parser(
        "view",
        help="reload a saved results file and re-plot / re-print it "
        "(the reference GUI's load-and-inspect capability)",
    )
    v.add_argument("file", help="sectioned-text (.txt) or .npz results file")
    v.add_argument("--shape", choices=["gamma", "rect"], default=None,
                   help="override the domain shape for grid-based plots "
                   "(default: the shape recorded in the file; files saved "
                   "before the SHAPE line existed fall back to gamma)")
    v.add_argument("--plots", metavar="DIR",
                   help="write the same PNG set as 'solve --plots'")
    v.add_argument("--html", metavar="PATH",
                   help="write the standalone interactive HTML explorer")
    v.add_argument("--report", action="store_true",
                   help="print the full text report (default when no other "
                   "output is requested)")
    v.add_argument("--print-vectors", metavar="Q", action="append", default=[],
                   choices=["solution", "true_solution", "residual", "error"],
                   help="print a result vector as a console table (repeatable)")
    v.add_argument("--limit", type=int, default=0,
                   help="truncate printed tables to N rows (0 = all)")
    v.add_argument("--save-npz", metavar="PATH",
                   help="re-save the loaded results as npz")

    sub.add_parser("version", help="print version")
    p._solve_parser = s  # for --config default injection (see main())
    return p


def cmd_solve(args) -> int:
    import torch

    from iterative_solvers_tpu_torch import results_io
    from iterative_solvers_tpu_torch.config import SolveConfig
    from iterative_solvers_tpu_torch.core import ordering

    cfg = SolveConfig(
        nx=args.nx, ny=args.ny, nz=args.nz,
        x0=args.x0, x1=args.x1, y0=args.y0, y1=args.y1,
        z0=args.z0, z1=args.z1, shape=args.shape, mask=args.mask,
        operator=args.operator, beta=args.beta, precond=args.precond,
        precision=args.precision, dtype=args.dtype,
        fmg_cycles=args.fmg_cycles, outer=args.outer,
        eps_precision=args.eps_precision, eps_residual=args.eps_residual,
        eps_error=args.eps_error, eps_relative=args.eps_relative,
        max_iter=args.max_iter,
    )
    if args.save_config:
        cfg.save(args.save_config)
        if not args.quiet:
            print(f"config written to {args.save_config}", file=sys.stderr)
    stop = cfg.stop_config()
    if not stop.any_enabled and not args.quiet:
        # reference GUI validates ">= 1 criterion" (mainwindow.cpp:211-216)
        print("note: no stop criterion enabled; running to --max-iter", file=sys.stderr)

    dom = cfg.make_domain()
    solver = cfg.make_solver(device=args.device)

    callback = None
    if args.outer == "ff" and (args.live or args.progress_every > 0):
        # the ff ladder has no host chunks to call back from (the facade
        # refuses a callback there). Drop the live trace instead of failing
        # the solve.
        if not args.quiet:
            print(
                "note: --outer ff runs as one device dispatch; live progress "
                "is unavailable (per-outer history is still recorded)",
                file=sys.stderr,
            )
        args.live = False
        args.progress_every = 0
    if args.progress_every > 0 and not args.quiet:
        def callback(k, prec, rmax, emax):
            def fmt(v):
                return "  -  " if math.isinf(v) else f"{v:.3e}"
            print(
                f"iter {k:>6}  |dx|inf={fmt(prec)}  |r|inf={fmt(rmax)}  |err|inf={fmt(emax)}",
                file=sys.stderr,
            )

    profiler = None
    if args.profile or args.trace_dir:
        from iterative_solvers_tpu_torch.profiling import Profiler

        profiler = Profiler()

    def run():
        if args.live:
            from iterative_solvers_tpu_torch.tui import live_solve

            return live_solve(
                solver,
                callback_every=max(1, args.progress_every),
                profiler=profiler,
            )
        return solver.solve(
            callback=callback,
            callback_every=max(1, args.progress_every),
            profiler=profiler,
        )

    if args.trace_dir:
        with profiler.device_trace(args.trace_dir):
            res = run()
        if not args.quiet:
            print(f"device trace written to {args.trace_dir}/trace.json", file=sys.stderr)
    else:
        res = run()

    if profiler is not None:
        print(profiler.report(), file=sys.stderr)

    if args.report or not args.quiet:
        print(res.report())

    if args.save:
        results_io.save_results(args.save, res)
    if args.save_npz:
        results_io.save_results_npz(args.save_npz, res)
    rhs = None
    if args.save_matrix or args.print_rhs:
        # the RHS in --dtype (f64 by default), compacted, on the host
        dtype = torch.float32 if args.dtype == "f32" else torch.float64
        rhs = ordering.pack(solver.problem.rhs_field(dtype, solver.device), dom).cpu().numpy()
    if args.save_matrix:
        results_io.save_matrix_and_rhs(args.save_matrix, dom, rhs)
    if args.save_3d:
        results_io.save_solution_3d(args.save_3d, res)
    if args.plots:
        _write_plots(res, dom, args.plots, args.quiet)
    if args.html:
        from iterative_solvers_tpu_torch.viz_html import export_html

        export_html(res, dom, args.html)
        if not args.quiet:
            print(f"interactive explorer written to {args.html}", file=sys.stderr)
    for q in args.print_vectors:
        from iterative_solvers_tpu_torch.report import vector_table

        print(vector_table(res, q, limit=args.limit))
    if args.print_matrix:
        from iterative_solvers_tpu_torch.report import matrix_table

        print(matrix_table(dom))
    if args.print_rhs:
        from iterative_solvers_tpu_torch.report import rhs_table

        print(rhs_table(dom, rhs))

    return 0 if res.converged or not stop.any_enabled else 2


def _write_plots(res, dom, outdir: str, quiet: bool) -> None:
    from iterative_solvers_tpu_torch import viz

    os.makedirs(outdir, exist_ok=True)
    if getattr(res, "history", None) is not None:
        viz.convergence_plot(res, os.path.join(outdir, "convergence.png"))
    elif not quiet:
        print("no recorded history; skipping convergence.png", file=sys.stderr)
    for q in ("solution", "error", "residual"):
        viz.scatter_plot(res, os.path.join(outdir, f"scatter_{q}.png"), q)
    if not getattr(res, "nz", 0):
        viz.heatmap(res, dom, os.path.join(outdir, "heatmap_error.png"), "error")
        viz.surface_3d(res, dom, os.path.join(outdir, "surface.png"))
    if not quiet:
        print(f"plots written to {outdir}/", file=sys.stderr)


def _interior_from_coords(res) -> "np.ndarray":
    """Reconstruct the full-grid interior mask from the saved unknown
    coordinates (text files don't store masks). The saved nodes ARE the
    interior; dilating them by one (8-neighborhood) yields an ``inside`` set
    whose Domain2D-derived boundary is exactly that dilation ring, leaving
    the saved nodes as the unknowns."""
    import numpy as np

    x0, x1, y0, y1 = res.bounds[:4]
    hx, hy = (x1 - x0) / res.nx, (y1 - y0) / res.ny
    ixs = np.rint((np.asarray(res.x_coords) - x0) / hx).astype(int)
    iys = np.rint((np.asarray(res.y_coords) - y0) / hy).astype(int)
    if ((ixs < 0) | (ixs > res.nx) | (iys < 0) | (iys > res.ny)).any():
        raise ValueError("saved coordinates fall outside the recorded bounds")
    interior = np.zeros((res.ny + 1, res.nx + 1), dtype=bool)
    interior[iys, ixs] = True
    return interior


def _view_domain_2d(res, shape_override):
    """Build the Domain2D a saved 2D result was solved on. Priority: explicit
    --shape flag > recorded shape > gamma (pre-SHAPE-line files)."""
    import numpy as np

    from iterative_solvers_tpu_torch.core.domain import Domain2D

    b = res.bounds
    shape = shape_override or getattr(res, "shape", "") or "gamma"
    if shape != "custom":
        return Domain2D(
            nx=res.nx, ny=res.ny,
            x0=b[0], x1=b[1], y0=b[2], y1=b[3], shape=shape,
        )
    # custom domains: exact mask from npz when present, else reconstructed
    # from the saved unknown coordinates
    mask = getattr(res, "interior_mask", None)
    if mask is None:
        interior = _interior_from_coords(res)
    else:
        interior = np.asarray(mask, dtype=bool)
    # 8-neighborhood dilation INCLUDING the center offset (unlike
    # Domain2D.boundary's neighbor sweep, which must exclude it)
    pad = np.pad(interior, 1)
    inside = np.zeros_like(interior)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            inside |= pad[1 + dy : pad.shape[0] + dy - 1,
                          1 + dx : pad.shape[1] + dx - 1]
    dom = Domain2D(
        nx=res.nx, ny=res.ny,
        x0=b[0], x1=b[1], y0=b[2], y1=b[3],
        shape="custom", inside_fn=lambda ix, iy: inside[iy, ix],
    )
    if res.solution.size and int(dom.interior.sum()) != res.solution.size:
        # a pathological mask (e.g. a 1-node hole ringed by unknowns) can
        # defeat the dilation reconstruction — fail loudly rather than
        # scatter values onto the wrong nodes
        hint = (
            "; re-save the results as .npz (which stores the mask)"
            if mask is None
            else ""
        )
        raise ValueError(
            f"reconstructed custom domain has {int(dom.interior.sum())} "
            f"unknowns but the file stores {res.solution.size} values" + hint
        )
    return dom


def cmd_view(args) -> int:
    """Reload a saved results file and re-plot / re-print it — the CLI verb
    for the reference GUI's load-and-inspect capability
    (reference solver/dirichlet_solver.cpp:315-405 loadResults)."""
    from iterative_solvers_tpu_torch import results_io
    from iterative_solvers_tpu_torch.core.domain import Domain3D
    from iterative_solvers_tpu_torch.report import vector_table

    if args.file.endswith(".npz"):
        res = results_io.load_results_npz(args.file)
    else:
        res, _solver_name = results_io.load_results(args.file)

    b = res.bounds
    if getattr(res, "nz", 0):
        dom = Domain3D(
            nx=res.nx, ny=res.ny, nz=res.nz,
            x0=b[0], x1=b[1], y0=b[2], y1=b[3],
            z0=b[4] if len(b) > 4 else 0.0, z1=b[5] if len(b) > 5 else 1.0,
        )
    else:
        dom = _view_domain_2d(res, args.shape)

    did_output = False
    if args.plots:
        _write_plots(res, dom, args.plots, quiet=False)
        did_output = True
    if args.html:
        from iterative_solvers_tpu_torch.viz_html import export_html

        export_html(res, dom, args.html)
        print(f"interactive explorer written to {args.html}", file=sys.stderr)
        did_output = True
    for q in args.print_vectors:
        print(vector_table(res, q, limit=args.limit))
        did_output = True
    if args.save_npz:
        results_io.save_results_npz(args.save_npz, res)
        print(f"results re-saved to {args.save_npz}", file=sys.stderr)
        did_output = True
    if args.report or not did_output:
        print(res.report())
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if getattr(args, "config", None):
        # Config-file values become defaults; explicit flags still win.
        from iterative_solvers_tpu_torch.config import SolveConfig

        cfg = SolveConfig.load(args.config)
        parser2 = build_parser()
        # Defaults must be set on the SUBPARSER: since Python 3.7 subparsers
        # parse into a fresh namespace and overwrite parent-namespace values,
        # so pre-populating the namespace would not survive.
        parser2._solve_parser.set_defaults(**cfg.to_dict())
        args = parser2.parse_args(argv)
    if args.command == "version":
        from iterative_solvers_tpu_torch import __version__

        print(__version__)
        return 0
    if args.command is None:
        parser.print_help()
        return 1
    try:
        if args.command == "view":
            return cmd_view(args)
        return cmd_solve(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())

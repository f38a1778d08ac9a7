"""The port's CLI (``python -m iterative_solvers_tpu_torch``) against the JAX
package's (the port's side of test_cli_viz.py and the CLI cases of
test_aux_subsystems.py, test_viz_html.py and test_tui.py).

Parity: the same ``solve`` command on the same route gives the same
iteration count and stop reason in both packages, arrays within f64
round-off (1e-12 relative to each field's largest magnitude), and the same
report and console-printer lines apart from timings and the solver-name line
(numbers within the same tolerance). Without ``--device cpu`` and without a
card, ``solve`` raises: nothing falls back to the CPU.
"""

import contextlib
import io
import json
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from iterative_solvers_tpu import results_io as jio
from iterative_solvers_tpu.cli import main as jmain

from iterative_solvers_tpu_torch import results_io
from iterative_solvers_tpu_torch.cli import _view_domain_2d, main
from iterative_solvers_tpu_torch.config import SolveConfig
from iterative_solvers_tpu_torch.core.domain import Domain2D
from iterative_solvers_tpu_torch.api import DirichletSolver
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = ["--device", "cpu"]
QUIET = ["--quiet", "--progress-every", "0"]
# the same route in both packages: the plain stencil (f64), the sparse CSR
# with Chebyshev, the host ladder (a live trace) with and without the FMG
# warm start, and the fused ff ladder with it
ROUTES = {
    "stencil": ["--nx", "16", "--ny", "16"] + QUIET,
    "sparse": ["--nx", "20", "--ny", "14", "--shape", "rect", "--operator", "sparse",
               "--precond", "chebyshev:4"] + QUIET,
    "mg ladder fmg0": ["--nx", "16", "--ny", "16", "--precond", "mg", "--precision", "mixed",
                       "--fmg-cycles", "0", "--progress-every", "5"],
    "mg ladder fmg2": ["--nx", "16", "--ny", "16", "--precond", "mg", "--precision", "mixed",
                       "--fmg-cycles", "2", "--progress-every", "5"],
    "mg ff fmg2": ["--nx", "16", "--ny", "16", "--precond", "mg", "--precision", "mixed",
                   "--fmg-cycles", "2", "--outer", "ff"] + QUIET,
}
PRINTERS = ["solve", "--nx", "6", "--ny", "6", "--print-matrix", "--print-rhs",
            "--print-vectors", "solution", "--print-vectors", "residual", "--report"] + QUIET
TOL = 1e-12


def _run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Every JAX CLI run of this file, once: (rc, stdout, stderr, npz)."""
    d = tmp_path_factory.mktemp("jax_cli")
    runs = {}
    for name, argv in ROUTES.items():
        npz = str(d / f"{name}.npz")
        runs[name] = _run(jmain, ["solve", *argv, "--platform", "cpu", "--save-npz", npz]) + (
            npz,)
    runs["printers"] = _run(jmain, PRINTERS + ["--platform", "cpu"]) + (None,)
    return runs


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    scale = max(np.abs(b).max(initial=0.0), 1.0)
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale, err_msg=what)


@pytest.mark.parametrize("route", list(ROUTES))
def test_solve_matches_jax_cli(tmp_path, jax_runs, route):
    jrc, _, jerr, jnpz = jax_runs[route]
    npz = str(tmp_path / "p.npz")
    rc, _, err = _run(main, ["solve", *ROUTES[route], *CPU, "--save-npz", npz])
    assert rc == jrc == 0
    got, want = results_io.load_results_npz(npz), jio.load_results_npz(jnpz)
    assert (got.iterations, got.stop_reason.name, got.converged) == (
        want.iterations, want.stop_reason.name, want.converged)
    # the live trace fires at the same iterations
    assert re.findall(r"iter +(\d+)", err) == re.findall(r"iter +(\d+)", jerr)
    for k in ("solution", "true_solution", "error", "x_coords", "y_coords"):
        _close(getattr(got, k), getattr(want, k), k)
    # the residual b - A x carries the round-off of A x: ‖A‖∞ ‖x‖∞ sets its scale
    x0, x1, y0, y1 = want.bounds
    norm_a = 4 * ((want.nx / (x1 - x0)) ** 2 + (want.ny / (y1 - y0)) ** 2)
    np.testing.assert_allclose(got.residual, want.residual, rtol=0,
                               atol=TOL * norm_a * np.abs(want.solution).max())


def _numbers(line):
    return [float(t) for t in re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?", line)]


def test_report_and_printers_match_jax(jax_runs):
    """The report and --print-matrix/--print-rhs/--print-vectors give the same
    lines: equal text, numbers within f64 round-off (the residual's to its
    RHS's round-off), the wall-time line aside."""
    rc, out, _ = _run(main, PRINTERS + CPU)
    jrc, jout, _, _ = jax_runs["printers"]
    assert rc == jrc == 0
    lines, jlines = out.splitlines(), jout.splitlines()
    assert len(lines) == len(jlines)
    assert "System matrix (16 x 16" in out and "-144" in out
    assert "Right-hand side (16 unknowns)" in out
    section = ""
    for a, b in zip(lines, jlines):
        if "Wall time" in a:
            assert "Wall time" in b
            continue
        if re.search(r"[a-zA-Z]", a) and not re.fullmatch(r"[\d\s.e+-]+", a):
            section = a
        assert re.sub(r"[-+]?\d+\.\d+(e[-+]?\d+)?", "#", a) == re.sub(
            r"[-+]?\d+\.\d+(e[-+]?\d+)?", "#", b), (a, b)
        x, y = _numbers(a), _numbers(b)
        # residual entries carry the round-off of A x: ‖A‖∞ ‖x‖∞ ≈ 576 · 20 at 6²
        atol = TOL * 576 * 20 if "residual" in section else 0.0
        np.testing.assert_allclose(x, y, rtol=TOL, atol=atol, err_msg=f"{a!r} vs {b!r}")


def test_solve_full(tmp_path):
    plots = str(tmp_path / "plots")
    rc, out, err = _run(main, [
        "solve", "--nx", "16", "--ny", "16", *CPU,
        "--save", str(tmp_path / "r.txt"), "--save-npz", str(tmp_path / "r.npz"),
        "--save-matrix", str(tmp_path / "m.txt"), "--save-3d", str(tmp_path / "s.dat"),
        "--plots", plots, "--progress-every", "10", "--profile",
        "--trace-dir", str(tmp_path / "trace"),
    ])
    assert rc == 0
    assert "Converged:               yes" in out
    assert "iter     10" in err  # progress cadence plumbed through
    assert "=== Profile ===" in err and "cg_chunk" in err and "effective_nnz_per_s" in err
    for f in ("r.txt", "r.npz", "m.txt", "s.dat"):
        assert (tmp_path / f).exists()
    for f in ("convergence.png", "scatter_solution.png", "scatter_error.png",
              "scatter_residual.png", "heatmap_error.png", "surface.png"):
        assert os.path.getsize(os.path.join(plots, f)) > 1000
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert {"solve", "cg_chunk"} <= names  # the phases' ranges on the timeline


@pytest.mark.parametrize("argv, rc", [
    (["solve", "--nx", "16", "--ny", "16", "--max-iter", "3", "--eps-residual", "1e-300",
      "--eps-precision", "-1", *CPU, "--quiet"], 2),
    (["solve", "--nx", "16", "--ny", "16", "--max-iter", "3", "--eps-residual", "-1",
      "--eps-precision", "-1", *CPU, "--quiet"], 0),  # no criterion: runs to --max-iter
    (["solve", "--nx", "7", "--ny", "8", *CPU, "--quiet"], 1),  # odd gamma grid
    ([], 1),
])
def test_exit_codes(argv, rc):
    assert _run(main, argv)[0] == rc


def test_version():
    rc, out, _ = _run(main, ["version"])
    assert rc == 0 and out.strip().count(".") == 2


def test_module_entry_point(monkeypatch, capsys):
    """``python -m iterative_solvers_tpu_torch`` runs the CLI and exits with its code."""
    monkeypatch.setattr(sys, "argv", ["iterative_solvers_tpu_torch", "solve", "--nx", "8",
                                      "--ny", "8", *CPU, "--quiet", "--report"])
    with pytest.raises(SystemExit) as exit_info:
        runpy.run_module("iterative_solvers_tpu_torch", run_name="__main__")
    assert exit_info.value.code == 0
    assert "Converged:               yes" in capsys.readouterr().out


def test_solve_without_card_raises(monkeypatch):
    """No --device cpu and no card: the 'no CUDA device' error, before any
    work runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(DirichletSolver, "solve", lambda *a, **k: calls.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["solve", "--nx", "8", "--ny", "8", "--quiet"])
    assert not calls


def test_view_round_trip(tmp_path):
    saved = str(tmp_path / "r.txt")
    assert _run(main, ["solve", "--nx", "16", "--ny", "16", "--save", saved, *CPU,
                       *QUIET])[0] == 0
    plots = str(tmp_path / "view_plots")
    rc, out, _ = _run(main, ["view", saved, "--plots", plots, "--report"])
    assert rc == 0 and "Dirichlet-Poisson solve report" in out
    for f in ("scatter_solution.png", "heatmap_error.png", "surface.png"):
        assert os.path.getsize(os.path.join(plots, f)) > 1000
    npz = str(tmp_path / "again.npz")
    assert _run(main, ["view", saved, "--save-npz", npz])[0] == 0
    rc, out, _ = _run(main, ["view", npz, "--print-vectors", "solution", "--limit", "5"])
    assert rc == 0 and "... (" in out and "solution" in out
    rc, out, _ = _run(main, ["view", saved])  # the report by default
    assert rc == 0 and "Outcome:" in out


def test_view_of_jax_file_matches_jax_view(tmp_path, jax_runs):
    """``view`` of a JAX npz prints the JAX view's lines."""
    npz = jax_runs["stencil"][3]
    args = ["view", npz, "--print-vectors", "error", "--limit", "7", "--report"]
    assert _run(main, args)[1] == _run(jmain, args)[1]


def test_view_uses_recorded_shape(tmp_path):
    saved = str(tmp_path / "rect.txt")
    assert _run(main, ["solve", "--nx", "7", "--ny", "7", "--shape", "rect", "--save", saved,
                       *CPU, *QUIET])[0] == 0
    assert _run(main, ["view", saved, "--html", str(tmp_path / "v.html")])[0] == 0
    assert _run(main, ["view", saved, "--shape", "rect", "--html",
                       str(tmp_path / "v2.html")])[0] == 0


def test_solve_mask_file(tmp_path):
    iy, ix = np.mgrid[0:11, 0:11]
    mfile = str(tmp_path / "mask.npy")
    np.save(mfile, ~((ix > 6) & (iy > 6)))  # notched rectangle
    saved = str(tmp_path / "m.txt")
    assert _run(main, ["solve", "--nx", "10", "--ny", "10", "--mask", mfile, "--save", saved,
                       *CPU, *QUIET])[0] == 0
    assert "SHAPE custom" in open(saved).read()
    assert _run(main, ["view", saved, "--html", str(tmp_path / "m.html")])[0] == 0
    rc, _, err = _run(main, ["solve", "--nx", "8", "--ny", "8", "--mask", mfile, *CPU, *QUIET])
    assert rc == 1 and "shape" in err


def test_view_custom_domain(tmp_path):
    dom = Domain2D(nx=12, ny=12, shape="custom",
                   inside_fn=lambda ix, iy: ~((ix > 8) & (iy > 8)))
    res = DirichletSolver(domain=dom, device="cpu").solve(record_history=False)
    assert res.shape == "custom" and res.interior_mask is not None
    npz = str(tmp_path / "c.npz")
    results_io.save_results_npz(npz, res)
    d2 = _view_domain_2d(results_io.load_results_npz(npz), None)
    np.testing.assert_array_equal(d2.interior, dom.interior)
    txt = str(tmp_path / "c.txt")
    res.save(txt)
    r3, _ = results_io.load_results(txt)
    assert r3.shape == "custom" and r3.interior_mask is None
    np.testing.assert_array_equal(_view_domain_2d(r3, None).interior, dom.interior)


def test_print_matrix_refuses_huge():
    rc, out, _ = _run(main, ["solve", "--nx", "64", "--ny", "64", *CPU, *QUIET,
                             "--print-matrix"])
    assert rc == 0 and "too large for a console table" in out


@pytest.mark.parametrize("flag, value", [("--outer", "ff"), ("--fmg-cycles", "0")])
def test_flags_round_trip_through_config(tmp_path, flag, value):
    cfg_path = str(tmp_path / "c.json")
    assert _run(main, ["solve", "--nx", "16", "--ny", "16", "--precond", "mg", "--precision",
                       "mixed", flag, value, "--save-config", cfg_path, *CPU, *QUIET])[0] == 0
    cfg = SolveConfig.load(cfg_path)
    attr = flag[2:].replace("-", "_")
    assert str(getattr(cfg, attr)) == value
    assert str(getattr(cfg.make_solver(device="cpu"), attr)) == value


@pytest.mark.parametrize("extra, grid", [([], "20 x 20"), (["--nx", "24", "--ny", "24"],
                                                          "24 x 24")])
def test_config_file_and_flag_override(tmp_path, extra, grid):
    path = str(tmp_path / "cfg.toml")
    with open(path, "w") as f:
        f.write("nx = 20\nny = 20\neps_precision = -1.0\neps_residual = 1e-3\n")
    rc, out, _ = _run(main, ["solve", "--config", path, *extra, *CPU, "--quiet", "--report"])
    assert rc == 0 and grid in out


def test_save_config(tmp_path):
    path = str(tmp_path / "out.json")
    assert _run(main, ["solve", "--nx", "16", "--ny", "16", "--eps-precision", "-1",
                       "--eps-residual", "1e-3", "--save-config", path, *CPU, "--quiet"])[0] == 0
    assert SolveConfig.load(path).nx == 16


def test_ff_with_a_live_trace_drops_the_trace():
    """--outer ff has no host chunks: the CLI notes it and drops the live
    trace (the facade itself refuses a callback on ff)."""
    rc, _, err = _run(main, ["solve", "--nx", "16", "--ny", "16", "--precond", "mg",
                             "--precision", "mixed", "--outer", "ff", "--live", *CPU])
    assert rc == 0 and "live progress is unavailable" in err and "iter " not in err
    s = DirichletSolver(nx=16, ny=16, preconditioner="mg", precision="mixed", outer="ff",
                        device="cpu")
    with pytest.raises(RuntimeError, match="callbacks"):
        s.solve(callback=lambda *a: None)


def test_live_flag():
    rc, _, err = _run(main, ["solve", "--nx", "12", "--ny", "12", "--live", "--quiet",
                             "--progress-every", "10", *CPU])
    assert rc == 0 and "done: converged=True" in err


def test_html(tmp_path):
    out = str(tmp_path / "solve.html")
    assert _run(main, ["solve", "--nx", "12", "--ny", "12", "--html", out, *CPU, *QUIET])[0] == 0
    doc = open(out, encoding="utf-8").read()
    m = re.search(r'<script type="application/json" id="data">(.*?)</script>', doc, re.S)
    assert json.loads(m.group(1))["meta"]["nx"] == 12

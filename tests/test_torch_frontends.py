"""The port's front-ends against the JAX package's: the profiler, the config,
the threaded driver, the TUI, the plots and the HTML explorer, and the
facade's members (the port's side of test_aux_subsystems.py, test_tui.py,
test_viz_html.py and the viz cases of test_cli_viz.py).

Cross-package: a config written as JSON or TOML by either package loads in
the other to the same fields; the profiler's counters of a solve equal the
JAX profiler's on the same route; ``cg_run`` equals the JAX ``cg_run``
within 1e-12 relative; the package exports the JAX package's 18 names.
"""

import dataclasses
import io
import json
import math
import re
import threading
import time

import numpy as np
import pytest
import torch

import iterative_solvers_tpu as jpkg
from iterative_solvers_tpu.api import DirichletSolver as JSolver
from iterative_solvers_tpu.config import SolveConfig as JConfig
from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.core.problem import PoissonProblem as JProblem
from iterative_solvers_tpu.ops.stencil import StencilOperator as JStencil
from iterative_solvers_tpu.profiling import Profiler as JProfiler
from iterative_solvers_tpu.solvers.cg import cg_run as jcg_run
from iterative_solvers_tpu.solvers.stopping import StopConfig as JStop
from iterative_solvers_tpu.tui import render_frame as jrender_frame

import iterative_solvers_tpu_torch as port
from iterative_solvers_tpu_torch import results_io, viz
from iterative_solvers_tpu_torch.api import DirichletSolver
from iterative_solvers_tpu_torch.async_driver import AsyncSolver, CompletionEvent, ProgressEvent
from iterative_solvers_tpu_torch.config import SolveConfig
from iterative_solvers_tpu_torch.core.domain import Domain2D, Domain3D
from iterative_solvers_tpu_torch.core.problem import PoissonProblem
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.profiling import RECORDER, Profiler
from iterative_solvers_tpu_torch.solvers.cg import CGOptions, cg_run, cg_solve
from iterative_solvers_tpu_torch.solvers.multigrid import (
    MultigridPreconditioner,
    PaddedPreconditioner,
)
from iterative_solvers_tpu_torch.solvers.precond import ChebyshevPreconditioner
from iterative_solvers_tpu_torch.solvers.refine import (
    _padded_hi_operator,
    device_refined_solve,
    fused_refined_solve,
)
from iterative_solvers_tpu_torch.solvers.stopping import StopConfig, StopReason
from iterative_solvers_tpu_torch.tui import live_solve, render_frame, sparkline
from iterative_solvers_tpu_torch.viz_html import export_html
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MIXED = dict(nx=32, ny=32, preconditioner="mg", precision="mixed",
             stop=dict(eps_precision=-1, eps_residual=1e-6, max_iterations=1000))


@pytest.fixture(scope="module")
def jax_profiles():
    """The JAX profiler's counters for the plain CG and the mixed host
    ladder (a callback makes JAX take it on the CPU), run once."""
    out = {}
    p = JProfiler()
    res = JSolver(nx=24, ny=24).solve(record_history=False, profiler=p)
    out["cg"] = (res.iterations, dict(p.counters), set(p.phases))
    p = JProfiler()
    kw = dict(MIXED, stop=JStop(**MIXED["stop"]))
    res = JSolver(**kw).solve(callback=lambda *a: None, record_history=False, profiler=p)
    out["ladder"] = (res.iterations, dict(p.counters), set(p.phases))
    return out


# --- profiling ----------------------------------------------------------------


def test_profiler_phases_and_counters():
    p = Profiler()
    with p.phase("a"):
        time.sleep(0.01)
    with p.phase("a"):
        with p.phase("nested"):
            pass
    p.count("iterations", 50)
    p.count("iterations", 25)
    assert p.phases["a"].calls == 2 and p.phases["nested"].calls == 1
    assert p.phases["a"].total_s >= 0.01
    assert p._top_total_s == pytest.approx(p.phases["a"].total_s)  # nested not counted twice
    assert p.counters["iterations"] == 75
    rep = p.report()
    assert "a" in rep and "iterations" in rep and "iterations_per_s" in rep


def test_profiler_through_solve_matches_jax(jax_profiles):
    p = Profiler()
    res = DirichletSolver(nx=24, ny=24, device="cpu").solve(record_history=False, profiler=p)
    iters, counters, phases = jax_profiles["cg"]
    assert res.converged and res.iterations == iters
    assert p.counters == counters  # iterations, operator_applies, nnz_per_apply
    assert phases <= set(p.phases)
    # the facade's own phases split the call: build, fields, solve, residual, copies
    assert {"assemble", "fields", "solve", "residual", "result_copies",
            "result_host"} <= set(p.phases)
    assert "effective_nnz_per_s" in p.throughput()
    assert p._top_total_s <= p.elapsed_s


def test_profiler_through_mixed_solve_matches_jax(jax_profiles):
    p = Profiler()
    kw = dict(MIXED, stop=StopConfig(**MIXED["stop"]))
    res = DirichletSolver(device="cpu", **kw).solve(callback=lambda *a: None,
                                                     record_history=False, profiler=p)
    iters, counters, phases = jax_profiles["ladder"]
    assert res.converged and res.iterations == iters
    assert p.counters["iterations"] == counters["iterations"]
    assert p.phases["inner_solve"].calls >= 1 and p.phases["outer_residual"].calls >= 1
    assert phases <= set(p.phases)


def test_profiler_through_device_ladder():
    p = Profiler()
    kw = dict(MIXED, stop=StopConfig(**MIXED["stop"]))
    s = DirichletSolver(device="cpu", **kw)
    res = s.solve(profiler=p)
    assert res.converged and p.counters["iterations"] == res.iterations
    assert p.phases["device_ir"].calls == 1 and p.phases["assemble"].calls == 1
    p2 = Profiler()
    s.solve(profiler=p2)  # the route is built once
    assert "assemble" not in p2.phases


REL6 = StopConfig(eps_precision=-1, eps_residual=-1, eps_relative=1e-6, max_iterations=1000)


def _mg_padded(dom, op):
    """The fused multigrid (plain versions on the CPU) with its FMG payload,
    under ``op``'s padded layout."""
    mg = MultigridPreconditioner.from_domain(dom, device="cpu", fuse=True, fuse_min_extent=16)
    prob = PoissonProblem.manufactured(dom)
    return PaddedPreconditioner(inner=mg.with_fmg(prob), padded_op=op), prob


def _fused_f64():
    dom = Domain2D(nx=32, ny=32)
    op = PaddedStencilOperator.from_domain(dom)
    M, prob = _mg_padded(dom, op)
    b = prob.rhs_field(torch.float64, "cpu")
    stop = StopConfig(eps_precision=1e-6, eps_residual=1e-6, max_iterations=1000)
    return lambda prof: fused_refined_solve(op, M, b, stop=stop, fmg=1, profiler=prof)


def _device_ff():
    dom = Domain3D(16, 16, 16)
    op = Padded3DStencilOperator.from_domain(dom)
    M, prob = _mg_padded(dom, op)
    b = op.pad(prob.rhs_field(torch.float64, "cpu"))
    return lambda prof: device_refined_solve(_padded_hi_operator(op), op, b, preconditioner=M,
                                             stop=REL6, fmg=1, ff=True, profiler=prof)


def _cg_chebyshev():
    dom = Domain2D(nx=32, ny=32)
    op = PaddedStencilOperator.from_domain(dom)
    M = ChebyshevPreconditioner.from_domain(op, dom, degree=8)
    b = op.pad(PoissonProblem.manufactured(dom).rhs_field(torch.float32, "cpu"))
    return lambda prof: cg_solve(op, b, options=CGOptions(stop=REL6, preconditioner=M,
                                                          profiler=prof))


# each span's possible parents (a top-level solve's own span has none)
_PARENTS = {
    "engine_refined_solve": {"fused_refined_solve"},
    "device_ir": {"engine_refined_solve", "device_refined_solve"},
    "fmg": {"device_ir"},
    "fmg_rung": {"fmg"},
    "inner_solve": {"device_ir"},
    "outer_residual": {"device_ir"},
    "setup": {"cg_solve"},
    "cg_chunk": {"cg_solve"},
    "inner_iter": {"inner_solve", "cg_chunk"},
    "precond": {"inner_solve", "inner_iter", "setup"},
    "vcycle_level": {"precond", "fmg_rung", "vcycle_level"},
    "host_read": {"device_ir", "inner_solve", "inner_iter", "outer_residual", "cg_solve"},
}


def _check_tree(spans, root_name):
    by_id = {sp.sid: sp for sp in spans}
    (root,) = [sp for sp in spans if sp.parent == 0]
    assert root.name == root_name
    for sp in spans:
        assert sp.solve == root.sid and sp.t0 <= sp.t1
        if sp is root:
            continue
        up = by_id[sp.parent]
        assert up.name in _PARENTS[sp.name], (sp.name, up.name)
        assert up.t0 <= sp.t0 and sp.t1 <= up.t1
        if sp.name == "vcycle_level" and up.name == "vcycle_level":
            assert sp.level == up.level + 1
    return {n: sum(sp.name == n for sp in spans) for n in {sp.name for sp in spans}}


@pytest.mark.parametrize("case, root", [(_fused_f64, "fused_refined_solve"),
                                        (_device_ff, "device_refined_solve"),
                                        (_cg_chebyshev, "cg_solve")],
                         ids=["fused_refined_solve_f64", "device_refined_solve_ff",
                              "cg_solve_chebyshev"])
def test_solve_spans_nest_count_and_never_synchronise(case, root, monkeypatch):
    """Off, a solve records nothing; with a Profiler, and under a
    torch.profiler capture, it records one solve whose spans nest as the
    layers do, one ``inner_iter`` an inner iteration, one ``inner_solve``
    and ``outer_residual`` an outer step and ``host_reads`` = 2 + Σ over the
    outers (2 + inner iterations) (cg_solve: 1 + iterations); no span or
    phase synchronises the card."""
    run = case()
    RECORDER.clear()
    run(None)
    assert not RECORDER.spans and not RECORDER.solves

    def no_sync(*a, **k):
        raise AssertionError("a span synchronised the card")

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "is_initialized", lambda: True)
        m.setattr(torch.cuda, "synchronize", no_sync)
        p = Profiler()
        res = run(p)
        with p.phase("a"):
            with p.phase("b"):
                pass
    (solve, _) = RECORDER.solves
    counts = _check_tree([sp for sp in RECORDER.spans if sp.solve == solve.sid], root)
    outers = getattr(res, "outer_iterations", 0)
    reads = 2 + 2 * outers + res.iterations if outers else 1 + res.iterations
    assert res.converged and counts["inner_iter"] == res.iterations
    assert counts.get("inner_solve", 0) == counts.get("outer_residual", 0) == outers
    assert solve.counters["host_reads"] == counts["host_read"] == reads
    assert p.phases["inner_iter"].calls == res.iterations and p.phases["b"].calls == 1
    assert p._top_total_s == pytest.approx(p.phases[root].total_s + p.phases["a"].total_s)
    if outers:
        assert counts["fmg"] == 1 and counts["vcycle_level"] > counts["precond"]
    RECORDER.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run(None)
    (solve,) = RECORDER.solves
    assert _check_tree(list(RECORDER.spans), root) == counts
    RECORDER.clear()


# --- config ---------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["json", "toml"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_config_round_trips_across_packages(tmp_path, fmt, writer):
    fields = dict(nx=48, ny=40, shape="rect", precond="mg:2", precision="mixed", dtype="f32",
                  fmg_cycles=2, outer="ff", eps_precision=-1.0, eps_relative=1e-9,
                  max_iter=321)
    path = str(tmp_path / f"cfg.{fmt}")
    src = (JConfig if writer == "jax" else SolveConfig)(**fields)
    if fmt == "json":
        src.save(path)
    else:
        with open(path, "w") as f:
            for k, v in fields.items():
                f.write(f"{k} = {json.dumps(v)}\n")
    for cls in (JConfig, SolveConfig):
        assert cls.load(path).to_dict() == src.to_dict()


def test_config_unknown_key_rejected(tmp_path):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump({"nx": 16, "epsilon": 1e-6}, f)
    with pytest.raises(ValueError, match="unknown config keys"):
        SolveConfig.load(path)


def test_config_make_solver():
    cfg = SolveConfig(nx=24, ny=24, precond="mg", eps_precision=-1, eps_residual=1e-3,
                      max_iter=100, dtype="f32", operator="pallas")
    s = cfg.make_solver(device="cpu")
    assert s.device.type == "cpu" and s.field_dtype == torch.float32
    res = s.solve(record_history=False)
    assert res.converged and res.iterations <= 15
    assert isinstance(SolveConfig(nx=8, ny=8, nz=8).make_domain(), Domain3D)


def test_config_make_solver_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolveConfig(nx=8, ny=8).make_solver()


# --- async driver ----------------------------------------------------------------


def test_async_solver_event_stream():
    s = DirichletSolver(nx=32, ny=32, device="cpu",
                        stop=StopConfig(eps_precision=-1, eps_residual=1e-4, max_iterations=2000))
    runner = AsyncSolver(s, callback_every=20).start()
    events = list(runner)
    assert isinstance(events[-1], CompletionEvent) and events[-1].converged
    progress = [e for e in events if isinstance(e, ProgressEvent)]
    assert progress[0].iteration == 0 and math.isinf(progress[0].precision)
    ks = [e.iteration for e in progress]
    assert ks == sorted(ks)
    res = runner.result(timeout=30)
    assert res.converged and ks[-1] == res.iterations


@pytest.mark.parametrize("kw", [dict(), dict(preconditioner="mg", precision="mixed",
                                             outer="f64")])
def test_async_solver_cancellation(kw):
    """stop() from the consuming thread reaches the worker's chunked loop
    (CG chunks, or the host ladder's outer steps)."""
    s = DirichletSolver(nx=64, ny=64, device="cpu", **kw,
                        stop=StopConfig(eps_precision=-1, eps_residual=1e-30,
                                        max_iterations=10**6))
    runner = AsyncSolver(s, callback_every=1).start()
    for seen, ev in enumerate(runner, 1):
        if seen == 3:
            runner.stop()
        if isinstance(ev, CompletionEvent):
            assert not ev.converged and "interrupt" in ev.reason
    assert runner.result(timeout=60).stop_reason == StopReason.INTERRUPTED


def test_async_solver_ff_refuses_live_events():
    s = DirichletSolver(nx=16, ny=16, preconditioner="mg", precision="mixed", outer="ff",
                        device="cpu")
    events = list(AsyncSolver(s).start())
    assert isinstance(events[-1].error, RuntimeError) and not events[-1].converged


def test_async_solver_usage_errors():
    runner = AsyncSolver(DirichletSolver(nx=16, ny=16, device="cpu"))
    with pytest.raises(RuntimeError, match="start"):
        next(iter(runner))
    with pytest.raises(RuntimeError, match="start"):
        runner.result()
    runner.start()
    runner.result(timeout=60)
    with pytest.raises(RuntimeError, match="already started"):
        runner.start()


def test_concurrent_solvers_thread_safety():
    stop = StopConfig(eps_precision=-1, eps_residual=1e-6, max_iterations=5000)

    def solve(n):
        return DirichletSolver(nx=n, ny=n, stop=stop, device="cpu").solve(record_history=False)

    serial = {n: solve(n) for n in (16, 24)}
    results, errs = {}, []

    def worker(n):
        try:
            results[n] = solve(n)
        except BaseException as e:  # surfaced to the main thread
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(n,)) for n in (16, 24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs, errs
    for n in (16, 24):
        assert results[n].iterations == serial[n].iterations
        np.testing.assert_array_equal(results[n].solution, serial[n].solution)


# --- TUI ----------------------------------------------------------------------------


@pytest.mark.parametrize("ev, hist, interactive", [
    (ProgressEvent(1200, 1.2e-4, 3.4e-3, 5.6e-3), [3.0e4, 1.0, 3.4e-3], True),
    (ProgressEvent(0, float("inf"), 3e4, float("inf")), [3e4], False),
])
def test_render_frame_matches_jax(ev, hist, interactive):
    """The panel's lines are the JAX TUI's, the title line aside."""
    from iterative_solvers_tpu.async_driver import ProgressEvent as JEvent

    lines = render_frame(ev, 10000, hist, elapsed_s=12.4, interactive=interactive)
    jlines = jrender_frame(JEvent(*dataclasses.astuple(ev)), 10000, hist, elapsed_s=12.4,
                           interactive=interactive)
    assert lines[1:] == jlines[1:]
    assert ("[q] cancel" in lines[0]) == interactive
    if not interactive:
        assert "\n".join(lines).count("   -    ") == 2  # inf norms as a dash


def test_sparkline_monotone():
    s = sparkline([10.0 ** -k for k in range(20)], width=10)
    levels = ["▁▂▃▄▅▆▇█".index(c) for c in s]
    assert len(s) == 10 and levels == sorted(levels, reverse=True)
    assert sparkline([]) == "" and sparkline([0.0, -1.0]) == ""


def test_live_solve_pipe():
    out = io.StringIO()
    res = live_solve(DirichletSolver(nx=16, ny=16, device="cpu"), callback_every=5, out=out,
                     key_poll=lambda: None)
    assert res.converged
    text = out.getvalue()
    assert "done: converged=True" in text and text.count("iter ") >= 2


def test_live_cancel_via_q():
    stop = StopConfig(eps_precision=-1, eps_residual=1e-300, max_iterations=100000)
    presses = iter([None, "q"])
    out = io.StringIO()
    res = live_solve(DirichletSolver(nx=32, ny=32, stop=stop, device="cpu"), callback_every=3,
                     out=out, key_poll=lambda: next(presses, "q"))
    assert res.stop_reason == StopReason.INTERRUPTED and not res.converged
    assert "cancelling" in out.getvalue() or "interrupted" in out.getvalue()


# --- plots and the HTML explorer ---------------------------------------------


@pytest.fixture(scope="module")
def small_solve():
    s = DirichletSolver(nx=16, ny=16, device="cpu")
    return s, s.solve()


def _payload(path):
    doc = open(path, encoding="utf-8").read()
    m = re.search(r'<script type="application/json" id="data">(.*?)</script>', doc, re.S)
    assert m, "embedded JSON payload missing"
    return doc, json.loads(m.group(1))


def test_viz_rejects_missing_quantity(tmp_path, small_solve):
    with pytest.raises(ValueError):
        viz.scatter_plot(small_solve[1], str(tmp_path / "x.png"), "nonsense")


def test_heatmap_stats(tmp_path, small_solve):
    s, res = small_solve
    stats = viz.heatmap(res, s.domain, str(tmp_path / "h.png"), "error")
    assert 0 <= stats["min"] <= stats["avg"] <= stats["max"]
    assert stats["max"] == pytest.approx(res.error_norm, rel=1e-9)


def test_export_payload_structure(tmp_path, small_solve):
    s, res = small_solve
    out = str(tmp_path / "exp.html")
    assert export_html(res, s.domain, out, title="t16") == out
    doc, d = _payload(out)
    assert set(d) == {"meta", "x", "y", "fields", "stats", "history"}
    assert set(d["fields"]) == {"solution", "true_solution", "error", "residual"}
    m = d["meta"]
    assert (m["nx"], m["ny"], m["converged"], m["iterations"]) == (16, 16, True, res.iterations)
    assert m["full"] == [17, 17] and m["sampled"] == [17, 17]
    assert "http://" not in doc and "https://" not in doc and "<title>t16</title>" in doc
    assert "NaN" not in doc.split('id="data">')[1].split("</script>")[0]
    sol = d["fields"]["solution"]
    for j in range(len(sol)):
        for i in range(len(sol[j])):
            assert (sol[j][i] is not None) == bool(s.domain.interior[j, i])
    assert len(d["history"]) == len(res.history) and d["history"][-1][0] == res.iterations


def test_export_matches_jax_payload(tmp_path, small_solve):
    """The same results give the JAX explorer's payload (title aside)."""
    from iterative_solvers_tpu.viz_html import export_html as jexport

    s, res = small_solve
    a, b = str(tmp_path / "p.html"), str(tmp_path / "j.html")
    export_html(res, s.domain, a, title="t", max_cells=9)
    jexport(res, JDomain2D(nx=16, ny=16), b, title="t", max_cells=9)
    assert _payload(a)[1] == _payload(b)[1]


def test_export_stats_are_full_field(tmp_path, small_solve):
    s, res = small_solve
    out = str(tmp_path / "exp.html")
    export_html(res, s.domain, out, max_cells=7)
    _, d = _payload(out)
    assert d["meta"]["sampled"] == [7, 7]
    assert d["x"][0] == pytest.approx(s.domain.x0) and d["x"][-1] == pytest.approx(s.domain.x1)
    assert d["stats"]["error"]["max"] == pytest.approx(float(np.max(np.abs(res.error))),
                                                       rel=1e-6)


def test_export_title_escaping_and_empty(tmp_path, small_solve):
    s, res = small_solve
    out = str(tmp_path / "exp.html")
    export_html(res, s.domain, out, title='<script>"x"</script>')
    assert "<title>&lt;script&gt;" in open(out, encoding="utf-8").read()
    hollow = dataclasses.replace(res, solution=np.empty(0), true_solution=np.empty(0),
                                 error=np.empty(0), residual=np.empty(0))
    with pytest.raises(ValueError, match="no per-node vectors"):
        export_html(hollow, s.domain, str(tmp_path / "x.html"))


def test_export_3d_mid_slice(tmp_path):
    dom = Domain3D(nx=8, ny=8, nz=8, x0=1, x1=2, y0=1, y1=2, z0=1, z1=2)
    s = DirichletSolver(domain=dom, device="cpu")
    out = str(tmp_path / "exp3d.html")
    export_html(s.solve(), s.domain, out)
    _, d = _payload(out)
    assert d["meta"]["nz"] == 8 and d["meta"]["slice_z"] == pytest.approx(1.5)
    assert d["meta"]["full"] == [9, 9]


# --- the facade's members and the exports ----------------------------------


def test_set_grid_and_set_stop():
    s = DirichletSolver(nx=16, ny=16, preconditioner="mg", device="cpu")
    first = s.solve()
    assert s._routes
    s.set_grid(24, 24, x1=3.0)
    assert not s._routes and s._parts is None  # the old grid's routes are dropped
    assert (s.domain.nx, s.domain.x1, s.domain.shape) == (24, 3.0, "gamma")
    s.set_stop(eps_precision=-1, eps_residual=-1, max_iterations=3)
    res = s.solve()
    assert res.nx == 24 and res.iterations == 3 and res.stop_reason == StopReason.ITERATIONS
    assert res.bounds == (1.0, 3.0, 1.0, 2.0) and first.nx == 16
    j = JSolver(nx=16, ny=16, preconditioner="mg")
    j.set_grid(24, 24, x1=3.0)
    j.set_stop(eps_precision=-1, eps_residual=-1, max_iterations=3)
    np.testing.assert_allclose(res.solution, j.solve().solution, rtol=1e-12)
    with pytest.raises(ValueError, match="2D-only"):
        DirichletSolver(domain=Domain3D(8, 8, 8), device="cpu").set_grid(16, 16)


def test_results_save_and_report(tmp_path, small_solve):
    from iterative_solvers_tpu.report import results_report

    _, res = small_solve
    res.save(str(tmp_path / "r.txt"))
    assert results_io.load_results(str(tmp_path / "r.txt"))[0].iterations == res.iterations
    assert res.report() == results_report(res)  # the JAX report of the same content


@pytest.mark.parametrize("n_iters", [1, 7])
def test_cg_run_matches_jax(n_iters):
    dom, jdom = Domain2D(nx=12, ny=12), JDomain2D(nx=12, ny=12)
    b = PoissonProblem.manufactured(dom).rhs_field(device="cpu")
    x, r2 = cg_run(StencilOperator.from_domain(dom), b, n_iters)
    jx, jr2 = jcg_run(JStencil.from_domain(jdom), JProblem.manufactured(jdom).rhs_field(),
                      n_iters)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(jx)).max())
    assert float(r2) == pytest.approx(float(jr2), rel=1e-12)


def test_exports_match_the_jax_package():
    assert set(port.__all__) - {"MaskSpec"} == set(jpkg.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None
    assert port.__version__.count(".") == 2

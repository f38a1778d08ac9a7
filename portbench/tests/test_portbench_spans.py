"""The span and counter metrics (``portbench/spans.py``; ``host_reads_per_solve``,
``host_wait_ms_per_solve``, ``fmg_ms_per_solve``, ``precond_ms_per_solve``,
``outer_ms_per_solve``) on a small traced run of each cell on the CPU: each
is reported in the cells the manifest lists it for, read from the window's
solves alone, and ``host_reads_per_solve`` is what the solves' own counts
give: 2 + Σ over the outer steps (2 + inner iterations) a refined solve,
1 + iterations a CG solve."""

from types import SimpleNamespace

import pytest

from portbench import run, spans
from portbench.tests._cells import SMALL, run_small

SPAN_METRICS = {"host_reads_per_solve", "host_wait_ms_per_solve", "fmg_ms_per_solve",
                "precond_ms_per_solve", "outer_ms_per_solve"}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_span_metrics_read_the_traced_window(cell):
    res, _ = run_small(cell, trace=True, seconds=0.0)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    listed = {e["name"] for e in run.cell_metrics(run.manifest(), cell, True)} & SPAN_METRICS
    assert listed and listed <= set(m)
    if "outer_iters" in m:
        assert m["host_reads_per_solve"] == pytest.approx(
            2 + 2 * m["outer_iters"] + m["inner_iters"])
        assert "fmg_ms_per_solve" in listed and "outer_ms_per_solve" in listed
    else:
        assert m["host_reads_per_solve"] == pytest.approx(1 + m["inner_iters"])
    for name in listed - {"host_reads_per_solve"}:
        assert m[name] > 0


def test_window_without_spans_reads_nothing():
    """No trace, no event, or no recorded solve in the window: None."""
    assert spans.window(SimpleNamespace(trace=None, solves=[{}])) is None
    empty = {"device": [], "ranges": []}
    assert spans.window(SimpleNamespace(trace=empty, solves=[{}])) is None
    far = {"device": [("k", 1.0, 2.0)], "ranges": []}  # 1970: no solve there
    rec = SimpleNamespace(trace=far, solves=[{}], n_solves=1)
    assert spans.window(rec) is None and spans.span_ms_per_solve(rec, "fmg") is None

"""The harness finds configurations, cells, routes and metrics by name, and
a new cell, configuration, route or metric needs only new files and new
manifest entries."""

import json
import shutil

import pytest

from portbench import run
from portbench.tests._cells import SMALL


def test_every_manifest_entry_has_its_files():
    man = run.manifest()
    for c in man["configs"]:
        cfg = json.load(open(run.ROOT / c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    for w in man["workloads"]:
        cell = run.load_json(run.ROOT, "workloads", w["name"])
        assert cell["config"] == w["config"] and w["name"] == f"{w['config']}.{w['traffic']}"
        spec = run.Spec(run.ROOT, w["name"])  # loads every file the cell names
        assert set(spec.checks) == {"rel_residual", "unconverged"}
        assert callable(spec.reference.rel_residual) and spec.Route.STATES
        assert spec.reference.geometry(spec.config["domain"]["kind"]).AXES
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(run.load_module(run.ROOT, "metrics", m["name"]).read)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_metrics_follow_the_manifest(trace):
    man = run.manifest()
    for w in man["workloads"]:
        names = {m["name"] for m in run.cell_metrics(man, w["name"], trace)}
        if trace:
            assert "inner_iters" in names
        else:
            assert {"solve_s", "setup_s", "peak_mem_gib"} <= names
    assert "solve_p95_s" not in {m["name"] for m in run.cell_metrics(
        man, "gamma2d.cheb8_4096", False)}


def test_new_cell_config_route_and_metric_need_only_new_files(tmp_path):
    """A throwaway configuration, route, cell and per-layer metric, added as
    files and manifest entries in a copy, run without editing a file."""
    shutil.copytree(run.ROOT / "portbench", tmp_path / "portbench")
    man = run.manifest()
    pb = tmp_path / "portbench"
    cfg = json.load(open(pb / "configs" / "gamma2d.json"))
    cfg["name"] = "gamma2d_copy"
    json.dump(cfg, open(pb / "configs" / "gamma2d_copy.json", "w"))
    shutil.copy(pb / "routes" / "fused_ir.py", pb / "routes" / "fused_ir_copy.py")
    cell = json.load(open(pb / "workloads" / "gamma2d.mg_8192.json"))
    cell.update(SMALL["gamma2d.mg_8192"], config="gamma2d_copy", route="fused_ir_copy")
    json.dump(cell, open(pb / "workloads" / "gamma2d_copy.tiny.json", "w"))
    (pb / "metrics" / "solves_seen.py").write_text(
        "def read(rec):\n    return float(rec.n_solves)\n")
    man["configs"].append({**man["configs"][0], "name": "gamma2d_copy",
                           "file": "portbench/configs/gamma2d_copy.json"})
    man["workloads"].append({"name": "gamma2d_copy.tiny", "config": "gamma2d_copy",
                             "traffic": "tiny", "chips": 1, "why": "a throwaway cell"})
    man["per_layer"].append({"name": "solves_seen", "unit": "count", "better": "higher",
                             "source": "program_counter", "layer": "device",
                             "moves": "solve_s", "workloads": ["gamma2d_copy.tiny"]})
    json.dump(man, open(tmp_path / "BENCHMARK.json", "w"))
    import time

    res, _ = run.run_cell("gamma2d_copy.tiny", 3, 0.1, True, device="cpu", root=tmp_path,
                          t0=time.perf_counter())
    assert res["correct"]
    assert res["metrics"]["solves_seen"]["value"] == res["attempted"]


RECT = """\"\"\"A rectangle: every node strictly inside is an unknown.\"\"\"

AXES = ("y", "x")


def interior(n, idx):
    iy, ix = idx
    return (iy > 0) & (iy < n) & (ix > 0) & (ix < n)
"""

EXP_XPY = """\"\"\"u = exp(a(x + y)), f = 2 a^2 u.\"\"\"

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Family:
    alpha: float

    def u(self, x, y):
        return torch.exp(self.alpha * (x + y))

    def f(self, x, y):
        return 2.0 * self.alpha**2 * self.u(x, y)
"""


def test_new_domain_kind_and_family_need_only_new_files(tmp_path):
    """A configuration on a domain kind the benchmark does not have (a
    rectangle), with a family of its own and a check of its own, added as
    files and manifest entries in a copy: the copy's reference finds the
    new predicate, and the run is correct."""
    shutil.copytree(run.ROOT / "portbench", tmp_path / "portbench")
    pb = tmp_path / "portbench"
    (pb / "domains" / "rect.py").write_text(RECT)
    (pb / "families" / "exp_xpy.py").write_text(EXP_XPY)
    (pb / "checks" / "solves_seen.py").write_text(
        "def judge(ctx, limit):\n    return len(ctx.solves), 0\n")
    cfg = {"name": "rect2d", "source": "a throwaway rectangle",
           "domain": {"kind": "rect", "x0": 0.0, "x1": 2.0, "y0": -1.0, "y1": 1.0},
           "family": "exp_xpy", "reference": "poisson"}
    json.dump(cfg, open(pb / "configs" / "rect2d.json", "w"))
    cell = json.load(open(pb / "workloads" / "gamma2d.mg_8192.json"))
    cell.update(SMALL["gamma2d.mg_8192"], config="rect2d")
    cell["limits"] = {**cell["limits"], "solves_seen": 0}
    json.dump(cell, open(pb / "workloads" / "rect2d.tiny.json", "w"))
    man = run.manifest()
    man["configs"].append({"name": "rect2d", "source": cfg["source"],
                           "file": "portbench/configs/rect2d.json", "reduced": [],
                           "why": "a throwaway configuration"})
    man["workloads"].append({"name": "rect2d.tiny", "config": "rect2d", "traffic": "tiny",
                             "chips": 1, "why": "a throwaway cell"})
    json.dump(man, open(tmp_path / "BENCHMARK.json", "w"))
    import time

    res, checks = run.run_cell("rect2d.tiny", 5, 0.1, False, device="cpu", root=tmp_path,
                               t0=time.perf_counter())
    assert res["correct"] and checks["solves_seen"]["value"] == res["attempted"]
    assert checks["rel_residual"]["value"] < 1e-9
    spec = run.Spec(tmp_path, "rect2d.tiny")
    fam = spec.family(1.0)
    x = spec.reference.rhs(cfg["domain"], 8, fam, "cpu")[1]
    assert int(x.sum()) == 49  # the 7 x 7 inner nodes of an 8-interval grid


def test_a_cell_that_states_what_its_route_does_not_build_is_refused():
    with pytest.raises(ValueError, match="precision"):
        run.Spec(run.ROOT, "gamma2d.mg_8192", {"precision": "f32"})
    with pytest.raises(ValueError, match="preconditioner"):
        run.Spec(run.ROOT, "gamma2d.cheb8_4096", {"preconditioner": "jacobi"})

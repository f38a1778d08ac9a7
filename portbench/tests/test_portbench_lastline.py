"""The shape of a run's result line and the harness's exits."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests._cells import SMALL, run_small

TOP = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_result_line_shape(cell, trace):
    res, checks = run_small(cell, trace=trace)
    keys = list(res)
    assert keys[: len(TOP)] == TOP and keys[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == {"rel_residual", "unconverged"} and res["checks"] == checks
    for v in checks.values():
        assert set(v) == {"value", "limit"}
    units = {m["name"]: m["unit"] for m in run.cell_metrics(run.manifest(), cell, trace)}
    for name, m in res["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and set(res["breakdown"]) == {
            "device_ops", "idle_gaps"}
        assert "inner_iters" in res["metrics"]
    else:
        assert {"solve_s", "setup_s"} <= set(res["metrics"])
    json.dumps(res)


def _cli(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_no_card_exits_2_without_a_result():
    """The decision is made in the run: this test runs only where the
    process sees no CUDA device."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _cli(["--workload", "gamma2d.mg_8192", "--seed", str(2**31 + 5), "--seconds", "1"],
             run.ROOT)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


def test_benchmark_files_alone_exit_without_a_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder has
    no program to run."""
    shutil.copytree(run.ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _cli(["--workload", "gamma2d.mg_8192", "--seed", "1", "--seconds", "1"], tmp_path, env)
    assert p.returncode != 0 and p.stdout.strip() == ""

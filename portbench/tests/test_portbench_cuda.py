"""On the card: one short run of each cell through the command, correct
and with the contract's result line. Skips where there is no CUDA device
(the decision is made inside the test)."""

import json
import subprocess
import sys

import pytest

from portbench import run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in run.manifest()["workloads"]])
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
                        str(2**31 + 41), "--seconds", "2", "--trace", "0"], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"

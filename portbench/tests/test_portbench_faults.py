"""A run whose timed path is broken underneath comes out not correct: a
solve that returns its state unchanged (x = 0), half of the pool left out
(those problems handed another problem's answer), and an answer altered
where it is produced. The exchange between chips does not exist here:
every cell runs on one chip."""

import pytest
import torch

from portbench import run
from portbench.tests._cells import SMALL, run_small


def _unchanged(solve, p, profiler):
    x, res = solve(p, profiler)
    return torch.zeros_like(x), res


def _half_left_out(solve, p, profiler):
    return solve(p - p % 2, profiler)  # odd problems get their neighbour's answer


def _altered(solve, p, profiler):
    x, res = solve(p, profiler)
    x = x.clone()
    x[tuple(s // 2 + 1 for s in x.shape)] += 1.0  # one unknown of the answer
    return x, res


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    load = run.load_module

    def load_broken(root, kind, name):
        mod = load(root, kind, name)
        if kind == "routes":
            class Broken(mod.Route):
                def solve(self, p, profiler=None):
                    return fault(super().solve, p, profiler)

            mod.Route = Broken
        return mod

    monkeypatch.setattr(run, "load_module", load_broken)
    res, checks = run_small(cell)
    assert res["correct"] is False
    assert checks["rel_residual"]["value"] > checks["rel_residual"]["limit"]


def test_an_answer_handed_out_again_stops_the_run(monkeypatch):
    """The harness keeps answers by reference; a route that hands out one
    buffer for every answer would overwrite what was kept, so the run
    stops rather than judge overwritten answers."""
    load = run.load_module

    def load_reusing(root, kind, name):
        mod = load(root, kind, name)
        if kind == "routes":
            class Reusing(mod.Route):
                def solve(self, p, profiler=None):
                    x, res = super().solve(p, profiler)
                    if not hasattr(self, "_buf"):
                        self._buf = torch.empty_like(x)
                    return self._buf.copy_(x), res

            mod.Route = Reusing
        return mod

    monkeypatch.setattr(run, "load_module", load_reusing)
    with pytest.raises(RuntimeError, match="returned before"):
        run_small("gamma2d.cheb8_4096")


def test_held_bytes_count_each_storage_once_in_allocator_blocks():
    a = torch.zeros(1000, dtype=torch.float64)  # 8000 B: 16 blocks of 512
    assert run._held_bytes([a, a[:10], torch.zeros(3)]) == 8192 + 512

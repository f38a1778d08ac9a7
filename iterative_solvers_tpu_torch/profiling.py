"""Profiling & tracing (counterpart of the JAX package's profiling.py).

- :class:`Profiler` — per-phase wall timing, call counts and user counters;
  each phase is also a ``torch.profiler.record_function`` range, so it shows
  on the timeline of a trace being captured;
- :meth:`Profiler.device_trace` — a ``torch.profiler`` capture (CPU, and CUDA
  activity when the card is in use) exported as a Chrome trace;
- throughput: iterations/s and effective stencil nnz/s from the standard
  counters (``iterations``, ``operator_applies``, ``nnz_per_apply``).

The solvers take it as ``CGOptions.profiler`` / ``profiler=`` (``cg_solve``,
the refinement drivers, ``DirichletSolver.solve``) and the CLI through
``--profile`` / ``--trace-dir``. A phase synchronises the card at its two
edges when CUDA is in use, so its time is the work's, not the launches'.
The solvers' phases end where they read the device anyway (a CG chunk, an
outer step), so no phase adds a synchronisation inside the CG loop.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class PhaseStat:
    calls: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.calls += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)


@dataclass
class Profiler:
    """Collects per-phase timings and throughput counters for one solve."""

    phases: Dict[str, PhaseStat] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    _t0: float = field(default_factory=time.perf_counter)
    # Only top-level phases count toward the throughput denominator: nested
    # phases (the refinement's 'inner_solve' wraps the inner cg_solve's
    # 'setup'/'cg_chunk' on the same Profiler) would double-count wall time.
    _depth: int = 0
    _top_total_s: float = 0.0

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Time a phase between two device synchronisations; it is also a
        ``record_function`` range on a captured trace's timeline."""
        stat = self.phases.setdefault(name, PhaseStat())
        _sync()
        t0 = time.perf_counter()
        self._depth += 1
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            _sync()
            self._depth -= 1
            dt = time.perf_counter() - t0
            stat.add(dt)
            if self._depth == 0:
                self._top_total_s += dt

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    @contextlib.contextmanager
    def device_trace(self, log_dir: str) -> Iterator[None]:
        """Capture a ``torch.profiler`` trace (CUDA activity too when a card
        is present) and write it to ``log_dir/trace.json`` (Chrome format)."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

    # --- reporting ---------------------------------------------------------

    @property
    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0

    def throughput(self) -> Dict[str, float]:
        """Derived rates from the standard counters (when present)."""
        out: Dict[str, float] = {}
        total = self._top_total_s or self.elapsed_s
        iters = self.counters.get("iterations")
        if iters:
            out["iterations_per_s"] = iters / total
        nnz = self.counters.get("nnz_per_apply")
        applies = self.counters.get("operator_applies")
        if nnz and applies:
            out["effective_nnz_per_s"] = nnz * applies / total
        return out

    def report(self) -> str:
        lines = ["=== Profile ===", f"{'phase':<24}{'calls':>7}{'total':>12}{'mean':>12}{'max':>12}"]
        for name, p in sorted(self.phases.items(), key=lambda kv: -kv[1].total_s):
            mean = p.total_s / max(p.calls, 1)
            lines.append(
                f"{name:<24}{p.calls:>7}{p.total_s * 1e3:>10.2f}ms"
                f"{mean * 1e3:>10.2f}ms{p.max_s * 1e3:>10.2f}ms"
            )
        if self.counters:
            lines.append("counters:")
            for k, v in sorted(self.counters.items()):
                lines.append(f"  {k:<26}{v:,.0f}")
        tp = self.throughput()
        if tp:
            lines.append("throughput:")
            for k, v in sorted(tp.items()):
                lines.append(f"  {k:<26}{v:,.3e}")
        return "\n".join(lines)


def phase_of(profiler):
    """``profiler.phase``, or a no-op context factory without a profiler."""
    if profiler is not None:
        return profiler.phase
    return lambda name: contextlib.nullcontext()

"""Profiling & tracing (counterpart of the JAX package's profiling.py): the
port's one recorder of spans and counters.

- :func:`span` — a named interval of the host's work: its start and end in
  Unix-epoch ns (``time.time_ns()``, the clock that ``torch.profiler``
  stamps its device events with), its parent span, the id of the top-level
  solve it belongs to and an optional ``level``. The solvers open one at
  each layer boundary: ``fmg`` around the FMG warm start and ``fmg_rung``
  for each of its rungs, ``inner_solve`` and ``outer_residual`` for each
  outer step, ``inner_iter`` for each inner iteration, ``precond`` for each
  preconditioner application, ``vcycle_level`` for each level of a V-cycle,
  ``host_read`` around each blocking read of a device value
  (:func:`host_read`, counted as ``host_reads``), and the drivers' phases
  (``device_ir``, ``setup``, ``cg_chunk``, ``escalated_polish``, the
  facade's ``assemble``, ``fields``, ``solve``, ``residual``,
  ``result_copies``, ``result_host``).
- :func:`solve_span` — the span of a solve entry point. Outside any solve it
  opens a top-level solve and decides whether the solve records: when a
  :class:`Profiler` is passed, or when a ``torch.profiler`` capture is
  active (``torch.autograd._profiler_enabled()``). Nothing else turns
  recording on, and no span deep in the solve needs the profiler passed to
  it. Off, a span costs one flag check and a shared null context.
- :data:`RECORDER` — the process's bounded in-memory buffer of spans and of
  top-level solves (each with its counters); :func:`self_times` sums a
  set of spans' self times by name.
- :class:`Profiler` — the per-name wall time and call count of every span
  of the solves it is passed to (its phases), and user counters;
  :meth:`Profiler.device_trace` writes a ``torch.profiler`` Chrome trace.

No span synchronises the card, so a span's time is the host's wall: the
time it took to issue the work, plus whatever a host read inside it waited
for the device. While a capture is active each span is also a
``torch.profiler.record_function`` range, so a capture with host activity
shows it on the timeline. Spans and recording state are per thread.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, NamedTuple, Optional

import torch

SPAN_CAP = 1 << 18  # spans kept; the oldest go first


class Span(NamedTuple):
    sid: int
    name: str
    t0: int  # ns, Unix epoch
    t1: int
    parent: int  # 0 for a top-level solve's own span
    solve: int  # the top-level solve's id (its own span's sid)
    level: Optional[int] = None


class SolveRecord(NamedTuple):
    sid: int
    name: str
    t0: int
    t1: int
    counters: Dict[str, int]


class Recorder:
    """Bounded buffers of the recorded spans and top-level solves."""

    def __init__(self, cap: int = SPAN_CAP):
        self.spans: deque = deque(maxlen=cap)
        self.solves: deque = deque(maxlen=cap // 16)

    def clear(self) -> None:
        self.spans.clear()
        self.solves.clear()

    def window(self, t0: int, t1: int):
        """(solves, their spans) of the top-level solves that overlap
        ``[t0, t1]`` (ns)."""
        solves = [s for s in list(self.solves) if s.t0 <= t1 and s.t1 >= t0]
        ids = {s.sid for s in solves}
        return solves, [sp for sp in list(self.spans) if sp.solve in ids]


RECORDER = Recorder()
_ids = itertools.count(1)


class _Thread(threading.local):
    def __init__(self):
        self.on = False  # this thread's open solve records
        self.capture = False  # ... and a torch.profiler capture was active at its start
        self.open = False  # a top-level solve is open in this thread
        self.solve = 0  # its id while it records
        self.stack = []  # open spans' sids
        self.profiler = None
        self.reads = 0


_state = _Thread()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "level", "sid", "parent", "t0", "rf")

    def __init__(self, name: str, level: Optional[int] = None):
        self.name, self.level = name, level

    def __enter__(self):
        st = _state
        self.sid = next(_ids)
        self.parent = st.stack[-1] if st.stack else 0
        st.stack.append(self.sid)
        self.rf = None
        if st.capture:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._close(exc)
        return False

    def _close(self, exc) -> Span:
        t1 = time.time_ns()
        st = _state
        if self.rf is not None:
            self.rf.__exit__(*exc)
        st.stack.pop()
        sp = Span(self.sid, self.name, self.t0, t1, self.parent, st.solve, self.level)
        RECORDER.spans.append(sp)
        if st.profiler is not None:
            st.profiler._add(self.name, (t1 - self.t0) / 1e9, top=not st.stack)
        return sp


class _Solve(_Span):
    """A top-level solve: decides whether it records, and is its root span."""

    __slots__ = ("profiler",)

    def __init__(self, name: str, profiler):
        super().__init__(name)
        self.profiler = profiler

    def __enter__(self):
        st = _state
        st.open = True
        st.capture = torch.autograd._profiler_enabled()
        st.on = self.profiler is not None or st.capture
        if not st.on:
            return self
        st.profiler, st.reads = self.profiler, 0
        super().__enter__()
        st.solve = self.sid
        return self

    def __exit__(self, *exc):
        st = _state
        try:
            if st.on:
                sp = self._close(exc)
                RECORDER.solves.append(SolveRecord(sp.sid, sp.name, sp.t0, sp.t1,
                                                   {"host_reads": st.reads}))
        finally:
            st.on = st.capture = st.open = False
            st.solve, st.profiler = 0, None
        return False


def span(name: str, level: Optional[int] = None):
    """A span of the open solve (a null context when it does not record)."""
    if not _state.on:
        return _OFF
    return _Span(name, level)


def solve_span(name: str, profiler=None):
    """The span of a solve entry point: inside an open solve, as
    :func:`span`; else a new top-level solve that records when
    ``profiler`` is given or a ``torch.profiler`` capture is active."""
    st = _state
    if st.open:
        return _Span(name) if st.on else _OFF
    return _Solve(name, profiler)


def host_read(t: torch.Tensor):
    """``t.tolist()``: the one way the solvers read a device value on the
    host (it waits for the work queued before it). Recorded as a
    ``host_read`` span and counted in the solve's ``host_reads``."""
    st = _state
    if not st.on:
        return t.tolist()
    st.reads += 1
    with _Span("host_read"):
        return t.tolist()


def self_times(spans: Iterable[Span]) -> Dict[str, int]:
    """{name: self time, ns} of ``spans``: each span's duration less the
    part its children cover (children of one span do not overlap)."""
    spans = list(spans)
    child = {}
    for sp in spans:
        if sp.parent:
            child[sp.parent] = child.get(sp.parent, 0) + (sp.t1 - sp.t0)
    out: Dict[str, int] = {}
    for sp in spans:
        out[sp.name] = out.get(sp.name, 0) + (sp.t1 - sp.t0) - child.get(sp.sid, 0)
    return out


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
    """Collects per-span timings and throughput counters for the solves it
    is passed to (``profiler=`` of the drivers and the facade)."""

    phases: Dict[str, PhaseStat] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    _t0: float = field(default_factory=time.perf_counter)
    # Only top-level spans count toward the throughput denominator: nested
    # ones (the refinement's 'inner_solve' wraps the inner cg_solve's
    # 'setup'/'cg_chunk') would double-count wall time.
    _top_total_s: float = 0.0

    def phase(self, name: str):
        """A span of this profiler's solve: inside an open solve a span of
        it, else a top-level solve recorded for this profiler. Its host
        wall time is the phase's (no device synchronisation)."""
        return solve_span(name, self)

    def _add(self, name: str, dt: float, top: bool) -> None:
        stat = self.phases.get(name)
        if stat is None:
            stat = self.phases[name] = PhaseStat()
        stat.add(dt)
        if top:
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

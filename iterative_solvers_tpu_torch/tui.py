"""Live terminal view of a running solve (counterpart of the JAX package's
tui.py) — the reference GUI's live-progress
capability (reference qt_gui/src/mainwindow.cpp:316-379: iteration labels,
progress bar, live log10 convergence chart; Stop button → cooperative
cancellation, mainwindow.cpp:268-288) as a dependency-free ANSI TUI.

Consumes the :class:`~iterative_solvers_tpu_torch.async_driver.AsyncSolver` event
stream (the same worker-thread + queue machinery the reference builds with
QThread/queued signals) and redraws a small panel per event:

    iterative_solvers_tpu_torch  —  live solve    [q] cancel
    iter   1200/10000   [=========>              ]  12%
    |dx|inf 1.235e-04   |r|inf 3.412e-03   |err|inf 5.6e-03
    log10|r| ████▇▇▆▆▅▅▄▄▃▃▂▂▁▁  (3.0e+04 → 3.4e-03)
    elapsed 12.4 s      status: running

On a TTY the panel redraws in place (ANSI cursor movement) and ``q`` cancels
cooperatively; on a plain pipe it degrades to one log line per event, so the
view is usable from CI logs and tests alike.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, List, Optional, TextIO

from iterative_solvers_tpu_torch.async_driver import AsyncSolver, CompletionEvent, ProgressEvent

_SPARK = "▁▂▃▄▅▆▇█"
_BAR_W = 30
_SPARK_W = 48


def sparkline(values: List[float], width: int = _SPARK_W) -> str:
    """log10 sparkline of a positive series, uniformly subsampled to width."""
    logs = [math.log10(v) for v in values if v > 0 and math.isfinite(v)]
    if not logs:
        return ""
    if len(logs) > width:
        step = len(logs) / width
        logs = [logs[int(i * step)] for i in range(width)]
    lo, hi = min(logs), max(logs)
    span = (hi - lo) or 1.0
    return "".join(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))] for v in logs)


def _fmt(v: float) -> str:
    return "   -    " if (v is None or math.isinf(v)) else f"{v:.3e}"


def render_frame(
    ev: ProgressEvent,
    max_iterations: int,
    residual_history: List[float],
    elapsed_s: float,
    status: str = "running",
    interactive: bool = True,
) -> List[str]:
    """The panel as a list of lines (pure function — unit-testable)."""
    frac = min(ev.iteration / max_iterations, 1.0) if max_iterations else 0.0
    filled = int(frac * _BAR_W)
    bar = "=" * filled + (">" if 0 < filled < _BAR_W else "") + " " * (_BAR_W - filled - 1)
    head = "iterative_solvers_tpu_torch  —  live solve"
    if interactive:
        head += "          [q] cancel"
    lines = [
        head,
        f"iter {ev.iteration:>7}/{max_iterations}   [{bar[:_BAR_W]}] {frac * 100:3.0f}%",
        f"|dx|inf {_fmt(ev.precision)}   |r|inf {_fmt(ev.residual)}   "
        f"|err|inf {_fmt(ev.error)}",
    ]
    spark = sparkline(residual_history)
    if spark:
        lines.append(
            f"log10|r| {spark}  ({residual_history[0]:.1e} → {residual_history[-1]:.1e})"
        )
    lines.append(f"elapsed {elapsed_s:6.1f} s      status: {status}")
    return lines


class _KeyPoller:
    """Non-blocking single-key reader on a TTY (cbreak via termios); inert on
    non-TTY stdin. Restores terminal state on close."""

    def __init__(self, stream=None):
        self._stream = stream if stream is not None else sys.stdin
        self._saved = None
        try:
            import termios
            import tty

            if self._stream.isatty():
                self._fd = self._stream.fileno()
                self._saved = termios.tcgetattr(self._fd)
                tty.setcbreak(self._fd)
        except Exception:
            self._saved = None

    @property
    def active(self) -> bool:
        return self._saved is not None

    def poll(self) -> Optional[str]:
        if not self.active:
            return None
        import select

        r, _, _ = select.select([self._stream], [], [], 0)
        if r:
            return self._stream.read(1)
        return None

    def close(self) -> None:
        if self._saved is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)
            self._saved = None


class LiveView:
    """Drive an :class:`AsyncSolver` while rendering the live panel.

    ``out`` defaults to stderr. ``key_poll`` overrides keyboard input
    (callable returning an optional character) — used by tests to inject a
    cancel keystroke.
    """

    def __init__(
        self,
        runner: AsyncSolver,
        max_iterations: int,
        out: Optional[TextIO] = None,
        key_poll: Optional[Callable[[], Optional[str]]] = None,
    ):
        self.runner = runner
        self.max_iterations = max_iterations
        self.out = out if out is not None else sys.stderr
        self._key_poll = key_poll
        self.frames = 0

    def run(self):
        """Consume the event stream to completion; returns SolverResults."""
        out = self.out
        tty_out = getattr(out, "isatty", lambda: False)()
        poller = None
        if self._key_poll is None:
            poller = _KeyPoller()
            key_poll = poller.poll
        else:
            key_poll = self._key_poll
        t0 = time.perf_counter()
        history: List[float] = []
        prev_lines = 0
        cancelled = False
        try:
            for ev in self.runner:
                if isinstance(ev, CompletionEvent):
                    status = ev.reason if not ev.error else f"error: {ev.error}"
                    line = f"done: converged={ev.converged}  ({status})"
                    if tty_out and prev_lines:
                        out.write("\n")
                    out.write(line + "\n")
                    out.flush()
                    break
                if ev.residual > 0 and math.isfinite(ev.residual):
                    history.append(ev.residual)
                if key_poll() in ("q", "Q") and not cancelled:
                    cancelled = True
                    self.runner.stop()
                lines = render_frame(
                    ev,
                    self.max_iterations,
                    history,
                    time.perf_counter() - t0,
                    status="cancelling…" if cancelled else "running",
                    interactive=poller.active if poller else key_poll is not None,
                )
                self.frames += 1
                if tty_out:
                    if prev_lines:
                        out.write(f"\x1b[{prev_lines}F\x1b[J")  # up + clear
                    out.write("\n".join(lines) + "\n")
                    prev_lines = len(lines)
                else:
                    # plain pipe: one compact line per event
                    out.write(lines[1] + "  " + lines[2] + "\n")
                out.flush()
        finally:
            if poller is not None:
                poller.close()
        return self.runner.result()


def live_solve(
    solver,
    callback_every: int = 100,
    out: Optional[TextIO] = None,
    key_poll: Optional[Callable[[], Optional[str]]] = None,
    **solve_kwargs,
):
    """One-call live view: run ``solver`` async with the TUI attached.

    Returns the full SolverResults (raises if the worker raised)."""
    runner = AsyncSolver(solver, callback_every=callback_every, **solve_kwargs).start()
    view = LiveView(
        runner,
        max_iterations=solver.stop.max_iterations,
        out=out,
        key_poll=key_poll,
    )
    return view.run()

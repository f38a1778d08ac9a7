"""Asynchronous solve driver with live progress (counterpart of the JAX
package's async_driver.py) — the equivalent of the reference GUI's
worker-thread machinery.

The reference moves a ``SolverWorker`` onto a ``QThread`` and streams progress
back to the UI via queued signals (``iterationUpdate``/``resultReady``/
``finished``, reference qt_gui/src/mainwindow.h:35-55, mainwindow.cpp:46-68,
233-258), with a Stop button driving cooperative cancellation through an
atomic flag (mainwindow.cpp:268-288 → msg_solver.cpp:82-87).

Here the same capability is a plain ``threading.Thread`` + ``queue.Queue`` of
typed events — UI-framework-free, usable from notebooks, TUIs, or services.
The device never blocks on the consumer: events are produced at the chunked
CG driver's host-sync boundaries (solvers/cg.py), exactly where the reference
fires its callbacks. The worker thread runs the solve's CUDA work on the
current stream; :meth:`AsyncSolver.stop` sets the facade's stop event
(``request_stop``), which the chunked loop polls at its next chunk. A route
with no host chunks (``outer='ff'``) refuses the live callback, and the
refusal arrives as the completion event's error.

>>> runner = AsyncSolver(DirichletSolver(nx=64, ny=64, device="cpu"))
>>> runner.start()
>>> for ev in runner:                 # live progress events
...     print(ev.iteration, ev.residual)
>>> results = runner.result()         # joined, full SolverResults
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Union


@dataclass(frozen=True)
class ProgressEvent:
    """One iteration-callback sample (reference iterationUpdate signal)."""

    iteration: int
    precision: float  # ||x_k - x_{k-1}||_inf
    residual: float  # ||A x - b||_inf
    error: float  # ||x - u||_inf (inf when no exact solution)


@dataclass(frozen=True)
class CompletionEvent:
    """Terminal event (reference resultReady/finished signals)."""

    converged: bool
    reason: str
    error: Optional[BaseException] = None  # solver exception, if any


Event = Union[ProgressEvent, CompletionEvent]


class AsyncSolver:
    """Runs ``solver.solve()`` on a background thread, streaming events.

    ``solver`` is a :class:`~iterative_solvers_tpu_torch.api.DirichletSolver` (or
    anything with the same ``solve``/``request_stop`` protocol).
    """

    def __init__(self, solver, callback_every: int = 100, **solve_kwargs):
        self.solver = solver
        self.events: "queue.Queue[Event]" = queue.Queue()
        self._solve_kwargs = dict(solve_kwargs, callback_every=callback_every)
        self._thread: Optional[threading.Thread] = None
        self._results = None
        self._exc: Optional[BaseException] = None

    # --- lifecycle ----------------------------------------------------------

    def start(self) -> "AsyncSolver":
        if self._thread is not None:
            raise RuntimeError("already started")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        def on_iter(k, prec, rmax, emax):
            self.events.put(ProgressEvent(k, prec, rmax, emax))

        def on_done(converged, reason):
            pass  # terminal event emitted below with exception context

        try:
            self._results = self.solver.solve(
                callback=on_iter,
                completion_callback=on_done,
                **self._solve_kwargs,
            )
            self.events.put(
                CompletionEvent(
                    converged=self._results.converged,
                    reason=self._results.stop_reason.text(),
                )
            )
        except BaseException as e:  # surfaced via the event stream + result()
            self._exc = e
            self.events.put(CompletionEvent(converged=False, reason=str(e), error=e))

    def stop(self) -> None:
        """Cooperative cancellation (reference Stop button path)."""
        self.solver.request_stop()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # --- consumption ----------------------------------------------------------

    def __iter__(self) -> Iterator[Event]:
        """Yield events until (and including) the CompletionEvent."""
        if self._thread is None:
            raise RuntimeError("call start() first")
        while True:
            ev = self.events.get()
            yield ev
            if isinstance(ev, CompletionEvent):
                return

    def result(self, timeout: Optional[float] = None):
        """Join the worker and return the full SolverResults."""
        if self._thread is None:
            raise RuntimeError("call start() first")
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("solver still running")
        if self._exc is not None:
            raise self._exc
        return self._results

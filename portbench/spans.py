"""The traced window's spans and counters, read from the program's recorder
(``iterative_solvers_tpu_torch.profiling.RECORDER``) by the span and counter
metrics (``metrics/host_reads_per_solve.py`` and the ``*_ms_per_solve``
readers of spans).

The window's bounds are its device operations' (Unix-epoch µs, the clock the
recorder stamps its spans with), or without any its host ranges (a capture
on the CPU). Its solves are the recorder's top-level solves that overlap
them: the warm-up before the window records nothing (no capture is active),
and the named solve after it starts after the window's last operation ends.
A program without the recorder gives None, and so does a window whose
solves the recorder does not hold one for one.
"""

from __future__ import annotations


def window(rec):
    """(solve records, their spans) of the traced window, or None."""
    try:
        from iterative_solvers_tpu_torch.profiling import RECORDER
    except ImportError:
        return None
    tr = rec.trace
    events = (tr["device"] or tr["ranges"]) if tr else []
    if not events:
        return None
    t0 = min(s for _, s, _ in events)
    t1 = max(e for _, _, e in events)
    solves, spans = RECORDER.window(int(t0 * 1e3), int(t1 * 1e3))
    if len(solves) != rec.n_solves:
        return None
    return solves, spans


def span_ms_per_solve(rec, name: str):
    """The summed durations of the window's spans called ``name``, ms per
    solve, or None."""
    got = window(rec)
    if got is None:
        return None
    return sum(sp.t1 - sp.t0 for sp in got[1] if sp.name == name) / 1e6 / rec.n_solves

"""The import guard: no module of JAX, Flax or the JAX package may be
loaded by a run of the benchmark.

Names are compared by their top-level part (before the first dot) whole,
so ``iterative_solvers_tpu_torch`` (the port) passes and
``iterative_solvers_tpu`` (the JAX package) does not.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "iterative_solvers_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The sorted top-level names in ``modules`` (``sys.modules`` by
    default) that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def check(when: str) -> None:
    """Exit with code 3, naming what was found on standard error, if a
    forbidden module is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"portbench: forbidden modules loaded {when}: {', '.join(found)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)

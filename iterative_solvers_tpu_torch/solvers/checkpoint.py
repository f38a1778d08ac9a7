"""CG solver-state checkpoint / resume (counterpart of the JAX package's
solvers/checkpoint.py).

The whole :class:`~iterative_solvers_tpu_torch.solvers.cg.CGState` (x, r, z,
the iteration count, the norms) round-trips through an ``.npz`` file, and
``cg_solve(..., init_state=...)`` (or ``fused_cg_solve(..., init_state=...)``
for a state of the fused engine) continues exactly where the saved run
stopped. The file has the JAX package's keys, so either package reads the
other's checkpoints; the fused-PCG carries ``w`` and ``rz_prev`` are written
as extra keys when present (the JAX loader reads by key and ignores them),
and a file without them loads with both None.

Typical wiring::

    opts = CGOptions(state_callback=periodic_checkpointer("ckpt.npz", every_s=60))
    cg_solve(A, b, options=opts)
    # later / elsewhere:
    state = load_cg_state("ckpt.npz", device="cuda")
    cg_solve(A, b, options=opts2, init_state=state)
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from iterative_solvers_tpu_torch.core.domain import resolve_device
from iterative_solvers_tpu_torch.solvers.cg import CGState

_ARRAY_FIELDS = ("x", "r", "z")
_SCALAR_FIELDS = ("k", "done", "reason", "rz", "r_norm2", "prec_max", "r_max", "err_max",
                  "r0_norm")
_CARRY_FIELDS = ("w", "rz_prev")  # fused PCG only


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_cg_state(path: str, state: CGState) -> None:
    """Write ``state`` to ``path`` atomically (a temporary file, then
    ``os.replace``): a crash never leaves a torn checkpoint."""
    data = {f: _host(getattr(state, f)) for f in _ARRAY_FIELDS + _SCALAR_FIELDS}
    data["k"] = np.asarray(int(state.k), np.int32)
    for f in _CARRY_FIELDS:
        if getattr(state, f) is not None:
            data[f] = _host(getattr(state, f))
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **data)
    os.replace(tmp, path)


def load_cg_state(path: str, dtype=None, device="cuda") -> CGState:
    """The state saved at ``path`` (by either package) on ``device``, in
    ``dtype`` (default: the saved iterate's). ``device`` defaults to
    ``"cuda"``, which raises without a card."""
    device = resolve_device(device)
    with np.load(path) as z:
        saved = {f: z[f] for f in z.files}
    dt = dtype or torch.from_numpy(saved["x"]).dtype

    def arr(f):
        return torch.as_tensor(saved[f], device=device).to(dt) if f in saved else None

    return CGState(
        x=arr("x"), r=arr("r"), z=arr("z"),
        k=int(saved["k"]),
        done=torch.as_tensor(bool(saved["done"]), device=device),
        reason=torch.as_tensor(int(saved["reason"]), dtype=torch.int32, device=device),
        rz=arr("rz"), r_norm2=arr("r_norm2"), prec_max=arr("prec_max"), r_max=arr("r_max"),
        err_max=arr("err_max"), r0_norm=arr("r0_norm"), w=arr("w"), rz_prev=arr("rz_prev"),
    )


def periodic_checkpointer(path: str, every_s: float = 60.0,
                          every_iters: Optional[int] = None) -> Callable[[CGState], None]:
    """A ``CGOptions.state_callback`` that writes atomically every
    ``every_s`` seconds (or every ``every_iters`` iterations)."""
    last = {"t": time.monotonic(), "k": 0}

    def cb(state: CGState) -> None:
        k = int(state.k)
        due = (
            time.monotonic() - last["t"] >= every_s
            if every_iters is None
            else k - last["k"] >= every_iters
        )
        if due:
            save_cg_state(path, state)
            last["t"] = time.monotonic()
            last["k"] = k

    return cb

"""Conjugate gradients with the reference stop criteria (counterpart of the JAX package's solvers/cg.py).

PyTorch runs eagerly, so the JAX package's compiled chunk becomes a host
loop over device tensors. Every scalar of the recurrence stays a 0-dim tensor
on the fields' device; the host reads the progress scalars with ONE packed
transfer per iteration (`_sync_stats`), which is also where the stop test and
the end of a chunk are decided. The iteration count ``k`` is a host integer.

The driver keeps the JAX ``cg_solve``'s host protocol: chunks end at
``chunk_size`` (default ``min(max_iterations, 500)``) or, with a
``callback``, at iterations 1, ``callback_every``, 2·``callback_every``, …;
``stop_requested`` is polled at the top of each chunk (INTERRUPTED),
``state_callback`` sees the state at each chunk's end, and the callback and
the history rows ``(k, prec∞, r∞, err∞, ‖r‖₂)`` fire at the initial state,
at each chunk's end and once more at the end. ``beta_kind`` is ``"msg"``
(the reference recurrence, β = ‖r_new‖²/(r, z)) or ``"fr"``
(Fletcher–Reeves, β = ‖r_new‖²/‖r‖²); a preconditioner runs standard PCG.
Spans (``profiling.py``): ``setup``, each ``cg_chunk`` (whose last
iteration's read is the chunk's synchronisation), each ``inner_iter``, each
``precond`` application and each ``host_read``; they record when
``profiler`` (:class:`~iterative_solvers_tpu_torch.profiling.Profiler`,
which also counts ``iterations``, ``operator_applies`` and
``nnz_per_apply``) is given or a ``torch.profiler`` capture is active.
:func:`cg_run` is the fixed-count core with no host read.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field as dataclass_field
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from iterative_solvers_tpu_torch.parallel.mesh import all_max, all_sum, mesh_of
from iterative_solvers_tpu_torch.profiling import host_read, solve_span, span
from iterative_solvers_tpu_torch.solvers.stopping import StopConfig, StopReason

Operator = Callable[[torch.Tensor], torch.Tensor]


class CGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor  # descent direction (z_{k-1} in the fused engine)
    k: int  # iterations done
    done: torch.Tensor  # bool: a stop criterion fired
    reason: torch.Tensor  # int32 StopReason value
    rz: torch.Tensor  # (r, z) of the current pair (PCG carry)
    r_norm2: torch.Tensor  # ‖r‖²
    prec_max: torch.Tensor  # ‖x_k − x_{k−1}‖∞
    r_max: torch.Tensor  # ‖r‖∞
    err_max: torch.Tensor  # ‖x − u_true‖∞ (inf without a true solution)
    r0_norm: torch.Tensor  # ‖r₀‖₂
    # fused-PCG carries: w = M r and the previous (r, w)
    w: Optional[torch.Tensor] = None
    rz_prev: Optional[torch.Tensor] = None


@dataclass
class CGOptions:
    stop: StopConfig = dataclass_field(default_factory=StopConfig)
    beta_kind: str = "msg"  # 'msg' | 'fr'
    preconditioner: Optional[Operator] = None
    callback: Optional[Callable[[int, float, float, float], None]] = None
    callback_every: int = 100  # the reference's trace cadence
    chunk_size: Optional[int] = None  # iterations between host protocol points
    stop_requested: Optional[Callable[[], bool]] = None  # cooperative interrupt
    record_history: bool = False
    state_callback: Optional[Callable[["CGState"], None]] = None  # the state at each sync
    # alternative iteration ``(state, u_true) -> state`` that also sets
    # done/reason, e.g. the fused engine's step (kernels/cg_fused.py); the
    # loop's stop protocol and result assembly stay the same around it
    step_fn: Optional[Callable] = None
    profiler: Optional[object] = None  # profiling.Profiler: phases and counters


@dataclass
class CGResult:
    x: torch.Tensor
    iterations: int
    converged: bool
    reason: StopReason
    precision_max: float
    residual_max: float
    error_max: float
    residual_norm: float  # ‖r‖₂
    initial_residual_norm: float
    elapsed_s: float
    history: Optional[np.ndarray] = None  # rows: (iter, prec∞, r∞, err∞, ‖r‖₂)


def precondition(M, r: torch.Tensor) -> torch.Tensor:
    """``M(r)``, one preconditioner application, in a ``precond`` span."""
    with span("precond"):
        return M(r)


def _dot(a, b):
    return torch.sum(a * b)


def _maxabs(a):
    return torch.max(torch.abs(a))


def stop_reason(stop: StopConfig, prec, r_max, err, r2, r0_norm, has_u: bool):
    """(done, reason) as device tensors, reference priority order:
    diverged, precision, residual, exact error, relative residual."""
    false = torch.zeros((), dtype=torch.bool, device=r2.device)
    done_p = (prec < stop.eps_precision) if stop.eps_precision > 0 else false
    done_r = (r_max < stop.eps_residual) if stop.eps_residual > 0 else false
    done_e = (err < stop.eps_exact_error) if (stop.eps_exact_error > 0 and has_u) else false
    done_rel = (
        (torch.sqrt(r2) < stop.eps_relative * r0_norm) if stop.eps_relative > 0 else false
    )
    done_div = ~torch.isfinite(r2)
    reason = torch.full((), int(StopReason.ITERATIONS), dtype=torch.int32, device=r2.device)
    for flag, code in (
        (done_rel, StopReason.RELATIVE_RESIDUAL),
        (done_e, StopReason.EXACT_ERROR),
        (done_r, StopReason.RESIDUAL),
        (done_p, StopReason.PRECISION),
        (done_div, StopReason.DIVERGED),
    ):  # lowest priority first, so the highest-priority flag wins
        reason = torch.where(flag, int(code), reason).to(torch.int32)
    return done_p | done_r | done_e | done_rel | done_div, reason


def _cg_init(A, M, b, x0, u_true) -> CGState:
    mesh = mesh_of(A)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0.clone()
        r = b - A(x0)
    z = precondition(M, r) if M is not None else r.clone()
    r2_0, rz = all_sum(mesh, _dot(r, r), _dot(r, z))
    inf = torch.full((), math.inf, dtype=b.dtype, device=b.device)
    r_max, err_max = all_max(mesh, _maxabs(r),
                             _maxabs(x - u_true) if u_true is not None else inf)
    return CGState(
        x=x, r=r, z=z, k=0,
        done=torch.zeros((), dtype=torch.bool, device=b.device),
        reason=torch.full((), int(StopReason.ITERATIONS), dtype=torch.int32, device=b.device),
        rz=rz, r_norm2=r2_0, prec_max=inf, r_max=r_max, err_max=err_max,
        r0_norm=torch.sqrt(r2_0),
    )


def cg_iteration(A, M, stop: StopConfig, s: CGState, u_true, beta_kind: str = "msg") -> CGState:
    """One (P)CG step (without a preconditioner, β by ``beta_kind``:
    ``"msg"`` or ``"fr"``) with the stop flags evaluated on device. On a
    mesh operator every reduction is all-reduced over the mesh, so every
    rank takes the same branch."""
    mesh = mesh_of(A)
    Az = A(s.z)
    if M is not None:
        rz = s.rz
        (zAz,) = all_sum(mesh, _dot(Az, s.z))
    else:
        rz, zAz = all_sum(mesh, _dot(s.r, s.z), _dot(Az, s.z))
    alpha = rz / zAz
    x = s.x + alpha * s.z
    r = s.r - alpha * Az
    if M is not None:
        w = precondition(M, r)
        r2, rz_new = all_sum(mesh, _dot(r, r), _dot(r, w))
    else:
        (r2,) = all_sum(mesh, _dot(r, r))
    r_max, z_max, err_max = all_max(
        mesh, _maxabs(r), _maxabs(s.z), _maxabs(x - u_true) if u_true is not None else s.err_max)
    prec_max = torch.abs(alpha) * z_max
    done, reason = stop_reason(stop, prec_max, r_max, err_max, r2, s.r0_norm,
                               u_true is not None)
    if M is None:
        z = r + (r2 / (s.r_norm2 if beta_kind == "fr" else rz)) * s.z
        rz_new = r2
    else:
        z = w + (rz_new / rz) * s.z
    return s._replace(
        x=x, r=r, z=z, k=s.k + 1, done=done, reason=reason, rz=rz_new,
        r_norm2=r2, prec_max=prec_max, r_max=r_max, err_max=err_max,
    )


def cg_run(A: Operator, b: torch.Tensor, n_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iters`` iterations of plain MSG CG from x0 = 0, with no stop test
    and no host read: the compute core alone, for timing and compile checks.
    Returns (x, ‖r‖²) as device tensors."""
    x, r, z = torch.zeros_like(b), b.clone(), b.clone()
    for _ in range(n_iters):
        Az = A(z)
        rz = _dot(r, z)
        alpha = rz / _dot(Az, z)
        x = x + alpha * z
        r = r - alpha * Az
        z = r + (_dot(r, r) / rz) * z
    return x, _dot(r, r)


def _sync_stats(s: CGState) -> Tuple[bool, int, float, float, float, float, float]:
    """ONE host transfer of the progress scalars."""
    f = s.r_max.dtype
    v = host_read(torch.stack([
        s.done.to(f), s.reason.to(f), s.prec_max.to(f), s.r_max.to(f),
        s.err_max.to(f), s.r_norm2.to(f), s.r0_norm.to(f),
    ]))
    return bool(v[0]), int(v[1]), v[2], v[3], v[4], v[5], v[6]


def cg_solve(
    A: Operator,
    b: torch.Tensor,
    *,
    x0: Optional[torch.Tensor] = None,
    u_true: Optional[torch.Tensor] = None,
    options: Optional[CGOptions] = None,
    init_state: Optional[CGState] = None,
) -> CGResult:
    """Solve ``A x = b`` by (preconditioned) conjugate gradients, from
    ``init_state`` when given (then ``A``, ``b`` and ``x0`` are not read)."""
    opts = options or CGOptions()
    stop = opts.stop
    if opts.beta_kind not in ("msg", "fr"):
        raise ValueError(f"unknown beta_kind {opts.beta_kind!r}")
    prof = opts.profiler
    if prof is not None and "nnz_per_apply" not in prof.counters and hasattr(A, "nnz"):
        prof.counters["nnz_per_apply"] = float(A.nnz())
    with solve_span("cg_solve", prof):
        t0 = time.perf_counter()
        if init_state is not None:
            state = init_state
        else:
            with span("setup"):
                state = _cg_init(A, opts.preconditioner, b, x0, u_true)
        step = opts.step_fn or (
            lambda s, u: cg_iteration(A, opts.preconditioner, stop, s, u, opts.beta_kind)
        )
        history = []

        def fire(k: int, prec: float, rmax: float, emax: float, rn: float) -> None:
            if opts.callback is not None:
                opts.callback(k, prec, rmax, emax)
            if opts.record_history:
                history.append((k, prec, rmax, emax, rn))

        def result(reason: StopReason, converged: bool) -> CGResult:
            return CGResult(
                x=state.x, iterations=k, converged=converged, reason=reason, precision_max=prec,
                residual_max=rmax, error_max=emax, residual_norm=math.sqrt(max(r2, 0.0)),
                initial_residual_norm=r0n, elapsed_s=time.perf_counter() - t0,
                history=np.asarray(history) if opts.record_history else None,
            )

        k = state.k
        _, _, prec, rmax, emax, r2, r0n = _sync_stats(state)
        if k == 0:
            prec = math.inf
        fire(k, prec, rmax, emax, r0n if k == 0 else math.sqrt(max(r2, 0.0)))
        if r2 == 0.0:  # x is already exact (and the recurrence would divide 0/0)
            return result(StopReason.RESIDUAL, True)
        max_iter = stop.max_iterations
        every = max(1, opts.callback_every)
        chunk = opts.chunk_size or (every if opts.callback else min(max_iter, 500))
        interrupted = False
        reason = StopReason.ITERATIONS
        while k < max_iter:
            if opts.stop_requested is not None and opts.stop_requested():
                interrupted, reason = True, StopReason.INTERRUPTED
                break
            if opts.callback is not None:
                k_stop = 1 if k == 0 else min((k // every + 1) * every, max_iter)
            else:
                k_stop = min(k + chunk, max_iter)
            k_prev, done = k, False
            with span("cg_chunk"):
                # one chunk: the JAX chunk's loop condition, read once per iteration
                while not done and k < k_stop and r2 > 0:
                    with span("inner_iter"):
                        state = step(state, u_true)
                        k = state.k
                        done, code, prec, rmax, emax, r2, r0n = _sync_stats(state)
            if prof is not None:
                prof.count("iterations", k - k_prev)
                prof.count("operator_applies", k - k_prev)
            if opts.state_callback is not None:
                opts.state_callback(state)
            if done:
                reason = StopReason(code)
                break
            if k == k_prev:  # no progress without a stop flag: r == 0, x is exact
                fire(k, prec, rmax, emax, math.sqrt(max(r2, 0.0)))
                return result(StopReason.RESIDUAL, True)
            if opts.callback is not None or opts.record_history:
                fire(k, prec, rmax, emax, math.sqrt(max(r2, 0.0)))
        fire(k, prec, rmax, emax, math.sqrt(max(r2, 0.0)))  # the final call, unconditional
        return result(reason, reason.converged and not interrupted)

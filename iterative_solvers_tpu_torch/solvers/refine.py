"""Mixed-precision iterative refinement, high-precision outer / f32 inner
MG-PCG (counterpart of the JAX package's solvers/refine.py).

The JAX package runs the whole refinement ladder as one compiled program
(``_device_ir``, ``_device_ir_generic``). Eager PyTorch runs it as a host
loop over device tensors with the same semantics: the same stop criteria and
stall test, the same history rows ``(max_outer + 1, 5)`` and the same packed
stats vector. The host reads one packed tensor per PCG iteration (the inner
stop test, decided on the device in f32) and one per outer step.

Two inner solvers: :func:`engine_refined_solve` runs a 2D fused PCG engine
on the caller's layout — the single-device engine (kernels/cg_fused.py)
behind :func:`fused_refined_solve`, which pads and crops, or the mesh's
(parallel/cg_fused_sharded.py); :func:`device_refined_solve` runs the plain PCG
recurrence around any f32 operator and preconditioner — the 3D path, on the
padded 7-point operator (kernel S7) and the fused 3D V-cycle, and the
generic ladder on the plain stencil with Jacobi, Chebyshev or no
preconditioner. :func:`refined_solve` is the host ladder: the escalated f64
polish of both, and the facade's path when a caller listens (``callback``,
``stop_requested``).

Two outers, as in the JAX package: f64 (:func:`_outer_refine_loop`; its
norms are compared on the host in f64, bit-identical to comparing them on
the device) and double-f32 pairs (:func:`_outer_refine_loop_ff`, ``ff=True``;
on a padded layout the compensated residual kernel ``kernels/resid_ff.py``,
on the plain stencil its torch form ``ops/ddf32.residual_ff``, as the JAX
package computes it there outside any kernel; f32 norms compared in f32 as
the device would). ``fmg`` starts the ladder from the FMG warm
start (:func:`_maybe_fmg_x0`) instead of zero.

Spans (``profiling.py``): the JAX package's phases, ``inner_solve`` and
``outer_residual`` for each outer step of either ladder, ``device_ir``
around a whole device ladder (FMG warm start included) and
``escalated_polish`` around its host polish; ``fmg`` around the FMG warm
start, ``inner_iter`` for each inner iteration, ``precond`` for each
preconditioner application, and ``host_read`` for each read of a device
value (:func:`~iterative_solvers_tpu_torch.profiling.host_read`). They
record when ``profiler=`` (:class:`~iterative_solvers_tpu_torch.profiling.
Profiler`, which also counts the inner ``iterations``) is given or a
``torch.profiler`` capture is active.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from iterative_solvers_tpu_torch.kernels.cg_fused import _engine_for
from iterative_solvers_tpu_torch.kernels.resid_ff import resid_ff
from iterative_solvers_tpu_torch.ops.ddf32 import (
    pair_add_f32,
    pair_value,
    residual_ff,
    split_f64,
    two_sum,
)
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
from iterative_solvers_tpu_torch.parallel.mesh import all_max, all_sum, mesh_of
from iterative_solvers_tpu_torch.profiling import host_read, solve_span, span
from iterative_solvers_tpu_torch.solvers.cg import (
    CGOptions,
    CGResult,
    CGState,
    cg_solve,
    precondition,
)
from iterative_solvers_tpu_torch.solvers.stopping import StopConfig, StopReason

F32 = torch.float32


@dataclass
class RefinedResult(CGResult):
    """CGResult plus refinement structure: ``iterations`` counts total inner
    PCG iterations; ``outer_iterations`` the f64 refinement steps."""

    outer_iterations: int = 0
    inner_iterations: Optional[List[int]] = None
    escalated: bool = False


def _norms(r, d, x, u_true, mesh=None):
    """(‖r‖∞, ‖d‖∞, ‖x−u‖∞, ‖r‖₂²) as host floats — one transfer (over a
    mesh, of the all-reduced values)."""
    e = (
        torch.max(torch.abs(x - u_true))
        if u_true is not None
        else torch.full((), math.inf, dtype=r.dtype, device=r.device)
    )
    maxes = all_max(mesh, torch.max(torch.abs(r)), torch.max(torch.abs(d)), e)
    v = host_read(torch.stack([*maxes, *all_sum(mesh, torch.sum(r * r))]))
    return v[0], v[1], v[2], v[3]


def refined_solve(
    A_hi: Callable,
    A_lo: Callable,
    b: torch.Tensor,
    *,
    u_true: Optional[torch.Tensor] = None,
    stop: Optional[StopConfig] = None,
    preconditioner: Optional[Callable] = None,
    inner_rel_tol: float = 1e-4,
    inner_max_iter: int = 200,
    max_outer: int = 40,
    x0: Optional[torch.Tensor] = None,
    callback: Optional[Callable[[int, float, float, float], None]] = None,
    stop_requested: Optional[Callable[[], bool]] = None,
    profiler=None,
) -> RefinedResult:
    """Host-driven refinement with the precision ladder: inner solves run in
    f32 until an outer step shrinks ‖r‖∞ by less than 20x, then in
    ``b.dtype`` (f64). This is the escalated polish of
    :func:`fused_refined_solve`, continuing from ``x0``, and the facade's
    ladder when a caller listens: ``callback(total inner, ‖d‖∞, ‖r‖∞,
    err∞)`` fires at the start and after each outer step, and
    ``stop_requested`` is polled before each (INTERRUPTED)."""
    stop = stop or StopConfig()
    lo_dtype = F32
    if b.dtype == lo_dtype:
        raise ValueError("b must be f64 for the high-precision outer loop")
    t0 = time.perf_counter()
    with solve_span("refined_solve", profiler):
        mesh = mesh_of(A_hi)

        def adaptive_inner_tol(r_max_now: float, r_norm_now: float) -> float:
            need = math.inf
            if stop.eps_relative > 0 and r_norm_now > 0:
                need = min(need, stop.eps_relative * r0_norm / r_norm_now)
            if stop.eps_residual > 0 and r_max_now > 0:
                need = min(need, stop.eps_residual / r_max_now)
            if not math.isfinite(need):
                return inner_rel_tol
            tol = min(max(inner_rel_tol, 0.3 * need), 0.1)
            return 10.0 ** math.floor(math.log10(tol))

        if x0 is None:
            x = torch.zeros_like(b)
            r = b
        else:
            x = x0.to(b.dtype).clone()
            r = b - A_hi(x)
        r_max, _, err_max, r2 = _norms(r, r, x, u_true, mesh)
        r_norm = math.sqrt(max(r2, 0.0))
        r0_norm = r_norm if x0 is None else math.sqrt(
            max(host_read(all_sum(mesh, torch.sum(b * b))[0]), 0.0))
        prec_max = math.inf
        reason = StopReason.ITERATIONS
        total_inner = 0
        inner_counts: List[int] = []
        cur_dtype = lo_dtype
        escalated = False
        stalls = 0
        interrupted = False
        hist_rows = [(0, math.inf, r_max, err_max, r_norm)]
        if callback is not None:
            callback(0, math.inf, r_max, err_max)

        for outer in range(max_outer):
            if r_max == 0.0:
                reason = StopReason.RESIDUAL
                break
            if stop.eps_residual > 0 and r_max < stop.eps_residual:
                reason = StopReason.RESIDUAL
                break
            if stop.eps_exact_error > 0 and err_max < stop.eps_exact_error:
                reason = StopReason.EXACT_ERROR
                break
            if stop.eps_precision > 0 and outer > 0 and prec_max < stop.eps_precision:
                reason = StopReason.PRECISION
                break
            if stop.eps_relative > 0 and r_norm < stop.eps_relative * r0_norm:
                reason = StopReason.RELATIVE_RESIDUAL
                break
            if total_inner >= stop.max_iterations:
                reason = StopReason.ITERATIONS
                break
            if stop_requested is not None and stop_requested():
                interrupted, reason = True, StopReason.INTERRUPTED
                break
            with span("inner_solve"):
                opts = CGOptions(
                    stop=StopConfig(
                        eps_precision=-1.0, eps_residual=-1.0, eps_exact_error=-1.0,
                        eps_relative=adaptive_inner_tol(r_max, r_norm),
                        max_iterations=inner_max_iter,
                    ),
                    preconditioner=preconditioner,
                    profiler=profiler,
                )
                # escalated (b.dtype) inners use A_hi: A_lo may be f32-only
                A_in = A_lo if cur_dtype == lo_dtype else A_hi
                inner = cg_solve(A_in, r.to(cur_dtype), options=opts)
            with span("outer_residual"):
                d = inner.x.to(b.dtype)
                x = x + d
                r = b - A_hi(x)
                total_inner += inner.iterations
                inner_counts.append(inner.iterations)
                r_max_new, prec_max, err, r2 = _norms(r, d, x, u_true, mesh)
            r_norm = math.sqrt(max(r2, 0.0))
            if u_true is not None:
                err_max = err
            hist_rows.append((total_inner, prec_max, r_max_new, err_max, r_norm))
            if not math.isfinite(r_max_new):
                r_max = r_max_new
                reason = StopReason.DIVERGED
                break
            if not escalated and r_max_new > 0.05 * r_max and r_max_new > 0:
                cur_dtype = b.dtype  # f32 floor reached: polish with f64 inners
                escalated = True
            elif cur_dtype == b.dtype:
                stalls = stalls + 1 if r_max_new > 0.5 * r_max else 0
                if stalls >= 2:
                    r_max = r_max_new
                    reason = StopReason.ITERATIONS
                    break
            r_max = r_max_new
            if callback is not None:
                callback(total_inner, prec_max, r_max, err_max)

        return RefinedResult(
            x=x,
            iterations=total_inner,
            converged=bool(reason.converged and not interrupted),
            reason=reason,
            precision_max=prec_max,
            residual_max=r_max,
            error_max=err_max,
            residual_norm=r_norm,
            initial_residual_norm=r0_norm,
            elapsed_s=time.perf_counter() - t0,
            history=np.asarray(hist_rows, dtype=np.float64),
            outer_iterations=len(inner_counts),
            inner_iterations=inner_counts,
            escalated=escalated,
        )


def _traced_inner_eta(stop: StopConfig, inner_rel_tol: float, r_hi, r0_norm, mesh=None):
    """Loosest inner tolerance meeting the outer target this step, as a
    device f32 scalar (safety factor 0.45, clipped to [inner_rel_tol, 0.1];
    a non-finite need falls back to inner_rel_tol)."""
    r_norm_hi = torch.sqrt(all_sum(mesh, torch.sum(r_hi * r_hi))[0])
    (r_max_hi,) = all_max(mesh, torch.max(torch.abs(r_hi)))
    need = torch.full((), math.inf, dtype=r_hi.dtype, device=r_hi.device)
    if stop.eps_relative > 0:
        need = torch.minimum(
            need, stop.eps_relative * r0_norm / torch.clamp(r_norm_hi, min=1e-300)
        )
    if stop.eps_residual > 0:
        need = torch.minimum(need, stop.eps_residual / torch.clamp(r_max_hi, min=1e-300))
    eta = torch.clamp(torch.clamp(0.45 * need, min=inner_rel_tol), inner_rel_tol, 0.1)
    return torch.where(torch.isfinite(need), eta, inner_rel_tol).to(F32)


def _fused_inner_solve(engine, eta, r_hi, inner_max_iter: int):
    """Fused PCG on ``A d = r`` (f32, from zero) to relative tolerance
    ``eta``; returns (d, iterations). One host read per iteration. Over a
    mesh (the engine's operator sharded) the norms are all-reduced."""
    mesh = mesh_of(engine.op)
    r32 = r_hi.to(F32)
    w0, rz0 = engine.precondition(r32)
    (r2_0,) = all_sum(mesh, torch.sum(r32 * r32))
    (r_max,) = all_max(mesh, torch.max(torch.abs(r32)))
    dev = r32.device
    s = CGState(
        x=torch.zeros_like(r32), r=r32, z=torch.zeros_like(r32), k=0,
        done=torch.zeros((), dtype=torch.bool, device=dev),
        reason=torch.full((), int(StopReason.ITERATIONS), dtype=torch.int32, device=dev),
        rz=rz0, r_norm2=r2_0,
        prec_max=torch.full((), math.inf, dtype=F32, device=dev),
        r_max=r_max,
        err_max=torch.full((), math.inf, dtype=F32, device=dev),
        r0_norm=torch.sqrt(r2_0),
        w=w0, rz_prev=torch.ones((), dtype=F32, device=dev),
    )
    going = host_read(r2_0 > 0)
    while going and s.k < inner_max_iter:
        with span("inner_iter"):
            s = engine.iteration(s)
            done = (torch.sqrt(s.r_norm2) < eta * s.r0_norm) | ~torch.isfinite(s.r_norm2)
            going = host_read(~done & (s.r_norm2 > 0))  # the one host read
    return s.x, s.k


def _pcg_inner_solve(A_lo, M, eta, r32, inner_max_iter: int):
    """The plain PCG recurrence on ``A_lo d = r32`` (f32, from zero) to
    relative tolerance ``eta``, as the JAX package's ``_device_ir_generic``
    runs it; returns (d, iterations). One host read per iteration. Over a
    mesh (``A_lo`` sharded) every dot is all-reduced."""
    mesh = mesh_of(A_lo)
    z = precondition(M, r32) if M is not None else r32
    rz, r2 = all_sum(mesh, torch.sum(r32 * z), torch.sum(r32 * r32))
    ir0 = torch.sqrt(r2)
    x, r, k = torch.zeros_like(r32), r32, 0
    going = host_read(r2 > 0)
    while going and k < inner_max_iter:
        with span("inner_iter"):
            Az = A_lo(z)
            alpha = rz / all_sum(mesh, torch.sum(Az * z))[0]
            x = x + alpha * z
            r = r - alpha * Az
            w = precondition(M, r) if M is not None else r
            r2, rz_new = all_sum(mesh, torch.sum(r * r), torch.sum(r * w))
            z = w + (rz_new / rz) * z
            rz = rz_new
            k += 1
            done = (torch.sqrt(r2) < eta * ir0) | ~torch.isfinite(r2)
            going = host_read(~done & (r2 > 0))  # the one host read
    return x, k


def _outer_ladder(stop: StopConfig, max_outer: int, has_u: bool, num, r0_norm, x, r,
                  inner_solve, step, norms):
    """The outer refinement loop both outers share. ``inner_solve: r ->
    (d_f32, k_inner)``; ``step(x, d_f32) -> (x, r)`` adds the correction and
    takes the true residual; ``norms(r, d_f32 or None, x) -> (‖r‖∞, ‖r‖₂²,
    ‖d‖∞, err∞)`` as host scalars of type ``num`` (float for the f64 outer,
    np.float32 for the ff outer), in which every stop and stall test
    compares. Exits on a stop criterion, on the outer or iteration budget,
    or on an f32-floor stall (an outer shrinking ‖r‖∞ by < 20x) so the
    escalated polish can take over. Returns (x, packed stats of dtype
    ``num``): the nine summary scalars, then the history block of
    ``max_outer + 1`` rows of (total_inner, ‖d‖∞, ‖r‖∞, err∞, ‖r‖₂), row 0
    the initial (or warm-start) state."""
    r_max, r2, _, err = norms(r, None, x)
    hist = np.zeros((max_outer + 1, 5), np.dtype(num))
    hist[0] = (0.0, math.inf, r_max, err, np.sqrt(r2))
    k_out = total_inner = 0
    done, reason, stalled = False, StopReason.ITERATIONS, False
    prec, rm_prev = num(math.inf), num(math.inf)
    while not done and not stalled and k_out < max_outer and total_inner < stop.max_iterations:
        with span("inner_solve"):
            d32, k_in = inner_solve(r)
        with span("outer_residual"):
            x, r = step(x, d32)
            r_max, r2, prec, e = norms(r, d32, x)
        if has_u:
            err = e
        total_inner += k_in
        r_norm = np.sqrt(r2)
        hist[k_out + 1] = (total_inner, prec, r_max, err, r_norm)
        stalled = bool(r_max > num(0.05) * rm_prev)
        checks = (
            (not np.isfinite(r2), StopReason.DIVERGED),
            (stop.eps_residual > 0 and r_max < num(stop.eps_residual), StopReason.RESIDUAL),
            (stop.eps_exact_error > 0 and has_u and err < num(stop.eps_exact_error),
             StopReason.EXACT_ERROR),
            (stop.eps_precision > 0 and prec < num(stop.eps_precision), StopReason.PRECISION),
            (stop.eps_relative > 0 and r_norm < num(stop.eps_relative) * r0_norm,
             StopReason.RELATIVE_RESIDUAL),
        )
        fired = [code for flag, code in checks if flag]
        done = bool(fired)
        reason = fired[0] if fired else StopReason.ITERATIONS
        rm_prev = r_max
        k_out += 1
    stats = np.concatenate([
        np.asarray([k_out, total_inner, float(done), float(int(reason)), r_max, prec, err, r2,
                    r0_norm], hist.dtype),
        hist.ravel(),
    ])
    return x, stats


def _outer_refine_loop(A_hi, stop: StopConfig, max_outer: int, b, u_true, inner_solve,
                       x0=None):
    """:func:`_outer_ladder` on true f64 quantities, compared on the host in
    f64. ``x0``: an f32 warm start; its residual is not counted in the inner
    iterations."""

    def step(x, d32):
        x = x + d32.to(b.dtype)
        return x, b - A_hi(x)

    mesh = mesh_of(A_hi)

    def norms(r, d32, x):
        r_max, prec, err, r2 = _norms(r, r if d32 is None else d32.to(b.dtype), x, u_true,
                                      mesh)
        return r_max, r2, prec, err

    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    r = b if x0 is None else b - A_hi(x)
    r0_norm = host_read(torch.sqrt(all_sum(mesh, torch.sum(b * b))[0]))
    return _outer_ladder(stop, max_outer, u_true is not None, float, r0_norm, x, r,
                         inner_solve, step, norms)


def _outer_refine_loop_ff(op, stop: StopConfig, max_outer: int, b, u_true, inner_solve,
                          x0=None):
    """:func:`_outer_ladder` with the high-precision state as double-f32
    pairs (ops/ddf32.py): no f64 op until the final ``x = xh + xl``. The
    true residual is the compensated residual kernel (:func:`resid_ff`) on a
    padded operator ``op``, and its torch form (``ddf32.residual_ff``) on a
    plain :class:`StencilOperator`. Norms are f32 reductions, and every stop
    and stall test compares f32 values in f32, as the JAX package's device
    loop does. ``inner_solve: (rh, rl) -> (d_f32, k_inner)``; the stats
    vector is f32."""
    f32 = np.float32
    if b.dtype == F32:
        bh, bl = b, torch.zeros_like(b)
    else:
        bh, bl = split_f64(b)
    if u_true is not None:
        uh, ul = (u_true, torch.zeros_like(u_true)) if u_true.dtype == F32 else split_f64(u_true)
    s0 = bh + bl
    r0 = f32(host_read(torch.sqrt(torch.sum(s0 * s0))))
    inf = torch.full((), math.inf, dtype=F32, device=b.device)

    if tuple(op.shape) != tuple(b.shape):
        raise ValueError(f"the ff outer's operator works on {tuple(op.shape)} fields, "
                         f"b is {tuple(b.shape)}")
    if isinstance(op, StencilOperator):
        interior = op.interior(b.device)

        def residual(x_pair):
            return residual_ff(interior, op.coeffs, (bh, bl), x_pair)
    else:
        def residual(x_pair):
            return resid_ff(x_pair[0], x_pair[1], bh, bl, op)

    def step(x_pair, d32):
        x_pair = pair_add_f32(x_pair, d32)
        return x_pair, residual(x_pair)

    def norms(r_pair, d32, x_pair):
        """(‖r‖∞, ‖r‖₂², ‖d‖∞, err∞) as f32 host values — one transfer."""
        s = pair_value(r_pair)
        if u_true is not None:
            # close values: (xh − uh) is nearly exact; the low parts ride plain
            d, e = two_sum(x_pair[0], -uh)
            err = torch.max(torch.abs(d + ((x_pair[1] - ul) + e)))
        else:
            err = inf
        prec = torch.max(torch.abs(d32)) if d32 is not None else inf
        v = host_read(torch.stack([torch.max(torch.abs(s)), torch.sum(s * s), prec, err]))
        return tuple(f32(a) for a in v)

    if x0 is None:
        x = (torch.zeros_like(bh), torch.zeros_like(bh))
        r = (bh, bl)
    else:
        x = (x0.to(F32), torch.zeros_like(bh))
        r = residual(x)
    x, stats = _outer_ladder(stop, max_outer, u_true is not None, f32, r0, x, r,
                             inner_solve, step, norms)
    # the full-precision iterate, once: the one f64 op of the ff ladder
    return x[0].to(b.dtype) + x[1].to(b.dtype), stats


def _device_ir(engine, A_hi, stop: StopConfig, inner_rel_tol: float, inner_max_iter: int,
               max_outer: int, b, u_true, x0=None, *, ff: bool = False):
    """The f32 ladder of mixed-precision refinement: the f64 outer (or, with
    ``ff``, the double-f32 outer) around fused PCG inner solves, from
    ``x0`` when given. Returns (x, packed stats). Over a mesh (the engine's
    operator sharded; f64 outer only) every norm is all-reduced."""
    mesh = mesh_of(engine.op)
    if ff:
        b32 = b.to(F32)
        r0_norm = torch.sqrt(torch.sum(b32 * b32))
    else:
        r0_norm = torch.sqrt(all_sum(mesh, torch.sum(b * b))[0])

    def inner_solve(r_hi):
        r = pair_value(r_hi) if ff else r_hi
        eta = _traced_inner_eta(stop, inner_rel_tol, r, r0_norm, mesh)
        return _fused_inner_solve(engine, eta, r, inner_max_iter)

    if ff:
        return _outer_refine_loop_ff(engine.op, stop, max_outer, b, u_true, inner_solve, x0=x0)
    return _outer_refine_loop(A_hi, stop, max_outer, b, u_true, inner_solve, x0=x0)


# Levels whose grid extent exceeds this bound polish with weighted-Jacobi
# sweeps (the Jacobi kernel) instead of a V-cycle in the FMG warm start;
# one sweep, as in the JAX package (whose measured reasons are in its
# solvers/refine.py).
_FMG_POLISH_MAX_EXTENT = 512
_FMG_SMOOTH_SWEEPS = 1


def _multigrid_of(M):
    """The multigrid inside ``M`` (through a PaddedPreconditioner), or None."""
    M = getattr(M, "inner", M)
    return M if hasattr(M, "fmg_stepwise") and hasattr(M, "levels") else None


def _maybe_fmg_x0(M, fmg, b):
    """FMG warm-start field (f32) on ``b``'s layout, or None for a cold
    start. ``fmg``: False/0 cold, True/1 or n >= 1 polish V-cycles per
    level. ``M``: a multigrid, or a :class:`PaddedPreconditioner` around
    one; with the :meth:`with_fmg` payload the stepwise warm start, without
    it the algebraic ``fmg``; any other preconditioner (or none) starts
    cold, as in the JAX package."""
    mg = _multigrid_of(M)
    if not fmg or mg is None:
        return None
    with span("fmg"):
        if mg.fmg_data is None:
            return M.fmg(b.to(F32), int(fmg))
        return M.fmg_stepwise(b, int(fmg), polish_max_extent=_FMG_POLISH_MAX_EXTENT,
                              smooth_sweeps=_FMG_SMOOTH_SWEEPS)


def _device_ir_generic(A_hi, A_lo, M, stop: StopConfig, inner_rel_tol: float,
                       inner_max_iter: int, max_outer: int, b, u_true, x0=None, *,
                       ff: bool = False):
    """:func:`_device_ir` with the plain PCG recurrence as the inner solve
    (:func:`_pcg_inner_solve` on ``A_lo`` and ``M``). The ff outer takes its
    residuals from ``A_lo`` (:func:`_outer_refine_loop_ff`)."""
    mesh = mesh_of(A_lo)
    if ff:
        b32 = b.to(F32)
        r0_norm = torch.sqrt(torch.sum(b32 * b32))
    else:
        r0_norm = torch.sqrt(all_sum(mesh, torch.sum(b * b))[0])

    def inner_solve(r_hi):
        r32 = pair_value(r_hi) if ff else r_hi.to(F32)
        eta = _traced_inner_eta(stop, inner_rel_tol, r32 if ff else r_hi, r0_norm, mesh)
        return _pcg_inner_solve(A_lo, M, eta, r32, inner_max_iter)

    if ff:
        return _outer_refine_loop_ff(A_lo, stop, max_outer, b, u_true, inner_solve, x0=x0)
    return _outer_refine_loop(A_hi, stop, max_outer, b, u_true, inner_solve, x0=x0)


def _padded_hi_operator(pop) -> StencilOperator:
    """High-precision plain stencil on the padded layout of ``pop`` (the
    5-point operator in 2D, the 7-point one in 3D)."""
    return StencilOperator(pop.mask_spec, pop.coeffs)


def _join_history(dev_hist, cont_hist, inner_offset: int):
    cont = np.asarray(cont_hist, dtype=np.float64).copy()
    cont[:, 0] += inner_offset
    return np.concatenate([dev_hist, cont[1:]], axis=0)


def _finish_refined(stats, x, *, stop: StopConfig, t0: float, max_outer: int, A_hi, A_lo, b,
                    u_true, preconditioner, inner_rel_tol: float, inner_max_iter: int,
                    profiler=None) -> RefinedResult:
    """Unpack the stats vector; if the f32 ladder left the criteria unmet,
    continue with the escalated polish (:func:`refined_solve` from x)."""
    k_out, total_inner = int(stats[0]), int(stats[1])
    done, reason = bool(stats[2]), StopReason(int(stats[3]))
    r_max, prec, err = float(stats[4]), float(stats[5]), float(stats[6])
    r_norm = math.sqrt(max(float(stats[7]), 0.0))
    r0_norm = float(stats[8])
    hist = stats[9:].reshape(max_outer + 1, 5)[: k_out + 1].copy()
    if profiler is not None:
        profiler.count("iterations", total_inner)
    if not done and reason == StopReason.ITERATIONS and total_inner < stop.max_iterations:
        with span("escalated_polish"):
            res = refined_solve(
                A_hi, A_lo, b, u_true=u_true, stop=stop, preconditioner=preconditioner,
                inner_rel_tol=inner_rel_tol, inner_max_iter=inner_max_iter, x0=x,
                profiler=profiler,
            )
        res.iterations += total_inner
        res.outer_iterations += k_out
        res.escalated = True
        res.elapsed_s = time.perf_counter() - t0
        res.history = _join_history(hist, res.history, total_inner)
        return res
    return RefinedResult(
        x=x,
        iterations=total_inner,
        converged=bool(done and reason.converged),
        reason=reason,
        precision_max=prec,
        residual_max=r_max,
        error_max=err,
        residual_norm=r_norm,
        initial_residual_norm=r0_norm,
        elapsed_s=time.perf_counter() - t0,
        history=hist,
        outer_iterations=k_out,
    )


def engine_refined_solve(
    engine,  # fused engine: kernels.cg_fused.FusedCGEngine or its mesh form
    A_hi: Callable,  # high-precision operator on the engine's field layout
    b: torch.Tensor,  # f64 RHS on that layout (padded; this rank's block on a mesh)
    *,
    u_true: Optional[torch.Tensor] = None,
    stop: Optional[StopConfig] = None,
    inner_rel_tol: float = 1e-4,
    inner_max_iter: int = 200,
    max_outer: int = 8,
    fmg=False,  # False/0 cold | True/1 | int n = FMG polish V-cycles per level
    ff: bool = False,  # double-f32 outer (single-device only)
    profiler=None,
) -> RefinedResult:
    """Mixed-precision refinement around any fused engine, on the caller's
    field layout: the FMG warm start when ``fmg`` (and ``engine.M`` carries
    the :meth:`with_fmg` payload), then the f64 or, with ``ff``, the
    double-f32 outer around fused PCG inners; the escalated f64 polish
    continues host-side if the f32 ladder leaves the criteria unmet. The
    layout-agnostic core of :func:`fused_refined_solve`; with a
    ``parallel.cg_fused_sharded.ShardedFusedCGEngine`` and the f64 halo
    twin as ``A_hi`` it is the mesh's engine ladder (every norm
    all-reduced; the outer is f64 there, as in the JAX package)."""
    stop = stop or StopConfig()
    if ff and mesh_of(engine.op) is not None:
        raise ValueError("the ff outer is single-device: over a mesh the outer is f64")
    t0 = time.perf_counter()
    with solve_span("engine_refined_solve", profiler):
        with span("device_ir"):
            x0 = _maybe_fmg_x0(engine.M, fmg, b)
            x, stats = _device_ir(engine, A_hi, stop, inner_rel_tol, inner_max_iter, max_outer,
                                  b, u_true, x0, ff=ff)
        return _finish_refined(
            stats, x, stop=stop, t0=t0, max_outer=max_outer, A_hi=A_hi, A_lo=A_hi, b=b,
            u_true=u_true, preconditioner=engine.M, inner_rel_tol=inner_rel_tol,
            inner_max_iter=inner_max_iter, profiler=profiler,
        )


def fused_refined_solve(
    pop,  # kernels.stencil_layout.PaddedStencilOperator
    M_padded,  # preconditioner on the padded layout
    b: torch.Tensor,  # UNPADDED f64 RHS
    *,
    u_true: Optional[torch.Tensor] = None,
    stop: Optional[StopConfig] = None,
    inner_rel_tol: float = 1e-4,
    inner_max_iter: int = 200,
    max_outer: int = 8,
    fmg=False,  # False/0 cold | True/1 | int n = FMG polish V-cycles per level
    ff: bool = False,  # double-f32 outer
    profiler=None,
) -> RefinedResult:
    """:func:`engine_refined_solve` on the single-device fused engine of
    ``pop``'s padded layout: pads ``b`` (and ``u_true``), crops ``x``."""
    with solve_span("fused_refined_solve", profiler):
        res = engine_refined_solve(
            _engine_for(pop, M_padded), _padded_hi_operator(pop), pop.pad(b),
            u_true=pop.pad(u_true) if u_true is not None else None, stop=stop,
            inner_rel_tol=inner_rel_tol, inner_max_iter=inner_max_iter, max_outer=max_outer,
            fmg=fmg, ff=ff, profiler=profiler,
        )
        res.x = pop.crop(res.x)
        return res


def device_refined_solve(
    A_hi: Callable,  # high-precision operator
    A_lo: Callable,  # f32 operator on the same field layout
    b: torch.Tensor,  # f64 RHS on that layout
    *,
    preconditioner: Optional[Callable] = None,
    u_true: Optional[torch.Tensor] = None,
    stop: Optional[StopConfig] = None,
    inner_rel_tol: float = 1e-4,
    inner_max_iter: int = 200,
    max_outer: int = 8,
    fmg=False,  # False/0 cold | True/1 | int n = FMG polish V-cycles per level
    ff: bool = False,  # double-f32 outer
    profiler=None,
) -> RefinedResult:
    """Mixed-precision refinement with the plain PCG recurrence as its inner
    solve, on the caller's field layout: the JAX package's 3D route, called
    as its bench calls it (``A_lo`` the padded 3D operator (S7),
    ``preconditioner`` a :class:`PaddedPreconditioner` whose multigrid
    carries the :meth:`with_fmg` payload, ``b`` padded), and its facade's
    generic ladder (``A_hi = A_lo`` the plain stencil, any preconditioner or
    none; ``fmg`` then starts cold, as in JAX, unless the preconditioner is a
    multigrid). With ``ff`` the outer takes its residuals from ``A_lo``: the
    residual kernel of a padded operator, ``ddf32.residual_ff`` on a plain
    :class:`StencilOperator`, on ``b``'s shape. The escalated f64 polish
    continues host-side if the f32 ladder leaves the criteria unmet."""
    stop = stop or StopConfig()
    if ff and mesh_of(A_lo) is not None:
        raise ValueError("the ff outer is single-device: over a mesh the outer is f64")
    t0 = time.perf_counter()
    with solve_span("device_refined_solve", profiler):
        with span("device_ir"):
            x0 = _maybe_fmg_x0(preconditioner, fmg, b)
            x, stats = _device_ir_generic(A_hi, A_lo, preconditioner, stop, inner_rel_tol,
                                          inner_max_iter, max_outer, b, u_true, x0, ff=ff)
        return _finish_refined(
            stats, x, stop=stop, t0=t0, max_outer=max_outer, A_hi=A_hi, A_lo=A_lo, b=b,
            u_true=u_true, preconditioner=preconditioner, inner_rel_tol=inner_rel_tol,
            inner_max_iter=inner_max_iter, profiler=profiler,
        )

"""Fused two-kernel CG/PCG iteration (counterpart of iterative_solvers_tpu/kernels/cg_fused.py).

- **K1** (:func:`k1`, CUDA ``csrc/cg_fused.cu``): forms ``z_k = d + β·z_prev``
  and ``A z_k`` on chip and emits per-block partials of (d, z_k),
  (A z_k, z_k), ‖z_k‖∞, plus each band's two z_k halo rows into a side buffer
  ``(g, 2, wp)``. Read-only on the fields; Az is never stored.
- **K2** (:func:`k2`, plain MSG CG) and **K2-pcg** (:func:`k2_pcg`): recompute
  z_k = r + β·z_prev (K2) or w + β·z_prev (K2-pcg) and A z_k, using K1's
  side rows at the band edges, and write ``x + α z_k``, ``r − α A z_k`` and
  z_k to fresh buffers, with partials of ‖r‖², ‖r‖∞ and, given a true
  solution ``u``, ‖x − u‖∞.

:func:`fused_cg_solve` runs the engine inside the CG loop
(:func:`~iterative_solvers_tpu_torch.solvers.cg.cg_solve`) with the JAX
package's fused-chunk stop rules.

Each wrapper launches its kernel on a CUDA tensor and runs its plain torch
version (``*_plain``, the same arithmetic on the whole canvas at once) on a
CPU tensor; any other device raises. The kernels cut the canvas into
tiles of :func:`tile_grid` rows (a divisor of the band height
``block_rows``, which stays the JAX package's) by 128 columns and emit one
partial per CUDA block; the plain versions emit one per band. Partial
sums are reduced afterwards in a fixed order with ``torch.sum``/
``torch.amax`` — no float atomics, so a trajectory repeats bit for bit.

On a custom layout (``op.mask8`` set) the kernels are the ``*_custom``
instantiations, which read the int8 mask where the others evaluate the
gamma/rect predicate; they replace the JAX package's ``custom=True``
bodies. Those trust their fields to be pre-masked (halo rows checked for
band validity only), as every solver field is; the port's kernels and plain
versions mask the halo rows by the mask, which agrees on such fields.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch.kernels import _build
# the tile rule lives with the layout, whose A1 tiles by it too (BLOCKS_PER_SM
# and TW stay importable from here)
from iterative_solvers_tpu_torch.kernels.stencil_layout import (  # noqa: F401
    BLOCKS_PER_SM,
    TW,
    PaddedStencilOperator,
    check_field,
    kernel_geometry,
    kernel_name,
    tile_grid,
)
from iterative_solvers_tpu_torch.parallel.mesh import all_max, all_sum, mesh_of
from iterative_solvers_tpu_torch.solvers.cg import CGOptions, CGResult, CGState, cg_solve, stop_reason
from iterative_solvers_tpu_torch.solvers.stopping import StopConfig, StopReason

def _scalar(name: str, t: torch.Tensor, device) -> None:
    if t.dtype != torch.float32 or t.device != device:
        raise TypeError(f"{name}: expected a float32 tensor on {device}")


def stencil_banded(zk, up_rows, dn_rows, mask, coeffs, by, left=None, right=None):
    """Masked ``A z_k`` where the rows just outside each band of ``by`` rows
    come from ``up_rows``/``dn_rows`` (g, wp) instead of the neighbouring band
    — the plain form of the kernels' band-local stencil. The columns just
    outside are ``left``/``right`` (hp,), zero when not given (off the
    canvas); a mesh block passes its neighbours' z_k there."""
    cd, cx, cy = coeffs
    hp, wp = zk.shape
    g = hp // by
    up = torch.cat([zk[:1], zk[:-1]]).view(g, by, wp).clone()
    up[:, 0] = up_rows
    dn = torch.cat([zk[1:], zk[-1:]]).view(g, by, wp).clone()
    dn[:, -1] = dn_rows
    if left is None:
        lr = F.pad(zk, (1, 1))
    else:
        lr = torch.cat([left[:, None], zk, right[:, None]], dim=1)
    y = cd * zk + cx * (lr[:, :-2] + lr[:, 2:]) + cy * (up.view(hp, wp) + dn.view(hp, wp))
    return torch.where(mask, y, 0.0)


def _geometry(launcher: str, op: PaddedStencilOperator, device):
    """(launcher name, geometry arguments with the tile rows, partials per field)."""
    hp, wp = op.padded_shape
    tj, blocks = tile_grid("k1" if launcher == "ist_k1" else "k2", op.padded_shape,
                           op.block_rows, _build.sm_count(device))
    name, geom = kernel_geometry(launcher, op.nx, op.ny, op.mask_mode, hp, wp, op.block_rows,
                                 op.mask8, device)
    return name, geom + (tj,), blocks


def k1_plain(d, zp, beta, op: PaddedStencilOperator):
    _build.note_plain(kernel_name("k1", op.mask8), d)
    hp, wp = op.padded_shape
    by = op.block_rows
    g = hp // by
    mask = op.mask_spec.build(d.device)
    zk = d + beta * zp
    # halo rows row0-1 and row0+by of each band, masked by their own row
    zpad = F.pad(torch.where(mask, zk, 0.0), (0, 0, 1, 1))
    up, dn = zpad[0:hp:by], zpad[by + 1 :: by]
    side = torch.stack([up, dn], dim=1)
    az = stencil_banded(zk, up, dn, mask, op.coeffs, by)
    rz_p = (d * zk).view(g, -1).sum(1)
    azz_p = (az * zk).view(g, -1).sum(1)
    zmax_p = zk.abs().view(g, -1).amax(1)
    return side, rz_p, azz_p, zmax_p


def k1(d, zp, beta, op: PaddedStencilOperator):
    """K1: ``(side, rz_p, azz_p, zmax_p)`` for ``z_k = d + β z_prev``; ``beta``
    is a 0-dim float32 tensor on the fields' device."""
    shape = op.padded_shape
    check_field("d", d, shape)
    check_field("z_prev", zp, shape)
    _scalar("beta", beta, d.device)
    if d.device.type == "cpu":
        return k1_plain(d, zp, beta, op)
    hp, wp = shape
    side = torch.empty((hp // op.block_rows, 2, wp), dtype=d.dtype, device=d.device)
    beta = beta.contiguous()
    p = _build.ptr
    name, geom, n_parts = _geometry("ist_k1", op, d.device)
    parts = torch.empty((3, n_parts), dtype=d.dtype, device=d.device)
    _build.launch(
        name, p(d), p(zp), p(beta), p(side), p(parts[0]), p(parts[1]), p(parts[2]),
        *geom, *op.coeffs,
    )
    return side, parts[0], parts[1], parts[2]


def _k2_plain(name, x, r, zp, d, side, scal, u, op: PaddedStencilOperator):
    """Plain form of K2 (``d`` = r) and K2-pcg (``d`` = w): z_k = d + β z_prev."""
    _build.note_plain(kernel_name(name, op.mask8), x)
    hp, _ = op.padded_shape
    g = hp // op.block_rows
    alpha, beta = scal[0], scal[1]
    mask = op.mask_spec.build(x.device)
    zk = d + beta * zp
    az = stencil_banded(zk, side[:, 0], side[:, 1], mask, op.coeffs, op.block_rows)
    xn = x + alpha * zk
    rn = r - alpha * az
    out = (xn, rn, zk, (rn * rn).view(g, -1).sum(1), rn.abs().view(g, -1).amax(1))
    if u is not None:
        out += ((xn - u).abs().view(g, -1).amax(1),)
    return out


def k2_plain(x, r, zp, side, scal, op: PaddedStencilOperator, u=None):
    return _k2_plain("k2", x, r, zp, r, side, scal, u, op)


def k2_pcg_plain(x, r, zp, w, side, scal, op: PaddedStencilOperator, u=None):
    return _k2_plain("k2_pcg", x, r, zp, w, side, scal, u, op)


def _k2_launch(name, x, r, zp, w, side, scal, u, op: PaddedStencilOperator):
    """Check the operands of K2 / K2-pcg (``w`` None for K2) and launch the
    kernel on CUDA tensors or run the plain version on CPU tensors."""
    shape = op.padded_shape
    fields = (("x", x), ("r", r), ("z_prev", zp), ("w", w), ("u", u))
    for fname, t in fields:
        if t is not None:
            check_field(fname, t, shape)
            if t.device != x.device:
                raise ValueError(f"{fname}: expected a tensor on {x.device}")
    hp, wp = shape
    check_field("side", side, (hp // op.block_rows, 2, wp))
    if scal.dtype != torch.float32 or scal.shape != (2,) or scal.device != x.device:
        raise TypeError("scal: expected float32 [alpha, beta] on the fields' device")
    if x.device.type == "cpu":
        if w is None:
            return k2_plain(x, r, zp, side, scal, op, u)
        return k2_pcg_plain(x, r, zp, w, side, scal, op, u)
    xo, ro, zo = (torch.empty_like(x) for _ in range(3))
    p = _build.ptr
    dirs = (p(x), p(r), p(zp)) + (() if w is None else (p(w),))
    name, geom, n_parts = _geometry(name, op, x.device)
    parts = torch.empty((3, n_parts), dtype=x.dtype, device=x.device)
    _build.launch(
        name, *dirs, p(side), p(scal.contiguous()), p(u), p(xo), p(ro), p(zo),
        p(parts[0]), p(parts[1]), p(parts[2]), *geom, *op.coeffs,
    )
    out = (xo, ro, zo, parts[0], parts[1])
    return out + ((parts[2],) if u is not None else ())


def k2(x, r, zp, side, scal, op: PaddedStencilOperator, u=None):
    """K2 (plain CG): ``(x', r', z_k, r2_p, rmax_p[, err_p])`` with z_k =
    r + β z_prev; ``scal`` = [α, β] (float32, on the fields' device); the
    ‖x' − u‖∞ partials ``err_p`` only when ``u`` is given. Inputs are left
    untouched."""
    return _k2_launch("ist_k2", x, r, zp, None, side, scal, u, op)


def k2_pcg(x, r, zp, w, side, scal, op: PaddedStencilOperator, u=None):
    """K2-pcg: as :func:`k2` with z_k = w + β z_prev (w = M r)."""
    return _k2_launch("ist_k2_pcg", x, r, zp, w, side, scal, u, op)


def _err_max(outs, like):
    """‖x − u‖∞ from K2's optional partials, else inf."""
    if len(outs) == 6:
        return torch.amax(outs[5])
    return torch.full((), float("inf"), dtype=like.dtype, device=like.device)


@dataclass(frozen=True, eq=False)
class FusedCGEngine:
    """Fused iteration for one padded layout. With ``M`` (PCG): K1, K2-pcg
    and one preconditioner application (``M.call_with_dot``) per iteration,
    β deferred as in the JAX engine: β_k = (r_k, w_k)/(r_{k−1}, w_{k−1}).
    Without ``M`` (plain MSG CG): K1 and K2, β = ‖r‖²/(r, z).

    The iteration is written once for one device and for a mesh: a mesh
    engine (``parallel/cg_fused_sharded.ShardedFusedCGEngine``) supplies
    the block kernels (:meth:`_k1`, :meth:`_k2`), and every scalar is
    all-reduced over ``mesh_of(op)`` (an identity without a mesh)."""

    op: PaddedStencilOperator
    M: Optional[object] = None

    def _k1(self, d, zp, beta):
        """K1 on ``z_k = d + β z_prev``: (side, rz_p, azz_p, zmax_p, halo),
        ``halo`` whatever :meth:`_k2` needs besides (nothing here)."""
        return k1(d, zp, beta, self.op) + (None,)

    def _k2(self, s: CGState, side, halo, scal, u_true):
        if self.M is not None:
            return k2_pcg(s.x, s.r, s.z, s.w, side, scal, self.op, u_true)
        return k2(s.x, s.r, s.z, side, scal, self.op, u_true)

    def precondition(self, r):
        """``(M r, (r, M r))``: the fused dot of ``M.call_with_dot`` where
        ``M`` has one, else the all-reduced dot."""
        fn = getattr(self.M, "call_with_dot", None)
        if fn is not None:
            return fn(r)
        w = self.M(r)
        return w, all_sum(mesh_of(self.op), torch.sum(r * w))[0]

    def iteration(self, state: CGState, u_true=None) -> CGState:
        """One fused iteration; ``state.z`` holds z_{k−1} (the direction
        update is deferred into K1/K2, where β is known)."""
        mesh = mesh_of(self.op)
        pcg = self.M is not None
        if state.k == 0:
            beta = torch.zeros((), dtype=state.r.dtype, device=state.r.device)
        elif pcg:
            beta = (state.rz / state.rz_prev).to(state.r.dtype)
        else:
            beta = (state.r_norm2 / state.rz).to(state.r.dtype)
        # PCG: K1 forms z_k from w (in d's slot); its (w, z_k) dot is not the PCG rz
        side, rz_p, azz_p, zmax_p, halo = self._k1(state.w if pcg else state.r, state.z, beta)
        if pcg:
            rz = state.rz
            (azz,) = all_sum(mesh, torch.sum(azz_p))
        else:
            rz, azz = all_sum(mesh, torch.sum(rz_p), torch.sum(azz_p))
        alpha = rz / azz
        outs = self._k2(state, side, halo, torch.stack([alpha, beta]), u_true)
        xn, rn, zk, r2_p, rmax_p = outs[:5]
        (r2,) = all_sum(mesh, torch.sum(r2_p))
        zmax, r_max, err = all_max(mesh, torch.amax(zmax_p), torch.amax(rmax_p),
                                   _err_max(outs, rn))
        s = state._replace(x=xn, r=rn, z=zk, k=state.k + 1, rz=rz, r_norm2=r2,
                           prec_max=torch.abs(alpha) * zmax, r_max=r_max, err_max=err)
        if pcg:
            wn, rz_new = self.precondition(rn)
            s = s._replace(w=wn, rz=rz_new, rz_prev=state.rz)
        return s

    def step(self, stop: StopConfig, state: CGState, u_true=None) -> CGState:
        """One iteration plus the stop flags of the JAX package's fused chunk
        (DIVERGED, PRECISION, RESIDUAL, EXACT_ERROR, RELATIVE_RESIDUAL in
        that priority), evaluated on the device."""
        s = self.iteration(state, u_true)
        done, reason = stop_reason(stop, s.prec_max, s.r_max, s.err_max, s.r_norm2,
                                   s.r0_norm, u_true is not None)
        return s._replace(done=done, reason=reason)


def _engine_for(op: PaddedStencilOperator, M) -> FusedCGEngine:
    """The engine for an (operator, preconditioner) pair. The JAX package
    memoises this to hit its compile cache; eager PyTorch has none to hit."""
    return FusedCGEngine(op, M)


def run_fused_solve(engine: FusedCGEngine, b: torch.Tensor, u_true, opts: CGOptions, *, lay,
                    unlay) -> CGResult:
    """The driver of the single-device and the mesh fused solves (the JAX
    package's ``_run_fused_solve``): the state init (z_prev convention,
    PCG carries z_0 = w_0 = M r_0), the CG loop with the fused-chunk stop
    rules, in one place so the twins cannot drift. ``lay`` maps an unpadded
    full-grid field onto the engine's layout (``op.pad``, or ``op.shard``
    over a mesh), ``unlay`` the iterate back (crop; gather and crop)."""
    if opts.beta_kind != "msg":
        raise ValueError("fused engine implements the MSG recurrence only")
    M = opts.preconditioner
    mesh = mesh_of(engine.op)
    f32 = torch.float32
    bp = lay(b.to(f32))
    up = lay(u_true.to(f32)) if u_true is not None else None
    dev = bp.device
    inf = torch.full((), float("inf"), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    (r2_0,) = all_sum(mesh, torch.sum(bp * bp))
    w0, rz0 = engine.precondition(bp) if M is not None else (None, None)
    r_max, err_max = all_max(mesh, torch.max(torch.abs(bp)),
                             torch.max(torch.abs(up)) if up is not None else inf)
    state = CGState(
        x=torch.zeros_like(bp), r=bp, z=torch.zeros_like(bp), k=0,
        done=torch.zeros((), dtype=torch.bool, device=dev),
        reason=torch.full((), int(StopReason.ITERATIONS), dtype=torch.int32, device=dev),
        rz=rz0 if rz0 is not None else one, r_norm2=r2_0, prec_max=inf,
        r_max=r_max, err_max=err_max,
        r0_norm=torch.sqrt(r2_0), w=w0, rz_prev=one if M is not None else None,
    )
    stop = opts.stop
    fused = dataclasses.replace(opts, step_fn=lambda s, u: engine.step(stop, s, u))
    res = cg_solve(None, bp, u_true=up, options=fused, init_state=state)
    res.x = unlay(res.x)
    return res


def fused_cg_solve(
    op: PaddedStencilOperator,
    b: torch.Tensor,
    *,
    u_true: Optional[torch.Tensor] = None,
    options: Optional[CGOptions] = None,
) -> CGResult:
    """Solve with the fused engine (f32). ``b``/``u_true`` are unpadded
    full-grid fields; the returned ``x`` is cropped back to the grid shape.
    With ``options.preconditioner`` the engine runs PCG (z_0 = w_0 = M r_0)."""
    opts = options or CGOptions()
    return run_fused_solve(_engine_for(op, opts.preconditioner), b, u_true, opts, lay=op.pad,
                           unlay=op.crop)

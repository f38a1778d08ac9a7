"""Mesh-sharded fused CG/PCG engine: the two-kernel iteration per block
(counterpart of the JAX package's parallel/cg_fused_sharded.py).

The single-device engine (``kernels/cg_fused.py``: K1, then K2 or K2-pcg)
runs on each rank's block of the sharded operator's padded layout:

- **D5**, :func:`k1_block` (CUDA ``ist_k1_block``, ``csrc/cg_fused_sharded.cu``;
  replaces ``_make_k1_block`` / ``_k1_call``): z_k = d + β·z_prev and
  A z_k in registers, the block's side rows ``(g, 2, Wb)`` and its partials
  of (d, z_k), (A z_k, z_k) and ‖z_k‖∞.
- **D6**, :func:`k2_block` / :func:`k2_pcg_block` (``ist_k2_block``,
  ``ist_k2_pcg_block``; replace ``_make_k2_block`` / ``_k2_call``): x + α z_k,
  r − α A z_k and z_k into fresh buffers, partials of ‖r‖², ‖r‖∞ and, with a
  true solution, ‖x − u‖∞.

Each kernel is its single-device tile kernel (``csrc/cg_tiles.cuh``) on
the block as a canvas of its own, tiled by ``kernels.cg_fused.tile_grid``
on the block's shape, with one partial per tile (the plain versions: per
band). One exchange per iteration serves both kernels: the edge rows and
columns of d (r for MSG CG, w = M r for PCG) and z_prev, packed into four
ring messages. The tiles at the block's edges form z_k at a neighbour
node from those raw values by the expression the owning block uses, zero
off the canvas, so every node takes the single-device arithmetic: stitched
blocks equal K1 / K2 / K2-pcg bit for bit, edges included, and the
partials cover the whole block. The JAX package zeroes the wrapped lane in
its kernels and adds the edge-column terms at the jit level
(``cg_fused_sharded.py:299-345``); that fix-up has no counterpart here.
D6 takes its halo rows from D5's side rows and its neighbour columns from
D5's exchange (d and z_prev do not change in between).

Every scalar is all-reduced over the mesh (``all_sum``/``all_max``, one
call per group), so every rank takes the same stop decision; the partials
are reduced in a fixed order first, with no float atomics. On a CPU tensor
each wrapper runs its plain torch version (``*_plain``), on a CUDA tensor
its kernel (f32); any other device raises. Nothing is memoised: eager
PyTorch has no compile cache to hit (``kernels/cg_fused._engine_for``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from iterative_solvers_tpu_torch.kernels import _build
from iterative_solvers_tpu_torch.kernels.cg_fused import (
    FusedCGEngine,
    _scalar,
    run_fused_solve,
    stencil_banded,
    tile_grid,
)
from iterative_solvers_tpu_torch.kernels.stencil_layout import check_aligned, check_field
from iterative_solvers_tpu_torch.parallel.halo_pallas import ShardedPallasStencilOperator
from iterative_solvers_tpu_torch.parallel.mesh import ring_take
from iterative_solvers_tpu_torch.solvers.cg import CGOptions, CGResult


def _neighbour_zk(op, left, right, beta):
    """z_k at the block's neighbour columns from their (d, z_prev) halos,
    zero where the column lies off the canvas (the single-device kernels'
    zero padding)."""
    _, wb = op.block_shape
    c0 = op.origin[1]
    zl = left[0] + beta * left[1]
    zr = right[0] + beta * right[1]
    if c0 == 0:
        zl = torch.zeros_like(zl)
    if c0 + wb >= op.padded_shape[1]:
        zr = torch.zeros_like(zr)
    return zl, zr


def k1_block_plain(d, zp, beta, up, dn, left, right, op: ShardedPallasStencilOperator):
    """D5's plain version: ``k1_plain``'s arithmetic on the block, its halo
    rows from ``up``/``dn`` and its neighbour columns from ``left``/``right``."""
    _build.note_plain("k1_block", d)
    (hb, wb), (r0, c0) = op.block_shape, op.origin
    by = op.block_rows
    g = hb // by
    mask = op.block_spec().build(d.device)
    zk = d + beta * zp
    # the rows -1 .. hb of z_k, masked by their own row (the bands' halo rows)
    rows = torch.cat([(up[0] + beta * up[1])[None], zk, (dn[0] + beta * dn[1])[None]])
    rmask = op.block_spec((hb + 2, wb), (r0 - 1, c0)).build(d.device)
    rows = torch.where(rmask, rows, 0.0)
    up_r, dn_r = rows[0:hb:by], rows[by + 1::by]
    side = torch.stack([up_r, dn_r], dim=1)
    az = stencil_banded(zk, up_r, dn_r, mask, op.coeffs, by,
                        *_neighbour_zk(op, left, right, beta))
    rz_p = (d * zk).view(g, -1).sum(1)
    azz_p = (az * zk).view(g, -1).sum(1)
    zmax_p = zk.abs().view(g, -1).amax(1)
    return side, rz_p, azz_p, zmax_p


def _k2_block_plain(name, x, r, zp, d, side, left, right, scal, u, op):
    """D6's plain version (``d`` = r for MSG, w for PCG): ``_k2_plain``'s
    arithmetic on the block with its neighbour columns."""
    _build.note_plain(name, x)
    hb, _ = op.block_shape
    g = hb // op.block_rows
    alpha, beta = scal[0], scal[1]
    mask = op.block_spec().build(x.device)
    zk = d + beta * zp
    az = stencil_banded(zk, side[:, 0], side[:, 1], mask, op.coeffs, op.block_rows,
                        *_neighbour_zk(op, left, right, beta))
    xn = x + alpha * zk
    rn = r - alpha * az
    out = (xn, rn, zk, (rn * rn).view(g, -1).sum(1), rn.abs().view(g, -1).amax(1))
    if u is not None:
        out += ((xn - u).abs().view(g, -1).amax(1),)
    return out


def k2_block_plain(x, r, zp, side, left, right, scal, op, u=None):
    return _k2_block_plain("k2_block", x, r, zp, r, side, left, right, scal, u, op)


def k2_pcg_block_plain(x, r, zp, w, side, left, right, scal, op, u=None):
    return _k2_block_plain("k2_pcg_block", x, r, zp, w, side, left, right, scal, u, op)


def _geometry(kernel: str, op: ShardedPallasStencilOperator, device):
    """(geometry arguments with the tile rows, partials per field) of D5
    (``kernel="k1"``) or D6 (``"k2"``): K1's or K2's tiles on the block."""
    (hb, wb), (r0, c0) = op.block_shape, op.origin
    tj, blocks = tile_grid(kernel, op.block_shape, op.block_rows, _build.sm_count(device))
    return (op.nx, op.ny, int(op.mask_mode == "gamma"), hb, wb, op.block_rows, tj, r0, c0,
            op.padded_shape[1]), blocks


def _check_halos(x, op, **halos):
    hb, wb = op.block_shape
    shapes = {"up": (2, wb), "dn": (2, wb), "left": (2, hb), "right": (2, hb)}
    for name, t in halos.items():
        check_field(name, t, shapes[name])
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, the block on {x.device}")


def k1_block(d, zp, beta, up, dn, left, right, op: ShardedPallasStencilOperator):
    """D5 on ``op``'s block: ``(side, rz_p, azz_p, zmax_p)`` for z_k = d +
    β z_prev; ``up``/``dn`` (2, Wb) the rows -1 / Hb and ``left``/``right``
    (2, Hb) the columns -1 / Wb of (d, z_prev), raw values; ``beta`` a
    0-dim float32 tensor on the block's device."""
    check_field("d", d, op.block_shape)
    check_field("z_prev", zp, op.block_shape)
    _scalar("beta", beta, d.device)
    up, dn, left, right = (t.contiguous() for t in (up, dn, left, right))
    _check_halos(d, op, up=up, dn=dn, left=left, right=right)
    if d.device.type == "cpu":
        return k1_block_plain(d, zp, beta, up, dn, left, right, op)
    check_aligned(d=d, z_prev=zp, up=up, dn=dn, left=left, right=right)
    hb, wb = op.block_shape
    side = torch.empty((hb // op.block_rows, 2, wb), dtype=d.dtype, device=d.device)
    geom, blocks = _geometry("k1", op, d.device)
    parts = torch.empty((3, blocks), dtype=d.dtype, device=d.device)
    p = _build.ptr
    _build.launch(
        "ist_k1_block", p(d), p(zp), p(beta.contiguous()), p(up), p(dn), p(left), p(right),
        p(side), p(parts[0]), p(parts[1]), p(parts[2]), *geom, *op.coeffs,
    )
    return side, parts[0], parts[1], parts[2]


def _k2_block(name, x, r, zp, w, side, left, right, scal, u, op):
    """Check D6's operands (``w`` None for MSG) and launch it on CUDA
    tensors, or run its plain version on CPU tensors."""
    hb, wb = op.block_shape
    for fname, t in (("x", x), ("r", r), ("z_prev", zp), ("w", w), ("u", u)):
        if t is not None:
            check_field(fname, t, op.block_shape)
            if t.device != x.device:
                raise ValueError(f"{fname}: expected a tensor on {x.device}")
    g = hb // op.block_rows
    check_field("side", side, (g, 2, wb))
    left, right = left.contiguous(), right.contiguous()
    _check_halos(x, op, left=left, right=right)
    if scal.dtype != torch.float32 or scal.shape != (2,) or scal.device != x.device:
        raise TypeError("scal: expected float32 [alpha, beta] on the fields' device")
    if x.device.type == "cpu":
        if w is None:
            return k2_block_plain(x, r, zp, side, left, right, scal, op, u)
        return k2_pcg_block_plain(x, r, zp, w, side, left, right, scal, op, u)
    check_aligned(x=x, r=r, z_prev=zp, w=w, u=u, side=side, left=left, right=right)
    xo, ro, zo = (torch.empty_like(x) for _ in range(3))
    geom, blocks = _geometry("k2", op, x.device)
    parts = torch.empty((3, blocks), dtype=x.dtype, device=x.device)
    p = _build.ptr
    dirs = (p(x), p(r), p(zp)) + (() if w is None else (p(w),))
    _build.launch(
        name, *dirs, p(left), p(right), p(side), p(scal.contiguous()), p(u), p(xo), p(ro),
        p(zo), p(parts[0]), p(parts[1]), p(parts[2]), *geom, *op.coeffs,
    )
    out = (xo, ro, zo, parts[0], parts[1])
    return out + ((parts[2],) if u is not None else ())


def k2_block(x, r, zp, side, left, right, scal, op, u=None):
    """D6 (MSG CG): ``(x', r', z_k, r2_p, rmax_p[, err_p])`` with z_k = r +
    β z_prev; ``side`` D5's side rows, ``left``/``right`` D5's column halos
    of (r, z_prev); ``scal`` = [α, β] (float32, on the fields' device)."""
    return _k2_block("ist_k2_block", x, r, zp, None, side, left, right, scal, u, op)


def k2_pcg_block(x, r, zp, w, side, left, right, scal, op, u=None):
    """D6 (PCG): as :func:`k2_block` with z_k = w + β z_prev; the column
    halos are those of (w, z_prev)."""
    return _k2_block("ist_k2_pcg_block", x, r, zp, w, side, left, right, scal, u, op)


def halos_from_global(op: ShardedPallasStencilOperator, d, zp):
    """(d block, z_prev block, up, dn, left, right) of ``op``'s block of
    two padded global fields, as :meth:`ShardedFusedCGEngine.exchange`
    delivers them (a block partition run in one process)."""
    (hb, wb), (r0, c0) = op.block_shape, op.origin
    rows, cols = range(r0, r0 + hb), range(c0, c0 + wb)

    def at(f, rr, cc):
        return ring_take(ring_take(f, rr, 0), cc, 1)

    def pair(rr, cc):
        return torch.stack([at(d, rr, cc), at(zp, rr, cc)]).reshape(2, -1)

    return (at(d, rows, cols), at(zp, rows, cols), pair([r0 - 1], cols), pair([r0 + hb], cols),
            pair(rows, [c0 - 1]), pair(rows, [c0 + wb]))


@dataclass(frozen=True, eq=False)
class ShardedFusedCGEngine(FusedCGEngine):
    """Drop-in for ``kernels/cg_fused.FusedCGEngine`` over a mesh: the same
    iteration (and ``step``) on this rank's block of ``op``'s layout, D5
    and D6 in place of K1 and K2, every scalar all-reduced. ``M``
    (optional) is a preconditioner on the same block layout
    (``ShardedFusedMultigrid``, whose ``call_with_dot`` all-reduces its dot;
    one without it gets the all-reduced (r, M r))."""

    op: ShardedPallasStencilOperator
    M: Optional[object] = None

    def exchange(self, d, zp):
        """The one halo exchange of an iteration: (up, dn, left, right),
        each the (d, z_prev) pair of one edge row or column."""
        return self.op.mesh.exchange([
            (torch.stack([d[-1], zp[-1]]), 0, 1), (torch.stack([d[0], zp[0]]), 0, -1),
            (torch.stack([d[:, -1], zp[:, -1]]), 1, 1), (torch.stack([d[:, 0], zp[:, 0]]), 1, -1),
        ])

    def _k1(self, d, zp, beta):
        up, dn, left, right = self.exchange(d, zp)
        return k1_block(d, zp, beta, up, dn, left, right, self.op) + ((left, right),)

    def _k2(self, s, side, halo, scal, u_true):
        if self.M is not None:
            return k2_pcg_block(s.x, s.r, s.z, s.w, side, *halo, scal, self.op, u_true)
        return k2_block(s.x, s.r, s.z, side, *halo, scal, self.op, u_true)


def sharded_fused_cg_solve(
    op: ShardedPallasStencilOperator,
    b: torch.Tensor,
    *,
    u_true: Optional[torch.Tensor] = None,
    options: Optional[CGOptions] = None,
) -> CGResult:
    """Solve over the mesh with the sharded fused engine (f32; cf.
    ``kernels/cg_fused.fused_cg_solve``). ``b``/``u_true`` are unpadded
    full-grid fields; the returned ``x`` is the whole field, gathered and
    cropped to the grid, on every rank."""
    opts = options or CGOptions()
    return run_fused_solve(ShardedFusedCGEngine(op, opts.preconditioner), b, u_true, opts,
                           lay=op.shard, unlay=lambda x: op.crop(op.mesh.gather(x)))

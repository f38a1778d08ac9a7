"""Mesh-sharded fused multigrid V-cycle: the sharded fast path's
preconditioner (counterpart of the JAX package's parallel/mg_sharded.py).

Each fused fine level runs its V-cycle legs per mesh block, as the
single-device legs' tiles (``csrc/mg_tiles.cuh``) on the block:

- **K_down** (D3, ``ist_k_down_block`` in ``csrc/mg_sharded.cu``): tiles of
  TJ coarse rows x 128 fine columns write the row-restricted residual
  (Hb/2, Wb). It needs a 2-row upper and 1-row lower halo of the level RHS
  ``b``, then the neighbour columns for the residual rows -1 .. Hb - 1:
  rows are exchanged first, then the edge columns with the received row -1
  in front (the corner rides along, as in the JAX package's
  corner-carrying exchange).
- **K_up** (D4, ``ist_k_up_block``): tiles of 2 TJ fine rows x 128 columns
  need 1-row halos of ``b`` and of the lane-prolonged coarse correction
  ``ec``, then the neighbour columns of ``b`` and of ``ec`` (with the
  received coarse row below: the corner), from which they form the
  corrected iterate at the neighbour column themselves.

The tiles at the block's first and last rows stage the exchanged rows, the
tiles at its x edges the exchanged columns; D3's last tile may be cut at
the block's edge, D4's tiles divide the block. Both kernels take their
single-device leg's arithmetic at every node (``csrc/common.cuh``), so a
V-cycle on blocks equals the single-device fused V-cycle level by level;
the JAX package's blocks differ from its own single-device legs by the
reassociation of their edge strips.

Between fused levels the lane (column) transfers change the padded width
from ``wp`` to the child's ``cw_pad``. The JAX package runs them, and the
coarse remainder below the fused levels, under GSPMD on global arrays.
Here they run on blocks (:func:`lane_restrict_block`,
:func:`lane_prolong_block`): each rank fetches from the ranks of its block
row only the columns its own output reads (:meth:`SolverMesh.fetch`, one
round of point-to-point messages a transfer) and applies the single-device
:func:`lane_restrict` / :func:`lane_prolong` rule to them, so a block
equals its slice of the single-device transfer bit for bit. The remainder
and the FMG run the plain hierarchy on blocks (``parallel/mg_blocks.py``:
:class:`BlockMultigrid`), which gathers only a field below its coarse
threshold and equals the single-device plain V-cycle bit for bit: JAX's
arithmetic exactly.

The kernels are f32-only; f64 fields (the escalated polish) take the plain
V-cycle on blocks, as the JAX package takes its jnp V-cycle.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import torch

from iterative_solvers_tpu_torch.core.domain import MaskSpec
from iterative_solvers_tpu_torch.kernels import _build
from iterative_solvers_tpu_torch.kernels.cg_fused import TW
from iterative_solvers_tpu_torch.kernels.mg_fused import tile_rows
from iterative_solvers_tpu_torch.kernels.stencil_layout import check_aligned, check_field, round_up
from iterative_solvers_tpu_torch.parallel.halo import apply5
from iterative_solvers_tpu_torch.parallel.halo_pallas import extended_mask
from iterative_solvers_tpu_torch.parallel.mesh import SolverMesh, all_sum, ring_take
from iterative_solvers_tpu_torch.parallel.mg_blocks import BlockMultigrid
from iterative_solvers_tpu_torch.solvers.multigrid import (
    MultigridPreconditioner,
    _coarsen_domain,
)


def lane_restrict_block(mesh: SolverMesh, rr: torch.Tensor, nx: int,
                        wc_pad: int) -> torch.Tensor:
    """:func:`~iterative_solvers_tpu_torch.kernels.mg_fused.lane_restrict`
    on blocks: ``rr`` is this rank's (rows, Wb) block of a field whose
    columns are split over the mesh's columns, the result its
    (rows, wc_pad / cols) block of ``lane_restrict(row, nx, wc_pad)`` on
    the whole block row, bit for bit. Coarse column c reads fine columns
    2c - 1 .. 2c + 1, so the coarse block ``[ci cwb, (ci + 1) cwb)`` reads
    fine ``[2 ci cwb - 1, 2 (ci + 1) cwb]``; fine columns below 0 and past
    ``nx`` read zero, coarse columns past ``nx // 2`` are zero."""
    wb, cols, ci = rr.shape[-1], mesh.cols, mesh.coords[1]
    cwb = wc_pad // cols
    old = [min(k * wb, nx + 1) for k in range(cols + 1)]  # the row's columns up to nx
    f = mesh.fetch(rr.narrow(-1, 0, old[ci + 1] - old[ci]), 1, old,
                   [(2 * k * cwb - 1, 2 * (k + 1) * cwb + 1) for k in range(cols)])
    lo, mid, hi = f[:, 0:2 * cwb:2], f[:, 1:2 * cwb:2], f[:, 2:2 * cwb + 1:2]
    out = 0.25 * (lo + hi) + 0.5 * mid
    out[:, max(nx // 2 + 1 - ci * cwb, 0):] = 0.0
    return out


def lane_prolong_block(mesh: SolverMesh, ec: torch.Tensor, cnx: int,
                       w_pad: int) -> torch.Tensor:
    """:func:`~iterative_solvers_tpu_torch.kernels.mg_fused.lane_prolong`
    on blocks: ``ec`` is this rank's (rows, cwb) block of a coarse field
    whose columns are split over the mesh's columns, the result its
    (rows, w_pad / cols) block of ``lane_prolong(row, cnx, w_pad)`` on the
    whole block row, bit for bit. Fine column j copies coarse column j / 2
    (j even) or averages (j - 1) / 2 and (j + 1) / 2 (j odd), so the fine
    block ``[ci wb, (ci + 1) wb)`` reads coarse ``[ci wb / 2, (ci + 1) wb / 2]``;
    coarse columns past ``cnx`` read zero, fine columns past ``2 cnx`` are
    zero."""
    cols, ci = mesh.cols, mesh.coords[1]
    wb = w_pad // cols
    h = wb // 2
    old = [min(k * ec.shape[-1], cnx + 1) for k in range(cols + 1)]  # coarse columns to cnx
    g = mesh.fetch(ec.narrow(-1, 0, old[ci + 1] - old[ci]), 1, old,
                   [(k * h, (k + 1) * h + 1) for k in range(cols)])
    left, right = g[:, :-1], g[:, 1:]
    out = torch.stack([left, 0.5 * (left + right)], dim=-1).reshape(g.shape[0], wb)
    out[:, max(2 * cnx + 1 - ci * wb, 0):] = 0.0
    return out


@dataclass(frozen=True, eq=False)
class _ShardedFusedLevel:
    """One shard-fused V-cycle level: the block kernels and their halos."""

    nx: int
    ny: int
    coeffs: Tuple[float, float, float]  # (cd, cx, cy)
    cs: float  # ω / diag
    mask_mode: str
    padded_shape: Tuple[int, int]  # (hp, wp) global
    block_shape: Tuple[int, int]  # (Hb, Wb) per rank
    by: int
    cw_pad: int  # the child level's padded column count

    @property
    def ch(self) -> int:
        return self.ny // 2 + 1

    def spec(self, origin) -> MaskSpec:
        return MaskSpec(self.mask_mode, self.nx, self.ny, tuple(self.block_shape),
                        origin=tuple(origin))

    def _geom(self, origin, tj):
        hb, wb = self.block_shape
        return (self.nx, self.ny, int(self.mask_mode == "gamma"), hb, wb, tj, origin[0],
                origin[1])

    # the legs' tile heights (kernels/mg_fused.tile_rows, as one device's
    # legs pick theirs) on a card of ``sm_count`` SMs: D3 TJ coarse rows
    # (16, 8 or 4; its last tile may be cut), D4 2 TJ fine rows (TJ 8 or 4,
    # dividing Hb: Hb % by == 0 and by >= 16 on every shard-fused level)
    def down_tile_rows(self, sm_count: int) -> int:
        hb, wb = self.block_shape
        return tile_rows(hb // 2, wb // TW, 1, 16, sm_count)

    def up_tile_rows(self, sm_count: int) -> int:
        hb, wb = self.block_shape
        return tile_rows(hb, wb // TW, 2, 8, sm_count)

    # --- D3 -----------------------------------------------------------------------

    def down_plain(self, b, up2, dn, left, right, origin) -> torch.Tensor:
        """D3's plain version: the residual rows -1 .. Hb - 1 of the
        pre-smoothed iterate on the extended block, row-restricted."""
        _build.note_plain("k_down_block", b)
        hb, wb = self.block_shape
        be = b.new_zeros((hb + 3, wb + 2))  # rows -2 .. hb, cols -1 .. wb
        be[2:-1, 1:-1] = b
        be[:2, 1:-1] = up2
        be[-1, 1:-1] = dn
        be[1:-1, 0] = left
        be[1:-1, -1] = right
        spec = self.spec(origin)
        me = MaskSpec(spec.kind, spec.nx, spec.ny, (hb + 3, wb + 2),
                      origin=(origin[0] - 2, origin[1] - 1)).build(b.device)
        bm = torch.where(me, be, 0.0)
        cd, cx, cy = self.coeffs
        R = torch.where(me[1:-1, 1:-1], bm[1:-1, 1:-1] - apply5(self.cs * bm, cd, cx, cy), 0.0)
        return 0.25 * R[0:-1:2] + 0.5 * R[1::2] + 0.25 * R[2::2]

    def down_block(self, b, up2, dn, left, right, origin) -> torch.Tensor:
        """D3 on one block: ``up2`` the rows -2, -1 (2, Wb), ``dn`` row Hb,
        ``left``/``right`` the columns -1 / Wb at rows -1 .. Hb - 1."""
        if b.device.type == "cpu":
            return self.down_plain(b, up2, dn, left, right, origin)
        hb, wb = self.block_shape
        up2, dn, left, right = (t.contiguous() for t in (up2, dn, left, right))
        for name, t, shape in (("b", b, (hb, wb)), ("up2", up2, (2, wb)), ("dn", dn, (wb,)),
                               ("left", left, (hb + 1,)), ("right", right, (hb + 1,))):
            check_field(name, t, shape)
        rr = torch.empty((hb // 2, wb), dtype=b.dtype, device=b.device)
        check_aligned(b=b, up2=up2, dn=dn)
        tj = self.down_tile_rows(_build.sm_count(b.device))
        _build.launch("ist_k_down_block", *map(_build.ptr, (b, up2, dn, left, right, rr)),
                      *self._geom(origin, tj), *self.coeffs, self.cs)
        return rr

    def down_halos_from_global(self, b: torch.Tensor, origin):
        """(block, up2, dn, left, right) of D3's block at ``origin`` of the
        level's padded global RHS, as the exchanges deliver them."""
        (hb, wb), (r0, c0) = self.block_shape, origin
        cols = range(c0, c0 + wb)
        return (ring_take(ring_take(b, range(r0, r0 + hb), 0), cols, 1),
                ring_take(ring_take(b, [r0 - 2, r0 - 1], 0), cols, 1),
                ring_take(ring_take(b, [r0 + hb], 0), cols, 1)[0],
                ring_take(ring_take(b, range(r0 - 1, r0 + hb), 0), [c0 - 1], 1)[:, 0],
                ring_take(ring_take(b, range(r0 - 1, r0 + hb), 0), [c0 + wb], 1)[:, 0])

    def up_halos_from_global(self, b: torch.Tensor, ec: torch.Tensor, origin):
        """D4's operands (b, bup, bdn, bleft, bright, ec, ecup, ecdn,
        ecleft, ecright) for the block at ``origin``, from the level's
        padded global RHS and its (hp/2, wp) lane-prolonged correction."""
        (hb, wb), (r0, c0) = self.block_shape, origin
        g0, hc = r0 // 2, hb // 2
        rows, cols, crows = range(r0, r0 + hb), range(c0, c0 + wb), range(g0, g0 + hc + 1)

        def at(f, rr, cc):
            return ring_take(ring_take(f, rr, 0), cc, 1)

        return (at(b, rows, cols), at(b, [r0 - 1], cols)[0], at(b, [r0 + hb], cols)[0],
                at(b, rows, [c0 - 1])[:, 0], at(b, rows, [c0 + wb])[:, 0],
                at(ec, range(g0, g0 + hc), cols), at(ec, [g0 - 1], cols)[0],
                at(ec, [g0 + hc], cols)[0], at(ec, crows, [c0 - 1])[:, 0],
                at(ec, crows, [c0 + wb])[:, 0])

    def down(self, mesh: SolverMesh, b: torch.Tensor) -> torch.Tensor:
        """Row-restricted residual of this rank's block, (Hb/2, Wb)."""
        up2, dn = mesh.exchange([(b[-2:], 0, 1), (b[0], 0, -1)])
        left, right = mesh.exchange([
            (torch.cat([up2[-1, -1:], b[:, -1]]), 1, 1),
            (torch.cat([up2[-1, :1], b[:, 0]]), 1, -1),
        ])
        return self.down_block(b, up2, dn, left, right, mesh.block_origin(self.block_shape))

    # --- D4 -----------------------------------------------------------------------

    def up_plain(self, b, bup, bdn, bleft, bright, ec, ecup, ecdn, ecleft, ecright, origin,
                 with_dot=False):
        """D4's plain version: the corrected iterate on the extended block
        (``kernels/mg_fused.up_plain``'s arithmetic), one post-smoothing
        sweep; with ``with_dot`` also the block's (b, out) partial."""
        _build.note_plain("k_up_block", b)
        hb, wb = self.block_shape
        roff, coff = origin
        goff = roff // 2
        be = b.new_zeros((hb + 2, wb + 2))  # rows -1 .. hb, cols -1 .. wb
        be[1:-1, 1:-1] = b
        be[0, 1:-1] = bup
        be[-1, 1:-1] = bdn
        be[1:-1, 0] = bleft
        be[1:-1, -1] = bright
        ee = ec.new_zeros((hb // 2 + 2, wb + 2))  # coarse rows goff-1 .. goff+hb/2
        ee[1:-1, 1:-1] = ec
        ee[0, 1:-1] = ecup
        ee[-1, 1:-1] = ecdn
        ee[1:, 0] = ecleft
        ee[1:, -1] = ecright
        J = torch.arange(goff - 1, goff + hb // 2 + 1, device=b.device)
        ee = torch.where(((J >= 0) & (J < self.ch))[:, None], ee, 0.0)
        # fine rows roff-1 .. roff+hb: roff-1 odd, then even/odd pairs, hb even
        even = ee[1:]  # coarse goff .. goff+hb/2 at fine rows roff, roff+2, .., roff+hb
        odd = 0.5 * (ee[:-1] + ee[1:])  # fine rows roff-1, roff+1, .., roff+hb-1
        p = torch.stack([odd, even], dim=1).reshape(hb + 2, wb + 2)
        me = extended_mask(self.spec(origin), b.device)
        xc = torch.where(me, self.cs * be + p, 0.0)
        m = me[1:-1, 1:-1]
        bm = torch.where(m, b, 0.0)
        cd, cx, cy = self.coeffs
        R = torch.where(m, bm - apply5(xc, cd, cx, cy), 0.0)
        out = torch.where(m, xc[1:-1, 1:-1] + self.cs * R, 0.0)
        if with_dot:
            return out, torch.sum(bm * out)
        return out

    def up_block(self, b, bup, bdn, bleft, bright, ec, ecup, ecdn, ecleft, ecright, origin,
                 with_dot=False):
        """D4 on one block: ``b`` and its rows -1 / Hb and columns -1 / Wb
        (rows 0 .. Hb - 1); ``ec`` (Hb/2, Wb), the lane-prolonged coarse
        correction, and its coarse rows goff - 1 / goff + Hb/2 and columns
        -1 / Wb (coarse rows goff .. goff + Hb/2). With ``with_dot`` returns
        ``(out, the block's (b, out))``."""
        if b.device.type == "cpu":
            return self.up_plain(b, bup, bdn, bleft, bright, ec, ecup, ecdn, ecleft, ecright,
                                 origin, with_dot)
        hb, wb = self.block_shape
        bup, bdn, bleft, bright, ecup, ecdn, ecleft, ecright = (
            t.contiguous() for t in (bup, bdn, bleft, bright, ecup, ecdn, ecleft, ecright))
        for name, t, shape in (
                ("b", b, (hb, wb)), ("bup", bup, (wb,)), ("bdn", bdn, (wb,)),
                ("bleft", bleft, (hb,)), ("bright", bright, (hb,)), ("ec", ec, (hb // 2, wb)),
                ("ecup", ecup, (wb,)), ("ecdn", ecdn, (wb,)), ("ecleft", ecleft, (hb // 2 + 1,)),
                ("ecright", ecright, (hb // 2 + 1,))):
            check_field(name, t, shape)
        out = torch.empty_like(b)
        tj = self.up_tile_rows(_build.sm_count(b.device))
        dot_p = (torch.empty((hb // (2 * tj), wb // TW), dtype=b.dtype, device=b.device)
                 if with_dot else None)  # one partial a tile (they divide Hb)
        check_aligned(b=b, bup=bup, bdn=bdn, ec=ec, ecup=ecup, ecdn=ecdn)
        geom = self._geom(origin, tj)
        _build.launch(
            "ist_k_up_block",
            *map(_build.ptr, (b, bup, bdn, bleft, bright, ec, ecup, ecdn, ecleft, ecright, out,
                              dot_p)),
            *geom[:6], self.ch, *geom[6:], *self.coeffs, self.cs,
        )
        if with_dot:
            return out, torch.sum(dot_p)
        return out

    def up(self, mesh: SolverMesh, b: torch.Tensor, ec: torch.Tensor, with_dot=False):
        """Post-smoothed corrected iterate of this rank's block; with
        ``with_dot`` also the mesh-wide (b, out)."""
        bup, bdn, ecup, ecdn, bleft, bright = mesh.exchange([
            (b[-1], 0, 1), (b[0], 0, -1), (ec[-1], 0, 1), (ec[0], 0, -1),
            (b[:, -1], 1, 1), (b[:, 0], 1, -1),
        ])
        ecleft, ecright = mesh.exchange([
            (torch.cat([ec[:, -1], ecdn[-1:]]), 1, 1),
            (torch.cat([ec[:, 0], ecdn[:1]]), 1, -1),
        ])
        outs = self.up_block(b, bup, bdn, bleft, bright, ec, ecup, ecdn, ecleft, ecright,
                             mesh.block_origin(self.block_shape), with_dot)
        if not with_dot:
            return outs
        out, part = outs
        return out, all_sum(mesh, part)[0]


@dataclass(frozen=True, eq=False)
class ShardedFusedMultigrid:
    """V(1,1) multigrid preconditioner over mesh blocks, with shard-fused
    fine levels (D3, D4) and the plain V-cycle on blocks for the coarse
    remainder.

    Build it with :meth:`from_operator` on a
    :class:`~iterative_solvers_tpu_torch.parallel.halo_pallas.
    ShardedPallasStencilOperator`: the fine level takes the operator's
    padded layout, so the solvers' fields need no pad or crop. f32 fields
    take the fused path; others (the escalated f64 polish) the plain
    V-cycle on blocks."""

    mesh: SolverMesh
    levels: Tuple[_ShardedFusedLevel, ...]
    inner: MultigridPreconditioner  # the whole plain hierarchy (fuse=False)
    grid_shape: Tuple[int, int]
    child_dims: Tuple[Tuple[int, int], ...]  # (nx, ny) of each level's child

    nu_pre: int = 1
    nu_post: int = 1

    @staticmethod
    def from_operator(op, domain, *, omega: float = 0.8, nu_pre: int = 1, nu_post: int = 1,
                      fuse_min_extent: int = 512, device="cuda", **kwargs
                      ) -> "ShardedFusedMultigrid":
        """The hierarchy of ``domain`` on ``op``'s mesh and layout, built
        for ``device`` (the card by default; ``"cpu"`` for the plain
        versions). Levels fuse, as in the JAX package, while ``ny + 1 >=
        fuse_min_extent`` and the block tiles (``Hb % by == 0``, ``by >=
        16``, ``Wb % 128 == 0``)."""
        if nu_pre != nu_post:
            raise ValueError("nu_pre must equal nu_post (symmetric V-cycle)")
        mesh = op.mesh
        my, mx = mesh.rows, mesh.cols
        inner = MultigridPreconditioner.from_domain(
            domain, omega=omega, nu_pre=nu_pre, nu_post=nu_post, fuse=False,
            device=device, **kwargs)
        domains = [domain]
        for _ in range(len(inner.levels) - 1):
            domains.append(_coarsen_domain(domains[-1]))
        levels, child_dims = [], []
        hp, wp = op.padded_shape
        by = min(op.block_rows, 128)
        for li, d in enumerate(domains):
            hb = hp // my
            if not (nu_pre == 1 and li < len(domains) - 1 and d.ny + 1 >= fuse_min_extent
                    and by >= 16 and hb % by == 0 and (wp // mx) % 128 == 0 and hb % 2 == 0):
                break
            c = domains[li + 1]
            cw_pad = round_up(c.nx + 1, mx * 128)
            levels.append(_ShardedFusedLevel(
                nx=d.nx, ny=d.ny, coeffs=(d.coeff_diag, d.coeff_x, d.coeff_y),
                cs=omega / d.coeff_diag, mask_mode=d.shape, padded_shape=(hp, wp),
                block_shape=(hb, wp // mx), by=by, cw_pad=cw_pad,
            ))
            child_dims.append((c.nx, c.ny))
            hp, wp = hp // 2, cw_pad
            by //= 2
        return ShardedFusedMultigrid(
            mesh=mesh, levels=tuple(levels), inner=inner, grid_shape=tuple(domain.grid_shape),
            child_dims=tuple(child_dims),
            nu_pre=nu_pre, nu_post=nu_post,
        )

    @cached_property
    def _block_cycles(self) -> dict:
        return {}

    def _blocks(self, li: int) -> BlockMultigrid:
        """The plain hierarchy on blocks from inner level ``li``."""
        if li not in self._block_cycles:
            self._block_cycles[li] = BlockMultigrid(self.inner, self.mesh, li)
        return self._block_cycles[li]

    def _remainder(self, li: int, b: torch.Tensor) -> torch.Tensor:
        """The plain V-cycle from inner level ``li``, on blocks."""
        return self._blocks(li).vcycle(b)

    def _vc(self, li: int, b: torch.Tensor, with_dot: bool = False):
        if li == len(self.levels):
            return self._remainder(li, b)
        lev = self.levels[li]
        cnx, cny = self.child_dims[li]
        mesh = self.mesh
        rr = lev.down(mesh, b)  # (Hb/2, Wb) row-restricted residual
        rc = lane_restrict_block(mesh, rr, lev.nx, lev.cw_pad)
        origin = mesh.block_origin(rc.shape)
        child = MaskSpec(lev.mask_mode, cnx, cny, tuple(rc.shape), origin=origin)
        rc = torch.where(child.build(rc.device), rc, 0.0)
        ec = self._vc(li + 1, rc)
        ecl = lane_prolong_block(mesh, ec, lev.nx // 2, lev.padded_shape[1])
        return lev.up(mesh, b, ecl, with_dot=with_dot)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if not self.levels:
            # grid or mesh too small to shard-fuse a level: the plain cycle
            return self._remainder(0, r)
        if tuple(r.shape) != self.levels[0].block_shape:
            raise ValueError(f"block shape {tuple(r.shape)} != the fine level's block "
                             f"{self.levels[0].block_shape}")
        if r.dtype == torch.float32:
            return self._vc(0, r)
        return self._remainder(0, r)  # the escalated f64 polish

    def call_with_dot(self, r: torch.Tensor):
        """``(M r, (r, M r))`` with the dot fused into the finest K_up's
        epilogue and all-reduced over the mesh."""
        if not self.levels or r.dtype != torch.float32:
            w = self(r)
            return w, all_sum(self.mesh, torch.sum(r * w))[0]
        return self._vc(0, r, with_dot=True)

    def with_fmg(self, problem) -> "ShardedFusedMultigrid":
        """A copy whose plain hierarchy carries the FMG payload."""
        return dataclasses.replace(self, inner=self.inner.with_fmg(problem))

    def fmg(self, r: torch.Tensor, n_vcycles: int = 1) -> torch.Tensor:
        """FMG warm start on the mesh-padded layout: a one-off set-up pass
        of the plain hierarchy on blocks (the JAX package runs it under
        GSPMD on the global array, not on the shard-fused kernels)."""
        return self._blocks(0).fmg(r, n_vcycles)

    def fmg_stepwise(self, r: torch.Tensor, n_vcycles: int = 1, **kw) -> torch.Tensor:
        """:meth:`MultigridPreconditioner.fmg_stepwise` on blocks."""
        return self._blocks(0).fmg_stepwise(r, n_vcycles, **kw)

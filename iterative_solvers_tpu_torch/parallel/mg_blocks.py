"""The plain multigrid V-cycle and FMG on mesh blocks: each rank runs every
level on its own block, with one-node halos, and only a coarse field is
gathered (the counterpart of the JAX package's
``ShardedMultigridPreconditioner``, whose crop, cycle and pad GSPMD
partitions on global arrays).

:class:`BlockMultigrid` runs ``MultigridPreconditioner._vcycle``, ``fmg``
and ``fmg_stepwise`` of a plain hierarchy (``fuse=False``) with the same
torch operations in the same order at every node, so its result equals the
hierarchy's on the gathered field bit for bit, in f32 and in f64:

- the masked stencil (``_Level.apply``), the full-weighting restriction
  and the linear prolongation read the block grown by one node a side
  along the split dims (rows of the first field dim, columns of the last;
  a 3D field's middle dim stays whole): one round of
  :meth:`SolverMesh.exchange` with the face neighbours and, when both
  dims are split, the diagonal ones for the corners. So a V-cycle level
  costs four rounds, as the shard-fused legs' D3 and D4 do;
- the transfers run axis by axis in field-axis order on the grown block:
  the nodes past a face are restricted (or prolonged) along the earlier
  axes exactly as their owner does it;
- the level masks and the FMG payload (each rediscretised level's RHS and
  Dirichlet field) are evaluated on the block's own nodes
  (``Domain*.box_mask_spec``, ``PoissonProblem.rhs_field(box=)``), never on
  the whole grid.

**The per-level layout.** Coarse node j is fine node 2j, so a rank owns
the coarse nodes whose fine twins it owns: its range [a, b) of one level
gives [⌈a/2⌉, ⌈b/2⌉) on the next. The partition is set at the coarsest
level that runs on blocks (balanced: rank k of P starts at ⌊k·n/P⌋) and
doubled towards the fine level, so every level's blocks stay balanced.
The layout that the operators, the CG and the results see is the mesh
layout (uniform blocks padded at the high end, ``parallel/mesh.py``); a
call moves its field into the cycle's partition and back point to point
(:meth:`SolverMesh.repartition`), which carries the rows or columns by
which the two partitions differ, not the field.

**The coarse threshold.** A level runs on blocks while its extent along
every split axis of P > 1 ranks is at least :data:`MIN_BLOCK_NODES` (4)
nodes a rank. The first level below it, or the coarsest level when its
solve is the dense inverse, is gathered (:meth:`SolverMesh.gather`), and
the rest of the cycle runs on the whole field on every rank, as the
single-device hierarchy does; a Chebyshev coarsest level above the
threshold takes its Chebyshev steps on blocks. A mesh of one rank runs the
whole hierarchy on its one block, as before.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch.kernels.mg_fused3d import restrict_axis
from iterative_solvers_tpu_torch.parallel.mesh import SolverMesh
from iterative_solvers_tpu_torch.solvers.multigrid import (
    F32,
    MultigridPreconditioner,
    _CoarseSolveChebyshev,
    _Level,
    _prolong1d,
    prolong_linear,
    restrict_full_weighting,
)
from iterative_solvers_tpu_torch.solvers.precond import chebyshev_apply

# a level runs on blocks while every rank keeps at least this many nodes
# along each split axis; the first level below is gathered
MIN_BLOCK_NODES = 4


def split_dims(nd: int, mesh: SolverMesh) -> Tuple[Tuple[int, int, int], ...]:
    """(field dim, mesh axis, ranks) of each field dim split over more than
    one rank: the first dim over the row axes, the last over the columns."""
    return tuple((d, ax, p) for d, ax, p in ((0, 0, mesh.rows), (nd - 1, 1, mesh.cols))
                 if p > 1)


def _every_other(t: torch.Tensor, d: int, start: int, n: int) -> torch.Tensor:
    """Nodes start, start + 2, .., start + 2(n - 1) of ``t`` along ``d``."""
    return t.narrow(d, start, 2 * n - 1)[(slice(None),) * d + (slice(None, None, 2),)]


class _BlockLevel:
    """One level on this rank's block: its node range per field dim
    (``box``), its interior mask there, and the level's operators on it."""

    def __init__(self, mesh: SolverMesh, domain, level: _Level,
                 starts: Dict[int, Sequence[int]]):
        self.mesh, self.domain, self.level = mesh, domain, level
        self.starts = starts  # per split dim: the P + 1 global starts of the ranks' ranges
        self.axes = {d: ax for d, ax, _ in split_dims(len(domain.grid_shape), mesh)}
        self.box = tuple(
            (starts[d][mesh.coords[self.axes[d]]], starts[d][mesh.coords[self.axes[d]] + 1])
            if d in self.axes else (0, n)
            for d, n in enumerate(domain.grid_shape))
        self._masks: Dict[torch.device, torch.Tensor] = {}

    def interior(self, device) -> torch.Tensor:
        device = torch.device(device)
        m = self._masks.get(device)
        if m is None:
            m = self._masks[device] = self.domain.box_mask_spec(self.box).build(device).contiguous()
        return m

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.interior(x.device), x, 0.0)

    def grown(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` grown by one node a side along each split dim, holding the
        neighbours' nodes there, the corners too (one round: the face
        neighbours' and, with both dims split, the diagonal neighbours'
        messages), zero past the grid's edges."""
        dims = tuple(self.axes)

        def side(t, d, hi):  # the node layer at the block's low or high face
            return t.narrow(d, t.shape[d] - 1 if hi else 0, 1)

        # a message sent with step +1 arrives from the neighbour below: it
        # is this block's low side
        msgs = [(side(x, d, step > 0), self.axes[d], step) for d in dims for step in (1, -1)]
        if len(dims) == 2:
            msgs += [(side(side(x, dims[0], sr > 0), dims[1], sc > 0), None, (sr, sc))
                     for sr in (1, -1) for sc in (1, -1)]
        got = self.mesh.exchange(msgs)
        off = [(d, self.box[d][0] == 0, self.box[d][1] == self.domain.grid_shape[d])
               for d in dims]

        def keep(t, *edges):  # zero where the node lies past the grid's edge
            return torch.zeros_like(t) if any(edges) else t

        (r, r_lo, r_hi), rest = off[0], off[1:]
        e = torch.cat([keep(got[0], r_lo), x, keep(got[1], r_hi)], dim=r)
        if rest:
            (c, c_lo, c_hi), = rest
            (clo, chi, cc) = got[2], got[3], got[4:]  # cc: (+,+), (+,-), (-,+), (-,-)
            low = torch.cat([keep(cc[0], r_lo, c_lo), keep(clo, c_lo), keep(cc[2], r_hi, c_lo)], r)
            high = torch.cat([keep(cc[1], r_lo, c_hi), keep(chi, c_hi), keep(cc[3], r_hi, c_hi)], r)
            e = torch.cat([low, e, high], dim=c)
        return e

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``_Level.apply`` on the block: the zero-grown field carries the
        neighbours' nodes on the split faces."""
        m = self.interior(x.device)
        xm = torch.where(m, x, 0.0)
        p = self.grown(xm)
        if len(self.axes) < x.ndim:  # zeros past the faces of the dims not split
            p = F.pad(p, [w for d in reversed(range(x.ndim))
                          for w in ((0, 0) if d in self.axes else (1, 1))])
        return self.level.stencil(xm, p, m)

    def restrict(self, r: torch.Tensor, child: "_BlockLevel") -> torch.Tensor:
        """Full weighting onto ``child``'s block, axis by axis in field-axis
        order (``restrict_full_weighting``'s, ``restrict_axis``'s weights),
        on the grown block: the nodes past a face are restricted along the
        earlier axes as their owner restricts them."""
        e = self.grown(r)
        for d in range(r.ndim):
            if d not in self.axes:
                e = restrict_axis(e, d)
                continue
            (a, _), (ca, cb) = self.box[d], child.box[d]
            s, n = 2 * ca - a, cb - ca  # coarse j reads fine 2j - 1 .. 2j + 1
            e = 0.25 * (_every_other(e, d, s, n) + _every_other(e, d, s + 2, n)) \
                + 0.5 * _every_other(e, d, s + 1, n)
        return e

    def prolong(self, e: torch.Tensor, child: "_BlockLevel", whole: bool) -> torch.Tensor:
        """Linear interpolation of ``child``'s block field (of the child's
        whole field when ``whole``) onto this block, axis by axis in
        field-axis order (``prolong_linear``'s), from the child's block
        grown by one node a side."""
        if whole:  # the child's block, one node wider a side, cut from the whole field
            sl, pad = [slice(None)] * e.ndim, [0, 0] * e.ndim
            for d in self.axes:
                ca, cb = child.box[d]
                sl[d] = slice(max(ca - 1, 0), cb + 1)
                # a zero node past the grid's edges, as the exchange gives
                pad[2 * (e.ndim - 1 - d)] = int(ca == 0)
                pad[2 * (e.ndim - 1 - d) + 1] = int(cb == e.shape[d])
            e = F.pad(e[tuple(sl)], pad)
        else:
            e = child.grown(e)
        for d in range(e.ndim):
            if d not in self.axes:
                e = _prolong1d(e, d)
                continue
            (a, b), ca = self.box[d], child.box[d][0]
            e = _prolong1d(e, d).narrow(d, a - 2 * (ca - 1), b - a)
        return e

    @property
    def largest_block(self) -> Tuple[int, ...]:
        """The largest rank's block extent per field dim."""
        return tuple(max(b - a for a, b in zip(self.starts[d], self.starts[d][1:]))
                     if d in self.axes else n for d, n in enumerate(self.domain.grid_shape))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The level's whole field, on every rank: the blocks zero-padded to
        the largest, one all-gather (:meth:`SolverMesh.gather`), cut back."""
        big = self.largest_block
        pad = [w for d in reversed(range(x.ndim)) for w in (0, big[d] - x.shape[d])]
        g = self.mesh.gather(F.pad(x, pad))
        for d in self.axes:
            st = self.starts[d]
            idx = torch.cat([torch.arange(k * big[d], k * big[d] + st[k + 1] - st[k])
                             for k in range(len(st) - 1)]).to(g.device)
            g = g.index_select(d, idx)
        return g


class BlockMultigrid:
    """A plain hierarchy (``MultigridPreconditioner`` with ``fuse=False``)
    run on the blocks of ``mesh`` from its level ``first``. Its calls take
    and return this rank's block of a field on the mesh layout: uniform
    blocks of the level's grid, padded at the high end with zeros."""

    def __init__(self, inner: MultigridPreconditioner, mesh: SolverMesh, first: int = 0):
        if not all(isinstance(lev, _Level) for lev in inner.levels):
            raise ValueError("the block V-cycle runs the plain levels (fuse=False)")
        self.inner, self.mesh, self.first = inner, mesh, first
        doms = inner.domains
        L = len(doms)
        split = split_dims(len(doms[0].grid_shape), mesh)
        top = L if isinstance(inner.coarse_solve, _CoarseSolveChebyshev) else L - 1
        stop = first
        while mesh.distributed and stop < top and all(
                doms[stop].grid_shape[d] >= MIN_BLOCK_NODES * p for d, _, p in split):
            stop += 1
        self.stop = stop  # levels first .. stop - 1 on blocks; level stop whole
        self.levels: Dict[int, _BlockLevel] = {}
        if stop == first:
            return
        base = stop - 1
        for li in range(first, min(stop + 1, L)):
            starts = {}
            for d, _, p in split:
                t = [k * doms[base].grid_shape[d] // p for k in range(p)]
                st = [s << (base - li) for s in t] if li <= base else [-(-s // 2) for s in t]
                starts[d] = tuple(st) + (doms[li].grid_shape[d],)
            self.levels[li] = _BlockLevel(mesh, doms[li], inner.levels[li], starts)

    @property
    def gathered_shape(self):
        """The shape of the field a call gathers (:meth:`SolverMesh.gather`
        of level ``stop``'s blocks, each zero-padded to the largest); None
        when no level is gathered (a Chebyshev coarsest level on blocks) or
        when level ``first`` is below the threshold already (then the
        caller's blocks are gathered)."""
        lev = self.levels.get(self.stop)
        if lev is None:
            return None
        parts = {d: p for d, _, p in split_dims(len(lev.box), self.mesh)}
        return tuple(n * parts.get(d, 1) for d, n in enumerate(lev.largest_block))

    # --- the mesh layout <-> the cycle's partition ------------------------------

    @staticmethod
    def _mesh_starts(p: int, extent: int, n: int):
        """The mesh layout's P + 1 starts along a split dim: blocks of ``extent``
        nodes, cut at the grid's ``n``."""
        return tuple(min(k * extent, n) for k in range(p)) + (n,)

    def _to_blocks(self, r: torch.Tensor) -> torch.Tensor:
        lev = self.levels[self.first]
        grid = lev.domain.grid_shape
        x = r
        for d, n in enumerate(grid):
            if d not in lev.axes:
                x = x.narrow(d, 0, n)
        for d, ax, p in split_dims(r.ndim, self.mesh):
            old = self._mesh_starts(p, r.shape[d], grid[d])
            k = self.mesh.coords[ax]
            x = self.mesh.repartition(x.narrow(d, 0, old[k + 1] - old[k]), ax, old,
                                      lev.starts[d])
        return x

    def _from_blocks(self, x: torch.Tensor, shape) -> torch.Tensor:
        lev = self.levels[self.first]
        for d, ax, p in split_dims(x.ndim, self.mesh):
            x = self.mesh.repartition(
                x, ax, lev.starts[d], self._mesh_starts(p, shape[d], lev.domain.grid_shape[d]))
        return F.pad(x, [w for d in reversed(range(x.ndim)) for w in (0, shape[d] - x.shape[d])])

    def _whole(self, fn, r: torch.Tensor) -> torch.Tensor:
        """``fn`` on the gathered field (a hierarchy whose level ``first``
        is already below the threshold)."""
        return self.mesh.global_apply(fn, r, self.inner.domains[self.first].grid_shape)

    # --- level operations, on blocks above the threshold, whole below -----------

    def _apply(self, li: int, x: torch.Tensor) -> torch.Tensor:
        return self.levels[li].apply(x) if li < self.stop else self.inner._apply_at(li, x)

    def _mask(self, li: int, x: torch.Tensor) -> torch.Tensor:
        return self.levels[li].mask(x) if li < self.stop else self.inner.levels[li].mask(x)

    def _restrict(self, li: int, r: torch.Tensor) -> torch.Tensor:
        """Level ``li``'s residual onto level ``li + 1``, masked there."""
        if li >= self.stop:
            return self.inner.levels[li + 1].mask(restrict_full_weighting(r))
        child = self.levels[li + 1]
        rc = child.mask(self.levels[li].restrict(r, child))
        return child.gather(rc) if li + 1 == self.stop else rc

    def _prolong(self, li: int, e: torch.Tensor) -> torch.Tensor:
        if li >= self.stop:
            return prolong_linear(e)
        return self.levels[li].prolong(e, self.levels[li + 1], whole=li + 1 == self.stop)

    def _payload(self, li: int, field, device) -> torch.Tensor:
        """Level ``li``'s FMG payload ``field`` (a rediscretised problem's
        ``rhs_field`` or ``boundary_field``) in f32 on its block, or whole
        below the threshold."""
        return field(F32, device, box=self.levels[li].box if li < self.stop else None)

    def _vc(self, li: int, b: torch.Tensor) -> torch.Tensor:
        """``MultigridPreconditioner._vcycle`` from level ``li``."""
        inner = self.inner
        if li >= self.stop:
            return inner._vcycle(li, b)
        lev = self.levels[li]
        if li == len(inner.levels) - 1:  # a Chebyshev coarsest level on blocks
            cs = inner.coarse_solve
            return lev.mask(chebyshev_apply(lev.apply, b, cs.lam_lo, cs.lam_hi, cs.degree))
        w = lev.level.omega_over_diag
        x = w * b
        for _ in range(inner.nu_pre - 1):
            x = x + w * (b - lev.apply(x))
        r = b - lev.apply(x)
        ec = self._vc(li + 1, self._restrict(li, r))
        x = x + lev.mask(self._prolong(li, ec))
        for _ in range(inner.nu_post):
            x = x + w * (b - lev.apply(x))
        return x

    # --- the calls --------------------------------------------------------------

    def vcycle(self, r: torch.Tensor) -> torch.Tensor:
        """One V-cycle from level ``first`` on this rank's block ``r``."""
        if self.stop == self.first:
            return self._whole(lambda g: self.inner._vcycle(self.first, g), r)
        return self._from_blocks(self._vc(self.first, self._to_blocks(r)), r.shape)

    def fmg(self, r: torch.Tensor, n_vcycles: int = 1) -> torch.Tensor:
        """:meth:`MultigridPreconditioner.fmg` (``first`` is 0)."""
        inner = self.inner
        if self.stop == 0:
            return self._whole(lambda g: inner.fmg(g, n_vcycles), r)
        b = self._to_blocks(r)
        L = len(inner.levels)
        if inner.fmg_data is None:
            bs = [b]
            for li in range(L - 1):
                bs.append(self._restrict(li, bs[-1]))
            gs = [None] * L
        else:
            bs = [b] + [self._payload(li, p.rhs_field, b.device).to(b.dtype)
                        for li, p in enumerate(inner.fmg_data) if li]
            gs = [None] + [self._payload(li, p.boundary_field, b.device).to(b.dtype)
                           for li, p in enumerate(inner.fmg_data) if li]
        x = self._vc(L - 1, bs[-1])
        for li in range(L - 2, -1, -1):
            if gs[li + 1] is not None:
                x = x + gs[li + 1]
            x = self._mask(li, self._prolong(li, x))
            for _ in range(n_vcycles):
                x = x + self._vc(li, bs[li] - self._apply(li, x))
        return self._from_blocks(x, r.shape)

    def fmg_stepwise(self, r: torch.Tensor, n_vcycles: int = 1, polish_max_extent=None,
                     smooth_sweeps: int = 4) -> torch.Tensor:
        """:meth:`MultigridPreconditioner.fmg_stepwise` (``first`` is 0)."""
        inner = self.inner
        data = inner.fmg_data
        if data is None:
            raise ValueError("fmg_stepwise requires the with_fmg payload")
        if self.stop == 0:
            return self._whole(lambda g: inner.fmg_stepwise(
                g, n_vcycles, polish_max_extent=polish_max_extent,
                smooth_sweeps=smooth_sweeps), r)
        b = self._to_blocks(r)
        L = len(inner.levels)
        p = data[-1]
        x = self._vc(L - 1, b.to(F32) if p is None else
                     self._payload(L - 1, p.rhs_field, b.device))
        for li in range(L - 2, -1, -1):
            nv = int(n_vcycles)
            if polish_max_extent is not None and max(inner.domains[li].grid_shape) > \
                    polish_max_extent:
                nv = 0
            x = x + self._payload(li + 1, data[li + 1].boundary_field, b.device).to(x.dtype)
            bl = b.to(F32) if li == 0 else self._payload(li, data[li].rhs_field, b.device)
            x = self._mask(li, self._prolong(li, x))
            if nv > 0:
                for _ in range(nv):
                    x = x + self._vc(li, bl - self._apply(li, x))
            else:
                w = inner.levels[li].omega_over_diag
                for _ in range(int(smooth_sweeps)):
                    x = x + w * (bl - self._apply(li, x))
        return self._from_blocks(x, r.shape)

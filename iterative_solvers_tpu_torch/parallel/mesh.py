"""Solver meshes over ``torch.distributed`` ranks and the block partition of
global fields (counterpart of the JAX package's parallel/mesh.py).

The JAX package names the devices of one program (a ``jax.sharding.Mesh``)
and keeps each field as one global array that GSPMD partitions. Here every
block of the mesh is a process (a rank of the default ``torch.distributed``
process group) that holds its own block of each field as a plain tensor. A
:class:`SolverMesh` names the axes, knows its rank's place and carries the
collectives the solvers need:

- :meth:`SolverMesh.exchange`: the ring halo exchange of the stencils, the
  counterpart of ``lax.ppermute`` on the ring pairs ``_fwd``/``_bwd``
  (``parallel/halo.py:37-44``). On a 1-wide axis a rank is its own
  neighbour: the message is a local copy. On a 2-wide axis both neighbours
  are one rank: the two messages are told apart by their tags.
- :func:`all_sum` and :func:`all_max`: the reductions of the CG and the
  refinement loops over sharded fields. Every rank gets the same bits, so
  every stop decision taken from them takes the same branch on every rank.
- :meth:`SolverMesh.repartition`: a field moved point to point from one
  partition of an axis into another (the block multigrid's own per-level
  layout, ``parallel/mg_blocks.py``), and :meth:`SolverMesh.fetch`: each
  rank's window of such a field, windows that may overlap and reach past
  the field (the shard-fused V-cycle's lane transfers,
  ``parallel/mg_sharded.py``).
- :meth:`SolverMesh.gather`: a global field from the blocks, on every rank
  (the results, and the coarse field below the block multigrid's
  threshold).

Layout, as in the JAX package: the first field dim (rows, or z-planes in
3D) is split over every mesh axis but the last, the last dim (columns) over
the last axis, and a 3D field's middle dim stays whole. Rank ``r`` holds
block ``(r // cols, r % cols)``, the order of ``np.reshape`` over a device
list. Grids that do not divide are padded at the high end with exterior
nodes (never interior), so padding is inert.

Transport: a mesh of one rank has no peer (exchanges are copies, reductions
identities). With ``nccl`` the collectives take the blocks' CUDA tensors.
``gloo`` takes CPU tensors only, so a CUDA block in a ``gloo`` group is
staged through host memory (``transport`` says which).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F


def _near_square_factors(n: int) -> Tuple[int, int]:
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return (n // a, a)  # rows >= cols


class SolverMesh:
    """Named axes over the ranks of the default process group, one rank
    per block; ``distributed`` is False for a mesh of one rank."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], rank: int = 0,
                 distributed: bool = False):
        if len(axis_names) != len(shape) or len(shape) < 2:
            raise ValueError("solver meshes need >= 2 named axes (rows, cols) — "
                             "use make_solver_mesh/make_hybrid_mesh")
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.rank = int(rank)
        self.distributed = bool(distributed)

    def __repr__(self) -> str:
        return (f"SolverMesh({dict(zip(self.axis_names, self.shape))}, rank={self.rank}, "
                f"transport={self.transport()!r})")

    @property
    def rows(self) -> int:
        """Blocks along the row (first field) dim: every axis but the last."""
        return math.prod(self.shape[:-1])

    @property
    def cols(self) -> int:
        return self.shape[-1]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's (block row, block column)."""
        return divmod(self.rank, self.cols)

    def transport(self, device=None) -> str:
        """What carries the halos and reductions of blocks on ``device``:
        ``local`` (one rank), ``nccl``, ``gloo`` (CPU blocks) or
        ``gloo-host`` (CUDA blocks staged through host memory)."""
        if not self.distributed:
            return "local"
        backend = str(dist.get_backend())
        if backend == "gloo" and device is not None and torch.device(device).type == "cuda":
            return "gloo-host"
        return backend

    def peer(self, axis: Optional[int], step) -> int:
        """The rank ``step`` blocks away along ``axis`` (0: rows, 1: cols;
        None: ``step`` is a (rows, cols) pair, a diagonal neighbour), on the
        ring (the wrapped halo is zeroed by the receiver's mask)."""
        ri, ci = self.coords
        dr, dc = step if axis is None else ((step, 0) if axis == 0 else (0, step))
        return (ri + dr) % self.rows * self.cols + (ci + dc) % self.cols

    # --- collectives ------------------------------------------------------------

    def exchange(self, msgs: Sequence[Tuple[torch.Tensor, Optional[int], object]]
                 ) -> List[torch.Tensor]:
        """One round of ring messages ``(tensor, axis, step)``: each rank
        sends ``tensor`` to ``peer(axis, step)`` and receives the tensor of
        ``peer(axis, -step)`` (both components negated for a diagonal
        step), of the same shape. Returns the received tensors, on the
        senders' device. All ranks must pass the same list of shapes."""
        out: List[Optional[torch.Tensor]] = [None] * len(msgs)
        device = msgs[0][0].device if msgs else None
        staged = self.transport(device) == "gloo-host"
        sent = []  # (slot, tensor, destination, source)
        for k, (t, axis, step) in enumerate(msgs):
            back = tuple(-s for s in step) if axis is None else -step
            dst, src = self.peer(axis, step), self.peer(axis, back)
            if dst == self.rank:  # a 1-wide axis: the neighbour is this rank
                out[k] = t.clone()
            else:
                sent.append((k, t.contiguous(), dst, src))
        sends = [t for _, t, _, _ in sent]
        ops = []
        for (k, _, dst, src), send in zip(sent, _to_host(sends) if staged else sends):
            out[k] = torch.empty_like(send)
            ops += [dist.P2POp(dist.isend, send, dst, tag=k),
                    dist.P2POp(dist.irecv, out[k], src, tag=k)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if staged:
            for k, t in zip([k for k, *_ in sent], _to_device([out[k] for k, *_ in sent], device)):
                out[k] = t
        return out

    def _all_reduce(self, ts, op) -> Tuple[torch.Tensor, ...]:
        v = torch.stack([t.reshape(()) for t in ts])
        staged = self.transport(v.device) == "gloo-host"
        w = v.cpu() if staged else v
        dist.all_reduce(w, op=op)
        return tuple((w.to(v.device) if staged else w).unbind())

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The global field from every rank's block, on every rank: blocks
        placed by their (row, col) coordinates along the first and last
        dims."""
        if not self.distributed:
            return block
        staged = self.transport(block.device) == "gloo-host"
        send = block.contiguous().cpu() if staged else block.contiguous()
        parts = [torch.empty_like(send) for _ in range(self.size)]
        dist.all_gather(parts, send)
        rows = [torch.cat(parts[r * self.cols:(r + 1) * self.cols], dim=-1)
                for r in range(self.rows)]
        out = torch.cat(rows, dim=0)
        return out.to(block.device) if staged else out

    def repartition(self, block: torch.Tensor, axis: int, old: Sequence[int],
                    new: Sequence[int]) -> torch.Tensor:
        """Move a field split along ``axis`` (0: the first field dim over
        the row axes, 1: the last dim over the columns) from one partition
        to another. ``old`` and ``new`` are the ``P + 1`` global starts of
        the ``P`` ranks' ranges along the axis (the last one the extent),
        the same on every rank; ``block`` holds this rank's range of
        ``old``, and the result its range of ``new``. Each rank sends each
        rank of its line the part of its old range that lies in that rank's
        new range (point to point: nothing is gathered)."""
        return self._move(block, axis, old, list(zip(new[:-1], new[1:])))

    def fetch(self, block: torch.Tensor, axis: int, old: Sequence[int],
              windows: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """This rank's window of a field split along ``axis`` as in
        :meth:`repartition`: ``windows`` holds each rank's global
        ``(start, stop)`` along the axis, the same on every rank; windows
        may overlap and reach past the field, which reads zero outside
        ``[0, old[-1])``. One round of point-to-point messages within the
        line: each rank receives only the parts of its window that other
        ranks hold."""
        return self._move(block, axis, old, windows)

    def _move(self, block, axis, old, windows) -> torch.Tensor:
        parts = self.rows if axis == 0 else self.cols
        d = 0 if axis == 0 else block.ndim - 1
        ri, ci = self.coords
        me = self.coords[axis]
        lo, hi = windows[me]
        if parts == 1 and (lo, hi) == (0, old[-1]):
            return block  # the whole line on this rank: nothing moves

        def rank_of(p):
            return p * self.cols + ci if axis == 0 else ri * self.cols + p

        def overlap(a, b):  # rank a's old range within rank b's window
            start, stop = max(old[a], windows[b][0]), min(old[a + 1], windows[b][1])
            return (start, stop) if stop > start else None

        def fresh(n, device, zero=False):  # a piece of n nodes along the axis
            shape = list(block.shape)
            shape[d] = n
            return (torch.zeros if zero else torch.empty)(shape, dtype=block.dtype,
                                                          device=device)

        staged = self.transport(block.device) == "gloo-host"
        sends, dsts, pieces, recvs = [], [], [], []
        if lo < 0:  # the window's part below the field
            pieces.append(fresh(min(hi, 0) - lo, block.device, zero=True))
        for p in range(parts):
            mine, theirs = overlap(me, p), overlap(p, me)
            if mine is not None and p != me:
                sends.append(block.narrow(d, mine[0] - old[me], mine[1] - mine[0]).contiguous())
                dsts.append(rank_of(p))
            if theirs is None:
                continue
            if p == me:
                pieces.append(block.narrow(d, theirs[0] - old[me], theirs[1] - theirs[0]))
                continue
            recvs.append((len(pieces), rank_of(p)))
            pieces.append(fresh(theirs[1] - theirs[0], "cpu" if staged else block.device))
        if hi > max(lo, old[-1]):  # and above it
            pieces.append(fresh(hi - max(lo, old[-1]), block.device, zero=True))
        ops = [dist.P2POp(dist.isend, t, dst)
               for t, dst in zip(_to_host(sends) if staged else sends, dsts)]
        ops += [dist.P2POp(dist.irecv, pieces[i], src) for i, src in recvs]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if staged:
            for (i, _), t in zip(recvs, _to_device([pieces[i] for i, _ in recvs], block.device)):
                pieces[i] = t
        if not pieces:  # an empty range (a block of padding only)
            return block.narrow(d, 0, 0)
        return torch.cat(pieces, dim=d)

    # --- blocks of global fields -----------------------------------------------

    def block_shape(self, padded_shape: Sequence[int]) -> Tuple[int, ...]:
        p = tuple(padded_shape)
        if p[0] % self.rows or p[-1] % self.cols:
            raise ValueError(f"padded shape {p} does not split over mesh {self.shape}")
        return (p[0] // self.rows,) + p[1:-1] + (p[-1] // self.cols,)

    def block_origin(self, block_shape: Sequence[int]) -> Tuple[int, ...]:
        """Global index of this rank's first node per field dim."""
        ri, ci = self.coords
        b = tuple(block_shape)
        return (ri * b[0],) + (0,) * (len(b) - 2) + (ci * b[-1],)

    def take_block(self, field: torch.Tensor, block_shape: Sequence[int]) -> torch.Tensor:
        """This rank's block of a global (padded) field, as its own tensor."""
        org = self.block_origin(block_shape)
        sl = tuple(slice(o, o + s) for o, s in zip(org, block_shape))
        return field[sl].clone()

    def global_apply(self, fn, block: torch.Tensor, grid_shape: Sequence[int]) -> torch.Tensor:
        """``fn`` on the cropped global field: gather the blocks, crop to
        ``grid_shape``, apply, pad back and take this rank's block. The
        block multigrid (``parallel/mg_blocks.py``) calls it only for a
        hierarchy whose first level is already below its coarse threshold,
        or on a mesh of one rank, where the gather is the block itself."""
        g = self.gather(block)
        sl = tuple(slice(0, s) for s in grid_shape)
        out = fn(g[sl])
        pad = []
        for p, s in zip(reversed(g.shape), reversed(tuple(grid_shape))):
            pad += [0, p - s]
        return self.take_block(F.pad(out, pad), block.shape)


def _to_host(ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Card tensors (one dtype) as host tensors through one copy: each copy
    waits for the card, so a round of messages waits once, not once a
    message."""
    if not ts:
        return []
    if len({t.dtype for t in ts}) > 1:
        raise ValueError("one round of staged messages takes one dtype")
    flat = torch.cat([t.reshape(-1) for t in ts]).cpu()
    return [f.view(t.shape) for f, t in zip(flat.split([t.numel() for t in ts]), ts)]


def _to_device(ts: Sequence[torch.Tensor], device) -> List[torch.Tensor]:
    """Host tensors (one dtype) on ``device`` through one copy."""
    if not ts:
        return []
    flat = torch.cat([t.reshape(-1) for t in ts]).to(device)
    return [f.view(t.shape) for f, t in zip(flat.split([t.numel() for t in ts]), ts)]


def ring_take(field: torch.Tensor, index, dim: int) -> torch.Tensor:
    """``field`` at indices ``index`` (a range, list or 1D tensor) along
    ``dim``, taken modulo its extent: the values a ring exchange delivers,
    wrap-around included. Builds a block's halo operands from a global
    field (a block partition run in one process, as ``chip_smoke.py`` and
    the tests hold the block kernels against the single-device ones)."""
    idx = torch.as_tensor(list(index), device=field.device) % field.shape[dim]
    return field.index_select(dim, idx)


def all_sum(mesh: Optional[SolverMesh], *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The mesh-wide sums of 0-dim partials (one all-reduce); without a
    mesh, or on one rank, the partials themselves."""
    if mesh is None or not mesh.distributed:
        return ts
    return mesh._all_reduce(ts, dist.ReduceOp.SUM)


def all_max(mesh: Optional[SolverMesh], *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The mesh-wide maxima of 0-dim partials (one all-reduce)."""
    if mesh is None or not mesh.distributed:
        return ts
    return mesh._all_reduce(ts, dist.ReduceOp.MAX)


def mesh_of(op) -> Optional[SolverMesh]:
    """The mesh a sharded operator runs on, None for a single-device one."""
    return getattr(op, "mesh", None)


def make_solver_mesh(n_devices: Optional[int] = None, shape: Optional[Tuple[int, int]] = None,
                     axis_names: Tuple[str, str] = ("y", "x")) -> SolverMesh:
    """A 2D (rows, cols) mesh over the ranks of the default process group
    (its world size by default; one rank, no group needed, for
    ``n_devices=1``). The default shape is near-square, rows >= cols — halo
    bytes scale with the block perimeter."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if shape is None:
        shape = _near_square_factors(n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return _mesh_over(n, shape, axis_names)


def _mesh_over(n: int, shape, axis_names) -> SolverMesh:
    if n == 1:
        return SolverMesh(axis_names, shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(
            f"a mesh of {n} ranks needs a process group of {n} ranks (world size {world}): "
            "start the ranks with parallel.multihost.run_world or initialize_distributed"
        )
    return SolverMesh(axis_names, shape, rank=dist.get_rank(), distributed=True)


def padded_grid_shape(grid_shape: Tuple[int, ...], mesh: SolverMesh) -> Tuple[int, ...]:
    """Grid shape rounded up so the mesh divides its first dim over the row
    axes and its last dim over the last axis."""
    out = list(grid_shape)
    out[0] = -(-out[0] // mesh.rows) * mesh.rows
    out[-1] = -(-out[-1] // mesh.cols) * mesh.cols
    return tuple(out)


def pad_field(field, mesh: SolverMesh, fill=0):
    """Pad a full-grid field (numpy or torch) at the high end to a
    mesh-divisible shape."""
    target = padded_grid_shape(tuple(field.shape), mesh)
    pads = [(0, t - s) for s, t in zip(field.shape, target)]
    if all(p == (0, 0) for p in pads):
        return field
    if isinstance(field, np.ndarray):
        return np.pad(field, pads, constant_values=fill)
    flat = [v for p in reversed(pads) for v in p]
    return F.pad(field, flat, value=fill)


def crop_field(field, grid_shape: Tuple[int, ...]):
    """Undo :func:`pad_field`."""
    return field[tuple(slice(0, s) for s in grid_shape)]


def row_col_axes(mesh: SolverMesh):
    """Mesh axis names pairing with the field's (row, column) dims: rows
    over every axis but the last (a tuple on a hybrid mesh), columns over
    the last."""
    names = mesh.axis_names
    ay = names[0] if len(names) == 2 else tuple(names[:-1])
    return ay, names[-1]


def shard_field(field, mesh: SolverMesh) -> torch.Tensor:
    """This rank's block of a full-grid field (numpy or torch), padded to
    :func:`padded_grid_shape` first, on the field's device."""
    f = torch.as_tensor(field)
    f = pad_field(f, mesh)
    return mesh.take_block(f, mesh.block_shape(f.shape))


def gather_field(block: torch.Tensor, mesh: SolverMesh) -> torch.Tensor:
    """The padded global field from the blocks (inverse of
    :func:`shard_field` up to :func:`crop_field`), on every rank."""
    return mesh.gather(block)


def make_sharded_problem(problem, mesh: SolverMesh, dtype=torch.float64, device="cuda"):
    """(operator, b, u_true) ready for ``cg_solve`` on a mesh: the halo
    stencil and this rank's blocks of the padded RHS and true solution
    (``crop_field(gather_field(x, mesh), grid_shape)`` restores a solution)."""
    from iterative_solvers_tpu_torch.core.domain import resolve_device
    from iterative_solvers_tpu_torch.parallel.halo import ShardedStencilOperator

    device = resolve_device(device)
    op = ShardedStencilOperator.from_domain(problem.domain, mesh)
    b = shard_field(problem.rhs_field(dtype, device), mesh)
    u = (shard_field(problem.true_solution_field(dtype, device), mesh)
         if problem.u_exact is not None else None)
    return op, b, u

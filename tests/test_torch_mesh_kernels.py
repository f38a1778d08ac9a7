"""The mesh kernels' plain versions on single blocks, in one process: D1–D4
(``parallel/halo_pallas.py``, ``parallel/mg_sharded.py``) against the JAX
package's block calls, the layouts against the JAX operators on the same
mesh shapes, stitched blocks against the single-device kernels' plain
versions, and the facade's mesh validation.

The JAX block calls (``_block_stencil_call``, ``_block_stencil_call_3d``,
``_k_down_call``, ``_k_up_call``) run in interpret mode on one block with a
non-zero origin and random halo rows. They zero the wrapped lane of their
lane rolls (the neighbour columns are edge strips added outside them), so
the port's plain versions are called with zero neighbour columns here.
Tolerances:

- block calls, f64: the same per-node expression: 1e-13 of max|out|; the
  D4 dot partial, which JAX takes without the edge lanes, to 1e-12.
- stitched blocks, f32: each node takes the single-device plain version's
  expression, so the stitched (2, 2) partition (D2: (2, 1, 2)) equals the
  single-device A1 / S7 / K_down / K_up plain version bit for bit.
- D2's staged z-march replayed in plain torch (``_torch_zstream``: tiles,
  chunks, per-plane sources, halo columns by the edge tiles): bit-equal to
  its plain version;
  so are D3's and D4's leg tiles (per-row sources, halo columns by the edge
  tiles), D4's summed tile partials within 1e-5 of the sum of |terms|.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh

from iterative_solvers_tpu.api import DirichletSolver as JSolver
from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.core.domain import Domain3D as JDomain3D
from iterative_solvers_tpu.parallel import ShardedPallasStencilOperator as JPallas
from iterative_solvers_tpu.parallel import make_solver_mesh as j_mesh
from iterative_solvers_tpu.parallel import padded_grid_shape as j_padded_grid_shape
from iterative_solvers_tpu.parallel.halo_pallas import (
    ShardedPallas3DStencilOperator as JPallas3D,
    _block_stencil_call,
    _block_stencil_call_3d,
    _embed_row,
)
from iterative_solvers_tpu.parallel.mg_sharded import _k_down_call, _k_up_call

from _torch_mesh_cases import BOX, raising_rank, sleeping_rank
from _torch_zstream import zstream_replay
from iterative_solvers_tpu_torch import DirichletSolver, Domain2D, Domain3D
from iterative_solvers_tpu_torch.interop import block_from_global, global_from_blocks
from iterative_solvers_tpu_torch.core.domain import MaskSpec
from iterative_solvers_tpu_torch.kernels.mg_fused import (
    FusedLevelKernels,
    lane_prolong,
    lane_restrict,
)
from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.parallel import (
    ShardedPallas3DStencilOperator,
    ShardedPallasStencilOperator,
    SolverMesh,
    make_solver_mesh,
    padded_grid_shape,
    run_world,
)
from iterative_solvers_tpu_torch.kernels.stencil3d_layout import (
    ZSTREAM_BLOCKS_PER_SM,
    ZSTREAM_DEPTH,
    ZSTREAM_TILE,
    zstream_chunk,
    zstream_chunks,
)
from iterative_solvers_tpu_torch.parallel.halo import apply5
from iterative_solvers_tpu_torch.parallel.halo_pallas import (
    block_stencil3d_plain,
    block_stencil_plain,
)
from iterative_solvers_tpu_torch.parallel.mg_sharded import ShardedFusedMultigrid
from iterative_solvers_tpu_torch.solvers.stopping import StopReason
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MESHES = [(2, 2), (4, 1), (1, 4), (2, 1, 2)]
OMEGA = 0.8


def _mesh(shape, rank=0):
    names = ("slice", "y", "x") if len(shape) == 3 else ("y", "x")
    return SolverMesh(names, shape, rank=rank)


def _jmesh(shape):
    devs = np.asarray(jax.devices()[:4]).reshape(shape)
    return Mesh(devs, ("slice", "y", "x") if len(shape) == 3 else ("y", "x"))


def _jax_origins(jop, grid_shape):
    """Each device's block origin in the JAX operator's sharded layout, in
    the mesh's device order (the port's rank order)."""
    arr = jop.shard(np.zeros(grid_shape))
    starts = {s.device: tuple(i.start or 0 for i in s.index) for s in arr.addressable_shards}
    return [starts[d] for d in jop.mesh.devices.flat]


@pytest.mark.parametrize("shape", MESHES)
def test_layouts_match_jax(shape):
    """Padded shapes, block shapes and every rank's block origin."""
    jm = _jmesh(shape)
    meshes = [_mesh(shape, r) for r in range(4)]
    cases = [
        (ShardedPallasStencilOperator, JPallas, Domain2D(nx=64, ny=64),
         JDomain2D(nx=64, ny=64)),
        (ShardedPallasStencilOperator, JPallas, Domain2D(nx=46, ny=38, shape="rect"),
         JDomain2D(nx=46, ny=38, shape="rect")),
        (ShardedPallas3DStencilOperator, JPallas3D, Domain3D(**BOX), JDomain3D(**BOX)),
    ]
    for cls, jcls, dom, jd in cases:
        jop = jcls.from_domain(jd, jm)
        ops = [cls.from_domain(dom, m) for m in meshes]
        assert ops[0].padded_shape == tuple(jop.padded_shape)
        assert ops[0].block_shape == tuple(jop.block_shape)
        assert ops[0].block_rows == jop.block_rows
        assert [op.origin for op in ops] == _jax_origins(jop, jd.grid_shape)
    for grid in ((31, 31), (36, 32), (23, 15, 19)):
        assert padded_grid_shape(grid, meshes[0]) == tuple(j_padded_grid_shape(grid, jm))


@pytest.mark.parametrize("shape", [(2, 2), (2, 1, 2)])
def test_interop_blocks_match_jax_shards(shape):
    """A JAX mesh field as numpy goes to each rank's block: the JAX
    device's own shard; one rank's blocks come back as the global field."""
    jd = JDomain2D(nx=46, ny=38, shape="rect")
    jop = JPallas.from_domain(jd, _jmesh(shape))
    x = np.random.default_rng(3).standard_normal(jd.grid_shape)
    arr = jop.shard(x)
    shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for r, dev in enumerate(jop.mesh.devices.flat):
        got = block_from_global(np.asarray(arr), _mesh(shape, r))
        np.testing.assert_array_equal(got.numpy(), shards[dev])
    one = make_solver_mesh(1)
    np.testing.assert_array_equal(global_from_blocks(block_from_global(np.asarray(arr), one), one),
                                  np.asarray(arr))


def _block_case(kind="gamma", n=64):
    """A (2, 2) partition of a Г or rect 2D grid: the JAX operator, the
    port's for block (1, 1) and its origin, a random f64 generator."""
    nx, ny = (n, n) if kind == "gamma" else (46, 38)
    jd = JDomain2D(nx=nx, ny=ny, shape=kind)
    dom = Domain2D(nx=nx, ny=ny, shape=kind)
    op = ShardedPallasStencilOperator.from_domain(dom, _mesh((2, 2), 3), block_rows=16)
    return jd, dom, op, op.origin, np.random.default_rng(7)


def _close(got, ref, rel):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["gamma", "rect"])
def test_block_stencil_plain_matches_jax(kind):
    """D1 on block (1, 1) of a (2, 2) partition, random halo rows."""
    jd, dom, op, (roff, coff), rng = _block_case(kind)
    hb, wb = op.block_shape
    x, up, dn = rng.standard_normal((hb, wb)), rng.standard_normal(wb), rng.standard_normal(wb)
    ref = _block_stencil_call(
        jnp.asarray([roff, coff], jnp.int32), jnp.asarray(x), _embed_row(jnp.asarray(up)[None], wb, 7),
        _embed_row(jnp.asarray(dn)[None], wb, 0), nx=jd.nx, ny=jd.ny, cd=jd.coeff_diag,
        cx=jd.coeff_x, cy=jd.coeff_y, by=op.block_rows, mask_mode=kind, nb=hb // op.block_rows,
        interpret=True)
    zeros = torch.zeros(hb, dtype=torch.float64)
    got = block_stencil_plain(torch.from_numpy(x), torch.from_numpy(up), torch.from_numpy(dn),
                              zeros, zeros, op.block_spec(), op.coeffs)
    _close(got.numpy(), np.asarray(ref), 1e-13)


def test_block_stencil_3d_plain_matches_jax():
    """D2 on block (1, 1) of a (2, 2) partition of the 16³ box."""
    jd, dom = JDomain3D(nx=16, ny=16, nz=16), Domain3D(nx=16, ny=16, nz=16)
    op = ShardedPallas3DStencilOperator.from_domain(dom, _mesh((2, 2), 3), block_rows=8)
    dzb, hp, wb = op.block_shape
    zoff, _, coff = op.origin
    rng = np.random.default_rng(8)
    x, zup, zdn = (rng.standard_normal(s) for s in ((dzb, hp, wb), (hp, wb), (hp, wb)))
    ref = _block_stencil_call_3d(
        jnp.asarray([zoff, coff], jnp.int32), jnp.asarray(x), jnp.asarray(zup)[None],
        jnp.asarray(zdn)[None], nx=16, ny=16, nz=16, cd=jd.coeff_diag, cx=jd.coeff_x,
        cy=jd.coeff_y, cz=jd.coeff_z, by=op.block_rows, interpret=True)
    zeros = torch.zeros((dzb, hp), dtype=torch.float64)
    got = block_stencil3d_plain(torch.from_numpy(x), torch.from_numpy(zup),
                                torch.from_numpy(zdn), zeros, zeros, op.block_spec(), op.coeffs)
    _close(got.numpy(), np.asarray(ref), 1e-13)


@pytest.mark.parametrize("dims,shape,rank,bz", [((16, 16, 16), (2, 1, 2), 3, None),
                                               ((16, 24, 8), (1, 1, 2), 1, 3),
                                               ((300, 8, 8), (1, 1, 2), 0, None),
                                               ((300, 8, 8), (2, 1, 2), 3, 2)])
def test_d2_zstream_schedule_emulation(dims, shape, rank, bz):
    """D2's staged z-march, replayed in plain torch on one block with a
    non-zero origin and raw (unmasked) random halos, equals D2's plain
    version bit for bit: chunks of the planner's depth (132 SMs) and of 3
    and 2 planes (a ragged last chunk), blocks one and two tiles wide, with
    interior halo planes and columns on either side."""
    op = ShardedPallas3DStencilOperator.from_domain(Domain3D(*dims), _mesh(shape, rank))
    dzb, hp, wb = op.block_shape
    rng = np.random.default_rng(9)
    x, zup, zdn, left, right = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                                for s in ((dzb, hp, wb), (hp, wb), (hp, wb), (dzb, hp),
                                          (dzb, hp)))
    spec = op.block_spec()
    bz = bz or zstream_chunk(dzb, hp, wb, 132)
    want = block_stencil3d_plain(x, zup, zdn, left, right, spec, op.coeffs)
    got = zstream_replay(x, spec, op.coeffs, bz, halos=(zup, zdn, left, right))
    assert torch.equal(got, want)


@pytest.mark.parametrize("planes,hp,wp", [(513, 520, 640), (257, 520, 384), (257, 264, 384),
                                          (17, 24, 128), (9, 24, 128), (1025, 1032, 1152)])
@pytest.mark.parametrize("sms", [132, 114])
def test_zstream_chunk_plan(planes, hp, wp, sms):
    """The planner's chunks cover every plane once, in chunks of one depth
    (the last shorter by less than the number of chunks), and the grid holds
    at least ``ZSTREAM_BLOCKS_PER_SM`` blocks on every SM unless the chunks
    are at their least depth."""
    lo, hi = ZSTREAM_DEPTH
    bz = zstream_chunk(planes, hp, wp, sms)
    chunks = zstream_chunks(planes, bz)
    assert [z for z0, z1 in chunks for z in range(z0, z1)] == list(range(planes))
    assert 1 <= bz <= hi and all(z1 - z0 == bz for z0, z1 in chunks[:-1])
    assert bz - (chunks[-1][1] - chunks[-1][0]) < len(chunks)
    tiles = (hp // ZSTREAM_TILE[0]) * (wp // ZSTREAM_TILE[1])
    assert len(chunks) * tiles >= ZSTREAM_BLOCKS_PER_SM * sms or bz <= lo


def _leg_tiles(rows, tile):
    """The row ranges [r0, r1) of a mesh leg's tiles down a block of
    ``rows`` rows (D3: coarse rows, D4: fine rows), as csrc/mg_tiles.cuh's
    grid runs them: ``tile`` rows each from row 0, the last cut at the
    block's edge."""
    return [(r, min(r + tile, rows)) for r in range(0, rows, tile)]


def _leg_stage(rows_of, cols, left, right, r0, nr, x0, wb):
    """A leg tile's staged rows r0 .. r0 + nr - 1 and columns x0 - 1 .. x0 +
    128, as csrc/mg_tiles.cuh stages them: each row from the one source
    ``rows_of(r)`` picks (None: zero), the block's halo column from
    ``left`` / ``right`` (``cols(r)``: its index there, or None) by the
    tiles at the block's x edges only."""
    s = torch.zeros((nr, 130), dtype=left.dtype)
    for k in range(nr):
        row = rows_of(r0 + k)
        if row is not None:
            s[k, 1:-1] = row[x0:x0 + 128]
            if x0 > 0:
                s[k, 0] = row[x0 - 1]
            if x0 + 128 < wb:
                s[k, -1] = row[x0 + 128]
        j = cols(r0 + k)
        if j is not None and x0 == 0:
            s[k, 0] = left[j]
        if j is not None and x0 + 128 == wb:
            s[k, -1] = right[j]
    return s


def _leg_mask(lev, origin, r0, nr, x0):
    """The interior of a leg tile's staged rows r0 .. r0 + nr - 1, columns
    x0 - 1 .. x0 + 128, at their global nodes."""
    return MaskSpec(lev.mask_mode, lev.nx, lev.ny, (nr, 130),
                    origin=(origin[0] + r0, origin[1] + x0 - 1)).build()


def _d3_replay(lev, origin, tj, b, up2, dn, left, right):
    """D3's tiles (csrc/mg_tiles.cuh, kBlock) in plain torch: per tile of
    :func:`_leg_tiles` (TJ coarse rows) and 128-column strip, b's staged rows
    2 J0 - 2 .. 2 J0 + 2 TJ (rows -2, -1 from ``up2``, row Hb from ``dn``)
    and halo columns, masked at their global nodes; the residual of cs b,
    row-restricted; the rows of the block written."""
    hb, wb = lev.block_shape
    rr = torch.full((hb // 2, wb), float("nan"), dtype=b.dtype)
    for J0, J1 in _leg_tiles(hb // 2, tj):
        r0, nr = 2 * J0 - 2, 2 * tj + 3
        for x0 in range(0, wb, 128):
            s = _leg_stage(lambda r: b[r] if 0 <= r < hb else up2[r + 2] if r in (-2, -1)
                           else dn if r == hb else None,
                           lambda r: r + 1 if -1 <= r < hb else None, left, right, r0, nr, x0,
                           wb)
            m = _leg_mask(lev, origin, r0, nr, x0)
            s = torch.where(m, s, 0.0)
            R = torch.where(m[1:-1, 1:-1], s[1:-1, 1:-1] - apply5(lev.cs * s, *lev.coeffs), 0.0)
            rows = 0.25 * R[0:-1:2] + 0.5 * R[1::2] + 0.25 * R[2::2]
            rr[J0:J1, x0:x0 + 128] = rows[:J1 - J0]
    return rr


def _d4_replay(lev, origin, tj, b, bup, bdn, bleft, bright, ec, ecup, ecdn, ecleft, ecright):
    """D4's tiles in plain torch: per tile (2 TJ fine rows, dividing Hb)
    and strip, b's staged rows i0 - 1 .. i0 + 2 TJ and ec's coarse rows J0
    - 1 .. J0 + TJ (zero outside the global [0, ch)), each with its halo
    column; the corrected iterate at every staged node (odd fine rows
    average two coarse rows), masked; one sweep. Returns (out, the summed
    tile partials of (b, out))."""
    (hb, wb), hc, goff = lev.block_shape, lev.block_shape[0] // 2, origin[0] // 2
    out = torch.full((hb, wb), float("nan"), dtype=b.dtype)
    dot = 0.0
    for i0, i1 in _leg_tiles(hb, 2 * tj):
        assert i1 - i0 == 2 * tj
        for x0 in range(0, wb, 128):
            sb = _leg_stage(lambda r: b[r] if 0 <= r < hb else bup if r == -1
                            else bdn if r == hb else None,
                            lambda r: r if 0 <= r < hb else None, bleft, bright, i0 - 1,
                            2 * tj + 2, x0, wb)
            se = _leg_stage(lambda J: None if not 0 <= goff + J < lev.ch
                            else ec[J] if 0 <= J < hc else ecup if J == -1
                            else ecdn if J == hc else None,
                            lambda J: J if 0 <= J <= hc and 0 <= goff + J < lev.ch else None,
                            ecleft, ecright, i0 // 2 - 1, tj + 2, x0, wb)
            p = torch.stack([0.5 * (se[:-1] + se[1:]), se[1:]], dim=1).reshape(2 * tj + 2, 130)
            m = _leg_mask(lev, origin, i0 - 1, 2 * tj + 2, x0)
            xc = torch.where(m, lev.cs * sb + p, 0.0)
            mi = m[1:-1, 1:-1]
            bm = torch.where(mi, sb[1:-1, 1:-1], 0.0)
            R = torch.where(mi, bm - apply5(xc, *lev.coeffs), 0.0)
            o = torch.where(mi, xc[1:-1, 1:-1] + lev.cs * R, 0.0)
            out[i0:i1, x0:x0 + 128] = o
            dot += float((bm * o).double().sum())
    return out, dot


@functools.lru_cache(maxsize=None)
def _leg_level(n, mesh_shape, rank):
    dom = Domain2D(nx=n, ny=n)
    op = ShardedPallasStencilOperator.from_domain(dom, _mesh(mesh_shape, rank), block_rows=16)
    lev = ShardedFusedMultigrid.from_operator(op, dom, fuse_min_extent=33,
                                              device="cpu").levels[0]
    return lev, op.origin


@pytest.mark.parametrize("case", [(200, (2, 2), 3), (200, (2, 2), 0), (64, (1, 1), 0)])
@pytest.mark.parametrize("tj", [4, 8, 16])
def test_d3_d4_leg_tile_schedule_emulation(case, tj):
    """D3's and D4's leg tiles, replayed in plain torch on one block, equal
    their plain versions bit for bit: blocks of a (2, 2) partition of 200²
    (origins (112, 128) and (0, 0): interior halo rows, and halo columns
    interior on the left or the right) with raw random halos, and the 1x1
    block of 64², whose halos are its own edges (the ring's), which the
    global interior test must zero. D3 at TJ 4, 8 and 16 (Hb/2 = 56 rows:
    a last tile cut at the block's edge at 16), D4 at TJ 4 and 8."""
    n, mesh_shape, rank = case
    lev, origin = _leg_level(n, mesh_shape, rank)
    hb, wb = lev.block_shape
    g = torch.Generator().manual_seed(11)
    x = torch.randn(lev.padded_shape, generator=g)
    ecg = torch.randn((lev.padded_shape[0] // 2, lev.padded_shape[1]), generator=g)
    dh = lev.down_halos_from_global(x, origin)
    uh = lev.up_halos_from_global(x, ecg, origin)
    if mesh_shape != (1, 1):  # raw halos of any value: every read is masked
        dh = dh[:1] + tuple(torch.randn(t.shape, generator=g) for t in dh[1:])
        uh = uh[:1] + tuple(torch.randn(t.shape, generator=g) for t in uh[1:5]) + uh[5:6] + \
            tuple(torch.randn(t.shape, generator=g) for t in uh[6:])
    assert torch.equal(_d3_replay(lev, origin, tj, *dh), lev.down_plain(*dh, origin))
    if tj > 8:  # D4's tallest tile is 2 x 8 rows
        return
    out, dot = _d4_replay(lev, origin, tj, *uh)
    ref, part = lev.up_plain(*uh, origin, with_dot=True)
    assert torch.equal(out, ref)
    bm = torch.where(lev.spec(origin).build(), uh[0], 0.0)
    assert abs(dot - float(part)) <= 1e-5 * float((bm * ref).abs().sum())


@pytest.mark.parametrize("n,mesh_shape,extent", [(8192, (1, 1), 512), (8192, (4, 2), 512),
                                                 (2048, (2, 2), 512), (200, (2, 2), 33)])
def test_leg_tile_plan(n, mesh_shape, extent):
    """The mesh legs' tiles on every shard-fused level (the sharded fast
    path's at 8192² on 1x1 and on (4, 2), the 4-rank world's at 2048², the
    replay's 200² on 16-row bands), on cards of 132 and 114 SMs: D3's tiles (TJ 16, 8 or 4 coarse rows) cover
    the block's Hb/2 rows once, only the last one cut; D4's (2 TJ fine rows,
    TJ 8 or 4) divide Hb, as the launcher requires; each leg keeps two
    blocks on every SM unless at TJ 4; the levels keep the rules the tiles
    rest on (Hb % by == 0, by >= 16, Wb % 128 == 0)."""
    dom = Domain2D(nx=n, ny=n)
    op = ShardedPallasStencilOperator.from_domain(dom, _mesh(mesh_shape),
                                                  block_rows=16 if n < 512 else None)
    levels = ShardedFusedMultigrid.from_operator(op, dom, fuse_min_extent=extent,
                                                 device="cpu").levels
    assert levels
    for lev in levels:
        hb, wb = lev.block_shape
        assert hb % lev.by == 0 and lev.by >= 16 and wb % 128 == 0
        for sms in (132, 114):
            for rows, tile, tj, tiles_ok in (
                    (hb // 2, lev.down_tile_rows(sms), lev.down_tile_rows(sms), (16, 8, 4)),
                    (hb, 2 * lev.up_tile_rows(sms), lev.up_tile_rows(sms), (8, 4))):
                assert tj in tiles_ok
                tiles = _leg_tiles(rows, tile)
                assert [r for r0, r1 in tiles for r in range(r0, r1)] == list(range(rows))
                assert all(r1 - r0 == tile for r0, r1 in tiles[:-1])
                assert len(tiles) * (wb // 128) >= 2 * sms or tj == 4
            assert hb % (2 * lev.up_tile_rows(sms)) == 0


def _level(kind="gamma"):
    jd, dom, op, origin, rng = _block_case(kind)
    M = ShardedFusedMultigrid.from_operator(op, dom, fuse_min_extent=33, device="cpu")
    return jd, M.levels[0], origin, rng


@pytest.mark.parametrize("kind", ["gamma", "rect"])
def test_k_down_block_plain_matches_jax(kind):
    """D3: 2 rows of b above the block, 1 below; zero neighbour columns."""
    jd, lev, (roff, coff), rng = _level(kind)
    hb, wb = lev.block_shape
    b, up2, dn = rng.standard_normal((hb, wb)), rng.standard_normal((2, wb)), rng.standard_normal(wb)
    ref = _k_down_call(
        jnp.asarray([roff, coff], jnp.int32), jnp.asarray(b), _embed_row(jnp.asarray(up2), wb, 6),
        _embed_row(jnp.asarray(dn)[None], wb, 0), nx=jd.nx, ny=jd.ny, cd=lev.coeffs[0],
        cx=lev.coeffs[1], cy=lev.coeffs[2], cs=lev.cs, by=lev.by, mask_mode=kind,
        nb=hb // lev.by, interpret=True)
    zeros = torch.zeros(hb + 1, dtype=torch.float64)
    got = lev.down_plain(*map(torch.from_numpy, (b, up2, dn)), zeros, zeros, (roff, coff))
    _close(got.numpy(), np.asarray(ref), 1e-13)


@pytest.mark.parametrize("kind,with_dot", [("gamma", False), ("gamma", True), ("rect", True)])
def test_k_up_block_plain_matches_jax(kind, with_dot):
    """D4 with b and ec halo rows; zero neighbour columns. JAX's (b, out)
    partial leaves out the edge lanes (it adds them from its edge strips):
    the port's whole-block partial minus those lanes matches it."""
    jd, lev, (roff, coff), rng = _level(kind)
    hb, wb = lev.block_shape
    b, bup, bdn = rng.standard_normal((hb, wb)), rng.standard_normal(wb), rng.standard_normal(wb)
    ec, ecup, ecdn = (rng.standard_normal(s) for s in ((hb // 2, wb), (wb,), (wb,)))
    ref = _k_up_call(
        jnp.asarray([roff, coff, roff // 2], jnp.int32), jnp.asarray(b),
        _embed_row(jnp.asarray(bup)[None], wb, 7), _embed_row(jnp.asarray(bdn)[None], wb, 0),
        jnp.asarray(ec), _embed_row(jnp.asarray(ecup)[None], wb, 7),
        _embed_row(jnp.asarray(ecdn)[None], wb, 0), nx=jd.nx, ny=jd.ny, cd=lev.coeffs[0],
        cx=lev.coeffs[1], cy=lev.coeffs[2], cs=lev.cs, by=lev.by, mask_mode=kind,
        ch=lev.ch, nb=hb // lev.by, interpret=True, with_dot=with_dot)
    t = torch.from_numpy
    z1, z2 = torch.zeros(hb, dtype=torch.float64), torch.zeros(hb // 2 + 1, dtype=torch.float64)
    got = lev.up_plain(t(b), t(bup), t(bdn), z1, z1, t(ec), t(ecup), t(ecdn), z2, z2,
                       (roff, coff), with_dot)
    if not with_dot:
        _close(got.numpy(), np.asarray(ref), 1e-13)
        return
    out, part = got
    _close(out.numpy(), np.asarray(ref[0]), 1e-13)
    bm = torch.where(lev.spec((roff, coff)).build("cpu"), t(b), 0.0)
    edges = float((bm * out)[:, [0, -1]].sum())
    jpart = float(np.asarray(ref[1])[:, 0, 0].sum())
    assert abs((float(part) - edges) - jpart) <= 1e-12 * np.abs(np.asarray(bm * out)).sum()


def _blocks(mesh_shape):
    return [_mesh(mesh_shape, r) for r in range(4)]


def _stitch(parts, meshes):
    rows = max(m.coords[0] for m in meshes) + 1
    cols = meshes[0].cols
    grid = [[None] * cols for _ in range(rows)]
    for m, p in zip(meshes, parts):
        grid[m.coords[0]][m.coords[1]] = p
    return torch.cat([torch.cat(r, dim=-1) for r in grid], dim=0)


@pytest.mark.parametrize("leg", ["D1", "D2", "D3", "D4"])
def test_stitched_blocks_equal_single_device(leg):
    """Every block of a partition, its halos cut from the global field as
    the ring exchange delivers them, stitched: the single-device plain
    version bit for bit (f32), edge nodes included."""
    g = torch.Generator().manual_seed(5)
    if leg == "D2":
        dom = Domain3D(nx=16, ny=16, nz=16)
        meshes = _blocks((2, 1, 2))
        ops = [ShardedPallas3DStencilOperator.from_domain(dom, m) for m in meshes]
        x = torch.randn(ops[0].padded_shape, generator=g)
        got = _stitch([op.apply_block(*op.halos_from_global(x, op.origin)) for op in ops],
                      meshes)
        single = Padded3DStencilOperator.from_domain(dom)
        d, h, w = single.padded_shape  # the single-device canvas lies inside the mesh's
        ref = single.apply_plain(x[:d, :h, :w].contiguous())
        np.testing.assert_array_equal(got[:d, :h, :w].numpy(), ref.numpy())
        return
    dom = Domain2D(nx=64, ny=64)
    meshes = _blocks((2, 2))
    ops = [ShardedPallasStencilOperator.from_domain(dom, m, block_rows=16) for m in meshes]
    hp, wp = ops[0].padded_shape
    x = torch.randn((hp, wp), generator=g)
    if leg == "D1":
        got = _stitch([op.apply_block(*op.halos_from_global(x, op.origin)) for op in ops],
                      meshes)
        ref = PaddedStencilOperator(64, 64, ops[0].coeffs, (65, 65), (hp, wp), 16,
                                    "gamma").apply_plain(x)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        return
    # a level is the same on every rank (each call takes its block's origin)
    lev = ShardedFusedMultigrid.from_operator(ops[0], dom, fuse_min_extent=33,
                                              device="cpu").levels[0]
    levs = [lev] * len(ops)
    # the single-device legs fold in the lane transfers and the child mask
    # that the mesh runs between its block legs: the same ops on the stitch
    single = FusedLevelKernels(64, 64, lev.coeffs, lev.cs, "gamma", (hp, wp), 16, (33, 33))
    ch, cw = single.coarse_shape
    if leg == "D3":
        got = _stitch([lv.down_plain(*lv.down_halos_from_global(x, op.origin), op.origin)
                       for lv, op in zip(levs, ops)], meshes)
        got = lane_restrict(got[:ch], 64, cw)
        got = torch.where(single.child_spec.build(), got, 0.0)
        np.testing.assert_array_equal(got.numpy(), single.down_plain(x).numpy())
        return
    ec = torch.randn((ch, cw), generator=g)
    ecl = F.pad(lane_prolong(ec, 32, wp), (0, 0, 0, hp // 2 - ch))
    got = _stitch([lv.up_plain(*lv.up_halos_from_global(x, ecl, op.origin), op.origin)
                   for lv, op in zip(levs, ops)], meshes)
    np.testing.assert_array_equal(got.numpy(), single.up_plain(x, ec).numpy())


def test_run_world_deadline_and_failures():
    """A rank that hangs past the deadline, or raises, ends the whole world
    and the launcher raises (the other ranks are killed, not waited on)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        run_world(sleeping_rank, 2, (120,), timeout=4)
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        run_world(raising_rank, 2, timeout=60)
    assert time.monotonic() - t0 < 60


def test_facade_mesh_validation():
    """The JAX facade's mesh rules and messages; the sharded fused engine's
    routes (ROADMAP item 14c) run."""
    mesh, jm = make_solver_mesh(1), j_mesh(4, (2, 2), devices=jax.devices()[:4])
    custom = dict(nx=16, ny=16, shape="custom", inside_fn=lambda x, y: x > 0)
    for Solver, D2, D3, m, dev in ((DirichletSolver, Domain2D, Domain3D, mesh, dict(device="cpu")),
                                   (JSolver, JDomain2D, JDomain3D, jm, {})):
        with pytest.raises(ValueError, match="gamma/rect"):
            Solver(domain=D2(**custom), operator="pallas", mesh=m, **dev)
        with pytest.raises(ValueError, match="2D-only"):
            Solver(domain=D3(nx=8, ny=8, nz=8), operator="fused", mesh=m, **dev)
        with pytest.raises(ValueError, match="single-chip only"):
            Solver(nx=16, ny=16, precision="mixed", outer="ff", mesh=m, **dev)
        with pytest.raises(ValueError, match="requires operator='stencil'"):
            Solver(nx=16, ny=16, operator="sparse", mesh=m, **dev)
    # the sharded fused engine's routes (item 14c, once NotImplementedError) run
    r = DirichletSolver(nx=16, ny=16, operator="fused", mesh=mesh, device="cpu").solve()
    assert r.converged and r.stop_reason == StopReason.PRECISION
    r = DirichletSolver(nx=64, ny=64, operator="pallas", preconditioner="mg", precision="mixed",
                        mesh=mesh, device="cpu").solve()
    assert r.converged and r.outer_iterations >= 1


@pytest.mark.parametrize("case", ["two nodes", "one node", "nccl short of cards", "no env"])
def test_initialize_distributed_backend_and_card(monkeypatch, case):
    """The backend and the card come from this node's ranks (torchrun's
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``; the global ones on a single node
    without them): 8 ranks on 2 nodes of 4 cards take ``nccl`` and card
    ``LOCAL_RANK``; ``nccl`` asked for with more local ranks than cards
    raises; nothing to join is a no-op."""
    from iterative_solvers_tpu_torch.parallel import multihost

    joined, cards = [], []
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda backend, **kw: joined.append((backend, kw["rank"], kw["world_size"])))
    monkeypatch.setattr(multihost.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(multihost.torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(multihost.torch.cuda, "set_device", cards.append)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    if case == "no env":
        multihost.initialize_distributed()
        assert joined == [] and cards == []
        return
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    if case == "two nodes":
        for k, v in (("WORLD_SIZE", 8), ("RANK", 6), ("LOCAL_RANK", 2), ("LOCAL_WORLD_SIZE", 4)):
            monkeypatch.setenv(k, str(v))
        multihost.initialize_distributed()
        assert (joined, cards) == ([("nccl", 6, 8)], [2])
    elif case == "one node":
        multihost.initialize_distributed(num_processes=4, process_id=3)
        assert (joined, cards) == ([("nccl", 3, 4)], [3])
        joined.clear()
        multihost.initialize_distributed(num_processes=8, process_id=5)  # 8 ranks, 4 cards
        assert (joined, cards) == ([("gloo", 5, 8)], [3])
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
        with pytest.raises(ValueError, match="card per local rank"):
            multihost.initialize_distributed(num_processes=8, process_id=0, backend="nccl")
        assert joined == []

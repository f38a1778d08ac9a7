"""The port's CUDA kernels against their plain torch versions on the card,
2D (A1–A8; A1 and C1 bit for bit on unmasked input on every layout they
run on), their custom-mask instantiations (C1–C3, K1/K2/K2-pcg and A8
with the int8 mask operand), 3D (S7, D3, U3, J3, R3), the in-place and
pipelined stencils (C4, C5), which must equal A1 bit for bit at scale 1,
and the mesh block kernels (D1–D6), whose stitched blocks must equal the
single-device kernels bit for bit; D3 and U3 equal their plain versions
bit for bit, and so do the kernels of the staged z-march, S7, J3 (at every
fused level), D2 and R3 (both words of R3's pair), on every split and
coefficient set, and the mesh legs D3 and D4 at each tile height.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere (the
card is looked for inside the fixture, never at import). Run them on a GPU
machine with ``python -m pytest tests/test_torch_cuda.py -q``.

Tolerance: 64 eps32 of each field's max (the kernel contracts products into
FMAs and sums in another order than torch); sums to 64 eps32 of the sum of
their terms' magnitudes. The double-f32 residual kernel runs every operation
uncontracted in its plain version's order: its high word must be
bit-equal, its low word within 32 · max|bh| · 2⁻⁴⁸."""

import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch import Domain2D, Domain3D
from iterative_solvers_tpu_torch.core.domain import notched_disk
from iterative_solvers_tpu_torch.kernels import _build, cg_fused, resid_ff
from iterative_solvers_tpu_torch.kernels import stencil_pipelined as sp
from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
from iterative_solvers_tpu_torch.kernels.mg_fused import (
    FusedLevelKernels,
    lane_prolong,
    lane_restrict,
)
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.ops import stencil as stencil_ops
from iterative_solvers_tpu_torch.ops.ddf32 import split_f64
from iterative_solvers_tpu_torch.parallel import (
    ShardedPallas3DStencilOperator,
    ShardedPallasStencilOperator,
    SolverMesh,
)
from iterative_solvers_tpu_torch.parallel.halo_pallas import (
    block_stencil3d_plain,
    block_stencil_plain,
)
from iterative_solvers_tpu_torch.parallel.mg_sharded import ShardedFusedMultigrid
from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner, _FusedLevel3D
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.cuda
EPS32 = torch.finfo(torch.float32).eps
SHAPES = [("gamma", 64, 64), ("rect", 40, 50), ("gamma", 512, 512)]
# (nx, ny, nz): D = 17 and the ragged D = 33, and a box with unequal spacings
BOXES = [(16, 16, 16), (32, 32, 32), (16, 24, 8)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    _build.load()
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref):
    tol = 64 * EPS32 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol


def _sum_close(got, ref, scale):
    assert abs(float(got.double().sum()) - float(ref.double().sum())) <= 64 * EPS32 * scale


@pytest.mark.parametrize("shape,nx,ny", SHAPES)
def test_k1_k2_pcg_match_plain(gen, shape, nx, ny):
    lay = PaddedStencilOperator.from_domain(Domain2D(nx=nx, ny=ny, shape=shape), block_rows=16)
    m = lay.mask_spec.build("cuda")
    x, r, z, w = (torch.where(m, torch.randn(lay.padded_shape, device="cuda", generator=gen), 0.0)
                  for _ in range(4))
    beta = torch.tensor(0.37, device="cuda")
    got, ref = cg_fused.k1(w, z, beta, lay), cg_fused.k1_plain(w, z, beta, lay)
    _close(got[0], ref[0])
    _sum_close(got[1], ref[1], float((w * (w + beta * z)).abs().sum()))
    _sum_close(got[2], ref[2], abs(float(ref[2].sum())))
    assert abs(float(got[3].max()) - float(ref[3].max())) <= 64 * EPS32 * float(ref[3].max())
    scal = torch.tensor([-2.0e-4, 0.37], device="cuda")
    got = cg_fused.k2_pcg(x, r, z, w, ref[0], scal, lay)
    ref = cg_fused.k2_pcg_plain(x, r, z, w, ref[0], scal, lay)
    for g, e in zip(got[:3], ref[:3]):
        _close(g, e)
    _sum_close(got[3], ref[3], float(ref[3].sum()))


@pytest.mark.parametrize("shape,nx,ny", SHAPES)
def test_k_down_k_up_match_plain(gen, shape, nx, ny):
    M = MultigridPreconditioner.from_domain(
        Domain2D(nx=nx, ny=ny, shape=shape), fuse=True, fuse_min_extent=16, device="cuda"
    )
    k = M.levels[0].kernels
    hp, wp = k.padded_shape
    b = torch.randn((hp, wp), device="cuda", generator=gen)
    ec = torch.randn(k.coarse_shape, device="cuda", generator=gen)
    _close(k.down(b), k.down_plain(b))
    _close(k.up(b, ec), k.up_plain(b, ec))
    (o, dot), (o_ref, dot_ref) = k.up(b, ec, with_dot=True), k.up_plain(b, ec, with_dot=True)
    _close(o, o_ref)
    bm = torch.where(k.mask_spec.build("cuda"), b, 0.0)
    assert abs(float(dot) - float(dot_ref)) <= 64 * EPS32 * float((bm * o_ref).abs().sum())


@pytest.mark.parametrize("shape", ["gamma", "custom"])
def test_legs_match_plain_at_every_fused_level(gen, shape):
    """K_down and K_up (C2, C3 on the notched disk) at every fused level of
    the 8192² default solve (8192 … 512), each writing or reading the coarse
    field on its child's layout (the 512 level's child is a plain grid),
    with and without the dot."""
    fn = notched_disk if shape == "custom" else None
    M = MultigridPreconditioner.from_domain(Domain2D(nx=8192, ny=8192, shape=shape,
                                                     inside_fn=fn), device="cuda")
    fused = [lev.kernels for lev in M.levels if hasattr(lev, "kernels")]
    assert [k.nx for k in fused] == [8192, 4096, 2048, 1024, 512]
    assert fused[-1].coarse_shape == (257, 257)
    for k in fused:
        mk = k.mask_spec.build("cuda")
        b = torch.where(mk, torch.randn(k.padded_shape, device="cuda", generator=gen), 0.0)
        ec = torch.randn(k.coarse_shape, device="cuda", generator=gen)
        _close(k.down(b), k.down_plain(b))
        _close(k.up(b, ec), k.up_plain(b, ec))
        (o, dot), (o_ref, dot_ref) = k.up(b, ec, with_dot=True), k.up_plain(b, ec, with_dot=True)
        _close(o, o_ref)
        assert abs(float(dot) - float(dot_ref)) <= 64 * EPS32 * float((b * o_ref).abs().sum())


@pytest.mark.parametrize("shape,nx,ny", SHAPES)
def test_k2_and_u_variants_match_plain(gen, shape, nx, ny):
    lay = PaddedStencilOperator.from_domain(Domain2D(nx=nx, ny=ny, shape=shape), block_rows=16)
    m = lay.mask_spec.build("cuda")
    x, r, z, w, u = (torch.where(m, torch.randn(lay.padded_shape, device="cuda", generator=gen),
                                 0.0) for _ in range(5))
    beta = torch.tensor(0.37, device="cuda")
    scal = torch.tensor([-2.0e-4, 0.37], device="cuda")
    side_r = cg_fused.k1_plain(r, z, beta, lay)[0]
    side_w = cg_fused.k1_plain(w, z, beta, lay)[0]
    for uu in (None, u):
        for got, ref in (
            (cg_fused.k2(x, r, z, side_r, scal, lay, u=uu),
             cg_fused.k2_plain(x, r, z, side_r, scal, lay, u=uu)),
            (cg_fused.k2_pcg(x, r, z, w, side_w, scal, lay, u=uu),
             cg_fused.k2_pcg_plain(x, r, z, w, side_w, scal, lay, u=uu)),
        ):
            assert len(got) == len(ref) == (5 if uu is None else 6)
            for g, e in zip(got[:3], ref[:3]):
                _close(g, e)
            _sum_close(got[3], ref[3], float(ref[3].sum()))
            for g, e in zip(got[4:], ref[4:]):
                assert abs(float(g.max()) - float(e.max())) <= 64 * EPS32 * float(e.max())


@pytest.mark.parametrize("nx,by,tiles", [
    (64, 16, (8, 8)),      # 16-row bands of two 8-row tiles: tile edges inside a band
    (64, 8, (8, 8)),       # 8-row bands: every band is one tile
    (1024, None, (16, 8)),  # path B's layout: 256-row bands of 16- and 8-row tiles
])
def test_k1_k2_tiles_match_plain(gen, nx, by, tiles):
    """K1, K2 and K2-pcg (with and without u) on their CUDA tiles against
    the plain versions, where a tile edge falls inside a band and where a
    band is one tile; K1's side rows bit-equal to ``k1_plain``'s."""
    lay = PaddedStencilOperator.from_domain(Domain2D(nx=nx, ny=nx), block_rows=by)
    sms = _build.sm_count(torch.device("cuda"))
    assert tuple(cg_fused.tile_grid(k, lay.padded_shape, lay.block_rows, sms)[0]
                 for k in ("k1", "k2")) == tiles
    m = lay.mask_spec.build("cuda")
    x, r, z, w, u = (torch.where(m, torch.randn(lay.padded_shape, device="cuda", generator=gen),
                                 0.0) for _ in range(5))
    beta = torch.tensor(0.37, device="cuda")
    scal = torch.tensor([-2.0e-4, 0.37], device="cuda")
    sides = {}
    for name, d in (("r", r), ("w", w)):
        got, ref = cg_fused.k1(d, z, beta, lay), cg_fused.k1_plain(d, z, beta, lay)
        assert torch.equal(got[0], ref[0])
        _sum_close(got[1], ref[1], float((d * (d + beta * z)).abs().sum()))
        _sum_close(got[2], ref[2], abs(float(ref[2].sum())))
        assert float(got[3].max()) == float(ref[3].max())
        sides[name] = got[0]
    for uu in (None, u):
        for got, ref in (
            (cg_fused.k2(x, r, z, sides["r"], scal, lay, u=uu),
             cg_fused.k2_plain(x, r, z, sides["r"], scal, lay, u=uu)),
            (cg_fused.k2_pcg(x, r, z, w, sides["w"], scal, lay, u=uu),
             cg_fused.k2_pcg_plain(x, r, z, w, sides["w"], scal, lay, u=uu)),
        ):
            assert len(got) == len(ref) == (5 if uu is None else 6)
            for g, e in zip(got[:3], ref[:3]):
                _close(g, e)
            _sum_close(got[3], ref[3], float(ref[3].sum()))
            for g, e in zip(got[4:], ref[4:]):
                assert abs(float(g.max()) - float(e.max())) <= 64 * EPS32 * float(e.max())


@pytest.mark.parametrize("shape,nx,ny", SHAPES)
def test_stencil_jacobi_resid_ff_match_plain(gen, shape, nx, ny):
    dom = Domain2D(nx=nx, ny=ny, shape=shape)
    lay = PaddedStencilOperator.from_domain(dom, block_rows=16)
    x = torch.randn(lay.padded_shape, device="cuda", generator=gen)  # unmasked: reads masked
    assert torch.equal(lay(x), lay.apply_plain(x))
    k = MultigridPreconditioner.from_domain(dom, fuse=True, fuse_min_extent=16,
                                            device="cuda").levels[0].kernels
    xj, b = (torch.randn(k.padded_shape, device="cuda", generator=gen) for _ in range(2))
    _close(k.jacobi(xj, b), k.jacobi_plain(xj, b))
    m = lay.mask_spec.build("cuda")
    f64 = dict(device="cuda", dtype=torch.float64, generator=gen)
    bh, bl = split_f64(torch.where(m, torch.randn(lay.padded_shape, **f64), 0.0) * 1e4)
    xh, xl = split_f64(torch.where(m, torch.randn(lay.padded_shape, **f64), 0.0))
    gh, gl = resid_ff.resid_ff(xh, xl, bh, bl, lay)
    rh, rl = resid_ff.resid_ff_plain(xh, xl, bh, bl, lay)
    assert torch.equal(gh, rh)
    assert float((gl - rl).abs().max()) <= 32 * float(bh.abs().max()) * 2.0**-48


# A1 and C1 on the layouts they run on: gamma 64², rect 40 × 50 and the
# notched disk at 64² (16- and 32-row bands); paths B's and C-B's 1280 ×
# 1152, the 4096² precond layout, the 8192² level-0 and nnz (256-row)
# layouts, all of whose tiles (16 or 32 rows on 132 SMs) end inside their
# bands; gamma 64² at its own 256-row bands (8-row tiles); 12-row bands,
# which no tile divides (the tiles follow the canvas, not the bands)
A1_LAYOUTS = [(dict(nx=64, ny=64), 16), (dict(nx=40, ny=50, shape="rect"), 16),
              (dict(nx=40, ny=40), 12),
              (dict(nx=64, ny=64, shape="custom", inside_fn=notched_disk), 32),
              (dict(nx=64, ny=64), None), (dict(nx=1024, ny=1024), None),
              (dict(nx=1024, ny=1024, shape="custom", inside_fn=notched_disk), None),
              (dict(nx=4096, ny=4096), None), (dict(nx=8192, ny=8192), None),
              (dict(nx=8192, ny=8192), 256)]


@pytest.mark.parametrize("kw,by", A1_LAYOUTS)
def test_a1_c1_bit_equal_to_plain(gen, kw, by):
    """A1 (C1 on the disk) on unmasked random input: every read is masked,
    every node takes the plain version's rounding order, so the tiles equal
    ``apply_plain`` bit for bit; one launch, no plain call."""
    lay = PaddedStencilOperator.from_domain(Domain2D(**kw), block_rows=by)
    x = torch.randn(lay.padded_shape, device="cuda", generator=gen)
    tj, blocks = lay.tile_grid(_build.sm_count(x.device))
    assert lay.padded_shape[0] % tj == 0 and blocks * tj * 128 == x.numel()
    _build.reset_counts()
    y = lay(x)
    assert dict(_build.launches) == {"stencil" if lay.mask8 is None else "stencil_custom": 1}
    assert not _build.plain_on_cuda
    assert torch.equal(y, lay.apply_plain(x))


@pytest.mark.parametrize("n,by", [(64, 32), (1024, None)])
def test_custom_kernels_match_plain(gen, n, by):
    """The *_custom launchers on the notched disk: 32-row bands at 64², the
    operator's own layout at 1024²; pre-masked inputs (the solver's
    invariant, and the TPU custom kernels' contract)."""
    dom = Domain2D(nx=n, ny=n, shape="custom", inside_fn=notched_disk)
    lay = PaddedStencilOperator.from_domain(dom, block_rows=by)
    k = MultigridPreconditioner.from_domain(dom, fuse=True, fuse_min_extent=16,
                                            device="cuda").levels[0].kernels
    assert lay.mask8 is not None and k.mask8 is not None
    m = lay.mask_spec.build("cuda")
    x, r, z, w, u = (torch.where(m, torch.randn(lay.padded_shape, device="cuda", generator=gen),
                                 0.0) for _ in range(5))
    _build.reset_counts()
    assert torch.equal(lay(x), lay.apply_plain(x))
    beta = torch.tensor(0.37, device="cuda")
    scal = torch.tensor([-2.0e-4, 0.37], device="cuda")
    got, ref = cg_fused.k1(w, z, beta, lay), cg_fused.k1_plain(w, z, beta, lay)
    _close(got[0], ref[0])
    _sum_close(got[1], ref[1], float((w * (w + beta * z)).abs().sum()))
    side_r, side_w = cg_fused.k1_plain(r, z, beta, lay)[0], ref[0]
    for uu in (None, u):
        for got, ref in ((cg_fused.k2(x, r, z, side_r, scal, lay, u=uu),
                          cg_fused.k2_plain(x, r, z, side_r, scal, lay, u=uu)),
                         (cg_fused.k2_pcg(x, r, z, w, side_w, scal, lay, u=uu),
                          cg_fused.k2_pcg_plain(x, r, z, w, side_w, scal, lay, u=uu))):
            for g, e in zip(got[:3], ref[:3]):
                _close(g, e)
            _sum_close(got[3], ref[3], float(ref[3].sum()))
    mk = k.mask_spec.build("cuda")
    b = torch.where(mk, torch.randn(k.padded_shape, device="cuda", generator=gen), 0.0)
    ec = torch.randn(k.coarse_shape, device="cuda", generator=gen)
    _close(k.down(b), k.down_plain(b))
    _close(k.up(b, ec), k.up_plain(b, ec))
    (o, dot), (o_ref, dot_ref) = k.up(b, ec, with_dot=True), k.up_plain(b, ec, with_dot=True)
    _close(o, o_ref)
    assert abs(float(dot) - float(dot_ref)) <= 64 * EPS32 * float((b * o_ref).abs().sum())
    f64 = dict(device="cuda", dtype=torch.float64, generator=gen)
    bh, bl = split_f64(torch.where(m, torch.randn(lay.padded_shape, **f64), 0.0) * 1e4)
    xh, xl = split_f64(torch.where(m, torch.randn(lay.padded_shape, **f64), 0.0))
    gh, gl = resid_ff.resid_ff(xh, xl, bh, bl, lay)
    rh, rl = resid_ff.resid_ff_plain(xh, xl, bh, bl, lay)
    assert torch.equal(gh, rh)
    assert float((gl - rl).abs().max()) <= 32 * float(bh.abs().max()) * 2.0**-48
    launched = {name for name, count in _build.launches.items() if count > 0}
    assert launched == {"stencil_custom", "k1_custom", "k2_custom", "k2_pcg_custom",
                        "k_down_custom", "k_up_custom", "k_resid_ff_custom"}


@pytest.mark.parametrize("dims", BOXES)
def test_3d_kernels_match_plain(gen, dims):
    """S7, J3, R3 on level 0; D3 and U3 bit-equal to their plain versions at
    every fused level, onto a fused child's padded canvas (32³ level 0) and
    a plain child's grid (the others), with ``ec`` on the child's layout."""
    dom = Domain3D(*dims)
    lay = Padded3DStencilOperator.from_domain(dom)
    x, b, xj = (torch.randn(lay.padded_shape, device="cuda", generator=gen) for _ in range(3))
    _close(lay(x), lay.apply_plain(x))  # unmasked inputs: the kernels mask their reads
    M = MultigridPreconditioner.from_domain(dom, fuse=True, fuse_min_extent=16, device="cuda")
    k = M.levels[0].kernels
    assert k.padded_shape == lay.padded_shape
    for lev in M.levels[:-1]:
        kl = lev.kernels
        bl = torch.randn(kl.padded_shape, device="cuda", generator=gen)
        ec = torch.randn(kl.child_shape, device="cuda", generator=gen)
        assert torch.equal(kl.down(bl), kl.down_plain(bl))
        assert torch.equal(kl.up(bl, ec), kl.up_plain(bl, ec))
    _close(k.jacobi(xj, b), k.jacobi_plain(xj, b))
    m = lay.mask_spec.build("cuda")
    f64 = dict(device="cuda", dtype=torch.float64, generator=gen)
    bh, bl = split_f64(torch.where(m, torch.randn(lay.padded_shape, **f64), 0.0) * 1e4)
    xh, xl = split_f64(torch.where(m, torch.randn(lay.padded_shape, **f64), 0.0))
    gh, gl = resid_ff.resid_ff(xh, xl, bh, bl, lay)
    rh, rl = resid_ff.resid_ff_plain(xh, xl, bh, bl, lay)
    assert torch.equal(gh, rh)
    assert float((gl - rl).abs().max()) <= 32 * float(bh.abs().max()) * 2.0**-48


def test_wrappers_reject_bad_input(gen):
    lay = PaddedStencilOperator.from_domain(Domain2D(nx=64, ny=64))
    f = torch.zeros(lay.padded_shape, device="cuda")
    beta = torch.zeros((), device="cuda")
    with pytest.raises(TypeError):
        cg_fused.k1(f.double(), f, beta, lay)
    with pytest.raises(ValueError):
        cg_fused.k1(f[:, :-128], f, beta, lay)
    with pytest.raises(ValueError):
        cg_fused.k1(f.t().contiguous().t(), f, beta, lay)  # non-contiguous
    with pytest.raises(TypeError):
        lay(f.double())
    with pytest.raises(ValueError, match="16-byte"):  # A1 stages x in 16-byte pieces
        lay(torch.zeros(f.numel() + 1, device="cuda")[1:].view(lay.padded_shape))
    with pytest.raises(ValueError):
        resid_ff.resid_ff(f, f, f, f.cpu(), lay)  # mixed devices


@pytest.mark.parametrize("shape,n,by", [("gamma", 64, 16), ("rect", 40, 16), ("gamma", 1024, None),
                                        ("custom", 64, 32), ("gamma", 8192, None)])
def test_inplace_pipelined_match_plain_and_a1(gen, shape, n, by):
    """C4 and C5 on an unmasked field: bit-equal to A1 at scale 1, within
    tolerance of their plain versions with the chain's scale; the in-place
    results in x's own storage; C5 both ways and at lookahead 2 and 4.
    8192² at auto_block_rows (8256 rows, 64-row panels): on a card of 132
    SMs the kernels' ranges of 63 rows end inside panels."""
    fn = notched_disk if shape == "custom" else None
    lay = PaddedStencilOperator.from_domain(Domain2D(nx=n, ny=n, shape=shape, inside_fn=fn),
                                            block_rows=by)
    x = torch.randn(lay.padded_shape, device="cuda", generator=gen)
    _build.reset_counts()
    a1 = lay(x)
    xc = x.clone()
    ptr = xc.data_ptr()
    y = sp.stencil_apply_inplace(xc, lay)
    assert y.data_ptr() == ptr and torch.equal(xc, a1)
    xc = x.clone()
    _close(sp.stencil_apply_inplace(xc, lay, 7e-6), sp.inplace_plain(x.clone(), lay, 7e-6))
    for lookahead in (2, 4):
        xc = x.clone()
        y = sp.stencil_apply_pipelined(xc, lay, lookahead=lookahead)
        assert y.data_ptr() == xc.data_ptr() and torch.equal(y, a1)
        y = sp.stencil_apply_pipelined(x, lay, in_place=False, lookahead=lookahead)
        assert y.data_ptr() != x.data_ptr() and torch.equal(y, a1)
    _close(sp.stencil_apply_pipelined(x.clone(), lay, scale=7e-6),
           sp.pipelined_plain(x.clone(), lay, scale=7e-6))
    sfx = "_custom" if shape == "custom" else ""
    assert _build.launches["stencil_inplace" + sfx] == 2
    assert _build.launches["stencil_pipelined" + sfx] == 5
    assert set(_build.plain_on_cuda) == {"stencil_inplace" + sfx, "stencil_pipelined" + sfx}


def test_inplace_pipelined_reject_bad_input(gen):
    lay = PaddedStencilOperator.from_domain(Domain2D(nx=64, ny=64), block_rows=16)
    x = torch.zeros(lay.padded_shape, device="cuda")
    with pytest.raises(TypeError):
        sp.stencil_apply_inplace(x.double(), lay)
    with pytest.raises(ValueError):
        sp.stencil_apply_pipelined(x[:, :-128].contiguous(), lay)
    with pytest.raises(ValueError):
        sp.stencil_apply_pipelined(x, lay, lookahead=5)
    # 20096 columns: three rows need 241152 bytes, more than a block's 232448
    wide = PaddedStencilOperator.from_domain(Domain2D(nx=20000, ny=16, shape="rect"))
    xw = torch.zeros(wide.padded_shape, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        sp.stencil_apply_inplace(xw, wide)
    with pytest.raises(ValueError, match="shared memory"):
        sp.stencil_apply_pipelined(xw, wide)


def test_cuda_fma_pass_equals_exact_fma(gen):
    """The plain 3D sum's fma on CUDA (one ``addcmul`` pass) equals the
    exact emulation of the CPU path bit for bit, on terms spread over 24
    binades and the stencil's coefficient scales."""
    n = 1 << 22
    b, c = (torch.randn(n, device="cuda", generator=gen)
            * torch.exp2(torch.randint(-12, 12, (n,), device="cuda", generator=gen).float())
            for _ in range(2))
    for a in (1.0 / 3.0, -6.0 * 262144.0, 262144.0 * 1.000001):
        assert torch.equal(stencil_ops._fma_f32_cuda(a, b, c), stencil_ops.fma_f32(a, b, c))


@pytest.mark.parametrize("dims", BOXES)
def test_stencil3d_bit_equal_to_plain(gen, dims):
    """S7 writes the fmaf chain that the plain version computes (XLA's
    order, ops/stencil.combine7): bit for bit, unmasked input."""
    lay = Padded3DStencilOperator.from_domain(Domain3D(*dims))
    x = torch.randn(lay.padded_shape, device="cuda", generator=gen)
    assert torch.equal(lay(x), lay.apply_plain(x))


@pytest.mark.parametrize("dims", BOXES + [(64, 64, 64)])
def test_j3_bit_equal_to_plain_at_every_fused_level(gen, dims):
    """J3 writes ist3::smooth7, x + cs (b - A x) rounded as its plain
    version rounds: bit for bit on every fused level's layout, unmasked
    input."""
    M = MultigridPreconditioner.from_domain(Domain3D(*dims), fuse=True, fuse_min_extent=16,
                                            device="cuda")
    levels = [lev.kernels for lev in M.levels if isinstance(lev, _FusedLevel3D)]
    assert len(levels) >= (3 if dims == (64, 64, 64) else 1)
    _build.reset_counts()
    for k in levels:
        x, b = (torch.randn(k.padded_shape, device="cuda", generator=gen) for _ in range(2))
        assert torch.equal(k.jacobi(x, b), k.jacobi_plain(x, b))
    assert _build.launches["k_jacobi3d"] == len(levels)


def _virtual(shape):
    """The ranks of a mesh shape, for a block partition run in one process."""
    names = ("slice", "y", "x") if len(shape) == 3 else ("y", "x")
    return [SolverMesh(names, shape, rank=r) for r in range(math.prod(shape))]


def _stitch(meshes, parts):
    rows = [[p for m, p in zip(meshes, parts) if m.coords[0] == ri]
            for ri in range(meshes[0].rows)]
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=0)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 2)])
def test_mesh_block_kernels_match_single_device(gen, mesh_shape):
    """D1, D3 and D4 on every block of a partition of the 1024² Г grid (D2:
    a (2, 1, 2) split of 32³), each block's halos cut from the global field
    as the ring exchange delivers them: each launch within tolerance of its
    plain version, and the stitched blocks bit-equal to the single-device
    kernels (A1, A5, A6, S7) at every node, edges included: D3's through the
    lane restriction and child mask that the mesh applies between its legs,
    D4's fed the lane prolongation of A6's coarse correction."""
    dom = Domain2D(nx=1024, ny=1024)
    meshes = _virtual(mesh_shape)
    ops = [ShardedPallasStencilOperator.from_domain(dom, m) for m in meshes]
    # a level is the same on every rank (each call takes its block's origin)
    levs = [ShardedFusedMultigrid.from_operator(ops[0], dom, fuse_min_extent=33,
                                                device="cuda").levels[0]] * len(ops)
    (hp, wp), by = ops[0].padded_shape, ops[0].block_rows
    x = torch.randn((hp, wp), device="cuda", generator=gen)
    # the single-device legs take the child's grid (513, 513); the blocks
    # its lane prolongation, as the mesh forms it between its legs
    ec = torch.randn((513, 513), device="cuda", generator=gen)
    ecl = F.pad(lane_prolong(ec, 512, wp), (0, 0, 0, hp // 2 - 513))
    _build.reset_counts()
    outs = {"D1": [], "D3": [], "D4": []}
    for op, lev in zip(ops, levs):
        halos = op.halos_from_global(x, op.origin)
        outs["D1"].append(op.apply_block(*halos))
        _close(outs["D1"][-1], block_stencil_plain(*halos, op.block_spec(), op.coeffs))
        dh = lev.down_halos_from_global(x, op.origin)
        outs["D3"].append(lev.down_block(*dh, op.origin))
        _close(outs["D3"][-1], lev.down_plain(*dh, op.origin))
        uh = lev.up_halos_from_global(x, ecl, op.origin)
        o, part = lev.up_block(*uh, op.origin, with_dot=True)
        o_ref, part_ref = lev.up_plain(*uh, op.origin, with_dot=True)
        _close(o, o_ref)
        assert abs(float(part) - float(part_ref)) <= 64 * EPS32 * float(
            (uh[0] * o_ref).abs().sum())
        outs["D4"].append(o)
    lev = levs[0]
    single = FusedLevelKernels(1024, 1024, lev.coeffs, lev.cs, "gamma", (hp, wp), by,
                               (513, 513))
    lay = PaddedStencilOperator(1024, 1024, ops[0].coeffs, (1025, 1025), (hp, wp), by, "gamma")
    assert torch.equal(_stitch(meshes, outs["D1"]), lay(x))
    # D3's stitch through the mesh's lane restriction and child mask: A5's
    # coarse field
    rc = lane_restrict(_stitch(meshes, outs["D3"])[:513], 1024, 513)
    rc = torch.where(single.child_spec.build("cuda"), rc, 0.0)
    assert torch.equal(rc, single.down(x))
    assert torch.equal(_stitch(meshes, outs["D4"]), single.up(x, ec))
    box = Domain3D(32, 32, 32)
    meshes3 = _virtual((2, 1, 2))
    ops3 = [ShardedPallas3DStencilOperator.from_domain(box, m) for m in meshes3]
    x3 = torch.randn(ops3[0].padded_shape, device="cuda", generator=gen)
    parts = []
    for op in ops3:
        halos = op.halos_from_global(x3, op.origin)
        parts.append(op.apply_block(*halos))
        _close(parts[-1], block_stencil3d_plain(*halos, op.block_spec(), op.coeffs))
    s7 = Padded3DStencilOperator.from_domain(box)
    d, h, w = s7.padded_shape
    assert torch.equal(_stitch(meshes3, parts)[:d, :h, :w], s7(x3[:d, :h, :w].contiguous()))
    n = len(meshes)
    assert {k: v for k, v in _build.launches.items() if v} == {
        "stencil_block": n, "k_down_block": n, "k_up_block": n, "stencil": 1, "k_down": 1,
        "k_up": 1, "stencil3d_block": 4, "stencil3d": 1}


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("pcg", [False, True])
def test_engine_block_kernels_match_single_device(gen, mesh_shape, pcg):
    """D5 and D6 (MSG or PCG, with and without u) on every block of a
    partition of the 1024² Г grid, each block's halos cut from the global
    fields as the engine's exchange delivers them (on (1, 1) the ring hands
    the block its own last row and column): each launch within tolerance of
    its plain version, one partial per tile of ``tile_grid``, and the
    stitched side rows, x', r' and z_k bit-equal to K1 and K2 / K2-pcg on
    the whole canvas at every node, edges included; the summed partials
    within 64 eps32 of their terms."""
    from iterative_solvers_tpu_torch.parallel import cg_fused_sharded as S

    dom = Domain2D(nx=1024, ny=1024)
    meshes = _virtual(mesh_shape)
    ops = [ShardedPallasStencilOperator.from_domain(dom, m) for m in meshes]
    (hp, wp), by = ops[0].padded_shape, ops[0].block_rows
    lay = PaddedStencilOperator(1024, 1024, ops[0].coeffs, (1025, 1025), (hp, wp), by, "gamma")
    mask = lay.mask_spec.build("cuda")
    x, r, z, w, u = (torch.where(mask, torch.randn((hp, wp), device="cuda", generator=gen), 0.0)
                     for _ in range(5))
    beta = torch.tensor(0.37, device="cuda")
    scal = torch.tensor([-1.3e-4, 0.37], device="cuda")
    d = w if pcg else r
    side_ref, rz_ref, azz_ref, _ = cg_fused.k1(d, z, beta, lay)
    _build.reset_counts()
    sides, rz, azz, outs = [], 0.0, 0.0, {False: [], True: []}
    for op in ops:
        db, zb, up, dn, left, right = S.halos_from_global(op, d, z)
        got = S.k1_block(db, zb, beta, up, dn, left, right, op)
        ref = S.k1_block_plain(db, zb, beta, up, dn, left, right, op)
        _close(got[0], ref[0])
        tiles = {k: cg_fused.tile_grid(k, op.block_shape, by, _build.sm_count(x.device))[1]
                 for k in ("k1", "k2")}
        assert all(p.shape == (tiles["k1"],) for p in got[1:])
        sides.append(got[0])
        rz, azz = rz + float(got[1].double().sum()), azz + float(got[2].double().sum())
        (h, wd), (r0, c0) = op.block_shape, op.origin
        cut = [f[r0:r0 + h, c0:c0 + wd].contiguous() for f in (x, r, z, w, u)]
        for with_u in (False, True):
            ub = cut[4] if with_u else None
            if pcg:
                got2 = S.k2_pcg_block(*cut[:4], got[0], left, right, scal, op, ub)
                ref2 = S.k2_pcg_block_plain(*cut[:4], got[0], left, right, scal, op, ub)
            else:
                got2 = S.k2_block(*cut[:3], got[0], left, right, scal, op, ub)
                ref2 = S.k2_block_plain(*cut[:3], got[0], left, right, scal, op, ub)
            for a, b in zip(got2[:3], ref2[:3]):
                _close(a, b)
            assert all(p.shape == (tiles["k2"],) for p in got2[3:])
            outs[with_u].append(got2)
    assert torch.equal(_stitch(meshes, sides), side_ref)
    dz = (d * (d + beta * z)).double().abs().sum()
    assert abs(rz - float(rz_ref.double().sum())) <= 64 * EPS32 * float(dz)
    assert abs(azz - float(azz_ref.double().sum())) <= 64 * EPS32 * abs(float(azz_ref.sum()))
    for with_u in (False, True):
        uu = u if with_u else None
        ref_all = (cg_fused.k2_pcg(x, r, z, w, side_ref, scal, lay, u=uu) if pcg
                   else cg_fused.k2(x, r, z, side_ref, scal, lay, u=uu))
        for i in range(3):
            assert torch.equal(_stitch(meshes, [o[i] for o in outs[with_u]]), ref_all[i])
        r2 = sum(float(o[3].double().sum()) for o in outs[with_u])
        assert abs(r2 - float(ref_all[3].double().sum())) <= 64 * EPS32 * r2
        for i in (4, 5) if with_u else (4,):
            assert max(float(o[i].max()) for o in outs[with_u]) == float(ref_all[i].max())
    n = len(meshes)
    k2 = "k2_pcg" if pcg else "k2"
    assert {k: v for k, v in _build.launches.items() if v} == {
        "k1_block": n, f"{k2}_block": 2 * n, k2: 2}


# the staged z-march (csrc/zstream3d.cuh): D2 on mesh splits of the box,
# R3 with and without the delta term, power-of-two and other coefficients
SPLITS = [(1, 1, 1), (1, 1, 2), (2, 1, 1), (2, 1, 2)]


@pytest.mark.parametrize("dims", [(16, 16, 16), (16, 24, 8)])
@pytest.mark.parametrize("split", SPLITS)
def test_d2_blocks_bit_equal_to_plain_and_s7(gen, dims, split):
    """D2 on every block of a split of the box, its halos cut from the
    global field as the ring exchange delivers them (on (1, 1, 1) the block
    wraps onto itself): each block bit-equal to its plain version, the
    stitched blocks bit-equal to S7 at every node."""
    box = Domain3D(*dims)
    meshes = _virtual(split)
    ops = [ShardedPallas3DStencilOperator.from_domain(box, m) for m in meshes]
    x = torch.randn(ops[0].padded_shape, device="cuda", generator=gen)
    _build.reset_counts()
    parts = []
    for op in ops:
        halos = op.halos_from_global(x, op.origin)
        parts.append(op.apply_block(*halos))
        assert torch.equal(parts[-1], block_stencil3d_plain(*halos, op.block_spec(), op.coeffs))
    s7 = Padded3DStencilOperator.from_domain(box)
    d, h, w = s7.padded_shape
    assert torch.equal(_stitch(meshes, parts)[:d, :h, :w], s7(x[:d, :h, :w].contiguous()))
    assert _build.launches["stencil3d_block"] == len(ops)


def _ff_layout(dims, coeffs):
    """The box's layout; ``"delta"``: a diagonal off -2 Σc (the delta term)
    and a y coefficient that is not a power of two."""
    lay = Padded3DStencilOperator.from_domain(Domain3D(*dims))
    if coeffs == "delta":
        cd, cx, cy, cz = lay.coeffs
        lay = dataclasses.replace(lay, coeffs=(cd - 0.37, cx, cy * 1.1, cz))
    return lay


@pytest.mark.parametrize("dims", BOXES)
@pytest.mark.parametrize("coeffs", ["box", "delta"])
def test_r3_bit_equal_to_plain(gen, dims, coeffs):
    """R3's pair bit-equal to its plain version, both words, on unmasked
    x (the kernel masks its reads)."""
    from iterative_solvers_tpu_torch.ops.ddf32 import coeff_delta, is_pow2

    lay = _ff_layout(dims, coeffs)
    assert (coeff_delta(lay.coeffs) != 0.0) == (coeffs == "delta")
    assert all(is_pow2(c) for c in lay.coeffs[1:]) == (coeffs == "box" and dims != (16, 24, 8))
    m = lay.mask_spec.build("cuda")
    f64 = dict(device="cuda", dtype=torch.float64, generator=gen)
    bh, bl = split_f64(torch.where(m, torch.randn(lay.padded_shape, **f64), 0.0) * 1e4)
    xh, xl = split_f64(torch.randn(lay.padded_shape, **f64))
    _build.reset_counts()
    gh, gl = resid_ff.resid_ff(xh, xl, bh, bl, lay)
    rh, rl = resid_ff.resid_ff_plain(xh, xl, bh, bl, lay)
    assert torch.equal(gh, rh) and torch.equal(gl, rl)
    assert _build.launches["k_resid_ff3d"] == 1


def test_zstream_launchers_refuse_bad_operands(gen):
    """S7, J3, D2 and R3 refuse operands off a 16-byte boundary, D2 and R3
    halos of the wrong shape; their launchers refuse a canvas that is not a
    whole number of 8 x 128 tiles."""
    box = Domain3D(16, 16, 16)
    lay = Padded3DStencilOperator.from_domain(box)
    f = torch.zeros(lay.padded_shape, device="cuda")
    odd = torch.zeros(f.numel() + 1, device="cuda")[1:].view(lay.padded_shape)
    k = MultigridPreconditioner.from_domain(box, fuse=True, fuse_min_extent=16,
                                            device="cuda").levels[0].kernels
    with pytest.raises(ValueError, match="16-byte"):
        lay(odd)
    with pytest.raises(ValueError, match="16-byte"):
        k.jacobi(f, odd)
    d, hp, wp = lay.padded_shape
    with pytest.raises(RuntimeError, match="ist_stencil3d"):
        _build.launch("ist_stencil3d", _build.ptr(f), _build.ptr(f), 16, 16, 16, d, hp, wp - 64,
                      8, *lay.coeffs)
    with pytest.raises(RuntimeError, match="ist_k_jacobi3d"):
        _build.launch("ist_k_jacobi3d", *map(_build.ptr, (f,) * 3), 16, 16, 16, d, hp - 4, wp,
                      8, *k.coeffs, k.cs)
    with pytest.raises(ValueError, match="16-byte"):
        resid_ff.resid_ff(f, odd, f, f, lay)
    with pytest.raises(ValueError):
        resid_ff.resid_ff(f, f, f[:, :-8].contiguous(), f, lay)
    op = ShardedPallas3DStencilOperator.from_domain(box, _virtual((1, 1, 1))[0])
    x, zup, zdn, left, right = op.halos_from_global(f, (0, 0, 0))
    xodd = torch.zeros(x.numel() + 1, device="cuda")[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        op.apply_block(xodd, zup, zdn, left, right)
    with pytest.raises(ValueError):
        op.apply_block(x, zup[:-8], zdn, left, right)
    with pytest.raises(ValueError):
        op.apply_block(x, zup, zdn, left[:, :-1], right)
    dzb, hp, wb = op.block_shape
    y = torch.empty_like(x)
    ptrs = map(_build.ptr, (x, zup, zdn, left, right, y))
    with pytest.raises(RuntimeError, match="ist_stencil3d_block"):
        _build.launch("ist_stencil3d_block", *ptrs, 16, 16, 16, dzb, hp - 4, wb, 8, 0, 0,
                      *op.coeffs)
    with pytest.raises(RuntimeError, match="ist_k_resid_ff3d"):
        _build.launch("ist_k_resid_ff3d", *map(_build.ptr, (f,) * 6), 16, 16, 16, dzb, hp,
                      wb - 64, 8, 1, 1, 1, 0, *lay.coeffs, *[0.0] * 9, 0.0)


@pytest.mark.parametrize("n,mesh_shape", [(200, (1, 1)), (300, (2, 2))])
@pytest.mark.parametrize("tj", [4, 8, 16])
def test_mesh_legs_bit_equal_to_plain_at_each_tile_height(gen, monkeypatch, n, mesh_shape, tj):
    """D3 and D4 (the leg tiles of csrc/mg_tiles.cuh on a mesh block) on
    every block of the partition, at each tile height their launchers take
    (D4: 4 and 8), bit-equal to their plain versions: the 1x1 block of 200²
    with the ring's own edges as halos (Hb/2 = 104 rows: D3's last tile cut
    at 16), the (2, 2) blocks of 300² (two column strips each, interior halo
    rows and columns) with raw random halos; D4's dot within 64 eps32 of
    the sum of its terms' magnitudes."""
    dom = Domain2D(nx=n, ny=n)
    meshes = _virtual(mesh_shape)
    ops = [ShardedPallasStencilOperator.from_domain(dom, m, block_rows=16) for m in meshes]
    lev = ShardedFusedMultigrid.from_operator(ops[0], dom, fuse_min_extent=33,
                                              device="cuda").levels[0]
    monkeypatch.setattr(type(lev), "down_tile_rows", lambda self, sms: tj)
    monkeypatch.setattr(type(lev), "up_tile_rows", lambda self, sms: min(tj, 8))
    hp, wp = lev.padded_shape
    x = torch.randn((hp, wp), device="cuda", generator=gen)
    ec = torch.randn((hp // 2, wp), device="cuda", generator=gen)
    for op in ops:
        dh = lev.down_halos_from_global(x, op.origin)
        uh = lev.up_halos_from_global(x, ec, op.origin)
        if mesh_shape != (1, 1):  # raw halos of any value: every read is masked
            dh = dh[:1] + tuple(torch.randn(t.shape, device="cuda", generator=gen)
                                for t in dh[1:])
            uh = tuple(t if k in (0, 5) else torch.randn(t.shape, device="cuda", generator=gen)
                       for k, t in enumerate(uh))
        assert torch.equal(lev.down_block(*dh, op.origin), lev.down_plain(*dh, op.origin))
        out, part = lev.up_block(*uh, op.origin, with_dot=True)
        ref, part_ref = lev.up_plain(*uh, op.origin, with_dot=True)
        assert torch.equal(out, ref)
        bm = torch.where(lev.spec(op.origin).build("cuda"), uh[0], 0.0)
        assert abs(float(part) - float(part_ref)) <= 64 * EPS32 * float((bm * ref).abs().sum())


def test_mesh_leg_launchers_refuse_bad_operands(gen):
    """D3 and D4 refuse operands off a 16-byte boundary; D4's launcher
    refuses a tile height whose tiles do not divide the block."""
    dom = Domain2D(nx=200, ny=200)
    op = ShardedPallasStencilOperator.from_domain(dom, _virtual((1, 1))[0], block_rows=16)
    lev = ShardedFusedMultigrid.from_operator(op, dom, fuse_min_extent=33,
                                              device="cuda").levels[0]
    hb, wb = lev.block_shape
    x = torch.zeros((hb, wb), device="cuda")
    dh = lev.down_halos_from_global(x, (0, 0))
    uh = lev.up_halos_from_global(x, torch.zeros((hb // 2, wb), device="cuda"), (0, 0))
    odd = torch.zeros(x.numel() + 1, device="cuda")[1:].view(hb, wb)
    with pytest.raises(ValueError, match="16-byte"):
        lev.down_block(odd, *dh[1:], (0, 0))
    with pytest.raises(ValueError, match="16-byte"):
        lev.up_block(odd, *uh[1:], (0, 0))
    nx, ny, gamma, hb_, wb_, _, roff, coff = lev._geom((0, 0), 8)
    out = torch.empty_like(x)
    with pytest.raises(RuntimeError, match="ist_k_up_block"):  # 2 x 16 rows: 208 % 32 != 0
        _build.launch("ist_k_up_block", *map(_build.ptr, (*uh, out, None)), nx, ny, gamma, hb_,
                      wb_, 16, lev.ch, roff, coff, *lev.coeffs, lev.cs)

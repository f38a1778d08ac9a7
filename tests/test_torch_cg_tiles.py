"""The tile rule of the fused CG kernels K1 and K2 (``kernels.cg_fused.
tile_grid``) on the layouts the solver runs them on, one device's canvas
or a mesh block (D5 and D6 are K1's and K2's tiles on the block): the tile
height divides the band height ``block_rows`` (a tile never straddles a
band, whose edge rows K1 hands to K2 through the side buffer), and where
the layout has the rows for it the grid puts at least two blocks on each
of the H100's 132 SMs. Pure arithmetic on the layouts: no card."""

import pytest
import torch

from iterative_solvers_tpu_torch import Domain2D
from iterative_solvers_tpu_torch.core.domain import notched_disk
from iterative_solvers_tpu_torch.kernels.cg_fused import BLOCKS_PER_SM, TW, tile_grid
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.parallel import SolverMesh, ShardedPallasStencilOperator
from iterative_solvers_tpu_torch.parallel.cg_fused_sharded import check_aligned

H100_SMS = 132

# name: (domain, block_rows or None for the operator's own,
#        K1's (tile rows, blocks), K2's (tile rows, blocks))
LAYOUTS = {
    "path B 1024^2": (dict(nx=1024, ny=1024), None, (16, 720), (8, 1440)),
    "C-B 1024^2 disk": (dict(nx=1024, ny=1024, shape="custom", inside_fn=notched_disk), None,
                        (16, 720), (8, 1440)),
    "8192^2 level 0": (dict(nx=8192, ny=8192), None, (32, 16770), (8, 67080)),
    "gamma 64^2": (dict(nx=64, ny=64), 16, (8, 10), (8, 10)),
    "rect 40x50": (dict(nx=40, ny=50, shape="rect"), 16, (8, 8), (8, 8)),
    "custom 64^2": (dict(nx=64, ny=64, shape="custom", inside_fn=notched_disk), 32, (8, 12),
                    (8, 12)),
}


@pytest.mark.parametrize("kernel", ["k1", "k2"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tiles_divide_the_band_and_fill_the_card(name, kernel):
    kw, by, want_k1, want_k2 = LAYOUTS[name]
    lay = PaddedStencilOperator.from_domain(Domain2D(**kw), block_rows=by)
    (hp, wp), by = lay.padded_shape, lay.block_rows
    tj, blocks = tile_grid(kernel, lay.padded_shape, by, H100_SMS)
    assert (tj, blocks) == (want_k1 if kernel == "k1" else want_k2)
    assert by % tj == 0 and hp % tj == 0
    assert blocks == (hp // tj) * (wp // TW)  # one block per tile
    if (hp // 8) * (wp // TW) >= 2 * H100_SMS:  # the layout has the rows for two per SM
        assert blocks >= 2 * H100_SMS
    if kernel == "k1" and blocks < BLOCKS_PER_SM * H100_SMS:
        assert tj == 8  # a grid too small to fill the card: the shortest tile


def test_tiles_refuse_bands_they_cannot_tile():
    for kernel in ("k1", "k2"):
        with pytest.raises(ValueError, match="block_rows"):
            tile_grid(kernel, (96, 128), 12, H100_SMS)


# the mesh blocks D5 / D6 run on: name: (grid n, mesh shape, block shape,
# block_rows, K1's (tile rows, blocks), K2's (tile rows, blocks)) per rank
BLOCK_LAYOUTS = {
    "1024^2 on 1x1": (1024, (1, 1), (1152, 1152), 128, (16, 648), (8, 1296)),
    "2048^2 on (2, 2)": (2048, (2, 2), (1152, 1152), 128, (16, 648), (8, 1296)),
    "8192^2 on 1x1": (8192, (1, 1), (8256, 8320), 64, (32, 16770), (8, 67080)),
    "8192^2 on (4, 2)": (8192, (4, 2), (2176, 4224), 128, (32, 2244), (8, 8976)),
}


@pytest.mark.parametrize("kernel", ["k1", "k2"])
@pytest.mark.parametrize("name", list(BLOCK_LAYOUTS))
def test_block_tiles_divide_the_band_and_fill_the_card(name, kernel):
    n, shape, block, by, want_k1, want_k2 = BLOCK_LAYOUTS[name]
    ranks = shape[0] * shape[1]
    ops = [ShardedPallasStencilOperator.from_domain(Domain2D(nx=n, ny=n),
                                                    SolverMesh(("y", "x"), shape, rank=k))
           for k in range(ranks)]
    for op in ops:  # every rank holds the same block, so launches the same grid
        assert (op.block_shape, op.block_rows) == (block, by)
        tj, blocks = tile_grid(kernel, op.block_shape, op.block_rows, H100_SMS)
        assert (tj, blocks) == (want_k1 if kernel == "k1" else want_k2)
        assert op.block_rows % tj == 0 and block[0] % op.block_rows == 0
        assert blocks == (block[0] // tj) * (block[1] // TW)  # one partial per tile
        assert blocks >= 2 * H100_SMS
    origins = {op.origin for op in ops}
    assert len(origins) == ranks and all(r % by == 0 and c % TW == 0 for r, c in origins)


def test_block_kernels_refuse_unaligned_operands():
    ok = torch.zeros((2, 256))
    check_aligned(up=ok, left=ok[1], u=None)  # rows of a 128-multiple width stay aligned
    with pytest.raises(ValueError, match="left: the kernels need 16-byte aligned"):
        check_aligned(up=ok, left=torch.zeros(257)[1:])

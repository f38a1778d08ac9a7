"""The tiles of the padded stencil A1 and its masked form C1
(``PaddedStencilOperator.tile_grid``, K1's rule ``kernels.stencil_layout.
tile_grid`` over the canvas's rows) on the layouts the solver runs them on:
the tile height divides the canvas, one block a tile of TJ rows by 128
columns covers it once, and where the layout has the rows for it the grid
puts four blocks on each of the H100's 132 SMs. The kernel itself is held
to the plain version on the card (``tests/test_torch_cuda.py``). No card."""

import pytest

from iterative_solvers_tpu_torch import Domain2D
from iterative_solvers_tpu_torch.core.domain import notched_disk
from iterative_solvers_tpu_torch.kernels.stencil_layout import (
    BLOCKS_PER_SM,
    TW,
    PaddedStencilOperator,
    kernel_geometry,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

H100_SMS = 132
DISK = dict(shape="custom", inside_fn=notched_disk)

# name: (domain, block_rows or None for the operator's own, padded shape,
#        band rows, (tile rows, blocks) on 132 SMs)
LAYOUTS = {
    "path B 1024^2": (dict(nx=1024, ny=1024), None, (1280, 1152), 256, (16, 720)),
    "C-B 1024^2 disk": (dict(nx=1024, ny=1024, **DISK), None, (1280, 1152), 256, (16, 720)),
    "precond 4096^2": (dict(nx=4096, ny=4096), None, (4224, 4224), 128, (32, 4356)),
    "8192^2 level 0": (dict(nx=8192, ny=8192), None, (8256, 8320), 64, (32, 16770)),
    "8192^2 nnz": (dict(nx=8192, ny=8192), 256, (8448, 8320), 256, (32, 17160)),
    "gamma 64^2": (dict(nx=64, ny=64), None, (256, 128), 256, (8, 32)),
    "gamma 64^2 16-row": (dict(nx=64, ny=64), 16, (80, 128), 16, (8, 10)),
    "rect 40x50": (dict(nx=40, ny=50, shape="rect"), 16, (64, 128), 16, (8, 8)),
    "custom 64^2": (dict(nx=64, ny=64, **DISK), 32, (96, 128), 32, (8, 12)),
    "12-row bands 40^2": (dict(nx=40, ny=40), 12, (48, 128), 12, (8, 6)),
    "24-row bands 1024^2": (dict(nx=1024, ny=1024), 24, (1032, 1152), 24, (8, 1161)),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tiles_cover_the_canvas_and_fill_the_card(name):
    kw, by, shape, bands, want = LAYOUTS[name]
    lay = PaddedStencilOperator.from_domain(Domain2D(**kw), block_rows=by)
    assert (lay.padded_shape, lay.block_rows) == (shape, bands)  # the layout contract
    (hp, wp), by = lay.padded_shape, lay.block_rows
    tj, blocks = lay.tile_grid(H100_SMS)
    assert (tj, blocks) == want
    assert hp % tj == 0 and wp % TW == 0
    assert blocks == (hp // tj) * (wp // TW)  # one block a tile, each node once
    if (hp // 8) * (wp // TW) >= BLOCKS_PER_SM * H100_SMS:  # rows enough to fill the card
        assert blocks >= BLOCKS_PER_SM * H100_SMS
    else:
        assert tj == 8  # too small a grid: the shortest tile
    # the launcher's arguments: the tile rows in the band height's place,
    # the int8 mask operand first on a custom layout
    launcher, geom = kernel_geometry("ist_stencil", lay.nx, lay.ny, lay.mask_mode, hp, wp, tj,
                                     lay.mask8, "cpu")
    if lay.mask8 is None:
        assert launcher == "ist_stencil"
        assert geom == (lay.nx, lay.ny, int(lay.mask_mode == "gamma"), hp, wp, tj)
    else:
        assert launcher == "ist_stencil_custom" and geom[1:] == (lay.nx, lay.ny, hp, wp, tj)


def test_tiles_keep_to_the_canvas_not_the_bands():
    """Tiles read their halo rows from x, so bands of a height no tile
    divides still tile (12-row bands, 8-row tiles); a canvas whose rows are
    not a multiple of 8 does not."""
    kw, by, *_ = LAYOUTS["12-row bands 40^2"]
    lay = PaddedStencilOperator.from_domain(Domain2D(**kw), block_rows=by)
    assert lay.block_rows % lay.tile_grid(H100_SMS)[0] != 0
    lay = PaddedStencilOperator.from_domain(Domain2D(nx=40, ny=50, shape="rect"), block_rows=12)
    assert lay.padded_shape == (60, 128)
    with pytest.raises(ValueError, match="multiple of 8"):
        lay.tile_grid(H100_SMS)

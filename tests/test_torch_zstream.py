"""S7 and J3 on the staged z-march (``csrc/zstream3d.cuh``), replayed in
plain torch on the CPU (``_torch_zstream``): the replay of each kernel's
schedule (chunks, 8 x 128 tiles, staged planes, masked copies, the emit)
equals the kernel's plain version bit for bit, ``apply_plain`` for S7 and
``jacobi_plain`` for J3, on unmasked random input (the kernels mask their
reads). The chunks are those of ``zstream_chunk`` on cards of 132 and 114
SMs and a forced depth of 3 planes, whose last chunk is ragged. The JAX
side of both plain versions is held in ``test_torch_3d_kernels.py``; the
kernels themselves against their plain versions in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from _torch_zstream import zstream_replay
from iterative_solvers_tpu_torch import Domain3D
from iterative_solvers_tpu_torch.kernels.mg_fused3d import FusedLevelKernels3D
from iterative_solvers_tpu_torch.kernels.stencil3d_layout import (
    Padded3DStencilOperator,
    zstream_chunk,
)
from iterative_solvers_tpu_torch.solvers.multigrid import (
    MultigridPreconditioner,
    _FusedLevel3D,
    fused_layout_3d,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

OMEGA = 0.8
# (nx, ny, nz): D = 17, the ragged D = 33, unequal extents and spacings, a
# deep narrow box (301 planes of one tile)
DIMS = [(16, 16, 16), (32, 32, 32), (16, 24, 8), (8, 8, 300)]
# chunk depth: the planner's on 132 and on 114 SMs, or forced to 3
CHUNKS = [132, 114, "3"]


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _bz(chunk, shape):
    return 3 if chunk == "3" else zstream_chunk(*shape, chunk)


def _level(dims):
    """J3's level-0 kernels of the box ``dims`` on the fused layout, or
    (``"coarse"``) level 1 of the fused 64 x 48 x 32 hierarchy."""
    if dims == "coarse":
        M = MultigridPreconditioner.from_domain(Domain3D(64, 48, 32), fuse=True,
                                                fuse_min_extent=16, device="cpu")
        assert isinstance(M.levels[1], _FusedLevel3D)
        return M.levels[1].kernels
    d = Domain3D(*dims)
    return FusedLevelKernels3D(
        nx=d.nx, ny=d.ny, nz=d.nz, coeffs=(d.coeff_diag, d.coeff_x, d.coeff_y, d.coeff_z),
        cs=OMEGA / d.coeff_diag, padded_shape=fused_layout_3d(d),
        child_shape=(d.nz // 2 + 1, d.ny // 2 + 1, d.nx // 2 + 1))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dims", DIMS)
def test_s7_zstream_schedule_emulation(dims, chunk):
    lay = Padded3DStencilOperator.from_domain(Domain3D(*dims))
    x = _field(lay.padded_shape, 11)
    got = zstream_replay(x, lay.mask_spec, lay.coeffs, _bz(chunk, lay.padded_shape))
    assert torch.equal(got, lay.apply_plain(x))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dims", DIMS + ["coarse"])
def test_j3_zstream_schedule_emulation(dims, chunk):
    k = _level(dims)
    x, b = _field(k.padded_shape, 12), _field(k.padded_shape, 13)
    got = zstream_replay(x, k.mask_spec, k.coeffs, _bz(chunk, k.padded_shape), b=b, cs=k.cs)
    assert torch.equal(got, k.jacobi_plain(x, b))

"""The staged z-march of the port's 3D kernels (``csrc/zstream3d.cuh``:
``ist3::zstream<1>``, which S7, J3 and D2 run), replayed in plain torch.

The CUDA kernels cannot run on the CPU, so the tests hold this replay of
their schedule against the kernels' plain versions bit for bit: the chunks
of ``zstream_chunks``, the 8 x 128 tiles, each staged plane taken from the
one source the kernel picks for it, the halo columns staged by the tiles at
the x edge only, every staged value masked at its global position (the
copies' zero-fill), and each kernel's emit on the staged planes. Imports
torch and the port only.
"""

from __future__ import annotations

import torch

from iterative_solvers_tpu_torch.kernels.stencil3d_layout import ZSTREAM_TILE, zstream_chunks
from iterative_solvers_tpu_torch.parallel.halo import apply7


def zstream_replay(x, spec, coeffs, bz, halos=None, b=None, cs=None):
    """``ist3::zstream<1>`` over ``x`` (d, hp, wp) in plain torch, chunks of
    ``bz`` planes. Per chunk and per 8 x 128 tile, each staged plane p =
    z0 - 1 .. z1 comes from one source chosen per plane: ``zup`` for -1,
    ``zdn`` for d, else ``x[p]``; rows y0 - 1 .. y0 + 8 and columns x0 - 1
    .. x0 + 128 (the kernel stages a float4 beyond each edge; only these
    columns are read), the columns beyond the canvas from ``left`` /
    ``right`` by the tiles at its x edge only. ``halos`` = (zup, zdn, left,
    right) are a mesh block's raw halo operands; None on a single-device
    canvas, whose planes -1 and d and columns beyond it hold no interior
    node (the kernel stages zeros there). ``spec``: the canvas's interior
    (its ``origin`` the global index of node (0, 0, 0), none on a
    single-device canvas).

    The emit at each interior node, 0 elsewhere: S7's and D2's sum A x;
    with ``b``, J3's weighted-Jacobi step x + cs (b - A x), b read at the
    node and each step rounded in f32 as ``ist3::smooth7`` rounds it."""
    d, hp, wp = x.shape
    zoff, _, coff = spec.origin or (0, 0, 0)
    ty, tx = ZSTREAM_TILE
    if halos is None:
        halos = (x.new_zeros((hp, wp)),) * 2 + (x.new_zeros((d, hp)),) * 2
    zup, zdn, left, right = halos

    def interior(z, r, c):
        return (z > 0) & (z < spec.nz) & (r > 0) & (r < spec.ny) & (c > 0) & (c < spec.nx)

    y = torch.full_like(x, float("nan"))
    for z0, z1 in zstream_chunks(d, bz):
        for y0 in range(0, hp, ty):
            rows = torch.arange(y0 - 1, y0 + ty + 1)
            for x0 in range(0, wp, tx):
                cols = torch.arange(x0 - 1, x0 + tx + 1)
                planes = []
                for p in range(z0 - 1, z1 + 1):
                    src = zup if p < 0 else zdn if p >= d else x[p]
                    s = torch.zeros((ty + 2, tx + 2), dtype=x.dtype)
                    on = (rows >= 0) & (rows < hp)
                    r = rows.clamp(0, hp - 1)
                    s[:, 1:-1] = src[r, x0:x0 + tx]
                    if x0 > 0:
                        s[:, 0] = src[r, x0 - 1]
                    elif 0 <= p < d:
                        s[:, 0] = left[p, r]
                    if x0 + tx < wp:
                        s[:, -1] = src[r, x0 + tx]
                    elif 0 <= p < d:
                        s[:, -1] = right[p, r]
                    m = on[:, None] & interior(torch.tensor(zoff + p), rows[:, None],
                                                coff + cols[None, :])
                    planes.append(torch.where(m, s, 0.0))
                staged = torch.stack(planes)
                out = apply7(staged, *coeffs)
                if b is not None:
                    bn = b[z0:z1, y0:y0 + ty, x0:x0 + tx]
                    out = staged[1:-1, 1:-1, 1:-1] + cs * (bn - out)
                m = interior(zoff + torch.arange(z0, z1)[:, None, None], rows[1:-1, None],
                             coff + cols[1:-1])
                y[z0:z1, y0:y0 + ty, x0:x0 + tx] = torch.where(m, out, 0.0)
    return y

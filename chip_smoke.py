#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --legs DIR   # only the V-cycle legs (2D and 3D), of the port in DIR
    python3 chip_smoke.py --cg DIR     # only the fused CG kernels K1/K2 and D5/D6 of the port in DIR
    python3 chip_smoke.py --stencil DIR  # only A1/C1, C4/C5 and the nnz chain of the port in DIR
    python3 chip_smoke.py --zstream DIR  # only the z-march's S7, J3, D2 and R3 of the port in DIR
    python3 chip_smoke.py --mesh DIR   # only the 4-rank world of the port in DIR

Phases, each printing its own lines; any failure exits non-zero before the
final ``ok`` line:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the hand-written kernels from ``iterative_solvers_tpu_torch/csrc``
   (one nvcc per source, all started together);
3. kernels: each kernel against its plain torch version on the card, at a
   small gamma grid, a ragged rect grid, path B's 1024² layout (timed) and
   the 8192² level-0 layout (2D; A1 and C1 bit-equal on unmasked input),
   A1 also at the 4096² ``precond`` layout (device timer, the stencil row's
   ``at_precond``); the custom-mask instantiations on the
   notched disk at 64² (32-row bands), 1024² (timed) and the 8192² level-0
   layout; and at
   16³, the ragged 32³, the unequal box 16 × 24 × 8 and the 512³ level-0
   layout (3D; S7, D3, U3, J3 and R3 bit-equal; D3, U3 and J3 also on each
   coarser fused level's layout: at 512³ the route's 257 and 129, whose
   child is the plain 65³ grid), with the max abs difference, the
   tolerance and the device times (back-to-back calls between CUDA
   events) of the kernel, its plain version and, for the
   stencils, one ``F.conv2d`` / ``F.conv3d``, and the kernel's time as one
   call between two events (which adds the host's launch); at the 1024²
   layouts of paths B and C-B also on the graph timer (20 calls captured in
   one CUDA graph, the replay over 20), the time those rows compare with
   their bound, since their kernels are shorter than the host needs to
   issue one call; the V-cycle legs K_down and
   K_up (C2, C3 on the disk) at every fused level of path A and of the
   disk (8192 … 512), against their plain versions, each beside its bound
   and its plain version, with the level's whole leg cost (device time of
   the V-cycle from the level minus that from its child, CUDA graphs);
   the staged z-march's kernels at 16³, 32³ and 16 × 24 × 8, all
   bit-equal (D2 on four splits, stitched against S7; R3 with two
   coefficient sets; S7; J3 on every fused level); the mesh block
   kernels D1, D3, D4 on a virtual (4, 2) partition of the 8192² level-0
   grid and D2 on a (2, 1, 2) split of 512³, each block with its halos cut
   from the global field, against its plain version (D2, D3, D4 bit for
   bit), stitched against A1, A5, A6, S7 (bit-equal away from block edges,
   edges within f32 round-off, D2, D3 and D4 bit-equal there too; D3
   through the mesh's lane restriction and child mask, D4 fed the lane
   prolongation of A6's coarse correction), and timed on the 1x1 block;
   D3 and D4 also bit-equal and timed on the 1x1 block of every
   shard-fused level of 8192² (8192, 4096, 2048); the sharded fused engine's D5
   and D6 (MSG and PCG, with and without u) on the same (4, 2) partition,
   each against its plain version, the stitched side rows, x', r' and z_k
   against K1, K2 and K2-pcg bit for bit at every node, the summed
   partials within f32 round-off, each timed on the 1x1 block of 8192² and
   of 1024² (path "mesh fused B"'s, also on the graph timer) beside K1,
   K2 and K2-pcg;
4. solves, each main path run with the launch counts set to 0 just before
   it and read just after:
   - 64²: the cold f64-outer solve, the default solve (FMG warm start,
     double-f32 outer), path B plain and with the multigrid, and the FMG
     warm start with its Jacobi polish, each on the card against the CPU
     (plain versions);
   - path A, the JAX package's default solve, at 8192² through
     ``DirichletSolver`` (FMG, outer='ff'): converged, true f64 relative
     residual < 1e-6, its kernels launched;
   - the CLI (``cli_phase``): ``solve`` at 8192² through ``cli.main`` in
     this process (path A's flags, also in a TOML ``--config``, with
     ``--profile --report --html``): rc 0, converged, true f64 relative
     residual < 1e-6, path A's kernels launched and none plain, the CLI's
     phase table and a warm solve's beside it; at 1024² ``solve --save
     --save-npz --save-matrix`` then ``view --save-npz``: the two npz files
     bit-equal on every array the text keeps, the native CSR equal to the
     NumPy builder's and to the dump's; plain f32 CG on A1 at 1024²
     stopped after its first ``periodic_checkpointer(every_iters=500)``
     write, reloaded and resumed: the uninterrupted run's count and x bit
     for bit; each part with its wall time;
   - the mesh: the sharded fast path (``device_refined_solve`` with the
     f64 halo twin, D1 and the shard-fused V-cycle with its FMG) at 8192²
     on a 1x1 mesh beside path A's counts; the engine ladder (the facade's
     ``pallas`` + ``mg`` + ``mixed`` with a mesh: ``engine_refined_solve``
     on D5, D6-pcg and the shard-fused V-cycle) at 8192² on 1x1 against
     path A's f64 outer; ``bench.py``'s ``shard`` ratio (the fused V-cycle
     single-device vs shard-fused on 1x1); a (2, 2) world of four ranks on
     the one card (``gloo``, halos through host memory) at 2048²: the fast
     path, the facade's ``pallas`` + ``mg``, the engine ladder and the
     ``fused`` MSG and PCG solves against the 1x1 mesh and the
     single-device solves; the routes whose plain multigrid runs on blocks
     (``stencil`` + ``mg`` at 2048², the 3D ``pallas`` + ``mg`` +
     ``mixed`` at 128³) against the 1x1 mesh, and the graft entry's dry
     run; per rank the bytes each preconditioner application gathers
     (``mesh.gather`` wrapped in the rank function; at most the block
     multigrid's threshold field) and receives (every all-gather,
     all-reduce and point-to-point message; the shard-fused V-cycle's lane
     transfers on a line of their own, at most their windows' bound), its
     device operations, each route's host seconds and peak device memory,
     the block V-cycle and FMG bit for bit against the single-device plain
     hierarchy; one shard-fused V-cycle application at 8192² on the (2, 2)
     mesh, bit for bit against the single-device fused V-cycle with the
     same levels fused, with its bytes, peak memory and seconds per rank;
   - the cold f64-outer 8192² solve of the first slice, as before;
   - the ff-vs-f64 A/B of path A's refinement (10 interleaved pairs, and
     whether ff qualifies for ``outer='auto'``);
   - path B, plain f32 CG on the fused engine (``operator='fused'``), at
     1024² to the relative criterion, and its ms per iteration at 8192²
     beside the sharded fused engine's (D5 + D6) on a 1x1 mesh, whose
     facade route runs at 1024² too ("mesh fused B");
   - the custom-mask domain (the notched disk): at 64² the default solve
     (ff and f64 outers) and path C-B (plain and with the multigrid), the
     card against the CPU; path C, the default solve at 8192²
     (``outer='ff'``, then ``'auto'``): converged, true f64 relative
     residual < 1e-6, its masked kernels launched; path C-B, plain f32 CG at
     1024² to the relative criterion and its ms per iteration at 8192²;
   - 3D: 64³ bench-route solves (f64 and ff outers) and the FMG warm start
     with its Jacobi polish, the card against the CPU; the JAX bench's 512³
     route (``device_refined_solve`` on the padded 7-point operator, FMG,
     ff outer, then f64): converged, true f64 relative residual < 1e-6, its
     kernels launched, and its ff-vs-f64 A/B (10 interleaved pairs); the
     facade's 512³ solve (``outer='auto'``); plain f32 CG on the 7-point
     kernel at 512³: ms per iteration and iterations to rel 1e-6;
   - the in-place and pipelined stencils (C4, C5): bit-equal to A1 at scale
     1 on gamma 64² (16-row panels), 1024², the 8192² ``nnz`` layout (256-row
     panels, 8448 × 8320), 8192² at ``auto_block_rows`` (8256 × 8320, ranges
     of 63 rows across 64-row panels; timed too) and the custom 64² and
     8192² layouts, with random and all-ones input, in x's storage, within
     their side buffer's memory (two rows a range, at most 1/16 of the
     field);
     ``bench.py``'s ``nnz`` chain at 8192² for A1, C4 and C5 (ms per apply
     as a two-point difference, Gnnz/s), and a short chain on the notched
     disk;
   - ``bench.py``'s ``precond`` race at 4096² (plain CG and Chebyshev-8 PCG
     on A1, fused MG-PCG, to recurrence rel 1e-6) and its ``csr`` race at
     1024² (200 CG iterations on the plain stencil and on the CSR matrix);
   - the facade at ``precision=None``: the reference default at 30² (card
     against CPU), ``operator='pallas'`` with Chebyshev-8 and with the
     multigrid at 4096², ``operator='sparse'`` at 1024², and
     ``precision='mixed'`` with Chebyshev at 2048² (f64 and ff outers), each
     to its stop with its true relative residual;
   - the 3D facade with a mesh (``pallas``, ``mg``, ``mixed``; D2 and the
     plain V-cycle) at 512³ on a 1x1 mesh;
5. one JSON line with every kernel's numbers (a kernel that a counted path
   launches at 1024² while its row is timed at 8192² also carries, under
   ``at_path``, that path's launches and its times and bound at 1024²), the
   card line, then ``ok``.

Paths B, C-B and "mesh fused B" must converge within 1 % of the iteration
counts they had before the K1/K2 tiles, the ``precond`` races' plain and
Chebyshev-8 CG and the facade's ``pallas`` Chebyshev-8 within 1 % of theirs
before A1's tiles (``CG_COUNTS``).

Imports nothing of JAX. Needs one card; fails without one.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N = 8192
NB = 1024  # paths B, C-B and "mesh fused B"
PRECOND_N = 4096  # bench.py's precond race and the facade's pallas paths
EPS32 = 1.1920929e-07
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
PKG = "iterative_solvers_tpu_torch/csrc/"
TPU = "iterative_solvers_tpu/kernels/"
PAR = "iterative_solvers_tpu/parallel/"
MASK_NOTE = "iterative_solvers_tpu/ops/ddf32.py:134"  # jnp residual_ff on a custom mask
# name -> (source, TPU kernel it replaces (the body on the main path), f32
# operations per node (per interior node in 3D) counted from its formula,
# the main path whose run gives its launch count)
KERNELS = {
    "k1": (PKG + "cg_tiles.cuh", TPU + "cg_fused.py:89", 14, "A"),
    "k2": (PKG + "cg_tiles.cuh", TPU + "cg_fused.py:133", 16, "B"),
    "k2_pcg": (PKG + "cg_tiles.cuh", TPU + "cg_fused.py:177", 16, "A"),
    "k_down": (PKG + "mg_fused.cu", TPU + "mg_fused.py:65", 22, "A"),
    "k_up": (PKG + "mg_fused.cu", TPU + "mg_fused.py:183", 26, "A"),
    "k_jacobi": (PKG + "mg_fused.cu", TPU + "mg_fused.py:238", 10, "A"),
    "stencil": (PKG + "stencil.cu", TPU + "stencil_pallas.py:124", 7, "B"),
    "k_resid_ff": (PKG + "resid_ff.cu", TPU + "resid_ff.py:111", 70, "A"),
    "stencil3d": (PKG + "stencil3d.cu", TPU + "stencil3d_pallas.py:128", 10, "3D"),
    "k_down3d": (PKG + "mg_fused3d.cu", TPU + "mg_fused3d.py:290", 20, "3D"),
    "k_up3d": (PKG + "mg_fused3d.cu", TPU + "mg_fused3d.py:343", 17, "3D"),
    "k_jacobi3d": (PKG + "mg_fused3d.cu", TPU + "mg_fused3d.py:149", 13, "3D"),
    "k_resid_ff3d": (PKG + "resid_ff.cu", TPU + "resid_ff.py:312", 110, "3D"),
    # the in-place and pipelined stencils (C4, C5) with the chain's scale,
    # on the nnz chain's 8192² layout (256-row panels)
    "stencil_inplace": (PKG + "stencil_pipelined.cu", TPU + "stencil_pipelined.py:134", 8,
                        "nnz C4"),
    "stencil_pipelined": (PKG + "stencil_pipelined.cu", TPU + "stencil_pipelined.py:44", 8,
                          "nnz C5"),
    # the custom-mask instantiations (int8 mask operand): C1–C3, the
    # custom=True bodies of A2–A4, and A8 where JAX runs the jnp residual
    "stencil_custom": (PKG + "stencil.cu", TPU + "stencil_pallas.py:60", 7, "C-B"),
    "k1_custom": (PKG + "cg_tiles.cuh", TPU + "cg_fused.py:89", 14, "C"),
    "k2_custom": (PKG + "cg_tiles.cuh", TPU + "cg_fused.py:133", 16, "C-B"),
    "k2_pcg_custom": (PKG + "cg_tiles.cuh", TPU + "cg_fused.py:177", 16, "C"),
    "k_down_custom": (PKG + "mg_fused.cu", TPU + "mg_fused.py:109", 22, "C"),
    "k_up_custom": (PKG + "mg_fused.cu", TPU + "mg_fused.py:140", 26, "C"),
    "k_resid_ff_custom": (PKG + "resid_ff.cu", MASK_NOTE, 70, "C"),
    # C4 and C5 with the custom mask, as C1 (the TPU bodies have none)
    "stencil_inplace_custom": (PKG + "stencil_pipelined.cu", TPU + "stencil_pipelined.py:134",
                               8, "nnz C4 custom"),
    "stencil_pipelined_custom": (PKG + "stencil_pipelined.cu", TPU + "stencil_pipelined.py:44",
                                 8, "nnz C5 custom"),
    # the mesh block kernels (D1–D4): launches from the sharded fast path
    # and the 3D facade with a mesh
    "stencil_block": (PKG + "halo_pallas.cu", PAR + "halo_pallas.py:130", 7, "mesh a"),
    "stencil3d_block": (PKG + "halo_pallas.cu", PAR + "halo_pallas.py:415", 10,
                        "mesh 3D facade"),
    "k_down_block": (PKG + "mg_sharded.cu", PAR + "mg_sharded.py:203", 22, "mesh a"),
    "k_up_block": (PKG + "mg_sharded.cu", PAR + "mg_sharded.py:257", 26, "mesh a"),
    # the sharded fused engine (D5, D6): launches from the engine ladder and
    # the engine's MSG CG, each at full width on a 1x1 mesh
    "k1_block": (PKG + "cg_tiles.cuh", PAR + "cg_fused_sharded.py:68", 14, "mesh engine"),
    "k2_block": (PKG + "cg_tiles.cuh", PAR + "cg_fused_sharded.py:108", 16,
                 "mesh fused B"),
    "k2_pcg_block": (PKG + "cg_tiles.cuh", PAR + "cg_fused_sharded.py:108", 16,
                     "mesh engine"),
}
PATH_KERNELS = {
    "A": ("k1", "k2_pcg", "k_down", "k_up", "k_jacobi", "k_resid_ff"),
    "f64": ("k1", "k2_pcg", "k_down", "k_up"),
    "B": ("k1", "k2", "stencil"),
    "3D": ("stencil3d", "k_down3d", "k_up3d", "k_jacobi3d", "k_resid_ff3d"),
    "3D f64": ("stencil3d", "k_down3d", "k_up3d", "k_jacobi3d"),
    "3D facade": ("stencil3d", "k_down3d", "k_up3d", "k_jacobi3d", "k_resid_ff3d"),
    "3D CG": ("stencil3d",),
    "C": ("k1_custom", "k2_pcg_custom", "k_down_custom", "k_up_custom", "k_resid_ff_custom"),
    "C f64": ("k1_custom", "k2_pcg_custom", "k_down_custom", "k_up_custom"),
    "C-B": ("k1_custom", "k2_custom", "stencil_custom"),
    "nnz A1": ("stencil",),
    "nnz A1 custom": ("stencil_custom",),  # C1: ``--stencil``'s chain on the disk
    "nnz C4": ("stencil_inplace",),
    "nnz C5": ("stencil_pipelined",),
    "nnz C4 custom": ("stencil_inplace_custom",),
    "nnz C5 custom": ("stencil_pipelined_custom",),
    "precond plain": ("stencil",),
    "precond cheb8": ("stencil",),
    "precond mg": ("k1", "k2_pcg", "k_down", "k_up"),
    "facade pallas cheb8": ("stencil",),
    "facade pallas mg": ("stencil", "k_down", "k_up"),
    # the JAX facade computes these in XLA outside any kernel: torch ops only
    "facade default": (),
    "facade sparse": (),
    "facade mixed cheb": (),
    "mesh a": ("stencil_block", "k_down_block", "k_up_block"),
    "mesh facade": ("stencil_block", "k_down_block", "k_up_block"),
    "mesh 3D facade": ("stencil3d_block",),
    "mesh engine": ("k1_block", "k2_pcg_block", "k_down_block", "k_up_block"),
    "mesh fused B": ("k1_block", "k2_block"),
    "mesh fused mg": ("k1_block", "k2_pcg_block", "k_down_block", "k_up_block"),
    # ShardedMultigridPreconditioner's routes: the halo stencil and the
    # plain V-cycle are torch ops (JAX: jnp); the 3D route runs D2
    "mesh stencil mg": (),
    "mesh 3D mg": ("stencil3d_block",),
}
# the kernels that a counted path launches at NB² (paths B's and C-B's
# 1280 x 1152 layout, the mesh block's 1152 x 1152) while their row's time
# is taken at 8192²: each row also carries its time and bound at NB²
# (``at_path``), so launches x gap reads from one line
AT_NB = {"k1": "B", "k2": "B", "stencil": "B", "k1_custom": "C-B", "k2_custom": "C-B",
         "stencil_custom": "C-B", "k1_block": "mesh fused B", "k2_block": "mesh fused B"}
# the counted paths that launch A1 at PRECOND_N² (the stencil row's
# ``at_precond``)
PRECOND_PATHS = ("precond plain", "precond cheb8", "facade pallas cheb8", "facade pallas mg")
# the live runs' iteration counts to rel 1e-6 before the K1/K2 tiles: a
# count may move only through the partials' summation order, within 1 %
CG_COUNTS = {"B": 2055, "C-B": 1703, "mesh fused B": 2055,
             # plain and Chebyshev-8 CG on A1, counted before A1's tiles
             "precond plain": 7480, "precond cheb8": 1276, "facade pallas cheb8": 1276}
N3 = 512


def log(*a):
    print(*a, flush=True)


def one_call_ms(fn, reps=15):
    """Median CUDA-event time of one call of ``fn`` between two events, after
    two warm-up calls. It also counts the card's wait for the host to issue
    the launch; kernel rows keep it as ``one_call_ms`` beside their device
    time, since this is how kernel times were taken before ``device_ms``."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=15):
    """Device time of one call of ``fn`` (a kernel, its plain version, a
    library call): two warm-up calls, then three runs of ``reps`` calls back
    to back between two CUDA events; the median run over ``reps``. Back to
    back, the card does not wait between calls for the host to issue the
    next launch, a wait that one call between two events adds to it."""
    import torch

    for _ in range(2):
        fn()
    runs = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / reps)
    return statistics.median(runs)


def kernel_times(kern, plain, plain_reps=15):
    """A kernel row's times: the kernel's device time (``ms``, the one every
    row compares with its bound), the same kernel as one call between two
    events (``one_call_ms``) and its plain version's device time."""
    return {"ms": device_ms(kern), "one_call_ms": one_call_ms(kern),
            "plain_ms": device_ms(plain, reps=plain_reps)}


def graph_ms(fn, reps=15, calls=1):
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph after two warm-up calls, the median CUDA-event time of its
    replays over ``calls``, so the host's launch stream (which keeps the
    card idle between small launches) is not in it. With ``calls`` = 20 it
    is the timer of kernels shorter than the host's ~0.02–0.03 ms to issue
    one wrapper call, where :func:`device_ms`'s back-to-back calls would
    time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return one_call_ms(graph.replay, reps) / calls


GRAPH_CALLS = 20  # kernel launches per graph of the short-kernel timer


def bound_ms(s, ops):
    """(bound ms, bound_by) of a kernel row ``s`` (its bytes and nodes) at
    ``ops`` f32 operations per node: the larger of bytes over the memory
    rate and operations over the f32 rate."""
    t_bytes = s["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = ops * s["nodes"] / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv2d_ms(lay, x):
    """Device time of one cuDNN convolution with the 5-point cross of
    ``lay`` on the field ``x``: the 2D stencils' library yardstick."""
    import torch
    import torch.nn.functional as F

    cd, cx, cy = lay.coeffs
    wt = torch.tensor([[0.0, cy, 0.0], [cx, cd, cx], [0.0, cy, 0.0]],
                      device="cuda").view(1, 1, 3, 3)
    xin = x.view(1, 1, *x.shape)
    return device_ms(lambda: F.conv2d(xin, wt, padding=1))


def nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def compare(name, outs, refs, kinds, scales=None):
    """Check each output against the plain version's. ``kinds``: 'field'
    (64 eps32 · max|ref|), 'exact' (bit-equal), 'pair' (the low word of a
    double-f32 pair: 32 · max|bh| · 2⁻⁴⁸, ``scales[i]`` = max|bh|), 'sum'
    (partials reduced to one scalar: 64 eps32 · the sum of |terms|,
    ``scales[i]``, else |ref|) or 'max' (64 eps32 · |ref| after the max).
    Returns the worst field (field, exact or pair) error and its tolerance."""
    worst, worst_tol = 0.0, 0.0
    scales = scales or {}
    for i, (o, r, kind) in enumerate(zip(outs, refs, kinds)):
        if kind in ("field", "exact", "pair"):
            err = float((o.double() - r.double()).abs().max())
            tol = {"field": 64 * EPS32 * float(r.double().abs().max()), "exact": 0.0,
                   "pair": 32 * scales.get(i, 0.0) * 2.0**-48}[kind]
        else:
            red = (lambda t: t.double().sum()) if kind == "sum" else (lambda t: t.double().max())
            ro = float(red(r))
            err = abs(float(red(o)) - ro)
            tol = 64 * EPS32 * scales.get(i, abs(ro))
        if not err <= tol:
            raise AssertionError(f"{name}: {kind} output {i} differs by {err:.3e} > tol {tol:.3e}")
        if kind != "sum" and kind != "max" and err * max(worst_tol, 1e-300) >= worst * max(tol, 1e-300):
            worst, worst_tol = err, tol
    return worst, worst_tol


def check_kernels(dom, gen, label, timed, block_rows=None, only=None, short=False):
    """Each kernel (of ``only``, else all) against its plain version on one
    layout (the solver's own, or ``block_rows``-row bands); returns {name:
    dict of max_abs_err, ms, plain_ms, library_ms, bytes, nodes, shape}.
    On a custom domain these are the ``*_custom`` instantiations (no Jacobi
    kernel), every input pre-masked, and the int8 mask counts among the
    bytes; A1 / C1 take their record from :func:`a1_row`. ``short`` (a layout whose kernels are shorter than the host's
    issue time) adds ``graph_ms`` (:func:`graph_ms`, ``GRAPH_CALLS`` calls
    in one graph), the time such a row compares with its bound."""
    import torch

    from iterative_solvers_tpu_torch.kernels import cg_fused, resid_ff
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.ops.ddf32 import split_f64
    from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner

    lay = PaddedStencilOperator.from_domain(dom, block_rows=block_rows)
    M = MultigridPreconditioner.from_domain(dom, fuse=True, fuse_min_extent=16, device="cuda")
    kl = M.levels[0].kernels
    mask = lay.mask_spec.build("cuda")
    custom = lay.mask8 is not None
    # the int8 mask operand each custom kernel reads (none for gamma/rect)
    m8, m8_level = ((lay.mask8.int8("cuda"), kl.mask8.int8("cuda")) if custom else (None, None))

    def field(shape, masked=True):
        t = torch.randn(shape, device="cuda", generator=gen)
        return torch.where(mask, t, 0.0) if masked else t

    d, z, x, r, w, u = (field(lay.padded_shape) for _ in range(6))
    beta = torch.tensor(0.37, device="cuda")
    scal = torch.tensor([-1.3e-4, 0.37], device="cuda")
    b = field(kl.padded_shape, masked=False)
    if custom:  # the TPU custom kernels' contract: a pre-masked level RHS
        b = torch.where(kl.mask_spec.build("cuda"), b, 0.0)
    xj = field(kl.padded_shape, masked=False)
    # the legs' coarse field lives on the child's input layout
    ec = torch.randn(kl.coarse_shape, device="cuda", generator=gen)
    cm8 = kl.child_mask8.int8("cuda") if custom else None
    side = cg_fused.k1_plain(w, z, beta, lay)[0]
    side_r = cg_fused.k1_plain(r, z, beta, lay)[0]
    bm = torch.where(kl.mask_spec.build("cuda"), b, 0.0)
    # a double-f32 pair problem at the solver's scales: b ~ 1e4, x ~ 1
    bh, bl = split_f64(torch.where(mask, torch.randn(lay.padded_shape, device="cuda",
                                                     dtype=torch.float64, generator=gen), 0.0) * 1e4)
    xh, xl = split_f64(torch.where(mask, torch.randn(lay.padded_shape, device="cuda",
                                                     dtype=torch.float64, generator=gen), 0.0))
    bh_max = float(bh.abs().max())
    # sums that may cancel are held to the sum of their terms' magnitudes
    scales = {
        "k1": lambda ref: {1: float((d * (d + beta * z)).abs().double().sum())},
        "k_up": lambda ref: {1: float((bm * ref[0]).abs().double().sum())},
        "k_resid_ff": lambda ref: {1: bh_max},
    }
    # name: (kernel, plain, output kinds, inputs for the byte count)
    cases = {
        "k1": (lambda: cg_fused.k1(d, z, beta, lay), lambda: cg_fused.k1_plain(d, z, beta, lay),
               ("field", "sum", "sum", "max"), (d, z, m8)),
        "k2": (lambda: cg_fused.k2(x, r, z, side_r, scal, lay),
               lambda: cg_fused.k2_plain(x, r, z, side_r, scal, lay),
               ("field", "field", "field", "sum", "max"), (x, r, z, side_r, m8)),
        "k2_pcg": (lambda: cg_fused.k2_pcg(x, r, z, w, side, scal, lay),
                   lambda: cg_fused.k2_pcg_plain(x, r, z, w, side, scal, lay),
                   ("field", "field", "field", "sum", "max"), (x, r, z, w, side, m8)),
        "k_down": (lambda: (kl.down(b),), lambda: (kl.down_plain(b),), ("field",),
                   (b, m8_level, cm8)),
        "k_up": (lambda: kl.up(b, ec, with_dot=True), lambda: kl.up_plain(b, ec, with_dot=True),
                 ("field", "sum"), (b, ec, m8_level)),
        "k_jacobi": (lambda: (kl.jacobi(xj, b),), lambda: (kl.jacobi_plain(xj, b),),
                     ("field",), (xj, b)),
        "k_resid_ff": (lambda: resid_ff.resid_ff(xh, xl, bh, bl, lay),
                       lambda: resid_ff.resid_ff_plain(xh, xl, bh, bl, lay),
                       ("exact", "pair"), (xh, xl, bh, bl, m8)),
    }
    if custom:
        del cases["k_jacobi"]  # no custom Jacobi kernel, as on the TPU
    if only is not None:
        cases = {k: v for k, v in cases.items() if k in only}
    out = {}
    if only is None or "stencil" in only:  # A1 / C1: their own record (a1_row)
        out["stencil" + ("_custom" if custom else "")] = a1_row(lay, gen, label, timed, short)
    # the true-solution variants of K2 and K2-pcg (the ‖x − u‖∞ partials)
    extra = {
        "k2+u": (lambda: cg_fused.k2(x, r, z, side_r, scal, lay, u=u),
                 lambda: cg_fused.k2_plain(x, r, z, side_r, scal, lay, u=u),
                 ("field", "field", "field", "sum", "max", "max")),
        "k2_pcg+u": (lambda: cg_fused.k2_pcg(x, r, z, w, side, scal, lay, u=u),
                     lambda: cg_fused.k2_pcg_plain(x, r, z, w, side, scal, lay, u=u),
                     ("field", "field", "field", "sum", "max", "max")),
    }
    sfx = "_custom" if custom else ""
    # K1's and K2's (tile rows, blocks) on this layout (none before the tiles)
    grid = getattr(cg_fused, "tile_grid", None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = {k: grid("k1" if k == "k1" else "k2", lay.padded_shape, lay.block_rows, sms)
             if grid else None for k in ("k1", "k2", "k2_pcg")}
    for name, (kern, plain, kinds) in extra.items():
        if name.removesuffix("+u") not in cases:
            continue
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err, tol = compare(f"{name}{sfx} @ {label}", got, ref, kinds)
        log(f"kernel {name + sfx:17s} @ {label}: max_abs_err {err:.3e} tol {tol:.3e}")
    for base, (kern, plain, kinds, ins) in cases.items():
        name = base + sfx
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        sc = scales[base](ref) if base in scales else None
        err, tol = compare(f"{name} @ {label}", got, ref, kinds, sc)
        rec = {"max_abs_err": err, "bytes": nbytes(ins) + nbytes(got),
               "nodes": lay.padded_shape[0] * lay.padded_shape[1], "library_ms": None,
               "shape": list(lay.padded_shape)}
        line = f"kernel {name:17s} @ {label}: max_abs_err {err:.3e} tol {tol:.3e}"
        if base in tiles:
            rec["tiles"] = tiles[base]
            line += f" (tile rows, blocks {tiles[base]}; bands {lay.block_rows})"
        if timed and base not in ("k_down", "k_up"):  # the legs: check_legs times them
            rec.update(kernel_times(kern, plain))
            line += f"  kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms"
            if short and base in ("k1", "k2", "k2_pcg"):  # the NB² paths' kernels
                rec["graph_ms"] = graph_ms(kern, reps=5, calls=GRAPH_CALLS)
                line += (f"  graph {rec['graph_ms']:.4f} ms  one call "
                         f"{rec['one_call_ms']:.4f} ms  bound "
                         f"{rec['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms")
        log(line)
        out[name] = rec
    return out


def check_kernels_3d(dims, gen, label, timed):
    """The 3D kernels against their plain versions on the fused level-0
    layout of the box ``dims`` (the 7-point operator's own layout too), then
    D3, U3 and J3 on every coarser fused level's layout (untimed); returns
    {name: dict of max_abs_err, ms, plain_ms, library_ms, bytes, nodes} of
    level 0. The hierarchy is the solver's own at 512³ (fused 513, 257 and
    129, whose child is the plain 65³ grid), else fused down to 16. S7, D3,
    U3 and J3 must equal their plain versions bit for bit. ``bytes`` counts what
    the function must move: the kernels read interior nodes only (the box
    mask is algebraic and a masked read touches no memory), so each
    full-depth input counts its interior nodes, ``ec`` the child's grid
    (dc, hc, wc), which U3 prolongs, and each output its whole canvas (D3's
    the child's layout); ``nodes`` (for the operation count) is the
    interior."""
    import torch
    import torch.nn.functional as F

    from iterative_solvers_tpu_torch import Domain3D
    from iterative_solvers_tpu_torch.kernels import resid_ff
    from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
    from iterative_solvers_tpu_torch.ops.ddf32 import split_f64
    from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner, _FusedLevel3D

    dom = Domain3D(*dims)
    lay = Padded3DStencilOperator.from_domain(dom)
    M = MultigridPreconditioner.from_domain(dom, fuse=True, device="cuda",
                                            fuse_min_extent=512 if dims[0] >= N3 else 16)
    kl = M.levels[0].kernels
    if kl.padded_shape != lay.padded_shape:
        raise AssertionError(f"{label}: V-cycle layout {kl.padded_shape} != operator's")
    shape = lay.padded_shape
    mask = lay.mask_spec.build("cuda")
    n_in = int(mask.sum())  # interior nodes of one full-depth input
    n_ec = kl.dc * (dom.ny // 2 + 1) * (dom.nx // 2 + 1)  # the child's grid
    # unmasked inputs: every kernel masks its reads
    x, b, xj = (torch.randn(shape, device="cuda", generator=gen) for _ in range(3))
    ec = torch.randn(kl.child_shape, device="cuda", generator=gen)
    f64 = dict(device="cuda", dtype=torch.float64, generator=gen)
    bh, bl = split_f64(torch.where(mask, torch.randn(shape, **f64), 0.0) * 1e4)
    xh, xl = split_f64(torch.where(mask, torch.randn(shape, **f64), 0.0))
    bh_max = float(bh.abs().max())
    # name: (kernel, plain, output kinds, f32 elements it must read)
    cases = {
        # S7 writes the fmaf chain its plain version emulates: bit-equal
        "stencil3d": (lambda: (lay(x),), lambda: (lay.apply_plain(x),), ("exact",), n_in),
        # D3 and U3 round every step as their plain versions do: bit-equal
        "k_down3d": (lambda: (kl.down(b),), lambda: (kl.down_plain(b),), ("exact",), n_in),
        "k_up3d": (lambda: (kl.up(b, ec),), lambda: (kl.up_plain(b, ec),), ("exact",),
                   n_in + n_ec),
        # J3 writes ist3::smooth7, the plain version's rounding: bit-equal
        "k_jacobi3d": (lambda: (kl.jacobi(xj, b),), lambda: (kl.jacobi_plain(xj, b),),
                       ("exact",), 2 * n_in),
        "k_resid_ff3d": (lambda: resid_ff.resid_ff(xh, xl, bh, bl, lay),
                         lambda: resid_ff.resid_ff_plain(xh, xl, bh, bl, lay),
                         ("exact", "pair"), 4 * n_in),
    }
    out = {}
    for name, (kern, plain, kinds, reads) in cases.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err, tol = compare(f"{name} @ {label}", got, ref, kinds, {1: bh_max})
        rec = {"max_abs_err": err, "bytes": 4 * reads + nbytes(got), "nodes": n_in,
               "library_ms": None}
        line = f"kernel {name:12s} @ {label}: max_abs_err {err:.3e} tol {tol:.3e}"
        del got, ref
        if timed:
            rec.update(kernel_times(kern, plain, 5))
            line += f"  kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms"
            if name == "stencil3d":
                # yardstick: one cuDNN convolution with the 7-point cross
                cd, cx, cy, cz = lay.coeffs
                wt = torch.zeros((1, 1, 3, 3, 3), device="cuda")
                wt[0, 0, 1, 1] = torch.tensor([cx, cd, cx])
                wt[0, 0, 1, 0, 1] = wt[0, 0, 1, 2, 1] = cy
                wt[0, 0, 0, 1, 1] = wt[0, 0, 2, 1, 1] = cz
                xin = x.view(1, 1, *shape)
                rec["library_ms"] = device_ms(lambda: F.conv3d(xin, wt, padding=1))
                line += f"  conv3d {rec['library_ms']:.4f} ms"
            torch.cuda.empty_cache()
        log(line)
        out[name] = rec
    del x, b, xj, ec, bh, bl, xh, xl
    # the coarser fused levels' own layouts, z-chunk tails and child layouts
    # (at 512³ the route launches D3 and U3 at 257 and 129 planes too, the
    # latter onto the plain 65³ grid)
    for i, lev in enumerate(M.levels[1:], start=1):
        if not isinstance(lev, _FusedLevel3D):
            continue
        k = lev.kernels
        bi, xi = (torch.randn(k.padded_shape, device="cuda", generator=gen) for _ in range(2))
        eci = torch.randn(k.child_shape, device="cuda", generator=gen)
        for name, kern, plain in (("k_down3d", lambda: (k.down(bi),), lambda: (k.down_plain(bi),)),
                                  ("k_up3d", lambda: (k.up(bi, eci),),
                                   lambda: (k.up_plain(bi, eci),)),
                                  ("k_jacobi3d", lambda: (k.jacobi(xi, bi),),
                                   lambda: (k.jacobi_plain(xi, bi),))):
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            where = f"{'x'.join(map(str, dims))} level {i} {k.padded_shape} -> {k.child_shape}"
            err, tol = compare(f"{name} @ {where}", got, ref, ("exact",))
            log(f"kernel {name:12s} @ {where}: max_abs_err {err:.3e} tol {tol:.3e}")
    return out


def leg_costs(M, gen):
    """Per fused level li of ``M`` (2D or 3D): the device time
    (:func:`graph_ms`) of the V-cycle from li on the level's padded layout
    minus that of the V-cycle from li + 1 on the child's input layout (its
    padded canvas when fused, else its grid). The difference is the level's
    whole leg: its two kernels and whatever runs between them and the
    child's own legs (the lane or y/x transfers, masks, pads and crops where
    a design has them). Uses only ``M.levels``, ``M.domains``, ``M._vcycle``
    and the levels' padded shapes and masks, so it times any version of the
    V-cycle alike."""
    import torch

    out = {}
    for li, lev in enumerate(M.levels[:-1]):
        k = getattr(lev, "kernels", None)
        if k is None:
            continue
        b = torch.where(k.mask_spec.build("cuda"),
                        torch.randn(k.padded_shape, device="cuda", generator=gen), 0.0)
        child = M.levels[li + 1]
        cshape = (child.kernels.padded_shape if hasattr(child, "kernels")
                  else M.domains[li + 1].grid_shape)
        bc = torch.randn(cshape, device="cuda", generator=gen)
        t_li = graph_ms(lambda: M._vcycle(li, b))
        t_child = graph_ms(lambda: M._vcycle(li + 1, bc))
        out[li] = (t_li - t_child, t_li, t_child)
        del b, bc
    return out


def check_legs(dom, gen, label):
    """K_down and K_up (with the dot, as level 0 runs in the PCG) at every
    fused level of the solver's own hierarchy on ``dom``: each against its
    plain version (fields within 64 eps32 · max|plain|, the dot within 64
    eps32 of the sum of its terms' magnitudes), timed (:func:`kernel_times`)
    beside its bound (each input read once, the int8 masks included, each
    output written once), then the level's whole leg cost
    (:func:`leg_costs`). Logs one line per level and returns {level:
    {"k_down": row, "k_up": row, ...}}, rows as :func:`check_kernels`'.
    Holds for any version of the legs' contract (K_up takes a field shaped
    as K_down's output; a level's int8 masks count where it has them), so
    ``--legs`` can time an earlier checkout's legs alike."""
    import torch

    from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner

    M = MultigridPreconditioner.from_domain(dom, device="cuda")
    recs = {}
    for li, lev in enumerate(M.levels):
        k = getattr(lev, "kernels", None)
        if k is None:
            continue
        b = torch.where(k.mask_spec.build("cuda"),
                        torch.randn(k.padded_shape, device="cuda", generator=gen), 0.0)
        coarse = tuple(k.down(b).shape)
        ec = torch.randn(coarse, device="cuda", generator=gen)
        m8 = [m.int8("cuda") for m in (k.mask8, getattr(k, "child_mask8", None))
              if m is not None]
        tiles = (k.down_tile_rows(b.device), k.up_tile_rows(b.device)) if hasattr(
            k, "down_tile_rows") else None
        rec = {"shape": k.padded_shape, "coarse": coarse, "tj": tiles}
        where = f"{label} level {li} {k.padded_shape} -> {coarse}"
        for name, kern, plain, kinds, ins in (
                ("k_down", lambda: (k.down(b),), lambda: (k.down_plain(b),), ("field",),
                 (b, *m8)),
                ("k_up", lambda: k.up(b, ec, with_dot=True),
                 lambda: k.up_plain(b, ec, with_dot=True), ("field", "sum"), (b, ec, *m8[:1]))):
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            sc = {1: float((b * ref[0]).abs().double().sum())} if name == "k_up" else None
            err, tol = compare(f"{name} @ {where}", got, ref, kinds, sc)
            nb = nbytes(ins) + nbytes(got[:1])
            rec[name] = {"max_abs_err": err, "tol": tol, "bytes": nb,
                         "nodes": k.padded_shape[0] * k.padded_shape[1], "library_ms": None,
                         "bound_ms": nb / HBM_BYTES_PER_S * 1e3, **kernel_times(kern, plain, 5)}
            del got, ref
        recs[li] = rec
        del b, ec
    for li, (leg, t_li, t_child) in leg_costs(M, gen).items():
        recs[li]["leg_ms"] = leg
        r = recs[li]
        log(f"leg {label} level {li} {r['shape']} -> {r['coarse']} (TJ {r['tj']}): " + "  ".join(
            f"{n} {r[n]['ms']:.4f} ms (one call {r[n]['one_call_ms']:.4f}; bound "
            f"{r[n]['bound_ms']:.4f}, {100 * r[n]['bound_ms'] / r[n]['ms']:.0f} %; plain "
            f"{r[n]['plain_ms']:.4f}; max_abs_err {r[n]['max_abs_err']:.3e} tol "
            f"{r[n]['tol']:.3e})" for n in ("k_down", "k_up"))
            + f"  leg {leg:.4f} ms (V-cycle from here {t_li:.4f} - from the child {t_child:.4f})")
    del M
    torch.cuda.empty_cache()
    return recs


def check_legs_3d(gen, n=N3):
    """D3 and U3 at every fused level of the 512³ route's hierarchy, each
    against its plain version (bit-equal where the legs take the child's
    layout; an earlier checkout's legs, which wrote the half-depth (dc, hp,
    wp) field for torch's y/x transfers, within 64 eps32 · max|plain|),
    timed (:func:`kernel_times`) beside the bound of the y/x-folded legs
    (b's interior read once, ``ec``'s child grid once, each output written
    once), then the level's whole leg cost (:func:`leg_costs`). Logs one
    line per level and returns {level: {"k_down3d": row, "k_up3d": row,
    ...}}; holds for either contract, so ``--legs`` times an earlier
    checkout's 3D legs alike."""
    import torch

    from iterative_solvers_tpu_torch import Domain3D
    from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner

    dom = Domain3D(n, n, n)
    M = MultigridPreconditioner.from_domain(dom, device="cuda")
    recs = {}
    for li, lev in enumerate(M.levels):
        k = getattr(lev, "kernels", None)
        if k is None:
            continue
        mask = k.mask_spec.build("cuda")
        b = torch.where(mask, torch.randn(k.padded_shape, device="cuda", generator=gen), 0.0)
        coarse = tuple(k.down(b).shape)
        ec = torch.randn(coarse, device="cuda", generator=gen)
        kind = "exact" if hasattr(k, "child_shape") else "field"
        child = M.levels[li + 1]
        n_in = int(mask.sum())
        n_ec = k.dc * (k.ny // 2 + 1) * (k.nx // 2 + 1)
        # the child's layout (D3's output when the y/x transfers are folded in)
        n_out = math.prod(child.kernels.padded_shape if hasattr(child, "kernels")
                          else M.domains[li + 1].grid_shape)
        rec = {"shape": k.padded_shape, "coarse": coarse}
        where = f"3D {n}^3 level {li} {k.padded_shape} -> {coarse}"
        for name, kern, plain, reads in (
                ("k_down3d", lambda: (k.down(b),), lambda: (k.down_plain(b),), n_in),
                ("k_up3d", lambda: (k.up(b, ec),), lambda: (k.up_plain(b, ec),), n_in + n_ec)):
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err, tol = compare(f"{name} @ {where}", got, ref, (kind,))
            nb = 4 * reads + (4 * n_out if name == "k_down3d" else nbytes(got))
            rec[name] = {"max_abs_err": err, "tol": tol, "bytes": nb, "nodes": n_in,
                         "library_ms": None, "bound_ms": nb / HBM_BYTES_PER_S * 1e3,
                         **kernel_times(kern, plain, 3)}
            del got, ref
        recs[li] = rec
        del b, ec, mask
    for li, (leg, t_li, t_child) in leg_costs(M, gen).items():
        recs[li]["leg_ms"] = leg
        r = recs[li]
        log(f"leg 3D {n}^3 level {li} {r['shape']} -> {r['coarse']}: " + "  ".join(
            f"{nm} {r[nm]['ms']:.4f} ms (one call {r[nm]['one_call_ms']:.4f}; bound "
            f"{r[nm]['bound_ms']:.4f}, {100 * r[nm]['bound_ms'] / r[nm]['ms']:.0f} %; plain "
            f"{r[nm]['plain_ms']:.4f}; max_abs_err {r[nm]['max_abs_err']:.3e} tol "
            f"{r[nm]['tol']:.3e})" for nm in ("k_down3d", "k_up3d"))
            + f"  leg {leg:.4f} ms (V-cycle from here {t_li:.4f} - from the child {t_child:.4f})")
    del M
    torch.cuda.empty_cache()
    return recs


def check_mesh_legs(gen, n=N):
    """The mesh's V-cycle legs D3 and D4 (``k_down_block``, ``k_up_block``
    with the dot) on the 1x1 block of every shard-fused level of the
    ``n``² Г grid (8192, 4096, 2048: path "mesh a" launches each three
    times a level): each launch against its plain version (the fields bit
    for bit, the dot within 64 eps32 of the sum of its terms' magnitudes),
    then on the device timer and on the graph timer (:func:`graph_ms`, 20
    calls a graph: at 4096² and 2048² the wrapper's host work outlasts the
    kernel back to back) beside the bound (each operand read once, each
    output written once); level 0 is the layout of the kernels line's D3
    and D4 rows. Holds for the column sweeps of earlier checkouts too, so
    ``--legs`` times them alike."""
    import torch

    from iterative_solvers_tpu_torch import Domain2D
    from iterative_solvers_tpu_torch.kernels import _build
    from iterative_solvers_tpu_torch.parallel import ShardedPallasStencilOperator, make_solver_mesh
    from iterative_solvers_tpu_torch.parallel.mg_sharded import ShardedFusedMultigrid

    dom = Domain2D(nx=n, ny=n)
    op = ShardedPallasStencilOperator.from_domain(dom, make_solver_mesh(1))
    M = ShardedFusedMultigrid.from_operator(op, dom, device="cuda")
    org = (0, 0)
    sms = _build.sm_count(torch.device("cuda"))
    recs = {}
    for li, lev in enumerate(M.levels):
        hp, wp = lev.padded_shape
        xb = torch.randn((hp, wp), device="cuda", generator=gen)
        ecb = torch.randn((hp // 2, wp), device="cuda", generator=gen)
        dh = lev.down_halos_from_global(xb, org)
        uh = lev.up_halos_from_global(xb, ecb, org)
        bm = torch.where(lev.spec(org).build("cuda"), uh[0], 0.0)
        tj = ((lev.down_tile_rows(sms), lev.up_tile_rows(sms))
              if hasattr(lev, "down_tile_rows") else None)
        rec = {"shape": (hp, wp), "tj": tj}
        where = f"mesh {n}^2 1x1 level {li} {(hp, wp)}"
        for name, fn, plain, kinds, ins in (
                ("k_down_block", lambda: (lev.down_block(*dh, org),),
                 lambda: (lev.down_plain(*dh, org),), ("exact",), dh),
                ("k_up_block", lambda: lev.up_block(*uh, org, with_dot=True),
                 lambda: lev.up_plain(*uh, org, with_dot=True), ("exact", "sum"), uh)):
            got, ref = fn(), plain()
            torch.cuda.synchronize()
            sc = {1: float((bm * ref[0]).abs().double().sum())} if name == "k_up_block" else None
            err, _ = compare(f"{name} @ {where}", got, ref, kinds, sc)
            nb = nbytes(ins) + nbytes(got[:1])
            rec[name] = {"max_abs_err": err, "ms": device_ms(fn),
                         "graph_ms": graph_ms(fn, calls=GRAPH_CALLS),
                         "bound_ms": nb / HBM_BYTES_PER_S * 1e3}
            del got, ref
        recs[li] = rec
        log(f"leg {where} (TJ {tj}): " + "  ".join(
            f"{k} {rec[k]['ms']:.4f} ms (graph {rec[k]['graph_ms']:.4f}; bound "
            f"{rec[k]['bound_ms']:.4f}, {100 * rec[k]['bound_ms'] / rec[k]['ms']:.0f} % / "
            f"{100 * rec[k]['bound_ms'] / rec[k]['graph_ms']:.0f} %; bit-equal to plain)"
            for k in ("k_down_block", "k_up_block")))
        del xb, ecb, dh, uh, bm
    del M, op
    torch.cuda.empty_cache()
    return recs


def legs_only(gen) -> int:
    """``--legs DIR``: :func:`check_legs` on path A's and the disk's
    hierarchies at 8192², :func:`check_legs_3d` on the 512³ route's and
    :func:`check_mesh_legs` on the 8192² mesh's for the port in DIR, then
    one JSON line {label: {level: record}}."""
    from iterative_solvers_tpu_torch.core.domain import Domain2D, notched_disk

    out = {}
    for label, dom in (("gamma", Domain2D(nx=N, ny=N)),
                       ("disk", Domain2D(nx=N, ny=N, shape="custom", inside_fn=notched_disk))):
        out[label] = check_legs(dom, gen, f"{label} {N}^2")
    out["3D"] = check_legs_3d(gen)
    out["mesh"] = check_mesh_legs(gen)
    log(json.dumps({"legs": out}))
    return 0


def cg_only(gen) -> int:
    """``--cg DIR``: K1, K2 and K2-pcg (gamma and custom: the six
    instantiations) of the port in DIR against their plain versions and
    timed, at path B's and C-B's NB² layouts (also on the graph timer) and
    the 8192² level-0 layouts; then its mesh blocks D5, D6 and D6-pcg on
    the 1x1 block of NB² (graph timer) and of 8192² (device and one-call
    timers), each against its plain version and beside K1, K2 and K2-pcg
    on the block's layout (:func:`_time_engine_1x1`); then one JSON line
    {label: {name: record}}."""
    from iterative_solvers_tpu_torch.core.domain import Domain2D, notched_disk

    out = {}
    for n in (NB, N):
        for label, dom in ((f"{n}^2", Domain2D(nx=n, ny=n)),
                           (f"custom {n}^2", Domain2D(nx=n, ny=n, shape="custom",
                                                      inside_fn=notched_disk))):
            out[label] = check_kernels(dom, gen, label, timed=True, only=("k1", "k2", "k2_pcg"),
                                       short=n == NB)
    ctx = _engine_checks()
    for n in (NB, N):
        out[f"block {n}^2 1x1"] = _time_engine_1x1(n, gen, *ctx, short=n == NB)
    log(json.dumps({"cg": out}))
    return 0


def check_count(path, iterations):
    """A live CG run's count within 1 % of ``CG_COUNTS[path]``."""
    want = CG_COUNTS[path]
    log(f"path {path} count {iterations} against {want} of CG_COUNTS "
        f"({100 * (iterations - want) / want:+.2f} %)")
    if abs(iterations - want) > 0.01 * want:
        raise AssertionError(f"path {path}: {iterations} iterations, more than 1 % from {want}")


def solve_64_agrees(label, run):
    """``run(device)`` -> (stop reason, outer count, inner count, converged,
    x on the CPU) at 64²: the card against the CPU — same stop reason and
    iteration counts, x within f32 round-off."""
    res = {dev: run(dev) for dev in ("cpu", "cuda")}
    a, b = res["cpu"], res["cuda"]
    gap = float((a[4] - b[4]).abs().max() / a[4].abs().max())
    log(f"{label} cuda vs cpu: reason {int(b[0])}/{int(a[0])} outer {b[1]}/{a[1]} "
        f"inner {b[2]}/{a[2]} x rel gap {gap:.2e} (tol 1e-5)")
    if b[:3] != a[:3]:
        raise AssertionError(f"{label}: trajectory differs between the card and the CPU")
    if not (b[3] and gap < 1e-5):
        raise AssertionError(f"{label}: the solve on the card disagrees with the CPU")


def small_checks(dom):
    """64² checks on ``dom``, the card against the CPU: the refinement (the
    gamma grid's cold f64 outer, or a custom domain's FMG + f64 default
    solve), the FMG + ff default solve, the reference algorithm through the
    facade (path B, or C-B on a custom domain; plain and preconditioned
    fused CG), and the FMG warm start with its polish at every fused level
    (the Jacobi kernel on gamma, plain level sweeps on a custom level)."""
    import torch

    from iterative_solvers_tpu_torch import DirichletSolver, PoissonProblem, StopConfig
    from iterative_solvers_tpu_torch.api import _attach_fmg
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.solvers.multigrid import (
        MultigridPreconditioner,
        PaddedPreconditioner,
    )
    from iterative_solvers_tpu_torch.solvers.refine import fused_refined_solve

    prob = PoissonProblem.manufactured(dom)
    lay = PaddedStencilOperator.from_domain(dom)
    custom = dom.shape == "custom"
    tag, path = (" custom", "C-B") if custom else ("", "B")

    def padded_mg(dev):
        M = MultigridPreconditioner.from_domain(dom, fuse=True, fuse_min_extent=16, device=dev)
        return _attach_fmg(PaddedPreconditioner(inner=M, padded_op=lay), prob)

    def run(dev, stop, **kw):
        r = fused_refined_solve(lay, padded_mg(dev), prob.rhs_field(device=dev),
                                u_true=prob.true_solution_field(device=dev), stop=stop, **kw)
        return r.reason, r.outer_iterations, r.iterations, r.converged, r.x.cpu()

    def run_b(dev, preconditioner):
        r = DirichletSolver(domain=dom, operator="fused", preconditioner=preconditioner,
                            device=dev).solve()
        return (r.stop_reason, r.outer_iterations, r.iterations, r.converged,
                torch.from_numpy(r.solution))

    rel6 = StopConfig(eps_precision=-1, eps_residual=-1, eps_relative=1e-6)
    if custom:
        solve_64_agrees("solve 64^2 custom fmg f64", lambda dev: run(dev, rel6, fmg=1))
    else:
        solve_64_agrees("solve 64^2 cold f64", lambda dev: run(
            dev, StopConfig(eps_precision=-1, eps_residual=-1, eps_relative=1e-9)))
    solve_64_agrees(f"solve 64^2{tag} fmg ff", lambda dev: run(dev, rel6, fmg=1, ff=True))
    solve_64_agrees(f"path {path} 64^2 plain CG", lambda dev: run_b(dev, None))
    solve_64_agrees(f"path {path} 64^2 mg PCG", lambda dev: run_b(dev, "mg"))
    # the warm start with the polish at every fused level (cutoff 16)
    kw = dict(polish_max_extent=16, smooth_sweeps=1)
    x0 = {dev: padded_mg(dev).fmg_stepwise(lay.pad(prob.rhs_field(device=dev)), 1, **kw)
          for dev in ("cpu", "cuda")}
    ref = x0["cpu"]
    gap = float((x0["cuda"].cpu() - ref).abs().max() / ref.abs().max())
    log(f"fmg_stepwise 64^2{tag} cutoff 16 cuda vs cpu: x0 rel gap {gap:.2e} (tol 1e-5)")
    if not gap < 1e-5:
        raise AssertionError("FMG warm start on the card disagrees with the CPU")
    torch.cuda.synchronize()


def stop_rel6():
    from iterative_solvers_tpu_torch import StopConfig

    return StopConfig(eps_precision=-1, eps_residual=-1, eps_relative=1e-6, max_iterations=100000)


def bench_route_3d(dom, device, **mg):
    """The JAX bench's 3D route: (padded 7-point operator, its f64 plain
    twin, PaddedPreconditioner around the multigrid with the FMG payload,
    padded f64 RHS)."""
    import torch

    from iterative_solvers_tpu_torch import PoissonProblem
    from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
    from iterative_solvers_tpu_torch.solvers.multigrid import (
        MultigridPreconditioner,
        PaddedPreconditioner,
    )
    from iterative_solvers_tpu_torch.solvers.refine import _padded_hi_operator

    prob = PoissonProblem.manufactured(dom)
    pop = Padded3DStencilOperator.from_domain(dom)
    M = MultigridPreconditioner.from_domain(dom, device=device, **mg)
    Mp = PaddedPreconditioner(inner=M.with_fmg(prob), padded_op=pop)
    return pop, _padded_hi_operator(pop), Mp, pop.pad(prob.rhs_field(torch.float64, device))


def small_checks_3d():
    """64³ checks of the 3D route, the card against the CPU: both outers,
    and the FMG warm start with the Jacobi polish (cutoff 16) at its three
    fused levels."""
    import torch

    from iterative_solvers_tpu_torch import Domain3D
    from iterative_solvers_tpu_torch.solvers.refine import device_refined_solve

    dom = Domain3D(64, 64, 64)

    def run(dev, ff):
        pop, A_hi, Mp, b = bench_route_3d(dom, dev, fuse=True, fuse_min_extent=16)
        r = device_refined_solve(A_hi, pop, b, stop=stop_rel6(), preconditioner=Mp, fmg=True, ff=ff)
        return r.reason, r.outer_iterations, r.iterations, r.converged, r.x.cpu()

    solve_64_agrees("3D 64^3 bench route f64", lambda dev: run(dev, False))
    solve_64_agrees("3D 64^3 bench route ff", lambda dev: run(dev, True))
    x0 = {}
    for dev in ("cpu", "cuda"):
        _, _, Mp, b = bench_route_3d(dom, dev, fuse=True, fuse_min_extent=16)
        x0[dev] = Mp.fmg_stepwise(b, 1, polish_max_extent=16, smooth_sweeps=1).cpu()
    gap = float((x0["cuda"] - x0["cpu"]).abs().max() / x0["cpu"].abs().max())
    log(f"3D fmg_stepwise 64^3 cutoff 16 cuda vs cpu: x0 rel gap {gap:.2e} (tol 1e-5)")
    if not gap < 1e-5:
        raise AssertionError("3D FMG warm start on the card disagrees with the CPU")
    torch.cuda.synchronize()


def solve_512_3d():
    """The JAX bench's 3D route at 512³ (ff outer, then f64), each timed
    after a warm-up with the launch counts set to 0 just before it. Returns
    the launch counts per path."""
    import torch

    from iterative_solvers_tpu_torch import Domain3D
    from iterative_solvers_tpu_torch.kernels import _build
    from iterative_solvers_tpu_torch.solvers.refine import device_refined_solve

    t0 = time.perf_counter()
    pop, A_hi, Mp, b = bench_route_3d(Domain3D(N3, N3, N3), "cuda")
    torch.cuda.synchronize()
    log(f"3D {N3}^3 set-up (hierarchy, f64 RHS on the card): {time.perf_counter() - t0:.3f} s; "
        f"layout {pop.padded_shape}, V-cycle levels "
        f"{[type(lv).__name__ for lv in Mp.inner.levels]}")

    def run(ff):
        return device_refined_solve(A_hi, pop, b, stop=stop_rel6(), preconditioner=Mp, fmg=True, ff=ff)

    run(True)  # warm: allocator pools, coarse inverse, masks
    launches = {}
    for path, ff in (("3D", True), ("3D f64", False)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        t0 = time.perf_counter()
        res = run(ff)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path], plain = dict(_build.launches), dict(_build.plain_on_cuda)
        peak = torch.cuda.max_memory_allocated()
        rel = float(torch.linalg.norm(b - A_hi(res.x)) / torch.linalg.norm(b))
        log(f"path {path} {N3}^3 bench route: converged {res.converged} reason {res.reason.name} "
            f"outer {res.outer_iterations} inner {res.iterations} true_rel {rel:.3e} "
            f"refine {res.elapsed_s:.4f} s wall {wall:.4f} s peak_mem {peak / 2**30:.2f} GiB")
        log(f"path {path} launches {launches[path]} plain_on_cuda {plain}")
        missing = [k for k in PATH_KERNELS[path] if launches[path].get(k, 0) <= 0]
        if not (res.converged and res.reason.name == "RELATIVE_RESIDUAL" and rel < 1e-6):
            raise AssertionError(f"path {path} failed: reason {res.reason.name} rel {rel:.3e}")
        if missing or plain:
            raise AssertionError(f"path {path}: kernels not launched {missing}; plain {plain}")
    refine_ab(run, f"{N3}^3 bench route")
    return launches


def plain_cg_3d():
    """Plain f32 CG on the 7-point kernel at 512³, as the JAX bench's
    baseline: ms per iteration as (t(110) − t(10)) / 100 (medians of two
    runs each, every criterion off), then one live run to rel 1e-6 with the
    launch counts set to 0 just before it. Returns its launch counts."""
    import torch

    from iterative_solvers_tpu_torch import Domain3D, PoissonProblem, StopConfig
    from iterative_solvers_tpu_torch.kernels import _build
    from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
    from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
    from iterative_solvers_tpu_torch.solvers.cg import CGOptions, cg_solve

    dom = Domain3D(N3, N3, N3)
    pop = Padded3DStencilOperator.from_domain(dom)
    b = pop.pad(PoissonProblem.manufactured(dom).rhs_field(torch.float32, "cuda"))
    t = {}
    for n_it in (10, 110, 10, 110):
        opts = CGOptions(stop=StopConfig(eps_precision=-1, eps_residual=-1, max_iterations=n_it))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg_solve(pop, b, options=opts)
        torch.cuda.synchronize()
        t.setdefault(n_it, []).append(time.perf_counter() - t0)
        assert res.iterations == n_it
    ms = (statistics.median(t[110]) - statistics.median(t[10])) / 100 * 1e3
    log(f"plain CG {N3}^3: {ms:.4f} ms/iteration (110-it {t[110]} s, 10-it {t[10]} s)")
    _build.reset_counts()
    t0 = time.perf_counter()
    res = cg_solve(pop, b, options=CGOptions(stop=stop_rel6()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_build.launches), dict(_build.plain_on_cuda)
    A64 = StencilOperator(pop.mask_spec, pop.coeffs)
    b64 = b.double()
    rel = float(torch.linalg.norm(b64 - A64(res.x.double())) / torch.linalg.norm(b64))
    log(f"plain CG {N3}^3 live run: reason {res.reason.name} iterations {res.iterations} "
        f"true_rel {rel:.3e} wall {wall:.3f} s launches {launches} plain_on_cuda {plain}")
    if not (res.converged and res.reason.name == "RELATIVE_RESIDUAL"):
        raise AssertionError(f"plain CG {N3}^3 failed: reason {res.reason.name}")
    if launches.get("stencil3d", 0) <= 0 or plain:
        raise AssertionError(f"plain CG {N3}^3: launches {launches}, plain {plain}")
    return launches


def true_rel(solver, res):
    import torch

    from iterative_solvers_tpu_torch import PoissonProblem
    from iterative_solvers_tpu_torch.ops.stencil import StencilOperator

    dom = solver.domain
    b = PoissonProblem.manufactured(dom).rhs_field(device="cuda")
    x = torch.as_tensor(res.solution_field(dom), device="cuda")
    return float(torch.linalg.norm(b - StencilOperator.from_domain(dom)(x)) / torch.linalg.norm(b))


def timed_solve(solver, path, warm=True):
    """A warm solve (unless ``warm`` is False), then one solve with the
    launch counts set to 0 just before it and read just after. Returns
    (results, wall s, launches)."""
    import torch

    from iterative_solvers_tpu_torch.kernels import _build

    if warm:
        solver.solve()  # warm: allocator pools, coarse inverse, masks, FMG payload
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_build.launches), dict(_build.plain_on_cuda)
    peak = torch.cuda.max_memory_allocated()
    log(f"path {path} launches {launches} plain_on_cuda {plain} peak_mem {peak / 2**30:.2f} GiB")
    missing = [k for k in PATH_KERNELS[path] if launches.get(k, 0) <= 0]
    if missing or plain:
        raise AssertionError(f"path {path}: kernels not launched {missing}; plain on CUDA {plain}")
    return res, wall, launches


def refine_ab(run, label, pairs=10):
    """ff vs f64 outer: ``run(ff)`` (a refinement, FMG warm start included)
    timed ``pairs`` times each, alternating which runs first. The rule for
    ``outer='auto'``: ff qualifies only if it wins at least 9 in 10 pairs by
    more than the f64 runs' quartile distance, with the same trajectory.
    Returns the medians, the trajectories and whether ff qualifies."""
    import torch

    times, traj = {"ff": [], "f64": []}, {}
    for i in range(pairs):
        for outer in (("ff", "f64") if i % 2 == 0 else ("f64", "ff")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(outer == "ff")
            torch.cuda.synchronize()
            times[outer].append(time.perf_counter() - t0)
            traj[outer] = (int(res.reason), res.outer_iterations, res.iterations)
    med = {k: statistics.median(v) for k, v in times.items()}
    quart = {k: statistics.quantiles(v, n=4) for k, v in times.items()}
    wins = sum(f < g for f, g in zip(times["ff"], times["f64"]))
    spread = quart["f64"][2] - quart["f64"][0]
    clear = sum(g - f > spread for f, g in zip(times["ff"], times["f64"]))
    qualifies = clear >= 0.9 * pairs and traj["ff"] == traj["f64"]
    log(f"A/B refine {label}, {pairs} pairs: ff median {med['ff']:.4f} s quartiles "
        f"{quart['ff'][0]:.4f}/{quart['ff'][2]:.4f} traj {traj['ff']}; f64 median "
        f"{med['f64']:.4f} s quartiles {quart['f64'][0]:.4f}/{quart['f64'][2]:.4f} traj "
        f"{traj['f64']}; ff faster in {wins}/{pairs} pairs, by more than the f64 quartile "
        f"distance {spread:.4f} s in {clear}/{pairs}: ff "
        f"{'qualifies' if qualifies else 'does not qualify'} for outer='auto'")
    log(f"A/B times ff {[round(t, 4) for t in times['ff']]} f64 {[round(t, 4) for t in times['f64']]}")
    return med, traj, qualifies


def plain_cg_ms_per_iter(dom, label, mesh=False):
    """Plain fused CG on ``dom`` with every criterion off: (t(105) − t(5)) /
    100, each the median of 3 wall times of ``fused_cg_solve`` (with
    ``mesh``, ``sharded_fused_cg_solve`` on a 1x1 mesh) ending in a sync."""
    import torch

    from iterative_solvers_tpu_torch import PoissonProblem, StopConfig
    from iterative_solvers_tpu_torch.kernels.cg_fused import fused_cg_solve
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.parallel import ShardedPallasStencilOperator, make_solver_mesh
    from iterative_solvers_tpu_torch.parallel.cg_fused_sharded import sharded_fused_cg_solve
    from iterative_solvers_tpu_torch.solvers.cg import CGOptions

    if mesh:
        pop = ShardedPallasStencilOperator.from_domain(dom, make_solver_mesh(1))
        solve = sharded_fused_cg_solve
    else:
        pop, solve = PaddedStencilOperator.from_domain(dom), fused_cg_solve
    b = PoissonProblem.manufactured(dom).rhs_field(device="cuda")
    t = {}
    for n_it in (5, 105, 5, 105, 5, 105):
        opts = CGOptions(stop=StopConfig(eps_precision=-1, eps_residual=-1, max_iterations=n_it))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(pop, b, options=opts)
        torch.cuda.synchronize()
        t.setdefault(n_it, []).append(time.perf_counter() - t0)
        assert res.iterations == n_it
    ms = (statistics.median(t[105]) - statistics.median(t[5])) / 100 * 1e3
    log(f"plain CG {label}: {ms:.4f} ms/iteration (105-it {t[105]} s, 5-it {t[5]} s)")
    return ms


def custom_paths(disk):
    """The custom-mask domain at full size: path C, the default solve on the
    8192² notched disk ``disk`` (``outer='ff'``, then ``'auto'``, f64 in
    2D), and path C-B, plain f32 CG at 1024² to the relative criterion and
    its ms per iteration at 8192². Returns the launch counts per path."""
    import torch

    from iterative_solvers_tpu_torch import DirichletSolver, Domain2D
    from iterative_solvers_tpu_torch.core.domain import notched_disk

    rel6 = stop_rel6()
    launches = {}
    for path, outer in (("C", "ff"), ("C f64", "auto")):
        t0 = time.perf_counter()
        solver = DirichletSolver(domain=disk, preconditioner="mg", precision="mixed", outer=outer,
                                 device="cuda", stop=rel6)
        res, wall, launches[path] = timed_solve(solver, path)
        rel = true_rel(solver, res)
        log(f"path {path} {N}^2 custom (outer {solver.outer_kind}, {disk.num_unknowns} unknowns): "
            f"converged {res.converged} reason {res.stop_reason.name} outer "
            f"{res.outer_iterations} inner {res.iterations} true_rel {rel:.3e} refine "
            f"{res.elapsed_s:.4f} s wall {wall:.3f} s (with set-up and warm-up "
            f"{time.perf_counter() - t0:.3f} s)")
        if not (res.converged and res.stop_reason.name == "RELATIVE_RESIDUAL" and rel < 1e-6):
            raise AssertionError(f"path {path} failed: reason {res.stop_reason.name} "
                                 f"rel {rel:.3e}")
        del solver, res
        torch.cuda.empty_cache()
    nb = NB
    solver = DirichletSolver(domain=Domain2D(nx=nb, ny=nb, shape="custom", inside_fn=notched_disk),
                             operator="fused", device="cuda", stop=rel6)
    res, wall, launches["C-B"] = timed_solve(solver, "C-B")
    rel = true_rel(solver, res)
    log(f"path C-B {nb}^2 custom plain CG: converged {res.converged} reason "
        f"{res.stop_reason.name} iterations {res.iterations} true_rel {rel:.3e} solve "
        f"{res.elapsed_s:.4f} s wall {wall:.3f} s")
    if not (res.converged and res.stop_reason.name == "RELATIVE_RESIDUAL" and rel < 1e-3):
        raise AssertionError(f"path C-B failed: converged={res.converged} rel={rel:.3e}")
    check_count("C-B", res.iterations)
    del solver, res
    torch.cuda.empty_cache()
    plain_cg_ms_per_iter(disk, f"{N}^2 custom")
    torch.cuda.empty_cache()
    return launches


def check_pipelined(dom, gen, label, timed, block_rows=None):
    """C4 and C5 on one layout, random and all-ones unmasked input: C4 at
    scale 1 and C5 (in place and not, lookahead 2 and 4) bit-equal to A1,
    the in-place results in x's storage, an in-place call's peak memory
    within its side buffer (two rows for each of ``plan_ranges``' ranges)
    plus 1 MiB, the side buffer within 1/16 of the field; then both against
    their plain versions with the chain's scale 7e-6 (64 eps32 ·
    max|plain|). Returns {name: dict of max_abs_err, ms, plain_ms,
    library_ms, bytes, nodes}: timed on the all-ones canvas, as the chain
    runs."""
    import torch

    from iterative_solvers_tpu_torch.kernels import _build
    from iterative_solvers_tpu_torch.kernels import stencil_pipelined as sp
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator

    lay = PaddedStencilOperator.from_domain(dom, block_rows=block_rows)
    sfx = "_custom" if lay.mask8 is not None else ""
    hp, wp = lay.padded_shape
    scale = 7e-6
    rows, ranges = sp.plan_ranges(hp, _build.sm_count(torch.device("cuda")))
    side = ranges * 2 * wp * 4
    if side > hp * wp * 4 // 16:
        raise AssertionError(f"C4/C5{sfx} @ {label}: side buffer {side} B above 1/16 of the field")

    def peak_growth(fn, x):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        y = fn(x)
        torch.cuda.synchronize()
        return y, torch.cuda.max_memory_allocated() - base

    for kind in ("random", "ones"):
        x = (torch.randn(lay.padded_shape, device="cuda", generator=gen) if kind == "random"
             else torch.ones(lay.padded_shape, device="cuda"))
        a1 = lay(x)
        xc = x.clone()
        y, grow4 = peak_growth(lambda t: sp.stencil_apply_inplace(t, lay), xc)
        if y.data_ptr() != xc.data_ptr():
            raise AssertionError(f"stencil_inplace{sfx} @ {label}: result not in x's storage")
        if not torch.equal(y, a1):
            raise AssertionError(f"stencil_inplace{sfx} @ {label} {kind}: differs from A1")
        grow5 = 0
        for lookahead in (2, 4):
            for in_place in (True, False):
                xc = x.clone()
                y, grow = peak_growth(lambda t: sp.stencil_apply_pipelined(
                    t, lay, in_place=in_place, lookahead=lookahead), xc)
                if not torch.equal(y, a1) or (y.data_ptr() == xc.data_ptr()) != in_place:
                    raise AssertionError(f"stencil_pipelined{sfx} @ {label} {kind} in_place "
                                         f"{in_place} lookahead {lookahead}: differs from A1")
                if in_place:
                    grow5 = max(grow5, grow)
        if max(grow4, grow5) > side + 2**20:
            raise AssertionError(f"C4/C5{sfx} @ {label}: in-place peak grew {grow4} / {grow5} B, "
                                 f"side buffer {side} B")
        log(f"kernel C4/C5{sfx} @ {label} {kind}: bit-equal to A1 (C5 in place and not, "
            f"lookahead 2 and 4), in x's storage; {ranges} ranges of {rows} rows "
            f"({lay.block_rows}-row panels); in-place peak +{grow4} B (C4), +{grow5} B (C5), "
            f"side buffer {side} B ({side / (hp * wp * 4):.4f} of the field)")
        del x, xc, y, a1
    x = torch.randn(lay.padded_shape, device="cuda", generator=gen)
    ones = torch.ones(lay.padded_shape, device="cuda")
    cases = {
        "stencil_inplace": (lambda t: sp.stencil_apply_inplace(t, lay, scale),
                            lambda t: sp.inplace_plain(t, lay, scale)),
        "stencil_pipelined": (lambda t: sp.stencil_apply_pipelined(t, lay, scale=scale),
                              lambda t: sp.pipelined_plain(t, lay, scale=scale)),
    }
    out = {}
    for base, (kern, plain) in cases.items():
        name = base + sfx
        got, ref = kern(x.clone()), plain(x.clone())
        torch.cuda.synchronize()
        err, tol = compare(f"{name} @ {label}", (got,), (ref,), ("field",))
        nb, n_in = stencil_bytes(lay)  # the same function as A1's
        rec = {"max_abs_err": err, "bytes": nb, "nodes": n_in, "library_ms": None,
               "shape": [hp, wp]}
        line = f"kernel {name:24s} @ {label}: max_abs_err {err:.3e} tol {tol:.3e}"
        if timed:
            xk, xp = ones.clone(), ones.clone()
            rec.update(kernel_times(lambda: kern(xk), lambda: plain(xp)))
            rec["library_ms"] = conv2d_ms(lay, ones)
            line += (f"  kernel {rec['ms']:.4f} ms (one call {rec['one_call_ms']:.4f}; bound "
                     f"{rec['bytes'] / HBM_BYTES_PER_S * 1e3:.4f})  plain "
                     f"{rec['plain_ms']:.4f} ms  conv2d {rec['library_ms']:.4f} ms")
        log(line)
        out[name] = rec
    if timed:  # the other C5 forms and A1, for the record
        xk = ones.clone()
        c5_4 = device_ms(lambda: sp.stencil_apply_pipelined(xk, lay, lookahead=4, scale=scale))
        c5_2 = device_ms(lambda: sp.stencil_apply_pipelined(ones, lay, in_place=False))
        log(f"C5{sfx} @ {label}: lookahead 4 in place {c5_4:.4f} ms, lookahead 2 out of place "
            f"{c5_2:.4f} ms; A1 {device_ms(lambda: lay(ones)):.4f} ms (device timer)")
    return out


def stencil_bytes(lay):
    """(bytes, interior nodes) of the masked 5-point function on ``lay``,
    which A1 / C1 and C4 / C5 compute: x read on the interior only (a read
    masked off it needs no memory, and A1's tiles issue none), y written
    over the whole canvas, a custom layout's int8 mask read once."""
    hp, wp = lay.padded_shape
    n_in = int(lay.mask_spec.build("cuda").sum())
    return 4 * n_in + 4 * hp * wp + (hp * wp if lay.mask8 is not None else 0), n_in


def a1_row(lay, gen, label, timed, short=False, exact=True):
    """A1 (C1 on a custom layout) on ``lay``, a kernel row as
    :func:`check_kernels` returns them: held to its plain version on an
    unmasked random field (every read is masked: bit for bit with
    ``exact``, else the field tolerance, for an earlier checkout); with
    ``timed`` its device, one-call and plain times and one ``F.conv2d``,
    with ``short`` also the graph timer (what a kernel shorter than the
    host's issue time holds against its bound). ``bytes``/``bound_ms`` from
    :func:`stencil_bytes`, ``nodes`` the interior. Uses only the operator's
    public calls, so an earlier checkout is timed alike."""
    import torch

    name = "stencil_custom" if lay.mask8 is not None else "stencil"
    x = torch.randn(lay.padded_shape, device="cuda", generator=gen)
    kern, plain = (lambda: (lay(x),)), (lambda: (lay.apply_plain(x),))
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err, tol = compare(f"{name} @ {label}", got, ref, ("exact" if exact else "field",))
    del got, ref
    nb, n_in = stencil_bytes(lay)
    rec = {"max_abs_err": err, "bytes": nb, "nodes": n_in, "library_ms": None,
           "shape": list(lay.padded_shape), "block_rows": lay.block_rows,
           "bound_ms": nb / HBM_BYTES_PER_S * 1e3}
    line = f"kernel {name:17s} @ {label}: max_abs_err {err:.3e} tol {tol:.3e}"
    if timed:
        rec.update(kernel_times(kern, plain))
        rec["library_ms"] = conv2d_ms(lay, x)
        t, timer = rec["ms"], "device"
        if short:
            rec["graph_ms"] = t = graph_ms(kern, reps=5, calls=GRAPH_CALLS)
            timer = "graph"
        line += (f"  kernel {rec['ms']:.4f} ms  one call {rec['one_call_ms']:.4f} ms"
                 + (f"  graph {t:.4f} ms" if short else "")
                 + f"  plain {rec['plain_ms']:.4f} ms  conv2d {rec['library_ms']:.4f} ms  "
                 f"bound {rec['bound_ms']:.4f} ms ({100 * rec['bound_ms'] / t:.0f} % on the "
                 f"{timer} timer; {lay.padded_shape}, {lay.block_rows}-row bands)")
    log(line)
    del x
    return rec


def time_d1(gen):
    """``--stencil``'s D1 (the mesh block stencil, ``ist::stencil_column``)
    on the 1x1 block of 8192², as :func:`check_mesh_kernels` times it:
    against its plain version (field tolerance), the device and one-call
    timers, one ``F.conv2d`` and the bound of D1's ``kernels`` row (the
    halos' and the output's bytes)."""
    import torch

    from iterative_solvers_tpu_torch import Domain2D
    from iterative_solvers_tpu_torch.parallel import ShardedPallasStencilOperator, make_solver_mesh
    from iterative_solvers_tpu_torch.parallel.halo_pallas import block_stencil_plain

    op1 = ShardedPallasStencilOperator.from_domain(Domain2D(nx=N, ny=N), make_solver_mesh(1))
    xb = torch.randn(op1.padded_shape, device="cuda", generator=gen)
    h1 = op1.halos_from_global(xb, (0, 0))
    kern = lambda: (op1.apply_block(*h1),)  # noqa: E731
    got = kern()
    torch.cuda.synchronize()
    err, tol = compare(f"stencil_block @ {N}^2 1x1", got,
                       (block_stencil_plain(*h1, op1.block_spec(), op1.coeffs),), ("field",))
    nb = nbytes(h1) + nbytes(got)
    rec = {"max_abs_err": err, "bytes": nb, "bound_ms": nb / HBM_BYTES_PER_S * 1e3,
           "ms": device_ms(kern), "one_call_ms": one_call_ms(kern),
           "library_ms": conv2d_ms(op1, xb), "shape": list(op1.padded_shape)}
    log(f"kernel stencil_block @ {N}^2 1x1: max_abs_err {err:.3e} tol {tol:.3e}  kernel "
        f"{rec['ms']:.4f} ms  one call {rec['one_call_ms']:.4f} ms  conv2d "
        f"{rec['library_ms']:.4f} ms  bound {rec['bound_ms']:.4f} ms "
        f"({100 * rec['bound_ms'] / rec['ms']:.0f} %)")
    del xb, h1, got
    torch.cuda.empty_cache()
    return rec


def time_stencils(dom, block_rows, label, gen):
    """``--stencil``'s record of one layout: C4 and C5 (in place and out of
    place, lookahead 2 and 4), each bit-equal to A1 at scale 1 on a random
    field, then timed with the chain's scale on the all-ones canvas (device
    and one-call timers), A1, one ``F.conv2d`` and one copy of the field
    (``Tensor.copy_``: what a plain 8 B/node stream reaches) on the same
    canvas, then :func:`nnz_chain` for A1, C4 and C5. Uses only the
    wrappers' public functions, so an earlier checkout is timed alike."""
    import torch

    from iterative_solvers_tpu_torch.kernels import stencil_pipelined as sp
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator

    lay = PaddedStencilOperator.from_domain(dom, block_rows=block_rows)
    hp, wp = lay.padded_shape
    custom = lay.mask8 is not None
    scale = 7e-6
    forms = {
        "C4": lambda t, s: sp.stencil_apply_inplace(t, lay, s),
        "C5 in place la2": lambda t, s: sp.stencil_apply_pipelined(t, lay, lookahead=2, scale=s),
        "C5 in place la4": lambda t, s: sp.stencil_apply_pipelined(t, lay, lookahead=4, scale=s),
        "C5 out la2": lambda t, s: sp.stencil_apply_pipelined(t, lay, in_place=False,
                                                              lookahead=2, scale=s),
        "C5 out la4": lambda t, s: sp.stencil_apply_pipelined(t, lay, in_place=False,
                                                              lookahead=4, scale=s),
    }
    x = torch.randn(lay.padded_shape, device="cuda", generator=gen)
    a1 = lay(x)
    for name, fn in forms.items():
        if not torch.equal(fn(x.clone(), 1.0), a1):
            raise AssertionError(f"{name} @ {label}: differs from A1")
    del x, a1
    ones = torch.ones(lay.padded_shape, device="cuda")
    rec = {"shape": [hp, wp], "block_rows": lay.block_rows,
           "bound_ms": stencil_bytes(lay)[0] / HBM_BYTES_PER_S * 1e3}
    for name, fn in forms.items():
        xk = ones.clone()
        rec[name] = {"ms": device_ms(lambda: fn(xk, scale)),
                     "one_call_ms": one_call_ms(lambda: fn(xk, scale))}
        del xk
    rec["A1"] = {"ms": device_ms(lambda: lay(ones)), "one_call_ms": one_call_ms(lambda: lay(ones))}
    rec["conv2d"] = {"ms": conv2d_ms(lay, ones)}
    # yardstick: one copy of the field, the same 8 B/node read-and-write stream
    yb = torch.empty_like(ones)
    rec["copy"] = {"ms": device_ms(lambda: yb.copy_(ones))}
    log(f"stencil {label} {lay.padded_shape} ({lay.block_rows}-row panels; bound "
        f"{rec['bound_ms']:.4f} ms): " + "  ".join(
            f"{n} {r['ms']:.4f} ms" + (f" (one call {r['one_call_ms']:.4f}, "
                                       f"{100 * rec['bound_ms'] / r['ms']:.0f} %)"
                                       if "one_call_ms" in r else "")
            for n, r in rec.items() if isinstance(r, dict)))
    del ones, yb
    sfx = " custom" if custom else ""
    rec["chain"] = nnz_chain(dom, block_rows, label, (
        (f"nnz A1{sfx}", "stencil", None), (f"nnz C4{sfx}", "inplace", None),
        (f"nnz C5{sfx}", "pipelined", None)))
    torch.cuda.empty_cache()
    return rec


def stencil_only(gen, exact) -> int:
    """``--stencil DIR``: for the port in DIR, A1 and C1 where the solver
    runs them (:func:`a1_row`): at paths B's and C-B's 1024² layouts on the
    graph timer, A1 at the 4096² ``precond`` layout on the device timer
    (``exact``: bit-equal to the plain version, else within the field
    tolerance, for an earlier checkout); D1 on the 1x1 block of 8192²
    (:func:`time_d1`); then :func:`time_stencils` at 8192²
    and on the notched disk at 8192², each on the 256-row panels of
    ``bench.py``'s ``nnz`` layout and at ``auto_block_rows``; then one JSON
    line {label: record}."""
    from iterative_solvers_tpu_torch.core.domain import Domain2D, notched_disk
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator

    out = {}
    for label, dom, graph in (
            (f"{NB}^2 path B", Domain2D(nx=NB, ny=NB), True),
            (f"custom {NB}^2 C-B", Domain2D(nx=NB, ny=NB, shape="custom",
                                            inside_fn=notched_disk), True),
            (f"{PRECOND_N}^2 precond", Domain2D(nx=PRECOND_N, ny=PRECOND_N), False)):
        out[label] = a1_row(PaddedStencilOperator.from_domain(dom), gen, label, timed=True,
                            short=graph, exact=exact)
    out[f"D1 {N}^2 1x1"] = time_d1(gen)
    for name, dom in (("", Domain2D(nx=N, ny=N)),
                      ("custom ", Domain2D(nx=N, ny=N, shape="custom", inside_fn=notched_disk))):
        for by in (256, None):
            label = f"{name}{N}^2 {by or 'auto'}"
            out[label] = time_stencils(dom, by, label, gen)
    log(json.dumps({"stencil": out}))
    return 0


def nnz_chain(dom, block_rows, label, kernels):
    """``bench.py``'s ``nnz`` mode on the port's chain (``spmv_chain`` from an
    all-ones canvas, scale 7e-6): per ``(path, kernel)`` the ms per apply as
    ``(t(4 k_lo) − t(k_lo)) / (3 k_lo)``, each the minimum of three runs,
    with k_lo sized for ~0.15 s as the bench does (``kernels`` with k None),
    or only a counted chain of k applies. Then one chain with the launch
    counts set to 0 just before it. Gnnz/s with the unpadded operator's nnz;
    the bound counts 8 B per canvas node (``bench.py``'s roofline, 9).
    The 4-apply chains are finite and give bit-equal sums (C4 and C5 fold
    the scale after A1's arithmetic, as A1's chain multiplies after it).
    Longer chains overflow: at 8192² the scale times the spectral radius of
    A is ~3.8e3, so the boundary modes reach f32's limit within ~11 applies
    and the timed chains, the bench's too, run on inf and NaN (at full
    speed: the card has no slow path for them). Returns {path: {launches,
    ms_per_apply, gnnz_s}} (the rates None for a counted chain alone)."""
    import torch

    from iterative_solvers_tpu_torch.kernels import _build
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.kernels.stencil_pipelined import spmv_chain
    from iterative_solvers_tpu_torch.ops.stencil import StencilOperator

    lay = PaddedStencilOperator.from_domain(dom, block_rows=block_rows)
    hp, wp = lay.padded_shape
    nnz = StencilOperator.from_domain(dom).nnz()
    x = torch.ones(lay.padded_shape, device="cuda")
    bound = 8 * hp * wp / HBM_BYTES_PER_S * 1e3

    def run(kernel, k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = float(spmv_chain(lay, x, k, kernel=kernel))
        return time.perf_counter() - t0, total

    log(f"nnz {label}: layout {lay.padded_shape}, {lay.block_rows}-row panels, nnz {nnz}; "
        f"bound 8 B/node {bound:.4f} ms ({nnz / bound * 1e3 / 1e9:.1f} Gnnz/s; bench.py's "
        f"roofline counts 9 B/node: {9 * hp * wp / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    out, sums = {}, {}
    for path, kernel, k in kernels:
        run(kernel, 2)  # warm
        sums[path] = run(kernel, 4)[1]
        out[path] = {"ms_per_apply": None, "gnnz_s": None}
        if k is None:
            per_est = max(run(kernel, 8)[0] / 8, 1e-7)
            k = max(8, int(0.15 / per_est))
            t_lo = min(run(kernel, k)[0] for _ in range(3))
            t_hi = min(run(kernel, 4 * k)[0] for _ in range(3))
            per = (t_hi - t_lo) / (3 * k)
            log(f"nnz {label} {kernel}: {per * 1e3:.4f} ms/apply, {nnz / per / 1e9:.1f} Gnnz/s "
                f"(k {k} / {4 * k}: {t_lo:.4f} / {t_hi:.4f} s), {bound / (per * 1e3):.1%} of "
                f"the 8 B/node bound")
            out[path] = {"ms_per_apply": per * 1e3, "gnnz_s": nnz / per / 1e9}
        _build.reset_counts()
        t, total = run(kernel, k)
        launches, plain = dict(_build.launches), dict(_build.plain_on_cuda)
        out[path]["launches"] = launches
        want = PATH_KERNELS[path][0]
        log(f"nnz {label} {kernel} counted chain: k {k} sum {total:.6e} {t:.4f} s launches "
            f"{launches} plain_on_cuda {plain}")
        if launches.get(want, 0) != k or plain:
            raise AssertionError(f"nnz {label} {kernel}: launches {launches}, plain {plain}")
    if len(set(sums.values())) != 1 or not all(abs(v) < float("inf") for v in sums.values()):
        raise AssertionError(f"nnz {label}: the 4-apply chains disagree or overflow: {sums}")
    log(f"nnz {label}: 4-apply chain sums bit-equal across kernels: {sums}")
    return out


def precond_race(n):
    """``bench.py``'s ``precond`` mode at n²: plain CG and Chebyshev-8 PCG on
    the padded operator (A1), fused MG-PCG, each to recurrence rel 1e-6 with
    the launch counts set to 0 just before it. Returns {path: launches}."""
    import torch

    from iterative_solvers_tpu_torch import Domain2D, PoissonProblem
    from iterative_solvers_tpu_torch.kernels import _build
    from iterative_solvers_tpu_torch.kernels.cg_fused import fused_cg_solve
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
    from iterative_solvers_tpu_torch.solvers.cg import CGOptions, cg_solve
    from iterative_solvers_tpu_torch.solvers.multigrid import (
        MultigridPreconditioner,
        PaddedPreconditioner,
    )
    from iterative_solvers_tpu_torch.solvers.precond import ChebyshevPreconditioner

    dom = Domain2D(nx=n, ny=n)
    op = PaddedStencilOperator.from_domain(dom)
    b64 = PoissonProblem.manufactured(dom).rhs_field(torch.float64, "cuda")
    b = op.pad(b64.float())
    rel6 = stop_rel6()
    M_cheb = ChebyshevPreconditioner.from_domain(op, dom, degree=8)
    M_mg = PaddedPreconditioner(inner=MultigridPreconditioner.from_domain(dom, device="cuda"),
                                padded_op=op)
    runs = {
        "precond plain": lambda: cg_solve(op, b, options=CGOptions(stop=rel6)),
        "precond cheb8": lambda: cg_solve(op, b, options=CGOptions(stop=rel6,
                                                                  preconditioner=M_cheb)),
        "precond mg": lambda: fused_cg_solve(op, op.crop(b), options=CGOptions(
            stop=rel6, preconditioner=M_mg)),
    }
    runs["precond mg"]()  # warm: the V-cycle's coarse inverse and masks
    A64 = StencilOperator.from_domain(dom)
    launches, secs = {}, {}
    for path, run in runs.items():
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        secs[path] = time.perf_counter() - t0
        launches[path], plain = dict(_build.launches), dict(_build.plain_on_cuda)
        x = res.x if res.x.shape == b64.shape else op.crop(res.x)
        rel = float(torch.linalg.norm(b64 - A64(x.double())) / torch.linalg.norm(b64))
        log(f"{path} {n}^2: reason {res.reason.name} iterations {res.iterations} "
            f"{secs[path]:.4f} s true_rel {rel:.3e} launches {launches[path]} plain_on_cuda "
            f"{plain}")
        missing = [k for k in PATH_KERNELS[path] if launches[path].get(k, 0) <= 0]
        if not (res.converged and res.reason.name == "RELATIVE_RESIDUAL") or missing or plain:
            raise AssertionError(f"{path}: reason {res.reason.name}, missing {missing}, "
                                 f"plain {plain}")
        if path in CG_COUNTS:
            check_count(path, res.iterations)
    log(f"precond {n}^2: plain / cheb8 {secs['precond plain'] / secs['precond cheb8']:.2f}x, "
        f"plain / mg {secs['precond plain'] / secs['precond mg']:.2f}x")
    return launches


def csr_race(n):
    """``bench.py``'s ``csr`` mode at n²: 200 f32 CG iterations on the plain
    stencil (full-grid fields) and on the CSR matrix (compacted vectors),
    each after a warm run; equal counts, ms per iteration of each."""
    import torch

    from iterative_solvers_tpu_torch import Domain2D, PoissonProblem, StopConfig
    from iterative_solvers_tpu_torch.core import ordering
    from iterative_solvers_tpu_torch.ops.sparse import SparseOperator
    from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
    from iterative_solvers_tpu_torch.solvers.cg import CGOptions, cg_solve

    dom = Domain2D(nx=n, ny=n)
    b = PoissonProblem.manufactured(dom).rhs_field(torch.float32, "cuda")
    opts = CGOptions(stop=StopConfig(max_iterations=200).disable_all_but_iterations())
    ms = {}
    for name, A, rhs in (("matrix-free", StencilOperator.from_domain(dom), b),
                         ("csr", SparseOperator.from_domain(dom, torch.float32, "cuda"),
                          ordering.pack(b, dom))):
        cg_solve(A, rhs, options=opts)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg_solve(A, rhs, options=opts)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / res.iterations * 1e3
        if res.iterations != 200:
            raise AssertionError(f"csr race {name}: {res.iterations} iterations")
    log(f"csr {n}^2, 200 CG iterations each: matrix-free {ms['matrix-free']:.4f} ms/iteration, "
        f"csr {ms['csr']:.4f} ms/iteration (csr / matrix-free {ms['csr'] / ms['matrix-free']:.2f})")


def facade_paths():
    """The facade's precision=None paths and the generic mixed ladder, each
    with the launch counts set to 0 just before it. Returns {path: launches}."""
    import torch

    from iterative_solvers_tpu_torch import DirichletSolver

    launches = {}
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = DirichletSolver(nx=30, ny=30, device=dev).solve()
    res, wall, launches["facade default"] = timed_solve(DirichletSolver(nx=30, ny=30),
                                                        "facade default")
    log(f"facade default 30^2 cuda / cpu: reason {res.stop_reason.name} / "
        f"{out['cpu'].stop_reason.name} iterations {res.iterations} / {out['cpu'].iterations} "
        f"error_norm {res.error_norm:.4e} / {out['cpu'].error_norm:.4e} wall {wall:.4f} s")
    if (res.stop_reason, res.iterations) != (out["cpu"].stop_reason, out["cpu"].iterations):
        raise AssertionError("facade default: the card and the CPU disagree")
    rel6 = stop_rel6()
    for path, kw, gate in (
        ("facade pallas cheb8", dict(nx=PRECOND_N, ny=PRECOND_N, operator="pallas",
                                     preconditioner="chebyshev:8"), 1e-3),
        ("facade pallas mg", dict(nx=PRECOND_N, ny=PRECOND_N, operator="pallas",
                                  preconditioner="mg"), 1e-3),
        ("facade sparse", dict(nx=1024, ny=1024, operator="sparse"), 1e-6),
        ("facade mixed cheb", dict(nx=2048, ny=2048, precision="mixed",
                                   preconditioner="chebyshev", outer="f64"), 1e-6),
        ("facade mixed cheb", dict(nx=2048, ny=2048, precision="mixed",
                                   preconditioner="chebyshev", outer="ff"), 1e-6),
    ):
        solver = DirichletSolver(device="cuda", stop=rel6, **kw)
        res, wall, launches[path] = timed_solve(solver, path, warm=False)
        rel = true_rel(solver, res)
        log(f"{path} {kw['nx']}^2 {kw.get('outer', '')}: converged {res.converged} reason "
            f"{res.stop_reason.name} outer {res.outer_iterations} iterations {res.iterations} "
            f"true_rel {rel:.3e} solve {res.elapsed_s:.4f} s wall {wall:.3f} s")
        if not (res.converged and res.stop_reason.name == "RELATIVE_RESIDUAL" and rel < gate):
            raise AssertionError(f"{path} failed: reason {res.stop_reason.name} rel {rel:.3e}")
        if path in CG_COUNTS:
            check_count(path, res.iterations)
        del solver, res
        torch.cuda.empty_cache()
    return launches



# --- the mesh layer (D1–D4) ----------------------------------------------------

MESH_N = 2048  # the 4-rank world on the one card
MESH_N3 = 512  # the 3D facade on a 1x1 mesh


def _virtual(shape):
    """The ranks of a mesh shape, for a block partition run in one process."""
    from iterative_solvers_tpu_torch.parallel import SolverMesh

    names = ("slice", "y", "x") if len(shape) == 3 else ("y", "x")
    return [SolverMesh(names, shape, rank=r) for r in range(math.prod(shape))]


def _stitch(meshes, parts):
    import torch

    rows = [[p for m, p in zip(meshes, parts) if m.coords[0] == ri]
            for ri in range(meshes[0].rows)]
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=0)


def _stitched_agree(name, got, ref, block, exact=False):
    """Stitched blocks against the single-device kernel: nodes away from the
    block edges bit-equal, edge nodes within 64 eps32 · max|ref| (the
    tolerance of mg_sharded.py:31-34's f32 round-off), or bit-equal too when
    ``exact``; logs whether the edges are bit-equal."""
    import torch

    diff = got != ref
    edge = torch.zeros_like(diff)
    for ax, b in ((0, block[0]), (diff.ndim - 1, block[-1])):
        idx = torch.arange(diff.shape[ax], device=diff.device) % b
        on = (idx == 0) | (idx == b - 1)
        edge |= on.view([-1 if a == ax else 1 for a in range(diff.ndim)])
    inner = int((diff & ~edge).sum())
    err = float((got.double() - ref.double())[edge].abs().max())
    tol = 64 * EPS32 * float(ref.double().abs().max())
    log(f"stitched {name}: {int(diff.sum())} nodes differ ({inner} away from block edges), "
        f"edge max err {err:.3e} tol {tol:.3e}")
    if inner or not err <= tol or (exact and err != 0.0):
        raise AssertionError(f"stitched {name} differs from the single-device kernel")


def check_mesh_kernels(gen):
    """D1, D3, D4 on a virtual (4, 2) partition of the 8192² Г level-0 grid
    and D2 on a (2, 1, 2) split of the 512³ box: each block's halos cut from
    the global field as the ring exchange delivers them, each launch against
    its plain version, the stitched blocks against the single-device A1,
    A5, A6 and S7. Then each kernel timed on the 1x1 block (the whole
    canvas) beside its plain version and, for D1/D2, F.conv2d/F.conv3d.
    Returns {name: stats} as check_kernels."""
    import torch
    import torch.nn.functional as F

    from iterative_solvers_tpu_torch import Domain2D, Domain3D
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
        make_solver_mesh,
    )
    from iterative_solvers_tpu_torch.parallel.halo_pallas import (
        block_stencil3d_plain,
        block_stencil_plain,
    )
    from iterative_solvers_tpu_torch.parallel.mg_sharded import ShardedFusedMultigrid
    from iterative_solvers_tpu_torch.solvers.multigrid import fused_block_rows

    worst = {k: 0.0 for k in ("stencil_block", "k_down_block", "k_up_block", "stencil3d_block")}

    def check(name, got, ref, kinds, scales=None):
        torch.cuda.synchronize()
        err, tol = compare(name, got, ref, kinds, scales)
        key = name.split(" ")[0]
        worst[key] = max(worst[key], err)
        return err, tol

    dom = Domain2D(nx=N, ny=N)
    meshes = _virtual((4, 2))
    ops = [ShardedPallasStencilOperator.from_domain(dom, m) for m in meshes]
    # a level is the same on every rank (each call takes its block's origin)
    levs = [ShardedFusedMultigrid.from_operator(ops[0], dom, device="cuda").levels[0]] * len(ops)
    (hp, wp), by = ops[0].padded_shape, ops[0].block_rows
    x = torch.randn((hp, wp), device="cuda", generator=gen)
    # A6 reads the coarse correction on the child's padded canvas (path A's
    # 4096 level: 4160 x 4224); the blocks read its lane prolongation, as the
    # mesh forms it between its legs
    single = FusedLevelKernels(N, N, levs[0].coeffs, levs[0].cs, "gamma", (hp, wp), by,
                               child_shape=fused_block_rows(N // 2 + 1, N // 2 + 1)[1:])
    ec = torch.randn(single.coarse_shape, device="cuda", generator=gen)
    ch = N // 2 + 1
    ecl = F.pad(lane_prolong(ec[:ch], N // 2, wp), (0, 0, 0, hp // 2 - ch))
    parts = {"stencil_block": [], "k_down_block": [], "k_up_block": []}
    for op, lev in zip(ops, levs):
        h = op.halos_from_global(x, op.origin)
        y = op.apply_block(*h)
        check("stencil_block @ (4,2)", (y,), (block_stencil_plain(*h, op.block_spec(), op.coeffs),),
              ("field",))
        dh = lev.down_halos_from_global(x, op.origin)
        rr = lev.down_block(*dh, op.origin)
        check("k_down_block @ (4,2)", (rr,), (lev.down_plain(*dh, op.origin),), ("exact",))
        uh = lev.up_halos_from_global(x, ecl, op.origin)
        got = lev.up_block(*uh, op.origin, with_dot=True)
        ref = lev.up_plain(*uh, op.origin, with_dot=True)
        bm = torch.where(lev.spec(op.origin).build("cuda"), uh[0], 0.0)
        check("k_up_block @ (4,2)", got, ref, ("exact", "sum"),
              {1: float((bm * ref[0]).abs().double().sum())})
        parts["stencil_block"].append(y)
        parts["k_down_block"].append(rr)
        parts["k_up_block"].append(got[0])
        del h, dh, uh, got, ref, bm
    blk = ops[0].block_shape
    lay = PaddedStencilOperator(N, N, ops[0].coeffs, dom.grid_shape, (hp, wp), by, "gamma")
    _stitched_agree("D1 vs A1 @ 8192^2 (4,2)", _stitch(meshes, parts["stencil_block"]), lay(x), blk)
    # D3's stitch through the lane restriction and child mask the mesh runs
    # between its legs (mg_sharded.py's _vc) against A5's coarse field, on
    # the rows and columns both layouts have (zero beyond the child grid)
    rc = lane_restrict(_stitch(meshes, parts["k_down_block"]), N, levs[0].cw_pad)
    rc = torch.where(MaskSpec("gamma", N // 2, N // 2, tuple(rc.shape)).build("cuda"), rc, 0.0)
    down = single.down(x)
    rows, cols = min(rc.shape[0], down.shape[0]), min(rc.shape[1], down.shape[1])
    if rc[rows:].any() or rc[:, cols:].any() or down[rows:].any() or down[:, cols:].any():
        raise AssertionError("D3 vs A5: a coarse value beyond the child grid")
    _stitched_agree("D3 + lanes vs A5 @ 8192^2 (4,2)", rc[:rows, :cols].contiguous(),
                    down[:rows, :cols].contiguous(), (blk[0] // 2, blk[1] // 2), exact=True)
    _stitched_agree("D4 vs A6 @ 8192^2 (4,2)", _stitch(meshes, parts["k_up_block"]),
                    single.up(x, ec), blk, exact=True)
    del parts, x, ec, ecl, single, lay, rc, down
    torch.cuda.empty_cache()

    box = Domain3D(N3, N3, N3)
    meshes3 = _virtual((2, 1, 2))
    ops3 = [ShardedPallas3DStencilOperator.from_domain(box, m) for m in meshes3]
    x3 = torch.randn(ops3[0].padded_shape, device="cuda", generator=gen)
    parts3 = []
    for op in ops3:
        h = op.halos_from_global(x3, op.origin)
        parts3.append(op.apply_block(*h))
        check("stencil3d_block @ (2,1,2)", (parts3[-1],),
              (block_stencil3d_plain(*h, op.block_spec(), op.coeffs),), ("exact",))
        del h
        torch.cuda.empty_cache()
    s7 = Padded3DStencilOperator.from_domain(box)
    d, h3, w3 = s7.padded_shape
    _stitched_agree("D2 vs S7 @ 512^3 (2,1,2)", _stitch(meshes3, parts3)[:d, :h3, :w3],
                    s7(x3[:d, :h3, :w3].contiguous()), ops3[0].block_shape, exact=True)
    del parts3, x3
    torch.cuda.empty_cache()

    # timings on the 1x1 block: the whole canvas, self-halos
    one = make_solver_mesh(1)
    out = {}
    op1 = ShardedPallasStencilOperator.from_domain(dom, one)
    lev1 = ShardedFusedMultigrid.from_operator(op1, dom, device="cuda").levels[0]
    org = (0, 0)
    xb = torch.randn(op1.padded_shape, device="cuda", generator=gen)
    ecb = torch.randn((op1.padded_shape[0] // 2, op1.padded_shape[1]), device="cuda",
                      generator=gen)
    h1 = op1.halos_from_global(xb, org)
    dh1 = lev1.down_halos_from_global(xb, org)
    uh1 = lev1.up_halos_from_global(xb, ecb, org)
    spec = op1.block_spec()
    nodes = op1.padded_shape[0] * op1.padded_shape[1]
    cases = {
        "stencil_block": (lambda: (op1.apply_block(*h1),),
                          lambda: (block_stencil_plain(*h1, spec, op1.coeffs),), ("field",), h1),
        "k_down_block": (lambda: (lev1.down_block(*dh1, org),),
                         lambda: (lev1.down_plain(*dh1, org),), ("exact",), dh1),
        "k_up_block": (lambda: lev1.up_block(*uh1, org, with_dot=True),
                       lambda: lev1.up_plain(*uh1, org, with_dot=True), ("exact", "sum"), uh1),
    }
    for name, (kern, plain, kinds, ins) in cases.items():
        got, ref = kern(), plain()
        sc = None
        if name == "k_up_block":
            bm = torch.where(spec.build("cuda"), uh1[0], 0.0)
            sc = {1: float((bm * ref[0]).abs().double().sum())}
        err, tol = check(f"{name} @ 8192^2 1x1", got, ref, kinds, sc)
        rec = {"max_abs_err": worst[name], "bytes": nbytes(ins) + nbytes(got), "nodes": nodes,
               "library_ms": None, **kernel_times(kern, plain, 5)}
        line = (f"kernel {name:17s} @ 8192^2 1x1: max_abs_err {err:.3e} tol {tol:.3e}  "
                f"kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms")
        if name == "stencil_block":
            cd, cx, cy = op1.coeffs
            wt = torch.tensor([[0.0, cy, 0.0], [cx, cd, cx], [0.0, cy, 0.0]],
                              device="cuda").view(1, 1, 3, 3)
            xin = xb.view(1, 1, *xb.shape)
            rec["library_ms"] = device_ms(lambda: F.conv2d(xin, wt, padding=1))
            line += f"  conv2d {rec['library_ms']:.4f} ms"
        log(line)
        out[name] = rec
        del got, ref
    del xb, ecb, h1, dh1, uh1
    torch.cuda.empty_cache()
    op31 = ShardedPallas3DStencilOperator.from_domain(box, one)
    x31 = torch.randn(op31.padded_shape, device="cuda", generator=gen)
    h31 = op31.halos_from_global(x31, (0, 0, 0))
    spec3 = op31.block_spec()
    kern = lambda: (op31.apply_block(*h31),)  # noqa: E731
    plain = lambda: (block_stencil3d_plain(*h31, spec3, op31.coeffs),)  # noqa: E731
    got = kern()
    err, tol = check("stencil3d_block @ 512^3 1x1", got, plain(), ("exact",))
    n_in = int(spec3.build("cuda").sum())
    rec = {"max_abs_err": worst["stencil3d_block"], "nodes": n_in,
           # interior reads (the mask is algebraic), whole-canvas write, halos
           "bytes": 4 * n_in + nbytes(got) + nbytes(h31[1:]),
           **kernel_times(kern, plain, 3)}
    cd, cx, cy, cz = op31.coeffs
    wt = torch.zeros((1, 1, 3, 3, 3), device="cuda")
    wt[0, 0, 1, 1] = torch.tensor([cx, cd, cx])
    wt[0, 0, 1, 0, 1] = wt[0, 0, 1, 2, 1] = cy
    wt[0, 0, 0, 1, 1] = wt[0, 0, 2, 1, 1] = cz
    xin = x31.view(1, 1, *x31.shape)
    rec["library_ms"] = device_ms(lambda: F.conv3d(xin, wt, padding=1))
    log(f"kernel stencil3d_block   @ 512^3 1x1: max_abs_err {err:.3e} tol {tol:.3e}  kernel "
        f"{rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms  conv3d {rec['library_ms']:.4f} ms")
    out["stencil3d_block"] = rec
    del x31, h31, got, xin
    torch.cuda.empty_cache()
    return out


def _d2_parts(box, split, x):
    """D2 on every block of ``split`` of ``box``, each block's halos cut
    from the global field ``x`` as the ring exchange delivers them, each
    bit-equal to its plain version; returns the stitched field, cropped to
    S7's canvas, and S7's apply there."""
    import torch

    from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
    from iterative_solvers_tpu_torch.parallel import ShardedPallas3DStencilOperator
    from iterative_solvers_tpu_torch.parallel.halo_pallas import block_stencil3d_plain

    meshes = _virtual(split)
    parts = []
    for m in meshes:
        op = ShardedPallas3DStencilOperator.from_domain(box, m)
        h = op.halos_from_global(x, op.origin)
        parts.append(op.apply_block(*h))
        ref = block_stencil3d_plain(*h, op.block_spec(), op.coeffs)
        torch.cuda.synchronize()
        if not torch.equal(parts[-1], ref):
            raise AssertionError(f"D2 block {m.coords} of {split} differs from its plain version")
        del h, ref
    s7 = Padded3DStencilOperator.from_domain(box)
    d, h3, w3 = s7.padded_shape
    return _stitch(meshes, parts)[:d, :h3, :w3], s7(x[:d, :h3, :w3].contiguous())


def _ff_cases(dims, gen):
    """R3's two coefficient sets on the box ``dims`` (the box's own, and one
    with the delta term and a y coefficient that is not a power of two),
    each with its inputs: {label: (layout, xh, xl, bh, bl)}."""
    import dataclasses

    import torch

    from iterative_solvers_tpu_torch import Domain3D
    from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
    from iterative_solvers_tpu_torch.ops.ddf32 import split_f64

    lay = Padded3DStencilOperator.from_domain(Domain3D(*dims))
    cd, cx, cy, cz = lay.coeffs
    mask = lay.mask_spec.build("cuda")
    f64 = dict(device="cuda", dtype=torch.float64, generator=gen)
    bh, bl = split_f64(torch.where(mask, torch.randn(lay.padded_shape, **f64), 0.0) * 1e4)
    xh, xl = split_f64(torch.randn(lay.padded_shape, **f64))  # unmasked: R3 masks its reads
    return {"box": (lay, xh, xl, bh, bl),
            "delta": (dataclasses.replace(lay, coeffs=(cd - 0.37, cx, cy * 1.1, cz)),
                      xh, xl, bh, bl)}


def check_zstream(gen, dims, timed, j3_kind="exact"):
    """The staged z-march's kernels on the box ``dims``: D2 on the 1x1 block
    and on the splits (1, 1, 2), (2, 1, 1) and (2, 1, 2), each block
    bit-equal to its plain version and the stitched blocks to S7 at every
    node; R3 with the box's coefficients (powers of two but at 16 x 24 x 8,
    no delta term) and with a delta term and a y coefficient that is not a
    power of two, both words bit-equal to its plain version; S7 on the box's
    layout and J3 on every fused level's (the solver's hierarchy at 512³),
    S7 bit-equal to its plain version and J3 held to ``j3_kind`` (``compare``;
    bit-equal on this checkout). ``timed``: D2 on the 1x1 block, R3, S7 and
    J3 on level 0 on the device timer and as one call, each beside its
    bound. Returns {name: record}."""
    import torch

    from iterative_solvers_tpu_torch import Domain3D
    from iterative_solvers_tpu_torch.kernels import resid_ff
    from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
    from iterative_solvers_tpu_torch.ops.ddf32 import coeff_delta, is_pow2
    from iterative_solvers_tpu_torch.parallel import (
        ShardedPallas3DStencilOperator,
        make_solver_mesh,
    )
    from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner, _FusedLevel3D

    label = "x".join(map(str, dims))
    box = Domain3D(*dims)
    out = {}
    x = torch.randn(ShardedPallas3DStencilOperator.from_domain(
        box, _virtual((2, 1, 2))[0]).padded_shape, device="cuda", generator=gen)
    for split in ((1, 1, 1), (1, 1, 2), (2, 1, 1), (2, 1, 2)):
        op = ShardedPallas3DStencilOperator.from_domain(box, _virtual(split)[0])
        # every split's canvas is within the (2, 1, 2) split's
        xs = x[tuple(slice(0, n) for n in op.padded_shape)].contiguous()
        got, ref = _d2_parts(box, split, xs)
        diff = int((got != ref).sum())
        log(f"zstream D2 {label} {split}: blocks bit-equal to plain; stitched vs S7: {diff} "
            f"nodes differ")
        if diff:
            raise AssertionError(f"stitched D2 {label} {split} differs from S7")
        del got, ref, xs
    del x
    torch.cuda.empty_cache()
    if timed:
        op = ShardedPallas3DStencilOperator.from_domain(box, make_solver_mesh(1))
        xb = torch.randn(op.padded_shape, device="cuda", generator=gen)
        h = op.halos_from_global(xb, (0, 0, 0))
        n_in = int(op.block_spec().build("cuda").sum())
        y = op.apply_block(*h)
        nb = 4 * n_in + nbytes((y,)) + nbytes(h[1:])
        out["stencil3d_block"] = {"ms": device_ms(lambda: op.apply_block(*h)),
                                  "one_call_ms": one_call_ms(lambda: op.apply_block(*h)),
                                  "bound_ms": nb / HBM_BYTES_PER_S * 1e3, "bytes": nb,
                                  "nodes": n_in, "shape": op.block_shape}
        del xb, h, y
        torch.cuda.empty_cache()
    for name, (lay, xh, xl, bh, bl) in _ff_cases(dims, gen).items():
        gh, gl = resid_ff.resid_ff(xh, xl, bh, bl, lay)
        rh, rl = resid_ff.resid_ff_plain(xh, xl, bh, bl, lay)
        torch.cuda.synchronize()
        err = max(float((gh.double() - rh.double()).abs().max()),
                  float((gl.double() - rl.double()).abs().max()))
        flags = (f"has_delta {int(coeff_delta(lay.coeffs) != 0.0)} pow2 "
                 f"{[int(is_pow2(c)) for c in lay.coeffs[1:]]}")
        log(f"zstream R3 {label} {name} ({flags}): max_abs_err {err:.3e} (rh, rl)")
        if err != 0.0:
            raise AssertionError(f"R3 {label} {name} differs from its plain version")
        del rh, rl
        if timed:
            n_in = int(lay.mask_spec.build("cuda").sum())
            nb = 4 * 4 * n_in + nbytes((gh, gl))
            out[f"k_resid_ff3d {name}"] = {
                "ms": device_ms(lambda: resid_ff.resid_ff(xh, xl, bh, bl, lay)),
                "one_call_ms": one_call_ms(lambda: resid_ff.resid_ff(xh, xl, bh, bl, lay)),
                "bound_ms": nb / HBM_BYTES_PER_S * 1e3, "bytes": nb, "nodes": n_in,
                "shape": lay.padded_shape, "max_abs_err": err}
        del gh, gl
    torch.cuda.empty_cache()
    # S7 on the box's layout, J3 on every fused level's; each reads x (and
    # J3 b) at interior nodes and writes its whole canvas
    s7 = Padded3DStencilOperator.from_domain(box)
    M = MultigridPreconditioner.from_domain(box, fuse=True, device="cuda",
                                            fuse_min_extent=512 if dims[0] >= N3 else 16)
    fused = [lev.kernels for lev in M.levels if isinstance(lev, _FusedLevel3D)]
    if fused[0].padded_shape != s7.padded_shape:
        raise AssertionError(f"{label}: J3's layout {fused[0].padded_shape} != S7's")
    xs = torch.randn(s7.padded_shape, device="cuda", generator=gen)
    cases = [("stencil3d", s7.padded_shape, s7.mask_spec, 1, "exact",
              lambda: (s7(xs),), lambda: (s7.apply_plain(xs),))]
    for i, k in enumerate(fused):
        xj, bj = (torch.randn(k.padded_shape, device="cuda", generator=gen) for _ in range(2))
        cases.append((f"k_jacobi3d level {i}", k.padded_shape, k.mask_spec, 2, j3_kind,
                      lambda k=k, xj=xj, bj=bj: (k.jacobi(xj, bj),),
                      lambda k=k, xj=xj, bj=bj: (k.jacobi_plain(xj, bj),)))
    for name, shape, spec, reads, kind, kern, plain in cases:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err, tol = compare(f"{name} @ {label}", got, ref, (kind,))
        diff = int((got[0] != ref[0]).sum())
        log(f"zstream {name} {label} {shape}: max_abs_err {err:.3e} tol {tol:.3e} "
            f"({diff} nodes differ)")
        if timed and name in ("stencil3d", "k_jacobi3d level 0"):
            n_in = int(spec.build("cuda").sum())
            nb = 4 * reads * n_in + nbytes(got)
            out[name.removesuffix(" level 0")] = {
                "ms": device_ms(kern), "one_call_ms": one_call_ms(kern),
                "bound_ms": nb / HBM_BYTES_PER_S * 1e3, "bytes": nb, "nodes": n_in,
                "shape": shape, "max_abs_err": err}
        del got, ref
    del cases, xs, M, fused
    torch.cuda.empty_cache()
    if timed:
        for name, r in out.items():
            log(f"zstream time {name} @ {label}: {r['ms']:.4f} ms (one call "
                f"{r['one_call_ms']:.4f}), bound {r['bound_ms']:.4f} "
                f"({100 * r['bound_ms'] / r['ms']:.0f} %)")
    return out


def zstream_only(gen, j3_kind) -> int:
    """``--zstream DIR``: :func:`check_zstream` for the port in DIR at 16³,
    32³ and 16 × 24 × 8, then at 512³ timed, then one JSON line."""
    for dims in ((16, 16, 16), (32, 32, 32), (16, 24, 8)):
        check_zstream(gen, dims, timed=False, j3_kind=j3_kind)
    out = check_zstream(gen, (N3, N3, N3), timed=True, j3_kind=j3_kind)
    log(json.dumps({"zstream": {k: {kk: vv for kk, vv in r.items() if kk != "bytes"}
                                for k, r in out.items()}}))
    return 0


def _check_engine_partition(n, shape, gen, check, dot_scale, beta, scal):
    """D5 and D6 (MSG and PCG, each with and without u) on a virtual
    ``shape`` partition of the n² Г grid: each block's halos cut from the
    global fields as the engine's exchange delivers them, each launch
    against its plain version (through ``check``), the stitched side rows,
    x', r' and z_k against K1, K2 and K2-pcg on the whole canvas bit for
    bit at every node (edges included), the summed partials within f32
    round-off of the sum."""
    import torch

    from iterative_solvers_tpu_torch import Domain2D
    from iterative_solvers_tpu_torch.kernels import cg_fused
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.parallel import ShardedPallasStencilOperator
    from iterative_solvers_tpu_torch.parallel import cg_fused_sharded as S

    dom = Domain2D(nx=n, ny=n)
    meshes = _virtual(shape)
    ops = [ShardedPallasStencilOperator.from_domain(dom, m) for m in meshes]
    (hp, wp), by = ops[0].padded_shape, ops[0].block_rows
    lay = PaddedStencilOperator(n, n, ops[0].coeffs, dom.grid_shape, (hp, wp), by, "gamma")
    mask = lay.mask_spec.build("cuda")
    x, r, z, w, u = (torch.where(mask, torch.randn((hp, wp), device="cuda", generator=gen), 0.0)
                     for _ in range(5))
    at = f"{n}^2 {shape}"

    def cut(f, op):
        (h, wd), (r0, c0) = op.block_shape, op.origin
        return f[r0:r0 + h, c0:c0 + wd].contiguous()

    for pcg in (False, True):
        d = w if pcg else r
        side_ref, *parts_ref = cg_fused.k1(d, z, beta, lay)
        blocks = {"side": [], "rz": [], "azz": [], "zmax": []}
        k2_name = "k2_pcg_block" if pcg else "k2_block"
        k2_outs = {False: [], True: []}
        for op in ops:
            db, zb, up, dn, left, right = S.halos_from_global(op, d, z)
            got = S.k1_block(db, zb, beta, up, dn, left, right, op)
            ref = S.k1_block_plain(db, zb, beta, up, dn, left, right, op)
            check(f"k1_block @ {at}", got, ref, ("field", "sum", "sum", "max"),
                  dot_scale(db, zb, beta))
            for key, t in zip(blocks, got):
                blocks[key].append(t)
            side = got[0]
            for with_u in (False, True):
                ub = cut(u, op) if with_u else None
                xb, rb, zpb = cut(x, op), cut(r, op), cut(z, op)
                if pcg:
                    wb_ = cut(w, op)
                    got2 = S.k2_pcg_block(xb, rb, zpb, wb_, side, left, right, scal, op, ub)
                    ref2 = S.k2_pcg_block_plain(xb, rb, zpb, wb_, side, left, right, scal, op, ub)
                else:
                    got2 = S.k2_block(xb, rb, zpb, side, left, right, scal, op, ub)
                    ref2 = S.k2_block_plain(xb, rb, zpb, side, left, right, scal, op, ub)
                kinds = ("field", "field", "field", "sum", "max") + (("max",) if with_u else ())
                check(f"{k2_name}{'+u' if with_u else ''} @ {at}", got2, ref2, kinds)
                k2_outs[with_u].append(got2)
            del db, zb, up, dn, left, right, got
        # stitched against the single-device kernels on the whole canvas
        side_st = _stitch(meshes, blocks["side"])
        if not torch.equal(side_st, side_ref):
            raise AssertionError(f"stitched D5 side rows differ from K1 @ {at} (pcg={pcg})")
        for key, ref_p, kind in zip(("rz", "azz", "zmax"), parts_ref, ("sum", "sum", "max")):
            got_p = torch.stack([p.double().sum() if kind == "sum" else p.double().max()
                                 for p in blocks[key]])
            compare(f"stitched D5 {key} vs K1 @ {at}", (got_p,), (ref_p,), (kind,),
                    {0: dot_scale(d, z, beta)[1]} if key == "rz" else None)
        single = (lambda uu: cg_fused.k2_pcg(x, r, z, w, side_ref, scal, lay, u=uu)) if pcg else (
            lambda uu: cg_fused.k2(x, r, z, side_ref, scal, lay, u=uu))
        for with_u in (False, True):
            ref_all = single(u if with_u else None)
            for i, what in enumerate(("x'", "r'", "z_k")):
                st = _stitch(meshes, [o[i] for o in k2_outs[with_u]])
                if not torch.equal(st, ref_all[i]):
                    n_diff = int((st != ref_all[i]).sum())
                    raise AssertionError(f"stitched {k2_name} {what} differs from the "
                                         f"single-device kernel at {n_diff} nodes @ {at} "
                                         f"(u={with_u})")
            for i, kind in ((3, "sum"), (4, "max")) + (((5, "max"),) if with_u else ()):
                red = [o[i].double().sum() if kind == "sum" else o[i].double().max()
                       for o in k2_outs[with_u]]
                got_p = torch.stack(red)
                compare(f"stitched {k2_name} partial {i} @ {at}", (got_p,), (ref_all[i],),
                        (kind,),
                        {0: float((ref_all[1].double() ** 2).sum())} if kind == "sum" else None)
            del ref_all
        log(f"stitched D5 + {'D6-pcg' if pcg else 'D6'} vs K1 + {'K2-pcg' if pcg else 'K2'} @ "
            f"{at}: side rows, x', r', z_k bit-equal at every node (with and without u); "
            f"summed partials within f32 round-off")
        del blocks, k2_outs, side_ref, parts_ref
        torch.cuda.empty_cache()
    del x, r, z, w, u
    torch.cuda.empty_cache()


def check_engine_kernels(gen):
    """D5 and D6 against their plain versions and, stitched, against K1, K2
    and K2-pcg (``_check_engine_partition``) on the (4, 2) partition of
    8192², the 1x1 block of 1024² (the layout of path "mesh fused B"'s live
    run) and the (2, 2) partition of 2048² (the 4-rank world's). Then each
    timed on the 1x1 block of 8192² (path "mesh engine"'s layout, which is
    K1's and K2's there) and of 1024² ("mesh fused B"'s), beside K1, K2 and
    K2-pcg (:func:`_time_engine_1x1`). Returns ({name: stats} at 8192²,
    the same at 1024²)."""
    ctx = _engine_checks()
    for n, shape in ((N, (4, 2)), (NB, (1, 1)), (MESH_N, (2, 2))):
        _check_engine_partition(n, shape, gen, *ctx[:4])
    out = _time_engine_1x1(N, gen, *ctx)
    out_nb = _time_engine_1x1(NB, gen, *ctx, short=True)
    return out, out_nb


def _engine_checks():
    """(check, dot_scale, beta, scal, worst) of the D5/D6 checks: ``check``
    compares a launch with its plain version (:func:`compare`) and keeps
    each kernel's worst field error in ``worst``; ``dot_scale`` the sum of
    |terms| of (d, z_k); β and [α, β] as the engine passes them."""
    import torch

    worst = dict.fromkeys(("k1_block", "k2_block", "k2_pcg_block"), 0.0)

    def check(name, got, ref, kinds, scales=None):
        torch.cuda.synchronize()
        err, tol = compare(name, got, ref, kinds, scales)
        key = name.split(" ")[0].removesuffix("+u")
        worst[key] = max(worst[key], err)
        return err, tol

    def dot_scale(d, z, beta):
        return {1: float((d * (d + beta * z)).abs().double().sum())}

    beta = torch.tensor(0.37, device="cuda")
    scal = torch.tensor([-1.3e-4, 0.37], device="cuda")
    return check, dot_scale, beta, scal, worst


def _time_engine_1x1(n, gen, check, dot_scale, beta, scal, worst, short=False):
    """D5, D6 and D6-pcg on the 1x1 block of the n² Г grid (the whole
    canvas, self-halos), each against its plain version and timed beside
    K1, K2 and K2-pcg on the block's layout (``short``: also on the graph
    timer, :func:`graph_ms`). Returns {name: stats}."""
    import torch

    from iterative_solvers_tpu_torch import Domain2D
    from iterative_solvers_tpu_torch.kernels import cg_fused
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.parallel import ShardedPallasStencilOperator, make_solver_mesh
    from iterative_solvers_tpu_torch.parallel import cg_fused_sharded as S

    dom = Domain2D(nx=n, ny=n)
    op1 = ShardedPallasStencilOperator.from_domain(dom, make_solver_mesh(1))
    # K1 / K2 on the block's layout (at 8192² the single-device one; at
    # 1024² the mesh's 1152 x 1152 canvas of 128-row bands, not path B's)
    lay1 = PaddedStencilOperator(n, n, op1.coeffs, dom.grid_shape, op1.padded_shape,
                                 op1.block_rows, "gamma")
    mask = lay1.mask_spec.build("cuda")
    x, r, z, w, u = (torch.where(mask, torch.randn(lay1.padded_shape, device="cuda",
                                                   generator=gen), 0.0) for _ in range(5))
    hr = S.halos_from_global(op1, r, z)
    hw = S.halos_from_global(op1, w, z)
    side_r = S.k1_block(*hr[:2], beta, *hr[2:], op1)[0]
    side_w = S.k1_block(*hw[:2], beta, *hw[2:], op1)[0]
    single_side_r = cg_fused.k1(r, z, beta, lay1)[0]
    single_side_w = cg_fused.k1(w, z, beta, lay1)[0]
    nodes = op1.padded_shape[0] * op1.padded_shape[1]
    cases = {
        "k1_block": (lambda: S.k1_block(*hr[:2], beta, *hr[2:], op1),
                     lambda: S.k1_block_plain(*hr[:2], beta, *hr[2:], op1),
                     ("field", "sum", "sum", "max"), hr, dot_scale(r, z, beta),
                     "k1", lambda: cg_fused.k1(r, z, beta, lay1)),
        "k2_block": (lambda: S.k2_block(x, r, z, side_r, *hr[4:], scal, op1),
                     lambda: S.k2_block_plain(x, r, z, side_r, *hr[4:], scal, op1),
                     ("field", "field", "field", "sum", "max"), (x, r, z, side_r) + hr[4:], None,
                     "k2", lambda: cg_fused.k2(x, r, z, single_side_r, scal, lay1)),
        "k2_pcg_block": (lambda: S.k2_pcg_block(x, r, z, w, side_w, *hw[4:], scal, op1),
                         lambda: S.k2_pcg_block_plain(x, r, z, w, side_w, *hw[4:], scal, op1),
                         ("field", "field", "field", "sum", "max"),
                         (x, r, z, w, side_w) + hw[4:], None,
                         "k2_pcg", lambda: cg_fused.k2_pcg(x, r, z, w, single_side_w, scal, lay1)),
    }
    out = {}
    for name, (kern, plain, kinds, ins, sc, single_name, single) in cases.items():
        got, ref = kern(), plain()
        err, tol = check(f"{name} @ {n}^2 1x1", got, ref, kinds, sc)
        rec = {"max_abs_err": worst[name], "bytes": nbytes(ins) + nbytes(got), "nodes": nodes,
               "library_ms": None, "shape": list(op1.padded_shape),
               **kernel_times(kern, plain, 5), "single_ms": device_ms(single)}
        line = (f"kernel {name:17s} @ {n}^2 1x1: max_abs_err {err:.3e} tol {tol:.3e}  kernel "
                f"{rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms  ({single_name} in this "
                f"call {rec['single_ms']:.4f} ms)")
        if short:
            rec["graph_ms"] = graph_ms(kern, reps=5, calls=GRAPH_CALLS)
            rec["single_graph_ms"] = graph_ms(single, reps=5, calls=GRAPH_CALLS)
            line += (f"  graph {rec['graph_ms']:.4f} ms ({single_name} "
                     f"{rec['single_graph_ms']:.4f})  one call {rec['one_call_ms']:.4f} ms  "
                     f"bound {rec['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms")
        log(line)
        out[name] = rec
        del got, ref
    del x, r, z, w, u, hr, hw
    torch.cuda.empty_cache()
    return out


def _fast_path_parts(n, mesh, device="cuda"):
    """The sharded fast path's parts at n² on ``mesh``: the D1 operator, the
    shard-fused V-cycle with its FMG payload, the f64 halo twin, this
    rank's block of b."""
    import torch

    from iterative_solvers_tpu_torch import DirichletSolver, Domain2D, PoissonProblem
    from iterative_solvers_tpu_torch.parallel import ShardedPallasStencilOperator
    from iterative_solvers_tpu_torch.parallel.mg_sharded import ShardedFusedMultigrid

    dom = Domain2D(nx=n, ny=n)
    prob = PoissonProblem.manufactured(dom)
    pop = ShardedPallasStencilOperator.from_domain(dom, mesh)
    M = ShardedFusedMultigrid.from_operator(pop, dom, device=device).with_fmg(prob)
    b = pop.shard(prob.rhs_field(torch.float64, device))
    return pop, M, DirichletSolver._hi_operator(pop), b


def _fast_path_true_rel(pop, x_global):
    import torch

    from iterative_solvers_tpu_torch import Domain2D, PoissonProblem
    from iterative_solvers_tpu_torch.ops.stencil import StencilOperator

    dom = Domain2D(nx=pop.nx, ny=pop.ny)
    b = PoissonProblem.manufactured(dom).rhs_field(device=x_global.device)
    x = pop.crop(x_global)
    return float(torch.linalg.norm(b - StencilOperator.from_domain(dom)(x)) / torch.linalg.norm(b))


def sharded_fast_path(path_a):
    """Path (a), the JAX package's sharded fast path, at 8192² on a 1x1
    mesh: ``device_refined_solve`` with the f64 halo twin outside and D1 +
    the shard-fused V-cycle (D3, D4) with the FMG warm start inside, to
    true rel < 1e-6; a warm run, then one with the counts reset."""
    import torch

    from iterative_solvers_tpu_torch.kernels import _build
    from iterative_solvers_tpu_torch.parallel import make_solver_mesh
    from iterative_solvers_tpu_torch.solvers.refine import device_refined_solve

    rel6 = stop_rel6()
    pop, M, A_hi, b = _fast_path_parts(N, make_solver_mesh(1))
    log(f"mesh a {N}^2 1x1: {len(M.levels)} shard-fused levels, layout {pop.padded_shape}")

    def run():
        return device_refined_solve(A_hi, pop, b, preconditioner=M, stop=rel6, fmg=True)

    run()
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_build.launches), dict(_build.plain_on_cuda)
    log(f"path mesh a launches {launches} plain_on_cuda {plain}")
    missing = [k for k in PATH_KERNELS["mesh a"] if launches.get(k, 0) <= 0]
    if missing or plain:
        raise AssertionError(f"mesh a: kernels not launched {missing}; plain on CUDA {plain}")
    rel = _fast_path_true_rel(pop, res.x)
    log(f"mesh a {N}^2 1x1 sharded fast path: converged {res.converged} reason "
        f"{res.reason.name} outer "
        f"{res.outer_iterations} inner {res.iterations} true_rel {rel:.3e} refine "
        f"{res.elapsed_s:.4f} s wall {wall:.3f} s (path A single-device: outer {path_a[0]} "
        f"inner {path_a[1]})")
    if not (res.converged and rel < 1e-6):
        raise AssertionError(f"mesh a failed: converged={res.converged} rel={rel:.3e}")
    counts = (int(res.reason), res.outer_iterations, res.iterations)
    del pop, M, A_hi, b, res
    torch.cuda.empty_cache()
    return launches, counts


def mesh_engine_path(path_a_f64, fast_path):
    """Path "mesh engine": path A's problem at 8192² through the facade on a
    1x1 mesh, ``operator="pallas"`` + ``"mg"`` + ``"mixed"`` with no
    callback: ``engine_refined_solve`` on the sharded fused engine (D5,
    D6-pcg) and the shard-fused V-cycle (D3, D4) with its FMG warm start,
    f64 outer, to true rel < 1e-6. The 1x1 block layout is path A's
    (8256 x 8320, 64-row bands), so its counts are held against path A's
    f64 outer and logged beside the sharded fast path's."""
    import torch

    from iterative_solvers_tpu_torch import DirichletSolver
    from iterative_solvers_tpu_torch.parallel import make_solver_mesh

    solver = DirichletSolver(nx=N, ny=N, operator="pallas", preconditioner="mg",
                             precision="mixed", mesh=make_solver_mesh(1), device="cuda",
                             stop=stop_rel6())
    res, wall, launches = timed_solve(solver, "mesh engine")
    rel = true_rel(solver, res)
    counts = (int(res.stop_reason), res.outer_iterations, res.iterations)
    log(f"mesh engine {N}^2 1x1 (pallas, mg, mixed; engine ladder): converged {res.converged} "
        f"reason {res.stop_reason.name} outer {res.outer_iterations} inner {res.iterations} "
        f"true_rel {rel:.3e} refine {res.elapsed_s:.4f} s wall {wall:.3f} s; (reason, outer, "
        f"inner) {counts} vs path A f64 outer {path_a_f64}, sharded fast path {fast_path}")
    if not (res.converged and res.stop_reason.name == "RELATIVE_RESIDUAL" and rel < 1e-6):
        raise AssertionError(f"mesh engine failed: converged={res.converged} rel={rel:.3e}")
    if counts[:2] != tuple(path_a_f64)[:2]:
        raise AssertionError(f"mesh engine: (reason, outer) {counts[:2]} differ from path A's "
                             f"f64 outer {tuple(path_a_f64)[:2]}")
    _count_gap("mesh engine: inners vs path A's f64 outer", counts[2], path_a_f64[2],
               "path A preconditions with the single-device fused V-cycle, the engine with "
               "the shard-fused V-cycle (D3, D4), whose f32 values may differ in the last bit")
    del solver, res
    torch.cuda.empty_cache()
    return launches


def mesh_fused_b(path_b_iterations, nb=NB):
    """Path "mesh fused B": ``operator="fused"`` with a 1x1 mesh, the sharded
    fused engine's MSG CG (D5, D6): its ms/iteration at 8192² beside K1 +
    K2's, and a live run at nb² to rel 1e-6 beside path B's count."""
    import torch

    from iterative_solvers_tpu_torch import DirichletSolver, Domain2D
    from iterative_solvers_tpu_torch.parallel import make_solver_mesh

    dom = Domain2D(nx=N, ny=N)
    single, sharded = (plain_cg_ms_per_iter(dom, f"{N}^2 K1 + K2"),
                       plain_cg_ms_per_iter(dom, f"{N}^2 D5 + D6 (1x1 mesh)", mesh=True))
    log(f"mesh fused B {N}^2: D5 + D6 {sharded:.4f} ms/iteration vs K1 + K2 {single:.4f} in "
        f"this call (ratio {sharded / single:.3f})")
    solver = DirichletSolver(nx=nb, ny=nb, operator="fused", mesh=make_solver_mesh(1),
                             device="cuda", stop=stop_rel6())
    res, wall, launches = timed_solve(solver, "mesh fused B", warm=False)
    rel = true_rel(solver, res)
    log(f"mesh fused B {nb}^2 1x1 plain CG: converged {res.converged} reason "
        f"{res.stop_reason.name} iterations {res.iterations} (path B {path_b_iterations}) "
        f"true_rel {rel:.3e} solve {res.elapsed_s:.4f} s wall {wall:.3f} s")
    if not (res.converged and res.stop_reason.name == "RELATIVE_RESIDUAL" and rel < 1e-3):
        raise AssertionError(f"mesh fused B failed: converged={res.converged} rel={rel:.3e}")
    check_count("mesh fused B", res.iterations)
    del solver, res
    torch.cuda.empty_cache()
    return launches


def vcycle_ratio():
    """bench.py's shard mode: the shard-fused V-cycle on a 1x1 mesh against
    the single-device fused V-cycle at 8192², ms each and their ratio."""
    import torch

    from iterative_solvers_tpu_torch import Domain2D
    from iterative_solvers_tpu_torch.parallel import ShardedPallasStencilOperator, make_solver_mesh
    from iterative_solvers_tpu_torch.parallel.mg_sharded import ShardedFusedMultigrid
    from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner

    dom = Domain2D(nx=N, ny=N)
    M1 = MultigridPreconditioner.from_domain(dom, device="cuda")
    a1 = torch.ones(M1.levels[0].kernels.padded_shape, device="cuda")
    op = ShardedPallasStencilOperator.from_domain(dom, make_solver_mesh(1))
    M2 = ShardedFusedMultigrid.from_operator(op, dom, device="cuda")
    a2 = torch.ones(op.padded_shape, device="cuda")
    t1, t2, t2b, t1b = (one_call_ms(lambda: M(a), reps=10)
                        for M, a in ((M1, a1), (M2, a2), (M2, a2), (M1, a1)))
    single, shard = (t1 + t1b) / 2, (t2 + t2b) / 2
    log(f"shard {N}^2: fused V-cycle single-device {single:.3f} ms ({t1:.3f}/{t1b:.3f}), "
        f"shard-fused on a 1x1 mesh ({len(M2.levels)} fused levels) {shard:.3f} ms "
        f"({t2:.3f}/{t2b:.3f}), per-chip ratio {single / shard:.3f}")
    del M1, M2, a1, a2
    torch.cuda.empty_cache()


def _engine_runs():
    """The facade's engine routes run in the 4-rank world and on the 1x1
    mesh: the engine ladder, and the sharded fused engine's MSG CG (to rel
    1e-2: plain CG at 2048² to 1e-6 would take thousands of iterations, each
    with host-staged collectives) and PCG; path -> DirichletSolver kwargs."""
    from iterative_solvers_tpu_torch import StopConfig

    return {
        "mesh engine": dict(operator="pallas", preconditioner="mg", precision="mixed",
                            stop=stop_rel6()),
        "mesh fused B": dict(operator="fused", stop=StopConfig(
            eps_precision=-1, eps_residual=-1, eps_relative=1e-2, max_iterations=5000)),
        "mesh fused mg": dict(operator="fused", preconditioner="mg", stop=StopConfig(
            eps_precision=-1, eps_residual=1e-3, max_iterations=200)),
    }


MESH_BLOCKS_N3 = 128  # the 3D mesh route in the 4-rank world


class _GatherLog:
    """This rank's collectives wrapped (attributes of the mesh object and
    of ``torch.distributed``, in the rank function, nothing in the
    program): the shape and bytes of every field ``mesh.gather``
    assembles, and the bytes this rank receives, in all (each all-gather's
    other blocks, each all-reduce's operand, each point-to-point message)
    and in the shard-fused V-cycle's lane transfers (``mesh.gather_cols``
    where the program has it, ``mesh.fetch`` where it has that), taken per
    phase."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.fields = []
        self.received = dict(all=0, lane=0)
        real = mesh.gather

        def gather(block):
            g = real(block)
            self.fields.append((tuple(g.shape), g.numel() * g.element_size()))
            return g

        mesh.gather = gather
        for name in ("gather_cols", "fetch"):
            lane = getattr(mesh, name, None)
            if lane is not None:
                setattr(mesh, name, self._lane(lane))
        all_gather, all_reduce, rounds = dist.all_gather, dist.all_reduce, dist.batch_isend_irecv

        def nbytes_(t):
            return t.numel() * t.element_size()

        def gathered(parts, t, *a, **kw):
            self.received["all"] += (len(parts) - 1) * nbytes_(t)
            return all_gather(parts, t, *a, **kw)

        def reduced(t, *a, **kw):
            self.received["all"] += nbytes_(t)
            return all_reduce(t, *a, **kw)

        def round_(ops):
            self.received["all"] += sum(nbytes_(o.tensor) for o in ops if o.op is dist.irecv)
            return rounds(ops)

        dist.all_gather, dist.all_reduce, dist.batch_isend_irecv = gathered, reduced, round_

    def _lane(self, fn):
        def lane(*a, **kw):
            before = self.received["all"]
            out = fn(*a, **kw)
            self.received["lane"] += self.received["all"] - before
            return out

        return lane

    def take(self):
        """(fields gathered, bytes, largest field's bytes, bytes received in
        the lane transfers, bytes received in all) since the last take."""
        out, self.fields = self.fields, []
        got, self.received = self.received, dict(all=0, lane=0)
        return (len(out), sum(b for _, b in out), max((b for _, b in out), default=0),
                got["lane"], got["all"])


def _lane_bound(M):
    """The bytes (f32) a rank's lane transfers may receive in one
    application of the shard-fused V-cycle ``M``: two a fused level, each
    window leaving the rank's own columns by at most (cols - 1)
    |2 cwb - wb| + 2 columns of Hb/2 rows."""
    cols = M.mesh.cols
    return sum(2 * 4 * (lev.block_shape[0] // 2)
               * ((cols - 1) * abs(2 * (lev.cw_pad // cols) - lev.block_shape[1]) + 2)
               for lev in M.levels)


def _route(gathers, fn):
    """``fn()`` timed on the host (ending in a synchronize), with this
    rank's peak device memory and the fields it gathered; the launch counts
    set to 0 just before it and read just after."""
    import torch
    import torch.distributed as dist

    from iterative_solvers_tpu_torch.kernels import _build

    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gathers.take()
    _build.reset_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    launches = (dict(_build.launches), dict(_build.plain_on_cuda))
    return res, dict(t=t, peak=torch.cuda.max_memory_allocated(), gathered=gathers.take(),
                     launches=launches)


def _device_ops(fn):
    """(device operations, their summed device ms) of one call of ``fn``:
    the kernels and copies ``torch.profiler`` sees."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(evs), sum(e.time_range.end - e.time_range.start for e in evs) / 1e3


def _block_cycles(mesh, gathers, n, M_fused, b_fused):
    """The preconditioners' applications on this rank's blocks at n²: the
    plain V-cycle (f32, f64) and the stepwise FMG (f32) of
    ``ShardedMultigridPreconditioner`` on the halo stencil's layout, each
    against the single-device plain hierarchy on the whole field on the
    card (bit for bit), and one shard-fused V-cycle (f32); the bytes each
    application gathered, its device operations (a second, profiled
    application), and the threshold's field (what the block path may
    gather: its gathered level's blocks) where the program has it."""
    import dataclasses

    import torch

    from iterative_solvers_tpu_torch import Domain2D, PoissonProblem
    from iterative_solvers_tpu_torch.parallel import crop_field, shard_field
    from iterative_solvers_tpu_torch.solvers.multigrid import ShardedMultigridPreconditioner

    dom = Domain2D(nx=n, ny=n)
    prob = PoissonProblem.manufactured(dom)
    M = ShardedMultigridPreconditioner.from_domain(dom, mesh, device="cuda")
    Mf = dataclasses.replace(M, inner=M.inner.with_fmg(prob))
    gen = torch.Generator(device="cuda").manual_seed(5)
    noise = torch.randn(dom.grid_shape, generator=gen, device="cuda", dtype=torch.float64)
    r = torch.where(dom.interior_on("cuda"), noise, 0.0)
    b = prob.rhs_field(torch.float64, "cuda")
    cases = {"vcycle f32": (M, r.float()), "vcycle f64": (M, r),
             "fmg_stepwise f32": (Mf, b)}
    out = {}
    for name, (P, f) in cases.items():
        call = P if name.startswith("vcycle") else (lambda g: P.fmg_stepwise(g, 1))
        ref = P.inner(f) if name.startswith("vcycle") else P.inner.fmg_stepwise(f, 1)
        z, rec = _route(gathers, lambda: call(shard_field(f, mesh)))
        got = crop_field(mesh.gather(z), dom.grid_shape)
        gathers.take()
        out[name] = dict(t=rec["t"], gathered=rec["gathered"], equal=bool(torch.equal(got, ref)),
                         ops=_device_ops(lambda: call(shard_field(f, mesh))))
    _, rec = _route(gathers, lambda: M_fused(b_fused.float()))
    out["shard-fused vcycle f32"] = dict(t=rec["t"], gathered=rec["gathered"], equal=True,
                                         ops=_device_ops(lambda: M_fused(b_fused.float())),
                                         lane_bound=_lane_bound(M_fused))
    blocks = getattr(M, "blocks", None)  # absent where the program gathers the fine field
    if blocks is not None:
        shape = blocks.gathered_shape
        out["threshold"] = dict(shape=shape, nodes=math.prod(shape), stop=blocks.stop,
                                levels=len(M.inner.levels))
        rem = M_fused._blocks(len(M_fused.levels))
        out["threshold fused"] = dict(shape=rem.gathered_shape,
                                      nodes=math.prod(rem.gathered_shape or (0,)))
    return out


MESH_FUSED_N = 8192  # the shard-fused V-cycle's single application in the 4-rank world


def _shard_fused_big(mesh, gathers, n=MESH_FUSED_N):
    """One shard-fused V-cycle application (f32) at n² on this rank's block
    of seeded noise, after one warm-up application: its host seconds, this
    rank's peak device memory, the bytes it gathered and received; held bit
    for bit against this rank's part of the single-device fused V-cycle on
    the whole field, built with the same levels fused."""
    import torch

    from iterative_solvers_tpu_torch import Domain2D
    from iterative_solvers_tpu_torch.parallel import ShardedPallasStencilOperator
    from iterative_solvers_tpu_torch.parallel.mg_sharded import ShardedFusedMultigrid
    from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner

    dom = Domain2D(nx=n, ny=n)
    gen = torch.Generator().manual_seed(7)  # on the host: the same field on every rank
    r = torch.where(dom.interior_on("cpu"), torch.randn(dom.grid_shape, generator=gen), 0.0)
    pop = ShardedPallasStencilOperator.from_domain(dom, mesh)
    M = ShardedFusedMultigrid.from_operator(pop, dom, device="cuda")
    rb = pop.shard(r).cuda()
    M(rb)
    z, rec = _route(gathers, lambda: M(rb))
    rem = getattr(M, "_blocks", None)  # the remainder's threshold field, where it has one
    shape = rem(len(M.levels)).gathered_shape if rem is not None else None
    out = dict(t=rec["t"], peak=rec["peak"], gathered=rec["gathered"], levels=len(M.levels),
               lane_bound=_lane_bound(M), threshold_nodes=math.prod(shape or (0,)))
    extent = M.levels[-1].ny + 1  # the last shard-fused level's: fuse down to it
    del M, rb
    torch.cuda.empty_cache()
    single = MultigridPreconditioner.from_domain(dom, device="cuda", fuse_min_extent=extent)
    ref = single(r.cuda())
    (r0, c0), (gh, gw) = mesh.block_origin(z.shape), dom.grid_shape
    h, w = max(0, min(z.shape[0], gh - r0)), max(0, min(z.shape[1], gw - c0))
    out["equal"] = bool(torch.equal(z[:h, :w], ref[r0:r0 + h, c0:c0 + w]))
    out["single_levels"] = sum(getattr(lev, "kernels", None) is not None for lev in single.levels)
    del single, ref, z
    torch.cuda.empty_cache()
    return out


def _mesh_rank(rank, n):
    """One rank of the 4-rank world on the one card: the sharded fast path,
    the facade's 'pallas' + 'mg', its engine routes (``_engine_runs``), its
    'stencil' + 'mg' route at n² and its 3D 'pallas' + 'mg' + 'mixed'
    route at ``MESH_BLOCKS_N3``³ on a (2, 2) mesh, each with the launch
    counts set to 0 just before it and read just after, its host seconds,
    this rank's peak device memory and the fields it gathered; the graft
    entry's dry run; the preconditioners' single applications
    (``_block_cycles``)."""
    import torch

    from iterative_solvers_tpu_torch import DirichletSolver, StopConfig
    from iterative_solvers_tpu_torch.parallel import make_solver_mesh
    from iterative_solvers_tpu_torch.solvers.refine import device_refined_solve

    laps = [("start", time.perf_counter())]
    mesh = make_solver_mesh(4, (2, 2))
    gathers = _GatherLog(mesh)
    pop, M, A_hi, b = _fast_path_parts(n, mesh)
    laps.append(("set-up", time.perf_counter()))
    res, fast = _route(gathers, lambda: device_refined_solve(A_hi, pop, b, preconditioner=M,
                                                         stop=stop_rel6(), fmg=True))
    x = pop.crop(mesh.gather(res.x)).cpu().numpy()  # results cross processes as numpy
    stop3 = StopConfig(eps_precision=-1, eps_residual=1e-3, max_iterations=200)
    s = DirichletSolver(nx=n, ny=n, operator="pallas", preconditioner="mg", mesh=mesh,
                        device="cuda", stop=stop3)
    r, facade = _route(gathers, lambda: s.solve(record_history=False))
    out = {"fast": (int(res.reason), res.outer_iterations, res.iterations), "t_fast": fast["t"],
           "facade": (int(r.stop_reason), r.iterations), "t_facade": facade["t"],
           "transport": mesh.transport(b.device),
           "counts": {"mesh a": fast["launches"], "mesh facade": facade["launches"]},
           "routes": {"mesh a": fast, "mesh facade": facade}}
    if rank == 0:
        out["x"], out["solution"] = x, r.solution
    laps.append(("fast path, facade", time.perf_counter()))
    out["engine"] = {}
    for path, kw in _engine_runs().items():
        s = DirichletSolver(nx=n, ny=n, mesh=mesh, device="cuda", **kw)
        r, rec = _route(gathers, lambda: s.solve(record_history=False))
        out["engine"][path] = dict(
            counts=(int(r.stop_reason), r.outer_iterations, r.iterations), t=rec["t"],
            launches=rec["launches"], solution=r.solution if rank == 0 else None)
        out["routes"][path] = rec
    laps.append(("engine routes", time.perf_counter()))
    # the routes whose multigrid is ShardedMultigridPreconditioner
    out["blocks"] = {}
    for path, kw in _block_runs(n).items():
        s = DirichletSolver(mesh=mesh, device="cuda", **kw)
        r, rec = _route(gathers, lambda: s.solve(record_history=False))
        out["blocks"][path] = dict(
            counts=(int(r.stop_reason), r.outer_iterations, r.iterations),
            solution=r.solution if rank == 0 else None)
        out["routes"][path] = rec
    try:
        from iterative_solvers_tpu_torch.graft_entry import dryrun_rank
    except ImportError:  # a checkout from before the graft entry (``--mesh DIR``)
        out["dryrun"] = None
    else:
        dry, rec = _route(gathers, lambda: dryrun_rank(rank, "cuda"))  # on a mesh of its own
        out["dryrun"] = (dry["reason"], dry["iterations"], rec["t"])
    laps.append(("block routes, dry run", time.perf_counter()))
    out["cycles"] = _block_cycles(mesh, gathers, n, M, b)
    del pop, M, A_hi, b, s
    torch.cuda.empty_cache()
    laps.append((f"applications {n}^2", time.perf_counter()))
    out["big"] = _shard_fused_big(mesh, gathers)
    laps.append((f"application {MESH_FUSED_N}^2 and its reference", time.perf_counter()))
    out["laps"] = [(name, t - t0) for (name, t), (_, t0) in zip(laps[1:], laps)]
    return out


def _block_runs(n):
    """The facade's mesh routes whose multigrid runs the plain hierarchy on
    blocks (``ShardedMultigridPreconditioner``): 'stencil' + 'mg' at n²
    (f64 PCG), and the 3D 'pallas' + 'mg' + 'mixed' route (D2, the FMG
    warm start and the f64 outer) at ``MESH_BLOCKS_N3``³; path ->
    DirichletSolver kwargs (no mesh, no device)."""
    from iterative_solvers_tpu_torch import Domain3D, StopConfig

    m = MESH_BLOCKS_N3
    return {
        "mesh stencil mg": dict(nx=n, ny=n, preconditioner="mg", stop=StopConfig(
            eps_precision=-1, eps_residual=1e-3, max_iterations=200)),
        "mesh 3D mg": dict(domain=Domain3D(m, m, m), operator="pallas", preconditioner="mg",
                           precision="mixed", stop=stop_rel6()),
    }


def _count_gap(what, got, want, why):
    """Equal counts pass; a difference of one passes with its reason logged;
    more fails."""
    if got == want:
        return
    if abs(got - want) > 1:
        raise AssertionError(f"{what} {got} vs {want}")
    log(f"{what} {got} vs {want}, within the 1 allowed: {why}")


def four_ranks_one_card(n=MESH_N, exact=True):
    """A (2, 2) gloo world of 4 ranks on the one card (NCCL refuses two
    ranks on one GPU, so the halos and reductions are staged through host
    memory), against the 1x1 mesh and the single-device solves; per rank
    the bytes each preconditioner application gathers, the peak device
    memory and the host seconds of every route (``_mesh_rank``). With
    ``exact`` (this checkout's port) the block multigrid's gathers are held
    to its threshold's field. Returns each path's launches (rank 0)."""
    import numpy as np
    import torch

    from iterative_solvers_tpu_torch import DirichletSolver, Domain2D, StopConfig
    from iterative_solvers_tpu_torch.parallel import make_solver_mesh, run_world
    from iterative_solvers_tpu_torch.solvers.refine import device_refined_solve

    t0 = time.perf_counter()
    ranks = run_world(_mesh_rank, 4, (n,), timeout=420)
    t_world = time.perf_counter() - t0
    r0 = ranks[0]
    pop, M, A_hi, b = _fast_path_parts(n, make_solver_mesh(1))
    one = device_refined_solve(A_hi, pop, b, preconditioner=M, stop=stop_rel6(), fmg=True)
    x1 = pop.crop(one.x).cpu()
    stop3 = StopConfig(eps_precision=-1, eps_residual=1e-3, max_iterations=200)
    f1 = DirichletSolver(nx=n, ny=n, operator="pallas", preconditioner="mg", device="cuda",
                         mesh=make_solver_mesh(1), stop=stop3).solve(record_history=False)
    fs = DirichletSolver(nx=n, ny=n, operator="pallas", preconditioner="mg", device="cuda",
                         stop=stop3).solve(record_history=False)
    xs = DirichletSolver(nx=n, ny=n, preconditioner="mg", precision="mixed", outer="f64",
                         device="cuda", stop=stop_rel6()).solve(record_history=False)
    x4 = torch.from_numpy(r0["x"])
    gap = float((x4 - x1).abs().max() / x1.abs().max())
    sol = torch.from_numpy(xs.solution_field(Domain2D(nx=n, ny=n)))
    gap_s = float((x4.double() - sol).abs().max() / sol.abs().max())
    gap_f = float(np.abs(r0["solution"] - fs.solution).max() / np.abs(fs.solution).max())
    one_t = (int(one.reason), one.outer_iterations, one.iterations)
    log(f"mesh 4 ranks {n}^2 (2,2) on one card, transport {r0['transport']}: world "
        f"{t_world:.1f} s; fast path {r0['fast']} (reason, outer, inner) in {r0['t_fast']:.3f} s "
        f"vs 1x1 {one_t}, x gap to 1x1 {gap:.2e}, to the single-device mixed solve "
        f"{gap_s:.2e}; facade pallas+mg {r0['facade']} in {r0['t_facade']:.3f} s vs 1x1 "
        f"{(int(f1.stop_reason), f1.iterations)} vs single-device "
        f"{(int(fs.stop_reason), fs.iterations)}, solution gap {gap_f:.2e}")
    if any(r["fast"] != r0["fast"] or r["facade"] != r0["facade"] for r in ranks):
        raise AssertionError("the ranks disagree")
    launches = {}
    for path, (counts, plain) in r0["counts"].items():
        log(f"mesh 4 ranks {path} launches (rank 0) {counts} plain_on_cuda {plain}")
        missing = [k for k in PATH_KERNELS[path] if counts.get(k, 0) <= 0]
        if missing or plain:
            raise AssertionError(f"4 ranks {path}: kernels not launched {missing}; "
                                 f"plain on CUDA {plain}")
        launches[f"{path} 4 ranks"] = counts
    if r0["fast"][:2] != one_t[:2] or r0["facade"][0] != int(f1.stop_reason):
        raise AssertionError(f"4 ranks: stop reason or outer count differ from the 1x1 mesh "
                             f"(fast path {r0['fast']} vs {one_t})")
    why = ("each dot's block partials are all-reduced over 4 ranks, so its f32 sum "
           "rounds in another order than on one block")
    _count_gap("mesh 4 ranks: fast path inners vs 1x1", r0["fast"][2], one_t[2], why)
    _count_gap("mesh 4 ranks: facade iterations vs 1x1", r0["facade"][1], f1.iterations, why)
    _count_gap("mesh 4 ranks: facade iterations vs single-device", r0["facade"][1],
               fs.iterations,
               why + "; the single-device solve takes one dot over the whole field")
    if not (gap < 1e-5 and gap_s < 1e-5 and gap_f < 1e-4):
        raise AssertionError(f"4 ranks: solutions differ (gaps {gap:.2e} {gap_s:.2e} {gap_f:.2e})")
    for path, kw in _engine_runs().items():
        got = r0["engine"][path]
        ref = DirichletSolver(nx=n, ny=n, mesh=make_solver_mesh(1), device="cuda",
                              **kw).solve(record_history=False)
        ref_c = (int(ref.stop_reason), ref.outer_iterations, ref.iterations)
        gap_e = float(np.abs(got["solution"] - ref.solution).max() / np.abs(ref.solution).max())
        counts, plain = got["launches"]
        log(f"mesh 4 ranks {path} {n}^2 (2,2): (reason, outer, inner) {got['counts']} in "
            f"{got['t']:.3f} s vs 1x1 {ref_c}, solution gap to 1x1 {gap_e:.2e}; launches "
            f"(rank 0) {counts} plain_on_cuda {plain}")
        if any(rk["engine"][path]["counts"] != got["counts"] for rk in ranks):
            raise AssertionError(f"4 ranks {path}: the ranks disagree")
        missing = [k for k in PATH_KERNELS[path] if counts.get(k, 0) <= 0]
        if missing or plain:
            raise AssertionError(f"4 ranks {path}: kernels not launched {missing}; "
                                 f"plain on CUDA {plain}")
        launches[f"{path} 4 ranks"] = counts
        if got["counts"][:2] != ref_c[:2]:
            raise AssertionError(f"4 ranks {path}: stop reason or outer count differ from the "
                                 f"1x1 mesh ({got['counts']} vs {ref_c})")
        _count_gap(f"mesh 4 ranks: {path} inners vs 1x1", got["counts"][2], ref_c[2], why)
        if not gap_e < 1e-5:
            raise AssertionError(f"4 ranks {path}: solution differs from 1x1 by {gap_e:.2e}")
    del pop, M, A_hi, b, one
    torch.cuda.empty_cache()
    # the routes on ShardedMultigridPreconditioner (its V-cycle and FMG on
    # blocks), against the 1x1 mesh, which runs the whole hierarchy
    for path, kw in _block_runs(n).items():
        got = r0["blocks"][path]
        ref = DirichletSolver(mesh=make_solver_mesh(1), device="cuda", **kw).solve(
            record_history=False)
        ref_c = (int(ref.stop_reason), ref.outer_iterations, ref.iterations)
        gap_b = float(np.abs(got["solution"] - ref.solution).max() / np.abs(ref.solution).max())
        counts, plain = r0["routes"][path]["launches"]
        log(f"mesh 4 ranks {path}: (reason, outer, inner) {got['counts']} in "
            f"{r0['routes'][path]['t']:.3f} s vs 1x1 {ref_c}, solution gap to 1x1 {gap_b:.2e}; "
            f"launches (rank 0) {counts} plain_on_cuda {plain}")
        if any(rk["blocks"][path]["counts"] != got["counts"] for rk in ranks):
            raise AssertionError(f"4 ranks {path}: the ranks disagree")
        missing = [k for k in PATH_KERNELS[path] if counts.get(k, 0) <= 0]
        if missing or plain:
            raise AssertionError(f"4 ranks {path}: kernels not launched {missing}; "
                                 f"plain on CUDA {plain}")
        launches[f"{path} 4 ranks"] = counts
        if got["counts"][:2] != ref_c[:2]:
            raise AssertionError(f"4 ranks {path}: stop reason or outer count differ from the "
                                 f"1x1 mesh ({got['counts']} vs {ref_c})")
        _count_gap(f"mesh 4 ranks: {path} inners vs 1x1", got["counts"][2], ref_c[2], why)
        if not gap_b < 1e-5:
            raise AssertionError(f"4 ranks {path}: solution differs from 1x1 by {gap_b:.2e}")
    if r0["dryrun"] is not None:
        log(f"mesh 4 ranks graft dry run (32^2, ShardedMultigridPreconditioner, cg_solve to 50 "
            f"its): (reason, iterations) {r0['dryrun'][:2]} in {r0['dryrun'][2]:.3f} s")
        if r0["dryrun"][1] <= 0 or any(rk["dryrun"][:2] != r0["dryrun"][:2] for rk in ranks):
            raise AssertionError(f"4 ranks graft dry run: {[rk['dryrun'] for rk in ranks]}")
    elif exact:
        raise AssertionError("4 ranks: the graft entry's dry run did not run")
    _print_rank_numbers(ranks, t_world, exact)
    return launches


def _print_rank_numbers(ranks, t_world, exact):
    """Per rank: the bytes each preconditioner application gathered (against
    the threshold's field) and received, the shard-fused V-cycle's lane
    transfers (2048² and 8192²) against their bound, the 8192²
    application's seconds and peak memory, and each route's host seconds,
    peak device memory and gathered bytes; the world's seconds. Each block
    application must equal the single-device plain hierarchy bit for bit,
    the 8192² application the single-device fused V-cycle; with ``exact`` a
    V-cycle gathers at most the threshold's field, an FMG no larger field,
    and the lane transfers receive at most their bound."""
    log(f"mesh 4 ranks world: {t_world:.3f} s (spawn, build of each rank's kernels, every route); "
        "rank 0's phases: " + ", ".join(f"{p} {t:.3f} s" for p, t in ranks[0]["laps"]))
    for k, rk in enumerate(ranks):
        c = rk["cycles"]
        thr = c.get("threshold")
        parts = []
        for name in ("vcycle f32", "vcycle f64", "fmg_stepwise f32", "shard-fused vcycle f32"):
            fields, total, largest, lane, received = c[name]["gathered"]
            ops, ops_ms = c[name]["ops"]
            parts.append(f"{name} {total} B in {fields} fields, largest {largest} B, received "
                         f"{received} B, {c[name]['t'] * 1e3:.1f} ms, {ops} device ops "
                         f"({ops_ms:.2f} ms)")
            if not c[name]["equal"]:
                raise AssertionError(f"rank {k}: {name} on blocks differs from the "
                                     "single-device plain hierarchy")
        log(f"mesh 4 ranks rank {k} per application: " + "; ".join(parts))
        big = rk["big"]
        for label, rec in ((MESH_N, c["shard-fused vcycle f32"]), (MESH_FUSED_N, big)):
            log(f"mesh 4 ranks rank {k} shard-fused V-cycle lane transfers {label}^2: received "
                f"{rec['gathered'][3]} B (bound {rec['lane_bound']} B) of "
                f"{rec['gathered'][4]} B received in all")
        log(f"mesh 4 ranks rank {k} shard-fused V-cycle {MESH_FUSED_N}^2 (2, 2), one application: "
            f"{big['t'] * 1e3:.1f} ms, peak {big['peak'] / 2**20:.1f} MiB, gathered "
            f"{big['gathered'][1]} B in {big['gathered'][0]} fields, received "
            f"{big['gathered'][4]} B; fused levels {big['levels']} (single-device "
            f"{big['single_levels']}), bit-equal to the single-device fused V-cycle {big['equal']}")
        if not big["equal"] or big["levels"] != big["single_levels"]:
            raise AssertionError(f"rank {k}: the {MESH_FUSED_N}^2 shard-fused V-cycle differs "
                                 "from the single-device fused V-cycle")
        if thr is not None:
            tf = c["threshold fused"]
            log(f"mesh 4 ranks rank {k} threshold field: {thr['shape']} ({thr['nodes']} nodes: "
                f"{4 * thr['nodes']} B f32, {8 * thr['nodes']} B f64; levels on blocks "
                f"{thr['stop']} of {thr['levels']}); shard-fused remainder's {tf['shape']}")
        if exact:
            if thr is None:
                raise AssertionError(f"rank {k}: no block multigrid")
            bound = {"vcycle f32": 4 * thr["nodes"], "vcycle f64": 8 * thr["nodes"],
                     "shard-fused vcycle f32": 4 * c["threshold fused"]["nodes"]}
            for name, b in bound.items():
                if c[name]["gathered"][1] > b:
                    raise AssertionError(f"rank {k}: {name} gathered {c[name]['gathered'][1]} B "
                                         f"> the threshold's field {b} B")
            if big["gathered"][1] > 4 * big["threshold_nodes"]:
                raise AssertionError(f"rank {k}: the {MESH_FUSED_N}^2 shard-fused V-cycle "
                                     f"gathered {big['gathered'][1]} B > its threshold's field")
            for rec in (c["shard-fused vcycle f32"], big):
                if rec["gathered"][3] > rec["lane_bound"]:
                    raise AssertionError(f"rank {k}: shard-fused lane transfers received "
                                         f"{rec['gathered'][3]} B > their bound "
                                         f"{rec['lane_bound']} B")
            if c["fmg_stepwise f32"]["gathered"][2] > 4 * thr["nodes"]:
                raise AssertionError(f"rank {k}: the FMG gathered a field above the threshold")
        log(f"mesh 4 ranks rank {k} per route (host s, peak device MiB, fields / MB gathered): "
            + "; ".join(f"{p} {r['t']:.3f} s, {r['peak'] / 2**20:.1f} MiB, "
                        f"{r['gathered'][0]} / {r['gathered'][1] / 1e6:.3f} MB"
                        for p, r in rk["routes"].items()))


def mesh_only(exact) -> int:
    """``--mesh DIR``: the 4-rank world of the port in DIR
    (:func:`four_ranks_one_card`), then one JSON line of each route's rank-0
    launches."""
    log(json.dumps({"mesh": four_ranks_one_card(MESH_N, exact)}))
    return 0


# the slice's CLI command: the JAX package's default solve at 8192², with
# the profile, the report and the HTML explorer (its flags also in a TOML)
CLI_FLAGS = ["--precond", "mg", "--precision", "mixed", "--outer", "ff",
             "--eps-precision", "-1", "--eps-residual", "-1", "--eps-relative", "1e-6"]
CLI_TOML = ('precond = "mg"\nprecision = "mixed"\nouter = "ff"\neps_precision = -1.0\n'
            'eps_residual = -1.0\neps_relative = 1e-6\n')
# what the sectioned text keeps, so what ``view T.txt --save-npz`` re-saves
TEXT_KEYS = ("solution", "true_solution", "residual", "error", "x_coords", "y_coords",
             "iterations", "converged", "stop_reason", "residual_norm", "error_norm", "nx",
             "ny", "nz", "bounds")


def _cli(argv):
    """``cli.main(argv)`` in this process: (rc, stdout, stderr)."""
    import contextlib
    import io

    from iterative_solvers_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def cli_solve(tmp, n=N):
    """(a) ``solve`` through the CLI at ``n``² with a TOML config, on the
    card: rc 0, converged in the report, true f64 relative residual < 1e-6
    (computed on the solver's device from the facade's results), path A's
    kernels launched and none run plain on CUDA; the CLI's phase table (a
    cold solve: the route is built) and a second, warm solve's on the same
    solver. Returns the launches."""
    import torch

    from iterative_solvers_tpu_torch.api import DirichletSolver
    from iterative_solvers_tpu_torch.kernels import _build
    from iterative_solvers_tpu_torch.profiling import Profiler

    cfg = os.path.join(tmp, "solve.toml")
    with open(cfg, "w") as f:
        f.write(f"nx = {n}\nny = {n}\n" + CLI_TOML)
    html = os.path.join(tmp, "solve.html")
    argv = ["solve", "--config", cfg, "--nx", str(n), "--ny", str(n), *CLI_FLAGS, "--profile",
            "--report", "--html", html]
    captured = {}
    solve = DirichletSolver.solve

    def keep(self, *a, **k):  # the CLI's solver and results, for the checks below
        captured["solver"] = self
        captured["res"] = solve(self, *a, **k)
        return captured["res"]

    torch.cuda.synchronize()
    _build.reset_counts()
    DirichletSolver.solve = keep
    t0 = time.perf_counter()
    try:
        rc, out, err = _cli(argv)
    finally:
        DirichletSolver.solve = solve
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_build.launches), dict(_build.plain_on_cuda)
    log(f"cli {n}^2: python -m iterative_solvers_tpu_torch {' '.join(argv[3:])} "
        f"(config {os.path.basename(cfg)}): rc {rc} wall {wall:.3f} s "
        f"(html {os.path.getsize(html) if os.path.exists(html) else 0} bytes)")
    for line in (err + out).splitlines():
        log(f"  cli| {line}")
    log(f"path cli launches {launches} plain_on_cuda {plain}")
    solver, res = captured["solver"], captured["res"]
    rel = true_rel(solver, res)
    log(f"cli {n}^2: converged {res.converged} reason {res.stop_reason.name} outer "
        f"{res.outer_iterations} inner {res.iterations} true_rel {rel:.3e}")
    missing = [k for k in PATH_KERNELS["A"] if launches.get(k, 0) <= 0]
    if rc != 0 or "Converged:               yes" not in out or not rel < 1e-6:
        raise AssertionError(f"cli solve failed: rc={rc} converged={res.converged} "
                             f"rel={rel:.3e}")
    if missing or plain:
        raise AssertionError(f"cli solve: kernels not launched {missing}; plain on CUDA {plain}")
    # the facade's warm wall split into its phases (the route is built)
    prof = Profiler()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(profiler=prof)
    torch.cuda.synchronize()
    log(f"cli {n}^2 warm facade solve: wall {time.perf_counter() - t0:.3f} s, inner "
        f"{res.iterations} converged {res.converged}")
    for line in prof.report().splitlines():
        log(f"  warm| {line}")
    del solver, res, captured
    torch.cuda.empty_cache()
    return launches


def cli_files(tmp, n=NB):
    """(b) ``solve --save T.txt --save-npz N.npz --save-matrix M.txt`` at
    ``n``², then ``view T.txt --save-npz N2.npz``: N and N2 bit-equal on
    every array the text format keeps; the native CSR equal to the NumPy
    builder's, and the dump's CSR to both."""
    import numpy as np

    from iterative_solvers_tpu_torch import Domain2D
    from iterative_solvers_tpu_torch.ops.sparse import assemble_csr
    from iterative_solvers_tpu_torch.results_io import load_matrix_and_rhs

    t_txt, t_npz, t_npz2, t_mat = (os.path.join(tmp, f) for f in ("T.txt", "N.npz", "N2.npz",
                                                                  "M.txt"))
    t0 = time.perf_counter()
    rc, _, err = _cli(["solve", "--nx", str(n), "--ny", str(n), *CLI_FLAGS, "--quiet",
                       "--save", t_txt, "--save-npz", t_npz, "--save-matrix", t_mat])
    t_solve = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli files: solve rc {rc}: {err}")
    t0 = time.perf_counter()
    rc, _, err = _cli(["view", t_txt, "--save-npz", t_npz2])
    t_view = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli files: view rc {rc}: {err}")
    with np.load(t_npz) as a, np.load(t_npz2) as b:
        differ = [k for k in TEXT_KEYS if not np.array_equal(a[k], b[k])]
        rest = sorted(set(a.files) - set(TEXT_KEYS))
    t0 = time.perf_counter()
    dom = Domain2D(nx=n, ny=n)
    native, plain = assemble_csr(dom, backend="native"), assemble_csr(dom, backend="numpy")
    t_csr = time.perf_counter() - t0
    t0 = time.perf_counter()
    dumped = load_matrix_and_rhs(t_mat)[:3]
    t_load = time.perf_counter() - t0
    csr_ok = all(np.array_equal(x, y) and np.array_equal(x, z)
                 for x, y, z in zip(native, plain, dumped))
    sizes = {os.path.basename(f): os.path.getsize(f) for f in (t_txt, t_npz, t_npz2, t_mat)}
    log(f"cli files {n}^2: solve+save {t_solve:.3f} s, view+npz {t_view:.3f} s, native vs "
        f"numpy CSR {t_csr:.3f} s ({len(native[1])} nonzeros, equal {csr_ok}), dump reload "
        f"{t_load:.3f} s; sizes {sizes}; N vs N2 bit-equal on {len(TEXT_KEYS)} arrays "
        f"(differ {differ}); not in the text format: {rest}")
    if differ or not csr_ok:
        raise AssertionError(f"cli files: N/N2 differ on {differ}; CSR equal {csr_ok}")


def cli_checkpoint(tmp, n=NB):
    """(c) plain f32 MSG CG on A1 at ``n``² to rel 1e-6: a run stopped after
    its first checkpoint (``periodic_checkpointer(every_iters=500)``),
    reloaded with ``load_cg_state`` and resumed, against an uninterrupted
    run: the same iteration count and x bit for bit. Returns the resumed
    run's launches."""
    import torch

    from iterative_solvers_tpu_torch import Domain2D, PoissonProblem
    from iterative_solvers_tpu_torch.kernels import _build
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.solvers.cg import CGOptions, cg_solve
    from iterative_solvers_tpu_torch.solvers.checkpoint import (
        load_cg_state,
        periodic_checkpointer,
    )

    dom = Domain2D(nx=n, ny=n)
    op = PaddedStencilOperator.from_domain(dom)
    b = op.pad(PoissonProblem.manufactured(dom).rhs_field(torch.float32, "cuda"))
    stop = stop_rel6()
    t0 = time.perf_counter()
    full = cg_solve(op, b, options=CGOptions(stop=stop))
    t_full = time.perf_counter() - t0
    ckpt = os.path.join(tmp, "cg.npz")
    t0 = time.perf_counter()
    first = cg_solve(op, b, options=CGOptions(
        stop=stop, state_callback=periodic_checkpointer(ckpt, every_iters=500),
        stop_requested=lambda: os.path.exists(ckpt)))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = load_cg_state(ckpt)
    t_load = time.perf_counter() - t0
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.perf_counter()
    res = cg_solve(op, b, options=CGOptions(stop=stop), init_state=state)
    t_resume = time.perf_counter() - t0
    launches, plain = dict(_build.launches), dict(_build.plain_on_cuda)
    same_x = bool(torch.equal(res.x, full.x))
    log(f"cli checkpoint {n}^2 plain f32 CG on A1: uninterrupted {full.iterations} "
        f"{full.reason.name} {t_full:.3f} s; first run {first.reason.name} at "
        f"{first.iterations} {t_first:.3f} s; checkpoint {os.path.getsize(ckpt)} bytes, load "
        f"{t_load:.3f} s (k {state.k}); resumed {res.iterations} {res.reason.name} "
        f"{t_resume:.3f} s; x bit-equal {same_x}; launches {launches} plain_on_cuda {plain}")
    if not (first.reason.name == "INTERRUPTED" and state.k == 500 and res.converged
            and res.iterations == full.iterations and same_x):
        raise AssertionError("cli checkpoint: the resumed run differs from the uninterrupted "
                             f"one ({res.iterations} vs {full.iterations}, x equal {same_x})")
    if launches.get("stencil", 0) <= 0 or plain:
        raise AssertionError(f"cli checkpoint: launches {launches}, plain on CUDA {plain}")
    return launches


def cli_phase():
    """The CLI and the files: (a) the 8192² solve, (b) the 1024² files,
    (c) the checkpoint, each with its wall time. Returns the launches of
    (a) and (c)."""
    import tempfile

    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        for name, fn in (("(a) solve", cli_solve), ("(b) files", cli_files),
                         ("(c) checkpoint", cli_checkpoint)):
            t0 = time.perf_counter()
            got = fn(tmp)
            log(f"cli phase {name}: {time.perf_counter() - t0:.3f} s")
            if got is not None:
                launches["cli" if name == "(a) solve" else "cli checkpoint"] = got
    return launches


def mesh_facade_3d(n=MESH_N3):
    """The 3D facade with a mesh: operator='pallas' (D2), 'mg' (the plain
    V-cycle, whole on the one block, as JAX runs its jnp legs there), mixed,
    on a 1x1 mesh, to true rel < 1e-6."""
    import torch

    from iterative_solvers_tpu_torch import DirichletSolver, Domain3D
    from iterative_solvers_tpu_torch.parallel import make_solver_mesh

    solver = DirichletSolver(domain=Domain3D(n, n, n), operator="pallas", preconditioner="mg",
                             precision="mixed", mesh=make_solver_mesh(1), device="cuda",
                             stop=stop_rel6())
    res, wall, launches = timed_solve(solver, "mesh 3D facade", warm=False)
    rel = true_rel(solver, res)
    log(f"mesh 3D facade {n}^3 1x1 (pallas, mg, mixed, outer {solver.outer_kind}): converged "
        f"{res.converged} reason {res.stop_reason.name} outer {res.outer_iterations} inner "
        f"{res.iterations} true_rel {rel:.3e} refine {res.elapsed_s:.4f} s wall {wall:.3f} s")
    if not (res.converged and rel < 1e-6):
        raise AssertionError(f"mesh 3D facade failed: converged={res.converged} rel={rel:.3e}")
    del solver, res
    torch.cuda.empty_cache()
    return launches


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port once on one NVIDIA GPU.")
    ap.add_argument("--legs", metavar="DIR",
                    help="only check and time the V-cycle legs (2D at 8192², 3D at 512³) "
                         "of the port in the checkout DIR (this one or an earlier commit's)")
    ap.add_argument("--cg", metavar="DIR",
                    help="only check and time the fused CG kernels K1, K2 and K2-pcg and "
                         "their mesh blocks D5, D6 and D6-pcg of the port in the checkout DIR "
                         "(this one or an earlier commit's)")
    ap.add_argument("--mesh", metavar="DIR",
                    help="only the 4-rank world on the one card (the mesh routes, the "
                         "preconditioners' gathered bytes, peak memory and seconds per rank) "
                         "of the port in the checkout DIR (this one or an earlier commit's)")
    ap.add_argument("--zstream", metavar="DIR",
                    help="only check and time the staged z-march's kernels S7, J3, D2 and R3 "
                         "of the port in the checkout DIR (this one or an earlier commit's)")
    ap.add_argument("--stencil", metavar="DIR",
                    help="only check and time A1 and C1 (1024², 4096², 8192²), the in-place "
                         "and pipelined stencils C4 and C5, conv2d and the nnz chain of the "
                         "port in the checkout DIR (this one or an earlier commit's)")
    args = ap.parse_args(argv)
    other = args.legs or args.cg or args.stencil or args.zstream or args.mesh
    root = os.path.abspath(other) if other else REPO
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(root, "iterative_solvers_tpu_torch")):
        print("chip_smoke: the iterative_solvers_tpu_torch package is missing", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build
    from iterative_solvers_tpu_torch import DirichletSolver
    from iterative_solvers_tpu_torch.core.domain import Domain2D, Domain3D, notched_disk
    from iterative_solvers_tpu_torch.kernels import _build
    from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
    from iterative_solvers_tpu_torch.solvers.refine import fused_refined_solve

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib, REPO)}")

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.legs:
        return legs_only(gen)
    if args.cg:
        return cg_only(gen)
    if args.stencil:
        return stencil_only(gen, exact=root == REPO)
    if args.mesh:
        return mesh_only(exact=root == REPO)
    if args.zstream:
        # an earlier checkout's J3 (PR 3's march, whose node update nvcc may
        # contract into an fmaf) is held to the field tolerance it had
        return zstream_only(gen, "exact" if root == REPO else "field")
    # 16-row bands: several bands, and their halos, even on small grids
    check_kernels(Domain2D(nx=64, ny=64), gen, "gamma 64^2", timed=False, block_rows=16)
    check_kernels(Domain2D(nx=40, ny=50, shape="rect"), gen, "rect 40x50", timed=False,
                  block_rows=16)
    # path B's own layout (256-row bands), timed on the graph timer too:
    # path B launches K1, K2 and the stencil at this shape
    at_nb = check_kernels(Domain2D(nx=NB, ny=NB), gen, f"{NB}^2 path B", timed=True, short=True)
    stats = check_kernels(Domain2D(nx=N, ny=N), gen, "8192^2 level 0", timed=True)
    torch.cuda.empty_cache()
    # A1 where the precond races and the facade's pallas paths launch it
    at_precond = a1_row(PaddedStencilOperator.from_domain(Domain2D(nx=PRECOND_N, ny=PRECOND_N)),
                        gen, f"{PRECOND_N}^2 precond", timed=True)
    # the V-cycle legs at every fused level of path A (8192 … 512); level 0
    # gives A5's and A6's rows
    stats.update(check_legs(Domain2D(nx=N, ny=N), gen, f"{N}^2")[0])
    # the custom-mask instantiations on the notched disk: 32-row bands, path
    # C-B's 1024² layout, the 8192² level-0 layout (its host masks are built
    # once here and reused by path C)
    t0 = time.perf_counter()
    disk = Domain2D(nx=N, ny=N, shape="custom", inside_fn=notched_disk)
    log(f"custom {N}^2 host masks: {disk.num_unknowns} unknowns, "
        f"{time.perf_counter() - t0:.3f} s")
    for n, by in ((64, 32), (NB, None)):  # path C-B's own layout timed
        at_nb.update(check_kernels(Domain2D(nx=n, ny=n, shape="custom", inside_fn=notched_disk),
                                   gen, f"custom {n}^2", timed=n == NB, short=n == NB,
                                   block_rows=by))
    stats.update(check_kernels(disk, gen, f"custom {N}^2 level 0", timed=True))
    torch.cuda.empty_cache()
    legs = check_legs(disk, gen, f"custom {N}^2")[0]
    stats.update({"k_down_custom": legs["k_down"], "k_up_custom": legs["k_up"]})
    for dims in ((16, 16, 16), (32, 32, 32), (16, 24, 8)):
        check_kernels_3d(dims, gen, "x".join(map(str, dims)), timed=False)
    stats.update(check_kernels_3d((N3, N3, N3), gen, f"{N3}^3 level 0", timed=True))
    torch.cuda.empty_cache()
    # the staged z-march's D2 and R3 on every split and coefficient set
    for dims in ((16, 16, 16), (32, 32, 32), (16, 24, 8)):
        check_zstream(gen, dims, timed=False)
    # the mesh block kernels D1–D4: virtual partitions, stitched, timed
    stats.update(check_mesh_kernels(gen))
    torch.cuda.empty_cache()
    # D3 and D4 bit-equal to their plain versions and timed at every
    # shard-fused level that path "mesh a" runs (8192², 4096², 2048² on 1x1)
    for li, rec in check_mesh_legs(gen).items():
        for k in ("k_down_block", "k_up_block"):
            stats[k].setdefault("levels", {})[li] = {
                "shape": rec["shape"], "tj": rec["tj"], "ms": rec[k]["ms"],
                "graph_ms": rec[k]["graph_ms"], "bound_ms": rec[k]["bound_ms"]}
    # the sharded fused engine's kernels D5, D6: the same, against K1 / K2
    engine, engine_nb = check_engine_kernels(gen)
    stats.update(engine)
    at_nb.update(engine_nb)
    torch.cuda.empty_cache()
    # C4 and C5: the gamma 64² (16-row panels) and 1024² layouts, the nnz
    # chain's 8192² layout (256-row panels), the custom 64² and 8192² ones
    check_pipelined(Domain2D(nx=64, ny=64), gen, "gamma 64^2", timed=False, block_rows=16)
    check_pipelined(Domain2D(nx=1024, ny=1024), gen, "1024^2", timed=False)
    stats.update(check_pipelined(Domain2D(nx=N, ny=N), gen, f"{N}^2 nnz", timed=True,
                                 block_rows=256))
    # the same grid at auto_block_rows (64-row panels, 8256 rows): ranges
    # that are not panel multiples, each kernel timed beside the nnz layout
    for name, rec in check_pipelined(Domain2D(nx=N, ny=N), gen, f"{N}^2 auto",
                                     timed=True).items():
        stats[name]["auto"] = {k: rec[k] for k in ("shape", "ms", "one_call_ms")}
    check_pipelined(Domain2D(nx=64, ny=64, shape="custom", inside_fn=notched_disk), gen,
                    "custom 64^2", timed=False, block_rows=32)
    stats.update(check_pipelined(disk, gen, f"custom {N}^2 nnz", timed=True, block_rows=256))
    torch.cuda.empty_cache()

    # 4. solves
    small_checks(Domain2D(nx=64, ny=64))
    small_checks(Domain2D(nx=64, ny=64, shape="custom", inside_fn=notched_disk))
    rel6 = stop_rel6()
    launches = {}
    # path A: the JAX package's default solve (fmg_cycles=1 by default)
    solver = DirichletSolver(nx=N, ny=N, preconditioner="mg", precision="mixed", outer="ff",
                             device="cuda", stop=rel6)
    res, wall, launches["A"] = timed_solve(solver, "A")
    rel = true_rel(solver, res)
    log(f"path A {N}^2 fmg ff: converged {res.converged} reason {res.stop_reason.name} "
        f"outer {res.outer_iterations} inner {res.iterations} true_rel {rel:.3e} "
        f"refine {res.elapsed_s:.4f} s wall {wall:.3f} s")
    if not res.converged or not rel < 1e-6:
        raise AssertionError(f"path A failed: converged={res.converged} rel={rel:.3e}")
    path_a = (res.outer_iterations, res.iterations)
    pop, Mp = solver._parts
    b, u = solver.problem.rhs_field(device="cuda"), solver.problem.true_solution_field(device="cuda")
    _, traj_a, _ = refine_ab(
        lambda ff: fused_refined_solve(pop, Mp, b, u_true=u, stop=rel6, fmg=1, ff=ff),
        f"{N}^2 path A")
    del pop, Mp, b, u
    del solver, res
    torch.cuda.empty_cache()
    # the CLI: the 8192² solve, the 1024² files, the checkpoint
    launches.update(cli_phase())
    torch.cuda.empty_cache()
    # the mesh: the sharded fast path on a 1x1 mesh, the per-chip V-cycle
    # ratio, four ranks on the one card
    launches["mesh a"], fast_path = sharded_fast_path(path_a)
    launches["mesh engine"] = mesh_engine_path(traj_a["f64"], fast_path)
    vcycle_ratio()
    launches.update(four_ranks_one_card())
    # the first slice's cold f64-outer solve, unchanged
    solver = DirichletSolver(nx=N, ny=N, preconditioner="mg", precision="mixed", outer="f64",
                             fmg_cycles=0, device="cuda", stop=rel6)
    res, wall, launches["f64"] = timed_solve(solver, "f64")
    rel = true_rel(solver, res)
    log(f"cold f64 {N}^2: converged {res.converged} reason {res.stop_reason.name} "
        f"outer {res.outer_iterations} inner {res.iterations} true_rel {rel:.3e} "
        f"refine {res.elapsed_s:.4f} s wall {wall:.3f} s")
    if not res.converged or not rel < 1e-6:
        raise AssertionError(f"cold f64 solve failed: converged={res.converged} rel={rel:.3e}")
    del solver, res
    torch.cuda.empty_cache()
    # path B: plain f32 CG on the fused engine (f32 bounds its true residual)
    nb = NB
    solver = DirichletSolver(nx=nb, ny=nb, operator="fused", device="cuda", stop=rel6)
    res, wall, launches["B"] = timed_solve(solver, "B")
    rel = true_rel(solver, res)
    log(f"path B {nb}^2 plain CG: converged {res.converged} reason {res.stop_reason.name} "
        f"iterations {res.iterations} true_rel {rel:.3e} solve {res.elapsed_s:.4f} s "
        f"wall {wall:.3f} s")
    if not (res.converged and res.stop_reason.name == "RELATIVE_RESIDUAL" and rel < 1e-3):
        raise AssertionError(f"path B failed: converged={res.converged} rel={rel:.3e}")
    check_count("B", res.iterations)
    res_b_iterations = res.iterations
    del solver, res
    torch.cuda.empty_cache()
    launches["mesh fused B"] = mesh_fused_b(res_b_iterations)
    torch.cuda.empty_cache()
    # the custom-mask domain: paths C and C-B
    launches.update(custom_paths(disk))
    # bench.py's nnz chain: A1, C4 and C5 at 8192², and C4/C5 on the disk
    for dom, label, paths in (
            (Domain2D(nx=N, ny=N), f"{N}^2", (("nnz A1", "stencil", None),
                                              ("nnz C4", "inplace", None),
                                              ("nnz C5", "pipelined", None))),
            (disk, f"custom {N}^2", (("nnz C4 custom", "inplace", 8),
                                     ("nnz C5 custom", "pipelined", 8)))):
        launches.update({p: r["launches"] for p, r in nnz_chain(dom, 256, label, paths).items()})
    del disk
    torch.cuda.empty_cache()
    # bench.py's precond (4096²) and csr (1024²) races, the facade's paths
    launches.update(precond_race(PRECOND_N))
    torch.cuda.empty_cache()
    csr_race(1024)
    launches.update(facade_paths())
    torch.cuda.empty_cache()

    # 3D: the 64^3 checks, the bench route at 512^3, the facade, plain CG
    small_checks_3d()
    launches.update(solve_512_3d())
    torch.cuda.empty_cache()
    solver = DirichletSolver(domain=Domain3D(N3, N3, N3), preconditioner="mg", precision="mixed",
                             device="cuda", stop=rel6)
    res, wall, launches["3D facade"] = timed_solve(solver, "3D facade")
    rel = true_rel(solver, res)
    log(f"3D facade {N3}^3 (outer {solver.outer_kind}): converged {res.converged} reason "
        f"{res.stop_reason.name} outer {res.outer_iterations} inner {res.iterations} true_rel "
        f"{rel:.3e} refine {res.elapsed_s:.4f} s wall {wall:.3f} s")
    if not (res.converged and res.stop_reason.name == "RELATIVE_RESIDUAL" and rel < 1e-6):
        raise AssertionError(f"3D facade failed: converged={res.converged} rel={rel:.3e}")
    del solver, res
    torch.cuda.empty_cache()
    launches["3D CG"] = plain_cg_3d()
    launches["mesh 3D facade"] = mesh_facade_3d()

    # 5. summary
    kernels = []
    for k, (src, rep, ops, path) in KERNELS.items():
        s = stats[k]
        bound, bound_by = bound_ms(s, ops)
        row = {
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[path].get(k, 0), "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "one_call_ms": s["one_call_ms"], "plain_ms": s["plain_ms"],
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": s["library_ms"], "path": path, "shape": s.get("shape"),
        }
        if "auto" in s:  # C4/C5 at auto_block_rows
            row["at_auto_block_rows"] = s["auto"]
        if "levels" in s:  # D3/D4 at each shard-fused level of "mesh a"
            row["levels"] = s["levels"]
        if k == "stencil":  # A1 where the precond paths launch it
            row["at_precond"] = {
                "shape": at_precond["shape"], "ms": at_precond["ms"],
                "one_call_ms": at_precond["one_call_ms"], "plain_ms": at_precond["plain_ms"],
                "bound_ms": bound_ms(at_precond, ops)[0], "library_ms": at_precond["library_ms"],
                "launches": {p: launches[p].get(k, 0) for p in PRECOND_PATHS}}
        if k in AT_NB:  # the time and bound where the NB² path launches it
            p, sn = AT_NB[k], at_nb[k]
            row["at_path"] = {
                "path": p, "shape": sn["shape"], "launches": launches[p].get(k, 0),
                "graph_ms": sn["graph_ms"], "ms": sn["ms"], "one_call_ms": sn["one_call_ms"],
                "bound_ms": bound_ms(sn, ops)[0]}
        kernels.append(row)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

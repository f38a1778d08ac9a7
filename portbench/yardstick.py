"""The benchmark's yardstick: frozen copies of the program's timers, byte
bounds and kernel-name pattern, and the reading of a ``torch.profiler``
trace. A later change to the program cannot move them.

Copied from the repository's ``chip_smoke.py`` (``device_ms``, ``nbytes``,
``stencil_bytes``, the level-0 cases of ``check_kernels`` and
``check_kernels_3d``: inputs read once, 3D inputs on the interior only,
outputs written once) and ``iterative_solvers_tpu_torch/profile_paths.py``
(``_OWN_KERNEL``, ``_busy_us``). The port's kernels are called through
their public wrappers, the only part of the program used here.
"""

from __future__ import annotations

import re
import statistics

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, 80 GB HBM3

# the port's hand-written kernels (csrc/*.cu), as the profiler names them
# (the mesh blocks' as *_block_kernel)
OWN_KERNEL = re.compile(
    r"(?<![A-Za-z_])(k1|k2|k_down3?d?|k_up3?d?|k_jacobi3?d?|stencil3?d?|k_resid_ff3?d?)"
    r"(_block)?_kernel"
)


def busy_us(spans):
    """(union of the ``(start, end)`` intervals, first start, last end), µs."""
    spans = sorted(spans)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, (spans[0][0] if spans else 0.0), (spans[-1][1] if spans else 0.0)


def idle_gaps(spans):
    """The gaps ``(start, end)`` between the union's intervals, µs."""
    gaps, cur_e = [], None
    for s, e in sorted(spans):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def device_ms(fn, reps=15):
    """Device time of one call of ``fn``: two warm-up calls, then three runs
    of ``reps`` calls back to back between two CUDA events; the median run
    over ``reps``."""
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


def nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def stencil_bytes(lay, device):
    """Bytes of the masked 5-point function on ``lay``: x read on the
    interior only, y written over the whole canvas."""
    hp, wp = lay.padded_shape
    n_in = int(lay.mask_spec.build(device).sum())
    return 4 * n_in + 4 * hp * wp


def level0_cases_2d(pop, mg, gen):
    """{kernel name: (call, bytes)} of the 2D kernels on the padded
    operator's layout ``pop`` and the fused level 0 of multigrid ``mg``
    (its legs' cases only when that level is fused)."""
    from iterative_solvers_tpu_torch.kernels import cg_fused, resid_ff
    from iterative_solvers_tpu_torch.ops.ddf32 import split_f64

    dev = gen.device
    mask = pop.mask_spec.build(dev)

    def field(shape, masked=True):
        t = torch.randn(shape, device=dev, generator=gen)
        return torch.where(mask, t, 0.0) if masked else t

    d, z, x, r, w = (field(pop.padded_shape) for _ in range(5))
    beta = torch.tensor(0.37, device=dev)
    scal = torch.tensor([-1.3e-4, 0.37], device=dev)
    side = cg_fused.k1_plain(w, z, beta, pop)[0]
    side_r = cg_fused.k1_plain(r, z, beta, pop)[0]
    f64 = dict(device=dev, dtype=torch.float64, generator=gen)
    bh, bl = split_f64(torch.where(mask, torch.randn(pop.padded_shape, **f64), 0.0) * 1e4)
    xh, xl = split_f64(torch.where(mask, torch.randn(pop.padded_shape, **f64), 0.0))
    cases = {
        "k1": (lambda: cg_fused.k1(d, z, beta, pop), (d, z)),
        "k2": (lambda: cg_fused.k2(x, r, z, side_r, scal, pop), (x, r, z, side_r)),
        "k2_pcg": (lambda: cg_fused.k2_pcg(x, r, z, w, side, scal, pop), (x, r, z, w, side)),
        "k_resid_ff": (lambda: resid_ff.resid_ff(xh, xl, bh, bl, pop), (xh, xl, bh, bl)),
    }
    out = {}
    for name, (call, ins) in cases.items():
        out[name] = (call, nbytes(ins) + nbytes(call()))
    xs = torch.randn(pop.padded_shape, device=dev, generator=gen)
    out["stencil"] = (lambda: pop(xs), stencil_bytes(pop, dev))
    kl = getattr(mg.levels[0], "kernels", None) if mg is not None else None
    if kl is not None:
        b = field(kl.padded_shape, masked=False)
        xj = field(kl.padded_shape, masked=False)
        ec = torch.randn(kl.coarse_shape, device=dev, generator=gen)
        legs = {
            "k_down": (lambda: (kl.down(b),), (b,)),
            "k_up": (lambda: kl.up(b, ec, with_dot=True), (b, ec)),
            "k_jacobi": (lambda: (kl.jacobi(xj, b),), (xj, b)),
        }
        for name, (call, ins) in legs.items():
            out[name] = (call, nbytes(ins) + nbytes(call()))
    return out


def level0_cases_3d(pop, mg, gen):
    """{kernel name: (call, bytes)} of the 3D kernels on the padded 7-point
    operator's layout ``pop`` and the fused level 0 of ``mg``: each
    full-depth input counts its interior nodes, ``ec`` the child's grid,
    each output its whole canvas."""
    from iterative_solvers_tpu_torch.kernels import resid_ff
    from iterative_solvers_tpu_torch.ops.ddf32 import split_f64

    dev = gen.device
    shape = pop.padded_shape
    mask = pop.mask_spec.build(dev)
    n_in = int(mask.sum())
    x = torch.randn(shape, device=dev, generator=gen)
    f64 = dict(device=dev, dtype=torch.float64, generator=gen)
    bh, bl = split_f64(torch.where(mask, torch.randn(shape, **f64), 0.0) * 1e4)
    xh, xl = split_f64(torch.where(mask, torch.randn(shape, **f64), 0.0))
    cases = {"stencil3d": (lambda: (pop(x),), n_in),
             "k_resid_ff3d": (lambda: resid_ff.resid_ff(xh, xl, bh, bl, pop), 4 * n_in)}
    kl = getattr(mg.levels[0], "kernels", None) if mg is not None else None
    if kl is not None:
        nz, ny, nx = (s - 1 for s in mg.domains[0].grid_shape)
        n_ec = kl.dc * (ny // 2 + 1) * (nx // 2 + 1)
        b, xj = (torch.randn(shape, device=dev, generator=gen) for _ in range(2))
        ec = torch.randn(kl.child_shape, device=dev, generator=gen)
        cases.update({
            "k_down3d": (lambda: (kl.down(b),), n_in),
            "k_up3d": (lambda: (kl.up(b, ec),), n_in + n_ec),
            "k_jacobi3d": (lambda: (kl.jacobi(xj, b),), 2 * n_in),
        })
    return {name: (call, 4 * reads + nbytes(call())) for name, (call, reads) in cases.items()}


def kernel_rooflines(cases, names):
    """{name: (bytes, device ms)} of the launched ``names`` that have a
    case, each timed alone by :func:`device_ms`."""
    out = {}
    for name in sorted(names):
        if name in cases:
            call, nb = cases[name]
            out[name] = (nb, device_ms(call))
    return out


def read_trace(prof):
    """The parts of a ``torch.profiler`` capture the metrics read: device
    operations ``(name, start µs, end µs)`` (kernels, copies and sets; not
    the device-side mirror of annotated ranges) and the host's annotated
    ranges ``(name, start µs, end µs)``. Reads Kineto's raw events where
    the installed torch gives them (seconds for a million events), else
    the profiler's function events."""
    try:
        rows = [(e.name(), e.device_type(), e.start_ns() / 1e3,
                 (e.start_ns() + e.duration_ns()) / 1e3, e.is_user_annotation())
                for e in prof.profiler.kineto_results.events()]
    except AttributeError:
        rows = [(e.name, e.device_type, e.time_range.start, e.time_range.end,
                 getattr(e, "is_user_annotation", False)) for e in prof.events()]
    device, ranges = [], []
    for name, kind, start, end, annotation in rows:
        if kind == torch.autograd.DeviceType.CUDA:
            if not annotation:
                device.append((name, start, end))
        elif annotation:
            ranges.append((name, start, end))
    return {"device": device, "ranges": ranges}


def name_gaps(gaps, ranges):
    """{host range name: µs of device idleness}: each gap charged to the
    innermost annotated range that held the host at the gap's midpoint
    ("no range" where none did)."""
    ranges = sorted(ranges, key=lambda r: r[1])
    out = {}
    for s, e in gaps:
        t = 0.5 * (s + e)
        name = "no range"
        for rn, rs, re_ in ranges:
            if rs > t:
                break
            if re_ >= t:
                name = rn  # the latest start that still holds t is the innermost
        out[name] = out.get(name, 0.0) + (e - s)
    return out

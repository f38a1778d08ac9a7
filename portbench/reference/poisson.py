"""Plain float64 reference for Dirichlet–Poisson problems on the nodes.

Written from the problem's statement alone, with its own grid and its own
5- and 7-point Laplacian; it imports nothing of the program. The domain's
unknowns come from ``portbench/domains/<kind>.py`` (its ``AXES``, slowest
first, and ``interior``), found beside this folder by the configuration's
``domain.kind``. A field is indexed ``[row, col]`` = ``[iy, ix]`` in 2D,
``[iz, iy, ix]`` in 3D, over the ``(n + 1)`` nodes a side of the
configuration's box (``x0``, ``x1``, ...).

Every node that is not an unknown carries the Dirichlet value u(node). The
equation at an unknown is the discrete Laplacian of the nodal values equal
to f there, so for a candidate solution ``x`` (read at the unknowns only)
the residual is ``f − L(v)`` with ``v = x`` at unknowns and ``u``
elsewhere, and the right-hand side with the boundary eliminated is
``f − L(v0)``, ``v0`` = 0 at unknowns and ``u`` elsewhere.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch

F64 = torch.float64
_GEOMETRY = {}  # domain file's path: its module


def geometry(kind: str):
    """``portbench/domains/<kind>.py``, loaded by its path beside this
    folder (so a copy of the benchmark reads its own)."""
    path = Path(__file__).resolve().parent.parent / "domains" / f"{kind}.py"
    if path not in _GEOMETRY:
        if not path.is_file():
            raise ValueError(f"unknown domain kind {kind!r}: no {path}")
        spec = importlib.util.spec_from_file_location(f"portbench_domain_{kind}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _GEOMETRY[path] = mod
    return _GEOMETRY[path]


def interior(kind: str, n: int, idx):
    """The unknowns among nodes of index tensors ``idx`` ((iy, ix) in 2D,
    (iz, iy, ix) in 3D, broadcastable), as a bool tensor."""
    return geometry(kind).interior(n, idx)


def _axes(dom: dict, n: int):
    """Per field axis (slowest first) the (origin, spacing) of the grid."""
    return [(dom[f"{a}0"], (dom[f"{a}1"] - dom[f"{a}0"]) / n)
            for a in geometry(dom["kind"]).AXES]


def _block(dom: dict, n: int, lo: int, hi: int, device):
    """Index tensors and f64 coordinates of the nodes of rows (2D) or
    planes (3D) ``lo`` .. ``hi - 1``, all columns."""
    axes = _axes(dom, n)
    nd = len(axes)
    idx, crd = [], []
    for a, (o, h) in enumerate(axes):
        i = torch.arange(lo, hi, device=device) if a == 0 else torch.arange(n + 1, device=device)
        shape = [-1 if b == a else 1 for b in range(nd)]
        idx.append(i.view(shape))
        crd.append((o + i.to(F64) * h).view(shape))
    return idx, crd


def _laplacian(v, dom: dict, n: int):
    """The 5- or 7-point Laplacian of ``v`` at the nodes one in from each
    face of the block ``v`` (its first and last rows / planes are halo)."""
    h2 = [h * h for _, h in _axes(dom, n)]
    c = v[(slice(1, -1),) + (slice(1, -1),) * (v.dim() - 1)]
    out = -2.0 * sum(1.0 / q for q in h2) * c
    for a, q in enumerate(h2):
        lo = [slice(1, -1)] * v.dim()
        hi = [slice(1, -1)] * v.dim()
        lo[a], hi[a] = slice(0, -2), slice(2, None)
        out = out + (v[tuple(lo)] + v[tuple(hi)]) / q
    return out


def residual_norms(x, dom: dict, n: int, fam):
    """(‖f − L(v)‖₂², ‖b‖₂²) over the unknowns for a candidate solution
    ``x`` (a full-grid field of any float type; values off the unknowns are
    not read), computed in f64 on ``x``'s device, in blocks of rows or
    planes of about 2**25 nodes. ``fam`` gives ``u`` and ``f``."""
    if tuple(x.shape) != (n + 1,) * len(_axes(dom, n)):
        raise ValueError(f"solution shape {tuple(x.shape)} is not the {n}-interval grid")
    block = max(1, 2**25 // (x[0].numel()))
    rr = bb = 0.0
    for lo in range(1, n, block):
        hi = min(lo + block, n)
        idx, crd = _block(dom, n, lo - 1, hi + 1, x.device)
        unk = interior(dom["kind"], n, idx)
        u = fam.u(*reversed(crd)).expand(unk.shape)
        v0 = torch.where(unk, 0.0, u)
        v = torch.where(unk, x[lo - 1:hi + 1].to(F64), u)
        mask = _core_of(unk, unk.shape)
        f = _core_of(fam.f(*reversed(crd)), unk.shape)
        b = torch.where(mask, f - _laplacian(v0, dom, n), 0.0)
        r = torch.where(mask, f - _laplacian(v, dom, n), 0.0)
        rr += float(torch.sum(r * r))
        bb += float(torch.sum(b * b))
    return rr, bb


def _core_of(t, shape):
    """``t`` broadcast to ``shape`` and cut to the nodes one in from each
    face of the block."""
    t = t.expand(shape)
    return t[(slice(1, -1),) * t.dim()]


def rel_residual(x, dom: dict, n: int, fam) -> float:
    """‖b − A x‖₂ / ‖b‖₂ over the unknowns, in f64."""
    rr, bb = residual_norms(x, dom, n, fam)
    return math.sqrt(rr / bb)


def rhs(dom: dict, n: int, fam, device, dtype=F64):
    """The right-hand side with the boundary eliminated (zero off the
    unknowns) on the whole grid."""
    idx, crd = _block(dom, n, 0, n + 1, device)
    unk = interior(dom["kind"], n, idx)
    u = fam.u(*reversed(crd)).expand(unk.shape)
    v0 = torch.nn.functional.pad(torch.where(unk, 0.0, u), (1,) * (2 * unk.dim()))
    f = fam.f(*reversed(crd)).expand(unk.shape)
    return torch.where(unk, f - _laplacian(v0, dom, n), 0.0).to(dtype), unk


def apply(x, unk, dom: dict, n: int):
    """``L`` on the unknowns of ``x`` (zero elsewhere), in ``x``'s type."""
    xm = torch.nn.functional.pad(torch.where(unk, x, 0), (1,) * (2 * x.dim()))
    h2 = [h * h for _, h in _axes(dom, n)]
    out = (-2.0 * sum(1.0 / q for q in h2)) * x
    for a, q in enumerate(h2):
        lo = [slice(1, -1)] * x.dim()
        hi = [slice(1, -1)] * x.dim()
        lo[a], hi[a] = slice(0, -2), slice(2, None)
        out = out + (xm[tuple(lo)] + xm[tuple(hi)]) * (1.0 / q)
    return torch.where(unk, out, 0).to(x.dtype)


def spectral_interval(dom: dict, n: int):
    """An interval [lo, hi] (both negative) holding the spectrum of ``L``:
    Gershgorin's bound at the wide end, the continuous problem's first
    eigenvalue on the enclosing square or cube at the narrow end."""
    h2 = [h * h for _, h in _axes(dom, n)]
    widths = [n * h for _, h in _axes(dom, n)]
    wide = -4.0 * sum(1.0 / q for q in h2)
    narrow = -(math.pi**2) * sum(1.0 / (w * w) for w in widths)
    return wide, narrow


def chebyshev_cg(dom: dict, n: int, fam, dtype, degree: int, iterations: int, device):
    """Chebyshev-preconditioned CG on ``L x = b`` in ``dtype`` from x = 0,
    ``iterations`` steps; returns x on the full grid. The preconditioner
    is ``degree`` Chebyshev steps on ``L z = r`` over
    :func:`spectral_interval`."""
    b, unk = rhs(dom, n, fam, device, dtype)
    wide, narrow = spectral_interval(dom, n)
    theta, delta = 0.5 * (wide + narrow), 0.5 * (narrow - wide)

    def precondition(r):
        sigma = theta / delta
        z = r / theta
        d = z
        rho_prev = 1.0 / sigma
        for _ in range(degree):
            rho = 1.0 / (2.0 * sigma - rho_prev)
            d = (rho * rho_prev) * d + (2.0 * rho / delta) * (r - apply(z, unk, dom, n))
            z = z + d
            rho_prev = rho
        return z

    x = torch.zeros_like(b)
    r = b.clone()
    z = precondition(r)
    p = z.clone()
    rz = torch.sum(r.float() * z.float())
    for _ in range(iterations):
        q = apply(p, unk, dom, n)
        pq = torch.sum(p.float() * q.float())
        if not bool(pq != 0):
            break
        a = (rz / pq).to(dtype)
        x = x + a * p
        r = r - a * q
        z = precondition(r)
        rz_new = torch.sum(r.float() * z.float())
        p = z + (rz_new / rz).to(dtype) * p
        rz = rz_new
    return x

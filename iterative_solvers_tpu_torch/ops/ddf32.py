"""Double-float32 (error-free transformation) arithmetic (counterpart of
the JAX package's ops/ddf32.py).

The double-f32 ("ff") outer of the mixed-precision refinement carries its
iterate and right-hand side as f32 pairs ``(hi, lo)`` and needs one
high-precision quantity, the true residual ``r = b − A x``.
:func:`residual_ff` evaluates it in f32 only: per axis the exact first
differences ``x_lo − x`` and ``x_hi − x`` with their TwoSum errors, the axis
coefficient applied exactly (a power of two) or by Dekker's TwoProd, a plain
f32 ``A·xl``, and the gap between the stored diagonal and the exact
``−2Σc`` folded back in (2D and 3D). On the padded layouts it is the plain
version of the kernels in ``kernels/resid_ff.py``.

Every step is one torch op on f32 tensors, so each product and sum is
rounded once, in the order written; scalars are f32 values (the coefficient
splits are computed in numpy f32), which torch applies without widening.
"""

from __future__ import annotations

from math import frexp, fsum
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch.ops.stencil import stencil_apply, stencil_apply_3d

Pair = Tuple[torch.Tensor, torch.Tensor]
F32 = torch.float32


def two_sum(a, b) -> Pair:
    """Knuth TwoSum: a + b = s + e exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def two_prod(a, b) -> Pair:
    """Dekker/Veltkamp TwoProd of f32 tensors (a may be 0-dim): a·b = p + e
    exactly."""
    p = a * b
    c = 4097.0 * a
    a_hi = c - (c - a)
    a_lo = a - a_hi
    c = 4097.0 * b
    b_hi = c - (c - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def split_f64(v: torch.Tensor) -> Pair:
    """f64 tensor -> (hi, lo) f32 pair with hi + lo == v to pair precision."""
    hi = v.to(F32)
    return hi, (v - hi.to(v.dtype)).to(F32)


def pair_to_f64(p: Pair) -> torch.Tensor:
    return p[0].to(torch.float64) + p[1].to(torch.float64)


def pair_add_f32(p: Pair, d: torch.Tensor) -> Pair:
    """(hi, lo) + d (plain f32) -> normalised pair (TwoSum + low fold)."""
    s, e = two_sum(p[0], d)
    return two_sum(s, e + p[1])


def pair_value(p: Pair) -> torch.Tensor:
    """Best single-f32 value of the pair, fl(hi + lo)."""
    return p[0] + p[1]


def is_pow2(v: float) -> bool:
    m, _ = frexp(abs(v))
    return m == 0.5 and v != 0.0


def coeff_split(c: float):
    """f32 constants of one axis coefficient: (cf, cf_hi, cf_lo, c_lo) with
    cf = f32(c), (cf_hi, cf_lo) Veltkamp's 12-bit split of cf and c_lo the
    f64 residue c − cf, all as Python floats holding f32 values."""
    cf = np.float32(c)
    k = np.float32(4097.0) * cf
    cf_hi = np.float32(k - (k - cf))
    cf_lo = np.float32(cf - cf_hi)
    c_lo = np.float32(c - float(cf))
    return float(cf), float(cf_hi), float(cf_lo), float(c_lo)


def coeff_delta(coeffs) -> float:
    """cd + 2Σ axis-c: the f64 rounding gap between the stored diagonal and
    the exact −2Σc of the difference form."""
    return fsum([coeffs[0]] + [2.0 * c for c in coeffs[1:]])


def _scaled_term(t: torch.Tensor, e_sum: torch.Tensor, c: float) -> Pair:
    """(main, err) of c·(t + e_sum) where t + e_sum is an exact pair: exact
    products for a power-of-two c, else TwoProd on the f32 head cf plus the
    f64 residue c_lo folded into the error channel."""
    cf, _, _, c_lo = coeff_split(c)
    if is_pow2(float(c)):
        return cf * t, cf * e_sum
    p, pe = two_prod(torch.tensor(cf, dtype=F32, device=t.device), t)
    return p, (pe + c_lo * t) + cf * e_sum


def _axis_diff2(xm: torch.Tensor, lo, hi, c: float) -> Pair:
    """(main, err) of c·(x_lo − 2x + x_hi) through exact first differences."""
    d1, e1 = two_sum(lo, -xm)
    d2, e2 = two_sum(hi, -xm)
    t, e3 = two_sum(d1, d2)
    return _scaled_term(t, (e1 + e2) + e3, c)


def _masked_shifts(xm: torch.Tensor):
    """(lo, hi) neighbour views of a masked field per axis, x first, zero
    outside the canvas."""
    if xm.ndim == 3:
        p = F.pad(xm, (1, 1, 1, 1, 1, 1))
        return (
            (p[1:-1, 1:-1, :-2], p[1:-1, 1:-1, 2:]),  # x
            (p[1:-1, :-2, 1:-1], p[1:-1, 2:, 1:-1]),  # y
            (p[:-2, 1:-1, 1:-1], p[2:, 1:-1, 1:-1]),  # z
        )
    p = F.pad(xm, (1, 1, 1, 1))
    return ((p[1:-1, :-2], p[1:-1, 2:]), (p[:-2, 1:-1], p[2:, 1:-1]))  # x, y


def residual_ff(interior: torch.Tensor, coeffs, b_pair: Pair, x_pair: Pair) -> Pair:
    """(rh, rl) ≈ (bh + bl) − A·(xh + xl) to f32-pair precision, all ops f32.
    ``interior``: bool mask (2D or 3D); ``coeffs``: (cd, cx, cy[, cz])."""
    bh, bl = b_pair
    xh, xl = x_pair
    axis_cs = coeffs[1:]
    xm = torch.where(interior, xh, 0.0)
    mains, errs = [], []
    for (lo, hi), c in zip(_masked_shifts(xm), axis_cs):
        m, e = _axis_diff2(xm, lo, hi, c)
        mains.append(m)
        errs.append(e)
    # exact sum of the axis mains, its errors summed in order
    S, es = two_sum(mains[0], mains[1])
    for m in mains[2:]:
        S, e = two_sum(S, m)
        es = es + e
    # plain-f32 corrections: axis errors, then A·xl, then the diagonal gap
    apply = stencil_apply_3d if xh.ndim == 3 else stencil_apply
    corr = sum(errs) + apply(xl, interior, *coeffs)
    delta = coeff_delta(coeffs)
    if delta != 0.0:
        corr = corr + float(np.float32(delta)) * xm
    t1, e_t1 = two_sum(bh, -S)
    rl = ((bl - es) - corr) + e_t1
    rh, rl = two_sum(t1, rl)
    return torch.where(interior, rh, 0.0), torch.where(interior, rl, 0.0)

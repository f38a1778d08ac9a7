"""Masked 5-point (2D) and 7-point (3D) stencils in plain torch (counterpart
of iterative_solvers_tpu/ops/stencil.py).

This is the high-precision operator ``A_hi`` of the mixed-precision outer
loop: it runs in f64 (or f32) outside any kernel, exactly as the JAX package
computes it in XLA outside any Pallas kernel. The interior mask is rebuilt
from :class:`MaskSpec` on the field's device and cached there. The f32
7-point sum is evaluated in XLA's order (:func:`combine7`).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch.core.domain import MaskSpec, resolve_device


def stencil_apply(x: torch.Tensor, interior: torch.Tensor, cd: float, cx: float,
                  cy: float) -> torch.Tensor:
    """y = A @ x on a full 2D grid; ``interior`` is the bool mask of unknowns."""
    xm = torch.where(interior, x, 0.0)
    p = F.pad(xm, (1, 1, 1, 1))
    y = (
        cd * xm
        + cx * (p[1:-1, :-2] + p[1:-1, 2:])
        + cy * (p[:-2, 1:-1] + p[2:, 1:-1])
    )
    return torch.where(interior, y, 0.0)


def fma_f32(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)`` elementwise on f32 tensors: a·b + c rounded once
    to f32, as a fused multiply-add does (``a`` a coefficient, taken as
    f32). The product of two f32 values is exact in f64; the f64 sum is
    rounded to odd (TwoSum's error sets the last bit), so its rounding to
    f32 is the correctly rounded result, with no double rounding."""
    p = float(np.float32(a)) * b.double()
    c = c.double()
    s = p + c
    t = s - p
    e = (p - (s - t)) + (c - t)
    to_odd = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    away = torch.nextafter(s, torch.where(e > 0, math.inf, -math.inf).to(s.dtype))
    return torch.where(to_odd, away, s).float()


@functools.lru_cache(maxsize=None)
def _coeff_on(a: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(a, dtype=torch.float32, device=device)


def _fma_f32_cuda(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)`` on CUDA f32 tensors in one pass: the kernel of
    ``torch.addcmul`` computes ``c + 1·b·a``, which nvcc contracts into one
    ``fmaf(b, a, c)`` (``tests/test_torch_cuda.py`` and ``chip_smoke.py``
    hold it bit for bit against the exact emulation and S7's ``__fmaf_rn``
    chain). The coefficient stays on the card, made once per device."""
    return torch.addcmul(c, b, _coeff_on(float(a), b.device))


def combine7(xm, sx, sy, sz, cd: float, cx: float, cy: float, cz: float) -> torch.Tensor:
    """cd·xm + cx·sx + cy·sy + cz·sz from the centre and the neighbour sums
    per axis. In f32 in XLA's order, ``fma(cz, sz, fma(cy, sy, fma(cd, xm,
    cx·sx)))``, which the JAX package's CPU runs in its vectorised loop body
    and the 3D kernels write as the same ``fmaf`` chain
    (``csrc/zstream3d.cuh: apply7``), so the card and this plain version
    agree bit for bit. On the CPU each fma is emulated exactly
    (:func:`fma_f32`); on CUDA it is one ``addcmul`` pass, the cost of the
    plain sum. Other types sum left to right."""
    if xm.dtype == torch.float32:
        fma = _fma_f32_cuda if xm.is_cuda else fma_f32
        return fma(cz, sz, fma(cy, sy, fma(cd, xm, cx * sx)))
    return cd * xm + cx * sx + cy * sy + cz * sz


def stencil_apply_3d(x: torch.Tensor, interior: torch.Tensor, cd: float, cx: float,
                     cy: float, cz: float) -> torch.Tensor:
    """y = A @ x for the masked 7-point stencil on a full 3D grid."""
    xm = torch.where(interior, x, 0.0)
    p = F.pad(xm, (1, 1, 1, 1, 1, 1))
    y = combine7(
        xm,
        p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:],
        p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1],
        p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1],
        cd, cx, cy, cz,
    )
    return torch.where(interior, y, 0.0)


def mask_nnz(m: np.ndarray) -> int:
    """Stored-matrix-equivalent nonzero count of the masked stencil on the
    bool interior ``m``: the diagonal plus two entries per interior-interior
    neighbour link (the nnz of the reference's CSR assembly)."""
    total = int(m.sum())
    for ax in range(m.ndim):
        lo = tuple(slice(None, -1) if a == ax else slice(None) for a in range(m.ndim))
        hi = tuple(slice(1, None) if a == ax else slice(None) for a in range(m.ndim))
        total += 2 * int((m[lo] & m[hi]).sum())
    return total


class StencilOperator:
    """Callable ``y = A @ x`` over full-grid (or padded-canvas) fields;
    ``coeffs`` is (cd, cx, cy) in 2D and (cd, cx, cy, cz) in 3D."""

    def __init__(self, mask_spec: MaskSpec, coeffs: Tuple[float, ...]):
        self.mask_spec = mask_spec
        self.coeffs = tuple(float(c) for c in coeffs)
        self._masks: Dict[torch.device, torch.Tensor] = {}

    @staticmethod
    def from_domain(domain) -> "StencilOperator":
        coeffs = (domain.coeff_diag, domain.coeff_x, domain.coeff_y)
        if hasattr(domain, "nz"):
            coeffs += (domain.coeff_z,)
        return StencilOperator(domain.mask_spec, coeffs)

    def interior(self, device) -> torch.Tensor:
        device = torch.device(device)
        m = self._masks.get(device)
        if m is None:
            m = self._masks[device] = self.mask_spec.build(device).contiguous()
        return m

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        apply = stencil_apply_3d if len(self.coeffs) == 4 else stencil_apply
        return apply(x, self.interior(x.device), *self.coeffs)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.mask_spec.shape)

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.interior(x.device), x, 0.0)

    def diagonal(self, device="cuda", dtype=torch.float64) -> torch.Tensor:
        """The operator's diagonal as a field (0 off the interior)."""
        m = self.interior(resolve_device(device))
        return torch.where(m, self.coeffs[0], 0.0).to(dtype)

    def nnz(self) -> int:
        """Stored-matrix-equivalent nonzero count (:func:`mask_nnz`), built
        from the host mask."""
        return mask_nnz(self.mask_spec.build_host())

"""Masked 5-point (2D) and 7-point (3D) stencils in plain torch (counterpart
of iterative_solvers_tpu/ops/stencil.py).

This is the high-precision operator ``A_hi`` of the mixed-precision outer
loop: it runs in f64 (or f32) outside any kernel, exactly as the JAX package
computes it in XLA outside any Pallas kernel. The interior mask is rebuilt
from :class:`MaskSpec` on the field's device and cached there.
"""

from __future__ import annotations

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


def stencil_apply_3d(x: torch.Tensor, interior: torch.Tensor, cd: float, cx: float,
                     cy: float, cz: float) -> torch.Tensor:
    """y = A @ x for the masked 7-point stencil on a full 3D grid."""
    xm = torch.where(interior, x, 0.0)
    p = F.pad(xm, (1, 1, 1, 1, 1, 1))
    y = (
        cd * xm
        + cx * (p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])
        + cy * (p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1])
        + cz * (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1])
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

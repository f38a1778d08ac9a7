"""Full-grid fields and compacted unknown vectors (counterpart of
the JAX package's core/ordering.py).

The compacted order is row-major over the interior mask: the reference's
unknown numbering on square Г-grids (bottom strip first, then the upper
block, x innermost), and a well-defined order on any mask. Packing is one
gather, unpacking one scatter; both take numpy arrays or torch tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def interior_indices(domain) -> np.ndarray:
    """Flat full-grid indices of the interior nodes, in compacted order."""
    return np.flatnonzero(domain.interior.ravel())


def pack(field, domain):
    """Gather a full-grid field into the compacted unknown vector (a torch
    tensor through the domain's interior mask on its device, so no index
    array crosses to the card)."""
    if isinstance(field, torch.Tensor):
        return field[domain.interior_on(field.device)]
    return np.asarray(field)[domain.interior]


def unpack(vec, domain, fill=0.0):
    """Scatter a compacted unknown vector back onto the full grid."""
    if isinstance(vec, torch.Tensor):
        out = torch.full(domain.grid_shape, fill, dtype=vec.dtype, device=vec.device)
        out[domain.interior_on(vec.device)] = vec
        return out
    vec = np.asarray(vec)
    out = np.full(domain.grid_shape, fill, dtype=vec.dtype)
    out[domain.interior] = vec
    return out


def node_coordinates(domain) -> Tuple[np.ndarray, ...]:
    """Physical (x, y[, z]) coordinates of each unknown, compacted order:
    ``x0 + i·hx`` per axis, as the JAX package samples them."""
    axes = [(domain.x0, domain.nx, domain.hx), (domain.y0, domain.ny, domain.hy)]
    if hasattr(domain, "nz"):
        axes.append((domain.z0, domain.nz, domain.hz))
    idx = np.unravel_index(interior_indices(domain), domain.grid_shape)
    # field axes are ([z,] y, x): coordinate k lives on field axis nd - 1 - k
    nd = len(domain.grid_shape)
    return tuple(
        (o + np.arange(n + 1, dtype=np.float64) * np.float64(h))[idx[nd - 1 - k]]
        for k, (o, n, h) in enumerate(axes)
    )

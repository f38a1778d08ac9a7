"""Visualization (counterpart of the JAX package's viz.py) — functional
equivalents of the reference Qt GUI's views (SURVEY §2.3), rendered
headlessly with matplotlib:

- live/final convergence chart: log10 of (precision, residual, error) vs
  iteration (reference qt_gui/src/mainwindow.cpp:338-378)
- 2D scatter of solution / |error| / |residual| vs x-coordinate
  (mainwindow.cpp:447-634)
- error heatmap with colormap, min/max/avg stats and PNG export
  (mainwindow.cpp:1139-1298)
- Г-shaped 3D surface of the numeric / true / error fields
  (createGShapedSurface, mainwindow.cpp:1382-1701) — here a single
  masked-array surface instead of the reference's three-patch assembly.

matplotlib is imported inside :func:`_plt` only, so importing this module
(and the CLI) needs none; the plots work on host arrays only.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def convergence_plot(results, path: str, title: str = "Convergence") -> None:
    """log10 norms vs iteration from the recorded history
    (columns: iter, |dx|_inf, |r|_inf, |err|_inf, |r|_2)."""
    plt = _plt()
    hist = results.history if hasattr(results, "history") else np.asarray(results)
    if hist is None or len(hist) == 0:
        raise ValueError("no recorded history; solve with record_history=True")
    hist = np.asarray(hist, dtype=float)
    fig, ax = plt.subplots(figsize=(7, 4.5))
    labels = [None, r"precision $\|x_n-x_{n-1}\|_\infty$", r"residual $\|Ax-b\|_\infty$",
              r"error $\|x-u\|_\infty$", r"residual $\|r\|_2$"]
    for col in (1, 2, 3, 4):
        if hist.shape[1] > col:
            vals = hist[:, col]
            finite = np.isfinite(vals) & (vals > 0)
            if finite.any():
                ax.plot(hist[finite, 0], np.log10(vals[finite]), label=labels[col])
    ax.set_xlabel("iteration")
    ax.set_ylabel("log10(norm)")
    ax.set_title(title)
    ax.grid(alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def scatter_plot(results, path: str, quantity: str = "solution") -> None:
    """Scatter of a per-node quantity vs x (reference's 2D chart combo box)."""
    plt = _plt()
    data = {
        "solution": (results.solution, "numeric solution"),
        "error": (np.abs(results.error), "|error|"),
        "residual": (np.abs(results.residual), "|residual|"),
        "true_solution": (results.true_solution, "true solution"),
    }
    if quantity not in data:
        raise ValueError(f"unknown quantity {quantity!r} (use {sorted(data)})")
    vals, label = data[quantity]
    if np.asarray(vals).size == 0:
        raise ValueError(f"results carry no {quantity}")
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.scatter(results.x_coords, vals, s=6, alpha=0.6)
    ax.set_xlabel("x")
    ax.set_ylabel(label)
    ax.set_title(f"{label} vs x")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def _field_on_grid(results, domain, which: str) -> np.ndarray:
    from iterative_solvers_tpu_torch.core import ordering

    vec = {
        "solution": results.solution,
        "true_solution": results.true_solution,
        "error": results.error,
        "residual": results.residual,
    }[which]
    if np.asarray(vec).size == 0:
        raise ValueError(f"results carry no {which}")
    field = ordering.unpack(np.asarray(vec, np.float64), domain)
    return np.where(domain.interior, field, np.nan)


def _grid_coords(domain):
    """Full-grid coordinate arrays ``(X, Y)``, ``x0 + i·hx`` per axis."""
    x = domain.x0 + np.arange(domain.nx + 1, dtype=np.float64) * np.float64(domain.hx)
    y = domain.y0 + np.arange(domain.ny + 1, dtype=np.float64) * np.float64(domain.hy)
    return np.meshgrid(x, y)


def heatmap(results, domain, path: str, quantity: str = "error") -> dict:
    """Heatmap PNG of |quantity| on the domain; returns min/max/avg stats
    (reference's error-heatmap dialog, mainwindow.cpp:1139-1298)."""
    plt = _plt()
    field = np.abs(_field_on_grid(results, domain, quantity))
    vals = field[np.isfinite(field)]
    stats = {
        "min": float(vals.min()),
        "max": float(vals.max()),
        "avg": float(vals.mean()),
    }
    fig, ax = plt.subplots(figsize=(6.5, 5.5))
    extent = (domain.x0, domain.x1, domain.y0, domain.y1)
    im = ax.imshow(field, origin="lower", extent=extent, cmap="coolwarm", interpolation="nearest")
    fig.colorbar(im, ax=ax, label=f"|{quantity}|")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_title(
        f"|{quantity}|  min={stats['min']:.2e}  max={stats['max']:.2e}  avg={stats['avg']:.2e}"
    )
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return stats


def surface_3d(
    results,
    domain,
    path: str,
    which: Sequence[str] = ("solution", "true_solution", "error"),
) -> None:
    """Г-shaped surface(s) (reference's Q3DSurface view with the three
    series toggles). NaN masking handles the excluded quadrant without the
    reference's three-patch surface assembly."""
    plt = _plt()
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401

    X, Y = _grid_coords(domain)
    n = len(which)
    fig = plt.figure(figsize=(6 * n, 5))
    for i, w in enumerate(which):
        field = _field_on_grid(results, domain, w)
        ax = fig.add_subplot(1, n, i + 1, projection="3d")
        # matplotlib can't mask plot_surface by NaN cleanly -> zero + alpha mask
        masked = np.ma.masked_invalid(field)
        ax.plot_surface(X, Y, masked, cmap="viridis", linewidth=0, antialiased=False)
        ax.set_title(w)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)

"""Configuration system: one dataclass, loadable from JSON/TOML, usable from
the CLI and the API (counterpart of the JAX package's config.py).

The reference has no config at all — interactive stdin prompts in the CLI
(reference solver/main.cpp:610-614), widget state in the GUI
(qt_gui/src/mainwindow.cpp:194-208), compile-time constants for the rest
(domain bounds, solver/main.cpp:617-620). SURVEY §5 calls for a real config;
this is it.

- :class:`SolveConfig` captures everything a solve needs: grid, domain
  bounds, geometry, operator kind, stop criteria, preconditioner, precision
  mode, CG variant.
- ``SolveConfig.load(path)`` reads ``.json`` or ``.toml``;
  ``cfg.save(path)`` writes JSON. Unknown keys are rejected (typo safety).
- ``cfg.make_solver(device=...)`` builds a ready
  :class:`~iterative_solvers_tpu_torch.api.DirichletSolver` on ``device``
  (``"cuda"`` by default, raising without a card; ``"cpu"`` on request).
  The device is an argument, not a field, so a config file saved by either
  this package or the JAX package loads in the other unchanged.
- The CLI accepts ``--config FILE``; file values become flag defaults, and
  explicit command-line flags still win.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional

from iterative_solvers_tpu_torch.solvers.stopping import StopConfig


def _load_inside_mask(path: str):
    """Boolean full-grid "inside" array from .npy, or .npz under the key
    ``inside``/``mask`` (first array as a fallback)."""
    import numpy as np

    data = np.load(path)
    if hasattr(data, "files"):  # npz archive
        for key in ("inside", "mask"):
            if key in data.files:
                arr = data[key]
                break
        else:
            if not data.files:
                raise ValueError(f"{path}: empty npz archive")
            arr = data[data.files[0]]
    else:
        arr = data
    if arr.ndim != 2:
        raise ValueError(f"{path}: mask must be 2D, got shape {arr.shape}")
    return np.asarray(arr, dtype=bool)


@dataclass
class SolveConfig:
    """Declarative description of one Dirichlet-Poisson solve."""

    # grid / domain (reference defaults: 30x30 on [1,2]², GUI
    # qt_gui/src/mainwindow.cpp:112-117)
    nx: int = 30
    ny: int = 30
    nz: int = 0  # > 0 selects the 3D box problem
    x0: float = 1.0
    x1: float = 2.0
    y0: float = 1.0
    y1: float = 2.0
    z0: float = 0.0
    z1: float = 1.0
    shape: str = "gamma"  # gamma | rect
    # path to a boolean full-grid "inside" mask (.npy, or .npz with key
    # 'inside'/'mask'), shape (ny+1, nx+1); selects a custom 2D domain
    mask: Optional[str] = None

    # solver
    operator: str = "stencil"  # stencil | sparse | pallas | fused
    beta: str = "msg"  # msg | fr
    precond: Optional[str] = None  # jacobi | chebyshev[:m] | mg[:nu]
    precision: Optional[str] = None  # None | mixed
    dtype: Optional[str] = None  # f32 | f64 | None (f64; f32 for operator='pallas')
    # FMG warm-start polish V-cycles per level for precision='mixed'
    # (0 disables; 2-3 for sharp problems — tests/test_fmg.py)
    fmg_cycles: int = 1
    # mixed ladder's outer arithmetic: auto | f64 | ff (double-f32 pairs)
    outer: str = "auto"

    # stop criteria (eps <= 0 disables; reference dirichlet_solver.cpp:14-16)
    eps_precision: float = 1e-6
    eps_residual: float = 1e-6
    eps_error: float = -1.0
    eps_relative: float = -1.0
    max_iter: int = 10000

    def stop_config(self) -> StopConfig:
        return StopConfig(
            eps_precision=self.eps_precision,
            eps_residual=self.eps_residual,
            eps_exact_error=self.eps_error,
            eps_relative=self.eps_relative,
            max_iterations=self.max_iter,
        )

    def make_domain(self):
        from iterative_solvers_tpu_torch.core.domain import Domain2D, Domain3D

        if self.nz > 0:
            if self.mask:
                raise ValueError("mask files are 2D-only (the 3D problem is a box)")
            return Domain3D(
                nx=self.nx, ny=self.ny, nz=self.nz,
                x0=self.x0, x1=self.x1, y0=self.y0, y1=self.y1,
                z0=self.z0, z1=self.z1,
            )
        if self.mask:
            inside = _load_inside_mask(self.mask)
            if inside.shape != (self.ny + 1, self.nx + 1):
                raise ValueError(
                    f"mask {self.mask}: shape {inside.shape} != node grid "
                    f"({self.ny + 1}, {self.nx + 1}) for nx={self.nx}, "
                    f"ny={self.ny}"
                )
            return Domain2D(
                nx=self.nx, ny=self.ny,
                x0=self.x0, x1=self.x1, y0=self.y0, y1=self.y1,
                shape="custom", inside_fn=lambda ix, iy: inside[iy, ix],
            )
        return Domain2D(
            nx=self.nx, ny=self.ny,
            x0=self.x0, x1=self.x1, y0=self.y0, y1=self.y1,
            shape=self.shape,
        )

    def make_solver(self, mesh=None, device="cuda"):
        import torch

        from iterative_solvers_tpu_torch.api import DirichletSolver
        from iterative_solvers_tpu_torch.core.problem import PoissonProblem

        dtype = {"f32": torch.float32, "f64": torch.float64, None: None}[self.dtype]
        return DirichletSolver(
            problem=PoissonProblem.manufactured(self.make_domain()),
            operator=self.operator,
            dtype=dtype,
            stop=self.stop_config(),
            beta_kind=self.beta,
            preconditioner=self.precond,
            precision=self.precision,
            mesh=mesh,
            fmg_cycles=self.fmg_cycles,
            outer=self.outer,
            device=device,
        )

    # --- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SolveConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown config keys: {sorted(unknown)} (known: {sorted(known)})"
            )
        return cls(**d)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "SolveConfig":
        if path.endswith(".toml"):
            import tomllib

            with open(path, "rb") as f:
                return cls.from_dict(tomllib.load(f))
        with open(path) as f:
            return cls.from_dict(json.load(f))

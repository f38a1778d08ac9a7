"""Window entry ``padded3d``: the facade's route for a 3D solve with
``preconditioner="mg", precision="mixed"`` and no callback.

One padded 7-point operator and one multigrid hierarchy serve the whole
pool; each problem has its own right-hand side, assembled by the port, and
its own FMG payload. A solve is ``solvers.refine.device_refined_solve(
_padded_hi_operator(pop), pop, pop.pad(b), preconditioner=Mp, stop=...,
fmg=..., ff=...)``: the FMG warm start, then the double-f32 (or f64) outer
around plain f32 PCG on the 3D stencil with the fused 3D V-cycle. The
control is the port's own f32 path for the same parts: ``cg_solve`` on the
padded operator with the V-cycle (the facade's ``operator="pallas",
preconditioner="mg"``).
"""

from __future__ import annotations

import dataclasses

import torch


class Route:
    # what the cell's file has to state (checked when it is loaded)
    STATES = {"precision": "mixed", "preconditioner": "mg"}

    def __init__(self, cell, config, families, device):
        from iterative_solvers_tpu_torch import Domain3D, PoissonProblem, StopConfig
        from iterative_solvers_tpu_torch.kernels.stencil3d_layout import Padded3DStencilOperator
        from iterative_solvers_tpu_torch.solvers.multigrid import (
            MultigridPreconditioner,
            PaddedPreconditioner,
        )
        from iterative_solvers_tpu_torch.solvers.refine import _padded_hi_operator

        n, d = cell["n"], config["domain"]
        dom = Domain3D(n, n, n, x0=d["x0"], x1=d["x1"], y0=d["y0"], y1=d["y1"], z0=d["z0"],
                       z1=d["z1"])
        self.stop = StopConfig(**cell["stop"])
        self.fmg, self.ff = cell["fmg"], {"f64": False, "ff": True}[cell["outer"]]
        self.op = Padded3DStencilOperator.from_domain(dom)
        self.hi = _padded_hi_operator(self.op)
        self.mg = MultigridPreconditioner.from_domain(dom, device=device,
                                                      **cell.get("mg_options", {}))
        padded = PaddedPreconditioner(inner=self.mg, padded_op=self.op)
        problems = [PoissonProblem(dom, f=fam.f, u_exact=fam.u) for fam in families]
        self.M = [dataclasses.replace(padded, inner=self.mg.with_fmg(p)) for p in problems]
        self.b = [p.rhs_field(torch.float64, device) for p in problems]

    def solve(self, p, profiler=None):
        """Solve problem ``p`` from x = 0: (its answer on the grid, the result)."""
        from iterative_solvers_tpu_torch.solvers.refine import device_refined_solve

        res = device_refined_solve(self.hi, self.op, self.op.pad(self.b[p]),
                                   preconditioner=self.M[p], stop=self.stop, fmg=self.fmg,
                                   ff=self.ff, profiler=profiler)
        return self.op.crop(res.x), res

    def warmup(self):
        """One solve of each problem; their answers (the window's shapes)."""
        return [self.solve(p)[0] for p in range(len(self.b))]

    def control(self, p, reference):
        """Problem ``p``'s answer by the port's f32 path."""
        from iterative_solvers_tpu_torch import StopConfig
        from iterative_solvers_tpu_torch.solvers.cg import CGOptions, cg_solve

        stop = StopConfig(eps_precision=-1, eps_residual=-1, eps_relative=1e-6,
                          max_iterations=1000)
        res = cg_solve(self.op, self.op.pad(self.b[p].float()),
                       options=CGOptions(stop=stop, preconditioner=self.M[p]))
        return self.op.crop(res.x)

"""Window entry ``fused_ir``: the facade's route for a 2D solve with
``preconditioner="mg", precision="mixed"`` and no callback.

One padded operator and one multigrid hierarchy serve the whole pool; each
problem has its own right-hand side, assembled by the port, and its own FMG
payload (the coarse levels are rediscretised from its f). A solve is
``solvers.refine.fused_refined_solve(pop, Mp, b, stop=..., fmg=..., ff=...)``:
the FMG warm start, then the f64 (or double-f32) outer around the fused PCG
engine with the fused V-cycle. The control is the port's own f32 path for
the same parts: ``fused_cg_solve`` with the V-cycle (the facade's
``operator="fused", preconditioner="mg"``).
"""

from __future__ import annotations

import dataclasses

import torch


class Route:
    # what the cell's file has to state (checked when it is loaded)
    STATES = {"precision": "mixed", "preconditioner": "mg"}

    def __init__(self, cell, config, families, device):
        from iterative_solvers_tpu_torch import Domain2D, PoissonProblem, StopConfig
        from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
        from iterative_solvers_tpu_torch.solvers.multigrid import (
            MultigridPreconditioner,
            PaddedPreconditioner,
        )

        n, dom_cfg = cell["n"], config["domain"]
        dom = Domain2D(nx=n, ny=n, x0=dom_cfg["x0"], x1=dom_cfg["x1"], y0=dom_cfg["y0"],
                       y1=dom_cfg["y1"], shape=dom_cfg["kind"])
        self.stop = StopConfig(**cell["stop"])
        self.fmg, self.ff = cell["fmg"], {"f64": False, "ff": True}[cell["outer"]]
        self.op = PaddedStencilOperator.from_domain(dom)
        self.mg = MultigridPreconditioner.from_domain(dom, device=device,
                                                      **cell.get("mg_options", {}))
        padded = PaddedPreconditioner(inner=self.mg, padded_op=self.op)
        problems = [PoissonProblem(dom, f=fam.f, u_exact=fam.u) for fam in families]
        self.M = [dataclasses.replace(padded, inner=self.mg.with_fmg(p)) for p in problems]
        self.b = [p.rhs_field(torch.float64, device) for p in problems]

    def solve(self, p, profiler=None):
        """Solve problem ``p`` from x = 0: (its answer on the grid, the result)."""
        from iterative_solvers_tpu_torch.solvers.refine import fused_refined_solve

        res = fused_refined_solve(self.op, self.M[p], self.b[p], stop=self.stop, fmg=self.fmg,
                                  ff=self.ff, profiler=profiler)
        return res.x, res

    def warmup(self):
        """One solve of each problem; their answers (the window's shapes)."""
        return [self.solve(p)[0] for p in range(len(self.b))]

    def control(self, p, reference):
        """Problem ``p``'s answer by the port's f32 path."""
        from iterative_solvers_tpu_torch import StopConfig
        from iterative_solvers_tpu_torch.kernels.cg_fused import fused_cg_solve
        from iterative_solvers_tpu_torch.solvers.cg import CGOptions

        stop = StopConfig(eps_precision=-1, eps_residual=-1, eps_relative=1e-6,
                          max_iterations=1000)
        return fused_cg_solve(self.op, self.b[p], options=CGOptions(
            stop=stop, preconditioner=self.M[p])).x

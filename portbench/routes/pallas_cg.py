"""Window entry ``pallas_cg``: the facade's ``operator="pallas",
preconditioner="chebyshev:<degree>"`` route in f32 (``bench.py``'s
``precond`` race): ``solvers.cg.cg_solve(op, op.pad(b), options=CGOptions(
stop=..., preconditioner=ChebyshevPreconditioner.from_domain(op, dom,
degree)))`` on the padded operator (the stencil kernel A1). It bypasses
the multigrid, the FMG, the fused engine and the outer.

One operator and one preconditioner serve the pool; each problem has its
own f32 right-hand side, assembled by the port. The configuration states
f32, and the program has no lower path of its own, so the control is the
plain reference's Chebyshev-preconditioned CG in bfloat16, as many
iterations as the program took.
"""

from __future__ import annotations

import dataclasses

import torch


class Route:
    # what the cell's file has to state (checked when it is loaded)
    STATES = {"precision": "f32", "preconditioner": "chebyshev"}

    def __init__(self, cell, config, families, device):
        from iterative_solvers_tpu_torch import Domain2D, PoissonProblem, StopConfig
        from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
        from iterative_solvers_tpu_torch.solvers.precond import ChebyshevPreconditioner

        n, d = cell["n"], config["domain"]
        dom = Domain2D(nx=n, ny=n, x0=d["x0"], x1=d["x1"], y0=d["y0"], y1=d["y1"],
                       shape=d["kind"])
        self.cell, self.config, self.families, self.device = cell, config, families, device
        self.stop = StopConfig(**cell["stop"])
        self.op = PaddedStencilOperator.from_domain(dom)
        self.mg = None
        self.M = ChebyshevPreconditioner.from_domain(self.op, dom, degree=cell["degree"])
        problems = [PoissonProblem(dom, f=fam.f, u_exact=fam.u) for fam in families]
        self.b = [p.rhs_field(torch.float32, device) for p in problems]
        self.iterations = {}

    def _run(self, p, stop, profiler=None):
        from iterative_solvers_tpu_torch.solvers.cg import CGOptions, cg_solve

        res = cg_solve(self.op, self.op.pad(self.b[p]), options=CGOptions(
            stop=stop, preconditioner=self.M, profiler=profiler))
        return self.op.crop(res.x), res

    def solve(self, p, profiler=None):
        """Solve problem ``p`` from x = 0: (its answer on the grid, the result)."""
        x, res = self._run(p, self.stop, profiler)
        self.iterations[p] = res.iterations
        return x, res

    def warmup(self):
        """20 iterations of each problem (every shape the loop uses); their
        iterates."""
        short = dataclasses.replace(self.stop.disable_all_but_iterations(), max_iterations=20)
        return [self._run(p, short)[0] for p in range(len(self.b))]

    def control(self, p, reference):
        """Problem ``p``'s answer by the reference's bfloat16 Chebyshev CG,
        as many iterations as the program's solve took."""
        if p not in self.iterations:
            self.solve(p)
        return reference.chebyshev_cg(self.config["domain"], self.cell["n"], self.families[p],
                            torch.bfloat16, self.cell["degree"], self.iterations[p],
                            self.device)

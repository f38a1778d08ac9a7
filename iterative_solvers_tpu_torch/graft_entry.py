"""Driver entry points of the port: a single-card check and a multi-rank
dry run (the counterpart of the repository's ``__graft_entry__.py``, whose
steps they repeat with torch).

- :func:`entry` returns ``(fn, args)``: 16 plain CG iterations
  (``cg_run``) on the 256² Г-domain problem in f32, on the card.
- :func:`dryrun_rank` is the dry run's body on one rank of a running world
  (or alone, without one): the 32² problem on a near-square mesh of the
  world's ranks, MG-PCG (``cg_solve`` with every stop criterion live, at
  most 50 iterations) on the halo stencil with
  ``ShardedMultigridPreconditioner``, whose V-cycle runs on each rank's
  blocks. It asserts the iteration count is positive and returns the run's
  counts and the gathered solution.
- :func:`dryrun_multichip` starts an ``n``-rank world
  (``parallel.run_world``: one process a rank, ``gloo``) and runs the body
  on every rank.

``python -m iterative_solvers_tpu_torch.graft_entry [N] [--device cpu]``
runs both (N ranks, 4 by default).
"""

from __future__ import annotations

import sys

import torch

from iterative_solvers_tpu_torch.core.domain import Domain2D
from iterative_solvers_tpu_torch.core.problem import PoissonProblem


def entry(device="cuda"):
    """(fn, example_args): ``fn(b)`` runs 16 plain CG iterations on the
    256² Г-domain problem and returns (x, ‖r‖²)."""
    from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
    from iterative_solvers_tpu_torch.solvers.cg import cg_run

    dom = Domain2D(nx=256, ny=256)
    op = StencilOperator.from_domain(dom)
    b = PoissonProblem.manufactured(dom).rhs_field(torch.float32, device)

    def step(b_field):
        return cg_run(op, b_field, 16)

    return step, (b,)


def dryrun_rank(rank: int = 0, device="cuda") -> dict:
    """The dry run's MG-PCG solve on this rank of the world (all ranks
    call it together); plain Python and numpy results."""
    from iterative_solvers_tpu_torch.parallel import (
        crop_field,
        make_sharded_problem,
        make_solver_mesh,
    )
    from iterative_solvers_tpu_torch.solvers.cg import CGOptions, cg_solve
    from iterative_solvers_tpu_torch.solvers.multigrid import ShardedMultigridPreconditioner
    from iterative_solvers_tpu_torch.solvers.stopping import StopConfig

    mesh = make_solver_mesh()
    dom = Domain2D(nx=32, ny=32)
    op, b, u = make_sharded_problem(PoissonProblem.manufactured(dom), mesh, device=device)
    M = ShardedMultigridPreconditioner.from_domain(dom, mesh, device=device)
    res = cg_solve(op, b, u_true=u, options=CGOptions(
        stop=StopConfig(eps_precision=1e-6, eps_residual=1e-6, max_iterations=50),
        preconditioner=M))
    x = crop_field(mesh.gather(res.x), dom.grid_shape)
    assert tuple(x.shape) == dom.grid_shape
    assert res.iterations > 0
    return dict(mesh=tuple(zip(mesh.axis_names, mesh.shape)), reason=int(res.reason),
                iterations=int(res.iterations), residual_max=float(res.residual_max),
                x=x.cpu().numpy())


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 300.0) -> dict:
    """Run :func:`dryrun_rank` on ``n_devices`` local ranks; returns rank
    0's result (every rank's counts must agree)."""
    from iterative_solvers_tpu_torch.parallel import run_world

    ranks = run_world(dryrun_rank, n_devices, (device,), timeout=timeout)
    first = ranks[0]
    if any((r["reason"], r["iterations"]) != (first["reason"], first["iterations"])
           for r in ranks):
        raise AssertionError("the ranks disagree")
    print(f"dryrun_multichip OK: mesh={dict(first['mesh'])}, iters={first['iterations']}, "
          f"|r|_inf={first['residual_max']:.3e}")
    return first


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="The port's entry check and multi-rank dry run.")
    ap.add_argument("n", nargs="?", type=int, default=4, help="ranks of the dry run")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    x, r2 = fn(*fargs)
    print(f"entry OK: x {tuple(x.shape)}, |r|^2 {float(r2):.3e}")
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

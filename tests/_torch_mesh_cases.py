"""The port's side of the mesh parity tests, run on every rank of a
4-rank ``gloo`` world (``parallel.multihost.run_world``).

Imports torch, numpy and the port only (the ranks never import JAX). Each
world function runs all the cases of one test module and returns, on every
rank, a dict of case name -> plain Python / numpy results: gathered global
fields, counts, stop reasons and history columns. The tests compare rank
0's results with the JAX package on a mesh of the same shape (the virtual
CPU devices of the test process) and check that every rank agrees.
The inputs come from the seeded numpy generators below, which the tests
call too.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from iterative_solvers_tpu_torch import DirichletSolver, Domain2D, Domain3D, PoissonProblem
from iterative_solvers_tpu_torch import StopConfig
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
from iterative_solvers_tpu_torch.parallel import (
    ShardedPallas3DStencilOperator,
    ShardedPallasStencilOperator,
    ShardedStencilOperator,
    crop_field,
    gather_field,
    make_hybrid_mesh,
    make_sharded_problem,
    make_solver_mesh,
    shard_field,
)
from iterative_solvers_tpu_torch.parallel.cg_fused_sharded import (
    ShardedFusedCGEngine,
    sharded_fused_cg_solve,
)
from iterative_solvers_tpu_torch.parallel.mg_sharded import ShardedFusedMultigrid
from iterative_solvers_tpu_torch.solvers.cg import CGOptions, cg_solve
from iterative_solvers_tpu_torch.solvers.multigrid import (
    MultigridPreconditioner,
    ShardedMultigridPreconditioner,
)
from iterative_solvers_tpu_torch.solvers.precond import make_preconditioner
from iterative_solvers_tpu_torch.solvers.refine import device_refined_solve, engine_refined_solve

CPU = "cpu"
MESHES = [(2, 2), (4, 1), (1, 4)]
BOX = dict(nx=18, ny=14, nz=22)


def noise(shape, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def masked_noise(interior, seed=0):
    r = np.random.default_rng(seed).standard_normal(interior.shape)
    return np.where(interior, r, 0).astype(np.float32)


def _mesh(shape):
    if len(shape) == 3:
        return make_hybrid_mesh(n_slices=shape[0], ici_shape=shape[1:])
    return make_solver_mesh(4, shape)


def _np(t):
    return t.detach().cpu().numpy()


def _res(res):
    """The comparable part of a CG or refinement result."""
    hist = None if res.history is None else np.asarray(res.history)
    return dict(reason=int(res.reason), converged=bool(res.converged),
                iterations=int(res.iterations),
                outers=int(getattr(res, "outer_iterations", 0)), history=hist)


# --- the launcher's failure modes (tests/test_torch_mesh_kernels.py) ----------


def sleeping_rank(rank: int, seconds: float) -> None:
    """A rank that hangs past the world's deadline."""
    time.sleep(seconds)


def raising_rank(rank: int) -> int:
    """Rank 1 raises; rank 0 returns and then waits for it at the barrier."""
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


# --- world 1: the operators and the CG (tests/test_torch_mesh.py) -------------


def world_operators(rank: int) -> dict:
    out = {}
    for shape in MESHES:
        mesh = _mesh(shape)
        dom = Domain2D(nx=30, ny=30)
        x = noise(dom.grid_shape)
        op = ShardedStencilOperator.from_domain(dom, mesh)
        y = gather_field(op(shard_field(torch.from_numpy(x), mesh)), mesh)
        out[("halo", shape)] = _np(crop_field(y, dom.grid_shape))
        for nx, ny, kind in ((30, 30, "gamma"), (46, 38, "rect")):
            d = Domain2D(nx=nx, ny=ny, shape=kind)
            pop = ShardedPallasStencilOperator.from_domain(d, mesh, block_rows=8)
            xx = torch.from_numpy(noise(d.grid_shape))
            out[("pallas", shape, kind)] = _np(pop.crop(mesh.gather(pop(pop.shard(xx)))))
    hybrid = _mesh((2, 1, 2))
    dom = Domain2D(nx=30, ny=30)
    pop = ShardedPallasStencilOperator.from_domain(dom, hybrid, block_rows=8)
    out["hybrid"] = _np(pop.crop(hybrid.gather(pop(pop.shard(torch.from_numpy(noise(dom.grid_shape, 1)))))))

    mesh = _mesh((2, 2))
    dom = Domain2D(nx=64, ny=64)
    x32 = torch.from_numpy(noise(dom.grid_shape, 3, np.float32))
    pop = ShardedPallasStencilOperator.from_domain(dom, mesh, block_rows=8)
    out["pallas_f32"] = _np(pop.crop(mesh.gather(pop(pop.shard(x32)))))
    box = Domain3D(**BOX)
    x3 = torch.from_numpy(noise(box.grid_shape))
    h3 = ShardedStencilOperator.from_domain(box, mesh)
    out["halo3d"] = _np(crop_field(mesh.gather(h3(shard_field(x3, mesh))), box.grid_shape))
    for shape in ((2, 2), (1, 4)):
        m = _mesh(shape)
        op3 = ShardedPallas3DStencilOperator.from_domain(box, m, block_rows=8)
        out[("pallas3d", shape)] = _np(op3.crop(m.gather(op3(op3.shard(x3)))))
    x3f = torch.from_numpy(noise(box.grid_shape, 4, np.float32))
    op3 = ShardedPallas3DStencilOperator.from_domain(box, mesh, block_rows=8)
    out["pallas3d_f32"] = _np(op3.crop(mesh.gather(op3(op3.shard(x3f)))))

    # CG on the halo stencil and on the block kernel (f64), reference stop
    dom = Domain2D(nx=30, ny=30)
    prob = PoissonProblem.manufactured(dom)
    stop = StopConfig(eps_precision=-1, eps_residual=1e-6, max_iterations=5000)
    op, b, u = make_sharded_problem(prob, _mesh((4, 1)), device=CPU)
    res = cg_solve(op, b, u_true=u, options=CGOptions(stop=stop))
    out["cg_halo"] = dict(_res(res), x=_np(crop_field(op.mesh.gather(res.x), dom.grid_shape)),
                          err=res.error_max)
    pop = ShardedPallasStencilOperator.from_domain(dom, mesh, block_rows=8)
    res = cg_solve(pop, pop.shard(prob.rhs_field(device=CPU)),
                   u_true=pop.shard(prob.true_solution_field(device=CPU)),
                   options=CGOptions(stop=stop))
    out["cg_pallas"] = dict(_res(res), x=_np(pop.crop(mesh.gather(res.x))))
    dom = Domain2D(nx=24, ny=24)
    prob = PoissonProblem.manufactured(dom)
    stop8 = StopConfig(eps_precision=-1, eps_residual=1e-8, max_iterations=5000)
    for shape in ((4, 1), (1, 4)):
        op, b, u = make_sharded_problem(prob, _mesh(shape), device=CPU)
        res = cg_solve(op, b, u_true=u, options=CGOptions(stop=stop8))
        out[("invariance", shape)] = dict(
            _res(res), x=_np(crop_field(op.mesh.gather(res.x), dom.grid_shape)))
    # MG-PCG with the plain V-cycle on the gathered field (f32)
    dom = Domain2D(nx=64, ny=64)
    prob = PoissonProblem.manufactured(dom)
    op, b, u = make_sharded_problem(prob, mesh, torch.float32, device=CPU)
    M = ShardedMultigridPreconditioner.from_domain(dom, mesh, device=CPU)
    stop4 = StopConfig(eps_precision=-1, eps_residual=1e-4, max_iterations=100)
    res = cg_solve(op, b, u_true=u, options=CGOptions(stop=stop4, preconditioner=M))
    out["mg_pcg"] = dict(_res(res), x=_np(crop_field(mesh.gather(res.x), dom.grid_shape)))
    return out


# --- world 2: the shard-fused V-cycle, the fast path and the facade -----------


def _fused(dom, mesh, block_rows=16, fuse_min_extent=33):
    op = ShardedPallasStencilOperator.from_domain(dom, mesh, block_rows=block_rows)
    M = ShardedFusedMultigrid.from_operator(op, dom, fuse_min_extent=fuse_min_extent,
                                            device=CPU)
    return op, M


def world_multigrid(rank: int) -> dict:
    out = {}
    for shape in MESHES + [(2, 1, 2)]:
        mesh = _mesh(shape)
        for kind in ("gamma", "rect"):
            if len(shape) == 3 and kind == "rect":
                continue
            dom = Domain2D(nx=64, ny=64, shape=kind)
            op, M = _fused(dom, mesh)
            r = torch.from_numpy(masked_noise(dom.interior))
            z = M(op.shard(r))
            w, rz = M.call_with_dot(op.shard(r))
            single = MultigridPreconditioner.from_domain(dom, fuse=True, fuse_min_extent=33,
                                                         device=CPU)
            out[("vcycle", shape, kind)] = dict(
                levels=len(M.levels), z=_np(op.crop(mesh.gather(z))),
                w_equal=bool(torch.equal(w, z)), rz=float(rz),
                single=_np(single(r)))
    mesh = _mesh((2, 2))
    dom = Domain2D(nx=128, ny=128)
    op, M = _fused(dom, mesh, block_rows=32)
    uu = op.shard(torch.from_numpy(masked_noise(dom.interior, 1)))
    vv = op.shard(torch.from_numpy(masked_noise(dom.interior, 2)))
    r = torch.from_numpy(masked_noise(dom.interior))
    out["two_levels"] = dict(
        levels=len(M.levels), z=_np(op.crop(mesh.gather(M(op.shard(r))))),
        d1=float(mesh.gather(uu * M(vv)).sum()), d2=float(mesh.gather(vv * M(uu)).sum()))

    dom = Domain2D(nx=64, ny=64)
    prob = PoissonProblem.manufactured(dom)
    op, M = _fused(dom, mesh)
    Mf = M.with_fmg(prob)
    b = op.shard(prob.rhs_field(torch.float32, CPU))
    out["fmg"] = dict(mono=_np(op.crop(mesh.gather(Mf.fmg(b)))),
                      step=_np(op.crop(mesh.gather(Mf.fmg_stepwise(b)))),
                      smooth=_np(op.crop(mesh.gather(
                          Mf.fmg_stepwise(b, polish_max_extent=32, smooth_sweeps=4)))))
    stop4 = StopConfig(eps_precision=-1, eps_residual=1e-4, max_iterations=100)
    res = cg_solve(op, b, options=CGOptions(stop=stop4, preconditioner=M))
    out["fused_pcg"] = dict(_res(res), x=_np(op.crop(mesh.gather(res.x))))

    # the sharded fast path: f64 halo twin outside, D1 + shard-fused V-cycle
    # with the FMG warm start inside
    A_hi = ShardedStencilOperator(mesh, op.coeffs, op.grid_shape, op.padded_shape,
                                  op.mask_mode, (dom.nx, dom.ny))
    rel8 = StopConfig(eps_precision=-1, eps_residual=-1, eps_exact_error=-1, eps_relative=1e-8,
                      max_iterations=10000)
    b64 = op.shard(prob.rhs_field(torch.float64, CPU))
    res = device_refined_solve(A_hi, op, b64, preconditioner=Mf, stop=rel8, fmg=True)
    out["fast_path"] = dict(_res(res), x=_np(op.crop(mesh.gather(res.x))),
                            rel=res.residual_norm / res.initial_residual_norm)
    res = device_refined_solve(A_hi, op, b64, preconditioner=M, stop=rel8)
    out["fast_path_cold"] = _res(res)

    # the facade's mesh routes
    facade = {}
    for key, kw in FACADE.items():
        calls = []
        s = DirichletSolver(mesh=mesh, device=CPU, **kw)
        # the mixed routes with a callback: the host ladder, as the JAX
        # facade runs it on a CPU
        cb = (lambda *a: calls.append(a[0])) if kw.get("precision") == "mixed" else None
        r = s.solve(callback=cb)
        facade[key] = dict(reason=int(r.stop_reason), iterations=r.iterations,
                           solution=r.solution, residual_norm=r.residual_norm,
                           history=np.asarray(r.history), calls=calls)
    out["facade"] = facade
    dev = DirichletSolver(nx=64, ny=64, preconditioner="mg", precision="mixed",
                          mesh=mesh, device=CPU,
                          stop=StopConfig(eps_precision=-1, eps_residual=1e-6))
    r = dev.solve()
    out["facade_device_ladder"] = dict(reason=int(r.stop_reason), iterations=r.iterations,
                                       residual_norm=r.residual_norm)
    return out


_S3 = dict(eps_precision=-1, eps_residual=1e-3, max_iterations=50)
_S6 = dict(eps_precision=-1, eps_residual=1e-6, max_iterations=10000)


def _facade_cases():
    d3 = dict(nx=16, ny=16, nz=16)
    return {
        "pallas_mg": dict(nx=64, ny=64, operator="pallas", preconditioner="mg",
                          stop=StopConfig(**_S3)),
        "stencil_mg": dict(nx=64, ny=64, preconditioner="mg", stop=StopConfig(**_S3)),
        "pallas_jacobi": dict(nx=32, ny=32, operator="pallas", preconditioner="jacobi",
                              stop=StopConfig(eps_precision=-1, eps_residual=1e-4,
                                              max_iterations=3000)),
        "pallas_cheb": dict(nx=32, ny=32, operator="pallas", preconditioner="chebyshev:8",
                            stop=StopConfig(eps_precision=-1, eps_residual=1e-4,
                                            max_iterations=3000)),
        "stencil_mixed_mg": dict(nx=64, ny=64, preconditioner="mg", precision="mixed",
                                 stop=StopConfig(**_S6)),
        "pallas_mixed_mg": dict(nx=64, ny=64, operator="pallas", preconditioner="mg",
                                precision="mixed", stop=StopConfig(**_S6)),
        "pallas_3d": dict(domain=Domain3D(**d3), operator="pallas",
                          stop=StopConfig(eps_precision=-1, eps_residual=1e-4,
                                          max_iterations=3000)),
        "pallas_3d_mixed_mg": dict(domain=Domain3D(**d3), operator="pallas",
                                   preconditioner="mg", precision="mixed",
                                   stop=StopConfig(eps_precision=-1, eps_residual=1e-7)),
    }


FACADE = _facade_cases()


# --- world 3: the sharded fused engine (tests/test_torch_mesh_engine.py) ------

REL8 = dict(eps_precision=-1, eps_residual=-1, eps_exact_error=-1, eps_relative=1e-8,
            max_iterations=10000)


def _engine_facade_cases():
    """The facade's engine routes: ``fused`` (MSG CG, PCG with the
    shard-fused V-cycle) at the default stop, and the engine ladder
    (``fused`` or ``pallas`` with ``mg`` and ``mixed``, no callback) to rel
    1e-8."""
    mixed = dict(preconditioner="mg", precision="mixed", stop=StopConfig(**REL8))
    return {
        "fused": dict(operator="fused"),
        "fused_mg": dict(operator="fused", preconditioner="mg"),
        "fused_mg_mixed": dict(mixed, operator="fused"),
        "pallas_mg_mixed": dict(mixed, operator="pallas"),
    }


ENGINE_FACADE = _engine_facade_cases()


def world_engine(rank: int) -> dict:
    """sharded_fused_cg_solve (MSG; PCG with the shard-fused V-cycle, and
    with Jacobi, whose (r, M r) the engine all-reduces itself) and
    engine_refined_solve (cold; warm with the FMG) at 64² on every mesh
    shape, the facade's engine routes on (2, 2)."""
    out = {}
    dom = Domain2D(nx=64, ny=64)
    prob = PoissonProblem.manufactured(dom)
    b32, u32 = prob.rhs_field(torch.float32, CPU), prob.true_solution_field(torch.float32, CPU)
    b64 = prob.rhs_field(torch.float64, CPU)
    for shape in MESHES:
        mesh = _mesh(shape)
        op, M = _fused(dom, mesh)
        jacobi = make_preconditioner("jacobi", op, dom, device=CPU)  # no call_with_dot
        for kind, pc in (("msg", None), ("pcg", M), ("jacobi", jacobi)):
            res = sharded_fused_cg_solve(op, b32, u_true=u32, options=CGOptions(preconditioner=pc))
            out[(kind, shape)] = dict(_res(res), x=_np(res.x), levels=len(M.levels))
        engine = ShardedFusedCGEngine(op, M.with_fmg(prob))
        for fmg in (False, True):
            res = engine_refined_solve(engine, DirichletSolver._hi_operator(op), op.shard(b64),
                                       stop=StopConfig(**REL8), fmg=fmg)
            out[("ladder", shape, fmg)] = dict(
                _res(res), x=_np(op.crop(mesh.gather(res.x))),
                rel=res.residual_norm / res.initial_residual_norm)
    mesh = _mesh((2, 2))
    for key, kw in ENGINE_FACADE.items():
        r = DirichletSolver(nx=64, ny=64, mesh=mesh, device=CPU, **kw).solve()
        out[("facade", key)] = dict(reason=int(r.stop_reason), iterations=r.iterations,
                                    outers=r.outer_iterations, solution=r.solution,
                                    residual_norm=r.residual_norm)
    return out

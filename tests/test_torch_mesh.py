"""CPU parity of the port's mesh operators and mesh CG against the JAX
package (ROADMAP item 14a): the halo stencil (2D, 3D), the block stencil
kernels D1 and D2 through their plain versions, the hybrid mesh, and CG and
MG-PCG over a mesh.

The port's side runs once per module, in one 4-rank ``gloo`` world
(``parallel.multihost.run_world``, with its deadline) that runs every case
(``tests/_torch_mesh_cases.py``); each test reads its case. The JAX side
runs here, on a mesh of the same shape over 4 of the virtual CPU devices,
its Pallas kernels in interpret mode. A sharded JAX operator costs 5-12 s
of compilation per mesh and shape, so the 2D operators are held against
their JAX counterparts on the (2, 2) mesh, and the other meshes and the 3D
operators against the local JAX operator (to which the JAX package's own
tests hold its sharded operators, at the same tolerance); D2's block
kernel is held against JAX's in tests/test_torch_mesh_kernels.py.
Tolerances:

- f64 operators: the JAX operators add their halo terms after the bulk sum,
  the port's take the single-device expression: 1e-13 (1e-12 on the
  kernels, as the JAX tests) relative to max|y|; the port's gathered apply
  equals its own single-device operator bit for bit.
- f32 operators: 64 eps32 · max|y| (contracted and reassociated products).
- CG: the same stop reason and iteration count as JAX on the same mesh
  shape (f64: reduction order only), x within 1e-9 (f64) or 5e-5 (f32).
- The graft entry (``graft_entry.py``): its dry run's MG-PCG as the JAX
  dry run's on (2, 2) (the CG's tolerances), its 16 f32 CG iterations at
  256² against the JAX entry's to 1e-4 of max|x| (reduction order over 66k
  nodes, 16 times).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.core.domain import Domain3D as JDomain3D
from iterative_solvers_tpu.core.problem import PoissonProblem as JProblem
from iterative_solvers_tpu.ops.stencil import StencilOperator as JStencil
from iterative_solvers_tpu.parallel import ShardedPallasStencilOperator as JPallas
from iterative_solvers_tpu.parallel import ShardedStencilOperator as JHalo
from iterative_solvers_tpu.parallel import make_sharded_problem as j_sharded_problem
from iterative_solvers_tpu.parallel import make_solver_mesh as j_mesh
from iterative_solvers_tpu.parallel import crop_field as j_crop
from iterative_solvers_tpu.parallel import shard_field as j_shard
from iterative_solvers_tpu.solvers.cg import CGOptions as JCGOptions
from iterative_solvers_tpu.solvers.cg import cg_solve as j_cg_solve
from iterative_solvers_tpu.solvers.multigrid import ShardedMultigridPreconditioner as JShardedMG
from iterative_solvers_tpu.solvers.stopping import StopConfig as JStop

from _torch_mesh_cases import BOX, MESHES, noise, world_operators
from iterative_solvers_tpu_torch import Domain2D, Domain3D
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
from iterative_solvers_tpu_torch.parallel import run_world
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def world():
    """Every rank's results of the module's cases (one world, 4 ranks)."""
    return run_world(world_operators, 4, timeout=240)


def jmesh(shape):
    devs = jax.devices()[:4]
    if len(shape) == 3:
        return Mesh(np.asarray(devs).reshape(shape), ("slice", "y", "x"))
    return j_mesh(4, shape, devices=devs)


def _rel_close(got, ref, rel):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _jax_local(jd, x):
    return np.asarray(JStencil.from_domain(jd)(jnp.asarray(x)))


def _local(dom, x):
    return StencilOperator.from_domain(dom)(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("shape", MESHES)
def test_halo_operator_matches_jax(world, shape):
    dom, jd = Domain2D(nx=30, ny=30), JDomain2D(nx=30, ny=30)
    x = noise(dom.grid_shape)
    if shape == (2, 2):
        m = jmesh(shape)
        ref = np.asarray(j_crop(JHalo.from_domain(jd, m)(j_shard(x, m)), jd.grid_shape))
    else:
        ref = _jax_local(jd, x)
    got = world[0][("halo", shape)]
    _rel_close(got, ref, 1e-13)
    np.testing.assert_array_equal(got, _local(dom, x))


@pytest.mark.parametrize("kind", ["gamma", "rect"])
@pytest.mark.parametrize("shape", MESHES)
def test_pallas_operator_matches_jax(world, shape, kind):
    nx, ny = (30, 30) if kind == "gamma" else (46, 38)
    dom, jd = Domain2D(nx=nx, ny=ny, shape=kind), JDomain2D(nx=nx, ny=ny, shape=kind)
    x = noise(dom.grid_shape)
    if (shape, kind) == ((2, 2), "gamma"):
        jop = JPallas.from_domain(jd, jmesh(shape), block_rows=8)
        ref = np.asarray(jop.crop(jop(jop.shard(x))))
    else:
        ref = _jax_local(jd, x)
    got = world[0][("pallas", shape, kind)]
    _rel_close(got, ref, 1e-12)
    np.testing.assert_array_equal(got, _local(dom, x))


def test_pallas_operator_hybrid_mesh(world):
    """The (slice, y, x) mesh: rows over ('slice', 'y') combined."""
    dom, jd = Domain2D(nx=30, ny=30), JDomain2D(nx=30, ny=30)
    x = noise(dom.grid_shape, 1)
    got = world[0]["hybrid"]
    _rel_close(got, _jax_local(jd, x), 1e-12)
    np.testing.assert_array_equal(got, _local(dom, x))


def test_pallas_operator_f32_matches_jax(world):
    dom, jd = Domain2D(nx=64, ny=64), JDomain2D(nx=64, ny=64)
    x = noise(dom.grid_shape, 3, np.float32)
    got = world[0]["pallas_f32"]
    assert got.dtype == np.float32
    _rel_close(got, _jax_local(jd, x), 64 * EPS32)
    np.testing.assert_array_equal(got, _local(dom, x))


def test_halo_3d_matches_jax(world):
    box, jbox = Domain3D(**BOX), JDomain3D(**BOX)
    x = noise(box.grid_shape)
    ref = _jax_local(jbox, x)
    got = world[0]["halo3d"]
    _rel_close(got, ref, 1e-13)
    np.testing.assert_array_equal(got, _local(box, x))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_pallas_3d_matches_jax(world, shape):
    box, jbox = Domain3D(**BOX), JDomain3D(**BOX)
    x = noise(box.grid_shape)
    ref = _jax_local(jbox, x)
    got = world[0][("pallas3d", shape)]
    _rel_close(got, ref, 1e-11)
    np.testing.assert_array_equal(got, _local(box, x))


def test_pallas_3d_f32_matches_jax(world):
    box, jbox = Domain3D(**BOX), JDomain3D(**BOX)
    x = noise(box.grid_shape, 4, np.float32)
    got = world[0]["pallas3d_f32"]
    _rel_close(got, _jax_local(jbox, x), 64 * EPS32)
    np.testing.assert_array_equal(got, _local(box, x))  # combine7, S7's order


def _same_run(got, ref):
    assert (got["reason"], got["converged"], got["iterations"]) == (
        int(ref.reason), bool(ref.converged), int(ref.iterations))


def test_sharded_cg_matches_jax(world):
    """test_distributed.py's sharded CG, on (4, 1)."""
    jd = JDomain2D(nx=30, ny=30)
    stop = JStop(eps_precision=-1, eps_residual=1e-6, max_iterations=5000)
    op, b, u = j_sharded_problem(JProblem.manufactured(jd), jmesh((4, 1)))
    ref = j_cg_solve(op, b, u_true=u, options=JCGOptions(stop=stop))
    got = world[0]["cg_halo"]
    _same_run(got, ref)
    np.testing.assert_allclose(got["x"], np.asarray(j_crop(ref.x, jd.grid_shape)), atol=1e-10)
    assert abs(got["err"] - ref.error_max) < 1e-10


def test_sharded_pallas_cg_matches_jax(world):
    jd = JDomain2D(nx=30, ny=30)
    prob = JProblem.manufactured(jd)
    stop = JStop(eps_precision=-1, eps_residual=1e-6, max_iterations=5000)
    op = JPallas.from_domain(jd, jmesh((2, 2)), block_rows=8)
    ref = j_cg_solve(op, op.shard(prob.rhs_field()), u_true=op.shard(prob.true_solution_field()),
                     options=JCGOptions(stop=stop))
    got = world[0]["cg_pallas"]
    _same_run(got, ref)
    np.testing.assert_allclose(got["x"], np.asarray(op.crop(ref.x)), atol=1e-9)


@pytest.mark.parametrize("shape", [(4, 1), (1, 4)])
def test_partition_invariance(world, shape):
    jd = JDomain2D(nx=24, ny=24)
    prob = JProblem.manufactured(jd)
    stop = JStop(eps_precision=-1, eps_residual=1e-8, max_iterations=5000)
    ref = j_cg_solve(JStencil.from_domain(jd), prob.rhs_field(), options=JCGOptions(stop=stop))
    got = world[0][("invariance", shape)]
    np.testing.assert_allclose(got["x"], np.asarray(ref.x), rtol=1e-9, atol=1e-9)
    assert got["iterations"] == ref.iterations


def test_sharded_multigrid_pcg_matches_jax(world):
    """test_distributed.py's MG-PCG through the gathered plain V-cycle (f32)."""
    jd = JDomain2D(nx=64, ny=64)
    m = jmesh((2, 2))
    op, b, u = j_sharded_problem(JProblem.manufactured(jd), m, jnp.float32)
    stop = JStop(eps_precision=-1, eps_residual=1e-4, max_iterations=100)
    ref = j_cg_solve(op, b, u_true=u, options=JCGOptions(
        stop=stop, preconditioner=JShardedMG.from_domain(jd, m)))
    got = world[0]["mg_pcg"]
    _same_run(got, ref)
    assert got["converged"] and got["iterations"] <= 15
    np.testing.assert_allclose(got["x"], np.asarray(j_crop(ref.x, jd.grid_shape)), atol=5e-5)


def test_graft_dryrun_matches_jax(world):
    """``graft_entry.dryrun_rank`` in this world: the JAX dry run's solve
    (``__graft_entry__.dryrun_multichip``: 32², ShardedMultigridPreconditioner,
    cg_solve to at most 50 iterations) on the (2, 2) mesh."""
    jd = JDomain2D(nx=32, ny=32)
    m = jmesh((2, 2))
    op, b, u = j_sharded_problem(JProblem.manufactured(jd), m)
    stop = JStop(eps_precision=1e-6, eps_residual=1e-6, max_iterations=50)
    ref = j_cg_solve(op, b, u_true=u, options=JCGOptions(
        stop=stop, preconditioner=JShardedMG.from_domain(jd, m)))
    got = world[0]["dryrun"]
    assert dict(got["mesh"]) == {"y": 2, "x": 2} and got["iterations"] > 0
    assert (got["reason"], got["iterations"]) == (int(ref.reason), int(ref.iterations))
    np.testing.assert_allclose(got["x"], np.asarray(j_crop(ref.x, jd.grid_shape)), atol=1e-9)


def test_graft_entry_matches_jax():
    """``graft_entry.entry`` (on the CPU): 16 plain CG iterations at 256²,
    as the JAX entry's jitted step."""
    import __graft_entry__ as jax_entry

    from iterative_solvers_tpu_torch.graft_entry import entry

    fn, args = entry(device="cpu")
    x, r2 = fn(*args)
    jfn, jargs = jax_entry.entry()
    jx, jr2 = jax.jit(jfn)(*jargs)
    assert x.dtype == torch.float32 and tuple(x.shape) == (257, 257)
    _rel_close(x.numpy(), np.asarray(jx), 1e-4)
    assert abs(float(r2) - float(jr2)) <= 1e-3 * float(jr2)


def test_every_rank_returns_the_same_results(world):
    """Every stop decision is taken from all-reduced scalars, and the
    gathered fields are the same on every rank."""
    ref = world[0]
    for other in world[1:]:
        assert other.keys() == ref.keys()
        for key, val in ref.items():
            got = other[key]
            if isinstance(val, dict):
                for k, v in val.items():
                    np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v))
            else:
                np.testing.assert_array_equal(got, val)

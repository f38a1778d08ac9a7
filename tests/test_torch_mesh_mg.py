"""CPU parity of the port's shard-fused V-cycle (D3, D4), the mesh FMG, the
sharded fast path and the facade's mesh routes against the JAX package
(ROADMAP item 14b).

The port's side runs once per module in one 4-rank ``gloo`` world
(``tests/_torch_mesh_cases.py: world_multigrid``, with its deadline). The
JAX side runs here on 4 virtual CPU devices. A JAX sharded Pallas program
in interpret mode costs 10-40 s of compilation per mesh, shape and route,
so the sharded fast path (which runs JAX's shard-fused V-cycle) is held
against JAX's on the (2, 2) mesh; the V-cycles against the port's
single-device fused V-cycle (bit for bit: the block legs take its
arithmetic at every node) and JAX's V-cycle, to which the JAX package's
own tests hold its shard-fused one; the facade routes against the JAX
facade's counts (see that test). Tolerances:

- V-cycle and FMG fields (f32): 1e-5 of max|z|, as the JAX tests; the fused
  (r, M r) dot to 1e-5 relative.
- The fast path: JAX's stop reason, outer and inner counts and history
  inner column exactly.
- Facade routes: JAX's stop reason and iteration count (the host ladder's
  callbacks at the same inner counts), the solution to 1e-4 (the JAX mesh
  tests' tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iterative_solvers_tpu.api import DirichletSolver as JSolver
from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.core.domain import Domain3D as JDomain3D
from iterative_solvers_tpu.core.problem import PoissonProblem as JProblem
from iterative_solvers_tpu.parallel import ShardedPallasStencilOperator as JPallas
from iterative_solvers_tpu.parallel import make_solver_mesh as j_mesh
from iterative_solvers_tpu.parallel.halo import ShardedStencilOperator as JHalo
from iterative_solvers_tpu.parallel.mg_sharded import ShardedFusedMultigrid as JFusedMG
from iterative_solvers_tpu.solvers.cg import CGOptions as JCGOptions
from iterative_solvers_tpu.solvers.cg import cg_solve as j_cg_solve
from iterative_solvers_tpu.ops.stencil import StencilOperator as JStencil
from iterative_solvers_tpu.solvers.multigrid import MultigridPreconditioner as JMG
from iterative_solvers_tpu.solvers.refine import device_refined_solve as j_device_refined_solve
from iterative_solvers_tpu.solvers.stopping import StopConfig as JStop

from _torch_mesh_cases import FACADE, MESHES, masked_noise, world_multigrid
from iterative_solvers_tpu_torch.parallel import run_world
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL8 = dict(eps_precision=-1.0, eps_residual=-1.0, eps_exact_error=-1.0, eps_relative=1e-8,
            max_iterations=10000)


@pytest.fixture(scope="module")
def world():
    """Every rank's results of the module's cases (one world, 4 ranks)."""
    return run_world(world_multigrid, 4, timeout=300)


@pytest.fixture(scope="module")
def jm():
    return j_mesh(4, (2, 2), devices=jax.devices()[:4])


@functools.lru_cache(maxsize=None)
def _jax_vcycle(kind, n):
    """JAX's V-cycle on the masked noise of an n² domain (compiled once per
    domain, shared by every mesh shape)."""
    jd = JDomain2D(nx=n, ny=n, shape=kind)
    r = masked_noise(np.asarray(jd.interior))
    return r, np.asarray(jax.jit(JMG.from_domain(jd, fuse=False))(jnp.asarray(r)))


def _scaled_close(got, ref, tol=1e-5):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol)


@pytest.mark.parametrize("shape,kind", [(s, k) for s in MESHES for k in ("gamma", "rect")]
                         + [((2, 1, 2), "gamma")])
def test_shard_fused_vcycle(world, jm, shape, kind):
    """One V(1,1) cycle with one shard-fused level (fuse_min_extent 33);
    (2, 1, 2) is the hybrid (slice, y, x) mesh."""
    got = world[0][("vcycle", shape, kind)]
    assert got["levels"] == 1
    r, ref = _jax_vcycle(kind, 64)
    np.testing.assert_array_equal(got["z"], got["single"])  # the single-device fused cycle
    _scaled_close(got["z"], ref)
    # call_with_dot: the same w, and (r, w) fused into the finest K_up
    assert got["w_equal"]
    dot = float(np.sum(r.astype(np.float64) * got["z"]))
    assert abs(got["rz"] - dot) <= 1e-5 * abs(dot)


def test_shard_fused_vcycle_two_levels_and_symmetry(world):
    got = world[0]["two_levels"]
    assert got["levels"] == 2
    _scaled_close(got["z"], _jax_vcycle("gamma", 128)[1])
    assert abs(got["d1"] - got["d2"]) / abs(got["d1"]) < 1e-5  # PCG-safe


def test_sharded_fmg_stepwise_matches_monolithic(world):
    got = world[0]["fmg"]
    _scaled_close(got["step"], got["mono"])
    jd = JDomain2D(nx=64, ny=64)
    prob = JProblem.manufactured(jd)
    b = prob.rhs_field(jnp.float32)
    fmg = jax.jit(JMG.from_domain(jd, fuse=False).with_fmg(prob).fmg)
    _scaled_close(got["mono"], np.asarray(fmg(b)))
    A = JStencil.from_domain(jd)
    bb = np.asarray(b)
    rel = np.linalg.norm(bb - np.asarray(A(jnp.asarray(got["smooth"])))) / np.linalg.norm(bb)
    assert rel < 5e-3, rel


def test_shard_fused_pcg_iteration_count(world):
    """As the JAX test: within one iteration of the single-device jnp MG-PCG."""
    got = world[0]["fused_pcg"]
    jd = JDomain2D(nx=64, ny=64)
    stop = JStop(eps_precision=-1, eps_residual=1e-4, max_iterations=100)
    ref = j_cg_solve(JStencil.from_domain(jd), JProblem.manufactured(jd).rhs_field(jnp.float32),
                     options=JCGOptions(stop=stop, preconditioner=JMG.from_domain(jd, fuse=False)))
    assert got["converged"] and abs(got["iterations"] - ref.iterations) <= 1
    np.testing.assert_allclose(got["x"], np.asarray(ref.x), atol=2e-5)


def _jax_fast_path(jm, fmg):
    jd = JDomain2D(nx=64, ny=64)
    prob = JProblem.manufactured(jd)
    pop = JPallas.from_domain(jd, jm, block_rows=16)
    M = JFusedMG.from_operator(pop, jd, fuse_min_extent=33)
    A_hi = JHalo(mesh=jm, coeffs=pop.coeffs, grid_shape=pop.grid_shape,
                 padded_shape=pop.padded_shape, mask_kind=pop.mask_mode, dims=(jd.nx, jd.ny))
    return j_device_refined_solve(A_hi, pop, pop.shard(prob.rhs_field(jnp.float64)),
                                  preconditioner=M.with_fmg(prob) if fmg else M,
                                  stop=JStop(**REL8), fmg=fmg), pop


def test_sharded_fast_path_matches_jax(world, jm):
    """``device_refined_solve`` with the f64 halo twin outside and D1 with
    the shard-fused V-cycle and its FMG warm start inside, on (2, 2) at
    64²: JAX's outer and inner counts, stop reason and history rows."""
    got = world[0]["fast_path"]
    ref, pop = _jax_fast_path(jm, True)
    assert (got["reason"], got["converged"], got["outers"], got["iterations"]) == (
        int(ref.reason), bool(ref.converged), ref.outer_iterations, ref.iterations)
    np.testing.assert_array_equal(got["history"][:, 0], np.asarray(ref.history)[:, 0])
    assert got["rel"] < 1e-8
    _scaled_close(got["x"], np.asarray(pop.crop(ref.x)), 1e-7)


def test_sharded_fast_path_cold_start(world):
    """The same ladder from zero (the JAX package's own mesh test): it
    converges to the criterion, in no fewer inner iterations than warm."""
    got, warm = world[0]["fast_path_cold"], world[0]["fast_path"]
    assert got["converged"] and got["reason"] == 5
    assert got["iterations"] >= warm["iterations"]


@pytest.mark.parametrize("route", list(FACADE))
def test_facade_mesh_routes(world, route):
    """Each mesh route of the facade on (2, 2); the mixed ones with a
    callback (the host ladder, which the JAX facade runs on a CPU). Held to
    the JAX facade's counts: JAX's mesh routes take its single-device
    facade's iterations on all eight (measured), and a JAX facade on a mesh
    compiles its sharded programs for 10-25 s a route, so the reference is
    the single-device JAX facade (the mixed ladder's on the stencil, which
    is its only single-device form; ``pallas`` + ``mg`` as the f32 stencil,
    whose jnp V-cycle its mesh route runs below the fuse extent)."""
    got = world[0]["facade"][route]
    kw = dict(FACADE[route])
    mixed = kw.get("precision") == "mixed"
    calls = []
    callback = (lambda *a: calls.append(a[0])) if mixed else None
    s = kw["stop"]
    kw["stop"] = JStop(eps_precision=s.eps_precision, eps_residual=s.eps_residual,
                       max_iterations=s.max_iterations)
    if "domain" in kw:
        kw["domain"] = JDomain3D(nx=16, ny=16, nz=16)
    if mixed:
        kw.pop("operator", None)
    elif route == "pallas_mg":
        kw.update(operator="stencil", dtype=jnp.float32)
    ref = JSolver(**kw).solve(callback=callback)
    assert (got["reason"], got["iterations"], got["calls"]) == (
        int(ref.stop_reason), ref.iterations, calls)
    np.testing.assert_allclose(got["solution"], ref.solution, atol=1e-4)
    if mixed:
        assert got["residual_norm"] < FACADE[route]["stop"].eps_residual


def test_facade_device_ladder(world):
    """precision='mixed' over the mesh without a callback: the device
    ladder (f64 outer through the halo stencil, the gathered V-cycle)."""
    got = world[0]["facade_device_ladder"]
    assert got["reason"] == 2 and got["residual_norm"] < 1e-6

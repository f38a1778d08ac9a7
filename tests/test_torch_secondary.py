"""CPU parity of the facade's remaining single-device paths against the JAX
package: the compacted ordering, CSR assembly and the sparse operator,
Jacobi and Chebyshev preconditioning, the Chebyshev coarse solve, the CG
driver's protocol (``beta_kind``, callbacks, ``request_stop``), the facade's
operator × preconditioner matrix at ``precision=None`` and the generic mixed
ladder.

Sizes: 2D at most 36², 3D at 8³. Tolerances:

- geometry (ordering, coordinates, CSR structure, spectral bounds) exact;
  CSR values exact (the same f64 coefficients);
- f64 solves: stop reason, iteration count and the history's iteration
  column exact, the other history columns and x within 1e-9 relative (the
  two packages sum in other orders, and the 2D RHS assembly subtracts its
  Dirichlet terms in another order: ~1e-14, amplified by the solve);
- f32 solves (``operator="pallas"``): counts exact, x within 1e-5 ·
  max|x| (as tests/test_torch_plain_cg.py), each history norm column within
  1e-3 of its largest value (the last rows sit near the f32 floor, where
  the step norm ‖αz‖∞ of the two reduction orders differs by ~4e-4 and
  ‖r‖∞ by percent);
- the mixed ladders: stop reason, outer and inner counts exact, x within
  1e-6 · max|x| (as tests/test_torch_3d.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solvers_tpu import api as japi
from iterative_solvers_tpu.core import ordering as jordering
from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.core.domain import Domain3D as JDomain3D
from iterative_solvers_tpu.core.problem import PoissonProblem as JProblem
from iterative_solvers_tpu.ops import sparse as jsparse
from iterative_solvers_tpu.ops.stencil import StencilOperator as JStencil
from iterative_solvers_tpu.solvers import precond as jprecond
from iterative_solvers_tpu.solvers.cg import CGOptions as JCGOptions
from iterative_solvers_tpu.solvers.cg import cg_solve as j_cg_solve
from iterative_solvers_tpu.solvers.multigrid import MultigridPreconditioner as JMG
from iterative_solvers_tpu.solvers.stopping import StopConfig as JStop

from iterative_solvers_tpu_torch import DirichletSolver, Domain2D, Domain3D, PoissonProblem
from iterative_solvers_tpu_torch import StopConfig
from iterative_solvers_tpu_torch.core import ordering
from iterative_solvers_tpu_torch.core.domain import notched_disk
from iterative_solvers_tpu_torch.interop import sparse_operator_from_csr
from iterative_solvers_tpu_torch.ops import sparse
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator, fma_f32
from iterative_solvers_tpu_torch.parallel import make_solver_mesh
from iterative_solvers_tpu_torch.solvers import precond
from iterative_solvers_tpu_torch.solvers.cg import CGOptions, cg_solve
from iterative_solvers_tpu_torch.solvers.multigrid import (
    MultigridPreconditioner,
    _CoarseSolveChebyshev,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL9 = dict(eps_precision=-1, eps_residual=-1, eps_relative=1e-9)
DOMAINS = {
    "gamma": (dict(nx=32, ny=32), None),
    "rect": (dict(nx=24, ny=16, shape="rect"), None),
    "custom": (dict(nx=32, ny=32, shape="custom", inside_fn=notched_disk), None),
    "3d": (None, (8, 8, 8)),
}


def _domains(name):
    kw, box = DOMAINS[name]
    if box is not None:
        return JDomain3D(*box), Domain3D(*box)
    return JDomain2D(**kw), Domain2D(**kw)


def _close(got, ref, rel):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-300))


def _same_history(h, hr, f32=False):
    """Rows at the same iterations; each norm column within 1e-9 relative
    (f64), or within 1e-3 of the column's largest value (f32)."""
    h, hr = np.asarray(h), np.asarray(hr)
    assert h.shape == hr.shape
    np.testing.assert_array_equal(h[:, 0], hr[:, 0])
    for col in range(1, h.shape[1]):
        a, b = h[:, col], hr[:, col]
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin)
        if f32:
            _close(a[fin], b[fin], 1e-3)
        else:
            np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9)


@pytest.mark.parametrize("name", list(DOMAINS))
def test_ordering_matches_jax(name):
    jd, pd = _domains(name)
    np.testing.assert_array_equal(ordering.interior_indices(pd), jordering.interior_indices(jd))
    for got, ref in zip(ordering.node_coordinates(pd), jordering.node_coordinates(jd)):
        np.testing.assert_array_equal(got, ref)
    f = np.random.default_rng(1).standard_normal(pd.grid_shape)
    v = ordering.pack(f, pd)
    np.testing.assert_array_equal(v, np.asarray(jordering.pack(jnp.asarray(f), jd)))
    np.testing.assert_array_equal(ordering.unpack(v, pd), np.where(pd.interior, f, 0.0))
    vt = ordering.pack(torch.from_numpy(f), pd)
    np.testing.assert_array_equal(vt.numpy(), v)
    np.testing.assert_array_equal(ordering.unpack(vt, pd).numpy(), ordering.unpack(v, pd))


@pytest.mark.parametrize("name", list(DOMAINS))
def test_csr_assembly_and_spmv_match_jax(name):
    jd, pd = _domains(name)
    for got, ref in zip(sparse.assemble_coo(pd), jsparse.assemble_coo(jd)):
        np.testing.assert_array_equal(got, ref)
    row_map, entries, values = sparse.assemble_csr(pd)
    # the JAX package's CSR, from its native engine where the domain has one
    j_row_map, j_entries, j_values = jsparse.assemble_csr(jd)
    np.testing.assert_array_equal(row_map, j_row_map)
    for r in range(pd.num_unknowns):  # the same content up to within-row order
        lo, hi = row_map[r], row_map[r + 1]
        o, oj = np.argsort(entries[lo:hi]), np.argsort(j_entries[lo:hi])
        np.testing.assert_array_equal(entries[lo:hi][o], j_entries[lo:hi][oj])
        np.testing.assert_array_equal(values[lo:hi][o], j_values[lo:hi][oj])
    np.testing.assert_array_equal(sparse.assemble_dense(pd), jsparse.assemble_dense(jd))
    # the JAX CSR carried across, against the port's own operator and JAX's BCOO
    A = sparse_operator_from_csr(j_row_map, j_entries, j_values, jd.num_unknowns, device="cpu")
    own = sparse.SparseOperator.from_domain(pd, device="cpu")
    jop = jsparse.SparseOperator.from_domain(jd)
    x = np.random.default_rng(2).standard_normal(pd.num_unknowns)
    ref = np.asarray(jop(jnp.asarray(x)))
    _close(A(torch.from_numpy(x)).numpy(), ref, 1e-14)
    _close(own(torch.from_numpy(x)).numpy(), ref, 1e-14)
    np.testing.assert_array_equal(own.diagonal().numpy(), np.asarray(jop.diagonal()))
    assert own.nnz() == A.nnz() == jop.nnz() == JStencil.from_domain(jd).nnz()
    assert StencilOperator.from_domain(pd).nnz() == own.nnz()


def test_unported_assembly_and_mesh_raise():
    """The native CSR engine and the mesh's sharded fused engine, which both
    raised before they were ported, now run: the native CSR equals the
    NumPy builder's (a custom mask, which the engine does not cover, raises
    on backend='native'), and the mesh engine takes the single-device fused
    engine's count."""
    dom = Domain2D(nx=8, ny=8)
    for got, want in zip(sparse.assemble_csr(dom, backend="native"),
                         sparse.assemble_csr(dom, backend="numpy")):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="custom masks"):
        sparse.assemble_csr(Domain2D(nx=8, ny=8, shape="custom",
                                     inside_fn=lambda ix, iy: ix + iy < 12), backend="native")
    with pytest.raises(ValueError):
        sparse.assemble_csr(Domain2D(nx=8, ny=8), backend="bogus")
    r = DirichletSolver(nx=8, ny=8, operator="fused", mesh=make_solver_mesh(1),
                        device="cpu").solve()
    ref = DirichletSolver(nx=8, ny=8, operator="fused", device="cpu").solve()
    assert r.converged and (r.stop_reason, r.iterations) == (ref.stop_reason, ref.iterations)


@pytest.mark.parametrize("name", ["gamma", "rect", "3d", "gamma_wide"])
def test_spectral_bounds_match_jax(name):
    if name == "gamma_wide":  # a non-square Г takes the enclosing box's bound
        jd, pd = JDomain2D(nx=16, ny=16, x1=3.0), Domain2D(nx=16, ny=16, x1=3.0)
    else:
        jd, pd = _domains(name)
    assert precond.spectral_bounds(pd) == jprecond.spectral_bounds(jd)


def _cg_pair(jd, pd, kind, beta_kind="msg", stop=None):
    """(JAX result, port result) of cg_solve in f64 on the plain stencil."""
    jA, pA = JStencil.from_domain(jd), StencilOperator.from_domain(pd)
    jM = pM = None
    if kind is not None:
        jM = jprecond.make_preconditioner(kind, jA, jd)
        pM = precond.make_preconditioner(kind, pA, pd, device="cpu")
    stop = stop or dict(eps_precision=1e-6, eps_residual=1e-6)
    jb = JProblem.manufactured(jd).rhs_field(jnp.float64)
    pb = torch.from_numpy(np.array(jb))  # the same b: only the solvers differ
    ref = j_cg_solve(jA, jb, options=JCGOptions(stop=JStop(**stop), preconditioner=jM,
                                                beta_kind=beta_kind, record_history=True))
    res = cg_solve(pA, pb, options=CGOptions(stop=StopConfig(**stop), preconditioner=pM,
                                             beta_kind=beta_kind, record_history=True))
    return ref, res


@pytest.mark.parametrize("kind,beta_kind", [("jacobi", "msg"), ("chebyshev:2", "msg"),
                                            ("chebyshev", "msg"), ("chebyshev:8", "msg"),
                                            (None, "fr")])
def test_preconditioned_cg_matches_jax(kind, beta_kind):
    """Chebyshev-m PCG in f64: JAX's trajectory; Jacobi leaves the CG
    iterates unchanged (a constant scaling); the Fletcher–Reeves β."""
    jd, pd = _domains("gamma")
    ref, res = _cg_pair(jd, pd, kind, beta_kind)
    assert (int(res.reason), res.iterations) == (int(ref.reason), ref.iterations)
    _same_history(res.history, ref.history)
    _close(res.x.numpy(), ref.x, 1e-9)
    if kind == "jacobi":
        # the operator's own diagonal (no domain) scales alike, on every operator
        r = torch.from_numpy(np.random.default_rng(6).standard_normal(pd.grid_shape))
        for A in (StencilOperator.from_domain(pd), sparse.SparseOperator.from_domain(pd,
                                                                               device="cpu")):
            rr = ordering.pack(r, pd) if isinstance(A, sparse.SparseOperator) else A.mask(r)
            np.testing.assert_allclose(precond.JacobiPreconditioner.from_operator(A)(rr).numpy(),
                                       (rr / pd.coeff_diag).numpy(), rtol=1e-15)
        plain = cg_solve(StencilOperator.from_domain(pd), torch.from_numpy(np.array(
            JProblem.manufactured(jd).rhs_field(jnp.float64))), options=CGOptions())
        assert plain.iterations == res.iterations
        _close(res.x.numpy(), plain.x.numpy(), 1e-12)


def test_chebyshev_coarse_solve_matches_jax():
    """A 36² Г coarsens to 18² and stops (9 is odd); with the dense limit
    below its unknowns the coarsest level takes the Chebyshev solve (degree
    8 here, where 48 is the default, to keep JAX's unrolled program small)."""
    jd, pd = JDomain2D(nx=36, ny=36), Domain2D(nx=36, ny=36)
    Mj = JMG.from_domain(jd, dense_coarse_limit=100, coarse_chebyshev_degree=8, fuse=False)
    Mt = MultigridPreconditioner.from_domain(pd, dense_coarse_limit=100,
                                             coarse_chebyshev_degree=8, device="cpu")
    assert isinstance(Mt.coarse_solve, _CoarseSolveChebyshev)
    assert Mt.domains[-1].nx == Mj.domains[-1].nx == 18
    r = np.where(pd.interior, np.random.default_rng(3).standard_normal(pd.grid_shape), 0.0)
    _close(Mt(torch.from_numpy(r)).numpy(), np.asarray(jax.jit(Mj)(jnp.asarray(r))), 1e-12)
    stop = dict(eps_precision=-1, eps_residual=-1, eps_relative=1e-10)
    jA, pA = JStencil.from_domain(jd), StencilOperator.from_domain(pd)
    jb = JProblem.manufactured(jd).rhs_field(jnp.float64)
    ref = j_cg_solve(jA, jb, options=JCGOptions(stop=JStop(**stop), preconditioner=Mj,
                                                record_history=True))
    res = cg_solve(pA, torch.from_numpy(np.array(jb)),
                   options=CGOptions(stop=StopConfig(**stop), preconditioner=Mt,
                                     record_history=True))
    assert (int(res.reason), res.iterations) == (int(ref.reason), ref.iterations)
    _same_history(res.history, ref.history)


def test_callbacks_and_request_stop_match_jax():
    """The callback list (k, prec, r∞, err∞) at callback_every=10, the
    completion callback, and request_stop from a callback: INTERRUPTED."""
    calls = {"jax": [], "port": []}
    done = {}
    ref = japi.DirichletSolver(nx=32, ny=32).solve(
        callback=lambda *a: calls["jax"].append(a), callback_every=10,
        completion_callback=lambda c, t: done.setdefault("jax", (c, t)))
    res = DirichletSolver(nx=32, ny=32, device="cpu").solve(
        callback=lambda *a: calls["port"].append(a), callback_every=10,
        completion_callback=lambda c, t: done.setdefault("port", (c, t)))
    assert res.iterations == ref.iterations
    assert done["port"] == done["jax"]
    got, want = np.asarray(calls["port"]), np.asarray(calls["jax"])
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[1:, 1:], want[1:, 1:], rtol=1e-9)
    _same_history(res.history, ref.history)
    for pkg, make in (("jax", lambda: japi.DirichletSolver(nx=32, ny=32)),
                      ("port", lambda: DirichletSolver(nx=32, ny=32, device="cpu"))):
        s = make()
        out = s.solve(callback=lambda k, *a: s.request_stop() if k >= 20 else None,
                      callback_every=10)
        assert out.stop_reason.name == "INTERRUPTED" and out.iterations == 20
        assert not out.converged


def _facade_pair(name, operator, pc, f32=False, **kw):
    jd, pd = _domains(name)
    jkw = dict(domain=jd, operator=operator, preconditioner=pc, **kw)
    pkw = dict(domain=pd, operator=operator, preconditioner=pc, **kw)
    if f32:
        jkw["dtype"], pkw["dtype"] = jnp.float32, torch.float32
    for k in ("stop",):
        if k in kw:
            jkw[k], pkw[k] = JStop(**kw[k]), StopConfig(**kw[k])
    return japi.DirichletSolver(**jkw).solve(), DirichletSolver(device="cpu", **pkw).solve()


FACADE = [
    ("gamma", "stencil", "jacobi"),
    ("gamma", "stencil", "mg"),
    ("gamma", "sparse", "chebyshev:8"),
    ("gamma", "pallas", None),
    ("gamma", "pallas", "chebyshev"),
    ("gamma", "pallas", "mg"),
    ("rect", "sparse", None),
    ("rect", "stencil", "chebyshev"),
    ("custom", "sparse", "jacobi"),
    ("custom", "stencil", "mg"),
    ("3d", "stencil", "chebyshev"),
    ("3d", "sparse", "jacobi"),
    ("3d", "pallas", None),
]


@pytest.mark.parametrize("name,operator,pc", FACADE)
def test_facade_matches_jax(name, operator, pc):
    """precision=None: the same stop reason, iteration count and history
    rows as the JAX facade ('pallas' in f32 on both sides, the rest f64)."""
    f32 = operator == "pallas"
    ref, res = _facade_pair(name, operator, pc, f32=f32)
    assert (int(res.stop_reason), res.converged, res.iterations) == (
        int(ref.stop_reason), ref.converged, ref.iterations)
    _same_history(res.history, ref.history, f32=f32)
    _close(res.solution, ref.solution, 1e-5 if f32 else 1e-9)
    # ‖x − u‖∞ within x's own tolerance
    assert abs(res.error_norm - ref.error_norm) <= (1e-5 if f32 else 1e-9) * np.abs(
        ref.solution).max()
    assert res.solution.shape == ref.solution.shape == (res.x_coords.size,)
    for got, want in zip((res.x_coords, res.y_coords, res.z_coords),
                         (ref.x_coords, ref.y_coords, ref.z_coords)):
        np.testing.assert_array_equal(got, want)
    assert (res.interior_mask is None) == (ref.interior_mask is None)


def test_reference_default_solve():
    """The reference GUI default at 30² on the CPU: the JAX facade's stop
    reason, 79 iterations and ‖x − u‖∞ ≈ 3.3e-3 (its verify notes)."""
    ref = japi.DirichletSolver(nx=30, ny=30).solve()
    res = DirichletSolver(nx=30, ny=30, device="cpu").solve()
    assert (res.stop_reason.name, res.iterations) == (ref.stop_reason.name, ref.iterations)
    assert res.iterations == 79 and res.stop_reason.name == "PRECISION"
    assert abs(res.error_norm - 3.3e-3) < 1e-4
    _close(res.solution, ref.solution, 1e-9)
    _close(res.residual, ref.residual, 1e-6)
    field = res.solution_field(Domain2D(nx=30, ny=30))
    np.testing.assert_array_equal(field[Domain2D(nx=30, ny=30).interior], res.solution)
    _close(field, ref.solution_field(JDomain2D(nx=30, ny=30)), 1e-9)


@pytest.mark.parametrize("pc", [None, "chebyshev"])
@pytest.mark.parametrize("ladder", ["device ff", "host f64"])
def test_generic_mixed_ladder_matches_jax(pc, ladder):
    """precision='mixed' with Chebyshev or no preconditioner: the JAX
    facade's device ladder with the ff outer (outer='ff' takes it on a CPU
    too), or its host ladder (a callback); the same outers and inners."""
    kw = dict(nx=32, ny=32, precision="mixed", preconditioner=pc)
    calls = {"jax": [], "port": []}
    if ladder == "device ff":
        ref = japi.DirichletSolver(outer="ff", stop=JStop(**REL9), **kw).solve()
        res = DirichletSolver(outer="ff", stop=StopConfig(**REL9), device="cpu", **kw).solve()
    else:
        ref = japi.DirichletSolver(outer="f64", stop=JStop(**REL9), **kw).solve(
            callback=lambda *a: calls["jax"].append(a))
        res = DirichletSolver(outer="f64", stop=StopConfig(**REL9), device="cpu",
                              **kw).solve(callback=lambda *a: calls["port"].append(a))
        np.testing.assert_array_equal(np.asarray(calls["port"])[:, 0],
                                      np.asarray(calls["jax"])[:, 0])
    assert (int(res.stop_reason), res.converged, res.iterations) == (
        int(ref.stop_reason), ref.converged, ref.iterations)
    np.testing.assert_array_equal(np.asarray(res.history)[:, 0], np.asarray(ref.history)[:, 0])
    assert res.outer_iterations == len(ref.history) - 1
    _close(res.solution, ref.solution, 1e-6)
    dom = Domain2D(nx=32, ny=32)
    b = PoissonProblem.manufactured(dom).rhs_field(device="cpu")
    x = torch.from_numpy(res.solution_field(dom))
    rel = torch.linalg.norm(b - StencilOperator.from_domain(dom)(x)) / torch.linalg.norm(b)
    assert float(rel) < 1e-9


def test_stencil_apply_3d_f32_order_matches_xla():
    """The f32 7-point sum in XLA's order, ``fma(cz, sz, fma(cy, sy,
    fma(cd, xm, cx·sx)))`` (ops/stencil.combine7): at 16³ and 24³ every
    node equals the JAX package's. No one order reproduces XLA's CPU code
    at every extent: its 8-wide vectorised loop body contracts the products
    into FMAs and its remainder does not (at 8³ nothing contracts). So at
    12³ (13 columns) every node of the first 8 columns equals JAX's and the
    nodes that differ sit in the remainder columns 8-11; at 8³ they spread
    over every column. There each node is held within eps32 · max|y| (one
    rounding of the largest term). At 16³ and 24³ the remainder is the
    boundary column, which the mask zeroes."""
    eps = float(np.finfo(np.float32).eps)
    for n in (8, 12, 16, 24):
        jd, pd = JDomain3D(nx=n, ny=n, nz=n), Domain3D(nx=n, ny=n, nz=n)
        x = np.random.default_rng(n).standard_normal(pd.grid_shape).astype(np.float32)
        ref = np.asarray(JStencil.from_domain(jd)(jnp.asarray(x)))
        got = StencilOperator.from_domain(pd)(torch.from_numpy(x)).numpy()
        if n >= 16:
            np.testing.assert_array_equal(got, ref)
            continue
        np.testing.assert_allclose(got, ref, rtol=0, atol=eps * np.abs(ref).max())
        if n == 12:
            body = (pd.grid_shape[-1] // 8) * 8
            np.testing.assert_array_equal(got[..., :body], ref[..., :body])
            assert (got[..., body:] != ref[..., body:]).any()


def test_xla_f32_field_dot_is_a_sequential_fma_chain():
    """Why the 3D ladders below keep a count tolerance even at 16³, where
    the operator equals JAX's at every node: XLA's CPU code sums an f32
    field's ``sum(a * b)`` (the CG's dots and norms) as one sequential
    chain in row-major order, ``acc = fma(a_i, b_i, acc)``; torch sums
    pairwise in vector lanes. So the two CGs' (r, z) differ in the last bit
    from the first iteration on, and the inner counts may drift apart by a
    few. Reproducing the chain would serialise every reduction."""
    a, b = (np.random.default_rng(s).standard_normal((17, 17, 17)).astype(np.float32)
            for s in (1, 2))
    ref = np.float32(jax.jit(lambda u, v: jnp.sum(u * v))(jnp.asarray(a), jnp.asarray(b)))
    acc = np.zeros(1, np.float32)
    for u, v in zip(a.ravel(), b.ravel()):
        acc = fma_f32(float(u), torch.tensor([v]), torch.from_numpy(acc)).numpy()
    assert acc[0] == ref


def _xla_vectorised_sum(p, lanes):
    """XLA's CPU code for a reduce over all dims of a fused elementwise
    product on a (17, 17, 17) f32 field (its LLVM IR): the loops are
    interchanged so that a ``lanes``-wide vector accumulator runs over dim 1
    in whole vectors, dim 2 innermost; the accumulator starts each dim-0
    slab as (running sum, -0, ...), is reduced by halving at the slab's
    end, and the remaining dim-1 rows are added one by one. Every add is
    one f32 rounding."""
    f = np.float32
    n1 = p.shape[1] // lanes * lanes
    acc = f(0)
    for i in range(p.shape[0]):
        v = np.zeros(lanes, np.float32)
        v[0] = acc
        for jb in range(0, n1, lanes):
            for k in range(p.shape[2]):
                v = (v + p[i, jb:jb + lanes, k]).astype(np.float32)
        while len(v) > 1:
            v = (v[:len(v) // 2] + v[len(v) // 2:]).astype(np.float32)
        acc = f(v[0])
        for j in range(n1, p.shape[1]):
            for k in range(p.shape[2]):
                acc = f(acc + p[i, j, k])
    return acc


def test_3d_jacobi_first_alpha_is_xla_reduction_order():
    """Where the 3D Jacobi ladders' counts part (ROADMAP Queue 3): the first
    inner iteration at 16³, both packages on the same f32 fields. M r and
    the operator output A z are bit-equal, α₀ = (r, z)/(A z, z) is not. JAX's
    (A z, z) is XLA's dot: the sequential row-major fma chain (the test
    above). JAX's (r, z) is not: its CG init fuses z = r · (1/diag) into the
    reduction, which XLA emits as an interchanged, vectorised loop whose sum
    is reassociated (``_xla_vectorised_sum``; the vector width is the host
    LLVM's choice, 8 lanes on AVX2/AVX-512 hosts). Those two orders give
    JAX's α₀ bit for bit; the port's pairwise sums give another last bit."""
    from iterative_solvers_tpu.solvers import cg as jcg
    from iterative_solvers_tpu_torch.solvers.cg import _cg_init, cg_iteration

    jd, pd = JDomain3D(nx=16, ny=16, nz=16), Domain3D(nx=16, ny=16, nz=16)
    jA, pA = JStencil.from_domain(jd), StencilOperator.from_domain(pd)
    jM = jprecond.make_preconditioner("jacobi", jA, jd)
    pM = precond.make_preconditioner("jacobi", pA, pd, device="cpu")
    r = np.asarray(JProblem.manufactured(jd).rhs_field(jnp.float64)).astype(np.float32)
    js = jcg._cg_init(jA, jM, jnp.asarray(r), None, None)
    z, j_rz = np.asarray(js.z), np.float32(js.rz)
    ps = _cg_init(pA, pM, torch.from_numpy(r), None, None)
    np.testing.assert_array_equal(ps.z.numpy(), z)
    az = np.asarray(jax.jit(jA)(jnp.asarray(z)))
    np.testing.assert_array_equal(pA(torch.from_numpy(z)).numpy(), az)
    j_azz = np.float32(jax.jit(lambda a, b: jnp.sum(a * b))(jnp.asarray(az), jnp.asarray(z)))
    j_alpha = j_rz / j_azz
    p_alpha = np.float32(ps.rz) / np.float32(torch.sum(torch.from_numpy(az * z)))
    assert j_alpha != p_alpha
    # each package's first step is x1 = α₀ z with its own α₀
    stop = dict(eps_precision=-1, eps_residual=-1)
    jx1 = np.asarray(jcg._cg_chunk(jA, jM, JStop(**stop), "msg", js, None, 1).x)
    np.testing.assert_array_equal(jx1, j_alpha * z)
    px1 = cg_iteration(pA, pM, StopConfig(**stop), ps, None).x.numpy()
    np.testing.assert_array_equal(px1, p_alpha * z)

    def chain(a, b):  # XLA's dot: acc = fma(a_i, b_i, acc), row-major
        acc = torch.zeros(1)
        for u, v in zip(a.ravel(), b.ravel()):
            if u * v != 0:  # fma(0, v, acc) == acc
                acc = fma_f32(float(u), torch.tensor([v]), acc)
        return np.float32(acc.item())

    azz = chain(az, z)
    assert azz == j_azz
    assert chain(r, z) != j_rz  # the fused init reduction is not the chain
    p = (r * z).astype(np.float32)
    rz = [_xla_vectorised_sum(p, lanes) for lanes in (8, 16, 4)]
    assert j_rz in rz
    assert j_rz / azz == j_alpha


@pytest.mark.parametrize("n", [8, 12, 16])
def test_3d_jacobi_mixed_ladder_matches_jax(n):
    """The 3D mixed host ladder with Jacobi (f64 outer, f32 CG inners).
    The JAX package takes 42, 68 and 92 inner iterations at 8³, 12³ and
    16³. The f32 inner CG is the plain recurrence, whose count moves with
    the last bits of its operator (at 8³ and 12³ XLA's rounding depends on
    the node's place in its loop) and of its dots (XLA's are sequential fma
    chains, the port's pairwise sums; see the two tests above), so the
    inner count is held within 3 of JAX's (the port takes 45, 68, 91), the
    outer count and the stop reason exactly, x within 1e-6 · max|x|
    (ROADMAP Queue 3, open)."""
    kw = dict(precision="mixed", preconditioner="jacobi", outer="f64")
    ref = japi.DirichletSolver(domain=JDomain3D(nx=n, ny=n, nz=n), stop=JStop(**REL9),
                               **kw).solve(callback=lambda *a: None)
    res = DirichletSolver(domain=Domain3D(nx=n, ny=n, nz=n), stop=StopConfig(**REL9),
                          device="cpu", **kw).solve(callback=lambda *a: None)
    assert (int(res.stop_reason), res.converged) == (int(ref.stop_reason), ref.converged)
    assert res.outer_iterations == len(ref.history) - 1
    assert abs(res.iterations - ref.iterations) <= 3
    _close(res.solution, ref.solution, 1e-6)


def test_3d_ff_ladder_without_preconditioner_matches_jax():
    """The 3D device ladder with the ff outer and no preconditioner at 8³:
    JAX's total of 40 inner iterations over 3 outers, each outer's inner
    count within one of JAX's split (17/16/7; the port takes 17/15/8, for
    the reasons the Jacobi ladder's test states; ROADMAP Queue 3, open)."""
    kw = dict(precision="mixed", outer="ff")
    ref = japi.DirichletSolver(domain=JDomain3D(nx=8, ny=8, nz=8), stop=JStop(**REL9),
                               **kw).solve()
    res = DirichletSolver(domain=Domain3D(nx=8, ny=8, nz=8), stop=StopConfig(**REL9),
                          device="cpu", **kw).solve()
    assert (int(res.stop_reason), res.iterations) == (int(ref.stop_reason), ref.iterations)
    split, jsplit = np.diff(np.asarray(res.history)[:, 0]), np.diff(np.asarray(ref.history)[:, 0])
    assert len(split) == len(jsplit) and np.abs(split - jsplit).max() <= 1
    _close(res.solution, ref.solution, 1e-6)

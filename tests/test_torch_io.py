"""Files of the port against the JAX package: results text and npz, the CSR
matrix + RHS dump, the gnuplot export, the native C++ engines and CG
checkpoints (the port's side of test_io_checkpoint.py and test_native.py).

Cross-package parity: a results file written by either package loads in the
other with every array equal bit for bit; the same results content gives
byte-identical text and matrix files from both; the native CSR equals the
NumPy builder's and the JAX package's native CSR exactly; a JAX checkpoint
of plain f64 CG resumes in the port to JAX's uninterrupted count with x
within 1e-12 relative, and a port checkpoint loads in JAX field for field.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from iterative_solvers_tpu import results_io as jio
from iterative_solvers_tpu.api import DirichletSolver as JSolver
from iterative_solvers_tpu.api import SolverResults as JResults
from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.core.domain import Domain3D as JDomain3D
from iterative_solvers_tpu.core.problem import PoissonProblem as JProblem
from iterative_solvers_tpu.native import loader as jloader
from iterative_solvers_tpu.ops.stencil import StencilOperator as JStencil
from iterative_solvers_tpu.solvers import checkpoint as jckpt
from iterative_solvers_tpu.solvers.cg import CGOptions as JCGOptions
from iterative_solvers_tpu.solvers.cg import cg_solve as jcg_solve
from iterative_solvers_tpu.solvers.stopping import StopConfig as JStop

from iterative_solvers_tpu_torch import results_io
from iterative_solvers_tpu_torch.api import DirichletSolver, SolverResults
from iterative_solvers_tpu_torch.core import ordering
from iterative_solvers_tpu_torch.core.domain import Domain2D, Domain3D, notched_disk
from iterative_solvers_tpu_torch.core.problem import PoissonProblem
from iterative_solvers_tpu_torch.kernels.cg_fused import fused_cg_solve
from iterative_solvers_tpu_torch.native import loader
from iterative_solvers_tpu_torch.ops.sparse import assemble_csr, assemble_dense
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
from iterative_solvers_tpu_torch.solvers.cg import CGOptions, CGState, cg_solve
from iterative_solvers_tpu_torch.solvers.checkpoint import (
    load_cg_state,
    periodic_checkpointer,
    save_cg_state,
)
from iterative_solvers_tpu_torch.solvers.stopping import StopConfig, StopReason
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

VECTORS = ("solution", "true_solution", "residual", "error", "x_coords", "y_coords")
# what the sectioned text keeps besides the vectors (a gamma file has no
# SHAPE line: its shape loads as "")
TEXT_META = ("iterations", "converged", "stop_reason", "residual_norm", "error_norm", "nx",
             "ny", "nz", "bounds")
STOP = dict(eps_precision=-1, eps_residual=1e-7)


@pytest.fixture(scope="module")
def solved():
    """A port solve and a JAX solve of the same 12² problem."""
    s = DirichletSolver(nx=12, ny=12, stop=StopConfig(**STOP), device="cpu")
    j = JSolver(nx=12, ny=12, stop=JStop(**STOP))
    return s, s.solve(), j.solve()


def _port_results(jres) -> SolverResults:
    """The port's SolverResults with the content of a JAX one."""
    names = {f.name for f in dataclasses.fields(SolverResults)}
    return SolverResults(**{f.name: getattr(jres, f.name) for f in dataclasses.fields(jres)
                            if f.name in names})


def _synthetic(kind: str, jax_side: bool):
    """Results of a rect, 3D or custom domain, filled from a seed (no solve)."""
    rng = np.random.default_rng(7)
    n = 23
    vec = {k: rng.standard_normal(n) for k in VECTORS}
    kw = dict(vec, iterations=17, converged=False, stop_reason=StopReason.ITERATIONS,
              residual_norm=float(rng.random()), error_norm=float(rng.random()),
              precision_norm=0.5, elapsed_s=0.25, nx=8, ny=6,
              bounds=(1.0, 2.0, 1.0, 2.0), history=rng.random((3, 5)))
    if kind == "rect":
        kw["shape"] = "rect"
    elif kind == "3d":
        kw.update(nz=4, bounds=(0.0, 1.0, 0.0, 1.0, 0.0, 1.0), z_coords=rng.random(n))
    else:
        kw.update(shape="custom", interior_mask=rng.random((7, 9)) < 0.5)
    if jax_side:
        from iterative_solvers_tpu.solvers.stopping import StopReason as JReason

        kw["stop_reason"] = JReason(int(kw["stop_reason"]))
        return JResults(**kw)
    return SolverResults(**kw)


def _same_vectors(a, b, names=VECTORS):
    for k in names:
        np.testing.assert_array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b, k)),
                                      err_msg=k)


# --- the port's own round trips (test_io_checkpoint.py) --------------------


def test_text_roundtrip(tmp_path, solved):
    _, res, _ = solved
    p = str(tmp_path / "results.txt")
    results_io.save_results(p, res)
    loaded, name = results_io.load_results(p)
    assert "MSG" in name
    _same_vectors(loaded, res)  # %.17e round-trips every double exactly
    assert (loaded.iterations, loaded.converged, loaded.stop_reason) == (
        res.iterations, res.converged, res.stop_reason)
    assert loaded.nx == res.nx and loaded.bounds == res.bounds
    assert loaded.outer_iterations == 0  # the text format has no such field


def test_text_format_sections(tmp_path, solved):
    _, res, _ = solved
    p = str(tmp_path / "results.txt")
    res.save(p)
    lines = open(p).read().splitlines()
    assert lines[0] == "PARAMETERS" and res.shape == "gamma"
    assert lines[4] == "CONVERGENCE"  # gamma files stay reference-compatible
    assert not any(ln.startswith("SHAPE") for ln in lines)
    for sec in ("SOLUTION", "TRUE_SOLUTION", "RESIDUAL", "ERROR", "X_COORDS", "Y_COORDS"):
        assert sec in lines


def test_npz_roundtrip(tmp_path, solved):
    _, res, _ = solved
    p = str(tmp_path / "results.npz")
    results_io.save_results_npz(p, dataclasses.replace(res, outer_iterations=3))
    loaded = results_io.load_results_npz(p)
    _same_vectors(loaded, res)
    assert loaded.stop_reason == res.stop_reason and loaded.elapsed_s == res.elapsed_s
    np.testing.assert_array_equal(loaded.history, res.history)
    assert loaded.outer_iterations == 3


def test_matrix_dump_roundtrip(tmp_path):
    dom = Domain2D(nx=6, ny=6)
    b = ordering.pack(PoissonProblem.manufactured(dom).rhs_field(device="cpu"), dom).numpy()
    p = str(tmp_path / "matrix.txt")
    results_io.save_matrix_and_rhs(p, dom, b)
    row_map, entries, values, rhs = results_io.load_matrix_and_rhs(p)
    A = np.zeros((16, 16))
    for i in range(16):
        for k in range(row_map[i], row_map[i + 1]):
            A[i, entries[k]] = values[k]
    np.testing.assert_array_equal(A, assemble_dense(dom))
    np.testing.assert_array_equal(rhs, b)


def test_solution_3d_export(tmp_path, solved):
    _, res, _ = solved
    p = str(tmp_path / "surface.dat")
    results_io.save_solution_3d(p, res)
    rows = np.loadtxt(p)
    assert rows.shape == (res.solution.size, 3)
    np.testing.assert_array_equal(rows[:, 2], res.solution)


def test_load_matrix_and_rhs_malformed(tmp_path):
    p = tmp_path / "bad.txt"
    for text, match in (
        ("NOT_A_DUMP\n", "bad header"),
        ("MATRIX_INFO\n6 6\nxx yy\nMATRIX\n", "size line"),
        ("MATRIX_INFO\n6 6\n2 3\nMATRIX\n0\n1\n3\n", "truncated"),
        ("MATRIX_INFO\n6 6\n2 2\nMATRIX\n" + "\n".join(
            ["0", "1", "3", "0", "1", "1.0", "2.0", "RHS", "1.0", "2.0"]) + "\n", "row_map"),
    ):
        p.write_text(text)
        with pytest.raises(ValueError, match=match):
            results_io.load_matrix_and_rhs(str(p))


# --- cross-package files ------------------------------------------------------


def test_jax_text_and_npz_load_in_port(tmp_path, solved):
    """JAX files load in the port with every array equal bit for bit."""
    _, _, jres = solved
    txt, npz = str(tmp_path / "j.txt"), str(tmp_path / "j.npz")
    jio.save_results(txt, jres)
    jio.save_results_npz(npz, jres)
    loaded, name = results_io.load_results(txt)
    assert "TPU" in name
    _same_vectors(loaded, jres)
    for k in TEXT_META:
        assert getattr(loaded, k) == getattr(jres, k), k
    loaded = results_io.load_results_npz(npz)
    _same_vectors(loaded, jres)
    np.testing.assert_array_equal(loaded.history, jres.history)
    assert loaded.outer_iterations == 0  # a JAX npz has none
    assert (loaded.precision_norm, loaded.elapsed_s) == (jres.precision_norm, jres.elapsed_s)


def test_port_text_and_npz_load_in_jax(tmp_path, solved):
    _, res, _ = solved
    txt, npz = str(tmp_path / "p.txt"), str(tmp_path / "p.npz")
    results_io.save_results(txt, res)
    results_io.save_results_npz(npz, res)
    loaded, name = jio.load_results(txt)
    assert name == "MSG (conjugate gradient, CUDA)"
    _same_vectors(loaded, res)
    for k in TEXT_META:
        assert getattr(loaded, k) == getattr(res, k), k
    loaded = jio.load_results_npz(npz)  # the extra outer_iterations key is ignored
    _same_vectors(loaded, res)
    np.testing.assert_array_equal(loaded.history, res.history)


@pytest.mark.parametrize("kind", ["solved", "rect", "3d", "custom"])
def test_text_bytes_identical_across_packages(tmp_path, solved, kind):
    """The same results content and solver name give the same bytes."""
    if kind == "solved":
        jres = solved[2]
        pres = _port_results(jres)
    else:
        jres, pres = _synthetic(kind, True), _synthetic(kind, False)
    a, b = tmp_path / "j.txt", tmp_path / "p.txt"
    jio.save_results(str(a), jres, solver_name="MSG")
    results_io.save_results(str(b), pres, solver_name="MSG")
    assert a.read_bytes() == b.read_bytes()
    a, b = tmp_path / "j.dat", tmp_path / "p.dat"
    jio.save_solution_3d(str(a), jres)
    results_io.save_solution_3d(str(b), pres)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("kind", ["rect", "3d", "custom"])
def test_npz_across_packages(tmp_path, kind):
    jres, pres = _synthetic(kind, True), _synthetic(kind, False)
    a, b = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jio.save_results_npz(a, jres)
    results_io.save_results_npz(b, pres)
    for got, want in ((results_io.load_results_npz(a), jres), (jio.load_results_npz(b), pres)):
        _same_vectors(got, want)
        assert got.shape == want.shape and got.nz == want.nz
        for k in ("z_coords", "interior_mask", "history"):
            g, w = getattr(got, k), getattr(want, k)
            assert (g is None) == (w is None), k
            if w is not None:
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("nx, ny, shape", [(6, 6, "gamma"), (9, 7, "rect")])
def test_matrix_dump_bytes_identical_across_packages(tmp_path, nx, ny, shape):
    dom, jdom = Domain2D(nx=nx, ny=ny, shape=shape), JDomain2D(nx=nx, ny=ny, shape=shape)
    b = np.random.default_rng(1).standard_normal(dom.num_unknowns)
    a, p = tmp_path / "j.txt", tmp_path / "p.txt"
    jio.save_matrix_and_rhs(str(a), jdom, b)
    results_io.save_matrix_and_rhs(str(p), dom, b)
    assert a.read_bytes() == p.read_bytes()
    for x, y in zip(jio.load_matrix_and_rhs(str(p)), results_io.load_matrix_and_rhs(str(a))):
        np.testing.assert_array_equal(x, y)


# --- the native engines (test_native.py) --------------------------------------


def _doms(spec):
    kind = spec[0]
    if kind == "3d":
        return Domain3D(*spec[1:]), JDomain3D(*spec[1:])
    nx, ny = spec[1:]
    return Domain2D(nx=nx, ny=ny, shape=kind), JDomain2D(nx=nx, ny=ny, shape=kind)


@pytest.fixture
def jnative(tmp_path, monkeypatch):
    """The JAX package's native engines, built into this test's own
    directory. Its loader compiles into a shared cache through one fixed
    temporary name, so two test processes that build at once can collide
    there, and the one that loses keeps None for the rest of its life: its
    state is reset here so that it builds and loads again."""
    monkeypatch.setenv("ISTPU_NATIVE_CACHE", str(tmp_path))
    for name, value in (("_lib", None), ("_load_failed", False), ("_textio_lib", None),
                        ("_textio_failed", False)):
        monkeypatch.setattr(jloader, name, value)
    assert jloader.available(), "the JAX package's native assembly engine did not build"
    return jloader


@pytest.mark.parametrize("spec", [
    ("gamma", 6, 6), ("gamma", 64, 64), ("gamma", 10, 6), ("rect", 12, 20), ("rect", 33, 17),
    ("3d", 6, 5, 4),
])
def test_native_csr_equals_numpy_and_jax(spec, jnative):
    dom, jdom = _doms(spec)
    native = assemble_csr(dom, backend="native")
    for other in (assemble_csr(dom, backend="numpy"), assemble_csr(dom),
                  jnative.assemble_csr_native(jdom)):
        for x, y in zip(native, other):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


@pytest.mark.parametrize("nx, ny, shape", [(6, 6, "gamma"), (14, 10, "rect"), (10, 6, "gamma")])
def test_native_counts_and_coords(nx, ny, shape):
    dom = Domain2D(nx=nx, ny=ny, shape=shape)
    assert loader.num_unknowns_native(dom) == dom.num_unknowns
    xs, ys = loader.node_coords_native(dom)
    xs_p, ys_p = ordering.node_coordinates(dom)
    np.testing.assert_allclose(xs, xs_p, rtol=1e-15)
    np.testing.assert_allclose(ys, ys_p, rtol=1e-15)


def test_custom_masks_take_the_numpy_builder():
    dom = Domain2D(nx=16, ny=16, shape="custom", inside_fn=notched_disk)
    assert loader.assemble_csr_native(dom) is None
    with pytest.raises(RuntimeError, match="custom masks"):
        assemble_csr(dom, backend="native")
    for x, y in zip(assemble_csr(dom), assemble_csr(dom, backend="numpy")):
        np.testing.assert_array_equal(x, y)


def test_native_build_is_the_ports_own(tmp_path, monkeypatch):
    """The engines compile from the port's sources into build/torch_native,
    named by a source hash; a failed compile raises with the compiler's
    stderr instead of falling back."""
    for name, src in loader.SOURCES.items():
        assert src.parent == loader.HERE and src.exists()
        path = loader.build(name)
        assert path.parent == loader.BUILD_DIR and path == loader.library_path(name)
    assert loader.available()
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setitem(loader.SOURCES, "broken", bad)
    with pytest.raises(RuntimeError, match="failed"):
        loader.build("broken")


def test_textio_format_matches_python(jnative):
    v = np.random.default_rng(3).standard_normal(1000)
    v[::100] = [0.0, -0.0, 1e-300, 1e300, -1.5, 2.0, 3.25, 1e-17, -7.0, 42.0]
    raw = loader.format_doubles(v)
    assert raw.decode("ascii") == "".join(f"{x:.17e}\n" for x in v)
    theirs = jnative.format_doubles(v)
    assert theirs is not None, "the JAX package's native textio engine did not build"
    assert raw == theirs


def test_textio_parse_roundtrip_and_sentinel():
    v = np.random.default_rng(4).standard_normal(500)
    raw = loader.format_doubles(v)
    vals, consumed = loader.parse_doubles(raw + b"SECTION\n1.0\n2.0\n", 10_000)
    assert consumed == len(raw)  # stopped exactly at the section header
    np.testing.assert_array_equal(vals, v)


def test_textio_xyz():
    x, y, z = np.ones(3), np.arange(3.0), np.full(3, -2.5)
    lines = loader.format_xyz(x, y, z).decode().splitlines()
    assert len(lines) == 3
    assert [float(t) for t in lines[1].split()] == [1.0, 1.0, -2.5]


def test_results_io_large_roundtrip(tmp_path):
    s = DirichletSolver(nx=48, ny=48, device="cpu",
                        stop=StopConfig(eps_precision=-1, eps_residual=1e-3, max_iterations=2000))
    res = s.solve(record_history=False)
    p = str(tmp_path / "big.txt")
    results_io.save_results(p, res)
    loaded, _ = results_io.load_results(p)
    _same_vectors(loaded, res, ("solution", "residual"))
    assert loaded.iterations == res.iterations


# --- checkpoints ----------------------------------------------------------------


CKPT_STOP = dict(eps_precision=-1, eps_residual=1e-8, max_iterations=5000)


def _interrupted(solve, ckpt, every=20):
    """Run ``solve(options)`` with a checkpoint at each chunk until two
    chunks are done (k = 1, then k = ``every``)."""
    states = []
    return solve(dict(
        callback=lambda *a: None, callback_every=every,
        stop_requested=lambda: len(states) >= 2,
        state_callback=lambda s: (states.append(1), save_cg_state(ckpt, s)),
    ))


def test_checkpoint_resume_exact(tmp_path):
    dom = Domain2D(nx=24, ny=24)
    op = StencilOperator.from_domain(dom)
    b = PoissonProblem.manufactured(dom).rhs_field(device="cpu")
    stop = StopConfig(**CKPT_STOP)
    full = cg_solve(op, b, options=CGOptions(stop=stop))
    ckpt = str(tmp_path / "cg.npz")
    res1 = _interrupted(lambda kw: cg_solve(op, b, options=CGOptions(stop=stop, **kw)), ckpt)
    assert res1.reason == StopReason.INTERRUPTED and res1.iterations == 20
    state = load_cg_state(ckpt, device="cpu")
    assert state.k == 20 and state.w is None and state.rz_prev is None
    res2 = cg_solve(op, b, options=CGOptions(stop=stop), init_state=state)
    assert res2.converged and res2.iterations == full.iterations
    assert torch.equal(res2.x, full.x)  # the same arithmetic from the same state


def test_periodic_checkpointer(tmp_path):
    dom = Domain2D(nx=16, ny=16)
    op = StencilOperator.from_domain(dom)
    b = PoissonProblem.manufactured(dom).rhs_field(device="cpu")
    ckpt = str(tmp_path / "p.npz")
    seen = []
    cb = periodic_checkpointer(ckpt, every_iters=25)

    def state_callback(s):  # chunks end at k = 1, 10, 20, ..., 60
        cb(s)
        if os.path.exists(ckpt):
            seen.append(load_cg_state(ckpt, device="cpu").k)

    cg_solve(op, b, options=CGOptions(
        stop=StopConfig(max_iterations=60).disable_all_but_iterations(),
        callback=lambda *a: None, callback_every=10, state_callback=state_callback))
    assert seen == [30, 30, 30, 60]


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A JAX checkpoint of plain f64 CG at 12², taken at k = 20, resumes in
    the port to JAX's uninterrupted count, x within 1e-12 relative."""
    jdom = JDomain2D(nx=12, ny=12)
    jop, jb = JStencil.from_domain(jdom), JProblem.manufactured(jdom).rhs_field()
    jstop = JStop(**CKPT_STOP)
    full = jcg_solve(jop, jb, options=JCGOptions(stop=jstop))
    ckpt = str(tmp_path / "jax.npz")
    states = []
    jcg_solve(jop, jb, options=JCGOptions(
        stop=jstop, callback=lambda *a: None, callback_every=20,
        stop_requested=lambda: len(states) >= 2,
        state_callback=lambda s: (states.append(1), jckpt.save_cg_state(ckpt, s))))
    state = load_cg_state(ckpt, device="cpu")
    assert state.k == 20 and state.x.dtype == torch.float64 and state.w is None
    dom = Domain2D(nx=12, ny=12)
    res = cg_solve(StencilOperator.from_domain(dom), None,
                   options=CGOptions(stop=StopConfig(**CKPT_STOP)), init_state=state)
    assert res.converged and res.iterations == full.iterations
    want = np.asarray(full.x)
    np.testing.assert_allclose(res.x.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_port_checkpoint_loads_in_jax(tmp_path):
    dom = Domain2D(nx=12, ny=12)
    op = StencilOperator.from_domain(dom)
    b = PoissonProblem.manufactured(dom).rhs_field(device="cpu")
    ckpt = str(tmp_path / "port.npz")
    _interrupted(lambda kw: cg_solve(op, b, options=CGOptions(stop=StopConfig(**CKPT_STOP),
                                                               **kw)), ckpt)
    mine, theirs = load_cg_state(ckpt, device="cpu"), jckpt.load_cg_state(ckpt)
    for f in CGState._fields:
        a, j = getattr(mine, f), getattr(theirs, f)
        if f in ("w", "rz_prev"):
            assert a is None and j is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(j), err_msg=f)


@pytest.mark.parametrize("pcg", [False, True])
def test_fused_engine_checkpoint_resume(tmp_path, pcg):
    """The fused engine resumes from its own checkpoint bit for bit; the PCG
    engine refuses a state without its carries w and rz_prev (what a JAX
    checkpoint holds) instead of resuming on a wrong β."""
    stop = StopConfig(eps_precision=-1, eps_residual=-1, eps_relative=1e-6)
    s = DirichletSolver(nx=32, ny=32, operator="fused", preconditioner="mg" if pcg else None,
                        stop=stop, device="cpu")
    full = s.solve()
    A, M = s._parts
    b = s.problem.rhs_field(device="cpu")

    def run(kw, init_state=None):
        opts = CGOptions(stop=stop, preconditioner=M, **kw)
        return fused_cg_solve(A, b, options=opts, init_state=init_state)

    ckpt = str(tmp_path / "fused.npz")
    first = _interrupted(run, ckpt, every=3 if pcg else 20)
    assert first.reason == StopReason.INTERRUPTED
    state = load_cg_state(ckpt, device="cpu")
    assert (state.w is not None) == pcg and (state.rz_prev is not None) == pcg
    res = run({}, init_state=state)
    assert res.iterations == full.iterations and res.reason == full.stop_reason
    np.testing.assert_array_equal(ordering.pack(res.x, s.domain).numpy(),
                                  full.solution.astype(np.float32))
    if pcg:
        with pytest.raises(ValueError, match="carries"):
            run({}, init_state=state._replace(w=None, rz_prev=None))


def test_load_cg_state_defaults_to_cuda(tmp_path, monkeypatch):
    dom = Domain2D(nx=8, ny=8)
    op = StencilOperator.from_domain(dom)
    b = PoissonProblem.manufactured(dom).rhs_field(device="cpu")
    ckpt = str(tmp_path / "c.npz")
    cg_solve(op, b, options=CGOptions(state_callback=lambda s: save_cg_state(ckpt, s)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_cg_state(ckpt)
    assert load_cg_state(ckpt, dtype=torch.float32, device="cpu").x.dtype == torch.float32

"""CPU parity of the PyTorch port's geometry, assembly and f64 stencil
against the JAX package, plus the port's package contract."""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solvers_tpu.core import ordering as jordering
from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.core.problem import PoissonProblem as JProblem
from iterative_solvers_tpu.kernels.stencil_pallas import PallasStencilOperator
from iterative_solvers_tpu.ops.stencil import StencilOperator as JStencil

import iterative_solvers_tpu_torch as port
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator
from iterative_solvers_tpu_torch.parallel import make_solver_mesh
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [("gamma", 64, 64), ("rect", 40, 24), ("gamma", 6, 6), ("rect", 33, 17)]


@pytest.mark.parametrize("shape,nx,ny", CASES)
def test_masks_equal(shape, nx, ny):
    # geometry is integer predicates: exact equality
    jd = JDomain2D(nx=nx, ny=ny, shape=shape)
    pd = port.Domain2D(nx=nx, ny=ny, shape=shape)
    np.testing.assert_array_equal(pd.interior, np.asarray(jd.interior))
    np.testing.assert_array_equal(pd.boundary, np.asarray(jd.boundary))
    np.testing.assert_array_equal(pd.interior_on("cpu").numpy(), np.asarray(jd.interior))
    np.testing.assert_array_equal(pd.boundary_on("cpu").numpy(), np.asarray(jd.boundary))
    assert pd.num_unknowns == jd.num_unknowns
    assert pd.grid_shape == jd.grid_shape
    assert (pd.coeff_diag, pd.coeff_x, pd.coeff_y) == (jd.coeff_diag, jd.coeff_x, jd.coeff_y)


@pytest.mark.parametrize("shape,nx,ny", CASES)
def test_fields_and_stencil_f64(shape, nx, ny):
    # f64 assembly: only exp() may differ between libraries, by an ulp or so,
    # hence 1e-14 relative to the field's max
    jd = JDomain2D(nx=nx, ny=ny, shape=shape)
    pd = port.Domain2D(nx=nx, ny=ny, shape=shape)
    jp, pp = JProblem.manufactured(jd), port.PoissonProblem.manufactured(pd)
    pairs = [
        (jp.rhs_field(jnp.float64), pp.rhs_field(device="cpu")),
        (jp.true_solution_field(jnp.float64), pp.true_solution_field(device="cpu")),
        (jp.boundary_field(jnp.float64), pp.boundary_field(device="cpu")),
        # the FMG payload's level fields (JAX in-trace assembly): f64, one cast
        (jp.rhs_field_traced(jnp.float32), pp.rhs_field(torch.float32, "cpu")),
        (jp.boundary_field_traced(jnp.float32), pp.boundary_field(torch.float32, "cpu")),
    ]
    for ref, got in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-14 * np.abs(ref).max())
    x = np.random.default_rng(7).standard_normal(jd.grid_shape)
    ref = np.asarray(JStencil.from_domain(jd)(jnp.asarray(x)))
    got = StencilOperator.from_domain(pd)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-14 * np.abs(ref).max())


def test_golden_16x16(golden_16x16):
    # the reference's 6x6 gamma-grid system: A entries are exact small
    # multiples of 36, b is printed to 8 decimals in the reference harness
    A_ref, b_ref = golden_16x16
    dom = port.Domain2D(nx=6, ny=6)
    op = StencilOperator.from_domain(dom)
    idx = np.flatnonzero(dom.interior.ravel())
    cols = []
    for j in range(idx.size):
        e = torch.zeros(dom.grid_shape, dtype=torch.float64)
        e.view(-1)[idx[j]] = 1.0
        cols.append(op(e).view(-1)[idx].numpy())
    np.testing.assert_allclose(np.stack(cols, axis=1), A_ref, atol=1e-12)
    b = port.PoissonProblem.manufactured(dom).rhs_field(device="cpu").view(-1)[idx].numpy()
    np.testing.assert_allclose(b, b_ref, atol=1e-7)


@pytest.mark.parametrize("shape,nx,ny", [("gamma", 64, 64), ("rect", 40, 24), ("gamma", 8192, 8192)])
def test_padded_layout_matches_pallas_operator(shape, nx, ny):
    # the (hp, wp, block_rows) rule is integer arithmetic: exact
    jd = JDomain2D(nx=nx, ny=ny, shape=shape)
    pop = PallasStencilOperator.from_domain(jd, interpret=True)
    lay = PaddedStencilOperator.from_domain(port.Domain2D(nx=nx, ny=ny, shape=shape))
    assert lay.padded_shape == pop.padded_shape
    assert lay.block_rows == pop.block_rows
    assert lay.coeffs == pop.coeffs
    if nx <= 64:
        np.testing.assert_array_equal(lay.interior_padded(), pop.interior_padded())
        f = np.random.default_rng(1).standard_normal(jd.grid_shape)
        padded = lay.pad(torch.from_numpy(f))
        np.testing.assert_array_equal(padded.numpy(), np.asarray(pop.pad(jnp.asarray(f))))
        np.testing.assert_array_equal(lay.crop(padded).numpy(), f)
        np.testing.assert_array_equal(
            lay.mask(padded).numpy(), np.asarray(pop.mask(pop.pad(jnp.asarray(f))))
        )


def test_port_imports_no_jax():
    """Importing every module of the port (the front-ends too: the CLI, the
    TUI, the plots, the native engines, the results files, the checkpoints)
    loads nothing of JAX or of the JAX package, nor matplotlib."""
    port_dir = os.path.join(REPO, "iterative_solvers_tpu_torch")
    modules = sorted(
        "iterative_solvers_tpu_torch." + os.path.relpath(os.path.join(d, f), port_dir)[:-3]
        .replace(os.sep, ".").removesuffix(".__init__")
        for d, _, files in os.walk(port_dir) for f in files
        if f.endswith(".py") and f != "__main__.py")
    for required in ("cli", "tui", "viz", "viz_html", "native.loader", "results_io",
                     "solvers.checkpoint", "config", "report", "profiling", "async_driver"):
        assert f"iterative_solvers_tpu_torch.{required}" in modules
    code = (
        "import importlib, sys; "
        f"[importlib.import_module(m) for m in {modules!r}]; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'iterative_solvers_tpu.', 'matplotlib')) or m == 'iterative_solvers_tpu']; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


def test_port_names_no_path_in_the_jax_package():
    """No file of the port names a path inside the JAX package (its C++
    sources included): the port builds, loads and reads only its own files."""
    port_dir = os.path.join(REPO, "iterative_solvers_tpu_torch")
    bad = []
    for d, _, files in os.walk(port_dir):
        for f in files:
            if f.endswith((".py", ".cpp", ".cu", ".cuh")):
                path = os.path.join(d, f)
                text = open(path, encoding="utf-8").read()
                if re.search(r"iterative_solvers_tpu/|[\'\"]iterative_solvers_tpu[\'\"]", text):
                    bad.append(os.path.relpath(path, REPO))
    assert not bad, bad


_MIXED = dict(preconditioner="mg", precision="mixed", outer="f64", fmg_cycles=0)


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.DirichletSolver(nx=16, ny=16, device="cuda", **_MIXED)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(operator="fused"),
        dict(operator="fused", preconditioner="mg"),
        dict(_MIXED, operator="fused"),
        dict(_MIXED, operator="pallas"),  # the engine ladder (no callback)
        dict(_MIXED, operator="pallas", preconditioner="mg:2"),
    ],
)
def test_unported_options_raise(kwargs):
    """The mesh routes of the sharded fused engine, which raised before it
    was ported (ROADMAP item 14c), now run: ``operator='fused'`` with a
    mesh (MSG CG, PCG) and the engine ladder (``fused``/``pallas`` with
    ``mg`` and ``mixed``, no callback) on a 1-rank mesh converge with the
    single-device facade's stop reason, counts and solution (the mixed
    routes against the single-device ``stencil`` ladder, their only
    single-device form; the layouts coincide at 16², so bit for bit)."""
    got = port.DirichletSolver(nx=16, ny=16, device="cpu", mesh=make_solver_mesh(1),
                               **kwargs).solve()
    single = dict(kwargs, operator="stencil") if kwargs.get("precision") else kwargs
    ref = port.DirichletSolver(nx=16, ny=16, device="cpu", **single).solve()
    assert got.converged
    assert (got.stop_reason, got.iterations, got.outer_iterations) == (
        ref.stop_reason, ref.iterations, ref.outer_iterations)
    np.testing.assert_array_equal(got.solution, ref.solution)


def test_invalid_options_raise_value_error():
    for kwargs in (dict(_MIXED, outer="bogus"), dict(_MIXED, fmg_cycles=-1),
                   dict(_MIXED, preconditioner="mg:x"), dict(_MIXED, precision="half"),
                   dict(_MIXED, operator="fused"), dict(operator="bogus"),
                   dict(operator="fused", preconditioner="jacobi"), dict(outer="ff")):
        with pytest.raises(ValueError):
            port.DirichletSolver(nx=16, ny=16, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="requires inside_fn"):
        port.Domain2D(nx=8, ny=8, shape="custom")


@pytest.mark.parametrize("entry", ["from_domain", "make_preconditioner", "rhs_field",
                                   "boundary_field", "true_solution_field", "fused"])
def test_entry_points_default_to_cuda(monkeypatch, entry):
    """The entry points run on the card unless the caller asks for the CPU:
    without one, their default raises."""
    from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner
    from iterative_solvers_tpu_torch.solvers.precond import make_preconditioner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dom = port.Domain2D(nx=16, ny=16)
    prob = port.PoissonProblem.manufactured(dom)
    call = {
        "from_domain": lambda: MultigridPreconditioner.from_domain(dom),
        "make_preconditioner": lambda: make_preconditioner("mg", None, dom),
        "rhs_field": prob.rhs_field,
        "boundary_field": prob.boundary_field,
        "true_solution_field": prob.true_solution_field,
        "fused": lambda: port.DirichletSolver(nx=16, ny=16, operator="fused"),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_compacted_ordering_matches_jax():
    jd = JDomain2D(nx=6, ny=6)
    pd = port.Domain2D(nx=6, ny=6)
    np.testing.assert_array_equal(
        np.flatnonzero(pd.interior.ravel()), jordering.interior_indices(jd)
    )

"""CPU parity of the port's reference algorithm against the JAX package:
the padded operator's stencil kernel (A1), the plain-CG K2 (A3) and
``DirichletSolver(operator="fused")``, plain and preconditioned.

The JAX side runs its Pallas kernels in interpret mode. Tolerances:

- A1: one f32 stencil per node in the same order on both sides; the
  products may contract or associate differently, so 64 · eps32 · max|y|.
- A3: as K2-pcg in tests/test_torch_kernels.py — fields to 1e-6 · max|ref|,
  the ‖r‖² partials' sum to 1e-5 relative, maxima to 1e-6 relative.
- One carried plain-CG iteration: fields to 1e-5 · max|ref|, scalars to
  1e-5 relative (as the carried PCG iteration in test_torch_kernels.py).
- Solves: the f32 recurrences round alike but reduce in another order, so
  the iteration count must match exactly and x within 1e-5 · max|x|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solvers_tpu import api as japi
from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.kernels.cg_fused import FusedCGEngine as JEngine
from iterative_solvers_tpu.kernels.stencil_pallas import (
    PallasStencilOperator,
    pallas_stencil_apply,
)
from iterative_solvers_tpu.solvers.cg import CGState as JCGState

from iterative_solvers_tpu_torch import DirichletSolver, Domain2D, PoissonProblem
from iterative_solvers_tpu_torch.core.domain import notched_disk
from iterative_solvers_tpu_torch.interop import cg_state_from_arrays
from iterative_solvers_tpu_torch.kernels import cg_fused
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EPS32 = float(np.finfo(np.float32).eps)
SHAPES = [("gamma", 64, 64), ("rect", 40, 50)]
# K2 and the carried iteration also on the notched disk (the JAX package's
# custom-mask test domain at 64²), on 32-row bands with the int8 mask
# operand; their fields are pre-masked, as the JAX custom kernels require
SHAPES_C = SHAPES + [("custom", 64, 64)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _layouts(shape, nx, ny, by=16):
    fn = notched_disk if shape == "custom" else None
    jd = JDomain2D(nx=nx, ny=ny, shape=shape, inside_fn=fn)
    pop = PallasStencilOperator.from_domain(jd, block_rows=by, interpret=True)
    lay = PaddedStencilOperator.from_domain(Domain2D(nx=nx, ny=ny, shape=shape, inside_fn=fn),
                                            block_rows=by)
    return pop, lay


@pytest.mark.parametrize("shape,nx,ny", SHAPES)
def test_stencil_apply_matches_pallas(shape, nx, ny):
    pop, lay = _layouts(shape, nx, ny)
    x = np.random.default_rng(31).standard_normal(pop.padded_shape).astype(np.float32)
    cd, cx, cy = pop.coeffs
    ref = np.asarray(pallas_stencil_apply(
        jnp.asarray(x), nx=nx, ny=ny, cd=cd, cx=cx, cy=cy, block_rows=16,
        mask_mode=shape, interpret=True))
    got = lay(_t(x)).numpy()  # unmasked input: the kernel masks its reads
    np.testing.assert_allclose(got, ref, rtol=0, atol=64 * EPS32 * np.abs(ref).max())
    assert lay.nnz() == pop.nnz()
    with pytest.raises(TypeError):
        lay(_t(x).double())


@pytest.mark.parametrize("shape,nx,ny", SHAPES_C)
@pytest.mark.parametrize("with_u", [False, True])
def test_k2_plain_matches_pallas(shape, nx, ny, with_u):
    pop, lay = _layouts(shape, nx, ny)
    m = pop.interior_padded()
    rng = np.random.default_rng(32)
    x, r, z, u = (rng.standard_normal(pop.padded_shape).astype(np.float32) * m for _ in range(4))
    beta, alpha = np.float32(0.21), np.float32(-3.1e-5)
    eng = JEngine(pop)
    side = eng._call_k1(jnp.asarray(r), jnp.asarray(z), beta)[0]
    ju = jnp.asarray(u) if with_u else None
    outs = eng._call_k2(*(jnp.asarray(a) for a in (x, r, z)), side, ju, alpha, beta)
    x_in = _t(x)
    got = cg_fused.k2(x_in, _t(r), _t(z), _t(np.asarray(side)[:, :2]),
                      torch.tensor([alpha, beta]), lay, u=_t(u) if with_u else None)
    assert len(got) == len(outs) == (6 if with_u else 5)
    for g, ref in zip(got[:3], outs[:3]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(got[3].sum().item(), float(np.asarray(outs[3])[:, 0, 0].sum()),
                               rtol=1e-5)
    for g, ref in zip(got[4:], outs[4:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref)[:, 0, 0], rtol=1e-6)
    np.testing.assert_array_equal(x_in.numpy(), x)  # inputs untouched


@pytest.mark.parametrize("preconditioner", [None, "mg"])
def test_dirichlet_solver_fused_matches_jax(preconditioner):
    """operator='fused' at 32²: plain MSG CG (K1 + K2), or PCG with the
    multigrid (K1 + K2-pcg with the true solution's error partials)."""
    ref = japi.DirichletSolver(nx=32, ny=32, operator="fused",
                               preconditioner=preconditioner).solve()
    s = DirichletSolver(nx=32, ny=32, operator="fused", preconditioner=preconditioner,
                        device="cpu")
    res = s.solve()
    assert (int(res.stop_reason), res.converged, res.iterations) == (
        int(ref.stop_reason), ref.converged, ref.iterations)
    xr = ref.solution
    np.testing.assert_allclose(res.solution, xr, rtol=0, atol=1e-5 * np.abs(xr).max())
    np.testing.assert_allclose(res.error_norm, ref.error_norm, rtol=1e-3)
    # history rows at the same iterations
    h, hr = np.asarray(res.history), np.asarray(ref.history)
    np.testing.assert_array_equal(h[:, 0], hr[:, 0])
    # the final residual is b − A x with A the f32 stencil (A1), as in JAX:
    # it carries that apply's round-off, about eps32 · max|b| per entry
    dom, lay = s.domain, s._parts[0]
    b = PoissonProblem.manufactured(dom).rhs_field(device="cpu")
    x = torch.from_numpy(res.solution_field(dom)).float()
    r = (b - lay.crop(lay(lay.pad(x))).double())[dom.interior_on("cpu")]
    np.testing.assert_array_equal(res.residual, r.numpy())
    np.testing.assert_allclose(res.residual, ref.residual, rtol=0,
                               atol=64 * EPS32 * float(b.abs().max()))


@pytest.mark.parametrize("shape,nx,ny", SHAPES_C)
def test_plain_cg_iteration_from_carried_state(shape, nx, ny):
    """A JAX plain-CG state after one iteration (w and rz_prev None),
    carried through interop; the next fused MSG iteration on both sides."""
    pop, lay = _layouts(shape, nx, ny)
    r = jnp.asarray(np.random.default_rng(33).standard_normal(pop.padded_shape)
                    .astype(np.float32) * pop.interior_padded())
    f32 = jnp.float32
    s = JCGState(
        x=jnp.zeros_like(r), r=r, z=jnp.zeros_like(r), k=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False), reason=jnp.asarray(0, jnp.int32), rz=jnp.asarray(1.0, f32),
        r_norm2=jnp.sum(r * r), prec_max=jnp.asarray(jnp.inf, f32),
        r_max=jnp.max(jnp.abs(r)), err_max=jnp.asarray(jnp.inf, f32),
        r0_norm=jnp.sqrt(jnp.sum(r * r)),
    )
    eng_j = JEngine(pop)
    s = eng_j.iteration(s, None)  # k = 1: the next step has beta != 0
    st = cg_state_from_arrays({k: np.asarray(v) for k, v in s._asdict().items()})
    assert st.w is None and st.rz_prev is None
    s2, st2 = eng_j.iteration(s, None), cg_fused.FusedCGEngine(lay).iteration(st)
    assert st2.k == int(s2.k) == 2 and st2.w is None
    for name in ("x", "r", "z"):
        ref = np.asarray(getattr(s2, name))
        np.testing.assert_allclose(getattr(st2, name).numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    for name in ("rz", "r_norm2", "prec_max", "r_max"):
        np.testing.assert_allclose(getattr(st2, name).item(), float(getattr(s2, name)),
                                   rtol=1e-5)

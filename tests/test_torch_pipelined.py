"""CPU parity of the in-place stencil (C4), the pipelined stencil (C5) and
the SpMV chain against the JAX package; the kernels' range planner, the
side rows they stage, and a plain emulation of their in-place schedule.

On a CPU tensor each wrapper runs its plain torch version; the JAX side runs
``pallas_stencil_apply_inplace`` (C4) and ``pallas_stencil_apply`` (A1, the
function C5 computes: C5 has no interpret path) in interpret mode. The
port's plain versions compute the stencil in the JAX kernels' term order,
but XLA's CPU backend contracts some of those products into FMAs (at 24²
and 20² with 8-row panels it does, at 64² with 16-row panels it does not),
so the two sides agree to 64 eps32 · max|y|, as
tests/test_torch_plain_cg.py holds A1; the port's C4 and C5 plain versions
equal its A1 plain version bit for bit (scale 1). The chain's k applies
carry that per-apply round-off: 64 eps32 · k relative.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_solvers_tpu.core.domain import Domain2D as JDomain2D
from iterative_solvers_tpu.kernels.stencil_pallas import (
    PallasStencilOperator,
    pallas_stencil_apply,
    pallas_stencil_apply_custom,
)
from iterative_solvers_tpu.kernels.stencil_pipelined import pallas_stencil_apply_inplace
from iterative_solvers_tpu.ops.stencil import StencilOperator as JStencil

from iterative_solvers_tpu_torch import Domain2D
from iterative_solvers_tpu_torch.core.domain import notched_disk
from iterative_solvers_tpu_torch.kernels import stencil_pipelined as sp
from iterative_solvers_tpu_torch.kernels.stencil_layout import PaddedStencilOperator
from iterative_solvers_tpu_torch.ops.stencil import StencilOperator, stencil_apply
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EPS32 = float(np.finfo(np.float32).eps)
CASES = [("gamma", 24, 8), ("rect", 20, 8), ("gamma", 64, 16)]


def _layouts(shape, n, block):
    fn = notched_disk if shape == "custom" else None
    jd = JDomain2D(nx=n, ny=n, shape=shape, inside_fn=fn)
    pop = PallasStencilOperator.from_domain(jd, block_rows=block, interpret=True)
    lay = PaddedStencilOperator.from_domain(Domain2D(nx=n, ny=n, shape=shape, inside_fn=fn),
                                            block_rows=block)
    return pop, lay


def _j_inplace(x, pop, scale=1.0):
    cd, cx, cy = pop.coeffs
    return pallas_stencil_apply_inplace(
        jnp.asarray(x), nx=pop.nx, ny=pop.ny, cd=cd, cx=cx, cy=cy,
        block_rows=pop.block_rows, mask_mode=pop.mask_mode, scale=scale, interpret=True)


def _close(got, ref, k=1):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=64 * k * EPS32 * np.abs(ref).max())


@pytest.mark.parametrize("shape,n,block", CASES)
@pytest.mark.parametrize("scale", [1.0, 7e-6])
def test_inplace_matches_pallas_inplace(shape, n, block, scale):
    """C4 on an unmasked random field: JAX's in-place kernel, and the
    overwrite contract (the result lives in x's storage)."""
    pop, lay = _layouts(shape, n, block)
    x = np.random.default_rng(0).standard_normal(lay.padded_shape).astype(np.float32)
    ref = np.asarray(_j_inplace(x, pop, scale))
    xt = torch.from_numpy(x.copy())
    y = sp.stencil_apply_inplace(xt, lay, scale)
    assert y is xt  # written over the caller's tensor
    _close(xt.numpy(), ref)
    a1 = lay.apply_plain(torch.from_numpy(x))
    if scale == 1.0:
        assert torch.equal(xt, a1)
    else:
        assert torch.equal(xt, a1 * scale)


def test_inplace_scale_folded_and_crop():
    """The folded scale on an all-ones canvas (the nnz chain's input), and
    pad -> apply -> crop against both packages' masked-field operators."""
    pop, lay = _layouts("gamma", 16, 8)
    ones = np.ones(lay.padded_shape, np.float32)
    _close(sp.stencil_apply_inplace(torch.from_numpy(ones.copy()), lay, 0.5).numpy(),
           np.asarray(_j_inplace(ones, pop, 0.5)))
    pop, lay = _layouts("gamma", 32, 8)
    dom = Domain2D(nx=32, ny=32)
    f = np.where(dom.interior, np.random.default_rng(2).standard_normal(dom.grid_shape),
                 0.0).astype(np.float32)
    y = lay.crop(sp.stencil_apply_inplace(lay.pad(torch.from_numpy(f)), lay))
    ref = np.asarray(JStencil.from_domain(JDomain2D(nx=32, ny=32))(jnp.asarray(f)))
    _close(y.numpy(), ref)
    assert torch.equal(y, StencilOperator.from_domain(dom)(torch.from_numpy(f)))


def test_inplace_custom_matches_pallas_custom():
    """C4 on the notched disk (32-row bands, the int8 mask): JAX's C1 on the
    pre-masked input that the JAX custom kernels require."""
    pop, lay = _layouts("custom", 64, 32)
    x = np.random.default_rng(4).standard_normal(lay.padded_shape).astype(np.float32)
    x *= lay.interior_padded()
    cd, cx, cy = pop.coeffs
    ref = pallas_stencil_apply_custom(jnp.asarray(x), pop.mask8, cd=cd, cx=cx, cy=cy,
                                      block_rows=32, interpret=True)
    xt = torch.from_numpy(x.copy())
    sp.stencil_apply_inplace(xt, lay)
    _close(xt.numpy(), np.asarray(ref))


@pytest.mark.parametrize("in_place", [True, False])
@pytest.mark.parametrize("lookahead", [2, 4])
def test_pipelined_matches_pallas_apply(in_place, lookahead):
    """C5 computes A1's function: JAX's A1 in interpret mode; in place it
    overwrites x, out of place it leaves x as it was."""
    pop, lay = _layouts("gamma", 64, 16)
    x = np.random.default_rng(5).standard_normal(lay.padded_shape).astype(np.float32)
    cd, cx, cy = pop.coeffs
    ref = np.asarray(pallas_stencil_apply(jnp.asarray(x), nx=64, ny=64, cd=cd, cx=cx, cy=cy,
                                          block_rows=16, mask_mode="gamma", interpret=True))
    xt = torch.from_numpy(x.copy())
    y = sp.stencil_apply_pipelined(xt, lay, in_place=in_place, lookahead=lookahead)
    assert (y is xt) == in_place
    _close(y.numpy(), ref)
    assert torch.equal(y, lay.apply_plain(torch.from_numpy(x)))
    if not in_place:
        np.testing.assert_array_equal(xt.numpy(), x)


@pytest.mark.parametrize("kernel", ["inplace", "pipelined", "stencil"])
def test_spmv_chain_matches_jax_fori_loop(kernel):
    """k = 3 scaled applies from an all-ones canvas, then the sum: the JAX
    bench's chain (a fori_loop of the in-place kernel); x stays as it was."""
    pop, lay = _layouts("gamma", 24, 8)
    x = np.ones(lay.padded_shape, np.float32)
    k, scale = 3, 7e-6
    y = jax.lax.fori_loop(0, k, lambda _, v: _j_inplace(v, pop, scale), jnp.asarray(x))
    xt = torch.from_numpy(x.copy())
    got = sp.spmv_chain(lay, xt, k, scale, kernel=kernel)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(jnp.sum(y)), rtol=64 * k * EPS32)
    np.testing.assert_array_equal(xt.numpy(), x)


def test_inputs_rejected():
    _, lay = _layouts("gamma", 64, 16)
    x = torch.zeros(lay.padded_shape)
    with pytest.raises(TypeError):
        sp.stencil_apply_inplace(x.double(), lay)
    with pytest.raises(ValueError):
        sp.stencil_apply_inplace(x[:, :-128].contiguous(), lay)
    with pytest.raises(ValueError):  # hp % block_rows != 0 (80 rows, 48-row panels)
        sp.stencil_apply_inplace(x, dataclasses.replace(lay, block_rows=48))
    for bad in (dict(lookahead=0), dict(lookahead=sp.MAX_LOOKAHEAD + 1), dict(n_out=0)):
        with pytest.raises(ValueError):
            sp.stencil_apply_pipelined(x, lay, **bad)
    with pytest.raises(ValueError):
        sp.spmv_chain(lay, x, 1, kernel="bogus")


def _ranges(hp, rows):
    return [(r0, min(r0 + rows, hp)) for r0 in range(0, hp, rows)]


@pytest.mark.parametrize("sm_count", [1, 7, 132])
@pytest.mark.parametrize("hp", [8, 40, 80, 1056, 1280, 8256, 8448, 16512])
def test_plan_ranges_cover_every_row_once(hp, sm_count):
    """The ranges tile the canvas's rows exactly once, at most one per SM,
    and (at 32 rows or more) keep the side buffer within 1/16 of the field."""
    rows, n = sp.plan_ranges(hp, sm_count)
    ranges = _ranges(hp, rows)
    assert len(ranges) == n <= sm_count
    assert [i for r0, r1 in ranges for i in range(r0, r1)] == list(range(hp))
    if hp >= sp.MIN_RANGE_ROWS:
        assert 2 * n * 16 <= hp


@pytest.mark.parametrize("by", [256, 64, None])
def test_plan_ranges_fill_the_card_whatever_the_panels(by):
    """At the nnz layout of 8192² (8448 × 8320 on 256- or 64-row panels, and
    8256 × 8320 at auto_block_rows) an H100's 132 SMs each get a range;
    the side buffer stays within 1/16 of the 281 MB field."""
    lay = PaddedStencilOperator.from_domain(Domain2D(nx=8192, ny=8192), block_rows=by)
    if by == 64:  # the 8448-row canvas cut into 64-row panels
        lay = dataclasses.replace(
            PaddedStencilOperator.from_domain(Domain2D(nx=8192, ny=8192), block_rows=256),
            block_rows=64)
    hp, wp = lay.padded_shape
    assert (hp, wp) == ((8256, 8320) if by is None else (8448, 8320))
    rows, n = sp.plan_ranges(hp, 132)
    assert n >= 132 and rows * (n - 1) < hp <= rows * n
    assert n * 2 * wp * 4 <= hp * wp * 4 / 16


@pytest.mark.parametrize("hp,rows", [(80, 24), (80, 40), (96, 7), (64, 64), (64, 100)])
def test_stage_rows_at_any_range_height(hp, rows):
    """The rows just above and below each range (the last one short where
    ``rows`` is not a divisor of ``hp``), zeros off the canvas."""
    x = torch.arange(hp * 128, dtype=torch.float32).view(hp, 128) + 1
    side = sp.stage_rows(x, rows)
    ranges = _ranges(hp, rows)
    assert side.shape == (len(ranges), 2, 128)
    for k, (r0, r1) in enumerate(ranges):
        for e, j in enumerate((r0 - 1, r1)):
            want = x[j] if 0 <= j < hp else torch.zeros(128)
            assert torch.equal(side[k, e], want)


@pytest.mark.parametrize("shape,n,block,sm_count", [
    ("gamma", 64, 16, 3), ("rect", 20, 8, 132), ("custom", 64, 32, 2), ("gamma", 24, 8, 1)])
@pytest.mark.parametrize("scale", [1.0, 7e-6])
def test_inplace_schedule_emulation(shape, n, block, sm_count, scale):
    """The kernels' in-place schedule in plain torch: the side rows staged
    first, then the ranges applied in reversed, then shuffled, order over
    one buffer, each reading only its own rows (still the input's: no other
    range writes them) and its two side rows; equal to C4's plain version
    bit for bit, with ranges of ``plan_ranges`` and of 7 and 13 rows (none
    a panel multiple)."""
    _, lay = _layouts(shape, n, block)
    hp, wp = lay.padded_shape
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((hp, wp)).astype(np.float32))
    want = sp.inplace_plain(x.clone(), lay, scale)
    # the interior with one row off the canvas above and below
    mask = torch.nn.functional.pad(lay.mask_spec.build("cpu"), (0, 0, 1, 1))
    for rows in (sp.plan_ranges(hp, sm_count)[0], 7, 13):
        ranges = _ranges(hp, rows)
        side = sp.stage_rows(x, rows)
        for order in (list(reversed(range(len(ranges)))),
                      random.Random(rows).sample(range(len(ranges)), len(ranges))):
            buf = x.clone()
            for k in order:
                r0, r1 = ranges[k]
                slab = torch.cat([side[k, :1], buf[r0:r1], side[k, 1:]])
                y = stencil_apply(slab, mask[r0 : r1 + 2], *lay.coeffs)[1:-1]
                buf[r0:r1] = y * scale if scale != 1.0 else y
            assert torch.equal(buf, want), (rows, order)

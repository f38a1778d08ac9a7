"""The manufactured families and their seeded draw."""

import pytest
import torch

from portbench import run
from portbench.problems import draw_alphas

Family2D = run.load_module(run.ROOT, "families", "exp_x2my2").Family
Family3D = run.load_module(run.ROOT, "families", "exp_xyz").Family


def _fd_error_2d(alpha, n):
    fam = Family2D(alpha)
    h = 1.0 / n
    x = 1.0 + torch.arange(n + 1, dtype=torch.float64) * h
    Y, X = torch.meshgrid(x, x, indexing="ij")
    u = fam.u(X, Y)
    lap = (u[1:-1, :-2] + u[1:-1, 2:] + u[:-2, 1:-1] + u[2:, 1:-1] - 4 * u[1:-1, 1:-1]) / h**2
    return float((lap - fam.f(X, Y)[1:-1, 1:-1]).abs().max())


def _fd_error_3d(alpha, n):
    fam = Family3D(alpha)
    h = 1.0 / n
    z, y, x = torch.meshgrid(*(torch.arange(n + 1, dtype=torch.float64) * h,) * 3,
                             indexing="ij")
    u = fam.u(x, y, z)
    c = (slice(1, -1),) * 3
    lap = -6 * u[c]
    for a in range(3):
        lo, hi = list(c), list(c)
        lo[a], hi[a] = slice(0, -2), slice(2, None)
        lap = lap + u[tuple(lo)] + u[tuple(hi)]
    return float((lap / h**2 - fam.f(x, y, z)[c]).abs().max())


@pytest.mark.parametrize("alpha", [0.75, 1.0, 1.25])
@pytest.mark.parametrize("err", [_fd_error_2d, _fd_error_3d])
def test_f_is_the_laplacian_of_u(alpha, err):
    """The finite-difference Laplacian of u_α meets f_α at second order."""
    e1, e2 = err(alpha, 32), err(alpha, 64)
    assert e2 < e1 / 3.3


def test_draw_is_seeded_stratified_and_in_range():
    a = draw_alphas(2**31 + 99, 4, 0.75, 1.25, 0.1)
    assert a == draw_alphas(2**31 + 99, 4, 0.75, 1.25, 0.1)
    assert a != draw_alphas(2**31 + 98, 4, 0.75, 1.25, 0.1)
    width = 0.125
    for k, v in enumerate(sorted(a)):
        centre = 0.75 + (k + 0.5) * width
        assert abs(v - centre) <= 0.05 * width + 1e-12

"""The plain reference: its predicates, right-hand side and residual on
small hand cases, and its Chebyshev CG (the control of the f32 cell)."""

import numpy as np
import torch

from portbench import run
from portbench.reference import poisson as R

Family2D = run.load_module(run.ROOT, "families", "exp_x2my2").Family
Family3D = run.load_module(run.ROOT, "families", "exp_xyz").Family

GAMMA = {"kind": "gamma", "x0": 1.0, "x1": 2.0, "y0": 1.0, "y1": 2.0}
BOX = {"kind": "box", "x0": 0.0, "x1": 1.0, "y0": 0.0, "y1": 1.0, "z0": 0.0, "z1": 1.0}


def test_gamma_predicate_by_hand():
    """n = 4: the unknowns are the interior nodes outside the closed
    bottom-left quadrant ix <= 2, iy <= 2."""
    iy, ix = torch.arange(5).view(-1, 1), torch.arange(5).view(1, -1)
    got = {(int(r), int(c)) for r, c in torch.nonzero(R.interior("gamma", 4, (iy, ix)))}
    assert got == {(1, 3), (2, 3), (3, 1), (3, 2), (3, 3)}


def test_box_predicate_by_hand():
    i = torch.arange(4)
    unk = R.interior("box", 3, (i.view(-1, 1, 1), i.view(1, -1, 1), i.view(1, 1, -1)))
    assert int(unk.sum()) == 8 and bool(unk[1:3, 1:3, 1:3].all())


def _dense_solution(dom, n, fam):
    b, unk = R.rhs(dom, n, fam, "cpu")
    idx = torch.nonzero(unk.flatten()).flatten()
    cols = []
    for k in idx:
        e = torch.zeros(unk.numel(), dtype=torch.float64)
        e[k] = 1.0
        cols.append(R.apply(e.view(unk.shape), unk, dom, n).flatten()[idx])
    A = torch.stack(cols, dim=1)
    x = torch.zeros(unk.numel(), dtype=torch.float64)
    x[idx] = torch.linalg.solve(A, b.flatten()[idx])
    return x.view(unk.shape)


def test_residual_of_the_discrete_solution_and_of_zero():
    for dom, n, fam in ((GAMMA, 8, Family2D(1.1)), (BOX, 4, Family3D(0.9))):
        x = _dense_solution(dom, n, fam)
        assert R.rel_residual(x, dom, n, fam) < 1e-13
        assert abs(R.rel_residual(torch.zeros_like(x), dom, n, fam) - 1.0) < 1e-15
        x[tuple(s // 2 + 1 for s in x.shape)] += 1e-3  # one altered unknown
        assert R.rel_residual(x, dom, n, fam) > 1e-6


def test_rhs_matches_the_port():
    """The reference's right-hand side and unknowns, worked out again,
    equal the port's assembly (a cross-check; the reference imports
    nothing of the port)."""
    from iterative_solvers_tpu_torch import Domain2D, Domain3D, PoissonProblem

    for dom, port_dom, fam in ((GAMMA, Domain2D(nx=16, ny=16), Family2D(0.8)),
                               (BOX, Domain3D(8, 8, 8), Family3D(1.2))):
        b, unk = R.rhs(dom, port_dom.nx, fam, "cpu")
        pb = PoissonProblem(port_dom, f=fam.f, u_exact=fam.u).rhs_field(device="cpu")
        assert bool((unk == torch.from_numpy(port_dom.interior)).all())
        assert float((b - pb).abs().max()) <= 1e-12 * float(b.abs().max())


def test_chebyshev_cg_converges_in_f64_and_not_in_bf16():
    fam = Family2D(1.0)
    x64 = R.chebyshev_cg(GAMMA, 32, fam, torch.float64, 8, 60, "cpu")
    assert R.rel_residual(x64, GAMMA, 32, fam) < 1e-9
    x16 = R.chebyshev_cg(GAMMA, 32, fam, torch.bfloat16, 8, 60, "cpu")
    assert R.rel_residual(x16, GAMMA, 32, fam) > 1e-3
    assert np.isfinite(R.rel_residual(x16, GAMMA, 32, fam))

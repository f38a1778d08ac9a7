"""Preconditioner specs (counterpart of iterative_solvers_tpu/solvers/precond.py).

Only the multigrid V-cycle (``"mg[:nu]"``) is ported; Jacobi and Chebyshev
parse but raise on construction."""

from __future__ import annotations

from typing import Tuple


def parse_preconditioner(name: str) -> Tuple[str, int]:
    """Validate a spec string and return (kind, param); param 0 = default."""
    base, _, arg = name.partition(":")
    try:
        param = int(arg) if arg else 0
    except ValueError:
        raise ValueError(f"non-integer parameter in preconditioner spec {name!r}")
    if param < 0:
        raise ValueError(f"negative parameter in preconditioner spec {name!r}")
    if base in ("jacobi", "diag"):
        if arg:
            raise ValueError(f"'jacobi' takes no parameter (got {name!r})")
        return "jacobi", 0
    if base == "chebyshev":
        return "chebyshev", param
    if base in ("mg", "multigrid"):
        return "mg", param
    raise ValueError(
        f"unknown preconditioner {name!r} (use 'jacobi', 'chebyshev[:m]' or 'mg[:nu]')"
    )


def make_preconditioner(name: str, domain, device="cuda"):
    """The preconditioner a spec names, built for ``domain`` (a
    :class:`Domain2D` or :class:`Domain3D`) on ``device`` (``"cuda"`` raises
    without a card)."""
    kind, param = parse_preconditioner(name)
    if kind != "mg":
        raise NotImplementedError(
            f"preconditioner {kind!r} is not ported yet (ROADMAP Queue 1 item 12)"
        )
    from iterative_solvers_tpu_torch.solvers.multigrid import MultigridPreconditioner

    nu = param or 1
    return MultigridPreconditioner.from_domain(domain, nu_pre=nu, nu_post=nu, device=device)

"""Geometric multigrid V-cycle preconditioner (counterpart of iterative_solvers_tpu/solvers/multigrid.py).

One V(ν,ν) cycle of rediscretised multigrid on full-grid masked fields of a
2D domain or a 3D box: weighted-Jacobi smoothing (ω = 0.8), full-weighting
restriction and linear prolongation with R = Pᵀ/2^ndim, and an exact
dense-inverse coarse solve (above ``dense_coarse_limit`` coarsest unknowns,
a fixed-degree Chebyshev one) — a symmetric linear operator, hence PCG-safe.
Fine levels of V(1,1) cycles run the fused down/up kernels on their padded
layouts (kernels/mg_fused.py in 2D, kernels/mg_fused3d.py in 3D), whose
legs also do the lane (2D) or y/x (3D) half of each transfer, which the
JAX package runs outside its kernels, and read and write the child's
field on the child's own input layout, so nothing runs between two fused
levels' kernels; the other levels, and any f64 field, take the plain
torch leg.

The FMG warm start (:meth:`MultigridPreconditioner.fmg_stepwise`) walks the
hierarchy from the exact coarsest solve upwards: BC-aware prolongation of
each level's solution plus a polish — V-cycles up to ``polish_max_extent``,
above it weighted-Jacobi sweeps, which on a fused level run the Jacobi
kernel on the level's padded layout (A7 in 2D, J3 in 3D). The JAX package
can compile the ladder per rung or as one program (its ``combine`` flag);
eager PyTorch runs the same ops in order either way, so the port has the
one form.

Custom-mask 2D domains (``shape="custom"``) coarsen by calling their
``inside_fn`` at each level's own indices, as the JAX package does. Their
fused levels run the masked K_down/K_up (C2, C3) on 32-row bands at least,
and their FMG rungs polish with plain level ops (no Jacobi kernel takes a
mask, as on the TPU).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from iterative_solvers_tpu_torch.core.domain import Domain3D, MaskSpec, resolve_device
from iterative_solvers_tpu_torch.kernels.mg_fused import FusedLevelKernels, lane_prolong
from iterative_solvers_tpu_torch.kernels.mg_fused3d import (
    FusedLevelKernels3D,
    prolong_yx,
    restrict_axis,
    restrict_yx,
)
from iterative_solvers_tpu_torch.kernels.stencil_layout import round_up

F32 = torch.float32


class _MaskCache:
    """Per-device interior masks of one MaskSpec, built on first use."""

    def __init__(self, spec: MaskSpec):
        self.spec = spec
        self._by_device: Dict[torch.device, torch.Tensor] = {}

    def on(self, device) -> torch.Tensor:
        device = torch.device(device)
        m = self._by_device.get(device)
        if m is None:
            m = self._by_device[device] = self.spec.build(device).contiguous()
        return m


def _prolong1d(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Linear interpolation along one axis: even fine nodes copy, odd ones
    average their two coarse neighbours (R = Pᵀ/2 per axis)."""
    nc1 = a.shape[axis]
    left = a.narrow(axis, 0, nc1 - 1)
    right = a.narrow(axis, 1, nc1 - 1)
    shape = list(a.shape)
    shape[axis] = 2 * (nc1 - 1)
    inter = torch.stack([left, 0.5 * (left + right)], dim=axis + 1).reshape(shape)
    return torch.cat([inter, a.narrow(axis, nc1 - 1, 1)], dim=axis)


def restrict_full_weighting(r: torch.Tensor) -> torch.Tensor:
    for ax in range(r.ndim):
        r = restrict_axis(r, ax)
    return r


def prolong_linear(e: torch.Tensor) -> torch.Tensor:
    for ax in range(e.ndim):
        e = _prolong1d(e, ax)
    return e


def _coarsen_domain(d):
    """The next-coarser domain (every interval count halved), or None if it
    cannot be rediscretised."""
    if isinstance(d, Domain3D):
        if d.nx % 2 or d.ny % 2 or d.nz % 2 or min(d.nx, d.ny, d.nz) < 4:
            return None
        return dataclasses.replace(d, nx=d.nx // 2, ny=d.ny // 2, nz=d.nz // 2)
    if d.nx % 2 or d.ny % 2 or min(d.nx, d.ny) < 4:
        return None
    cnx, cny = d.nx // 2, d.ny // 2
    if d.shape == "gamma" and (cnx % 2 or cny % 2):
        return None
    c = d.with_resolution(cnx, cny)
    return c if c.num_unknowns > 0 else None


def _axis_coeffs(d) -> Tuple[float, ...]:
    """The neighbour coefficients in field-axis order: (c_y, c_x) in 2D,
    (c_z, c_y, c_x) in 3D."""
    if isinstance(d, Domain3D):
        return (d.coeff_z, d.coeff_y, d.coeff_x)
    return (d.coeff_y, d.coeff_x)


def _assemble_dense(d) -> Tuple[np.ndarray, np.ndarray]:
    """(interior flat indices, dense f64 matrix) of the coarsest operator."""
    interior = np.asarray(d.interior)
    flat = np.arange(interior.size).reshape(interior.shape)
    idx = np.flatnonzero(interior.ravel())
    n = idx.size
    pos = np.full(interior.size, -1, dtype=np.int64)
    pos[idx] = np.arange(n)
    A = np.zeros((n, n), dtype=np.float64)
    A[np.arange(n), np.arange(n)] = d.coeff_diag
    for axis, c in enumerate(_axis_coeffs(d)):
        lo = [slice(None)] * interior.ndim
        hi = [slice(None)] * interior.ndim
        lo[axis] = slice(None, -1)
        hi[axis] = slice(1, None)
        both = interior[tuple(lo)] & interior[tuple(hi)]
        f_lo = flat[tuple(lo)][both]
        f_hi = flat[tuple(hi)][both]
        A[pos[f_lo], pos[f_hi]] = c
        A[pos[f_hi], pos[f_lo]] = c
    return idx, A


class _Level:
    """Plain torch level: masked stencil and weighted-Jacobi scaling."""

    def __init__(self, mask_spec: MaskSpec, coeffs, omega_over_diag: float):
        self.mask_spec = mask_spec
        self.coeffs = tuple(float(c) for c in coeffs)  # (cd, c_axis0, c_axis1[, c_axis2])
        self.omega_over_diag = float(omega_over_diag)
        self._mask = _MaskCache(mask_spec)

    @property
    def grid_shape(self):
        return tuple(self.mask_spec.shape)

    def interior(self, device) -> torch.Tensor:
        return self._mask.on(device)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Masked stencil apply, the axes' terms added in field-axis order."""
        m = self.interior(x.device)
        xm = torch.where(m, x, 0.0)
        nd = x.ndim
        p = F.pad(xm, (1, 1) * nd)
        y = self.coeffs[0] * xm
        for ax in range(nd):
            lo = tuple(slice(0, -2) if a == ax else slice(1, -1) for a in range(nd))
            hi = tuple(slice(2, None) if a == ax else slice(1, -1) for a in range(nd))
            y = y + self.coeffs[1 + ax] * (p[lo] + p[hi])
        return torch.where(m, y, 0.0)

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.interior(x.device), x, 0.0)


class _CoarseSolveDense:
    """e = A⁻¹ b on the coarsest level: gather, f64 product, scatter. The
    product is a plain ``torch.matmul`` outside any kernel, kept in f64 as
    the JAX package keeps it."""

    def __init__(self, idx: np.ndarray, a_inv: np.ndarray):
        self.idx = np.asarray(idx, np.int64)
        self.a_inv = np.asarray(a_inv, np.float64)
        self._on: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _tensors(self, device):
        device = torch.device(device)
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = (
                torch.as_tensor(self.idx, device=device),
                torch.as_tensor(self.a_inv, device=device),
            )
        return t

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        idx, a_inv = self._tensors(b.device)
        ep = torch.matmul(a_inv, b.reshape(-1)[idx].to(a_inv.dtype)).to(b.dtype)
        out = torch.zeros(b.numel(), dtype=b.dtype, device=b.device)
        out[idx] = ep
        return out.view(b.shape)


class _CoarseSolveChebyshev:
    """A fixed-degree Chebyshev approximation of A⁻¹ on the coarsest level
    (plain torch, as the JAX package's): linear and symmetric, the coarse
    solve where that level has too many unknowns to invert densely."""

    def __init__(self, level: _Level, lam_lo: float, lam_hi: float, degree: int):
        self.level = level
        self.lam_lo, self.lam_hi, self.degree = lam_lo, lam_hi, degree

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        from iterative_solvers_tpu_torch.solvers.precond import chebyshev_apply

        z = chebyshev_apply(self.level.apply, b, self.lam_lo, self.lam_hi, self.degree)
        return self.level.mask(z)


class _FusedLevel:
    """Fine level running the fused down/up kernels on its padded layout;
    the kernels read and write the child's field on the child's own input
    layout (``kernels.coarse_shape``)."""

    def __init__(self, kernels: FusedLevelKernels, h, w, jnp_level: _Level):
        self.kernels = kernels
        self.h, self.w = h, w
        self.ch, self.cw = kernels.ny // 2 + 1, kernels.nx // 2 + 1
        self.jnp_level = jnp_level  # plain leg for non-f32 fields

    @property
    def grid_shape(self):
        return (self.h, self.w)

    def pad_in(self, f: torch.Tensor) -> torch.Tensor:
        hp, wp = self.kernels.padded_shape
        return F.pad(f, (0, wp - self.w, 0, hp - self.h))

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return self.jnp_level.mask(x)


class _FusedLevel3D:
    """Fine 3D level running the fused legs (D3, U3) and the Jacobi sweep
    (J3) on its padded layout; the legs read and write the child's field on
    the child's own input layout (``kernels.coarse_shape``)."""

    def __init__(self, kernels: FusedLevelKernels3D, h: int, w: int, jnp_level: _Level):
        self.kernels = kernels
        self.h, self.w = h, w
        self.jnp_level = jnp_level  # plain leg for non-f32 fields

    @property
    def grid_shape(self):
        return (self.kernels.padded_shape[0], self.h, self.w)

    def pad_in(self, f: torch.Tensor) -> torch.Tensor:
        _, hp, wp = self.kernels.padded_shape
        return F.pad(f, (0, wp - self.w, 0, hp - self.h))

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        return self.jnp_level.mask(x)

    def restrict_yx(self, rr: torch.Tensor) -> torch.Tensor:
        """(dc, hp, wp) z-restricted residual -> (dc, hc, wc) child field
        (the y/x half of D3's restriction, :func:`restrict_yx`)."""
        return restrict_yx(rr, self.h, self.w)

    def prolong_yx(self, ec: torch.Tensor) -> torch.Tensor:
        """(dc, hc, wc) child correction -> (dc, hp, wp) (the y/x half of
        U3's prolongation, :func:`prolong_yx`)."""
        _, hp, wp = self.kernels.padded_shape
        return prolong_yx(ec, self.h, self.w, hp, wp)


def fused_block_rows(h: int, w: int, by_floor: int = 16) -> Tuple[int, int, int]:
    """(block_rows, hp, wp) of a fused level — the JAX package's rule;
    ``by_floor`` is 32 on a custom level (its int8 mask tiling)."""
    by = 64 if h >= 1024 else (32 if h >= 256 else by_floor)
    wp = round_up(w, 128)
    while by > by_floor and 32 * by * wp > 24 * 2**20:
        by //= 2
    return by, round_up(h, by), wp


def fused_layout_3d(d: Domain3D) -> Tuple[int, int, int]:
    """A fused 3D level's padded layout, the JAX package's: exact depth,
    hp = round_up(ny+1, 8), wp = round_up(nx+1, 128)."""
    dz, h, w = d.grid_shape
    return dz, round_up(h, 8), round_up(w, 128)


def _make_fused_3d(d: Domain3D, omega: float, plain: _Level,
                   child_shape: Tuple[int, int, int]) -> _FusedLevel3D:
    k = FusedLevelKernels3D(
        nx=d.nx, ny=d.ny, nz=d.nz, coeffs=(d.coeff_diag, d.coeff_x, d.coeff_y, d.coeff_z),
        cs=omega / d.coeff_diag, padded_shape=fused_layout_3d(d), child_shape=child_shape,
    )
    return _FusedLevel3D(k, d.ny + 1, d.nx + 1, plain)


@dataclass(frozen=True, eq=False)
class MultigridPreconditioner:
    """Callable ``z = M r`` ≈ ``A⁻¹ r``: one V(nu_pre, nu_post) cycle."""

    levels: Tuple[object, ...]
    coarse_solve: Callable
    nu_pre: int = 1
    nu_post: int = 1
    domains: Tuple = ()  # per-level Domain2D/Domain3D (FMG rediscretisation)
    # FMG payload (with_fmg): per level None (finest: the caller's b) or the
    # problem rediscretised on that level, whose f32 RHS and Dirichlet field
    # are assembled where the FMG needs them (as the JAX package evaluates
    # its recipes inside the FMG program). Coarse RHS are rediscretised, not
    # restricted, and the level's Dirichlet values are added before
    # prolongation.
    fmg_data: Optional[Tuple] = None

    @staticmethod
    def from_domain(
        domain,
        *,
        omega: float = 0.8,
        nu_pre: int = 1,
        nu_post: int = 1,
        dense_coarse_limit: int = 2048,
        coarse_chebyshev_degree: int = 48,
        fuse: Optional[bool] = None,
        fuse_min_extent: int = 512,
        device="cuda",
    ) -> "MultigridPreconditioner":
        """Build the hierarchy of a :class:`Domain2D` or :class:`Domain3D`
        for ``device`` (``"cuda"`` raises without a card). ``fuse=None``
        fuses on a CUDA device (as the JAX package fuses on an accelerator);
        ``fuse=True`` on the CPU runs the fused levels through the kernels'
        plain versions. A 3D level fuses from ``ny + 1 >= fuse_min_extent //
        4``, as in the JAX package; its kernels take any depth, so there is
        no z-chunk option (the JAX package's ``fuse_block_z``)."""
        device = resolve_device(device)
        if nu_pre != nu_post:
            raise ValueError(
                "nu_pre must equal nu_post: an asymmetric V-cycle is not a "
                "symmetric operator and silently breaks PCG"
            )
        domains = [domain]
        while True:
            c = _coarsen_domain(domains[-1])
            if c is None:
                break
            domains.append(c)
            if c.num_unknowns <= dense_coarse_limit:
                break
        coarsest = domains[-1]
        if fuse is None:
            fuse = device.type == "cuda"

        def make_level(d):
            return _Level(d.mask_spec, (d.coeff_diag, *_axis_coeffs(d)), omega / d.coeff_diag)

        def fuses(i):
            d = domains[i]
            is3d = isinstance(d, Domain3D)
            return (fuse and nu_pre == 1 and i < len(domains) - 1
                    and d.ny + 1 >= (fuse_min_extent // 4 if is3d else fuse_min_extent))

        # each 2D fused level's layout: (block_rows, padded shape, padded
        # custom interior); a fused child's is where its parent's legs write
        layouts = {}
        for i, d in enumerate(domains):
            if fuses(i) and not isinstance(d, Domain3D):
                custom = d.shape == "custom"
                by, hp, wp = fused_block_rows(*d.grid_shape, 32 if custom else 16)
                layouts[i] = (by, (hp, wp), d.mask_spec.padded((hp, wp)) if custom else None)
        levels = []
        for i, d in enumerate(domains):
            if not fuses(i):
                levels.append(make_level(d))
                continue
            c = domains[i + 1]
            if isinstance(d, Domain3D):
                child = fused_layout_3d(c) if fuses(i + 1) else c.grid_shape
                levels.append(_make_fused_3d(d, omega, make_level(d), child))
                continue
            by, padded, mask8 = layouts[i]
            if i + 1 in layouts:
                child_shape, child_mask8 = layouts[i + 1][1:]
            else:
                child_shape = c.grid_shape
                child_mask8 = c.mask_spec.padded(child_shape) if mask8 is not None else None
            k = FusedLevelKernels(
                nx=d.nx, ny=d.ny, coeffs=(d.coeff_diag, d.coeff_x, d.coeff_y),
                cs=omega / d.coeff_diag, mask_mode=d.shape, padded_shape=padded,
                block_rows=by, mask8=mask8, child_shape=child_shape, child_mask8=child_mask8,
            )
            levels.append(_FusedLevel(k, *d.grid_shape, make_level(d)))
        if coarsest.num_unknowns <= dense_coarse_limit:
            idx, A = _assemble_dense(coarsest)
            coarse = _CoarseSolveDense(idx, np.linalg.inv(A))
        else:
            from iterative_solvers_tpu_torch.solvers.precond import spectral_bounds

            coarse = _CoarseSolveChebyshev(levels[-1], *spectral_bounds(coarsest),
                                           coarse_chebyshev_degree)
        return MultigridPreconditioner(
            levels=tuple(levels), coarse_solve=coarse, nu_pre=nu_pre, nu_post=nu_post,
            domains=tuple(domains),
        )

    def _fused_leg_3d(self, li: int, lev: _FusedLevel3D, bp: torch.Tensor) -> torch.Tensor:
        """D3 onto the child's input layout, the coarser cycle (which returns
        its correction on that layout), U3: no op in between."""
        ec = self._vcycle(li + 1, lev.kernels.down(bp))
        return lev.kernels.up(bp, ec)

    def _fused_leg(self, li: int, lev: _FusedLevel, bp: torch.Tensor, with_dot: bool):
        """K_down onto the child's input layout, the coarser cycle (which
        returns its correction on that layout), K_up: no op in between."""
        ec = self._vcycle(li + 1, lev.kernels.down(bp))
        return lev.kernels.up(bp, ec, with_dot=with_dot)

    def _vcycle(self, li: int, b: torch.Tensor) -> torch.Tensor:
        if li == len(self.levels) - 1:
            return self.coarse_solve(b)
        lev = self.levels[li]
        if isinstance(lev, (_FusedLevel, _FusedLevel3D)):
            if b.dtype == torch.float32:
                # a field already on this level's padded layout skips pad/crop
                padded_in = tuple(b.shape) == tuple(lev.kernels.padded_shape)
                bp = b if padded_in else lev.pad_in(b)
                if isinstance(lev, _FusedLevel3D):
                    out = self._fused_leg_3d(li, lev, bp)
                else:
                    out = self._fused_leg(li, lev, bp, with_dot=False)
                return out if padded_in else out[..., : lev.h, : lev.w]
            lev = lev.jnp_level  # the kernels are f32-only
        # pre-smooth from x = 0: the first sweep is a pure scaling of b
        x = lev.omega_over_diag * b
        for _ in range(self.nu_pre - 1):
            x = x + lev.omega_over_diag * (b - lev.apply(x))
        r = b - lev.apply(x)
        rc = self.levels[li + 1].mask(restrict_full_weighting(r))
        ec = self._vcycle(li + 1, rc)
        x = x + lev.mask(prolong_linear(ec))
        for _ in range(self.nu_post):
            x = x + lev.omega_over_diag * (b - lev.apply(x))
        return x

    # --- FMG warm start ---------------------------------------------------------

    def _apply_at(self, li: int, x: torch.Tensor) -> torch.Tensor:
        """Level-li stencil apply (plain; the fused legs expose none)."""
        lev = self.levels[li]
        return getattr(lev, "jnp_level", lev).apply(x)

    def with_fmg(self, problem) -> "MultigridPreconditioner":
        """A copy carrying the FMG payload for ``problem``: per coarse level
        the problem rediscretised there (its own BC elimination)."""
        if not self.domains:
            raise ValueError("preconditioner built without level domains")
        data = tuple(
            None if li == 0 else dataclasses.replace(problem, domain=d)
            for li, d in enumerate(self.domains)
        )
        return dataclasses.replace(self, fmg_data=data)

    def fmg(self, b: torch.Tensor, n_vcycles: int = 1) -> torch.Tensor:
        """Full-multigrid (nested-iteration) solve: exact coarsest solve,
        then per level BC-aware prolongation plus ``n_vcycles`` V-cycles.
        Without the :meth:`with_fmg` payload, the algebraic variant
        (restricted RHS, zero-BC prolongation)."""
        L = len(self.levels)
        if self.fmg_data is None:
            bs = [b]
            for li in range(L - 1):
                bs.append(self.levels[li + 1].mask(restrict_full_weighting(bs[-1])))
            gs = [None] * L
        else:
            bs = [b] + [p.rhs_field(F32, b.device).to(b.dtype) for p in self.fmg_data[1:]]
            gs = [None] + [p.boundary_field(F32, b.device).to(b.dtype)
                           for p in self.fmg_data[1:]]
        x = self.coarse_solve(bs[-1])
        for li in range(L - 2, -1, -1):
            if gs[li + 1] is not None:
                x = x + gs[li + 1]  # carry Dirichlet values into interpolation
            x = self.levels[li].mask(prolong_linear(x))
            for _ in range(n_vcycles):
                x = x + self._vcycle(li, bs[li] - self._apply_at(li, x))
        return x

    def fmg_stepwise(self, b: torch.Tensor, n_vcycles: int = 1,
                     polish_max_extent: Optional[int] = None,
                     smooth_sweeps: int = 4) -> torch.Tensor:
        """:meth:`fmg` rung by rung; levels whose grid extent exceeds
        ``polish_max_extent`` polish with ``smooth_sweeps`` weighted-Jacobi
        sweeps instead of V-cycles. Requires the :meth:`with_fmg` payload."""
        if self.fmg_data is None:
            raise ValueError("fmg_stepwise requires the with_fmg payload")
        x = self._fmg_rung_coarsest(b)
        for li in range(len(self.levels) - 2, -1, -1):
            nv = int(n_vcycles)
            if polish_max_extent is not None and max(self.domains[li].grid_shape) > polish_max_extent:
                nv = 0
            x = self._fmg_rung(li, nv, int(smooth_sweeps), x, b)
        return x

    def _fmg_rung_coarsest(self, b: torch.Tensor) -> torch.Tensor:
        """Exact solve of the rediscretised coarsest problem (of ``b`` when
        the hierarchy has a single level)."""
        p = self.fmg_data[-1]
        bc = b.to(F32) if p is None else p.rhs_field(F32, b.device)
        return self.coarse_solve(bc)

    def _fmg_rung(self, li: int, n_vcycles: int, n_smooth: int, x: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
        """BC-aware prolongation of the level-``li+1`` solution to level
        ``li`` plus its polish. ``b`` (the finest RHS) is read at li == 0."""
        p = self.fmg_data[li + 1]
        if p is not None:
            x = x + p.boundary_field(F32, x.device).to(x.dtype)
        bl = b.to(F32) if li == 0 else self.fmg_data[li].rhs_field(F32, b.device)
        lev = self.levels[li]
        if (n_vcycles == 0 and n_smooth >= 1 and isinstance(lev, _FusedLevel) and x.dtype == F32
                and lev.kernels.mask8 is None):
            # padded flow: prolong straight into the level's padded layout;
            # the Jacobi kernel masks its reads, so the boundary-interpolated
            # values are discarded exactly as mask(prolong_linear(x)) would
            hp, wp = lev.kernels.padded_shape
            xp = lane_prolong(_prolong1d(x, 0), (lev.w - 1) // 2, wp)
            xp = F.pad(xp, (0, 0, 0, hp - xp.shape[0]))
            bp = lev.pad_in(bl)
            for _ in range(n_smooth):
                xp = lev.kernels.jacobi(xp, bp)
            return xp[: lev.h, : lev.w]
        x = lev.mask(prolong_linear(x))
        if n_vcycles > 0:
            for _ in range(n_vcycles):
                x = x + self._vcycle(li, bl - self._apply_at(li, x))
        elif isinstance(lev, _FusedLevel3D) and x.dtype == F32:
            # the Jacobi kernel J3 on the level's padded layout
            xp, bp = lev.pad_in(x), lev.pad_in(bl)
            for _ in range(n_smooth):
                xp = lev.kernels.jacobi(xp, bp)
            x = xp[:, : lev.h, : lev.w]
        else:
            jl = getattr(lev, "jnp_level", lev)
            for _ in range(n_smooth):
                x = x + jl.omega_over_diag * (bl - self._apply_at(li, x))
        return x

    def accepts_padded(self, shape) -> bool:
        """True when ``shape`` is the fine level's own padded layout."""
        lev0 = self.levels[0]
        return isinstance(lev0, (_FusedLevel, _FusedLevel3D)) and tuple(shape) == tuple(
            lev0.kernels.padded_shape
        )

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        shape0 = self.levels[0].grid_shape
        if tuple(r.shape) != tuple(shape0) and not (
            r.dtype == torch.float32 and self.accepts_padded(r.shape)
        ):
            raise ValueError(f"field shape {tuple(r.shape)} != fine-level grid {shape0}")
        return self._vcycle(0, r)

    def call_with_dot(self, r: torch.Tensor):
        """(z, (r, z)); on a fused padded 2D fine level the dot rides K_up."""
        lev = self.levels[0]
        if isinstance(lev, _FusedLevel) and r.dtype == torch.float32 and self.accepts_padded(
                r.shape):
            return self._fused_leg(0, lev, r, with_dot=True)
        z = self(r)
        return z, torch.sum(r * z)


@dataclass(frozen=True, eq=False)
class PaddedPreconditioner:
    """Runs an unpadded-field preconditioner under a padded layout; fields
    already on the V-cycle's own padded layout pass straight through."""

    inner: MultigridPreconditioner
    padded_op: object  # needs .pad(x) and .crop(x)

    def _passes(self, r: torch.Tensor) -> bool:
        return r.dtype == torch.float32 and self.inner.accepts_padded(r.shape)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if self._passes(r):
            return self.inner(r)
        return self.padded_op.pad(self.inner(self.padded_op.crop(r)))

    def call_with_dot(self, r: torch.Tensor):
        if self._passes(r):
            return self.inner.call_with_dot(r)
        z = self(r)
        return z, torch.sum(r * z)

    def fmg(self, r: torch.Tensor, n_vcycles: int = 1) -> torch.Tensor:
        """FMG initial guess on the padded layout."""
        return self.padded_op.pad(self.inner.fmg(self.padded_op.crop(r), n_vcycles))

    def fmg_stepwise(self, r: torch.Tensor, n_vcycles: int = 1, **kw) -> torch.Tensor:
        """Stepwise FMG initial guess on the padded layout."""
        return self.padded_op.pad(
            self.inner.fmg_stepwise(self.padded_op.crop(r), n_vcycles, **kw)
        )


@dataclass(frozen=True, eq=False)
class ShardedMultigridPreconditioner:
    """The multigrid V-cycle over mesh blocks (``parallel/mesh.py``
    layout). The V-cycle's transfers need the exact ``2^k·n + 1`` node
    extents, so each call gathers the blocks into the global field, crops
    it to the grid, runs the plain hierarchy there (on every rank, the same
    arithmetic) and takes this rank's block of the zero-padded result — the
    JAX package runs the same crop, cycle and pad on global arrays under
    GSPMD. The gather of the fine field does not scale: a limit of the
    port's mesh."""

    inner: MultigridPreconditioner
    grid_shape: Tuple[int, ...]
    mesh: object  # parallel.mesh.SolverMesh

    @staticmethod
    def from_domain(domain, mesh, **kwargs) -> "ShardedMultigridPreconditioner":
        kwargs.setdefault("fuse", False)  # the plain levels, as in the JAX package
        return ShardedMultigridPreconditioner(
            inner=MultigridPreconditioner.from_domain(domain, **kwargs),
            grid_shape=tuple(domain.grid_shape), mesh=mesh,
        )

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self.mesh.global_apply(self.inner, r, self.grid_shape)

    def fmg(self, r: torch.Tensor, n_vcycles: int = 1) -> torch.Tensor:
        """FMG initial guess on the mesh-padded layout."""
        return self.mesh.global_apply(lambda g: self.inner.fmg(g, n_vcycles), r,
                                      self.grid_shape)

    def fmg_stepwise(self, r: torch.Tensor, n_vcycles: int = 1, **kw) -> torch.Tensor:
        """Stepwise FMG initial guess on the mesh-padded layout."""
        return self.mesh.global_apply(lambda g: self.inner.fmg_stepwise(g, n_vcycles, **kw), r,
                                      self.grid_shape)

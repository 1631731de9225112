"""Geometric multigrid preconditioners on structured grids.

The reference preconditions its CG solves with SSOR
(``PoroElasticDisplacementSolver.h:302`` etc.) — a sequential sweep that
cannot vectorize.  The data-parallel answer at scale is a geometric V-cycle
over the structured grid hierarchy, generic over the FE space:

* every level's operator is the two-conv stencil apply (ops/stencil.py)
  built from that level's (uniform) element matrix, Dirichlet-masked;
* smoothers are Chebyshev-accelerated Jacobi (pure applies, no dot products
  — fully parallel, and a *fixed* polynomial, so the V-cycle is a fixed SPD
  linear operator, legal as a CG preconditioner);
* grid transfers are the Q_k finite-element embedding, expressed as
  parity-decomposed stride-k convs (the single dilated-conv formulation
  lowers through space_to_batch, which crashed an XLA backend) with exact
  boundary handling
  via multiplicity normalization; R = P^T exactly;
* the coarsest level is solved exactly with a precomputed dense inverse.

Used for the Q2 elasticity solve (``build_gmg_elasticity``) and the Q1
pressure Jacobian (``build_gmg_pressure``).  Requires the fine cell count
divisible by 2**(n_levels-1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np

import jax
import jax.numpy as jnp

from ..config import InputData
from ..mesh.generator import hyper_rectangle
from ..mesh.qk import build_fe_space
from ..mesh.structured import build_structured_space, structured_mesh
from ..ops import dense
from ..ops.devconst import host_const
from ..ops.shape import node_lattice, shape_tables
from ..ops.stencil import (_scatter_kernel, _to_kernel, conv_cellwise,
                           conv_scatter, make_stencil_apply)
from ..ops import operators as ops
from .discretization import _dirichlet_constraints, _pressure_dirichlet


# ---------------------------------------------------------------------------
# Chebyshev-Jacobi smoother (fixed polynomial in D^{-1} A)
# ---------------------------------------------------------------------------

def chebyshev_smooth(apply_a: Callable, inv_diag, b, degree: int,
                     lmax: float, lmin: float):
    """Approximate A^{-1} b by a degree-``degree`` Chebyshev polynomial of
    the Jacobi-preconditioned operator, targeting [lmin, lmax] of D^{-1}A.
    Starts from x = 0."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    x = inv_diag * b / theta
    r = b - apply_a(x)
    p = x
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        p = (rho_new * rho) * p + (2.0 * rho_new / delta) * (inv_diag * r)
        x = x + p
        r = b - apply_a(x)
        rho = rho_new
    return x


def estimate_lmax(apply_a: Callable, inv_diag, n: int, dtype,
                  iters: int = 60, seed: int = 0) -> float:
    """Upper-bound estimate of lmax(D^{-1}A) via power iteration (run once
    at setup, on device).

    An UNDERestimated lmax makes the Chebyshev smoother AMPLIFY the top
    modes and the whole V-cycle diverges on iteration (observed at 40^3
    before the iteration count was raised), so use plenty of iterations and
    take the max of the Rayleigh quotient and the last growth ratio."""
    key = jax.random.PRNGKey(seed)
    v = jax.random.normal(key, (n,), dtype)
    v = v / jnp.linalg.norm(v)

    def body(_, carry):
        v, _ = carry
        w = inv_diag * apply_a(v)
        growth = jnp.linalg.norm(w)
        return (w / growth, growth)

    v, growth = jax.lax.fori_loop(0, iters, body, (v, jnp.ones((), dtype)))
    w = inv_diag * apply_a(v)
    rq = jnp.vdot(v, w) / jnp.vdot(v, v)
    return float(jnp.maximum(rq, growth))


# ---------------------------------------------------------------------------
# transfers: parity-decomposed Q_k embedding
# ---------------------------------------------------------------------------

def _parity_embedding_matrices(dim: int, degree: int, n_comp: int):
    """Q_degree embedding split per fine-subcell parity: (2^dim, NL, NL)
    with NL = (degree+1)^dim * n_comp."""
    lat = node_lattice(degree, dim).astype(np.float64) / degree  # in [0,1]
    mats = []
    for s in range(2 ** dim):
        bits = [(s >> d) & 1 for d in range(dim)]
        pts = np.stack([(bits[d] + lat[:, d]) / 2.0 for d in range(dim)],
                       axis=-1) * 2.0 - 1.0
        phi, _ = shape_tables(degree, dim, pts)
        nf, nc = phi.shape
        E = np.zeros((nf * n_comp, nc * n_comp))
        for i in range(n_comp):
            E[i::n_comp, i::n_comp] = phi
        mats.append(E)
    return np.stack(mats)


def _prolong_multiplicity_np(E: np.ndarray, fine_conn: np.ndarray,
                             nf: int, dim: int, n_comp: int,
                             n_fine_dofs: int) -> np.ndarray:
    """``raw_p(ones)`` (the per-fine-dof prolongation multiplicity) computed
    host-side: scatter the row-sums of the parity embedding matrices through
    the fine-space connectivity.

    Replaces the eager-jnp evaluation in :func:`build_gmg`, which cost
    ~8-12 small XLA compiles PER LEVEL on the accelerator at setup.
    Bit-for-bit validated against the jnp path for 2D/3D, scalar/vector
    (tests/test_multigrid.py::test_multiplicity_numpy_matches_device).

    Conventions (mesh/structured.py): fine cells are x-fastest
    lexicographic; parity bit d of a fine cell = (coord along axis d) % 2
    with x = bit 0, matching ``_parity_embedding_matrices``."""
    rowsum = E.sum(axis=2)                        # (2^dim, n_local)
    e = np.arange(nf ** dim)
    s = np.zeros(nf ** dim, dtype=np.int64)
    for d in range(dim):
        s |= ((e // nf ** d) % 2) << d
    out = np.zeros(n_fine_dofs)
    np.add.at(out, fine_conn.astype(np.int64).reshape(-1),
              rowsum[s].reshape(-1))
    return out


def _deinterleave_parities(v, dim: int, nc: int):
    """(CH, (2nc)^dim) fine-cell array -> (2^dim, CH, nc^dim) per parity."""
    ch = v.shape[0]
    w = v.reshape((ch,) + tuple(x for _ in range(dim) for x in (nc, 2)))
    perm = [2 * d + 2 for d in range(dim)] + [0] \
        + [2 * d + 1 for d in range(dim)]
    w = w.transpose(perm)
    return w.reshape(2 ** dim, ch, nc ** dim)


def _interleave_parities(vals, dim: int, nc: int):
    """(2^dim, CH, nc^dim) per-parity cell arrays -> (CH, (2nc)^dim)."""
    ch = vals.shape[1]
    v = vals.reshape((2,) * dim + (ch,) + (nc,) * dim)
    perm = [dim]
    for d in range(dim):
        perm += [dim + 1 + d, d]
    v = v.transpose(perm)
    return v.reshape(ch, *((2 * nc,) * dim))


# ---------------------------------------------------------------------------
# Q1 scalar transfers: direct nodal interpolation (no convs)
# ---------------------------------------------------------------------------

def _q1_interp_axis(A, axis: int):
    """Per-axis Q1 embedding: size m+1 -> 2m+1 (even = copy, odd = mean).
    Interleaves via stack+reshape — no strided writes."""
    def sl(s):
        return tuple(s if d == axis else slice(None) for d in range(A.ndim))
    head = A[sl(slice(None, -1))]
    mid = 0.5 * (head + A[sl(slice(1, None))])
    B = jnp.stack([head, mid], axis=axis + 1)
    shp = list(A.shape)
    shp[axis] = 2 * (A.shape[axis] - 1)
    B = B.reshape(shp)
    return jnp.concatenate([B, A[sl(slice(-1, None))]], axis=axis)


def _q1_restrict_axis(A, axis: int):
    """Exact transpose of :func:`_q1_interp_axis`: size 2m+1 -> m+1,
    rc[i] = ev[i] + (od[i-1] + od[i]) / 2.  Even/odd split via reshape —
    no strided reads."""
    def sl(s):
        return tuple(s if d == axis else slice(None) for d in range(A.ndim))
    m = (A.shape[axis] - 1) // 2
    body = A[sl(slice(None, -1))]
    shp = list(A.shape)
    shp[axis:axis + 1] = [m, 2]
    pairs = body.reshape(shp)

    def psl(s0, s1):
        return tuple(s0 if d == axis else (s1 if d == axis + 1 else
                     slice(None)) for d in range(pairs.ndim))
    ev0 = pairs[psl(slice(None), 0)]
    od = pairs[psl(slice(None), 1)]
    ev = jnp.concatenate([ev0, A[sl(slice(-1, None))]], axis=axis)
    zpad = [(0, 0)] * A.ndim
    zpad[axis] = (1, 0)
    od_lo = jnp.pad(od, zpad)
    zpad[axis] = (0, 1)
    od_hi = jnp.pad(od, zpad)
    return ev + 0.5 * (od_lo + od_hi)


def _q1_direct_transfers(dim: int, nc: int, dtype):
    """(raw_prolong, raw_restrict) for the scalar Q1 space on an
    nc-cells-per-axis coarse grid: exact nodal interpolation and its exact
    transpose, as per-axis stack/reshape sweeps.  Replaces the conv
    gather/einsum/scatter + multiplicity-normalization pipeline, which
    runs several small-channel convs per transfer."""
    gc = nc + 1

    def raw_p(xc):
        X = xc.reshape((gc,) * dim)
        for a in range(dim):
            X = _q1_interp_axis(X, a)
        return X.reshape(-1)

    def raw_r(yf):
        Y = yf.reshape((2 * nc + 1,) * dim)
        for a in range(dim):
            Y = _q1_restrict_axis(Y, a)
        return Y.reshape(-1)

    return raw_p, raw_r


# ---------------------------------------------------------------------------
# generic V-cycle builder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Level:
    n_cells: int
    apply: Callable            # Dirichlet-masked operator apply
    inv_diag: jnp.ndarray
    free_mask: jnp.ndarray
    lmax: float
    prolong: Callable = None   # from next-coarser level to this one
    restrict: Callable = None  # from this level to next-coarser
    # optional resident layout (2D parity): the smoother sweeps run inside
    # the layout, conversions happen at the level boundary — a per-apply
    # interleave would cost as much as the apply itself, so a degree-3
    # Chebyshev pays 1 conversion pair per level visit instead of per apply
    lto: Callable = None       # flat -> layout
    lfrom: Callable = None     # layout -> flat
    apply_l: Callable = None   # Dirichlet-masked apply, layout -> layout
    inv_diag_l: jnp.ndarray = None
    # layout-resident transfers: when this level AND the next are
    # layout-resident, the V-cycle recursion never leaves the layout (see
    # ops/parity2d.make_parity_transfers)
    prolong_l: Callable = None   # next-coarser layout -> this layout
    restrict_l: Callable = None  # this layout -> next-coarser layout


def build_gmg(data: InputData, n_fine: int, n_levels: int, dtype,
              element_matrix_fn: Callable[[int], np.ndarray],
              degree: int, n_comp: int,
              free_mask_fn: Callable,
              smoother_degree: int = 3, smoother_precision=None,
              lower=None, upper=None, cycle: int = 1,
              parity_layout: bool = False):
    """Build a V-cycle preconditioner for a Q_degree operator on an
    ``n_fine``-cells-per-axis structured grid.

    Args:
      element_matrix_fn: ``n_cells_per_axis -> (NL, NL)`` uniform-cell
        element matrix of the operator at that level.
      free_mask_fn: ``(mesh, space) -> bool (n_dofs,)`` free-dof mask.
    Returns ``(precond, levels)``.
    """
    dim = data.dim
    sizes = [n_fine // (2 ** l) for l in range(n_levels)]
    for l, s in enumerate(sizes[1:], 1):
        if s * (2 ** l) != n_fine:
            raise ValueError(f"n_fine={n_fine} not divisible for level {l}")

    import jax.lax as lax
    prec = smoother_precision or lax.Precision.HIGHEST
    FULL = lax.Precision.HIGHEST
    # transfers and the coarse solve always run at full precision; only the
    # smoother operator applies honor `smoother_precision`
    E = _parity_embedding_matrices(dim, degree, n_comp)
    n_local = ((degree + 1) ** dim) * n_comp

    levels: List[_Level] = []
    for l, n in enumerate(sizes):
        mesh = structured_mesh(data.domain_size[:dim], n,
                               lower=lower, upper=upper)
        space, _ = build_structured_space(mesh, n, degree)
        free_np = free_mask_fn(mesh, space, n_comp)
        free = host_const(free_np.astype(np.float64), dtype)
        Ke = element_matrix_fn(n)
        raw = make_stencil_apply(Ke, degree, degree, n_comp, n_comp, dim, n,
                                 dtype, precision=prec)
        apply = ops.constrained_apply(raw, free)
        # diagonal: scatter the (uniform) element-matrix diagonal
        conn = space.vector_cell_dofs(n_comp) if n_comp > 1 \
            else space.cell_nodes
        diag_np = np.zeros(space.n_nodes * n_comp)
        np.add.at(diag_np, conn.astype(np.int64).reshape(-1),
                  np.broadcast_to(np.diag(Ke),
                                  (conn.shape[0], n_local)).reshape(-1))
        diag_np = np.where(free_np, diag_np, 1.0)
        inv_diag = host_const(1.0 / diag_np, dtype)
        # rigorous Gershgorin-type upper bound on lmax(D^{-1} A): an
        # UNDERestimate (e.g. a short power iteration) makes the Chebyshev
        # smoother AMPLIFY top modes and the V-cycle diverges on iteration
        # (observed at 40^3); the |row|-sum bound is safe by construction.
        rowsum_np = np.zeros(space.n_nodes * n_comp)
        np.add.at(rowsum_np, conn.astype(np.int64).reshape(-1),
                  np.broadcast_to(np.abs(Ke).sum(axis=1),
                                  (conn.shape[0], n_local)).reshape(-1))
        lmax = float(np.max(np.where(free_np, rowsum_np / diag_np, 1.0)))
        lev = _Level(n_cells=n, apply=apply, inv_diag=inv_diag,
                     free_mask=free, lmax=lmax)
        if parity_layout and l < len(sizes) - 1:
            # resident 2D parity layout for this level's smoother (the
            # coarsest level keeps the flat dense solve)
            if dim != 2 or degree != 2:
                raise NotImplementedError(
                    "parity_layout is 2D Q2 only; got "
                    f"dim={dim}, degree={degree}")
            from ..ops.parity2d import (from_parity, make_apply_parity,
                                        to_parity, to_parity_np)
            raw_l = make_apply_parity(Ke, n, n_comp, dtype, precision=prec)
            # setup constants host-side (to_parity_np): zero eager compiles
            mask_l = host_const(to_parity_np(free_np.astype(np.float64),
                                               n, n_comp), dtype)

            def apply_l(xp, _r=raw_l, _m=mask_l):
                return _m * _r(xp * _m) + (1.0 - _m) * xp

            lev.apply_l = apply_l
            lev.inv_diag_l = host_const(
                to_parity_np(1.0 / diag_np, n, n_comp), dtype)
            lev.lto = (lambda v, _n=n, _c=n_comp: to_parity(v, _n, _c))
            lev.lfrom = (lambda v, _n=n, _c=n_comp: from_parity(v, _n, _c))
        levels.append(lev)
        if l > 0 and degree == 1 and n_comp == 1:
            # scalar Q1: transfers are exact nodal interpolation / its
            # exact transpose — no convs, no multiplicity normalization
            raw_p1, raw_r1 = _q1_direct_transfers(dim, n, dtype)
            fine_free = levels[l - 1].free_mask
            coarse_free = free

            def prolong(xc, _rp=raw_p1, _ff=fine_free, _cf=coarse_free):
                return _rp(xc * _cf) * _ff

            def restrict(rf, _rr=raw_r1, _ff=fine_free, _cf=coarse_free):
                return _rr(rf * _ff) * _cf

            levels[l - 1].prolong = prolong
            levels[l - 1].restrict = restrict
        elif l > 0:
            nc = n
            nf = 2 * nc
            ident_k = host_const(
                _to_kernel(np.eye(n_local), n_comp, degree, dim), dtype)
            scat = host_const(
                _scatter_kernel(n_comp, (degree + 1) ** dim, n_comp, degree,
                                dim), dtype)
            Es = host_const(E, dtype)
            g_c = degree * nc + 1
            g_f = degree * nf + 1

            def raw_p(xc, _Es=Es, _ik=ident_k, _s=scat, _nc=nc, _nf=nf,
                      _gc=g_c):
                uc = conv_cellwise(xc, _ik, degree, dim, n_comp, _gc,
                                   precision=FULL)
                ye = jnp.einsum("sab,bE->saE", _Es, uc, precision=FULL)
                ye_f = _interleave_parities(ye, dim, _nc)
                return conv_scatter(ye_f.reshape(ye.shape[1], -1), _s,
                                    degree, dim, n_comp, _nf,
                                    precision=FULL)

            # multiplicity host-side (was raw_p(ones) eagerly on device:
            # the round-4 147-compile setup storm — see
            # _prolong_multiplicity_np)
            mult_np = _prolong_multiplicity_np(
                E, prev_conn, nf, dim, n_comp,
                levels[l - 1].free_mask.shape[0])
            inv_mult = host_const(1.0 / mult_np, dtype)

            def raw_r(yf, _Es=Es, _ik=ident_k, _s=scat, _nc=nc, _nf=nf,
                      _gf=g_f):
                ye_f = conv_cellwise(yf, _ik, degree, dim, n_comp, _gf,
                                     precision=FULL)
                ye = _deinterleave_parities(ye_f, dim, _nc)
                zc = jnp.einsum("sab,saE->bE", _Es, ye, precision=FULL)
                return conv_scatter(zc, _s, degree, dim, n_comp, _nc,
                                    precision=FULL)

            fine_free = levels[l - 1].free_mask
            coarse_free = free

            # P = diag(ff/mult) raw_p diag(cf); R = P^T exactly
            def prolong(xc, _rp=raw_p, _im=inv_mult, _ff=fine_free,
                        _cf=coarse_free):
                return _rp(xc * _cf) * _im * _ff

            def restrict(rf, _rr=raw_r, _im=inv_mult, _ff=fine_free,
                         _cf=coarse_free):
                return _rr(rf * _im * _ff) * _cf

            levels[l - 1].prolong = prolong
            levels[l - 1].restrict = restrict
            if levels[l - 1].apply_l is not None and lev.apply_l is not None:
                # both level endpoints are parity-resident: give the FINE
                # level layout-resident transfers so the V-cycle recursion
                # never leaves parity layout (same P/R operators — coarse
                # Q2 nodal interpolation and its exact transpose with the
                # same masks — only the dataflow changes)
                from ..ops.parity2d import (make_parity_transfers,
                                            to_parity_np)
                raw_pp, raw_rp, mult_p = make_parity_transfers(
                    nc, n_comp, dtype, precision=FULL)
                ffp = to_parity_np(prev_free_np.astype(np.float64),
                                   nf, n_comp)
                wp = host_const(
                    np.where(mult_p > 0, ffp / np.maximum(mult_p, 1.0),
                             0.0), dtype)
                cfp = host_const(to_parity_np(free_np.astype(np.float64),
                                              nc, n_comp), dtype)

                def prolong_l(xc, _p=raw_pp, _w=wp, _cf=cfp):
                    return _p(xc * _cf) * _w

                def restrict_l(rf, _r=raw_rp, _w=wp, _cf=cfp):
                    return _r(rf * _w) * _cf

                levels[l - 1].prolong_l = prolong_l
                levels[l - 1].restrict_l = restrict_l
        prev_conn = conn          # this level's connectivity: the FINE side
        #                           of the next level's transfer multiplicity
        prev_free_np = free_np

    # coarsest: dense inverse of the masked operator (host, float64)
    n_c = sizes[-1]
    n_coarse_dofs = n_comp * (degree * n_c + 1) ** dim
    if n_coarse_dofs > 20_000:
        raise ValueError(
            f"coarsest level has {n_coarse_dofs} dofs — too large for a "
            "dense inverse; use more levels")
    mesh_c = structured_mesh(data.domain_size[:dim], n_c,
                             lower=lower, upper=upper)
    space_c, _ = build_structured_space(mesh_c, n_c, degree)
    conn_c = space_c.vector_cell_dofs(n_comp) if n_comp > 1 \
        else space_c.cell_nodes
    Ke_c = element_matrix_fn(n_c)
    Kg = dense.assemble_global(
        np.broadcast_to(Ke_c, (mesh_c.n_cells,) + Ke_c.shape), conn_c,
        space_c.n_nodes * n_comp).toarray()
    free_c = free_mask_fn(mesh_c, space_c, n_comp)
    Kg[~free_c, :] = 0.0
    Kg[:, ~free_c] = 0.0
    Kg[np.ix_(~free_c, ~free_c)] = np.eye((~free_c).sum())
    coarse_inv = host_const(np.linalg.inv(Kg), dtype)

    def coarse_solve(r):
        # full precision: a reduced-precision default matmul (bf16/TF32)
        # destroys the exact coarse solve (inverse entries span ~10 orders
        # of magnitude)
        return jnp.dot(coarse_inv, r, precision=lax.Precision.HIGHEST)

    deg = smoother_degree

    def vcycle(l, r, r_in_layout=False):
        lev = levels[l]
        if l == len(levels) - 1:
            return coarse_solve(r)
        lmin = lev.lmax / 8.0   # smooth the upper spectrum only
        if lev.apply_l is not None:
            # resident-layout level: both smoother sweeps and their
            # residuals run inside the layout; with layout-resident
            # transfers (prolong_l/restrict_l) the recursion itself stays
            # in the layout and only the coarsest-parity boundary converts
            # (dots/axpys are layout-exact, see ops/parity2d.py)
            rp = r if r_in_layout else lev.lto(r)
            x = chebyshev_smooth(lev.apply_l, lev.inv_diag_l, rp, deg,
                                 lev.lmax, lmin)
            res_p = rp - lev.apply_l(x)
            nxt = levels[l + 1]
            if lev.restrict_l is not None:
                rc = lev.restrict_l(res_p)              # coarse, in-layout
                xc = vcycle(l + 1, rc, r_in_layout=True)
                for _ in range(cycle - 1):
                    xc = xc + vcycle(l + 1, rc - nxt.apply_l(xc),
                                     r_in_layout=True)
                x = x + lev.prolong_l(xc)
            else:
                rc = lev.restrict(lev.lfrom(res_p))
                xc = vcycle(l + 1, rc)
                for _ in range(cycle - 1):
                    xc = xc + vcycle(l + 1, rc - nxt.apply(xc))
                x = x + lev.lto(lev.prolong(xc))
            x = x + chebyshev_smooth(lev.apply_l, lev.inv_diag_l,
                                     rp - lev.apply_l(x), deg, lev.lmax,
                                     lmin)
            return x if r_in_layout else lev.lfrom(x)
        x = chebyshev_smooth(lev.apply, lev.inv_diag, r, deg, lev.lmax, lmin)
        rc = lev.restrict(r - lev.apply(x))
        # cycle=1: V-cycle; cycle=2: W-cycle (re-residualized recursion —
        # coarser levels cost ~2^-dim each, so the extra visits are cheap)
        xc = vcycle(l + 1, rc)
        nxt = levels[l + 1]
        for _ in range(cycle - 1):
            xc = xc + vcycle(l + 1, rc - nxt.apply(xc))
        x = x + lev.prolong(xc)
        x = x + chebyshev_smooth(lev.apply, lev.inv_diag, r - lev.apply(x),
                                 deg, lev.lmax, lmin)
        return x

    def precond(r):
        return vcycle(0, r)

    if levels[0].apply_l is not None:
        # layout-resident entry point (2D parity mechanics: the rows-layout
        # Richardson solve preconditions without leaving parity layout)
        def precond_rows(rp):
            return vcycle(0, rp, r_in_layout=True)

        precond.rows = precond_rows

    return precond, levels


# ---------------------------------------------------------------------------
# concrete builders
# ---------------------------------------------------------------------------

def _uniform_cell_space(data: InputData, n: int, degree: int,
                        lower=None, upper=None):
    """1-cell space with the level's cell size.  ``lower``/``upper``: the
    grid's actual bounds (cell size must follow the mesh, not
    ``domain_size``, when the grid uses custom bounds — e.g. Mandel's
    quarter domain)."""
    dim = data.dim
    if lower is not None and upper is not None:
        span = np.asarray(upper, float) - np.asarray(lower, float)
    else:
        span = np.asarray(data.domain_size[:dim], float)
    h = [span[d] / n for d in range(dim)]
    cell_mesh = hyper_rectangle(h, cells_per_axis=1)
    return build_fe_space(cell_mesh, degree)


def build_gmg_elasticity(data: InputData, n_fine: int, n_levels: int,
                         dtype, displacement_degree: int = 2,
                         smoother_degree: int = 3,
                         lower=None, upper=None, smoother_precision=None,
                         parity_layout: bool = False):
    """V-cycle for the Dirichlet-masked Q2 elasticity operator."""
    if displacement_degree != 2:
        raise NotImplementedError("GMG transfer assumes Q2 displacement")
    dim = data.dim
    lam, mu = data.lame_constant, data.shear_modulus

    def emat(n):
        su1 = _uniform_cell_space(data, n, 2, lower, upper)
        return dense.elasticity_element_matrices(su1, lam, mu)[0]

    def fmask(mesh, space, n_comp):
        free, _ = _dirichlet_constraints(mesh, space, data)
        return free

    return build_gmg(data, n_fine, n_levels, dtype, emat, 2, dim, fmask,
                     smoother_degree=smoother_degree,
                     smoother_precision=smoother_precision,
                     lower=lower, upper=upper, parity_layout=parity_layout)


def build_gmg_pressure(data: InputData, n_fine: int, n_levels: int, dtype,
                       dt: float, pressure_degree: int = 1,
                       smoother_degree: int = 3,
                       lower=None, upper=None, smoother_precision=None,
                       cycle: int = 1):
    """V-cycle for the pressure Jacobian mass/(M dt) + (k/mu) L.

    Smoother degree 3 (vs 2) improves the per-iteration contraction at
    40^3 from ~0.18 to ~0.04, so a 1e-5 relative solve takes 2-3
    Richardson iterations instead of ~11 CG iterations."""
    def emat(n):
        sp1 = _uniform_cell_space(data, n, pressure_degree, lower, upper)
        Me = dense.mass_element_matrices(sp1)[0]
        Le = dense.laplace_element_matrices(sp1)[0]
        return Me / (data.m_modulus * dt) + (data.perm / data.visc) * Le

    def fmask(mesh, space, n_comp):
        free, _ = _pressure_dirichlet(mesh, space, data)
        return free

    return build_gmg(data, n_fine, n_levels, dtype, emat, pressure_degree,
                     1, fmask, smoother_degree=smoother_degree,
                     smoother_precision=smoother_precision,
                     lower=lower, upper=upper, cycle=cycle)

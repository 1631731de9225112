"""Structured-grid discretization: the gather/scatter-free fast path.

Same :class:`~.discretization.Discretization` interface (so the
FixedStressSolver runs unchanged), but on a uniform structured mesh:

* grid-lexicographic node numbering (mesh/structured.py),
* operator applies through strided-slice gather + interior-pad scatter
  (ops/structured.py) — no XLA gather/scatter instructions,
* constant-Jacobian geometry stored once and broadcast over cells — the
  apply streams essentially only the dof vector.

This is the path the 1M-DOF benchmark configs use; gmsh meshes fall back to
the generic path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax.numpy as jnp

from ..config import InputData
from ..mesh.structured import (GridInfo, build_structured_space,
                               structured_mesh)
from ..ops import operators as ops
from ..ops.quadrature import gauss_tensor
from ..ops.shape import shape_tables
from ..ops.structured import (grid_gather, grid_scatter,
                              uniform_geometry_factors)
from .discretization import (Discretization, _body_force_vector,
                             _dirichlet_constraints, _neumann_vector,
                             _pressure_dirichlet, _well_vector)


@dataclasses.dataclass
class GridDiscretization(Discretization):
    """Discretization with structured strided-slice operator closures."""

    info_p: GridInfo = None
    info_u: GridInfo = None
    gmg_precond: object = None   # V-cycle for the elasticity solve, or None

    def mass(self, p):
        pe = grid_gather(p, self.info_p, 1)[:, 0, :]
        return grid_scatter(ops.mass_core(pe, self.psi_p_at_pq, self.jxw_p),
                            self.info_p, 1)

    def laplace(self, p):
        pe = grid_gather(p, self.info_p, 1)[:, 0, :]
        ye = ops.laplace_core(pe, self.dref_p_at_pq, self.jinv_p, self.jxw_p)
        return grid_scatter(ye, self.info_p, 1)

    def elasticity(self, u):
        ue = grid_gather(u, self.info_u, self.dim)
        ye = ops.elasticity_core(ue, self.dref_u_at_uq, self.jinv_u,
                                 self.jxw_u, self.lam, self.mu)
        return grid_scatter(ye, self.info_u, self.dim)

    def coupling_rhs(self, p, biot_coef):
        pe = grid_gather(p, self.info_p, 1)[:, 0, :]
        ye = ops.coupling_core(pe, self.psi_p_at_uq, self.dref_u_at_uq,
                               self.jinv_u, self.jxw_u, biot_coef)
        return grid_scatter(ye, self.info_u, self.dim)

    def strain_projection_rhs(self, u):
        import jax
        ue = grid_gather(u, self.info_u, self.dim)
        ye = ops.projection_core(ue, self.psi_p_at_pq, self.dref_u_at_pq,
                                 self.jinv_p, self.jxw_p)     # (Np, C, E)
        return jax.vmap(lambda y: grid_scatter(y, self.info_p, 1),
                        in_axes=1, out_axes=0)(ye)


@dataclasses.dataclass
class ConvGridDiscretization(GridDiscretization):
    """Operator applies as two XLA convolutions each (ops/stencil.py).

    The per-cell dense element matrices (constant on a uniform grid) are
    folded into the gather conv kernels at build time.
    """

    stencil_mass: object = None
    stencil_laplace: object = None
    stencil_elasticity: object = None
    stencil_coupling: object = None
    stencil_projection: object = None
    # persistent resident-layout elasticity kit (3D rows:
    # ops/rows3d.ElasticityRowOps; 2D parity: ops/parity2d) — when set, the
    # mechanics CG runs in that layout instead of through the conv stencil
    # (fss._mechanics_solve)
    row_ops: object = None
    # single-cell element matrices (numpy, f64), kept so the sharded
    # production path (parallel/rows.py) can rebuild per-device kernels
    # without re-deriving them
    element_ke: object = None       # (Nu*dim, Nu*dim) elasticity
    element_ce: object = None       # (Nu*dim, Np) pressure coupling
    element_pe: object = None       # (Np*C, Nu*dim) strain-projection
    # optional hook: wraps stencil applies built AFTER construction (the
    # per-dt fused pressure Jacobian) — the sharded path uses it to install
    # its GSPMD sharding constraint on those too
    wrap_pressure_stencil: object = None

    def mass(self, p):
        return self.stencil_mass(p)

    def laplace(self, p):
        return self.stencil_laplace(p)

    def elasticity(self, u):
        return self.stencil_elasticity(u)

    def coupling_rhs(self, p, biot_coef):
        # biot_coef is folded into the kernel at build time (constant)
        return self.stencil_coupling(p)

    def strain_projection_rhs(self, u):
        return self.stencil_projection(u)


def _single_cell_spaces(data: InputData, cells_per_axis,
                        pressure_degree: int, displacement_degree: int,
                        span=None):
    """1-cell mesh with the uniform grid's cell size, for element matrices.

    ``span``: physical extent per axis (defaults to ``data.domain_size``;
    pass the actual mesh bounds when the grid uses custom lower/upper)."""
    from ..mesh.generator import hyper_rectangle, normalize_cells_per_axis
    from ..mesh.qk import build_fe_space
    dim = data.dim
    ns = normalize_cells_per_axis(cells_per_axis, dim)
    if span is None:
        span = data.domain_size
    h = [span[d] / ns[d] for d in range(dim)]
    cell_mesh = hyper_rectangle(h, cells_per_axis=1)
    sp1 = build_fe_space(cell_mesh, pressure_degree)
    su1 = build_fe_space(cell_mesh, displacement_degree)
    return cell_mesh, sp1, su1


def _coupling_element_matrix(cell_mesh, su1, sp1, biot_coef):
    """C_e[(n,i), m] = b ∫ psi_m d phi_n/d x_i dx on the single cell."""
    from ..ops.geometry import geometry_factors
    dim = cell_mesh.dim
    pts, wts = gauss_tensor(su1.degree + 1, dim)
    jinv, jxw = geometry_factors(cell_mesh.vertices[cell_mesh.cells],
                                 pts, wts)
    jinv, jxw = np.asarray(jinv)[0], np.asarray(jxw)[0]   # (Q,m,d), (Q,)
    _, dref_u = shape_tables(su1.degree, dim, pts)
    psi_p, _ = shape_tables(sp1.degree, dim, pts)
    g = np.einsum("qnm,qmd->qnd", dref_u, jinv)           # phys grads
    ce = biot_coef * np.einsum("q,qm,qnd->ndm", jxw, psi_p, g)
    N = dref_u.shape[1]
    return ce.reshape(N * dim, psi_p.shape[1])


def _projection_element_matrix(cell_mesh, su1, sp1):
    """P_e[(i_p * C + c), (m, j)] = ∫ psi_i eps_c(phi_mj) dx."""
    from ..ops.geometry import geometry_factors
    from ..ops.operators import VOIGT_PAIRS
    dim = cell_mesh.dim
    pts, wts = gauss_tensor(sp1.degree + 1, dim)
    jinv, jxw = geometry_factors(cell_mesh.vertices[cell_mesh.cells],
                                 pts, wts)
    jinv, jxw = np.asarray(jinv)[0], np.asarray(jxw)[0]
    _, dref_u = shape_tables(su1.degree, dim, pts)
    psi_p, _ = shape_tables(sp1.degree, dim, pts)
    g = np.einsum("qnm,qmd->qnd", dref_u, jinv)
    pairs = VOIGT_PAIRS[dim]
    Np = psi_p.shape[1]
    Nu = dref_u.shape[1]
    C = len(pairs)
    P = np.zeros((Np * C, Nu * dim))
    for c, (a, b) in enumerate(pairs):
        # eps_c(phi_mj) = 0.5 (delta_ja G[m,b] + delta_jb G[m,a])
        B = np.zeros((len(wts), Nu, dim))
        B[:, :, a] += 0.5 * g[:, :, b]
        B[:, :, b] += 0.5 * g[:, :, a]
        blk = np.einsum("q,qi,qmj->imj", jxw, psi_p, B).reshape(Np, Nu * dim)
        P[c::C, :] = blk  # row (i*C + c)
    return P


def build_grid_discretization(data: InputData,
                              cells_per_axis: Optional[int] = None,
                              pressure_degree: int = 1,
                              displacement_degree: int = 2,
                              dtype=None,
                              lower=None, upper=None,
                              backend: str = "conv",
                              multigrid: str = "auto",
                              elasticity_backend: Optional[str] = None
                              ) -> GridDiscretization:
    from ..mesh.generator import normalize_cells_per_axis
    dim = data.dim
    if cells_per_axis is None:
        cells_per_axis = getattr(data, "cells_per_axis", None) \
            or 2 ** data.initial_refinement_level
    cells_per_axis = normalize_cells_per_axis(cells_per_axis, dim)
    if dtype is None:
        dtype = np.float64 if data.dtype == "float64" else np.float32
    dtype = np.dtype(dtype)

    mesh = structured_mesh(data.domain_size[:dim], cells_per_axis,
                           lower=lower, upper=upper)
    p_space, info_p = build_structured_space(mesh, cells_per_axis,
                                             pressure_degree)
    u_space, info_u = build_structured_space(mesh, cells_per_axis,
                                             displacement_degree)

    pq_pts, pq_wts = gauss_tensor(pressure_degree + 1, dim)
    uq_pts, uq_wts = gauss_tensor(displacement_degree + 1, dim)
    jinv_p, jxw_p = uniform_geometry_factors(mesh.vertices, cells_per_axis,
                                             pq_pts, pq_wts)
    jinv_u, jxw_u = uniform_geometry_factors(mesh.vertices, cells_per_axis,
                                             uq_pts, uq_wts)

    psi_p_at_pq, dref_p_at_pq = shape_tables(pressure_degree, dim, pq_pts)
    psi_p_at_uq, _ = shape_tables(pressure_degree, dim, uq_pts)
    psi_u_at_uq, dref_u_at_uq = shape_tables(displacement_degree, dim, uq_pts)
    _, dref_u_at_pq = shape_tables(displacement_degree, dim, pq_pts)

    conn_p = np.ascontiguousarray(p_space.cell_nodes.T)
    conn_u = np.ascontiguousarray(u_space.vector_cell_dofs(dim).T)

    # physical coordinates of pressure quadrature points (for the well)
    n1_at_pq, _ = shape_tables(1, dim, pq_pts)
    corner_xyz = mesh.vertices[mesh.cells]
    x_q = np.einsum("qv,evd->eqd", n1_at_pq, corner_xyz)
    jxw_p_full = np.broadcast_to(jxw_p.T, (mesh.n_cells, jxw_p.shape[0]))

    f_well = _well_vector(p_space, data, jxw_p_full, psi_p_at_pq, x_q)
    jxw_u_full = np.broadcast_to(jxw_u.T, (mesh.n_cells, jxw_u.shape[0]))
    f_neumann = _neumann_vector(mesh, u_space, data) \
        + _body_force_vector(u_space, data, jxw_u_full, psi_u_at_uq)
    free_np, dirichlet_np = _dirichlet_constraints(mesh, u_space, data)
    free_p_np, dirichlet_p_np = _pressure_dirichlet(mesh, p_space, data)

    lam, mu = data.lame_constant, data.shear_modulus
    from ..ops.devconst import device_const
    jp = lambda a: device_const(a, dtype)  # noqa: E731

    # preconditioner diagonals on the host (numpy path of the *_diagonal
    # dispatchers) — avoids per-shape eager-XLA compiles at setup
    n_pdofs = p_space.n_nodes
    n_udofs = u_space.n_nodes * dim
    diag_mass = ops.mass_diagonal(conn_p, psi_p_at_pq, jxw_p, n_pdofs)
    diag_lap = ops.laplace_diagonal(conn_p, dref_p_at_pq, jinv_p,
                                    jxw_p, n_pdofs)
    diag_el = ops.elasticity_diagonal(conn_u, dref_u_at_uq, jinv_u,
                                      jxw_u, lam, mu, n_udofs)
    diag_el = np.where(free_np, diag_el, 1.0)

    d = GridDiscretization(
        dim=dim, dtype=jnp.dtype(dtype),
        pressure_space=p_space, displacement_space=u_space,
        conn_p=jnp.asarray(conn_p), conn_u=jnp.asarray(conn_u),
        psi_p_at_pq=jp(psi_p_at_pq), dref_p_at_pq=jp(dref_p_at_pq),
        psi_p_at_uq=jp(psi_p_at_uq), dref_u_at_uq=jp(dref_u_at_uq),
        dref_u_at_pq=jp(dref_u_at_pq),
        jinv_u=jp(jinv_u), jxw_u=jp(jxw_u),
        jinv_p=jp(jinv_p), jxw_p=jp(jxw_p),
        free_mask_u=jp(free_np.astype(np.float64)),
        dirichlet_values=jp(dirichlet_np),
        f_neumann=jp(f_neumann), f_well=jp(f_well),
        free_mask_p=jp(free_p_np.astype(np.float64)),
        dirichlet_values_p=jp(dirichlet_p_np),
        diag_mass=jp(diag_mass),
        diag_laplace=jp(diag_lap),
        diag_elasticity=jp(diag_el),
        lam=lam, mu=mu,
        info_p=info_p, info_u=info_u,
    )
    if backend != "conv":
        return d

    # ---- conv-stencil backend: fold element matrices into conv kernels ----
    from ..ops import dense, stencil
    from ..ops.operators import VOIGT_PAIRS
    span = mesh.vertices.max(axis=0) - mesh.vertices.min(axis=0)
    cell_mesh, sp1, su1 = _single_cell_spaces(data, cells_per_axis,
                                              pressure_degree,
                                              displacement_degree,
                                              span=span)
    Me = dense.mass_element_matrices(sp1)[0]
    Le = dense.laplace_element_matrices(sp1)[0]
    Ke = dense.elasticity_element_matrices(su1, lam, mu)[0]
    Ce = _coupling_element_matrix(cell_mesh, su1, sp1, data.biot_coef)
    Pe = _projection_element_matrix(cell_mesh, su1, sp1)
    C = len(VOIGT_PAIRS[dim])
    n = cells_per_axis
    kp, ku = pressure_degree, displacement_degree

    mk = lambda M, kin, kout, ci, co: stencil.make_stencil_apply(  # noqa: E731
        np.asarray(M, np.float64), kin, kout, ci, co, dim, n, dtype)
    st_mass = mk(Me, kp, kp, 1, 1)
    st_lap = mk(Le, kp, kp, 1, 1)
    st_el = mk(Ke, ku, ku, dim, dim)
    st_cp = mk(Ce, kp, ku, 1, dim)
    proj_raw = mk(Pe, ku, kp, dim, C)

    def st_proj(u):
        return proj_raw(u).reshape(-1, C).T     # (C, n_pdofs)

    fields = {f.name: getattr(d, f.name) for f in dataclasses.fields(d)}
    d = ConvGridDiscretization(
        **fields, stencil_mass=st_mass, stencil_laplace=st_lap,
        stencil_elasticity=st_el, stencil_coupling=st_cp,
        stencil_projection=st_proj,
        element_ke=np.asarray(Ke, np.float64),
        element_ce=np.asarray(Ce, np.float64),
        element_pe=np.asarray(Pe, np.float64))

    # ---- row-layout elasticity (the production mechanics apply) ----------
    eb = elasticity_backend or getattr(data, "elasticity_backend", "auto")
    eb = ELASTICITY_BACKEND_ALIASES.get(eb, eb)
    if eb not in ("auto", "conv", "rows", "parity"):
        raise ValueError(f"unknown elasticity backend {eb!r}")
    # 'auto' switches to a resident layout only at production sizes: below
    # the threshold plain conv Jacobi-CG converges fine and the pinned
    # small-deck histories stay bit-for-bit on the conv path
    big = d.n_udofs >= PARITY_AUTO_MIN_UDOFS
    equal = len(set(cells_per_axis)) == 1
    eligible2d = (dim == 2 and displacement_degree == 2
                  and pressure_degree == 1 and equal)
    eligible3d = dim == 3 and displacement_degree == 2 and equal
    if eb == "parity" and not eligible2d:
        raise NotImplementedError(
            "parity elasticity backend needs a 2D Q2/Q1 space with "
            f"equal cells per axis; got dim={dim}, degree="
            f"{displacement_degree}/{pressure_degree}, "
            f"cells={cells_per_axis}")
    if eb == "rows" and not eligible3d:
        raise NotImplementedError(
            "rows elasticity backend needs a 3D Q2 space with equal "
            f"cells per axis; got dim={dim}, degree="
            f"{displacement_degree}, cells={cells_per_axis}")
    if eligible2d and (eb == "parity" or (eb == "auto" and big)):
        # 2D parity-class layout (ops/parity2d.py): persistent
        # de-interleaved dof layout, one matmul per apply
        from ..ops.parity2d import make_parity_ops
        # numpy mask/diag (NOT the jnp fields): setup runs host-side,
        # jnp inputs would cost a device->host pull each
        d.row_ops = make_parity_ops(
            np.asarray(Ke, np.float64), cells_per_axis[0],
            free_np.astype(np.float64), diag_el, dtype=d.dtype,
            coupling_matrix=np.asarray(Ce, np.float64),
            projection_matrix=np.asarray(Pe, np.float64))
    elif eligible3d and (eb == "rows" or (eb == "auto" and big)):
        # 3D comp-major row layout (ops/rows3d.py)
        from ..ops.rows3d import make_row_ops
        d.row_ops = make_row_ops(
            np.asarray(Ke, np.float64), cells_per_axis[0],
            free_np.astype(np.float64), diag_el, dtype=d.dtype,
            coupling_matrix=np.asarray(Ce, np.float64),
            projection_matrix=np.asarray(Pe, np.float64))

    # ---- geometric multigrid for the elasticity solve --------------------
    # (isotropic cell counts only: the V-cycle hierarchy coarsens all axes
    # together; anisotropic grids fall back to the Jacobi/Richardson path)
    # With the 3D row-layout CG available, 'auto' skips elasticity GMG:
    # warm-started row-CG converges in tens of iterations per step at
    # production tolerances, while the 3D Q2 V-cycle is a large program
    # to compile.  'on' still builds it.
    # The 2D parity path is the OPPOSITE regime: plain Jacobi-CG does not
    # converge at production 2D sizes (512^2 hits the 1000-iteration cap —
    # 2D runs are ~10x more cells per axis than 3D, so ~10x the condition
    # number), so the parity path builds GMG with parity-RESIDENT level
    # smoothers and exposes it as gmg_precond_rows.
    parity_rows = d.row_ops is not None and dim == 2
    if d.row_ops is not None and multigrid == "auto" and not parity_rows:
        return d
    if len(set(cells_per_axis)) == 1:
        n_levels = _gmg_levels(cells_per_axis[0], dim, u_space.n_nodes * dim,
                               multigrid)
        if n_levels >= 2:
            from .multigrid import build_gmg_elasticity
            lo = mesh.vertices.min(axis=0)
            hi = mesh.vertices.max(axis=0)
            precond, levels = build_gmg_elasticity(
                data, n_fine=cells_per_axis[0], n_levels=n_levels,
                dtype=dtype, lower=lo, upper=hi,
                parity_layout=parity_rows)
            d.gmg_precond = precond
            if parity_rows:
                d.gmg_precond_rows = getattr(precond, "rows", None)
    elif multigrid == "on":
        raise NotImplementedError(
            "elasticity GMG needs equal cells per axis; got "
            f"{cells_per_axis}")
    return d


def mechanics_backend_name(disc) -> str:
    """The mechanics path the solver ACTUALLY runs on ``disc`` (run logs
    and benchmark records name it, so a change of auto-selection never
    mislabels a result)."""
    ro = getattr(disc, "row_ops", None)
    kind = type(ro).__name__ if ro is not None else None
    if kind == "ElasticityParityOps":
        name = "parity2d (parity-class resident, one-matmul apply)"
        if getattr(disc, "gmg_precond_rows", None) is not None:
            name += " + parity-resident GMG"
        return name
    if kind == "ElasticityRowOps":
        return "rows3d (comp-major row layout, one-matmul apply)"
    if getattr(disc, "gmg_precond", None) is not None:
        return "conv-stencil + GMG-Richardson mechanics"
    return "conv-stencil Jacobi-CG"


# 'auto' switches the mechanics solve to the resident layout (2D parity,
# 3D rows) only at sizes where conv Jacobi-CG stops being competitive;
# below this, small decks (including the pinned golden histories) keep the
# conv path bit-for-bit.  Same philosophy (and value) as _gmg_levels' auto
# threshold.
PARITY_AUTO_MIN_UDOFS = 150_000

# 'pallas' is the deck value that selected the 3D row layout when it ran
# as a hand-written kernel; decks that still say so get the rows backend.
ELASTICITY_BACKEND_ALIASES = {"pallas": "rows"}


def _gmg_levels(n: int, dim: int, n_dofs: int, multigrid: str,
                auto_threshold: int = 150_000, degree: int = 2,
                n_comp: int = None) -> int:
    """Pick the V-cycle depth: the SHALLOWEST hierarchy (divisible cell
    counts, coarse grid >= 4 cells) whose coarsest level is
    dense-invertible (<= 8000 dofs).  'auto' enables GMG only when the
    problem is big enough to amortize setup.

    Shallowest, not deepest: below the dense-solve threshold the exact
    inverse replaces the recursion, so fewer levels can only improve the
    contraction — while each extra level adds a near-constant ~80-100 XLA
    ops of smoother/transfer dispatch per V-cycle (at 512^2, 6 levels with
    the exact 16^2 coarse solve do the same preconditioning work as 8
    levels with 2 levels less dispatch)."""
    if multigrid in ("off", "false", False, None):
        return 1
    if multigrid == "auto" and n_dofs < auto_threshold:
        return 1
    if n_comp is None:
        n_comp = dim
    best = 1
    L = 1
    while True:
        L += 1
        if n % (2 ** (L - 1)) != 0:
            break
        nc = n // (2 ** (L - 1))
        if nc < 4:
            break
        if n_comp * (degree * nc + 1) ** dim <= 8000:
            best = L
            break
    return best

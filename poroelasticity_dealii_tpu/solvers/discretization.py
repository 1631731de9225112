"""Setup: mesh + config -> device-resident discrete problem arrays.

This is the one-time analogue of the reference's ``setup_dofs`` chain
(``PoroelasticityFSS.h:132-151``) plus everything the reference recomputes
every assembly but that is actually constant for a fixed mesh: Jacobian
factors, the well-source FEM vector (``right_hand_side.h:99-116`` via
``PoroElasticPressureSolver.h:142-148``), the Neumann traction vector
(``PoroElasticDisplacementSolver.h:249-277``) and Dirichlet constraint masks
(``PoroElasticDisplacementSolver.h:117-134``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax.numpy as jnp

from ..config import InputData
from ..mesh.core import FESpace, Mesh
from ..mesh.qk import build_fe_space
from ..ops.geometry import geometry_factors
from ..ops.quadrature import gauss_tensor
from ..ops.shape import face_lattice_indices, shape_tables
from ..ops import operators as ops


@dataclasses.dataclass
class Discretization:
    """All arrays the jitted solve path closes over. Immutable after build."""

    dim: int
    dtype: jnp.dtype
    # spaces (host-side, for output/inspection)
    pressure_space: FESpace
    displacement_space: FESpace
    # connectivity — cells-LAST layout (cell index is the minor dim; see
    # ops/operators.py module docstring for why this is load-bearing)
    conn_p: jnp.ndarray        # (Np, E)
    conn_u: jnp.ndarray        # (Nu*dim, E), interleaved comps
    # shape tables (compile-time-constant sized)
    psi_p_at_pq: jnp.ndarray   # (Qp, Np)
    dref_p_at_pq: jnp.ndarray  # (Qp, Np, dim)
    psi_p_at_uq: jnp.ndarray   # (Qu, Np)
    dref_u_at_uq: jnp.ndarray  # (Qu, Nud, dim)
    dref_u_at_pq: jnp.ndarray  # (Qp, Nud, dim)
    # geometry factors, cells-last
    jinv_u: jnp.ndarray        # (Qu, dim, dim, E)
    jxw_u: jnp.ndarray         # (Qu, E)
    jinv_p: jnp.ndarray        # (Qp, dim, dim, E)
    jxw_p: jnp.ndarray         # (Qp, E)
    # boundary conditions
    free_mask_u: jnp.ndarray   # (n_udofs,) 1.0 free / 0.0 dirichlet
    dirichlet_values: jnp.ndarray  # (n_udofs,) 0 on free dofs
    f_neumann: jnp.ndarray     # (n_udofs,)
    f_well: jnp.ndarray        # (n_pdofs,)
    # pressure Dirichlet (drainage) — extension over the reference, which
    # supports none (PoroElasticPressureSolver.h:72)
    free_mask_p: jnp.ndarray       # (n_pdofs,)
    dirichlet_values_p: jnp.ndarray  # (n_pdofs,)
    # preconditioner diagonals
    diag_mass: jnp.ndarray     # (n_pdofs,)
    diag_laplace: jnp.ndarray  # (n_pdofs,)
    diag_elasticity: jnp.ndarray  # (n_udofs,) — dirichlet-masked to 1
    # material scalars
    lam: float
    mu: float
    # hanging-node constraints (AMR meshes only; None = conforming mesh)
    hc_p: object = None
    hc_u: object = None

    # Sizes derive from the ARRAYS, not the FE spaces: the AMR bucketing
    # path (amr/bucketing.py) pads cells/dofs to shape buckets so remeshes
    # reuse compiled executables — solver-visible sizes are then the padded
    # ones, while host consumers (VTK, transfer, Kelly) keep using the
    # spaces' real node counts.  On conforming/structured discretizations
    # the two coincide.
    @property
    def n_pdofs(self) -> int:
        return self.free_mask_p.shape[0]

    @property
    def n_udofs(self) -> int:
        return self.free_mask_u.shape[0]

    @property
    def n_cells(self) -> int:
        return self.conn_p.shape[-1]

    # ---- operator closures (matrix-free) ---------------------------------
    def mass(self, p):
        return ops.apply_mass(p, self.conn_p, self.psi_p_at_pq, self.jxw_p)

    def laplace(self, p):
        return ops.apply_laplace(p, self.conn_p, self.dref_p_at_pq,
                                 self.jinv_p, self.jxw_p)

    def elasticity(self, u):
        return ops.apply_elasticity(u, self.conn_u, self.dref_u_at_uq,
                                    self.jinv_u, self.jxw_u, self.lam, self.mu)

    # ---- constraint helpers (no-ops on conforming meshes) ----------------
    @property
    def _hcp(self):
        from ..amr.constraints import empty_constraints
        if self.hc_p is None:
            self.hc_p = empty_constraints(self.dtype)
        return self.hc_p

    @property
    def _hcu(self):
        from ..amr.constraints import empty_constraints
        if self.hc_u is None:
            self.hc_u = empty_constraints(self.dtype)
        return self.hc_u

    def elasticity_constrained(self, u):
        """Hanging-node + Dirichlet constrained elasticity operator."""
        hc = self._hcu
        return ops.constrained_apply(hc.constrained(self.elasticity),
                                     self.free_mask_u)(u)

    def coupling_rhs(self, p, biot_coef):
        return ops.coupling_rhs(p, self.conn_p, self.conn_u, self.psi_p_at_uq,
                                self.dref_u_at_uq, self.jinv_u, self.jxw_u,
                                biot_coef, self.n_udofs)

    def strain_projection_rhs(self, u):
        return ops.strain_projection_rhs(u, self.conn_u, self.conn_p,
                                         self.psi_p_at_pq, self.dref_u_at_pq,
                                         self.jinv_p, self.jxw_p,
                                         self.n_pdofs)


def _embedded_face_points(local_face: int, pts_f: np.ndarray, dim: int):
    """Map (dim-1)-dimensional face quad points into cell reference coords."""
    d, side = divmod(local_face, 2)
    other = [a for a in range(dim) if a != d]
    n = pts_f.shape[0] if pts_f.ndim else 1
    out = np.zeros((max(n, 1), dim))
    out[:, d] = -1.0 if side == 0 else 1.0
    for k, a in enumerate(other):
        out[:, a] = pts_f[:, k]
    return out


def _neumann_vector(mesh: Mesh, u_space: FESpace, data: InputData) -> np.ndarray:
    """Assemble ∫_face phi_n * value * n_comp ds over all stress boundaries.

    Semantics match the reference exactly: the applied traction on component
    c is ``value * n_c`` (normal-component-scaled scalar, not a raw traction
    vector — quirk documented in SURVEY §2.1.11;
    PoroElasticDisplacementSolver.h:263-273).
    """
    dim = mesh.dim
    ku = u_space.degree
    n_udofs = u_space.n_nodes * dim
    f = np.zeros(n_udofs)
    if not data.stress_boundary_labels:
        return f
    if dim == 1:
        # a 1D "face" is an endpoint: the surface integral degenerates to a
        # point evaluation, ds = 1, outward normal n = -1 (left) / +1
        # (right); contribution = value * n * phi_n(endpoint)
        for local_face in (0, 1):
            sel = mesh.face_local == local_face
            if not sel.any():
                continue
            cells_f = mesh.face_cells[sel]
            ids_f = mesh.face_ids[sel]
            ref = np.array([[-1.0 if local_face == 0 else 1.0]])
            phi_u, _ = shape_tables(ku, 1, ref)            # (1, N)
            normal = -1.0 if local_face == 0 else 1.0
            cell_nodes_f = u_space.cell_nodes[cells_f]     # (F, N)
            for lbl, comp, val in zip(data.stress_boundary_labels,
                                      data.stress_boundary_components,
                                      data.stress_boundary_values):
                m = ids_f == lbl
                if not m.any() or comp != 0:
                    continue
                contrib = val * normal * np.broadcast_to(
                    phi_u[0], cell_nodes_f[m].shape)
                np.add.at(f, cell_nodes_f[m].reshape(-1),
                          contrib.reshape(-1))
        return f
    pts_f, wts_f = gauss_tensor(ku + 1, dim - 1)
    corner_xyz = mesh.vertices[mesh.cells]

    for local_face in range(2 * dim):
        sel = mesh.face_local == local_face
        if not sel.any():
            continue
        cells_f = mesh.face_cells[sel]
        ids_f = mesh.face_ids[sel]
        d, side = divmod(local_face, 2)
        ref_pts = _embedded_face_points(local_face, pts_f, dim)
        # geometry at embedded points
        _, dn1 = shape_tables(1, dim, ref_pts)
        xc = corner_xyz[cells_f]                          # (F, 2^d, dim)
        jac = np.einsum("fvi,qvj->fqij", xc, dn1)         # (F, Q, dim, dim)
        other = [a for a in range(dim) if a != d]
        if dim == 2:
            t = jac[:, :, :, other[0]]
            area = np.linalg.norm(t, axis=-1)
        else:
            t1 = jac[:, :, :, other[0]]
            t2 = jac[:, :, :, other[1]]
            area = np.linalg.norm(np.cross(t1, t2), axis=-1)
        jxw_f = area * wts_f[None, :]
        # unit outward normal ∝ ± row d of J^{-1}
        jinv = np.linalg.inv(jac)
        ndir = jinv[:, :, d, :] * (1.0 if side == 1 else -1.0)
        normal = ndir / np.linalg.norm(ndir, axis=-1, keepdims=True)
        # displacement shape values at the embedded points
        phi_u, _ = shape_tables(ku, dim, ref_pts)          # (Q, Nnodes)
        cell_nodes_f = u_space.cell_nodes[cells_f]         # (F, Nnodes)
        for lbl, comp, val in zip(data.stress_boundary_labels,
                                  data.stress_boundary_components,
                                  data.stress_boundary_values):
            m = ids_f == lbl
            if not m.any():
                continue
            contrib = np.einsum("fq,qn->fn",
                                val * normal[m][:, :, comp] * jxw_f[m], phi_u)
            dofs = cell_nodes_f[m] * dim + comp
            np.add.at(f, dofs.reshape(-1), contrib.reshape(-1))
    return f


def _pressure_dirichlet(mesh: Mesh, p_space: FESpace, data: InputData):
    """First-wins (node) pinning for drainage boundaries (our extension)."""
    n = p_space.n_nodes
    free = np.ones(n, dtype=bool)
    values = np.zeros(n)
    faces_lat = face_lattice_indices(p_space.degree, mesh.dim)
    for lbl, val in zip(data.pressure_boundary_labels,
                        data.pressure_boundary_values):
        sel = mesh.face_ids == lbl
        if not sel.any():
            continue
        for local_face in np.unique(mesh.face_local[sel]):
            m = sel & (mesh.face_local == local_face)
            nodes = np.unique(
                p_space.cell_nodes[mesh.face_cells[m]][:, faces_lat[local_face]])
            newly = free[nodes]
            values[nodes[newly]] = val
            free[nodes[newly]] = False
    return free, values


def _dirichlet_constraints(mesh: Mesh, u_space: FESpace, data: InputData):
    """First-condition-wins Dirichlet (node, component) pinning, matching
    deal.II interpolate_boundary_values into a ConstraintMatrix
    (PoroElasticDisplacementSolver.h:117-134)."""
    dim = mesh.dim
    n_udofs = u_space.n_nodes * dim
    free = np.ones(n_udofs, dtype=bool)
    values = np.zeros(n_udofs)
    faces_lat = face_lattice_indices(u_space.degree, dim)
    for lbl, comp, val in zip(data.displacement_boundary_labels,
                              data.displacement_boundary_components,
                              data.displacement_boundary_values):
        sel = mesh.face_ids == lbl
        if not sel.any():
            continue
        for local_face in np.unique(mesh.face_local[sel]):
            m = sel & (mesh.face_local == local_face)
            nodes = u_space.cell_nodes[mesh.face_cells[m]][:, faces_lat[local_face]]
            dofs = np.unique(nodes.astype(np.int64) * dim + comp)
            newly = free[dofs]
            values[dofs[newly]] = val
            free[dofs[newly]] = False
    return free, values


def _body_force_vector(u_space: FESpace, data: InputData,
                       jxw_u: np.ndarray, psi_u: np.ndarray) -> np.ndarray:
    """Gravity body-force RHS: f[(n,c)] = ∫ phi_n * rho * g_c dx.

    The reference's BodyForces (right_hand_side.h:47-84) is effectively a
    no-op (SURVEY §2.1.2): default direction 3 fails the ``<= dim`` guard in
    2D and would be out of bounds in 3D.  Our default (-1) replicates the
    no-op; setting ``TPU / Gravity direction`` to a valid axis enables the
    intended -9.81*rho load."""
    dim = u_space.mesh.dim
    n_udofs = u_space.n_nodes * dim
    f = np.zeros(n_udofs)
    d = data.gravity_direction
    if d < 0 or d >= dim:
        return f
    fe = np.einsum("eq,qn->en", jxw_u, psi_u) * (-9.81 * data.bulk_density)
    dofs = u_space.cell_nodes.astype(np.int64) * dim + d
    np.add.at(f, dofs.reshape(-1), fe.reshape(-1))
    return f


def _well_vector(p_space: FESpace, data: InputData,
                 jxw_p: np.ndarray, psi_p: np.ndarray,
                 x_q: np.ndarray) -> np.ndarray:
    """FEM RHS of the disc-shaped well source (right_hand_side.h:99-116):
    q(x) = -Q/(pi r²) where x²+y² <= r², else 0.  In 3D the radial distance
    uses the first two coordinates (a vertical line well through the origin);
    the reference asserts dim == 2 and never defines a 3D well."""
    r2 = x_q[..., 0] ** 2 + (x_q[..., 1] ** 2 if x_q.shape[-1] > 1 else 0.0)
    src = np.where(r2 <= data.r_well ** 2,
                   -data.flow_rate / (np.pi * data.r_well ** 2), 0.0)
    fe = np.einsum("eq,qi->ei", jxw_p * src, psi_p)
    f = np.zeros(p_space.n_nodes)
    np.add.at(f, p_space.cell_nodes.reshape(-1), fe.reshape(-1))
    return f


def build_discretization(mesh: Mesh, data: InputData,
                         pressure_degree: int = 1,
                         displacement_degree: int = 2,
                         dtype: Optional[np.dtype] = None) -> Discretization:
    """Build everything. Degrees default to the reference's hardcoded
    Q1 pressure / Q2 displacement (PoroElasticPressureSolver.h:20,
    PoroElasticDisplacementSolver.h:67)."""
    dim = mesh.dim
    if dtype is None:
        dtype = np.float64 if data.dtype == "float64" else np.float32
    dtype = np.dtype(dtype)

    p_space = build_fe_space(mesh, pressure_degree)
    u_space = build_fe_space(mesh, displacement_degree)

    # quadratures: QGauss(fe.degree + 1) per space
    pq_pts, pq_wts = gauss_tensor(pressure_degree + 1, dim)
    uq_pts, uq_wts = gauss_tensor(displacement_degree + 1, dim)

    corner_xyz = mesh.vertices[mesh.cells]
    jinv_p, jxw_p = geometry_factors(corner_xyz, pq_pts, pq_wts)
    jinv_u, jxw_u = geometry_factors(corner_xyz, uq_pts, uq_wts)
    jinv_p, jxw_p = np.asarray(jinv_p), np.asarray(jxw_p)
    jinv_u, jxw_u = np.asarray(jinv_u), np.asarray(jxw_u)

    psi_p_at_pq, dref_p_at_pq = shape_tables(pressure_degree, dim, pq_pts)
    psi_p_at_uq, _ = shape_tables(pressure_degree, dim, uq_pts)
    psi_u_at_uq, dref_u_at_uq = shape_tables(displacement_degree, dim, uq_pts)
    _, dref_u_at_pq = shape_tables(displacement_degree, dim, pq_pts)

    # cells-last layouts for the hot path
    conn_p = np.ascontiguousarray(p_space.cell_nodes.T)
    conn_u = np.ascontiguousarray(u_space.vector_cell_dofs(dim).T)
    t_jinv = lambda a: np.ascontiguousarray(  # (E,Q,m,d) -> (Q,m,d,E)
        np.transpose(np.asarray(a), (1, 2, 3, 0)))  # noqa: E731
    t_jxw = lambda a: np.ascontiguousarray(np.asarray(a).T)  # noqa: E731

    # physical coordinates of pressure quadrature points (for the well)
    n1_at_pq, _ = shape_tables(1, dim, pq_pts)
    x_q = np.einsum("qv,evd->eqd", n1_at_pq, corner_xyz)

    f_well = _well_vector(p_space, data, jxw_p, psi_p_at_pq, x_q)
    f_neumann = _neumann_vector(mesh, u_space, data) \
        + _body_force_vector(u_space, data, jxw_u, psi_u_at_uq)
    free_np, dirichlet_np = _dirichlet_constraints(mesh, u_space, data)
    free_p_np, dirichlet_p_np = _pressure_dirichlet(mesh, p_space, data)

    lam, mu = data.lame_constant, data.shear_modulus

    jp = lambda a: jnp.asarray(np.asarray(a), dtype=dtype)  # noqa: E731

    # preconditioner diagonals: host numpy (f64, cast once below).  Eager
    # jnp here costs ~50 tiny per-shape XLA compiles, which dominated the
    # AMR remesh wall-clock (profiled: ~3.7 s of a ~6 s remesh).
    n_pdofs = p_space.n_nodes
    n_udofs = u_space.n_nodes * dim
    jinv_p_cl, jxw_p_cl = t_jinv(jinv_p), t_jxw(jxw_p)
    jinv_u_cl, jxw_u_cl = t_jinv(jinv_u), t_jxw(jxw_u)
    diag_mass = ops.mass_diagonal(conn_p, psi_p_at_pq, jxw_p_cl, n_pdofs)
    diag_lap = ops.laplace_diagonal(conn_p, dref_p_at_pq, jinv_p_cl,
                                    jxw_p_cl, n_pdofs)
    diag_el = ops.elasticity_diagonal(conn_u, dref_u_at_uq, jinv_u_cl,
                                      jxw_u_cl, lam, mu, n_udofs)
    diag_el = np.where(free_np, diag_el, 1.0)

    d = Discretization(
        dim=dim, dtype=jnp.dtype(dtype),
        pressure_space=p_space, displacement_space=u_space,
        conn_p=jnp.asarray(conn_p), conn_u=jnp.asarray(conn_u),
        psi_p_at_pq=jp(psi_p_at_pq), dref_p_at_pq=jp(dref_p_at_pq),
        psi_p_at_uq=jp(psi_p_at_uq), dref_u_at_uq=jp(dref_u_at_uq),
        dref_u_at_pq=jp(dref_u_at_pq),
        jinv_u=jp(jinv_u_cl), jxw_u=jp(jxw_u_cl),
        jinv_p=jp(jinv_p_cl), jxw_p=jp(jxw_p_cl),
        free_mask_u=jp(free_np.astype(np.float64)),
        dirichlet_values=jp(dirichlet_np),
        f_neumann=jp(f_neumann), f_well=jp(f_well),
        free_mask_p=jp(free_p_np.astype(np.float64)),
        dirichlet_values_p=jp(dirichlet_p_np),
        diag_mass=jp(diag_mass),
        diag_laplace=jp(diag_lap),
        diag_elasticity=jp(diag_el),
        lam=lam, mu=mu,
    )
    return d

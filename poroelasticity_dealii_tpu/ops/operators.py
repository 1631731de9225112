"""Matrix-free FEM operator applies (the hot path).

Replaces the reference's global ``SparseMatrix`` SpMVs and cell-loop assembly
(``PoroElasticPressureSolver.h:96-101,133-139``,
``PoroElasticDisplacementSolver.h:155-291``, ``StrainProjector.h:109-198``)
with sum-factorized on-the-fly quadrature:

    gather dofs -> shared-table contraction (matmul) -> pointwise
    geometric factors -> transpose contraction (matmul) ->
    deterministic segment-sum scatter.

Layout decision (load-bearing): all per-cell arrays are **cells-last**
("structure of arrays"): connectivity ``(n_local, E)``, Jacobian factors
``(Q, dim, dim, E)``, weights ``(Q, E)``.  The cell index is the minor
(contiguous) dimension, so every elementwise op is a long unit-stride
stream and the two big shared-table contractions lower to plain matmuls
``(Q*dim, N) @ (N, comp*E)``.  A cells-first layout leaves trailing dims
of 3/9 that vectorize poorly.

Per apply this reads only O(E*Q*dim^2) Jacobian factors from HBM instead of
O(E*ndof^2) stored element matrices — ~25x less HBM traffic for Q2/3D.

All functions are pure and jit-safe; dtype follows the inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Voigt-style unique symmetric tensor components, in the reference's
# TensorIndexer order (TensorIndexer.h:18-35):
#   2D: xx, xy, yy       3D: xx, xy, xz, yy, yz, zz
VOIGT_PAIRS = {
    1: [(0, 0)],
    2: [(0, 0), (0, 1), (1, 1)],
    3: [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)],
}
# entries of VOIGT_PAIRS that are diagonal (volumetric) / off-diagonal (shear)
VOLUMETRIC_ENTRIES = {1: [0], 2: [0, 2], 3: [0, 3, 5]}
SHEAR_ENTRIES = {1: [], 2: [1], 3: [1, 2, 4]}


def scatter_add(values, conn, n_dofs):
    """Deterministic global assembly: sum per-cell values into a dof vector.

    ``values`` and ``conn`` must have identical shapes (any rank); this is
    the vector path of the reference's
    ``constraints.distribute_local_to_global``.
    """
    return jax.ops.segment_sum(values.reshape(-1), conn.reshape(-1),
                               num_segments=n_dofs)


def _scatter_add_host(values, conn, n_dofs):
    """Host (numpy) twin of :func:`scatter_add` for setup-time assembly."""
    out = np.zeros(n_dofs, dtype=np.asarray(values).dtype)
    np.add.at(out, np.asarray(conn).reshape(-1),
              np.ascontiguousarray(values).reshape(-1))
    return out


# --------------------------------------------------------------------------
# compute cores — local dof values in, local contributions out, cells in the
# trailing (lane) axis.  Shared by the generic gather/scatter wrappers below
# and the structured strided-slice path (ops/structured.py).  Geometry
# factors may broadcast over cells (trailing dim 1) for uniform grids.
#
# The dim-sized contractions with jinv are unrolled into broadcast
# multiply-adds: einsum would lower them to batched 3x3 dots, which run far
# slower than plain fused multiply-add chains.
# --------------------------------------------------------------------------

def _apply_jinv(r, jinv):
    """h[q,i,j,E] = sum_m r[q,m,i,E] * jinv[q,m,j,E] (unrolled over m)."""
    dim = jinv.shape[1]
    return sum(r[:, m, :, None, :] * jinv[:, m, None, :, :]
               for m in range(dim))


def _apply_jinv_T(s, jinv):
    """t[q,m,i,E] = sum_j s[q,i,j,E] * jinv[q,m,j,E] (unrolled over j)."""
    dim = jinv.shape[1]
    return sum(s[:, None, :, j, :] * jinv[:, :, None, j, :]
               for j in range(dim))


def mass_core(pe, psi, jxw):
    """pe (N, E) -> M_e pe (N, E)."""
    v = jnp.einsum("qn,nE->qE", psi, pe)
    return jnp.einsum("qn,qE->nE", psi, jxw * v)


def laplace_core(pe, dref, jinv, jxw):
    """pe (N, E) -> L_e pe (N, E)."""
    dim = jinv.shape[1]
    r = jnp.einsum("qnm,nE->qmE", dref, pe)          # ref gradients
    g = sum(r[:, m, None, :] * jinv[:, m, :, :] for m in range(dim))  # (q,d,E)
    gw = g * jxw[:, None, :]
    t = sum(gw[:, None, d, :] * jinv[:, :, d, :] for d in range(dim))
    return jnp.einsum("qnm,qmE->nE", dref, t)


def elasticity_core(ue, dref, jinv, jxw, lam, mu):
    """ue (N, dim, E) -> K_e ue (N*dim, E).

    K[(n,i),(m,j)] = ∫ eps(phi_ni) : C : eps(phi_mj) with
    C = lambda I⊗I + 2 mu II (the reference's ``isotropic_gassman_tensor``,
    ConstitutiveModel.h:45-57; cell kernel
    PoroElasticDisplacementSolver.h:237-242).  Exploits isotropy as
    sigma = lambda tr(grad u) I + mu (grad u + grad uᵀ) instead of
    materializing the rank-4 tensor.
    """
    Q, N, dim = dref.shape
    E = ue.shape[-1]
    r = jnp.einsum("qnm,niE->qmiE", dref, ue)        # GEMM: (Q*m, N)@(N, i*E)
    h = _apply_jinv(r, jinv)                         # grad u (Q, i, j, E)
    tr = sum(h[:, i, i] for i in range(dim))
    sig = mu * (h + jnp.swapaxes(h, 1, 2))
    eye = jnp.eye(dim, dtype=ue.dtype)[None, :, :, None]
    sig = sig + (lam * tr)[:, None, None, :] * eye
    s = sig * jxw[:, None, None, :]
    t = _apply_jinv_T(s, jinv)
    ye = jnp.einsum("qnm,qmiE->niE", dref, t)        # GEMM: (N, Q*m)@(Q*m, i*E)
    return ye.reshape(N * dim, E)


def coupling_core(pe, psi_p_at_uq, dref_u, jinv_u, jxw_u, biot_coef):
    """pe (Np, E) -> coupling RHS contribution (Nu*dim, E):
    f[(n,i)] = ∫ b p d phi_n/d x_i dx
    (PoroElasticDisplacementSolver.h:227-234)."""
    Q, N, dim = dref_u.shape
    E = pe.shape[-1]
    pv = jnp.einsum("qj,jE->qE", psi_p_at_uq, pe)    # pressure at disp q-pts
    w = biot_coef * jxw_u * pv                       # (Q, E)
    t = w[:, None, None, :] * jinv_u                 # (Q, m, c, E)
    ye = jnp.einsum("qnm,qmcE->ncE", dref_u, t)
    return ye.reshape(N * dim, -1)


def projection_core(ue, psi_p, dref_u_at_pq, jinv_p, jxw_p):
    """ue (Nu, dim, E) -> per-cell projection RHS (Np, C, E):
    rhs[c][i] = ∫ psi_i eps_c(u) dx (StrainProjector.h:159-196)."""
    dim = dref_u_at_pq.shape[2]
    pairs = VOIGT_PAIRS[dim]
    r = jnp.einsum("qnm,niE->qmiE", dref_u_at_pq, ue)
    h = _apply_jinv(r, jinv_p)                       # grad u at pressure q-pts
    eps = 0.5 * (h + jnp.swapaxes(h, 1, 2))
    comps = jnp.stack([eps[:, a, b] for (a, b) in pairs], axis=1)  # (Q,C,E)
    return jnp.einsum("qi,qcE->icE", psi_p, comps * jxw_p[:, None, :])


# --------------------------------------------------------------------------
# generic (unstructured) wrappers — conn (N, E) gather + segment-sum scatter
# --------------------------------------------------------------------------

def apply_mass(p, conn, psi, jxw):
    """y = M p (MatrixCreator::create_mass_matrix,
    PoroElasticPressureSolver.h:96-98)."""
    return scatter_add(mass_core(p[conn], psi, jxw), conn, p.shape[0])


def apply_laplace(p, conn, dref, jinv, jxw):
    """y = L p (MatrixCreator::create_laplace_matrix,
    PoroElasticPressureSolver.h:99-101)."""
    return scatter_add(laplace_core(p[conn], dref, jinv, jxw), conn,
                       p.shape[0])


def apply_elasticity(u, conn_u, dref, jinv, jxw, lam, mu):
    """y = K u for isotropic linear elasticity (see elasticity_core)."""
    Q, N, dim = dref.shape
    E = conn_u.shape[-1]
    ue = u[conn_u].reshape(N, dim, E)                # local (node, comp, cell)
    return scatter_add(elasticity_core(ue, dref, jinv, jxw, lam, mu),
                       conn_u, u.shape[0])


def coupling_rhs(p, conn_p, conn_u, psi_p_at_uq, dref_u, jinv_u, jxw_u,
                 biot_coef, n_udofs):
    ye = coupling_core(p[conn_p], psi_p_at_uq, dref_u, jinv_u, jxw_u,
                       biot_coef)
    return scatter_add(ye, conn_u, n_udofs)


def strain_projection_rhs(u, conn_u, conn_p, psi_p, dref_u_at_pq, jinv_p,
                          jxw_p, n_pdofs):
    """All unique strain components in one sweep; returns (n_voigt, n_pdofs)."""
    Q, N, dim = dref_u_at_pq.shape
    E = conn_u.shape[-1]
    ue = u[conn_u].reshape(N, dim, E)
    ye = projection_core(ue, psi_p, dref_u_at_pq, jinv_p, jxw_p)
    return jax.vmap(lambda y: scatter_add(y, conn_p, n_pdofs),
                    in_axes=1, out_axes=0)(ye)


# --------------------------------------------------------------------------
# diagonals (Jacobi preconditioning)
# --------------------------------------------------------------------------

def mass_diagonal(conn, psi, jxw, n_dofs):
    """Dispatches on input type like ops/geometry.py: numpy in -> numpy out
    (setup stays on the host — eager jnp here would trigger a fresh XLA
    compile of every tiny op per mesh shape, which dominated the AMR remesh
    cost), jnp in -> jnp out."""
    xp, scat = ((jnp, scatter_add) if isinstance(conn, jnp.ndarray)
                else (np, _scatter_add_host))
    de = xp.einsum("qE,qn->nE", jxw, psi * psi)
    de = xp.broadcast_to(de, conn.shape)            # uniform-grid E=1 case
    return scat(de, conn, n_dofs)


def laplace_diagonal(conn, dref, jinv, jxw, n_dofs):
    xp, scat = ((jnp, scatter_add) if isinstance(conn, jnp.ndarray)
                else (np, _scatter_add_host))
    g = xp.einsum("qnm,qmdE->qndE", dref, jinv)
    de = xp.einsum("qE,qndE->nE", jxw, g * g)
    de = xp.broadcast_to(de, conn.shape)
    return scat(de, conn, n_dofs)


def elasticity_diagonal(conn_u, dref, jinv, jxw, lam, mu, n_udofs):
    """diag K[(n,c)] = ∫ [lam G_nc² + mu (Σ_j G_nj² + G_nc²)] dx."""
    xp, scat = ((jnp, scatter_add) if isinstance(conn_u, jnp.ndarray)
                else (np, _scatter_add_host))
    Q, N, dim = dref.shape
    g = xp.einsum("qnm,qmdE->qndE", dref, jinv)     # physical gradients
    g2 = g * g
    sum_g2 = xp.sum(g2, axis=2, keepdims=True)
    de = xp.einsum("qE,qncE->ncE", jxw, (lam + mu) * g2 + mu * sum_g2)
    de = xp.broadcast_to(de.reshape(N * dim, -1), conn_u.shape)
    return scat(de, conn_u, n_udofs)


# --------------------------------------------------------------------------
# Dirichlet-constrained operator wrapper
# --------------------------------------------------------------------------

def constrained_apply(apply_fn, free_mask):
    """Restrict an SPD operator to the free-dof subspace.

    Equivalent to the reference's keep-constrained-dofs assembly +
    ``ConstraintMatrix`` condensation (PoroElasticDisplacementSolver.h:279-286):
    constrained rows/columns are zeroed and replaced by the identity, so CG
    iterates only move on free dofs while the operator stays SPD.
    """
    def apply(x):
        xm = x * free_mask
        y = apply_fn(xm)
        return y * free_mask + x * (1.0 - free_mask)
    return apply

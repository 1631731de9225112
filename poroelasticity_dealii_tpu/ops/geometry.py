"""Batched isoparametric geometry factors.

For every (cell, quadrature point) pair this computes, in one vectorized
sweep, what deal.II's ``FEValues::reinit`` recomputes per cell inside the
assembly loops (reference ``PoroElasticDisplacementSolver.h:209``,
``StrainProjector.h:162-163``): the Q1 cell-map Jacobian, its inverse and
``JxW`` weights.  These (E, Q, dim, dim) arrays are the *only* per-cell
operator state the matrix-free applies read — O(E·Q·dim²) HBM traffic per
apply instead of O(E·ndof²) for stored element matrices.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .quadrature import gauss_tensor
from .shape import shape_tables


def geometry_factors(corner_xyz, quad_points, quad_weights):
    """Jacobian factors of the isoparametric Q1 map at quadrature points.

    Args:
      corner_xyz: ``(E, 2**dim, dim)`` cell corner coordinates.
      quad_points: ``(Q, dim)`` reference points in [-1, 1]^dim.
      quad_weights: ``(Q,)`` reference weights.

    Returns:
      ``(jinv (E, Q, dim, dim), jxw (E, Q))`` with
      ``jinv[m, d] = (J^{-1})[m, d]`` so that
      ``grad_x phi[d] = sum_m jinv[m, d] * grad_ref phi[m]``.

    Dispatches on input type: numpy in -> numpy out (setup stays on the
    host, with no device dispatch), jnp in -> jnp out.
    """
    xp = jnp if isinstance(corner_xyz, jnp.ndarray) else np
    dim = corner_xyz.shape[-1]
    dtype = corner_xyz.dtype
    _, dn1 = shape_tables(1, dim, np.asarray(quad_points))
    dn1 = xp.asarray(dn1, dtype=dtype)             # (Q, 2**dim, dim)
    w = xp.asarray(np.asarray(quad_weights), dtype=dtype)

    # J[e,q,i,j] = d x_i / d xi_j
    jac = xp.einsum("evi,qvj->eqij", corner_xyz, dn1)
    if dim == 1:
        det = jac[..., 0, 0]
        jinv = (1.0 / det)[..., None, None]
    elif dim == 2:
        a, b = jac[..., 0, 0], jac[..., 0, 1]
        c, d = jac[..., 1, 0], jac[..., 1, 1]
        det = a * d - b * c
        inv_det = 1.0 / det
        jinv = xp.stack([
            xp.stack([d * inv_det, -b * inv_det], axis=-1),
            xp.stack([-c * inv_det, a * inv_det], axis=-1),
        ], axis=-2)
    else:
        # explicit adjugate: cheaper than a batched tiny LU
        a = jac
        c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
        c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
        c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
        c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
        c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
        c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
        c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
        c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
        c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        det = (a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02)
        inv_det = 1.0 / det
        jinv = xp.stack([
            xp.stack([c00, c10, c20], axis=-1),
            xp.stack([c01, c11, c21], axis=-1),
            xp.stack([c02, c12, c22], axis=-1),
        ], axis=-2) * inv_det[..., None, None]
    jxw = det * w[None, :]
    return jinv, jxw


def make_quadrature(degree_plus_one: int, dim: int):
    """Gauss rule matching the reference's ``QGauss<dim>(fe.degree + 1)``."""
    return gauss_tensor(degree_plus_one, dim)

"""Gather/scatter-free element access on structured grids.

With grid-lexicographic node numbering (mesh/structured.py), the per-cell
local view of a field is, for each of the (k+1)^dim local lattice offsets, a
stride-k slice of the node grid — and the transpose (assembly scatter) is a
``lax.pad`` with interior padding k-1 followed by adds.  Both are dense,
fully-vectorized data movements; XLA gather/scatter ops (which serialize
on accumulation conflicts) never appear.

On a uniform grid the Jacobian is also constant, so geometry factors enter
as cells-broadcast ``(Q, dim, dim, 1)`` arrays: an operator apply then
streams only the dof vector itself — the memory floor.

All functions here take/return the same cells-last shapes as the compute
cores in ops/operators.py, which they share with the unstructured path.
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp
from jax import lax

import numpy as np

from ..mesh.structured import GridInfo
from ..ops.shape import node_lattice


def _grid_shape(info: GridInfo):
    return tuple(reversed(info.nodes_per_axis))   # (z, y, x) ordering, x last


def grid_gather(x, info: GridInfo, n_comp: int):
    """dof vector (n_nodes * n_comp,) -> local view (N, n_comp, E).

    E enumerates cells x-fastest (matching the mesh cell ordering);
    components are interleaved in the dof vector (node * n_comp + comp).
    """
    dim, k, ns = info.dim, info.degree, info.cells_per_axis
    gs = _grid_shape(info)
    X = x.reshape(*gs, n_comp)
    X = jnp.moveaxis(X, -1, 0)                       # (comp, z, y, x)
    lat = node_lattice(k, dim)                       # (N, dim) x-first
    views = []
    for off in lat:
        idx = [slice(None)]                          # comp axis
        for d in range(dim - 1, -1, -1):             # z, y, x axis order
            o = int(off[d])
            idx.append(slice(o, o + k * (ns[d] - 1) + 1, k))
        views.append(X[tuple(idx)].reshape(n_comp, -1))
    return jnp.stack(views, axis=0)                  # (N, comp, E)


def grid_scatter(ye, info: GridInfo, n_comp: int):
    """Local contributions (N * n_comp, E) -> assembled dof vector.

    The transpose of :func:`grid_gather`: each local-offset slab is
    interior-padded back onto the node grid and accumulated.
    """
    dim, k, ns = info.dim, info.degree, info.cells_per_axis
    gs = info.nodes_per_axis
    lat = node_lattice(k, dim)
    N = lat.shape[0]
    y = ye.reshape(N, n_comp, *reversed(ns))         # (N, comp, z, y, x)
    zero = jnp.zeros((), ye.dtype)
    acc = None
    for a, off in enumerate(lat):
        cfg = [(0, 0, 0)]                            # comp axis
        for d in range(dim - 1, -1, -1):             # z, y, x
            o = int(off[d])
            hi = gs[d] - (o + k * (ns[d] - 1) + 1)
            cfg.append((o, hi, k - 1))
        padded = lax.pad(y[a], zero, cfg)            # (comp, gz, gy, gx)
        acc = padded if acc is None else acc + padded
    out = jnp.moveaxis(acc, 0, -1)                   # (gz, gy, gx, comp)
    return out.reshape(-1)


def make_structured_ops(info_p: GridInfo, info_u: GridInfo, dim: int):
    """Bind gather/scatter closures for the pressure (Q1) and displacement
    (Q2) grids."""
    gather_p = partial(grid_gather, info=info_p, n_comp=1)
    gather_u = partial(grid_gather, info=info_u, n_comp=dim)
    scatter_p = partial(grid_scatter, info=info_p, n_comp=1)
    scatter_u = partial(grid_scatter, info=info_u, n_comp=dim)
    return gather_p, gather_u, scatter_p, scatter_u


def uniform_geometry_factors(mesh_vertices: np.ndarray, cells_per_axis,
                             quad_points, quad_weights):
    """Geometry factors of ONE cell of a uniform grid, cells-broadcast.

    Returns ``jinv (Q, dim, dim, 1)``, ``jxw (Q, 1)`` suitable for the
    shared compute cores (they broadcast over the trailing cell axis).
    ``cells_per_axis``: int or per-axis counts (anisotropic grids).
    """
    from .geometry import geometry_factors
    lo = mesh_vertices.min(axis=0)
    hi = mesh_vertices.max(axis=0)
    dim = lo.shape[0]
    h = (hi - lo) / np.asarray(cells_per_axis, np.float64)
    corners = np.array(np.indices([2] * dim).reshape(dim, -1).T[:, ::-1],
                       dtype=np.float64) * h
    jinv, jxw = geometry_factors(corners[None], quad_points, quad_weights)
    jinv_t = np.transpose(np.asarray(jinv), (1, 2, 3, 0))   # (Q, m, d, 1)
    jxw_t = np.asarray(jxw).T                               # (Q, 1)
    return jinv_t, jxw_t

"""Interface-scaled domain decomposition: sharded DOF vectors + ghost halos.

The scalable successor to :class:`.sharding.ShardedDiscretization`, whose
replicate-everything / full-vector ``psum`` per apply moves O(n_dofs) bytes
per operator application.  Here the collective volume per apply is
O(interface):

* cells keep their (spatially sorted) order and are partitioned into
  ``n_dev`` contiguous chunks — a slab domain decomposition;
* DOFs are **renumbered by first-touching cell** (the deal.II
  ``DoFRenumbering::subdomain_wise`` analogue), so each chunk touches one
  contiguous DOF band; each device owns the equal chunk
  ``[d*C, (d+1)*C)`` of the renumbered vector;
* every operator apply runs inside one ``jax.shard_map``:
  two ``ppermute``s pull the halo bands (H entries) from the two slab
  neighbours, the unmodified element kernels from :mod:`..ops.operators`
  run on window-local connectivity, and two more ``ppermute``s return the
  halo *contributions* to their owners — 4·H exchanged values per device
  per apply, independent of the interior size;
* DOF vectors stay sharded ``P('cells')`` through the whole CG loop
  (elementwise solver algebra needs no communication; dot products lower
  to scalar ``all-reduce``s).

The reference is fully serial (SURVEY §2), so this is the data-parallel
analogue of MPI-parallel FEM with ghosted ``PETScWrappers::MPI::Vector``s,
not a port.  tests/test_ghost_sharding.py asserts the compiled HLO moves
halo-scaled (O(n²)), not volume-scaled (O(n³)), bytes per apply.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import operators as ops
from ..solvers.discretization import Discretization
from .sharding import CELL_AXIS, make_device_mesh  # noqa: F401


# ---------------------------------------------------------------------------
# DOF renumbering (host side)
# ---------------------------------------------------------------------------

def first_touch_order(cell_nodes: np.ndarray, n_nodes: int) -> np.ndarray:
    """Old node ids sorted by the first cell whose closure contains them.

    Cells are assumed spatially sorted (true for ``hyper_rectangle`` and
    forest meshes); the resulting numbering makes any contiguous cell range
    touch a contiguous node band plus a one-cell-deep halo.
    Returns ``old_order`` with ``old_order[new_id] = old_id``.
    """
    first = np.full(n_nodes, cell_nodes.shape[0], dtype=np.int64)
    cells_rep = np.repeat(np.arange(cell_nodes.shape[0], dtype=np.int64),
                          cell_nodes.shape[1])
    np.minimum.at(first, cell_nodes.astype(np.int64).reshape(-1), cells_rep)
    return np.argsort(first, kind="stable")


def _renumber_space(space, old_order: np.ndarray):
    new_of_old = np.empty_like(old_order)
    new_of_old[old_order] = np.arange(old_order.shape[0])
    return dataclasses.replace(
        space,
        node_coords=space.node_coords[old_order],
        cell_nodes=new_of_old[space.cell_nodes.astype(np.int64)].astype(
            space.cell_nodes.dtype)), new_of_old


def renumber_discretization(disc: Discretization
                            ) -> Tuple[Discretization, np.ndarray, np.ndarray]:
    """First-touch renumber both spaces of a (conforming) discretization.

    Returns ``(new_disc, old_order_p, old_order_udof)`` where
    ``x_new = x_old[old_order]`` maps vectors into the new numbering.
    """
    if disc.hc_p is not None or disc.hc_u is not None:
        # Hanging-node constraints couple DOFs across the slab interface in
        # ways the first-touch band/halo model doesn't capture (a hanging
        # DOF's masters can live outside the one-cell halo after
        # renumbering).  AMR meshes shard through the psum element path
        # instead (parallel.sharding.shard_discretization carries hc_p/
        # hc_u; 1-vs-8 equality tested in tests/test_sharding.py).
        raise NotImplementedError(
            "ghost sharding on AMR meshes — use shard_discretization "
            "(psum mode), which supports hanging-node constraints")
    dim = disc.dim
    sp, su = disc.pressure_space, disc.displacement_space
    order_p = first_touch_order(sp.cell_nodes, sp.n_nodes)
    order_u = first_touch_order(su.cell_nodes, su.n_nodes)
    sp2, new_p = _renumber_space(sp, order_p)
    su2, new_u = _renumber_space(su, order_u)
    # interleaved vector dofs follow the node permutation
    order_udof = (order_u[:, None] * dim
                  + np.arange(dim)[None, :]).reshape(-1)
    new_udof = (new_u[:, None] * dim + np.arange(dim)[None, :]).reshape(-1)

    conn_p = jnp.asarray(
        new_p[np.asarray(disc.conn_p).astype(np.int64)].astype(np.int32))
    conn_u = jnp.asarray(
        new_udof[np.asarray(disc.conn_u).astype(np.int64)].astype(np.int32))

    def vp(a):
        return a[jnp.asarray(order_p)]

    def vu(a):
        return a[jnp.asarray(order_udof)]

    new_disc = dataclasses.replace(
        disc,
        pressure_space=sp2, displacement_space=su2,
        conn_p=conn_p, conn_u=conn_u,
        free_mask_u=vu(disc.free_mask_u),
        dirichlet_values=vu(disc.dirichlet_values),
        f_neumann=vu(disc.f_neumann),
        diag_elasticity=vu(disc.diag_elasticity),
        f_well=vp(disc.f_well),
        free_mask_p=vp(disc.free_mask_p),
        dirichlet_values_p=vp(disc.dirichlet_values_p),
        diag_mass=vp(disc.diag_mass),
        diag_laplace=vp(disc.diag_laplace))
    return new_disc, order_p, order_udof


# ---------------------------------------------------------------------------
# halo plumbing (inside shard_map; all slices static)
# ---------------------------------------------------------------------------

def _shift(x, k: int, n_dev: int):
    """Value of x on device d-k (zeros at the edge)."""
    if k > 0:
        perm = [(d, d + k) for d in range(n_dev - k)]
    else:
        perm = [(d, d + k) for d in range(-k, n_dev)]
    return lax.ppermute(x, CELL_AXIS, perm)


def _halo_window(x, C: int, H: int, n_dev: int):
    """Owned chunk (..., C) -> window (..., C + 2H) with halos from the
    D = ceil(H/C) slab neighbours each side (usually 1; >1 only on tiny
    problems).  Edge devices receive zeros — never referenced.  Exchanged
    bytes per device: 2*D*C ≈ 2(H+C), interface-scaled."""
    if H == 0:
        return x
    if H <= C:      # the production case: one round, H-sized slices only
        pre = _shift(x[..., -H:], 1, n_dev)
        post = _shift(x[..., :H], -1, n_dev)
        return jnp.concatenate([pre, x, post], axis=-1)
    D = -(-H // C)
    pre = jnp.concatenate([_shift(x, k, n_dev)
                           for k in range(D, 0, -1)], axis=-1)
    post = jnp.concatenate([_shift(x, -k, n_dev)
                            for k in range(1, D + 1)], axis=-1)
    return jnp.concatenate([pre[..., -H:], x, post[..., :H]], axis=-1)


def _halo_return(y_win, C: int, H: int, n_dev: int):
    """Window contributions (..., C + 2H) -> owned chunk (..., C), sending
    halo contributions back to their owners (D ppermute rounds per side)."""
    if H == 0:
        return y_win
    if H <= C:      # one round, H-sized slices only
        to_tail = _shift(y_win[..., :H], -1, n_dev)
        to_head = _shift(y_win[..., C + H:], 1, n_dev)
        y = y_win[..., H:H + C]
        y = y.at[..., C - H:].add(to_tail)
        y = y.at[..., :H].add(to_head)
        return y
    D = -(-H // C)
    lead = y_win.shape[:-1]
    zpad = jnp.zeros(lead + (D * C - H,), y_win.dtype)
    pre = jnp.concatenate([zpad, y_win[..., :H]], axis=-1)
    post = jnp.concatenate([y_win[..., C + H:], zpad], axis=-1)
    y = y_win[..., H:H + C]
    for k in range(1, D + 1):
        # pre block D-k holds contributions to dofs owned by device d-k;
        # after shifting by -k, device d receives its own chunk's worth
        blk = pre[..., (D - k) * C:(D - k + 1) * C]
        y = y + _shift(blk, -k, n_dev)
        blk = post[..., (k - 1) * C:k * C]
        y = y + _shift(blk, k, n_dev)
    return y


# ---------------------------------------------------------------------------
# the sharded discretization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GhostShardedDiscretization(Discretization):
    """Discretization with halo-exchange operator closures.

    Exposes the renumbered (first-touch) DOF ordering; ``order_p`` /
    ``order_udof`` map original-numbering vectors in (``x_new = x[order]``).
    """

    device_mesh: object = None
    conn_p_loc: jnp.ndarray = None   # (Np, E_pad) window-local ids
    conn_u_loc: jnp.ndarray = None   # (Nu*dim, E_pad)
    C_p: int = 0
    H_p: int = 0
    C_u: int = 0
    H_u: int = 0
    order_p: np.ndarray = None
    order_udof: np.ndarray = None

    @property
    def n_dev(self) -> int:
        return self.device_mesh.devices.size

    # -- shard_map plumbing -------------------------------------------------
    def _smap(self, fn, in_space: str, out_specs):
        in_specs = ((P(CELL_AXIS),)
                    + tuple(P(*([None] * (a.ndim - 1) + [CELL_AXIS]))
                            for a in self._cell_args(in_space)))
        return jax.shard_map(fn, mesh=self.device_mesh, in_specs=in_specs,
                             out_specs=out_specs)

    def _cell_args(self, kind: str):
        if kind == "p":          # pressure-quadrature element tables
            return (self.conn_p_loc, self.jinv_p, self.jxw_p)
        return (self.conn_u_loc, self.jinv_u, self.jxw_u)

    def _pad_in(self, x, C: int):
        n_pad = C * self.n_dev
        return jnp.pad(x, (0, n_pad - x.shape[0]))

    # -- operator closures ----------------------------------------------------
    def mass(self, p):
        C, H, nd = self.C_p, self.H_p, self.n_dev

        def k(x, conn, jinv, jxw):
            win = _halo_window(x, C, H, nd)
            ye = ops.mass_core(win[conn], self.psi_p_at_pq, jxw)
            yw = ops.scatter_add(ye, conn, C + 2 * H)
            return _halo_return(yw, C, H, nd)
        f = self._smap(k, "p", P(CELL_AXIS))
        return f(self._pad_in(p, C), *self._cell_args("p"))[:self.n_pdofs]

    def laplace(self, p):
        C, H, nd = self.C_p, self.H_p, self.n_dev

        def k(x, conn, jinv, jxw):
            win = _halo_window(x, C, H, nd)
            ye = ops.laplace_core(win[conn], self.dref_p_at_pq, jinv, jxw)
            yw = ops.scatter_add(ye, conn, C + 2 * H)
            return _halo_return(yw, C, H, nd)
        f = self._smap(k, "p", P(CELL_AXIS))
        return f(self._pad_in(p, C), *self._cell_args("p"))[:self.n_pdofs]

    def elasticity(self, u):
        C, H, nd = self.C_u, self.H_u, self.n_dev
        dim = self.dim

        def k(x, conn, jinv, jxw):
            win = _halo_window(x, C, H, nd)
            N = conn.shape[0] // dim
            ue = win[conn].reshape(N, dim, -1)
            ye = ops.elasticity_core(ue, self.dref_u_at_uq, jinv, jxw,
                                     self.lam, self.mu)
            yw = ops.scatter_add(ye, conn, C + 2 * H)
            return _halo_return(yw, C, H, nd)
        f = self._smap(k, "u", P(CELL_AXIS))
        return f(self._pad_in(u, C), *self._cell_args("u"))[:self.n_udofs]

    def coupling_rhs(self, p, biot_coef):
        Cp, Hp = self.C_p, self.H_p
        Cu, Hu = self.C_u, self.H_u
        nd = self.n_dev

        def k(x, conn_p, conn_u, jinv, jxw):
            win = _halo_window(x, Cp, Hp, nd)
            ye = ops.coupling_core(win[conn_p], self.psi_p_at_uq,
                                   self.dref_u_at_uq, jinv, jxw, biot_coef)
            yw = ops.scatter_add(ye, conn_u, Cu + 2 * Hu)
            return _halo_return(yw, Cu, Hu, nd)
        f = jax.shard_map(
            k, mesh=self.device_mesh,
            in_specs=(P(CELL_AXIS), P(None, CELL_AXIS), P(None, CELL_AXIS),
                      P(None, None, None, CELL_AXIS), P(None, CELL_AXIS)),
            out_specs=P(CELL_AXIS))
        y = f(self._pad_in(p, Cp), self.conn_p_loc, self.conn_u_loc,
              self.jinv_u, self.jxw_u)
        return y[:self.n_udofs]

    def strain_projection_rhs(self, u):
        Cu, Hu = self.C_u, self.H_u
        Cp, Hp = self.C_p, self.H_p
        nd = self.n_dev
        dim = self.dim

        def k(x, conn_u, conn_p, jinv, jxw):
            win = _halo_window(x, Cu, Hu, nd)
            N = conn_u.shape[0] // dim
            ue = win[conn_u].reshape(N, dim, -1)
            ye = ops.projection_core(ue, self.psi_p_at_pq,
                                     self.dref_u_at_pq, jinv, jxw)
            yw = jax.vmap(lambda y: ops.scatter_add(y, conn_p, Cp + 2 * Hp),
                          in_axes=1, out_axes=0)(ye)     # (C_voigt, W_p)
            return _halo_return(yw, Cp, Hp, nd)
        f = jax.shard_map(
            k, mesh=self.device_mesh,
            in_specs=(P(CELL_AXIS), P(None, CELL_AXIS), P(None, CELL_AXIS),
                      P(None, None, None, CELL_AXIS), P(None, CELL_AXIS)),
            out_specs=P(None, CELL_AXIS))
        y = f(self._pad_in(u, Cu), self.conn_u_loc, self.conn_p_loc,
              self.jinv_p, self.jxw_p)
        return y[:, :self.n_pdofs]


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

def _chunk_windows(conn: np.ndarray, cells_per_dev: int, n_dev: int,
                   n_real_cells: int, C: int) -> int:
    """Smallest H with every chunk's touched-DOF set inside
    ``[d*C - H, d*C + C + H)``; requires H <= C (halo only from slab
    neighbours)."""
    H = 0
    for d in range(n_dev):
        lo_c = d * cells_per_dev
        hi_c = min((d + 1) * cells_per_dev, n_real_cells)
        if lo_c >= hi_c:
            continue
        sub = conn[:, lo_c:hi_c]
        H = max(H, d * C - int(sub.min()),
                int(sub.max()) + 1 - (d + 1) * C, 0)
    return H


def shard_discretization_ghost(disc: Discretization,
                               device_mesh) -> GhostShardedDiscretization:
    """Build the halo-exchange sharded discretization (renumbering DOFs
    first-touch; cell order must be spatially coherent, as produced by
    ``hyper_rectangle`` / the AMR forests)."""
    n_dev = device_mesh.devices.size
    rdisc, order_p, order_udof = renumber_discretization(disc)

    E = rdisc.conn_p.shape[-1]
    E_per = math.ceil(E / n_dev)
    E_pad = E_per * n_dev

    conn_p = np.asarray(rdisc.conn_p, np.int64)
    conn_u = np.asarray(rdisc.conn_u, np.int64)
    C_p = math.ceil(rdisc.n_pdofs / n_dev)
    C_u = math.ceil(rdisc.n_udofs / n_dev)
    H_p = _chunk_windows(conn_p, E_per, n_dev, E, C_p)
    H_u = _chunk_windows(conn_u, E_per, n_dev, E, C_u)
    if H_p > (n_dev - 1) * C_p or H_u > (n_dev - 1) * C_u:
        raise ValueError(
            f"halo spans all devices (H_p={H_p}/C_p={C_p}, "
            f"H_u={H_u}/C_u={C_u}): cell order is not spatially coherent "
            "enough for ghost sharding; use shard_discretization (psum mode)")

    def localize(conn, C, H):
        out = np.zeros((conn.shape[0], E_pad), np.int32)
        for d in range(n_dev):
            lo, hi = d * E_per, min((d + 1) * E_per, E)
            if lo < hi:
                out[:, lo:hi] = conn[:, lo:hi] - d * C + H
        return out

    def pad_cells(a):
        pw = [(0, 0)] * (a.ndim - 1) + [(0, E_pad - a.shape[-1])]
        return jnp.pad(jnp.asarray(a), pw)

    def put(a, ndim=None):
        a = jnp.asarray(a)
        spec = P(*([None] * (a.ndim - 1) + [CELL_AXIS]))
        return jax.device_put(a, NamedSharding(device_mesh, spec))

    rep = NamedSharding(device_mesh, P())

    fields = {f.name: getattr(rdisc, f.name)
              for f in dataclasses.fields(Discretization)}
    # geometry may broadcast over cells (uniform grids, trailing dim 1):
    # materialize before padding/sharding
    for name in ("jinv_u", "jxw_u", "jinv_p", "jxw_p"):
        a = jnp.asarray(fields[name])
        if a.shape[-1] == 1 and E > 1:
            a = jnp.broadcast_to(a, a.shape[:-1] + (E,))
        fields[name] = put(pad_cells(a))
    for name in ("free_mask_u", "dirichlet_values", "f_neumann", "f_well",
                 "free_mask_p", "dirichlet_values_p", "diag_mass",
                 "diag_laplace", "diag_elasticity", "psi_p_at_pq",
                 "dref_p_at_pq", "psi_p_at_uq", "dref_u_at_uq",
                 "dref_u_at_pq"):
        fields[name] = jax.device_put(jnp.asarray(fields[name]), rep)

    return GhostShardedDiscretization(
        **fields,
        device_mesh=device_mesh,
        conn_p_loc=put(localize(conn_p, C_p, H_p)),
        conn_u_loc=put(localize(conn_u, C_u, H_u)),
        C_p=C_p, H_p=H_p, C_u=C_u, H_u=H_u,
        order_p=order_p, order_udof=order_udof)

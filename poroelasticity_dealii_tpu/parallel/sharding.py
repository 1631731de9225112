"""GSPMD domain decomposition: elements sharded over a device mesh.

The reference is fully serial (SURVEY §2: no MPI/threads anywhere), so this
subsystem is a design obligation from BASELINE.json, not a port: the
data-parallel analogue of MPI-parallel FEM with ghosted vectors is

* element arrays (connectivity, Jacobian factors) sharded over a 1D device
  mesh axis ``"cells"`` — the domain decomposition;
* DOF vectors replicated (a few MB even at 1M DOF — far below the per-chip
  HBM the element arrays need);
* each operator apply runs the unmodified single-chip element kernels from
  :mod:`..ops.operators` on the local element shard inside ``jax.shard_map``,
  then reduces interface (and interior) DOF contributions with one ``psum``
  over ICI — the collective form of halo exchange + ghost-row accumulation.

CG dot products act on replicated vectors, so no extra collectives appear in
the solver loops: exactly one all-reduce per operator apply.  That all-reduce
is O(n_dofs) — fine at ~1M DOF on one pod slice; for interface-scaled
collective volume use :mod:`.ghost` (sharded DOF vectors + halo ppermutes).

Because :class:`ShardedDiscretization` exposes the same operator-closure API
as :class:`~..solvers.discretization.Discretization`, the entire
``FixedStressSolver`` works unchanged on N chips.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import operators as ops
from ..solvers.discretization import Discretization

CELL_AXIS = "cells"


def make_device_mesh(n_devices: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> DeviceMesh:
    """1D device mesh over the cell axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"requested {n_devices} devices, only {len(devices)} "
                    "visible (set --xla_force_host_platform_device_count "
                    "for CPU simulation)")
            devices = devices[:n_devices]
    return DeviceMesh(np.asarray(devices), (CELL_AXIS,))


def _pad_cells(arr: jnp.ndarray, n_pad: int, pad_value=0):
    """Pad the trailing (cell/lane) axis."""
    if n_pad == 0:
        return arr
    pad_width = [(0, 0)] * (arr.ndim - 1) + [(0, n_pad)]
    return jnp.pad(arr, pad_width, constant_values=pad_value)


def _cell_spec(ndim: int) -> P:
    """PartitionSpec sharding only the trailing cell axis."""
    return P(*([None] * (ndim - 1) + [CELL_AXIS]))


@dataclasses.dataclass
class ShardedDiscretization(Discretization):
    """Discretization whose element arrays live sharded on a device mesh.

    Padded cells (to make n_cells divisible by the mesh size) carry
    ``jxw == 0`` so they contribute exactly nothing to any integral.
    """

    device_mesh: DeviceMesh = None

    # -- sharded operator closures ------------------------------------------
    def _smap(self, fn, n_dof_args: int, cell_arg_ndims):
        """Wrap an element kernel: dof-vector args replicated, element arrays
        sharded on their trailing cell axis, output psum-reduced to a
        replicated vector."""
        in_specs = (P(),) * n_dof_args + tuple(
            _cell_spec(nd) for nd in cell_arg_ndims)
        reduced = lambda *a: jax.lax.psum(fn(*a), CELL_AXIS)  # noqa: E731
        return jax.shard_map(reduced, mesh=self.device_mesh,
                             in_specs=in_specs, out_specs=P())

    def mass(self, p):
        f = self._smap(
            lambda x, conn, jxw: ops.apply_mass(x, conn, self.psi_p_at_pq, jxw),
            1, (2, 2))
        return f(p, self.conn_p, self.jxw_p)

    def laplace(self, p):
        f = self._smap(
            lambda x, conn, jinv, jxw: ops.apply_laplace(
                x, conn, self.dref_p_at_pq, jinv, jxw), 1, (2, 4, 2))
        return f(p, self.conn_p, self.jinv_p, self.jxw_p)

    def elasticity(self, u):
        f = self._smap(
            lambda x, conn, jinv, jxw: ops.apply_elasticity(
                x, conn, self.dref_u_at_uq, jinv, jxw, self.lam, self.mu),
            1, (2, 4, 2))
        return f(u, self.conn_u, self.jinv_u, self.jxw_u)

    def coupling_rhs(self, p, biot_coef):
        n_udofs = self.n_udofs
        f = self._smap(
            lambda x, cp, cu, jinv, jxw: ops.coupling_rhs(
                x, cp, cu, self.psi_p_at_uq, self.dref_u_at_uq, jinv, jxw,
                biot_coef, n_udofs), 1, (2, 2, 4, 2))
        return f(p, self.conn_p, self.conn_u, self.jinv_u, self.jxw_u)

    def strain_projection_rhs(self, u):
        n_pdofs = self.n_pdofs
        f = self._smap(
            lambda x, cu, cp, jinv, jxw: ops.strain_projection_rhs(
                x, cu, cp, self.psi_p_at_pq, self.dref_u_at_pq, jinv, jxw,
                n_pdofs), 1, (2, 2, 4, 2))
        return f(u, self.conn_u, self.conn_p, self.jinv_p, self.jxw_p)


def shard_grid_discretization(disc, device_mesh: DeviceMesh):
    """GSPMD-shard the structured conv-stencil path spatially.

    Annotates the node-grid image inside every operator apply with a
    sharding over the slowest spatial axis (a slab domain decomposition);
    XLA GSPMD then partitions the convolutions and inserts the halo
    exchanges (collective-permutes) over ICI automatically — the
    convolution-native form of ghost-layer exchange.  DOF vectors stay
    logically global; only compute and intermediate activations shard.
    """
    import dataclasses as _dc

    from ..solvers.structured import ConvGridDiscretization

    if not isinstance(disc, ConvGridDiscretization):
        raise TypeError("spatial sharding requires the conv-stencil backend")
    dim = disc.dim
    spec = NamedSharding(device_mesh, P(CELL_AXIS, *([None] * dim)))

    def wrap(f, gs, n_comp):
        shape = tuple(reversed(gs)) + (n_comp,)     # (z, y, x, comp)
        def inner(x, *a):
            X = x.reshape(shape)
            X = jax.lax.with_sharding_constraint(X, spec)
            return f(X.reshape(-1), *a)
        return inner

    gp = disc.info_p.nodes_per_axis
    gu = disc.info_u.nodes_per_axis
    return _dc.replace(
        disc,
        stencil_mass=wrap(disc.stencil_mass, gp, 1),
        stencil_laplace=wrap(disc.stencil_laplace, gp, 1),
        stencil_elasticity=wrap(disc.stencil_elasticity, gu, dim),
        stencil_coupling=wrap(disc.stencil_coupling, gp, 1),
        stencil_projection=wrap(disc.stencil_projection, gu, dim),
        # stencils built AFTER construction (the per-dt fused pressure
        # Jacobian — the pressure CG's hot operator) get the same slab
        # constraint through this hook
        wrap_pressure_stencil=lambda st: wrap(st, gp, 1),
        # the single-device row layout does not shard by GSPMD; this mode
        # uses the GSPMD-partitioned conv stencils (parallel/rows.py
        # re-adds z-slab-sharded row ops on top of this function)
        row_ops=None,
    )


def shard_discretization(disc: Discretization,
                         device_mesh: DeviceMesh) -> ShardedDiscretization:
    """Pad element arrays to the mesh size and place them sharded."""
    n_dev = device_mesh.devices.size
    n_cells = disc.conn_p.shape[-1]
    n_pad = (-n_cells) % n_dev

    rep = NamedSharding(device_mesh, P())

    def put_cells(arr, pad_value=0):
        arr = jnp.asarray(arr)
        if arr.shape[-1] == 1 and n_cells > 1:
            # uniform structured grids broadcast geometry over cells
            # (trailing dim 1) — materialize before sharding
            arr = jnp.broadcast_to(arr, arr.shape[:-1] + (n_cells,))
        padded = _pad_cells(arr, n_pad, pad_value)
        sharding = NamedSharding(device_mesh, _cell_spec(padded.ndim))
        return jax.device_put(padded, sharding)

    def put_rep(arr):
        return jax.device_put(arr, rep)

    return ShardedDiscretization(
        dim=disc.dim, dtype=disc.dtype,
        pressure_space=disc.pressure_space,
        displacement_space=disc.displacement_space,
        conn_p=put_cells(disc.conn_p), conn_u=put_cells(disc.conn_u),
        psi_p_at_pq=put_rep(disc.psi_p_at_pq),
        dref_p_at_pq=put_rep(disc.dref_p_at_pq),
        psi_p_at_uq=put_rep(disc.psi_p_at_uq),
        dref_u_at_uq=put_rep(disc.dref_u_at_uq),
        dref_u_at_pq=put_rep(disc.dref_u_at_pq),
        jinv_u=put_cells(disc.jinv_u), jxw_u=put_cells(disc.jxw_u),
        jinv_p=put_cells(disc.jinv_p), jxw_p=put_cells(disc.jxw_p),
        free_mask_u=put_rep(disc.free_mask_u),
        dirichlet_values=put_rep(disc.dirichlet_values),
        f_neumann=put_rep(disc.f_neumann), f_well=put_rep(disc.f_well),
        free_mask_p=put_rep(disc.free_mask_p),
        dirichlet_values_p=put_rep(disc.dirichlet_values_p),
        diag_mass=put_rep(disc.diag_mass),
        diag_laplace=put_rep(disc.diag_laplace),
        diag_elasticity=put_rep(disc.diag_elasticity),
        lam=disc.lam, mu=disc.mu,
        # hanging-node constraints ride along (replicated index maps), so
        # AMR meshes shard through the psum path — the solver's
        # condense/distribute wrappers work unchanged on the replicated
        # DOF vectors (the ghost path still rejects AMR, ghost.py)
        hc_p=disc.hc_p, hc_u=disc.hc_u,
        device_mesh=device_mesh,
    )

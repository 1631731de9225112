"""Multi-chip form of the PRODUCTION solver configuration.

The single-chip production path — row-layout mechanics CG
(`ops/rows3d.py`) + slice-stencil/fused-Jacobian pressure — shards here
with a **z-slab domain decomposition of the comp-major row layout**:

* the row layout is z-half-major, so a z-slab of the displacement grid IS
  a contiguous row range — each device owns ``Lz = ceil((n+1)/n_dev)``
  z-half layers (``Lz*24`` rows) of every row-layout vector, and the whole
  mechanics CG (dots/axpys/masks) runs on those sharded arrays unchanged;
* one elasticity apply needs exactly ONE 24-row halo band from the z+
  neighbour (cell layer ``Lz-1`` reaches z-half layer ``Lz``) and returns
  ONE 24-row contribution band — two ``ppermute``s per apply, each moving
  ``24*W`` values, independent of the slab depth (interface-scaled);
* inside ``jax.shard_map`` each device runs the single-chip row apply on
  its local slab (``make_apply_rows(nz=Lz)``), with the count of real
  cell layers passed at runtime (``lax.axis_index``-derived — tail
  devices own padding layers);
* the pressure side reuses the conv/slice-stencil operators under a GSPMD
  slab sharding constraint (XLA inserts the conv halo exchanges), exactly
  like :func:`..parallel.sharding.shard_grid_discretization`, but WITHOUT
  dropping ``row_ops``.

The reference is fully serial (SURVEY §2 parallelism paragraph); this is
the BASELINE.json configs[4] obligation ("elements sharded over GSPMD
mesh, halo exchange") applied to the production backend.

Shape contract: sharded row-layout vectors are padded from ``(n+1)*24``
to ``n_dev*Lz*24`` rows.  Padding rows carry ``free_mask = 0`` and
``diag = 1``, so the existing ``fss._mechanics_solve`` treats them as
constrained DOFs with zero boundary value — they stay exactly zero
through every CG iteration with no special-casing.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from .sharding import CELL_AXIS
from ..ops.rows3d import (ElasticityRowOps, from_rows, lazy_block_precond,
                          make_apply_rows, make_coupling_rows,
                          make_projection_rows, to_rows)


def slab_layers(n: int, n_dev: int) -> int:
    """Z-half layers owned per device (the grid has n+1 of them)."""
    return math.ceil((n + 1) / n_dev)


def make_row_ops_sharded(element_matrix: np.ndarray, n: int, free_mask_u,
                         diag_elasticity, device_mesh, dtype=jnp.float32,
                         coupling_matrix: np.ndarray = None,
                         projection_matrix: np.ndarray = None
                         ) -> ElasticityRowOps:
    """Z-slab-sharded :class:`ElasticityRowOps` over ``device_mesh``.

    Every returned array/function works on the PADDED row shape
    ``(n_dev*Lz*24, W)``, sharded ``P('cells', None)``.
    """
    n_dev = device_mesh.devices.size
    Lz = slab_layers(n, n_dev)
    n_rows = n_dev * Lz * 24
    pad = n_rows - (n + 1) * 24
    slab_apply = make_apply_rows(element_matrix, n, dtype, nz=Lz)
    spec = NamedSharding(device_mesh, P(CELL_AXIS, None))

    def shard(R):
        return lax.with_sharding_constraint(R, spec)

    def pad_rows(R):
        return shard(jnp.pad(R, ((0, pad), (0, 0))))

    t = jax.jit(lambda x: pad_rows(to_rows(x, n)))
    f = jax.jit(lambda R: from_rows(R[:(n + 1) * 24], n))

    def _local_apply(x_loc):
        """Per-device slab apply: ((Lz*24, W)) -> same, with one 24-row
        halo band exchanged each way (the only collectives)."""
        idx = lax.axis_index(CELL_AXIS)
        nv = jnp.clip(n - idx * Lz, 0, Lz).astype(jnp.int32)
        # halo gather: z-half layer (d+1)*Lz lives as the NEXT device's
        # first 24 rows; the last device gets zeros (never referenced —
        # its layers past n are masked by nv)
        fwd = [(d + 1, d) for d in range(n_dev - 1)]
        halo = lax.ppermute(x_loc[:24], CELL_AXIS, fwd)
        y = slab_apply(jnp.concatenate([x_loc, halo], axis=0), nv)
        # halo return: my contribution to the neighbour's first z-half
        # layer goes forward; device 0 receives zeros
        bwd = [(d, d + 1) for d in range(n_dev - 1)]
        ret = lax.ppermute(y[Lz * 24:], CELL_AXIS, bwd)
        return y[:Lz * 24].at[:24].add(ret)

    smapped = jax.shard_map(_local_apply, mesh=device_mesh,
                            in_specs=P(CELL_AXIS, None),
                            out_specs=P(CELL_AXIS, None))
    apply_rows = jax.jit(lambda R: smapped(shard(R)))

    ones = jnp.ones_like(jnp.asarray(diag_elasticity, dtype))
    mask_rows = jax.device_put(t(jnp.asarray(free_mask_u, dtype)), spec)
    diag_rows = jax.device_put(
        t(jnp.asarray(diag_elasticity, dtype)) + (1.0 - t(ones)), spec)

    cr = None
    if coupling_matrix is not None:
        base_cr = make_coupling_rows(coupling_matrix, n, dtype)
        cr = jax.jit(lambda p: pad_rows(base_cr(p)))
    pr = None
    if projection_matrix is not None:
        # make_projection_rows slices R[:(n+1)*24] itself, so the padded
        # sharded shape feeds straight in
        pr = make_projection_rows(projection_matrix, n, dtype)

    # node-block Jacobi, identity-padded to the sharded plane count; the
    # apply is elementwise per (z-half, parity, lane) so it shards with
    # the row axis (the M planes ride as a replicated->resharded const).
    # Lazy: only 'Mechanics preconditioner = block' decks build it.
    bp = lazy_block_precond(element_matrix, n, free_mask_u, dtype,
                            nz_pad=n_dev * Lz)

    return ElasticityRowOps(n=n, apply_rows=apply_rows, to_rows=t,
                            from_rows=f, free_mask_rows=mask_rows,
                            diag_rows=diag_rows, coupling_rows=cr,
                            projection_rows=pr, block_precond=bp)


def make_parity_ops_sharded(element_matrix: np.ndarray, n: int,
                            free_mask_u, diag_elasticity, device_mesh,
                            dtype=jnp.float32,
                            coupling_matrix: np.ndarray = None,
                            projection_matrix: np.ndarray = None):
    """Y-slab-sharded 2D parity ops (round-4 verdict #4: the parallelism
    obligation had a hole exactly where the reference's practical dimension
    lives — the 2D production parity path was single-chip only).

    The 2D mirror of :func:`make_row_ops_sharded`: parity arrays
    ``(nc, 2, 2, n+1, n+1)`` are sharded along the iy axis (axis 3) —
    each device owns ``Ly = ceil((n+1)/n_dev)`` node rows of every
    parity-layout vector, and the whole mechanics CG (dots/axpys/masks)
    runs on those sharded arrays unchanged.  One elasticity apply needs
    exactly ONE node row from the y+ neighbour and returns ONE
    contribution row — two ``ppermute``s per apply, each moving
    ``nc*2*2*(n+1)`` values, independent of the slab depth.  The
    coupling/projection RHS forms (once per FSS iteration, not per CG
    iteration) ride GSPMD through the base parity closures with a
    sharding constraint on the layout boundary.

    Shape contract (mirrors the 3D rows contract): sharded parity vectors
    are padded from ``n+1`` to ``n_dev*Ly`` iy-rows; padding rows carry
    ``free_mask = 0`` / ``diag = 1`` so ``fss._mechanics_solve`` treats
    them as constrained DOFs with zero boundary value.
    """
    import math as _math

    from ..ops.devconst import device_const
    from ..ops.parity2d import (ElasticityParityOps, from_parity,
                                make_apply_parity_local,
                                make_coupling_parity,
                                make_projection_parity, to_parity,
                                to_parity_np)
    nc = 2
    n_dev = device_mesh.devices.size
    Ly = _math.ceil((n + 1) / n_dev)
    P_rows = n_dev * Ly
    pad = P_rows - (n + 1)
    spec = NamedSharding(device_mesh, P(None, None, None, CELL_AXIS, None))

    def shard(Xp):
        return lax.with_sharding_constraint(Xp, spec)

    def pad_rows(Xp):
        return shard(jnp.pad(Xp, ((0, 0),) * 3 + ((0, pad), (0, 0))))

    t = jax.jit(lambda x: pad_rows(to_parity(x, n, nc)))
    f = jax.jit(lambda Xp: from_parity(Xp[:, :, :, :n + 1], n, nc))

    local = make_apply_parity_local(element_matrix, n, Ly, nc, dtype)

    def _local_apply(xl):
        """Per-device slab apply ((nc,2,2,Ly,n+1) -> same), one halo row
        each way (the only collectives)."""
        idx = lax.axis_index(CELL_AXIS)
        nv = jnp.clip(n - idx * Ly, 0, Ly).astype(jnp.int32)
        # halo gather: node row (d+1)*Ly is the NEXT device's first row;
        # the last device gets zeros (its rows past n are masked by nv)
        fwd = [(d + 1, d) for d in range(n_dev - 1)]
        halo = lax.ppermute(xl[:, :, :, :1], CELL_AXIS, fwd)
        y = local(jnp.concatenate([xl, halo], axis=3), nv)
        # halo return: my contribution to the neighbour's first row
        bwd = [(d, d + 1) for d in range(n_dev - 1)]
        ret = lax.ppermute(y[:, :, :, Ly:], CELL_AXIS, bwd)
        return y[:, :, :, :Ly].at[:, :, :, :1].add(ret)

    smapped = jax.shard_map(_local_apply, mesh=device_mesh,
                            in_specs=P(None, None, None, CELL_AXIS, None),
                            out_specs=P(None, None, None, CELL_AXIS, None),
                            check_vma=False)
    apply_rows = jax.jit(lambda Xp: smapped(shard(Xp)))

    # setup constants host-side (to_parity_np + numpy row pad), placed
    # directly with the slab sharding
    free_np = np.asarray(free_mask_u, np.float64)
    diag_np = np.asarray(diag_elasticity, np.float64)
    row_pad = ((0, 0),) * 3 + ((0, pad), (0, 0))
    mask_rows = jax.device_put(
        np.asarray(np.pad(to_parity_np(free_np, n, nc), row_pad),
                   jnp.dtype(dtype)), spec)
    ones_p = to_parity_np(np.ones_like(diag_np), n, nc)
    diag_p = to_parity_np(diag_np, n, nc) + (1.0 - ones_p)
    diag_rows = jax.device_put(
        np.asarray(np.pad(diag_p, row_pad, constant_values=1.0),
                   jnp.dtype(dtype)), spec)

    cr = None
    if coupling_matrix is not None:
        base_cr = make_coupling_parity(coupling_matrix, n, nc, dtype)
        cr = jax.jit(lambda p: pad_rows(base_cr(p)))
    pr = None
    if projection_matrix is not None:
        base_pr = make_projection_parity(projection_matrix, n, nc, dtype)
        pr = jax.jit(lambda Xp: base_pr(Xp[:, :, :, :n + 1]))

    return ElasticityParityOps(n=n, apply_rows=apply_rows, to_rows=t,
                               from_rows=f, free_mask_rows=mask_rows,
                               diag_rows=diag_rows, coupling_rows=cr,
                               projection_rows=pr)


def shard_production_discretization(disc, device_mesh):
    """Shard the production ConvGridDiscretization: GSPMD slab constraints
    on the conv/slice stencils (delegated to
    :func:`.sharding.shard_grid_discretization`) PLUS shard_map row ops
    for the production mechanics path — z-slab rows in 3D,
    y-slab parity in 2D.

    Requires the row-ops-eligible configuration (equal-axis Q2 grid with
    ``row_ops`` built).
    """
    from .sharding import shard_grid_discretization

    if getattr(disc, "row_ops", None) is None:   # generic discs lack the attr
        raise ValueError(
            "production sharding needs row_ops (equal-axis Q2 grid with "
            "elasticity_backend='rows'/'parity' or auto at size)")
    base = shard_grid_discretization(disc, device_mesh)  # stencils + hook
    n = disc.info_u.cells_per_axis[0]
    if len(disc.info_u.cells_per_axis) == 2:
        row_ops = make_parity_ops_sharded(
            disc.element_ke, n, disc.free_mask_u, disc.diag_elasticity,
            device_mesh, dtype=disc.dtype,
            coupling_matrix=disc.element_ce,
            projection_matrix=disc.element_pe)
        new = dataclasses.replace(base, row_ops=row_ops,
                                   gmg_precond=None)
        # parity-resident GMG rides along when the source disc built it
        # (production 2D sizes NEED it: Jacobi-CG hits the iteration cap
        # at 512^2).  The V-cycle closures act on UNPADDED single-chip
        # parity arrays; this adapter slices the slab padding off, runs
        # the V-cycle as a plain GSPMD computation on the sharded array
        # (XLA chooses the collectives — the per-FSS-iteration Richardson
        # preconditioner is not on the per-CG-iteration halo fast path),
        # and pads/re-shards the correction.  Padding rows are constrained
        # dofs with zero value, so a zero correction there is exact.
        base_gmg = getattr(disc, "gmg_precond_rows", None)
        if base_gmg is not None:
            pad = device_mesh.devices.size \
                * slab_layers(n, device_mesh.devices.size) - (n + 1)
            spec = NamedSharding(device_mesh,
                                 P(None, None, None, CELL_AXIS, None))

            def gmg_rows_sharded(rp, _g=base_gmg, _n=n, _pad=pad,
                                 _spec=spec):
                z = _g(rp[:, :, :, :_n + 1, :])
                z = jnp.pad(z, ((0, 0),) * 3 + ((0, _pad), (0, 0)))
                return lax.with_sharding_constraint(z, _spec)
            new.gmg_precond_rows = gmg_rows_sharded
        return new
    row_ops = make_row_ops_sharded(
        disc.element_ke, n, disc.free_mask_u, disc.diag_elasticity,
        device_mesh, dtype=disc.dtype,
        coupling_matrix=disc.element_ce,
        projection_matrix=disc.element_pe)
    return dataclasses.replace(base, row_ops=row_ops)

"""Shape bucketing for AMR: pad the discretization so remeshes reuse
compiled executables.

Every remesh changes ``(n_cells, n_pdofs, n_udofs, H_p, H_u)`` and XLA must
recompile the whole jitted time step for the new shapes — seconds per
shape change, the dominant AMR cost (the reference pays nothing here
because deal.II assembles eagerly, ``PoroelasticityFSS.h:448-498``; SURVEY
§7 names "host remesh + bucketed recompile" as the compiled-program
answer).  Padding all five sizes up to
geometric buckets makes nearby meshes land on identical shapes: the
lowered HLO depends only on shapes (mesh arrays are closed-over device
constants, passed as runtime parameters), so with the persistent compile
cache a bucket revisit costs one re-trace + cache load instead of a full
compile.

Padding is EXACT, not approximate, by the same invariants the row-layout
kernel padding uses:

* phantom CELLS carry zero geometry (``jxw = 0``, ``jinv = 0``) and
  connectivity pointing at dof 0 — every quadrature contribution they
  scatter is exactly ``0.0`` (float-exact to add);
* phantom DOFS are Dirichlet-constrained to zero (``free_mask = 0``,
  ``dirichlet_values = 0``, preconditioner diagonals 1) — solver vectors
  stay exactly zero there through CG's free-subspace invariant, and extra
  zeros change no norm or dot;
* phantom CONSTRAINT rows constrain one phantom dof to a zero-weight
  combination of itself — ``distribute``/``condense_vec``/``constrained``
  all act as the identity on real data.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

import jax.numpy as jnp

from .constraints import HangingConstraints


def bucket_size(n: int, ratio: float = 1.25, quantum: int = 32) -> int:
    """Smallest bucket STRICTLY greater than ``n``: quantum-aligned sizes
    growing geometrically (32, 64, 96, 128, 160, 224, 288, ...).  Strict
    so at least one phantom dof always exists (the no-op constraint rows
    need one to point at)."""
    m = quantum
    while m <= n:
        m = max(m + quantum, int(math.ceil(m * ratio / quantum)) * quantum)
    return m


def _pad_last(a, n_to: int, fill=0.0):
    """Pad the LAST axis of ``a`` to length ``n_to`` with ``fill``."""
    pad = [(0, 0)] * (a.ndim - 1) + [(0, n_to - a.shape[-1])]
    return jnp.pad(a, pad, constant_values=fill)


def _pad_vec(v, n_to: int, fill=0.0):
    return jnp.pad(v, (0, n_to - v.shape[0]), constant_values=fill)


def _pad_constraints(hc, n_dofs_pad: int, H_to: int, W_to: int,
                     dtype) -> HangingConstraints:
    """Pad the (H, W) constraint tables with no-op rows: each padding row
    constrains the last (phantom) dof to a zero-weight combination of
    itself.  Duplicate phantom-row writes all store the same value (0), so
    the ``.at[].set`` scatters stay deterministic."""
    phantom = n_dofs_pad - 1
    H = int(hc.hanging.shape[0])
    W = int(hc.masters.shape[1])
    hanging = np.full(H_to, phantom, np.int32)
    masters = np.full((H_to, W_to), phantom, np.int32)
    weights = np.zeros((H_to, W_to))
    if H:
        hanging[:H] = np.asarray(hc.hanging)
        masters[:H, :W] = np.asarray(hc.masters)
        weights[:H, :W] = np.asarray(hc.weights)
    return HangingConstraints(hanging=jnp.asarray(hanging),
                              masters=jnp.asarray(masters),
                              weights=jnp.asarray(weights, dtype))


def pad_amr_discretization(disc, ratio: float = 1.25, quantum: int = 32):
    """Return a copy of a generic AMR ``Discretization`` padded to shape
    buckets (cells, pressure dofs, displacement dofs, both constraint
    tables).  The FE spaces stay the REAL ones — host boundaries (VTK,
    Kelly, transfer, checkpoints) read real sizes from them and slice."""
    E = disc.n_cells
    n_p = disc.n_pdofs
    n_u = disc.n_udofs
    Ep = bucket_size(E, ratio, quantum)
    npp = bucket_size(n_p, ratio, quantum)
    nup = bucket_size(n_u, ratio, quantum)
    dt = disc.dtype
    dim = disc.dim

    # constraint tables: W padded to the dim/degree-stable width so a
    # mesh moment with only edge (not face) constraints still buckets
    # width = one face's worth of master dofs, (k+1)^(dim-1).  Vector
    # components add constraint ROWS (constraints._pack_rows expands
    # H × n_comp), never width — each row's masters are same-component —
    # so no per-component factor applies here
    w_cap_u = max((disc.displacement_space.degree + 1) ** (dim - 1),
                  int(disc._hcu.masters.shape[1]))
    w_cap_p = max((disc.pressure_space.degree + 1) ** (dim - 1),
                  int(disc._hcp.masters.shape[1]))
    hc_p = _pad_constraints(
        disc._hcp, npp,
        bucket_size(int(disc._hcp.hanging.shape[0]), ratio, quantum),
        w_cap_p, dt)
    hc_u = _pad_constraints(
        disc._hcu, nup,
        bucket_size(int(disc._hcu.hanging.shape[0]), ratio, quantum),
        w_cap_u, dt)

    return dataclasses.replace(
        disc,
        conn_p=_pad_last(disc.conn_p, Ep, 0),
        conn_u=_pad_last(disc.conn_u, Ep, 0),
        jinv_u=_pad_last(disc.jinv_u, Ep, 0.0),
        jxw_u=_pad_last(disc.jxw_u, Ep, 0.0),
        jinv_p=_pad_last(disc.jinv_p, Ep, 0.0),
        jxw_p=_pad_last(disc.jxw_p, Ep, 0.0),
        free_mask_u=_pad_vec(disc.free_mask_u, nup, 0.0),
        dirichlet_values=_pad_vec(disc.dirichlet_values, nup, 0.0),
        f_neumann=_pad_vec(disc.f_neumann, nup, 0.0),
        f_well=_pad_vec(disc.f_well, npp, 0.0),
        free_mask_p=_pad_vec(disc.free_mask_p, npp, 0.0),
        dirichlet_values_p=_pad_vec(disc.dirichlet_values_p, npp, 0.0),
        diag_mass=_pad_vec(disc.diag_mass, npp, 1.0),
        diag_laplace=_pad_vec(disc.diag_laplace, npp, 1.0),
        diag_elasticity=_pad_vec(disc.diag_elasticity, nup, 1.0),
        hc_p=hc_p, hc_u=hc_u)


def real_sizes(disc):
    """(n_pdofs, n_udofs) of the REAL mesh (from the FE spaces)."""
    return (disc.pressure_space.n_nodes,
            disc.pressure_space.mesh.dim * disc.displacement_space.n_nodes)


def slice_state(state, n_p: int, n_u: int):
    """Restrict a (possibly padded) State to the real dof counts (derived
    caches dropped — they are layout/shape-bound)."""
    return state._replace(
        p=state.p[:n_p], u=state.u[:n_u], eps_v=state.eps_v[:n_p],
        eps_v0=state.eps_v0[:n_p], strains=state.strains[:, :n_p],
        u_rows=None, mech_b=None)


def pad_state(state, n_p: int, n_u: int, mech_b=None):
    """Zero-pad a real-sized State to the padded dof counts (phantom
    entries are exactly zero — the invariant the padded operators keep)."""
    return state._replace(
        p=_pad_vec(state.p, n_p), u=_pad_vec(state.u, n_u),
        eps_v=_pad_vec(state.eps_v, n_p), eps_v0=_pad_vec(state.eps_v0, n_p),
        strains=_pad_last(state.strains, n_p),
        u_rows=None, mech_b=mech_b)

"""3D comp-major row layout — the 3D production mechanics path.

The 3D twin of :mod:`.parity2d`: a persistent de-interleaved DOF layout
in which every per-cell local-node gather of the Q2 elasticity apply is a
contiguous slice, the whole FLOP volume of an apply is ONE
``(81, 81) @ (81, cells)`` matmul, and the assembly scatter is a set of
pad+adds.  Plain ``jax.numpy``/``lax``: XLA fuses the slices and pad+adds
and hands the matmul to the backend's GEMM library.

The layout:

* the (2n+1)^3 x 3 node grid is split into **24 parity-comp planes per
  z-half-layer** (2 parities per axis x 3 components), each plane
  flattened over (y-half, x-half) into one row of ``(n+1)^2`` lanes
  (zero-padded to a 128 multiple) — rows are ordered z-half-major so any
  z-slab is one contiguous row range (the sharded form in
  ``parallel/rows.py`` relies on this);
* the per-cell gather for local Q2 node offset (ox, oy, oz) is then a
  plain **lane-shifted slice** of row ``r(zh + (oz>>1), oz&1, oy&1,
  ox&1, c)`` at lane offset ``(oy>>1) * (n+1) + (ox>>1)`` — stacking the
  81 (node, comp) slices gives the ``(81, n(n+1))`` operand of one cell
  layer, whose lane axis enumerates the layer's cells (x fastest) plus
  one masked phantom column per y-row (~1/n wasted lanes);
* :func:`make_apply_rows` vectorizes that over all cell layers at once:
  viewed plane-major ``(24, n+1, W)``, each (node, comp) operand row of
  every layer is ONE contiguous ``(n, Lc)`` block, so the apply is one
  stacked gather, one ``(81, 81) @ (81, n*Lc)`` dot, the phantom-lane
  mask, and pad+adds back into the planes.

``to_rows``/``from_rows`` are bijective zero-padded linear layout maps, so
dots, axpys, norms and elementwise masks computed in row layout equal
their flat counterparts exactly — a whole mechanics CG solve runs in this
layout with conversions only at the solve boundary
(:class:`ElasticityRowOps`).  :func:`make_reference_apply` runs the same
dataflow layer by layer (index-math oracle; validated against the conv
path in tests/test_pallas.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.devconst import device_const, host_const
from ..ops.shape import node_lattice


def _width(n: int) -> int:
    """Padded lane width: >= (n+1)^2 + max shift (n+2), 128-multiple."""
    need = (n + 1) * (n + 1) + (n + 2)
    return -(-need // 128) * 128


def to_rows(u_flat, n: int):
    """Flat dof vector ((2n+1)^3 * 3,) -> row layout ((n+1)*24, W).

    Row index = zh*24 + ((pz*2 + py)*2 + px)*3 + c; lane = yh*(n+1) + xh.
    """
    g = 2 * n + 1
    W = _width(n)
    U = u_flat.reshape(g, g, g, 3)
    U = jnp.pad(U, ((0, 1), (0, 1), (0, 1), (0, 0)))    # to 2n+2 per axis
    V = U.reshape(n + 1, 2, n + 1, 2, n + 1, 2, 3)       # zh pz yh py xh px c
    V = V.transpose(0, 1, 3, 5, 6, 2, 4)                 # zh pz py px c yh xh
    R = V.reshape((n + 1) * 24, (n + 1) * (n + 1))
    return jnp.pad(R, ((0, 0), (0, W - R.shape[1])))


def from_rows(R, n: int):
    """Inverse of :func:`to_rows` -> flat dof vector."""
    g = 2 * n + 1
    V = R[:, :(n + 1) * (n + 1)].reshape(
        n + 1, 2, 2, 2, 3, n + 1, n + 1)                 # zh pz py px c yh xh
    V = V.transpose(0, 1, 5, 2, 6, 3, 4)                 # zh pz yh py xh px c
    U = V.reshape(2 * n + 2, 2 * n + 2, 2 * n + 2, 3)
    return U[:g, :g, :g, :].reshape(-1)


def scalar_rows_np(v: np.ndarray, n: int, fill: float = 0.0) -> np.ndarray:
    """Nodal scalar grid ((2n+1)^3,) -> scalar row layout ((n+1)*8, W).

    The comp-free companion of :func:`to_rows`: row = zh*8 +
    ((pz*2 + py)*2 + px), lane = yh*(n+1) + xh — i.e. exactly the
    (zh, parity) structure of the u row layout with the 3-comp factor
    dropped, so a ((n+1)*24, W) u-rows array viewed as
    ``(n+1, 8, 3, W)`` broadcasts against scalar rows viewed as
    ``(n+1, 8, 1, W)``.  ``fill`` seeds the phantom (padding) nodes and
    lanes.  Host numpy (setup-time constants only)."""
    g = 2 * n + 1
    W = _width(n)
    U = np.full((2 * n + 2,) * 3, fill, dtype=np.float64)
    U[:g, :g, :g] = np.asarray(v, np.float64).reshape(g, g, g)
    V = U.reshape(n + 1, 2, n + 1, 2, n + 1, 2)          # zh pz yh py xh px
    V = V.transpose(0, 1, 3, 5, 2, 4)                    # zh pz py px yh xh
    R = V.reshape((n + 1) * 8, (n + 1) * (n + 1))
    out = np.full(((n + 1) * 8, W), fill, dtype=np.float64)
    out[:, :R.shape[1]] = R
    return out


def to_rows_np(v, n: int, fill: float = 0.0) -> np.ndarray:
    """Numpy :func:`to_rows` for SETUP-time constants (masks, diagonals).

    Mirrors :func:`to_rows` exactly but fills phantom nodes and padding
    lanes with ``fill`` (0 for masks, 1 for diagonals) — building these on
    the device would cost one eager XLA compile + transfer per constant
    per process (see ops/devconst.py).  Bit-for-bit vs the device path:
    tests/test_pallas.py::test_to_rows_np_matches_device."""
    g = 2 * n + 1
    W = _width(n)
    U = np.full((2 * n + 2,) * 3 + (3,), fill, dtype=np.float64)
    U[:g, :g, :g, :] = np.asarray(v, np.float64).reshape(g, g, g, 3)
    V = U.reshape(n + 1, 2, n + 1, 2, n + 1, 2, 3)       # zh pz yh py xh px c
    V = V.transpose(0, 1, 3, 5, 6, 2, 4)                 # zh pz py px c yh xh
    R = V.reshape((n + 1) * 24, (n + 1) * (n + 1))
    out = np.full(((n + 1) * 24, W), fill, dtype=np.float64)
    out[:, :R.shape[1]] = R
    return out


def elasticity_node_blocks(element_matrix: np.ndarray, n: int,
                           free_mask_u) -> np.ndarray:
    """Per-node (3, 3) diagonal blocks of the CONSTRAINED elasticity
    operator on the structured Q2 grid: B[node][c, c'] = sum over cells
    touching the node of the element matrix's local diagonal node block,
    with Dirichlet-constrained (node, comp) rows/cols replaced by the
    identity (the constrained operator acts as identity there).

    Feeds the node-block Jacobi preconditioner (the 3x3 coupling between
    a node's displacement components that scalar Jacobi ignores — the
    lam/mu cross terms of ``PoroElasticDisplacementSolver.h:237-242``).
    Host numpy, setup-time.  Returns (g^3, 3, 3), g = 2n+1.

    Caveat (docs/VALIDATION.md "node-block Jacobi ablation"): on the
    uniform grids this path runs on, the assembled INTERIOR blocks are
    exactly diagonal — the per-element cross terms (up to 37% of the
    diagonal at corner nodes) cancel by parity across the 8 surrounding
    cells — and off-diagonals survive only at boundary nodes free in
    several components, which the golden decks' Dirichlet masks zero.
    Hence 'block' == scalar Jacobi numerically on those decks, and the
    knob defaults to 'jacobi'."""
    g = 2 * n + 1
    Ke = np.asarray(element_matrix, np.float64)
    lat = node_lattice(2, 3)                             # (27, 3) x-first
    B = np.zeros((g ** 3, 3, 3))
    idx = np.arange(n)
    cz, cy, cx = np.meshgrid(idx, idx, idx, indexing="ij")
    for a in range(27):
        ox, oy, oz = int(lat[a, 0]), int(lat[a, 1]), int(lat[a, 2])
        nodes = (((2 * cz + oz) * g + (2 * cy + oy)) * g
                 + (2 * cx + ox)).ravel()                # unique per a
        B[nodes] += Ke[a * 3:a * 3 + 3, a * 3:a * 3 + 3]
    f = np.asarray(free_mask_u, np.float64).reshape(g ** 3, 3) > 0
    B *= f[:, :, None] & f[:, None, :]                   # zero constrained
    for c in range(3):
        B[~f[:, c], c, c] = 1.0                          # identity rows
    return B


def make_block_precond(block_inv: np.ndarray, n: int, dtype=jnp.float32,
                       nz_pad: int = None):
    """Node-block (3x3) Jacobi preconditioner in the comp-major row layout:
    ``r rows ((n+1)*24, W) -> z = B^{-1} r`` applied nodewise.

    ``block_inv``: (g^3, 3, 3) inverted blocks from
    :func:`elasticity_node_blocks` (symmetric — 6 unique planes are
    stored/read).  Phantom rows/lanes map 0 -> 0 (identity fill), so the
    free-subspace invariant :meth:`ElasticityRowOps.free_apply` relies on
    is preserved: z is zero wherever r is (constrained rows carry identity
    blocks).

    ``nz_pad`` (default n+1): total z-half planes of the vectors the
    preconditioner will see — the sharded rows backend pads to
    ``n_dev * Lz`` planes; the extra planes get identity blocks."""
    if nz_pad is None:
        nz_pad = n + 1
    pl_ = {}
    for c in range(3):
        for d in range(c, 3):
            fill = 1.0 if c == d else 0.0
            plane = scalar_rows_np(block_inv[:, c, d], n, fill)
            if nz_pad > n + 1:
                extra = np.full(((nz_pad - (n + 1)) * 8, plane.shape[1]),
                                fill)
                plane = np.concatenate([plane, extra], axis=0)
            pl_[(c, d)] = plane
    # Host numpy, NOT a device array: the lazy path builds this inside a
    # trace, and a memoized jnp constant created under one trace leaks as
    # a tracer into the next (observed under shard_map).  numpy operands
    # embed as fresh compile-time constants in every trace.
    M = np.stack([pl_[(0, 0)], pl_[(0, 1)], pl_[(0, 2)],
                  pl_[(1, 1)], pl_[(1, 2)], pl_[(2, 2)]]).astype(
        np.dtype(jnp.dtype(dtype).name)).reshape(6, nz_pad, 8, -1)
    W = _width(n)

    def block_precond(R):
        R4 = R.reshape(nz_pad, 8, 3, W)
        r0, r1, r2 = R4[:, :, 0], R4[:, :, 1], R4[:, :, 2]
        m00, m01, m02, m11, m12, m22 = (M[i] for i in range(6))
        z0 = m00 * r0 + m01 * r1 + m02 * r2
        z1 = m01 * r0 + m11 * r1 + m12 * r2
        z2 = m02 * r0 + m12 * r1 + m22 * r2
        return jnp.stack([z0, z1, z2], axis=2).reshape(R.shape)

    return block_precond


def _slice_params(n: int):
    """Per local Q2 node a: (dz, row-offset-within-zh-block, lane shift)."""
    lat = node_lattice(2, 3)                            # (27, 3) x-first
    out = []
    for a in range(27):
        ox, oy, oz = int(lat[a, 0]), int(lat[a, 1]), int(lat[a, 2])
        dz = oz >> 1
        base = (((oz & 1) * 2 + (oy & 1)) * 2 + (ox & 1)) * 3
        shift = (oy >> 1) * (n + 1) + (ox >> 1)
        out.append((dz, base, shift))
    return out


def cell_lane_mask(n: int, dtype):
    """(n(n+1),) 1 on real cell lanes, 0 on the per-row phantom column."""
    lanes = np.arange(n * (n + 1))
    return host_const((lanes % (n + 1)) < n, dtype)


def _interval_plan(n: int):
    """Group the 81 (node, comp) rows by lane shift, then coalesce each
    group's rows into maximal CONTIGUOUS (dz, row-offset) intervals.

    The 81 per-(node, comp) slices/pad+adds of the naive dataflow coalesce
    into 14 interval ops — including one aligned 24-plane block and one
    12-plane block for the zero-shift group — which keeps the traced
    program small.

    Returns ``(plan, perm)``: plan = [(shift, col0, [(dz, r0, m), ...])]
    with ``col0`` the group's first row/column in the permuted element
    matrix; perm = the (node, comp) traversal order.
    """
    lat = node_lattice(2, 3)
    groups = {}
    for a in range(27):
        ox, oy, oz = int(lat[a, 0]), int(lat[a, 1]), int(lat[a, 2])
        dz = oz >> 1
        base = (((oz & 1) * 2 + (oy & 1)) * 2 + (ox & 1)) * 3
        shift = (oy >> 1) * (n + 1) + (ox >> 1)
        for c in range(3):
            groups.setdefault(shift, []).append((dz, base + c, a * 3 + c))
    plan = []
    perm = []
    col0 = 0
    for shift in sorted(groups):
        rows = sorted(groups[shift])
        ivs = []
        for dz, r, kk in rows:
            perm.append(kk)
            if ivs and ivs[-1][0] == dz and ivs[-1][1] + ivs[-1][2] == r:
                ivs[-1] = (dz, ivs[-1][1], ivs[-1][2] + 1)
            else:
                ivs.append((dz, r, 1))
        plan.append((shift, col0, [tuple(iv) for iv in ivs]))
        col0 += len(rows)
    return plan, perm


def make_reference_apply(element_matrix: np.ndarray, n: int,
                         dtype=jnp.float32):
    """Layer-by-layer jnp implementation of the row dataflow (index-math
    oracle for :func:`make_apply_rows`; its Python loop over cell layers
    unrolls to O(n * 81) ops, so it is test-only)."""
    Ke = jnp.asarray(element_matrix, dtype)             # (81, 81)
    Lc = n * (n + 1)
    params = _slice_params(n)
    mask = cell_lane_mask(n, dtype)

    def apply(u_flat):
        R = to_rows(u_flat, n)
        out = jnp.zeros_like(R)
        for iz in range(n):
            ops_rows = []
            for (dz, base, shift) in params:
                for c in range(3):
                    r = (iz + dz) * 24 + base + c
                    ops_rows.append(R[r, shift:shift + Lc])
            U = jnp.stack(ops_rows)                     # (81, Lc)
            ye = (Ke @ U) * mask                        # (81, Lc)
            k = 0
            for (dz, base, shift) in params:
                for c in range(3):
                    r = (iz + dz) * 24 + base + c
                    out = out.at[r, shift:shift + Lc].add(ye[k])
                    k += 1
        return from_rows(out, n)

    return apply


def make_apply_rows(element_matrix: np.ndarray, n: int, dtype=jnp.float32,
                    nz: int = None):
    """Row-layout elasticity apply ``R -> Y`` (both ``((nz+1)*24, W)``).

    The production form: no layout conversions — callers keep DOF vectors
    in the comp-major row layout.  Padding lanes/rows of the input must be
    zero; the output preserves that invariant (phantom contributions are
    masked).

    ``nz`` (default ``n``): number of cell LAYERS swept — the z-slab
    ``shard_map`` form (parallel/rows.py) passes each device's local slab
    depth while ``n`` keeps fixing the transverse lane geometry.  The
    returned ``apply_rows(R, nv=None)`` takes an optional runtime count of
    real cell layers (int32 scalar, <= nz); layers past it are masked out
    (their input rows can hold live neighbour-halo data, so this is a
    correctness mask, not padding hygiene)."""
    if nz is None:
        nz = n
    W = _width(n)
    Lc = n * (n + 1)
    plan, perm = _interval_plan(n)
    Kp = host_const(np.asarray(element_matrix)[np.ix_(perm, perm)], dtype)
    lane = cell_lane_mask(n, dtype)                      # (Lc,)

    def apply_rows(R, nv=None):
        T = R.reshape(nz + 1, 24, W).swapaxes(0, 1)      # (24, nz+1, W)
        U = jnp.concatenate(
            [T[r0:r0 + cnt, dz:dz + nz, s:s + Lc]
             for (s, _, ivs) in plan for (dz, r0, cnt) in ivs])  # (81,nz,Lc)
        Y = jnp.dot(Kp, U.reshape(81, nz * Lc), preferred_element_type=dtype,
                    precision=jax.lax.Precision.HIGHEST).reshape(81, nz, Lc)
        mask = lane
        if nv is not None:                               # phantom layers
            mask = mask * (jnp.arange(nz) < nv)[:, None].astype(dtype)
        Y = Y * mask
        acc = None
        row = 0
        for (s, _, ivs) in plan:
            for (dz, r0, cnt) in ivs:
                P = jnp.pad(Y[row:row + cnt],
                            ((r0, 24 - r0 - cnt), (dz, 1 - dz),
                             (s, W - Lc - s)))
                acc = P if acc is None else acc + P
                row += cnt
        return acc.swapaxes(0, 1).reshape((nz + 1) * 24, W)

    return apply_rows


def make_coupling_rows(coupling_matrix: np.ndarray, n: int,
                       dtype=jnp.float32):
    """Pressure-coupling RHS assembled DIRECTLY in the comp-major row
    layout: ``p (Q1 grid flat) -> rows ((n+1)*24, W)``.

    The row layout IS the Q2 parity decomposition, so per Q2 local node
    (o2x, o2y, o2z) the per-cell contribution lands in parity-comp plane
    ``base(o2&1)+c`` at z-half/lane offsets ``o2>>1`` — 8 Q1 gather
    slices, one (81, 8) matmul over cells, 81 pad+adds into 24
    accumulators, one (24, zh) axis swap.  Replaces the Q2 coupling
    scatter conv AND the to_rows transpose of the assembled RHS in the
    mechanics solve.
    ``coupling_matrix``: (81, 8) element matrix, rows (node*3 + comp)
    lex x-fastest, biot folded in (structured._coupling_element_matrix).
    """
    Ce = host_const(coupling_matrix, dtype)            # (81, 8)
    W = _width(n)
    g1 = n + 1
    lat_u = node_lattice(2, 3)                           # (27, 3)
    lat_p = node_lattice(1, 3)                           # (8, 3)

    def coupling_rows(p_flat):
        P3 = p_flat.reshape(g1, g1, g1).astype(dtype)    # (z, y, x)
        U = jnp.stack([P3[oz:oz + n, oy:oy + n, ox:ox + n].reshape(-1)
                       for (ox, oy, oz) in lat_p])       # (8, n^3)
        Ye = jnp.dot(Ce, U, preferred_element_type=dtype,
                     precision=jax.lax.Precision.HIGHEST)  # (81, n^3)
        acc = [None] * 24
        for a in range(27):
            ox, oy, oz = int(lat_u[a, 0]), int(lat_u[a, 1]), int(lat_u[a, 2])
            base = (((oz & 1) * 2 + (oy & 1)) * 2 + (ox & 1)) * 3
            pw = ((oz >> 1, 1 - (oz >> 1)), (oy >> 1, 1 - (oy >> 1)),
                  (ox >> 1, 1 - (ox >> 1)))
            for c in range(3):
                Pd = jnp.pad(Ye[a * 3 + c].reshape(n, n, n), pw)
                r = base + c
                acc[r] = Pd if acc[r] is None else acc[r] + Pd
        A = jnp.stack(acc)                               # (24, zh, yh, xh)
        R = jnp.swapaxes(A, 0, 1).reshape((n + 1) * 24, (n + 1) * (n + 1))
        return jnp.pad(R, ((0, 0), (0, W - R.shape[1])))

    return coupling_rows


def make_projection_rows(projection_matrix: np.ndarray, n: int,
                         dtype=jnp.float32):
    """Strain-projection RHS assembled DIRECTLY from the comp-major row
    layout: ``u rows ((n+1)*24, W) -> (C, n_pdofs)`` (Q1 grid flat).

    The mixed-degree mirror of :func:`make_apply_rows`: the rows array is
    viewed plane-major ``(24, n+1, W)``, so the 81 (Q2 local node, comp)
    operand rows of all cell layers are the same 14 contiguous interval
    slices (:func:`_interval_plan`) — then one (48, 81) @ (81, n*Lc)
    matmul and 8 pad+adds into the Q1 grid.  Replaces the Q2 projection conv stencil
    AND the from_rows conversion it needed.
    ``projection_matrix``: (Np*C, 81) element matrix, rows (i_p*C + c)
    with c over VOIGT_PAIRS, cols (node*3 + comp) lex x-fastest
    (structured._projection_element_matrix).
    """
    plan, perm = _interval_plan(n)
    Pe = host_const(np.asarray(projection_matrix)[:, perm], dtype)
    C = Pe.shape[0] // 8
    g1 = n + 1
    Lc = n * (n + 1)
    lane = cell_lane_mask(n, dtype)                      # (Lc,)
    lat_p = node_lattice(1, 3)                           # (8, 3)

    def projection_rows(R):
        T = R[:(n + 1) * 24].reshape(n + 1, 24, -1).swapaxes(0, 1)
        U = jnp.concatenate(
            [T[r0:r0 + cnt, dz:dz + n, s:s + Lc]
             for (s, _, ivs) in plan for (dz, r0, cnt) in ivs])  # (81,n,Lc)
        Ye = jnp.dot(Pe, U.reshape(81, n * Lc), preferred_element_type=dtype,
                     precision=jax.lax.Precision.HIGHEST)
        # rows (i_p*C + c) -> (8, C, z, y, x) cell grid (drop phantom x)
        Yc = (Ye.reshape(8, C, n, Lc) * lane).reshape(
            8, C, n, n, n + 1)[..., :n]
        acc = None
        for i_p in range(8):
            ox, oy, oz = (int(lat_p[i_p, 0]), int(lat_p[i_p, 1]),
                          int(lat_p[i_p, 2]))
            pw = ((0, 0), (oz, 1 - oz), (oy, 1 - oy), (ox, 1 - ox))
            Pd = jnp.pad(Yc[i_p], pw)                    # (C, g1, g1, g1)
            acc = Pd if acc is None else acc + Pd
        return acc.reshape(C, g1 * g1 * g1)

    return projection_rows


@dataclasses.dataclass(frozen=True)
class ElasticityRowOps:
    """The comp-major row layout as a persistent DOF-vector format.

    ``to_rows``/``from_rows`` are bijective (zero-padded) linear layout
    maps, so dots, axpys, norms and elementwise masks computed in row
    layout equal their flat-vector counterparts exactly — a whole CG solve
    runs in row layout with conversions only at the solve boundary."""
    n: int
    apply_rows: object           # unconstrained K: rows -> rows
    to_rows: object              # flat (n_udofs,) -> rows ((n+1)*24, W)
    from_rows: object
    free_mask_rows: jnp.ndarray  # Dirichlet mask in rows (padding = 0)
    diag_rows: jnp.ndarray       # Jacobi diagonal in rows (padding = 1)
    coupling_rows: object = None  # p -> coupling RHS directly in rows
    projection_rows: object = None  # u rows -> (C, n_pdofs) strain RHS
    block_precond: object = None  # nodewise 3x3-block Jacobi (rows -> rows)

    def constrained_apply(self, x):
        """Free-subspace restriction, same semantics as
        ops.constrained_apply (identity on constrained dofs)."""
        m = self.free_mask_rows
        y = self.apply_rows(x * m)
        return y * m + x * (1.0 - m)

    def free_apply(self, x):
        """``m * A(x)`` for x ALREADY in the free subspace (zero at
        constrained rows/padding) — equal to :meth:`constrained_apply`
        there (``x*m == x`` and ``(1-m)*x == 0``), one full-vector mask
        pass cheaper.  Used as cg_solve's per-iteration ``apply_iter``:
        every CG direction vector satisfies the invariant when b/x0 carry
        the Dirichlet values."""
        return self.apply_rows(x) * self.free_mask_rows


def make_row_ops(element_matrix: np.ndarray, n: int, free_mask_u,
                 diag_elasticity, dtype=jnp.float32,
                 coupling_matrix: np.ndarray = None,
                 projection_matrix: np.ndarray = None) -> ElasticityRowOps:
    """Build the persistent-row-layout elasticity solve kit for a 3D
    structured Q2 grid (``n`` cells per axis)."""
    apply_rows = jax.jit(make_apply_rows(element_matrix, n, dtype))
    t = jax.jit(lambda x: to_rows(x, n))
    f = jax.jit(lambda r: from_rows(r, n))
    # setup constants in numpy (to_rows_np) + device_const transfers: no
    # eager device compiles, no device->host pulls (ops/devconst.py)
    free_mask_u = np.asarray(free_mask_u, np.float64)
    mask_rows = device_const(to_rows_np(free_mask_u, n, fill=0.0), dtype)
    diag_rows = device_const(
        to_rows_np(np.asarray(diag_elasticity, np.float64), n, fill=1.0),
        dtype)
    cr = (make_coupling_rows(coupling_matrix, n, dtype)
          if coupling_matrix is not None else None)
    pr = (make_projection_rows(projection_matrix, n, dtype)
          if projection_matrix is not None else None)
    bp = lazy_block_precond(element_matrix, n, free_mask_u, dtype)
    return ElasticityRowOps(n=n, apply_rows=apply_rows, to_rows=t,
                            from_rows=f, free_mask_rows=mask_rows,
                            diag_rows=diag_rows, coupling_rows=cr,
                            projection_rows=pr, block_precond=bp)


def lazy_block_precond(element_matrix: np.ndarray, n: int, free_mask_u,
                       dtype=jnp.float32, nz_pad: int = None):
    """Defer the node-block setup (27-point host assembly + one batched
    3x3 inverse per node) until the first TRACE that uses the
    preconditioner — 'Mechanics preconditioner = jacobi' decks (the
    default) never pay it.  The built apply is memoized, so retraces reuse
    the planes."""
    cache = []

    def block_precond(R):
        if not cache:
            blocks = elasticity_node_blocks(element_matrix, n, free_mask_u)
            cache.append(make_block_precond(np.linalg.inv(blocks), n,
                                            dtype, nz_pad=nz_pad))
        return cache[0](R)

    return block_precond

"""2D parity-resident operator layout — the 2D production mechanics path.

Reference parity: this accelerates the displacement solve of the
fixed-stress loop (/root/reference/lib/include/PoroElasticDisplacementSolver.h)
and its coupling/projection RHS assembly on 2D structured grids; only the
DOF-vector layout and execution strategy change, not the operator.

Why: the reference is practically a 2D code (the well term asserts
dim == 2, reference lib/include/right_hand_side.h:104).  Tiny-channel conv
applies stream far below memory bandwidth, and a per-apply parity-matmul
reformulation is dominated by its interleave/de-interleave.  The fix is
the same design as the 3D production path (ops/rows3d.ElasticityRowOps):
make the de-interleaved layout a PERSISTENT dof-vector format so a whole
CG solve runs inside it and the interleave cost is paid once per solve,
not per apply.

The layout ("parity" classes, degree 2):
    node index along an axis is i = 2*cell + o with offset o in {0, 1, 2};
    offsets 0/2 share parity class 0 (length n+1), offset 1 is class 1
    (length n, zero-padded to n+1).  A flat x-fastest comp-interleaved
    vector becomes a ``(nc, 2, 2, n+1, n+1)`` array
    ``Xp[c, oy, ox, iy, ix] = x[((2*iy+oy)*gx + (2*ix+ox))*nc + c]``.

In this layout every per-cell local-node gather is a CONTIGUOUS slice of a
class array, the whole FLOP volume of an operator apply is ONE
(N_out, N_in) x (N_in, n_cells) einsum (one GEMM), and the scatter back is
a per-class pad+add.  ``to_parity``/``from_parity`` are zero-padded
bijective linear layout maps, so dots, axpys, norms and elementwise masks
computed in parity layout equal their flat counterparts exactly — the same
contract as the 3D row layout (rows3d.ElasticityRowOps).

Pure XLA — works on any backend (CPU tests run it): the einsum is one
GEMM and the slices/pads are contiguous.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .devconst import device_const, host_const
from .shape import node_lattice


def _comp_major(M: np.ndarray, nci: int, nco: int) -> np.ndarray:
    """Reorder an element matrix from interleaved (node*nc + c) indexing to
    comp-major (c*n_nodes + node) on both sides."""
    n_in = M.shape[1] // nci
    n_out = M.shape[0] // nco
    cols = np.array([node * nci + c
                     for c in range(nci) for node in range(n_in)])
    rows = np.array([node * nco + c
                     for c in range(nco) for node in range(n_out)])
    return np.asarray(M, np.float64)[np.ix_(rows, cols)]


def _cls_start(o: int):
    """Axis offset o in {0,1,2} -> (parity class, slice start)."""
    return (o, 0) if o < 2 else (0, 1)


def to_parity_np(x, n: int, nc: int) -> np.ndarray:
    """Numpy :func:`to_parity` for SETUP-time constants (masks, diagonals).

    Eagerly calling the jnp version at build time costs one small XLA
    compile per distinct shape on the accelerator (dozens in a GMG
    hierarchy).  Setup constants are host data anyway."""
    g, n1 = 2 * n + 1, n + 1
    X = np.pad(np.asarray(x, np.float64).reshape(g, g, nc),
               ((0, 1), (0, 1), (0, 0)))
    X = X.reshape(n1, 2, n1, 2, nc)
    return np.ascontiguousarray(X.transpose(4, 1, 3, 0, 2))


def to_parity(x, n: int, nc: int):
    """Flat x-fastest comp-interleaved vector -> (nc, 2, 2, n+1, n+1).

    ONE pad + ONE reshape + ONE transpose, which XLA runs as a single
    memory-speed transpose; an equivalent strided-slice / per-class-stack
    formulation is many times slower — the single most important
    implementation choice in this module."""
    g, n1 = 2 * n + 1, n + 1
    X = jnp.pad(x.reshape(g, g, nc), ((0, 1), (0, 1), (0, 0)))
    X = X.reshape(n1, 2, n1, 2, nc)
    return X.transpose(4, 1, 3, 0, 2)


def from_parity(Xp, n: int, nc: int):
    """Exact inverse of :func:`to_parity` (drops the zero padding)."""
    g, n1 = 2 * n + 1, n + 1
    X = Xp.transpose(3, 1, 4, 2, 0).reshape(2 * n1, 2 * n1, nc)
    return X[:g, :g].reshape(-1)


def _gather_q2(Xp, n: int, nc: int, lat):
    """Parity array -> per-cell operand (nc * 9, n*n): 9 contiguous
    slices, stacked comp-major."""
    pieces = []
    for node in range(9):
        (cy, sy), (cx, sx) = _cls_start(int(lat[node, 1])), \
            _cls_start(int(lat[node, 0]))
        pieces.append(Xp[:, cy, cx, sy:sy + n, sx:sx + n])
    return jnp.stack(pieces, 1).reshape(nc * 9, n * n)


def _scatter_q2(Ye, n: int, nc: int, lat):
    """Per-cell results (nc, 9, n, n) -> parity array: pad+add per class."""
    acc = [[None, None], [None, None]]
    for node in range(9):
        (cy, sy), (cx, sx) = _cls_start(int(lat[node, 1])), \
            _cls_start(int(lat[node, 0]))
        P = jnp.pad(Ye[:, node], ((0, 0), (sy, 1 - sy), (sx, 1 - sx)))
        acc[cy][cx] = P if acc[cy][cx] is None else acc[cy][cx] + P
    return jnp.stack([jnp.stack(r, 1) for r in acc], 1)


def make_apply_parity(element_matrix: np.ndarray, n: int, nc: int,
                      dtype=jnp.float32,
                      precision=lax.Precision.HIGHEST):
    """Unconstrained Q2->Q2 operator apply, parity -> parity."""
    lat = node_lattice(2, 2)
    Kr = host_const(_comp_major(element_matrix, nc, nc), dtype)

    def apply_p(Xp):
        U = _gather_q2(Xp, n, nc, lat)
        Ye = jnp.einsum("oi,ie->oe", Kr, U, precision=precision)
        return _scatter_q2(Ye.reshape(nc, 9, n, n), n, nc, lat)

    return apply_p


def make_apply_parity_local(element_matrix: np.ndarray, n: int, Ly: int,
                            nc: int = 2, dtype=jnp.float32,
                            precision=lax.Precision.HIGHEST):
    """Per-device y-slab apply for the SHARDED parity path
    (parallel/rows.py::make_parity_ops_sharded).

    Input ``xl``: ``(nc, 2, 2, Ly + 1, n + 1)`` — the device's ``Ly``
    owned iy-rows plus ONE halo row (the y+ neighbour's first row,
    already concatenated by the caller).  ``nv`` (traced int32): the
    device's count of REAL cell rows (tail devices own padding rows).
    Output: ``(nc, 2, 2, Ly + 1, n + 1)`` — the local contribution
    including the band for the y+ neighbour's first row (row Ly), which
    the caller ppermutes back.  Same gather/einsum/scatter as
    :func:`make_apply_parity`, restricted to the slab."""
    lat = node_lattice(2, 2)
    Kr = host_const(_comp_major(element_matrix, nc, nc), dtype)

    def apply_local(xl, nv):
        pieces = []
        for node in range(9):
            (cy, sy), (cx, sx) = _cls_start(int(lat[node, 1])), \
                _cls_start(int(lat[node, 0]))
            pieces.append(xl[:, cy, cx, sy:sy + Ly, sx:sx + n])
        U = jnp.stack(pieces, 1).reshape(nc * 9, Ly * n)
        Ye = jnp.einsum("oi,ie->oe", Kr, U, precision=precision)
        Ye = Ye.reshape(nc, 9, Ly, n)
        # mask cell rows past the device's real count (the halo row can
        # hold live neighbour data — this is a correctness mask)
        rowmask = (jnp.arange(Ly) < nv).astype(Ye.dtype)[None, None, :, None]
        Ye = Ye * rowmask
        acc = [[None, None], [None, None]]
        for node in range(9):
            (cy, sy), (cx, sx) = _cls_start(int(lat[node, 1])), \
                _cls_start(int(lat[node, 0]))
            P = jnp.pad(Ye[:, node], ((0, 0), (sy, 1 - sy), (sx, 1 - sx)))
            acc[cy][cx] = P if acc[cy][cx] is None else acc[cy][cx] + P
        return jnp.stack([jnp.stack(r, 1) for r in acc], 1)

    return apply_local


# ---------------------------------------------------------------------------
# parity-resident Q2 grid transfers (GMG level boundaries)
# ---------------------------------------------------------------------------
#
# With flat conv_cellwise/conv_scatter level transfers, a parity-GMG
# V-cycle leaves the parity layout at every level (lfrom/lto) and runs the
# tiny-channel conv forms this module exists to avoid.  These transfers
# keep the whole V-cycle in parity layout: one coarse-cell gather, ONE
# (25*nc, 9*nc) matmul, one scatter — same dataflow as the apply, one
# degree up.  All interleaves keep the minor dim large
# (_ileave2/_ileave_lanes): the whole-array (q, r) quad transpose
# materializes a minor-dim-2 layout that XLA copies element by element.
#
# Geometry: fine node o in 0..4 per axis within a coarse cell (global fine
# node coord 4*cc + o) has fine parity class p = o % 2 and in-class index
# i = 2*cc + j, j = o // 2.  Splitting i = 2q + r ("quad-parity") makes the
# per-coarse-cell scatter CONTIGUOUS: q = cc + (j >> 1), r = j & 1 — i.e.
# a plain pad+add into the (q, r)-split class array, exactly `_scatter_q2`
# one level up.  The (q, r) split itself is ONE pad+reshape+transpose
# (XLA memory-speed, same argument as `to_parity`).

_O2QUAD = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1)]
#           o=0        o=1        o=2        o=3        o=4
#          (class p, sub-index r, pad offset s) per fine local offset


def _ileave2(A0, A1, n_out):
    """Interleave along the SECOND-minor axis: two (..., q, m) ->
    (..., 2q, m) rows [A0_0, A1_0, A0_1, ...], truncated to ``n_out``
    rows.  Minor dim untouched -> row-contiguous writes (the naive
    whole-array (q, r) transpose materializes a minor-dim-2 layout that
    XLA copies element by element)."""
    Q = jnp.stack([A0, A1], axis=-2)                # (..., q, 2, m)
    Q = Q.reshape(A0.shape[:-2] + (2 * A0.shape[-2],) + A0.shape[-1:])
    return Q[..., :n_out, :]


def _dileave2(Y, q: int):
    """Exact adjoint of :func:`_ileave2`: (..., n, m) -> two
    (..., q, m) (zero-padding the odd tail row)."""
    pad = [(0, 0)] * (Y.ndim - 2) + [(0, 2 * q - Y.shape[-2]), (0, 0)]
    Q = jnp.pad(Y, pad).reshape(Y.shape[:-2] + (q, 2) + Y.shape[-1:])
    return Q[..., 0, :], Q[..., 1, :]


def _ileave_lanes(A0, A1, n_out):
    """Interleave along the MINOR axis via transpose sandwiches: the two
    swaps move a large dim (no minor-dim-2 intermediate)."""
    Y = _ileave2(jnp.swapaxes(A0, -1, -2), jnp.swapaxes(A1, -1, -2), n_out)
    return jnp.swapaxes(Y, -1, -2)


def _dileave_lanes(Y, q: int):
    A0, A1 = _dileave2(jnp.swapaxes(Y, -1, -2), q)
    return jnp.swapaxes(A0, -1, -2), jnp.swapaxes(A1, -1, -2)


def _q2_refine_matrix() -> np.ndarray:
    """(25, 9) coarse-Q2 nodal interpolation onto the 5x5 fine nodes of
    one coarse cell (both sides x-fastest lex; fine node f at reference
    coords (fx/4, fy/4), coarse 1D Q2 nodes at 0, 1/2, 1)."""
    pts = np.linspace(0.0, 1.0, 5)
    phi = np.stack([2.0 * (pts - 0.5) * (pts - 1.0),
                    4.0 * pts * (1.0 - pts),
                    2.0 * pts * (pts - 0.5)])           # (3 nodes, 5 pts)
    M = np.zeros((25, 9))
    for f in range(25):
        fy, fx = f // 5, f % 5
        for c in range(9):
            cy, cx = c // 3, c % 3
            M[f, c] = phi[cy, fy] * phi[cx, fx]
    return M


def make_parity_transfers(n_coarse: int, nc: int, dtype=jnp.float32,
                          precision=lax.Precision.HIGHEST):
    """Raw (unmasked, multiplicity-unnormalized) Q2 GMG transfers fully in
    parity layout: returns ``(raw_prolong, raw_restrict, mult_np)`` with

    * ``raw_prolong``: coarse parity -> fine parity, per-coarse-cell
      scatter-add of the 25 interpolated fine-node values (duplicated at
      coarse-cell-shared fine nodes — divide by ``mult_np``);
    * ``raw_restrict``: its EXACT transpose (fine parity -> coarse);
    * ``mult_np``: host-numpy per-fine-entry contribution count in parity
      layout (``raw_prolong(ones)``; 0 at the class-1 padding entries).

    The caller composes the GMG-standard P = diag(ff/mult) raw_p diag(cf)
    and R = P^T, matching multigrid.build_gmg's flat transfers exactly
    (both are coarse-Q2 nodal interpolation with the same masks)."""
    lat = node_lattice(2, 2)
    nC = n_coarse
    M = _q2_refine_matrix()                             # (25, 9)
    Mc = host_const(np.kron(np.eye(nc), M), dtype)      # comp-major
    McT = host_const(np.kron(np.eye(nc), M.T), dtype)

    nF = 2 * nC

    def raw_prolong(Xc):
        U = _gather_q2(Xc, nC, nc, lat)                 # (nc*9, nC^2)
        Ye = jnp.einsum("oi,ie->oe", Mc, U,
                        precision=precision).reshape(nc, 25, nC, nC)
        acc = [[[[None, None] for _ in range(2)] for _ in range(2)]
               for _ in range(2)]                       # [py][px][ry][rx]
        for f in range(25):
            oy, ox = f // 5, f % 5
            py, ry, sy = _O2QUAD[oy]
            px, rx, sx = _O2QUAD[ox]
            P = jnp.pad(Ye[:, f], ((0, 0), (sy, 1 - sy), (sx, 1 - sx)))
            cur = acc[py][px][ry][rx]
            acc[py][px][ry][rx] = P if cur is None else cur + P
        # every (py, px, ry, rx) slot gets a contribution (all 4 (p, r)
        # axis combos are hit by some o); interleave the (q, r) splits
        # back per axis (rows, then lanes via transpose sandwich)
        cls = []
        for py in range(2):
            for px in range(2):
                b = [_ileave2(acc[py][px][0][rx], acc[py][px][1][rx],
                              nF + 1) for rx in range(2)]
                cls.append(_ileave_lanes(b[0], b[1], nF + 1))
        F = jnp.stack(cls, 1).reshape(nc, 2, 2, nF + 1, nF + 1)
        return F

    def raw_restrict(Rf):
        pieces_by = {}
        for py in range(2):
            for px in range(2):
                y0, y1 = _dileave_lanes(Rf[:, py, px], nC + 1)
                q = [[None, None], [None, None]]
                q[0][0], q[1][0] = _dileave2(y0, nC + 1)
                q[0][1], q[1][1] = _dileave2(y1, nC + 1)
                pieces_by[(py, px)] = q                 # [ry][rx]
        pieces = []
        for f in range(25):
            oy, ox = f // 5, f % 5
            py, ry, sy = _O2QUAD[oy]
            px, rx, sx = _O2QUAD[ox]
            Q = pieces_by[(py, px)][ry][rx]
            pieces.append(Q[:, sy:sy + nC, sx:sx + nC])
        U = jnp.stack(pieces, 1).reshape(nc * 25, nC * nC)
        Zc = jnp.einsum("oi,ie->oe", McT, U,
                        precision=precision).reshape(nc, 9, nC, nC)
        return _scatter_q2(Zc, nC, nc, lat)

    # multiplicity: the same scatter with per-node all-ones blocks, in
    # host numpy (setup-time constant; eager device eval was the round-4
    # GMG compile storm)
    mult = np.zeros((nc, 2, 2, 2, 2, nC + 1, nC + 1))
    ones = np.ones((nC, nC))
    for f in range(25):
        oy, ox = f // 5, f % 5
        py, ry, sy = _O2QUAD[oy]
        px, rx, sx = _O2QUAD[ox]
        mult[:, py, px, ry, rx] += np.pad(ones,
                                          ((sy, 1 - sy), (sx, 1 - sx)))
    nF = 2 * nC
    mult = mult.transpose(0, 1, 2, 5, 3, 6, 4).reshape(
        nc, 2, 2, 2 * nC + 2, 2 * nC + 2)[:, :, :, :nF + 1, :nF + 1]
    # class-1 padding entries (in-class index nF) received spurious
    # counts from the (q, r) fold only if any scatter reached index nF —
    # class 1 tops out at 2(nC-1)+1 = nF-1, class 0 at nF, so zero the
    # class-1 pad row/col explicitly for a clean 0-at-padding contract
    mult[:, 1, :, nF, :] = 0.0
    mult[:, :, 1, :, nF] = 0.0
    return raw_prolong, raw_restrict, mult


def make_coupling_parity(coupling_matrix: np.ndarray, n: int, nc: int,
                         dtype=jnp.float32,
                         precision=lax.Precision.HIGHEST):
    """p (flat Q1 scalar grid) -> coupling RHS directly in parity layout.

    The Q1 input grid needs no parity split: the 4 local-node gathers are
    already contiguous slices of the (n+1, n+1) node grid."""
    lat_u = node_lattice(2, 2)
    lat_p = node_lattice(1, 2)
    Cr = host_const(_comp_major(coupling_matrix, 1, nc), dtype)
    g1 = n + 1

    def coupling_p(p):
        P = p.reshape(g1, g1)
        pieces = [P[int(lat_p[i, 1]):int(lat_p[i, 1]) + n,
                    int(lat_p[i, 0]):int(lat_p[i, 0]) + n]
                  for i in range(4)]
        U = jnp.stack(pieces, 0).reshape(4, n * n)
        Ye = jnp.einsum("oi,ie->oe", Cr, U, precision=precision)
        return _scatter_q2(Ye.reshape(nc, 9, n, n), n, nc, lat_u)

    return coupling_p


def make_projection_parity(projection_matrix: np.ndarray, n: int, nc: int,
                           dtype=jnp.float32,
                           precision=lax.Precision.HIGHEST):
    """u (parity) -> strain-projection RHS (C, n_pdofs), all Voigt entries
    in one einsum (the one-sweep all-Voigt RHS of solvers/fss.py)."""
    lat_u = node_lattice(2, 2)
    lat_p = node_lattice(1, 2)
    C = projection_matrix.shape[0] // 4
    Pr = host_const(_comp_major(projection_matrix, nc, C), dtype)
    g1 = n + 1

    def projection_p(Xp):
        U = _gather_q2(Xp, n, nc, lat_u)
        Ye = jnp.einsum("oi,ie->oe", Pr, U, precision=precision)
        Ye = Ye.reshape(C, 4, n, n)
        acc = None
        for i in range(4):
            oy, ox = int(lat_p[i, 1]), int(lat_p[i, 0])
            Pd = jnp.pad(Ye[:, i], ((0, 0), (oy, 1 - oy), (ox, 1 - ox)))
            acc = Pd if acc is None else acc + Pd
        return acc.reshape(C, g1 * g1)

    return projection_p


@dataclasses.dataclass(frozen=True)
class ElasticityParityOps:
    """Parity layout as a persistent DOF-vector format — duck-types
    :class:`ops.rows3d.ElasticityRowOps` (same attribute and
    method names), so the fss.py production rows plumbing (in-rows RHS
    assembly, rows-resident CG, rows projection RHS) runs unchanged on 2D
    grids."""
    n: int
    apply_rows: object            # unconstrained K: parity -> parity
    to_rows: object               # flat (n_udofs,) -> (nc, 2, 2, n+1, n+1)
    from_rows: object
    free_mask_rows: jnp.ndarray   # Dirichlet mask in parity (padding = 0)
    diag_rows: jnp.ndarray        # Jacobi diagonal in parity (padding = 1)
    coupling_rows: object = None
    projection_rows: object = None
    block_precond: object = None

    def constrained_apply(self, x):
        m = self.free_mask_rows
        y = self.apply_rows(x * m)
        return y * m + x * (1.0 - m)

    def free_apply(self, x):
        """``m * A(x)`` for x already in the free subspace (zero at
        constrained entries/padding) — one mask pass cheaper per CG
        iteration than :meth:`constrained_apply` (same invariant argument
        as the 3D row layout)."""
        return self.apply_rows(x) * self.free_mask_rows


def make_parity_ops(element_matrix: np.ndarray, n: int, free_mask_u,
                    diag_elasticity, dtype=jnp.float32,
                    coupling_matrix: np.ndarray = None,
                    projection_matrix: np.ndarray = None,
                    nc: int = 2) -> ElasticityParityOps:
    """Build the persistent-parity-layout elasticity solve kit for a 2D
    structured Q2 grid (``n`` cells per axis)."""
    apply_p = make_apply_parity(element_matrix, n, nc, dtype)
    t = jax.jit(lambda x: to_parity(x, n, nc))
    f = jax.jit(lambda r: from_parity(r, n, nc))
    # setup constants in numpy (to_parity_np) + device_const transfers:
    # no eager device compiles, no device->host pulls (callers pass the
    # numpy originals)
    free_mask_u = np.asarray(free_mask_u, np.float64)
    diag_elasticity = np.asarray(diag_elasticity, np.float64)
    mask_p = device_const(to_parity_np(free_mask_u, n, nc), dtype)
    ones_p = to_parity_np(np.ones(diag_elasticity.shape), n, nc)
    diag_p = device_const(
        to_parity_np(diag_elasticity, n, nc) + (1.0 - ones_p), dtype)
    cr = (make_coupling_parity(coupling_matrix, n, nc, dtype)
          if coupling_matrix is not None else None)
    pr = (make_projection_parity(projection_matrix, n, nc, dtype)
          if projection_matrix is not None else None)
    return ElasticityParityOps(n=n, apply_rows=apply_p, to_rows=t,
                               from_rows=f, free_mask_rows=mask_p,
                               diag_rows=diag_p, coupling_rows=cr,
                               projection_rows=pr)

"""Operator applies as XLA convolutions (uniform structured grids).

On a uniform grid every cell has the same element matrix, so each FEM
operator is translation-invariant and factorizes into exactly two convs:

1. **gather∘element-matrix conv** — input: the node grid as channels-first
   image ``(1, n_comp, g, ..)``; kernel: the dense per-cell element matrix
   reshaped to ``(n_local_dofs_out, n_comp, (k+1)^dim window)``, stride k,
   VALID.  Output ``(1, N_out, n, ..)``: per-cell local contributions.
2. **one-hot scatter conv** — transposed placement of local contributions
   back onto the node grid: ``lhs_dilation = k`` with a one-hot kernel.

This is the whole matrix-free apply: ~2·Ndof² FLOPs of dense conv work, a
few ops of HLO (seconds to compile instead of
minutes for slice/pad chains), and zero gather/scatter instructions.  The
element matrices are computed once on the host from the same definitions the
dense test oracle uses (ops/dense.py), so the conv path is verified against
the generic path bit-for-bit (tests/test_structured.py).
"""

from __future__ import annotations


import numpy as np

import jax.numpy as jnp

from .devconst import host_const
from jax import lax

from ..ops.shape import node_lattice

_DIMNUMS = {
    1: ("NCH", "OIH", "NCH"),
    2: ("NCHW", "OIHW", "NCHW"),
    3: ("NCDHW", "OIDHW", "NCDHW"),
}


def _to_kernel(element_matrix: np.ndarray, n_comp_in: int, k: int, dim: int):
    """Element matrix (N_out, N_in_nodes * n_comp_in) -> conv kernel
    (N_out, n_comp_in, (k+1) spatial ... x-last).

    Local node m = ix + (k+1) iy + (k+1)^2 iz maps to window position
    [..., iz, iy, ix].
    """
    n1 = k + 1
    n_out = element_matrix.shape[0]
    n_nodes_in = element_matrix.shape[1] // n_comp_in
    w = element_matrix.reshape(n_out, n_nodes_in, n_comp_in)
    # split node index (x fastest) into spatial window axes (z, y, x):
    # C-order split puts the most significant digit (z) first
    w = w.reshape(n_out, *([n1] * dim), n_comp_in)
    w = np.moveaxis(w, -1, 1)                     # (n_out, comp, z, y, x)
    return w


def _scatter_kernel(n_out_comp: int, n_local: int, n_comp: int, k: int,
                    dim: int):
    """One-hot kernel placing local dof (node, comp) at grid offset(node):
    (n_comp out, n_local * n_comp in, window k+1 per axis) with the
    spatially-flipped one-hot positions ``k - off``."""
    n1 = k + 1
    lat = node_lattice(k, dim)                    # (n_nodes, dim) x-first
    w = np.zeros((n_comp, n_local * n_comp, *([n1] * dim)))
    n_nodes = n_local
    for node in range(n_nodes):
        pos = [k - int(lat[node, d]) for d in range(dim)]  # x, y, z flips
        for c in range(n_comp):
            w[(c, node * n_comp + c, *pos[::-1])] = 1.0    # index z, y, x
    return w


def conv_cellwise(x, kernel, k: int, dim: int, n_comp: int, gs,
                  precision=lax.Precision.HIGHEST):
    """Node grid -> per-cell local values: stride-k VALID conv.

    x: flat dof vector (prod(gs) * n_comp,), interleaved comps;
    ``gs``: nodes per axis in (x, y[, z]) order (int = same per axis).
    Returns (N_out, n_cells) with cells x-fastest.
    """
    gs = (gs,) * dim if np.ndim(gs) == 0 else tuple(gs)
    X = x.reshape(*reversed(gs), n_comp)
    X = jnp.moveaxis(X, -1, 0)[None]              # (1, comp, z, y, x)
    out = lax.conv_general_dilated(
        X, kernel, window_strides=(k,) * dim, padding="VALID",
        dimension_numbers=_DIMNUMS[dim], precision=precision)
    n_out = kernel.shape[0]
    return out[0].reshape(n_out, -1)


def conv_scatter(ye, kernel, k: int, dim: int, n_comp: int, n,
                 precision=lax.Precision.HIGHEST):
    """Per-cell local values (N_local*n_comp, n_cells) -> node grid flat
    vector.  ``n``: cells per axis in (x, y[, z]) order (int = same)."""
    ns = (n,) * dim if np.ndim(n) == 0 else tuple(n)
    Y = ye.reshape(1, ye.shape[0], *reversed(ns))
    out = lax.conv_general_dilated(
        Y, kernel, window_strides=(1,) * dim,
        padding=[(k, k)] * dim, lhs_dilation=(k,) * dim,
        dimension_numbers=_DIMNUMS[dim], precision=precision)
    # out: (1, n_comp, gz, .., gx)
    return jnp.moveaxis(out[0], 0, -1).reshape(-1)


def make_stencil_apply(element_matrix: np.ndarray, k_in: int, k_out: int,
                       n_comp_in: int, n_comp_out: int, dim: int,
                       n_cells, dtype,
                       precision=lax.Precision.HIGHEST):
    """Build ``apply(x) -> y`` for one operator.

    ``element_matrix``: (N_out_nodes * n_comp_out, N_in_nodes * n_comp_in)
    dense per-cell matrix; rows/cols indexed (node * n_comp + comp) with the
    standard x-fastest local node ordering.  ``k_in``/``k_out`` are the
    polynomial degrees of the input/output spaces.  ``n_cells``: int or
    per-axis counts in (x, y[, z]) order (anisotropic grids).

    ``precision``: conv precision.  HIGHEST = full f32 (the solver
    operator); lower settings are legitimate for *preconditioner* applies
    (smoothers), which only need to be a fixed linear operator.
    """
    ns = (n_cells,) * dim if np.ndim(n_cells) == 0 else tuple(n_cells)
    if k_in == k_out == 1 and n_comp_in == n_comp_out == 1:
        return _make_q1_slices_apply(element_matrix, dim, ns, dtype)
    if dim == 2:
        # 2D: tiny-channel convs stream far below memory bandwidth; the
        # parity-matmul formulation below is the same algorithm as the 3D
        # row layout (one N_in-contraction matmul per apply)
        return _make_parity_matmul_apply(element_matrix, k_in, k_out,
                                         n_comp_in, n_comp_out, dim, ns,
                                         dtype, precision)
    gs_in = tuple(k_in * n + 1 for n in ns)
    wg = host_const(_to_kernel(element_matrix, n_comp_in, k_in, dim),
                      dtype)
    n_local_out = element_matrix.shape[0] // n_comp_out
    ws = host_const(
        _scatter_kernel(n_comp_out, n_local_out, n_comp_out, k_out, dim),
        dtype)

    def apply(x):
        ye = conv_cellwise(x, wg, k_in, dim, n_comp_in, gs_in,
                           precision=precision)
        return conv_scatter(ye, ws, k_out, dim, n_comp_out, ns,
                            precision=precision)

    return apply


def _make_q1_slices_apply(element_matrix: np.ndarray, dim: int, ns, dtype):
    """Scalar Q1 -> Q1 operator as shifted-slice multiply-adds.

    The tiny-channel convs of the generic path stream far below memory
    bandwidth; for the Q1 case the cell loop collapses to 2^dim full-grid
    shifted slices, 4^dim scalar fused multiply-adds, and 2^dim shifted
    accumulations — plain elementwise streaming that XLA fuses into one
    loop.  Semantics identical to the two-conv form (cells enumerate slices,
    so boundary weights are exact); carries the pressure mass/Laplace/
    fused-Jacobian applies and the pressure GMG level operators."""
    K = np.asarray(element_matrix, np.float64)
    # local lex order (x fastest) -> per-axis offsets in (x, y[, z])
    offsets = [tuple((a >> d) & 1 for d in range(dim)) for a in range(2**dim)]
    Kj = host_const(K, dtype)
    rev = tuple(reversed(ns))                       # grid is (z, y, x)

    def cell_slice(off):
        # numpy axis order is reversed (z, y, x); offset tuple is (x, y, z)
        return tuple(slice(off[dim - 1 - a], off[dim - 1 - a] + rev[a])
                     for a in range(dim))

    def pad_width(off):
        # scatter via pad + add: XLA fuses the 2^dim pads into ONE output
        # loop, vs one dynamic-update-slice per .at[].add window
        return tuple((off[dim - 1 - a], 1 - off[dim - 1 - a])
                     for a in range(dim))

    def apply(x):
        X = x.reshape(tuple(r + 1 for r in rev))
        U = [X[cell_slice(off)] for off in offsets]
        Y = None
        for ao, off in enumerate(offsets):
            V = sum(Kj[ao, ai] * U[ai] for ai in range(2**dim))
            P = jnp.pad(V, pad_width(off))
            Y = P if Y is None else Y + P
        return Y.reshape(-1)

    return apply


def _make_parity_matmul_apply(element_matrix: np.ndarray, k_in: int,
                              k_out: int, nci: int, nco: int, dim: int, ns,
                              dtype, precision=lax.Precision.HIGHEST):
    """Operator apply as ONE N_in-contraction matmul over all cells.

    The same algorithm as the 3D row layout (ops/rows3d, "one
    81-contraction matmul"), for the spaces/dims it does not cover (2D,
    mixed-degree coupling/projection):

    1. de-interleave the node grid into degree-parity subgrids with ONE
       pad+reshape per axis (node i = k*cell + o; class o=0 length n+1,
       classes 1..k-1 length n) — every local-node gather then becomes a
       CONTIGUOUS slice, no strided slicing, no tiny-channel convs;
    2. assemble the per-cell operand U (N_in, cells...) from those slices
       and issue one (N_out, N_in) x (N_in, E) einsum — the entire FLOP
       volume of the apply in a single matmul;
    3. scatter back by accumulating per parity class (pad+add, as the Q1
       slices path) and re-interleaving with one stack+reshape per axis.

    Layout contract identical to the conv pair: flat x-fastest dof vector,
    comps interleaved.  Verified bit-consistent with the conv path by
    tests/test_structured.py (same element matrices, tolerance-level
    equality — the summation order differs)."""
    K = np.asarray(element_matrix, np.float64)
    n_nodes_in = K.shape[1] // nci
    n_nodes_out = K.shape[0] // nco
    lat_in = node_lattice(k_in, dim)              # (n_nodes, dim) x-first
    lat_out = node_lattice(k_out, dim)
    # reorder to comp-major rows/cols: r_new = comp * n_nodes + node
    cols = np.array([node * nci + c
                     for c in range(nci) for node in range(n_nodes_in)])
    rows = np.array([node * nco + c
                     for c in range(nco) for node in range(n_nodes_out)])
    Kr = host_const(K[np.ix_(rows, cols)], dtype)
    rev_ns = tuple(reversed(ns))                  # cells per axis (z, y, x)
    gs_in = tuple(k_in * n + 1 for n in rev_ns)
    g_out = tuple(k_out * n + 1 for n in rev_ns)

    def apply(x):
        # comp-first grid (nci, z, y, x)
        X = jnp.moveaxis(x.reshape(*gs_in, nci), -1, 0)
        # de-interleave every spatial axis: (nci, nz+1, k, ny+1, k, ...)
        Xd = X
        for a in range(dim):
            ax = 1 + 2 * a                        # spatial axis position
            pad = [(0, 0)] * Xd.ndim
            pad[ax] = (0, k_in - 1)               # k*n+1 -> k*(n+1)
            Xd = jnp.pad(Xd, pad).reshape(
                Xd.shape[:ax] + (rev_ns[a] + 1, k_in) + Xd.shape[ax + 1:])
        pieces = []
        for node in range(n_nodes_in):
            idx = [slice(None)]                   # comp axis
            for a in range(dim):                  # z .. x
                o = int(lat_in[node, dim - 1 - a])
                cls, start = (o, 0) if o < k_in else (0, 1)
                idx += [slice(start, start + rev_ns[a]), cls]
            pieces.append(Xd[tuple(idx)])         # (nci, nz, ny, nx)
        U = jnp.stack(pieces, axis=1).reshape(nci * n_nodes_in, *rev_ns)
        Ye = jnp.einsum("oi,i...->o...", Kr, U, precision=precision)
        Ye = Ye.reshape(nco, n_nodes_out, *rev_ns)
        # accumulate per out parity class (class 0 takes offsets 0 AND k)
        combos: dict = {}
        for node in range(n_nodes_out):
            pads = [(0, 0)]                       # comp axis
            cls = []
            for a in range(dim):
                o = int(lat_out[node, dim - 1 - a])
                if o < k_out:
                    cls.append(o)
                    pads.append((0, 1))
                else:
                    cls.append(0)
                    pads.append((1, 0))
            P = jnp.pad(Ye[:, node], pads)        # (nco, nz+1, .., nx+1)
            key = tuple(cls)
            combos[key] = combos[key] + P if key in combos else P
        # re-interleave axis by axis, innermost (x) first
        for a in reversed(range(dim)):
            new = {}
            for key in {k[:a] for k in combos}:
                S = jnp.stack([combos[key + (c,)] for c in range(k_out)],
                              axis=a + 2)         # right after axis a's n+1
                S = S.reshape(S.shape[:a + 1]
                              + ((rev_ns[a] + 1) * k_out,) + S.shape[a + 3:])
                idx = [slice(None)] * (a + 1) + [slice(0, g_out[a])]
                new[key] = S[tuple(idx)]
            combos = new
        Z = combos[()]                            # (nco, gz, gy, gx)
        return jnp.moveaxis(Z, 0, -1).reshape(-1)

    return apply

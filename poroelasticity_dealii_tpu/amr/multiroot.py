"""Forest-of-roots AMR over an arbitrary coarse quad mesh (2D).

deal.II refines any ``Triangulation`` — including one read from gmsh
(``/root/reference/lib/include/PoroelasticityFSS.h:439-445`` feeding
``refine_mesh`` at ``:448-498``): the coarse cells are the forest roots and
refinement subdivides each root's reference square.  This module is the
array-based equivalent of that model, generalizing :class:`.forest.QuadForest`
(one axis-aligned root) to a forest rooted on the cells of an imported
``.msh``: each root carries a bilinear map from the unit square onto its
(possibly distorted) physical quad, and all refinement bookkeeping runs in
exact per-root integer coordinates.

A leaf is ``(level, ix, iy, root)`` — level first so the shared
``fixed_fraction_marks`` level clamps (``kelly.py``) apply unchanged.

Key geometric facts this module relies on:

* a bilinear map restricted to an axis-aligned sub-rectangle of the unit
  square is again bilinear in the sub-rectangle's local coordinates, so
  every fine cell is exactly the bilinear quad of its corner images — the
  extracted :class:`~..mesh.core.Mesh` is self-contained and the existing
  isoparametric discretization applies as-is;
* bilinear maps are affine along each edge, so root edges (and all fine
  face segments) are straight, shared-edge points computed from either
  incident root coincide, and the hanging-node interpolation weights in the
  edge parameter (0.5/0.5 for Q1; 0.375/0.75/-0.125 for Q2) are exact on
  distorted parents too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..mesh.core import Mesh

# leaf = (level, ix, iy, root)
MRLeaf = Tuple[int, int, int, int]

# local side id (== deal.II colorize face_local 2*axis+side):
#   0 = left (x=0), 1 = right (x=1), 2 = bottom (y=0), 3 = top (y=1)
# corners of each side in lex corner order, listed at (param=0, param=1);
# the edge parameter is y for vertical sides, x for horizontal ones
_SIDE_CORNERS = {0: (0, 2), 1: (1, 3), 2: (0, 1), 3: (2, 3)}


@dataclasses.dataclass
class MultiRootQuadForest:
    """2D quadtree forest whose roots are the cells of a coarse quad mesh."""

    root_cells: np.ndarray       # (C, 4) int coarse corner vertex ids (lex)
    root_coords: np.ndarray      # (V, 2) float coarse vertex coordinates
    # (root, side) -> boundary id for coarse boundary faces
    boundary_ids: Dict[Tuple[int, int], int]
    leaves: Set[MRLeaf]

    def __post_init__(self):
        self.root_cells = np.asarray(self.root_cells, np.int64)
        self.root_coords = np.asarray(self.root_coords, float)
        # edge registry: canonical (vmin, vmax) -> [(root, side, flip)];
        # flip means the root's side parameter runs opposite to the
        # canonical (vmin -> vmax) direction
        reg: Dict[Tuple[int, int], List[Tuple[int, int, bool]]] = {}
        for r in range(self.n_roots):
            for s, (c0, c1) in _SIDE_CORNERS.items():
                va = int(self.root_cells[r, c0])
                vb = int(self.root_cells[r, c1])
                key = (min(va, vb), max(va, vb))
                reg.setdefault(key, []).append((r, s, va > vb))
        for key, inc in reg.items():
            if len(inc) > 2:
                raise ValueError(f"non-manifold coarse edge {key}")
        self._edges = reg
        # (root, side) -> (neighbor root, neighbor side, rel_flip) | None
        self._nbr: Dict[Tuple[int, int], Optional[Tuple[int, int, bool]]] = {}
        for inc in reg.values():
            if len(inc) == 1:
                self._nbr[inc[0][:2]] = None
            else:
                (ra, sa, fa), (rb, sb, fb) = inc
                self._nbr[(ra, sa)] = (rb, sb, fa ^ fb)
                self._nbr[(rb, sb)] = (ra, sa, fa ^ fb)
        self._vid: Dict[tuple, int] = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_mesh(cls, coarse: Mesh, level: int = 0) -> "MultiRootQuadForest":
        """Root the forest on ``coarse``'s cells, each uniformly refined
        ``level`` times (the ``initial refinement level`` semantics of the
        reference's ``create_mesh``, applied to an imported mesh)."""
        if coarse.dim != 2:
            raise NotImplementedError("multi-root AMR is 2D (quad) only")
        bids = {(int(c), int(s)): int(i)
                for c, s, i in zip(coarse.face_cells, coarse.face_local,
                                   coarse.face_ids)}
        n = 2 ** level
        leaves = {(level, ix, iy, r)
                  for r in range(coarse.n_cells)
                  for ix in range(n) for iy in range(n)}
        return cls(root_cells=coarse.cells, root_coords=coarse.vertices,
                   boundary_ids=bids, leaves=leaves)

    def copy(self) -> "MultiRootQuadForest":
        return MultiRootQuadForest(self.root_cells, self.root_coords,
                                   dict(self.boundary_ids), set(self.leaves))

    @property
    def n_roots(self) -> int:
        return self.root_cells.shape[0]

    @property
    def max_level(self) -> int:
        return max(leaf[0] for leaf in self.leaves)

    def sorted_leaves(self) -> List[MRLeaf]:
        """Deterministic cell order: by root, then spatially within the
        root (y-major, x fastest) at the common resolution."""
        R = 2 ** self.max_level

        def key(leaf):
            l, ix, iy, r = leaf
            s = R >> l
            return (r, iy * s, ix * s)
        return sorted(self.leaves, key=key)

    # ------------------------------------------------------------------
    # integer-geometry helpers (root frame, resolution n = 2**level)
    # ------------------------------------------------------------------
    def _cross(self, l: int, ix: int, iy: int, r: int, side: int):
        """Map the OUT-OF-ROOT virtual cell position (l, ix, iy, r) that
        lies just across ``side`` of root ``r`` into the neighboring root's
        frame; None at a domain boundary."""
        nbr = self._nbr.get((r, side))
        if nbr is None:
            return None
        rn, sn, flip = nbr
        n = 1 << l
        q = iy if side in (0, 1) else ix        # edge-parameter index
        if flip:
            q = n - 1 - q
        if sn == 0:
            return (l, 0, q, rn)
        if sn == 1:
            return (l, n - 1, q, rn)
        if sn == 2:
            return (l, q, 0, rn)
        return (l, q, n - 1, rn)

    def _edge_neighbor_cell(self, l, ix, iy, r, dx, dy):
        """The same-level cell position across one edge (may live in a
        neighboring root); None outside the domain."""
        n = 1 << l
        nx, ny = ix + dx, iy + dy
        if 0 <= nx < n and 0 <= ny < n:
            return (l, nx, ny, r)
        if nx < 0:
            return self._cross(l, nx, iy, r, 0)
        if nx >= n:
            return self._cross(l, nx, iy, r, 1)
        if ny < 0:
            return self._cross(l, ix, ny, r, 2)
        return self._cross(l, ix, ny, r, 3)

    def neighbors_coarser(self, leaf: MRLeaf) -> List[MRLeaf]:
        """Existing leaves edge-adjacent to ``leaf`` at a coarser level
        (including across root boundaries)."""
        l, ix, iy, r = leaf
        out = []
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            pos = self._edge_neighbor_cell(l, ix, iy, r, dx, dy)
            if pos is None:
                continue
            pl, px, py, pr = pos
            for lc in range(pl - 1, -1, -1):
                cand = (lc, px >> (pl - lc), py >> (pl - lc), pr)
                if cand in self.leaves:
                    out.append(cand)
                    break
        return out

    def _has_descendant_leaf(self, cell: MRLeaf) -> bool:
        l, ix, iy, r = cell
        for dl in (1, 2):           # 1-irregular forests never need more
            f = 1 << dl
            for dx in range(f):
                for dy in range(f):
                    if (l + dl, ix * f + dx, iy * f + dy, r) in self.leaves:
                        return True
        return False

    def _enforce_one_irregular_refine(self, marked: Set[MRLeaf]):
        marked = set(marked)
        changed = True
        while changed:
            changed = False
            for leaf in list(marked):
                l = leaf[0]
                for nb in self.neighbors_coarser(leaf):
                    if l - nb[0] >= 1 and nb not in marked:
                        marked.add(nb)
                        changed = True
        return marked

    # ------------------------------------------------------------------
    def refine_and_coarsen(self, refine: Set[MRLeaf], coarsen: Set[MRLeaf]):
        """deal.II-like mark application (mirrors ``QuadForest``):
        refinement wins; coarsening needs all four siblings and must not
        break 1-irregularity (checked across root boundaries too)."""
        refine = self._enforce_one_irregular_refine(
            set(refine) & self.leaves)
        coarsen = set(coarsen) & self.leaves - refine

        new_leaves = set(self.leaves)
        for (l, ix, iy, r) in refine:
            new_leaves.discard((l, ix, iy, r))
            for dx in (0, 1):
                for dy in (0, 1):
                    new_leaves.add((l + 1, 2 * ix + dx, 2 * iy + dy, r))

        by_parent: Dict[MRLeaf, int] = {}
        for (l, ix, iy, r) in coarsen:
            if l == 0:
                continue
            p = (l - 1, ix // 2, iy // 2, r)
            by_parent[p] = by_parent.get(p, 0) + 1
        tmp = self.copy()
        tmp.leaves = new_leaves
        for parent, count in sorted(by_parent.items()):
            if count != 4:
                continue
            l, ix, iy, r = parent
            children = [(l + 1, 2 * ix + dx, 2 * iy + dy, r)
                        for dx in (0, 1) for dy in (0, 1)]
            if not all(c in tmp.leaves for c in children):
                continue
            ok = True
            for (cl, cx, cy, cr) in children:
                for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    pos = tmp._edge_neighbor_cell(cl, cx, cy, cr, dx, dy)
                    if pos is None:
                        continue
                    if pos[3] == cr and (pos[1] // 2, pos[2] // 2) == \
                            (cx // 2, cy // 2):
                        continue            # sibling
                    if tmp._has_descendant_leaf(pos):
                        ok = False
                        break
                if not ok:
                    break
            if ok:
                for c in children:
                    tmp.leaves.discard(c)
                tmp.leaves.add(parent)
        self.leaves = tmp.leaves

    # ------------------------------------------------------------------
    # mesh extraction
    # ------------------------------------------------------------------
    def _classify(self, r: int, x: int, y: int, R: int) -> tuple:
        """Exact cross-root dedup key of the integer point (x, y) in root
        ``r``'s frame at resolution ``R``: coarse-vertex key at corners,
        canonical (vmin, vmax, param) key on root edges, per-root key in
        the interior."""
        on_x = x == 0 or x == R
        on_y = y == 0 or y == R
        if on_x and on_y:
            corner = (1 if x else 0) + (2 if y else 0)
            return ("v", int(self.root_cells[r, corner]))
        if on_x or on_y:
            side = (0 if x == 0 else 1) if on_x else (2 if y == 0 else 3)
            p = y if on_x else x
            c0, c1 = _SIDE_CORNERS[side]
            va = int(self.root_cells[r, c0])
            vb = int(self.root_cells[r, c1])
            if va < vb:
                return ("e", va, vb, p)
            return ("e", vb, va, R - p)
        return ("i", r, x, y)

    def _bilinear(self, r: int, xi: np.ndarray) -> np.ndarray:
        """Physical position(s) of reference point(s) ``xi`` (.., 2) in
        root ``r``."""
        c = self.root_coords[self.root_cells[r]]          # (4, 2) lex
        u, v = xi[..., :1], xi[..., 1:]
        return ((1 - u) * (1 - v) * c[0] + u * (1 - v) * c[1]
                + (1 - u) * v * c[2] + u * v * c[3])

    def to_mesh(self) -> Mesh:
        R = 2 ** self.max_level
        leaves = self.sorted_leaves()
        vid: Dict[tuple, int] = {}
        coords: List[np.ndarray] = []

        def get_vid(r, x, y):
            key = self._classify(r, x, y, R)
            i = vid.get(key)
            if i is None:
                i = len(coords)
                vid[key] = i
                coords.append(self._bilinear(r, np.array([x / R, y / R])))
            return i

        cells = np.zeros((len(leaves), 4), np.int32)
        face_cells, face_local, face_ids = [], [], []
        for c, (l, ix, iy, r) in enumerate(leaves):
            s = R >> l
            x0, y0 = ix * s, iy * s
            cells[c] = [get_vid(r, x0, y0), get_vid(r, x0 + s, y0),
                        get_vid(r, x0, y0 + s), get_vid(r, x0 + s, y0 + s)]
            n = 1 << l
            for side, at_bdry in ((0, ix == 0), (1, ix == n - 1),
                                  (2, iy == 0), (3, iy == n - 1)):
                if at_bdry and self._nbr.get((r, side)) is None:
                    face_cells.append(c)
                    face_local.append(side)
                    face_ids.append(self.boundary_ids.get((r, side), 0))
        self._vid = vid
        return Mesh(dim=2, vertices=np.asarray(coords, float),
                    cells=cells,
                    face_cells=np.asarray(face_cells, np.int32),
                    face_local=np.asarray(face_local, np.int32),
                    face_ids=np.asarray(face_ids, np.int32))

    # ------------------------------------------------------------------
    # interior faces (conforming + coarse-fine), in CURVE coordinates
    # ------------------------------------------------------------------
    def _leaf_edge_records(self):
        """Per leaf edge: (curve, lo, span, side_flag, cell_index).

        ``curve`` identifies the straight line the edge lies on:
        ``('i', root, axis, line)`` for intra-root lines (lo = transverse
        start) or ``('e', vmin, vmax)`` for coarse-mesh edges (lo in the
        canonical vmin->vmax parameterization).  ``side_flag`` is 0/1 and
        differs for the two cells incident to a curve."""
        R = 2 ** self.max_level
        leaves = self.sorted_leaves()
        recs = []
        for i, (l, ix, iy, r) in enumerate(leaves):
            s = R >> l
            x0, y0 = ix * s, iy * s
            n = 1 << l
            # (side, interior-line spec) for each of the 4 leaf edges
            for side, line, lo in ((0, x0, y0), (1, x0 + s, y0),
                                   (2, y0, x0), (3, y0 + s, x0)):
                axis = 0 if side in (0, 1) else 1
                at_root_edge = (side == 0 and ix == 0) or \
                    (side == 1 and ix == n - 1) or \
                    (side == 2 and iy == 0) or \
                    (side == 3 and iy == n - 1)
                if at_root_edge:
                    if self._nbr.get((r, side)) is None:
                        continue                      # domain boundary
                    c0, c1 = _SIDE_CORNERS[side]
                    va = int(self.root_cells[r, c0])
                    vb = int(self.root_cells[r, c1])
                    if va < vb:
                        curve, clo = ("e", va, vb), lo
                    else:
                        curve, clo = ("e", vb, va), R - lo - s
                    # the two (root, side) incidences of the curve get
                    # opposite flags (order in the edge registry)
                    inc = self._edges[(min(va, vb), max(va, vb))]
                    flag = [t[:2] for t in inc].index((r, side))
                    recs.append((curve, clo, s, flag, i))
                else:
                    curve = ("i", r, axis, line)
                    flag = 0 if side in (1, 3) else 1   # 0: cell on low side
                    recs.append((curve, lo, s, flag, i))
        return recs

    def interior_face_records(self):
        """Fine face segments as (cell_a, cell_b, curve, lo, span) with
        cell_a the coarse cell at coarse-fine interfaces.  One record per
        conforming face, two per hanging coarse edge (one per fine half)."""
        by_curve: Dict[tuple, List[Tuple[int, int, int, int]]] = {}
        for curve, lo, s, flag, i in self._leaf_edge_records():
            by_curve.setdefault(curve, []).append((lo, s, flag, i))
        out = []
        for curve, segs in sorted(by_curve.items()):
            sides = ({}, {})
            for lo, s, flag, i in segs:
                sides[flag][(lo, s)] = i
            for (lo, s), i in sorted(sides[0].items()):
                j = sides[1].get((lo, s))
                if j is not None:
                    out.append((i, j, curve, lo, s))
                    continue
                h = s // 2
                if h and (lo, h) in sides[1]:        # i coarse, j0/j1 fine
                    out.append((i, sides[1][(lo, h)], curve, lo, h))
                    out.append((i, sides[1][(lo + h, h)], curve, lo + h, h))
                # i fine with coarse partner: emitted when iterating the
                # coarse side below
            for (lo, s), j in sorted(sides[1].items()):
                if (lo, s) in sides[0]:
                    continue
                h = s // 2
                if h and (lo, h) in sides[0]:        # j coarse, fine in 0
                    out.append((j, sides[0][(lo, h)], curve, lo, h))
                    out.append((j, sides[0][(lo + h, h)], curve, lo + h, h))
        return out, self.sorted_leaves()

    def _curve_point(self, leaf: MRLeaf, curve, t: int, R: int):
        """Integer root-frame coordinates (x, y) of curve parameter ``t``
        as seen from ``leaf``'s root."""
        l, ix, iy, r = leaf
        if curve[0] == "i":
            _, cr, axis, line = curve
            assert cr == r
            return (line, t) if axis == 0 else (t, line)
        _, vmin, vmax = curve
        # which side of root r lies on this curve?
        for side, (c0, c1) in _SIDE_CORNERS.items():
            va = int(self.root_cells[r, c0])
            vb = int(self.root_cells[r, c1])
            if (min(va, vb), max(va, vb)) == (vmin, vmax):
                p = t if va < vb else R - t
                if side == 0:
                    return (0, p)
                if side == 1:
                    return (R, p)
                if side == 2:
                    return (p, 0)
                return (p, R)
        raise AssertionError("leaf's root not incident to curve")

    def _ref_seg(self, leaf: MRLeaf, curve, lo: int, span: int, R: int):
        """Segment endpoints in ``leaf``'s unit reference square, ordered
        by increasing curve parameter."""
        l, ix, iy, r = leaf
        s = R >> l
        x0, y0 = ix * s, iy * s
        pts = []
        for t in (lo, lo + span):
            x, y = self._curve_point(leaf, curve, t, R)
            pts.append(((x - x0) / s, (y - y0) / s))
        return np.asarray(pts, float)       # (2, 2)

    # ------------------------------------------------------------------
    def hanging_edges(self) -> List[Tuple[int, int, int]]:
        """Hanging coarse edges as (v0, v1, h) fine-mesh vertex-id triples
        (v0/v1 = coarse edge endpoints, h = hanging midpoint vertex).
        Requires a prior :meth:`to_mesh` call (uses its vertex ids)."""
        if not self._vid:
            raise RuntimeError("call to_mesh() before hanging_edges()")
        R = 2 ** self.max_level
        records, leaves = self.interior_face_records()
        triples = []
        seen = set()
        for (a, b, curve, lo, span) in records:
            if leaves[a][0] == leaves[b][0]:
                continue                        # conforming
            span2 = 2 * span
            LO = lo - (lo % span2)
            key = (curve, LO)
            if key in seen:
                continue
            seen.add(key)
            coarse = a if leaves[a][0] < leaves[b][0] else b
            ids = []
            for t in (LO, LO + span, LO + span2):
                x, y = self._curve_point(leaves[coarse], curve, t, R)
                ids.append(self._vid[self._classify(
                    leaves[coarse][3], x, y, R)])
            v0, h, v1 = ids
            triples.append((v0, v1, h))
        return triples


# ---------------------------------------------------------------------------
# Kelly estimator on multi-root (distorted-cell) meshes
# ---------------------------------------------------------------------------

def _bilinear_grads_phys(corners, values, ref):
    """Physical gradient of the Q1 field with corner ``values`` (F, 4) on
    bilinear cells with ``corners`` (F, 4, 2), at reference points ``ref``
    (F, Q, 2).  Returns (F, Q, 2)."""
    u, v = ref[..., 0], ref[..., 1]                       # (F, Q)
    # d phi / d(u, v) in lex corner order
    du = np.stack([-(1 - v), (1 - v), -v, v], axis=-1)    # (F, Q, 4)
    dv = np.stack([-(1 - u), -u, (1 - u), u], axis=-1)
    g_ref = np.stack([np.einsum("fqa,fa->fq", du, values),
                      np.einsum("fqa,fa->fq", dv, values)], axis=-1)
    # Jacobian d(x, y)/d(u, v): columns are corner combinations
    Jxu = np.einsum("fqa,fad->fqd", du, corners)          # (F, Q, 2)
    Jxv = np.einsum("fqa,fad->fqd", dv, corners)
    J = np.stack([Jxu, Jxv], axis=-1)                     # (F, Q, 2(x), 2(u))
    # grad_phys = J^{-T} grad_ref
    return np.linalg.solve(np.swapaxes(J, -1, -2), g_ref[..., None])[..., 0]


def kelly_estimate_multiroot(forest: MultiRootQuadForest, mesh,
                             p: np.ndarray) -> np.ndarray:
    """Per-cell Kelly indicator eta_K on a multi-root forest: face-jump
    integrals of the normal pressure derivative over all interior fine face
    segments (2-point Gauss), geometry-exact on distorted bilinear cells;
    same (h_F / 24) convention as :func:`.kelly.kelly_estimate`."""
    records, leaves = forest.interior_face_records()
    eta2 = np.zeros(len(leaves))
    if not records:
        return eta2
    R = 2 ** forest.max_level
    gp = np.array([0.5 - 0.5 / np.sqrt(3), 0.5 + 0.5 / np.sqrt(3)])
    gw = np.array([0.5, 0.5])

    A = np.array([r[0] for r in records])
    B = np.array([r[1] for r in records])
    refA = np.stack([forest._ref_seg(leaves[r[0]], r[2], r[3], r[4], R)
                     for r in records])                   # (F, 2, 2)
    refB = np.stack([forest._ref_seg(leaves[r[1]], r[2], r[3], r[4], R)
                     for r in records])
    corners = mesh.vertices[mesh.cells]                   # (E, 4, 2)
    cellv = p[mesh.cells]                                 # (E, 4)

    # physical endpoints from cell A's bilinear map (straight segments)
    def at_ref(c, ref):
        u, v = ref[..., :1], ref[..., 1:]
        w = np.concatenate([(1 - u) * (1 - v), u * (1 - v),
                            (1 - u) * v, u * v], axis=-1)  # (F, .., 4)
        return np.einsum("f...a,fad->f...d", w, c)

    pe = at_ref(corners[A], refA)                         # (F, 2, 2)
    tangent = pe[:, 1] - pe[:, 0]
    length = np.linalg.norm(tangent, axis=-1)
    normal = np.stack([tangent[:, 1], -tangent[:, 0]], axis=-1) \
        / np.maximum(length, 1e-300)[:, None]

    qA = refA[:, None, 0, :] + gp[None, :, None] \
        * (refA[:, 1, :] - refA[:, 0, :])[:, None, :]     # (F, Q, 2)
    qB = refB[:, None, 0, :] + gp[None, :, None] \
        * (refB[:, 1, :] - refB[:, 0, :])[:, None, :]
    ga = _bilinear_grads_phys(corners[A], cellv[A], qA)
    gb = _bilinear_grads_phys(corners[B], cellv[B], qB)
    jump = np.einsum("fqd,fd->fq", ga - gb, normal)
    integral = length * (gw[None, :] * jump ** 2).sum(axis=1)
    contrib = (length / 24.0) * integral
    np.add.at(eta2, A, contrib)
    np.add.at(eta2, B, contrib)
    return np.sqrt(eta2)


# ---------------------------------------------------------------------------
# solution transfer on multi-root forests
# ---------------------------------------------------------------------------

def _invert_bilinear(corners: np.ndarray, pts: np.ndarray,
                     iters: int = 12) -> np.ndarray:
    """Newton inversion of one root's bilinear map for many points:
    ``corners`` (4, 2) lex order, ``pts`` (P, 2) -> reference (P, 2)."""
    c0, c1, c2, c3 = corners
    bx = c1 - c0
    cy = c2 - c0
    d = c3 - c1 - c2 + c0
    xi = np.full((pts.shape[0], 2), 0.5)
    for _ in range(iters):
        u, v = xi[:, :1], xi[:, 1:]
        x = c0 + u * bx + v * cy + (u * v) * d
        res = pts - x
        Ju = bx + v * d                                   # (P, 2)
        Jv = cy + u * d
        det = Ju[:, 0] * Jv[:, 1] - Ju[:, 1] * Jv[:, 0]
        det = np.where(np.abs(det) < 1e-300, 1e-300, det)
        du = (res[:, 0] * Jv[:, 1] - res[:, 1] * Jv[:, 0]) / det
        dv = (Ju[:, 0] * res[:, 1] - Ju[:, 1] * res[:, 0]) / det
        xi = xi + np.stack([du, dv], axis=1)
        xi = np.clip(xi, -0.5, 1.5)         # keep Newton in the basin
    return xi


def transfer_nodal_multiroot(forest_old: MultiRootQuadForest, mesh_old,
                             values: np.ndarray,
                             new_points: np.ndarray) -> np.ndarray:
    """Evaluate old Q1 nodal field(s) at ``new_points`` (the deal.II
    ``SolutionTransfer`` analogue of :func:`.transfer.transfer_nodal`, for
    multi-root forests): locate the containing root by inverting each
    root's bilinear map, then the containing leaf in exact root-reference
    coordinates, then interpolate bilinearly within the leaf."""
    from .transfer import _morton

    P = new_points.shape[0]
    was_1d = values.ndim == 1
    values = np.atleast_2d(values)
    cellv = values[..., mesh_old.cells]                   # (..., E, 4)

    # 1. containing root: min residual over roots with in-square ref coords
    best_res = np.full(P, np.inf)
    root_of = np.zeros(P, np.int64)
    ref = np.zeros((P, 2))
    for r in range(forest_old.n_roots):
        corners = forest_old.root_coords[forest_old.root_cells[r]]
        xi = _invert_bilinear(corners, new_points)
        xi_c = np.clip(xi, 0.0, 1.0)
        x_back = forest_old._bilinear(r, xi_c)
        res = np.linalg.norm(x_back - new_points, axis=-1)
        take = res < best_res - 1e-12
        best_res = np.where(take, res, best_res)
        root_of = np.where(take, r, root_of)
        ref[take] = xi_c[take]

    # 2. containing leaf within the root (per-root Morton lookup)
    leaves = forest_old.sorted_leaves()
    Lmax = forest_old.max_level
    R = 2 ** Lmax
    lv = np.array([leaf[0] for leaf in leaves], dtype=np.int64)
    li = np.array([(leaf[1], leaf[2]) for leaf in leaves], dtype=np.int64)
    lr = np.array([leaf[3] for leaf in leaves], dtype=np.int64)
    starts = _morton(li << (Lmax - lv)[:, None], Lmax, 2)
    # compose (root, morton) into one sortable key
    key = lr * (R * R) + starts
    order = np.argsort(key)
    f = np.minimum((ref * R).astype(np.int64), R - 1)
    pkey = root_of * (R * R) + _morton(f, Lmax, 2)
    c = order[np.searchsorted(key[order], pkey, side="right") - 1]

    n = (1 << lv[c]).astype(np.float64)
    idx = np.minimum((ref * n[:, None]).astype(np.int64),
                     (n[:, None] - 1).astype(np.int64))
    xi = ref * n[:, None] - idx                           # (P, 2) in [0, 1]
    w = np.stack([(1 - xi[:, 0]) * (1 - xi[:, 1]),
                  xi[:, 0] * (1 - xi[:, 1]),
                  (1 - xi[:, 0]) * xi[:, 1],
                  xi[:, 0] * xi[:, 1]], axis=1)           # (P, 4)
    out = np.einsum("...pv,pv->...p", cellv[..., c, :], w)
    return out[0] if was_1d else out

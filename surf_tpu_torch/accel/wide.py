"""The layouts the traversals read: the port's copies of
``surf_tpu.accel.wide.build_leaf_table`` (the dense leaf table of
``bitsru8``) and of ``build_wide_stream`` / ``pad_wide_stream`` /
``refit_wide_stream`` (the 8-wide DFS stream of the ``skip`` and ``stack``
walks, and its topology-preserving refit after animation).

Leaf table.  Leaf-ordered triangles are packed 8 to a 128-lane row, each in a 16-lane
record: v0 at lanes 0-2, e1 = v1 - v0 at 3-5, e2 = v2 - v0 at 6-8, and the
record's leaf-order triangle slot as int32 bits in lane 9 (-1 for
padding).  Zero records fail the Möller–Trumbore |det| >= eps test, so no
count field is needed.  Over the rows sits an arithmetic 8-ary box
hierarchy: each level boxes 8 consecutive entries of the level below.
Beside it, ``tablew`` holds the same triangles as Baldwin–Weber records
(``algo="bitsw"``), row for row.

Stream.  The binary SAH BVH collapsed into a branching-factor-8 tree and
flattened into one DFS-preorder table of 128-lane rows of two kinds:

- node row: child slot k at lanes [16k, 16k+6) = the child's box lo/hi,
  and lanes 16k+6, 16k+7 = (child's stream position, child is a leaf) as
  int32.  Empty slots carry NaN boxes, which fail every slab comparison;
- leaf row: triangle j at lanes [16j, 16j+9) = v0, e1, e2 (zero padding
  fails the Möller–Trumbore |det| >= eps test).

Lane 9 (int32) is 1 for leaf rows and 0 for node rows, lane 10 (int32) the
skip link, the stream position after the row's subtree.  Per node the
order is [node row][its leaf-item rows][child subtrees...].  Each node
slot keeps its provenance (a binary node, or a leaf-order triangle range),
so a refit rewrites the slot boxes without rebuilding the stream.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .builder import BVH, triangle_bounds

LEAF_TRIS = 8        # triangles per leaf row
LANE = 128
REC = 16
WIDTH = 8            # children per stream node row
IS_LEAF_LANE = 9
SKIP_LANE = 10


class LeafTable(NamedTuple):
    table: np.ndarray     # [n_pad, 128] f32 (v0/e1/e2 per 16-lane record)
    rec_slot: np.ndarray  # [n_pad * 8] int32 -> leaf-order tri slot (-1)
    box_lo: np.ndarray    # [E, 3] f32 (rows then hierarchy levels)
    box_hi: np.ndarray    # [E, 3]
    anc: np.ndarray       # [n_rows, MAXD] int32 (self, parent, ..., root)
    n_rows: int           # real leaf rows
    # Baldwin–Weber records, same rows and record slots: per 16-lane record
    #   [nx ny nz d0  a1x a1y a1z a1w  a2x a2y a2z a2w  slot 0 0 0]
    # with n = e1 x e2 (unnormalised), d0 = n.v0, and the affine
    # barycentric rows u = a1.p + a1w, v = a2.p + a2w of a point p on the
    # triangle's plane.  n.d is the Möller–Trumbore determinant up to sign,
    # so |n.d| >= eps is MT's |det| gate.  Padding records are all zero:
    # n.d = 0 fails the gate.
    tablew: np.ndarray    # [n_pad, 128] f32


def _fill_leaf_rows(table, rec_slot, tv0, tv1, tv2):
    """Vectorized in-place write of every leaf record's (v0, e1, e2) from
    leaf-ordered vertices."""
    valid = rec_slot >= 0
    rows_idx = np.nonzero(valid)[0] // LEAF_TRIS
    lane0 = (np.nonzero(valid)[0] % LEAF_TRIS) * REC
    slots = rec_slot[valid]
    for c in range(3):
        table[rows_idx, lane0 + 0 + c] = tv0[slots, c]
        table[rows_idx, lane0 + 3 + c] = tv1[slots, c] - tv0[slots, c]
        table[rows_idx, lane0 + 6 + c] = tv2[slots, c] - tv0[slots, c]


def _fill_bw_rows(table, rec, tv0, tv1, tv2):
    """Vectorised in-place write of the Baldwin–Weber records (see
    LeafTable.tablew).  The coefficients are derived in float64 and stored
    as f32; the projection axis k is the normal's dominant axis, with
    (i, j, k) cyclic, so the 2-D determinant is exactly n_k."""
    valid = rec >= 0
    pos = np.nonzero(valid)[0]
    ridx = pos // LEAF_TRIS
    lane0 = (pos % LEAF_TRIS) * REC
    slots = rec[valid]
    v0 = tv0[slots].astype(np.float64)
    e1 = (tv1[slots] - tv0[slots]).astype(np.float64)
    e2 = (tv2[slots] - tv0[slots]).astype(np.float64)
    n = np.cross(e1, e2)
    k = np.argmax(np.abs(n), axis=1)
    i_ = (k + 1) % 3
    j_ = (k + 2) % 3
    r = np.arange(len(slots))
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / n[r, k]
    a1 = np.zeros((len(slots), 3))
    a2 = np.zeros((len(slots), 3))
    a1[r, i_] = e2[r, j_] * inv
    a1[r, j_] = -e2[r, i_] * inv
    a1w = (e2[r, i_] * v0[r, j_] - e2[r, j_] * v0[r, i_]) * inv
    a2[r, i_] = -e1[r, j_] * inv
    a2[r, j_] = e1[r, i_] * inv
    a2w = (e1[r, j_] * v0[r, i_] - e1[r, i_] * v0[r, j_]) * inv
    d0 = np.einsum("ij,ij->i", n, v0)
    cols = [n[:, 0], n[:, 1], n[:, 2], d0,
            a1[:, 0], a1[:, 1], a1[:, 2], a1w,
            a2[:, 0], a2[:, 1], a2[:, 2], a2w]
    for c, col in enumerate(cols):
        # A degenerate triangle (n = 0) gets inf or NaN coefficients; its
        # n.d = 0 fails the |den| >= eps gate, as MT's |det| gate rejects it.
        table[ridx, lane0 + c] = col.astype(np.float32)
    table[ridx, lane0 + BW_SLOT_LANE] = slots.astype(np.int32).view(np.float32)


BW_SLOT_LANE = 12  # slot-id lane of a Baldwin–Weber record


def build_leaf_table(tv0, tv1, tv2) -> LeafTable:
    """Pack leaf-ordered triangles densely (8/row) and build the 8-ary
    box hierarchy over consecutive rows."""
    tv0 = np.asarray(tv0, np.float32)
    tv1 = np.asarray(tv1, np.float32)
    tv2 = np.asarray(tv2, np.float32)
    T = len(tv0)
    n0 = -(-T // LEAF_TRIS)
    # Pad with one FULL inert 8-row group beyond the last (possibly
    # partial) real group: list padding points at it (all-zero rows fail
    # every MT |det| test).
    n_pad = (-(-n0 // 8) + 1) * 8
    rec = np.full(n_pad * LEAF_TRIS, -1, np.int32)
    rec[:T] = np.arange(T, dtype=np.int32)
    table = np.zeros((n_pad, LANE), np.float32)
    _fill_leaf_rows(table, rec, tv0, tv1, tv2)
    # Spare lane 9 of each 16-lane record carries the record's leaf-order
    # tri slot (int32; -1 for padding), so the intersection kernels emit
    # prim ids straight from the fetched row.
    rec2d = rec.reshape(n_pad, LEAF_TRIS)
    for j in range(LEAF_TRIS):
        table[:, REC * j + 9] = np.ascontiguousarray(
            rec2d[:, j]).view(np.float32)
    tablew = np.zeros((n_pad, LANE), np.float32)
    _fill_bw_rows(tablew, rec, tv0, tv1, tv2)

    tlo, thi = triangle_bounds(tv0, tv1, tv2)
    lo0 = np.full((n0, 3), np.inf, np.float32)
    hi0 = np.full((n0, 3), -np.inf, np.float32)
    idx = np.arange(T) // LEAF_TRIS
    np.minimum.at(lo0, idx, tlo)
    np.maximum.at(hi0, idx, thi)
    levels_lo, levels_hi = [lo0], [hi0]
    while len(levels_lo[-1]) > 1:
        cur_lo, cur_hi = levels_lo[-1], levels_hi[-1]
        n = len(cur_lo)
        npar = -(-n // 8)
        plo = np.full((npar, 3), np.inf, np.float32)
        phi = np.full((npar, 3), -np.inf, np.float32)
        gid = np.arange(n) // 8
        np.minimum.at(plo, gid, cur_lo)
        np.maximum.at(phi, gid, cur_hi)
        levels_lo.append(plo)
        levels_hi.append(phi)
    box_lo = np.concatenate(levels_lo)
    box_hi = np.concatenate(levels_hi)
    offs = np.cumsum([0] + [len(x) for x in levels_lo])
    maxd = len(levels_lo)
    r = np.arange(n0)
    anc = np.empty((n0, maxd), np.int32)
    for k in range(maxd):
        anc[:, k] = offs[k] + r // (8 ** k)
    return LeafTable(table, rec, box_lo, box_hi, anc, n0, tablew)


class WideStream(NamedTuple):
    """The 8-wide DFS stream (host arrays) and each node slot's provenance
    for ``refit_wide_stream``: kind 0 empty, 1 a binary node (a = its id),
    2 a leaf-order triangle range (a = first slot, b = count)."""

    stream: np.ndarray     # [E, 128] f32 node and leaf rows
    rec_slot: np.ndarray   # [E * 8] int32: record -> leaf-order tri slot (-1)
    n_entries: int         # rows before padding
    slot_kind: np.ndarray  # [E, 8] int8
    slot_a: np.ndarray     # [E, 8] int32
    slot_b: np.ndarray     # [E, 8] int32


def build_wide_stream(bvh: BVH, tri_v0, tri_v1, tri_v2) -> WideStream:
    """Collapse a binary BVH over *leaf-ordered* triangles (vertices already
    permuted by ``bvh.indices``) into the wide DFS stream
    (``surf_tpu/accel/wide.py:105-310``, without the own-box / ancestor
    arrays and the depth, which no ported walk reads: ``stream_depth``
    reads the depth from the stream)."""
    tv0 = np.asarray(tri_v0, np.float32)
    tv1 = np.asarray(tri_v1, np.float32)
    tv2 = np.asarray(tri_v2, np.float32)
    tlo, thi = triangle_bounds(tv0, tv1, tv2)

    count = bvh.count
    left_first = bvh.left_first
    node_lo, node_hi = bvh.node_lo, bvh.node_hi

    # items: ('n', i) binary node | ('l', first, cnt) leaf triangle range
    def item_box(it):
        if it[0] == "n":
            return node_lo[it[1]], node_hi[it[1]]
        return tlo[it[1]:it[1] + it[2]].min(axis=0), thi[it[1]:it[1] + it[2]].max(axis=0)

    def expandable(it):
        if it[0] == "n":
            return count[it[1]] == 0 or count[it[1]] > LEAF_TRIS
        return it[2] > LEAF_TRIS

    def area(it):
        lo, hi = item_box(it)
        e = hi - lo
        return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    def expand(it):
        if it[0] == "n" and count[it[1]] == 0:
            l = int(left_first[it[1]])
            return [("n", l), ("n", l + 1)]
        first, cnt = (int(left_first[it[1]]), int(count[it[1]])) \
            if it[0] == "n" else (it[1], it[2])
        h = cnt // 2
        return [("l", first, h), ("l", first + h, cnt - h)]

    def merge_adjacent_leaves(items):
        """Merge sibling leaf ranges that are contiguous in leaf order and
        fit one row."""
        def rng(it):
            if it[0] == "l":
                return it[1], it[2]
            if count[it[1]] > 0:
                return int(left_first[it[1]]), int(count[it[1]])
            return None
        changed = True
        while changed:
            changed = False
            for i in range(len(items)):
                a = rng(items[i])
                if a is None:
                    continue
                for j in range(len(items)):
                    if i == j:
                        continue
                    b = rng(items[j])
                    if b is None:
                        continue
                    if a[0] + a[1] == b[0] and a[1] + b[1] <= LEAF_TRIS:
                        items[i] = ("l", a[0], a[1] + b[1])
                        del items[j]
                        changed = True
                        break
                if changed:
                    break
        return items

    def make_children(root_items):
        items = merge_adjacent_leaves(list(root_items))
        while len(items) < WIDTH:
            cands = [i for i, it in enumerate(items) if expandable(it)]
            if not cands:
                break
            pick = max(cands, key=lambda i: area(items[i]))
            items[pick:pick + 1] = expand(items[pick])
        return items

    rows: list[np.ndarray] = []
    recs: list[np.ndarray] = []
    provenance: list[tuple[int, int, int, int, int]] = []  # row, slot, kind, a, b

    def emit_leaf_row(tri_slots) -> int:
        """One leaf item -> one row (<= 8 tris); returns its position.
        Triangle data is filled vectorized afterwards (_fill_leaf_rows)."""
        pos = len(rows)
        row = np.zeros(LANE, np.float32)
        rec = np.full(LEAF_TRIS, -1, np.int32)
        rec[: len(tri_slots)] = tri_slots
        row[IS_LEAF_LANE:SKIP_LANE + 1] = np.array([1, pos + 1], np.int32).view(np.float32)
        rows.append(row)
        recs.append(rec)
        return pos

    def emit_node(items):
        pos = len(rows)
        rows.append(np.zeros(LANE, np.float32))  # placeholder
        recs.append(np.full(LEAF_TRIS, -1, np.int32))
        boxes, child_pos, child_leaf, interior = [], [], [], []
        for k, it in enumerate(items):
            boxes.append(item_box(it))
            if it[0] == "n" and count[it[1]] == 0:
                l = int(left_first[it[1]])
                interior.append((k, make_children([("n", l), ("n", l + 1)])))
                child_pos.append(-1)  # filled after recursion
                child_leaf.append(0)
                provenance.append((pos, k, 1, it[1], 0))
            else:
                first, cnt = (int(left_first[it[1]]), int(count[it[1]])) \
                    if it[0] == "n" else (it[1], it[2])
                child_pos.append(emit_leaf_row(range(first, first + cnt)))
                child_leaf.append(1)
                provenance.append((pos, k, 2, first, cnt))
        for k, child_items in interior:
            child_pos[k] = emit_node(child_items)

        row = np.zeros(LANE, np.float32)
        for k, (lo, hi) in enumerate(boxes):
            row[REC * k + 0: REC * k + 3] = lo
            row[REC * k + 3: REC * k + 6] = hi
            row[REC * k + 6: REC * k + 8] = np.array(
                [child_pos[k], child_leaf[k]], np.int32).view(np.float32)
        for k in range(len(boxes), WIDTH):
            row[REC * k + 0: REC * k + 6] = np.nan  # empty slot: never hit
        row[IS_LEAF_LANE:SKIP_LANE + 1] = np.array([0, len(rows)], np.int32).view(np.float32)
        rows[pos] = row
        return pos

    if count[0] > 0:
        root_items = make_children([("l", int(left_first[0]), int(count[0]))])
    else:
        l = int(left_first[0])
        root_items = make_children([("n", l), ("n", l + 1)])
    emit_node(root_items)

    n_entries = len(rows)
    # Pad to a multiple of 8 rows with inert leaf rows, at least one.
    while len(rows) % 8 or len(rows) == n_entries:
        row = np.zeros(LANE, np.float32)
        row[IS_LEAF_LANE:SKIP_LANE + 1] = np.array(
            [1, len(rows) + 1], np.int32).view(np.float32)
        rows.append(row)
        recs.append(np.full(LEAF_TRIS, -1, np.int32))

    stream = np.stack(rows).astype(np.float32)
    rec_slot = np.concatenate(recs).astype(np.int32)
    _fill_leaf_rows(stream, rec_slot, tv0, tv1, tv2)
    slot = np.zeros((3, len(rows), WIDTH), np.int32)
    for r, k, *kab in provenance:
        slot[:, r, k] = kab
    return WideStream(stream, rec_slot, n_entries, slot[0].astype(np.int8), slot[1], slot[2])


def pad_wide_stream(ws: WideStream, target_rows: int) -> WideStream:
    """Pad a built stream to ``target_rows`` rows with inert node rows
    (``surf_tpu/accel/wide.py:479-517``): every slot box is NaN and the
    skip link jumps to ``target_rows``, so a walk that reaches the pad pays
    one visit and exits.  Their slots are empty (kind 0)."""
    e0 = ws.stream.shape[0]
    if target_rows <= e0:
        return ws
    add = target_rows - e0
    rows = np.full((add, LANE), np.nan, np.float32)
    rows[:, IS_LEAF_LANE:SKIP_LANE + 1] = np.array([0, target_rows], np.int32).view(np.float32)
    slots = {name: np.concatenate([getattr(ws, name), np.zeros((add, WIDTH), getattr(ws, name).dtype)])
             for name in ("slot_kind", "slot_a", "slot_b")}
    return ws._replace(
        stream=np.concatenate([ws.stream, rows]),
        rec_slot=np.concatenate([ws.rec_slot, np.full(add * LEAF_TRIS, -1, np.int32)]),
        **slots)


def refit_wide_stream(ws: WideStream, bvh: BVH, tri_v0, tri_v1, tri_v2) -> WideStream:
    """Topology-preserving refit of a stream after vertex motion
    (``surf_tpu/accel/wide.py:520-563``, without the own boxes): the leaf
    rows' triangles and the node rows' slot boxes are rewritten from the
    refit ``bvh`` (same topology as at build) and the leaf-ordered
    vertices."""
    tv0 = np.asarray(tri_v0, np.float32)
    tv1 = np.asarray(tri_v1, np.float32)
    tv2 = np.asarray(tri_v2, np.float32)
    stream = ws.stream.copy()
    _fill_leaf_rows(stream, ws.rec_slot, tv0, tv1, tv2)

    tlo, thi = triangle_bounds(tv0, tv1, tv2)
    rn, kn = np.nonzero(ws.slot_kind == 1)
    if len(rn):
        ids = ws.slot_a[rn, kn]
        for c in range(3):
            stream[rn, REC * kn + 0 + c] = bvh.node_lo[ids, c]
            stream[rn, REC * kn + 3 + c] = bvh.node_hi[ids, c]
    rl, kl = np.nonzero(ws.slot_kind == 2)
    if len(rl):
        first = ws.slot_a[rl, kl]
        cnt = ws.slot_b[rl, kl]
        # ranges are contiguous and at most LEAF_TRIS long: an unrolled
        # min / max in JAX's order
        lo = tlo[first].copy()
        hi = thi[first].copy()
        for j in range(1, int(cnt.max())):
            m = cnt > j
            lo[m] = np.minimum(lo[m], tlo[first[m] + j])
            hi[m] = np.maximum(hi[m], thi[first[m] + j])
        for c in range(3):
            stream[rl, REC * kl + 0 + c] = lo[:, c]
            stream[rl, REC * kl + 3 + c] = hi[:, c]
    return ws._replace(stream=stream)


def stream_depth(stream: np.ndarray) -> int:
    """The node-tree depth of a stream, read from its child pointers (the
    root row 0 is depth 1; rows are in DFS preorder, so a parent precedes
    its children).  ``from_render_scene`` takes the depth from here for
    the port's arrays and the JAX package's alike (its ``RenderScene``
    does not carry the depth)."""
    meta = stream[:, IS_LEAF_LANE].view(np.int32)
    ptr = stream.view(np.int32).reshape(len(stream), WIDTH, REC)[:, :, 6:8]
    boxes = stream.reshape(len(stream), WIDTH, REC)[:, :, 0]
    depth = np.zeros(len(stream), np.int64)
    depth[0] = 1
    for r in np.nonzero(meta == 0)[0]:
        if depth[r] == 0:
            continue  # a pad row, reached from no node
        kids = ptr[r][~np.isnan(boxes[r]) & (ptr[r][:, 1] == 0)][:, 0]
        depth[kids] = depth[r] + 1
    return int(depth.max())

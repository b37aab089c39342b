"""The binary BVH as a skip-link node list, and the 16-lane record tables
the binary packet walk reads (the port's copies of ``build_skiplinks``,
``pack_records_np``, ``pack_trace_tables``, ``skiplink_boxes`` and
``bvh_max_depth`` from ``surf_tpu/accel/traverse.py:92-205``).

Nodes are in DFS preorder, left child first; ``meta[:, 0]`` is a leaf's
first triangle slot, ``meta[:, 1]`` its triangle count (0 for an internal
node) and ``meta[:, 2]`` the skip link, the position after the node's
subtree.  A record is 16 lanes (float32 fields, then int32 fields as their
bits), 8 records to a 128-lane row.
"""

from __future__ import annotations

import numpy as np

from .builder import BVH


def pack_records_np(f32_cols, i32_cols) -> np.ndarray:
    """Pack columns into 16-lane records, 8 per row, rows padded to a
    multiple of 8: [ceil(n / 8) rounded up to 8, 128] f32."""
    n = len(f32_cols[0])
    cols = [np.asarray(c, np.float32) for c in f32_cols] + [
        np.asarray(c, np.int32).view(np.float32) for c in i32_cols]
    if len(cols) > 16:
        raise ValueError(f"a record holds 16 lanes, not {len(cols)}")
    rows = (n + 7) // 8
    rows_pad = rows + ((-rows) % 8)
    flat = np.zeros((rows_pad * 8, 16), np.float32)
    for j, c in enumerate(cols):
        flat[:n, j] = c
    return flat.reshape(rows_pad, 128)


def pack_trace_tables(tri_v0, tri_v1, tri_v2, boxes, meta):
    """(nodes_packed, tris_packed): node records (box lo, box hi, then
    leaf_first, leaf_count, skip as int32) and triangle records (v0, e1 =
    v1 - v0, e2 = v2 - v0) of leaf-ordered triangles."""
    nodes_packed = pack_records_np([boxes[:, i] for i in range(6)],
                                   [meta[:, i] for i in range(3)])
    e1 = np.asarray(tri_v1, np.float32) - tri_v0
    e2 = np.asarray(tri_v2, np.float32) - tri_v0
    tris_packed = pack_records_np(
        [tri_v0[:, 0], tri_v0[:, 1], tri_v0[:, 2],
         e1[:, 0], e1[:, 1], e1[:, 2], e2[:, 0], e2[:, 1], e2[:, 2]], [])
    return nodes_packed, tris_packed


def skiplink_boxes(bvh: BVH, order: np.ndarray) -> np.ndarray:
    """The node boxes of a refit tree re-gathered in a cached DFS preorder
    (a refit moves box values only; the skip links stay)."""
    return np.concatenate([bvh.node_lo[order], bvh.node_hi[order]],
                          axis=1).astype(np.float32)


def build_skiplinks(bvh: BVH, return_order: bool = False) -> tuple[np.ndarray, ...]:
    """DFS-preorder node arrays with skip links: (boxes [D, 6] f32, meta
    [D, 3] int32) over the D nodes reachable from the root, and with
    ``return_order`` the node ids in preorder, for ``skiplink_boxes``."""
    walk = [0]
    order = []
    while walk:
        node = walk.pop()
        order.append(node)
        if bvh.count[node] == 0:
            left = int(bvh.left_first[node])
            walk.append(left + 1)  # pushed first -> visited after left
            walk.append(left)

    size = np.zeros(bvh.nodes_used, np.int64)  # subtree sizes, bottom-up
    for node in reversed(order):
        if bvh.count[node] != 0:
            size[node] = 1
        else:
            left = int(bvh.left_first[node])
            size[node] = 1 + size[left] + size[left + 1]

    d = len(order)
    boxes = np.empty((d, 6), np.float32)
    meta = np.empty((d, 3), np.int32)
    for i, node in enumerate(order):
        boxes[i, 0:3] = bvh.node_lo[node]
        boxes[i, 3:6] = bvh.node_hi[node]
        leaf = bvh.count[node] != 0
        meta[i, 0] = bvh.left_first[node] if leaf else 0
        meta[i, 1] = bvh.count[node] if leaf else 0
        meta[i, 2] = i + size[node]
    if return_order:
        return boxes, meta, np.asarray(order, np.int64)
    return boxes, meta


def bvh_max_depth(bvh: BVH) -> int:
    """The binary tree's depth (the root is depth 1)."""
    depth = 0
    stack = [(0, 1)]
    while stack:
        node, dd = stack.pop()
        depth = max(depth, dd)
        if bvh.count[node] == 0:
            left = int(bvh.left_first[node])
            stack.append((left, dd + 1))
            stack.append((left + 1, dd + 1))
    return depth

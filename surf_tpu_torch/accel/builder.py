"""Binned-SAH BVH construction: native C++ builder + NumPy builder.

The port's copy of ``surf_tpu.accel.builder``.  Algorithm replicated from the reference (bvh.cpp):
- 8 bins, 7 candidate planes per axis over the binning-key extent
  (bvh.cpp:294-377); leaf when best plane cost >= parent cost;
- node pool of 2N with node 1 unused, children allocated in adjacent pairs
  (left = leftFirst, right = leftFirst + 1, bvh.h:36-46);
- BLAS keys are triangle centroids ((v0+v1+v2)*0.333f); TLAS keys replicate
  the AABB::center() quirk that returns the half-extent 0.5*(max-min)
  (bvh.cpp:35-38);
- refit = leaf-up AABB recompute without topology change (bvh.cpp:268-287).

The NumPy builder (``SURF_NO_NATIVE=1``, see native.py) uses a stable
partition instead of the reference's two-pointer swap partition (same
left/right membership, different order within each side), which changes
nothing observable except the order in which leaf primitives are tested.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import native


class BVH(NamedTuple):
    """Flattened SoA node pool + primitive permutation (host arrays)."""

    indices: np.ndarray     # [n] uint32 — permutation of primitive ids
    node_lo: np.ndarray     # [2n, 3] float32
    node_hi: np.ndarray     # [2n, 3] float32
    left_first: np.ndarray  # [2n] uint32 — child pair base (internal) / first prim slot (leaf)
    count: np.ndarray       # [2n] uint32 — 0 for internal nodes
    nodes_used: int


BIN_COUNT = 8
PLANE_COUNT = BIN_COUNT - 1


def _numpy_build(prim_lo, prim_hi, key, min_leaf: int = 1) -> BVH:
    n = len(prim_lo)
    prim_lo = np.asarray(prim_lo, np.float32)
    prim_hi = np.asarray(prim_hi, np.float32)
    key = np.asarray(key, np.float32)

    indices = np.arange(n, dtype=np.uint32)
    node_lo = np.zeros((2 * n, 3), np.float32)
    node_hi = np.zeros((2 * n, 3), np.float32)
    left_first = np.zeros(2 * n, np.uint32)
    count = np.zeros(2 * n, np.uint32)

    def box_area(lo, hi):
        e = (hi - lo).astype(np.float32)
        return np.float32(e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0])

    def update_bounds(node):
        ids = indices[left_first[node]: left_first[node] + count[node]]
        node_lo[node] = prim_lo[ids].min(axis=0)
        node_hi[node] = prim_hi[ids].max(axis=0)

    left_first[0] = 0
    count[0] = n
    update_bounds(0)

    nodes_used = 2
    stack = [0]
    with np.errstate(invalid="ignore", over="ignore"):
        while stack:
            node = stack.pop()
            if count[node] <= min_leaf:
                continue
            ids = indices[left_first[node]: left_first[node] + count[node]]
            k = key[ids]
            boxes_lo, boxes_hi = prim_lo[ids], prim_hi[ids]

            best_cost = np.float32(np.inf)
            best_axis, best_split = 0, np.float32(0.0)
            for axis in range(3):
                lo = np.float32(k[:, axis].min())
                # FLT_MIN init quirk (bvh.cpp:303): max clamped >= ~1.18e-38
                hi = np.float32(max(k[:, axis].max(), np.finfo(np.float32).tiny))
                if lo == hi:
                    continue
                bin_scale = np.float32(BIN_COUNT) / (hi - lo)
                sections = ((k[:, axis] - lo) * bin_scale).astype(np.int64)
                bins = np.minimum(BIN_COUNT - 1, sections)

                bin_n = np.bincount(bins, minlength=BIN_COUNT).astype(np.uint32)
                bin_lo = np.full((BIN_COUNT, 3), np.inf, np.float32)
                bin_hi = np.full((BIN_COUNT, 3), -np.inf, np.float32)
                np.minimum.at(bin_lo, bins, boxes_lo)
                np.maximum.at(bin_hi, bins, boxes_hi)

                l_cnt = np.cumsum(bin_n[:PLANE_COUNT]).astype(np.float32)
                r_cnt = np.cumsum(bin_n[:0:-1])[::-1].astype(np.float32)
                l_lo = np.minimum.accumulate(bin_lo[:PLANE_COUNT])
                l_hi = np.maximum.accumulate(bin_hi[:PLANE_COUNT])
                r_lo = np.minimum.accumulate(bin_lo[:0:-1])[::-1]
                r_hi = np.maximum.accumulate(bin_hi[:0:-1])[::-1]
                costs = l_cnt * box_area(l_lo, l_hi) + r_cnt * box_area(r_lo, r_hi)

                for plane in range(PLANE_COUNT):
                    c = np.float32(costs[plane])
                    if c < best_cost:
                        best_cost = c
                        bin_extent = (hi - lo) / np.float32(BIN_COUNT)
                        best_split = lo + bin_extent * np.float32(plane + 1)
                        best_axis = axis

            parent_cost = np.float32(count[node]) * box_area(node_lo[node], node_hi[node])
            if best_cost >= parent_cost:
                continue

            mask = k[:, best_axis] < best_split
            lcount = int(mask.sum())
            if lcount == 0 or lcount == len(ids):
                continue

            # Stable partition (membership identical to the reference's
            # two-pointer partition; intra-side order differs — see module doc).
            indices[left_first[node]: left_first[node] + count[node]] = np.concatenate(
                [ids[mask], ids[~mask]]
            )

            li, ri = nodes_used, nodes_used + 1
            nodes_used += 2
            left_first[li] = left_first[node]
            count[li] = lcount
            left_first[ri] = left_first[node] + lcount
            count[ri] = count[node] - lcount
            left_first[node] = li
            count[node] = 0
            update_bounds(li)
            update_bounds(ri)
            stack.append(ri)
            stack.append(li)

    return BVH(indices, node_lo, node_hi, left_first, count, nodes_used)


def build_bvh(prim_lo, prim_hi, key, min_leaf: int = 1) -> BVH:
    """Build over per-primitive AABBs with per-primitive binning keys.

    ``min_leaf`` stops subdivision at/below that primitive count (the
    reference's pure-SAH termination yields ~1.1-tri leaves; packet
    traversal prefers shallower trees)."""
    if native.enabled():
        return BVH(*native.native_build(prim_lo, prim_hi, key, min_leaf))
    return _numpy_build(prim_lo, prim_hi, key, min_leaf)


def enforce_max_leaf(bvh: BVH, prim_lo, prim_hi, key, max_leaf: int) -> BVH:
    """Post-pass: split any leaf holding more than ``max_leaf`` primitives
    (median split along the largest-extent axis of the binning key).

    The SAH builder's parent-cost termination can produce arbitrarily fat
    leaves (clustered centroids); the leaf table stores at most 8 triangles
    of a leaf per row, so the render BVH bounds leaf size here.  Node pool
    capacity 2n is sufficient for any full binary tree."""
    prim_lo = np.asarray(prim_lo, np.float32)
    prim_hi = np.asarray(prim_hi, np.float32)
    key = np.asarray(key, np.float32)
    indices = bvh.indices.copy()
    node_lo = bvh.node_lo.copy()
    node_hi = bvh.node_hi.copy()
    left_first = bvh.left_first.copy()
    count = bvh.count.copy()
    nodes_used = bvh.nodes_used

    stack = [i for i in range(nodes_used)
             if i != 1 and count[i] > max_leaf]
    while stack:
        node = stack.pop()
        first = int(left_first[node])
        cnt = int(count[node])
        ids = indices[first: first + cnt]
        k = key[ids]
        axis = int(np.argmax(k.max(axis=0) - k.min(axis=0)))
        order = np.argsort(k[:, axis], kind="stable")
        indices[first: first + cnt] = ids[order]
        half = cnt // 2

        li, ri = nodes_used, nodes_used + 1
        nodes_used += 2
        left_first[li] = first
        count[li] = half
        left_first[ri] = first + half
        count[ri] = cnt - half
        left_first[node] = li
        count[node] = 0
        for c in (li, ri):
            cids = indices[left_first[c]: left_first[c] + count[c]]
            node_lo[c] = prim_lo[cids].min(axis=0)
            node_hi[c] = prim_hi[cids].max(axis=0)
            if count[c] > max_leaf:
                stack.append(c)

    return BVH(indices, node_lo, node_hi, left_first, count, nodes_used)


def triangle_bounds(v0, v1, v2):
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    return lo, hi


def build_blas(v0, v1, v2, min_leaf: int = 1,
               max_leaf: int | None = None) -> BVH:
    """BLAS over a triangle soup; bins by the 0.333f centroid (mesh.cpp:20).

    ``max_leaf`` (optional) bounds leaf size via enforce_max_leaf."""
    lo, hi = triangle_bounds(v0, v1, v2)
    centroid = ((np.asarray(v0, np.float32) + v1 + v2) * np.float32(0.333)).astype(np.float32)
    bvh = build_bvh(lo, hi, centroid, min_leaf)
    if max_leaf is not None and bvh.count.max() > max_leaf:
        bvh = enforce_max_leaf(bvh, lo, hi, centroid, max_leaf)
    return bvh


def build_tlas(inst_lo, inst_hi) -> BVH:
    """TLAS over instance AABBs; bins by the AABB::center() half-extent
    quirk 0.5*(max-min) (bvh.cpp:35-38, 842-860)."""
    inst_lo = np.asarray(inst_lo, np.float32)
    inst_hi = np.asarray(inst_hi, np.float32)
    key = (np.float32(0.5) * (inst_hi - inst_lo)).astype(np.float32)
    return build_bvh(inst_lo, inst_hi, key)


def refit(bvh: BVH, prim_lo, prim_hi) -> BVH:
    """Leaf-up AABB recompute over unchanged topology (bvh.cpp:268-287):
    native, or in NumPy with ``SURF_NO_NATIVE=1``."""
    node_lo = np.ascontiguousarray(bvh.node_lo.copy())
    node_hi = np.ascontiguousarray(bvh.node_hi.copy())
    if native.enabled():
        native.native_refit(prim_lo, prim_hi, bvh.indices, node_lo, node_hi,
                            bvh.left_first, bvh.count, bvh.nodes_used)
        return bvh._replace(node_lo=node_lo, node_hi=node_hi)
    prim_lo = np.asarray(prim_lo, np.float32)
    prim_hi = np.asarray(prim_hi, np.float32)
    for i in range(bvh.nodes_used - 1, -1, -1):
        if i == 1:
            continue
        if bvh.count[i] != 0:
            ids = bvh.indices[bvh.left_first[i]: bvh.left_first[i] + bvh.count[i]]
            node_lo[i] = prim_lo[ids].min(axis=0)
            node_hi[i] = prim_hi[ids].max(axis=0)
        else:
            l, r = bvh.left_first[i], bvh.left_first[i] + 1
            node_lo[i] = np.minimum(node_lo[l], node_lo[r])
            node_hi[i] = np.maximum(node_hi[l], node_hi[r])
    return bvh._replace(node_lo=node_lo, node_hi=node_hi)

"""The binary-BVH packet walk (``use_wide=False``): the port of
``pallas_traverse.traverse_pallas`` and its kernel
``_traverse_kernel_multiblock`` / ``_walk_block``
(``surf_tpu/accel/pallas_traverse.py:72-309``).

Rays go in fixed packets of BLOCK = 1024.  Each packet walks the
skip-link node list (``accel/skiplinks.py``) with one cursor: at node
``dfs`` every live ray slab-tests the node's box (C-style min/max, ``a < b
? a : b``, which is neither IEEE rule: a NaN from 0 * inf is absorbed or
kept by operand order, exactly as the TPU kernel does); if any live ray
hits a leaf node, every ray tests the leaf's ``min(count, 256)`` triangles
in order, keeping the strictly closest hit (with ``any_hit`` a ray stops
at its first hit).  The cursor goes to ``dfs + 1`` on a hit internal node,
else to the skip link, and never backwards.  With ``any_hit`` a packet
stops once every active ray has a hit.  Directions are not nudged: 1/0 is
+-inf, as on the TPU.  The TPU's 64K-ray VMEM chunks are gone: one launch
covers every packet.

``bvh_walk`` launches the hand-written kernel of ``csrc/bvh_walk_live.cu``
on CUDA tensors (live-ray compaction, both successors and a leaf's
triangles staged while a step runs, one vote a step) and runs
``bvh_walk_plain`` on CPU tensors.  ``bvh_walk_pr3`` launches the first
design (``csrc/bvh_walk.cu``) on the same function, to time the two side
by side; no render path reaches it.

Inputs (all on one device):
  nodes   [Rn, 128] f32   node records (box lo, hi; leaf_first,
                          leaf_count, skip as int32), 8 per row
  tris    [Rt, 128] f32   triangle records (v0, e1, e2), 8 per row
  n_nodes                 the walk's end (the padded node count)
  rays    [7, g * 1024] f32  ox, oy, oz, dx, dy, dz, t_max
  act     [g * 1024] int32
Returns (t, prim, u, v, counts): per ray the best t (t_max on a miss), the
leaf-order triangle slot (-1 on a miss) and barycentrics; per packet
[g, 2] int32 the nodes visited and the triangle records tested.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .bits import Hit
from .leaf_rows import REC
from .stream import pack_rays
from .stream_walk import nearest_records

BLOCK = 1024
MAX_LEAF = 256   # triangles tested per leaf at most (pallas_traverse.py:173-175)

# The entry points of bvh_walk_live.cu, and the first design's of
# bvh_walk.cu (reached only by bvh_walk_pr3).
ENTRY_POINTS = ("bvh_walk_closest", "bvh_walk_any")
FIRST_DESIGNS = {"bvh_walk_closest": "bvh_walk_closest_pr3", "bvh_walk_any": "bvh_walk_any_pr3"}
# Kernel launches since the last reset, per entry point.
LAUNCHES = dict.fromkeys((*ENTRY_POINTS, *FIRST_DESIGNS.values()), 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class BinaryTrace(NamedTuple):
    """The skip-link node list and triangles as packed records."""

    nodes: torch.Tensor  # [Rn, 128] f32 nodes_packed
    tris: torch.Tensor   # [Rt, 128] f32 tris_packed
    n_nodes: int         # node count with capacity padding (node_boxes rows)


def _check(nodes, tris, n_nodes, rays, act):
    for name, x in (("nodes", nodes), ("tris", tris)):
        if x.dim() != 2 or x.shape[1] != 128 or x.dtype != torch.float32:
            raise ValueError(f"{name} must be [rows, 128] float32, got {tuple(x.shape)} "
                             f"{x.dtype}")
    if not 0 < n_nodes <= nodes.shape[0] * 8:
        raise ValueError(f"n_nodes={n_nodes} does not fit {nodes.shape[0] * 8} records")
    n = rays.shape[1] if rays.dim() == 2 else -1
    if rays.shape != (7, n) or rays.dtype != torch.float32 or n % BLOCK or n == 0:
        raise ValueError(f"rays must be [7, k * {BLOCK}] float32 with k > 0, got "
                         f"{tuple(rays.shape)} {rays.dtype}")
    if act.shape != (n,) or act.dtype != torch.int32:
        raise ValueError(f"act must be [{n}] int32, got {tuple(act.shape)} {act.dtype}")
    devices = {x.device for x in (nodes, tris, rays, act)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def bvh_walk(nodes: torch.Tensor, tris: torch.Tensor, n_nodes: int, rays: torch.Tensor,
             act: torch.Tensor, any_hit: bool = False):
    """The binary packet walk of every ray: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    _check(nodes, tris, n_nodes, rays, act)
    if nodes.device.type == "cpu":
        return bvh_walk_plain(nodes, tris, n_nodes, rays, act, any_hit)
    return _launch(ENTRY_POINTS[int(any_hit)], nodes, tris, n_nodes, rays, act)


def bvh_walk_pr3(nodes: torch.Tensor, tris: torch.Tensor, n_nodes: int, rays: torch.Tensor,
                 act: torch.Tensor, any_hit: bool = False):
    """``bvh_walk`` through the first design's kernel (``FIRST_DESIGNS``: a
    512-thread block a packet, every lane, the node record loaded after
    each vote).  The same function; the plain version for CPU tensors."""
    _check(nodes, tris, n_nodes, rays, act)
    if nodes.device.type == "cpu":
        return bvh_walk_plain(nodes, tris, n_nodes, rays, act, any_hit)
    return _launch(FIRST_DESIGNS[ENTRY_POINTS[int(any_hit)]], nodes, tris, n_nodes, rays, act)


def _launch(name, nodes, tris, n_nodes, rays, act):
    """Launch entry point ``name`` on CUDA tensors (checked by ``_check``),
    or raise."""
    device = nodes.device
    if device.type != "cuda":
        raise ValueError(f"bvh_walk runs on cpu or cuda, not {device}")
    lib = _build.library()
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"{device} is not the current CUDA device")
    for label, x in (("nodes", nodes), ("tris", tris), ("rays", rays), ("act", act)):
        if not x.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if nodes.data_ptr() % 16 or tris.data_ptr() % 16:
        raise ValueError("nodes and tris must be 16-byte aligned (records are read as float4)")
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=device)
    p = torch.empty(n, dtype=torch.int32, device=device)
    u = torch.empty(n, dtype=torch.float32, device=device)
    v = torch.empty(n, dtype=torch.float32, device=device)
    counts = torch.empty(n // BLOCK, 2, dtype=torch.int32, device=device)
    cuda_stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(
        nodes.data_ptr(), n_nodes, tris.data_ptr(), rays.data_ptr(), act.data_ptr(), n,
        t.data_ptr(), p.data_ptr(), u.data_ptr(), v.data_ptr(), counts.data_ptr(),
        ctypes.c_void_p(cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return t, p, u, v, counts


def _c_min(a, b):
    return torch.where(a < b, a, b)


def _c_max(a, b):
    return torch.where(a > b, a, b)


def bvh_walk_plain(nodes: torch.Tensor, tris: torch.Tensor, n_nodes: int,
                   rays: torch.Tensor, act: torch.Tensor, any_hit: bool = False,
                   work: torch.Tensor | None = None):
    """Plain PyTorch version of the kernels: every packet walks in
    lockstep with its own cursor; the loop condition is read on the host
    once per visit.  Where ``work`` ([g, 2] int64) is given, adds to it per
    packet the tests the function needs: ray x box slab tests and ray x
    triangle tests of the live rays (active, and for any-hit without a hit
    yet)."""
    g = rays.shape[1] // BLOCK
    dev = nodes.device
    o = rays[0:3].reshape(3, g, BLOCK)
    d = rays[3:6].reshape(3, g, BLOCK)
    inv = 1.0 / d
    o3 = tuple(x[..., None] for x in o)
    d3 = tuple(x[..., None] for x in d)
    act = act.reshape(g, BLOCK) != 0
    best = (rays[6].reshape(g, BLOCK).clone(),
            torch.full((g, BLOCK), -1, dtype=torch.int32, device=dev),
            torch.zeros((g, BLOCK), device=dev), torch.zeros((g, BLOCK), device=dev))
    counts = torch.zeros(g, 2, dtype=torch.int32, device=dev)
    recs = nodes.reshape(-1, REC)[:n_nodes]
    recs_i = recs.view(torch.int32)
    tri_recs = tris.reshape(-1, REC)
    ks = torch.arange(max(min(int(recs_i[:, 7].max()), MAX_LEAF), 1), device=dev)
    dfs = torch.where(act.any(1), 0, n_nodes)
    while True:
        valid = dfs < n_nodes
        if not bool(valid.any()):
            break
        node = torch.where(valid, dfs, 0)
        rec = recs[node]
        leaf_first, leaf_count, skip = recs_i[node, 6], recs_i[node, 7], recs_i[node, 8]
        live = act & (best[1] < 0) if any_hit else act
        tmin = tmax = None
        for c in range(3):
            tn = (rec[:, c, None] - o[c]) * inv[c]
            tf = (rec[:, 3 + c, None] - o[c]) * inv[c]
            lo, hi = _c_min(tn, tf), _c_max(tn, tf)
            tmin = lo if tmin is None else _c_max(tmin, lo)
            tmax = hi if tmax is None else _c_min(tmax, hi)
        box_hit = (tmax >= tmin) & (tmin < best[0]) & (tmax > 0.0) & live
        packet_hit = box_hit.any(1) & valid
        is_leaf = leaf_count > 0
        n_tris = torch.where(packet_hit & is_leaf, leaf_count.clamp(0, MAX_LEAF), 0)
        if bool((n_tris > 0).any()):
            ids = (leaf_first[:, None] + ks).clamp(max=tri_recs.shape[0] - 1)
            best = nearest_records(tri_recs[ids], leaf_first, live, o3, d3, best, any_hit,
                                   ks < n_tris[:, None])
        new = torch.where(packet_hit & ~is_leaf, dfs + 1, skip)
        new = torch.where(valid, torch.maximum(new, dfs + 1), dfs)
        if any_hit:
            new = torch.where((act & (best[1] < 0)).any(1), new, n_nodes)
        counts[:, 0] += valid
        counts[:, 1] += n_tris.to(torch.int32)
        if work is not None:
            n_live = live.sum(1)
            work[:, 0] += n_live * valid
            work[:, 1] += n_live * n_tris
        dfs = new
    return (*(x.reshape(-1) for x in best), counts)


def traverse_binary(trace: BinaryTrace, origin: torch.Tensor, direction: torch.Tensor,
                    t_max: torch.Tensor, active: torch.Tensor,
                    any_hit: bool = False) -> Hit:
    """Closest-hit (or any-hit) traversal of [N] rays with the binary packet
    walk; ``prim`` is the leaf-order triangle slot, -1 for a miss or an
    inactive ray."""
    n = origin.shape[0]
    rays, act = pack_rays(origin, direction, t_max, active, BLOCK)
    t, p, u, v, _ = bvh_walk(trace.nodes, trace.tris, trace.n_nodes, rays, act, any_hit)
    return Hit(prim=torch.where(active, p[:n], -1), t=t[:n], u=u[:n], v=v[:n])

"""Pure two-level instanced traversal: TLAS -> instance -> shared
object-space BLAS (port of ``surf_tpu.accel.pallas_instanced``).

The reference's instancing shape (bvh.cpp:481-513): every unique mesh has
one leaf table in object space, and an instance is its mesh plus a
transform, so device memory is O(unique mesh triangles), not O(instance
triangles).  Rays are padded into packets of ``block_rays``; then:

- phase 0: every packet's rays against every instance's world AABB (the
  TLAS at packet granularity);
- phase 1, per unique mesh, over the (packet, instance) pairs that passed
  phase 0 and hold a live ray: the packet's rays are taken into the
  instance's object space, slab-tested against the mesh's boxes at each
  ray's own t_max, ANDed down the mesh's 8-ary levels, and the visible leaf
  rows form the pair's exact, ascending list of global row ids (cumsum +
  one scatter, as accel/bits.py does).  A pair with more rows than its cap
  gets a negative count instead, and the kernel sweeps that instance's
  whole mesh: rows keep leaf order either way, so the winner is the same;
- phase 2: ``accel.inst_rows`` intersects each ray with its packet's
  instance segments.

Phases 0 and 1 are torch ops, chunked so no [pairs, boxes, rays]
intermediate exceeds ``PHASE1_ELEMS`` floats.  Inactive rays carry
t_max = -1e30, which fails every box and triangle test.  Unlike the TPU
build, the sum of the caps is not clamped to a VMEM budget and a mesh may
have any number of rows (the TPU's bf16 one-hot list contraction was exact
only below 16384 rows).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.vecmath import F32_FAR_AWAY
from .bits import _leaf_vis, _packet_bits, nudge
from .builder import build_blas
from .inst_rows import inst_rows, object_rays
from .wide import LEAF_TRIS, build_leaf_table

BLOCK = 2048
CAP_PER_INST = 512   # candidate rows per (packet, instance); more -> sweep
PHASE1_ELEMS = 1 << 26


class InstancedMeta(NamedTuple):
    """Static layout of the concatenated tables (plain Python values)."""

    mesh_of: tuple     # per instance: mesh index
    row_off: tuple     # per mesh: first leaf row in ltab
    n_rows: tuple      # per mesh: real leaf rows L_m
    box_off: tuple     # per mesh: first column of its boxes in box_lo/box_hi
    sizes: tuple       # per mesh: 8-ary level sizes (L_m, ceil/8, ..., 1)
    caps: tuple        # per instance: candidate-list capacity (rows)
    inert_row: int     # an all-zero row of ltab (list padding)


class InstancedTrace(NamedTuple):
    """The two-level tables on one device."""

    ltab: torch.Tensor     # [rows_tot, 128] f32 per-mesh leaf tables
    box_lo: torch.Tensor   # [3, E_tot] f32 per-mesh box chains (SoA)
    box_hi: torch.Tensor   # [3, E_tot]
    inv: torch.Tensor      # [I, 12] f32 inverse 3x4 per instance (A | b)
    inst_lo: torch.Tensor  # [3, I] f32 instance world AABBs
    inst_hi: torch.Tensor  # [3, I]
    segs: torch.Tensor     # [3, I] int32: list segment offset, mesh first
                           # row, mesh rows rounded up to 8 (inst_rows.py)
    caps: torch.Tensor     # [I] int32 meta.caps
    mesh_insts: tuple      # per mesh: [k] int64 ids of its instances
    meta: InstancedMeta


class InstancedHost(NamedTuple):
    """The device tables plus the per-mesh leaf orders the prim mapping
    reads."""

    trace: InstancedTrace
    perms: list            # per mesh: leaf-order slot -> mesh tri id


class InstHit(NamedTuple):
    inst: torch.Tensor  # [N] int32 instance id, -1 on a miss
    prim: torch.Tensor  # [N] int32 mesh-local leaf-order slot, -1 on a miss
    t: torch.Tensor     # [N] f32
    u: torch.Tensor
    v: torch.Tensor


def segment_table(meta: InstancedMeta, device: torch.device) -> torch.Tensor:
    """[3, I] int32: each instance's list segment offset, its mesh's first
    table row, and the mesh's row count rounded up to 8."""
    seg_off = np.concatenate([[0], np.cumsum(meta.caps)[:-1]])
    row0 = [meta.row_off[m] for m in meta.mesh_of]
    rows8 = [-(-meta.n_rows[m] // 8) * 8 for m in meta.mesh_of]
    return torch.tensor(np.array([seg_off, row0, rows8], np.int32),
                        device=device)


def make_trace(ltab, box_lo, box_hi, inv, inst_lo, inst_hi,
               meta: InstancedMeta, device: torch.device) -> InstancedTrace:
    """InstancedTrace on ``device`` from host arrays (box_lo/box_hi
    [3, E_tot], inst_lo/inst_hi [3, I], inv [I, 12])."""
    def put(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    mesh_of = np.asarray(meta.mesh_of)
    return InstancedTrace(
        ltab=put(ltab), box_lo=put(box_lo), box_hi=put(box_hi), inv=put(inv),
        inst_lo=put(inst_lo), inst_hi=put(inst_hi),
        segs=segment_table(meta, device),
        caps=torch.tensor(meta.caps, dtype=torch.int32, device=device),
        mesh_insts=tuple(torch.tensor(np.flatnonzero(mesh_of == m), device=device)
                         for m in range(len(meta.row_off))),
        meta=meta)


def build_instanced_trace(meshes, instances, device: torch.device,
                          cap_per_inst: int = CAP_PER_INST) -> InstancedHost:
    """meshes: list of (v0, v1, v2) object-space triangle SoA arrays.
    instances: list of (mesh_index, inverse transform 4x4, world_lo,
    world_hi), as ``scene.instance.Instance`` caches them
    (``inv_transform``, ``bounds_min``, ``bounds_max``).  ``cap_per_inst``
    bounds each (packet, instance) candidate list (a longer list becomes a
    sweep of the mesh)."""
    tabs, box_los, box_his = [], [], []
    row_off, n_rows, box_off, sizes_all = [], [], [], []
    perms = []
    rows_acc = 0
    box_acc = 0
    for (v0, v1, v2) in meshes:
        bvh = build_blas(np.asarray(v0, np.float32),
                         np.asarray(v1, np.float32),
                         np.asarray(v2, np.float32),
                         min_leaf=4, max_leaf=LEAF_TRIS)
        perm = bvh.indices.astype(np.int64)
        tv0 = np.asarray(v0, np.float32)[perm]
        tv1 = np.asarray(v1, np.float32)[perm]
        tv2 = np.asarray(v2, np.float32)[perm]
        lt = build_leaf_table(tv0, tv1, tv2)
        tabs.append(lt.table)
        box_los.append(lt.box_lo)
        box_his.append(lt.box_hi)
        row_off.append(rows_acc)
        n_rows.append(int(lt.n_rows))
        box_off.append(box_acc)
        szs = [int(lt.n_rows)]
        while szs[-1] > 1:
            szs.append(-(-szs[-1] // 8))
        sizes_all.append(tuple(szs))
        rows_acc += lt.table.shape[0]
        box_acc += lt.box_lo.shape[0]
        perms.append(perm.astype(np.int32))
    # every mesh's table ends with a full inert group (build_leaf_table);
    # the first mesh's last row pads every list
    inert_row = row_off[0] + tabs[0].shape[0] - 1

    mesh_of, inv3x4, ilo, ihi, caps = [], [], [], [], []
    for (mi, inv, wlo, whi) in instances:
        mesh_of.append(int(mi))
        inv3x4.append(np.asarray(inv, np.float32)[:3, :4].reshape(12))
        ilo.append(np.asarray(wlo, np.float32))
        ihi.append(np.asarray(whi, np.float32))
        caps.append(int(min(-(-n_rows[mi] // 8) * 8, cap_per_inst)))
    inv3x4 = np.stack(inv3x4)

    meta = InstancedMeta(
        mesh_of=tuple(mesh_of), row_off=tuple(row_off),
        n_rows=tuple(n_rows), box_off=tuple(box_off),
        sizes=tuple(sizes_all), caps=tuple(caps), inert_row=int(inert_row))
    trace = make_trace(np.concatenate(tabs), np.concatenate(box_los).T,
                       np.concatenate(box_his).T, inv3x4, np.stack(ilo).T,
                       np.stack(ihi).T, meta, device)
    return InstancedHost(trace=trace, perms=perms)


def prepare(trace: InstancedTrace, origin: torch.Tensor,
            direction: torch.Tensor, t_max: torch.Tensor,
            active: torch.Tensor, block_rays: int = BLOCK):
    """Phases 0 and 1: pad the rays into packets and build each (packet,
    instance) row list.  Returns the instanced kernel's inputs (rays
    [7, n_pad], lists [g, sum(caps)] int32, counts [g, I] int32: 0 to
    skip, -1 to sweep the mesh)."""
    meta = trace.meta
    n = origin.shape[0]
    pad = (-n) % block_rays
    g = (n + pad) // block_rays
    dev = origin.device
    tmf = torch.where(active, t_max.to(torch.float32), -F32_FAR_AWAY)
    rays = torch.cat([origin.T, nudge(direction).T, tmf[None]], dim=0)
    if pad:
        fill = torch.tensor([0, 0, 0, 1, 1, 1, -F32_FAR_AWAY],
                            dtype=torch.float32, device=dev)
        rays = torch.cat([rays, fill[:, None].expand(7, pad)], dim=1)
    rays = rays.contiguous()

    R = block_rays
    n_inst = len(meta.mesh_of)
    o3 = rays[0:3].reshape(3, g, R)
    d3 = rays[3:6].reshape(3, g, R)
    tm = rays[6].reshape(g, R)

    # phase 0: instance world AABBs, a chunk of packets at a time
    inv3 = 1.0 / d3
    step = max(1, PHASE1_ELEMS // (n_inst * R))
    ibits = torch.cat([
        _packet_bits(trace.inst_lo, trace.inst_hi, o3[:, s:s + step],
                     inv3[:, s:s + step], tm[s:s + step])
        for s in range(0, g, step)])
    pairs = ibits & (tm > -F32_FAR_AWAY).any(dim=1)[:, None]   # [g, I]

    # phase 1, one unique mesh at a time over its live pairs
    cap_tot = sum(meta.caps)
    seg_off = trace.segs[0]
    buf = torch.full((g * cap_tot + 1,), meta.inert_row, dtype=torch.int32,
                     device=dev)
    counts = torch.zeros((g, n_inst), dtype=torch.int32, device=dev)
    for m, insts in enumerate(trace.mesh_insts):
        pk, k = torch.nonzero(pairs[:, insts], as_tuple=True)
        if pk.shape[0] == 0:
            continue
        inst = insts[k]
        e0 = meta.box_off[m]
        e1 = e0 + sum(meta.sizes[m])
        lo, hi = trace.box_lo[:, e0:e1], trace.box_hi[:, e0:e1]
        chunk = max(1, PHASE1_ELEMS // ((e1 - e0) * R))
        vis = []
        for s in range(0, pk.shape[0], chunk):
            p_, i_ = pk[s:s + chunk], inst[s:s + chunk]
            oi, di = object_rays(trace.inv[i_], o3[:, p_], d3[:, p_])
            bits = _packet_bits(lo, hi, oi, 1.0 / nudge(di), tm[p_])
            vis.append(_leaf_vis(bits, list(meta.sizes[m])))
        vis = torch.cat(vis)                                  # [P, L_m]
        L = vis.shape[1]
        cnt = vis.sum(dim=1, dtype=torch.int32)
        key = vis.cumsum(dim=1, dtype=torch.int32) - 1
        cap = trace.caps[inst][:, None]
        dest = torch.where(vis & (key < cap),
                           pk[:, None] * cap_tot + seg_off[inst][:, None] + key,
                           g * cap_tot)
        row_id = meta.row_off[m] + torch.arange(L, device=dev, dtype=torch.int32)
        buf.scatter_(0, dest.reshape(-1), row_id.expand(pk.shape[0], L).reshape(-1))
        counts[pk, inst] = torch.where(cnt > cap[:, 0], -1, cnt).to(torch.int32)
    return rays, buf[:g * cap_tot].reshape(g, cap_tot), counts


def traverse_instanced(trace: InstancedTrace, origin: torch.Tensor,
                       direction: torch.Tensor, t_max: torch.Tensor,
                       active: torch.Tensor, any_hit: bool = False,
                       block_rays: int = BLOCK) -> InstHit:
    """Two-level closest-hit (or any-hit) traversal of [N] rays over the
    shared object-space tables.  ``prim`` is the mesh-local leaf-order slot
    (map it through the mesh's perm for the mesh triangle id); inst and
    prim are -1 for a miss or an inactive ray."""
    n = origin.shape[0]
    rays, lists, counts = prepare(trace, origin, direction, t_max, active,
                                  block_rays)
    t, r, u, v, i = inst_rows(trace.ltab, lists, counts, trace.segs,
                              trace.inv, rays, block_rays, any_hit)
    found = active & (r[:n] >= 0)
    return InstHit(inst=torch.where(found, i[:n], -1),
                   prim=torch.where(found, r[:n], -1),
                   t=t[:n], u=u[:n], v=v[:n])

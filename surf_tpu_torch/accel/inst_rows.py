"""Instanced leaf-row intersection: the port of
``pallas_instanced._inst_rows_kernel``.

``inst_rows`` runs, for every ray of a packet, one segment per instance in
ascending instance order: the ray is taken into the instance's object
space with its 12 inverse-transform scalars (each component
((A0*o0 + A1*o1) + A2*o2) + A3, the direction left unnormalised so t stays
the world parameter), then Möller–Trumbore runs over the segment's rows of
the shared mesh table, rows ascending and the 8 records of a row in order,
keeping the strictly closest hit with its instance id.  On a CUDA tensor it
launches ``inst_rows_live_kernel`` of ``csrc/inst_rows.cu``: only live rays
(t_max > 1e-5) are tested, the packet's rows (its segments one after the
other) are cut into chunks of ``split_rows(n)`` rows shared out among
``splits(...)`` work items a packet, and the work items merge through an
exact (t, position) key in ``leaf_rows.merge_scratch``.  On a CPU tensor it
runs ``inst_rows_plain``, the plain PyTorch version of the same function.
``inst_rows_first_design`` launches the first design's kernel
(``inst_rows_{closest,any}_pr2``: a thread a ray, every lane, a block
walking all of its packet's segments) to time it beside the live one; no
algo reaches it.

Inputs (all on one device):
  table   [rows_tot, 128] f32  every mesh's leaf table, concatenated
  lists   [g, cap_tot] int32   per packet, each instance's row ids (global,
                               ascending) in its segment of the row
  counts  [g, I] int32         rows listed per (packet, instance); 0 skips
                               the instance, < 0 sweeps its whole mesh
  segs    [3, I] int32         per instance: segment offset in a list row,
                               its mesh's first table row, and the mesh's
                               row count rounded up to 8 (the sweep)
  inv     [I, 12] f32          inverse 3x4 transforms, row-major (A | b)
  rays    [7, g * block_rays]  world ox, oy, oz, dx, dy, dz, t_max
Returns (t, slot, u, v, inst), each [g * block_rays]: the closest hit's t,
mesh-local leaf-order slot, barycentrics and instance id, or
(t_max, -1, 0, 0, -1) on a miss.  With ``any_hit`` the hit set is what
counts: slot is 0 where some triangle lies in [1e-5, t_max) and -1
elsewhere, u = v = 0, and t / inst are those of the closest hit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .leaf_rows import PLAIN_PAIRS, TRIS, merge_scratch, rows_chunk, split_rows

# The entry points of inst_rows_live_kernel, and the first design's kernel
# on the function of each, reached only through inst_rows_first_design.
LIVE_ENTRY_POINTS = ("inst_rows_closest", "inst_rows_any")
FIRST_DESIGNS = {k: k + "_pr2" for k in LIVE_ENTRY_POINTS}
# Kernel launches since the last reset, per entry point of inst_rows.cu.
LAUNCHES = dict.fromkeys((*LIVE_ENTRY_POINTS, *FIRST_DESIGNS.values()), 0)
# The live kernel's grid: about this many blocks, as work items of
# ``split_rows(n)``-row chunks, and never more work items a packet than its
# list width has chunks (a sweep's extra rows go to the same items).
LIVE_BLOCKS = 16384


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def splits(n_rays: int, cap_tot: int, rows: int) -> int:
    """Work items a packet of the live kernel in a call of n_rays rays whose
    lists are cap_tot wide, in chunks of ``rows`` rows: enough for about
    LIVE_BLOCKS blocks, at most the list width's chunks, at least 1."""
    blocks = max(1, n_rays // 256)
    return max(1, min(-(-cap_tot // rows), LIVE_BLOCKS // blocks))


def _check(table, lists, counts, segs, inv, rays, block_rays):
    g = lists.shape[0]
    n_inst = inv.shape[0]
    if table.dim() != 2 or table.shape[1] != 128 or table.dtype != torch.float32:
        raise ValueError(f"table must be [E, 128] float32, got {tuple(table.shape)} {table.dtype}")
    if lists.dim() != 2 or lists.dtype != torch.int32:
        raise ValueError(f"lists must be [g, cap_tot] int32, got {tuple(lists.shape)} {lists.dtype}")
    if counts.shape != (g, n_inst) or counts.dtype != torch.int32:
        raise ValueError(f"counts must be [{g}, {n_inst}] int32, got "
                         f"{tuple(counts.shape)} {counts.dtype}")
    if segs.shape != (3, n_inst) or segs.dtype != torch.int32:
        raise ValueError(f"segs must be [3, {n_inst}] int32, got {tuple(segs.shape)} {segs.dtype}")
    if inv.dim() != 2 or inv.shape[1] != 12 or inv.dtype != torch.float32:
        raise ValueError(f"inv must be [I, 12] float32, got {tuple(inv.shape)} {inv.dtype}")
    if rays.shape != (7, g * block_rays) or rays.dtype != torch.float32:
        raise ValueError(f"rays must be [7, {g * block_rays}] float32, got "
                         f"{tuple(rays.shape)} {rays.dtype}")
    devices = {x.device for x in (table, lists, counts, segs, inv, rays)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def inst_rows(table: torch.Tensor, lists: torch.Tensor, counts: torch.Tensor,
              segs: torch.Tensor, inv: torch.Tensor, rays: torch.Tensor,
              block_rays: int, any_hit: bool = False):
    """Closest (or any-hit) intersection of each ray with its packet's
    instance segments: the live kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _check(table, lists, counts, segs, inv, rays, block_rays)
    if table.device.type == "cpu":
        return inst_rows_plain(table, lists, counts, segs, inv, rays,
                               block_rays, any_hit)
    return _launch(LIVE_ENTRY_POINTS[int(any_hit)], table, lists, counts, segs, inv, rays,
                   block_rays)


def inst_rows_first_design(table: torch.Tensor, lists: torch.Tensor, counts: torch.Tensor,
                           segs: torch.Tensor, inv: torch.Tensor, rays: torch.Tensor,
                           block_rays: int, any_hit: bool = False):
    """``inst_rows`` through the first design's kernel (``FIRST_DESIGNS``:
    one thread per ray, every lane, a block walking all of its packet's
    segments).  The same function; the plain version for CPU tensors."""
    _check(table, lists, counts, segs, inv, rays, block_rays)
    if table.device.type == "cpu":
        return inst_rows_plain(table, lists, counts, segs, inv, rays,
                               block_rays, any_hit)
    name = FIRST_DESIGNS[LIVE_ENTRY_POINTS[int(any_hit)]]
    return _launch(name, table, lists, counts, segs, inv, rays, block_rays)


def _launch(name, table, lists, counts, segs, inv, rays, block_rays):
    """Launch entry point ``name`` on CUDA tensors (checked by ``_check``),
    or raise."""
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"inst_rows runs on cpu or cuda, not {device}")
    lib = _build.library()
    threads = lib.inst_rows_threads_per_block()
    if block_rays <= 0 or block_rays % threads or lists.shape[0] == 0:
        raise ValueError(f"block_rays={block_rays} must be a positive multiple "
                         f"of {threads}, with at least one packet")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"{device} is not the current CUDA device")
    for label, x in (("table", table), ("lists", lists), ("counts", counts),
                     ("segs", segs), ("inv", inv), ("rays", rays)):
        if not x.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (rows are read as float4)")
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=device)
    r = torch.empty(n, dtype=torch.int32, device=device)
    u = torch.empty(n, dtype=torch.float32, device=device)
    v = torch.empty(n, dtype=torch.float32, device=device)
    i = torch.empty(n, dtype=torch.int32, device=device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    head = (table.data_ptr(), lists.data_ptr(), lists.shape[1], counts.data_ptr(),
            inv.shape[0], segs.data_ptr(), inv.data_ptr(), rays.data_ptr(), n, block_rays)
    outs = (t.data_ptr(), r.data_ptr(), u.data_ptr(), v.data_ptr(), i.data_ptr())
    if name in LIVE_ENTRY_POINTS:
        rows = split_rows(n)
        keys, arrivals = merge_scratch(device, n)
        err = getattr(lib, name)(*head, rows, splits(n, lists.shape[1], rows), *outs,
                                 keys.data_ptr(), arrivals.data_ptr(), stream)
    else:
        err = getattr(lib, name)(*head, *outs, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return t, r, u, v, i


def object_rays(a: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """World rays into object space: a [P, 12] inverse 3x4 per packet,
    o / d [3, P, R] -> (o', d') [3, P, R].  Each component is
    ((A0*x + A1*y) + A2*z) + A3 (no A3 for d'), the order the kernel uses."""
    a = a[:, :, None]
    oi = torch.stack([a[:, 4 * k] * o[0] + a[:, 4 * k + 1] * o[1]
                      + a[:, 4 * k + 2] * o[2] + a[:, 4 * k + 3]
                      for k in range(3)])
    di = torch.stack([a[:, 4 * k] * d[0] + a[:, 4 * k + 1] * d[1]
                      + a[:, 4 * k + 2] * d[2] for k in range(3)])
    return oi, di


def inst_rows_plain(table: torch.Tensor, lists: torch.Tensor,
                    counts: torch.Tensor, segs: torch.Tensor,
                    inv: torch.Tensor, rays: torch.Tensor, block_rays: int,
                    any_hit: bool = False):
    """Plain PyTorch version of the kernel (same inputs, same outputs, bit
    for bit where both round each op alike).

    Instances are taken in ascending order, each over the packets that list
    it; within an instance, rows a chunk of list positions at a time
    (PLAIN_PAIRS bounds the pairs per op, ``leaf_rows.rows_chunk`` picks each
    chunk's winner).  Loop bounds are read on the host."""
    g = lists.shape[0]
    R = block_rays
    dev = table.device
    o = rays[:6].reshape(6, g, R)
    tm = rays[6].reshape(g, R)
    best_t = tm.clone()
    best_r = torch.full((g, R), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((g, R), dtype=torch.float32, device=dev)
    best_v = torch.zeros((g, R), dtype=torch.float32, device=dev)
    best_i = torch.full((g, R), -1, dtype=torch.int32, device=dev)
    seg_off, row0, rows8 = segs.tolist()
    last_col = lists.shape[1] - 1
    for i in range(inv.shape[0]):
        pk = torch.nonzero(counts[:, i]).flatten()
        P = pk.shape[0]
        if P == 0:
            continue
        c = counts[pk, i]
        sweep = c < 0
        count = torch.where(sweep, rows8[i], c)
        width = int(count.max())
        pos = torch.arange(width, device=dev, dtype=torch.int32)
        col = (seg_off[i] + pos).clamp(max=last_col).long()
        ids = torch.where(sweep[:, None], row0[i] + pos[None, :],
                          lists[pk][:, col]).long()                  # [P, width]
        oi, di = object_rays(inv[i].expand(P, 12), o[0:3, pk], o[3:6, pk])
        best = (best_t[pk], best_r[pk], best_u[pk], best_v[pk])
        bi = best_i[pk]
        chunk_rows = max(1, PLAIN_PAIRS // (P * R * TRIS))
        for k0 in range(0, width, chunk_rows):
            rows = table[ids[:, k0:k0 + chunk_rows]]            # [P, K, 128]
            live = pos[k0:k0 + rows.shape[1]][None, :] < count[:, None]
            best, upd = rows_chunk(rows, live, oi[:, :, :, None], di[:, :, :, None],
                                   best, any_hit)
            bi = torch.where(upd, i, bi)
        best_t[pk], best_r[pk], best_u[pk], best_v[pk] = best
        best_i[pk] = bi
    if any_hit:
        best_r = torch.where(best_t < tm, 0, -1).to(torch.int32)
    return (best_t.reshape(-1), best_r.reshape(-1), best_u.reshape(-1),
            best_v.reshape(-1), best_i.reshape(-1))

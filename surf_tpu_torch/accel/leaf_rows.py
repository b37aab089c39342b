"""Leaf-row intersection: the port of ``pallas_wide._leaf_rows_kernel``.

``leaf_rows`` runs Möller–Trumbore for every ray of a packet against the
leaf-table rows of the packet's candidate list (or, for a packet whose list
length is negative, against the whole table in row order) and keeps the
strictly closest hit.  On a CUDA tensor it launches the hand-written kernel
of ``csrc/leaf_rows.cu``; on a CPU tensor it runs ``leaf_rows_plain``, the
plain PyTorch version of the same function, which the CPU tests exercise
and the chip smoke test compares the kernel with.

Inputs (all on one device):
  table   [E, 128] f32    leaf table: 8 triangle records of 16 lanes per
                          row (v0, e1, e2, slot id bits in lane 9)
  lists   [g, cap] int32  each packet's row ids in ascending order
  n_rows  [g] int32       list length; < 0 means sweep all E rows
  rays    [7, g * block_rays] f32  ox, oy, oz, dx, dy, dz, t_max
Returns (t, r, u, v), each [g * block_rays]: the closest hit's t, slot id
and barycentrics, or (t_max, -1, 0, 0) on a miss.  With ``any_hit`` only
t is carried: r is 0 where some triangle lies in [1e-5, t_max) and -1
elsewhere, and u = v = 0 (the shadow-ray trim of ``_mt8_any``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

EPS = 1e-5
REC = 16
TRIS = 8

# The plain version tests this many (ray, triangle) pairs per torch op.
PLAIN_PAIRS = 1 << 24

# Kernel launches since the last reset, per entry point of leaf_rows.cu.
LAUNCHES = {"leaf_rows_closest": 0, "leaf_rows_any": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(table, lists, n_rows, rays, block_rays):
    g = lists.shape[0]
    if table.dim() != 2 or table.shape[1] != 128 or table.dtype != torch.float32:
        raise ValueError(f"table must be [E, 128] float32, got {tuple(table.shape)} {table.dtype}")
    if lists.dim() != 2 or lists.dtype != torch.int32:
        raise ValueError(f"lists must be [g, cap] int32, got {tuple(lists.shape)} {lists.dtype}")
    if n_rows.shape != (g,) or n_rows.dtype != torch.int32:
        raise ValueError(f"n_rows must be [{g}] int32, got {tuple(n_rows.shape)} {n_rows.dtype}")
    if rays.shape != (7, g * block_rays) or rays.dtype != torch.float32:
        raise ValueError(f"rays must be [7, {g * block_rays}] float32, got "
                         f"{tuple(rays.shape)} {rays.dtype}")
    devices = {x.device for x in (table, lists, n_rows, rays)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def leaf_rows(table: torch.Tensor, lists: torch.Tensor, n_rows: torch.Tensor,
              rays: torch.Tensor, block_rays: int, any_hit: bool = False):
    """Closest (or any-hit) intersection of each ray with its packet's rows:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    _check(table, lists, n_rows, rays, block_rays)
    device = table.device
    if device.type == "cpu":
        return leaf_rows_plain(table, lists, n_rows, rays, block_rays, any_hit)
    if device.type != "cuda":
        raise ValueError(f"leaf_rows runs on cpu or cuda, not {device}")
    lib = _build.library()
    threads = lib.leaf_rows_threads_per_block()
    if block_rays <= 0 or block_rays % threads or lists.shape[0] == 0:
        raise ValueError(f"block_rays={block_rays} must be a positive multiple "
                         f"of {threads}, with at least one packet")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"{device} is not the current CUDA device")
    for name, x in (("table", table), ("lists", lists), ("n_rows", n_rows),
                    ("rays", rays)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (rows are read as float4)")
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=device)
    r = torch.empty(n, dtype=torch.int32, device=device)
    u = torch.empty(n, dtype=torch.float32, device=device)
    v = torch.empty(n, dtype=torch.float32, device=device)
    name = "leaf_rows_any" if any_hit else "leaf_rows_closest"
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(
        table.data_ptr(), table.shape[0], lists.data_ptr(), lists.shape[1],
        n_rows.data_ptr(), rays.data_ptr(), n, block_rays,
        t.data_ptr(), r.data_ptr(), u.data_ptr(), v.data_ptr(),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return t, r, u, v


def mt_records(rec: torch.Tensor, o, d):
    """Möller–Trumbore of rays against triangle records, in the operand
    order of ``pallas_wide.py:225-238`` (the kernels' ``mt_hit``).

    rec [G, 1, M, 16] (v0, e1, e2 in lanes 0-8); o and d are (x, y, z)
    triples of [G, R, 1].  Returns (t, u, v, ok), each [G, R, M]; ok is
    every test but the t_max bound: |det| >= eps, the barycentric range
    and t >= eps."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = rec[..., 0], rec[..., 1], rec[..., 2]
    e1x, e1y, e1z = rec[..., 3], rec[..., 4], rec[..., 5]
    e2x, e2y, e2z = rec[..., 6], rec[..., 7], rec[..., 8]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = torch.ones_like(a) / a
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = ((a.abs() >= EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= EPS))
    return t, u, v, ok


def mt_chunk(rows: torch.Tensor, live: torch.Tensor, o, d, best,
             any_hit: bool):
    """One chunk of rows of the plain versions: Möller–Trumbore of every
    ray against every record of the chunk, and the strictly-closer update.

    rows [G, K, 128] with live [G, K] (dead rows never hit); o and d are
    (x, y, z) triples of [G, R, 1]; best = (t, r, u, v), each [G, R].
    Within the chunk the first record (in row order) with the least t
    below the running best wins, which is the winner of the kernels'
    one-by-one strictly-closer updates.  Returns the new best and the
    [G, R] mask of rays whose best changed (with ``any_hit`` only t moves)."""
    G, K = rows.shape[:2]
    rec = rows.reshape(G, 1, K * TRIS, REC)
    live = live.repeat_interleave(TRIS, dim=1)[:, None, :]
    best_t, best_r, best_u, best_v = best
    t, u, v, ok = mt_records(rec, o, d)
    hit = ok & (t < best_t[..., None]) & live
    t_min, j = torch.where(hit, t, torch.inf).min(dim=2)
    upd = hit.any(dim=2)
    best_t = torch.where(upd, t_min, best_t)
    if not any_hit:
        j = j[..., None]
        sid = rows.view(torch.int32).reshape(G, 1, K * TRIS, REC)[..., 9]
        sid = sid.expand(G, t.shape[1], K * TRIS).gather(2, j)[..., 0]
        best_r = torch.where(upd, sid, best_r)
        best_u = torch.where(upd, u.gather(2, j)[..., 0], best_u)
        best_v = torch.where(upd, v.gather(2, j)[..., 0], best_v)
    return (best_t, best_r, best_u, best_v), upd


def leaf_rows_plain(table: torch.Tensor, lists: torch.Tensor,
                    n_rows: torch.Tensor, rays: torch.Tensor, block_rays: int,
                    any_hit: bool = False):
    """Plain PyTorch version of the kernel (same inputs, same outputs, bit
    for bit where both round each op alike).

    Rows are taken a chunk of list positions at a time (PLAIN_PAIRS bounds
    the pairs per op, ``mt_chunk`` picks each chunk's winner).  The loop
    bound is read on the host."""
    g = lists.shape[0]
    R = block_rays
    E = table.shape[0]
    dev = table.device
    o = rays[:6].reshape(6, g, R, 1)
    tm = rays[6].reshape(g, R)
    sweep = n_rows < 0
    count = torch.where(sweep, torch.full_like(n_rows, E), n_rows)
    width = int(count.max()) if g else 0
    if width > lists.shape[1]:
        lists = torch.nn.functional.pad(lists, (0, width - lists.shape[1]))
    pos = torch.arange(width, device=dev, dtype=torch.int32)
    ids = torch.where(sweep[:, None], pos[None, :], lists[:, :width]).long()

    best = (tm.clone(), torch.full((g, R), -1, dtype=torch.int32, device=dev),
            torch.zeros((g, R), dtype=torch.float32, device=dev),
            torch.zeros((g, R), dtype=torch.float32, device=dev))
    chunk_rows = max(1, PLAIN_PAIRS // (max(g, 1) * R * TRIS))
    for k0 in range(0, width, chunk_rows):
        rows = table[ids[:, k0:k0 + chunk_rows]]           # [g, K, 128]
        live = pos[k0:k0 + rows.shape[1]][None, :] < count[:, None]
        best, _ = mt_chunk(rows, live, o[0:3], o[3:6], best, any_hit)
    best_t, best_r, best_u, best_v = best
    if any_hit:
        best_r = torch.where(best_t < tm, 0, -1).to(torch.int32)
    return (best_t.reshape(-1), best_r.reshape(-1), best_u.reshape(-1),
            best_v.reshape(-1))

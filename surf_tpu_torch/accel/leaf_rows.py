"""Leaf-row intersection: the port of ``pallas_wide._leaf_rows_kernel``.

``leaf_rows`` intersects every ray of a packet (or of one sub-list of a
packet) with the leaf-table rows of its candidate list (or, for a list
whose length is negative, with the whole table in row order) and keeps the
strictly closest hit.  On a CUDA tensor it launches one instantiation of
the hand-written kernel of ``csrc/leaf_rows.cu``; on a CPU tensor it runs
``leaf_rows_plain``, the plain PyTorch version of the same function, which
the CPU tests exercise and the chip smoke test compares the kernel with.

Every f32 entry point (``LIVE_ENTRY_POINTS``: the sequential
Möller–Trumbore closest hit and any-hit trim, ``leaf_rows_closest`` and
``leaf_rows_any``, which every ``bitsru8`` frame runs, and the
Baldwin–Weber, ILP and carry-in ones) launches ``leaf_rows_live_kernel``:
only live rays (start t, t_max or the carry-in t, > 1e-5) are tested, each
list's rows are split into work items of ``split_rows(n)`` rows, and the
splits merge through an exact (t, list position) key in a scratch that
this module keeps per device and stream (``merge_scratch``; all zero
between calls).  The bf16 sequential closest hit, without and with
carry-in (``leaf_rows_mt_bf16_closest``,
``leaf_rows_mt_bf16_carry_closest``: ``bitsh``, ``bits2h``), launches
``leaf_rows_bf16_live_kernel``: the same structure, with records staged as
bf16x2 pairs and the record test's polynomial in packed bf16x2 ops.
``leaf_rows_first_design`` launches the first design's kernel on the
function of any entry point, to time the designs side by side; no algo
reaches it.

The instantiation is chosen by five arguments, as the TPU kernel's flags
choose its body:
  record     "mt": Möller–Trumbore on ``LeafTable.table`` records (v0, e1,
             e2, slot id bits in lane 9); "bw": Baldwin–Weber on
             ``LeafTable.tablew`` records (slot id in lane 12);
  merge      "seq": a strictly-closer update record by record; "ilp": the 8
             records of a row tested independently and merged by a
             left-preferring min-tree, then one strict < per row;
  precision  "f32", or "bf16" (Möller–Trumbore, sequential): the record
             test's arithmetic rounded to bf16 op by op, compares in f32;
  carry      None, or (t, r, u, v), each [n]: the running best to resume
             from instead of (t_max, -1, 0, 0);
  trim       the any-hit trim (f32 sequential MT without carry only): only
             t is carried, r is 0 where some triangle lies in [1e-5,
             t_max) and -1 elsewhere, and u = v = 0.
A combination that no instantiation serves raises ``ValueError``; no
combination falls back to another.

Inputs (all on one device):
  table   [E, 128] f32    leaf table (``table`` or ``tablew``)
  lists   [g, cap] int32  each list's row ids in processing order
  n_rows  [g] int32       list length; < 0 means sweep all E rows
  rays    [7, g * block_rays] f32  ox, oy, oz, dx, dy, dz, t_max
Returns (t, r, u, v), each [g * block_rays]: the closest hit's t, slot id
and barycentrics, or the starting values on a miss.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

EPS = 1e-5
REC = 16
TRIS = 8
SLOT_LANE = {"mt": 9, "bw": 12}

# The plain version tests this many (ray, triangle) pairs per torch op.
PLAIN_PAIRS = 1 << 24
# Rows of one work item of the live kernels:
# SPLIT_ROWS in a call of at least WIDE_RAYS rays, NARROW_SPLIT_ROWS in a
# narrower one, which has fewer lists to fill the card with.
SPLIT_ROWS = 32
NARROW_SPLIT_ROWS = 16
WIDE_RAYS = 131072

# (record, merge, precision, carry, trim) of each entry point of leaf_rows.cu.
ENTRY_POINTS = {
    "leaf_rows_closest": ("mt", "seq", "f32", False, False),
    "leaf_rows_any": ("mt", "seq", "f32", False, True),
    "leaf_rows_mt_carry_closest": ("mt", "seq", "f32", True, False),
    "leaf_rows_mt_bf16_closest": ("mt", "seq", "bf16", False, False),
    "leaf_rows_mt_bf16_carry_closest": ("mt", "seq", "bf16", True, False),
    "leaf_rows_mt_ilp_closest": ("mt", "ilp", "f32", False, False),
    "leaf_rows_mt_ilp_carry_closest": ("mt", "ilp", "f32", True, False),
    "leaf_rows_bw_closest": ("bw", "seq", "f32", False, False),
    "leaf_rows_bw_carry_closest": ("bw", "seq", "f32", True, False),
    "leaf_rows_bw_ilp_closest": ("bw", "ilp", "f32", False, False),
    "leaf_rows_bw_ilp_carry_closest": ("bw", "ilp", "f32", True, False),
}
_NAME_OF = {v: k for k, v in ENTRY_POINTS.items()}
# The entry points of leaf_rows_live_kernel (f32) and of
# leaf_rows_bf16_live_kernel; both take the split merge's scratch.
BF16_ENTRY_POINTS = ("leaf_rows_mt_bf16_closest", "leaf_rows_mt_bf16_carry_closest")
LIVE_ENTRY_POINTS = tuple(k for k in ENTRY_POINTS if k not in BF16_ENTRY_POINTS)
# The first design's kernel on the function of each entry point, reached
# only through leaf_rows_first_design: the f32 pair's (_pr1) and the
# others' (_pr4).
FIRST_DESIGNS = {k: k + ("_pr1" if k in ("leaf_rows_closest", "leaf_rows_any") else "_pr4")
                 for k in ENTRY_POINTS}
# Kernel launches since the last reset, per entry point of leaf_rows.cu.
LAUNCHES = dict.fromkeys((*ENTRY_POINTS, *FIRST_DESIGNS.values()), 0)

# The live kernels' merge scratch (leaf_rows.cu's and inst_rows.cu's) per
# (device, stream): (keys int64, arrivals int32), zeroed once when allocated
# and left zero by every launch (``merge_scratch``).
_SCRATCH: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def entry_point(record: str = "mt", merge: str = "seq", precision: str = "f32",
                carry: bool = False, trim: bool = False) -> str:
    """The entry point of leaf_rows.cu that serves a combination, or
    ValueError."""
    key = (record, merge, precision, bool(carry), bool(trim))
    if key not in _NAME_OF:
        raise ValueError(f"no leaf-row kernel for record={record!r}, merge={merge!r}, "
                         f"precision={precision!r}, carry={bool(carry)}, trim={bool(trim)}")
    return _NAME_OF[key]


def _check(table, lists, n_rows, rays, block_rays, carry):
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
    xs = [table, lists, n_rows, rays]
    if carry is not None:
        want = (torch.float32, torch.int32, torch.float32, torch.float32)
        if len(carry) != 4 or any(c.shape != (rays.shape[1],) or c.dtype != w
                                  for c, w in zip(carry, want)):
            raise ValueError("carry must be (t, r, u, v) of shape "
                             f"[{rays.shape[1]}], float32 / int32 / float32 / float32")
        xs += list(carry)
    devices = {x.device for x in xs}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def leaf_rows(table: torch.Tensor, lists: torch.Tensor, n_rows: torch.Tensor,
              rays: torch.Tensor, block_rays: int, trim: bool = False, *,
              record: str = "mt", merge: str = "seq", precision: str = "f32",
              carry=None):
    """Closest (or trimmed any-hit) intersection of each ray with its list's
    rows: the kernel for CUDA tensors, the plain version for CPU tensors."""
    name = entry_point(record, merge, precision, carry is not None, trim)
    _check(table, lists, n_rows, rays, block_rays, carry)
    if table.device.type == "cpu":
        return leaf_rows_plain(table, lists, n_rows, rays, block_rays, trim,
                               record=record, merge=merge, precision=precision,
                               carry=carry)
    return _launch(name, table, lists, n_rows, rays, block_rays, carry)


def leaf_rows_first_design(table: torch.Tensor, lists: torch.Tensor, n_rows: torch.Tensor,
                           rays: torch.Tensor, block_rays: int, trim: bool = False, *,
                           record: str = "mt", merge: str = "seq", precision: str = "f32",
                           carry=None):
    """``leaf_rows`` through the first design's kernel (``FIRST_DESIGNS``:
    one thread per ray, every lane, one block per 256 rays walking the whole
    list).  The same function as the entry point it stands beside; the
    plain version for CPU tensors."""
    name = entry_point(record, merge, precision, carry is not None, trim)
    _check(table, lists, n_rows, rays, block_rays, carry)
    if table.device.type == "cpu":
        return leaf_rows_plain(table, lists, n_rows, rays, block_rays, trim, record=record,
                               merge=merge, precision=precision, carry=carry)
    return _launch(FIRST_DESIGNS[name], table, lists, n_rows, rays, block_rays, carry)


def split_rows(n_rays: int) -> int:
    """Rows of one work item of the live kernel in a call of n_rays rays."""
    return SPLIT_ROWS if n_rays >= WIDE_RAYS else NARROW_SPLIT_ROWS


def scratch_key(device: torch.device):
    """The key of ``merge_scratch``'s pair: the CUDA device and the handle of
    its current stream."""
    device = torch.device("cuda", torch.cuda.current_device() if device.index is None
                          else device.index)
    return device, torch.cuda.current_stream(device).cuda_stream


def merge_scratch(device: torch.device, n: int):
    """The live kernels' merge scratch for n rays on the current stream of
    ``device``: keys [>= n] int64 and arrivals [>= n / 256] int32, zero.
    One pair a (device, stream): the calls on a stream run in order and
    each leaves the pair zero, and a larger call replaces only its own
    stream's pair (the caching allocator hands the old one out again on
    that stream only, after the calls queued before it), so calls on two
    streams never share a slot."""
    key = scratch_key(device)
    keys, arrivals = _SCRATCH.get(key, (None, None))
    if keys is None or keys.numel() < n:
        keys = torch.zeros(n, dtype=torch.int64, device=key[0])
        arrivals = torch.zeros(max(1, n // 256), dtype=torch.int32, device=key[0])
        _SCRATCH[key] = keys, arrivals
    return keys, arrivals


def _launch(name, table, lists, n_rows, rays, block_rays, carry):
    """Launch entry point ``name`` on CUDA tensors (checked by ``_check``),
    or raise."""
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"leaf_rows runs on cpu or cuda, not {device}")
    lib = _build.library()
    threads = lib.leaf_rows_threads_per_block()
    if block_rays <= 0 or block_rays % threads or lists.shape[0] == 0:
        raise ValueError(f"block_rays={block_rays} must be a positive multiple "
                         f"of {threads}, with at least one packet")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"{device} is not the current CUDA device")
    named = [("table", table), ("lists", lists), ("n_rows", n_rows), ("rays", rays)]
    named += list(zip(("carry t", "carry r", "carry u", "carry v"), carry or ()))
    for label, x in named:
        if not x.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (rows are read as float4)")
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=device)
    r = torch.empty(n, dtype=torch.int32, device=device)
    u = torch.empty(n, dtype=torch.float32, device=device)
    v = torch.empty(n, dtype=torch.float32, device=device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    head = (table.data_ptr(), table.shape[0], lists.data_ptr(), lists.shape[1],
            n_rows.data_ptr(), rays.data_ptr(), n, block_rays)
    outs = (t.data_ptr(), r.data_ptr(), u.data_ptr(), v.data_ptr())
    c_in = [x.data_ptr() for x in carry] if carry is not None else [None] * 4
    if name in LIVE_ENTRY_POINTS + BF16_ENTRY_POINTS:
        keys, arrivals = merge_scratch(device, n)
        err = getattr(lib, name)(*head, split_rows(n), *c_in, *outs, keys.data_ptr(),
                                 arrivals.data_ptr(), stream)
    else:
        err = getattr(lib, name)(*head, *c_in, *outs, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return t, r, u, v


def _mt_poly(rec, o, d, recip=None):
    """The Möller–Trumbore polynomial in the operand order of
    ``pallas_wide.py:1049-1062`` (the kernels' ``mt_hit``), in the dtype of
    its inputs: (a, u, v, t).  ``recip`` maps a to f (default 1 / a)."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = rec[..., 0], rec[..., 1], rec[..., 2]
    e1x, e1y, e1z = rec[..., 3], rec[..., 4], rec[..., 5]
    e2x, e2y, e2z = rec[..., 6], rec[..., 7], rec[..., 8]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = torch.ones_like(a) / a if recip is None else recip(a)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    return a, u, v, t


def _mt_ok(a, u, v, t):
    return ((a.abs() >= EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
            & (u + v <= 1.0) & (t >= EPS))


def mt_records(rec: torch.Tensor, o, d, recip=None):
    """Möller–Trumbore of rays against triangle records (the kernels'
    ``mt_hit``; ``recip`` as ``_mt_poly``'s, the microbenchmarks' stand-ins
    for the division).

    rec [..., M, 16] (v0, e1, e2 in lanes 0-8); o and d are (x, y, z)
    triples that broadcast against rec[..., 0] (e.g. rec [G, 1, M, 16] with
    [G, R, 1], or rec [R, M, 16] with [R, 1]).  Returns (t, u, v, ok) of
    the broadcast shape; ok is every test but the t_max bound: |det| >= eps,
    the barycentric range and t >= eps."""
    a, u, v, t = _mt_poly(rec, o, d, recip)
    return t, u, v, _mt_ok(a, u, v, t)


def mt_records_bf16(rec: torch.Tensor, o, d):
    """``mt_records`` in bf16, the ``h`` flag's record test
    (``pallas_wide.py:1024-1076`` with dtype=bfloat16; the kernels'
    ``mt_hit_bf16``): the record's lanes and the ray are cast to bfloat16,
    every op of the polynomial (the reciprocal too) is a torch.bfloat16 op,
    one at a time; a, u, v and t go back to float32 for the compares."""
    rec = rec.to(torch.bfloat16)
    o = tuple(x.to(torch.bfloat16) for x in o)
    d = tuple(x.to(torch.bfloat16) for x in d)
    a, u, v, t = (x.float() for x in _mt_poly(rec, o, d))
    return t, u, v, _mt_ok(a, u, v, t)


def bw_records(rec: torch.Tensor, o, d):
    """Baldwin–Weber of rays against precomputed records
    (``LeafTable.tablew``; the kernels' ``bw_hit``), in the operand order
    of ``pallas_wide.py:1155-1167``: t = num * (1 / den), the hit point,
    the affine barycentrics.  Shapes as ``mt_records``.  Returns (t, u, v,
    ok); ok is |den| >= eps, u, v >= 0, u + v <= 1 and t >= eps (there is
    no u <= 1 test).  The all-zero padding record gives t = 0 * inf = NaN,
    which fails every compare."""
    ox, oy, oz = o
    dx, dy, dz = d
    nx, ny, nz, d0 = rec[..., 0], rec[..., 1], rec[..., 2], rec[..., 3]
    den = nx * dx + ny * dy + nz * dz
    num = d0 - (nx * ox + ny * oy + nz * oz)
    t = num * (torch.ones_like(den) / den)
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    u = rec[..., 7] + rec[..., 4] * px + rec[..., 5] * py + rec[..., 6] * pz
    v = rec[..., 11] + rec[..., 8] * px + rec[..., 9] * py + rec[..., 10] * pz
    ok = ((den.abs() >= EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= EPS))
    return t, u, v, ok


RECORD_TESTS = {("mt", "f32"): mt_records, ("mt", "bf16"): mt_records_bf16,
                ("bw", "f32"): bw_records}


def _min_tree(t: torch.Tensor):
    """The ILP merge of the kernels over the last dim (8 records): pairs
    (0,1),(2,3),(4,5),(6,7), then pairs of those, then the last pair; the
    right candidate wins only when strictly closer.  Returns (t, j)."""
    j = torch.arange(t.shape[-1], device=t.device).expand(t.shape)
    while t.shape[-1] > 1:
        s = t[..., 1::2] < t[..., 0::2]
        t = torch.where(s, t[..., 1::2], t[..., 0::2])
        j = torch.where(s, j[..., 1::2], j[..., 0::2])
    return t[..., 0], j[..., 0]


def rows_chunk(rows: torch.Tensor, live: torch.Tensor, o, d, best, trim: bool,
               record: str = "mt", merge: str = "seq", precision: str = "f32"):
    """One chunk of rows of the plain versions: the record test of every
    ray against every record of the chunk, and the strictly-closer update.

    rows [G, K, 128] with live [G, K] (dead rows never hit); o and d are
    (x, y, z) triples of [G, R, 1]; best = (t, r, u, v), each [G, R].
    merge="seq": within the chunk the first record (in row order) with the
    least t below the running best wins, which is the winner of the
    kernels' one-by-one strictly-closer updates.  merge="ilp": each row's
    records are merged by the kernels' min-tree (a failed test counts as
    t = +inf), then the first row with the least merged t wins if it is
    strictly below the running best: the kernels' one strict < per row.
    Returns the new best and the [G, R] mask of rays whose best changed
    (with ``trim`` only t moves)."""
    G, K = rows.shape[:2]
    rec = rows.reshape(G, 1, K * TRIS, REC)
    best_t, best_r, best_u, best_v = best
    t, u, v, ok = RECORD_TESTS[record, precision](rec, o, d)
    R = t.shape[1]
    if merge == "seq":
        live = live.repeat_interleave(TRIS, dim=1)[:, None, :]
        hit = ok & (t < best_t[..., None]) & live
        t_min, j = torch.where(hit, t, torch.inf).min(dim=2)
        upd = hit.any(dim=2)
    else:
        cand = torch.where(ok, t, torch.inf).reshape(G, R, K, TRIS)
        t_row, j_row = _min_tree(cand)
        t_row = torch.where(live[:, None, :], t_row, torch.inf)
        t_min, k = t_row.min(dim=2)
        j = k * TRIS + j_row.gather(2, k[..., None])[..., 0]
        upd = t_min < best_t
    best_t = torch.where(upd, t_min, best_t)
    if not trim:
        j = j[..., None]
        sid = rows.view(torch.int32).reshape(G, 1, K * TRIS, REC)[..., SLOT_LANE[record]]
        sid = sid.expand(G, R, K * TRIS).gather(2, j)[..., 0]
        best_r = torch.where(upd, sid, best_r)
        best_u = torch.where(upd, u.gather(2, j)[..., 0], best_u)
        best_v = torch.where(upd, v.gather(2, j)[..., 0], best_v)
    return (best_t, best_r, best_u, best_v), upd


def leaf_rows_plain(table: torch.Tensor, lists: torch.Tensor,
                    n_rows: torch.Tensor, rays: torch.Tensor, block_rays: int,
                    trim: bool = False, *, record: str = "mt", merge: str = "seq",
                    precision: str = "f32", carry=None):
    """Plain PyTorch version of the kernel (same inputs, same outputs, bit
    for bit where both round each op alike).

    Rows are taken a chunk of list positions at a time (PLAIN_PAIRS bounds
    the pairs per op, ``rows_chunk`` picks each chunk's winner).  The loop
    bound is read on the host."""
    entry_point(record, merge, precision, carry is not None, trim)
    _check(table, lists, n_rows, rays, block_rays, carry)
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

    if carry is not None:
        best = tuple(x.reshape(g, R).clone() for x in carry)
    else:
        best = (tm.clone(), torch.full((g, R), -1, dtype=torch.int32, device=dev),
                torch.zeros((g, R), dtype=torch.float32, device=dev),
                torch.zeros((g, R), dtype=torch.float32, device=dev))
    chunk_rows = max(1, PLAIN_PAIRS // (max(g, 1) * R * TRIS))
    for k0 in range(0, width, chunk_rows):
        rows = table[ids[:, k0:k0 + chunk_rows]]           # [g, K, 128]
        live = pos[k0:k0 + rows.shape[1]][None, :] < count[:, None]
        best, _ = rows_chunk(rows, live, o[0:3], o[3:6], best, trim,
                             record, merge, precision)
    best_t, best_r, best_u, best_v = best
    if trim:
        best_r = torch.where(best_t < tm, 0, -1).to(torch.int32)
    return (best_t.reshape(-1), best_r.reshape(-1), best_u.reshape(-1),
            best_v.reshape(-1))

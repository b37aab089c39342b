"""Packet walks of the 8-wide DFS stream: the port of
``pallas_wide._kernel_multiblock`` with ``algo="skip"`` (``_walk_block`` /
``_make_skip_visit``) and ``algo="stack"`` (``_walk_block_stack``).

Each packet of ``block_rays`` rays walks the stream (``accel/wide.py``)
with ONE cursor for the whole packet:

- ``skip``: visit row p.  A node row descends to p + 1 if any live ray of
  the packet hits any child box, else jumps to the row's skip link; a
  leaf row tests its 8 triangles and goes on to p + 1.  The cursor only
  grows, so a packet visits at most every row once.
- ``stack``: a node row tests its 8 child boxes against the packet and
  goes to the first child some live ray hits, keeping (row, remaining
  children) on a per-packet stack; with no child hit it pops the stack
  (re-reading the parent row for the next child's pointer).  Only hit
  children are visited.

Every ray keeps the strictly closest hit in visit order; with ``any_hit``
a ray stops testing once it has a hit, and the packet stops once every
active ray has one.  A packet with no active ray visits nothing.  The
slab test uses NaN-propagating min/max (empty child slots and pad rows
are NaN boxes and never hit); the caller nudges zero direction
components, so 1/d is finite.

On a CUDA tensor ``stream_walk`` launches the hand-written kernels of
``csrc/stream_walk.cu``; on a CPU tensor it runs ``stream_walk_plain``,
the plain PyTorch version, which walks all packets in lockstep, each with
its own cursor.

Inputs (all on one device):
  stream  [E, 128] f32    the stream (node and leaf rows, lanes 9/10 meta)
  rays    [7, g * block_rays] f32  ox, oy, oz, dx, dy, dz, t_max
  act     [g * block_rays] int32   1 for an active ray
Returns (t, rec, u, v, visits): per ray the best t (t_max on a miss), the
record ``row * 8 + j`` of the hit triangle (-1 on a miss) and its
barycentrics; per packet [g, 2] int32 the rows visited (JAX's visit
count) and how many of them were leaf rows.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .leaf_rows import REC, TRIS, mt_records

ALGOS = ("skip", "stack")
STACK_DEPTH = 16    # the stack walk's least depth, pallas_wide.STACK_DEPTH
STACK_CAP = 64      # the kernel's stack capacity (kMaxStack)
K_VISITS = 32       # the stack walk's iteration belt: n_entries + K_VISITS

# Kernel launches since the last reset, per entry point of stream_walk.cu.
LAUNCHES = {f"stream_walk_{a}_{m}": 0 for a in ALGOS for m in ("closest", "any")}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stack_depth(max_depth: int) -> int:
    """The stack depth a walk of a stream ``max_depth`` node levels deep
    needs: at least STACK_DEPTH, as JAX sizes it.  A push can happen at
    every node level, so a deeper tree than the kernel's capacity would
    lose pushes: that raises."""
    if max_depth > STACK_CAP:
        raise ValueError(f"the stream's node tree is {max_depth} levels deep, more "
                         f"than the stack walk's capacity of {STACK_CAP}")
    return max(max_depth, STACK_DEPTH)


def _check(stream, rays, act, block_rays, algo):
    if algo not in ALGOS:
        raise ValueError(f"algo must be one of {ALGOS}, not {algo!r}")
    if stream.dim() != 2 or stream.shape[1] != 128 or stream.dtype != torch.float32:
        raise ValueError(f"stream must be [E, 128] float32, got {tuple(stream.shape)} "
                         f"{stream.dtype}")
    n = rays.shape[1] if rays.dim() == 2 else -1
    if rays.shape != (7, n) or rays.dtype != torch.float32 or block_rays <= 0 \
            or n % block_rays or n == 0:
        raise ValueError(f"rays must be [7, k * {block_rays}] float32 with k > 0, got "
                         f"{tuple(rays.shape)} {rays.dtype}")
    if act.shape != (n,) or act.dtype != torch.int32:
        raise ValueError(f"act must be [{n}] int32, got {tuple(act.shape)} {act.dtype}")
    devices = {x.device for x in (stream, rays, act)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def stream_walk(stream: torch.Tensor, rays: torch.Tensor, act: torch.Tensor,
                block_rays: int, algo: str = "skip", any_hit: bool = False,
                max_depth: int = 0):
    """The packet walk of every ray: the kernel for CUDA tensors, the plain
    version for CPU tensors.  ``max_depth`` is the stream's node-tree depth
    (it sizes the stack walk's stack)."""
    _check(stream, rays, act, block_rays, algo)
    depth = stack_depth(max_depth) if algo == "stack" else STACK_DEPTH
    device = stream.device
    if device.type == "cpu":
        return stream_walk_plain(stream, rays, act, block_rays, algo, any_hit, max_depth)
    if device.type != "cuda":
        raise ValueError(f"stream_walk runs on cpu or cuda, not {device}")
    lib = _build.library()
    threads = lib.stream_walk_threads_per_block()
    if block_rays % threads or block_rays // threads not in (1, 2, 4):
        raise ValueError(f"block_rays={block_rays} must be 1, 2 or 4 times {threads}")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"{device} is not the current CUDA device")
    for name, x in (("stream", stream), ("rays", rays), ("act", act)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if stream.data_ptr() % 16:
        raise ValueError("stream must be 16-byte aligned (rows are read as float4)")
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=device)
    r = torch.empty(n, dtype=torch.int32, device=device)
    u = torch.empty(n, dtype=torch.float32, device=device)
    v = torch.empty(n, dtype=torch.float32, device=device)
    visits = torch.empty(n // block_rays, 2, dtype=torch.int32, device=device)
    name = f"stream_walk_{algo}_{'any' if any_hit else 'closest'}"
    cuda_stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(
        stream.data_ptr(), stream.shape[0], rays.data_ptr(), act.data_ptr(), n,
        block_rays, depth, t.data_ptr(), r.data_ptr(), u.data_ptr(), v.data_ptr(),
        visits.data_ptr(), ctypes.c_void_p(cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return t, r, u, v, visits


# --------------------------------------------------------------------------
# Plain PyTorch version: all packets in lockstep, one cursor per packet
# --------------------------------------------------------------------------

def _slab8(rows, o, inv, best_t):
    """The 8 child boxes of each packet's row against the packet's rays,
    with NaN-propagating min/max (``pallas_wide.py:186-209``): [g, 8, R]."""
    box = rows.reshape(rows.shape[0], TRIS, REC)[:, :, :6, None]
    tmin = tmax = None
    for c in range(3):
        tn = (box[:, :, c] - o[c][:, None, :]) * inv[c][:, None, :]
        tf = (box[:, :, 3 + c] - o[c][:, None, :]) * inv[c][:, None, :]
        lo = torch.minimum(tn, tf)
        hi = torch.maximum(tn, tf)
        tmin = lo if tmin is None else torch.maximum(tmin, lo)
        tmax = hi if tmax is None else torch.minimum(tmax, hi)
    return (tmax >= tmin) & (tmin < best_t[:, None, :]) & (tmax > 0.0)


def first_true(mask):
    """Index of the first True along the last dim (its length where none)."""
    k = torch.arange(mask.shape[-1], device=mask.device)
    return torch.where(mask, k, mask.shape[-1]).amin(-1)


def nearest_records(rec, rec0, live, o3, d3, best, any_hit: bool, rec_ok=None):
    """Möller–Trumbore of each packet's rays against its records in order,
    as the kernels' one-by-one updates leave them: for closest hit the
    first record with the least t below the running best, for any-hit the
    first record that hits (a ray stops testing at its first hit).  rec
    [g, M, 16]; rec0 [g] the id of each packet's record 0 (record k's id is
    rec0 + k); live [g, R] the rays that test; rec_ok [g, M] the records
    that may hit (all when None); o3/d3 triples of [g, R, 1]; best = (t,
    id, u, v), each [g, R]."""
    m = rec.shape[1]
    best_t, best_r, best_u, best_v = best
    t, u, v, ok = mt_records(rec[:, None], o3, d3)
    cand = ok & (t < best_t[..., None]) & live[..., None]
    if rec_ok is not None:
        cand &= rec_ok[:, None, :]
    if any_hit:
        j = first_true(cand)
        upd = j < m
        j = j.clamp(max=m - 1)
    else:
        j = torch.where(cand, t, torch.inf).min(dim=2).indices
        upd = cand.any(dim=2)
    j1 = j[..., None]
    return (torch.where(upd, t.gather(2, j1)[..., 0], best_t),
            torch.where(upd, (rec0[:, None] + j).to(torch.int32), best_r),
            torch.where(upd, u.gather(2, j1)[..., 0], best_u),
            torch.where(upd, v.gather(2, j1)[..., 0], best_v))


def stream_walk_plain(stream: torch.Tensor, rays: torch.Tensor, act: torch.Tensor,
                      block_rays: int, algo: str = "skip", any_hit: bool = False,
                      max_depth: int = 0, work: torch.Tensor | None = None):
    """Plain PyTorch version of the kernels (same inputs and outputs, bit
    for bit where both round each op alike).  The loop runs until every
    packet's cursor has left the stream, reading that condition on the
    host once per visit.  Where ``work`` ([g, 2] int64) is given, adds to
    it per packet the tests the function needs: ray x box slab tests and
    ray x triangle tests of the live rays (active, and for any-hit without
    a hit yet) against the real slots of each row visited (``row_slots``)."""
    depth = stack_depth(max_depth) if algo == "stack" else STACK_DEPTH
    g = rays.shape[1] // block_rays
    dev = stream.device
    o = rays[0:3].reshape(3, g, block_rays)
    d = rays[3:6].reshape(3, g, block_rays)
    inv = 1.0 / d
    o3 = tuple(x[..., None] for x in o)
    d3 = tuple(x[..., None] for x in d)
    tm = rays[6].reshape(g, block_rays)
    act = act.reshape(g, block_rays) != 0
    best = (tm.clone(), torch.full((g, block_rays), -1, dtype=torch.int32, device=dev),
            torch.zeros((g, block_rays), device=dev), torch.zeros((g, block_rays), device=dev))
    visits = torch.zeros(g, 2, dtype=torch.int32, device=dev)
    n_e = stream.shape[0]
    rows_i = stream.view(torch.int32)
    walk = _skip_walk if algo == "skip" else _stack_walk
    tally = _tally(work, row_slots(stream)) if work is not None else None
    best = walk(stream, rows_i, act, o, inv, o3, d3, best, visits, n_e, any_hit, depth, tally)
    return (*(x.reshape(-1) for x in best), visits)


def row_slots(stream: torch.Tensor) -> torch.Tensor:
    """[E] int64: the real slots of each row, the tests one ray needs at a
    visit: child boxes of a node row (empty slots are NaN boxes) and
    triangles of a leaf row (empty slots have zero edges)."""
    recs = stream.reshape(-1, TRIS, REC)
    boxes = ~torch.isnan(recs[:, :, 0])
    tris = (recs[:, :, 3:9] != 0).any(2)
    is_leaf = stream.view(torch.int32)[:, 9] == 1
    return torch.where(is_leaf, tris.sum(1), boxes.sum(1))


def _tally(work, slots):
    """One visit's tests into ``work``: [g, 0] slab tests at node rows,
    [g, 1] triangle tests at leaf rows."""
    def add(pc, valid, leaf, live):
        n = live.sum(1) * slots[pc] * valid
        work[:, 0] += torch.where(leaf, 0, n)
        work[:, 1] += torch.where(leaf, n, 0)
    return add


def _live(act, best, any_hit):
    return act & (best[1] < 0) if any_hit else act


def _skip_walk(stream, rows_i, act, o, inv, o3, d3, best, visits, n_e, any_hit, depth,
               tally):
    p = torch.where(act.any(1), 0, n_e)
    while True:
        valid = p < n_e
        if not bool(valid.any()):
            return best
        pc = torch.where(valid, p, 0)
        rows = stream[pc]
        is_leaf = rows_i[pc, 9] == 1
        live = _live(act, best, any_hit)
        if tally:
            tally(pc, valid, is_leaf, live)
        descend = (_slab8(rows, o, inv, best[0]).any(1) & live).any(1)
        best = nearest_records(rows.reshape(-1, TRIS, REC), pc * TRIS,
                               live & (is_leaf & valid)[:, None], o3, d3, best, any_hit)
        new_p = torch.where(is_leaf | descend, p + 1, rows_i[pc, 10])
        new_p = torch.where(valid, torch.maximum(new_p, p + 1), p)
        if any_hit:
            new_p = torch.where(_live(act, best, True).any(1), new_p, n_e)
        visits[:, 0] += valid
        visits[:, 1] += valid & is_leaf
        p = new_p


def _stack_walk(stream, rows_i, act, o, inv, o3, d3, best, visits, n_e, any_hit, depth,
                tally):
    g = act.shape[0]
    dev = act.device
    pk = torch.arange(g, device=dev)
    cur = torch.where(act.any(1), 0, -1)
    cleaf = torch.zeros(g, dtype=torch.bool, device=dev)
    sp = torch.zeros(g, dtype=torch.int64, device=dev)
    srows = torch.zeros(g, depth, dtype=torch.int64, device=dev)
    smasks = torch.zeros(g, depth, TRIS, dtype=torch.bool, device=dev)
    slot = torch.arange(TRIS, device=dev)
    ptr = rows_i.reshape(-1, TRIS, REC)[:, :, 6:8].long()  # [E, 8, (child, leaf)]
    while True:
        valid = (cur >= 0) & (visits[:, 0] < n_e + K_VISITS)
        if not bool(valid.any()):
            return best
        pc = torch.where(valid, cur, 0)
        rows = stream[pc]
        live = _live(act, best, any_hit)
        if tally:
            tally(pc, valid, cleaf, live)
        # node interpretation: one bit per child box some live ray hits
        mask = ((_slab8(rows, o, inv, best[0]) & live[:, None, :]).any(2)
                & (valid & ~cleaf)[:, None])
        best = nearest_records(rows.reshape(-1, TRIS, REC), pc * TRIS,
                               live & (valid & cleaf)[:, None], o3, d3, best, any_hit)
        # descend to the first hit child, or pop the stack
        low = first_true(mask)
        go = low < TRIS
        rem = mask & (slot != low[:, None])
        child = ptr[pc, low.clamp(max=TRIS - 1)]
        push = valid & go & rem.any(1)
        pop = valid & ~go & (sp > 0)
        top = sp - 1
        in_range = (top >= 0) & (top < depth)
        ti = top.clamp(0, depth - 1)
        trow = torch.where(in_range, srows[pk, ti], 0)
        tmask = smasks[pk, ti] & in_range[:, None]
        plow = first_true(tmask)
        prem = tmask & (slot != plow[:, None])
        pchild = torch.where((plow < TRIS)[:, None], ptr[trow, plow.clamp(max=TRIS - 1)], 0)
        nxt = torch.where(go[:, None], child, torch.where(pop[:, None], pchild, 0))
        nxt[:, 0] = torch.where(go | pop, nxt[:, 0], -1)
        at = push & (sp < depth)
        si = sp.clamp(max=depth - 1)
        srows[pk[at], si[at]] = pc[at]
        smasks[pk[at], si[at]] = rem[at]
        at = pop & in_range
        smasks[pk[at], ti[at]] = prem[at]
        sp = sp + push.long() - (pop & ~prem.any(1)).long()
        visits[:, 0] += valid
        visits[:, 1] += valid & cleaf
        cur = torch.where(valid, nxt[:, 0], cur)
        cleaf = torch.where(valid, nxt[:, 1] == 1, cleaf)
        if any_hit:
            cur = torch.where(_live(act, best, True).any(1), cur, -1)

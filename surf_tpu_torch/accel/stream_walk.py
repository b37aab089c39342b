"""Packet walks of the 8-wide DFS stream: the port of
``pallas_wide._kernel_multiblock``'s walks (``pallas_wide.py:862-940``).

Each packet of ``block_rays`` rays walks the stream (``accel/wide.py``)
with ONE cursor for the whole packet.  The algo names a walk and, for the
TPU's schedules of the skip walk, its width N:

- ``skip`` (``_walk_block`` / ``_make_skip_visit``): visit row p.  A node
  row descends to p + 1 if any live ray of the packet hits any child box,
  else jumps to the row's skip link; a leaf row tests its 8 triangles and
  goes on to p + 1.  The cursor only grows, so a packet visits at most
  every row once.
- ``skip2`` (``_walk_block_pair``) and ``ilvN``, 1 <= N <= 4
  (``_walk_block_multi``): N packets walk ``skip`` side by side (``skip2``
  is ``ilv2``).  Each packet's result and visits are those of ``skip``,
  whatever the grouping.
- ``specN`` / ``specbN``, 1 <= N <= 8 (``_walk_block_spec`` /
  ``_walk_block_specb``): one step (a window) tests N consecutive rows in
  stream order against the running state, then resolves the cursor from
  the N (descend, leaf, skip) triples once (``_spec_walk``).
- ``stack`` (``_walk_block_stack``): a node row tests its 8 child boxes
  against the packet and goes to the first child some live ray hits,
  keeping (row, remaining children) on a per-packet stack; with no child
  hit it pops the stack (to the next pending child of the top entry).
  Only hit children are visited.

Every ray keeps the strictly closest hit in test order; with ``any_hit``
a ray stops testing once it has a hit, and the packet stops once every
active ray has one (``spec``/``specb``: checked between groups of
K_VISITS / SPECB_VISITS windows, as JAX's while condition does).  A
packet with no active ray visits nothing.  The slab test uses
NaN-propagating min/max (empty child slots and pad rows are NaN boxes and
never hit); the caller nudges zero direction components, so 1/d is
finite.

On a CUDA tensor ``stream_walk`` launches the hand-written kernels of
``csrc/stream_walk_ilv.cu`` (``skip``, ``skip2`` and ``ilvN``: ``skip`` is
``ilv1``'s function, one cursor a packet along the skip links),
``csrc/stream_walk_spec.cu`` (``specN`` and ``specbN``) and
``csrc/stream_walk_stack.cu`` (``stack``); each takes one packet a work
item, its active rays spread over a cluster of 8 blocks.  On a CPU tensor
it runs ``stream_walk_plain``, the plain PyTorch version, which walks all
packets in lockstep, each with its own cursor.  ``stream_walk_skip_pr3``,
``stream_walk_stack_pr3``, ``stream_walk_ilv_pr5`` and
``stream_walk_spec_pr5`` launch the first designs of ``csrc/stream_walk.cu``:
skip and stack (a 512-thread block a packet), skip2 / ilvN (N packets a
block) and specN / specbN (a block a packet), to time them beside
``stream_walk``; no algo reaches them.

Inputs (all on one device):
  stream  [E, 128] f32    the stream (node and leaf rows, lanes 9/10 meta)
  rays    [7, g * block_rays] f32  ox, oy, oz, dx, dy, dz, t_max
  act     [g * block_rays] int32   1 for an active ray
Returns (t, rec, u, v, visits): per ray the best t (t_max on a miss), the
record ``row * 8 + j`` of the hit triangle (-1 on a miss) and its
barycentrics; per packet [g, 3] int32 the rows on the packet's path (JAX's
visit count), the leaf rows among them, and the windows walked (the rows
tested are windows x N for ``spec``/``specb``; the other walks test one
row a window, so there it equals the rows visited).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .leaf_rows import REC, TRIS, mt_records

MAX_ILV = 4         # ilvN: at most 4 packets walk side by side
MAX_SPEC = 8        # specN / specbN: at most 8 rows a window
ALGOS = ("skip", "stack", "skip2", *(f"ilv{n}" for n in range(1, MAX_ILV + 1)),
         *(f"spec{n}" for n in range(1, MAX_SPEC + 1)),
         *(f"specb{n}" for n in range(1, MAX_SPEC + 1)))
STACK_DEPTH = 16    # the stack walk's least depth, pallas_wide.STACK_DEPTH
STACK_CAP = 64      # the kernels' stack capacity (kMaxStack)
K_VISITS = 32       # the stack walk's belt (n_entries + K_VISITS); spec's group
SPECB_VISITS = 8    # specb's group of windows between any-hit checks

# Kernel launches since the last reset, per entry point of stream_walk.cu,
# stream_walk_ilv.cu, stream_walk_spec.cu and stream_walk_stack.cu (one
# kernel template per walk of parse_algo, and the first skip, stack, ilv
# and spec designs; a skip walk counts under stream_walk_ilv_*, its first
# design under stream_walk_skip_*).
LAUNCHES = dict.fromkeys((*_build.WALK_ENTRY_POINTS, *_build.STACK_PR3_ENTRY_POINTS,
                          *_build.ILV_PR5_ENTRY_POINTS, *_build.SPEC_PR5_ENTRY_POINTS), 0)


def parse_algo(algo: str) -> tuple[str, int]:
    """(walk, n) of an algo name: ("skip", 1), ("stack", 0), ("ilv", M) for
    ``skip2`` (M = 2) and ``ilvM``, ("spec", W) and ("specb", W).  Any other
    name raises ``ValueError``."""
    if algo not in ALGOS:
        raise ValueError(f"algo must be one of {ALGOS}, not {algo!r}")
    if algo == "skip2":
        return "ilv", 2
    for walk in ("specb", "spec", "ilv"):
        if algo.startswith(walk):
            return walk, int(algo[len(walk):])
    return algo, 1 if algo == "skip" else 0


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
    walk, width = parse_algo(algo)
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
    if walk == "specb" and width > stream.shape[0]:
        raise ValueError(f"{algo}'s window of {width} rows is longer than the stream "
                         f"({stream.shape[0]} rows)")
    return walk, width


def stream_walk(stream: torch.Tensor, rays: torch.Tensor, act: torch.Tensor,
                block_rays: int, algo: str = "skip", any_hit: bool = False,
                max_depth: int = 0):
    """The packet walk of every ray: the kernel for CUDA tensors, the plain
    version for CPU tensors.  ``algo`` is one of ALGOS (``parse_algo``);
    ``max_depth`` is the stream's node-tree depth (it sizes the stack
    walk's stack)."""
    walk, width = _check(stream, rays, act, block_rays, algo)
    if stream.device.type == "cpu":
        return stream_walk_plain(stream, rays, act, block_rays, algo, any_hit, max_depth)
    # skip is ilv1 (parse_algo gives it N = 1); the kernel's one size
    # argument: the stack's depth, ilvN's N or rows per window (spec, specb)
    walk = "ilv" if walk == "skip" else walk
    arg = stack_depth(max_depth) if walk == "stack" else width
    name = f"stream_walk_{walk}_{'any' if any_hit else 'closest'}"
    return _launch(name, stream, rays, act, block_rays, arg)


def stream_walk_skip_pr3(stream: torch.Tensor, rays: torch.Tensor, act: torch.Tensor,
                         block_rays: int, any_hit: bool = False):
    """``stream_walk`` of ``skip`` through the first design's kernel
    (``stream_walk.cu``: a 512-thread block a packet, every lane, 4 rays a
    thread at 2048-ray packets); the plain version for CPU tensors."""
    _check(stream, rays, act, block_rays, "skip")
    if stream.device.type == "cpu":
        return stream_walk_plain(stream, rays, act, block_rays, "skip", any_hit)
    name = f"stream_walk_skip_{'any' if any_hit else 'closest'}"
    return _launch(name, stream, rays, act, block_rays, 1)


def stream_walk_stack_pr3(stream: torch.Tensor, rays: torch.Tensor, act: torch.Tensor,
                          block_rays: int, any_hit: bool = False, max_depth: int = 0):
    """``stream_walk`` of ``stack`` through the first design's kernel
    (``stream_walk.cu``: a 512-thread block a packet, every lane, 4 rays a
    thread at 2048-ray packets, the stack in shared memory); the plain
    version for CPU tensors."""
    _check(stream, rays, act, block_rays, "stack")
    if stream.device.type == "cpu":
        return stream_walk_plain(stream, rays, act, block_rays, "stack", any_hit, max_depth)
    name = _build.STACK_PR3_ENTRY_POINTS[int(bool(any_hit))]
    return _launch(name, stream, rays, act, block_rays, stack_depth(max_depth))


def stream_walk_ilv_pr5(stream: torch.Tensor, rays: torch.Tensor, act: torch.Tensor,
                        block_rays: int, algo: str = "skip2", any_hit: bool = False):
    """``stream_walk`` of a skip2 / ilvN algo through the first design's
    kernel (N packets a block, one barrier for all); the plain version for
    CPU tensors."""
    walk, width = _check(stream, rays, act, block_rays, algo)
    if walk != "ilv":
        raise ValueError(f"{algo} is not skip2 or ilvN")
    if stream.device.type == "cpu":
        return stream_walk_plain(stream, rays, act, block_rays, algo, any_hit)
    name = _build.ILV_PR5_ENTRY_POINTS[int(bool(any_hit))]
    return _launch(name, stream, rays, act, block_rays, width)


def stream_walk_spec_pr5(stream: torch.Tensor, rays: torch.Tensor, act: torch.Tensor,
                         block_rays: int, algo: str = "spec4", any_hit: bool = False):
    """``stream_walk`` of a specN / specbN algo through the first design's
    kernel (one 512-thread block a packet); the plain version for CPU
    tensors."""
    walk, width = _check(stream, rays, act, block_rays, algo)
    if walk not in ("spec", "specb"):
        raise ValueError(f"{algo} is not specN or specbN")
    if stream.device.type == "cpu":
        return stream_walk_plain(stream, rays, act, block_rays, algo, any_hit)
    name = f"stream_walk_{walk}_{'any' if any_hit else 'closest'}_pr5"
    return _launch(name, stream, rays, act, block_rays, width)


def _launch(name, stream, rays, act, block_rays, arg):
    """Launch entry point ``name`` on CUDA tensors (checked by ``_check``),
    or raise."""
    device = stream.device
    if device.type != "cuda":
        raise ValueError(f"stream_walk runs on cpu or cuda, not {device}")
    lib = _build.library()
    threads = lib.stream_walk_threads_per_block()
    if block_rays % threads or block_rays // threads not in (1, 2, 4):
        raise ValueError(f"block_rays={block_rays} must be 1, 2 or 4 times {threads}")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"{device} is not the current CUDA device")
    for label, x in (("stream", stream), ("rays", rays), ("act", act)):
        if not x.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if stream.data_ptr() % 16:
        raise ValueError("stream must be 16-byte aligned (rows are read as float4)")
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=device)
    r = torch.empty(n, dtype=torch.int32, device=device)
    u = torch.empty(n, dtype=torch.float32, device=device)
    v = torch.empty(n, dtype=torch.float32, device=device)
    visits = torch.empty(n // block_rays, 3, dtype=torch.int32, device=device)
    cuda_stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(
        stream.data_ptr(), stream.shape[0], rays.data_ptr(), act.data_ptr(), n,
        block_rays, arg, t.data_ptr(), r.data_ptr(), u.data_ptr(), v.data_ptr(),
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
    with NaN-propagating min/max (``pallas_wide.py:186-209``): [g, 8, R].
    The three axes go through each op together; a max or min is exact, so
    reducing over them at once gives the kernels' booleans (a NaN still
    propagates, and +0 and -0 compare alike)."""
    box = rows.reshape(rows.shape[0], TRIS, REC)[:, :, :6, None]  # [g, 8, 6, 1]
    o_, inv_ = o.transpose(0, 1)[:, None], inv.transpose(0, 1)[:, None]  # [g, 1, 3, R]
    tn = (box[:, :, 0:3] - o_) * inv_
    tf = (box[:, :, 3:6] - o_) * inv_
    tmin = torch.minimum(tn, tf).amax(2)
    tmax = torch.maximum(tn, tf).amin(2)
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
    packet's cursor has left the stream, reading on the host at each row
    whether some packet's row is a leaf or a node row (``_kinds``), and
    ``spec``/``specb`` their stop test once per group of windows.
    ``skip2`` and ``ilvN`` compute ``skip``'s function for every packet,
    so their plain version is ``_skip_walk``.  Where ``work`` ([g, 2]
    int64) is given, adds to it per packet the tests the function needs:
    ray x box slab tests and ray x triangle tests of the live rays
    (active, and for any-hit without a hit yet) against the real slots of
    each row on the packet's path (``row_slots``); the speculative walks'
    rows off the path are not counted."""
    walk, width = _check(stream, rays, act, block_rays, algo)
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
    visits = torch.zeros(g, 3, dtype=torch.int32, device=dev)
    n_e = stream.shape[0]
    rows_i = stream.view(torch.int32)
    tally = _tally(work, row_slots(stream)) if work is not None else None
    args = (stream, rows_i, act, o, inv, o3, d3, best, visits, n_e, any_hit, tally)
    if walk in ("spec", "specb"):
        best = _spec_walk(*args, width=width, block=walk == "specb")
    else:
        best = (_stack_walk(*args, stack_depth(max_depth)) if walk == "stack"
                else _skip_walk(*args))
        visits[:, 2] = visits[:, 0]
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


def _kinds(on, is_leaf) -> tuple[bool, bool]:
    """(some packet's row is a leaf row, some is a node row) among the
    packets ``on``, read in one host sync.  A plain walk skips the triangle
    tests of a step without leaf rows and the box tests of one without
    node rows: their masked results would change nothing."""
    return tuple(torch.stack([(on & is_leaf).any(), (on & ~is_leaf).any()]).tolist())


def _descend(rows, o, inv, best_t, live, nodes: bool):
    """[g] bool: some live ray of the packet hits some child box of its row
    (all False without node rows, where the step ignores it)."""
    if not nodes:
        return torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    return (_slab8(rows, o, inv, best_t).any(1) & live).any(1)


def _skip_walk(stream, rows_i, act, o, inv, o3, d3, best, visits, n_e, any_hit, tally):
    p = torch.where(act.any(1), 0, n_e)
    while True:
        valid = p < n_e
        pc = torch.where(valid, p, 0)
        rows = stream[pc]
        is_leaf = rows_i[pc, 9] == 1
        leaves, nodes = _kinds(valid, is_leaf)
        if not (leaves or nodes):
            return best
        live = _live(act, best, any_hit)
        if tally:
            tally(pc, valid, is_leaf, live)
        descend = _descend(rows, o, inv, best[0], live, nodes)
        if leaves:
            best = nearest_records(rows.reshape(-1, TRIS, REC), pc * TRIS,
                                   live & (is_leaf & valid)[:, None], o3, d3, best, any_hit)
        new_p = torch.where(is_leaf | descend, p + 1, rows_i[pc, 10])
        new_p = torch.where(valid, torch.maximum(new_p, p + 1), p)
        if any_hit:
            new_p = torch.where(_live(act, best, True).any(1), new_p, n_e)
        visits[:, 0] += valid
        visits[:, 1] += valid & is_leaf
        p = new_p


def _spec_walk(stream, rows_i, act, o, inv, o3, d3, best, visits, n_e, any_hit, tally, *,
               width: int, block: bool):
    """``specN`` (``block=False``) and ``specbN`` (``block=True``) with N =
    ``width``, as ``_walk_block_spec`` / ``_walk_block_specb`` compute them
    (``pallas_wide.py:339-511``, ``:514-666``).  A window tests ``width``
    rows in stream order against the running state (best t and, for
    any-hit, the rays still without a hit: the docstrings' "visit-start
    state" is not what the code does); a node row never merges a triangle.
    ``spec`` tests rows base + w with base = min(p, n_e - 1), each clamped
    to n_e - 1; ``specb`` the block [base, base + width) with base =
    clip(p, 0, n_e - width), which may re-test rows before p.  The cursor
    is then resolved from the rows' (descend, leaf, skip): starting at
    base (``spec``) or p (``specb``), row base + w steers while the cursor
    equals it and it lies in the stream, stepping to base + w + 1 on a
    leaf or a descend, else to its skip link; then max(cursor, p + 1).
    The visit count is the rows that steered.  Windows run in groups of
    K_VISITS (``spec``) or SPECB_VISITS (``specb``); the group continues
    after the cursor leaves the stream, re-testing the clamped window, and
    the stop tests (cursor in the stream, and for any-hit some active ray
    without a hit) come only between groups, as JAX's while condition."""
    group = SPECB_VISITS if block else K_VISITS
    p = torch.where(act.any(1), 0, n_e)
    offs = torch.arange(width, device=p.device)
    while True:
        run = p < n_e
        if any_hit:
            run &= _live(act, best, True).any(1)
        if not bool(run.any()):
            return best
        for _ in range(group):
            if block:
                base = p.clamp(max=n_e - width).clamp(min=0)
                idx = base[:, None] + offs
            else:
                base = p.clamp(max=n_e - 1)
                idx = (base[:, None] + offs).clamp(max=n_e - 1)
            desc, lives = [], []
            for w in range(width):
                pc = idx[:, w]
                rows = stream[pc]
                is_leaf = rows_i[pc, 9] == 1
                leaves, nodes = _kinds(run, is_leaf)
                live = _live(act, best, any_hit) & run[:, None]
                desc.append(_descend(rows, o, inv, best[0], live, nodes))
                lives.append(live)
                if leaves:
                    best = nearest_records(rows.reshape(-1, TRIS, REC), pc * TRIS,
                                           live & is_leaf[:, None], o3, d3, best, any_hit)
            on_p = run & (p < n_e)
            nxt = p if block else base
            for w in range(width):
                pc = idx[:, w]
                on = on_p & (nxt == base + w) & (base + w < n_e)
                is_leaf = rows_i[pc, 9] == 1
                if tally:
                    tally(pc, on, is_leaf, lives[w])
                step = torch.where(is_leaf | desc[w], base + w + 1, rows_i[pc, 10])
                nxt = torch.where(on, step, nxt)
                visits[:, 0] += on
                visits[:, 1] += on & is_leaf
            p = torch.where(on_p, torch.maximum(nxt, p + 1), p)
            visits[:, 2] += run


def _stack_walk(stream, rows_i, act, o, inv, o3, d3, best, visits, n_e, any_hit, tally,
                depth):
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
        leaves, nodes = _kinds(valid, cleaf)
        if not (leaves or nodes):
            return best
        pc = torch.where(valid, cur, 0)
        rows = stream[pc]
        live = _live(act, best, any_hit)
        if tally:
            tally(pc, valid, cleaf, live)
        # node interpretation: one bit per child box some live ray hits
        if nodes:
            mask = ((_slab8(rows, o, inv, best[0]) & live[:, None, :]).any(2)
                    & (valid & ~cleaf)[:, None])
        else:
            mask = torch.zeros(act.shape[0], TRIS, dtype=torch.bool, device=dev)
        if leaves:
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

"""The decomposition of the speculative window walks' kernel (algo="specN",
"specbN"; ``csrc/stream_walk_spec.cu`` ``stream_walk_spec_split_kernel``),
emulated window by window on the CPU and held ``torch.equal`` to
``stream_walk_plain`` (t, record, u, v and all three columns of the
per-packet visits):

- one packet a work item, its lanes spread over a cluster of C blocks:
  each block ranks the packet's active lanes with the same scan (ranks go
  thread by thread) and takes ranks [s n / C, (s + 1) n / C); inactive
  lanes return (t_max, -1, 0, 0);
- a window tests its min(N, n - base) rows in stream order, each block its
  own rays, each ray on L = 1, 2, 4 or 8 lanes (the most that the block's
  threads allow): lane sub tests children c = sub (mod L), and at a leaf
  row the lanes' bests reduce to the least (t, record) (any-hit: the least
  record that hits); the window's vote is a mask (bit w: some live ray of
  the block hits some child box of row w; any-hit, one more bit: some
  active ray of the block lacks a hit), OR-ed across the blocks, and every
  block resolves the same cursor from it;
- once the cursor leaves the stream mid-group, the group's remaining
  windows test nothing: the rows of the clamped window that the last
  window did not test, [max(n - 1 or n - N, base + N), n), are tested once
  (leaf rows only), and the windows are added to the count;
- an any-hit packet whose active rays all have hits mid-group walks its
  cursor through the group's remaining windows without tests (descend 0).

The kernel runs C = 8; C = 2 checks that the function does not depend on
C.  The data: a stream built from a seeded triangle soup (every row
steers: node rows and leaf rows, no pad), the same stream with the root's
last node subtree made unreachable (its child boxes NaN), so that a walk
leaves the stream by a skip link past untested leaf rows, rays aimed at
that subtree's last leaf row (their hits there come only from the
re-test), and a stream of 5 rows.  One case holds the emulation against
``surf_tpu``'s Pallas walks for spec4 and specb8 on the box scene, in
interpret mode, with the gates of tests/test_torch_schedules.py.
"""

import warnings

import numpy as np
import pytest
import torch

from surf_tpu_torch.accel.bits import nudge
from surf_tpu_torch.accel.builder import build_blas
from surf_tpu_torch.accel.leaf_rows import REC, TRIS, mt_records
from surf_tpu_torch.accel.stream import pack_rays
from surf_tpu_torch.accel.stream_walk import (K_VISITS, SPECB_VISITS, _live, _slab8,
                                              first_true, parse_algo, stream_walk_plain)
from surf_tpu_torch.accel.wide import build_wide_stream

warnings.filterwarnings("ignore", category=RuntimeWarning)
torch.set_num_threads(1)

CPU = torch.device("cpu")
BLOCK = 512       # rays a packet here (the kernel takes 512, 1024 or 2048)
CLUSTER = 8       # the kernel's blocks a packet


def slices(act_p: torch.Tensor, cluster: int, threads: int) -> list:
    """The lanes of each block's rays, in rank order, for one packet's act:
    ranks go thread by thread (lane % T), then by j (lane // T)."""
    lanes = torch.arange(act_p.shape[0])
    order = lanes[torch.argsort(lanes % threads * act_p.shape[0] + lanes // threads)]
    live = order[act_p[order] != 0]
    n = live.shape[0]
    return [live[s * n // cluster:(s + 1) * n // cluster] for s in range(cluster)]


def spec_emulation(stream_t, rays, act, block_rays, algo, any_hit=False, cluster=CLUSTER,
                   trace=None, overshoot=True):
    """The kernel's decomposition on the CPU: (t, rec, u, v, visits).  With
    ``trace`` (a dict), counts the windows that tested rows before the
    cursor (specb), the re-tests of a clamped window's untested leaf rows,
    the windows added without tests and the windows walked without tests.
    ``overshoot=False`` drops the re-test (to show the data need it)."""
    walk, width = parse_algo(algo)
    block = walk == "specb"
    group = SPECB_VISITS if block else K_VISITS
    threads = block_rays // cluster
    g = rays.shape[1] // block_rays
    act = act.reshape(g, block_rays)
    per_block = [slices(act[p], cluster, threads) for p in range(g)]
    cap = max(1, max(len(x) for blocks in per_block for x in blocks))
    lane = torch.full((g, cluster, cap), -1, dtype=torch.int64)
    for p, blocks in enumerate(per_block):
        for s, x in enumerate(blocks):
            lane[p, s, :len(x)] = x
    on = (lane >= 0).reshape(g * cluster, cap)
    idx = (torch.arange(g)[:, None, None] * block_rays + lane.clamp(min=0)).reshape(-1)
    o = rays[0:3, idx].reshape(3, g * cluster, cap)
    d = rays[3:6, idx].reshape(3, g * cluster, cap)
    inv = 1.0 / d
    o3 = tuple(x[..., None] for x in o)
    d3 = tuple(x[..., None] for x in d)
    tm = rays[6, idx].reshape(g * cluster, cap)
    best = [tm.clone(), torch.full_like(tm, -1, dtype=torch.int32), torch.zeros_like(tm),
            torch.zeros_like(tm)]
    rows_i = stream_t.view(torch.int32)
    n_e = stream_t.shape[0]
    trace = {} if trace is None else trace
    for k in ("before_p", "retested", "added", "untested"):
        trace[k] = 0

    # Lanes a ray in each block: the largest L <= 8 with L x its rays <= T.
    cnt = on.sum(1)
    lanes = torch.ones_like(cnt)
    for _ in range(3):
        lanes = torch.where((lanes < TRIS) & (cnt * 2 * lanes <= threads), lanes * 2, lanes)
    kids = torch.arange(TRIS)

    def test_rows(sel, r, live):
        """Leaf row r[b] against the rays of the blocks ``sel`` (b): lane sub
        of a ray's L tests triangles c = sub (mod L) in order from the
        row-start best (its first hit with the least t below it; any-hit:
        its first hit), then the lanes' bests reduce to the least (t,
        record) (any-hit: the least record that hits)."""
        bt, br, bu, bv = (x[sel] for x in best)
        t, u, v, ok = mt_records(stream_t[r].reshape(-1, 1, TRIS, REC),
                                 tuple(x[sel] for x in o3), tuple(x[sel] for x in d3))
        cand = ok & (t < bt[..., None]) & live[..., None]              # [b, cap, 8]
        lane_l = lanes[sel][:, None, None, None]
        subs = torch.arange(TRIS)[:, None]
        # [b, cap, lane, c]: the triangles each lane tests that hit
        mine = cand[:, :, None, :] & (kids % lane_l == subs) & (subs < lane_l)
        if any_hit:
            j = first_true(mine)                                       # [b, cap, lane]
        else:
            j = torch.where(mine, t[:, :, None, :], torch.inf).min(dim=3).indices
        found = mine.any(3)
        tj = t.gather(2, j.clamp(max=TRIS - 1))
        # the lanes' reduction: the least (t, c) (any-hit: the least c) found
        if any_hit:
            key = torch.where(found, j, TRIS)
        else:
            key = torch.where(found, tj, torch.inf)
            key = torch.where(found & (key == key.min(2, keepdim=True).values), j, TRIS)
        win = key.min(2).values                                        # [b, cap]
        take = win < TRIS
        w1 = win.clamp(max=TRIS - 1)[..., None]
        part = (t.gather(2, w1)[..., 0], (r[:, None] * TRIS + win).to(torch.int32),
                u.gather(2, w1)[..., 0], v.gather(2, w1)[..., 0])
        for x, old, y in zip(best, (bt, br, bu, bv), part):
            x[sel] = torch.where(take, y, old)

    def base_of(q):
        return q.clamp(max=n_e - width).clamp(min=0) if block else q.clamp(max=n_e - 1)

    n_live = (act != 0).sum(1)
    p = torch.where(n_live > 0, 0, n_e)                      # one cursor a packet
    unfinished = n_live > 0                                  # the last vote's any-hit bit
    visits = torch.zeros(g, 3, dtype=torch.int32)
    while True:
        going = (p < n_e) & (unfinished | (not any_hit))     # the group-start test
        if not bool(going.any()):
            break
        for k in range(group):
            if not bool(going.any()):
                break
            base = base_of(p)
            m = (n_e - base).clamp(max=width)
            trace["before_p"] += int((going & (base < p)).sum())
            mask = torch.zeros(g, dtype=torch.int64)
            for w in range(width):
                valid = going & (w < m)                      # clamped copies are not tested
                r = (base + w).clamp(max=n_e - 1)
                is_leaf = rows_i[r, 9] == 1
                valid_b = valid.repeat_interleave(cluster)
                live = _live(on, best, any_hit) & valid_b[:, None]
                if bool((valid & ~is_leaf).any()):
                    hit = (_slab8(stream_t[r].repeat_interleave(cluster, 0), o, inv,
                                  best[0]).any(1) & live).any(1)   # each block's bit
                    mask |= ((hit.view(g, cluster).any(1) & valid & ~is_leaf).long() << w)
                sel = torch.nonzero((valid & is_leaf).repeat_interleave(cluster)).squeeze(1)
                if sel.numel():
                    test_rows(sel, r.repeat_interleave(cluster)[sel], live[sel])
            unf = (on & (best[1] < 0)).any(1).view(g, cluster).any(1)   # the OR
            nxt = p.clone() if block else base.clone()
            for w in range(width):
                r = base + w
                rc = r.clamp(max=n_e - 1)
                steer = going & (w < m) & (nxt == r)
                is_leaf = rows_i[rc, 9] == 1
                step = torch.where(is_leaf | ((mask >> w) & 1).bool(), r + 1, rows_i[rc, 10])
                nxt = torch.where(steer, step, nxt)
                visits[:, 0] += steer
                visits[:, 1] += steer & is_leaf
            p = torch.where(going, torch.maximum(nxt, p + 1), p)
            visits[:, 2] += going
            if any_hit:
                unfinished = torch.where(going, unf, unfinished)
            tail = group - k - 1
            left = going & (p >= n_e)
            # any-hit: no active ray lacks a hit, the cursor still in the stream
            stop = going & ~left & ~unfinished if any_hit else torch.zeros_like(going)
            if tail > 0:
                for pk in torch.nonzero(left).flatten().tolist():
                    # the clamped window's rows the last window did not test
                    lo = max(n_e - (width if block else 1), int(base[pk]) + width)
                    bl = torch.arange(pk * cluster, (pk + 1) * cluster)
                    for r in range(lo, n_e):
                        if overshoot and rows_i[r, 9] == 1 and (not any_hit
                                                                 or bool(unfinished[pk])):
                            test_rows(bl, torch.full((cluster,), r), _live(on[bl],
                                      [x[bl] for x in best], any_hit))
                            trace["retested"] += 1
                    visits[pk, 2] += tail
                    trace["added"] += tail
                for pk in torch.nonzero(stop).flatten().tolist():
                    q = int(p[pk])
                    for _ in range(tail):                    # descend is 0: no live ray
                        if q >= n_e:
                            visits[pk, 2] += 1
                            continue
                        b = int(base_of(torch.tensor(q)))
                        cur = q if block else b
                        for r in range(b, b + width):
                            if cur != r or r >= n_e:
                                continue
                            leaf = bool(rows_i[r, 9] == 1)
                            cur = r + 1 if leaf else int(rows_i[r, 10])
                            visits[pk, 0] += 1
                            visits[pk, 1] += leaf
                        q = max(cur, q + 1)
                        visits[pk, 2] += 1
                        trace["untested"] += 1
                    p[pk] = q
            going &= ~(left | stop)
    n = rays.shape[1]
    out_t = rays[6].clone()
    out_r = torch.full((n,), -1, dtype=torch.int32)
    out_u = torch.zeros(n)
    out_v = torch.zeros(n)
    keep = on.reshape(-1)
    for out, x in zip((out_t, out_r, out_u, out_v), best):
        out[idx[keep]] = x.reshape(-1)[keep]
    return out_t, out_r, out_u, out_v, visits


# --------------------------------------------------------------------------
# Data (also read by tests/test_torch_cuda.py, which imports no JAX)
# --------------------------------------------------------------------------

def soup_stream(n_tris: int = 150, seed: int = 3) -> torch.Tensor:
    """The 8-wide stream of a seeded soup of small triangles in [-3, 3]^3,
    built as compile_scene builds a scene's, without the empty leaf rows
    that pad it to 8 rows: it ends at the root's skip link, in a leaf row
    with triangles."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (n_tris, 1, 3))
    v = (c + rng.uniform(-0.4, 0.4, (n_tris, 3, 3))).astype(np.float32)
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    bvh = build_blas(v0, v1, v2, min_leaf=4, max_leaf=8)
    perm = bvh.indices.astype(np.int64)
    s = torch.from_numpy(build_wide_stream(bvh, v0[perm], v1[perm], v2[perm]).stream.copy())
    return s[:int(s.view(torch.int32)[0, 10])].clone()


def cut_stream(stream_t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The stream with the root's last node child made a dead end: its 8
    child boxes NaN, so that a walk takes its skip link to the end of the
    stream past the leaf rows of its subtree.  Returns (stream, that row)."""
    s = stream_t.clone()
    ints = s.view(torch.int32).reshape(-1, TRIS, REC)
    kids = [(int(ints[0, k, 6]), k) for k in range(TRIS)
            if not bool(torch.isnan(s.reshape(-1, TRIS, REC)[0, k, 0])) and ints[0, k, 7] == 0]
    row = max(kids)[0]
    s.reshape(-1, TRIS, REC)[row, :, 0:6] = float("nan")
    return s, row


def aimed_rays(stream_t: torch.Tensor, row: int, n: int, seed: int, span: float):
    """(o, d): n rays from seeded points in [-span, span]^3 towards the
    centroids of leaf row ``row``'s triangles, in turn."""
    rng = np.random.default_rng(seed)
    tri = stream_t[row].reshape(TRIS, REC)[:, :9].numpy().astype(np.float64)
    real = np.abs(tri[:, 3:9]).sum(1) > 0
    v0, e1, e2 = tri[real, 0:3], tri[real, 3:6], tri[real, 6:9]
    cen = v0 + (e1 + e2) / 3
    o = rng.uniform(-span, span, (n, 3))
    d = cen[np.arange(n) % len(cen)] - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def soup_rays(n: int, seed: int):
    """(o, d): n rays from seeded points in [-3.5, 3.5]^3 in seeded
    directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.5, 3.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


# The packets of ``packets``, BLOCK rays each: 0 all active; 1 40% active;
# 2 five rays active; 3 all dead; 4 active only in lanes [0, 64), the first
# lane slice; 5 rays from near the soup's centre towards the stream's first
# leaf row with t_max 1e30, which all hit early (any-hit: the packet's rays
# all have hits mid-group); 6 100 pad rays (pack_rays).  t_max 2.5
# elsewhere.
PACKETS = 7


def packets(stream_t, seed: int = 11, block: int = BLOCK):
    n = PACKETS * block - 100
    o, d = soup_rays(n, seed)
    rng = np.random.default_rng(seed + 1)
    act = torch.ones(n, dtype=torch.bool)
    act[block:2 * block] = torch.from_numpy(rng.random(block) < 0.4)
    act[2 * block:4 * block] = False
    act[2 * block + torch.from_numpy(rng.choice(block, 5, replace=False))] = True
    act[4 * block + 64:5 * block] = False
    tmax = torch.full((n,), 2.5)
    sl = slice(5 * block, 6 * block)
    first_leaf = int(torch.nonzero(stream_t.view(torch.int32)[:, 9] == 1)[0])
    o[sl], d[sl] = aimed_rays(stream_t, first_leaf, block, seed + 2, 0.3)
    tmax[sl] = 1e30
    return pack_rays(o, nudge(d), tmax, act, block)


def tail_packets(stream_t, block: int = BLOCK, live: float = 0.7, seed: int = 21):
    """4 packets of rays from [-4, 4]^3 aimed at the last leaf row, t_max
    1e30, ``live`` of them active."""
    n = 4 * block
    o, d = aimed_rays(stream_t, stream_t.shape[0] - 1, n, seed, 4.0)
    act = torch.from_numpy(np.random.default_rng(seed).random(n) < live)
    return pack_rays(o, nudge(d), torch.full((n,), 1e30), act, block)


# --------------------------------------------------------------------------
# Tests
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def soup():
    return soup_stream()


@pytest.fixture(scope="module")
def soup_walks(soup):
    """(rays, act, plain result, trace) of ``packets(soup)`` per (algo,
    any_hit), the emulation held to the plain walk on first use."""
    rays, a = packets(soup)
    cache = {}

    def get(algo, any_hit):
        if (algo, any_hit) not in cache:
            trace = {}
            cache[algo, any_hit] = (_check(soup, rays, a, BLOCK, algo, any_hit, trace=trace),
                                    trace)
        return (rays, a, *cache[algo, any_hit])
    return get


def _check(stream_t, rays, a, block, algo, any_hit, cluster=CLUSTER, trace=None):
    want = stream_walk_plain(stream_t, rays, a, block, algo, any_hit)
    got = spec_emulation(stream_t, rays, a, block, algo, any_hit, cluster, trace)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    return want


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("algo", ["spec1", "spec2", "spec4", "spec8", "specb1", "specb2",
                                  "specb4", "specb8"])
def test_spec_split_matches_plain(soup_walks, algo, any_hit):
    """Seven packets of every live share over the soup stream: the
    emulation equals the plain walk, windows added after the cursor left
    among them."""
    rays, a, want, trace = soup_walks(algo, any_hit)
    visits = want[4]
    assert visits[3].tolist() == [0, 0, 0] and (visits[[0, 1, 2, 4, 5, 6], 0] > 0).all()
    assert (want[1][3 * BLOCK:4 * BLOCK] == -1).all() and (want[1] >= 0).any()
    assert torch.equal(want[0][-100:], rays[6, -100:]) and (want[1][-100:] == -1).all()
    assert trace["added"] > 0


@pytest.mark.parametrize("algo", ["specb4", "specb8"])
def test_spec_split_retests_rows_before_the_cursor(algo):
    """Rays aimed at the last leaf row: the cursor reaches the stream's
    last rows, where specb's window [n - N, n) re-tests rows before it (a
    soup whose last node row lies 7 rows before the end)."""
    s = soup_stream(seed=4)
    rays, a = tail_packets(s)
    for any_hit in (False, True):
        trace = {}
        want = _check(s, rays, a, BLOCK, algo, any_hit, trace=trace)
        assert trace["before_p"] > 0 and (want[1] >= 0).any()


@pytest.mark.parametrize("algo", ["spec1", "spec8", "specb4", "specb8"])
def test_spec_split_retests_the_clamped_window(soup, algo):
    """The root's last node subtree a dead end and rays aimed at its last
    leaf row: the cursor leaves the stream by a skip link past untested
    leaf rows, whose one re-test mid-group finds the rays' hits (without it
    the result differs), closest and any-hit."""
    cut, row = cut_stream(soup)
    n_e = cut.shape[0]
    assert n_e - row > 8 and cut.view(torch.int32)[-1, 9] == 1
    for any_hit in (False, True):
        rays, a = tail_packets(cut)
        trace = {}
        want = _check(cut, rays, a, BLOCK, algo, any_hit, trace=trace)
        assert trace["retested"] > 0
        assert ((want[1] // TRIS) == n_e - 1).sum() > 0       # hits in the last row
        without = spec_emulation(cut, rays, a, BLOCK, algo, any_hit, overshoot=False)
        assert not torch.equal(without[1], want[1])


@pytest.mark.parametrize("algo", ["spec2", "specb2", "specb8"])
def test_spec_split_walks_all_hit_packets_untested(soup_walks, algo):
    """Any-hit: packet 5's rays all hit within the first group, with the
    cursor still inside the stream, so the group's remaining windows walk
    without tests; their rows and windows count as the plain walk's."""
    rays, a, want, trace = soup_walks(algo, True)
    assert trace["untested"] > 0 and (want[1][5 * BLOCK:6 * BLOCK] >= 0).all()


def test_spec_split_short_stream():
    """spec8 and specb4 on a stream of 5 rows (one node row, four leaf
    rows): windows longer than what is left of the stream."""
    s = soup_stream(n_tris=12, seed=5)
    assert s.shape[0] == 5
    rays, a = packets(s, seed=31)
    for algo, any_hit in (("spec8", False), ("spec8", True), ("specb4", False)):
        want = _check(s, rays, a, BLOCK, algo, any_hit)
        assert (want[1] >= 0).any()


@pytest.mark.parametrize("block", [512, 1024, 2048])
def test_spec_split_packet_sizes(soup, block):
    """Packets of 512, 1024 and 2048 rays (64, 128, 256 threads a block),
    100%, 40%, five rays and 0% live (``packets``' first four), through
    spec4 (closest) and specb8 (any-hit); and C = 2 at 1024 (the function
    does not depend on C)."""
    rays, a = packets(soup, seed=41, block=block)
    rays, a = rays[:, :4 * block].contiguous(), a[:4 * block].contiguous()
    _check(soup, rays, a, block, "spec4", False)
    _check(soup, rays, a, block, "specb8", True)
    if block == 1024:
        _check(soup, rays, a, block, "spec4", True, cluster=2)

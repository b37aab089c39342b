"""The decomposition of the stack walk's kernel (algo="stack";
``csrc/stream_walk_stack.cu`` ``stream_walk_stack_split_kernel``), emulated
step by step on the CPU and held ``torch.equal`` to ``stream_walk_plain``
(t, record, u, v and the per-packet visits):

- one packet a work item, its lanes spread over a cluster of C blocks:
  each block ranks the packet's active lanes with the same scan (thread i
  reads lanes j * T + i, in j order: ranks go thread by thread) and takes
  ranks [s n / C, (s + 1) n / C); inactive lanes return (t_max, -1, 0, 0);
- one vote a block a step: at a node row the 8-bit mask of the child boxes
  some live ray of the block hits, at a leaf row (any-hit) whether some
  active ray of the block still lacks a hit; the OR across the blocks;
- the stack of the kernel, the same in every block: the top entry's
  pending mask and its next child's pointer in registers, the entries
  below it as (mask, the 8 pointers of its row) in shared memory; a push
  beyond the stack depth is lost, a pop from beyond it goes to row 0;
- the pop target, staged before a step's tests (the top's next pending
  child, row 0 past the stack depth): a pop goes to the staged row.

Each block has T = block_rays / C threads of one ray each (the kernel runs
C = 8; C = 1, 2 and 4 check that the function does not depend on C).  One
case holds the emulation against ``surf_tpu``'s Pallas stack walk on the
box scene, in interpret mode.
"""

import warnings
from unittest import mock

import numpy as np
import pytest
import torch

from surf_tpu_torch.accel import stream
from surf_tpu_torch.accel.bits import nudge
from surf_tpu_torch.accel.leaf_rows import REC, TRIS
from surf_tpu_torch.accel.stream import pack_rays, traverse_stream
from surf_tpu_torch.accel.stream_walk import (K_VISITS, _live, _slab8, nearest_records,
                                              stack_depth, stream_walk_plain)
from surf_tpu_torch.accel.wide import stream_depth
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.compile import compile_scene

warnings.filterwarnings("ignore", category=RuntimeWarning)
torch.set_num_threads(1)

CPU = torch.device("cpu")
BLOCK = 512      # rays a packet here (the kernel takes 512, 1024 or 2048)
CLUSTERS = (1, 2, 4, 8)
BITS = 1 << torch.arange(TRIS)


def slices(act_p: torch.Tensor, cluster: int, threads: int) -> list:
    """The lanes of each block's rays, in rank order, for one packet's act:
    ranks go thread by thread (lane % T), then by j (lane // T)."""
    lanes = torch.arange(act_p.shape[0])
    order = lanes[torch.argsort(lanes % threads * act_p.shape[0] + lanes // threads)]
    live = order[act_p[order] != 0]
    n = live.shape[0]
    return [live[s * n // cluster:(s + 1) * n // cluster] for s in range(cluster)]


def _low(mask: int) -> int:
    return (mask & -mask).bit_length() - 1


class Walk:
    """One packet's walk state, the same in every block of its cluster."""

    def __init__(self, started: bool, depth: int):
        self.cur = 0 if started else -1
        self.cleaf = False
        self.sp = 0
        self.tmask = 0           # the top's pending children (0: no top in range)
        self.tnext = (0, 0)      # the (child, leaf) pointer of its next child
        self.s_mask = [0] * depth
        self.s_ptr = [[(0, 0)] * TRIS for _ in range(depth)]
        self.depth = depth
        self.visits = self.leaf_visits = 0
        self.max_sp = 0

    def pop_target(self):
        """The row staged before the step's tests: the top's next pending
        child (row 0 with the top past the stack depth), or None with an
        empty stack."""
        if self.sp == 0:
            return None
        return self.tnext[0] if self.tmask else 0

    def step(self, mask: int, alive: bool, ptr, any_hit: bool):
        """The step after the vote: (next row, whether it is a pop)."""
        row = ptr[self.cur]
        mask = 0 if self.cleaf else mask
        nxt, nleaf, popped = -1, False, False
        if mask:
            k = _low(mask)
            nxt, nleaf = row[k][0], row[k][1] == 1
            rem = mask & (mask - 1)
            if rem:  # push (row, rem)
                if 1 <= self.sp <= self.depth:
                    self.s_mask[self.sp - 1] = self.tmask
                if self.sp < self.depth:
                    self.s_ptr[self.sp] = [tuple(p) for p in row]
                    self.tmask, self.tnext = rem, tuple(row[_low(rem)])
                else:
                    self.tmask = 0
                self.sp += 1
        elif self.sp > 0:  # pop
            nxt = self.tnext[0] if self.tmask else 0
            nleaf, popped = bool(self.tmask) and self.tnext[1] == 1, True
            prem = self.tmask & (self.tmask - 1)
            if prem:
                self.tmask, self.tnext = prem, self.s_ptr[self.sp - 1][_low(prem)]
            else:
                self.sp -= 1
                in_range = 1 <= self.sp <= self.depth
                self.tmask = self.s_mask[self.sp - 1] if in_range else 0
                if self.tmask:
                    self.tnext = self.s_ptr[self.sp - 1][_low(self.tmask)]
        self.max_sp = max(self.max_sp, min(self.sp, self.depth))
        self.visits += 1
        self.leaf_visits += self.cleaf
        self.cur = -1 if any_hit and self.cleaf and not alive else nxt
        self.cleaf = nleaf
        return nxt, popped


def split_emulation(stream_t, rays, act, block_rays, any_hit=False, cluster=1, max_depth=0,
                    trace=None):
    """The kernel's decomposition on the CPU: (t, rec, u, v, visits).  With
    ``trace`` (a dict), records each packet's deepest stack."""
    depth = stack_depth(max_depth)
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
    best = (tm.clone(), torch.full_like(tm, -1, dtype=torch.int32), torch.zeros_like(tm),
            torch.zeros_like(tm))
    n_e = stream_t.shape[0]
    rows_i = stream_t.view(torch.int32).reshape(n_e, TRIS, REC)
    ptr = rows_i[:, :, 6:8].tolist()                                  # [E][8] (child, leaf)
    walks = [Walk(bool((act[p] != 0).any()), depth) for p in range(g)]
    belt = n_e + K_VISITS
    while True:
        run = [w.cur >= 0 and w.visits < belt for w in walks]
        if not any(run):
            break
        valid = torch.tensor(run)
        cur = torch.tensor([w.cur if r else 0 for w, r in zip(walks, run)])
        cleaf = torch.tensor([w.cleaf for w in walks])
        staged = [w.pop_target() for w in walks]
        rows_b = stream_t[cur].repeat_interleave(cluster, 0)          # each block reads the row
        node_b = (valid & ~cleaf).repeat_interleave(cluster)
        leaf_b = (valid & cleaf).repeat_interleave(cluster)
        live = _live(on, best, any_hit)
        bits = torch.zeros(g * cluster, TRIS, dtype=torch.bool)
        if bool(node_b.any()):
            bits = (_slab8(rows_b, o, inv, best[0]) & live[:, None, :]).any(2) & node_b[:, None]
        sel = torch.nonzero(leaf_b & live.any(1)).squeeze(1)
        if sel.numel():
            part = nearest_records(rows_b[sel].reshape(-1, TRIS, REC),
                                   cur.repeat_interleave(cluster)[sel] * TRIS, live[sel],
                                   tuple(x[sel] for x in o3), tuple(x[sel] for x in d3),
                                   tuple(x[sel] for x in best), any_hit)
            for x, y in zip(best, part):
                x[sel] = y
        unfinished = (on & (best[1] < 0)).any(1)
        # the OR across the cluster
        mask = (bits.view(g, cluster, TRIS).any(1) * BITS).sum(1).tolist()
        alive = unfinished.view(g, cluster).any(1).tolist()
        for p, w in enumerate(walks):
            if run[p]:
                nxt, popped = w.step(mask[p], alive[p], ptr, any_hit)
                assert not popped or staged[p] == nxt, "a pop left the staged row"
    if trace is not None:
        trace["max_sp"] = [w.max_sp for w in walks]
        trace["depth"] = depth
    n = rays.shape[1]
    out_t = rays[6].clone()
    out_r = torch.full((n,), -1, dtype=torch.int32)
    out_u = torch.zeros(n)
    out_v = torch.zeros(n)
    keep = on.reshape(-1)
    for out, x in zip((out_t, out_r, out_u, out_v), best):
        out[idx[keep]] = x.reshape(-1)[keep]
    v = torch.tensor([[w.visits, w.leaf_visits, w.visits] for w in walks], dtype=torch.int32)
    return out_t, out_r, out_u, out_v, v


def _assert_equal(got, want):
    for name, x, y in zip(("t", "rec", "u", "v", "visits"), got, want):
        assert torch.equal(x, y), f"{name} differs"


# --- the indoor scene's packets ---------------------------------------------

@pytest.fixture(scope="module")
def indoor():
    return compile_scene(builtin.make_indoor_scene(), CPU)


def _camera_rays(n, seed):
    """Rays from the indoor camera's eye (0, 0, -7) +- 0.05 towards the
    plane z = 0 within +-5."""
    rng = np.random.default_rng(seed)
    o = (np.array([0, 0, -7]) + rng.uniform(-0.05, 0.05, (n, 3))).astype(np.float32)
    tgt = np.concatenate([rng.uniform(-5, 5, (n, 2)), np.zeros((n, 1))], 1)
    d = (tgt - o).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


# The packets, 512 rays each, t_max 6: 0-2 camera rays with 100%, 40% and
# 1% of them active; 3 all dead; 4 active only in lanes [0, 64); 5 rays
# inside the room in random directions, t_max 1 (closest hit), or for
# any-hit t_max 1e30 and the first half a bundle towards -z; 6 camera rays,
# 100 of them pad rays (pack_rays).
PACKETS = 7


def _data(any_hit):
    n = PACKETS * BLOCK - 100
    o, d = _camera_rays(n, seed=21)
    rng = np.random.default_rng(22)
    act = np.ones(n, bool)
    act[BLOCK:2 * BLOCK] = rng.random(BLOCK) < 0.4
    act[2 * BLOCK:3 * BLOCK] = False
    act[2 * BLOCK + rng.choice(BLOCK, 5, replace=False)] = True
    act[3 * BLOCK:4 * BLOCK] = False
    act[4 * BLOCK + 64:5 * BLOCK] = False
    tmax = np.full(n, 6.0, np.float32)
    sl = slice(5 * BLOCK, 6 * BLOCK)
    r = np.random.default_rng(23)
    o[sl] = (np.array([0, 1, 0]) + r.uniform(-0.2, 0.2, (BLOCK, 3))).astype(np.float32)
    dd = r.normal(size=(BLOCK, 3)).astype(np.float32)
    d[sl] = dd / np.linalg.norm(dd, axis=1, keepdims=True)
    tmax[sl] = 1.0
    if any_hit:
        bundle = np.array([0, 0, -1]) + rng.uniform(-0.01, 0.01, (BLOCK // 2, 3))
        d[5 * BLOCK:5 * BLOCK + BLOCK // 2] = bundle / np.linalg.norm(bundle, axis=1,
                                                                      keepdims=True)
        tmax[sl] = 1e30
    return pack_rays(*(torch.from_numpy(x) for x in (o, d, tmax, act)), BLOCK)


@pytest.fixture(scope="module")
def plain(indoor):
    """(rays, act, stream_walk_plain's stack result) per any_hit."""
    cache = {}

    def get(any_hit):
        if any_hit not in cache:
            rays, a = _data(any_hit)
            cache[any_hit] = (rays, a, stream_walk_plain(
                indoor.stream.stream, rays, a, BLOCK, "stack", any_hit,
                indoor.stream.max_depth))
        return cache[any_hit]
    return get


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_split_matches_plain(indoor, plain, cluster, any_hit):
    rays, a, want = plain(any_hit)
    trace = {}
    got = split_emulation(indoor.stream.stream, rays, a, BLOCK, any_hit, cluster,
                          indoor.stream.max_depth, trace)
    _assert_equal(got, want)
    visits = got[4]
    assert visits[3].tolist() == [0, 0, 0] and (visits[[0, 1, 2, 4, 5, 6], 0] > 0).all()
    assert (got[1][3 * BLOCK:4 * BLOCK] == -1).all() and (got[1] >= 0).any()
    assert torch.equal(got[0][-100:], rays[6, -100:]) and (got[1][-100:] == -1).all()
    assert max(trace["max_sp"]) >= 2  # the walk pushed and popped


def test_split_live_shares(plain):
    """The data hold the live shares the kernel is tested at."""
    _, a, _ = plain(False)
    share = a.view(PACKETS, BLOCK).float().mean(1).tolist()
    assert share[0] == 1.0 and 0.3 < share[1] < 0.5 and share[2] == 5 / BLOCK
    assert share[3] == 0.0 and share[4] == 64 / BLOCK and share[6] == 412 / BLOCK


# --- a deep stream: the stack filled to its depth, and past it ---------------

def deep_stream(levels: int, seed: int = 0) -> torch.Tensor:
    """A chain of ``levels`` node rows in DFS preorder: node L holds child 0,
    node L + 1, and child 1, a leaf row (the deepest node two leaf rows).
    Every box is [-10, 10]^3, so every ray hits every child, and the walk
    pushes at every level: its stack reaches ``levels`` entries.  The leaf
    rows hold random triangles within [-4, 4]^3."""
    rng = np.random.default_rng(seed)
    rows = []

    def leaf():
        row = np.zeros((TRIS, REC), np.float32)
        for j in range(TRIS):
            v0 = rng.uniform(-4, 4, 3)
            row[j, 0:3], row[j, 3:6], row[j, 6:9] = v0, rng.uniform(-3, 3, 3), \
                rng.uniform(-3, 3, 3)
        row = row.reshape(-1)
        row[9:11] = np.array([1, len(rows) + 1], np.int32).view(np.float32)
        rows.append(row)
        return len(rows) - 1

    def node(level):
        at = len(rows)
        rows.append(None)
        kids = [(leaf(), 1)] if level < levels else [(leaf(), 1), (leaf(), 1)]
        if level < levels:
            kids.insert(0, (node(level + 1), 0))
        row = np.zeros((TRIS, REC), np.float32)
        row[:, 0:6] = np.nan
        for k, (pos, is_leaf) in enumerate(kids):
            row[k, 0:3], row[k, 3:6] = -10.0, 10.0
            row[k, 6:8] = np.array([pos, is_leaf], np.int32).view(np.float32)
        row = row.reshape(-1)
        row[9:11] = np.array([0, len(rows)], np.int32).view(np.float32)
        rows[at] = row
        return at

    node(1)
    return torch.from_numpy(np.stack(rows))


def _deep_rays(n, seed=5):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), np.full(n, -20.0)], 1)
    d = np.stack([rng.normal(0, 0.1, n), rng.normal(0, 0.1, n), np.ones(n)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = np.ones(n, bool)
    act[BLOCK:2 * BLOCK] = rng.random(BLOCK) < 0.3
    return pack_rays(torch.from_numpy(o.astype(np.float32)),
                     torch.from_numpy(d.astype(np.float32)), torch.full((n,), 1e30),
                     torch.from_numpy(act), BLOCK)


LEVELS = 18  # above stack_depth's least 16: the depth is the stream's own


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_split_fills_the_stack(any_hit):
    """Two packets down an 18-level chain: the stack holds 18 entries, the
    whole depth, and every block agrees with the plain version."""
    s = deep_stream(LEVELS)
    assert stream_depth(s.numpy()) == LEVELS == stack_depth(LEVELS)
    rays, a = _deep_rays(2 * BLOCK)
    want = stream_walk_plain(s, rays, a, BLOCK, "stack", any_hit, LEVELS)
    trace = {}
    got = split_emulation(s, rays, a, BLOCK, any_hit, 8, LEVELS, trace)
    _assert_equal(got, want)
    assert trace["max_sp"] == [LEVELS, LEVELS]
    assert (got[1] >= 0).any()


def test_split_past_the_depth_exhausts_the_belt():
    """The same chain walked with a stack of 16 (max_depth 16, two levels
    short): the pushes past it are lost and the pops from beyond it go back
    to row 0, so the walk runs until the belt (rows + K_VISITS visits)
    stops it; the emulation follows the plain version step for step."""
    s = deep_stream(LEVELS)
    rays, a = _deep_rays(2 * BLOCK)
    want = stream_walk_plain(s, rays, a, BLOCK, "stack", False, 16)
    trace = {}
    for cluster in (1, 8):
        got = split_emulation(s, rays, a, BLOCK, False, cluster, 16, trace)
        _assert_equal(got, want)
    assert trace["depth"] == 16 and trace["max_sp"] == [16, 16]
    assert (want[4][:, 0] == s.shape[0] + K_VISITS).all()


# --- the stack walk against the JAX kernel ----------------------------------

def test_split_matches_jax_stack():
    """Box scene, 2048 rays in 1024-ray packets, closest hit and any-hit:
    the emulation (C = 8) through traverse_stream against surf_tpu's stack
    Pallas walk in interpret mode, hits and per-packet visits (the gates of
    tests/test_torch_walk_split.py test_split_matches_jax_ilv2)."""
    import jax.numpy as jnp

    from surf_tpu.accel.pallas_wide import device_wide_trace, traverse_wide
    from surf_tpu.scene import builtin as jbuiltin
    from surf_tpu.scene.compile import HostCompiled

    host = HostCompiled(jbuiltin.make_diffuse_box_scene())
    wt = device_wide_trace(host._ws)
    ts = compile_scene(builtin.make_diffuse_box_scene(), CPU)
    n = 2048
    rng = np.random.default_rng(7)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:3] = [[1, 0, 0], [0, -1, 0], [0, 0, 1]]
    act = np.ones(n, bool)
    act[::7] = False

    def emulated(stream_t, rays, a, block_rays, algo, any_hit, max_depth):
        assert algo == "stack"
        return split_emulation(stream_t, rays, a, block_rays, any_hit, 8, max_depth)

    for any_hit, t in ((False, 1e30), (True, 4.0)):
        tmax = np.full(n, t, np.float32)
        port = [torch.from_numpy(x) for x in (o, d, tmax, act)]
        kw = dict(block_rays=1024, algo="stack", any_hit=any_hit)
        with mock.patch.object(stream, "stream_walk", emulated):
            got = traverse_stream(ts.stream, *port, **kw)
            visits = traverse_stream(ts.stream, *port, return_visits=True, **kw)
        jax_in = [jnp.asarray(x) for x in (o, d, tmax, act)]
        want = traverse_wide(wt, *jax_in, interpret=True, **kw)
        want_visits = traverse_wide(wt, *jax_in, interpret=True, return_visits=True, **kw)
        gp, wp = got.prim.numpy(), np.asarray(want.prim)
        gt, wt_ = got.t.numpy(), np.asarray(want.t)
        assert (gp[~act] == -1).all() and (gp >= 0).any()
        assert np.array_equal(gp >= 0, wp >= 0)
        assert np.array_equal(visits.numpy(), np.asarray(want_visits))
        if not any_hit:
            assert ((gp == wp) | (gt == wt_)).all()
            both = (gp >= 0) & (wp >= 0)
            np.testing.assert_allclose(gt[both], wt_[both], rtol=5e-6)
        # the emulation equals the plain walk bit for bit on the same packets
        rays, a = pack_rays(port[0], nudge(port[1]), port[2], port[3], 1024)
        _assert_equal(split_emulation(ts.stream.stream, rays, a, 1024, any_hit, 8,
                                      ts.stream.max_depth),
                      stream_walk_plain(ts.stream.stream, rays, a, 1024, "stack", any_hit,
                                        ts.stream.max_depth))

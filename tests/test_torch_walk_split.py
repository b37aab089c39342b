"""The decomposition of the interleaved skip walk's kernel (algo="skip2",
"ilvN"; ``csrc/stream_walk_ilv.cu`` ``stream_walk_ilv_split_kernel``),
emulated step by step on the CPU and held ``torch.equal`` to
``stream_walk_plain`` (t, record, u, v and the per-packet visits):

- one packet a work item, its lanes spread over a cluster of C blocks:
  each block ranks the packet's active lanes with the same scan (thread i
  reads lanes j * T + i, in j order: ranks go thread by thread) and takes
  ranks [s n / C, (s + 1) n / C); inactive lanes return (t_max, -1, 0, 0);
- one vote a block a step (a node row: some live ray of the block hits
  some child box; a leaf row with any-hit: some active ray of the block
  still lacks a hit), the OR across the blocks, and the same cursor in
  every block: max(p + 1 or the skip link, p + 1), the any-hit stop at a
  leaf row when the OR is false;
- every block counts the same visits.

Each block has T = block_rays / C threads of one ray each (the kernel
runs C = 8; C = 1, 2 and 4 check that the function does not depend on C).
One case holds the emulation against ``surf_tpu``'s Pallas walk for ilv2
on the box scene, in interpret mode, with the gates of
tests/test_torch_schedules.py.
"""

import warnings
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.accel.pallas_wide import device_wide_trace, traverse_wide
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.compile import HostCompiled
from surf_tpu_torch.accel import stream
from surf_tpu_torch.accel.bits import nudge
from surf_tpu_torch.accel.leaf_rows import REC, TRIS
from surf_tpu_torch.accel.stream import pack_rays, traverse_stream
from surf_tpu_torch.accel.stream_walk import (_live, _slab8, nearest_records, parse_algo,
                                              stream_walk_plain)
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.compile import compile_scene

warnings.filterwarnings("ignore", category=RuntimeWarning)
torch.set_num_threads(1)

CPU = torch.device("cpu")
BLOCK = 512      # rays a packet here (the kernel takes 512, 1024 or 2048)
CLUSTERS = (1, 2, 4, 8)


def slices(act_p: torch.Tensor, cluster: int, threads: int) -> list:
    """The lanes of each block's rays, in rank order, for one packet's act:
    ranks go thread by thread (lane % T), then by j (lane // T)."""
    lanes = torch.arange(act_p.shape[0])
    order = lanes[torch.argsort(lanes % threads * act_p.shape[0] + lanes // threads)]
    live = order[act_p[order] != 0]
    n = live.shape[0]
    return [live[s * n // cluster:(s + 1) * n // cluster] for s in range(cluster)]


def split_emulation(stream_t, rays, act, block_rays, any_hit=False, cluster=1, trace=None):
    """The kernel's decomposition on the CPU: (t, rec, u, v, visits).  With
    ``trace`` (a dict), records per (packet, block) the step at which the
    block's last unfinished ray got its hit (any-hit), and each packet's
    steps."""
    threads = block_rays // cluster
    g = rays.shape[1] // block_rays
    act = act.reshape(g, block_rays)
    # [g, C, cap] lane of each block's ray q (-1: none)
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
    rows_i = stream_t.view(torch.int32)
    n_e = stream_t.shape[0]
    n_live = (act != 0).sum(1)
    p = torch.where(n_live > 0, 0, n_e)                      # one cursor a packet
    visits = torch.zeros(g, cluster, 2, dtype=torch.int32)   # counted in every block
    done_at = torch.full((g, cluster), -1)
    step = 0
    while bool((p < n_e).any()):
        valid = p < n_e
        pc = torch.where(valid, p, 0)
        rows = stream_t[pc]
        is_leaf = rows_i[pc, 9] == 1
        rows_b = rows.repeat_interleave(cluster, 0)           # each block reads the row
        leaf_b = is_leaf.repeat_interleave(cluster, 0)
        live = _live(on, best, any_hit)
        # a step without leaf rows (node rows) skips the triangle (box) tests
        leaves, nodes = torch.stack([(valid & is_leaf).any(), (valid & ~is_leaf).any()]).tolist()
        node_vote = torch.zeros(g * cluster, dtype=torch.bool)
        if nodes:
            node_vote = (_slab8(rows_b, o, inv, best[0]).any(1) & live).any(1)
        if leaves:
            # the blocks at a leaf row with a live ray test their rays
            sel = torch.nonzero(leaf_b & live.any(1)).squeeze(1)
            part = nearest_records(rows_b[sel].reshape(-1, TRIS, REC),
                                   pc.repeat_interleave(cluster)[sel] * TRIS, live[sel],
                                   tuple(x[sel] for x in o3), tuple(x[sel] for x in d3),
                                   tuple(x[sel] for x in best), any_hit)
            for x, y in zip(best, part):
                x[sel] = y
        unfinished = (on & (best[1] < 0)).any(1)
        vote = torch.where(leaf_b, unfinished & any_hit, node_vote).view(g, cluster)
        if trace is not None:
            first = (~unfinished.view(g, cluster)) & (done_at < 0) & valid[:, None]
            done_at[first] = step
        anyv = vote.any(1)                                    # the OR across the cluster
        nxt = torch.where(is_leaf | anyv, p + 1, rows_i[pc, 10])
        nxt = torch.maximum(nxt, p + 1)
        if any_hit:
            nxt = torch.where(is_leaf & ~anyv, n_e, nxt)
        visits[:, :, 0] += valid[:, None]
        visits[:, :, 1] += (valid & is_leaf)[:, None]
        p = torch.where(valid, nxt, p)
        step += 1
    assert (visits == visits[:, :1]).all()                   # every block counted alike
    if trace is not None:
        trace.update(done_at=done_at, steps=visits[:, 0, 0])
    n = rays.shape[1]
    out_t = rays[6].clone()
    out_r = torch.full((n,), -1, dtype=torch.int32)
    out_u = torch.zeros(n)
    out_v = torch.zeros(n)
    keep = on.reshape(-1)
    for out, x in zip((out_t, out_r, out_u, out_v), best):
        out[idx[keep]] = x.reshape(-1)[keep]
    v = visits[:, 0]
    return out_t, out_r, out_u, out_v, torch.stack([v[:, 0], v[:, 1], v[:, 0]], 1)


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


def _inside_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = (np.array([0, 1, 0]) + rng.uniform(-0.2, 0.2, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


# The packets, 512 rays each, t_max 6: 0-2 camera rays with 100%, 40% and
# 1% of them active; 3 all dead; 4 active only in lanes [0, 64), the first
# lane slice; 5 rays inside the room in random directions, t_max 1 (closest
# hit), or for any-hit t_max 1e30 and the first half a bundle towards -z
# that hits within a few rows; 6 camera rays, 100 of them pad rays
# (pack_rays).  For a cluster of C blocks packet 5's rays are laid out in
# the kernel's rank order, so that the first half are the rays of blocks
# [0, C / 2): block 0 finishes long before the packet.
PACKETS = 7
SKEW = 5


def _data(any_hit):
    n = PACKETS * BLOCK - 100
    o, d = _camera_rays(n, seed=11)
    rng = np.random.default_rng(12)
    act = np.ones(n, bool)
    act[BLOCK:2 * BLOCK] = rng.random(BLOCK) < 0.4
    act[2 * BLOCK:3 * BLOCK] = False
    act[2 * BLOCK + rng.choice(BLOCK, 5, replace=False)] = True
    act[3 * BLOCK:4 * BLOCK] = False
    act[4 * BLOCK + 64:5 * BLOCK] = False
    tmax = np.full(n, 6.0, np.float32)
    sl = slice(SKEW * BLOCK, (SKEW + 1) * BLOCK)
    o[sl], d[sl] = _inside_rays(BLOCK, seed=13)
    tmax[sl] = 1.0
    if any_hit:
        bundle = np.array([0, 0, -1]) + rng.uniform(-0.01, 0.01, (BLOCK // 2, 3))
        d[SKEW * BLOCK:SKEW * BLOCK + BLOCK // 2] = bundle / np.linalg.norm(bundle, axis=1,
                                                                            keepdims=True)
        tmax[sl] = 1e30
    return pack_rays(*(torch.from_numpy(x) for x in (o, d, tmax, act)), BLOCK)


def _rank_layout(cluster):
    """Lanes of packet 5 (all active) in the kernel's rank order for C."""
    return SKEW * BLOCK + slices(torch.ones(BLOCK, dtype=torch.int32), 1, BLOCK // cluster)[0]


@pytest.fixture(scope="module")
def plain(indoor):
    """(rays, act, stream_walk_plain's ilv2 result) per any_hit."""
    cache = {}

    def get(any_hit):
        if any_hit not in cache:
            rays, a = _data(any_hit)
            cache[any_hit] = (rays, a, stream_walk_plain(indoor.stream.stream, rays, a, BLOCK,
                                                         "ilv2", any_hit))
        return cache[any_hit]
    return get


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_split_matches_plain(indoor, plain, cluster, any_hit):
    rays, a, want = plain(any_hit)
    # packet 5's ray q to its rank-q lane; the walk does not depend on where
    # a packet's rays lie, so the plain result moves with them
    dst = _rank_layout(cluster)
    src = torch.arange(SKEW * BLOCK, (SKEW + 1) * BLOCK)
    rays_c, a_c = rays.clone(), a.clone()
    rays_c[:, dst], a_c[dst] = rays[:, src], a[src]
    trace = {}
    got = split_emulation(indoor.stream.stream, rays_c, a_c, BLOCK, any_hit, cluster, trace)
    got = list(got)
    for k in range(4):
        moved = got[k].clone()
        moved[src] = got[k][dst]
        got[k] = moved
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    visits = got[4]
    assert visits[3].tolist() == [0, 0, 0] and (visits[[0, 1, 2, 4, 5, 6], 0] > 0).all()
    assert (got[1][3 * BLOCK:4 * BLOCK] == -1).all() and (got[1] >= 0).any()
    assert torch.equal(got[0][-100:], rays[6, -100:]) and (got[1][-100:] == -1).all()
    if any_hit and cluster > 1:
        # block 0 of packet 5 had every ray hit, many rows before the packet ended
        done = trace["done_at"][SKEW]
        assert 0 <= int(done[0]) < int(trace["steps"][SKEW]) - 10
        assert int(done[-1]) < 0 or int(done[-1]) > int(done[0])


def test_split_live_shares(plain):
    """The data hold the live shares the kernel is tested at."""
    _, a, _ = plain(False)
    share = a.view(PACKETS, BLOCK).float().mean(1).tolist()
    assert share[0] == 1.0 and 0.3 < share[1] < 0.5 and share[2] == 5 / BLOCK
    assert share[3] == 0.0 and share[4] == 64 / BLOCK and share[6] == 412 / BLOCK


def test_split_matches_jax_ilv2():
    """Box scene, 2048 rays in 1024-ray packets, closest hit: the emulation
    (C = 4) through traverse_stream against surf_tpu's ilv2 Pallas walk in
    interpret mode, hits and per-packet visits (tests/test_torch_schedules.py
    test_schedule_matches_jax's rays and gates)."""
    host = HostCompiled(jbuiltin.make_diffuse_box_scene())
    wt = device_wide_trace(host._ws)
    ts = compile_scene(builtin.make_diffuse_box_scene(), CPU)
    n = 2048
    rng = np.random.default_rng(7)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:3] = [[1, 0, 0], [0, -1, 0], [0, 0, 1]]
    tmax = np.full(n, 1e30, np.float32)
    act = np.ones(n, bool)
    act[::7] = False
    assert parse_algo("ilv2") == ("ilv", 2)

    def emulated(stream_t, rays, a, block_rays, algo, any_hit, max_depth):
        return split_emulation(stream_t, rays, a, block_rays, any_hit, cluster=4)

    port = [torch.from_numpy(x) for x in (o, d, tmax, act)]
    kw = dict(block_rays=1024, algo="ilv2")
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
    assert ((gp == wp) | (gt == wt_)).all()
    both = (gp >= 0) & (wp >= 0)
    np.testing.assert_allclose(gt[both], wt_[both], rtol=5e-6)
    assert np.array_equal(visits.numpy(), np.asarray(want_visits))
    # the emulation equals the plain walk bit for bit on the same packets
    rays, a = pack_rays(port[0], nudge(port[1]), port[2], port[3], 1024)
    for x, y in zip(split_emulation(ts.stream.stream, rays, a, 1024, cluster=4),
                    stream_walk_plain(ts.stream.stream, rays, a, 1024, "ilv2")):
        assert torch.equal(x, y)

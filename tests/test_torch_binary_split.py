"""The decomposition of the binary walk's kernel (use_wide=False;
``csrc/bvh_walk_live.cu`` ``bvh_walk_live_kernel``), emulated step by step
on the CPU and held ``torch.equal`` to ``bvh_walk_plain`` (t, triangle
slot, u, v and the per-packet counts of nodes visited and triangle records
tested):

- live-ray compaction: the packet's active lanes ranked by one scan over
  the block's 512 threads (thread i reads lanes i and i + 512, in that
  order: ranks go thread by thread), rank q to thread q mod 512 (two rays
  a thread); inactive lanes return (t_max, -1, 0, 0);
- staging: a step reads its node record from the buffer of its parity, in
  which the step before staged the two records the cursor could take,
  dfs + 1 and the skip link; at a leaf it stages the leaf's triangle
  records into the leaf buffer of its parity, and the tests read them
  there;
- one vote a step, the block's OR of "some live ray hits the node's box";
  any-hit's stop folded into the next step: after a leaf's tests each
  warp flags whether some active ray of its threads still lacks a hit,
  and the step after ORs the flags and, if all are clear, ends the walk
  uncounted;
- the successor: dfs + 1 on a hit internal node, else the skip link, never
  backwards.
"""

import warnings

import numpy as np
import pytest
import torch

from surf_tpu_torch.accel.bvh_walk import BLOCK, MAX_LEAF, bvh_walk, bvh_walk_plain
from surf_tpu_torch.accel.leaf_rows import REC, mt_records
from surf_tpu_torch.accel.stream import pack_rays
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.compile import compile_scene

warnings.filterwarnings("ignore", category=RuntimeWarning)
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _c_min(a, b):
    return torch.where(a < b, a, b)


def _c_max(a, b):
    return torch.where(a > b, a, b)


THREADS = 512                    # the kernel's block: two rays a thread
WARPS = THREADS // 32


def ranked_lanes(act_p: torch.Tensor) -> torch.Tensor:
    """The packet's active lanes in rank order: thread i scans lanes i and
    i + THREADS."""
    lanes = torch.arange(act_p.shape[0])
    order = lanes[torch.argsort(lanes % THREADS * act_p.shape[0] + lanes // THREADS)]
    return order[act_p[order] != 0]


class Rays:
    """The packet's live rays, the state a thread keeps in registers."""

    def __init__(self, rays, lanes):
        self.lanes = lanes
        self.o = tuple(rays[c, lanes] for c in range(3))
        self.d = tuple(rays[c, lanes] for c in range(3, 6))
        self.inv = tuple(1.0 / x for x in self.d)
        self.t = rays[6, lanes].clone()
        self.p = torch.full_like(lanes, -1, dtype=torch.int32)
        self.u = torch.zeros_like(self.t)
        self.v = torch.zeros_like(self.t)

    def live(self, any_hit):
        return self.p < 0 if any_hit else torch.ones_like(self.p, dtype=torch.bool)

    def slab(self, rec):
        """The C-style slab test of every ray against the record's box."""
        tmin = tmax = None
        for c in range(3):
            tn = (rec[c] - self.o[c]) * self.inv[c]
            tf = (rec[3 + c] - self.o[c]) * self.inv[c]
            lo, hi = _c_min(tn, tf), _c_max(tn, tf)
            tmin = lo if tmin is None else _c_max(tmin, lo)
            tmax = hi if tmax is None else _c_min(tmax, hi)
        return (tmax >= tmin) & (tmin < self.t) & (tmax > 0.0)

    def leaf_tests(self, tri_buf, leaf_first, any_hit):
        """The staged triangles in order, strictly-closer updates (any-hit:
        a ray stops at its first hit)."""
        rec = torch.zeros(tri_buf.shape[0], REC)
        rec[:, :12] = tri_buf
        t, u, v, ok = mt_records(rec, tuple(x[:, None] for x in self.o),
                                 tuple(x[:, None] for x in self.d))   # [rays, triangles]
        for k in range(tri_buf.shape[0]):
            hit = ok[:, k] & (t[:, k] < self.t) & self.live(any_hit)
            self.t = torch.where(hit, t[:, k], self.t)
            self.p = torch.where(hit, leaf_first + k, self.p).to(torch.int32)
            self.u = torch.where(hit, u[:, k], self.u)
            self.v = torch.where(hit, v[:, k], self.v)


def split_emulation(nodes, tris, n_nodes, rays, act, any_hit=False, trace=None):
    """bvh_walk_live_kernel's decomposition on the CPU: (t, p, u, v, counts)."""
    g = rays.shape[1] // BLOCK
    recs = nodes.reshape(-1, REC)
    tri_recs = tris.reshape(-1, REC)
    out_t = rays[6].clone()           # inactive lanes: (t_max, -1, 0, 0)
    out_p = torch.full((rays.shape[1],), -1, dtype=torch.int32)
    out_u = torch.zeros(rays.shape[1])
    out_v = torch.zeros(rays.shape[1])
    counts = torch.zeros(g, 2, dtype=torch.int32)
    for q in range(g):
        first = q * BLOCK
        ray = Rays(rays, first + ranked_lanes(act[first:first + BLOCK]))
        n_live = ray.lanes.numel()
        warp = torch.arange(n_live) % THREADS // 32     # rank q: thread q mod THREADS
        staged = {(0, 0): recs[0, :12].clone()}   # (parity, slot): a staged record
        leaf_buf = {}
        flags = None                              # the last step's leaf: flags to read
        dfs = 0 if n_live > 0 else n_nodes
        sel = step = visits = tests = 0
        while dfs < n_nodes:
            par = step & 1
            rec = staged.pop((par, sel))         # staged by the step before
            staged.pop((par, 1 - sel), None)
            rec_i = rec.view(torch.int32)
            leaf_first, leaf_count, skip = (int(x) for x in rec_i[6:9])
            n_tris = min(leaf_count, MAX_LEAF)
            is_leaf = leaf_count > 0
            if dfs + 1 < n_nodes:
                staged[(par ^ 1, 0)] = recs[dfs + 1, :12].clone()
            if dfs + 1 < skip < n_nodes:
                staged[(par ^ 1, 1)] = recs[skip, :12].clone()
            if is_leaf:
                leaf_buf[par] = tri_recs[leaf_first:leaf_first + n_tris, :12].clone()
            packet_hit = bool((ray.slab(rec) & ray.live(any_hit)).any())   # the block's OR
            if any_hit and flags is not None and not bool((flags > 0).any()):
                break                            # the last leaf gave every ray its hit
            flags = None
            if packet_hit and is_leaf:
                ray.leaf_tests(leaf_buf[par], leaf_first, any_hit)
                tests += n_tris
                flags = torch.zeros(WARPS, dtype=torch.int64)   # a flag a warp
                flags.index_add_(0, warp, ray.live(True).long())
            nxt = max(dfs + 1 if (packet_hit and not is_leaf) else skip, dfs + 1)
            sel = 0 if nxt == dfs + 1 else 1
            visits += 1
            step += 1
            dfs = nxt
        out_t[ray.lanes], out_p[ray.lanes], out_u[ray.lanes], out_v[ray.lanes] = (
            ray.t, ray.p, ray.u, ray.v)
        counts[q] = torch.tensor([visits, tests])
        if trace is not None:
            trace.setdefault("steps", []).append(step)
    return out_t, out_p, out_u, out_v, counts


def _assert_equal(got, want):
    for name, x, y in zip(("t", "prim", "u", "v", "counts"), got, want):
        x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{name} differs at {int((x != y).sum())} lanes"


# --- the data ---------------------------------------------------------------

SCENES = {"box": "make_diffuse_box_scene", "indoor": "make_indoor_scene"}
PACKETS = 4


@pytest.fixture(scope="module")
def scenes():
    return {k: compile_scene(getattr(builtin, make)(), CPU) for k, make in SCENES.items()}


def _data(scene: str, any_hit: bool):
    """Four packets of 1024 rays, the last 100 lanes pad rays: 0, camera
    rays (the indoor eye, or random rays through the box), all active;
    1, the same 40% active; 2, all dead; 3, rays from inside the room (box)
    in random directions, every one of which hits (t_max 1e30), with
    any-hit's first half a bundle towards -z.  t_max 6 elsewhere, 1e30 on
    the box."""
    n = PACKETS * BLOCK - 100
    rng = np.random.default_rng(31)
    if scene == "indoor":
        o = (np.array([0, 0, -7]) + rng.uniform(-0.05, 0.05, (n, 3))).astype(np.float32)
        tgt = np.concatenate([rng.uniform(-5, 5, (n, 2)), np.zeros((n, 1))], 1)
        d = tgt - o
        inside, tmax_v = np.array([0, 1, 0]), 6.0
    else:
        o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3))
        inside, tmax_v = np.array([0, 0, 0]), 1e30
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[0] = [0, 0, 1]  # zero components: 1/0 = inf, not nudged
    act = np.ones(n, bool)
    act[BLOCK:2 * BLOCK] = rng.random(BLOCK) < 0.4
    act[2 * BLOCK:3 * BLOCK] = False
    tmax = np.full(n, tmax_v, np.float32)
    sl = slice(3 * BLOCK, n)
    m = n - 3 * BLOCK
    o[sl] = (inside + rng.uniform(-0.2, 0.2, (m, 3))).astype(np.float32)
    dd = rng.normal(size=(m, 3))
    if any_hit:
        dd[:m // 2] = np.array([0, 0, -1]) + rng.uniform(-0.01, 0.01, (m // 2, 3))
    d[sl] = (dd / np.linalg.norm(dd, axis=1, keepdims=True)).astype(np.float32)
    tmax[sl] = 1e30
    return pack_rays(*(torch.from_numpy(x) for x in (o, d, tmax, act)), BLOCK)


@pytest.fixture(scope="module")
def plain(scenes):
    """(scene, rays, act, bvh_walk_plain's result) per (scene, any_hit)."""
    cache = {}

    def get(scene, any_hit):
        if (scene, any_hit) not in cache:
            tr = scenes[scene].binary
            rays, a = _data(scene, any_hit)
            cache[scene, any_hit] = (tr, rays, a,
                                     bvh_walk_plain(tr.nodes, tr.tris, tr.n_nodes, rays, a,
                                                    any_hit))
        return cache[scene, any_hit]
    return get


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_split_matches_plain(plain, scene, any_hit):
    tr, rays, a, want = plain(scene, any_hit)
    trace = {}
    got = split_emulation(tr.nodes, tr.tris, tr.n_nodes, rays, a, any_hit, trace)
    _assert_equal(got, want)
    counts = got[4]
    assert counts[2].tolist() == [0, 0] and (counts[[0, 1, 3], 0] > 0).all()
    assert (counts[:, 1] > 0).any()
    assert (got[1][2 * BLOCK:3 * BLOCK] == -1).all()
    live3 = a[3 * BLOCK:] != 0
    assert (got[1][3 * BLOCK:][live3] >= 0).all()          # packet 3: every ray hits
    assert torch.equal(got[0][-100:], rays[6, -100:]) and (got[1][-100:] == -1).all()
    if any_hit:  # the packet whose rays all hit stops before the list's end
        assert trace["steps"][3] < tr.n_nodes and counts[3, 0] < counts[0, 0]


def test_wrapper_takes_the_plain_version_on_cpu(plain):
    """On CPU tensors bvh_walk is bvh_walk_plain (the kernel runs only on
    CUDA tensors)."""
    tr, rays, a, want = plain("box", False)
    _assert_equal(bvh_walk(tr.nodes, tr.tris, tr.n_nodes, rays, a), want)


def test_ranks_hand_every_active_lane_out_once():
    """The compaction's ranks: every active lane once, thread by thread
    (lanes i, i + 512)."""
    act = torch.zeros(BLOCK, dtype=torch.int32)
    act[torch.randperm(BLOCK, generator=torch.Generator().manual_seed(3))[:700]] = 1
    live = torch.nonzero(act)[:, 0]
    assert ranked_lanes(act).tolist() == sorted(live.tolist(), key=lambda x: (x % 512, x // 512))

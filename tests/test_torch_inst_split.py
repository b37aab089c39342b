"""The decomposition of the instanced leaf-row kernel (algo="twolevelp";
``csrc/inst_rows.cu`` ``inst_rows_live_kernel``), emulated step by step on
the CPU and held ``torch.equal`` to ``inst_rows_plain``:

- live-ray compaction: a lane is live when t_max > 1e-5 (NaN is not); the
  block of slice 0, work item 0 writes every dead lane's (t_max, -1, 0, 0,
  -1), and the live lanes of a packet are handed out 256 to a slice in lane
  order;
- row splits across the packet's segments: the packet's rows, segment
  after segment in instance order (a negative count: the mesh's rows8
  rows from its first table row), numbered by one position q and cut into
  chunks of K rows; with parts = min(splits, chunks) work items, item y
  tests chunks y, y + parts, ..., each row in its instance's object space,
  keeping the least (t, q x 8 + j) below t_max (what its strictly-closer
  updates in position order leave);
- the merge: each item's hit goes in as the inverted key ~(t bits << 32 |
  q x 8 + j) through a max, in any order of arrival; the last item decodes
  the key, finds q's instance and row, recomputes u and v with the same
  transform and record test, reads the slot from lane 9 (any-hit: slot 0,
  u = v = 0, t and instance kept), and resets the key.

One case holds the emulation, through ``traverse_instanced``, against
``surf_tpu``'s instanced Pallas kernel in interpret mode on
tests/test_torch_instanced.py's setup.
"""

import warnings
from unittest import mock

import numpy as np
import pytest
import torch

from surf_tpu_torch.accel import instanced
from surf_tpu_torch.accel.inst_rows import inst_rows, inst_rows_plain, object_rays
from surf_tpu_torch.accel.leaf_rows import (EPS, REC, SLOT_LANE, TRIS, _mt_ok, _mt_poly,
                                            mt_records)
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.compile import compile_scene

warnings.filterwarnings("ignore", category=RuntimeWarning)
torch.set_num_threads(1)

CPU = torch.device("cpu")
THREADS = 256  # rays of one slice (inst_rows_threads_per_block)
FAR = 1e30
WIDE = 2.0 ** 126  # |det| past the in-range reciprocal's range


def split_emulation(table, lists, counts, segs, inv, rays, block_rays, any_hit=False,
                    split_rows=32, splits=4, order_seed=0, trace=None):
    """inst_rows_live_kernel's decomposition on the CPU: (t, r, u, v, inst).
    A work item's running best after its strictly-closer updates in position
    order is the least (t, q x 8 + j) over its hits below t_max: here the
    least of the integer (t bits << 32 | q x 8 + j), chunk by chunk.  With
    ``trace`` (a dict), counts the rows tested whose determinant lies past
    the in-range reciprocal's range ("wide")."""
    g, n_inst = counts.shape
    E = table.shape[0]
    n = rays.shape[1]
    out_t = torch.full((n,), float("nan"))
    out_r = torch.full((n,), -7, dtype=torch.int32)
    out_u = torch.full((n,), float("nan"))
    out_v = torch.full((n,), float("nan"))
    out_i = torch.full((n,), -7, dtype=torch.int32)
    keys = np.zeros(n, np.uint64)  # the scratch, inverted keys: 0 = no hit
    recs = table.reshape(E, TRIS, REC)
    sids = table.view(torch.int32).reshape(E, TRIS, REC)[..., SLOT_LANE["mt"]]
    seg_off, row0, rows8 = segs.tolist()
    order = np.random.default_rng(order_seed)
    j8 = torch.arange(TRIS)
    if trace is not None:
        trace.setdefault("wide", 0)
    for p in range(g):
        # the packet's positions: instance and table row of each
        q_inst, q_row = [], []
        for i, c in enumerate(counts[p].tolist()):
            for k in range(rows8[i] if c < 0 else c):
                q_inst.append(i)
                q_row.append(row0[i] + k if c < 0 else int(lists[p, seg_off[i] + k]))
        total = len(q_inst)
        q_inst, q_row = torch.tensor(q_inst, dtype=torch.int64), torch.tensor(q_row)
        chunks = -(-total // split_rows)
        parts = max(1, min(splits, chunks))
        first = p * block_rays
        live = rays[6, first:first + block_rays] > EPS
        # slice 0, item 0 writes the dead lanes' start values
        dead = first + torch.nonzero(~live)[:, 0]
        out_t[dead] = rays[6, dead]
        out_r[dead] = -1
        out_u[dead] = 0.0
        out_v[dead] = 0.0
        out_i[dead] = -1
        lanes = first + torch.nonzero(live)[:, 0]  # rank order = lane order
        for s in range(-(-lanes.numel() // THREADS)):
            ray = lanes[s * THREADS:(s + 1) * THREADS]
            R = ray.numel()
            o, d, tm = rays[0:3, ray], rays[3:6, ray], rays[6, ray]
            # the rays in every instance's object space: [3, I, R]
            oi, di = object_rays(inv, o[:, None].expand(3, n_inst, R),
                                 d[:, None].expand(3, n_inst, R))
            for y in order.permutation(parts):  # work items arrive in any order
                best = torch.full((R,), torch.iinfo(torch.int64).max)
                for c in range(y, chunks, parts):
                    qs = torch.arange(c * split_rows, min(total, (c + 1) * split_rows))
                    ii = q_inst[qs]
                    oq = tuple(x[ii].T[:, :, None] for x in oi)      # [R, K, 1]
                    dq = tuple(x[ii].T[:, :, None] for x in di)
                    a, u, v, t = _mt_poly(recs[q_row[qs]][None], oq, dq)
                    hit = _mt_ok(a, u, v, t) & (t < tm[:, None, None])  # [R, K, 8]
                    pos = qs[:, None] * TRIS + j8
                    k64 = (t.view(torch.int32).long() << 32) | pos
                    k64 = torch.where(hit, k64, torch.iinfo(torch.int64).max)
                    best = torch.minimum(best, k64.flatten(1).amin(1))
                    if trace is not None:
                        trace["wide"] += int((a.abs() >= WIDE).any(0).any(1).sum())
                found = (best < torch.iinfo(torch.int64).max).numpy()
                idx = ray.numpy()[found]
                keys[idx] = np.maximum(keys[idx], ~best.numpy()[found].astype(np.uint64))
            # the last item to arrive: decode, recompute, reset
            k = keys[ray.numpy()]
            keys[ray.numpy()] = 0
            hit = torch.from_numpy(k != 0)
            kk = ~k
            t_hit = torch.from_numpy((kk >> np.uint64(32)).astype(np.uint32).view(np.int32))
            out_t[ray] = torch.where(hit, t_hit.view(torch.float32), tm)
            pos = torch.from_numpy((kk & np.uint64(0xFFFFFFFF)).astype(np.int64))
            q = torch.where(hit, pos // TRIS, 0).clamp(max=max(total - 1, 0))
            inst = q_inst[q] if total else torch.zeros(R, dtype=torch.int64)
            out_i[ray] = torch.where(hit, inst, -1).to(torch.int32)
            if any_hit:
                out_r[ray] = torch.where(hit, 0, -1).to(torch.int32)
                out_u[ray] = 0.0
                out_v[ray] = 0.0
                continue
            row = q_row[q] if total else torch.zeros(R, dtype=torch.int64)
            j = pos % TRIS
            ow, dw = object_rays(inv[inst], o[:, :, None], d[:, :, None])
            _, u, v, _ = mt_records(recs[row, j], tuple(ow[:, :, 0]), tuple(dw[:, :, 0]))
            out_r[ray] = torch.where(hit, sids[row, j], -1)
            out_u[ray] = torch.where(hit, u, 0.0)
            out_v[ray] = torch.where(hit, v, 0.0)
    assert not keys.any(), "the scratch must be left zero"
    assert (out_r != -7).all() and (out_i != -7).all(), "every lane must be written"
    return out_t, out_r, out_u, out_v, out_i


def _assert_equal(got, want):
    """torch.equal on the bits (a NaN t_max comes back as the same NaN)."""
    for name, g, w in zip(("t", "slot", "u", "v", "inst"), got, want):
        g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"{name} differs at {int((g != w).sum())} lanes"


# --- adversarial data -------------------------------------------------------

def _tri_record(v0, v1, v2, sid):
    rec = np.zeros(REC, np.float32)
    rec[0:3] = v0
    rec[3:6] = np.subtract(v1, v0)
    rec[6:9] = np.subtract(v2, v0)
    rec[9] = np.array([sid], np.int32).view(np.float32)[0]
    return rec


def _translate(tx, ty, tz):
    """The inverse 3x4 of a translation by (tx, ty, tz)."""
    return [1, 0, 0, -tx, 0, 1, 0, -ty, 0, 0, 1, -tz]


# Instances of two 8-row meshes: (mesh, inverse 3x4).  Instance 2 repeats
# instance 0 (equal t: the lower instance must win); 4 places mesh 1 as it
# is, whose row 1 holds a triangle of edges 1.2e19 across the rays' path.
INSTANCES = [(0, _translate(0, 0, 0)), (1, _translate(3, 0, 0)), (0, _translate(0, 0, 0)),
             (0, [2, 0, 0, 0, 0, 0.5, 0, 0, 0, 0, 1, -1]), (1, _translate(0, 0, 0))]
CAP = 4    # listed rows a (packet, instance) at most: more sweep the mesh
COUNTS = [[3, -1, 2, 0, 4],     # lists, a sweep between them, a skipped instance
          [0, 0, 0, 0, 0],      # no rows: live lanes keep t_max
          [-1, 0, -1, 1, -1],   # sweeps around a one-row list
          [4, 4, 4, 4, 4]]      # all lanes dead (t_max -FAR)
LISTS = {(0, 0): [1, 2, 4], (0, 2): [2, 6], (0, 4): [8, 9, 10, 15], (2, 3): [2],
         **{(3, i): [0, 1, 2, 3] if INSTANCES[i][0] == 0 else [8, 9, 10, 11]
            for i in range(5)}}


def adversarial(seed=0, live_share=1.0, block_rays=512):
    """(table, lists, counts, segs, inv, rays, block_rays) of four packets.

    Mesh 0 (table rows 0-7) holds a triangle X in the plane z = 0.5 at row
    2, j 3 (slot 100) and an inert (all-zero) row 5; mesh 1 (rows 8-15)
    holds, at row 9, j 1, a triangle of edges 1.2e19 in the plane z = 0.3
    (slot 200; |det| past 2^126) and an inert row 15; the other records are
    small triangles off the rays' path.  Rays aim at X from above and below.
    Packet 0 lists instances 0 and 2 (both reach X: equal t, instance 0
    must win), sweeps instance 1 between them and lists instance 4 (its
    wide triangle comes first from below); COUNTS has the rest.  t_max:
    live_share of the lanes at 1e30 and the rest -FAR, and in each packet
    lanes of 1e-5 (dead), 1.00001e-5 (live), 0, NaN, +inf and 2."""
    rng = np.random.default_rng(seed)
    E = 16
    table = np.zeros((E, TRIS, REC), np.float32)
    for r in range(E):
        for j in range(TRIS):
            c = np.array([rng.uniform(4, 8), rng.uniform(-2, 2), rng.uniform(-2, 2)])
            table[r, j] = _tri_record(c, c + rng.uniform(-1, 1, 3), c + rng.uniform(-1, 1, 3),
                                      r * TRIS + j)
    table[2, 3] = _tri_record([0.0, -0.5, 0.5], [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5], 100)
    table[9, 1] = _tri_record([-1.0, -1.0, 0.3], [1.2e19, -1.0, 0.3], [-1.0, 1.2e19, 0.3], 200)
    table[5] = 0.0
    table[15] = 0.0
    table = torch.from_numpy(table.reshape(E, 128))

    n_inst = len(INSTANCES)
    segs = torch.tensor([[CAP * i for i in range(n_inst)],
                         [8 * m for m, _ in INSTANCES], [8] * n_inst], dtype=torch.int32)
    inv = torch.tensor([a for _, a in INSTANCES], dtype=torch.float32)
    g = len(COUNTS)
    lists = np.full((g, CAP * n_inst), 5, np.int32)  # padded with an inert row
    for (p, i), rows in LISTS.items():
        lists[p, CAP * i:CAP * i + len(rows)] = rows
    counts = torch.tensor(COUNTS, dtype=torch.int32)

    R = block_rays
    n = g * R
    rng_t = np.random.default_rng(seed + 1)
    aim = np.stack([rng_t.uniform(-0.2, 0.2, n), rng_t.uniform(0.0, 0.4, n),
                    np.full(n, 0.5)], 1)
    side = np.where(rng_t.random(n) < 0.5, -1.0, 1.0)
    o = aim + np.stack([rng_t.normal(0, 0.3, n), rng_t.normal(0, 0.3, n),
                        side * rng_t.uniform(0.5, 3.0, n)], 1)
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.where(rng_t.random(n) < live_share, FAR, -FAR).astype(np.float32)
    for k, val in enumerate((1e-5, 1.00001e-5, 0.0, np.nan, np.inf, 2.0)):
        tm[7 + k::50] = val
    tm[3 * R:] = -FAR                            # packet 3: all dead
    rays = np.concatenate([o.T, d.T, tm[None]]).astype(np.float32)
    return (table, torch.from_numpy(lists), counts, segs, inv,
            torch.from_numpy(rays).contiguous(), R)


LIVE_SHARES = [0.0, 0.01, 0.4, 1.0]


@pytest.mark.parametrize("live_share", LIVE_SHARES)
@pytest.mark.parametrize("split_rows", [1, 16, 32])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_emulation_matches_plain_on_adversarial_data(any_hit, split_rows, live_share):
    data = adversarial(live_share=live_share)
    want = inst_rows_plain(*data, any_hit)
    for splits in (1, 3, 64):
        trace = {}
        got = split_emulation(*data, any_hit, split_rows=split_rows, splits=splits,
                              order_seed=split_rows + splits, trace=trace)
        _assert_equal(got, want)
        assert live_share == 0.0 or trace["wide"] > 0


def test_adversarial_data_exercises_every_case():
    """The data hold what they promise: instance 0 wins X over its copy
    (instance 2) at equal t, the wide triangle (instance 4, slot 200) comes
    first from below, a list of 0 rows keeps t_max, the all-dead packet
    and the dead and NaN t_max keep their start values."""
    table, lists, counts, segs, inv, rays, R = adversarial()
    t, r, u, v, i = inst_rows_plain(table, lists, counts, segs, inv, rays, R)
    x = (r[:R] == 100)
    assert x.sum() > 50 and (i[:R][x] == 0).all()          # never instance 2
    below = r[:R] == 200
    assert below.sum() > 50 and (i[:R][below] == 4).all()
    # X through instance 2 alone gives the same t: the tie is exact
    solo = counts.clone()
    solo[0] = torch.tensor([0, 0, 2, 0, 0], dtype=torch.int32)
    t2, r2, _, _, i2 = inst_rows_plain(table, lists, solo, segs, inv, rays, R)
    both = x & (r2[:R] == 100)
    assert both.sum() > 50 and torch.equal(t[:R][both], t2[:R][both])
    assert (i2[:R][both] == 2).all()
    assert (r[R:2 * R] == -1).all() and (i[R:2 * R] == -1).all()
    live1 = rays[6, R:2 * R] > EPS
    assert torch.equal(t[R:2 * R][live1], rays[6, R:2 * R][live1])
    assert (r[3 * R:] == -1).all() and torch.equal(t[3 * R:], rays[6, 3 * R:])
    for lane in (7, 9, 10):
        assert r[lane] == -1 and i[lane] == -1 and u[lane] == 0 and v[lane] == 0
    assert torch.isnan(t[10]) and t[7] == 1e-5


# --- the stress scene's packets ---------------------------------------------

SWEEP_CAP = 32  # the sweep mode's inst_cap: some (packet, instance) lists overflow


def stress_packets(cap=None, any_hit=False, seed=2, block_rays=512):
    """The 32-instance stress scene (pure two-level; ``cap`` its inst_cap,
    SWEEP_CAP to force per-instance sweeps) and 4 packets of random rays
    from above the floor: the second all dead, the third 40% active; t_max
    1e30 (4 with any-hit).  Returns inst_rows' arguments."""
    ps = compile_scene(builtin.make_instanced_stress_scene(32), CPU, two_level="pure",
                       inst_cap=cap)
    n = 4 * block_rays
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1])
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = np.ones(n, bool)
    act[block_rays:2 * block_rays] = False
    act[2 * block_rays:3 * block_rays] = rng.random(block_rays) < 0.4
    tmax = torch.full((n,), 4.0 if any_hit else FAR)
    rays, lists, counts = instanced.prepare(ps.inst, torch.from_numpy(o), torch.from_numpy(d),
                                            tmax, torch.from_numpy(act), block_rays)
    return ps.inst.ltab, lists, counts, ps.inst.segs, ps.inst.inv, rays, block_rays


@pytest.fixture(scope="module")
def stress():
    """(inst_rows' arguments, inst_rows_plain's result) per mode."""
    cache = {}

    def get(mode):
        if mode not in cache:
            data = stress_packets(cap=SWEEP_CAP if mode == "sweep" else None,
                                  any_hit=mode == "any_hit")
            cache[mode] = data, inst_rows_plain(*data, mode == "any_hit")
        return cache[mode]
    return get


@pytest.mark.parametrize("split_rows", [1, 16, 32])
@pytest.mark.parametrize("mode", ["closest", "any_hit", "sweep"])
def test_emulation_matches_plain_on_stress_packets(stress, mode, split_rows):
    data, want = stress(mode)
    counts, R = data[2], data[6]
    assert (counts < 0).any() == (mode == "sweep") and (counts > 0).any()
    got = split_emulation(*data, mode == "any_hit", split_rows=split_rows, splits=4,
                          order_seed=split_rows)
    _assert_equal(got, want)
    assert (want[1][R:2 * R] == -1).all() and (want[1] >= 0).any()


def test_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors inst_rows is inst_rows_plain (the kernel runs only on
    CUDA tensors)."""
    data = adversarial()
    for any_hit in (False, True):
        _assert_equal(inst_rows(*data, any_hit), inst_rows_plain(*data, any_hit))


# --- the instanced rows against the JAX kernel -------------------------------

def test_emulation_matches_jax_inst_rows():
    """tests/test_torch_instanced.py's setup (a cube and a plane, four
    instances) and rays: the emulation through traverse_instanced against
    surf_tpu's instanced Pallas kernel in interpret mode (unroll=1), closest
    hit (inst and prim equal, t within rtol 5e-6: XLA's CPU backend
    contracts multiply-adds) and any-hit (the same rays occluded)."""
    from surf_tpu.accel import pallas_instanced as jpi
    from surf_tpu.core import transform as jtf
    from surf_tpu.scene.mesh import make_cube, make_plane
    from surf_tpu_torch.core import transform as ptf
    from surf_tpu_torch.scene.instance import world_bounds

    xforms = [
        (0, jtf.identity()),
        (0, jtf.rotate(jtf.translate(jtf.identity(), [2.5, 0.5, 0.0]), 0.7, [0, 1, 0])),
        (0, jtf.scale(jtf.translate(jtf.identity(), [-2.0, 0.0, 1.0]), [1.5, 0.5, 1.0])),
        (1, jtf.scale(jtf.translate(jtf.identity(), [0.0, -1.0, 0.0]), [10, 1, 10])),
    ]
    cube, plane = make_cube(), make_plane()
    meshes = [(cube.v0, cube.v1, cube.v2), (plane.v0, plane.v1, plane.v2)]
    jhost = jpi.build_instanced_trace(meshes, [(m, x, None, None) for m, x in xforms])
    host = instanced.build_instanced_trace(
        meshes, [(m, ptf.inverse(x), *world_bounds(x, *meshes[m])) for m, x in xforms], CPU)
    rng = np.random.default_rng(3)
    n = 512
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    aim = rng.uniform(-2, 2, (n // 2, 3)).astype(np.float32)
    d[: n // 2] = aim - o[: n // 2]
    d[: n // 2] /= np.linalg.norm(d[: n // 2], axis=1, keepdims=True)
    act = np.ones(n, bool)

    def emulated(table, lists, counts, segs, inv, rays, block_rays, any_hit):
        return split_emulation(table, lists, counts, segs, inv, rays, block_rays, any_hit,
                               split_rows=16, splits=3)

    for any_hit, t in ((False, FAR), (True, 4.0)):
        tm = np.full(n, t, np.float32)
        args = [torch.from_numpy(x) for x in (o, d, tm, act)]
        with mock.patch.object(instanced, "inst_rows", emulated):
            hit = instanced.traverse_instanced(host.trace, *args, any_hit=any_hit,
                                               block_rays=1024)
        jh = jpi.traverse_instanced(jhost, o, d, tm, act, any_hit=any_hit, interpret=True,
                                    block_rays=1024, unroll=1)
        if any_hit:
            assert np.array_equal(hit.prim.numpy() >= 0, np.asarray(jh.prim) >= 0)
            assert 0.05 < (hit.prim.numpy() >= 0).mean() < 0.95
            continue
        assert (hit.inst.numpy() >= 0).mean() > 0.3
        assert np.array_equal(hit.inst.numpy(), np.asarray(jh.inst))
        assert np.array_equal(hit.prim.numpy(), np.asarray(jh.prim))
        m = hit.inst.numpy() >= 0
        np.testing.assert_allclose(hit.t.numpy()[m], np.asarray(jh.t)[m], rtol=5e-6, atol=0)
        # the emulation equals the plain version bit for bit on the same inputs
        rays, lists, counts = instanced.prepare(host.trace, *args, 1024)
        data = (host.trace.ltab, lists, counts, host.trace.segs, host.trace.inv, rays, 1024)
        _assert_equal(emulated(*data, False), inst_rows_plain(*data))

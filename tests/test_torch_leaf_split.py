"""The decomposition of the leaf-row kernel's f32 entry points
(``csrc/leaf_rows.cu`` ``leaf_rows_live_kernel``), emulated
step by step on the CPU and held ``torch.equal`` to ``leaf_rows_plain``:

- live-ray compaction: a lane is live when its start t (t_max, or the
  carry-in t) > 1e-5 (NaN is not); the
  block of slice 0, split 0 writes every dead lane's start value, and the
  live lanes of a list are handed out 256 to a slice in lane order;
- row splits: split y tests list positions [y K, y K + K) record by
  record with strictly-closer updates from the start t, carrying only (t,
  position); a list of 0 rows still has split 0;
- the merge: each split's hit goes in as the inverted key ~(t bits << 32 |
  position · 8 + j) (the trim: ~(t bits)) through a max, in any order of
  arrival; the last split decodes the key, recomputes u and v with the
  same record test on the winning record and reads the slot id from its
  lane 9, and resets the key.

The same emulation covers the kernel's other f32 entry points: Baldwin–Weber
records (the decode recomputes u and v with ``bw_records`` and reads the
slot id from lane 12), the ILP merge (each row's records tested against
+inf, the left-preferring min-tree, one strict < a row: the same (t,
position) key) and carry-in (the start t, r, u, v from an earlier call; a
lane is live when its start t > 1e-5).

One tie case also holds ``leaf_rows_plain`` (through ``traverse_bits``)
against ``surf_tpu``'s ``traverse_wide(algo="bitsru8")`` in interpret mode,
which pins the first-position tie rule to the JAX kernel's.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.accel.pallas_wide import WideTrace, traverse_wide
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.compile import HostCompiled
from surf_tpu_torch.accel import bits
from surf_tpu_torch.accel.leaf_rows import (EPS, RECORD_TESTS, REC, SLOT_LANE, TRIS, _min_tree,
                                            leaf_rows, leaf_rows_plain)
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.compile import compile_scene

from leaf_split_data import adversarial, bw_table, carry_starts

warnings.filterwarnings("ignore", category=RuntimeWarning)
torch.set_num_threads(1)

CPU = torch.device("cpu")
THREADS = 256  # rays of one slice (leaf_rows_threads_per_block)


def _key(t: torch.Tensor, pos: torch.Tensor, trim: bool) -> np.ndarray:
    """The inverted merge key of hits (t >= 1e-5 > 0, so its bits order as
    the values): ~(t bits << 32 | pos), or ~(t bits) for the trim."""
    tb = t.numpy().view(np.uint32).astype(np.uint64)
    k = tb if trim else (tb << np.uint64(32)) | pos.numpy().astype(np.uint64)
    return ~k


def split_emulation(table, lists, n_rows, rays, block_rays, trim=False, split_rows=32,
                    order_seed=0, record="mt", merge="seq", carry=None):
    """leaf_rows_live_kernel's decomposition on the CPU: (t, r, u, v)."""
    g = lists.shape[0]
    E = table.shape[0]
    n = rays.shape[1]
    test = RECORD_TESTS[record, "f32"]
    start = carry[0] if carry is not None else rays[6]
    out_t = torch.empty(n, dtype=torch.float32)
    out_r = torch.empty(n, dtype=torch.int32)
    out_u = torch.empty(n, dtype=torch.float32)
    out_v = torch.empty(n, dtype=torch.float32)
    keys = np.zeros(n, np.uint64)  # the scratch: 0 = no hit
    recs = table.reshape(E, TRIS, REC)
    sids = table.view(torch.int32).reshape(E, TRIS, REC)[..., SLOT_LANE[record]]

    def write_start(at):
        out_t[at] = start[at]
        out_r[at] = carry[1][at] if carry is not None else -1
        out_u[at] = carry[2][at] if carry is not None else 0.0
        out_v[at] = carry[3][at] if carry is not None else 0.0

    order = np.random.default_rng(order_seed)
    for p in range(g):
        first = p * block_rays
        count = int(n_rows[p])
        sweep = count < 0
        if sweep:
            count = E
        parts = max(1, -(-count // split_rows))
        live = start[first:first + block_rays] > EPS
        # slice 0, split 0 writes the dead lanes' start values
        write_start(first + torch.nonzero(~live)[:, 0])
        lanes = first + torch.nonzero(live)[:, 0]  # rank order = lane order
        for s in range(-(-lanes.numel() // THREADS)):
            ray = lanes[s * THREADS:(s + 1) * THREADS]
            o = tuple(rays[c, ray] for c in range(3))
            d = tuple(rays[c, ray] for c in range(3, 6))
            o1, d1 = tuple(x[:, None] for x in o), tuple(x[:, None] for x in d)
            t0 = start[ray]
            for y in order.permutation(parts):  # splits arrive in any order
                best_t = t0.clone()
                best_pos = torch.full_like(ray, -1)
                for pos in range(y * split_rows, min(count, (y + 1) * split_rows)):
                    row = pos if sweep else int(lists[p, pos])
                    t8, _, _, ok8 = test(recs[row], o1, d1)     # [rays, 8]
                    if merge == "seq":  # strictly-closer updates, record by record
                        for j in range(TRIS):
                            hit = ok8[:, j] & (t8[:, j] < best_t)
                            best_t = torch.where(hit, t8[:, j], best_t)
                            best_pos = torch.where(hit, pos * TRIS + j, best_pos)
                    else:  # the min-tree over tests against +inf, one strict <
                        cand = torch.where(ok8 & (t8 < torch.inf), t8, torch.inf)
                        tw, jw = _min_tree(cand)
                        hit = tw < best_t
                        best_t = torch.where(hit, tw, best_t)
                        best_pos = torch.where(hit, pos * TRIS + jw, best_pos)
                found = (best_t < t0).numpy()
                idx = ray.numpy()[found]
                keys[idx] = np.maximum(keys[idx], _key(best_t[found], best_pos[found], trim))
            # the last split to arrive: decode, recompute, reset
            k = keys[ray.numpy()]
            keys[ray.numpy()] = 0
            hit = torch.from_numpy(k != 0)
            write_start(ray[~hit])
            kk = ~k
            t_hit = torch.from_numpy((kk >> np.uint64(32) if not trim else kk)
                                     .astype(np.uint32).view(np.int32)).view(torch.float32)
            out_t[ray[hit]] = t_hit[hit]
            if trim:
                out_r[ray[hit]] = 0
                out_u[ray[hit]] = 0.0
                out_v[ray[hit]] = 0.0
                continue
            pos = torch.from_numpy((kk & np.uint64(0xFFFFFFFF)).astype(np.int64))
            pos = torch.where(hit, pos, 0)
            at = pos // TRIS
            row = at if sweep else lists[p].long()[at]
            j = pos % TRIS
            _, u, v, _ = test(recs[row, j], o, d)          # the winning record, per ray
            out_r[ray[hit]] = sids[row, j][hit]
            out_u[ray[hit]] = u[hit]
            out_v[ray[hit]] = v[hit]
    assert not keys.any(), "the scratch must be left zero"
    return out_t, out_r, out_u, out_v


def _assert_equal(got, want):
    """torch.equal on the bits (a NaN t_max comes back as the same NaN)."""
    for name, g, w in zip("truv", got, want):
        g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"{name} differs at {int((g != w).sum())} lanes"


# --- the indoor scene's packets ---------------------------------------------

@pytest.fixture(scope="module")
def indoor():
    return compile_scene(builtin.make_indoor_scene(), CPU)


def _indoor_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = np.ones(n, bool)
    act[1024:2048] = False                       # an all-dead packet
    act[2048:] = rng.random(n - 2048) < 0.4      # a packet 40% live
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(act)


@pytest.mark.parametrize("mode", ["closest", "any_hit", "sweep"])
def test_emulation_matches_plain_on_indoor_packets(indoor, mode):
    o, d, act = _indoor_rays(3 * 1024, seed=5)
    tmax = torch.full((o.shape[0],), 6.0 if mode == "any_hit" else 1e30)
    tmax[::97] = 1e-5     # live by the activity mask, dead by the t_max rule
    tmax[5::97] = float("nan")
    rays, lists, n_rows = bits.prepare(indoor.trace, o, d, tmax, act, 1024,
                                       cap_rows=8 if mode == "sweep" else 0)
    if mode == "sweep":
        assert (n_rows < 0).any()
    trim = mode == "any_hit"
    want = leaf_rows_plain(indoor.trace.ltab, lists, n_rows, rays, 1024, trim)
    got = split_emulation(indoor.trace.ltab, lists, n_rows, rays, 1024, trim,
                          split_rows=32)
    _assert_equal(got, want)
    assert (want[1][1024:2048] == -1).all() and (want[1] >= 0).any()


# --- adversarial data -------------------------------------------------------

K_SMALL = 4  # rows of a split in the adversarial cases: many splits


@pytest.mark.parametrize("live_share", [0.01, 0.4, 1.0])
@pytest.mark.parametrize("split_rows", [1, K_SMALL, 32])
@pytest.mark.parametrize("trim", [False, True], ids=["closest", "trim"])
def test_emulation_matches_plain_on_adversarial_data(trim, split_rows, live_share):
    table, lists, n_rows, rays, R = adversarial(live_share=live_share)
    want = leaf_rows_plain(table, lists, n_rows, rays, R, trim)
    got = split_emulation(table, lists, n_rows, rays, R, trim, split_rows=split_rows,
                          order_seed=split_rows)
    _assert_equal(got, want)


def test_adversarial_data_exercises_every_case():
    """The data hold what they promise: first-position wins among equal t
    (list 0: row 11 at position 1 before rows 5 and 6 either side of a
    split boundary), hits on a triangle with |det| past 2^126, 0-row list
    misses, sweep, all-dead packet, dead and barely-live t_max."""
    table, lists, n_rows, rays, R = adversarial()
    t, r, u, v = leaf_rows_plain(table, lists, n_rows, rays, R)
    tm = rays[6]
    dups = {1000, 1001, 1002, 1003, 1004}
    r0, r1, r3 = r[:R], r[R:2 * R], r[3 * R:]
    # list 0 reaches X first through row 11 (position 1): slot 1004
    assert (r0 == 1004).sum() > 100 and not (set(r0.tolist()) & (dups - {1004}))
    assert (r1 == -1).all()                     # packet 1 is all dead ...
    assert torch.equal(t[R:2 * R], tm[R:2 * R])
    assert (r[2 * R:3 * R] == -1).all()         # ... list 2 has 0 rows
    live2 = tm[2 * R:3 * R] > EPS
    assert torch.equal(t[2 * R:3 * R][live2], tm[2 * R:3 * R][live2])
    # rays from below X meet the triangle of |det| past 2^126 first
    assert (r0 == 2000).sum() > 50 and (r3 == 2000).sum() > 50 and not (r == 2001).any()
    # the sweep reaches X first through row 2, j 1
    assert (r3 == 1000).sum() > 100 and not (set(r3.tolist()) & (dups - {1000}))
    # dead by the t_max rule: start values; NaN stays NaN
    for lane in (7, 9, 10, 11):
        assert r[lane] == -1 and u[lane] == 0 and v[lane] == 0
    assert torch.isnan(t[11]) and t[7] == 1e-5


# --- Baldwin–Weber, the ILP merge and carry-in -----------------------------

# (record, merge, carry) of the live kernel's other f32 entry points.
VARIANTS = [("mt", "seq", True), ("mt", "ilp", False), ("mt", "ilp", True),
            ("bw", "seq", False), ("bw", "seq", True), ("bw", "ilp", False),
            ("bw", "ilp", True)]
CARRY_ROWS = 3  # round A's rows before a carry-in call


def _variant_call(table, lists, n_rows, rays, R, record, merge, carry, seed=0):
    """(args, kw) of a variant's call: without carry, or resuming after round
    A's first CARRY_ROWS rows of each list (sweeps whole in round A) with
    start t at the liveness rule's edges (``carry_starts``)."""
    kw = dict(record=record, merge=merge)
    if record == "bw":
        table = bw_table(table)
    if not carry:
        return (table, lists, n_rows, rays, R), kw
    n_a = torch.where(n_rows < 0, -1, n_rows.clamp(max=CARRY_ROWS)).to(torch.int32)
    kw["carry"] = carry_starts(*leaf_rows_plain(table, lists, n_a, rays, R, **kw), seed=seed)
    n_b = torch.where(n_rows < 0, 0, (n_rows - CARRY_ROWS).clamp(min=0)).to(torch.int32)
    return (table, lists[:, CARRY_ROWS:].contiguous(), n_b, rays, R), kw


@pytest.mark.parametrize("split_rows", [1, K_SMALL])
@pytest.mark.parametrize("record, merge, carry", VARIANTS)
def test_variant_emulation_matches_plain_on_adversarial_data(record, merge, carry, split_rows):
    """The live kernel's seven other entry points: Baldwin–Weber records
    (bw_table: |den| past 2^126 and inf too), the ILP merge (row 2 holds
    the least t twice, at j 1 and j 6: the first must win) and carry-in
    resumed from round A."""
    args, kw = _variant_call(*adversarial(seed=2, live_share=0.4), record, merge, carry,
                             seed=split_rows)
    want = leaf_rows_plain(*args, **kw)
    got = split_emulation(*args, split_rows=split_rows, order_seed=split_rows, **kw)
    _assert_equal(got, want)
    R = args[4]
    r3 = want[1][3 * R:]
    if not carry:  # the sweep reaches X first through row 2, j 1, never j 6
        assert (r3 == 1000).sum() > 20 and not (r3 == 1001).any()
        assert (want[1] == 2000).any()  # |det| or |den| past 2^126 hits


@pytest.mark.parametrize("record, merge, carry", [("bw", "ilp", False), ("mt", "ilp", True)])
def test_variant_emulation_matches_plain_on_indoor_packets(indoor, record, merge, carry):
    """The same on the indoor scene's lists, with a sweep."""
    o, d, act = _indoor_rays(3 * 1024, seed=6)
    rays, lists, n_rows = bits.prepare(indoor.trace, o, d, torch.full((o.shape[0],), 1e30),
                                       act, 1024, cap_rows=8)
    assert (n_rows < 0).any()
    table = indoor.trace.ltabw if record == "bw" else indoor.trace.ltab
    kw = dict(record=record, merge=merge)
    if carry:
        n_a = torch.where(n_rows < 0, -1, n_rows.clamp(max=2)).to(torch.int32)
        kw["carry"] = leaf_rows_plain(table, lists, n_a, rays, 1024, **kw)
        lists = lists[:, 2:].contiguous()
        n_rows = torch.where(n_rows < 0, 0, (n_rows - 2).clamp(min=0)).to(torch.int32)
    want = leaf_rows_plain(table, lists, n_rows, rays, 1024, **kw)
    _assert_equal(split_emulation(table, lists, n_rows, rays, 1024, **kw), want)
    assert (want[1] >= 0).any()


def test_emulation_matches_plain_on_a_one_list_call():
    """One packet: the split merge across every split of one list."""
    table, lists, n_rows, rays, R = adversarial(seed=3)
    args = (table, lists[:1], n_rows[:1], rays[:, :R].contiguous(), R)
    for trim in (False, True):
        _assert_equal(split_emulation(*args, trim, split_rows=K_SMALL),
                      leaf_rows_plain(*args, trim))


def test_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors leaf_rows is leaf_rows_plain (the kernel runs only on
    CUDA tensors)."""
    table, lists, n_rows, rays, R = adversarial()
    for trim in (False, True):
        _assert_equal(leaf_rows(table, lists, n_rows, rays, R, trim),
                      leaf_rows_plain(table, lists, n_rows, rays, R, trim))


# --- the tie rule against the JAX kernel ------------------------------------

def test_first_position_tie_matches_jax_bitsru8():
    """The box scene's leaf rows with triangle X (row 0, j 4) copied under
    other slot ids into row 0 j 6, row 2 j 1 and row 3 j 4, every box
    opened so every list holds every row: 16x16 rays aimed at X get X's own
    slot id from JAX's bitsru8 kernel (interpret mode), from the port's
    plain version and from the split emulation (K = 1 and 2), never a
    copy's."""
    host = HostCompiled(jbuiltin.make_diffuse_box_scene())
    tr = host.render_scene.trace
    ltab = np.array(tr.wide_ltab, np.float32).reshape(-1, TRIS, REC)
    x = ltab[0, 4].copy()
    x_sid = int(x[9:10].view(np.int32)[0])
    dups = (9001, 9002, 9003)
    for (r, j), sid in zip([(0, 6), (2, 1), (3, 4)], dups):
        ltab[r, j] = x
        ltab[r, j, 9:10] = np.array([sid], np.int32).view(np.float32)
    ltab = ltab.reshape(-1, 128)
    box_lo = np.full(np.shape(tr.wide_box_lo), -1e6, np.float32)
    box_hi = np.full(np.shape(tr.wide_box_hi), 1e6, np.float32)
    wt = WideTrace(tr.wide_stream, tr.wide_rec_slot, ltab=jnp.asarray(ltab),
                   ltabw=tr.wide_ltabw, lrec=tr.wide_lrec, box_lo=jnp.asarray(box_lo),
                   box_hi=jnp.asarray(box_hi), anc=tr.wide_anc,
                   inert_row=int(tr.wide_ltab.shape[0]) - 1)
    lt = bits.LeafTrace(torch.from_numpy(ltab), torch.from_numpy(np.array(tr.wide_ltabw)),
                        torch.from_numpy(box_lo), torch.from_numpy(box_hi),
                        torch.from_numpy(np.array(tr.wide_anc)), wt.inert_row)

    n = 16 * 16
    rng = np.random.default_rng(11)
    v0, e1, e2 = x[0:3], x[3:6], x[6:9]
    a, b = rng.uniform(0.05, 0.45, n), rng.uniform(0.05, 0.45, n)
    aim = v0 + a[:, None] * e1 + b[:, None] * e2
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm)
    side = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    o = (aim + side[:, None] * rng.uniform(0.05, 0.5, n)[:, None] * nrm
         + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 1e30, np.float32)
    act = np.ones(n, bool)

    want = traverse_wide(wt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
                         jnp.asarray(act), False, interpret=True, algo="bitsru8",
                         block_rays=1024)
    want = [np.asarray(w) for w in want]
    got = bits.traverse_bits(lt, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tmax), torch.from_numpy(act),
                             block_rays=1024)
    assert np.array_equal(got.prim.numpy(), want[0])
    assert (want[0] == x_sid).sum() > n // 2
    assert not set(want[0].tolist()) & set(dups)

    rays, lists, n_rows = bits.prepare(lt, torch.from_numpy(o), torch.from_numpy(d),
                                       torch.from_numpy(tmax), torch.from_numpy(act), 1024)
    assert int(n_rows[0]) == lt.anc.shape[0]    # every leaf row listed
    plain = leaf_rows_plain(lt.ltab, lists, n_rows, rays, 1024)
    assert np.array_equal(plain[1][:n].numpy(), want[0])
    for k in (1, 2):
        _assert_equal(split_emulation(lt.ltab, lists, n_rows, rays, 1024, split_rows=k),
                      plain)

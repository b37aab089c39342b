"""The hand-written kernels (leaf rows with every entry point, instanced leaf
rows, the stream walks with the TPU schedules, the binary walk, the
dependent-cursor, leaf-row, walk-visit, visit-shape, matrix-unit and
op-cost microbenchmarks) against their plain PyTorch versions, on the card.
These tests need an NVIDIA GPU with nvcc and skip elsewhere.  They import
no JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX).  The kernels are built
with --fmad=false, so each and its plain version round every op alike and
must agree bit for bit; the matrix-unit kernels' tensor-core dots are
held by their gates (micro/_mxu.py MXU_GATE, BF16_GATE).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from surf_tpu_torch.accel import (_build, bits, bvh_walk, inst_rows, instanced, stream,
                                  stream_walk)
from surf_tpu_torch.accel.leaf_rows import (ENTRY_POINTS, LAUNCHES, leaf_rows,
                                            leaf_rows_plain, reset_launches)
from surf_tpu_torch.micro import (_mxu, cond_visit, dep_chain, lane_extract, lane_splat,
                                  leaf_groups, leaf_visit, mask_reduce, mxu_parts, mxu_pltd,
                                  mxu_tiles, quant_visit, spec_visit, stack_visit, visit_bodies,
                                  visit_cost, visit_parts, walk_interleave)
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams
from surf_tpu_torch.scene.compile import compile_scene
from surf_tpu_torch.wavefront.integrator import (RenderConfig, initial_seeds,
                                                 render_frame_seeded)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def indoor(cuda):
    return compile_scene(builtin.make_indoor_scene(), cuda)


def _rays(n, seed, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = rng.random(n) < 0.9
    act[2048:4096] = False  # one all-dead packet
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device),
            torch.from_numpy(act).to(device))


@pytest.mark.parametrize("mode", ["closest", "any_hit", "sweep"])
def test_kernel_matches_plain_bit_exact(indoor, cuda, mode):
    o, d, act = _rays(3 * 2048, seed=1, device=cuda)
    tmax = torch.full((o.shape[0],), 6.0 if mode == "any_hit" else 1e30, device=cuda)
    rays, lists, n_rows = bits.prepare(indoor.trace, o, d, tmax, act, 2048,
                                       cap_rows=8 if mode == "sweep" else 0)
    if mode == "sweep":
        assert (n_rows == -1).any()
    any_hit = mode == "any_hit"
    got = leaf_rows(indoor.trace.ltab, lists, n_rows, rays, 2048, any_hit)
    want = leaf_rows_plain(indoor.trace.ltab, lists, n_rows, rays, 2048, any_hit)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1][2048:4096] == -1).all()


def test_kernel_rejects_bad_inputs(indoor, cuda):
    lists = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    n_rows = torch.zeros(1, dtype=torch.int32, device=cuda)
    rays = torch.zeros(7, 2048, device=cuda)
    with pytest.raises(ValueError):
        leaf_rows(indoor.trace.ltab, lists, n_rows.cpu(), rays, 2048)
    with pytest.raises(ValueError):
        leaf_rows(indoor.trace.ltab, lists, n_rows, torch.zeros(7, 1000, device=cuda), 1000)


def test_render_through_kernel_matches_plain(indoor, cuda):
    """A 64x64 render with the bench knobs through the kernel equals the
    same render with the plain version swapped in, bit for bit, and the
    kernel's launch counts show both entry points ran."""
    cfg = RenderConfig.for_scene(indoor, 64, 64, 1, use_defocus=True)._replace(
        block_rays=2048, wave_limit=32, compact=True, compact_every=16,
        ladder=6, ladder_shrink=2, pixel_order="morton")
    cam = CameraParams.from_camera(builtin.make_indoor_camera(64, 64), cuda)
    reset_launches()
    img_k, seed_k = render_frame_seeded(indoor, cfg, cam, initial_seeds(cfg, 0, cuda))
    torch.cuda.synchronize()
    assert LAUNCHES["leaf_rows_closest"] > 0 and LAUNCHES["leaf_rows_any"] > 0
    with mock.patch.object(bits, "leaf_rows", leaf_rows_plain):
        img_p, seed_p = render_frame_seeded(indoor, cfg, cam, initial_seeds(cfg, 0, cuda))
    assert torch.isfinite(img_k).all() and (img_k >= 0).all()
    assert torch.equal(img_k, img_p)
    assert torch.equal(seed_k, seed_p)


# The entry points of leaf_rows.cu beyond the f32 sequential MT pair.
VARIANTS = [k for k in ENTRY_POINTS if k not in ("leaf_rows_closest", "leaf_rows_any")]
CARRY_ROWS = 16  # round A's rows before a carry-in call


@pytest.mark.parametrize("mode", ["closest", "any_hit", "sweep"])
@pytest.mark.parametrize("name", VARIANTS)
def test_variant_matches_plain_bit_exact(indoor, cuda, name, mode):
    """Each further entry point against its plain version on random rays,
    bit for bit.  A carry-in entry point resumes from a first call over
    each list's first CARRY_ROWS rows (the sweeps all in that call) over
    the rest of the list, and then also equals the one-call result."""
    record, merge, precision, carry, _ = ENTRY_POINTS[name]
    o, d, act = _rays(3 * 2048, seed=4, device=cuda)
    tmax = torch.full((o.shape[0],), 6.0 if mode == "any_hit" else 1e30, device=cuda)
    rays, lists, n_rows = bits.prepare(indoor.trace, o, d, tmax, act, 2048,
                                       cap_rows=8 if mode == "sweep" else 0)
    table = indoor.trace.ltabw if record == "bw" else indoor.trace.ltab
    kw = dict(record=record, merge=merge, precision=precision)
    whole = leaf_rows(table, lists, n_rows, rays, 2048, **kw) if carry else None
    c = None
    if carry:
        k = CARRY_ROWS
        n_a = torch.where(n_rows < 0, -1, n_rows.clamp(max=k)).to(torch.int32)
        c = leaf_rows(table, lists, n_a, rays, 2048, **kw)
        lists = lists[:, k:].contiguous()
        n_rows = torch.where(n_rows < 0, 0, (n_rows - k).clamp(min=0)).to(torch.int32)
    reset_launches()
    got = leaf_rows(table, lists, n_rows, rays, 2048, carry=c, **kw)
    want = leaf_rows_plain(table, lists, n_rows, rays, 2048, carry=c, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if carry:
        for g, w in zip(got, whole):
            assert torch.equal(g, w)
    assert (got[1][2048:4096] == -1).all() and (got[1] >= 0).any()


@pytest.mark.parametrize("record", ["mt", "bw"])
def test_ilp_merge_equals_sequential(indoor, cuda, record):
    """The ILP min-tree picks the sequential updates' winner, bit for bit."""
    o, d, act = _rays(3 * 2048, seed=5, device=cuda)
    rays, lists, n_rows = bits.prepare(indoor.trace, o, d, torch.full((o.shape[0],), 1e30,
                                                                     device=cuda), act, 2048)
    table = indoor.trace.ltabw if record == "bw" else indoor.trace.ltab
    seq = leaf_rows(table, lists, n_rows, rays, 2048, record=record)
    ilp = leaf_rows(table, lists, n_rows, rays, 2048, record=record, merge="ilp")
    for a, b in zip(seq, ilp):
        assert torch.equal(a, b)


def test_variant_rejects_unserved_combinations(indoor, cuda):
    lists = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    n_rows = torch.zeros(1, dtype=torch.int32, device=cuda)
    rays = torch.zeros(7, 2048, device=cuda)
    for kw in (dict(record="bw", precision="bf16"), dict(merge="ilp", precision="bf16"),
               dict(record="bw", trim=True), dict(precision="f16")):
        with pytest.raises(ValueError):
            leaf_rows(indoor.trace.ltab, lists, n_rows, rays, 2048, **kw)


@pytest.mark.parametrize("algo", ["bitsw", "bitsh", "bits2", "bitsp", "bits8", "bits2wi"])
def test_bits_render_through_kernel_matches_plain(indoor, cuda, algo):
    """A 64x64 render with the bench knobs through each algo's entry points
    equals the same render with the plain version swapped in, bit for
    bit."""
    cfg = RenderConfig.for_scene(indoor, 64, 64, 1, use_defocus=True)._replace(
        block_rays=2048, wave_limit=32, compact=True, compact_every=16,
        ladder=6, ladder_shrink=2, pixel_order="morton", algo=algo, pair_groups=2)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(64, 64), cuda)
    reset_launches()
    img_k, seed_k = render_frame_seeded(indoor, cfg, cam, initial_seeds(cfg, 0, cuda))
    torch.cuda.synchronize()
    assert sum(LAUNCHES.values()) > 0
    with mock.patch.object(bits, "leaf_rows", leaf_rows_plain):
        img_p, seed_p = render_frame_seeded(indoor, cfg, cam, initial_seeds(cfg, 0, cuda))
    assert torch.isfinite(img_k).all() and (img_k >= 0).all()
    assert torch.equal(img_k, img_p)
    assert torch.equal(seed_k, seed_p)


@pytest.fixture(scope="module")
def stress(cuda):
    """The 32-instance stress scene, pure two-level, twice: default caps,
    and inst_cap=8 so that lists overflow into per-instance sweeps."""
    scene = builtin.make_instanced_stress_scene(32)
    return {cap: compile_scene(scene, cuda, two_level="pure", inst_cap=cap)
            for cap in (None, 8)}


@pytest.mark.parametrize("mode", ["closest", "any_hit", "sweep"])
def test_inst_kernel_matches_plain_bit_exact(stress, cuda, mode):
    ps = stress[8 if mode == "sweep" else None]
    n = 3 * 2048
    rng = np.random.default_rng(2)
    o = torch.from_numpy(rng.uniform(-12, 12, (n, 3)).astype(np.float32)).to(cuda)
    o[:, 1] = o[:, 1].abs()
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(n, 3)).astype(np.float32)).to(cuda), dim=1)
    act = torch.ones(n, dtype=torch.bool, device=cuda)
    act[2048:4096] = False  # one all-dead packet
    tmax = torch.full((n,), 4.0 if mode == "any_hit" else 1e30, device=cuda)
    rays, lists, counts = instanced.prepare(ps.inst, o, d, tmax, act, 2048)
    if mode == "sweep":
        assert (counts < 0).any()
    args = (ps.inst.ltab, lists, counts, ps.inst.segs, ps.inst.inv, rays, 2048,
            mode == "any_hit")
    got = inst_rows.inst_rows(*args)
    want = inst_rows.inst_rows_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1][2048:4096] == -1).all() and (got[1] >= 0).any()


def test_twolevelp_render_through_kernel_matches_plain(stress, cuda):
    """A 64x64 twolevelp render through the instanced kernel equals the same
    render with the plain version swapped in, bit for bit."""
    ps = stress[None]
    cfg = RenderConfig.for_scene(ps, 64, 64, 1, use_defocus=True)._replace(
        block_rays=2048, wave_limit=32, compact=True, compact_every=16,
        ladder=6, ladder_shrink=2, pixel_order="morton")
    cam = CameraParams.from_camera(builtin.make_stress_camera(64, 64, 32), cuda)
    inst_rows.reset_launches()
    img_k, seed_k = render_frame_seeded(ps, cfg, cam, initial_seeds(cfg, 0, cuda))
    torch.cuda.synchronize()
    assert all(k > 0 for k in inst_rows.LAUNCHES.values())
    with mock.patch.object(instanced, "inst_rows", inst_rows.inst_rows_plain):
        img_p, seed_p = render_frame_seeded(ps, cfg, cam, initial_seeds(cfg, 0, cuda))
    assert torch.isfinite(img_k).all() and (img_k >= 0).all()
    assert torch.equal(img_k, img_p)
    assert torch.equal(seed_k, seed_p)


def _walk_rays(cuda, block):
    """3 packets and 500 rays (not a whole packet), the second packet all
    dead, through the traversals' own padding: (rays, act)."""
    o, d, act = _rays(3 * 2048 + 500, seed=3, device=cuda)
    act[block:2 * block] = False
    return o, d, act


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("algo", ["skip", "stack"])
def test_stream_walk_matches_plain_bit_exact(indoor, cuda, algo, any_hit):
    o, d, act = _walk_rays(cuda, 2048)
    tmax = torch.full((o.shape[0],), 6.0 if any_hit else 1e30, device=cuda)
    rays, a = stream.pack_rays(o, bits.nudge(d), tmax, act, 2048)
    args = (indoor.stream.stream, rays, a, 2048, algo, any_hit, indoor.stream.max_depth)
    stream_walk.reset_launches()
    got = stream_walk.stream_walk(*args)
    want = stream_walk.stream_walk_plain(*args)
    torch.cuda.synchronize()
    assert stream_walk.LAUNCHES[f"stream_walk_{algo}_{'any' if any_hit else 'closest'}"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    visits = got[4]
    assert visits.shape == (4, 3) and visits[1].tolist() == [0, 0, 0]
    assert (visits[[0, 2, 3], 1] > 0).all() and (got[1][2048:4096] == -1).all()
    assert torch.equal(visits[:, 0], visits[:, 2]) and (got[1] >= 0).any()


# The TPU schedules beyond those chip_smoke.py times (skip2, ilv2, ilv4,
# spec2, spec4, specb4, specb8): every ilvN, and the window's ends.
SCHEDULES = ["skip2", "ilv1", "ilv2", "ilv3", "ilv4", "spec1", "spec3", "spec8", "specb1",
             "specb5", "specb8"]


def _schedule_rays(cuda, block):
    """4 packets and 300 rays: random rays (90% active; ``_rays`` kills rays
    2048-4095), the second packet all dead, the third from inside the
    indoor room, where every ray hits (t_max 1e30 in any mode)."""
    o, d, act = _rays(4 * block + 300, seed=4, device=cuda)
    act[block:2 * block] = False
    act[2 * block:3 * block] = True
    rng = np.random.default_rng(5)
    o[2 * block:3 * block] = torch.from_numpy(
        (np.array([0, 1, 0]) + rng.uniform(-0.2, 0.2, (block, 3))).astype(np.float32)).to(cuda)
    return o, d, act


@pytest.mark.parametrize("block", [1024, 2048])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("algo", SCHEDULES)
def test_schedule_matches_plain_bit_exact(indoor, cuda, algo, any_hit, block):
    """Each schedule's entry point against its plain version, bit for bit
    with equal counts; skip2 / ilvN also equal to the skip kernel."""
    o, d, act = _schedule_rays(cuda, block)
    tmax = torch.full((o.shape[0],), 6.0 if any_hit else 1e30, device=cuda)
    tmax[2 * block:3 * block] = 1e30
    rays, a = stream.pack_rays(o, bits.nudge(d), tmax, act, block)
    args = (indoor.stream.stream, rays, a, block, algo, any_hit, indoor.stream.max_depth)
    walk, _ = stream_walk.parse_algo(algo)
    name = f"stream_walk_{walk}_{'any' if any_hit else 'closest'}"
    stream_walk.reset_launches()
    got = stream_walk.stream_walk(*args)
    torch.cuda.synchronize()
    assert stream_walk.LAUNCHES[name] == 1
    want = stream_walk.stream_walk_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    visits = got[4]
    assert visits.shape == (5, 3) and visits[1].tolist() == [0, 0, 0]
    assert (got[1][block:2 * block] == -1).all() and (got[1][2 * block:3 * block] >= 0).all()
    if walk == "ilv":
        skip = stream_walk.stream_walk(*args[:4], "skip", *args[5:])
        for g, w in zip(got, skip):
            assert torch.equal(g, w)


@pytest.mark.parametrize("variant", dep_chain.VARIANTS)
def test_dep_chain_matches_plain(cuda, variant):
    """The microbenchmark's kernel against its plain version at 512 rows,
    bit for bit (hits and the row the cursor ends at), and its launch
    count."""
    rows_b, rows_w, rays = dep_chain.make_data(cuda)
    table = rows_w if variant.startswith("depb") else rows_b
    dep_chain.reset_launches()
    got = dep_chain.dep_chain(table, rays, variant, dep_chain.CHECK_ROWS)
    torch.cuda.synchronize()
    assert dep_chain.LAUNCHES[f"dep_chain_{variant}"] == 1
    want = dep_chain.dep_chain_plain(table, rays, variant, dep_chain.CHECK_ROWS)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1] >= 0).any() == (variant != "dep0")


@pytest.mark.parametrize("variant", leaf_groups.VARIANTS)
def test_leaf_groups_matches_plain(cuda, variant):
    """The leaf-group kernel against its plain version at cap8 = 8, with
    per-packet counts 0..10 (0: no group; 9, 10: clamped to cap8), bit for
    bit, and its launch count."""
    data = leaf_groups.make_data(cuda)
    lists = data.lists[:, :8].contiguous()
    counts = (torch.arange(leaf_groups.PACKETS, device=cuda) % 11).to(torch.int32)
    args = (data.table, lists, counts, data.rays, data.t_max, variant, 8)
    leaf_groups.reset_launches()
    got = leaf_groups.leaf_groups(*args)
    torch.cuda.synchronize()
    assert leaf_groups.LAUNCHES[f"leaf_groups_{variant}"] == 1
    want = leaf_groups.leaf_groups_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1][0] == -1).all() and (got[1][1:] >= 0).any()


@pytest.mark.parametrize("variant", leaf_visit.VARIANTS)
@pytest.mark.parametrize("iters", [256, 200])
def test_leaf_visit_matches_plain(cuda, variant, iters):
    """The leaf-visit kernel against its plain version at 256 visits and at
    200 (224 visits: the loop tests p < iters every 32), bit for bit, or
    for recip within leaf_visit.RECIP_GATE; and its launch count."""
    table, rays = leaf_visit.make_data(cuda)
    leaf_visit.reset_launches()
    got = leaf_visit.leaf_visit(table, rays, variant, iters)
    torch.cuda.synchronize()
    assert leaf_visit.LAUNCHES[f"leaf_visit_{variant}"] == 1
    want = leaf_visit.leaf_visit_plain(table, rays, variant, iters)
    assert got[2].tolist() == want[2].tolist() == [-(-iters // 32) * 32]
    if variant == "recip":
        gate = leaf_visit.recip_gate(got, want)
        assert gate["ok"], gate
    else:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (got[1] >= 0).any() == (variant != "empty")


# Each walk-visit entry point: (module, wrapper, data makers, visits of the
# check; visit_cost's are rows, 520 of them wrap the 512-row table).
WALK_MICRO = {
    **{f"visit_cost_{v}": (visit_cost, visit_cost.visit_cost, (visit_cost.make_data,), 520, v)
       for v in visit_cost.VARIANTS},
    **{f"quant_visit_{v}": (quant_visit, quant_visit.quant_visit,
                            (quant_visit.make_data, quant_visit.make_jump_data), 200, v)
       for v in quant_visit.VARIANTS},
    **{f"stack_visit_{v}": (stack_visit, stack_visit.stack_visit, (stack_visit.make_data,), 32, v)
       for v in stack_visit.VARIANTS},
    **{f"mask_reduce_{v}": (mask_reduce, mask_reduce.mask_reduce,
                            (mask_reduce.make_data, mask_reduce.make_mixed_data), 200, v)
       for v in mask_reduce.VARIANTS},
}


@pytest.mark.parametrize("name", list(WALK_MICRO))
def test_walk_micro_matches_plain(cuda, name):
    """Each walk-visit microbenchmark kernel against its plain version (the
    wrapper on CPU tensors) on the script's data and on its test-only data,
    bit for bit, and its launch count."""
    mod, fn, makers, n, variant = WALK_MICRO[name]
    for make in makers:
        data = make(cuda)
        mod.reset_launches()
        got = fn(*data, variant, n)
        torch.cuda.synchronize()
        assert mod.LAUNCHES[name] == 1
        want = fn(*(x.cpu() for x in data), variant, n)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


# name: (module, wrapper, visit counts); visit_bodies also at
# the script's 2048, where wide_x's and smem_stack's values overflow.
SHAPE_MICRO = {
    **{f"visit_parts_{v}": (visit_parts, visit_parts.visit_parts, (64, 4096)) for v in
       visit_parts.VARIANTS},
    **{f"cond_visit_{v}": (cond_visit, cond_visit.cond_visit, (64, 2048)) for v in
       cond_visit.VARIANTS},
    **{f"visit_body_{v}": (visit_bodies, visit_bodies.visit_body, (32, 2048)) for v in
       visit_bodies.VARIANTS},
}


@pytest.mark.parametrize("name", list(SHAPE_MICRO))
def test_shape_micro_matches_plain(cuda, name):
    """Each visit-shape microbenchmark kernel against its plain version (the
    wrapper on CPU tensors) on the script's data and on the module's vote
    data, bit for bit, inf included, and its launch count."""
    mod, fn, counts = SHAPE_MICRO[name]
    variant = name.split("_", 2)[2]
    for make in (mod.make_data, mod.make_vote_data):
        data = make(cuda)
        for n in counts:
            mod.reset_launches()
            got = fn(*data, variant, n)
            torch.cuda.synchronize()
            assert mod.LAUNCHES[name] == 1
            want = fn(*(x.cpu() for x in data), variant, n)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)


def _mxu_cases(name, cuda):
    """(module, wrapper on (*data), the data sets, compare mode) of a
    matrix-unit entry point: the first 4 blocks of the script's data, the
    tmax data and, for mxu_tiles, the trips data."""
    if name.startswith("mxu_tiles"):
        case = [f"mxu_tiles{n}_{m}" for n, m in mxu_tiles.CASES].index(name)
        ntiles, mode = mxu_tiles.CASES[case]
        sets = [mxu_tiles.make_data(case, cuda, 4), mxu_tiles.make_trips_data(ntiles, cuda),
                mxu_tiles.make_tmax_data(case, cuda)]
        return mxu_tiles, lambda *d: mxu_tiles.mxu_tiles(*d, mode == "dyn"), sets, "epi"
    if name.startswith("mxu_parts"):
        v = name.split("_", 2)[2]
        sets = [mxu_parts.make_data(cuda, 4), mxu_parts.make_tmax_data(cuda)]
        return (mxu_parts, lambda *d: mxu_parts.mxu_parts(*d, v), sets,
                "exact" if v == "epionly" else mxu_parts.mode(v))
    return mxu_pltd, mxu_pltd.mxu_pltd, [mxu_pltd.make_data(cuda, 4),
                                         mxu_pltd.make_tmax_data(cuda)], "pltd"


@pytest.mark.parametrize("name", _build.MXU_ENTRY_POINTS)
def test_mxu_micro_matches_plain(cuda, name):
    """Each matrix-unit kernel against its plain version (the wrapper on CPU
    tensors) under its module gate, epionly bit for bit, one launch a
    call."""
    mod, fn, sets, mode = _mxu_cases(name, cuda)
    for data in sets:
        mod.reset_launches()
        got = fn(*data)
        torch.cuda.synchronize()
        assert mod.LAUNCHES[name] == 1
        cpu = [x.cpu() for x in data]
        want = fn(*cpu)
        got = [None if x is None else x.cpu() for x in got]
        res = (mxu_pltd.compare(got, want, cpu[0], cpu[1]) if mode == "pltd" else
               _mxu.compare(got, want, cpu[0], cpu[1], mode))
        assert res["ok"], res


def test_mxu_wrappers_reject_bad_inputs(cuda):
    """A CPU / CUDA mix and a tile count without an entry point raise."""
    rays, rows, tmax, trips = mxu_tiles.make_data(0, cuda, 2)
    with pytest.raises(ValueError):
        mxu_tiles.mxu_tiles(rays.cpu(), rows, tmax, trips, False)
    with pytest.raises(ValueError):
        mxu_tiles.mxu_tiles(rays, rows, tmax, trips.cpu(), True)
    with pytest.raises(ValueError):
        mxu_tiles.mxu_tiles(rays, rows[:, :3].contiguous(), tmax, trips, False)
    with pytest.raises(ValueError):
        mxu_parts.mxu_parts(rays, rows, tmax, "full")          # 8 tiles, not 16
    with pytest.raises(ValueError):
        mxu_pltd.mxu_pltd(*(x.cpu() if i == 2 else x for i, x in
                            enumerate(mxu_pltd.make_data(cuda, 2))))


# name: (module, wrapper, data makers, check size) of the op-cost micros;
# lane_splat's plain version is visit_parts' base.
OP_MICRO = {
    **{f"lane_splat_{v}": (lane_splat, lane_splat.lane_splat,
                           (lane_splat.make_data, visit_parts.make_vote_data), 64)
       for v in lane_splat.VARIANTS},
    **{f"lane_extract_{v}": (lane_extract, lane_extract.lane_extract,
                             (lane_extract.make_data, lane_extract.make_vote_data), 32)
       for v in lane_extract.VARIANTS},
    **{f"walk_interleave_{v}": (walk_interleave, walk_interleave.walk_interleave,
                                (walk_interleave.make_data, walk_interleave.make_vote_data), 32)
       for v in walk_interleave.VARIANTS},
    **{f"spec_visit_{v}": (spec_visit, spec_visit.spec_visit,
                           (spec_visit.make_data, spec_visit.make_jump_data), 512)
       for v in spec_visit.VARIANTS},
}


@pytest.mark.parametrize("name", list(OP_MICRO))
def test_op_micro_matches_plain(cuda, name):
    """Each op-cost microbenchmark kernel against its plain version (the
    wrapper on CPU tensors) on the script's data and on the module's
    test-only data at the check size, every output bit for bit, and its
    launch count."""
    mod, fn, makers, n = OP_MICRO[name]
    variant = name[len(mod.__name__.rsplit(".", 1)[1]) + 1:]
    for make in makers:
        data = make(cuda)
        mod.reset_launches()
        got = fn(*data, variant, n)
        torch.cuda.synchronize()
        assert mod.LAUNCHES[name] == 1
        want = fn(*(x.cpu() for x in data), variant, n)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_op_micro_wrappers_reject_bad_inputs(cuda):
    """A CPU / CUDA mix, a short x, an unknown variant and no visits raise."""
    table, x = lane_splat.make_data(cuda)
    with pytest.raises(ValueError):
        lane_splat.lane_splat(table.cpu(), x, "bcast_1x128", 8)
    with pytest.raises(ValueError):
        lane_extract.lane_extract(table, x[:512].contiguous(), "e8_v0", 16)
    with pytest.raises(ValueError):
        walk_interleave.walk_interleave(table, x, "inter3", 8)
    rows, rays = spec_visit.make_data(cuda)
    with pytest.raises(ValueError):
        spec_visit.spec_visit(rows, rays.cpu(), "w2", 64)
    with pytest.raises(ValueError):
        spec_visit.spec_visit(rows, rays, "cur", 0)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_bvh_walk_matches_plain_bit_exact(indoor, cuda, any_hit):
    o, d, act = _walk_rays(cuda, 1024)
    d[:3] = torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0]], device=cuda)  # 1/0
    tmax = torch.full((o.shape[0],), 6.0 if any_hit else 1e30, device=cuda)
    rays, a = stream.pack_rays(o, d, tmax, act, 1024)
    tr = indoor.binary
    args = (tr.nodes, tr.tris, tr.n_nodes, rays, a, any_hit)
    got = bvh_walk.bvh_walk(*args)
    want = bvh_walk.bvh_walk_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    counts = got[4]
    assert counts.shape == (7, 2) and counts[1].tolist() == [0, 0]
    assert (got[1][1024:2048] == -1).all() and (got[1] >= 0).any()


@pytest.mark.parametrize("walk", [dict(algo="skip"), dict(algo="stack"), dict(use_wide=False),
                                  dict(algo="ilv2"), dict(algo="spec4")],
                         ids=["skip", "stack", "binary", "ilv2", "spec4"])
def test_walk_render_through_kernel_matches_plain(indoor, cuda, walk):
    """A 64x64 render with the bench knobs but a wave cap of 8 (the plain
    walks take a second a call on the card) through each walk's kernel
    equals the same render with the plain version swapped in, bit for
    bit."""
    cfg = RenderConfig.for_scene(indoor, 64, 64, 1, use_defocus=True)._replace(
        block_rays=2048, wave_limit=8, compact=True, compact_every=16,
        ladder=6, ladder_shrink=2, pixel_order="morton", **walk)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(64, 64), cuda)
    mod, name, plain = ((bvh_walk, "bvh_walk", bvh_walk.bvh_walk_plain) if "use_wide" in walk
                        else (stream, "stream_walk", stream_walk.stream_walk_plain))
    counts = bvh_walk.LAUNCHES if "use_wide" in walk else stream_walk.LAUNCHES
    for k in counts:
        counts[k] = 0
    img_k, seed_k = render_frame_seeded(indoor, cfg, cam, initial_seeds(cfg, 0, cuda))
    torch.cuda.synchronize()
    assert sum(counts.values()) > 0
    with mock.patch.object(mod, name, plain):
        img_p, seed_p = render_frame_seeded(indoor, cfg, cam, initial_seeds(cfg, 0, cuda))
    assert torch.isfinite(img_k).all() and (img_k >= 0).all()
    assert torch.equal(img_k, img_p)
    assert torch.equal(seed_k, seed_p)

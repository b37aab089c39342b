"""The hand-written kernels (leaf rows with every entry point and their
first designs, the merge scratch of two streams at once, the packed bf16x2
ops, instanced leaf rows and their first design, the stream walks with the
TPU schedules and the first designs of skip, stack, ilvN and specN /
specbN, the binary walk and its first design, the SASS of the redesigned
kernels, the
dependent-cursor, leaf-row,
walk-visit, visit-shape, matrix-unit and op-cost microbenchmarks) against
their plain PyTorch versions, on the card.
These tests need an NVIDIA GPU with nvcc and skip elsewhere.  They import
no JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX).  The kernels are built
with --fmad=false, so each and its plain version round every op alike and
must agree bit for bit; the matrix-unit kernels' tensor-core dots are
held by their gates (micro/_mxu.py MXU_GATE, BF16_GATE).
"""

import ctypes
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch

from surf_tpu_torch.accel import (_build, bits, bvh_walk, inst_rows, instanced, stream,
                                  stream_walk)
from surf_tpu_torch.accel import leaf_rows as leaf_rows_mod
from surf_tpu_torch.accel.leaf_rows import (ENTRY_POINTS, FIRST_DESIGNS, LAUNCHES, leaf_rows,
                                            leaf_rows_first_design, leaf_rows_plain,
                                            reset_launches)
from surf_tpu_torch.micro import (_mxu, _visit, cond_visit, dep_chain, lane_extract, lane_splat,
                                  leaf_groups, leaf_visit, mask_reduce, mxu_parts, mxu_pltd,
                                  mxu_tiles, quant_visit, spec_visit, stack_visit, visit_bodies,
                                  visit_cost, visit_parts, walk_interleave)
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams
from surf_tpu_torch.scene.compile import compile_scene
from surf_tpu_torch.wavefront.integrator import (BENCH_KNOBS, RenderConfig, initial_seeds,
                                                 render_frame_seeded)

import test_torch_binary_split as binary_split
import test_torch_inst_split as inst_split
import test_torch_spec_split as spec_split
import test_torch_stack_split as stack_split
from leaf_split_data import adversarial, bf16_pairs, bf16_ties, bw_table, carry_starts

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


def _bits_equal(got, want):
    """Every output equal bit for bit (a NaN t_max comes back as itself)."""
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


LIVE_SHARES = [0.01, 0.4, 1.0]


@pytest.mark.parametrize("packets", [1, 4])
@pytest.mark.parametrize("split_rows", [1, 4, 32])
@pytest.mark.parametrize("live_share", LIVE_SHARES)
@pytest.mark.parametrize("trim", [False, True], ids=["closest", "any_hit"])
def test_live_kernel_matches_plain_on_adversarial_data(cuda, trim, live_share, split_rows,
                                                       packets):
    """leaf_rows_closest / leaf_rows_any (live compaction, row splits, the
    (t, position) merge) against the plain version and the first design's
    kernel: equal-t copies of one triangle either side of split
    boundaries, a 0-row list, a sweep, an all-dead packet, inert rows, dead
    and barely live t_max; one launch a call, and the merge's scratch left
    zero."""
    table, lists, n_rows, rays, R = (x.to(cuda) if torch.is_tensor(x) else x
                                     for x in adversarial(seed=7, live_share=live_share))
    lists, n_rows = lists[:packets].contiguous(), n_rows[:packets].contiguous()
    rays = rays[:, :packets * R].contiguous()
    args = (table, lists, n_rows, rays, R, trim)
    name = "leaf_rows_any" if trim else "leaf_rows_closest"
    reset_launches()
    with mock.patch.object(leaf_rows_mod, "split_rows", lambda n: split_rows):
        got = leaf_rows(*args)
    assert LAUNCHES[name] == 1
    old = leaf_rows_first_design(*args)
    assert LAUNCHES[name + "_pr1"] == 1
    want = leaf_rows_plain(*args)
    torch.cuda.synchronize()
    _bits_equal(got, want)
    _bits_equal(old, want)
    for x in leaf_rows_mod._SCRATCH[leaf_rows_mod.scratch_key(torch.device("cuda"))]:
        assert not bool(x.any())


@pytest.mark.parametrize("packets", [1, 4])
@pytest.mark.parametrize("live_share", LIVE_SHARES)
@pytest.mark.parametrize("mode", ["closest", "any_hit", "sweep"])
def test_live_kernel_matches_plain_on_indoor_packets(indoor, cuda, mode, live_share, packets):
    """The same on the indoor scene's lists, 2048-ray packets at three
    shares of live rays."""
    o, d, _ = _rays(packets * 2048, seed=3, device=cuda)
    act = torch.rand(o.shape[0], generator=torch.Generator().manual_seed(5)) < live_share
    act = act.to(cuda)
    tmax = torch.full((o.shape[0],), 6.0 if mode == "any_hit" else 1e30, device=cuda)
    rays, lists, n_rows = bits.prepare(indoor.trace, o, d, tmax, act, 2048,
                                       cap_rows=8 if mode == "sweep" else 0)
    args = (indoor.trace.ltab, lists, n_rows, rays, 2048, mode == "any_hit")
    got = leaf_rows(*args)
    old = leaf_rows_first_design(*args)
    want = leaf_rows_plain(*args)
    torch.cuda.synchronize()
    _bits_equal(got, want)
    _bits_equal(old, want)


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


def _carry_call(table, lists, n_rows, rays, R, kw, carry, rows_a=8):
    """(args, kw, one-call result) of a call of kind ``kw`` (record, merge,
    precision), without carry or resuming after round A's first ``rows_a``
    rows of each list (sweeps whole in round A)."""
    kw = dict(kw)
    if not carry:
        return (table, lists, n_rows, rays, R), kw, None
    whole = leaf_rows(table, lists, n_rows, rays, R, **kw)
    n_a = torch.where(n_rows < 0, -1, n_rows.clamp(max=rows_a)).to(torch.int32)
    kw["carry"] = leaf_rows(table, lists, n_a, rays, R, **kw)
    n_b = torch.where(n_rows < 0, 0, (n_rows - rows_a).clamp(min=0)).to(torch.int32)
    return (table, lists[:, rows_a:].contiguous(), n_b, rays, R), kw, whole


def _bf16_calls(table, lists, n_rows, rays, R, carry):
    """``_carry_call`` of a bf16 call."""
    return _carry_call(table, lists, n_rows, rays, R, dict(precision="bf16"), carry)


def _design_matches(args, kw, whole=None):
    """The entry point of a call against the plain version and its first
    design, bit for bit; one launch each; the merge's scratch left zero; a
    carry-in call equal to the one-call result (``whole``).  Returns the
    plain result."""
    name = leaf_rows_mod.entry_point(**{k: v for k, v in kw.items() if k != "carry"},
                                     carry="carry" in kw)
    reset_launches()
    got = leaf_rows(*args, **kw)
    old = leaf_rows_first_design(*args, **kw)
    want = leaf_rows_plain(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == 1 and LAUNCHES[FIRST_DESIGNS[name]] == 1
    assert sum(LAUNCHES.values()) == 2
    _bits_equal(got, want)
    _bits_equal(old, want)
    if whole is not None:
        _bits_equal(got, whole)
    for x in leaf_rows_mod._SCRATCH[leaf_rows_mod.scratch_key(torch.device("cuda"))]:
        assert not bool(x.any())
    return want


@pytest.mark.parametrize("carry", [False, True], ids=["no_carry", "carry"])
@pytest.mark.parametrize("block", [512, 1024, 2048])
@pytest.mark.parametrize("live_share", LIVE_SHARES)
@pytest.mark.parametrize("lists", [1, 4, 128])
def test_bf16_kernel_matches_plain_and_pr4(indoor, cuda, lists, live_share, block, carry):
    """leaf_rows_mt_bf16_closest / _carry_closest (compaction, row splits,
    the (t, position) merge, packed bf16x2 arithmetic) on the indoor
    scene's lists, 1-128 lists of 512-2048 rays at three live shares, and a
    sweep where a list overflows 64 rows."""
    n = lists * block
    o, d, _ = _rays(max(n, 4096), seed=8, device=cuda)
    o, d = o[:n], d[:n]
    act = (torch.rand(n, generator=torch.Generator().manual_seed(9)) < live_share).to(cuda)
    tmax = torch.full((n,), 1e30, device=cuda)
    rays, lst, n_rows = bits.prepare(indoor.trace, o, d, tmax, act, block, cap_rows=64)
    got = _design_matches(*_bf16_calls(indoor.trace.ltab, lst, n_rows, rays, block, carry))
    assert (got[1] >= 0).any()


@pytest.mark.parametrize("carry", [False, True], ids=["no_carry", "carry"])
@pytest.mark.parametrize("split_rows", [1, 16, 32])
@pytest.mark.parametrize("live_share", LIVE_SHARES)
@pytest.mark.parametrize("data", ["adversarial", "ties"])
def test_bf16_kernel_on_adversarial_and_tie_data(cuda, data, live_share, split_rows, carry):
    """The same on leaf_split_data's adversarial lists (|det| past 2^126,
    inert rows, 0-row lists, a sweep, an all-dead packet, dead and barely
    live t_max) and on its bf16 tie set (equal bf16 t at two positions
    within a pair, a row, across rows and across a split boundary: the
    first position wins), with carry-in start t at the liveness rule's
    edges (1e-5, 0, NaN, -inf dead; +inf, 1.00001e-5 live)."""
    make = adversarial if data == "adversarial" else bf16_ties
    table, lists, n_rows, rays, R = (x.to(cuda) if torch.is_tensor(x) else x
                                     for x in make(seed=3, live_share=live_share))
    args, kw, whole = _bf16_calls(table, lists, n_rows, rays, R, carry)
    if carry:
        kw["carry"] = carry_starts(*kw["carry"], seed=split_rows)
        whole = None
    with mock.patch.object(leaf_rows_mod, "split_rows", lambda n: split_rows):
        _design_matches(args, kw, whole)


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_bf16x2_ops_round_as_the_plain_version(cuda, op):
    """mul / add / sub.rn.bf16x2 through the probe kernel
    (leaf_rows_bf16x2_probe: csrc/mt.cuh's bmul2, badd2, bsub2 alone, one
    bf16x2 word a thread) equal the f32 op rounded to bf16 (the plain
    version's) bit for bit, on random bit patterns over every exponent,
    subnormals, ties, +-0, overflow and inf; a NaN comes out as a NaN (its
    payload may differ)."""
    x, y = bf16_pairs(4096, seed=len(op))
    probe = _build.library().leaf_rows_bf16x2_probe
    p, i = ctypes.c_void_p, ctypes.c_int
    probe.argtypes = [i, p, p, p, i, p]  # op, a, b, out, n words, stream
    probe.restype = i
    a = x.to(cuda).view(torch.int32)
    b = y.to(cuda).view(torch.int32)
    out = torch.empty_like(a)
    stream = ctypes.c_void_p(torch.cuda.current_stream(cuda).cuda_stream)
    assert probe(("mul", "add", "sub").index(op), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 a.numel(), stream) == 0
    got = out.view(torch.bfloat16).cpu()
    xf, yf = x.float(), y.float()
    want = {"mul": xf * yf, "add": xf + yf, "sub": xf - yf}[op].to(torch.bfloat16)
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    assert torch.equal(got[~nan].view(torch.int16), want[~nan].view(torch.int16))
    assert (want[~nan].float().abs() < 2.0 ** -126).any()


# The f32 entry points beyond the pair, on leaf_rows_live_kernel since the
# Baldwin–Weber, ILP and carry-in redesign; their first designs are _pr4.
F32_VARIANTS = [k for k in leaf_rows_mod.LIVE_ENTRY_POINTS
                if k not in ("leaf_rows_closest", "leaf_rows_any")]


def _variant_call(name, table, lists, n_rows, rays, R, rows_a=8):
    """``_carry_call`` of entry point ``name``."""
    record, merge, _, carry, _ = ENTRY_POINTS[name]
    return _carry_call(table, lists, n_rows, rays, R, dict(record=record, merge=merge), carry,
                       rows_a)


@pytest.mark.parametrize("block", [512, 2048])
@pytest.mark.parametrize("live_share", [0.0, 0.01, 0.4, 1.0])
@pytest.mark.parametrize("lists", [1, 4, 128])
@pytest.mark.parametrize("name", F32_VARIANTS)
def test_f32_live_kernel_matches_plain_and_pr4(indoor, cuda, name, lists, live_share, block):
    """leaf_rows_{mt,bw}[_ilp][_carry]_closest on leaf_rows_live_kernel
    (compaction, row splits, the (t, position) merge, the in-range
    reciprocal) against the plain version and the first design on the
    indoor scene's lists: 1-128 lists of 512 or 2048 rays, 0-100% live, a
    sweep where a list overflows 64 rows, carry-in resumed from round A."""
    n = lists * block
    o, d, _ = _rays(max(n, 4096), seed=10, device=cuda)
    o, d = o[:n], d[:n]
    act = (torch.rand(n, generator=torch.Generator().manual_seed(11)) < live_share).to(cuda)
    rays, lst, n_rows = bits.prepare(indoor.trace, o, d, torch.full((n,), 1e30, device=cuda),
                                     act, block, cap_rows=64)
    table = indoor.trace.ltabw if ENTRY_POINTS[name][0] == "bw" else indoor.trace.ltab
    want = _design_matches(*_variant_call(name, table, lst, n_rows, rays, block))
    if live_share == 1.0:
        assert (want[1] >= 0).any()


@pytest.mark.parametrize("split_rows", [1, 4, 32])
@pytest.mark.parametrize("live_share", LIVE_SHARES)
@pytest.mark.parametrize("name", F32_VARIANTS)
def test_f32_live_kernel_on_adversarial_data(cuda, name, live_share, split_rows):
    """The same on leaf_split_data's adversarial lists (equal t either side
    of split boundaries and twice in one row, |det| and |den| past 2^126
    and inf, inert rows, a 0-row list, a sweep, an all-dead packet, dead,
    NaN and barely live t_max; Baldwin–Weber records by bw_table), 1-32
    rows a split, carry-in with start t at the liveness rule's edges."""
    table, lists, n_rows, rays, R = adversarial(seed=5, live_share=live_share)
    if ENTRY_POINTS[name][0] == "bw":
        table = bw_table(table)
    table, lists, n_rows, rays = (x.to(cuda) for x in (table, lists, n_rows, rays))
    args, kw, whole = _variant_call(name, table, lists, n_rows, rays, R, rows_a=3)
    if "carry" in kw:
        kw["carry"] = carry_starts(*kw["carry"], seed=split_rows)
        whole = None
    with mock.patch.object(leaf_rows_mod, "split_rows", lambda n: split_rows):
        want = _design_matches(args, kw, whole)
    if "carry" not in kw and live_share == 1.0:
        assert (want[1] == 2000).any() and not (want[1] == 1001).any()


def test_merge_scratch_is_private_to_a_stream(indoor, cuda):
    """Two live-kernel calls in flight at once on two streams, of different
    sizes: a small one (the adversarial lists, 2,048 rays) on one stream and
    a large one (128 indoor lists of 2,048 rays) on the other, one split a
    row so that every ray's key goes through the scratch; the small call
    again after the large one has replaced a scratch shared by the device.
    Each result equal bit for bit to its plain result, and each stream's
    scratch left zero."""
    table, lists, n_rows, rays, R = (x.to(cuda) if torch.is_tensor(x) else x
                                     for x in adversarial(seed=7))
    small = (table, lists, n_rows, rays, R)
    n = 128 * 2048
    o, d, _ = _rays(n, seed=12, device=cuda)
    act = torch.ones(n, dtype=torch.bool, device=cuda)
    r_big, l_big, n_big = bits.prepare(indoor.trace, o, d, torch.full((n,), 1e30, device=cuda),
                                       act, 2048)
    large = (indoor.trace.ltab, l_big, n_big, r_big, 2048)
    want_small = leaf_rows_plain(*small)
    want_large = leaf_rows_plain(*large)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    got = []
    with mock.patch.object(leaf_rows_mod, "split_rows", lambda n: 1):
        for _ in range(4):
            with torch.cuda.stream(s1):
                got.append(("small", leaf_rows(*small)))
            with torch.cuda.stream(s2):
                got.append(("large", leaf_rows(*large)))
            with torch.cuda.stream(s1):
                got.append(("small", leaf_rows(*small)))
    torch.cuda.synchronize()
    for kind, out in got:
        _bits_equal(out, want_small if kind == "small" else want_large)
    for s in (s1, s2):
        with torch.cuda.stream(s):
            for x in leaf_rows_mod._SCRATCH[leaf_rows_mod.scratch_key(torch.device("cuda"))]:
                assert not bool(x.any())


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
    assert all(inst_rows.LAUNCHES[k] > 0 for k in inst_rows.FIRST_DESIGNS)
    with mock.patch.object(instanced, "inst_rows", inst_rows.inst_rows_plain):
        img_p, seed_p = render_frame_seeded(ps, cfg, cam, initial_seeds(cfg, 0, cuda))
    assert torch.isfinite(img_k).all() and (img_k >= 0).all()
    assert torch.equal(img_k, img_p)
    assert torch.equal(seed_k, seed_p)


def _inst_matches(data, any_hit, split_rows=None, splits=None):
    """inst_rows (the live kernel) and inst_rows_first_design against the
    plain version, bit for bit, one launch each (split_rows / splits: the
    live kernel's, else the wrapper's); the merge's scratch left zero.
    Returns the plain result."""
    name = "inst_rows_any" if any_hit else "inst_rows_closest"
    inst_rows.reset_launches()
    with mock.patch.object(inst_rows, "split_rows",
                           (lambda n: split_rows) if split_rows else inst_rows.split_rows), \
            mock.patch.object(inst_rows, "splits",
                              (lambda n, c, r: splits) if splits else inst_rows.splits):
        got = inst_rows.inst_rows(*data, any_hit)
    old = inst_rows.inst_rows_first_design(*data, any_hit)
    assert inst_rows.LAUNCHES[name] == 1 and inst_rows.LAUNCHES[name + "_pr2"] == 1
    assert sum(inst_rows.LAUNCHES.values()) == 2
    want = inst_rows.inst_rows_plain(*data, any_hit)
    torch.cuda.synchronize()
    _bits_equal(got, want)
    _bits_equal(old, want)
    for x in leaf_rows_mod._SCRATCH[leaf_rows_mod.scratch_key(torch.device("cuda"))]:
        assert not bool(x.any())
    return want


@pytest.mark.parametrize("splits", [1, 3, 64])
@pytest.mark.parametrize("split_rows", [1, 16, 32])
@pytest.mark.parametrize("live_share", [0.0, 0.01, 0.4, 1.0])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_inst_live_kernel_on_adversarial_data(cuda, any_hit, live_share, split_rows, splits):
    """The live instanced kernel on tests/test_torch_inst_split.py's
    adversarial set: equal t through two instances (the lower must win),
    sweeps between list segments, a triangle whose |det| is past the
    in-range reciprocal's range, a 0-row packet, an all-dead packet, and
    dead, NaN and barely live t_max; 1-32 rows a chunk, 1-64 work items."""
    data = tuple(x.to(cuda) if torch.is_tensor(x) else x
                 for x in inst_split.adversarial(seed=3, live_share=live_share))
    _inst_matches(data, any_hit, split_rows, splits)


@pytest.mark.parametrize("mode", ["closest", "any_hit", "sweep"])
def test_inst_live_kernel_on_stress_packets(cuda, mode):
    """The same on the emulation's stress32 packets (512-ray packets, one
    all dead, one 40% active; SWEEP_CAP forces per-instance sweeps), and
    in 2048-ray packets at every chunk size."""
    data = tuple(x.to(cuda) if torch.is_tensor(x) else x
                 for x in inst_split.stress_packets(
                     cap=inst_split.SWEEP_CAP if mode == "sweep" else None,
                     any_hit=mode == "any_hit"))
    _inst_matches(data, mode == "any_hit")
    for rows in (1, 16, 32):
        _inst_matches(data, mode == "any_hit", rows, 5)


def test_inst_live_kernel_on_the_capacity_scene(cuda):
    """The 202-instance capacity scene (phase 4c's), 2048-ray packets of
    random rays over the grid, closest and any-hit, with inst_cap 8 too
    (most lists sweep)."""
    scene = builtin.make_instanced_stress_scene(200)
    n = 8 * 2048
    rng = np.random.default_rng(9)
    o = torch.from_numpy(rng.uniform(-30, 30, (n, 3)).astype(np.float32)).to(cuda)
    o[:, 1] = o[:, 1].abs() + 1.0
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(n, 3)).astype(np.float32)).to(cuda), dim=1)
    act = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
    for cap in (None, 8):
        ps = compile_scene(scene, cuda, two_level="pure", inst_cap=cap)
        assert ps.inst.inv.shape[0] == 202
        for any_hit, t in ((False, 1e30), (True, 6.0)):
            rays, lists, counts = instanced.prepare(ps.inst, o, d, torch.full((n,), t,
                                                                              device=cuda),
                                                    act, 2048)
            if cap:
                assert (counts < 0).any()
            data = (ps.inst.ltab, lists, counts, ps.inst.segs, ps.inst.inv, rays, 2048)
            want = _inst_matches(data, any_hit)
            assert (want[4] >= 0).any()


def _frame_calls(module, attr, scene, cam, cuda, **knobs):
    """The positional arguments of every ``module.attr`` call of one 128x128
    1-spp frame with the bench knobs (its waves narrow down the ladder,
    closest-hit and shadow calls alike), in order."""
    cfg = RenderConfig.for_scene(scene, 128, 128, 1, use_defocus=True)._replace(
        **BENCH_KNOBS, **knobs)
    calls = []
    real = getattr(module, attr)

    def spy(*args, **kw):
        assert not kw
        calls.append(args)
        return real(*args)

    with mock.patch.object(module, attr, spy):
        render_frame_seeded(scene, cfg, cam, initial_seeds(cfg, 0, cuda))
    torch.cuda.synchronize()
    return calls


def test_inst_live_kernel_on_a_frames_calls(stress, cuda):
    """Every inst_rows call of a 128x128 stress32 twolevelp frame: the live
    kernel and the first design against the plain version."""
    cam = CameraParams.from_camera(builtin.make_stress_camera(128, 128, 32), cuda)
    calls = _frame_calls(instanced, "inst_rows", stress[None], cam, cuda)
    assert len(calls) >= 8 and {bool(args[7]) for args in calls} == {False, True}
    for args in calls:
        _inst_matches(args[:7], args[7])


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
    walk = "ilv" if algo == "skip" else algo  # skip runs the ilv kernel (ilv1)
    assert stream_walk.LAUNCHES[f"stream_walk_{walk}_{'any' if any_hit else 'closest'}"] == 1
    assert sum(stream_walk.LAUNCHES.values()) == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if algo == "skip":  # and equals the first design, the skip kernel
        for g, w in zip(stream_walk.stream_walk_skip_pr3(*args[:4], any_hit), want):
            assert torch.equal(g, w)
    visits = got[4]
    assert visits.shape == (4, 3) and visits[1].tolist() == [0, 0, 0]
    assert (visits[[0, 2, 3], 1] > 0).all() and (got[1][2048:4096] == -1).all()
    assert torch.equal(visits[:, 0], visits[:, 2]) and (got[1] >= 0).any()


def _stack_matches(stream_t, rays, a, block, any_hit, max_depth):
    """stream_walk_stack_{closest,any} and the first design (_pr3) against
    the plain version, bit for bit with equal counts, one launch each;
    returns the plain result."""
    mode = "any" if any_hit else "closest"
    base = (stream_t, rays, a, block)
    want = stream_walk.stream_walk_plain(*base, "stack", any_hit, max_depth)
    stream_walk.reset_launches()
    got = stream_walk.stream_walk(*base, "stack", any_hit, max_depth)
    old = stream_walk.stream_walk_stack_pr3(*base, any_hit, max_depth)
    torch.cuda.synchronize()
    assert stream_walk.LAUNCHES[f"stream_walk_stack_{mode}"] == 1
    assert stream_walk.LAUNCHES[f"stream_walk_stack_{mode}_pr3"] == 1
    assert sum(stream_walk.LAUNCHES.values()) == 2
    for g, o, w in zip(got, old, want):
        assert torch.equal(g, w) and torch.equal(o, w)
    return want


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("live", [0.01, 0.4, 1.0])
@pytest.mark.parametrize("packets", [1, 2, 4, 128])
def test_stack_kernel_matches_plain_and_pr3(indoor, cuda, packets, live, any_hit):
    """The cluster stack walk and its first design against the plain version
    on the indoor stream, 1-128 packets of 2048 rays, 1-100% live
    (``_ilv_rays``: the second packet all dead, 300 pad rays)."""
    rays, a = _ilv_rays(cuda, packets, live, any_hit)
    want = _stack_matches(indoor.stream.stream, rays, a, 2048, any_hit,
                          indoor.stream.max_depth)
    assert want[4].shape == (packets, 3)
    if packets > 1:
        assert want[4][1].tolist() == [0, 0, 0] and (want[1][2048:4096] == -1).all()


def test_stack_kernel_on_a_frames_calls(indoor, cuda):
    """Every stream-walk call of a 128x128 indoor stack frame: the cluster
    stack kernel and its first design against the plain version, counts
    included."""
    cam = CameraParams.from_camera(builtin.make_indoor_camera(128, 128), cuda)
    calls = _frame_calls(stream, "stream_walk", indoor, cam, cuda, algo="stack")
    assert len(calls) >= 8 and {bool(args[5]) for args in calls} == {False, True}
    for stream_t, rays, a, block, algo, any_hit, max_depth in calls:
        assert algo == "stack"
        _stack_matches(stream_t, rays, a, block, any_hit, max_depth)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("block", [512, 1024, 2048])
def test_stack_packet_sizes_match_plain(indoor, cuda, block, any_hit):
    """The stack kernel at every packet size the wrapper takes (8 blocks of
    64, 128 or 256 threads a packet), 4 packets, 40% active."""
    rays, a = _ilv_rays(cuda, 4, 0.4, any_hit, block=block)
    _stack_matches(indoor.stream.stream, rays, a, block, any_hit, indoor.stream.max_depth)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_stack_kernel_on_the_emulation_data(indoor, cuda, any_hit):
    """tests/test_torch_stack_split.py's sets in 512-ray packets: the indoor
    packets (1-100% live, an all-dead packet, a lane slice, rays inside the
    room, pad rays); the 18-level chain that fills the stack to its depth;
    and the same chain with a stack of 16, whose lost pushes send the walk
    back to row 0 until the belt stops it."""
    rays, a = (x.to(cuda) for x in stack_split._data(any_hit))
    _stack_matches(indoor.stream.stream, rays, a, 512, any_hit, indoor.stream.max_depth)
    chain = stack_split.deep_stream(stack_split.LEVELS).to(cuda)
    rays, a = (x.to(cuda) for x in stack_split._deep_rays(2 * 512))
    _stack_matches(chain, rays, a, 512, any_hit, stack_split.LEVELS)
    if not any_hit:
        want = _stack_matches(chain, rays, a, 512, False, 16)
        assert (want[4][:, 0] == chain.shape[0] + stream_walk.K_VISITS).all()


def test_stack_kernel_rejects_bad_inputs(indoor, cuda):
    """A stream deeper than the stack's capacity and a packet size the
    kernel does not take raise, as on the CPU."""
    rays, a = _ilv_rays(cuda, 1, 1.0, False)
    with pytest.raises(ValueError):
        stream_walk.stream_walk(indoor.stream.stream, rays, a, 2048, "stack", False, 65)
    with pytest.raises(ValueError):
        stream_walk.stream_walk(indoor.stream.stream, rays[:, :1536].contiguous(),
                                a[:1536].contiguous(), 1536, "stack")


# The new kernels' entry points, found by name (csrc/entry.cuh).
NEW_SASS = ("stream_walk_stack_closest", "stream_walk_stack_any", "inst_rows_closest",
            "inst_rows_any", "bvh_walk_closest", "bvh_walk_any", *F32_VARIANTS)


@pytest.mark.parametrize("entry", NEW_SASS)
def test_new_kernels_fuse_no_multiply_and_add(cuda, entry):
    """--fmad=false: in every loop of the kernel that holds slab tests
    (FMNMX) or record tests (MUFU.RCP), each FFMA is a reciprocal's Newton
    step (nvcc's 1 / a and mt.cuh rcp_in_range: two a MUFU.RCP), never a
    multiply and add of a test fused, and the tests' FMUL and FADD are
    there."""
    loops = [ops for _, _, ops in _visit.loop_bodies(entry)
             if any(o.startswith(("FMNMX", "MUFU.RCP")) for o in ops)]
    assert loops, f"{entry}: no loop holds a test"
    for ops in loops:
        count = Counter(o.split(".")[0] for o in ops)
        rcp = sum(o.startswith("MUFU.RCP") for o in ops)
        assert count["FFMA"] <= 2 * rcp, f"{entry}: {count['FFMA']} FFMA, {rcp} MUFU.RCP"
        assert count["FMUL"] + count["FADD"] >= 8 * rcp


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
        skip = stream_walk.stream_walk_skip_pr3(*args[:4], any_hit)
        for g, w in zip(got, skip):
            assert torch.equal(g, w)


# skip2 / ilvN (stream_walk_ilv.cu): every N, from one packet to a full
# 512x512 wave; every packet size in test_ilv_packet_sizes_match_plain.
ILV_ALGOS = ["skip2", "ilv1", "ilv2", "ilv3", "ilv4"]


def _ilv_rays(cuda, packets, live, any_hit, block=2048, seed=6):
    """packets x block random rays (``_rays``' origins and directions) with
    ``live`` of them active; with two packets or more the second is all
    dead, and the last 300 lanes are pad rays.  (rays, act) packed."""
    n = packets * block - (300 if packets > 1 else 0)
    o, d, _ = _rays(max(n, 4096), seed=seed, device=cuda)
    rng = np.random.default_rng(seed)
    act = torch.from_numpy(rng.random(n) < live).to(cuda)
    if packets > 1:
        act[block:2 * block] = False
    tmax = torch.full((n,), 6.0 if any_hit else 1e30, device=cuda)
    return stream.pack_rays(o[:n], bits.nudge(d[:n]), tmax, act, block)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("live", [0.01, 0.4, 1.0])
@pytest.mark.parametrize("packets", [1, 2, 4, 128])
def test_ilv_kernel_matches_plain_and_skip(indoor, cuda, packets, live, any_hit):
    """stream_walk_ilv_{closest,any} for skip2 and every ilvN, and the
    first design (_pr5), bit for bit with equal counts against the plain
    version and the skip kernel; one launch a call."""
    rays, a = _ilv_rays(cuda, packets, live, any_hit)
    base = (indoor.stream.stream, rays, a, 2048)
    want = stream_walk.stream_walk_plain(*base, "skip", any_hit)
    skip = stream_walk.stream_walk_skip_pr3(*base, any_hit)
    for g, w in zip(skip, want):
        assert torch.equal(g, w)
    mode = "any" if any_hit else "closest"
    for algo in ILV_ALGOS:
        stream_walk.reset_launches()
        got = stream_walk.stream_walk(*base, algo, any_hit)
        old = stream_walk.stream_walk_ilv_pr5(*base, algo, any_hit)
        torch.cuda.synchronize()
        assert stream_walk.LAUNCHES[f"stream_walk_ilv_{mode}"] == 1
        assert stream_walk.LAUNCHES[f"stream_walk_ilv_{mode}_pr5"] == 1
        assert sum(stream_walk.LAUNCHES.values()) == 2
        for g, o, w in zip(got, old, want):
            assert torch.equal(g, w) and torch.equal(o, w)
    visits = want[4]
    assert visits.shape == (packets, 3)
    if packets > 1:
        assert visits[1].tolist() == [0, 0, 0] and (want[1][2048:4096] == -1).all()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("block", [512, 1024, 2048])
def test_ilv_packet_sizes_match_plain(indoor, cuda, block, any_hit):
    """stream_walk_ilv_{closest,any} at every packet size the wrapper takes
    (8 blocks of 64, 128 or 256 threads a packet) against the plain
    version on 4 packets, 40% active; one launch a call."""
    rays, a = _ilv_rays(cuda, 4, 0.4, any_hit, block=block)
    base = (indoor.stream.stream, rays, a, block)
    want = stream_walk.stream_walk_plain(*base, "skip2", any_hit)
    stream_walk.reset_launches()
    got = stream_walk.stream_walk(*base, "skip2", any_hit)
    torch.cuda.synchronize()
    assert stream_walk.LAUNCHES[f"stream_walk_ilv_{'any' if any_hit else 'closest'}"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# specN / specbN (stream_walk_spec.cu): every N at 4 packets, spec4 and
# specb8 from one packet to a full 512x512 wave; the data of
# tests/test_torch_spec_split.py (the emulation of the kernel's
# decomposition) for the ends of a group.
SPEC_ALGOS = ["spec1", "spec2", "spec4", "spec8", "specb1", "specb2", "specb4", "specb8"]


def _spec_matches(stream_t, rays, a, block, algo, any_hit):
    """stream_walk_spec{,b}_* and the first design (_pr5) against the plain
    version, bit for bit with equal counts, one launch each; returns the
    plain result."""
    walk, _ = stream_walk.parse_algo(algo)
    mode = "any" if any_hit else "closest"
    base = (stream_t, rays, a, block)
    want = stream_walk.stream_walk_plain(*base, algo, any_hit)
    stream_walk.reset_launches()
    got = stream_walk.stream_walk(*base, algo, any_hit)
    old = stream_walk.stream_walk_spec_pr5(*base, algo, any_hit)
    torch.cuda.synchronize()
    assert stream_walk.LAUNCHES[f"stream_walk_{walk}_{mode}"] == 1
    assert stream_walk.LAUNCHES[f"stream_walk_{walk}_{mode}_pr5"] == 1
    assert sum(stream_walk.LAUNCHES.values()) == 2
    for g, o, w in zip(got, old, want):
        assert torch.equal(g, w) and torch.equal(o, w)
    return want


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("live", [0.01, 0.4, 1.0])
@pytest.mark.parametrize("packets", [1, 2, 4, 128])
def test_spec_kernel_matches_plain_and_pr5(indoor, cuda, packets, live, any_hit):
    """The new spec / specb kernel and the first design against the plain
    version on the indoor stream, 1-128 packets of 2048 rays, 1-100% live
    (``_ilv_rays``: the second packet all dead, 300 pad rays)."""
    rays, a = _ilv_rays(cuda, packets, live, any_hit)
    for algo in SPEC_ALGOS if packets == 4 else ["spec4", "specb8"]:
        want = _spec_matches(indoor.stream.stream, rays, a, 2048, algo, any_hit)
        assert want[4].shape == (packets, 3)
        if packets > 1:
            assert want[4][1].tolist() == [0, 0, 0] and (want[1][2048:4096] == -1).all()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("block", [512, 1024, 2048])
def test_spec_packet_sizes_match_plain(indoor, cuda, block, any_hit):
    """The spec kernel at every packet size the wrapper takes (8 blocks of
    64, 128 or 256 threads a packet), 4 packets, 40% active."""
    rays, a = _ilv_rays(cuda, 4, 0.4, any_hit, block=block)
    for algo in ("spec4", "specb8"):
        _spec_matches(indoor.stream.stream, rays, a, block, algo, any_hit)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_spec_kernel_ends_of_a_group(cuda, any_hit):
    """The soup streams of tests/test_torch_spec_split.py in 512-ray
    packets: a dead-end subtree whose last leaf row only the re-test of
    the clamped window reaches (its hits must appear), rays that reach
    specb's rows before the cursor, packets whose rays all hit mid-group
    (any-hit), every live share, and a stream of 5 rows with spec8."""
    soup = spec_split.soup_stream().to(cuda)
    cut, _ = spec_split.cut_stream(soup)
    rays, a = (x.to(cuda) for x in spec_split.tail_packets(cut.cpu()))
    for algo in ("spec1", "spec8", "specb4", "specb8"):
        want = _spec_matches(cut, rays, a, 512, algo, any_hit)
        assert ((want[1] // 8) == cut.shape[0] - 1).any()
    end = spec_split.soup_stream(seed=4).to(cuda)
    rays, a = (x.to(cuda) for x in spec_split.tail_packets(end.cpu()))
    for algo in ("specb4", "specb8"):
        _spec_matches(end, rays, a, 512, algo, any_hit)
    rays, a = (x.to(cuda) for x in spec_split.packets(soup.cpu()))
    for algo in SPEC_ALGOS:
        _spec_matches(soup, rays, a, 512, algo, any_hit)
    short = spec_split.soup_stream(n_tris=12, seed=5).to(cuda)
    rays, a = (x.to(cuda) for x in spec_split.packets(short.cpu(), seed=31))
    _spec_matches(short, rays, a, 512, "spec8", any_hit)


def test_spec_kernel_rejects_bad_inputs(indoor, cuda):
    """A window wider than 8 rows, specb's window longer than the stream
    and a packet size the kernel does not take raise, as on the CPU."""
    rays, a = _ilv_rays(cuda, 1, 1.0, False)
    short = indoor.stream.stream[:4].contiguous()
    with pytest.raises(ValueError):
        stream_walk.stream_walk(indoor.stream.stream, rays, a, 2048, "spec9")
    with pytest.raises(ValueError):
        stream_walk.stream_walk(short, rays, a, 2048, "specb8")
    with pytest.raises(ValueError):
        stream_walk.stream_walk(indoor.stream.stream, rays[:, :1536].contiguous(),
                                a[:1536].contiguous(), 1536, "spec4")


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


def _bvh_matches(tr, rays, a, any_hit):
    """bvh_walk_{closest,any} and the first design (_pr3) against the plain
    version, bit for bit with equal counts, one launch each; returns the
    plain result."""
    args = (tr.nodes, tr.tris, tr.n_nodes, rays, a, any_hit)
    want = bvh_walk.bvh_walk_plain(*args)
    bvh_walk.reset_launches()
    got = bvh_walk.bvh_walk(*args)
    old = bvh_walk.bvh_walk_pr3(*args)
    torch.cuda.synchronize()
    name = bvh_walk.ENTRY_POINTS[int(any_hit)]
    assert bvh_walk.LAUNCHES[name] == 1 and bvh_walk.LAUNCHES[name + "_pr3"] == 1
    assert sum(bvh_walk.LAUNCHES.values()) == 2
    _bits_equal(got, want)
    _bits_equal(old, want)
    return want


def _bvh_rays(cuda, packets, live, any_hit, seed=6):
    """packets x 1024 random rays with ``live`` of them active, three with a
    zero direction component (1/0 = inf, not nudged); with two packets or
    more the second is all dead, and the last 300 lanes are pad rays."""
    n = packets * 1024 - (300 if packets > 1 else 0)
    o, d, _ = _rays(max(n, 4096), seed=seed, device=cuda)
    o, d = o[:n], d[:n].clone()
    d[:3] = torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0]], device=cuda)
    act = torch.from_numpy(np.random.default_rng(seed).random(n) < live).to(cuda)
    if packets > 1:
        act[1024:2048] = False
    tmax = torch.full((n,), 6.0 if any_hit else 1e30, device=cuda)
    return stream.pack_rays(o, d, tmax, act, 1024)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("live", [0.0, 0.01, 0.4, 1.0])
@pytest.mark.parametrize("packets", [1, 2, 4, 128])
def test_bvh_kernel_matches_plain_and_pr3(indoor, cuda, packets, live, any_hit):
    """The binary walk (compaction, both successors and a leaf's triangles
    staged, one vote a step, the in-range reciprocal) and its first design
    against the plain version on the indoor node list, 1-128 packets,
    0-100% live."""
    rays, a = _bvh_rays(cuda, packets, live, any_hit)
    want = _bvh_matches(indoor.binary, rays, a, any_hit)
    assert want[4].shape == (packets, 2)
    if packets > 1:
        assert want[4][1].tolist() == [0, 0] and (want[1][1024:2048] == -1).all()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("scene", ["box", "indoor"])
def test_bvh_kernel_on_the_emulation_data(indoor, cuda, scene, any_hit):
    """tests/test_torch_binary_split.py's packets on both scenes: all
    active, 40% active, all dead, and rays from inside the room every one
    of which hits (any-hit: the packet stops before the list's end), pad
    rays."""
    tr = (indoor if scene == "indoor"
          else compile_scene(builtin.make_diffuse_box_scene(), cuda)).binary
    rays, a = (x.to(cuda) for x in binary_split._data(scene, any_hit))
    want = _bvh_matches(tr, rays, a, any_hit)
    assert (want[1][3 * 1024:][a[3 * 1024:] != 0] >= 0).all()


def test_bvh_kernel_on_a_triangle_past_the_in_range_reciprocal(cuda):
    """A node list of one leaf over a triangle of edges 1.2e19 (|det| about
    1.4e38, past 2^126: the IEEE redo) and one of edges 1e20 (det = inf),
    hit from below: the kernels and the plain version agree bit for bit."""
    from surf_tpu_torch.accel.skiplinks import pack_records_np

    rec = np.zeros((2, 16), np.float32)
    rec[0, 0:3] = [-1.0, -1.0, 0.3]
    rec[0, 3:6] = [1.2e19 + 1.0, 0.0, 0.0]
    rec[0, 6:9] = [0.0, 1.2e19 + 1.0, 0.0]
    rec[1, 0:3] = [-1.0, -1.0, 0.2]
    rec[1, 3:6] = [1e20, 0.0, 0.0]
    rec[1, 6:9] = [0.0, 1e20, 0.0]
    tris = torch.from_numpy(np.concatenate([rec, np.zeros((6, 16), np.float32)])
                            .reshape(1, 128)).to(cuda)
    f = [np.array([v], np.float32) for v in (-1e30, -1e30, -1e30, 1e30, 1e30, 1e30)]
    i = [np.array([v], np.int32) for v in (0, 2, 1)]
    nodes = torch.from_numpy(pack_records_np(f, i)).to(cuda)
    n = 1024
    rng = np.random.default_rng(4)
    o = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n), np.full(n, -1.0)], 1)
    d = np.stack([rng.normal(0, 0.1, n), rng.normal(0, 0.1, n), np.ones(n)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays, a = stream.pack_rays(torch.from_numpy(o.astype(np.float32)).to(cuda),
                               torch.from_numpy(d.astype(np.float32)).to(cuda),
                               torch.full((n,), 1e30, device=cuda),
                               torch.ones(n, dtype=torch.bool, device=cuda), 1024)
    tr = bvh_walk.BinaryTrace(nodes, tris, 1)
    for any_hit in (False, True):
        want = _bvh_matches(tr, rays, a, any_hit)
        assert (want[1] == 0).sum() > n // 2


def test_bvh_kernel_on_a_frames_calls(indoor, cuda):
    """Every binary-walk call of a 128x128 use_wide=False frame: the kernel
    and its first design against the plain version, counts included."""
    cam = CameraParams.from_camera(builtin.make_indoor_camera(128, 128), cuda)
    calls = _frame_calls(bvh_walk, "bvh_walk", indoor, cam, cuda, use_wide=False)
    assert len(calls) >= 8 and {bool(args[5]) for args in calls} == {False, True}
    for nodes, tris, n_nodes, rays, a, any_hit in calls:
        _bvh_matches(bvh_walk.BinaryTrace(nodes, tris, n_nodes), rays, a, any_hit)


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

"""The port's bits* list machinery against its own bitsru8 and against
surf_tpu's ``traverse_wide`` in interpret mode, on the indoor scene with
numpy-made rays: sub-lists (``8``), the one-pass overflow sweep against
JAX's chunked sweep and the port's own chunked sweep through carry-in, and
any-hit through every flag.  Gates as tests/test_torch_bits_family.py:
bit-equal to the port's bitsru8; against JAX prim equal and t within
rtol 5e-6 (XLA's FMA contraction).
"""

import warnings

import jax
import numpy as np
import torch
from test_torch_bits import _rays, scenes  # noqa: F401  (scenes is a fixture)
from test_torch_bits_family import N, _inputs, _jax, _port

import surf_tpu.accel.pallas_wide as pw
from surf_tpu_torch.accel.bits import pack_rays, parse_algo
from surf_tpu_torch.accel.leaf_rows import leaf_rows

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)


def test_sub_lists_match_bitsru8_and_jax(scenes):  # noqa: F811
    """``8`` at 2048-ray packets: two 1024-ray lists per packet, which is
    ``bits`` at 1024-ray packets, bit for bit."""
    _, wt, ts = scenes
    o, d, act = _inputs()
    tmax = np.full(N, 1e30, np.float32)
    got = _port(ts, o, d, tmax, act, block_rays=2048, algo="bits8")
    for algo, blk in (("bitsru8", 2048), ("bits", 1024)):
        ref = _port(ts, o, d, tmax, act, block_rays=blk, algo=algo)
        for x, y in zip(got, ref):
            assert np.array_equal(x, y), algo
    want = _jax(wt, o, d, tmax, act, algo="bits8", block_rays=2048)
    assert np.array_equal(got[0], want[0])
    both = got[0] >= 0
    np.testing.assert_allclose(got[1][both], want[1][both], rtol=5e-6)


ANY_ALGOS = ("bitsru8", "bitsr", "bits", "bitsi", "bitsw", "bitswi", "bits2",
             "bits8", "bitsa", "bitsp", "bits2wi", "bitsrb", "bitsru16")


def test_any_hit_occlusion_for_every_flag(scenes):  # noqa: F811
    """Any-hit at t_max 6: the occlusion mask is the same for every algo
    whose arithmetic decides hits as bitsru8's does (bf16 aside); the
    trimmed algos return prim 0 for an occluded ray, the others without
    ``2`` (and ``bitsa`` first) the closest slot below t_max.  With ``2``
    a ray that found a hit in round A leaves round B's phase 1, so its
    slot is a hit, not always the closest (pallas_wide.py:1847-1849)."""
    _, _, ts = scenes
    o, d, act = _inputs(seed=7)
    tmax = np.full(N, 6.0, np.float32)
    closest = _port(ts, o, d, tmax, act, algo="bitsru8")
    occ = closest[0] >= 0
    assert 0.1 < occ.mean() < 0.9
    for algo in ANY_ALGOS:
        got = _port(ts, o, d, tmax, act, any_hit=True, algo=algo)
        assert np.array_equal(got[0] >= 0, occ), algo
        f = parse_algo(algo)
        if f.pairs:
            continue  # the closest slot, or 0 where a ray overflowed its list
        if f.refine:
            continue
        if f.bw or f.ilp or f.full_any:
            same = _port(ts, o, d, tmax, act, algo=algo)
            assert np.array_equal(got[0], same[0]), algo
        else:
            assert set(np.unique(got[0])) <= {-1, 0}, algo
    got = _port(ts, o, d, tmax, act, any_hit=True, algo="bitsa")
    for x, y in zip(got, closest):
        assert np.array_equal(x, y)


def _chunked_sweep(table, rays, chunk):
    """The port's kernel swept over the table in chunks of ``chunk`` rows,
    the running best carried from chunk to chunk (JAX's sweep_all)."""
    g = rays.shape[1] // 1024
    lists = torch.zeros((g, 8), dtype=torch.int32)
    sweep = torch.full((g,), -1, dtype=torch.int32)
    best = None
    for s in range(0, table.shape[0], chunk):
        best = leaf_rows(table[s:s + chunk].contiguous(), lists, sweep, rays, 1024,
                         carry=best)
    return best


def test_one_pass_sweep_matches_chunked_sweeps(scenes, monkeypatch):  # noqa: F811
    """Every packet overflows (cap_rows=8) into the sweep.  The port sweeps
    the table in one pass; JAX, with SWEEP_CHUNK_ROWS at 128 (the stand-in
    indoor table has 376 rows, so 512 would make one chunk), in 3 chunks
    through carry-in.  Closest hit: prim equal, t within the FMA rtol, and
    bit-equal to the port's own chunked sweep through carry-in; any-hit:
    the same occlusion (JAX's later chunks resume without the trim, so
    their prim is a slot where the port's trimmed prim is 0)."""
    _, wt, ts = scenes
    n = 1024
    o, d = _rays(n, seed=21)
    act = np.ones(n, bool)
    tmax = np.full(n, 1e30, np.float32)
    one = _port(ts, o, d, tmax, act, block_rays=1024, algo="bitsr", cap_rows=8)
    one_any = _port(ts, o, d, np.full(n, 6.0, np.float32), act, any_hit=True,
                    block_rays=1024, algo="bitsr", cap_rows=8)
    monkeypatch.setattr(pw, "SWEEP_CHUNK_ROWS", 128)
    jax.clear_caches()
    want = _jax(wt, o, d, tmax, act, algo="bitsr", block_rays=1024, cap_rows=8)
    want_any = _jax(wt, o, d, np.full(n, 6.0, np.float32), act, any_hit=True,
                    algo="bitsr", block_rays=1024, cap_rows=8)
    assert wt.ltab.shape[0] > 2 * 128
    assert np.array_equal(one[0], want[0]) and (one[0] >= 0).mean() > 0.5
    both = one[0] >= 0
    np.testing.assert_allclose(one[1][both], want[1][both], rtol=5e-6)
    assert np.array_equal(one_any[0] >= 0, want_any[0] >= 0)
    rays = pack_rays(*map(torch.from_numpy, (o, d, tmax, act)), 1024)
    t, r, u, v = _chunked_sweep(ts.trace.ltab, rays, 128)
    for x, y in zip((r, t, u, v), one):
        assert np.array_equal(x.numpy(), y)

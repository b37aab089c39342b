"""The port's bits* algos whose arithmetic is bitsru8's (group lists, the
ILP merge, the t-refresh round, per-ray pair lists) against the port's own
bitsru8 and against surf_tpu's ``traverse_wide`` with the same algo in
interpret mode, on the indoor scene with numpy-made rays, and the parse of
algo strings (sub-lists, the overflow sweep and any-hit:
tests/test_torch_bits_lists.py).

Gates: against the port's bitsru8, ``prim``, t, u and v bit-equal (the
rows each algo drops or adds cannot hold a closer hit, and every kernel
picks the first record with the least t).  Against JAX's same algo,
``prim`` equal and t within rtol 5e-6: XLA's CPU backend contracts
multiply-adds into FMAs, while the port rounds every op separately
(tests/test_torch_bits.py).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bits import _rays, scenes  # noqa: F401  (scenes is a fixture)

from surf_tpu.accel.pallas_wide import traverse_wide
from surf_tpu_torch.accel import pairs
from surf_tpu_torch.accel.bits import pack_rays, parse_algo, traverse_bits

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

N = 4096


def _inputs(seed=5, n=N):
    o, d = _rays(n, seed)
    act = np.ones(n, bool)
    act[::7] = False
    return o, d, act


def _port(ts, o, d, tmax, act, any_hit=False, **kw):
    h = traverse_bits(ts.trace, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(tmax), torch.from_numpy(act), any_hit=any_hit, **kw)
    return [x.numpy() for x in h]


def _jax(wt, o, d, tmax, act, any_hit=False, **kw):
    h = traverse_wide(wt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
                      jnp.asarray(act), any_hit, interpret=True, **kw)
    return [np.asarray(x) for x in h]


# (algo, traverse keyword arguments); each costs one interpret-mode compile.
EXACT = {
    "bits": ("bits", {}),
    "bitsi": ("bitsi", {}),
    "bits2_refine16": ("bits2", dict(refine_rows=16)),
    "bits2_refine192": ("bits2", dict(refine_rows=192)),
    "bitsp": ("bitsp", dict(pair_groups=0)),
    "bitsp_overflow": ("bitsp", dict(pair_groups=2)),
}


@pytest.mark.parametrize("case", sorted(EXACT))
def test_exact_algo_matches_bitsru8_and_jax(scenes, case):  # noqa: F811
    _, wt, ts = scenes
    algo, kw = EXACT[case]
    o, d, act = _inputs()
    tmax = np.full(N, 1e30, np.float32)
    got = _port(ts, o, d, tmax, act, block_rays=2048, algo=algo, **kw)
    ref = _port(ts, o, d, tmax, act, block_rays=2048, algo="bitsru8")
    for x, y in zip(got, ref):
        assert np.array_equal(x, y)
    assert (got[0][~act] == -1).all() and (got[0] >= 0).mean() > 0.5
    want = _jax(wt, o, d, tmax, act, algo=algo, block_rays=2048, **kw)
    assert np.array_equal(got[0], want[0])
    both = got[0] >= 0
    np.testing.assert_allclose(got[1][both], want[1][both], rtol=5e-6)
    if case == "bitsp_overflow":
        # 48% of the live rays list more than 2 groups: the fallback
        # resolves them
        rays = pack_rays(*map(torch.from_numpy, (o, d, tmax, act)), 2048)[:, :N]
        ovf = pairs.pair_hits(ts.trace, rays[:, torch.from_numpy(act)], 2)[4]
        assert ovf.float().mean() > 0.25


def test_ilp_merge_is_bit_equal(scenes):  # noqa: F811
    """``i`` changes only how a row's 8 tests merge: t, u, v and prim are
    bit-equal to the sequential kernel's, for MT and for Baldwin–Weber."""
    _, _, ts = scenes
    o, d, act = _inputs(seed=6)
    tmax = np.full(N, 1e30, np.float32)
    for seq, ilp in (("bits", "bitsi"), ("bitsw", "bitswi"), ("bits2", "bits2i")):
        a = _port(ts, o, d, tmax, act, algo=seq)
        b = _port(ts, o, d, tmax, act, algo=ilp)
        for x, y in zip(a, b):
            assert np.array_equal(x, y), (seq, ilp)


VALID = ("bits", "bitsr", "bitsru8", "bitsru16", "bitsrb", "bitsrbu2", "bits28whia",
         "bitsp", "bitspu1", "bitsu1", "bitsrr", "bitsw2i8")
INVALID = ("bitsq", "bitsru28", "bitsp2", "bitsr2", "bitsr8", "bitsu4", "bitsb",
           "bitsrbw", "bitsrbi", "bitspr", "bitsru3", "bitsru", "bits ")


def test_parse_algo_follows_jax(scenes):  # noqa: F811
    """Every string that traverse_wide's parse rejects raises ValueError in
    the port, and the strings it accepts parse (the asserts fire before
    any compile)."""
    _, wt, _ = scenes
    o, d = _rays(8, seed=1)
    args = (wt, jnp.asarray(o), jnp.asarray(d), jnp.full(8, 1e30, jnp.float32),
            jnp.ones(8, bool))
    for algo in INVALID:
        with pytest.raises(AssertionError):
            traverse_wide(*args, interpret=True, algo=algo)
        with pytest.raises(ValueError):
            parse_algo(algo)
    for algo in VALID:
        parse_algo(algo)
    f = parse_algo("bitsru16b")
    assert f.row_lists and f.block_fetch and f.unroll == 16
    assert parse_algo("bits28whia") == parse_algo("bitsaihw82")

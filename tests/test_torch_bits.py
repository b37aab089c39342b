"""The port's bitsru8 traversal (plain leaf-row version on the CPU) against
surf_tpu's ``traverse_wide(algo="bitsru8")`` in interpret mode and against
the NumPy stream oracle, on the indoor scene with numpy-made rays.

Gates: ``prim`` equal everywhere.  t within rtol 1e-6 of the stream oracle
where both hit, as tests/test_wide_kernel.py holds the Pallas kernel.
Against the JAX traversal t agrees within rtol 5e-6: XLA's CPU backend
contracts multiply-adds into FMAs (measured up to 2.7e-6 apart on these
rays), while the port rounds every op separately, as the CUDA kernel does
with --fmad=false.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.accel.pallas_wide import WideTrace, traverse_wide
from surf_tpu.accel.wide import traverse_stream_np
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.compile import HostCompiled
from surf_tpu_torch.accel.bits import list_capacity, prepare, traverse_bits
from surf_tpu_torch.accel.leaf_rows import leaf_rows
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.compile import compile_scene

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scenes():
    host = HostCompiled(jbuiltin.make_indoor_scene())
    tr = host.render_scene.trace
    wt = WideTrace(tr.wide_stream, tr.wide_rec_slot, ltab=tr.wide_ltab,
                   ltabw=tr.wide_ltabw, lrec=tr.wide_lrec,
                   box_lo=tr.wide_box_lo, box_hi=tr.wide_box_hi,
                   anc=tr.wide_anc, inert_row=int(tr.wide_ltab.shape[0]) - 1)
    return host, wt, compile_scene(builtin.make_indoor_scene(), CPU)


def _rays(n, seed, span=3.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:3] = [[1, 0, 0], [0, -1, 0], [0, 0, 1]]  # exercise the zero nudge
    return o, d


# (rays, any_hit, t_max, cap_rows, inactive lanes).  Each distinct
# (rays, any_hit, cap_rows) costs one interpret-mode compile (~20 s).
CASES = {
    "closest_4096": (4096, False, 1e30, 0, "every7"),
    "dead_packet": (4096, False, 1e30, 0, "second_packet"),
    "any_2048": (2048, True, 6.0, 0, "every7"),
    "overflow_sweep": (4096, False, 1e30, 8, "none"),
}
ORACLE_RAYS = 512  # the stream oracle walks ray by ray in Python


@pytest.mark.parametrize("case", sorted(CASES))
def test_bits_matches_jax_and_oracle(scenes, case):
    host, wt, ts = scenes
    n, any_hit, tmax_v, cap_rows, dead = CASES[case]
    o, d = _rays(n, seed=len(case))
    tmax = np.full(n, tmax_v, np.float32)
    act = np.ones(n, bool)
    if dead == "every7":
        act[::7] = False
    elif dead == "second_packet":
        act[2048:] = False

    got = traverse_bits(ts.trace, torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(tmax), torch.from_numpy(act),
                        any_hit=any_hit, block_rays=2048, cap_rows=cap_rows)
    got = [x.numpy() for x in got]
    want = traverse_wide(wt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
                         jnp.asarray(act), any_hit, interpret=True,
                         algo="bitsru8", block_rays=2048, cap_rows=cap_rows)
    want = [np.asarray(x) for x in want]
    assert np.array_equal(got[0], want[0])
    assert (got[0][~act] == -1).all()
    both = (got[0] >= 0) & (want[0] >= 0)
    np.testing.assert_allclose(got[1][both], want[1][both], rtol=5e-6)

    k = ORACLE_RAYS
    t_w, rec, _, _ = traverse_stream_np(host._ws, o[:k], d[:k], tmax[:k],
                                        any_hit=any_hit)
    slot = np.where(rec >= 0, host._ws.rec_slot[np.maximum(rec, 0)], -1)
    slot = np.where(act[:k], slot, -1)
    got = [x[:k] for x in got]
    if any_hit:
        # the oracle stops at its first occluder; compare occlusion only
        assert np.array_equal(got[0] >= 0, slot >= 0)
    else:
        assert np.array_equal(got[0], slot)
        np.testing.assert_allclose(got[1][slot >= 0], t_w[slot >= 0], rtol=1e-6)


def test_row_lists_and_sweep_selection(scenes):
    """Lists are ascending, padded with the inert row, and a packet whose
    candidates exceed the capacity is marked for the sweep (n_rows = -1)."""
    _, _, ts = scenes
    o, d = _rays(4096, seed=3)
    act = np.ones(4096, bool)
    act[2048:] = False
    args = (ts.trace, torch.from_numpy(o), torch.from_numpy(d),
            torch.full((4096,), 1e30), torch.from_numpy(act))
    rays, lists, n_rows = prepare(*args, block_rays=2048)
    cap = list_capacity(ts.trace)
    assert lists.shape == (2, cap) and cap % 8 == 0
    k = int(n_rows[0])
    assert 0 < k <= cap and int(n_rows[1]) == 0
    assert (lists[0, :k].diff() > 0).all()
    assert (lists[0, k:] == ts.trace.inert_row).all()
    assert (lists[1] == ts.trace.inert_row).all()
    assert (rays[6, 2048:] == -1e30).all()
    _, _, n_small = prepare(*args, block_rays=2048, cap_rows=8)
    assert int(n_small[0]) == -1 and int(n_small[1]) == 0
    # the sweep and the list give the same hits
    a = leaf_rows(ts.trace.ltab, lists, n_rows, rays, 2048)
    b = leaf_rows(ts.trace.ltab, lists, torch.tensor([-1, 0], dtype=torch.int32),
                  rays, 2048)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_leaf_rows_rejects_bad_inputs(scenes):
    _, _, ts = scenes
    lists = torch.zeros(1, 8, dtype=torch.int32)
    n_rows = torch.zeros(1, dtype=torch.int32)
    rays = torch.zeros(7, 2048)
    with pytest.raises(ValueError):
        leaf_rows(ts.trace.ltab, lists.long(), n_rows, rays, 2048)
    with pytest.raises(ValueError):
        leaf_rows(ts.trace.ltab, lists, n_rows, rays, 1024)
    with pytest.raises(ValueError):
        leaf_rows(ts.trace.ltab.double(), lists, n_rows, rays, 2048)

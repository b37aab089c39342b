"""The port's 8-wide stream walks (algo="skip" and "stack", plain version on
the CPU) against surf_tpu: the stream tables against HostCompiled's, the
walks against ``traverse_wide`` in interpret mode, and against the NumPy
stream oracle on the indoor scene.

Gates: prim equal except at coincident-t ties; t within rtol 5e-6 where
both hit (XLA's CPU backend contracts multiply-adds into FMAs, ROADMAP
queue 3); any-hit occlusion masks equal; the rows each packet visits equal
JAX's ``return_visits`` counts (the packet semantics are the same, so the
walks read the same rows).  Against the oracle t is held to rtol 1e-6.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.accel.pallas_wide import device_wide_trace, traverse_wide
from surf_tpu.accel.wide import traverse_stream_np
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.compile import HostCompiled
from surf_tpu_torch.accel.stream import StreamTrace, traverse_stream
from surf_tpu_torch.accel.bits import nudge
from surf_tpu_torch.accel.stream import pack_rays
from surf_tpu_torch.accel.stream_walk import STACK_CAP, stream_walk, stream_walk_plain
from surf_tpu_torch.accel.wide import IS_LEAF_LANE, LANE, REC, stream_depth
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.compile import compile_scene, scene_arrays

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
SCENES = {"box": "make_diffuse_box_scene", "indoor": "make_indoor_scene"}


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    make = SCENES[request.param]
    return HostCompiled(getattr(jbuiltin, make)()), getattr(builtin, make)()


def test_stream_arrays_equal_jax(pair):
    """wide_stream bit for bit (NaN boxes included) and rec_slot equal
    HostCompiled's (its stream is padded to the same sticky capacity), and
    the tree depth read from the stream equals its builder's."""
    host, scene = pair
    got = scene_arrays(scene)
    ref = host.render_scene.trace
    assert np.array_equal(got["wide_stream"].view(np.int32),
                          np.asarray(ref.wide_stream).view(np.int32))
    assert np.array_equal(got["wide_rec_slot"], np.asarray(ref.wide_rec_slot))
    assert stream_depth(got["wide_stream"]) == host._ws.max_depth


@pytest.fixture(scope="module")
def box():
    host = HostCompiled(jbuiltin.make_diffuse_box_scene())
    return device_wide_trace(host._ws), compile_scene(builtin.make_diffuse_box_scene(), CPU)


def _rays(n, seed, span=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:3] = [[1, 0, 0], [0, -1, 0], [0, 0, 1]]  # exercise the zero nudge
    return o, d


def _both(o, d, tmax, act):
    """The same rays for the port (torch) and for JAX."""
    return ([torch.from_numpy(x) for x in (o, d, tmax, act)],
            [jnp.asarray(x) for x in (o, d, tmax, act)])


@pytest.mark.parametrize("block_rays", [1024, 2048])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("algo", ["skip", "stack"])
def test_walk_matches_jax(box, algo, any_hit, block_rays):
    """Box scene, 2048 rays (every 7th inactive): the port's walk against
    JAX's Pallas kernel in interpret mode, hits and per-packet visits."""
    wt, ts = box
    n = 2048
    o, d = _rays(n, seed=7)
    tmax = np.full(n, 8.0 if any_hit else 1e30, np.float32)
    act = np.ones(n, bool)
    act[::7] = False
    port, jax_in = _both(o, d, tmax, act)
    kw = dict(any_hit=any_hit, block_rays=block_rays, algo=algo)
    got = traverse_stream(ts.stream, *port, **kw)
    visits = traverse_stream(ts.stream, *port, return_visits=True, **kw)
    want = traverse_wide(wt, *jax_in, interpret=True, **kw)
    want_visits = traverse_wide(wt, *jax_in, interpret=True, return_visits=True, **kw)
    gp, wp = got.prim.numpy(), np.asarray(want.prim)
    gt, wt_ = got.t.numpy(), np.asarray(want.t)
    assert (gp[~act] == -1).all()
    assert np.array_equal(gp >= 0, wp >= 0)
    if not any_hit:
        assert ((gp == wp) | (gt == wt_)).all()
        both = (gp >= 0) & (wp >= 0)
        np.testing.assert_allclose(gt[both], wt_[both], rtol=5e-6)
    assert np.array_equal(visits.numpy(), np.asarray(want_visits))
    assert (visits > 0).all()


def test_inactive_lanes_and_padding(box):
    """777 rays (not a multiple of the packet): pad rays are inactive, the
    result has 777 entries, inactive rays get -1, and an all-inactive
    packet visits no row."""
    _, ts = box
    n = 777
    o, d = _rays(n, seed=3)
    act = np.arange(n) % 3 == 0
    args = [torch.from_numpy(x) for x in (o, d, np.full(n, 1e30, np.float32), act)]
    for algo in ("skip", "stack"):
        hit = traverse_stream(ts.stream, *args, block_rays=1024, algo=algo)
        assert hit.prim.shape == (n,) and (hit.prim[~torch.from_numpy(act)] == -1).all()
        assert (hit.prim >= 0).any()
        dead = [*args[:3], torch.zeros(n, dtype=torch.bool)]
        visits = traverse_stream(ts.stream, *dead, block_rays=512, algo=algo,
                                 return_visits=True)
        assert visits.tolist() == [0, 0]


@pytest.mark.parametrize("algo", ["skip", "stack"])
def test_indoor_matches_oracle(algo):
    """Indoor scene, 256 rays: prim equal to the NumPy stream oracle's
    (``traverse_stream_np``), t within rtol 1e-6."""
    host = HostCompiled(jbuiltin.make_indoor_scene())
    ts = compile_scene(builtin.make_indoor_scene(), CPU)
    n = 256
    o, d = _rays(n, seed=5, span=3.0)
    tmax = np.full(n, 1e30, np.float32)
    hit = traverse_stream(ts.stream, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(tmax), torch.ones(n, dtype=torch.bool),
                          block_rays=256, algo=algo)
    t_w, rec, _, _ = traverse_stream_np(host._ws, o, d, tmax)
    slot = np.where(rec >= 0, host._ws.rec_slot[np.maximum(rec, 0)], -1)
    assert np.array_equal(hit.prim.numpy(), slot)
    assert (slot >= 0).sum() > n // 4
    np.testing.assert_allclose(hit.t.numpy()[slot >= 0], t_w[slot >= 0], rtol=1e-6)


def _chain_stream(levels: int) -> StreamTrace:
    """A hand-made stream ``levels`` node rows deep: node k (row 2k) has
    the next node in slot 0 and a leaf row (row 2k + 1, one triangle in the
    plane z = k + 1) in slot 1, all boxes [-2, 2]^2 x [0, levels + 2].  A
    packet of +z rays hits every box, so the stack walk pushes at every
    level (the stack grows to ``levels``) and the nearest triangle is the
    first leaf's."""
    rows = np.zeros((2 * levels, LANE), np.float32)
    ints = rows.view(np.int32)
    box = [-2, -2, 0, 2, 2, levels + 2]
    for k in range(levels):
        node, leaf = 2 * k, 2 * k + 1
        rows[node, :] = np.nan
        slots = [(node + 2, 0), (leaf, 1)] if k < levels - 1 else [(leaf, 1)]
        for s, (child, is_leaf) in enumerate(slots):
            rows[node, REC * s:REC * s + 6] = box
            ints[node, REC * s + 6:REC * s + 8] = (child, is_leaf)
        ints[node, IS_LEAF_LANE:IS_LEAF_LANE + 2] = (0, 2 * levels)
        rows[leaf, 0:9] = [-1, -1, k + 1, 3, 0, 0, 0, 3, 0]  # v0, e1, e2
        ints[leaf, IS_LEAF_LANE:IS_LEAF_LANE + 2] = (1, leaf + 1)
    rec_slot = np.full(2 * levels * 8, -1, np.int32)
    rec_slot[np.arange(levels) * 16 + 8] = np.arange(levels)
    assert stream_depth(rows) == levels
    return StreamTrace(torch.from_numpy(rows), torch.from_numpy(rec_slot), levels)


def test_stack_deeper_than_capacity_raises():
    """A 40-level stream (deeper than JAX's fixed 16-entry stack, which
    would drop pushes) walks with a 40-entry stack and agrees with the
    skip walk; a stream deeper than the stack's capacity raises instead of
    overflowing."""
    n = 256
    o = torch.zeros(n, 3)
    o[:, 0] = torch.linspace(-0.5, 0.5, n)
    o[:, 2] = -5.0
    d = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3).contiguous()
    args = (o, d, torch.full((n,), 1e30), torch.ones(n, dtype=torch.bool))
    trace = _chain_stream(40)
    skip = traverse_stream(trace, *args, block_rays=256, algo="skip")
    stack = traverse_stream(trace, *args, block_rays=256, algo="stack")
    assert (skip.prim == 0).all() and torch.equal(skip.t, stack.t)
    assert torch.equal(skip.prim, stack.prim)
    assert traverse_stream(trace, *args, block_rays=256, algo="stack",
                           return_visits=True).tolist() == [80]
    deep = _chain_stream(STACK_CAP + 1)
    assert (traverse_stream(deep, *args, block_rays=256, algo="skip").prim == 0).all()
    with pytest.raises(ValueError, match="deep"):
        traverse_stream(deep, *args, block_rays=256, algo="stack")


@pytest.mark.parametrize("algo,any_hit,want", [
    ("skip", False, [79, 40]), ("stack", False, [79, 40]),
    ("skip", True, [2, 1]), ("stack", True, [79, 1])])
def test_plain_counts_live_tests(algo, any_hit, want):
    """The plain walk's ``work`` on the 40-level chain, 128 of 256 rays
    active, per active ray: closest hit visits every row (39 nodes of two
    children, one of one; 40 one-triangle leaves); any-hit stops at the
    first leaf, which the skip walk reaches after the root and the stack
    walk after every node."""
    n = 256
    o = torch.zeros(n, 3)
    o[:, 0] = torch.linspace(-0.5, 0.5, n)
    o[:, 2] = -5.0
    d = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3).contiguous()
    act = torch.arange(n) < 128
    trace = _chain_stream(40)
    rays, a = pack_rays(o, nudge(d), torch.full((n,), 1e30), act, n)
    work = torch.zeros(1, 2, dtype=torch.int64)
    stream_walk_plain(trace.stream, rays, a, n, algo, any_hit, trace.max_depth, work=work)
    assert work.tolist() == [[128 * want[0], 128 * want[1]]]


def test_stream_walk_rejects_bad_inputs(box):
    _, ts = box
    rays = torch.zeros(7, 1024)
    act = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError):
        stream_walk(ts.stream.stream, rays, act.bool(), 1024)
    with pytest.raises(ValueError):
        stream_walk(ts.stream.stream, rays, act, 1000)
    with pytest.raises(ValueError):
        stream_walk(ts.stream.stream, rays, act, 1024, algo="skip3")

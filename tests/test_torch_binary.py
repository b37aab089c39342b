"""The port's binary-BVH packet walk (use_wide=False, plain version on the
CPU) against surf_tpu: the skip-link and record tables against
HostCompiled's, and the walk against ``traverse_pallas`` in interpret mode
with the gates of tests/test_pallas_kernel.py: closest hit (prim equal, t
within rtol 1e-6, u within 1e-6), any-hit occlusion, inactive lanes and a
ray count that is not a multiple of the 1024-ray packet."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.accel.pallas_traverse import traverse_pallas
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.compile import HostCompiled
from surf_tpu_torch.accel.bvh_walk import bvh_walk, bvh_walk_plain, traverse_binary
from surf_tpu_torch.accel.skiplinks import pack_records_np
from surf_tpu_torch.accel.stream import pack_rays
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.compile import compile_scene, scene_arrays

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
SCENES = {"box": "make_diffuse_box_scene", "indoor": "make_indoor_scene"}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_binary_arrays_equal_jax(name):
    """node_boxes (NaN capacity padding included), node_meta, nodes_packed
    and tris_packed bit for bit equal to HostCompiled's."""
    make = SCENES[name]
    ref = HostCompiled(getattr(jbuiltin, make)()).render_scene.trace
    got = scene_arrays(getattr(builtin, make)())
    for key in ("node_boxes", "node_meta", "nodes_packed", "tris_packed"):
        a, b = got[key], np.asarray(getattr(ref, key))
        assert a.shape == b.shape and a.dtype == b.dtype, key
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), key
    assert np.isnan(got["node_boxes"][-1]).all()


def test_pack_records_layout():
    f = [np.arange(10, dtype=np.float32) + i for i in range(6)]
    i = [np.arange(10, dtype=np.int32) * (k + 1) for k in range(3)]
    packed = pack_records_np(f, i)
    assert packed.shape == (8, 128)
    assert packed[1, 16] == np.float32(9.0)  # f32 col 0 of record 9
    ints = packed.view(np.int32)
    assert ints[1, 16 + 6] == 9 and ints[1, 16 + 8] == 27


@pytest.fixture(scope="module")
def box():
    return (HostCompiled(jbuiltin.make_diffuse_box_scene()).render_scene.trace,
            compile_scene(builtin.make_diffuse_box_scene(), CPU))


def _run(box, n, seed, tmax_v, any_hit, act=None):
    trace, ts = box
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[0] = [0, 0, 1]  # zero components: 1/0 = inf, not nudged
    tmax = np.full(n, tmax_v, np.float32)
    act = np.ones(n, bool) if act is None else act
    got = traverse_binary(ts.binary, *(torch.from_numpy(x) for x in (o, d, tmax, act)),
                          any_hit=any_hit)
    want = traverse_pallas(trace, *(jnp.asarray(x) for x in (o, d, tmax, act)),
                           any_hit, interpret=True)
    return ([x.numpy() for x in got], [np.asarray(x) for x in want])


def test_closest_matches_jax(box):
    got, want = _run(box, 2048, 0, 1e30, False)
    assert np.array_equal(got[0], want[0])
    both = want[0] >= 0
    assert both.sum() > 100
    np.testing.assert_allclose(got[1][both], want[1][both], rtol=1e-6)
    np.testing.assert_allclose(got[2][both], want[2][both], atol=1e-6)


def test_any_hit_matches_jax(box):
    got, want = _run(box, 2048, 1, 8.0, True)
    assert np.array_equal(got[0] >= 0, want[0] >= 0)
    assert (got[0] >= 0).any() and (got[0] < 0).any()


def test_inactive_lanes(box):
    act = np.arange(1024) % 3 == 0
    got, want = _run(box, 1024, 2, 1e30, False, act)
    assert (got[0][~act] == -1).all()
    assert np.array_equal(got[0], want[0])


def test_nonmultiple_block_padding(box):
    got, want = _run(box, 777, 3, 1e30, False)
    assert got[0].shape == (777,)
    assert np.array_equal(got[0], want[0])


def test_counts_and_dead_packet(box):
    """Per packet the nodes visited and the triangles tested; a packet with
    no active ray visits nothing."""
    _, ts = box
    n = 2048
    rng = np.random.default_rng(4)
    o = torch.from_numpy(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(n, 3)).astype(np.float32)), dim=1)
    act = torch.ones(n, dtype=torch.bool)
    act[1024:] = False
    rays, a = pack_rays(o, d, torch.full((n,), 1e30), act, 1024)
    tr = ts.binary
    *_, counts = bvh_walk(tr.nodes, tr.tris, tr.n_nodes, rays, a)
    assert counts[1].tolist() == [0, 0]
    assert 0 < int(counts[0, 0]) <= tr.n_nodes and int(counts[0, 1]) > 0
    with pytest.raises(ValueError):
        bvh_walk(tr.nodes, tr.tris, tr.n_nodes, rays[:, :1000], a[:1000])


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_plain_counts_live_tests(box, any_hit):
    """The plain walk's ``work``: for closest hit every active ray tests
    each node visited and each triangle tested (the packet's counts times
    its active rays); any-hit tests no more than that; a packet with no
    active ray adds nothing."""
    _, ts = box
    n = 2048
    rng = np.random.default_rng(5)
    o = torch.from_numpy(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(n, 3)).astype(np.float32)), dim=1)
    act = torch.ones(n, dtype=torch.bool)
    act[::3] = False
    act[1024:] = False
    rays, a = pack_rays(o, d, torch.full((n,), 4.0 if any_hit else 1e30), act, 1024)
    tr = ts.binary
    work = torch.zeros(2, 2, dtype=torch.int64)
    *_, counts = bvh_walk_plain(tr.nodes, tr.tris, tr.n_nodes, rays, a, any_hit, work=work)
    full = counts.long() * a.view(2, 1024).sum(1, keepdim=True)
    assert work[1].tolist() == [0, 0] and int(work[0, 0]) > 0 and int(work[0, 1]) > 0
    if any_hit:
        assert (work <= full).all() and int(work[0, 1]) < int(full[0, 1])
    else:
        assert torch.equal(work, full)

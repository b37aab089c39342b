"""The stream walk's TPU schedules in the port (algo="skip2", "ilvN",
"specN", "specbN"; plain versions on the CPU) against surf_tpu: the walks
against ``traverse_wide`` in interpret mode, the speculative walks'
any-hit visit counts on a set in which every ray hits, the speculative
walks against the port's own ``skip``, and box renders against JAX's
render of the same algo.

Gates: those of tests/test_torch_stream.py (prim equal except at
coincident-t ties, t within rtol 5e-6 where both hit: XLA's CPU backend
contracts multiply-adds into FMAs, ROADMAP queue 3; any-hit occlusion
masks equal; per-packet visits equal to JAX's ``return_visits``) and the
render gate of tests/test_torch_walks.py.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.accel.pallas_wide import device_wide_trace, traverse_wide
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.camera import CameraParams as JCameraParams
from surf_tpu.scene.compile import HostCompiled
from surf_tpu.wavefront import RenderConfig as JRenderConfig
from surf_tpu.wavefront import integrator as jint
from surf_tpu_torch.accel.stream import StreamTrace, traverse_stream
from surf_tpu_torch.accel.stream_walk import ALGOS, parse_algo, stream_walk
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams
from surf_tpu_torch.scene.compile import compile_scene
from surf_tpu_torch.wavefront.integrator import (BENCH_KNOBS, RenderConfig,
                                                 initial_seeds, render_frame_seeded)

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def box():
    host = HostCompiled(jbuiltin.make_diffuse_box_scene())
    return device_wide_trace(host._ws), compile_scene(builtin.make_diffuse_box_scene(), CPU)


@pytest.fixture(scope="module")
def indoor():
    return compile_scene(builtin.make_indoor_scene(), CPU)


@pytest.fixture(scope="module")
def indoor_wide():
    return device_wide_trace(HostCompiled(jbuiltin.make_indoor_scene())._ws)


def _rays(n, seed, span):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("algo,block_rays", [
    ("skip2", 2048), ("ilv2", 2048), ("ilv2", 1024), ("spec2", 2048), ("spec4", 2048),
    ("specb4", 2048), ("specb8", 2048)])
def test_schedule_matches_jax(box, algo, block_rays, any_hit):
    """Box scene, 2048 rays (every 7th inactive, three axis directions for
    the zero nudge): the port's plain walk against JAX's Pallas kernel in
    interpret mode, hits and per-packet visits."""
    wt, ts = box
    n = 2048
    o, d = _rays(n, seed=7, span=6.0)
    d[:3] = [[1, 0, 0], [0, -1, 0], [0, 0, 1]]
    tmax = np.full(n, 8.0 if any_hit else 1e30, np.float32)
    act = np.ones(n, bool)
    act[::7] = False
    port = [torch.from_numpy(x) for x in (o, d, tmax, act)]
    jax_in = [jnp.asarray(x) for x in (o, d, tmax, act)]
    kw = dict(any_hit=any_hit, block_rays=block_rays, algo=algo)
    got = traverse_stream(ts.stream, *port, **kw)
    visits = traverse_stream(ts.stream, *port, return_visits=True, **kw)
    want = traverse_wide(wt, *jax_in, interpret=True, **kw)
    want_visits = traverse_wide(wt, *jax_in, interpret=True, return_visits=True, **kw)
    gp, wp = got.prim.numpy(), np.asarray(want.prim)
    gt, wt_ = got.t.numpy(), np.asarray(want.t)
    assert (gp[~act] == -1).all() and (gp >= 0).any()
    assert np.array_equal(gp >= 0, wp >= 0)
    if not any_hit:
        assert ((gp == wp) | (gt == wt_)).all()
        both = (gp >= 0) & (wp >= 0)
        np.testing.assert_allclose(gt[both], wt_[both], rtol=5e-6)
    assert np.array_equal(visits.numpy(), np.asarray(want_visits))
    assert (visits > 0).all()


def _all_hit_rays(n=2048):
    """Rays from (0, 1, 0) +- 0.2 in random directions, inside the indoor
    room: every one hits."""
    rng = np.random.default_rng(1)
    o = (np.array([0, 1, 0]) + rng.uniform(-0.2, 0.2, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.from_numpy(o), torch.from_numpy(d), torch.full((n,), 1e30),
            torch.ones(n, dtype=torch.bool)]


@pytest.mark.parametrize("algo,want", [
    ("skip", [180, 195]), ("spec2", [182, 197]), ("specb8", [182, 197])])
def test_all_hit_any_hit_counts(indoor, indoor_wide, algo, want):
    """Indoor scene, 2048 rays that all hit, any-hit in 1024-ray packets:
    the per-packet visits equal those of JAX's kernel in interpret mode on
    the same rays, and the counts surf_tpu gave there (``want``).  The
    speculative walks check "every active ray has a hit" only between
    groups of windows (32 for spec, 8 for specb), so they walk two rows
    further than skip."""
    args = _all_hit_rays()
    kw = dict(any_hit=True, block_rays=1024, algo=algo)
    hit = traverse_stream(indoor.stream, *args, **kw)
    assert (hit.prim >= 0).all()
    visits = traverse_stream(indoor.stream, *args, return_visits=True, **kw)
    jax_in = [jnp.asarray(x.numpy()) for x in args]
    want_visits = traverse_wide(indoor_wide, *jax_in, interpret=True, return_visits=True, **kw)
    assert visits.tolist() == np.asarray(want_visits).tolist()
    assert visits.tolist() == want


@pytest.mark.parametrize("algo", ["spec4", "specb8"])
def test_spec_matches_skip_indoor(indoor, algo):
    """Indoor scene, 2048 rays: the speculative walk against the port's own
    skip walk, the gate of tests/test_wide_kernel.py's
    test_wide_algos_match_skip_indoor (closest hit: prim and t equal;
    any-hit at t_max 8: occlusion equal)."""
    n = 2048
    o, d = (torch.from_numpy(x) for x in _rays(n, seed=8, span=3.0))
    act = torch.ones(n, dtype=torch.bool)
    far = torch.full((n,), 1e30)
    hs = traverse_stream(indoor.stream, o, d, far, act, algo="skip")
    hk = traverse_stream(indoor.stream, o, d, far, act, algo=algo)
    assert torch.equal(hs.prim, hk.prim) and torch.equal(hs.t, hk.t)
    near = torch.full((n,), 8.0)
    ha_s = traverse_stream(indoor.stream, o, d, near, act, any_hit=True, algo="skip")
    ha_k = traverse_stream(indoor.stream, o, d, near, act, any_hit=True, algo=algo)
    assert torch.equal(ha_s.prim >= 0, ha_k.prim >= 0)


def test_algo_names():
    """The accepted names and their (walk, width); other names, and a specb
    window longer than the stream, raise."""
    assert len(ALGOS) == 2 + 1 + 4 + 8 + 8
    assert parse_algo("skip2") == ("ilv", 2) and parse_algo("ilv4") == ("ilv", 4)
    assert parse_algo("spec8") == ("spec", 8) and parse_algo("specb1") == ("specb", 1)
    for bad in ("skip3", "ilv0", "ilv5", "spec0", "spec9", "specb16", "specb", "bitsru8"):
        with pytest.raises(ValueError):
            parse_algo(bad)
    stream = torch.zeros(4, 128)
    rays = torch.zeros(7, 512)
    act = torch.zeros(512, dtype=torch.int32)
    assert stream_walk(stream, rays, act, 512, "specb4")[4].tolist() == [[0, 0, 0]]
    with pytest.raises(ValueError, match="longer than the stream"):
        stream_walk(stream, rays, act, 512, "specb8")
    tiny = StreamTrace(stream, torch.full((32,), -1, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="longer than the stream"):
        traverse_stream(tiny, torch.zeros(1, 3), torch.ones(1, 3), torch.ones(1),
                        torch.ones(1, dtype=torch.bool), algo="specb5")


W = H = 32


@pytest.mark.parametrize("algo", ["ilv2", "spec4"])
def test_schedule_render_matches_jax(box, algo):
    """32x32 @ 2 spp of the box scene with the bench knobs through the
    schedule's plain walk, against JAX's render of the same algo (its
    Pallas kernel in interpret mode)."""
    _, ts = box
    cfg = RenderConfig.for_scene(ts, W, H, 2, use_defocus=True)._replace(
        **BENCH_KNOBS, algo=algo)
    cam = CameraParams.from_camera(builtin.make_box_camera(W, H), CPU)
    img, _ = render_frame_seeded(ts, cfg, cam, initial_seeds(cfg, 0, CPU))
    img = img.numpy()
    assert np.isfinite(img).all() and (img >= 0).all() and img.sum() > 0
    host = HostCompiled(jbuiltin.make_diffuse_box_scene())
    jcfg = JRenderConfig.for_scene(host.static, W, H, 2, use_defocus=True,
                                   use_pallas=True)._replace(
        max_bounces=None, pallas_interpret=True, **BENCH_KNOBS, algo=algo)
    jcam = JCameraParams.from_camera(jbuiltin.make_box_camera(W, H))
    jimg, _ = jint.render_frame_seeded(host.render_scene, jcfg, jcam,
                                       jint.initial_seeds(jcfg, jnp.uint32(0)))
    ref = np.asarray(jimg)
    diff = np.abs(ref - img).max(axis=2)
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert abs(ref.sum() - img.sum()) / abs(ref.sum()) < 0.01

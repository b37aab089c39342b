"""Hybrid two-level rendering (algo="twolevel") and the pure refresh of
surf_tpu_torch against surf_tpu: the hybrid tables and prim map of
HostCompiled(two_level=True), as built and after a rebuild; the hybrid
render against JAX's (Pallas kernel in interpret mode) and against the
port's flattened render, with tests/test_instanced.py:163-166's gate; the
pure refresh against JAX's and against a fresh pure compile."""

import functools
import warnings
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.accel import pallas_instanced as jpi
from surf_tpu.core import transform as jtf
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.camera import CameraParams as JCameraParams
from surf_tpu.scene.compile import HostCompiled as JHostCompiled
from surf_tpu.wavefront import RenderConfig as JRenderConfig
from surf_tpu.wavefront import integrator as jint
from surf_tpu_torch.core import transform as tf
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams
from surf_tpu_torch.scene.compile import (HostCompiled, HybridScene, PureScene,
                                          compile_scene, from_render_scene)
from surf_tpu_torch.wavefront.integrator import (RenderConfig, initial_seeds,
                                                 render_frame_seeded)

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
SCENES = {"box": "make_diffuse_box_scene", "indoor": "make_indoor_scene"}
HYBRID_KEYS = ("inst_ltab", "inst_box_lo", "inst_box_hi", "inst_inv", "inst_wlo",
               "inst_whi", "inst_prim_map", "inst_prim_base")
MOVED = jtf.translate(jtf.identity(), [0.6, 0.2, 0.0])  # tests/test_instanced.py:280


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _jax_leaves(host: JHostCompiled) -> dict:
    rs = host.render_scene
    out = {k: np.asarray(v) for k, v in rs._asdict().items()
           if k != "trace" and v is not None}
    out.update({k: np.asarray(v) for k, v in rs.trace._asdict().items() if v is not None})
    return out


def _flat(scene) -> dict:
    """Every tensor and scalar of a scene, nested traces by dotted name
    (a tuple of tensors by index)."""
    out = {}
    for f, v in scene._asdict().items():
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out.update({f"{f}.{k}": x for k, x in _flat(v).items()})
        elif isinstance(v, tuple) and all(isinstance(x, torch.Tensor) for x in v):
            out.update({f"{f}.{k}": x for k, x in enumerate(v)})
        else:
            out[f] = v
    return out


def _equal_scenes(a, b) -> None:
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k, x in fa.items():
        assert (_same(x, fb[k]) if isinstance(x, torch.Tensor) else x == fb[k]), k


def _check_hybrid(jh: JHostCompiled, ph: HostCompiled) -> None:
    ref = _jax_leaves(jh)
    assert ph.inst_meta == tuple(jh.static.inst_meta)
    for key in HYBRID_KEYS:
        assert _same(ph.arrays[key], ref[key]), key
    for key, val in ph.arrays.items():
        assert _same(val, ref[key]), key
    ts = ph.scene
    assert isinstance(ts, HybridScene)
    assert _same(ts.inst_prim_map, ref["inst_prim_map"]) and _same(ts.inst.inv, ref["inst_inv"])
    assert _same(ts.inst.inst_lo, ref["inst_wlo"]) and _same(ts.inst.ltab, ref["inst_ltab"])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_hybrid_arrays_equal_jax(name):
    make = SCENES[name]
    _check_hybrid(JHostCompiled(getattr(jbuiltin, make)(), two_level=True),
                  HostCompiled(getattr(builtin, make)(), CPU, two_level=True))


@pytest.mark.parametrize("rebuild", [False, True], ids=["refit", "rebuild"])
def test_hybrid_arrays_after_update_equal_jax(rebuild):
    """After update(0.3): the transforms refreshed on a refit, and the map
    re-derived from the new perm on a rebuild; the hybrid leaves carried
    across equal the port's own scene."""
    jh = JHostCompiled(jbuiltin.make_indoor_scene(), two_level=True)
    ph = HostCompiled(builtin.make_indoor_scene(), CPU, two_level=True)
    map0 = ph.arrays["inst_prim_map"]
    inv0 = ph.scene.inst.inv
    jh.update(0.3, rebuild=rebuild)
    ph.update(0.3, rebuild=rebuild)
    _check_hybrid(jh, ph)
    assert not _same(ph.scene.inst.inv, inv0)
    assert _same(ph.arrays["inst_prim_map"], map0) != rebuild
    _equal_scenes(from_render_scene(_jax_leaves(jh), CPU, tuple(jh.static.inst_meta)),
                  ph.scene)


W = H = 24


def _gate(ref, img):
    """tests/test_instanced.py:163-166: under 1% of pixels off by more than
    1e-3, energy within 0.5%."""
    d = np.abs(ref - img).max(axis=2)
    assert (d > 1e-3).mean() < 0.01, d.max()
    assert abs(ref.sum() - img.sum()) / abs(ref.sum()) < 0.005


def _port_render(ts, algo):
    cfg = RenderConfig.for_scene(ts, W, H, 1, use_defocus=True)._replace(
        wave_limit=8, compact=True, block_rays=1024, algo=algo)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(W, H), CPU)
    img, _ = render_frame_seeded(ts, cfg, cam, initial_seeds(cfg, 0, CPU))
    return img.numpy()


@pytest.fixture(scope="module")
def port_box_twolevel():
    img = _port_render(compile_scene(builtin.make_diffuse_box_scene(), CPU, two_level=True),
                       "twolevel")
    assert np.isfinite(img).all() and (img >= 0).all() and img.sum() > 0
    return img


def test_twolevel_matches_jax(port_box_twolevel):
    """The box at 24x24 @ 1 spp, wave cap 8, compaction on: the port's
    twolevel render against JAX's (Pallas kernel in interpret mode,
    unroll=1: rows per loop trip, which the result does not depend on)."""
    h = JHostCompiled(jbuiltin.make_diffuse_box_scene(), two_level=True)
    cfg = JRenderConfig.for_scene(h.static, W, H, 1, use_defocus=True, use_pallas=True)._replace(
        max_bounces=None, wave_limit=8, compact=True, pallas_interpret=True,
        algo="twolevel", block_rays=1024)
    cp = JCameraParams.from_camera(jbuiltin.make_indoor_camera(W, H))
    with mock.patch.object(jpi, "traverse_instanced_arrays", functools.partial(
            jpi.traverse_instanced_arrays, unroll=1)):
        img, _ = jint.render_frame_seeded(h.render_scene, cfg, cp,
                                          jint.initial_seeds(cfg, jnp.uint32(0)))
    _gate(np.asarray(img), port_box_twolevel)


def test_twolevel_matches_flattened(port_box_twolevel):
    """The same render against the port's flattened bitsru8 render of the
    same hybrid scene (its flattened tables)."""
    ts = compile_scene(builtin.make_diffuse_box_scene(), CPU, two_level=True)
    _gate(_port_render(ts, "bitsru8"), port_box_twolevel)


def _move(scene, transform):
    scene.instances[1].set_transform(transform)


def test_pure_refresh_equals_jax():
    """The pure refresh after moving the middle box: every leaf equals
    JAX's refreshed pure HostCompiled; the shared tables keep their
    tensors."""
    js, ps = jbuiltin.make_diffuse_box_scene(), builtin.make_diffuse_box_scene()
    jh = JHostCompiled(js, two_level="pure")
    ph = HostCompiled(ps, CPU, two_level="pure")
    before = ph.scene
    _move(js, MOVED)
    _move(ps, tf.translate(tf.identity(), [0.6, 0.2, 0.0]))
    jh.refresh()
    ph.refresh()
    ref = _jax_leaves(jh)
    assert ph.inst_meta == tuple(jh.static.inst_meta)
    for key, val in ph.arrays.items():
        assert _same(val, ref[key]), key
    assert not _same(ph.scene.inst.inv, before.inst.inv)
    assert ph.scene.inst.ltab is before.inst.ltab and ph.scene.obj_v0 is before.obj_v0


def test_pure_refresh_render_equals_fresh_compile():
    """tests/test_instanced.py:243-289: the refreshed render is bit-equal to
    a fresh pure compile's of the same state, and the move changes it."""
    moved = tf.translate(tf.identity(), [0.6, 0.2, 0.0])
    scene = builtin.make_diffuse_box_scene()
    ph = HostCompiled(scene, CPU, two_level="pure")
    img0 = _port_render(ph.scene, "twolevelp")
    _move(scene, moved)
    ph.refresh()
    img1 = _port_render(ph.scene, "twolevelp")
    assert not np.allclose(img0, img1)
    fresh = builtin.make_diffuse_box_scene()
    _move(fresh, moved)
    ps = compile_scene(fresh, CPU, two_level="pure")
    assert isinstance(ps, PureScene)
    _equal_scenes(ps, ph.scene)
    assert np.array_equal(img1, _port_render(ps, "twolevelp"))


def test_facade_follows_host_update():
    """WavefrontRenderer over a hybrid HostCompiled renders the host's
    current scene each frame: after update(0.3) the second frame is the
    moved scene's twolevel frame."""
    from surf_tpu_torch.app.renderer import RendererConfigHost, WavefrontRenderer
    from surf_tpu_torch.wavefront.integrator import render_frame

    ph = HostCompiled(builtin.make_indoor_scene(), CPU, two_level=True)
    camera = builtin.make_indoor_camera(16, 16)
    wf = WavefrontRenderer(ph, camera, RendererConfigHost(samples_per_frame=1), CPU,
                           algo="twolevel")
    first = wf.render()
    ph.update(0.3)
    second = 2 * wf.render() - first  # the accumulator averages the two frames
    cfg = wf._rcfg
    want = render_frame(ph.scene, cfg, CameraParams.from_camera(camera, CPU), 1, CPU).numpy()
    np.testing.assert_allclose(second, want, rtol=1e-5, atol=1e-6)
    stale = render_frame(compile_scene(builtin.make_indoor_scene(), CPU, two_level=True), cfg,
                         CameraParams.from_camera(camera, CPU), 1, CPU).numpy()
    assert not np.allclose(stale, want)

"""Pure two-level rendering (algo="twolevelp") of surf_tpu_torch against
surf_tpu: the pure compile carried across from HostCompiled(two_level=
"pure"), the render against JAX's twolevelp render (Pallas kernel in
interpret mode) and against the port's own flattened bitsru8 render, with
the gates of tests/test_instanced.py:215-216."""

import functools
import warnings
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.accel import pallas_instanced as jpi
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.camera import CameraParams as JCameraParams
from surf_tpu.scene.compile import HostCompiled
from surf_tpu.wavefront import RenderConfig as JRenderConfig
from surf_tpu.wavefront import integrator as jint
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams
from surf_tpu_torch.scene.compile import (PureScene, compile_scene,
                                          from_render_scene, pure_scene_arrays)
from surf_tpu_torch.wavefront.integrator import (RenderConfig, initial_seeds,
                                                 render_frame_seeded)

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
SCENES = {"box": lambda m: m.make_diffuse_box_scene(),
          "stress8": lambda m: m.make_instanced_stress_scene(8)}


def _jax_leaves(host: HostCompiled) -> dict:
    rs = host.render_scene
    out = {k: np.asarray(v) for k, v in rs._asdict().items()
           if k != "trace" and v is not None}
    out.update({k: np.asarray(v) for k, v in rs.trace._asdict().items()
                if v is not None})
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _flat(ps: PureScene) -> dict:
    out = {f: getattr(ps, f) for f in PureScene._fields if f != "inst"}
    for f in ps.inst._fields:
        v = getattr(ps.inst, f)
        if isinstance(v, tuple) and all(isinstance(x, torch.Tensor) for x in v):
            out.update({f"inst.{f}.{k}": x for k, x in enumerate(v)})
        else:
            out[f"inst.{f}"] = v
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    make = SCENES[request.param]
    return HostCompiled(make(jbuiltin), two_level="pure"), make(builtin)


def test_pure_arrays_equal_jax(pair):
    host, scene = pair
    ref = _jax_leaves(host)
    got, meta = pure_scene_arrays(scene)
    assert meta == tuple(host.static.inst_meta)
    for key, val in got.items():
        assert np.array_equal(_bits(val), _bits(ref[key])), key
    assert np.array_equal(ref["inst_xf"][:, :12], ref["inst_inv"])


def test_from_render_scene_equals_compile(pair):
    """JAX's pure RenderScene leaves -> PureScene equals the port's own
    pure compile of the same scene, tensor for tensor."""
    host, scene = pair
    got = _flat(from_render_scene(_jax_leaves(host), CPU,
                                  tuple(host.static.inst_meta)))
    own = _flat(compile_scene(scene, CPU, two_level="pure"))
    assert got.keys() == own.keys()
    for f, val in got.items():
        if isinstance(val, np.ndarray):
            assert np.array_equal(_bits(val), _bits(own[f])), f
        else:
            assert val == own[f], f
    assert got["num_lights"] == host.static.num_lights


W = H = 24


def _gate(ref, img):
    """tests/test_instanced.py:215-216: under 1% of pixels off by more
    than 1e-3, energy within 0.5%."""
    d = np.abs(ref - img).max(axis=2)
    assert (d > 1e-3).mean() < 0.01, d.max()
    assert abs(ref.sum() - img.sum()) / abs(ref.sum()) < 0.005


def _port_render(ts):
    cfg = RenderConfig.for_scene(ts, W, H, 1, use_defocus=True)._replace(
        wave_limit=8, compact=True, block_rays=1024)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(W, H), CPU)
    img, _ = render_frame_seeded(ts, cfg, cam, initial_seeds(cfg, 0, CPU))
    return cfg, img.numpy()


@pytest.fixture(scope="module")
def port_box_twolevelp():
    cfg, img = _port_render(compile_scene(builtin.make_diffuse_box_scene(), CPU,
                                          two_level="pure"))
    assert cfg.algo == "twolevelp"
    assert np.isfinite(img).all() and (img >= 0).all() and img.sum() > 0
    return img


def test_twolevelp_matches_jax(port_box_twolevelp):
    """The diffuse box scene at 24x24 @ 1 spp, wave cap 8, compaction on:
    the port's twolevelp render against JAX's, whose Pallas kernel runs in
    interpret mode (unroll=1: rows per loop trip, which the result does
    not depend on, so the interpreter takes seconds, not minutes)."""
    hp = HostCompiled(jbuiltin.make_diffuse_box_scene(), two_level="pure")
    cfg = JRenderConfig.for_scene(
        hp.static, W, H, 1, use_defocus=True, use_pallas=True,
    )._replace(max_bounces=None, wave_limit=8, compact=True,
               pallas_interpret=True, algo="twolevelp", block_rays=1024)
    cp = JCameraParams.from_camera(jbuiltin.make_indoor_camera(W, H))
    with mock.patch.object(jpi, "traverse_instanced_arrays", functools.partial(
            jpi.traverse_instanced_arrays, unroll=1)):
        img, _ = jint.render_frame_seeded(hp.render_scene, cfg, cp,
                                          jint.initial_seeds(cfg, jnp.uint32(0)))
    _gate(np.asarray(img), port_box_twolevelp)


def test_twolevelp_matches_flattened(port_box_twolevelp):
    """The same render against the port's flattened bitsru8 render."""
    cfg, img = _port_render(compile_scene(builtin.make_diffuse_box_scene(), CPU))
    assert cfg.algo == "bitsru8"
    _gate(img, port_box_twolevelp)


def test_algo_checks():
    """The combinations that stay invalid: twolevel on a scene without
    instanced tables (JAX asserts, integrator.py:273-274), twolevelp on a
    flattened scene (hybrid or not), and an unknown two_level."""
    ts = compile_scene(builtin.make_diffuse_box_scene(), CPU)
    hs = compile_scene(builtin.make_diffuse_box_scene(), CPU, two_level=True)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(8, 8), CPU)
    cfg = RenderConfig.for_scene(ts, 8, 8, 1, use_defocus=False)
    for scene, bad in ((ts, cfg._replace(algo="twolevel")), (ts, cfg._replace(algo="twolevelp")),
                       (hs, cfg._replace(algo="twolevelp"))):
        with pytest.raises(ValueError):
            render_frame_seeded(scene, bad, cam, initial_seeds(cfg, 0, CPU))
    with pytest.raises(ValueError):
        compile_scene(builtin.make_diffuse_box_scene(), CPU, two_level="hybrid")

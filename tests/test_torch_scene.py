"""surf_tpu_torch.scene and ray generation against surf_tpu: the compiled
scene arrays, the TorchScene hand-over, the view plane and primary rays."""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.camera import CameraParams as JCameraParams
from surf_tpu.scene.camera import view_plane_jnp
from surf_tpu.scene.compile import HostCompiled
from surf_tpu.wavefront import integrator as jint
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams, view_plane
from surf_tpu_torch.scene.compile import (TorchScene, compile_scene,
                                          from_render_scene, scene_arrays)
from surf_tpu_torch.wavefront import integrator

CPU = torch.device("cpu")
SCENES = {"box": "make_diffuse_box_scene", "indoor": "make_indoor_scene"}


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    """(HostCompiled of the JAX package, the port's scene) for one scene."""
    make = SCENES[request.param]
    return (HostCompiled(getattr(jbuiltin, make)()),
            getattr(builtin, make)())


def _render_scene_arrays(host: HostCompiled) -> dict:
    rs = host.render_scene
    out = {k: np.asarray(v) for k, v in rs._asdict().items()
           if k != "trace" and v is not None}
    out.update({k: np.asarray(v) for k, v in rs.trace._asdict().items()
                if v is not None})
    return out


def _bits(a):
    """Compare float arrays by bit pattern (the leaf table's slot lanes
    hold int32 ids, and -1 reads as a NaN)."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_compiled_arrays_equal_jax(pair):
    host, scene = pair
    ref = _render_scene_arrays(host)
    got = scene_arrays(scene)
    assert "wide_ltabw" in got  # the Baldwin–Weber table of the w algos
    for key, val in got.items():
        assert np.array_equal(_bits(val), _bits(ref[key])), key


# TorchScene trace fields -> RenderScene / TraceArrays leaf.
KEY_OF = {"ltab": "wide_ltab", "ltabw": "wide_ltabw", "box_lo": "wide_box_lo",
          "box_hi": "wide_box_hi", "anc": "wide_anc", "stream.stream": "wide_stream",
          "stream.rec_slot": "wide_rec_slot", "binary.nodes": "nodes_packed",
          "binary.tris": "tris_packed"}


def _flat(ts: TorchScene) -> dict:
    """TorchScene fields (trace fields inlined, those of the stream and
    binary traces as ``stream.*`` / ``binary.*``) as numpy arrays or ints."""
    out = {f: getattr(ts, f) for f in TorchScene._fields
           if f not in ("trace", "stream", "binary")}
    out.update(ts.trace._asdict())
    for name in ("stream", "binary"):
        out.update({f"{name}.{k}": v for k, v in getattr(ts, name)._asdict().items()})
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def test_from_render_scene_round_trip(pair):
    """JAX RenderScene leaves -> TorchScene -> numpy gives the leaves back,
    and equals the port's own compile of the same scene."""
    host, scene = pair
    ref = _render_scene_arrays(host)
    got = _flat(from_render_scene(ref, CPU))
    own = _flat(compile_scene(scene, CPU))
    assert got.pop("num_lights") == host.static.num_lights
    assert got.pop("inert_row") == ref["wide_ltab"].shape[0] - 1
    # the stream depth is read from the stream; HostCompiled keeps its own
    assert got.pop("stream.max_depth") == own.pop("stream.max_depth") == host._ws.max_depth
    assert got.pop("binary.n_nodes") == own.pop("binary.n_nodes") == ref["node_boxes"].shape[0]
    for f, val in got.items():
        assert np.array_equal(_bits(val), _bits(ref[KEY_OF.get(f, f)])), f
    for f, val in got.items():
        assert np.array_equal(_bits(val), _bits(own[f])), f


@pytest.mark.parametrize("wh", [(32, 32), (24, 16), (512, 512)])
def test_view_plane_matches_jax(wh):
    w, h = wh
    cam = builtin.make_indoor_camera(w, h)
    got = view_plane(CameraParams.from_camera(cam, CPU), w, h)
    want = view_plane_jnp(JCameraParams.from_camera(
        jbuiltin.make_indoor_camera(w, h)), w, h)
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)


@pytest.mark.parametrize("order", ["native", "morton"])
def test_ray_generation_matches_jax(order):
    """Seeds exact (same draws per lane, defocus redraws included),
    origins and directions within 1e-6."""
    w, h = 64, 48
    n = w * h
    ts_cfg = integrator.RenderConfig(width=w, height=h, spp=1,
                                     use_defocus=True, num_lights=1,
                                     pixel_order=order)
    j_cfg = jint.RenderConfig(width=w, height=h, spp=1, use_defocus=True,
                              stack_depth=8, num_lights=1, pixel_order=order)
    perm = integrator.lane_pixel_perm(ts_cfg, CPU)
    jperm = jint.lane_pixel_perm(j_cfg)
    lane = np.arange(n) if perm is None else perm.numpy()
    assert np.array_equal(lane, np.arange(n) if jperm is None else np.asarray(jperm))

    seed = np.random.default_rng(3).integers(1, 2**32, n, dtype=np.uint64)
    px, py = lane % w, lane // w
    vp = view_plane(CameraParams.from_camera(builtin.make_indoor_camera(w, h), CPU), w, h)
    s_t, o_t, d_t = integrator.ray_generation(
        ts_cfg, vp, torch.from_numpy(seed.astype(np.int64)),
        torch.from_numpy(px), torch.from_numpy(py))
    jvp = view_plane_jnp(JCameraParams.from_camera(jbuiltin.make_indoor_camera(w, h)), w, h)
    s_j, o_j, d_j = jint.ray_generation(
        j_cfg, jvp, jnp.asarray(seed.astype(np.uint32)),
        jnp.asarray(px.astype(np.int32)), jnp.asarray(py.astype(np.int32)))
    assert np.array_equal(s_t.numpy().astype(np.uint32), np.asarray(s_j))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6, atol=1e-6)


def test_port_imports_without_jax():
    """With jax blocked, every port module imports and the indoor scene
    compiles: the port reaches no JAX, directly or through surf_tpu."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import importlib, pkgutil, torch
        import surf_tpu_torch
        for m in pkgutil.walk_packages(surf_tpu_torch.__path__, "surf_tpu_torch."):
            importlib.import_module(m.name)
        from surf_tpu_torch.scene import builtin
        from surf_tpu_torch.scene.compile import compile_scene
        ts = compile_scene(builtin.make_indoor_scene(), torch.device("cpu"))
        assert ts.num_lights == 2 and ts.trace.ltab.shape[1] == 128
        assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules
                       if sys.modules[k] is not None)
        print("OK", ts.perm.shape[0])
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")

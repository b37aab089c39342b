"""Animation of surf_tpu_torch (Scene.update, builder.refit,
refit_wide_stream, HostCompiled.update with a refit and with a rebuild)
against surf_tpu: the host arrays bit for bit, padding included, and the
renders of the moved indoor scene under tests/test_animation.py's gate and
tests/test_torch_render.py's."""

import warnings
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.accel import builder as jbuilder
from surf_tpu.accel import native as jnative
from surf_tpu.accel import wide as jwide
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.camera import CameraParams as JCameraParams
from surf_tpu.scene.compile import HostCompiled as JHostCompiled
from surf_tpu.wavefront import RenderConfig as JRenderConfig
from surf_tpu.wavefront import render_frame_jit
from surf_tpu_torch.accel import builder, wide
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams
from surf_tpu_torch.scene.compile import HostCompiled, TorchScene, from_render_scene
from surf_tpu_torch.wavefront.integrator import (RenderConfig, initial_seeds,
                                                 render_frame_seeded)

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
DT = 0.3
STEPS = 2
W = H = 16


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


@pytest.fixture(scope="module")
def hosts():
    """{rebuild: (JAX HostCompiled, the port's HostCompiled)} of the indoor
    scene after STEPS update(DT) steps, refit (False) and rebuilt (True)."""
    out = {}
    for rebuild in (False, True):
        jh = JHostCompiled(jbuiltin.make_indoor_scene())
        ph = HostCompiled(builtin.make_indoor_scene(), CPU)
        for _ in range(STEPS):
            jh.update(DT, rebuild=rebuild)
            ph.update(DT, rebuild=rebuild)
        out[rebuild] = (jh, ph)
    return out


def _render(ts):
    cfg = RenderConfig.for_scene(ts, W, H, 1, use_defocus=True)._replace(block_rays=256)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(W, H), CPU)
    img, _ = render_frame_seeded(ts, cfg, cam, initial_seeds(cfg, 0, CPU))
    return img.numpy()


@pytest.fixture(scope="module")
def images(hosts):
    return {rebuild: _render(ph.scene) for rebuild, (_, ph) in hosts.items()}


def test_scene_update_matches_jax():
    """Instance 3's transform, inverse, bounds, area and version, the
    scene's version and its refit TLAS, bit for bit after each step."""
    js, ps = jbuiltin.make_indoor_scene(), builtin.make_indoor_scene()
    for step in range(STEPS):
        js.update(DT)
        ps.update(DT)
        assert ps.version == js.version == step + 1
        for ji, pi in zip(js.instances, ps.instances):
            for f in ("transform", "inv_transform", "bounds_min", "bounds_max"):
                assert _same(getattr(pi, f), getattr(ji, f)), f
            assert pi.area == ji.area and pi.version == ji.version
        for f in builder.BVH._fields:
            assert _same(getattr(ps.tlas, f), getattr(js.tlas, f)), f


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_refit_matches_jax(impl, monkeypatch):
    """builder.refit of the indoor BVH over the moved triangles' bounds,
    native against JAX's native refit and NumPy against JAX's NumPy
    fallback."""
    scene = builtin.make_indoor_scene()
    ph = HostCompiled(scene, CPU)
    bvh0 = ph.bvh
    scene.update(DT)
    ph.refresh(rebuild=False)
    lo, hi = builder.triangle_bounds(*ph.samp[:3])
    if impl == "numpy":
        monkeypatch.setenv("SURF_NO_NATIVE", "1")
        monkeypatch.setattr(jnative, "native_refit", lambda *a: False)
    got = builder.refit(bvh0, lo, hi)
    want = jbuilder.refit(jbuilder.BVH(*bvh0), lo, hi)
    assert not _same(got.node_lo, bvh0.node_lo)  # the boxes moved
    for f in builder.BVH._fields:
        assert _same(getattr(got, f), getattr(want, f)), f
    if impl == "native":
        assert _same(got.node_lo, ph.bvh.node_lo) and _same(got.node_hi, ph.bvh.node_hi)


def test_refit_wide_stream_matches_jax():
    """The stream and its slot provenance as built, then refit over the
    moved scene, against JAX's (leaf ranges of kind 2 with their unrolled
    min / max included)."""
    scene = builtin.make_indoor_scene()
    ph = HostCompiled(scene, CPU)
    bvh0 = ph.bvh
    perm = bvh0.indices.astype(np.int64)
    tv = [x[perm] for x in ph.samp[:3]]
    ws = wide.build_wide_stream(bvh0, *tv)
    jws = jwide.build_wide_stream(jbuilder.BVH(*bvh0), *tv)
    assert ws.n_entries == jws.n_entries
    for f in ("stream", "rec_slot", "slot_kind", "slot_a", "slot_b"):
        assert _same(getattr(ws, f), getattr(jws, f)), f
    assert (ws.slot_kind == 2).any() and (ws.slot_kind == 1).any()
    scene.update(DT)
    ph.refresh(rebuild=False)
    tv = [x[perm] for x in ph.samp[:3]]
    got = wide.refit_wide_stream(ws, ph.bvh, *tv)
    want = jwide.refit_wide_stream(jws, jbuilder.BVH(*ph.bvh), *tv)
    assert not _same(got.stream, ws.stream)
    assert _same(got.stream, want.stream)


@pytest.mark.parametrize("rebuild", [False, True], ids=["refit", "rebuild"])
def test_host_arrays_match_jax(hosts, rebuild):
    """Every leaf of the port's HostCompiled after the steps, padding
    included, equals JAX's; the sticky capacities too, and the device
    scene holds the arrays."""
    jh, ph = hosts[rebuild]
    ref = _jax_leaves(jh)
    for key, val in ph.arrays.items():
        assert _same(val, ref[key]), key
    assert ph._caps == jh._caps and ph.stack_depth == jh.static.stack_depth
    sizes = (5000, 100, 7000, 10)  # a capacity stays until a size exceeds it
    assert [ph._cap("probe", n) for n in sizes] == [jh._cap("probe", n) for n in sizes]
    ts = ph.scene
    assert _same(ts.trace.ltab, ref["wide_ltab"]) and _same(ts.stream.stream, ref["wide_stream"])
    assert _same(ts.binary.nodes, ref["nodes_packed"]) and _same(ts.samp_v0, ref["samp_v0"])
    assert ts.binary.n_nodes == len(ref["node_boxes"])


def test_refit_keeps_unchanged_tensors():
    """A refit uploads the changed leaves only: the material table, the
    lanes' maps and the topology tensors keep their tensors."""
    ph = HostCompiled(builtin.make_indoor_scene(), CPU)
    before = ph.scene
    ph.update(DT)
    after = ph.scene
    for f in ("perm", "tri_inst", "inst_material", "mat_albedo", "light_inst",
              "inst_tri_offset"):
        assert getattr(after, f) is getattr(before, f), f
    assert after.trace.anc is before.trace.anc
    assert after.stream.rec_slot is before.stream.rec_slot
    for moved in (after.trace.ltab, after.stream.stream, after.binary.nodes, after.samp_v0):
        assert not any(moved is x for x in (before.trace.ltab, before.stream.stream,
                                            before.binary.nodes, before.samp_v0))


def test_refit_image_matches_rebuild(images):
    """tests/test_animation.py:30-33: under 2% of pixels off by more than
    1e-3, energy within 1%."""
    a, b = images[False], images[True]
    assert np.isfinite(a).all() and (a >= 0).all() and a.sum() > 0
    diff = np.abs(a - b).max(axis=2)
    assert (diff > 1e-3).mean() < 0.02
    assert abs(a.sum() - b.sum()) / abs(a.sum()) < 0.01


def test_refit_image_matches_jax(hosts, images):
    """The port's refit frame against JAX's XLA render of the same state,
    under tests/test_torch_render.py's gate: under 1% of pixels off by
    more than 1e-3, energy within 1%."""
    jh, _ = hosts[False]
    jcfg = JRenderConfig.for_scene(jh.static, W, H, 1, use_defocus=True, use_pallas=False)
    ref = np.asarray(render_frame_jit(
        jh.render_scene, jcfg, JCameraParams.from_camera(jbuiltin.make_indoor_camera(W, H)),
        jnp.uint32(0)))
    img = images[False]
    diff = np.abs(ref - img).max(axis=2)
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert abs(ref.sum() - img.sum()) / abs(ref.sum()) < 0.01


def test_jax_leaves_render_equal(hosts, images):
    """JAX's refit leaves through from_render_scene give the port host's
    own scene, tensor for tensor, and its frame bit for bit."""
    jh, ph = hosts[False]
    ts = from_render_scene(_jax_leaves(jh), CPU)
    for f in TorchScene._fields:
        a, b = getattr(ts, f), getattr(ph.scene, f)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert (_same(x, y) if isinstance(x, torch.Tensor) else x == y), f
    assert np.array_equal(_render(ts), images[False])

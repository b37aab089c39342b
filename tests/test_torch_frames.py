"""The frame entry points of surf_tpu_torch besides ``render_frame_seeded``
and deferral: ``render_frame`` (seeds from the sample count), the
instrumented frame, the bounded loop (``max_bounces``) and the Russian
roulette switch (``rr``), against surf_tpu on the 16x16 diffuse box seen
through ``make_indoor_camera`` (JAX's default CPU traversal).  Both
renderers consume identical per-pixel RNG streams, so only float ulp
noise (libm, XLA's FMA contraction) may move a path; the tolerances:

- images against JAX: ``test_torch_render._pixel_gate`` (under 1% of
  pixels off by more than 1e-3, energy within 1%), and for ``max_bounces=48``
  also tests/test_render_parity.py:214's max |difference| < 1e-4;
- wave statistics: the integer counts equal, occupancy (float32 in both)
  within 1e-6;
- the port against itself (lane order, bounded against capped): bit for
  bit, since per-lane results do not depend on which lanes share a packet.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.camera import CameraParams as JCameraParams
from surf_tpu.scene.compile import HostCompiled
from surf_tpu.wavefront import RenderConfig as JRenderConfig
from surf_tpu.wavefront import integrator as jint
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams
from surf_tpu_torch.scene.compile import compile_scene
from surf_tpu_torch.wavefront import integrator as wi
from test_torch_render import _pixel_gate

warnings.filterwarnings("ignore", category=RuntimeWarning)
torch.set_num_threads(1)

CPU = torch.device("cpu")
W = H = 16


@pytest.fixture(scope="module")
def box():
    host = HostCompiled(jbuiltin.make_diffuse_box_scene())
    ts = compile_scene(builtin.make_diffuse_box_scene(), CPU)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(W, H), CPU)
    jcam = JCameraParams.from_camera(jbuiltin.make_indoor_camera(W, H))
    return host, ts, cam, jcam


def _cfgs(host, ts, spp, **knobs):
    """The port's config and JAX's, with the same knobs."""
    return (wi.RenderConfig.for_scene(ts, W, H, spp, use_defocus=True)._replace(**knobs),
            JRenderConfig.for_scene(host.static, W, H, spp, use_defocus=True)._replace(**knobs))


def test_render_frame_seeds_from_total_samples(box):
    """render_frame(total_samples) is render_frame_seeded from that count's
    seeds, and another count gives another image."""
    _, ts, cam, _ = box
    cfg = wi.RenderConfig.for_scene(ts, W, H, 1, use_defocus=True)
    img = wi.render_frame(ts, cfg, cam, 5, CPU)
    seeded, _ = wi.render_frame_seeded(ts, cfg, cam, wi.initial_seeds(cfg, 5, CPU))
    assert torch.equal(img, seeded)
    assert not torch.equal(img, wi.render_frame(ts, cfg, cam, 0, CPU))


def test_instrumented_matches_jax(box):
    """Two samples at wave limit 2 with compaction (every wave, as in
    JAX), where paths are still alive at the cap: the image and every
    statistic against JAX's render_frame_instrumented."""
    host, ts, cam, jcam = box
    cfg, jcfg = _cfgs(host, ts, 2, wave_limit=2, compact=True)
    img, st = wi.render_frame_instrumented(ts, cfg, cam, 3, CPU)
    jimg, jst = jint.render_frame_instrumented(host.render_scene, jcfg, jcam, jnp.uint32(3))
    _pixel_gate(np.asarray(jimg), img.numpy())
    for k in ("waves", "lane_steps", "deferred"):
        assert st[k] == int(jst[k]), k
    assert st["deferred"] > 0
    assert abs(st["occupancy"] - float(jst["occupancy"])) <= 1e-6


def test_instrumented_image_and_cap(box, monkeypatch):
    """The instrumented frame compacts on every wave whatever
    compact_every says, and its image equals render_frame with compaction
    every wave (native lanes, no ladder) bit for bit; capped by
    max_bounces it counts like the same cap as wave_limit."""
    _, ts, cam, _ = box
    cfg = wi.RenderConfig.for_scene(ts, W, H, 2, use_defocus=True)._replace(
        wave_limit=2, compact=True, compact_every=4, ladder=6, ladder_shrink=2)
    compactions = []
    compact = wi.compact_paths
    monkeypatch.setattr(wi, "compact_paths", lambda s: (compactions.append(1), compact(s))[1])
    img, st = wi.render_frame_instrumented(ts, cfg, cam, 3, CPU)
    assert len(compactions) == st["waves"]
    monkeypatch.undo()
    plain = wi.render_frame(ts, cfg._replace(compact_every=1, ladder=0), cam, 3, CPU)
    assert torch.equal(img, plain)
    img_b, st_b = wi.render_frame_instrumented(
        ts, cfg._replace(wave_limit=128, max_bounces=2), cam, 3, CPU)
    assert torch.equal(img, img_b)
    assert st == st_b
    assert st["waves"] == 4 and st["lane_steps"] > 2 * W * H  # two full-width waves a sample


def test_bounded_matches_jax(box):
    """max_bounces=48 at 2 spp (tests/test_render_parity.py:214's frame)
    against JAX's bounded frame."""
    host, ts, cam, jcam = box
    cfg, jcfg = _cfgs(host, ts, 2, max_bounces=48)
    img = wi.render_frame(ts, cfg, cam, 0, CPU).numpy()
    jimg = np.asarray(jint.render_frame_jit(host.render_scene, jcfg, jcam, jnp.uint32(0)))
    _pixel_gate(jimg, img)
    assert np.abs(jimg - img).max() < 1e-4


@pytest.mark.parametrize("cap,knobs", [
    (2, {}),
    (8, dict(compact=True, compact_every=4, ladder=6, ladder_shrink=2, pixel_order="morton")),
])
def test_bounded_equals_capped(box, cap, knobs, monkeypatch):
    """max_bounces=N equals wave_limit=N bit for bit (a wave on dead lanes
    changes nothing), with the ladder off under max_bounces, and runs
    exactly N waves without reading a live count."""
    _, ts, cam, _ = box
    cfg = wi.RenderConfig.for_scene(ts, W, H, 2, use_defocus=True)._replace(**knobs)
    seed0 = wi.initial_seeds(cfg, 1, CPU)
    capped, capped_seed = wi.render_frame_seeded(ts, cfg._replace(wave_limit=cap), cam, seed0)
    waves = []
    wave = wi._wave
    monkeypatch.setattr(wi, "_wave", lambda *a: (waves.append(a[2]), wave(*a))[1])
    monkeypatch.setattr(wi, "_run_waves", None)  # the live-count loop
    bounded, bounded_seed = wi.render_frame_seeded(
        ts, cfg._replace(wave_limit=1, max_bounces=cap), cam, seed0)
    assert waves == list(range(cap)) * 2
    assert torch.equal(capped, bounded)
    assert torch.equal(capped_seed, bounded_seed)


def test_rr_off_matches_jax(box):
    """rr=False (no kill, no 1/p weight, the draw still consumed) against
    JAX's, at 1 spp; it changes the image."""
    host, ts, cam, jcam = box
    cfg, jcfg = _cfgs(host, ts, 1, rr=False)
    img = wi.render_frame(ts, cfg, cam, 0, CPU).numpy()
    jimg = np.asarray(jint.render_frame_jit(host.render_scene, jcfg, jcam, jnp.uint32(0)))
    _pixel_gate(jimg, img)
    assert not np.array_equal(img, wi.render_frame(ts, cfg._replace(rr=True), cam, 0, CPU).numpy())

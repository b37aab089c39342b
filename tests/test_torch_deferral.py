"""Cross-frame deferral of surf_tpu_torch (``render_frame_carry``) against
surf_tpu's ``render_frame_carry_jit`` on the data of tests/test_deferral.py
(the 16x16 diffuse box seen through ``make_indoor_camera``, JAX's default
CPU traversal), at wave limits where deferral acts: one capped frame
defers 128 paths at limit 1 and 7 at limit 2, none from 3 on.  Three
samples a frame at limit 1 overflow the W*H-lane pool (``dropped`` > 0).
Both renderers consume identical per-pixel RNG streams, so the tolerances
are those float ulp noise needs (libm, XLA's FMA contraction):

- frame images: ``test_torch_render._pixel_gate`` (under 1% of pixels off
  by more than 1e-3, energy within 1%);
- the pool: its live count and ``dropped`` equal; on its live prefix,
  ``pixel`` equal and ``seed`` equal on at least 99% of the lanes (a path
  that float noise sends elsewhere draws other numbers; JAX's dead lanes
  hold stale data, so only the prefix is compared);
- the drained sum against uncapped frames: rtol 1e-5, atol 1e-5, the gate of
  test_deferral.py (the same paths, their energy added in another order).
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
DRAINS = 8  # spp=0 frames allowed to empty the pool


@pytest.fixture(scope="module")
def box():
    host = HostCompiled(jbuiltin.make_diffuse_box_scene())
    ts = compile_scene(builtin.make_diffuse_box_scene(), CPU)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(W, H), CPU)
    jcam = JCameraParams.from_camera(jbuiltin.make_indoor_camera(W, H))
    return host, ts, cam, jcam


def _cfg(ts, spp, **knobs):
    return wi.RenderConfig.for_scene(ts, W, H, spp, use_defocus=True)._replace(**knobs)


def _deferred_frames(ts, cam, cfg, frames):
    """``frames`` deferring frames at total_samples f * spp: their images
    and seeds, and the carry after each."""
    carry = wi.empty_frame_carry(cfg, CPU)
    out = []
    for f in range(frames):
        acc, seed, carry = wi.render_frame_carry(
            ts, cfg, cam, wi.initial_seeds(cfg, f * cfg.spp, CPU), carry)
        out.append((acc.numpy(), seed.numpy(), carry))
    return out


@pytest.mark.parametrize("limit,spp", [(1, 1), (2, 1), (1, 3)])
def test_deferral_matches_jax(box, limit, spp):
    """Two deferring frames (the second drains the first's pool first)
    against JAX's: images, the pool's live count, ``dropped``, and the
    pool's live prefix."""
    host, ts, cam, jcam = box
    cfg = _cfg(ts, spp, wave_limit=limit)
    jcfg = JRenderConfig.for_scene(host.static, W, H, spp, use_defocus=True)._replace(
        wave_limit=limit)
    jcarry = jint.empty_frame_carry(jcfg)
    for f, (img, seed, carry) in enumerate(_deferred_frames(ts, cam, cfg, 2)):
        jacc, jseed, jcarry = jint.render_frame_carry_jit(
            host.render_scene, jcfg, jcam, jint.initial_seeds(jcfg, jnp.uint32(f * spp)), jcarry)
        _pixel_gate(np.asarray(jacc), img)
        assert (seed.astype(np.uint32) != np.asarray(jseed)).mean() < 0.01
        d, jd = carry.deferred, jcarry.deferred
        m = int(d.alive.sum())
        assert m == int(np.asarray(jd.alive).sum()) > 0
        assert bool(d.alive[:m].all()) and not bool(d.alive[m:].any())  # live prefix
        assert int(carry.dropped) == int(np.asarray(jcarry.dropped))
        assert np.array_equal(d.pixel[:m].numpy(), np.asarray(jd.pixel)[:m])
        same = d.seed[:m].numpy().astype(np.uint32) == np.asarray(jd.seed)[:m]
        assert same.mean() >= 0.99
        if spp == 3:
            assert int(carry.dropped) > 0
        else:
            assert int(carry.dropped) == 0


@pytest.mark.parametrize("limit", [1, 2])
def test_drain_recovers_uncapped(box, limit):
    """Four deferring frames, then spp=0 frames until the pool is empty:
    the sum equals the same four frames uncapped (wave limit 256), while
    the capped frames without deferral lose energy."""
    _, ts, cam, _ = box
    frames = 4
    ref = sum(wi.render_frame(ts, _cfg(ts, 1, wave_limit=256), cam, f, CPU).numpy()
              for f in range(frames))
    capped = sum(wi.render_frame(ts, _cfg(ts, 1, wave_limit=limit), cam, f, CPU).numpy()
                 for f in range(frames))
    cfg = _cfg(ts, 1, wave_limit=limit)
    runs = _deferred_frames(ts, cam, cfg, frames)
    total = sum(img for img, _, _ in runs)
    carry = runs[-1][2]
    assert bool(carry.deferred.alive.any())
    drain = cfg._replace(spp=0)
    zeros = torch.zeros(W * H, dtype=torch.int64)
    for _ in range(DRAINS):
        if not bool(carry.deferred.alive.any()):
            break
        acc, _, carry = wi.render_frame_carry(ts, drain, cam, zeros, carry)
        total = total + acc.numpy()
    assert not bool(carry.deferred.alive.any()), "the pool did not drain"
    assert int(carry.dropped) == 0
    assert np.allclose(total, ref, rtol=1e-5, atol=1e-5), float(np.abs(total - ref).max())
    assert capped.sum() < ref.sum()  # the bias deferral recovers


@pytest.mark.parametrize("knobs", [
    dict(compact=True, compact_every=1),
    dict(compact=True, compact_every=16, ladder=6, ladder_shrink=2, pixel_order="morton"),
])
def test_deferral_knobs_bit_identical(box, knobs):
    """Compaction keeps the live lanes in pixel order, and deferring
    samples run native lanes without the ladder whatever the config says
    (as in JAX), so images, seeds and the pool (``dropped`` > 0 here) equal
    those of the plain loop bit for bit."""
    _, ts, cam, _ = box
    cfg = _cfg(ts, 3, wave_limit=1)
    for (img0, seed0, c0), (img1, seed1, c1) in zip(
            _deferred_frames(ts, cam, cfg, 2), _deferred_frames(ts, cam, cfg._replace(**knobs), 2)):
        assert np.array_equal(img0, img1)
        assert np.array_equal(seed0, seed1)
        assert int(c0.dropped) == int(c1.dropped) > 0
        for a, b in zip(c0.deferred, c1.deferred):
            assert torch.equal(a, b)

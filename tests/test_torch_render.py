"""End-to-end render parity of surf_tpu_torch against the NumPy oracle and
surf_tpu (plain leaf-row version on the CPU), with the gates of
tests/test_render_parity.py: both renderers consume identical per-pixel
RNG streams, so only float ulp noise (libm, FMA contraction in XLA) may
move a few deep paths."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.reference.cpu_renderer import OracleRenderer
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.camera import CameraParams as JCameraParams
from surf_tpu.scene.compile import HostCompiled
from surf_tpu.wavefront import RenderConfig as JRenderConfig
from surf_tpu.wavefront import render_frame_jit
from surf_tpu.wavefront import integrator as jint
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams
from surf_tpu_torch.scene.compile import compile_scene
from surf_tpu_torch.wavefront.integrator import (RenderConfig, initial_seeds,
                                                 render_frame_seeded)

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
# The bench knobs (bench.py) other than the resolution.
BENCH_KNOBS = dict(wave_limit=32, compact=True, compact_every=16, ladder=6,
                   ladder_shrink=2, pixel_order="morton")


@pytest.fixture(scope="module")
def box():
    return (HostCompiled(jbuiltin.make_diffuse_box_scene()),
            compile_scene(builtin.make_diffuse_box_scene(), CPU))


@pytest.fixture(scope="module")
def indoor():
    return (HostCompiled(jbuiltin.make_indoor_scene()),
            compile_scene(builtin.make_indoor_scene(), CPU))


def _render(ts, cfg, total_samples=0):
    cam = CameraParams.from_camera(builtin.make_indoor_camera(cfg.width, cfg.height), CPU)
    img, seed = render_frame_seeded(ts, cfg, cam, initial_seeds(cfg, total_samples, CPU))
    return img.numpy(), seed.numpy()


def _pixel_gate(ref, img):
    """Under 1% of pixels off by more than 1e-3, energy within 1%."""
    diff = np.abs(ref - img).max(axis=2)
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert abs(ref.sum() - img.sum()) / abs(ref.sum()) < 0.01


def test_box_matches_oracle_and_jax(box):
    host, ts = box
    W = H = 32
    spp = 2
    img = _render(ts, RenderConfig.for_scene(ts, W, H, spp, use_defocus=True))[0]
    assert np.isfinite(img).all() and (img >= 0).all()
    cam = jbuiltin.make_indoor_camera(W, H)
    _pixel_gate(OracleRenderer(host, cam).render(W, H, spp), img)
    jcfg = JRenderConfig.for_scene(host.static, W, H, spp, use_defocus=True)
    _pixel_gate(np.asarray(render_frame_jit(
        host.render_scene, jcfg, JCameraParams.from_camera(cam), jnp.uint32(0))), img)


def test_indoor_matches_oracle_high_spp(indoor):
    """Indoor scene (dielectric, specular, NEE, RR) at 16 spp: relative L1
    under 3% and energy within 1% of the oracle.  256-ray packets keep the
    CPU plain version cheap; packet size does not change the image."""
    host, ts = indoor
    W = H = 16
    spp = 16
    cfg = RenderConfig.for_scene(ts, W, H, spp, use_defocus=True)._replace(block_rays=256)
    img = _render(ts, cfg)[0]
    ref = OracleRenderer(host, jbuiltin.make_indoor_camera(W, H)).render(W, H, spp)
    assert np.abs(ref - img).mean() / ref.mean() < 0.03
    assert abs(ref.sum() - img.sum()) / abs(ref.sum()) < 0.01


def test_bench_knobs_match_jax(box):
    """64x64 at 1 spp with every bench knob (2048-ray packets, Morton order,
    compaction every 16 waves, ladder 6 rungs / shrink 2 — two rungs engage,
    at 2048 and 1024 lanes — wave cap 32) against surf_tpu with the same
    knobs on its CPU traversal."""
    host, ts = box
    W = H = 64
    cfg = RenderConfig.for_scene(ts, W, H, 1, use_defocus=True)._replace(
        block_rays=2048, **BENCH_KNOBS)
    img, seed = _render(ts, cfg)
    jcfg = JRenderConfig.for_scene(host.static, W, H, 1, use_defocus=True,
                                   use_pallas=False)._replace(max_bounces=None,
                                                             **BENCH_KNOBS)
    cam = JCameraParams.from_camera(jbuiltin.make_indoor_camera(W, H))
    jimg, jseed = jint.render_frame_seeded(host.render_scene, jcfg, cam,
                                           jint.initial_seeds(jcfg, jnp.uint32(0)))
    _pixel_gate(np.asarray(jimg), img)
    # per-pixel streams agree except on the few float-chaos lanes
    assert (seed.astype(np.uint32) != np.asarray(jseed)).mean() < 0.01


@pytest.fixture(scope="module")
def box_plain_loop(box):
    """Box 64x64 @ 2 spp through the port's plain loop (native lanes, no
    compaction, no ladder): its config and (image, seeds)."""
    _, ts = box
    base = RenderConfig.for_scene(ts, 64, 64, 2, use_defocus=True)._replace(
        block_rays=2048, wave_limit=32)
    return base, _render(ts, base, total_samples=5)


@pytest.mark.parametrize("knobs", [
    dict(pixel_order="morton"),
    dict(compact=True, compact_every=1),
    dict(compact=True, compact_every=16, ladder=6, ladder_shrink=2),
    BENCH_KNOBS,
])
def test_lane_order_knobs_bit_identical(box, box_plain_loop, knobs):
    """Morton order, compaction and the width ladder only change which
    lanes share a packet: image and seeds are bit-identical to the port's
    own plain loop."""
    _, ts = box
    base, (img0, seed0) = box_plain_loop
    img1, seed1 = _render(ts, base._replace(**knobs), total_samples=5)
    assert np.array_equal(img0, img1)
    assert np.array_equal(seed0, seed1)


def test_spp_chunking_bit_identical(box):
    """Rendering 2 spp as two 1-spp calls that carry the seeds gives the
    same image as one call (bench.py chunks spp this way)."""
    _, ts = box
    cfg2 = RenderConfig.for_scene(ts, 32, 32, 2, use_defocus=True)
    cfg1 = cfg2._replace(spp=1)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(32, 32), CPU)
    whole, s_whole = render_frame_seeded(ts, cfg2, cam, initial_seeds(cfg2, 0, CPU))
    a, s = render_frame_seeded(ts, cfg1, cam, initial_seeds(cfg1, 0, CPU))
    b, s = render_frame_seeded(ts, cfg1, cam, s)
    assert torch.equal(whole, a + b)
    assert torch.equal(s_whole, s)

"""The progressive renderer facade of surf_tpu_torch
(``app.renderer.WavefrontRenderer``) and its accumulator against
surf_tpu's facade, on the 16x16 diffuse box seen through
``make_indoor_camera`` (JAX's default CPU traversal): two frames of 2 spp,
with deferral off and on (at wave cap 2, where paths are deferred).  Both
consume identical per-pixel RNG streams, so the resolved images are held
by ``test_torch_render._pixel_gate`` (under 1% of pixels off by more than
1e-3, energy within 1%: float ulp noise only); sample counts, the pool
and the port's own repeats are held exactly.
"""

import warnings

import numpy as np
import pytest
import torch

from surf_tpu.app.renderer import RendererConfigHost as JRendererConfigHost
from surf_tpu.app.renderer import WavefrontRenderer as JWavefrontRenderer
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.compile import HostCompiled
from surf_tpu_torch.app.renderer import RendererConfigHost, WavefrontRenderer
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.compile import compile_scene
from surf_tpu_torch.wavefront.accumulator import Accumulator
from test_torch_render import _pixel_gate

warnings.filterwarnings("ignore", category=RuntimeWarning)
torch.set_num_threads(1)

CPU = torch.device("cpu")
W = H = 16
DEFER = dict(defer=True, compact=True, wave_limit=2)


@pytest.fixture(scope="module")
def box():
    return (HostCompiled(jbuiltin.make_diffuse_box_scene()),
            compile_scene(builtin.make_diffuse_box_scene(), CPU))


def _renderer(ts, **kw):
    return WavefrontRenderer(ts, builtin.make_indoor_camera(W, H),
                             RendererConfigHost(samples_per_frame=2), CPU, **kw)


@pytest.mark.parametrize("kw", [{}, DEFER], ids=["plain", "defer"])
def test_facade_matches_jax(box, kw):
    host, ts = box
    wf = _renderer(ts, **kw)
    jwf = JWavefrontRenderer(host, jbuiltin.make_indoor_camera(W, H),
                             JRendererConfigHost(samples_per_frame=2), **kw)
    for frame in (1, 2):
        img, jimg = wf.render(), jwf.render()
        _pixel_gate(jimg, img)
        assert wf.frame_info().total_samples == jwf.frame_info().total_samples == 2 * frame
        assert abs(wf.frame_info().energy - jwf.frame_info().energy) <= 0.01 * jwf.frame_info().energy
    # chip_smoke.py's phase 12 sets _rcfg and reads _carry and _acc.buffer
    assert wf._rcfg.wave_limit == kw.get("wave_limit", 128)
    assert np.array_equal(wf._acc.buffer / np.float32(4), wf._acc.resolve())
    if kw:
        live = int(wf._carry.deferred.alive.sum())
        assert live == int(np.asarray(jwf._carry.deferred.alive).sum()) > 0
        assert int(wf._carry.dropped) == int(np.asarray(jwf._carry.dropped)) == 0


def test_facade_clear_and_camera_change(box):
    """clear_accumulator() restarts the seed streams: the next image is the
    first one bit for bit.  notify_camera_changed() also empties the
    deferred pool, so a deferring renderer restarts exactly too."""
    _, ts = box
    wf = _renderer(ts)
    first = wf.render()
    assert not np.array_equal(first, wf.render())
    wf.clear_accumulator()
    assert wf.frame_info().total_samples == 4  # the last frame's
    assert np.array_equal(first, wf.render())

    wd = _renderer(ts, **DEFER)
    first = wd.render()
    wd.render()
    assert bool(wd._carry.deferred.alive.any())
    wd.notify_camera_changed()
    assert not bool(wd._carry.deferred.alive.any()) and int(wd._carry.dropped) == 0
    assert np.array_equal(first, wd.render())


def test_accumulator_resolve_and_checkpoint(tmp_path):
    """Sums over frames, resolves by the sample count (the raw buffer
    before any sample) and survives save/load bit for bit."""
    acc = Accumulator(3, 2)
    assert np.array_equal(acc.resolve(), np.zeros((2, 3, 3), np.float32))
    rng = np.random.default_rng(0)
    a, b = (rng.random((2, 3, 3), dtype=np.float32) for _ in range(2))
    acc.add_frame(a, 2)
    acc.add_frame(b, 3)
    assert acc.total_samples == 5
    assert np.array_equal(acc.resolve(), (a + b) / np.float32(5))
    assert acc.energy() == float(((a + b) / np.float32(5)).sum())
    acc.save(tmp_path / "acc.npz")
    back = Accumulator.load(tmp_path / "acc.npz")
    assert (back.width, back.height, back.total_samples) == (3, 2, 5)
    assert np.array_equal(back.buffer, acc.buffer)

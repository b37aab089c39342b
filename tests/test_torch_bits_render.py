"""The bits* algos end to end: the indoor scene rendered by the port with
algo="bitsw", "bits2" and "bitsp" (plain versions on the CPU) at 16x16 @
1 spp with the bench knobs, against JAX's render of the same config (its
Pallas kernels in interpret mode) with the gates of
tests/test_torch_walks.py (``_gate``: under 1% of pixels off by more than
1e-3, energy within 1%), and against the port's own bitsru8 frame.

``bits2`` and ``bitsp`` keep bitsru8's winners, so their frames must be
bit-equal to its frame.  ``bitsw`` rounds its record test otherwise, and a
path whose hit moves draws other random numbers from then on: on this
scene its frame departs from bitsru8's by 3 pixels of 256 (1.2%, on a
CPU), as JAX's bitsw frame departs from JAX's bitsru8 frame, so it is
held to depart no further than JAX's does plus 1% of the pixels, and to
its energy within 1%.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_walks import _gate

from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.camera import CameraParams as JCameraParams
from surf_tpu.scene.compile import HostCompiled
from surf_tpu.wavefront import RenderConfig as JRenderConfig
from surf_tpu.wavefront import integrator as jint
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
W = H = 16


@pytest.fixture(scope="module")
def indoor():
    return compile_scene(builtin.make_indoor_scene(), CPU), HostCompiled(
        jbuiltin.make_indoor_scene())


def _port_render(ts, algo):
    cfg = RenderConfig.for_scene(ts, W, H, 1, use_defocus=True)._replace(
        **BENCH_KNOBS, algo=algo)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(W, H), CPU)
    img, _ = render_frame_seeded(ts, cfg, cam, initial_seeds(cfg, 0, CPU))
    img = img.numpy()
    assert np.isfinite(img).all() and (img >= 0).all() and img.sum() > 0
    return img


def _jax_render(host, algo):
    jcfg = JRenderConfig.for_scene(host.static, W, H, 1, use_defocus=True,
                                   use_pallas=True)._replace(
        max_bounces=None, pallas_interpret=True, **BENCH_KNOBS, algo=algo)
    cam = JCameraParams.from_camera(jbuiltin.make_indoor_camera(W, H))
    img, _ = jint.render_frame_seeded(host.render_scene, jcfg, cam,
                                      jint.initial_seeds(jcfg, jnp.uint32(0)))
    return np.asarray(img)


def _off(a, b):
    return (np.abs(a - b).max(axis=2) > 1e-3).mean()


@pytest.mark.parametrize("algo", ["bitsw", "bits2", "bitsp"])
def test_bits_render_matches_jax_and_bitsru8(indoor, algo):
    ts, host = indoor
    img = _port_render(ts, algo)
    jimg = _jax_render(host, algo)
    _gate(jimg, img)
    ref = _port_render(ts, "bitsru8")
    if algo != "bitsw":
        assert np.array_equal(ref, img)
        return
    jax_off = _off(_jax_render(host, "bitsru8"), jimg)
    assert _off(ref, img) <= jax_off + 0.01
    assert abs(ref.sum() - img.sum()) / ref.sum() < 0.01

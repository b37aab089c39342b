"""The walks of this slice end to end: the diffuse box scene rendered by the
port with algo="skip", algo="stack" and use_wide=False (plain versions on
the CPU) against JAX's render of the same config (its Pallas kernels in
interpret mode) and against the port's own bitsru8 frame, with the gates
of tests/test_render_parity.py (under 1% of pixels off by more than 1e-3,
energy within 1%); and the algo / scene checks of ``render_frame_seeded``.
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
from surf_tpu_torch.wavefront.integrator import (BENCH_KNOBS, RenderConfig,
                                                 initial_seeds, render_frame_seeded)

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
W = H = 16
WALKS = {"skip": dict(algo="skip"), "stack": dict(algo="stack"),
         "binary": dict(use_wide=False)}


def _gate(ref, img):
    d = np.abs(ref - img).max(axis=2)
    assert (d > 1e-3).mean() < 0.01, d.max()
    assert abs(ref.sum() - img.sum()) / abs(ref.sum()) < 0.01


@pytest.fixture(scope="module")
def box():
    return compile_scene(builtin.make_diffuse_box_scene(), CPU)


def _port_render(ts, **walk):
    cfg = RenderConfig.for_scene(ts, W, H, 1, use_defocus=True)._replace(
        **BENCH_KNOBS, **walk)
    cam = CameraParams.from_camera(builtin.make_box_camera(W, H), CPU)
    img, _ = render_frame_seeded(ts, cfg, cam, initial_seeds(cfg, 0, CPU))
    img = img.numpy()
    assert np.isfinite(img).all() and (img >= 0).all() and img.sum() > 0
    return img


@pytest.fixture(scope="module")
def bitsru8_frame(box):
    return _port_render(box)


@pytest.mark.parametrize("walk", sorted(WALKS))
def test_walk_render_matches_jax_and_bitsru8(box, bitsru8_frame, walk):
    """16x16 @ 1 spp with the bench knobs (2048-ray packets, Morton lanes,
    compaction, ladder, wave cap 32)."""
    img = _port_render(box, **WALKS[walk])
    host = HostCompiled(jbuiltin.make_diffuse_box_scene())
    jcfg = JRenderConfig.for_scene(host.static, W, H, 1, use_defocus=True,
                                   use_pallas=True)._replace(
        max_bounces=None, pallas_interpret=True, **BENCH_KNOBS, **WALKS[walk])
    cam = JCameraParams.from_camera(jbuiltin.make_box_camera(W, H))
    jimg, _ = jint.render_frame_seeded(host.render_scene, jcfg, cam,
                                       jint.initial_seeds(jcfg, jnp.uint32(0)))
    _gate(np.asarray(jimg), img)
    _gate(bitsru8_frame, img)


def test_algo_checks(box):
    """Unported algo names, bits* strings that traverse_wide rejects and
    algo / scene mismatches raise; no walk falls back to another."""
    cam = CameraParams.from_camera(builtin.make_box_camera(8, 8), CPU)
    cfg = RenderConfig.for_scene(box, 8, 8, 1, use_defocus=False)
    pure = compile_scene(builtin.make_diffuse_box_scene(), CPU, two_level="pure")
    bad = [(box, cfg._replace(algo=a)) for a in
           ("skip3", "ilv0", "ilv5", "spec0", "specb16", "twolevel", "twolevelp",
            "bitsq", "bitsru28", "bitsp2", "bitsr2")]
    bad += [(pure, cfg._replace(algo=a)) for a in ("bitsru8", "bits", "skip", "stack",
                                                   "skip2", "spec2")]
    bad += [(box, cfg._replace(algo="bitsq", use_wide=False))]
    for scene, c in bad:
        with pytest.raises(ValueError, match="ported algos"):
            render_frame_seeded(scene, c, cam, initial_seeds(c, 0, CPU))

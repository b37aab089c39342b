"""Data-parallel distribution of surf_tpu_torch (dist/sharding.py,
dist/multihost.py) on the CPU: one spawn of 2 gloo ranks computes every
sharded result on the 16x16 box scene (tests/torch_dist_ranks.py), and
the cases hold it to the port's single-device frame and gradient at
tests/test_sharding.py's gates, count its collectives, and hold the
sharded image to surf_tpu's render_frame_sharded on a 2-device mesh."""

import os
import warnings
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_ranks as ranks
from surf_tpu.dist import make_mesh as jmake_mesh
from surf_tpu.dist import render_frame_sharded as jrender_frame_sharded
from surf_tpu.scene import builtin as jbuiltin
from surf_tpu.scene.camera import CameraParams as JCameraParams
from surf_tpu.scene.compile import HostCompiled as JHostCompiled
from surf_tpu.wavefront import RenderConfig as JRenderConfig
from surf_tpu_torch.diff import DiffTargets, grad_image_loss, tree_flatten
from surf_tpu_torch.dist import (init_multihost, make_host_chip_mesh, render_frame_sharded)
from surf_tpu_torch.dist.launch import run_local_ranks
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.compile import HostCompiled
from surf_tpu_torch.wavefront.integrator import render_frame

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

CPU = ranks.CPU
WORLD = 2
DEADLINE = 300  # seconds for the spawned ranks, start-up included
ATOL = 1e-5     # tests/test_sharding.py:44


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """[rank 0's results, rank 1's]."""
    return run_local_ranks(ranks.sharded_box, WORLD, tmp_path_factory.mktemp("ranks"),
                           DEADLINE)


@pytest.fixture(scope="module")
def single():
    host = HostCompiled(builtin.make_diffuse_box_scene(), CPU)
    return host, ranks.box_config(host), ranks.camera(ranks.W, ranks.H)


def _close(single_img, sharded, record_property, what):
    assert torch.allclose(single_img, sharded, atol=ATOL, rtol=0), \
        (what, float((single_img - sharded).abs().max()))
    record_property(f"{what} bit-identical", bool(torch.equal(single_img, sharded)))


def test_sharded_matches_single_device(results, single, record_property):
    """Meshes (2,), (1, 2) and (2, 1): the image equals the single-device
    frame on every rank (each lane's path depends on its own seed only)."""
    host, cfg, cam = single
    ref = render_frame(host.scene, cfg, cam, 0, CPU)
    for out in results:
        assert set(out["images"]) == {(("chips",), (2,)), (("hosts", "chips"), (1, 2)),
                                      (("hosts", "chips"), (2, 1))}
        for key, img in out["images"].items():
            _close(ref, img, record_property, f"rank {out['rank']} {key}")


def test_sharded_knobs_match_single_device(results, single, record_property):
    """tests/test_sharding.py:124-125's knobs (bitsru8, wave limit 6,
    compaction, 1024-ray packets) through the leaf-row plain version:
    compaction runs per rank on its own lanes."""
    host, cfg, cam = single
    ref = render_frame(host.scene, cfg._replace(**ranks.KNOBS), cam, 0, CPU)
    for out in results:
        _close(ref, out["knobs"], record_property, f"rank {out['rank']} knobs")


@pytest.mark.parametrize("with_reference", [False, True])
def test_sharded_gradients_match_single_device(results, single, with_reference):
    """The all-reduced loss and gradients against grad_image_loss at
    tests/test_sharding.py:60-62's bounds, the same on both ranks: the mean
    radiance, and the mean squared difference to a reference image (each
    rank its lanes of it)."""
    host, cfg, cam = single
    ref = ranks.reference_image(host, cfg, cam) if with_reference else None
    loss1, g1 = grad_image_loss(host.scene, cfg._replace(max_bounces=ranks.BOUNCES),
                                DiffTargets.from_scene(host.scene, cam), 0, CPU,
                                reference_image=ref)
    for out in results:
        loss, grads = out["grad"][with_reference]
        assert np.isclose(float(loss1), float(loss), rtol=1e-5)
        for k, (a, b) in enumerate(zip(tree_flatten(g1)[0], grads)):
            assert torch.allclose(a, b, rtol=1e-4, atol=1e-6), (k, float((a - b).abs().max()))
    (_, rank0), (_, rank1) = (out["grad"][with_reference] for out in results)
    assert all(torch.equal(a, b) for a, b in zip(rank0, rank1))


def test_one_all_reduce_and_split_lanes(results):
    """What JAX's grad_step_compiled tests read from the HLO
    (tests/test_sharding.py:215-241, :208-212): one all-reduce a gradient
    step at W = 16 and W = 32, of the loss and every gradient element, and
    each rank's lane arrays hold n/2 lanes."""
    n_grad = sum(x.numel() for x in results[0]["grad"][False][1])
    for out in results:
        for w in ranks.COUNT_WIDTHS:
            assert out["all_reduces"][w] == [1 + n_grad], (w, out["all_reduces"][w])
            assert out["lanes"][w] == [w * 16 // WORLD] * 3


def test_sharded_session(results, single):
    """Two frames equal to render_frame's (and so to
    render_frame_sharded's), different from each other; after
    HostCompiled.update and update_scene, the moved scene's frame."""
    host, cfg, cam = single
    first, second, moved = results[0]["session"]
    assert torch.allclose(first, render_frame(host.scene, cfg, cam, 0, CPU), atol=ATOL, rtol=0)
    assert torch.allclose(second, render_frame(host.scene, cfg, cam, ranks.SPP, CPU),
                          atol=ATOL, rtol=0)
    assert not torch.equal(first, second)
    host.update(ranks.DT)
    assert torch.allclose(moved, render_frame(host.scene, cfg, cam, 0, CPU), atol=ATOL, rtol=0)
    assert not torch.equal(first, moved)


def test_uneven_lanes_rejected(results):
    """15 x 3 = 45 lanes over 2 ranks raise before any work
    (tests/test_sharding.py:244; ValueError where JAX asserts)."""
    for out in results:
        assert out["uneven"] is not None and "not divisible by 2" in out["uneven"]


def test_scaling_sweeps(results):
    """scaling_sweep((1, 2)) and weak_scaling_sweep return positive times
    on every rank (tests/test_animation.py:49), the weak sweep 128 lanes a
    rank."""
    for out in results:
        assert set(out["scaling"]) == {1, 2}
        assert all(v > 0 for v in out["scaling"].values())
        assert {k: v[1] for k, v in out["weak"].items()} == {1: 128, 2: 128}
        assert all(v[0] > 0 for v in out["weak"].values())
    assert results[0]["scaling"] == results[1]["scaling"]


def test_world_of_one(single, tmp_path):
    """init_multihost with no launcher environment starts a world of one
    in this process (gloo on the CPU); make_host_chip_mesh is (1, 1) and
    renders the single-device frame."""
    host, cfg, cam = single
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        "MASTER_ADDR", "MASTER_PORT")}
    with mock.patch.dict(os.environ, env, clear=True):
        assert init_multihost(device="cpu") == CPU
        try:
            mesh = make_host_chip_mesh(CPU)
            assert (mesh.axis_names, mesh.shape, dist.get_backend()) == (
                ("hosts", "chips"), (1, 1), "gloo")
            img = render_frame_sharded(host.scene, cfg, cam, 0, mesh)
        finally:
            dist.destroy_process_group()
    assert torch.equal(img, render_frame(host.scene, cfg, cam, 0, CPU))


def test_matches_jax_render_frame_sharded(results):
    """The slice against the reference: the port's 2-rank image against
    surf_tpu's render_frame_sharded on a 2-device mesh (the conftest's
    virtual CPU devices), at tests/test_torch_render.py:59-60's gate."""
    host = JHostCompiled(jbuiltin.make_diffuse_box_scene())
    jcfg = JRenderConfig.for_scene(host.static, ranks.W, ranks.H, ranks.SPP, use_defocus=True)
    cp = JCameraParams.from_camera(jbuiltin.make_indoor_camera(ranks.W, ranks.H))
    ref = np.asarray(jrender_frame_sharded(host.render_scene, jcfg, cp, jnp.uint32(0),
                                           jmake_mesh(WORLD)))
    img = results[0]["images"][(("chips",), (WORLD,))].numpy()
    diff = np.abs(ref - img).max(axis=2)
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert abs(ref.sum() - img.sum()) / abs(ref.sum()) < 0.01

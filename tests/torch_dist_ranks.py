"""Rank bodies for the tests that spawn ranks of surf_tpu_torch.dist
(tests/test_torch_dist.py, tests/test_torch_app.py).  Each runs in a
spawned process already joined to a gloo process group
(``surf_tpu_torch.dist.launch.run_local_ranks``) and returns plain data.
Imports no JAX: the spawned interpreters import this module by name."""

from unittest import mock

import torch

from surf_tpu_torch.app import cli
from surf_tpu_torch.diff import DiffTargets, tree_flatten
from surf_tpu_torch.dist import (ShardedSession, grad_step_sharded, make_mesh, make_mesh_2d,
                                 render_frame_sharded, scaling_sweep, sharding,
                                 weak_scaling_sweep)
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams
from surf_tpu_torch.scene.compile import HostCompiled
from surf_tpu_torch.wavefront.integrator import RenderConfig, render_frame

CPU = torch.device("cpu")
W = H = 16          # tests/test_sharding.py:22-28: the 16x16 box at 2 spp
SPP = 2
BOUNCES = 12        # tests/test_sharding.py:50
COUNT_WIDTHS = (16, 32)  # tests/test_sharding.py:230
DT = 0.3
REF_SAMPLES = 64    # the reference image's sample stream
# tests/test_sharding.py:124-125's knobs (JAX's bits kernel there; the
# leaf-row plain version here)
KNOBS = dict(wave_limit=6, compact=True, algo="bitsru8", block_rays=1024)


def camera(w: int, h: int) -> CameraParams:
    return CameraParams.from_camera(builtin.make_indoor_camera(w, h), CPU)


def box_config(host: HostCompiled, w: int = W, h: int = H, spp: int = SPP) -> RenderConfig:
    return RenderConfig.for_scene(host.scene, w, h, spp, use_defocus=True)


def reference_image(host: HostCompiled, cfg: RenderConfig, cam: CameraParams) -> torch.Tensor:
    """An inverse-rendering target: the mean of another sample stream's
    frame [H, W, 3]."""
    return render_frame(host.scene, cfg, cam, REF_SAMPLES, CPU) / cfg.spp


def sharded_box() -> dict:
    """Everything tests/test_torch_dist.py asserts on, from one rank of a
    2-rank world, on the 16x16 box scene."""
    host = HostCompiled(builtin.make_diffuse_box_scene(), CPU)
    cfg = box_config(host)
    cam = camera(W, H)
    out = {"rank": torch.distributed.get_rank(), "images": {}}
    for mesh in (make_mesh(CPU), make_mesh_2d(1, 2, CPU), make_mesh_2d(2, 1, CPU)):
        out["images"][(mesh.axis_names, mesh.shape)] = render_frame_sharded(
            host.scene, cfg, cam, 0, mesh)
    mesh = make_mesh(CPU)
    out["knobs"] = render_frame_sharded(host.scene, cfg._replace(**KNOBS), cam, 0, mesh)

    targets = DiffTargets.from_scene(host.scene, cam)
    gcfg = cfg._replace(max_bounces=BOUNCES)
    out["grad"] = {}
    for ref in (None, reference_image(host, cfg, cam)):
        loss, grads = grad_step_sharded(host.scene, gcfg, targets, 0, mesh, ref)
        out["grad"][ref is not None] = (loss, tree_flatten(grads)[0])

    calls = []
    real = sharding._all_reduce

    def counted(t, m):
        calls.append(t.numel())
        return real(t, m)

    out["all_reduces"], out["lanes"] = {}, {}
    with mock.patch.object(sharding, "_all_reduce", counted):
        for w in COUNT_WIDTHS:
            c = box_config(host, w, 16, 1)._replace(max_bounces=4)
            calls.clear()
            grad_step_sharded(host.scene, c, DiffTargets.from_scene(host.scene, camera(w, 16)),
                              0, mesh)
            out["all_reduces"][w] = list(calls)
            out["lanes"][w] = [x.shape[0] for x in sharding._lane_arrays(c, 0, mesh)]

    try:
        render_frame_sharded(host.scene, cfg._replace(width=15, height=3), cam, 0, mesh)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)

    out["scaling"] = scaling_sweep(host.scene, cfg, cam, (1, 2), repeats=1)
    out["weak"] = weak_scaling_sweep(lambda n: box_config(host, W, 8 * n, 1), host.scene,
                                     lambda c: camera(c.width, c.height), (1, 2), repeats=1)

    sess = ShardedSession(host.scene, cfg, mesh)
    out["session"] = [sess.render(cam, 0), sess.render(cam, SPP)]
    host.update(DT)
    sess.update_scene(host.scene)
    out["session"].append(sess.render(cam, 0))
    return out


def sharded_cli(argv: list[str]) -> int:
    """The CLI with --shard on this rank."""
    return cli.main([*argv, "--shard"])

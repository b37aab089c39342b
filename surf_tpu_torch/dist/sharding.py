"""Data-parallel distribution (port of ``surf_tpu.dist.sharding``): pixel
lanes split over the ranks of a ``torch.distributed`` process group, the
scene replicated on every rank, gradients all-reduced.

JAX expresses this with ``NamedSharding`` annotations and lets XLA derive
the collectives; here each rank runs the port's host-driven integrator on
its own lanes and the module makes the two collectives itself:

- a frame: rank r of a W-rank mesh renders the contiguous lanes
  ``[r n/W, (r+1) n/W)`` of the ``n = W_img * H_img`` row-major pixels,
  seeded from their global lane ids (so the image equals the
  single-device frame's), and one all-gather returns the whole image to
  every rank.  Compaction and the width ladder run per rank on its own
  lanes; like JAX, the sharded path renders native lanes whatever
  ``cfg.pixel_order`` says;
- a gradient step: each rank differentiates its lanes' share of the
  global mean (divided by the global element count), and the loss and
  every gradient leaf are packed into one flat buffer, so a step makes
  exactly one all-reduce whatever the lane count.

The collectives are ``torch.distributed``'s: NCCL on the card, gloo on the
CPU, and gloo also for two ranks sharing one card (NCCL refuses a duplicate
GPU), whose collectives take CUDA tensors.

JAX's ``grad_step_compiled`` returns XLA's compiled HLO, which has no
PyTorch counterpart, and is not ported.  What its tests assert (the lanes
really split, one all-reduce whatever the lane count) is checked on the
port by counting the calls of ``_all_reduce`` and by the size of each
rank's lane arrays (``_lane_arrays``)."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..core import rng
from ..diff.estimator import DiffTargets, apply_targets
from ..diff.fd import tree_flatten
from ..scene.camera import CameraParams, view_plane
from ..scene.compile import PureScene, TorchScene
from ..wavefront.integrator import RenderConfig, _check_algo, render_sample


@dataclass(frozen=True)
class Mesh:
    """The first prod(shape) ranks of the initialised process group,
    shaped ``shape`` over ``axis_names`` (row-major, hosts first): rank r
    is the r-th of the row-major flattening.  ``group`` is their process
    group (``dist.GroupMember.NON_GROUP_MEMBER`` on a rank outside them)
    and ``device`` this rank's device."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    group: object
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def position(self) -> int | None:
        """This rank's place in the mesh, or None outside it."""
        r = dist.get_rank()
        return r if r < self.size else None

    def lanes(self, n: int) -> tuple[int, int]:
        """[lo, hi) of the n lanes that this rank owns."""
        if n % self.size:
            raise ValueError(f"lane count {n} not divisible by {self.size} ranks")
        p = self.position
        if p is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh {self.shape}")
        return p * n // self.size, (p + 1) * n // self.size


def _mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], device) -> Mesh:
    """A mesh over the first prod(shape) ranks of the world.  Every rank
    calls it in the same order: a mesh smaller than the world is a new
    group, which every rank of the world must create."""
    n = math.prod(shape)
    world = dist.get_world_size()
    if not 0 < n <= world:
        raise ValueError(f"a mesh of shape {shape} needs {n} ranks, the world has {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    return Mesh(axis_names, shape, group, torch.device(device))


def make_mesh(device, n_devices: int | None = None) -> Mesh:
    """1-D mesh over the 'chips' axis: the first ``n_devices`` ranks (all
    of the world without it)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return _mesh((n,), ("chips",), device)


def make_mesh_2d(n_hosts: int, chips_per_host: int, device) -> Mesh:
    """('hosts', 'chips') mesh, hosts-major: rank h * chips_per_host + c
    is chip c of host h."""
    return _mesh((n_hosts, chips_per_host), ("hosts", "chips"), device)


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """t summed over the mesh's ranks, in place."""
    dist.all_reduce(t, group=mesh.group)
    return t


def _all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' t (equal shapes) concatenated along dim 0 in mesh order."""
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def _lane_ids(cfg: RenderConfig, mesh: Mesh) -> torch.Tensor:
    """The global ids of this rank's lanes (native row-major pixels)."""
    lo, hi = mesh.lanes(cfg.width * cfg.height)
    return torch.arange(lo, hi, dtype=torch.int64, device=mesh.device)


def _lane_arrays(cfg: RenderConfig, total_samples: int, mesh: Mesh):
    """(seed0, px, py) of this rank's lanes, the seeds from the global ids
    (as the single-device frame seeds them)."""
    lane = _lane_ids(cfg, mesh)
    return rng.pixel_seed(lane, total_samples), lane % cfg.width, lane // cfg.width


def _render_lanes(scene: TorchScene | PureScene, cfg: RenderConfig, cam: CameraParams,
                  seed0, px, py) -> torch.Tensor:
    """cfg.spp samples of the given lanes: their radiance sums [n_local, 3]."""
    vp = view_plane(cam, cfg.width, cfg.height)
    seed = seed0
    acc = torch.zeros(seed0.shape[0], 3, device=seed0.device)
    for _ in range(cfg.spp):
        seed, energy = render_sample(scene, cfg, vp, seed, px, py)
        acc = acc + energy
    return acc


class ShardedSession:
    """Render-many over one mesh: the lane coordinates are made once; a
    frame makes its seeds, renders the rank's lanes and all-gathers the
    image.  ``update_scene`` takes the scene a ``HostCompiled`` holds after
    ``update`` (the port's scene lives on the device already)."""

    def __init__(self, scene: TorchScene | PureScene, cfg: RenderConfig, mesh: Mesh):
        _check_algo(scene, cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.lane = _lane_ids(cfg, mesh)
        self.px, self.py = self.lane % cfg.width, self.lane // cfg.width
        self.scene = scene

    def update_scene(self, scene: TorchScene | PureScene) -> None:
        _check_algo(scene, self.cfg)
        self.scene = scene

    def render(self, cam: CameraParams, total_samples: int) -> torch.Tensor:
        """One frame: the radiance sums [H, W, 3], the same on every rank."""
        cfg = self.cfg
        acc = _render_lanes(self.scene, cfg, cam, rng.pixel_seed(self.lane, total_samples),
                            self.px, self.py)
        return _all_gather(acc, self.mesh).reshape(cfg.height, cfg.width, 3)


def render_frame_sharded(scene: TorchScene | PureScene, cfg: RenderConfig,
                         cam: CameraParams, total_samples: int, mesh: Mesh) -> torch.Tensor:
    """One frame with the pixel lanes split over the mesh; returns the
    radiance sums [H, W, 3] on every rank (one all-gather)."""
    return ShardedSession(scene, cfg, mesh).render(cam, total_samples)


def grad_step_sharded(scene: TorchScene | PureScene, cfg: RenderConfig,
                      targets: DiffTargets, total_samples: int, mesh: Mesh,
                      reference_image: torch.Tensor | None = None):
    """One differentiable render and backward over the mesh: (loss,
    dloss/dtargets), the same on every rank.  The loss is the mean squared
    difference to ``reference_image`` ([H, W, 3]) if given, else the mean
    radiance, as ``diff.grad_image_loss``.  Each rank differentiates its
    lanes' share of the global mean; one all-reduce sums the shares of the
    loss and of every gradient leaf."""
    if cfg.max_bounces is None:
        raise ValueError("differentiable rendering needs a static bounce cap "
                         "(RenderConfig.max_bounces)")
    _check_algo(scene, cfg)
    seed0, px, py = _lane_arrays(cfg, total_samples, mesh)
    leaves, unflatten = tree_flatten(targets)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    t = unflatten(leaves)
    img = _render_lanes(apply_targets(scene, t), cfg, t.camera, seed0, px, py)
    img = img / img.new_tensor(float(cfg.spp))
    if reference_image is not None:
        lo, hi = mesh.lanes(cfg.width * cfg.height)
        d = img - reference_image.reshape(-1, 3)[lo:hi].to(img.device)
        img = d * d
    share = img.sum() / img.new_tensor(float(cfg.width * cfg.height * 3))
    grads = torch.autograd.grad(share, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    flat = _all_reduce(torch.cat([share.detach().reshape(1),
                                  *(g.reshape(-1) for g in grads)]), mesh)
    out, k = [], 1
    for g in grads:
        out.append(flat[k:k + g.numel()].reshape(g.shape))
        k += g.numel()
    return flat[0], unflatten(out)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_seconds(sess: ShardedSession, cam: CameraParams, repeats: int) -> float:
    """The least wall time of ``repeats`` frames after a warm-up frame,
    each ending in a device sync."""
    sess.render(cam, 0)
    _sync(sess.mesh.device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        sess.render(cam, 0)
        _sync(sess.mesh.device)
        best = min(best, time.perf_counter() - t0)
    return best


def _swept(seconds: float, mesh: Mesh) -> float:
    """The slowest member's time, on every rank of the world (the ranks
    outside the mesh wait here while the members render)."""
    t = torch.tensor([seconds if mesh.position is not None else 0.0],
                     dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def scaling_sweep(scene: TorchScene | PureScene, cfg: RenderConfig, cam: CameraParams,
                  device_counts, repeats: int = 3) -> dict:
    """Strong scaling, fixed total work: {rank count: best frame seconds}.
    Every rank of the world calls it; a count below the world size renders
    on the first ranks and the rest wait.  A frame ends in an all-gather,
    so its time is the slowest member's."""
    device = cam.position.device
    results = {}
    for nd in device_counts:
        mesh = make_mesh(device, nd)
        best = 0.0
        if mesh.position is not None:
            best = _best_seconds(ShardedSession(scene, cfg, mesh), cam, repeats)
        results[nd] = _swept(best, mesh)
    return results


def weak_scaling_sweep(make_cfg, scene: TorchScene | PureScene, cam_for, device_counts,
                       repeats: int = 3) -> dict:
    """Weak scaling, fixed work a rank: ``make_cfg(n)`` gives a config
    whose lane count grows with n, ``cam_for(cfg)`` its camera.  Returns
    {rank count: (best frame seconds, lanes a rank)}."""
    results = {}
    for nd in device_counts:
        cfg = make_cfg(nd)
        cam = cam_for(cfg)
        mesh = make_mesh(cam.position.device, nd)
        best = 0.0
        if mesh.position is not None:
            best = _best_seconds(ShardedSession(scene, cfg, mesh), cam, repeats)
        results[nd] = (_swept(best, mesh), cfg.width * cfg.height // nd)
    return results

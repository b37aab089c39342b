"""The command line (port of ``surf_tpu.app.cli``) — the headless analog of the
reference's main loop (main.cpp:381-446): progressive frames with optional
animation, per-frame metrics, accumulator checkpoint/resume, image output.

    python -m surf_tpu_torch.app.cli --scene indoor --width 512 --height 512 \
        --spp 4 --frames 4 --output out.png --metrics-jsonl metrics.jsonl

``--device cuda`` (the default) renders on the card and raises without
one; ``--device cpu`` renders on the CPU.  ``--shard`` splits the pixel
lanes over the ranks of a process group: under ``torchrun
--nproc-per-node=N -m surf_tpu_torch.app.cli --shard ...`` one rank a GPU,
alone a world of one in this process (``dist.init_multihost``).  Rank 0
alone prints and writes the image, the metrics and the checkpoint.
"""

from __future__ import annotations

import argparse
import collections
import sys

import torch
import torch.distributed as dist

from ..dist import init_multihost, make_mesh, render_frame_sharded
from ..scene import builtin
from ..scene.camera import CameraParams
from ..scene.compile import HostCompiled
from ..scene.loader import camera_from_spec, load_scene_file
from ..wavefront.accumulator import Accumulator
from ..wavefront.integrator import (
    RenderConfig,
    empty_frame_carry,
    initial_seeds,
    render_frame,
    render_frame_carry,
    render_frame_instrumented,
)
from .config import AppConfig
from .image_io import save_image
from .metrics import MetricsLog


def build_scene(cfg: AppConfig, device: torch.device):
    """Returns (HostCompiled, camera_spec|None)."""
    cam_spec = None
    if cfg.scene == "indoor":
        scene = builtin.make_indoor_scene()
    elif cfg.scene == "box":
        scene = builtin.make_diffuse_box_scene()
    elif cfg.scene.endswith(".json"):
        scene, cam_spec = load_scene_file(cfg.scene)
    else:
        raise ValueError(f"unknown scene: {cfg.scene}")
    return HostCompiled(scene, device), cam_spec


def _device(name: str) -> torch.device:
    """The device to render on; a CUDA device must exist (no fallback)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but CUDA is not available "
                               "(pass --device cpu to render on the CPU)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unknown device: {name}")
    return device


def run(cfg: AppConfig) -> dict:
    """Render cfg.frames frames; returns the accumulated energy, the
    sample count and the last frame's Mrays/s.  With ``cfg.shard`` and no
    process group yet, starts one (``dist.init_multihost``) and destroys
    it at the end."""
    own_group = False
    if cfg.shard and not dist.is_initialized():
        init_multihost(device=cfg.device)
        own_group = True
    try:
        return _run(cfg)
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(cfg: AppConfig) -> dict:
    device = _device(cfg.device)
    host, cam_spec = build_scene(cfg, device)
    if cam_spec is not None:
        cam = camera_from_spec(cam_spec, cfg.width, cfg.height)
    else:
        cam = builtin.make_indoor_camera(cfg.width, cfg.height)
    if cfg.focal_length is not None:
        cam.focal_length = cfg.focal_length
    if cfg.defocus_angle is not None:
        cam.defocus_angle = cfg.defocus_angle
    cam_params = CameraParams.from_camera(cam, device)

    rcfg = RenderConfig.for_scene(
        host.scene, cfg.width, cfg.height, cfg.spp,
        use_defocus=cam.defocus_angle != 0.0,
        max_bounces=cfg.max_bounces,
    )._replace(compact=cfg.compact)
    if cfg.wave_limit is not None:
        rcfg = rcfg._replace(wave_limit=cfg.wave_limit)
    if cfg.algo is not None:
        rcfg = rcfg._replace(algo=cfg.algo)
    if cfg.ladder:
        rcfg = rcfg._replace(ladder=cfg.ladder,
                             ladder_shrink=cfg.ladder_shrink)
    if cfg.block_rays is not None:
        rcfg = rcfg._replace(block_rays=cfg.block_rays)
    # pixel_order applies to the plain render path; the sharded /
    # wave-stats / deferral variants keep their own native lane layouts.
    if not (cfg.shard or cfg.wave_stats or cfg.defer):
        rcfg = rcfg._replace(pixel_order=cfg.pixel_order)

    if cfg.resume and cfg.checkpoint:
        acc = Accumulator.load(cfg.checkpoint)
        if (acc.width, acc.height) != (cfg.width, cfg.height):
            raise ValueError(f"checkpoint {cfg.checkpoint} is {acc.width}x{acc.height}, "
                             f"not {cfg.width}x{cfg.height}")
    else:
        acc = Accumulator(cfg.width, cfg.height)
    acc.total_samples += cfg.seed_offset

    mesh = None
    lead = True  # the rank that prints and writes
    if cfg.shard:
        mesh = make_mesh(device)
        lead = dist.get_rank() == 0

    log = MetricsLog(cfg.width, cfg.height, cfg.metrics_jsonl if lead else None)
    n_tris = sum(inst.mesh.tri_count for inst in host.host_scene.instances)
    if lead:
        print(
            f"surf_tpu_torch: {cfg.scene} {cfg.width}x{cfg.height} spp={cfg.spp} "
            f"frames={cfg.frames} tris={n_tris} device={device}"
            f"{f' ranks={mesh.size} (sharded)' if mesh else ''}"
        )

    # Frames in flight (renderer.h:22, FRAMES_IN_FLIGHT=3): the host
    # readback and accumulation of a frame wait for up to (depth-1) later
    # frames to be dispatched; depth=1 reproduces the strictly-blocking loop.
    flight = max(1, cfg.frames_in_flight)
    pending: collections.deque = collections.deque()

    def finish_one():
        radiance_d, spp_f, extra_f, clear_first = pending.popleft()
        if clear_first:
            # Scene motion invalidates the accumulator (main.cpp:411-419);
            # deferred to drain time so in-flight frames land in order.
            acc.clear()
        extra_f = {k: float(v) for k, v in extra_f.items()}
        acc.add_frame(radiance_d.cpu().numpy(), spp_f)
        m = log.tick(spp_f, acc.total_samples, acc.energy(), **extra_f)
        if lead:
            print(m.format_line())
            if extra_f:
                print(f"  waves={extra_f['waves']:.0f} "
                      f"occupancy={extra_f['occupancy']:.3f} "
                      f"deferred={extra_f['deferred']:.0f}")

    carry = None
    dispatch_samples = acc.total_samples
    for frame in range(cfg.frames):
        clear_first = False
        if cfg.animate and frame > 0:
            host.update(cfg.dt, rebuild=cfg.rebuild_bvh)
            clear_first = True
            dispatch_samples = 0

        extra = {}
        if mesh is not None:
            radiance = render_frame_sharded(host.scene, rcfg, cam_params,
                                            dispatch_samples, mesh)
        elif cfg.wave_stats:
            radiance, extra = render_frame_instrumented(
                host.scene, rcfg, cam_params, dispatch_samples, device)
        elif cfg.defer:
            # Cross-frame deferral (renderer.cpp:1101-1104): capped-out
            # paths resume next frame; zero estimator bias at any wave cap.
            if carry is None or (cfg.animate and frame > 0):
                carry = empty_frame_carry(rcfg, device)  # the scene moved: discard
            seed0 = initial_seeds(rcfg, dispatch_samples, device)
            radiance, _, carry = render_frame_carry(host.scene, rcfg, cam_params, seed0,
                                                    carry)
        else:
            radiance = render_frame(host.scene, rcfg, cam_params, dispatch_samples, device)
        pending.append((radiance, cfg.spp, extra, clear_first))
        dispatch_samples += cfg.spp
        while len(pending) >= flight:
            finish_one()
    while pending:
        finish_one()

    if lead and cfg.checkpoint and not cfg.resume:
        acc.save(cfg.checkpoint)
    if lead and cfg.output:
        save_image(cfg.output, acc.resolve())
        print(f"wrote {cfg.output}")

    return {
        "energy": acc.energy(),
        "total_samples": acc.total_samples,
        "mrays_per_s": log.history[-1].mrays_per_s if log.history else 0.0,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="surf_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", help="JSON config file (AppConfig fields)")
    p.add_argument("--scene", default="indoor",
                   help="indoor | box | path to a scene .json")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--max-bounces", type=int, default=None)
    p.add_argument("--animate", action="store_true")
    p.add_argument("--rebuild-bvh", action="store_true")
    p.add_argument("--focal-length", type=float, default=None)
    p.add_argument("--defocus-angle", type=float, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--shard", action="store_true")
    p.add_argument("--output", default=None)
    p.add_argument("--metrics-jsonl", default=None)
    p.add_argument("--wave-stats", action="store_true")
    p.add_argument("--compact", action="store_true")
    p.add_argument("--defer", action="store_true", dest="defer_paths")
    p.add_argument("--wave-limit", type=int, default=None)
    p.add_argument("--algo", default=None)
    p.add_argument("--ladder", type=int, default=0,
                   help="width-ladder rungs for the wave loop")
    p.add_argument("--ladder-shrink", type=int, default=4,
                   help="ladder width divisor per rung")
    p.add_argument("--block-rays", type=int, default=None)
    p.add_argument("--pixel-order", default="native",
                   choices=["native", "morton"],
                   help="lane->pixel mapping (morton = tiled packets)")
    p.add_argument("--frames-in-flight", type=int, default=1,
                   help="dispatch-ahead depth (reference FRAMES_IN_FLIGHT=3)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", action="store_true")
    args = p.parse_args(argv)

    if args.config:
        cfg = AppConfig.from_file(args.config)
    else:
        cfg = AppConfig(
            scene=args.scene, width=args.width, height=args.height,
            spp=args.spp, frames=args.frames, max_bounces=args.max_bounces,
            animate=args.animate, rebuild_bvh=args.rebuild_bvh,
            focal_length=args.focal_length, defocus_angle=args.defocus_angle,
            device=args.device, shard=args.shard, output=args.output,
            metrics_jsonl=args.metrics_jsonl, checkpoint=args.checkpoint,
            resume=args.resume, wave_stats=args.wave_stats,
            compact=args.compact, defer=args.defer_paths,
            wave_limit=args.wave_limit, algo=args.algo,
            ladder=args.ladder, ladder_shrink=args.ladder_shrink,
            block_rays=args.block_rays, pixel_order=args.pixel_order,
            frames_in_flight=args.frames_in_flight,
        )
    run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Application configuration (port of ``surf_tpu.app.config``).

Replaces the reference's compile-time #defines + RendererConfig + UIState
(SURVEY.md §5.6: GPU_PATH_TRACING, RESOLUTION_SCALE, maxBounces,
samplesPerFrame, focalLength/defocus sliders, animate toggle) with one
dataclass settable from CLI flags or a JSON file.  JAX's ``backend``
("default | cpu | cpu8", virtual devices) is ``device`` here: the port has
no virtual devices, and ``shard`` takes its ranks from the launcher."""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass


@dataclass
class AppConfig:
    scene: str = "indoor"          # indoor | box | path to a scene .json
    width: int = 1280
    height: int = 720
    spp: int = 1                   # samples per frame (UIState.spp, 1-24 slider)
    frames: int = 1                # number of progressive frames
    max_bounces: int | None = None # None = unbounded (RR-terminated)
    seed_offset: int = 0           # initial totalSamples offset
    animate: bool = False          # rotate instance 3 per frame (UIState.animate)
    rebuild_bvh: bool = False      # full SAH rebuild per frame (config 4)
    focal_length: float | None = None   # override camera focal length
    defocus_angle: float | None = None  # override defocus angle
    device: str = "cuda"           # cuda | cpu (no fallback between them)
    output: str | None = None      # .png / .npy path
    metrics_jsonl: str | None = None
    checkpoint: str | None = None  # accumulator checkpoint path (.npz)
    resume: bool = False
    shard: bool = False            # shard lanes over the process group's ranks
    dt: float = 1.0 / 60.0         # animation time step per frame
    wave_stats: bool = False       # per-frame wavefront stats (waves/occupancy)
    compact: bool = False          # stream compaction each wave
    defer: bool = False            # cross-frame deferral of capped paths
    wave_limit: int | None = None  # override the per-sample wave cap
    algo: str | None = None        # wide-kernel walk algorithm override
    ladder: int = 0                # width-ladder rungs for the wave loop
    ladder_shrink: int = 4         # ladder width divisor per rung
    block_rays: int | None = None  # traversal packet size override
    pixel_order: str = "native"    # lane->pixel map ("morton" = tiled
                                   # traversal packets; bit-identical)
    frames_in_flight: int = 1      # dispatch-ahead depth (renderer.h:22 = 3)

    @classmethod
    def from_file(cls, path: str) -> "AppConfig":
        with open(path) as fh:
            return cls(**json.load(fh))

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

"""The headline benchmark of the port: ``bench.py``'s first configuration
through ``surf_tpu_torch``.

    python -m surf_tpu_torch.bench --device cuda

renders the built-in indoor scene at 512x512 @ 16 spp as 16 one-spp calls
with the bench knobs (``integrator.BENCH_KNOBS``: wave cap 32, 2048-ray
packets, compaction every 16 waves, a 6-rung ladder with shrink 2, Morton
lanes): one warm-up frame at total_samples 0, then FRAMES timed frames at
total_samples 16 and 32, each ending in a device synchronise.  It prints
``bench.py``'s one JSON line,

    {"metric": "rays_per_s_chip", "value": N, "unit": "rays/s",
     "vs_baseline": x, "detail": {...}}

with N = W * H * spp / mean frame time (primary samples per second) and
x = N / 2e8, the BASELINE.json north star; ``detail`` names the device (on
CUDA the card's name and power limit as ``nvidia-smi`` gives them), the
configuration, the frame times and the energy (sum of the last frame's
image / spp).  Unlike ``bench.py`` it falls back to nothing: ``--device
cuda`` without a CUDA device exits non-zero.  Smaller sizes and the CPU
(``--device cpu --size 16 --spp 1``) are for tests.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .scene import builtin
from .scene.camera import CameraParams
from .scene.compile import compile_scene
from .wavefront import integrator as wi

BASELINE_RAYS_PER_S = 2.0e8
FRAMES = 2


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def _frame(scene, cfg, cam, device, total_samples: int, spp: int) -> torch.Tensor:
    """One frame of ``spp`` one-spp calls continuing the per-pixel seeds
    from ``total_samples``, as bench.py chunks it; synchronised."""
    seed = wi.initial_seeds(cfg, total_samples, device)
    acc = None
    for _ in range(spp):
        part, seed = wi.render_frame_seeded(scene, cfg, cam, seed)
        acc = part if acc is None else acc + part
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return acc


def run_bench(device: torch.device, width: int = 512, height: int = 512,
              spp: int = 16) -> dict:
    """bench.py's JSON record of FRAMES timed frames after a warm-up."""
    scene = compile_scene(builtin.make_indoor_scene(), device)
    cfg = wi.RenderConfig.for_scene(scene, width, height, 1,
                                    use_defocus=True)._replace(**wi.BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(width, height), device)
    _frame(scene, cfg, cam, device, 0, spp)  # warm-up
    times, img = [], None
    for i in range(FRAMES):
        t0 = time.perf_counter()
        img = _frame(scene, cfg, cam, device, (i + 1) * spp, spp)
        times.append(time.perf_counter() - t0)
    dt = sum(times) / FRAMES
    energy = float(img.sum()) / spp
    if not (np.isfinite(energy) and energy > 0):
        raise RuntimeError(f"render produced bad energy {energy}")
    rays_per_s = width * height * spp / dt
    return {
        "metric": "rays_per_s_chip", "value": rays_per_s, "unit": "rays/s",
        "vs_baseline": rays_per_s / BASELINE_RAYS_PER_S,
        "detail": {
            "device": _card(device),
            "config": dict(scene="indoor", width=width, height=height, spp=spp,
                           spp_chunk=1, frames=FRAMES, algo=cfg.algo, **wi.BENCH_KNOBS),
            "frame_times_s": times, "frame_time_s": dt, "energy": energy,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", required=True, help="cuda, cuda:N or cpu")
    ap.add_argument("--size", type=int, default=512, help="width and height")
    ap.add_argument("--spp", type=int, default=16)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("surf_tpu_torch.bench: no CUDA device")
    print(json.dumps(run_bench(device, args.size, args.size, args.spp)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

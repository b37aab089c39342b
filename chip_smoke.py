#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (surf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles surf_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  3. kernel: the leaf-row kernel against its plain PyTorch version on the
     card, at the bench's shapes (512x512 = 262,144 rays of the indoor
     scene, 2048-ray packets): primary rays and one bounce's rays, closest
     hit, any-hit trim and the overflow sweep (forced with cap_rows=8),
     with one all-dead packet.  Expected bit-identical (--fmad=false);
     else the gate of the JAX tests: prim equal except coincident-t ties,
     t within rtol 1e-6;
  4. bench: the bench config (bench.py: indoor scene, 512x512 @ 16 spp as
     16 one-spp calls, wave cap 32, 2048-ray packets, Morton lanes,
     compaction every 16 waves, ladder 6 / shrink 2) through the kernel:
     frame time, rays/s, energy and the kernel's launch counts;
  5. parity: 64x64 @ 2 spp with the bench knobs through the kernel and
     through the plain version on the card (energy within 1%, relative
     L1 under 3%; bit equality expected).
Then a JSON line of per-kernel results and, last, the device summary.
Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from surf_tpu_torch.accel import _build, bits
from surf_tpu_torch.accel.leaf_rows import (LAUNCHES, leaf_rows,
                                            leaf_rows_plain, reset_launches)
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams, view_plane
from surf_tpu_torch.scene.compile import compile_scene
from surf_tpu_torch.wavefront import integrator as wi

TPU_ENERGY = 87157.2109375  # surf_tpu on a TPU v5e, BENCH_r05.json
W = H = 512
SPP = 16
BENCH_KNOBS = dict(wave_limit=32, block_rays=2048, compact=True,
                   compact_every=16, ladder=6, ladder_shrink=2,
                   pixel_order="morton")


def say(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    say(smi)
    say(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def phase_build() -> None:
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    log = so.with_suffix(".log")
    info = [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "Compiling entry" in ln] if log.exists() else []
    say(f"[2 build] {so.name} in {dt:.1f} s (0 s means it was already built)")
    for ln in info:
        say(f"[2 build]   {ln}")


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _compare(got, want):
    """(bit-identical?, max |dt| over lanes where both hit, gate holds?)."""
    t_k, r_k, u_k, v_k = got
    t_p, r_p, u_p, v_p = want
    bit = all(torch.equal(x, y) for x, y in zip(got, want))
    both = (r_k >= 0) & (r_p >= 0)
    err = float((t_k - t_p)[both].abs().max()) if bool(both.any()) else 0.0
    tie = t_k == t_p
    gate = bool(((r_k == r_p) | tie).all()) and bool(
        torch.allclose(t_k[both], t_p[both], rtol=1e-6, atol=0.0))
    return bit, err, gate


def phase_kernel(dev: torch.device) -> dict:
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cfg = wi.RenderConfig.for_scene(scene, W, H, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(W, H), dev)
    vp = view_plane(cam, W, H)
    perm = wi.lane_pixel_perm(cfg, dev)
    seed = wi.initial_seeds(cfg, 0, dev)[perm]
    seed, origin, direction = wi.ray_generation(cfg, vp, seed, perm % W, perm // W)
    n = W * H
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[5 * 2048:6 * 2048] = False  # one all-dead packet
    state = wi.PathState(origin, direction, seed, torch.ones(n, 3, device=dev),
                         torch.zeros(n, 3, device=dev), alive.clone(),
                         torch.zeros(n, dtype=torch.bool, device=dev), alive, perm)
    bounced = wi.bounce_step(scene, cfg, state)
    far = torch.full((n,), 1e30, device=dev)
    sets = {
        "primary/closest": (origin, direction, far, alive, False, 0),
        "bounce/closest": (bounced.origin, bounced.direction, far, bounced.alive, False, 0),
        "primary/any_hit": (origin, direction, torch.full((n,), 8.0, device=dev), alive, True, 0),
        "bounce/any_hit": (bounced.origin, bounced.direction,
                           torch.full((n,), 4.0, device=dev), bounced.alive, True, 0),
        "primary/sweep": (origin, direction, far, alive, False, 8),
        "bounce/sweep": (bounced.origin, bounced.direction, far, bounced.alive, False, 8),
    }
    out = {"leaf_rows_closest": {"max_abs_err": 0.0}, "leaf_rows_any": {"max_abs_err": 0.0}}
    for label, (o, d, tm, act, any_hit, cap) in sets.items():
        rays, lists, n_rows = bits.prepare(scene.trace, o, d, tm, act, 2048, cap)
        args = (scene.trace.ltab, lists, n_rows, rays, 2048, any_hit)
        got = leaf_rows(*args)
        want = leaf_rows_plain(*args)
        torch.cuda.synchronize()
        bit, err, gate = _compare(got, want)
        if not (bit or gate):
            raise AssertionError(f"{label}: kernel disagrees with the plain version "
                                 f"(max |dt| {err})")
        k_ms = _time_ms(lambda: leaf_rows(*args), 20)
        p_ms = _time_ms(lambda: leaf_rows_plain(*args), 3)
        sweeps = int((n_rows < 0).sum())
        say(f"[3 kernel] {label}: {'bit-identical' if bit else 'within gate'}, "
            f"max |dt| {err:.3g}, kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"packets {lists.shape[0]} (sweep {sweeps}), cap {lists.shape[1]}, "
            f"mean list {float(n_rows.clamp(min=0).float().mean()):.1f} rows")
        name = "leaf_rows_any" if any_hit else "leaf_rows_closest"
        rec = out[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if label in ("bounce/closest", "bounce/any_hit"):
            rec["ms"], rec["plain_ms"] = k_ms, p_ms
    return out


def _render(scene, cfg, cam, dev, total_samples, calls):
    """``calls`` chunked render calls of cfg.spp each, as bench.py chunks
    spp, continuing the per-pixel seed streams."""
    seed = wi.initial_seeds(cfg, total_samples, dev)
    acc = None
    for _ in range(calls):
        part, seed = wi.render_frame_seeded(scene, cfg, cam, seed)
        acc = part if acc is None else acc + part
    return acc


def phase_bench(dev: torch.device) -> dict:
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cfg = wi.RenderConfig.for_scene(scene, W, H, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(W, H), dev)
    _render(scene, cfg, cam, dev, 0, 1)  # warm-up: allocator, first launches
    torch.cuda.synchronize()
    reset_launches()
    times = []
    for frame in (1, 2):  # bench.py times frames at total_samples 16 and 32
        t0 = time.perf_counter()
        img = _render(scene, cfg, cam, dev, frame * SPP, SPP)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    img = img.cpu().numpy()
    if not (np.isfinite(img).all() and (img >= 0).all()):
        raise AssertionError("bench image has non-finite or negative values")
    energy = float(img.sum()) / SPP
    if not energy > 0:
        raise AssertionError(f"bench energy {energy} is not positive")
    for name, k in launches.items():
        if k <= 0:
            raise AssertionError(f"{name} was never launched by the render")
    dt = sum(times) / len(times)
    say(f"[4 bench] {W}x{H} @ {SPP} spp, frame times {['%.3f' % t for t in times]} s, "
        f"mean {dt:.3f} s, {W * H * SPP / dt:.1f} rays/s")
    say(f"[4 bench] energy {energy!r} (TPU run of surf_tpu: {TPU_ENERGY!r}, "
        f"rel diff {(energy - TPU_ENERGY) / TPU_ENERGY:+.4%}); launches {launches}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_parity(dev: torch.device) -> None:
    w = h = 64
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cfg = wi.RenderConfig.for_scene(scene, w, h, 2, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    img_k = _render(scene, cfg, cam, dev, 0, 1).cpu().numpy()
    # the same render with the traversal's intersect swapped for the plain version
    with mock.patch.object(bits, "leaf_rows", leaf_rows_plain):
        img_p = _render(scene, cfg, cam, dev, 0, 1).cpu().numpy()
    e_k, e_p = float(img_k.sum()), float(img_p.sum())
    rel_e = abs(e_k - e_p) / e_p
    rel_l1 = float(np.abs(img_k - img_p).mean() / img_p.mean())
    say(f"[5 parity] {w}x{h} @ 2 spp: energy kernel {e_k!r} plain {e_p!r} "
        f"(rel {rel_e:.3g}), relL1 {rel_l1:.3g}, bit-identical "
        f"{bool(np.array_equal(img_k, img_p))}")
    if not (rel_e < 0.01 and rel_l1 < 0.03):
        raise AssertionError("kernel render disagrees with the plain render")


def main() -> int:
    dev = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    kernels = phase_kernel(dev)
    launches = phase_bench(dev)
    phase_parity(dev)
    rows = []
    for name, rec in kernels.items():
        rows.append({
            "name": name, "route": "cuda",
            "source": "surf_tpu_torch/csrc/leaf_rows.cu",
            "replaces": "surf_tpu/accel/pallas_wide.py:1287",
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

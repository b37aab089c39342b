"""Where a frame's time goes: one spp of a bench-knob render under
``torch.profiler``, with the render's layers annotated.

    python -m surf_tpu_torch.breakdown --scene stress --algo twolevelp
    python -m surf_tpu_torch.breakdown --scene indoor --algo bitsru8
    python -m surf_tpu_torch.breakdown --scene indoor --algo bitsw   # any bits* algo
    python -m surf_tpu_torch.breakdown --scene indoor --algo skip    # or stack
    python -m surf_tpu_torch.breakdown --scene indoor --algo spec4   # skip2, ilvN, specN, specbN
    python -m surf_tpu_torch.breakdown --scene indoor --algo binary  # use_wide=False
    python -m surf_tpu_torch.breakdown --scene indoor --algo bitsru8 --grad

Runs on the card at 512x512 with the bench knobs (the stress scene with
32 instances, as ``chip_smoke.py`` renders it): one warm-up spp, 4
unprofiled spp timed on the host clock, then one spp profiled.  Prints
the kernel count, the total kernel
time, the device's busy share of the profiled spp's wall time (the union of
the kernel intervals over the wall time) and, per layer, the device time of
the kernels launched inside it and inside no layer nested in it ("shading"
is what no layer claims, "unattributed" device work the profiler links to
no CPU op).  The layers are annotated by wrapping the port's
functions for the duration of the run; the port's code carries no
annotations.

With ``--grad`` each spp is a gradient step instead
(``diff.grad_image_loss``, mean radiance, ``max_bounces=GRAD_BOUNCES``,
the ladder off; no wave is checkpointed at this size on an 80 GB card):
the kernels that autograd's backward launches form the layer "backward",
and the kernels with the most device time are listed by name.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import time
from unittest import mock

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .accel import bits, bvh_walk, instanced, pairs, stream
from .core import sampling
from .diff import DiffTargets, grad_image_loss
from .scene import builtin
from .scene.camera import CameraParams
from .scene.compile import compile_scene
from .wavefront import integrator as wi

SIZE = 512        # image width and height
STRESS_N = 32     # instanced copies in the stress scene
TIMED_SPP = 4     # unprofiled spp timed on the host clock
GRAD_BOUNCES = 12  # --grad: the static wave count
TOP_KERNELS = 12   # --grad: kernels listed by device time
BACKWARD = "autograd::engine::evaluate_function"  # a backward node's CPU op
# (module, attribute, layer): the functions whose calls form each layer.
# A kernel counts toward the innermost layer it was launched in.  The
# hand-written kernels are launched through ctypes, outside any torch op,
# so the profiler links them to no CPU event: they count by name.
OWN_KERNELS = {"leaf_rows_kernel": "leaf_rows kernel",
               "leaf_rows_live_kernel": "leaf_rows kernel",
               "leaf_rows_bf16_live_kernel": "leaf_rows kernel",
               "inst_rows_kernel": "inst_rows kernel",
               "inst_rows_live_kernel": "inst_rows kernel",
               "stream_walk_": "stream_walk kernel",
               "bvh_walk_kernel": "bvh_walk kernel",
               "bvh_walk_live_kernel": "bvh_walk kernel"}
LAYERS = (
    (wi, "ray_generation", "raygen"),
    (wi, "compact_paths", "compaction"),
    (bits, "packet_vis", "bits phases 1/1.5"),
    (bits, "row_lists", "bits phases 1/1.5"),
    (bits, "group_any", "bits phases 1/1.5"),
    (bits, "group_lists", "bits phases 1/1.5"),
    (pairs, "pair_hits", "bitsp pair lists"),
    (bits, "leaf_rows", "leaf_rows kernel"),
    (instanced, "prepare", "twolevelp phases 0/1"),
    (instanced, "inst_rows", "inst_rows kernel"),
    (stream, "stream_walk", "stream_walk kernel"),
    (bvh_walk, "bvh_walk", "bvh_walk kernel"),
    (wi, "_next_event", "NEE (not its traversal)"),
    (sampling, "cosine_hemisphere", "cosine sampling"),
)


def _annotated(fn, label):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return wrapper


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _algo(name: str) -> str:
    if name != "binary" and not wi.is_ported(name):
        raise argparse.ArgumentTypeError(
            f"{name!r} is not an algo render_frame_seeded renders ({wi.ALGOS}, "
            f"a bits* string of traverse_wide, or binary)")
    return name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=("indoor", "stress"), default="stress")
    ap.add_argument("--algo", type=_algo, default="twolevelp",
                    help="a RenderConfig algo (twolevelp, a stream walk such as skip, "
                         "stack, skip2, ilv2, spec4, specb8, or any bits* "
                         "string), or binary: the binary walk (use_wide=False)")
    ap.add_argument("--grad", action="store_true",
                    help="profile a gradient step (grad_image_loss) instead of a frame")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("breakdown: no CUDA device")
    dev = torch.device("cuda", 0)
    w = h = SIZE
    if args.scene == "stress":
        scene = builtin.make_instanced_stress_scene(STRESS_N)
        cam = builtin.make_stress_camera(w, h, STRESS_N)
    else:
        scene = builtin.make_indoor_scene()
        cam = builtin.make_indoor_camera(w, h)
    ts = compile_scene(scene, dev, two_level="pure" if args.algo == "twolevelp" else False)
    walk = dict(use_wide=False) if args.algo == "binary" else dict(algo=args.algo)
    cfg = wi.RenderConfig.for_scene(ts, w, h, 1, use_defocus=True)._replace(
        **wi.BENCH_KNOBS, **walk)
    cp = CameraParams.from_camera(cam, dev)
    if args.grad:
        cfg = cfg._replace(max_bounces=GRAD_BOUNCES)
        targets = DiffTargets.from_scene(ts, cp)
        spp = [0]

        def step(seed):  # each step at the next sample count's seeds
            spp[0] += 1
            grad_image_loss(ts, cfg, targets, spp[0], dev)
            return seed
    else:
        def step(seed):
            return wi.render_frame_seeded(ts, cfg, cp, seed)[1]

    seed = step(wi.initial_seeds(cfg, 16, dev))  # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(TIMED_SPP):
        t0 = time.perf_counter()
        seed = step(seed)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    with contextlib.ExitStack() as stack:
        for mod, name, label in LAYERS:
            stack.enter_context(mock.patch.object(
                mod, name, _annotated(getattr(mod, name), label)))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(seed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    labels = {label for _, _, label in LAYERS}
    layer_us = dict.fromkeys([label for _, _, label in LAYERS] + ["shading", "backward"], 0.0)
    calls = dict.fromkeys(layer_us, 0)
    n_kernels, k_us, spans = 0, 0.0, []
    by_name: dict[str, list] = {}

    def layer(e):
        """The innermost annotated layer of a CPU op (or "backward"), or
        None."""
        while e is not None and e.name not in labels and not e.name.startswith(BACKWARD):
            e = e.cpu_parent
        return None if e is None else (e.name if e.name in labels else "backward")

    def own(name):
        return next((v for k, v in OWN_KERNELS.items() if k in name), None)

    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name in labels:  # the device copy of an annotation
                continue
            spans.append((e.time_range.start, e.time_range.end))
            n_kernels += 1
            k_us += e.time_range.elapsed_us()
            rec = by_name.setdefault(e.name, [0, 0.0])
            rec[0] += 1
            rec[1] += e.time_range.elapsed_us()
            if own(e.name):
                layer_us[own(e.name)] += e.time_range.elapsed_us()
            continue
        p = layer(e)
        if p == e.name:
            calls[e.name] += 1
        for k in e.kernels:  # a kernel attaches to the op that launched it
            if not own(k.name):
                layer_us["shading" if p is None else p] += k.duration
    layer_us["unattributed"] = k_us - sum(layer_us.values())
    calls["unattributed"] = 0
    busy = _union_us(spans)
    what = f", gradient step (max_bounces {GRAD_BOUNCES})" if args.grad else ""
    print(f"scene {args.scene} ({len(scene.instances)} instances), algo {args.algo}, "
          f"{w}x{h}, bench knobs{what}, device {torch.cuda.get_device_name(dev)}")
    print(f"unprofiled spp wall (s): {[round(x, 4) for x in walls]}")
    print(f"profiled spp: wall {wall:.4f} s, {n_kernels} kernels, kernel time "
          f"{k_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
          f"({busy / 1e6 / wall:.1%} of wall)")
    for label, us in layer_us.items():
        print(f"  {label:26s} calls {calls[label]:5d}  device {us / 1e3:9.2f} ms"
              f"  ({us / max(k_us, 1):.1%} of kernel time)")
    if args.grad:
        print("kernels with the most device time:")
        for name, (n, us) in sorted(by_name.items(), key=lambda x: -x[1][1])[:TOP_KERNELS]:
            print(f"  {n:6d} x {us / 1e3:9.2f} ms  {name[:110]}")


if __name__ == "__main__":
    main()

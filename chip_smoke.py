#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (surf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles surf_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
     process per source, all started together;
  3. kernel: the leaf-row kernel against its plain PyTorch version on the
     card, at the bench's shapes (512x512 = 262,144 rays of the indoor
     scene, 2048-ray packets): primary rays and one bounce's rays, closest
     hit, any-hit trim and the overflow sweep (forced with cap_rows=8),
     with one all-dead packet.  Expected bit-identical (--fmad=false);
     else the gate of the JAX tests: prim equal except coincident-t ties,
     t within rtol 1e-6;
  3b. inst kernel: the instanced leaf-row kernel against its plain version
     on the pure two-level stress scene (32 instances, 512x512 primary
     rays and one bounce's rays, 2048-ray packets, one all-dead packet):
     closest, any-hit (t_max 16 primary, 4 bounce) and per-instance sweeps
     (inst_cap=8), with the same gates;
  3c. stream walks: the skip and stack walk kernels against their plain
     versions on the indoor scene's 8-wide stream, primary and one
     bounce's rays at 512x512, 2048-ray packets, one all-dead packet,
     closest and any-hit (t_max 8 primary, 4 bounce): t, record, u, v and
     the per-packet visit counts: the counts must be equal, the hits
     bit-identical expected (else the gate of phase 3); the bound counts
     the slab and triangle tests of the live rays (active, and for any-hit
     without a hit yet) at each row the plain version visits;
  3d. binary walk: the binary-BVH walk kernel against its plain version on
     the same rays in 1024-ray packets, the same way;
  4. bench: the bench config (bench.py: indoor scene, 512x512 @ 16 spp as
     16 one-spp calls, wave cap 32, 2048-ray packets, Morton lanes,
     compaction every 16 waves, ladder 6 / shrink 2) through the leaf-row
     kernel: frame time, rays/s, energy and the kernel's launch counts;
  4b. twolevelp bench: the 32-instance stress scene, pure two-level, at
     512x512 @ 16 spp with the bench knobs through the instanced kernel:
     frame time, rays/s, energy, launches, peak memory and the scene's
     device bytes against the flattened compile of the same scene, whose
     bitsru8 frame is timed beside it (the bytes of the tensors a render
     reads: the flattened scene's stream and binary walk tables are counted
     apart, since a bitsru8 render never reads them);
  4d. walk benches: the bench config through algo="skip", algo="stack" and
     use_wide=False: one 512x512 @ 16 spp frame each at phase 4's seeds
     (total_samples 32), frame time, rays/s, energy, the walk's launch
     counts (> 0), and its image within the parity gates of phase 4's
     bitsru8 frame (under 1% of pixels off by more than 1e-3, energy
     within 1%);
  4c. capacity: the 200-instance stress scene (202 instances, 256,014
     effective triangles), pure two-level, 256x256 @ 1 spp: a finite,
     non-negative image with positive energy, and the instanced kernel
     against its plain version on one bounce's rays (closest and any-hit),
     with the gates of 3b;
  5. parity: 64x64 @ 2 spp with the bench knobs through the leaf-row kernel
     and through its plain version on the card (energy within 1%, relative
     L1 under 3%; bit equality expected);
  5b. twolevelp parity: the stress scene at 64x64 @ 2 spp through the
     instanced kernel and through its plain version (the same gates), and
     the diffuse box scene twolevelp against flattened bitsru8 (under 1%
     of pixels off by more than 1e-3, energy within 0.5%);
  5c. walk parity: the indoor scene at 32x32 @ 2 spp with the bench knobs
     through each new walk's kernel and through its plain version on the
     card (the gates of phase 5; bit equality expected);
  3e. leaf-row variants: every further entry point of the leaf-row kernel
     (Baldwin–Weber, the ILP merge, bf16, carry-in) against its plain
     version on phase 3's six ray sets: bit-identical or the phase fails.
     A carry-in entry point resumes over each list's rows past the first
     CARRY_ROWS from a round-A call of its non-carry twin over those rows
     (the sweeps all in round A), and must then equal the one-call result;
  4e. bits benches: one 512x512 @ 8 spp frame at phase 4's seeds through
     each algo of BITS_ALGOS (frame time, rays/s, energy, launches per
     entry point, peak memory): those of EXACT_ALGOS within 0.1% of
     pixels (ties) of a bitsru8 image of the same spp and seeds; those of
     ROUNDING_ALGOS, whose record test rounds otherwise, with their energy
     relative to it inside ENERGY_BAND and their pixels' distance printed;
     then a
     512x512 @ 1 spp frame through each algo of CARRY_ALGOS (the carry-in
     entry points no frame above launches), held the same way to a 1 spp
     bitsru8 frame at the same seeds.  An entry point's launches in the
     kernels line are those of the first frame that drives it;
  5e. bits parity: 64x64 @ 2 spp through PARITY_ALGOS with the kernel and
     with leaf_rows swapped for its plain version: bit equality or the
     phase fails;
  3f. schedules: the stream walk's TPU schedules (SCHEDULES: skip2, ilvN,
     specN, specbN) against their plain versions on phase 3c's four ray
     sets and on an any-hit set of 512x512 rays from inside the indoor
     room, every one of which hits: t, record, u, v bit-identical and the
     per-packet counts equal, or the phase fails; skip2 / ilvN also equal
     to the skip kernel's output, specN / specbN's records equal to its
     but at coincident-t ties (any-hit: the same rays hit).  Prints ms per
     call, the bound (the tests the rows on the path need), visits per
     packet and the rows tested over the rows on the path;
  4f. schedule benches: one 512x512 @ 16 spp frame through each of
     SCHEDULE_BENCH at phase 4's seeds, held to phase 4's bitsru8 image by
     phase 4d's gates: frame time, rays/s, energy, launches, peak memory;
  5f. schedule parity: 32x32 @ 2 spp through SCHEDULE_PARITY with the
     kernel and with the plain version (skip2 / ilvN: phase 5c's plain
     skip render, the same function): bit equality or the phase fails;
  6. micro: the dependent-cursor microbenchmark (micro/dep_chain.py): each
     variant's kernel against its plain version at 512 rows (bit-identical
     or the phase fails) and both timed there (the kernels line's ms,
     plain ms, launches and bound), then the kernel's ms at two sizes and
     the slope in ns per row;
  7. leaf micro: the leaf-row microbenchmarks.  micro/leaf_groups.py: each
     variant's kernel against its plain version at 32 and 256 groups a
     packet (bit-identical or the phase fails), timed at both, the slope
     in ns per group (the kernels line: 256 groups); micro/leaf_visit.py:
     each variant's kernel against its plain version at 512 visits
     (bit-identical; recip within leaf_visit.RECIP_GATE), timed at 32768
     visits (the kernels line) and the slope to 98304.  Each entry point
     must launch in the timed runs;
  8. walk micro: the walk-visit microbenchmarks, each entry point's kernel
     against its plain version, bit-identical or the phase fails:
     micro/visit_cost.py at 512 rows, timed at 32768 (the kernels line)
     and 98304 rows; micro/quant_visit.py at 512 visits on the script's
     table and on its jump table, timed at 4096 (the kernels line) and
     12288 visits; micro/stack_visit.py at 32 visits, timed at 2048 (the
     kernels line) and 6144, its end cursor and stack pointer at 2048
     equal to the plain version's; micro/mask_reduce.py at 2048 visits on
     the script's data and on its mixed data, timed at 2048 (the kernels
     line) and 6144.  The slope in ns a row or visit; each entry point must
     launch in the timed runs;
  9. shape micro: the visit-shape microbenchmarks, each entry point's
     kernel against its plain version, every output bit-identical (o, the
     end cursor, the visits whose vote was set) or the phase fails, on the
     script's data and on the module's vote data at a small size (64
     visits; visit_bodies 32) and on the script's data at its ITERS (with
     wide_x's and smem_stack's overflow to inf): micro/visit_parts.py timed
     at 4096 (the kernels line) and 12288 visits, micro/cond_visit.py and
     micro/visit_bodies.py at 2048 (the kernels line) and 6144; the slope
     in ns a visit; each entry point must launch in the timed runs.  Then
     the SASS of the kernels (cuobjdump): visit_parts any keeps its vote's
     barrier (base has none), fori0 its zero-trip loop (more loads than
     base), cond_visit both and cond both bodies (FMNMX and MUFU.RCP), and
     cond a branch more than both.
  10. mxu micro: the matrix-unit microbenchmarks (micro/mxu_tiles.py,
     mxu_parts.py, mxu_pltd.py), the port's tensor-core kernels: each entry
     point's kernel against its plain version on the first 4 blocks of the
     script's data, on the module's tmax data (mxu_tiles also its trips
     data) and on the script's whole data, within micro._mxu's MXU_GATE
     (3xTF32) or BF16_GATE (dotbf16), epionly bit-identical, or the phase
     fails; timed at the scripts' sizes (4096 tiles a case; 64 x 16; 256 x
     16) in ms (the least of 3 means of 10 back-to-back calls; single
     calls printed beside) and ps a test, the plain version there, and the
     dot alone as one torch.bmm (float32 without and with TF32; bf16 for
     dotbf16: the kernels line's library_ms is the float32 one, bf16's for
     dotbf16).
     Then the SASS: each kernel's HMMA count at least 3 x 6 x 4 a tile for
     the f32 dots (one tile body for dyn), 6 x 4 a tile for bf16, none for
     epionly.
  11. op micro: the op-cost microbenchmarks (micro/lane_splat.py,
     lane_extract.py, walk_interleave.py, spec_visit.py), each entry
     point's kernel against its plain version at a check size (64 visits,
     32, 32 steps, 512 rows) on the script's data and on the module's
     test-only data (signed rows, vote data, jump data), every output
     bit-identical or the phase fails (lane_splat's six against
     visit_parts' base); then timed at the script's size (4096 visits,
     2048, 2048 steps, 32768 rows; the kernels line) and 3 times it, the
     least of 3 single calls, and the slope in ns a visit, step or row
     tested.  Then the SASS, found by entry point: each splat keeps its
     path (LDG, LDG.CONSTANT, LDS behind a BAR or not, SHFL), lane_extract
     reads n_e lanes a visit and keeps n_e + n_v FMUL/FADD pairs a value
     and no FFMA, the interleaved walks and the W-row visits one barrier
     a step whatever n or W.
Each phase prints its seconds.  Then a JSON line of per-kernel results
and, last, the device summary.  Imports no JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from surf_tpu_torch.accel import (_build, bits, bvh_walk, inst_rows, instanced,
                                  leaf_rows, stream, stream_walk)
from surf_tpu_torch.micro import (_mxu, _visit, cond_visit, dep_chain, lane_extract,
                                  lane_splat, leaf_groups, leaf_visit, mask_reduce, mxu_parts,
                                  mxu_pltd, mxu_tiles, quant_visit, spec_visit, stack_visit,
                                  visit_bodies, visit_cost, visit_parts, walk_interleave)
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams, view_plane
from surf_tpu_torch.scene.compile import compile_scene
from surf_tpu_torch.wavefront import integrator as wi

TPU_ENERGY = 87157.2109375  # surf_tpu on a TPU v5e, BENCH_r05.json
W = H = 512
SPP = 16
STRESS_N = 32
BENCH_KNOBS = wi.BENCH_KNOBS
BLOCK = BENCH_KNOBS["block_rays"]
# The least time the card could take for the same work: H100 SXM
# peaks at 700 W, 67 TFLOP/s FP32 outside the tensor cores and 3.35 TB/s;
# bf16 arithmetic outside the tensor cores (packed bf16x2) runs at twice
# the FP32 rate, 133.8 TFLOP/s (NVIDIA's H100 data sheet).  No ray test of
# a render path is a matrix product, so the tensor cores' rates apply only
# to phase 10's matrix-unit micros (PEAK_TC).
PEAK_FLOPS = {"f32": 67e12, "bf16": 133.8e12}
PEAK_BYTES = 3.35e12
MT_FLOPS = 48      # one ray x triangle Moller-Trumbore test (division as one)
# Of those, the multiplies, adds and the reciprocal of the polynomial (h:
# 9, a: 5, 1 / a, s: 3, u: 6, q: 9, v: 6, t: 6) are bf16 operations in
# the bf16 test (mt.cuh mt_hit_bf16); the rest run in f32.
MT_BF16_FLOPS = 45
# One ray x triangle Baldwin-Weber test, counted from mt.cuh bw_hit: den 5,
# num 6, the reciprocal 1, t 1, the hit point 6, u 6, v 6 multiply/add
# operations, then |den| and 7 compares (u + v's add among them).
BW_FLOPS = 39
SLAB_FLOPS = 25    # one ray x box slab test (6 sub, 6 mul, 10 min/max, 3 compares)
# The walks of phases 3c-5c, as RenderConfig fields.
WALKS = {"skip": dict(algo="skip"), "stack": dict(algo="stack"),
         "binary": dict(use_wide=False)}
XF_FLOPS = 33      # one ray into one instance's object space (origin + dir)
# Phase 3e: the entry points beyond phase 3's pair, and round A's rows
# before a carry-in call (bits2's default refine_rows).
VARIANTS = [k for k in leaf_rows.ENTRY_POINTS if k not in ("leaf_rows_closest", "leaf_rows_any")]
CARRY_ROWS = bits.BITS_REFINE_ROWS
# Phase 4e: the bits algos timed at full depth, those whose image is
# expected bit-equal to bitsru8's up to exact-t ties, and the 1 spp frames
# that drive the remaining carry-in entry points.  Phase 5e: kernel vs plain.
BITS_ALGOS = ("bits", "bitsi", "bitsw", "bitswi", "bits2", "bits8", "bitsh", "bitsa", "bitsp")
EXACT_ALGOS = ("bits", "bitsi", "bits2", "bits8", "bitsa", "bitsp", "bits2i")
# The algos whose record test rounds otherwise than bitsru8's (Baldwin-Weber,
# bf16): a path whose hit moves takes other random numbers from then on, so
# their pixels depart from bitsru8's beyond phase 4d's pixel gate, as the JAX
# package's own renders of the same algos depart from its bitsru8 render
# (PERF.md, section 6).  4e holds their energy, relative to bitsru8's, to a
# band: Baldwin-Weber to phase 4's 1%, bf16 to -40% .. -30% around the
# departure of the JAX package's bitsh on a TPU (-34%) and on the CPU; 3e
# and 5e hold them to their plain versions, and the CPU tests
# (tests/test_torch_bits_render.py) to the JAX package's same algo.
ROUNDING_ALGOS = ("bitsw", "bitswi", "bitsh", "bits2w", "bits2wi", "bits2h")
ENERGY_BAND = {"bw": (-0.01, 0.01), "bf16": (-0.40, -0.30)}
CARRY_ALGOS = ("bits2w", "bits2i", "bits2h", "bits2wi")
PARITY_ALGOS = ("bitsw", "bitsh", "bits2", "bitsp")
# Phase 4e's frames: 8 spp each, held to a bitsru8 frame of 8 spp at the
# same seeds (at 16 spp they took 143 s of the script's 1200 s limit).
BITS_SPP = 8
# Phases 5c and 5f: the side of their 2 spp renders, whose plain versions
# (Python loops over the walk's rows) took 132 s and 116 s at 64x64.
PARITY_W = 32
# Phases 3f, 4f, 5f: the stream walk's TPU schedules checked, benched and
# rendered kernel against plain; the schedule whose 3f bounce-set time and
# 4f launches stand for each entry point in the kernels line.
SCHEDULES = ("skip2", "ilv2", "ilv4", "spec2", "spec4", "specb4", "specb8")
SCHEDULE_BENCH = ("skip2", "ilv4", "spec4", "specb8")
SCHEDULE_PARITY = ("skip2", "ilv2", "spec2", "specb4")
SCHEDULE_OF = {"ilv": "ilv4", "spec": "spec4", "specb": "specb8"}
# Phase 6: one plane-form record test, counted from dep_micro.cu: den 5,
# num 6, the division 1, the hit point 6, u 6, v 6, then |den| and 7
# compares (u + v's add among them).
LEAN_FLOPS = 38
# Phase 7: the record test of each leaf micro variant, counted from
# leaf_micro.cu: Moller-Trumbore without its division (leaf_groups nodiv,
# f = a), and extonly's 8 adds, 1 multiply and 1 compare.
GROUP_FLOPS = {"full": MT_FLOPS, "nodiv": MT_FLOPS - 1, "noext": MT_FLOPS,
               "halftri": MT_FLOPS}
VISIT_FLOPS = {"empty": 0, "full": MT_FLOPS, "recip": MT_FLOPS, "nodiv": MT_FLOPS,
               "extonly": 10, "half": MT_FLOPS}
# Phase 8, counted from visit_micro.cu: quant_visit's u8 slab does a
# ray's per-axis a = (lo - o) * inv and b = scale * inv once a visit (9),
# then per child the planes' t = a + q * b (12) and the slab's 10 min/max
# and 3 compares (the byte unpacks and converts are integer work);
# stack_visit's toy slab per child 6 subtracts or multiplies, 10 min/max,
# 1 compare and 1 add, then 1 compare a value; mask_reduce per child 1
# multiply and 1 compare, then a += (0.001 x) * mask (2).
Q8_VISIT_FLOPS = 9
STACK_CHILD_FLOPS = 18
MASK_VISIT_FLOPS = 8 * 2 + 2
# Phase 9, counted from shape_micro.cu, per value: a link of the chain 1
# multiply, 1 add and 1 compare (the select is a move); a toy box
# STACK_CHILD_FLOPS; a toy record (mt8) h 9, a 5, the division 1, u 3,
# v 6, t 2, |a| and 5 compares 6, the add 1; a vote 1 compare.
LINK_FLOPS = 3
TOY_MT_FLOPS = 33
# Phase 10: the tensor cores' dense peaks (NVIDIA's H100 SXM data sheet):
# the f32 dots run as 3xTF32, three TF32 products for each; bf16 at its
# rate.  A tile's dot is 2 x 256 x 8 x 768 FLOP.  The epilogue, counted
# from mxu_micro.cu, per test: the division 1, u and v 2 multiplies and 2
# adds, |den| 1, 7 compares and u + v's add, the select of t, the compare
# with bt and 2 selects; the DEAD parts' min 1.  The bound is the largest
# of the dot's, the epilogue's and the bytes' times (the tensor cores and
# the FP32 units run side by side).
PEAK_TC = {"tf32": 495e12, "bf16": 989e12}
TILE_DOT_FLOPS = 2 * _mxu.R * _mxu.K * _mxu.COLS
EPI_FLOPS = 18
# Each entry point's least HMMA count in the SASS of the kernel it
# launches (a tile's f32 dot is 4 n8 tiles x 6 blocks x 3 TF32 products;
# bf16 one product each; dyn's loop body holds at least one tile).
MXU_SASS = {
    "mxu_tiles8_static": 72 * 8,
    "mxu_tiles8_dyn": 72,
    "mxu_tiles16_static": 72 * 16,
    "mxu_tiles16_dyn": 72,
    "mxu_parts_full": 72 * 16,
    "mxu_parts_dotonly": 72 * 16,
    "mxu_parts_epionly": 0,
    "mxu_parts_dotbf16": 24 * 16,
    "mxu_parts_bigdot": 72 * 16,
    "mxu_pltd": 72 * 16,
}
BODY_VISIT_FLOPS = {"bin_sroll": 9 * LINK_FLOPS + 1, "wide_x": 8 * STACK_CHILD_FLOPS + 1,
                    "wide_bc": STACK_CHILD_FLOPS, "smem_stack": 8 * STACK_CHILD_FLOPS + 1}
# Phase 11, counted from op_micro.cu, per value: lane_splat's and the
# interleaved walks' chain links LINK_FLOPS, a vote 1 compare;
# lane_extract a lane or a link 1 multiply and 1 add, and its vote;
# roll_tput 1 multiply and 1 add a lane (128 lanes a visit); spec_visit a
# row's 8 boxes and 8 records per ray.
SPEC_ROW_FLOPS = 8 * SLAB_FLOPS + 8 * MT_FLOPS


def say(msg: str) -> None:
    print(msg, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


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


def _ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel of nvcc's -Xptxas -v output: its
    (mangled) name, registers and spill bytes."""
    out, name, spill = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = m.group(1), "?"
        elif name and "spill stores" in ln:
            spill = re.search(r"(\d+) bytes spill stores", ln).group(1)
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers, {spill} bytes spilled")
            name = None
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    log = so.with_suffix(".log")
    say(f"[2 build] {so.name} in {dt:.1f} s (0 s means it was already built)")
    for ln in _ptxas_summary(log.read_text()) if log.exists() else []:
        say(f"[2 build]   {ln}")


def _time_ms(fn, reps: int, dev: torch.device) -> float:
    """Mean ms per call: CUDA events on the card, the host clock elsewhere
    (CPU rehearsals only)."""
    fn()
    _sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _time_once(fn, dev: torch.device):
    """(result, ms) of one call: CUDA events on the card, the host clock
    elsewhere.  For the plain walks, which take seconds a call."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def _compare(got, want):
    """(bit-identical?, max |dt| over lanes where both hit, gate holds?):
    slot (and instance) equal except at coincident-t ties, t within rtol
    1e-6 where both hit."""
    t_k, r_k = got[0], got[1]
    t_p, r_p = want[0], want[1]
    bit = all(torch.equal(x, y) for x, y in zip(got, want))
    both = (r_k >= 0) & (r_p >= 0)
    err = float((t_k - t_p)[both].abs().max()) if bool(both.any()) else 0.0
    same = r_k == r_p
    if len(got) > 4:
        same &= got[4] == want[4]
    gate = bool((same | (t_k == t_p)).all()) and bool(
        torch.allclose(t_k[both], t_p[both], rtol=1e-6, atol=0.0))
    return bit, err, gate


def _bound(flops: float, nbytes: float, bf16_flops: float = 0.0) -> tuple[float, str]:
    """(bound ms, what bounds it): the larger of the operations over the
    peak for their type (``flops`` f32, ``bf16_flops`` bf16) and the bytes
    over the memory rate."""
    t_ops = flops / PEAK_FLOPS["f32"] + bf16_flops / PEAK_FLOPS["bf16"]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _active_per_packet(act, g: int, blk: int) -> torch.Tensor:
    """[g] int64: the active rays of each packet (pad rays are inactive)."""
    a = torch.zeros(g * blk, dtype=torch.int64, device=act.device)
    a[:act.shape[0]] = act
    return a.view(g, blk).sum(1)


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def _first_wave(scene, cfg, cam, dev, w, h):
    """Primary rays of a Morton-ordered frame with one all-dead packet, and
    the state after one bounce: (origin, direction, alive) for each."""
    vp = view_plane(cam, w, h)
    perm = wi.lane_pixel_perm(cfg, dev)
    seed = wi.initial_seeds(cfg, 0, dev)[perm]
    seed, origin, direction = wi.ray_generation(cfg, vp, seed, perm % w, perm // w)
    n = w * h
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[5 * BLOCK:6 * BLOCK] = False  # one all-dead packet
    state = wi.PathState(origin, direction, seed, torch.ones(n, 3, device=dev),
                         torch.zeros(n, 3, device=dev), alive.clone(),
                         torch.zeros(n, dtype=torch.bool, device=dev), alive, perm)
    bounced = wi.bounce_step(scene, cfg, state)
    return (origin, direction, alive), (bounced.origin, bounced.direction, bounced.alive)


def _ray_sets(primary, bounce, n, dev, t_any_primary, cap):
    far = torch.full((n,), 1e30, device=dev)
    return {
        "primary/closest": (*primary, far, False, 0),
        "bounce/closest": (*bounce, far, False, 0),
        "primary/any_hit": (*primary, torch.full((n,), t_any_primary, device=dev), True, 0),
        "bounce/any_hit": (*bounce, torch.full((n,), 4.0, device=dev), True, 0),
        "primary/sweep": (*primary, far, False, cap),
        "bounce/sweep": (*bounce, far, False, cap),
    }


def phase_kernel(dev: torch.device, w: int = W, h: int = H) -> dict:
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    primary, bounce = _first_wave(scene, cfg, cam, dev, w, h)
    out = {"leaf_rows_closest": {"max_abs_err": 0.0}, "leaf_rows_any": {"max_abs_err": 0.0}}
    for label, (o, d, act, tm, any_hit, cap) in _ray_sets(primary, bounce, w * h, dev,
                                                          8.0, 8).items():
        rays, lists, n_rows = bits.prepare(scene.trace, o, d, tm, act, BLOCK, cap)
        args = (scene.trace.ltab, lists, n_rows, rays, BLOCK, any_hit)
        got = leaf_rows.leaf_rows(*args)
        want = leaf_rows.leaf_rows_plain(*args)
        _sync(dev)
        bit, err, gate = _compare(got, want)
        if not (bit or gate):
            raise AssertionError(f"{label}: kernel disagrees with the plain version "
                                 f"(max |dt| {err})")
        k_ms = _time_ms(lambda: leaf_rows.leaf_rows(*args), 20, dev)
        p_ms = _time_ms(lambda: leaf_rows.leaf_rows_plain(*args), 3, dev)
        E = scene.trace.ltab.shape[0]
        rows = torch.where(n_rows < 0, E, n_rows)
        tests = float((rows * _active_per_packet(act, lists.shape[0], BLOCK)).sum()) * 8
        bound_ms, bound_by = _bound(tests * MT_FLOPS, _nbytes(*args[:4]) + 16 * rays.shape[1])
        sweeps = int((n_rows < 0).sum())
        say(f"[3 kernel] {label}: {'bit-identical' if bit else 'within gate'}, "
            f"max |dt| {err:.3g}, kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by}, {tests:.4g} tests), "
            f"packets {lists.shape[0]} (sweep {sweeps}), cap {lists.shape[1]}, "
            f"mean list {float(n_rows.clamp(min=0).float().mean()):.1f} rows")
        rec = out["leaf_rows_any" if any_hit else "leaf_rows_closest"]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if label in ("bounce/closest", "bounce/any_hit"):
            rec.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
    return out


def phase_inst_kernel(dev: torch.device, w: int = W, h: int = H,
                      n_inst: int = STRESS_N) -> dict:
    scene_h = builtin.make_instanced_stress_scene(n_inst)
    scenes = {0: compile_scene(scene_h, dev, two_level="pure"),
              8: compile_scene(scene_h, dev, two_level="pure", inst_cap=8)}
    ps = scenes[0]
    cfg = wi.RenderConfig.for_scene(ps, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_stress_camera(w, h, n_inst), dev)
    primary, bounce = _first_wave(ps, cfg, cam, dev, w, h)
    out = {"inst_rows_closest": {"max_abs_err": 0.0}, "inst_rows_any": {"max_abs_err": 0.0}}
    for label, (o, d, act, tm, any_hit, cap) in _ray_sets(primary, bounce, w * h, dev,
                                                          16.0, 8).items():
        tr = scenes[cap].inst
        rays, lists, counts = instanced.prepare(tr, o, d, tm, act, BLOCK)
        args = (tr.ltab, lists, counts, tr.segs, tr.inv, rays, BLOCK, any_hit)
        got = inst_rows.inst_rows(*args)
        want = inst_rows.inst_rows_plain(*args)
        _sync(dev)
        bit, err, gate = _compare(got, want)
        if not (bit or gate):
            raise AssertionError(f"{label}: instanced kernel disagrees with the plain "
                                 f"version (max |dt| {err})")
        k_ms = _time_ms(lambda: inst_rows.inst_rows(*args), 10, dev)
        p_ms = _time_ms(lambda: inst_rows.inst_rows_plain(*args), 2, dev)
        rows = torch.where(counts < 0, tr.segs[2][None, :], counts)
        pairs = int((counts != 0).sum())
        live = _active_per_packet(act, lists.shape[0], BLOCK)[:, None]
        tests = float((rows * live).sum()) * 8
        xf = float(((counts != 0) * live).sum())  # active rays x listed instances
        bound_ms, bound_by = _bound(tests * MT_FLOPS + xf * XF_FLOPS,
                                    _nbytes(*args[:6]) + 20 * rays.shape[1])
        say(f"[3b inst] {label}: {'bit-identical' if bit else 'within gate'}, "
            f"max |dt| {err:.3g}, kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by}, {tests:.4g} tests), "
            f"packets {lists.shape[0]}, pairs {pairs} (sweep {int((counts < 0).sum())}), "
            f"mean list {float(rows.sum()) / max(pairs, 1):.1f} rows")
        rec = out["inst_rows_any" if any_hit else "inst_rows_closest"]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if label in ("bounce/closest", "bounce/any_hit"):
            rec.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
    return out


def _walk_sets(primary, bounce, n, dev):
    """The closest-hit and any-hit ray sets of ``_ray_sets`` (no sweeps)."""
    return {k: v[:5] for k, v in _ray_sets(primary, bounce, n, dev, 8.0, 0).items()
            if not k.endswith("sweep")}


def _walk_record(out, name, label, got, want, k_ms, p_ms, work, nbytes, what):
    """Checks a walk kernel's result against its plain version's (per-packet
    counts equal, and every output bit-identical or the hits within phase
    3's gate), prints one line and keeps the bounce sets' numbers for the
    kernels line.  ``work`` is the plain version's [slab, triangle] tests
    of live rays."""
    if not torch.equal(got[4], want[4]):
        raise AssertionError(f"{name} {label}: per-packet counts differ from the plain "
                             f"version's")
    bit = all(torch.equal(x, y) for x, y in zip(got, want))
    _, err, gate = _compare(got[:4], want[:4])
    if not (bit or gate):
        raise AssertionError(f"{name} {label}: kernel disagrees with the plain version "
                             f"(max |dt| {err})")
    bound_ms, bound_by = _bound(work[0] * SLAB_FLOPS + work[1] * MT_FLOPS, nbytes)
    say(f"{what} {name} {label}: {'bit-identical' if bit else 'within gate'}, counts "
        f"equal, max |dt| {err:.3g}, kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; live tests: {work[0]} slab, {work[1]} triangle)")
    rec = out.setdefault(name, {"max_abs_err": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    if label.startswith("bounce"):
        rec.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_stream_kernel(dev: torch.device, w: int = W, h: int = H) -> dict:
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    primary, bounce = _first_wave(scene, cfg, cam, dev, w, h)
    tr = scene.stream
    say(f"[3c stream] indoor stream {tuple(tr.stream.shape)} rows (depth {tr.max_depth}), "
        f"{w * h} rays in {w * h // BLOCK} packets of {BLOCK}")
    out = {}
    for algo in ("skip", "stack"):
        for label, (o, d, act, tm, any_hit) in _walk_sets(primary, bounce, w * h, dev).items():
            rays, a = stream.pack_rays(o, bits.nudge(d), tm, act, BLOCK)
            args = (tr.stream, rays, a, BLOCK, algo, any_hit, tr.max_depth)
            got = stream_walk.stream_walk(*args)
            work = torch.zeros(a.shape[0] // BLOCK, 2, dtype=torch.int64, device=dev)
            want, p_ms = _time_once(
                lambda: stream_walk.stream_walk_plain(*args, work=work), dev)
            k_ms = _time_ms(lambda: stream_walk.stream_walk(*args), 10, dev)
            visits = want[4].sum(0, dtype=torch.int64).tolist()  # rows, leaf rows
            nbytes = _nbytes(tr.stream, rays, a, *got)
            name = f"stream_walk_{algo}_{'any' if any_hit else 'closest'}"
            _walk_record(out, name, label, got, want, k_ms, p_ms, work.sum(0).tolist(),
                         nbytes, "[3c stream]")
            g = want[4].shape[0]
            say(f"[3c stream]   visits per packet: mean {visits[0] / g:.1f} rows "
                f"({visits[1] / g:.1f} leaf), max {int(want[4][:, 0].max())}")
    return out


def phase_bvh_kernel(dev: torch.device, w: int = W, h: int = H) -> dict:
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    primary, bounce = _first_wave(scene, cfg, cam, dev, w, h)
    tr = scene.binary
    blk = bvh_walk.BLOCK
    say(f"[3d binary] indoor node list {tr.n_nodes} nodes (with capacity padding), "
        f"{tr.tris.shape[0] * 8} triangle records, {w * h // blk} packets of {blk}")
    out = {}
    for label, (o, d, act, tm, any_hit) in _walk_sets(primary, bounce, w * h, dev).items():
        rays, a = stream.pack_rays(o, d, tm, act, blk)
        args = (tr.nodes, tr.tris, tr.n_nodes, rays, a, any_hit)
        got = bvh_walk.bvh_walk(*args)
        work = torch.zeros(a.shape[0] // blk, 2, dtype=torch.int64, device=dev)
        want, p_ms = _time_once(lambda: bvh_walk.bvh_walk_plain(*args, work=work), dev)
        k_ms = _time_ms(lambda: bvh_walk.bvh_walk(*args), 10, dev)
        counts = want[4].sum(0, dtype=torch.int64).tolist()  # nodes, triangles
        nbytes = _nbytes(tr.nodes, tr.tris, rays, a, *got)
        name = f"bvh_walk_{'any' if any_hit else 'closest'}"
        _walk_record(out, name, label, got, want, k_ms, p_ms, work.sum(0).tolist(), nbytes,
                     "[3d binary]")
        g = want[4].shape[0]
        say(f"[3d binary]   per packet: mean {counts[0] / g:.1f} nodes, "
            f"{counts[1] / g:.1f} triangles")
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


def _check_image(img, what: str, spp: int) -> float:
    img = img.cpu().numpy()
    if not (np.isfinite(img).all() and (img >= 0).all()):
        raise AssertionError(f"{what} image has non-finite or negative values")
    energy = float(img.sum()) / spp
    if not energy > 0:
        raise AssertionError(f"{what} energy {energy} is not positive")
    return energy


def _timed_frames(scene, cfg, cam, dev, spp, frames):
    """Frame times (s) and the last image, frame k at total_samples k*spp."""
    times, img = [], None
    for frame in range(1, frames + 1):
        t0 = time.perf_counter()
        img = _render(scene, cfg, cam, dev, frame * spp, spp)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return times, img


def _scene_bytes(scene) -> int:
    """Device bytes of every tensor of a compiled scene (nested traces too;
    a trace set to None counts nothing)."""
    total = 0
    for x in scene:
        if isinstance(x, torch.Tensor):
            total += _nbytes(x)
        elif isinstance(x, tuple):
            total += _scene_bytes(x)
    return total


def phase_bench(dev: torch.device, w: int = W, h: int = H, spp: int = SPP) -> dict:
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    _render(scene, cfg, cam, dev, 0, 1)  # warm-up: allocator, first launches
    _sync(dev)
    leaf_rows.reset_launches()
    times, img = _timed_frames(scene, cfg, cam, dev, spp, 2)
    launches = {k: leaf_rows.LAUNCHES[k] for k in ("leaf_rows_closest", "leaf_rows_any")}
    energy = _check_image(img, "bench", spp)
    for name, k in launches.items():
        if k <= 0 and dev.type == "cuda":
            raise AssertionError(f"{name} was never launched by the render")
    dt = sum(times) / len(times)
    say(f"[4 bench] {w}x{h} @ {spp} spp, frame times {['%.3f' % t for t in times]} s, "
        f"mean {dt:.3f} s, {w * h * spp / dt:.1f} rays/s")
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    say(f"[4 bench] energy {energy!r} (TPU run of surf_tpu: {TPU_ENERGY!r}, "
        f"rel diff {(energy - TPU_ENERGY) / TPU_ENERGY:+.4%}); launches {launches}; "
        f"peak memory {peak:.2f} GiB")
    return launches, img


def _pixel_stats(ref, img):
    """(pixels off by more than 1e-3, relative energy difference, message)."""
    a, b = ref.cpu().numpy(), img.cpu().numpy()
    off = float((np.abs(a - b).max(axis=2) > 1e-3).mean())
    rel_e = abs(float(b.sum()) - float(a.sum())) / abs(float(a.sum()))
    msg = (f"energy rel {rel_e:.3g}, pixels off by >1e-3 {off:.4%}, "
           f"bit-identical {bool(np.array_equal(a, b))}")
    return off, rel_e, msg


def _pixel_gate(ref, img, what: str) -> str:
    """tests/test_render_parity.py's gate: under 1% of pixels off by more
    than 1e-3, energy within 1%."""
    off, rel_e, msg = _pixel_stats(ref, img)
    if not (off < 0.01 and rel_e < 0.01):
        raise AssertionError(f"{what}: {msg}")
    return msg


def phase_walk_bench(dev: torch.device, ref_img, w: int = W, h: int = H,
                     spp: int = SPP) -> dict:
    """The bench config through each new walk: one frame at phase 4's
    second frame's seeds (total_samples 2 * spp), held to its image."""
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    launches = {}
    for walk, knobs in WALKS.items():
        cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(
            **BENCH_KNOBS, **knobs)
        _render(scene, cfg, cam, dev, 0, 1)  # warm-up
        _sync(dev)
        counts = bvh_walk.LAUNCHES if walk == "binary" else stream_walk.LAUNCHES
        mine = {k: 0 for k in counts if walk == "binary" or f"_{walk}_" in k}
        stream_walk.reset_launches()
        bvh_walk.reset_launches()
        t0 = time.perf_counter()
        img = _render(scene, cfg, cam, dev, 2 * spp, spp)
        _sync(dev)
        dt = time.perf_counter() - t0
        mine = {k: counts[k] for k in mine}
        launches.update(mine)
        energy = _check_image(img, f"{walk} bench", spp)
        for name, k in mine.items():
            if k <= 0 and dev.type == "cuda":
                raise AssertionError(f"{name} was never launched by the {walk} render")
        say(f"[4d walks] {walk}: {w}x{h} @ {spp} spp, frame {dt:.3f} s, "
            f"{w * h * spp / dt:.1f} rays/s, energy {energy!r}, launches {mine}; "
            f"vs bitsru8: {_pixel_gate(ref_img, img, f'{walk} bench frame')}")
    return launches


def phase_twolevelp_bench(dev: torch.device, w: int = W, h: int = H, spp: int = SPP,
                          n_inst: int = STRESS_N) -> dict:
    scene_h = builtin.make_instanced_stress_scene(n_inst)
    ps = compile_scene(scene_h, dev, two_level="pure")
    cfg = wi.RenderConfig.for_scene(ps, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_stress_camera(w, h, n_inst), dev)
    _render(ps, cfg, cam, dev, 0, 1)  # warm-up
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    inst_rows.reset_launches()
    times, img = _timed_frames(ps, cfg, cam, dev, spp, 2)
    launches = dict(inst_rows.LAUNCHES)
    energy = _check_image(img, "twolevelp bench", spp)
    for name, k in launches.items():
        if k <= 0 and dev.type == "cuda":
            raise AssertionError(f"{name} was never launched by the twolevelp render")
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    dt = sum(times) / len(times)
    say(f"[4b twolevelp] stress {n_inst} ({len(scene_h.instances)} instances), {w}x{h} "
        f"@ {spp} spp, frame times {['%.3f' % t for t in times]} s, mean {dt:.3f} s, "
        f"{w * h * spp / dt:.1f} rays/s, energy {energy!r}, launches {launches}, "
        f"peak memory {peak:.2f} GiB")

    fs = compile_scene(scene_h, dev)
    fcfg = wi.RenderConfig.for_scene(fs, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    _render(fs, fcfg, cam, dev, 0, 1)  # warm-up
    _sync(dev)
    f_times, f_img = _timed_frames(fs, fcfg, cam, dev, spp, 2)
    f_energy = _check_image(f_img, "flattened stress bench", spp)
    f_dt = sum(f_times) / len(f_times)
    say(f"[4b twolevelp] flattened bitsru8 of the same scene: frame times "
        f"{['%.3f' % t for t in f_times]} s, mean {f_dt:.3f} s, "
        f"{w * h * spp / f_dt:.1f} rays/s, energy {f_energy!r} "
        f"(twolevelp rel diff {(energy - f_energy) / f_energy:+.4%})")
    bitsru8_reads = fs._replace(trace=fs.trace._replace(ltabw=None), stream=None, binary=None)
    say(f"[4b twolevelp] device bytes: pure {_scene_bytes(ps)} "
        f"(tables {_nbytes(ps.inst.ltab, ps.inst.box_lo, ps.inst.box_hi)}), "
        f"flattened, what bitsru8 reads {_scene_bytes(bitsru8_reads)} "
        f"(tables {_nbytes(fs.trace.ltab, fs.trace.box_lo, fs.trace.box_hi)}); the flattened "
        f"scene's stream {_scene_bytes(fs.stream)} and binary walk tables "
        f"{_scene_bytes(fs.binary)}, read by the walks only, and its Baldwin-Weber "
        f"table {_nbytes(fs.trace.ltabw)}, read by the w algos only")
    return launches


def phase_capacity(dev: torch.device, w: int = 256, h: int = 256, n_inst: int = 200) -> dict:
    scene_h = builtin.make_instanced_stress_scene(n_inst)
    t0 = time.perf_counter()
    ps = compile_scene(scene_h, dev, two_level="pure")
    t_compile = time.perf_counter() - t0
    cfg = wi.RenderConfig.for_scene(ps, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_stress_camera(w, h, n_inst), dev)
    t0 = time.perf_counter()
    img = _render(ps, cfg, cam, dev, 0, 1)
    _sync(dev)
    dt = time.perf_counter() - t0
    energy = _check_image(img, "capacity", 1)
    eff = sum(i.mesh.tri_count for i in scene_h.instances)
    say(f"[4c capacity] stress {n_inst} ({len(scene_h.instances)} instances, {eff} "
        f"effective triangles, {ps.obj_v0.shape[0]} stored), {w}x{h} @ 1 spp: "
        f"compile {t_compile:.2f} s, frame {dt:.3f} s (first call), energy {energy!r}, "
        f"device bytes {_scene_bytes(ps)}")
    # the kernel against its plain version on one bounce's rays at this count
    _, (o, d, act) = _first_wave(ps, cfg, cam, dev, w, h)
    errs = {}
    for name, any_hit, t in (("inst_rows_closest", False, 1e30), ("inst_rows_any", True, 4.0)):
        rays, lists, counts = instanced.prepare(ps.inst, o, d, torch.full((w * h,), t, device=dev),
                                                act, BLOCK)
        args = (ps.inst.ltab, lists, counts, ps.inst.segs, ps.inst.inv, rays, BLOCK, any_hit)
        got = inst_rows.inst_rows(*args)
        want = inst_rows.inst_rows_plain(*args)
        _sync(dev)
        bit, errs[name], gate = _compare(got, want)
        if not (bit or gate):
            raise AssertionError(f"capacity {name}: instanced kernel disagrees with the "
                                 f"plain version (max |dt| {errs[name]})")
        say(f"[4c capacity] bounce/{'any_hit' if any_hit else 'closest'} kernel vs plain: "
            f"{'bit-identical' if bit else 'within gate'}, max |dt| {errs[name]:.3g}, "
            f"packets {lists.shape[0]}, list width {lists.shape[1]}, "
            f"pairs {int((counts != 0).sum())} (sweep {int((counts < 0).sum())})")
    return errs


def _parity(img_a, img_b, what: str, rel_e_max: float, rel_l1_max: float) -> str:
    a, b = img_a.cpu().numpy(), img_b.cpu().numpy()
    e_a, e_b = float(a.sum()), float(b.sum())
    rel_e = abs(e_a - e_b) / e_b
    rel_l1 = float(np.abs(a - b).mean() / b.mean())
    msg = (f"energy {e_a!r} vs {e_b!r} (rel {rel_e:.3g}), relL1 {rel_l1:.3g}, "
           f"bit-identical {bool(np.array_equal(a, b))}")
    if not (rel_e < rel_e_max and rel_l1 < rel_l1_max):
        raise AssertionError(f"{what}: {msg}")
    return msg


def phase_parity(dev: torch.device, w: int = 64, h: int = 64) -> None:
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cfg = wi.RenderConfig.for_scene(scene, w, h, 2, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    img_k = _render(scene, cfg, cam, dev, 0, 1)
    # the same render with the traversal's intersect swapped for the plain version
    with mock.patch.object(bits, "leaf_rows", leaf_rows.leaf_rows_plain):
        img_p = _render(scene, cfg, cam, dev, 0, 1)
    say(f"[5 parity] {w}x{h} @ 2 spp, kernel vs plain: "
        f"{_parity(img_k, img_p, 'leaf-row kernel render', 0.01, 0.03)}")


def phase_twolevelp_parity(dev: torch.device, w: int = 64, h: int = 64) -> None:
    ps = compile_scene(builtin.make_instanced_stress_scene(STRESS_N), dev, two_level="pure")
    cfg = wi.RenderConfig.for_scene(ps, w, h, 2, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_stress_camera(w, h, STRESS_N), dev)
    img_k = _render(ps, cfg, cam, dev, 0, 1)
    with mock.patch.object(instanced, "inst_rows", inst_rows.inst_rows_plain):
        img_p = _render(ps, cfg, cam, dev, 0, 1)
    say(f"[5b parity] stress {STRESS_N} {w}x{h} @ 2 spp, kernel vs plain: "
        f"{_parity(img_k, img_p, 'instanced kernel render', 0.01, 0.03)}")

    box = builtin.make_diffuse_box_scene()
    cam = CameraParams.from_camera(builtin.make_box_camera(2 * w, 2 * h), dev)
    imgs = {}
    for two_level in ("pure", False):
        ts = compile_scene(box, dev, two_level=two_level)
        bcfg = wi.RenderConfig.for_scene(ts, 2 * w, 2 * h, 1, use_defocus=True)._replace(
            **BENCH_KNOBS)
        imgs[bcfg.algo] = _render(ts, bcfg, cam, dev, 0, 1).cpu().numpy()
    f, p = imgs["bitsru8"], imgs["twolevelp"]
    off = float((np.abs(f - p).max(axis=2) > 1e-3).mean())
    rel_e = abs(float(f.sum()) - float(p.sum())) / abs(float(f.sum()))
    say(f"[5b parity] box {2 * w}x{2 * h} @ 1 spp, twolevelp vs bitsru8: energy "
        f"{float(p.sum())!r} vs {float(f.sum())!r} (rel {rel_e:.3g}), pixels off by "
        f">1e-3 {off:.4%}, bit-identical {bool(np.array_equal(f, p))}")
    if not (off < 0.01 and rel_e < 0.005):
        raise AssertionError("twolevelp render disagrees with the flattened render")


def phase_walk_parity(dev: torch.device, w: int = PARITY_W, h: int = PARITY_W) -> dict:
    """Returns each walk's plain-version image."""
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    plain_imgs = {}
    for walk, knobs in WALKS.items():
        cfg = wi.RenderConfig.for_scene(scene, w, h, 2, use_defocus=True)._replace(
            **BENCH_KNOBS, **knobs)
        img_k = _render(scene, cfg, cam, dev, 0, 1)
        mod, name, plain = ((bvh_walk, "bvh_walk", bvh_walk.bvh_walk_plain) if walk == "binary"
                            else (stream, "stream_walk", stream_walk.stream_walk_plain))
        t0 = time.perf_counter()
        with mock.patch.object(mod, name, plain):
            img_p = _render(scene, cfg, cam, dev, 0, 1)
        _sync(dev)
        say(f"[5c parity] {walk} {w}x{h} @ 2 spp, kernel vs plain: "
            f"{_parity(img_k, img_p, f'{walk} kernel render', 0.01, 0.03)} "
            f"(plain render {time.perf_counter() - t0:.1f} s)")
        plain_imgs[walk] = img_p
    return plain_imgs


def _bits_kw(name: str) -> dict:
    """leaf_rows keyword arguments of an entry point (carry aside)."""
    record, merge, precision, _, _ = leaf_rows.ENTRY_POINTS[name]
    return dict(record=record, merge=merge, precision=precision)


def phase_variants(dev: torch.device, w: int = W, h: int = H) -> dict:
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    primary, bounce = _first_wave(scene, cfg, cam, dev, w, h)
    tr = scene.trace
    out = {name: {"max_abs_err": 0.0} for name in VARIANTS}
    for label, (o, d, act, tm, any_hit, cap) in _ray_sets(primary, bounce, w * h, dev,
                                                          8.0, 8).items():
        rays, lists, n_rows = bits.prepare(tr, o, d, tm, act, BLOCK, cap)
        live = _active_per_packet(act, lists.shape[0], BLOCK)
        for name in VARIANTS:
            kw = _bits_kw(name)
            table = tr.ltabw if kw["record"] == "bw" else tr.ltab
            l, nr, carry, k = lists, n_rows, None, 0
            if leaf_rows.ENTRY_POINTS[name][3]:
                k = min(CARRY_ROWS, lists.shape[1] // 2)
                n_a = torch.where(n_rows < 0, -1, n_rows.clamp(max=k)).to(torch.int32)
                carry = leaf_rows.leaf_rows(table, lists, n_a, rays, BLOCK, **kw)
                l = lists[:, k:].contiguous()
                nr = torch.where(n_rows < 0, 0, (n_rows - k).clamp(min=0)).to(torch.int32)
            args = (table, l, nr, rays, BLOCK)
            got = leaf_rows.leaf_rows(*args, carry=carry, **kw)
            want, p_ms = _time_once(lambda: leaf_rows.leaf_rows_plain(*args, carry=carry, **kw),
                                    dev)
            bit, err, _ = _compare(got, want)
            if not bit:
                raise AssertionError(f"{name} {label}: kernel differs from its plain version "
                                     f"(max |dt| {err})")
            if carry is not None:
                whole = leaf_rows.leaf_rows(table, lists, n_rows, rays, BLOCK, **kw)
                if not all(torch.equal(x, y) for x, y in zip(got, whole)):
                    raise AssertionError(f"{name} {label}: round A + carry-in differs from "
                                         f"one call over the whole lists")
            k_ms = _time_ms(lambda: leaf_rows.leaf_rows(*args, carry=carry, **kw), 10, dev)
            rows = torch.where(nr < 0, table.shape[0], nr)
            tests = float((rows * live).sum()) * 8
            f32_ops, bf16_ops = {("bw", "f32"): (BW_FLOPS, 0),
                                 ("mt", "f32"): (MT_FLOPS, 0),
                                 ("mt", "bf16"): (MT_FLOPS - MT_BF16_FLOPS, MT_BF16_FLOPS)}[
                                     kw["record"], kw["precision"]]
            nbytes = _nbytes(*args[:4]) + 16 * rays.shape[1] * (2 if carry else 1)
            bound_ms, bound_by = _bound(tests * f32_ops, nbytes, tests * bf16_ops)
            resumed = f", resumed after round A's first {k} rows" if carry is not None else ""
            say(f"[3e variants] {name} {label}: bit-identical, kernel {k_ms:.3f} ms, "
                f"plain {p_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, {tests:.4g} "
                f"tests{resumed})")
            if label == "bounce/closest":
                out[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
    return out


def _entry_points_of(algo: str) -> list[str]:
    """The leaf-row entry points a frame of ``algo`` must launch (bitsp's
    fallback launches only when some ray overflows its list)."""
    f = bits.parse_algo(algo)
    if f.pairs:
        return []
    names = {leaf_rows.entry_point(**f.kernel())}
    if f.refine:
        names.add(leaf_rows.entry_point(**f.kernel(), carry=True))
    if f.trims():
        names.add("leaf_rows_any")
    return sorted(names)


def _tie_gate(ref, img, what: str) -> str:
    """Images expected equal but for exact-t ties taken in another order:
    under 0.1% of pixels differ, and phase 4d's gates."""
    a, b = ref.cpu().numpy(), img.cpu().numpy()
    diff = float((a != b).any(axis=2).mean())
    if not diff < 0.001:
        raise AssertionError(f"{what}: {diff:.4%} of pixels differ (over 0.1%)")
    return f"pixels differing {diff:.4%}; {_pixel_gate(ref, img, what)}"


def _rounding_gate(ref, img, algo: str, what: str) -> str:
    """The energy of a rounding algo's image relative to bitsru8's, within
    its record test's ENERGY_BAND; the pixels' distance is printed."""
    lo, hi = ENERGY_BAND["bf16" if bits.parse_algo(algo).bf16 else "bw"]
    e_ref = float(ref.sum())
    rel = (float(img.sum()) - e_ref) / e_ref
    msg = f"energy {rel:+.4%} (band {lo:+.0%} .. {hi:+.0%}); {_pixel_stats(ref, img)[2]}"
    if not lo <= rel <= hi:
        raise AssertionError(f"{what}: {msg}")
    return msg


def _bits_gate(ref, img, algo: str, what: str) -> str:
    if algo in EXACT_ALGOS:
        return _tie_gate(ref, img, what)
    if algo in ROUNDING_ALGOS:
        return _rounding_gate(ref, img, algo, what)
    return _pixel_gate(ref, img, what)


def _bits_frame(scene, cam, dev, algo, w, h, spp, total):
    """One frame of ``algo`` with the launch counts reset just before it and
    read just after: (image, seconds, launches, peak GiB)."""
    cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(
        **BENCH_KNOBS, algo=algo)
    _render(scene, cfg, cam, dev, 0, 1)  # warm-up
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    leaf_rows.reset_launches()
    t0 = time.perf_counter()
    img = _render(scene, cfg, cam, dev, total, spp)
    _sync(dev)
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in leaf_rows.LAUNCHES.items() if v}
    for name in _entry_points_of(algo):
        if launches.get(name, 0) <= 0 and dev.type == "cuda":
            raise AssertionError(f"{name} was never launched by the {algo} render")
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
    return img, dt, launches, peak


def phase_bits_bench(dev: torch.device, w: int = W, h: int = H, spp: int = BITS_SPP,
                     total: int = 2 * SPP) -> dict:
    """The bench config through each bits algo: one frame of ``spp`` at
    phase 4's second frame's seeds (total_samples 2 * SPP), held to a
    bitsru8 frame of the same spp and seeds; then 1 spp frames of the
    carry-in algos, held to a 1 spp bitsru8 frame.  Returns each new entry
    point's launches in the first frame that drives it (the ``spp`` frame
    where there is one)."""
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    launches, source = {}, {}
    ref_img, dt, _, _ = _bits_frame(scene, cam, dev, "bitsru8", w, h, spp, total)
    say(f"[4e bits] bitsru8 reference: {w}x{h} @ {spp} spp, frame {dt:.3f} s, energy "
        f"{_check_image(ref_img, 'bitsru8 reference', spp)!r}")
    for algo in BITS_ALGOS:
        img, dt, counts, peak = _bits_frame(scene, cam, dev, algo, w, h, spp, total)
        energy = _check_image(img, f"{algo} bench", spp)
        gate = _bits_gate(ref_img, img, algo, f"{algo} bench frame")
        for k, v in counts.items():
            if k not in launches:
                launches[k], source[k] = v, f"{algo} @ {spp} spp"
        say(f"[4e bits] {algo}: {w}x{h} @ {spp} spp, frame {dt:.3f} s, "
            f"{w * h * spp / dt:.1f} rays/s, energy {energy!r}, launches {counts}, "
            f"peak memory {peak:.2f} GiB; vs bitsru8: {gate}")
    ref1, _, _, _ = _bits_frame(scene, cam, dev, "bitsru8", w, h, 1, total)
    for algo in CARRY_ALGOS:
        img, dt, counts, peak = _bits_frame(scene, cam, dev, algo, w, h, 1, total)
        energy = _check_image(img, f"{algo} frame", 1)
        gate = _bits_gate(ref1, img, algo, f"{algo} 1 spp frame")
        for k, v in counts.items():
            if k not in launches:
                launches[k], source[k] = v, f"{algo} @ 1 spp"
        say(f"[4e bits] {algo}: {w}x{h} @ 1 spp, frame {dt:.3f} s, energy {energy!r} "
            f"(bitsru8 {float(ref1.sum())!r}), launches {counts}; vs bitsru8: {gate}")
    mine = {k: launches[k] for k in VARIANTS if k in launches}
    say("[4e bits] launches for the kernels line: "
        + ", ".join(f"{k} {v} ({source[k]})" for k, v in mine.items()))
    return mine


def phase_bits_parity(dev: torch.device, w: int = 64, h: int = 64) -> None:
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    for algo in PARITY_ALGOS:
        cfg = wi.RenderConfig.for_scene(scene, w, h, 2, use_defocus=True)._replace(
            **BENCH_KNOBS, algo=algo)
        img_k = _render(scene, cfg, cam, dev, 0, 1)
        t0 = time.perf_counter()
        with mock.patch.object(bits, "leaf_rows", leaf_rows.leaf_rows_plain):
            img_p = _render(scene, cfg, cam, dev, 0, 1)
        _sync(dev)
        msg = _parity(img_k, img_p, f"{algo} kernel render", 0.01, 0.03)
        if not torch.equal(img_k, img_p):
            raise AssertionError(f"{algo}: kernel and plain renders differ ({msg})")
        say(f"[5e parity] {algo} {w}x{h} @ 2 spp, kernel vs plain: {msg} "
            f"(plain render {time.perf_counter() - t0:.1f} s)")


def _inside_rays(n, dev):
    """n rays from (0, 1, 0) +- 0.2 in random directions (default_rng(1)):
    inside the indoor room, where every ray hits."""
    rng = np.random.default_rng(1)
    o = (np.array([0, 1, 0]) + rng.uniform(-0.2, 0.2, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def phase_schedule_kernel(dev: torch.device, w: int = W, h: int = H) -> dict:
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    primary, bounce = _first_wave(scene, cfg, cam, dev, w, h)
    n = w * h
    sets = _walk_sets(primary, bounce, n, dev)
    sets["inside/any_hit"] = (*_inside_rays(n, dev), torch.ones(n, dtype=torch.bool, device=dev),
                              torch.full((n,), 1e30, device=dev), True)
    tr = scene.stream
    out = {}
    for label, (o, d, act, tm, any_hit) in sets.items():
        rays, a = stream.pack_rays(o, bits.nudge(d), tm, act, BLOCK)
        base = (tr.stream, rays, a, BLOCK)
        g = a.shape[0] // BLOCK
        skip = stream_walk.stream_walk(*base, "skip", any_hit, tr.max_depth)
        skip_k_ms = _time_ms(lambda: stream_walk.stream_walk(*base, "skip", any_hit,
                                                             tr.max_depth), 10, dev)
        skip_work = torch.zeros(g, 2, dtype=torch.int64, device=dev)
        skip_plain, skip_ms = _time_once(lambda: stream_walk.stream_walk_plain(
            *base, "skip", any_hit, tr.max_depth, work=skip_work), dev)
        if label.startswith("inside") and not bool((skip[1][:n] >= 0).all()):
            raise AssertionError(f"{label}: {int((skip[1][:n] < 0).sum())} rays miss")
        for algo in SCHEDULES:
            walk, width = stream_walk.parse_algo(algo)
            args = (*base, algo, any_hit, tr.max_depth)
            got = stream_walk.stream_walk(*args)
            if walk == "ilv":  # its plain version is the skip walk's
                want, p_ms, work = skip_plain, skip_ms, skip_work
            else:
                work = torch.zeros(g, 2, dtype=torch.int64, device=dev)
                want, p_ms = _time_once(
                    lambda: stream_walk.stream_walk_plain(*args, work=work), dev)
            k_ms = _time_ms(lambda: stream_walk.stream_walk(*args), 10, dev)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{algo} {label}: kernel differs from its plain version")
            if walk == "ilv":
                vs_skip = all(torch.equal(x, y) for x, y in zip(got, skip))
            elif any_hit:
                vs_skip = torch.equal(got[1] >= 0, skip[1] >= 0)
            else:
                vs_skip = bool(((got[1] == skip[1]) | (got[0] == skip[0])).all())
            if not vs_skip:
                raise AssertionError(f"{algo} {label}: differs from the skip kernel")
            v = want[4].to(torch.int64)
            tested = float(v[:, 2].sum()) * (width if walk in ("spec", "specb") else 1)
            work = work.sum(0).tolist()
            bound_ms, bound_by = _bound(work[0] * SLAB_FLOPS + work[1] * MT_FLOPS,
                                        _nbytes(tr.stream, rays, a, *got))
            say(f"[3f schedules] {algo} {label}: bit-identical, counts equal, "
                f"{'equal to skip' if walk == 'ilv' else 'skip hits kept'}; kernel "
                f"{k_ms:.3f} ms (skip kernel {skip_k_ms:.3f} ms), plain {p_ms:.3f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; live tests: {work[0]} slab, {work[1]} "
                f"triangle); visits per packet mean {float(v[:, 0].float().mean()):.1f} max "
                f"{int(v[:, 0].max())}; rows tested / on the path "
                f"{tested / max(float(v[:, 0].sum()), 1.0):.3f}")
            name = f"stream_walk_{walk}_{'any' if any_hit else 'closest'}"
            rec = out.setdefault(name, {"max_abs_err": 0.0})
            if algo == SCHEDULE_OF[walk] and label.startswith("bounce"):
                rec.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
    return out


def phase_schedule_bench(dev: torch.device, ref_img, w: int = W, h: int = H,
                         spp: int = SPP) -> dict:
    """The bench config through each schedule of SCHEDULE_BENCH: one frame at
    phase 4's second frame's seeds (total_samples 2 * spp), held to its
    image by phase 4d's gates.  Returns each entry point's launches in the
    frame of its SCHEDULE_OF schedule."""
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    launches = {}
    for algo in SCHEDULE_BENCH:
        walk, _ = stream_walk.parse_algo(algo)
        cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(
            **BENCH_KNOBS, algo=algo)
        _render(scene, cfg, cam, dev, 0, 1)  # warm-up
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        stream_walk.reset_launches()
        t0 = time.perf_counter()
        img = _render(scene, cfg, cam, dev, 2 * spp, spp)
        _sync(dev)
        dt = time.perf_counter() - t0
        mine = {k: stream_walk.LAUNCHES[k] for k in stream_walk.LAUNCHES if f"_{walk}_" in k}
        energy = _check_image(img, f"{algo} bench", spp)
        for name, k in mine.items():
            if k <= 0 and dev.type == "cuda":
                raise AssertionError(f"{name} was never launched by the {algo} render")
            if SCHEDULE_OF[walk] == algo:
                launches[name] = k
        peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
        say(f"[4f schedules] {algo}: {w}x{h} @ {spp} spp, frame {dt:.3f} s, "
            f"{w * h * spp / dt:.1f} rays/s, energy {energy!r}, launches {mine}, peak memory "
            f"{peak:.2f} GiB; vs bitsru8: {_pixel_gate(ref_img, img, f'{algo} bench frame')}")
    return launches


def phase_schedule_parity(dev: torch.device, skip_plain=None, w: int = PARITY_W,
                          h: int = PARITY_W) -> None:
    """skip2 / ilvN's plain version is the skip walk's: with ``skip_plain``,
    phase 5c's plain skip image of the same render, they are held to it."""
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    for algo in SCHEDULE_PARITY:
        cfg = wi.RenderConfig.for_scene(scene, w, h, 2, use_defocus=True)._replace(
            **BENCH_KNOBS, algo=algo)
        img_k = _render(scene, cfg, cam, dev, 0, 1)
        t0 = time.perf_counter()
        if skip_plain is not None and stream_walk.parse_algo(algo)[0] == "ilv":
            img_p = skip_plain
        else:
            with mock.patch.object(stream, "stream_walk", stream_walk.stream_walk_plain):
                img_p = _render(scene, cfg, cam, dev, 0, 1)
        _sync(dev)
        msg = _parity(img_k, img_p, f"{algo} kernel render", 0.01, 0.03)
        if not torch.equal(img_k, img_p):
            raise AssertionError(f"{algo}: kernel and plain renders differ ({msg})")
        say(f"[5f parity] {algo} {w}x{h} @ 2 spp, kernel vs plain: {msg} "
            f"(plain render {time.perf_counter() - t0:.1f} s)")


def phase_micro(dev: torch.device) -> dict:
    """The dependent-cursor microbenchmark; per variant the kernels line's
    numbers at dep_chain.CHECK_ROWS rows, where the plain version runs too.
    The bound counts what the variant's outputs need of the distinct rows
    that walk reads: dep0 one 32-byte sector of each (its skip lane) and
    its outputs, no operations; the others the whole rows, the rays and
    the outputs, with every row's records, and the boxes of the rows whose
    vote picks the cursor: none for dep1, every row for dep1red and
    dep1lean, the last row of a window for depb8 and depb8all (whose
    resolve keeps only the last row's pick)."""
    res = dep_chain.measure(dev, say)
    out_bytes = 8 * dep_chain.RAYS + 4
    out = {}
    for v, r in res.items():
        tests = r["rows"] * dep_chain.RAYS * 8
        rec_flops = LEAN_FLOPS if v == "dep1lean" else MT_FLOPS
        box_rows = {"dep0": 0, "dep1": 0, "depb8": r["rows"] // 8,
                    "depb8all": r["rows"] // 8}.get(v, r["rows"])
        flops = 0 if v == "dep0" else (tests * rec_flops
                                       + box_rows * dep_chain.RAYS * 8 * SLAB_FLOPS)
        n_bytes = (r["rows"] * 32 + out_bytes if v == "dep0" else
                   r["rows"] * 4 * dep_chain.LANE + 24 * dep_chain.RAYS + out_bytes)
        bound_ms, bound_by = _bound(flops, n_bytes)
        say(f"[6 micro] {v}: bound {bound_ms:.6f} ms ({bound_by}; {r['rows']} rows read) "
            f"at {dep_chain.CHECK_ROWS} rows; kernel {r['check_ms']:.4f} ms there "
            f"({r['launches']} launches)")
        out[f"dep_chain_{v}"] = dict(max_abs_err=0.0, ms=r["check_ms"],
                                     plain_ms=r["plain_ms"], bound_ms=bound_ms,
                                     bound_by=bound_by, launches=r["launches"])
    return out


def phase_leaf_micro(dev: torch.device) -> dict:
    """The leaf-row microbenchmarks; per entry point the kernels line's
    numbers at the size the scripts time: leaf_groups at 256 groups a
    packet, leaf_visit at 32768 visits.  Bounds count the record tests the
    variant makes (halftri's 4 list entries a group, half's 4 records a
    visit; empty none) and the bytes: leaf_groups the distinct rows read
    (noext: row 0), the list entries tested, the counts, the rays, t_max
    and the outputs; leaf_visit the 512 rows (empty: one 32-byte sector of
    each, its lanes 9/10), the rays and the outputs."""
    out = {}
    pk, rays = leaf_groups.PACKETS, leaf_groups.PACKETS * leaf_groups.RAYS
    trip = leaf_groups.TRIPS[1]
    for v, r in leaf_groups.measure(dev, say).items():
        entries = trip * leaf_groups.entries(v)
        flops = rays * entries * leaf_groups.TRIS * GROUP_FLOPS[v]
        n_bytes = r["rows"] * 512 + pk * entries * 4 + pk * 4 + rays * 4 * (6 + 1 + 4)
        out[f"leaf_groups_{v}"] = dict(max_abs_err=0.0, ms=r["ms"][1], plain_ms=r["plain_ms"],
                                       launches=r["launches"], bound=_bound(flops, n_bytes))
    rows = min(leaf_visit.ITERS, leaf_visit.D_ROWS)
    for v, r in leaf_visit.measure(dev, say).items():
        flops = leaf_visit.ITERS * leaf_visit.RAYS * leaf_visit.tests(v) * VISIT_FLOPS[v]
        n_bytes = (rows * (32 if v == "empty" else 512) + 24 * leaf_visit.RAYS
                   + 8 * leaf_visit.RAYS + 4)
        out[f"leaf_visit_{v}"] = dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                                      plain_ms=r["plain_ms"], launches=r["launches"],
                                      bound=_bound(flops, n_bytes))
    for name, rec in out.items():
        rec["bound_ms"], rec["bound_by"] = rec.pop("bound")
        if rec["launches"] <= 0 and dev.type == "cuda":
            raise AssertionError(f"{name} was never launched in its timed runs")
        say(f"[7 leaf micro] {name}: kernel {rec['ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms "
            f"({rec['bound_by']}), plain {rec['plain_ms']:.1f} ms, {rec['launches']} launches")
    return out


def phase_walk_micro(dev: torch.device) -> dict:
    """The walk-visit microbenchmarks; per entry point the kernels line's
    numbers at the size the scripts time (visit_cost at
    visit_cost.SMOKE_SIZES[0] rows, the others at their ITERS).  Bounds
    count the operations of the visits made (per ray: visit_cost 1 add a
    row, the slab's 8 x SLAB_FLOPS, the records' 8 x MT_FLOPS, and the
    lane sums' adds once a row; quant_visit the f32 or u8 slab and the
    records; stack_visit's and mask_reduce's toy tests) and the bytes: the
    32-byte sectors of the lanes each variant reads of the distinct rows
    it reads, the rays (or x) and the outputs."""
    out = {}
    n = visit_cost.SMOKE_SIZES[0]
    for v, r in visit_cost.measure(dev, say, visit_cost.SMOKE_SIZES).items():
        per_row = (1 + (8 * SLAB_FLOPS if visit_cost.has_slab(v) else 0)
                   + (8 * MT_FLOPS if visit_cost.has_mt(v) else 0))
        flops = n * (_visit.RAYS * per_row + visit_cost.n_ext(v)) + _visit.RAYS
        n_bytes = (r["rows"] * _visit.row_bytes(visit_cost.lanes(v)) + 24 * _visit.RAYS
                   + 16 * _visit.RAYS + 8)
        out[f"visit_cost_{v}"] = dict(r, bound=_bound(flops, n_bytes))
    for v, r in quant_visit.measure(dev, say).items():
        per_visit = (8 * SLAB_FLOPS + (Q8_VISIT_FLOPS if v.endswith("q8") else 0)
                     + (8 * MT_FLOPS if v.startswith("full") else 0))
        n_bytes = (r["rows"] * _visit.row_bytes(quant_visit.lanes(v)) + 24 * _visit.RAYS
                   + 8 * _visit.RAYS + 4)
        out[f"quant_visit_{v}"] = dict(r, bound=_bound(r["visits"] * _visit.RAYS * per_visit,
                                                        n_bytes))
    for v, r in stack_visit.measure(dev, say).items():
        n_bytes = (r["rows"] * _visit.row_bytes(stack_visit.lanes(v)) + 8 * _visit.RAYS + 8)
        out[f"stack_visit_{v}"] = dict(r, bound=_bound(
            r["visits"] * _visit.RAYS * (8 * STACK_CHILD_FLOPS + 1), n_bytes))
    for v, r in mask_reduce.measure(dev, say).items():
        n_bytes = (r["rows"] * _visit.row_bytes(mask_reduce.lanes(v)) + 8 * _visit.RAYS + 4)
        out[f"mask_reduce_{v}"] = dict(r, bound=_bound(
            r["visits"] * _visit.RAYS * MASK_VISIT_FLOPS, n_bytes))
    for name, rec in out.items():
        rec["bound_ms"], rec["bound_by"] = rec.pop("bound")
        rec["max_abs_err"] = 0.0
        if rec["launches"] <= 0 and dev.type == "cuda":
            raise AssertionError(f"{name} was never launched in its timed runs")
        say(f"[8 walk micro] {name}: kernel {rec['ms']:.4f} ms, slope {rec['slope_ns']:.2f} ns, "
            f"bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}), plain {rec['plain_ms']:.1f} ms, "
            f"{rec['launches']} launches")
    return out


def _shape_sass(say) -> None:
    """The SASS checks of shape_micro.cu's kernels: the parts that the TPU
    scripts' compiler could drop or restructure are there.  ``both`` runs
    both bodies on every visit when the leaf flag's predicate feeds only
    selects, ``cond`` one body when it feeds a branch."""
    parts = {v: _visit.sass_counts(f"visit_parts_{v}", ("BAR", "LDG"))
             for v in visit_parts.VARIANTS}
    conds = {v: _visit.sass_counts(f"cond_visit_{v}", ("FMNMX", "MUFU.RCP", "BRA"))
             for v in cond_visit.VARIANTS}
    flag = {v: _visit.flag_uses(f"cond_visit_{v}", 4 * _visit.LEAF_LANE)
            for v in cond_visit.VARIANTS}
    say(f"[9 shape micro] SASS visit_parts {parts}; cond_visit {conds}; "
        f"the leaf flag's predicate read by {flag}")
    if parts["any"]["BAR"] < 1 or parts["base"]["BAR"] != 0:
        raise AssertionError("visit_parts any lost its vote's barrier")
    if parts["fori0"]["LDG"] <= parts["base"]["LDG"]:
        raise AssertionError("visit_parts fori0 lost its zero-trip loop")
    if not all(c["FMNMX"] > 0 and c["MUFU.RCP"] > 0 for c in conds.values()):
        raise AssertionError("a cond_visit kernel lost one of its bodies")
    if not flag["both"] or "BRA" in flag["both"]:
        raise AssertionError("cond_visit both branches on the flag: a body is not run every visit")
    if "BRA" not in flag["cond"]:
        raise AssertionError("cond_visit cond does not branch on the flag")


def phase_shape_micro(dev: torch.device) -> dict:
    """The visit-shape microbenchmarks; per entry point the kernels line's
    numbers at the script's ITERS.  Bounds count the operations of the
    visits made (visit_parts the chain's links and the vote; cond_visit
    both bodies, or the flag's body, and the vote; visit_bodies the body's
    tests and the vote) and the bytes: the distinct 32-byte sectors the
    run read, x and o and the state."""
    out = {}
    io_bytes = 8 * _visit.RAYS + 8
    for v, r in visit_parts.measure(dev, say).items():
        flops = r["visits"] * _visit.RAYS * (visit_parts.LINKS * LINK_FLOPS
                                            + visit_parts.votes(v))
        out[f"visit_parts_{v}"] = dict(r, bound=_bound(flops, 32 * r["sectors"] + io_bytes))
    slab_flops = 8 * STACK_CHILD_FLOPS
    mt_flops = 8 * TOY_MT_FLOPS
    for v, r in cond_visit.measure(dev, say).items():
        work = (r["visits"] * (slab_flops + mt_flops) if v == "both" else
                r["leaf_visits"] * mt_flops + (r["visits"] - r["leaf_visits"]) * slab_flops)
        flops = _visit.RAYS * (work + r["visits"])
        out[f"cond_visit_{v}"] = dict(r, bound=_bound(flops, 32 * r["sectors"] + io_bytes))
    for v, r in visit_bodies.measure(dev, say).items():
        flops = r["visits"] * _visit.RAYS * BODY_VISIT_FLOPS[v]
        out[f"visit_body_{v}"] = dict(r, bound=_bound(flops, 32 * r["sectors"] + io_bytes))
    if dev.type == "cuda":
        say(f"[9 shape micro] SM clock after the timed runs, and its most (MHz): "
            f"{_visit.card_line('clocks.sm,clocks.max.sm')}")
        _shape_sass(say)
    for name, rec in out.items():
        rec["bound_ms"], rec["bound_by"] = rec.pop("bound")
        rec["max_abs_err"] = 0.0
        if rec["launches"] <= 0 and dev.type == "cuda":
            raise AssertionError(f"{name} was never launched in its timed runs")
        say(f"[9 shape micro] {name}: kernel {rec['ms']:.4f} ms, slope {rec['slope_ns']:.2f} ns, "
            f"bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}), plain {rec['plain_ms']:.1f} ms, "
            f"{rec['launches']} launches")
    return out


def _mxu_sass(say) -> None:
    """The HMMA count of each matrix-unit kernel: its products were not
    dropped (the DEAD parts' five unused blocks included), and epionly has
    none.  Prints the kernels' instruction counts beside them (every
    opcode starts with "")."""
    sass = {name: _visit.sass_counts(name, ("HMMA", "")) for name in MXU_SASS}
    counts = {name: c["HMMA"] for name, c in sass.items()}
    say(f"[10 mxu micro] SASS HMMA counts {counts}; instructions "
        f"{ {name: c[''] for name, c in sass.items()} }")
    for name, least in MXU_SASS.items():
        if counts[name] < least or (least == 0 and counts[name] != 0):
            raise AssertionError(f"{name}: {counts[name]} HMMA in its SASS, expected "
                                 f"{'none' if least == 0 else f'at least {least}'}")


def phase_mxu_micro(dev: torch.device) -> dict:
    """The matrix-unit microbenchmarks; per entry point the kernels line's
    numbers at the script's size.  The bound is the largest of the dot's
    FLOP over the tensor cores' rate (3xTF32: three TF32 products; bf16;
    none for epionly), the epilogue's operations (EPI_FLOPS a test, the
    DEAD parts' 1) over FP32's and the bytes the function needs (rays,
    panels, tmax where read, the outputs) over the memory rate."""
    out = {}
    for mod in (mxu_tiles, mxu_parts, mxu_pltd):
        out.update(mod.measure(dev, say))
    if dev.type == "cuda":
        _mxu_sass(say)
    for name, rec in out.items():
        variant = name.rsplit("_", 1)[1]
        dot = rec["tiles"] * TILE_DOT_FLOPS
        t_dot = {"epionly": 0.0, "dotbf16": dot / PEAK_TC["bf16"]}.get(variant,
                                                                        3 * dot / PEAK_TC["tf32"])
        t_epi = rec["tests"] * (1 if variant in _mxu.DEAD else EPI_FLOPS) / PEAK_FLOPS["f32"]
        t_bytes = rec["bytes"] / PEAK_BYTES
        rec["bound_ms"] = max(t_dot, t_epi, t_bytes) * 1e3
        rec["bound_by"] = "bytes" if t_bytes >= max(t_dot, t_epi) else "operations"
        lib = rec.pop("library")
        rec["library_ms"] = lib.get("bf16" if variant == "dotbf16" else "f32")
        if rec["launches"] <= 0 and dev.type == "cuda":
            raise AssertionError(f"{name} was never launched in its timed runs")
        say(f"[10 mxu micro] {name}: kernel {rec['ms']:.4f} ms ({rec['ps_per_test']:.3f} ps a "
            f"test), bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}: dot {t_dot * 1e3:.6f}, "
            f"epilogue {t_epi * 1e3:.6f}, bytes {t_bytes * 1e3:.6f}), plain "
            f"{rec['plain_ms']:.2f} ms, the dot alone {lib}, {rec['launches']} launches")
    return out


def _op_sass(say) -> None:
    """The SASS checks of op_micro.cu's kernels, each found by its entry
    point: every splat keeps its own path to the lane and reads the
    chain's lanes; lane_extract reads n_e lanes a visit and keeps n_e +
    n_v multiplies and adds a value, none merged into an FFMA; the
    interleaved walks and the W-row visits take one barrier a step
    whatever n or W."""
    links = visit_parts.LINKS
    # the words a splat's loads read as LDG (plain or read-only) or LDS, its
    # shuffles and its block barriers
    splat = {v: _visit.sass_counts(f"lane_splat_{v}", ("LDG", "LDG.CONSTANT", "LDS", "SHFL",
                                                       "BAR"), words=True)
             for v in lane_splat.VARIANTS}
    say(f"[11 op micro] SASS lane_splat (words read, SHFL, BAR): {splat}")
    for v, c in splat.items():
        plain, ro = c["LDG"] - c["LDG.CONSTANT"], c["LDG.CONSTANT"]
        keeps = {"scalar_extract": plain >= links > ro and c["LDS"] == c["SHFL"] == 0,
                 "bcast_1x128": ro >= links > plain and c["LDS"] == c["SHFL"] == 0,
                 "rep_then_slice": c["LDS"] >= links and c["BAR"] >= 1 and c["SHFL"] == 0,
                 "concat_then_slice": c["LDS"] >= links and c["BAR"] == c["SHFL"] == 0,
                 "repeat_prim": c["SHFL"] >= links and c["LDS"] == c["BAR"] == 0,
                 "roll_lane0": c["SHFL"] > links and c["LDS"] == c["BAR"] == 0}[v]
        if not keeps:
            raise AssertionError(f"lane_splat {v} lost its path to the lane: {c}")
    ext = {v: _visit.sass_counts(f"lane_extract_{v}", ("FMUL", "FADD", "FFMA"))
           for v in lane_extract.VARIANTS}
    words = {v: _visit.sass_counts(f"lane_extract_{v}", ("LDG",), words=True)["LDG"]
             for v in lane_extract.VARIANTS}
    say(f"[11 op micro] SASS lane_extract {ext}; words loaded {words}")
    for v, c in ext.items():
        n_e, n_v = lane_extract.case(v)
        pairs = 2 * (n_e + n_v)  # 2 values a thread
        if c["FFMA"] or c["FMUL"] < pairs or c["FADD"] < pairs or words[v] < n_e:
            raise AssertionError(f"lane_extract {v}: {c}, {words[v]} words loaded; expected "
                                 f"{pairs} FMUL and FADD, no FFMA, {n_e} lanes")
    bars = {name: _visit.sass_counts(name, ("BAR",))["BAR"]
            for name in _build.INTERLEAVE_ENTRY_POINTS[:-1] + _build.SPEC_ENTRY_POINTS[1:]}
    say(f"[11 op micro] SASS barriers {bars}")
    for group in (_build.INTERLEAVE_ENTRY_POINTS[:-1], _build.SPEC_ENTRY_POINTS[1:]):
        if len({bars[name] for name in group}) != 1:
            raise AssertionError(f"barriers a step differ with n or W: {bars}")


def _rows_read(starts, steps) -> int:
    """The distinct table rows of cursors that start at ``starts`` and move
    by ``steps`` (a list of 1s and 2s, the same for every start)."""
    seen = set()
    for p in starts:
        for s in steps:
            seen.add(p % _visit.D_ROWS)
            p += s
    return len(seen)


def phase_op_micro(dev: torch.device) -> dict:
    """The op-cost microbenchmarks; per entry point the kernels line's
    numbers at the script's size.  Bounds count the operations of the
    visits made (lane_splat and the interleaved walks the chain's links
    and the vote; lane_extract (n_e + n_v) x 2 + 1 a value; roll_tput 2 a
    lane; spec_visit the rows tested x 1024 rays x (8 x 25 + 8 x 48)) and
    the bytes: the 32-byte sectors of the lanes each reads of the distinct
    rows it reads, x or the rays, and the outputs.  The rows are those of
    the script's data: lane_splat, roll_tput and spec_visit read their
    rows in order; the interleaved walks' votes are all set there (r only
    grows), and lane_extract's, once set, stay set, so the state's vote
    count gives the cursor's path."""
    out = {}
    io = 8 * _visit.RAYS + 8
    chain = visit_parts.LINKS * LINK_FLOPS
    chain_bytes = _visit.row_bytes(range(visit_parts.LINKS))
    for v, r in lane_splat.measure(dev, say).items():
        n = lane_splat.ITERS
        out[f"lane_splat_{v}"] = dict(r, bound=_bound(
            n * _visit.RAYS * chain, _rows_read([0], [1] * n) * chain_bytes + io))
    for v, r in lane_extract.measure(dev, say).items():
        n_e, n_v = lane_extract.case(v)
        n = _visit.block_visits(lane_extract.ITERS)
        votes = r["state"][1]
        rows = _rows_read([lane_extract.START], [2] * (n - votes) + [1] * votes)
        out[f"lane_extract_{v}"] = dict(r, bound=_bound(
            n * _visit.RAYS * ((n_e + n_v) * 2 + 1), rows * _visit.row_bytes(range(n_e)) + io))
    for v, r in walk_interleave.measure(dev, say).items():
        n = walk_interleave.ITERS
        if v == "roll_tput":
            flops = n * _visit.LANE * 2
            n_bytes = _rows_read([0], [1] * n) * 4 * _visit.LANE + io
        else:
            b = walk_interleave.walks(v)
            if any(votes != n for _, votes in r["state"]):
                raise AssertionError(f"walk_interleave {v}: a vote failed on the script's data")
            flops = n * b * _visit.RAYS * (chain + 1)
            n_bytes = (_rows_read([7 * k for k in range(b)], [1] * n) * chain_bytes
                       + 8 * _visit.RAYS + 8 * b)
        out[f"walk_interleave_{v}"] = dict(r, bound=_bound(flops, n_bytes))
    for v, r in spec_visit.measure(dev, say).items():
        rows = r["work"]
        n_bytes = min(rows, _visit.D_ROWS) * 4 * _visit.LANE + 24 * _visit.RAYS + io
        out[f"spec_visit_{v}"] = dict(r, bound=_bound(rows * _visit.RAYS * SPEC_ROW_FLOPS,
                                                      n_bytes))
    if dev.type == "cuda":
        say(f"[11 op micro] SM clock after the timed runs, and its most (MHz): "
            f"{_visit.card_line('clocks.sm,clocks.max.sm')}")
        _op_sass(say)
    for name, rec in out.items():
        rec["bound_ms"], rec["bound_by"] = rec.pop("bound")
        rec["max_abs_err"] = 0.0
        if rec["launches"] <= 0 and dev.type == "cuda":
            raise AssertionError(f"{name} was never launched in its timed runs")
        say(f"[11 op micro] {name}: kernel {rec['ms']:.4f} ms, slope {rec['slope_ns']:.2f} ns, "
            f"bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}), plain {rec['plain_ms']:.1f} ms, "
            f"{rec['launches']} launches")
    return out


KERNELS = {
    "leaf_rows_closest": ("surf_tpu_torch/csrc/leaf_rows.cu", "surf_tpu/accel/pallas_wide.py:1287"),
    "leaf_rows_any": ("surf_tpu_torch/csrc/leaf_rows.cu", "surf_tpu/accel/pallas_wide.py:1287"),
    **{name: ("surf_tpu_torch/csrc/leaf_rows.cu", "surf_tpu/accel/pallas_wide.py:1287")
       for name in VARIANTS},
    "inst_rows_closest": ("surf_tpu_torch/csrc/inst_rows.cu",
                          "surf_tpu/accel/pallas_instanced.py:260"),
    "inst_rows_any": ("surf_tpu_torch/csrc/inst_rows.cu",
                      "surf_tpu/accel/pallas_instanced.py:260"),
    **{f"stream_walk_{a}_{m}": ("surf_tpu_torch/csrc/stream_walk.cu",
                                "surf_tpu/accel/pallas_wide.py:862")
       for a in ("skip", "stack") for m in ("closest", "any")},
    **{f"bvh_walk_{m}": ("surf_tpu_torch/csrc/bvh_walk.cu",
                         "surf_tpu/accel/pallas_traverse.py:193") for m in ("closest", "any")},
    # ilv serves skip2 (_walk_block_pair, pallas_wide.py:314) as ilv2
    **{f"stream_walk_{a}_{m}": ("surf_tpu_torch/csrc/stream_walk.cu",
                                f"surf_tpu/accel/pallas_wide.py:{line}")
       for a, line in (("ilv", 264), ("spec", 339), ("specb", 514))
       for m in ("closest", "any")},
    **{f"dep_chain_{v}": ("surf_tpu_torch/csrc/dep_micro.cu", "scripts/tpu_dep_micro.py:222")
       for v in dep_chain.VARIANTS},
    # leaf_groups_full also serves scripts/tpu_leaf_kernel_micro.py:69, whose
    # kernel was make_kernel("full") (micro/leaf_groups.py)
    **{f"leaf_groups_{v}": ("surf_tpu_torch/csrc/leaf_micro.cu",
                            "scripts/tpu_leaf_variants_micro.py:157")
       for v in leaf_groups.VARIANTS},
    **{f"leaf_visit_{v}": ("surf_tpu_torch/csrc/leaf_micro.cu", "scripts/tpu_leaf_micro.py:141")
       for v in leaf_visit.VARIANTS},
    **{f"{mod.__name__.rsplit('.', 1)[1]}_{v}": ("surf_tpu_torch/csrc/visit_micro.cu",
                                                 f"scripts/{script}")
       for mod, script in ((visit_cost, "tpu_cost_micro.py:227"),
                           (quant_visit, "tpu_quant_micro.py:203"),
                           (stack_visit, "tpu_stack_micro.py:81"),
                           (mask_reduce, "tpu_reduce_micro.py:80"))
       for v in mod.VARIANTS},
    **{f"{prefix}_{v}": ("surf_tpu_torch/csrc/shape_micro.cu", f"scripts/{script}")
       for mod, prefix, script in ((visit_parts, "visit_parts", "tpu_visit_micro.py:88"),
                                   (cond_visit, "cond_visit", "tpu_cond_micro.py:110"),
                                   (visit_bodies, "visit_body", "tpu_body_micro.py:140"))
       for v in mod.VARIANTS},
    **{f"mxu_tiles{n}_{m}": ("surf_tpu_torch/csrc/mxu_micro.cu",
                             "scripts/tpu_mxu_pallas_micro.py:101") for n, m in mxu_tiles.CASES},
    **{f"mxu_parts_{v}": ("surf_tpu_torch/csrc/mxu_micro.cu",
                          "scripts/tpu_mxu_pallas_micro2.py:121") for v in mxu_parts.VARIANTS},
    "mxu_pltd": ("surf_tpu_torch/csrc/mxu_micro.cu", "scripts/tpu_mxu_micro3.py:124"),
    **{f"{prefix}_{v}": ("surf_tpu_torch/csrc/op_micro.cu", f"scripts/{script}")
       for mod, prefix, script in ((lane_splat, "lane_splat", "tpu_splat_micro.py:85"),
                                   (lane_extract, "lane_extract", "tpu_extract_micro.py:65"),
                                   (walk_interleave, "walk_interleave",
                                    "tpu_interleave_micro.py:96"),
                                   (spec_visit, "spec_visit", "tpu_spec_micro.py:270"))
       for v in mod.VARIANTS},
}


def timed(label: str, fn, *args):
    """Runs one phase and prints its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"[{label}] phase took {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    dev = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    timed("2 build", phase_build)
    kernels = timed("3 kernel", phase_kernel, dev)
    kernels.update(timed("3b inst", phase_inst_kernel, dev))
    kernels.update(timed("3c stream", phase_stream_kernel, dev))
    kernels.update(timed("3d binary", phase_bvh_kernel, dev))
    kernels.update(timed("3e variants", phase_variants, dev))
    launches, bench_img = timed("4 bench", phase_bench, dev)
    launches.update(timed("4b twolevelp", phase_twolevelp_bench, dev))
    launches.update(timed("4d walks", phase_walk_bench, dev, bench_img))
    launches.update(timed("4e bits", phase_bits_bench, dev))
    for name, err in timed("4c capacity", phase_capacity, dev).items():
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    timed("5 parity", phase_parity, dev)
    timed("5b parity", phase_twolevelp_parity, dev)
    plain_imgs = timed("5c parity", phase_walk_parity, dev)
    timed("5e parity", phase_bits_parity, dev)
    kernels.update(timed("3f schedules", phase_schedule_kernel, dev))
    launches.update(timed("4f schedules", phase_schedule_bench, dev, bench_img))
    timed("5f parity", phase_schedule_parity, dev, plain_imgs["skip"])
    for label, phase in (("6 micro", phase_micro), ("7 leaf micro", phase_leaf_micro),
                         ("8 walk micro", phase_walk_micro),
                         ("9 shape micro", phase_shape_micro),
                         ("10 mxu micro", phase_mxu_micro),
                         ("11 op micro", phase_op_micro)):
        micro = timed(label, phase, dev)
        kernels.update(micro)
        launches.update({k: v.pop("launches") for k, v in micro.items()})
    say(f"[done] all phases in {time.perf_counter() - t0:.1f} s")
    rows = []
    for name, rec in kernels.items():
        source, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec.get("library_ms"),
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

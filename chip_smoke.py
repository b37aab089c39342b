#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (surf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles surf_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
     process per source, all started together;
  3. kernel: the leaf-row kernel (leaf_rows_closest, leaf_rows_any: live
     compaction, row splits, the (t, position) merge) and the first
     design's kernel on the same function (leaf_rows_first_design) against
     the plain PyTorch version on the card, at the bench's shapes (512x512
     = 262,144 rays of the indoor scene, 2048-ray packets): primary rays and one
     bounce's rays, closest hit, any-hit trim and the overflow sweep
     (forced with cap_rows=8), with one all-dead packet; then the inputs of
     every leaf-row call of an untimed 512x512 1-spp bench frame (32 waves,
     closest and any), captured by a spy.  Bit-identical (--fmad=false) or
     the phase fails; each set timed new against the first design, in
     turns, with its bound and live share; the SASS instructions a record
     test of both designs and their ptxas registers;
  3b. inst kernel: the instanced leaf-row kernel (inst_rows_closest,
     inst_rows_any: live compaction, row splits across the packet's
     segments, the (t, position) merge) and its first design
     (inst_rows_first_design: the _pr2 entry points) against the plain
     version on the pure two-level stress scene (32 instances, 512x512
     primary rays and one bounce's rays, 2048-ray packets, one all-dead
     packet): closest, any-hit (t_max 16 primary, 4 bounce) and
     per-instance sweeps (inst_cap=8), bit-identical or the phase fails;
     the two timed in turns; the SASS instructions a record test of both;
  3c. stream walks: the skip and stack walks against their plain versions
     on the indoor scene's 8-wide stream, primary and one bounce's rays at
     512x512, 2048-ray packets, one all-dead packet, closest and any-hit
     (t_max 8 primary, 4 bounce): t, record, u, v and the per-packet visit
     counts: the counts must be equal, the hits bit-identical expected
     (else the gate of phase 3); the bound counts the slab and triangle
     tests of the live rays (active, and for any-hit without a hit yet) at
     each row the plain version visits.  algo="skip" runs the ilv kernel
     (stream_walk_ilv_*, ilv1); the skip kernel (stream_walk_skip_*) is its
     first design, reached by stream_walk_skip_pr3, held to the same gates
     and timed in turns with the routed walk (the kernels line's skip rows).
     algo="stack" runs the cluster stack kernel (stream_walk_stack.cu), and
     its first design (stream_walk_stack_pr3: the _pr3 entry points) is
     held bit-identical too and timed in turns with it;
  3d. binary walk: the binary-BVH walk kernel (bvh_walk_live.cu: live
     compaction, both successors and a leaf's triangles staged, one vote a
     step) and its first design (bvh_walk_pr3: the _pr3 entry points)
     against the plain version on the same rays in 1024-ray packets, hits
     and per-packet counts bit-identical or the phase fails; the two timed
     in turns; the SASS instructions a triangle test and a slab test (with
     the step) of both and their ptxas registers;
  4. bench: the bench config (bench.py: indoor scene, 512x512 @ 16 spp as
     16 one-spp calls, wave cap 32, 2048-ray packets, Morton lanes,
     compaction every 16 waves, ladder 6 / shrink 2) through the leaf-row
     kernel: frame time, rays/s, energy and the kernel's launch counts;
  4b. twolevelp bench: the 32-instance stress scene, pure two-level, at
     512x512 @ 16 spp (one timed frame after a warm-up spp) with the bench
     knobs through the instanced kernel:
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
     non-negative image with positive energy, and the instanced kernel and
     its first design against the plain version on one bounce's rays
     (closest and any-hit), bit-identical as in 3b;
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
     (the sweeps all in round A), and must then equal the one-call result.
     Each (the f32 ones on leaf_rows_live_kernel, the bf16 pair on
     leaf_rows_bf16_live_kernel) is timed in turns with its first design
     (leaf_rows_first_design: the _pr4 entry points), which must be
     bit-identical too; then the SASS instructions a record test of the
     seven f32 entry points and their first designs;
  3i. bf16 frames: the inputs of every leaf-row call of an untimed 512x512
     1-spp bitsh frame (64 calls) and bits2h frame (128: round A and the
     carry-in round B), captured by a spy: the new bf16 kernel
     bit-identical to the plain version and to its first design, the two
     timed in turns, with each call's width, live share and bound and the
     sums a spp; then the SASS of the step loop of both designs (by entry
     name): instructions, packed bf16 instructions and F2F conversions a
     record test, and ptxas registers and spills;
  3m. f32 frames: the same for the leaf-row calls of an untimed 512x512
     1-spp frame of each of F32_FRAMES (bitsi, bitsw, bitswi: 64 calls;
     bits2, bits2i, bits2w, bits2wi: 128, round A and the carry-in round
     B): the live kernel bit-identical to the plain version and to its
     first design on every call, timed in turns, with each call's entry
     point, width, live share and bound, and the sums a spp by entry
     point;
  3j. stack frame: the inputs of every stream-walk call of an untimed
     512x512 1-spp stack bench frame (64 calls), captured by a spy: the new
     stack kernel bit-identical to its first design on every call (visits
     included) and to the plain version on PLAIN_WAVES, the two
     timed in turns, with each call's width, live share and visits (and
     the bound where the plain version ran), the sums a spp, and the SASS
     instructions a slab and a triangle test of both designs;
  3k. inst frame: the same for the 64 inst_rows calls of an untimed
     512x512 1-spp stress32 twolevelp frame: the live kernel bit-identical
     to its first design on every call and to the plain version on
     PLAIN_WAVES, timed in turns, with each call's width, live
     share, rows a packet and bound, and the sums a spp;
  3l. binary frame: the inputs of every binary-walk call of an untimed
     512x512 1-spp use_wide=False bench frame (64 calls), captured by a
     spy: the new kernel bit-identical to its first design on every call
     (counts included) and to the plain version on PLAIN_WAVES, the two
     timed in turns, with each call's width, live share and nodes and
     triangles a packet (and the bound where the plain version ran), and
     the sums a spp;
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
     to the skip kernel's output (stream_walk_skip_pr3), specN / specbN's
     records equal to its but at coincident-t ties (any-hit: the same rays
     hit).  Prints ms per
     call, the bound (the tests the rows on the path need), visits per
     packet and the rows tested over the rows on the path; each kernel
     timed in turns with its first design (stream_walk_ilv_pr5,
     stream_walk_spec_pr5; bit-identical too) and the skip kernel, with the
     live share;
  3g. ilv frame: the inputs of every stream-walk call of an untimed
     512x512 1-spp ilv2 bench frame (32 waves, closest and any), captured
     by a spy once for 3g and 3h: the new ilv kernel bit-identical to the
     skip kernel, the first design and the plain version, timed in turns
     with the first design and the skip kernel, with width, live share and
     the bound per wave and the sums per spp; the SASS instructions a slab
     test and a triangle test of the skip kernel, the first ilv design and
     the new one, and their ptxas registers;
  3h. spec frame: the same calls through spec4 and specb8: the new spec
     kernel bit-identical to its first design (visits included) on every
     call and to the plain version on PLAIN_WAVES, timed in turns with
     the first design and the ilv kernel, bounded by 3g's tests (the skip
     path's; the spec path's own where the plain version runs), the sums
     per spp, and the SASS counts and ptxas registers of both spec designs;
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
  12. defer: cross-frame deferral through the facade
     (app.renderer.WavefrontRenderer(defer=True, wave_limit=8)) on the
     indoor scene at 512x512, bitsru8, 2048-ray packets, compaction every
     16 waves: 4 frames of 1 spp (survivors deferred, pool, dropped, wall
     time and leaf-row launches each), then spp=0 frames drain the pool (at
     most 8): dropped 0, leaf-row launches > 0, and the total's energy
     within 1e-4 of the 4 frames at wave cap 256 without deferral (the 4
     frames capped at 8 printed beside it as the bias deferral recovers);
     an instrumented frame at the bench knobs (waves, lane steps,
     occupancy, deferred) bit-identical to render_frame with compaction
     every wave, native lanes and no ladder; a max_bounces=32 frame, which
     reads no live count, bit-identical to the unbounded frame at wave cap
     32, both timed.
  13. grad: a trainer's step through the differentiable estimator
     (surf_tpu_torch.diff) on the indoor scene at 512x512, 1 spp, bitsru8,
     the bench's packet knobs and max_bounces=12 (the ladder off): the
     forward alone under no_grad; then the step's forward (image_loss) and
     backward (torch.autograd.grad) timed apart, their ratio, peak memory
     and leaf-row launches (the forward's: no wave checkpointed), the loss
     bit-equal to grad_image_loss's and every gradient finite and within
     1e-5 of the leaf's largest |g|; the same with all but 3.5 GiB of the
     card held, where the integrator checkpoints the waves (more
     launches, the loss bit-equal, the gradients within 1e-5); with
     rr=False, AD of the largest albedo entry against a central
     difference (h 4e-3, loss in float64) within 1e-3 relative; two steps
     under torch.use_deterministic_algorithms, bit-equal.  Timing lines
     name the card.
  14. animate / twolevel: scene animation through HostCompiled and hybrid
     two-level rendering, at 512x512 @ 1 spp with the bench knobs.
     (a) A refit host and a rebuild host of the indoor scene each take
     ANIM_STEPS update(0.3) steps, each followed by a bitsru8 frame (the
     update's wall, its uploads' and the frame's, leaf-row launches): the
     refit frame against the rebuild frame under tests/test_animation.py's
     gate (under 2% of pixels off by more than 1e-3, energy within 1%),
     the last rebuild frame bit-equal to a fresh compile of the same moved
     scene, and one refit frame at 64x64 @ 2 spp with the leaf-row kernel
     and with its plain version (phase 5's gates).  (b) The indoor and
     stress32 scenes compiled with two_level=True: the twolevel frame
     against the same scene's flattened bitsru8 frame under
     tests/test_instanced.py:163-166's gate (under 1% of pixels off by
     more than 1e-3, energy within 0.5%), inst_rows launches and both
     frames' walls; the indoor hybrid host again after update(0.3,
     rebuild=True); stress32's twolevel frame at 64x64 @ 2 spp with the
     instanced kernel and with its plain version (phase 5b's gates).
     (c) Pure stress32: instance 1 moved and refresh(): the frame
     bit-equal to a fresh pure compile's.  The launches of the (a) and (b)
     frames count into the kernels line.
  15. dist / cli: data-parallel distribution (surf_tpu_torch.dist) and
     the CLI on the indoor scene at 512x512 @ 1 spp, the bench knobs with
     native lanes.  (a) A world of one in this process
     (init_multihost: NCCL on the card, gloo on the CPU; destroyed at the
     end of (a)): render_frame_sharded bit-identical to render_frame, its
     leaf-row launches equal to render_frame's; a ShardedSession's two
     frames and, after HostCompiled.update and update_scene, a third,
     each bit-identical to render_frame; grad_step_sharded at
     max_bounces=12 against grad_image_loss at tests/test_sharding.py's
     bounds (loss rtol 1e-5, leaves rtol 1e-4 / atol 1e-6);
     scaling_sweep((1,)); the CLI in process (--scene indoor --spp 1
     --frames 2 --animate) with --shard and without, both .npy images
     equal.  (b) DIST_RANKS ranks spawned on the same card over gloo
     (dist.launch.run_local_ranks): each renders the sharded frame and
     takes the sharded gradient step on its half of the lanes (each after
     a warm-up call), held to
     (a)'s single-device frame (atol 1e-5, exact equality printed) and
     gradients (the same bounds); every sharded call launches both
     leaf-row entry points.  The launches of the sharded calls, (b)'s
     ranks' included, count into the kernels line.
Each phase prints its seconds.  Then a JSON line of per-kernel results
and, last, the device summary.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from surf_tpu_torch.accel import (_build, bits, bvh_walk, inst_rows, instanced,
                                  leaf_rows, stream, stream_walk)
from surf_tpu_torch.app import cli
from surf_tpu_torch.app.renderer import RendererConfigHost, WavefrontRenderer
from surf_tpu_torch.diff import (DiffTargets, finite_difference, grad_image_loss, image_loss,
                                 render_image_diff, tree_flatten)
from surf_tpu_torch.dist import (ShardedSession, grad_step_sharded, init_multihost, make_mesh,
                                 render_frame_sharded, scaling_sweep)
from surf_tpu_torch.dist.launch import run_local_ranks
from surf_tpu_torch.micro import (_mxu, _visit, cond_visit, dep_chain, lane_extract,
                                  lane_splat, leaf_groups, leaf_visit, mask_reduce, mxu_parts,
                                  mxu_pltd, mxu_tiles, quant_visit, spec_visit, stack_visit,
                                  visit_bodies, visit_cost, visit_parts, walk_interleave)
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.camera import CameraParams, view_plane
from surf_tpu_torch.core import transform as tf
from surf_tpu_torch.scene import compile as sc
from surf_tpu_torch.scene.compile import HostCompiled, compile_scene
from surf_tpu_torch.wavefront import integrator as wi

TPU_ENERGY = 87157.2109375  # surf_tpu on a TPU v5e, BENCH_r05.json
W = H = 512
SPP = 16
STRESS_N = 32
STRESS_FRAMES = 1  # 4b's timed frames of each compile (2 until phase 13 took their time)
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
# The entry points each walk's frame must launch (skip: the ilv kernel).
WALK_LAUNCHES = {"skip": ("stream_walk_ilv_closest", "stream_walk_ilv_any"),
                 "stack": ("stream_walk_stack_closest", "stream_walk_stack_any"),
                 "binary": ("bvh_walk_closest", "bvh_walk_any")}
XF_FLOPS = 33      # one ray into one instance's object space (origin + dir)
# Phase 3e: the entry points beyond phase 3's pair, and round A's rows
# before a carry-in call (bits2's default refine_rows).
VARIANTS = [k for k in leaf_rows.ENTRY_POINTS if k not in ("leaf_rows_closest", "leaf_rows_any")]
CARRY_ROWS = bits.BITS_REFINE_ROWS
# The first designs, kept as yardsticks that no algo reaches: the f32
# pair's (phase 3), the other entry points' (3e, 3i, 3m;
# leaf_rows.leaf_rows_first_design) and the skip walk's (3c, 3f, 3g;
# stream_walk.stream_walk_skip_pr3, whose launches count under the entry
# points stream_walk_skip_*).
PAIR = ("leaf_rows_closest", "leaf_rows_any")
F32_FIRST = tuple(leaf_rows.FIRST_DESIGNS[k] for k in PAIR)
VARIANT_FIRST = tuple(leaf_rows.FIRST_DESIGNS[k] for k in VARIANTS)
SKIP_FIRST = ("stream_walk_skip_closest", "stream_walk_skip_any")
# ... the stack walk's (3c, 3j; stream_walk.stream_walk_stack_pr3), the
# instanced rows' (3b, 3k; inst_rows.inst_rows_first_design) and the binary
# walk's (3d, 3l; bvh_walk.bvh_walk_pr3).
STACK_FIRST = _build.STACK_PR3_ENTRY_POINTS
INST_FIRST = tuple(inst_rows.FIRST_DESIGNS.values())
BVH_FIRST = tuple(bvh_walk.FIRST_DESIGNS.values())
# Phases 3i and 3m: the bf16 frames and the f32 bits frames replayed, and the
# 1 spp frame's leaf-row calls each (32 waves, closest and shadow; bits2h
# and bits2 rounds A and B).
BF16_FRAMES = {"bitsh": 64, "bits2h": 128}
F32_FRAMES = {"bitsi": 64, "bitsw": 64, "bitswi": 64, "bits2": 128, "bits2i": 128, "bits2w": 128,
              "bits2wi": 128}
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
# Phases 3h, 3j, 3k and 3l: the waves of a replayed frame that the plain
# version also runs on (1.4-3.4 s a full-width call of the plain spec,
# stack and binary walks): the first two, full width, and the first and
# last of the narrow tail.
PLAIN_WAVES = (0, 1, 16, 31)
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


CARD = {"smi": "not a GPU run"}  # nvidia-smi's name and power limit, for timing lines


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    CARD["smi"] = smi
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


def _bits_same(got, want) -> bool:
    """Every output equal bit for bit (a NaN t_max comes back as itself)."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(got, want))


def _leaf_bound(table, lists, n_rows, rays):
    """(bound ms, what bounds it, tests, live share) of a leaf-row call:
    the tests of its live rays (t_max > 1e-5) against its lists' rows."""
    g = lists.shape[0]
    live = (rays[6] > leaf_rows.EPS).view(g, -1).sum(1)
    rows = torch.where(n_rows < 0, table.shape[0], n_rows)
    tests = float((rows * live).sum()) * 8
    bound_ms, bound_by = _bound(tests * MT_FLOPS,
                                _nbytes(table, lists, n_rows, rays) + 16 * rays.shape[1])
    return bound_ms, bound_by, tests, float(live.sum()) / rays.shape[1]


def _in_turns(fns: dict, reps: int, dev: torch.device) -> dict:
    """Mean ms per call of each function, timed in turns: in order, then in
    the reverse order (first design, new, new, first design); each the mean
    of its two."""
    ms = {k: 0.0 for k in fns}
    for k in [*fns, *reversed(fns)]:
        ms[k] += _time_ms(fns[k], reps, dev) / 2
    return ms


def _new_vs_pr1(args, reps: int, dev: torch.device):
    """(new ms, first design's ms) of one leaf-row call, timed in turns."""
    ms = _in_turns({"pr1": lambda: leaf_rows.leaf_rows_first_design(*args),
                    "new": lambda: leaf_rows.leaf_rows(*args)}, reps, dev)
    return ms["new"], ms["pr1"]


def _spy(module, attr: str, scene, cfg, cam, dev) -> list:
    """The calls of ``module.attr`` in one untimed 1-spp render of cfg, in
    order: (args, kw) as the render made them."""
    calls = []
    real = getattr(module, attr)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    with mock.patch.object(module, attr, spy):
        _render(scene, cfg, cam, dev, 0, 1)
    _sync(dev)
    return calls


def _by_wave(calls, is_any) -> list:
    """(wave, closest or any, args) of each call, waves counted apart for the
    closest-hit and the any-hit calls (``is_any(args)``), which a frame
    makes as many of."""
    waves, seen = [], {False: 0, True: 0}
    for args, _ in calls:
        any_hit = bool(is_any(args))
        waves.append((seen[any_hit], "any" if any_hit else "closest", args))
        seen[any_hit] += 1
    if seen[False] != seen[True]:
        raise AssertionError(f"{seen[False]} closest calls against {seen[True]} any calls")
    return waves


def _bench_waves(scene, dev, w, h):
    """The leaf-row calls of one untimed w x h 1-spp bench frame, in order:
    (wave, closest or any, its inputs), captured by a spy on bits.leaf_rows."""
    cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    calls = _spy(bits, "leaf_rows", scene, cfg, cam, dev)
    for args, kw in calls:
        if len(args) != 6 or leaf_rows.entry_point(**kw, trim=bool(args[5])) not in PAIR:
            raise AssertionError(f"the bench frame called leaf_rows with {len(args)} {kw}")
    return _by_wave(calls, lambda args: args[5])


def _ptxas_regs() -> dict:
    """{device kernel name: its ptxas registers and spills} of the build."""
    regs = {}
    log = _build.build().with_suffix(".log")
    for ln in _ptxas_summary(log.read_text()) if log.exists() else []:
        name, rest = ln.split(": ", 1)
        regs[name] = rest
    return regs


def _is_packed_bf16(op: str) -> bool:
    """A packed bf16x2 arithmetic instruction (HADD2/HMUL2/HFMA2 .BF16*)."""
    first, *parts = op.split(".")
    return first in ("HADD2", "HMUL2", "HFMA2") and any(x.startswith("BF16") for x in parts)


def _leaf_sass(say, entries, label: str) -> dict:
    """SASS instructions a record test of the leaf-row kernels of
    ``entries`` and their ptxas registers, found by entry name: the
    smallest loop that holds a row's 8 record tests (8 or more MUFU.RCP,
    one reciprocal a test; the row loop, unrolled over them), less the
    loops nested in it (the live kernels' exact redo of a row), over its
    MUFU.RCP (a test's); of those, the packed bf16 instructions and the
    F2F conversions.  A static count: the branches around the division's
    and the redo's rare paths count once."""
    regs = _ptxas_regs()
    out = {}
    for entry in entries:
        loops = _visit.loop_bodies(entry)
        rows = [(lo, hi, ops) for lo, hi, ops in loops if ops.count("MUFU.RCP") >= 8]
        if not rows:
            raise AssertionError(f"{entry}: no loop holds a row's record tests")
        lo, hi, ops = min(rows, key=lambda x: len(x[2]))
        inner = [(a, b, o) for a, b, o in loops if lo <= a and b <= hi and (a, b) != (lo, hi)]
        outer = [x for x in inner if not any(y[0] <= x[0] and x[1] <= y[1] and y is not x
                                             for y in inner)]
        own = Counter(ops) - sum((Counter(o) for _, _, o in outer), Counter())
        n_own = sum(own.values())
        tests = own["MUFU.RCP"]
        lds = {op: k for op, k in own.items() if op.startswith("LDS")}
        packed = sum(k for op, k in own.items() if _is_packed_bf16(op))
        f2f = sum(k for op, k in own.items() if op.startswith("F2F"))
        out[entry] = n_own / tests
        say(f"[{label}] SASS {entry}: {n_own} instructions for {tests} record tests "
            f"({len(ops) - n_own} more in {len(outer)} nested loop(s)) = {n_own / tests:.2f} a "
            f"test, packed bf16 {packed / tests:.2f} a test, F2F {f2f / tests:.2f} a test, loads "
            f"{lds}; ptxas {regs.get(_visit.kernel_name(entry), 'not found')}")
    return out


def phase_kernel(dev: torch.device, w: int = W, h: int = H) -> dict:
    """The two designs of leaf_rows_closest / leaf_rows_any against the
    plain version: phase 3's six sets and every wave of a bench frame."""
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
        old = leaf_rows.leaf_rows_first_design(*args)
        want = leaf_rows.leaf_rows_plain(*args)
        _sync(dev)
        bit, err, _ = _compare(got, want)
        if not bit:
            raise AssertionError(f"{label}: kernel disagrees with the plain version "
                                 f"(max |dt| {err})")
        if not _bits_same(old, want):
            raise AssertionError(f"{label}: the first design's kernel disagrees with the "
                                 f"plain version")
        k_ms, pr1_ms = _new_vs_pr1(args, 20, dev)
        p_ms = _time_ms(lambda: leaf_rows.leaf_rows_plain(*args), 3, dev)
        bound_ms, bound_by, tests, live = _leaf_bound(*args[:4])
        sweeps = int((n_rows < 0).sum())
        say(f"[3 kernel] {label}: bit-identical, "
            f"max |dt| {err:.3g}, kernel {k_ms:.4f} ms (first design {pr1_ms:.4f} ms, "
            f"{pr1_ms / k_ms:.2f}x), plain {p_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, {tests:.4g} tests), live {live:.1%}, "
            f"packets {lists.shape[0]} (sweep {sweeps}), cap {lists.shape[1]}, "
            f"mean list {float(n_rows.clamp(min=0).float().mean()):.1f} rows")
        rec = out["leaf_rows_any" if any_hit else "leaf_rows_closest"]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if label in ("bounce/closest", "bounce/any_hit"):
            rec.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)

    # Every wave of a bench frame: the inputs of its closest and any calls,
    # each held bit for bit to the plain version and timed in both designs.
    total = {"new": 0.0, "pr1": 0.0, "bound": 0.0}
    for wave, kind, args in _bench_waves(scene, dev, w, h):
        got = leaf_rows.leaf_rows(*args)
        want, p_ms = _time_once(lambda: leaf_rows.leaf_rows_plain(*args), dev)
        if not (_bits_same(got, want)
                and _bits_same(leaf_rows.leaf_rows_first_design(*args), want)):
            raise AssertionError(f"wave {wave} {kind}: a kernel disagrees with the plain version")
        k_ms, pr1_ms = _new_vs_pr1(args, 10, dev)
        bound_ms, bound_by, tests, live = _leaf_bound(*args[:4])
        total["new"] += k_ms
        total["pr1"] += pr1_ms
        total["bound"] += bound_ms
        lists = args[1]
        say(f"[3 kernel] wave {wave:2d} {kind:7s} width {args[3].shape[1]:6d}, live {live:6.1%}, "
            f"bit-identical, kernel {k_ms:.4f} ms, first design {pr1_ms:.4f} ms "
            f"({pr1_ms / k_ms:.2f}x), bound {bound_ms:.4f} ms ({bound_by}, {tests:.4g} tests), "
            f"plain {p_ms:.1f} ms, mean list "
            f"{float(args[2].clamp(min=0).float().mean()):.1f} rows of {lists.shape[1]}")
    say(f"[3 kernel] one {w}x{h} spp's leaf-row calls: kernel {total['new']:.3f} ms, "
        f"first design {total['pr1']:.3f} ms, bound {total['bound']:.3f} ms")
    if dev.type == "cuda":
        _leaf_sass(say, PAIR + F32_FIRST, "3 kernel")
    return out


def _inst_bound(table, lists, counts, segs, inv, rays):
    """(bound ms, what bounds it, tests, live share) of an instanced call:
    the record tests of its live rays (t_max > 1e-5) against the rows of
    each listed instance, and one transform a live ray and listed
    instance."""
    g = lists.shape[0]
    rows = torch.where(counts < 0, segs[2][None, :], counts)
    live = (rays[6] > leaf_rows.EPS).view(g, -1).sum(1)[:, None]
    tests = float((rows * live).sum()) * 8
    xf = float(((counts != 0) * live).sum())
    bound_ms, bound_by = _bound(tests * MT_FLOPS + xf * XF_FLOPS,
                                _nbytes(table, lists, counts, segs, inv, rays)
                                + 20 * rays.shape[1])
    return bound_ms, bound_by, tests, float(live.sum()) / rays.shape[1]


def _inst_turns(args, reps: int, dev: torch.device) -> dict:
    """ms of the live kernel ("new") and the first design ("pr2") on one
    instanced call, timed in turns."""
    return _in_turns({"pr2": lambda: inst_rows.inst_rows_first_design(*args),
                      "new": lambda: inst_rows.inst_rows(*args)}, reps, dev)


def phase_inst_kernel(dev: torch.device, w: int = W, h: int = H,
                      n_inst: int = STRESS_N) -> dict:
    """The two designs of inst_rows_closest / inst_rows_any against the
    plain version on the stress scene's six sets, bit-identical, timed in
    turns; then the SASS instructions a record test of both."""
    scene_h = builtin.make_instanced_stress_scene(n_inst)
    scenes = {0: compile_scene(scene_h, dev, two_level="pure"),
              8: compile_scene(scene_h, dev, two_level="pure", inst_cap=8)}
    ps = scenes[0]
    cfg = wi.RenderConfig.for_scene(ps, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_stress_camera(w, h, n_inst), dev)
    primary, bounce = _first_wave(ps, cfg, cam, dev, w, h)
    out = {name: {"max_abs_err": 0.0} for name in (*inst_rows.FIRST_DESIGNS, *INST_FIRST)}
    for label, (o, d, act, tm, any_hit, cap) in _ray_sets(primary, bounce, w * h, dev,
                                                          16.0, 8).items():
        tr = scenes[cap].inst
        rays, lists, counts = instanced.prepare(tr, o, d, tm, act, BLOCK)
        args = (tr.ltab, lists, counts, tr.segs, tr.inv, rays, BLOCK, any_hit)
        got = inst_rows.inst_rows(*args)
        old = inst_rows.inst_rows_first_design(*args)
        want = inst_rows.inst_rows_plain(*args)
        _sync(dev)
        if not (_bits_same(got, want) and _bits_same(old, want)):
            _, err, _ = _compare(got, want)
            raise AssertionError(f"{label}: an instanced design disagrees with the plain "
                                 f"version (max |dt| {err})")
        t = _inst_turns(args, 10, dev)
        p_ms = _time_ms(lambda: inst_rows.inst_rows_plain(*args), 2, dev)
        pairs = int((counts != 0).sum())
        bound_ms, bound_by, tests, _ = _inst_bound(*args[:6])
        rows = torch.where(counts < 0, tr.segs[2][None, :], counts)
        say(f"[3b inst] {label}: bit-identical, kernel {t['new']:.3f} ms, first design "
            f"{t['pr2']:.3f} ms ({t['pr2'] / t['new']:.2f}x), plain {p_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by}, {tests:.4g} tests), "
            f"packets {lists.shape[0]}, pairs {pairs} (sweep {int((counts < 0).sum())}), "
            f"mean list {float(rows.sum()) / max(pairs, 1):.1f} rows")
        name = "inst_rows_any" if any_hit else "inst_rows_closest"
        if label in ("bounce/closest", "bounce/any_hit"):
            for k, ms in ((name, t["new"]), (inst_rows.FIRST_DESIGNS[name], t["pr2"])):
                out[k].update(ms=ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
    if dev.type == "cuda":
        _leaf_sass(say, (*inst_rows.FIRST_DESIGNS, *INST_FIRST), "3b inst")
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
            nbytes = _nbytes(tr.stream, rays, a, *got)
            name = f"stream_walk_{algo}_{'any' if any_hit else 'closest'}"
            if algo == "skip":  # the routed walk (the ilv kernel) and the skip kernel in turns
                if not _bits_same(got, want):
                    raise AssertionError(f"skip {label}: the routed walk differs from the "
                                         f"plain version")
                first = stream_walk.stream_walk_skip_pr3(*args[:4], any_hit)
                t = _in_turns({"pr3": lambda: stream_walk.stream_walk_skip_pr3(*args[:4],
                                                                               any_hit),
                               "new": lambda: stream_walk.stream_walk(*args)}, 10, dev)
                _walk_record(out, name, label, first, want, t["pr3"], p_ms,
                             work.sum(0).tolist(), nbytes, "[3c stream] first design")
                say(f"[3c stream] skip {label}: routed (stream_walk_ilv_*) {t['new']:.3f} ms, "
                    f"bit-identical; the skip kernel (stream_walk_skip_pr3) {t['pr3']:.3f} ms "
                    f"({t['pr3'] / t['new']:.2f}x)")
            else:  # the cluster stack walk and its first design in turns
                first = stream_walk.stream_walk_stack_pr3(*args[:4], any_hit, tr.max_depth)
                t = _in_turns({"pr3": lambda: stream_walk.stream_walk_stack_pr3(
                                   *args[:4], any_hit, tr.max_depth),
                               "new": lambda: stream_walk.stream_walk(*args)}, 10, dev)
                if not (_bits_same(got, want) and _bits_same(first, want)):
                    raise AssertionError(f"stack {label}: a stack design differs from the "
                                         f"plain version")
                _walk_record(out, name, label, got, want, t["new"], p_ms,
                             work.sum(0).tolist(), nbytes, "[3c stream]")
                _walk_record(out, f"{name}_pr3", label, first, want, t["pr3"], p_ms,
                             work.sum(0).tolist(), nbytes, "[3c stream] first design")
                say(f"[3c stream] stack {label}: new {t['new']:.3f} ms, first design "
                    f"(stream_walk_stack_pr3) {t['pr3']:.3f} ms ({t['pr3'] / t['new']:.2f}x), "
                    f"both bit-identical")
            visits = want[4].sum(0, dtype=torch.int64).tolist()  # rows, leaf rows
            g = want[4].shape[0]
            say(f"[3c stream]   visits per packet: mean {visits[0] / g:.1f} rows "
                f"({visits[1] / g:.1f} leaf), max {int(want[4][:, 0].max())}")
    return out


def _bvh_turns(args, reps: int, dev: torch.device) -> dict:
    """ms of the binary walk ("new") and its first design ("pr3") on one
    call, timed in turns."""
    return _in_turns({"pr3": lambda: bvh_walk.bvh_walk_pr3(*args),
                      "new": lambda: bvh_walk.bvh_walk(*args)}, reps, dev)


def phase_bvh_kernel(dev: torch.device, w: int = W, h: int = H) -> dict:
    """The binary walk (bvh_walk_{closest,any}) and its first design
    (bvh_walk_pr3) against the plain version on phase 3c's four ray sets in
    1024-ray packets: hits and per-packet counts bit-identical, or the
    phase fails; the two timed in turns; the SASS a slab and a triangle test
    of both."""
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
        first = bvh_walk.bvh_walk_pr3(*args)
        work = torch.zeros(a.shape[0] // blk, 2, dtype=torch.int64, device=dev)
        want, p_ms = _time_once(lambda: bvh_walk.bvh_walk_plain(*args, work=work), dev)
        if not (_bits_same(got, want) and _bits_same(first, want)):
            raise AssertionError(f"binary {label}: a binary walk design differs from the plain "
                                 f"version")
        t = _bvh_turns(args, 10, dev)
        counts = want[4].sum(0, dtype=torch.int64).tolist()  # nodes, triangles
        nbytes = _nbytes(tr.nodes, tr.tris, rays, a, *got)
        name = bvh_walk.ENTRY_POINTS[int(any_hit)]
        _walk_record(out, name, label, got, want, t["new"], p_ms, work.sum(0).tolist(), nbytes,
                     "[3d binary]")
        _walk_record(out, bvh_walk.FIRST_DESIGNS[name], label, first, want, t["pr3"], p_ms,
                     work.sum(0).tolist(), nbytes, "[3d binary] first design")
        g = want[4].shape[0]
        say(f"[3d binary] {label}: new {t['new']:.3f} ms, first design (bvh_walk_pr3) "
            f"{t['pr3']:.3f} ms ({t['pr3'] / t['new']:.2f}x), both bit-identical; per packet: "
            f"mean {counts[0] / g:.1f} nodes, {counts[1] / g:.1f} triangles, live "
            f"{float(a.float().mean()):.1%}")
    if dev.type == "cuda":
        _bvh_sass(say, (*bvh_walk.ENTRY_POINTS, *BVH_FIRST), "3d binary")
    return out


# Rays a thread of each binary walk kernel holds and tests in its one
# triangle loop: two in bvh_walk_live.cu and in the first design (kRays).
BVH_RAYS = 2


def _bvh_sass(say, entries, label: str) -> None:
    """SASS instructions a triangle test and a slab test of the binary walk
    kernels of ``entries`` (found by entry name), with their ptxas
    registers: the triangle loop is the innermost loop that holds a
    MUFU.RCP, its instructions over the rays a thread tests in it; the
    step loop is the largest loop, and its instructions outside the loops
    nested in it over the rays a thread holds are a slab test with the
    step's vote, cursor and staging.  A static count: the division's and
    the redo's rare paths count once."""
    regs = _ptxas_regs()
    for entry in entries:
        loops = _visit.loop_bodies(entry)
        rcp = [x for x in loops if any(o.startswith("MUFU.RCP") for o in x[2])]
        tri = min(rcp, key=lambda x: len(x[2]))
        step = max(loops, key=lambda x: len(x[2]))
        inner = sum(len(x[2]) for x in loops if x is not step and step[0] <= x[0]
                    and x[1] <= step[1] and not any(y is not x and y is not step and y[0] <= x[0]
                                                    and x[1] <= y[1] for y in loops))
        say(f"[{label}] SASS {entry}: triangle loop {len(tri[2])} instructions for "
            f"{BVH_RAYS} rays = {len(tri[2]) / BVH_RAYS:.1f} a triangle test; step loop "
            f"{len(step[2])} instructions, {len(step[2]) - inner} outside its nested loops = "
            f"{(len(step[2]) - inner) / BVH_RAYS:.1f} a slab test with the step; ptxas "
            f"{regs.get(_visit.kernel_name(entry), 'not found')}")


def phase_bvh_frame(dev: torch.device, w: int = W, h: int = H, reps: int = 3) -> None:
    """Every binary-walk call of an untimed 1-spp use_wide=False bench frame
    (64: 32 waves, closest and shadow rays): the new kernel bit-identical
    to its first design on every call (counts included) and to the plain
    version on PLAIN_WAVES (where the plain version's tally gives the
    bound); the two timed in turns, with each call's width, live share and
    visits a packet, and the sums a spp."""
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(
        **BENCH_KNOBS, use_wide=False)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    calls = _spy(bvh_walk, "bvh_walk", scene, cfg, cam, dev)
    for args, kw in calls:
        if kw or len(args) != 6:
            raise AssertionError(f"the binary frame called bvh_walk with {len(args)} {kw}")
    waves = _by_wave(calls, lambda args: args[5])
    total = {"new": 0.0, "pr3": 0.0, "bound": 0.0}
    bounded = 0
    for wave, kind, args in waves:
        got = bvh_walk.bvh_walk(*args)
        if not _bits_same(got, bvh_walk.bvh_walk_pr3(*args)):
            raise AssertionError(f"binary wave {wave} {kind}: the binary walk designs disagree")
        a = args[4]
        g = a.shape[0] // bvh_walk.BLOCK
        plain = ""
        if wave in PLAIN_WAVES:
            work = torch.zeros(g, 2, dtype=torch.int64, device=dev)
            want, p_ms = _time_once(lambda: bvh_walk.bvh_walk_plain(*args, work=work), dev)
            if not _bits_same(got, want):
                raise AssertionError(f"binary wave {wave} {kind}: the kernel differs from the "
                                     f"plain version")
            work = work.sum(0).tolist()
            bound_ms, bound_by = _bound(work[0] * SLAB_FLOPS + work[1] * MT_FLOPS,
                                        _nbytes(*args[:2], *args[3:5], *got))
            total["bound"] += bound_ms
            bounded += 1
            plain = (f", plain {p_ms:.1f} ms (bit-identical), bound {bound_ms:.4f} ms "
                     f"({bound_by})")
        t = _bvh_turns(args, reps, dev)
        for k in ("new", "pr3"):
            total[k] += t[k]
        v = got[4].float()
        say(f"[3l binary frame] wave {wave:2d} {kind:7s} width {a.shape[0]:6d} ({g} packets), "
            f"live {float(a.float().mean()):6.1%}, bit-identical to the first design, new "
            f"{t['new']:.4f} ms, first design {t['pr3']:.4f} ms ({t['pr3'] / t['new']:.2f}x); "
            f"nodes mean {float(v[:, 0].mean()):.1f} max {int(v[:, 0].max())}, triangles mean "
            f"{float(v[:, 1].mean()):.1f}{plain}")
    say(f"[3l binary frame] one spp's {len(waves)} walk calls: new {total['new']:.3f} ms, "
        f"first design {total['pr3']:.3f} ms ({total['pr3'] / total['new']:.2f}x); bound of "
        f"the {bounded} calls the plain version ran {total['bound']:.3f} ms")


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
        stream_walk.reset_launches()
        bvh_walk.reset_launches()
        t0 = time.perf_counter()
        img = _render(scene, cfg, cam, dev, 2 * spp, spp)
        _sync(dev)
        dt = time.perf_counter() - t0
        mine = {k: counts[k] for k in WALK_LAUNCHES[walk]}
        launches.update(mine)
        energy = _check_image(img, f"{walk} bench", spp)
        for name, k in mine.items():
            if k <= 0 and dev.type == "cuda":
                raise AssertionError(f"{name} was never launched by the {walk} render")
        first = ""
        yardsticks = {"skip": SKIP_FIRST, "stack": STACK_FIRST, "binary": BVH_FIRST}[walk]
        if yardsticks:  # the first design is a yardstick: no frame launches it
            launches.update({k: counts[k] for k in yardsticks})
            first = f" (the first design's {dict((k, counts[k]) for k in yardsticks)})"
        say(f"[4d walks] {walk}: {w}x{h} @ {spp} spp, frame {dt:.3f} s, "
            f"{w * h * spp / dt:.1f} rays/s, energy {energy!r}, launches {mine}{first}; "
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
    times, img = _timed_frames(ps, cfg, cam, dev, spp, STRESS_FRAMES)
    launches = dict(inst_rows.LAUNCHES)
    energy = _check_image(img, "twolevelp bench", spp)
    for name in inst_rows.FIRST_DESIGNS:
        if launches[name] <= 0 and dev.type == "cuda":
            raise AssertionError(f"{name} was never launched by the twolevelp render")
    for name in INST_FIRST:  # the first design is a yardstick: no frame launches it
        if launches[name] != 0:
            raise AssertionError(f"the twolevelp render launched {name}")
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
    f_times, f_img = _timed_frames(fs, fcfg, cam, dev, spp, STRESS_FRAMES)
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
        old = inst_rows.inst_rows_first_design(*args)
        want = inst_rows.inst_rows_plain(*args)
        _sync(dev)
        _, errs[name], _ = _compare(got, want)
        if not (_bits_same(got, want) and _bits_same(old, want)):
            raise AssertionError(f"capacity {name}: an instanced design disagrees with the "
                                 f"plain version (max |dt| {errs[name]})")
        say(f"[4c capacity] bounce/{'any_hit' if any_hit else 'closest'} kernel and first "
            f"design vs plain: bit-identical, max |dt| {errs[name]:.3g}, "
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


def _record_ops(kw) -> tuple:
    """(f32, bf16) operations of one record test of a leaf-row call's kind."""
    return {("bw", "f32"): (BW_FLOPS, 0), ("mt", "f32"): (MT_FLOPS, 0),
            ("mt", "bf16"): (MT_FLOPS - MT_BF16_FLOPS, MT_BF16_FLOPS)}[
                kw.get("record", "mt"), kw.get("precision", "f32")]


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
            # the live design and the first in turns
            first = lambda: leaf_rows.leaf_rows_first_design(  # noqa: E731
                *args, carry=carry, **kw)
            if not _bits_same(first(), want):
                raise AssertionError(f"{name} {label}: the first design differs from the "
                                     f"plain version")
            t = _in_turns({"pr4": first,
                           "new": lambda: leaf_rows.leaf_rows(*args, carry=carry, **kw)},
                          10, dev)
            k_ms = t["new"]
            rows = torch.where(nr < 0, table.shape[0], nr)
            tests = float((rows * live).sum()) * 8
            f32_ops, bf16_ops = _record_ops(kw)
            nbytes = _nbytes(*args[:4]) + 16 * rays.shape[1] * (2 if carry else 1)
            bound_ms, bound_by = _bound(tests * f32_ops, nbytes, tests * bf16_ops)
            resumed = f", resumed after round A's first {k} rows" if carry is not None else ""
            say(f"[3e variants] {name} {label}: bit-identical, kernel {k_ms:.3f} ms, first "
                f"design {t['pr4']:.3f} ms ({t['pr4'] / k_ms:.2f}x, bit-identical), plain "
                f"{p_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, {tests:.4g} "
                f"tests{resumed}), live {float(live.sum()) / rays.shape[1]:.1%}")
            if label == "bounce/closest":
                out[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
                out[leaf_rows.FIRST_DESIGNS[name]] = dict(
                    max_abs_err=0.0, ms=t["pr4"], plain_ms=p_ms, bound_ms=bound_ms,
                    bound_by=bound_by)
    if dev.type == "cuda":
        seven = [k for k in VARIANTS if k not in leaf_rows.BF16_ENTRY_POINTS]
        _leaf_sass(say, (*seven, *(leaf_rows.FIRST_DESIGNS[k] for k in seven)), "3e variants")
    return out


def _leaf_calls(scene, dev, w, h, algo):
    """The leaf-row calls of one untimed w x h 1-spp bench frame of
    ``algo``, in order: (args, kw) as bits.traverse_bits made them,
    captured by a spy on bits.leaf_rows."""
    cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(
        **BENCH_KNOBS, algo=algo)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    return _spy(bits, "leaf_rows", scene, cfg, cam, dev)


def _leaf_frames(dev: torch.device, frames: dict, label: str, w: int, h: int,
                 reps: int) -> None:
    """Every leaf-row call of an untimed w x h 1-spp frame of each algo of
    ``frames`` (algo: its call count): the live kernel bit-identical to its
    first design and to the plain version, the two designs timed in turns,
    with each call's entry point, width, live share and bound, and the sums
    a spp, by entry point."""
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    for algo, n_calls in frames.items():
        calls = _leaf_calls(scene, dev, w, h, algo)
        if len(calls) != n_calls:
            raise AssertionError(f"the {algo} frame made {len(calls)} leaf-row calls, not "
                                 f"{n_calls}")
        totals = {}
        for i, (args, kw) in enumerate(calls):
            carry = kw.get("carry")
            if len(args) != 6:
                raise AssertionError(f"{algo} call {i}: {len(args)} arguments ({kw})")
            name = leaf_rows.entry_point(**{k: v for k, v in kw.items() if k != "carry"},
                                         carry=carry is not None, trim=bool(args[5]))
            got = leaf_rows.leaf_rows(*args, **kw)
            old = leaf_rows.leaf_rows_first_design(*args, **kw)
            want, p_ms = _time_once(lambda: leaf_rows.leaf_rows_plain(*args, **kw), dev)
            if not (_bits_same(got, want) and _bits_same(old, want)):
                raise AssertionError(f"{algo} call {i} ({name}): a design differs from the "
                                     f"plain version")
            t = _in_turns({"pr": lambda: leaf_rows.leaf_rows_first_design(*args, **kw),
                           "new": lambda: leaf_rows.leaf_rows(*args, **kw)}, reps, dev)
            table, lists, n_rows, rays = args[:4]
            start = carry[0] if carry is not None else rays[6]
            live = (start > leaf_rows.EPS).view(lists.shape[0], -1).sum(1)
            tests = float((torch.where(n_rows < 0, table.shape[0], n_rows) * live).sum()) * 8
            nbytes = _nbytes(table, lists, n_rows, rays) + 16 * rays.shape[1] * (
                2 if carry is not None else 1)
            f32_ops, bf16_ops = _record_ops(kw)
            bound_ms, bound_by = _bound(tests * f32_ops, nbytes, tests * bf16_ops)
            total = totals.setdefault(name, {"new": 0.0, "pr": 0.0, "bound": 0.0, "calls": 0})
            for k in ("new", "pr"):
                total[k] += t[k]
            total["bound"] += bound_ms
            total["calls"] += 1
            say(f"[{label}] {algo} call {i:3d} {name:31s} "
                f"width {rays.shape[1]:6d}, live {float(live.sum()) / rays.shape[1]:6.1%}, "
                f"bit-identical, new {t['new']:.4f} ms, first design {t['pr']:.4f} ms "
                f"({t['pr'] / t['new']:.2f}x), bound {bound_ms:.4f} ms ({bound_by}, "
                f"{tests:.4g} tests), plain {p_ms:.1f} ms, mean list "
                f"{float(n_rows.clamp(min=0).float().mean()):.1f} rows of {lists.shape[1]}")
        for name, total in totals.items():
            say(f"[{label}] {algo}: one {w}x{h} spp's {total['calls']} {name} calls: new "
                f"{total['new']:.3f} ms, first design {total['pr']:.3f} ms "
                f"({total['pr'] / total['new']:.2f}x), bound {total['bound']:.3f} ms")


def phase_bf16_frame(dev: torch.device, w: int = W, h: int = H, reps: int = 3) -> None:
    """Every leaf-row call of an untimed 512x512 1-spp frame of bitsh (64:
    32 waves, closest and shadow rays) and of bits2h (128: round A and the
    carry-in round B of each), as ``_leaf_frames``; then the SASS counts of
    both bf16 designs."""
    _leaf_frames(dev, BF16_FRAMES, "3i bf16 frame", w, h, reps)
    if dev.type == "cuda":
        _leaf_sass(say, leaf_rows.BF16_ENTRY_POINTS
                   + tuple(leaf_rows.FIRST_DESIGNS[k] for k in leaf_rows.BF16_ENTRY_POINTS),
                   "3i bf16 frame")


def phase_f32_frames(dev: torch.device, w: int = W, h: int = H, reps: int = 3) -> None:
    """The same for the f32 bits frames of F32_FRAMES, which drive each of
    the seven f32 entry points beyond the pair."""
    _leaf_frames(dev, F32_FRAMES, "3m f32 frames", w, h, reps)


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
    for k in VARIANT_FIRST:  # yardsticks: no frame above launched them
        mine[k], source[k] = launches.get(k, 0), "the bits frames"
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
        skip = stream_walk.stream_walk_skip_pr3(*base, any_hit)
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
            # the new design, the first and the skip kernel in turns
            first = stream_walk.stream_walk_ilv_pr5 if walk == "ilv" else \
                stream_walk.stream_walk_spec_pr5
            old = first(*base, algo, any_hit)
            if not all(torch.equal(x, y) for x, y in zip(old, want)):
                raise AssertionError(f"{algo} {label}: the first design differs from the "
                                     f"plain version")
            t = _in_turns({"pr5": lambda: first(*base, algo, any_hit),
                           "new": lambda: stream_walk.stream_walk(*args),
                           "skip": lambda: stream_walk.stream_walk_skip_pr3(*base, any_hit)},
                          10, dev)
            k_ms = t["new"]
            turns = (f"; in turns: first design {t['pr5']:.3f} ms ({t['pr5'] / k_ms:.2f}x), "
                     f"skip kernel {t['skip']:.3f} ms; live {float(a.float().mean()):.1%}")
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
                f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}; live tests: {work[0]} slab, {work[1]} "
                f"triangle); visits per packet mean {float(v[:, 0].float().mean()):.1f} max "
                f"{int(v[:, 0].max())}; rows tested / on the path "
                f"{tested / max(float(v[:, 0].sum()), 1.0):.3f}{turns}")
            name = f"stream_walk_{walk}_{'any' if any_hit else 'closest'}"
            rec = out.setdefault(name, {"max_abs_err": 0.0})
            if algo == SCHEDULE_OF[walk] and label.startswith("bounce"):
                rec.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
    return out


def _walk_waves(scene, dev, w, h, algo):
    """The stream-walk calls of one untimed w x h 1-spp bench frame of
    ``algo``, in order: (wave, closest or any, its inputs), captured by a
    spy on stream.stream_walk."""
    cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(
        **BENCH_KNOBS, algo=algo)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    calls = _spy(stream, "stream_walk", scene, cfg, cam, dev)
    for args, kw in calls:
        if kw or len(args) != 7 or args[4] != algo:
            raise AssertionError(f"the {algo} frame called stream_walk with {len(args)} {kw}")
    return _by_wave(calls, lambda args: args[5])


def _walk_sass(say, entries, label: str) -> None:
    """SASS instructions a slab test and a triangle test of the walk
    kernels of ``entries`` (found by entry name), with their ptxas
    registers and spills.  The step loop is the kernel's largest loop that
    holds tests and no other loop that does (stream_walk_spec.cu: the one
    without shuffles, the one-lane path's); its slab tests are its FMNMX
    over 10 (a slab test's NaN-propagating min/max), its triangle tests the
    MUFU.RCP outside the slab tests' span (one IEEE division a test; the
    first ilv design's node rows also divide 1/d, inside that span); a
    test's count is its kind's span, first to last such instruction, over
    its tests.  A static count: the division's rare path counts once."""
    regs = _ptxas_regs()
    for entry in entries:
        tests = [x for x in _visit.loop_bodies(entry) if any(o.startswith("FMNMX") for o in x[2])]
        inner = [x for x in tests if not any(y is not x and x[0] <= y[0] and y[1] <= x[1]
                                             for y in tests)]
        plain = [x for x in inner if not any(o.startswith("SHFL") for o in x[2])] or inner
        ops = max(plain, key=lambda x: len(x[2]))[2]
        mnmx = [i for i, op in enumerate(ops) if op.startswith("FMNMX")]
        rcp = [i for i, op in enumerate(ops) if op.startswith("MUFU.RCP")
               and not (mnmx and mnmx[0] <= i <= mnmx[-1])]
        slab = (mnmx[-1] - mnmx[0] + 1) / (len(mnmx) / 10) if mnmx else float("nan")
        tri = (rcp[-1] - rcp[0] + 1) / len(rcp) if rcp else float("nan")
        overlap = bool(mnmx and rcp) and rcp[0] < mnmx[-1] and mnmx[0] < rcp[-1]
        say(f"[{label}] SASS {entry}: step loop {len(ops)} instructions, "
            f"{len(mnmx) / 10:g} slab tests ({slab:.1f} a test), {len(rcp)} triangle tests "
            f"({tri:.1f} a test){'; spans interleave' if overlap else ''}; ptxas "
            f"{regs.get(_visit.kernel_name(entry), 'not found')}")


def phase_ilv_frame(dev: torch.device, waves, reps: int = 5) -> list:
    """Every stream-walk call of an untimed 1-spp ilv2 bench frame
    (``waves``, from ``_walk_waves``): the new design
    (stream_walk_ilv_{closest,any}) bit-identical to the skip kernel, the
    first design and the plain version; timed in turns with the first
    design and the skip kernel; bounded by the plain version's tests of
    live rays.  Then the SASS counts.  Returns each call's [slab, triangle]
    tests (the skip walk's function)."""
    total = {"new": 0.0, "pr5": 0.0, "skip": 0.0, "bound": 0.0}
    works = []
    for wave, kind, args in waves:
        stream_t, rays, a, blk, algo, any_hit, depth = args
        base = (stream_t, rays, a, blk)
        g = a.shape[0] // blk
        got = stream_walk.stream_walk(*args)
        skip = stream_walk.stream_walk_skip_pr3(*base, any_hit)
        old = stream_walk.stream_walk_ilv_pr5(*base, algo, any_hit)
        work = torch.zeros(g, 2, dtype=torch.int64, device=dev)
        want, p_ms = _time_once(lambda: stream_walk.stream_walk_plain(*args, work=work), dev)
        if not (_bits_same(got, skip) and _bits_same(old, skip) and _bits_same(got, want)):
            raise AssertionError(f"wave {wave} {kind}: the ilv designs, the skip kernel and "
                                 f"the plain version disagree")
        t = _in_turns({"pr5": lambda: stream_walk.stream_walk_ilv_pr5(*base, algo, any_hit),
                       "new": lambda: stream_walk.stream_walk(*args),
                       "skip": lambda: stream_walk.stream_walk_skip_pr3(*base, any_hit)},
                      reps, dev)
        work = work.sum(0).tolist()
        works.append(work)
        bound_ms, bound_by = _bound(work[0] * SLAB_FLOPS + work[1] * MT_FLOPS,
                                    _nbytes(stream_t, rays, a, *got))
        for k in ("new", "pr5", "skip"):
            total[k] += t[k]
        total["bound"] += bound_ms
        v = want[4][:, 0].float()
        say(f"[3g ilv frame] wave {wave:2d} {kind:7s} width {a.shape[0]:6d} ({g} packets), live {float(a.float().mean()):6.1%}, bit-identical to skip and "
            f"plain, new {t['new']:.4f} ms, first design {t['pr5']:.4f} ms "
            f"({t['pr5'] / t['new']:.2f}x), skip kernel {t['skip']:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), plain {p_ms:.1f} ms, visits mean "
            f"{float(v.mean()):.1f} max {int(v.max())}")
    say(f"[3g ilv frame] one spp's {len(waves)} walk calls: new {total['new']:.3f} ms, first "
        f"design {total['pr5']:.3f} ms, skip kernel {total['skip']:.3f} ms, bound "
        f"{total['bound']:.3f} ms")
    if dev.type == "cuda":
        _walk_sass(say, [k for k in _build.WALK_KERNELS if "_spec" not in k and "_stack" not in k],
                   "3g ilv frame")
    return works


def phase_spec_frame(dev: torch.device, waves, works, reps: int = 3) -> None:
    """The same calls (3g's ``waves``) through spec4 and specb8: the new
    design (stream_walk_spec{,b}_{closest,any}) bit-identical to the first
    design, visits included, and, on PLAIN_WAVES, to the plain
    version; timed in turns with the first design and the ilv kernel (the
    frame's own algo).  The bound is 3g's: the tests of live rays along
    the skip walk's path (``works``), since the plain spec walk, at 1.4-1.8
    s a call, runs on PLAIN_WAVES only; there its own tally is printed
    beside it.  Then the SASS counts of both spec designs."""
    for algo in ("spec4", "specb8"):
        total = {"new": 0.0, "pr5": 0.0, "ilv": 0.0, "bound": 0.0}
        for (wave, kind, args), work in zip(waves, works):
            stream_t, rays, a, blk, frame_algo, any_hit, depth = args
            base = (stream_t, rays, a, blk)
            g = a.shape[0] // blk
            got = stream_walk.stream_walk(*base, algo, any_hit, depth)
            old = stream_walk.stream_walk_spec_pr5(*base, algo, any_hit)
            if not _bits_same(got, old):
                raise AssertionError(f"{algo} wave {wave} {kind}: the spec designs disagree")
            plain = ""
            if wave in PLAIN_WAVES:
                own = torch.zeros(g, 2, dtype=torch.int64, device=dev)
                want, p_ms = _time_once(lambda: stream_walk.stream_walk_plain(
                    *base, algo, any_hit, depth, work=own), dev)
                if not _bits_same(got, want):
                    raise AssertionError(f"{algo} wave {wave} {kind}: the kernel differs from "
                                         f"the plain version")
                own = own.sum(0).tolist()
                own_ms, _ = _bound(own[0] * SLAB_FLOPS + own[1] * MT_FLOPS,
                                   _nbytes(stream_t, rays, a, *got))
                plain = (f", plain {p_ms:.1f} ms (bit-identical), the spec path's own bound "
                         f"{own_ms:.4f} ms")
            t = _in_turns({"pr5": lambda: stream_walk.stream_walk_spec_pr5(*base, algo, any_hit),
                           "new": lambda: stream_walk.stream_walk(*base, algo, any_hit),
                           "ilv": lambda: stream_walk.stream_walk(*args)}, reps, dev)
            bound_ms, bound_by = _bound(work[0] * SLAB_FLOPS + work[1] * MT_FLOPS,
                                        _nbytes(stream_t, rays, a, *got))
            for k in ("new", "pr5", "ilv"):
                total[k] += t[k]
            total["bound"] += bound_ms
            v = got[4].float()
            say(f"[3h spec frame] {algo} wave {wave:2d} {kind:7s} width {a.shape[0]:6d}, live "
                f"{float(a.float().mean()):6.1%}, bit-identical to the first design, new "
                f"{t['new']:.4f} ms, first design {t['pr5']:.4f} ms ({t['pr5'] / t['new']:.2f}x), "
                f"ilv kernel {t['ilv']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); visits "
                f"mean {float(v[:, 0].mean()):.1f} rows, {float(v[:, 2].mean()):.1f} "
                f"windows{plain}")
        say(f"[3h spec frame] {algo}: one spp's {len(waves)} walk calls: new "
            f"{total['new']:.3f} ms, first design {total['pr5']:.3f} ms, ilv kernel "
            f"{total['ilv']:.3f} ms, bound {total['bound']:.3f} ms")
    if dev.type == "cuda":
        _walk_sass(say, [k for k in _build.WALK_KERNELS if "_spec" in k], "3h spec frame")


def phase_stack_frame(dev: torch.device, w: int = W, h: int = H, reps: int = 3) -> None:
    """Every stream-walk call of an untimed 1-spp stack bench frame (64: 32
    waves, closest and shadow rays): the cluster stack kernel
    (stream_walk_stack_{closest,any}) bit-identical to its first design,
    visits included, on every call and to the plain version on
    PLAIN_WAVES (where the plain version's tally gives the bound);
    the two timed in turns, with each call's width, live share and visits
    per packet, and the sums a spp.  Then the SASS counts of both."""
    waves = _walk_waves(compile_scene(builtin.make_indoor_scene(), dev), dev, w, h, "stack")
    total = {"new": 0.0, "pr3": 0.0}
    for wave, kind, args in waves:
        stream_t, rays, a, blk, algo, any_hit, depth = args
        base = (stream_t, rays, a, blk)
        g = a.shape[0] // blk
        got = stream_walk.stream_walk(*args)
        if not _bits_same(got, stream_walk.stream_walk_stack_pr3(*base, any_hit, depth)):
            raise AssertionError(f"stack wave {wave} {kind}: the stack designs disagree")
        plain = ""
        if wave in PLAIN_WAVES:
            work = torch.zeros(g, 2, dtype=torch.int64, device=dev)
            want, p_ms = _time_once(lambda: stream_walk.stream_walk_plain(*args, work=work),
                                    dev)
            if not _bits_same(got, want):
                raise AssertionError(f"stack wave {wave} {kind}: the kernel differs from the "
                                     f"plain version")
            work = work.sum(0).tolist()
            bound_ms, bound_by = _bound(work[0] * SLAB_FLOPS + work[1] * MT_FLOPS,
                                        _nbytes(stream_t, rays, a, *got))
            plain = (f", plain {p_ms:.1f} ms (bit-identical), bound {bound_ms:.4f} ms "
                     f"({bound_by})")
        t = _in_turns({"pr3": lambda: stream_walk.stream_walk_stack_pr3(*base, any_hit, depth),
                       "new": lambda: stream_walk.stream_walk(*args)}, reps, dev)
        for k in total:
            total[k] += t[k]
        v = got[4][:, 0].float()
        say(f"[3j stack frame] wave {wave:2d} {kind:7s} width {a.shape[0]:6d} ({g} packets), "
            f"live {float(a.float().mean()):6.1%}, bit-identical to the first design, new "
            f"{t['new']:.4f} ms, first design {t['pr3']:.4f} ms ({t['pr3'] / t['new']:.2f}x); "
            f"visits mean {float(v.mean()):.1f} max {int(v.max())}{plain}")
    say(f"[3j stack frame] one spp's {len(waves)} walk calls: new {total['new']:.3f} ms, "
        f"first design {total['pr3']:.3f} ms ({total['pr3'] / total['new']:.2f}x)")
    if dev.type == "cuda":
        _walk_sass(say, ("stream_walk_stack_closest", "stream_walk_stack_any", *STACK_FIRST),
                   "3j stack frame")


def _inst_calls(dev: torch.device, w: int, h: int, n_inst: int = STRESS_N) -> list:
    """The inst_rows calls of one untimed w x h 1-spp twolevelp bench frame of
    the stress scene, in order: (wave, closest or any, its arguments),
    captured by a spy on instanced.inst_rows."""
    ps = compile_scene(builtin.make_instanced_stress_scene(n_inst), dev, two_level="pure")
    cfg = wi.RenderConfig.for_scene(ps, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    cam = CameraParams.from_camera(builtin.make_stress_camera(w, h, n_inst), dev)
    calls = _spy(instanced, "inst_rows", ps, cfg, cam, dev)
    for args, kw in calls:
        if kw or len(args) != 8:
            raise AssertionError(f"the twolevelp frame called inst_rows with {len(args)} {kw}")
    return _by_wave(calls, lambda args: args[7])


def phase_inst_frame(dev: torch.device, w: int = W, h: int = H, reps: int = 3) -> None:
    """Every inst_rows call of an untimed 1-spp stress32 twolevelp bench
    frame (64: 32 waves, closest and shadow rays): the live kernel
    bit-identical to its first design on every call and to the plain version
    on PLAIN_WAVES; the two timed in turns, with each call's width,
    live share, listed rows and bound, and the sums a spp."""
    waves = _inst_calls(dev, w, h)
    total = {"new": 0.0, "pr2": 0.0, "bound": 0.0}
    for wave, kind, args in waves:
        got = inst_rows.inst_rows(*args)
        if not _bits_same(got, inst_rows.inst_rows_first_design(*args)):
            raise AssertionError(f"twolevelp wave {wave} {kind}: the instanced designs "
                                 f"disagree")
        plain = ""
        if wave in PLAIN_WAVES:
            want, p_ms = _time_once(lambda: inst_rows.inst_rows_plain(*args), dev)
            if not _bits_same(got, want):
                raise AssertionError(f"twolevelp wave {wave} {kind}: the kernel differs from "
                                     f"the plain version")
            plain = f", plain {p_ms:.1f} ms (bit-identical)"
        t = _inst_turns(args, reps, dev)
        bound_ms, bound_by, tests, live = _inst_bound(*args[:6])
        for k in ("new", "pr2"):
            total[k] += t[k]
        total["bound"] += bound_ms
        counts = args[2]
        rows = torch.where(counts < 0, args[3][2][None, :], counts)
        say(f"[3k inst frame] wave {wave:2d} {kind:7s} width {args[5].shape[1]:6d}, live "
            f"{live:6.1%}, bit-identical to the first design, new {t['new']:.4f} ms, first "
            f"design {t['pr2']:.4f} ms ({t['pr2'] / t['new']:.2f}x), bound {bound_ms:.4f} ms "
            f"({bound_by}, {tests:.4g} tests), mean rows a packet "
            f"{float(rows.sum(1).float().mean()):.1f}{plain}")
    say(f"[3k inst frame] one spp's {len(waves)} inst_rows calls: new {total['new']:.3f} ms, "
        f"first design {total['pr2']:.3f} ms ({total['pr2'] / total['new']:.2f}x), bound "
        f"{total['bound']:.3f} ms")


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
        mine = {k: stream_walk.LAUNCHES[k]
                for k in (f"stream_walk_{walk}_closest", f"stream_walk_{walk}_any")}
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


DEFER_FRAMES = 4
DEFER_CAP = 8      # the facade's wave cap in phase 12
DRAINS = 8         # spp=0 frames allowed to empty the pool
DRAIN_MIN = 0.1    # stop draining once a drain retires less of the pool
DEFER_REL = 1e-4   # the deferred total's energy against the uncapped frames
UNCAPPED = 256     # the uncapped frames' wave cap


def _leaf_launches() -> dict:
    return {k: leaf_rows.LAUNCHES[k] for k in PAIR}


def _wall(fn, dev):
    """(result, wall seconds) of fn() ending in a sync."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def phase_defer(dev: torch.device, w: int = W, h: int = H) -> None:
    """Cross-frame deferral through the facade, and the other frame entry
    points, on the indoor scene (bitsru8, 2048-ray packets, compaction
    every 16 waves).  WavefrontRenderer(defer=True, wave_limit=8) renders
    DEFER_FRAMES 1-spp frames (each frame's survivors deferred, the pool's
    live count, dropped, wall time and leaf-row launches printed), then
    spp=0 frames drain the pool (at most DRAINS, and none after a drain
    that retires less than DRAIN_MIN of the pool's live paths: those left
    are trapped paths that each further drain's 64 full-width waves barely
    move): dropped must be 0 and the total's energy within DEFER_REL of
    the same frames at wave cap
    UNCAPPED without deferral (with the width ladder and Morton lanes,
    which change no lane's result); the same frames capped at 8 without
    deferral are printed beside it.  Then an instrumented frame at the
    bench knobs (waves, lane steps, occupancy, deferred), bit-identical to
    render_frame with compaction every wave, native lanes, no ladder; and a
    max_bounces=32 frame, which reads no live count, bit-identical to the
    unbounded frame capped at 32 waves.

    The facade takes JAX's arguments, which do not set the packet size or
    the compaction cadence, so the phase relies on three of its private
    attributes: it sets ``_rcfg`` (the RenderConfig) and reads ``_carry``
    (the FrameCarry) and ``_acc.buffer`` (the accumulated sums).  A rename
    in ``app/renderer.py`` must follow here (``test_torch_facade`` reads
    the same three)."""
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    camera = builtin.make_indoor_camera(w, h)
    cam = CameraParams.from_camera(camera, dev)
    knobs = dict(block_rays=BLOCK, compact=True, compact_every=BENCH_KNOBS["compact_every"])
    wf = WavefrontRenderer(scene, camera, RendererConfigHost(samples_per_frame=1), dev,
                           compact=True, defer=True, wave_limit=DEFER_CAP)
    # the facade takes JAX's arguments; the bench's packet size and cadence
    # are set on its config
    wf._rcfg = cfg = wf._rcfg._replace(**knobs)
    if cfg.algo != "bitsru8":
        raise AssertionError(f"the facade renders the indoor scene with {cfg.algo}")
    merged = []
    merge = wi._merge_deferred

    def spy(d, s, dropped):
        merged.append(int(s.alive.sum()))
        return merge(d, s, dropped)

    launches = Counter()
    with mock.patch.object(wi, "_merge_deferred", spy):
        for frame in range(DEFER_FRAMES):
            merged.clear()
            leaf_rows.reset_launches()
            _, dt = _wall(wf.render, dev)
            n_leaf = _leaf_launches()
            launches.update(n_leaf)
            carry = wf._carry
            say(f"[12 defer] frame {frame}: {sum(merged)} survivors deferred, pool live "
                f"{int(carry.deferred.alive.sum())}, dropped {int(carry.dropped)}, "
                f"{dt:.3f} s, leaf-row launches {n_leaf}")
    total = float(np.float64(wf._acc.buffer).sum())
    drain = cfg._replace(spp=0)
    zeros = torch.zeros(w * h, dtype=torch.int64, device=dev)
    carry = wf._carry
    for k in range(DRAINS):
        live = int(carry.deferred.alive.sum())
        if live == 0:
            break
        leaf_rows.reset_launches()
        (acc, _, carry), dt = _wall(
            lambda: wi.render_frame_carry(scene, drain, cam, zeros, carry), dev)
        launches.update(_leaf_launches())
        total += float(acc.double().sum())
        left = int(carry.deferred.alive.sum())
        say(f"[12 defer] drain {k}: pool live {live} -> {left}, {dt:.3f} s")
        if live - left < DRAIN_MIN * live:
            break
    dropped = int(carry.dropped)
    if dropped != 0:
        raise AssertionError(f"deferral dropped {dropped} paths")
    for name, n in launches.items():
        if n <= 0 and dev.type == "cuda":
            raise AssertionError(f"{name} was never launched by the deferral run")
    # the uncapped frames with the bench's lane knobs: the width ladder and
    # Morton lanes leave every lane's result as it is and make the long
    # tail of narrow waves cheap
    uncapped = cfg._replace(**BENCH_KNOBS)._replace(wave_limit=UNCAPPED)
    ref, capped, t_ref, t_cap = 0.0, 0.0, 0.0, 0.0
    for frame in range(DEFER_FRAMES):
        img, dt = _wall(lambda: wi.render_frame(scene, uncapped, cam, frame, dev), dev)
        ref += float(img.double().sum())
        t_ref += dt
        img, dt = _wall(lambda: wi.render_frame(scene, cfg, cam, frame, dev), dev)
        capped += float(img.double().sum())
        t_cap += dt
    rel = (total - ref) / ref
    say(f"[12 defer] {DEFER_FRAMES} frames: deferred and drained energy {total!r}, uncapped "
        f"(wave cap {UNCAPPED}) {ref!r} ({t_ref:.3f} s), rel {rel:+.3e}; capped at "
        f"{DEFER_CAP} without deferral {capped!r} ({t_cap:.3f} s), bias "
        f"{(capped - ref) / ref:+.4%}; pool left {int(carry.deferred.alive.sum())}; "
        f"leaf-row launches {dict(launches)}")
    if not abs(rel) <= DEFER_REL:
        raise AssertionError(f"deferred energy {total} vs uncapped {ref}: rel {rel:+.3e}")

    bench = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    (img, st), dt = _wall(lambda: wi.render_frame_instrumented(scene, bench, cam, 0, dev), dev)
    plain, dt_plain = _wall(lambda: wi.render_frame(
        scene, bench._replace(compact_every=1, ladder=0, pixel_order="native"), cam, 0, dev),
        dev)
    if not torch.equal(img, plain):
        raise AssertionError("the instrumented frame differs from render_frame")
    say(f"[12 defer] instrumented frame at the bench knobs: waves {st['waves']}, lane steps "
        f"{st['lane_steps']}, occupancy {st['occupancy']!r}, deferred {st['deferred']}, "
        f"{dt:.3f} s; bit-identical to render_frame (compaction every wave, native lanes, "
        f"no ladder, {dt_plain:.3f} s)")

    cap = BENCH_KNOBS["wave_limit"]
    unbounded, dt_u = _wall(lambda: wi.render_frame(
        scene, bench._replace(ladder=0, wave_limit=cap), cam, 0, dev), dev)
    with mock.patch.object(wi, "_run_waves", None):  # the loop that reads live counts
        bounded, dt_b = _wall(lambda: wi.render_frame(
            scene, bench._replace(ladder=0, max_bounces=cap), cam, 0, dev), dev)
    if not torch.equal(bounded, unbounded):
        raise AssertionError(f"the max_bounces={cap} frame differs from the frame capped at "
                             f"{cap} waves")
    say(f"[12 defer] max_bounces={cap} frame {dt_b:.3f} s (no live count read), bit-identical "
        f"to the unbounded frame capped at {cap} waves {dt_u:.3f} s; energy "
        f"{_check_image(bounded, 'bounded', 1)!r}")


GRAD_BOUNCES = 12  # phase 13's static wave count (the ladder is off)
GRAD_REL = 1e-5  # a gradient against another run's, of the leaf's max |g| (atomics' order)
GRAD_FD_H = 4e-3  # tests/test_grads.py:187's step
GRAD_FD_REL = 1e-3  # ... and its gate on |FD - AD| / |AD|
GRAD_FREE_LEFT = 3.5 * 2**30  # the card's memory left free in the checkpointed cell


def _peak_gib(dev) -> float:
    return torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _check_grads(loss, grads, n_leaf, dev, label: str) -> None:
    """Each leaf-row entry point launched, the loss and every gradient
    leaf finite."""
    for name, n in n_leaf.items():
        if n <= 0 and dev.type == "cuda":
            raise AssertionError(f"{name} was never launched by the {label} gradient step")
    for f, g in zip(("albedo", "emission_color", "emission_strength", "absorption",
                     *(f"camera.{c}" for c in CameraParams._fields)), tree_flatten(grads)[0]):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: the gradient of {f} is not finite")
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"{label}: the loss {float(loss)} is not finite")


def _grad_step(scene, cfg, targets, dev, label: str):
    """One grad_image_loss call: (loss, grads, wall s, peak GiB, leaf-row
    launches); the gradients must be finite."""
    _reset_peak(dev)
    leaf_rows.reset_launches()
    (loss, grads), dt = _wall(lambda: grad_image_loss(scene, cfg, targets, 0, dev), dev)
    peak, n_leaf = _peak_gib(dev), _leaf_launches()
    _check_grads(loss, grads, n_leaf, dev, label)
    return loss, grads, dt, peak, n_leaf


def _split_step(scene, cfg, targets, dev, label: str):
    """grad_image_loss's two halves, each timed: image_loss on copies of
    the leaves that require grad (the forward, recording autograd's tape),
    then torch.autograd.grad (the backward).  Returns (loss, grads, forward
    s, backward s, peak GiB, leaf-row launches); the gradients must be
    finite."""
    leaves, unflatten = tree_flatten(targets)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    _reset_peak(dev)
    leaf_rows.reset_launches()
    loss, t_f = _wall(lambda: image_loss(scene, cfg, unflatten(leaves), 0, dev), dev)
    grads, t_b = _wall(lambda: torch.autograd.grad(loss, leaves, allow_unused=True), dev)
    grads = unflatten([torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)])
    peak, n_leaf = _peak_gib(dev), _leaf_launches()
    loss = loss.detach()
    _check_grads(loss, grads, n_leaf, dev, label)
    return loss, grads, t_f, t_b, peak, n_leaf


def _grads_close(grads, ref, label: str) -> float:
    """The largest difference of a gradient leaf from ref's, relative to
    that leaf's max |g|; raises above GRAD_REL."""
    worst = 0.0
    for k, (g, r) in enumerate(zip(tree_flatten(grads)[0], tree_flatten(ref)[0])):
        scale = float(r.abs().max())
        err = float((g - r).abs().max())
        if not err <= GRAD_REL * scale:
            raise AssertionError(f"{label}: gradient leaf {k} differs by {err} (max |g| {scale})")
        worst = max(worst, err / scale if scale > 0 else 0.0)
    return worst


@contextlib.contextmanager
def _ballast(dev):
    """Hold all of the card's memory but GRAD_FREE_LEFT (what the rest of
    a trainer's process would hold: its data, its other models); yields
    the bytes held.  Off the card the integrator is told that nothing is
    free instead."""
    if dev.type != "cuda":
        with mock.patch.object(wi, "_free_bytes", lambda device: 0):
            yield 0
        return
    torch.cuda.empty_cache()
    n = int(wi._free_bytes(dev) - GRAD_FREE_LEFT)
    block = torch.empty(n, dtype=torch.uint8, device=dev)
    try:
        yield n
    finally:
        del block
        torch.cuda.empty_cache()


def phase_grad(dev: torch.device, w: int = W, h: int = H) -> None:
    """A trainer's step through the differentiable estimator
    (surf_tpu_torch.diff) on the indoor scene at w x h, 1 spp,
    use_defocus, the bench's packet knobs (bitsru8, 2048-ray packets,
    compaction every 16 waves, Morton lanes) and max_bounces=GRAD_BOUNCES
    (the ladder off).  (a) The forward alone under no_grad, timed.  A
    first grad_image_loss call (every DiffTargets leaf finite).  (b) Its
    two halves timed apart, image_loss (the forward with autograd's tape)
    and torch.autograd.grad (the backward), their ratio, peak memory and
    the leaf-row launches (counted from 0 around the step): the loss
    bit-equal to the first call's, the gradients within GRAD_REL of it
    (the backward's index_add_ are atomics on the card), the albedo
    gradient nonzero, and the launches the forward's (no wave
    checkpointed with the card's memory free).  (c) The same with all but
    GRAD_FREE_LEFT of the card's memory held: the integrator checkpoints
    the waves after the first (more launches: the backward runs them
    again), the loss bit-equal and the gradients within GRAD_REL of (b)'s.
    (d) rr=False: AD of the largest albedo entry against the central
    difference at h=GRAD_FD_H of the loss reduced in float64, relative
    error under GRAD_FD_REL.  (e) Under torch.use_deterministic_algorithms:
    two grad_image_loss calls, bit-equal to each other and within GRAD_REL
    of (b)'s.  Every timing line names the card."""
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(
        **BENCH_KNOBS)._replace(max_bounces=GRAD_BOUNCES)
    if cfg.algo != "bitsru8":
        raise AssertionError(f"the gradient step renders the indoor scene with {cfg.algo}")
    targets = DiffTargets.from_scene(scene, cam)
    card = CARD["smi"]

    with torch.no_grad():
        render_image_diff(scene, cfg, targets, 0, dev)  # warm-up: allocator, first launches
        _reset_peak(dev)
        leaf_rows.reset_launches()
        img, t_fwd = _wall(lambda: render_image_diff(scene, cfg, targets, 0, dev), dev)
    fwd_peak, fwd_leaf = _peak_gib(dev), _leaf_launches()
    _check_image(img, "grad forward", 1)
    say(f"[13 grad] {w}x{h} @ 1 spp, max_bounces {GRAD_BOUNCES}, bitsru8: forward alone "
        f"(no_grad) {t_fwd:.3f} s, peak memory {fwd_peak:.2f} GiB, leaf-row launches "
        f"{fwd_leaf} ({card})")

    loss0, grads0, t_first, _, _ = _grad_step(scene, cfg, targets, dev, "first")
    loss, grads, t_f, t_b, peak, n_leaf = _split_step(scene, cfg, targets, dev, "plain")
    if not torch.equal(loss, loss0):
        raise AssertionError(f"the split step's loss {float(loss)!r} differs from "
                             f"grad_image_loss's {float(loss0)!r}")
    worst0 = _grads_close(grads, grads0, "the split step against grad_image_loss")
    if not float(grads.albedo.abs().sum()) > 0:
        raise AssertionError("the albedo gradient is zero")
    if n_leaf != fwd_leaf:
        raise AssertionError(f"the gradient step launched {n_leaf}, the forward {fwd_leaf}: "
                             "a wave was checkpointed with the card's memory free")
    say(f"[13 grad] gradient step: loss {float(loss)!r}, forward with tape {t_f:.3f} s, "
        f"backward {t_b:.3f} s, backward/forward {t_b / t_f:.3f}, peak memory {peak:.2f} GiB, "
        f"leaf-row launches {n_leaf}, free {wi._free_bytes(dev) / 2**30:.2f} GiB; "
        f"grad_image_loss's first call {t_first:.3f} s, within {worst0:.3e} ({card})")

    ckpt, ckpt_dt = torch.utils.checkpoint.checkpoint, []

    def timed_checkpoint(*args, **kw):  # the first call imports torch._dynamo
        if not ckpt_dt:
            t0 = time.perf_counter()
            out = ckpt(*args, **kw)
            ckpt_dt.append(time.perf_counter() - t0)
            return out
        return ckpt(*args, **kw)

    with _ballast(dev) as held, \
            mock.patch.object(torch.utils.checkpoint, "checkpoint", timed_checkpoint):
        free = wi._free_bytes(dev)
        _split_step(scene, cfg, targets, dev, "first checkpointed")
        loss_r, grads_r, t_fr, t_br, peak_r, n_leaf_r = _split_step(
            scene, cfg, targets, dev, "checkpointed")
    peak_r -= held / 2**30
    if dev.type == "cuda" and not all(n_leaf_r[k] > n_leaf[k] for k in n_leaf):
        raise AssertionError(f"with {free / 2**30:.2f} GiB free the step launched "
                             f"{n_leaf_r}, as many as with the card free: no wave was "
                             "checkpointed")
    if not torch.equal(loss_r, loss):
        raise AssertionError(f"the checkpointed loss {float(loss_r)!r} differs from "
                             f"{float(loss)!r}")
    worst = _grads_close(grads_r, grads, "checkpointed")
    say(f"[13 grad] {free / 2**30:.2f} GiB free (the rest held): waves checkpointed, forward "
        f"with tape {t_fr:.3f} s, backward {t_br:.3f} s, backward/forward {t_br / t_fr:.3f}, "
        f"peak memory {peak_r:.2f} GiB beside what is held, leaf-row launches {n_leaf_r}; "
        f"the first checkpoint {ckpt_dt[0]:.3f} s (imports torch._dynamo); loss bit-equal, "
        f"gradients within {worst:.3e} of each leaf's max |g| ({card})")

    cfg_n = cfg._replace(rr=False)
    (_, grads_n), t_n = _wall(lambda: grad_image_loss(scene, cfg_n, targets, 0, dev), dev)
    ga = grads_n.albedo.double().cpu().numpy()
    e = np.unravel_index(int(np.argmax(np.abs(ga))), ga.shape)
    ad = float(ga[e])

    def f(t):
        return image_loss(scene, cfg_n, t, 0, dev, loss_fn=lambda im: im.double().mean())

    with torch.no_grad():
        fd, t_fd = _wall(lambda: finite_difference(f, targets, GRAD_FD_H, [(0, e)]), dev)
    fd = float(fd.albedo[e])
    rel = abs(fd - ad) / abs(ad)
    say(f"[13 grad] rr=False: d loss / d albedo{tuple(int(i) for i in e)} AD {ad!r} "
        f"({t_n:.3f} s), central difference at h={GRAD_FD_H} {fd!r} ({t_fd:.3f} s for 2 "
        f"frames), relative error {rel:.3e} (gate {GRAD_FD_REL}) ({card})")
    if not rel < GRAD_FD_REL:
        raise AssertionError(f"AD {ad} against FD {fd}: relative error {rel:.3e}")

    torch.use_deterministic_algorithms(True)
    try:
        runs = [_grad_step(scene, cfg, targets, dev, f"deterministic {k}") for k in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    (loss_d, grads_d, t_d0, _, _), (loss_d1, grads_d1, t_d1, _, _) = runs
    if not (torch.equal(loss_d, loss_d1) and all(
            torch.equal(a, b) for a, b in zip(tree_flatten(grads_d)[0],
                                              tree_flatten(grads_d1)[0]))):
        raise AssertionError("two deterministic gradient steps differ")
    if not torch.equal(loss_d, loss):
        raise AssertionError(f"the deterministic loss {float(loss_d)!r} differs from "
                             f"{float(loss)!r}")
    worst_d = _grads_close(grads_d, grads, "deterministic")
    say(f"[13 grad] torch.use_deterministic_algorithms(True): grad_image_loss {t_d0:.3f} s, "
        f"{t_d1:.3f} s, bit-equal to each other, within {worst_d:.3e} of the step's "
        f"gradients ({card})")


ANIM_STEPS = 3
ANIM_DT = 0.3
ANIM_GATE = (0.02, 0.01)      # tests/test_animation.py:30-33: pixels off, energy
TWOLEVEL_GATE = (0.01, 0.005)  # tests/test_instanced.py:163-166
PARITY_SIZE = 64


def _gate(ref, img, gate, what: str) -> str:
    """Under gate[0] of the pixels off by more than 1e-3 and the energy
    within gate[1]."""
    off, rel_e, msg = _pixel_stats(ref, img)
    if not (off < gate[0] and rel_e < gate[1]):
        raise AssertionError(f"{what}: {msg}")
    return msg


def _frame(scene, cfg, cam, dev):
    """One bench frame (total_samples 0): (image, wall s, launches of the
    leaf-row and instanced kernels counted from 0)."""
    leaf_rows.reset_launches()
    inst_rows.reset_launches()
    img, dt = _wall(lambda: _render(scene, cfg, cam, dev, 0, 1), dev)
    counts = Counter({**_leaf_launches(),
                      **{k: inst_rows.LAUNCHES[k] for k in inst_rows.FIRST_DESIGNS}})
    return img, dt, +counts


def _timed_update(host, dev, rebuild: bool):
    """host.update(ANIM_DT, rebuild) ending in a sync: (wall s, the part
    spent uploading)."""
    spent = [0.0]

    def timing(fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            _sync(dev)
            spent[0] += time.perf_counter() - t0
            return out
        return run

    with mock.patch.object(host, "_put", timing(host._put)), \
            mock.patch.object(sc, "from_render_scene", timing(sc.from_render_scene)):
        _, dt = _wall(lambda: host.update(ANIM_DT, rebuild=rebuild), dev)
    return dt, spent[0]


def _need(counts, names, what, dev) -> None:
    for name in names:
        if counts[name] <= 0 and dev.type == "cuda":
            raise AssertionError(f"{name} was never launched by the {what}")


def phase_animate(dev: torch.device, w: int = W, h: int = H) -> Counter:
    """Phase 14 (see the module docstring); returns the launches of the
    main-path frames."""
    card = CARD["smi"]
    launches = Counter()
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)
    hosts = {rebuild: HostCompiled(builtin.make_indoor_scene(), dev) for rebuild in (False, True)}
    cfg = wi.RenderConfig.for_scene(hosts[False].scene, w, h, 1, use_defocus=True)._replace(
        **BENCH_KNOBS)
    _render(hosts[False].scene, cfg, cam, dev, 0, 1)  # warm-up
    for step in range(ANIM_STEPS):
        imgs = {}
        for rebuild, host in hosts.items():
            dt_u, dt_up = _timed_update(host, dev, rebuild)
            imgs[rebuild], dt_f, n = _frame(host.scene, cfg, cam, dev)
            _check_image(imgs[rebuild], "animated", 1)
            _need(n, PAIR, "animated frame", dev)
            launches.update(n)
            say(f"[14 animate] step {step} {'rebuild' if rebuild else 'refit'}: update "
                f"{dt_u * 1e3:.1f} ms (uploads {dt_up * 1e3:.1f} ms), {w}x{h} @ 1 spp frame "
                f"{dt_f:.3f} s, leaf-row launches {dict(n)} ({card})")
        say(f"[14 animate] step {step} refit vs rebuild: "
            f"{_gate(imgs[True], imgs[False], ANIM_GATE, f'refit frame, step {step}')}")
    fresh = builtin.make_indoor_scene()
    for _ in range(ANIM_STEPS):
        fresh.update(ANIM_DT)
    img = _render(compile_scene(fresh, dev), cfg, cam, dev, 0, 1)
    if not torch.equal(img, imgs[True]):
        raise AssertionError("the rebuilt frame differs from a fresh compile's of the scene")
    say(f"[14 animate] the rebuilt frame is bit-equal to a fresh compile's; caps "
        f"{hosts[True]._caps}")
    pw = PARITY_SIZE
    pcfg = wi.RenderConfig.for_scene(hosts[False].scene, pw, pw, 2, use_defocus=True)._replace(
        **BENCH_KNOBS)
    pcam = CameraParams.from_camera(builtin.make_indoor_camera(pw, pw), dev)
    img_k = _render(hosts[False].scene, pcfg, pcam, dev, 0, 1)
    with mock.patch.object(bits, "leaf_rows", leaf_rows.leaf_rows_plain):
        img_p = _render(hosts[False].scene, pcfg, pcam, dev, 0, 1)
    say(f"[14 animate] refit scene {pw}x{pw} @ 2 spp, kernel vs plain: "
        f"{_parity(img_k, img_p, 'refit leaf-row kernel render', 0.01, 0.03)}")

    hybrids = [("indoor", HostCompiled(builtin.make_indoor_scene(), dev, two_level=True),
                builtin.make_indoor_camera),
               ("stress32", HostCompiled(builtin.make_instanced_stress_scene(STRESS_N), dev,
                                         two_level=True),
                lambda a, b: builtin.make_stress_camera(a, b, STRESS_N))]
    hybrids.append(("indoor rebuilt", hybrids[0][1], builtin.make_indoor_camera))
    for label, host, make_cam in hybrids:
        if label == "indoor rebuilt":
            host.update(ANIM_DT, rebuild=True)
        hcam = CameraParams.from_camera(make_cam(w, h), dev)
        frames = {}
        for algo in ("twolevel", "bitsru8"):
            hcfg = wi.RenderConfig.for_scene(host.scene, w, h, 1, use_defocus=True)._replace(
                **BENCH_KNOBS, algo=algo)
            _render(host.scene, hcfg, hcam, dev, 0, 1)  # warm-up
            frames[algo] = _frame(host.scene, hcfg, hcam, dev)
        (img_t, dt_t, n_t), (img_f, dt_f, _) = frames["twolevel"], frames["bitsru8"]
        _check_image(img_t, f"{label} twolevel", 1)
        _need(n_t, inst_rows.FIRST_DESIGNS, f"{label} twolevel frame", dev)
        launches.update(n_t)
        say(f"[14 twolevel] {label} {w}x{h} @ 1 spp: twolevel frame {dt_t:.3f} s, inst_rows "
            f"launches {dict(n_t)}; flattened bitsru8 frame {dt_f:.3f} s ({card}); twolevel vs "
            f"bitsru8: {_gate(img_f, img_t, TWOLEVEL_GATE, f'{label} twolevel frame')}")
    stress = hybrids[1][1].scene
    scfg = wi.RenderConfig.for_scene(stress, pw, pw, 2, use_defocus=True)._replace(
        **BENCH_KNOBS, algo="twolevel")
    scam = CameraParams.from_camera(builtin.make_stress_camera(pw, pw, STRESS_N), dev)
    img_k = _render(stress, scfg, scam, dev, 0, 1)
    with mock.patch.object(instanced, "inst_rows", inst_rows.inst_rows_plain):
        img_p = _render(stress, scfg, scam, dev, 0, 1)
    say(f"[14 twolevel] stress32 {pw}x{pw} @ 2 spp, kernel vs plain: "
        f"{_parity(img_k, img_p, 'twolevel instanced kernel render', 0.01, 0.03)}")

    moved = tf.translate(tf.identity(), [0.6, 0.2, 0.0])
    pure = HostCompiled(builtin.make_instanced_stress_scene(STRESS_N), dev, two_level="pure")
    pure.host_scene.instances[1].set_transform(moved)
    _, dt_r = _wall(pure.refresh, dev)
    fresh = builtin.make_instanced_stress_scene(STRESS_N)
    fresh.instances[1].set_transform(moved)
    scam = CameraParams.from_camera(builtin.make_stress_camera(w, h, STRESS_N), dev)
    pcfg = wi.RenderConfig.for_scene(pure.scene, w, h, 1, use_defocus=True)._replace(**BENCH_KNOBS)
    img_r = _render(pure.scene, pcfg, scam, dev, 0, 1)
    img_f = _render(compile_scene(fresh, dev, two_level="pure"), pcfg, scam, dev, 0, 1)
    _check_image(img_r, "refreshed pure", 1)
    if not torch.equal(img_r, img_f):
        raise AssertionError("the refreshed pure frame differs from a fresh pure compile's")
    say(f"[14 pure] stress32 instance 1 moved: refresh {dt_r * 1e3:.1f} ms ({card}), the frame "
        f"bit-equal to a fresh pure compile's")
    return launches


DIST_RANKS = 2        # phase 15b: ranks sharing the card over gloo
DIST_DEADLINE = 300   # seconds for 15b's spawned ranks, start-up included
DIST_ATOL = 1e-5      # tests/test_sharding.py:44
DIST_GRAD = (1e-5, 1e-4, 1e-6)  # tests/test_sharding.py:60-62: loss rtol, leaf rtol, atol
CLI_FRAMES = 2


def _dist_setup(dev, w, h):
    """Phase 15's indoor scene, config (1 spp, the bench knobs, native
    lanes: the sharded path renders native lanes) and camera."""
    scene = compile_scene(builtin.make_indoor_scene(), dev)
    cfg = wi.RenderConfig.for_scene(scene, w, h, 1, use_defocus=True)._replace(
        **BENCH_KNOBS)._replace(pixel_order="native")
    return scene, cfg, CameraParams.from_camera(builtin.make_indoor_camera(w, h), dev)


def _launched(fn, dev):
    """(fn(), wall s, leaf-row launches counted from 0 around it)."""
    leaf_rows.reset_launches()
    out, dt = _wall(fn, dev)
    return out, dt, _leaf_launches()


def _image_gate(ref, img, what: str) -> str:
    """tests/test_sharding.py:44's gate, exact equality reported."""
    err = float((ref - img).abs().max())
    if not err <= DIST_ATOL:
        raise AssertionError(f"{what}: max |d| {err} against the single-device frame")
    return f"max |d| {err}, bit-identical {bool(torch.equal(ref, img))}"


def _grad_gate(loss, grads, ref_loss, ref_grads, what: str) -> str:
    """tests/test_sharding.py:60-62's bounds on the loss and every leaf."""
    rtol_loss, rtol, atol = DIST_GRAD
    if not np.isclose(float(loss), float(ref_loss), rtol=rtol_loss):
        raise AssertionError(f"{what}: loss {float(loss)!r} against {float(ref_loss)!r}")
    worst = 0.0
    for k, (g, r) in enumerate(zip(grads, tree_flatten(ref_grads)[0])):
        g = g.to(r.device)
        if not torch.allclose(g, r, rtol=rtol, atol=atol):
            raise AssertionError(f"{what}: gradient leaf {k} off by "
                                 f"{float((g - r).abs().max())}")
        worst = max(worst, float(((g - r).abs() / (atol + rtol * r.abs())).max()))
    return (f"loss {float(loss)!r} (single {float(ref_loss)!r}), every leaf within "
            f"{worst:.3f} of its bound")


def _dist_rank(device: str, w: int, h: int) -> dict:
    """Phase 15b's rank body (a spawned process in a gloo group): on this
    rank's half of the lanes, the sharded frame and the sharded gradient
    step, each after a warm-up call and with its wall and leaf-row
    launches."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    scene, cfg, cam = _dist_setup(dev, w, h)
    mesh = make_mesh(dev)
    render_frame_sharded(scene, cfg, cam, 0, mesh)  # warm-up
    img, dt, n = _launched(lambda: render_frame_sharded(scene, cfg, cam, 0, mesh), dev)
    gcfg = cfg._replace(max_bounces=GRAD_BOUNCES)
    targets = DiffTargets.from_scene(scene, cam)
    grad_step_sharded(scene, gcfg, targets, 0, mesh)  # warm-up
    (loss, grads), dt_g, n_g = _launched(
        lambda: grad_step_sharded(scene, gcfg, targets, 0, mesh), dev)
    return {"image": img.cpu(), "frame_s": dt, "launches": n, "lanes": mesh.lanes(w * h),
            "backend": dist.get_backend(), "loss": loss.cpu(), "grad_s": dt_g,
            "grads": [g.cpu() for g in tree_flatten(grads)[0]], "grad_launches": n_g}


def phase_dist(dev: torch.device, w: int = W, h: int = H) -> Counter:
    """Phase 15 (see the module docstring); returns the leaf-row launches
    of the sharded entry points (in this process and in 15b's ranks)."""
    card = CARD["smi"]
    launches = Counter()
    if init_multihost(device=dev.type) != dev:
        raise AssertionError(f"init_multihost did not give this rank {dev}")
    try:
        mesh = make_mesh(dev)
        scene, cfg, cam = _dist_setup(dev, w, h)
        ref, dt_ref, n_ref = _launched(lambda: wi.render_frame(scene, cfg, cam, 0, dev), dev)
        img, dt, n = _launched(lambda: render_frame_sharded(scene, cfg, cam, 0, mesh), dev)
        _need(n, PAIR, "sharded frame", dev)
        if not torch.equal(img, ref) or n != n_ref:
            raise AssertionError(f"the sharded frame ({n}) differs from render_frame's "
                                 f"({n_ref}): {_image_gate(ref, img, 'sharded frame')}")
        launches.update(n)
        say(f"[15 dist] {dist.get_backend()} world of {dist.get_world_size()}, mesh "
            f"{mesh.shape}: {w}x{h} @ 1 spp sharded frame {dt:.3f} s, leaf-row launches "
            f"{dict(n)}, bit-identical to render_frame ({dt_ref:.3f} s) ({card})")

        host = HostCompiled(builtin.make_indoor_scene(), dev)
        sess = ShardedSession(host.scene, cfg, mesh)
        frames = []
        for k, total in enumerate((0, 1, 0)):
            if k == 2:
                host.update(ANIM_DT)
                sess.update_scene(host.scene)
            img_s, dt_s, n_s = _launched(lambda: sess.render(cam, total), dev)
            _need(n_s, PAIR, "session frame", dev)
            if not torch.equal(img_s, wi.render_frame(host.scene, cfg, cam, total, dev)):
                raise AssertionError(f"session frame {k} differs from render_frame's")
            launches.update(n_s)
            frames.append(img_s)
            say(f"[15 dist] ShardedSession frame {k} (total_samples {total}"
                f"{', after update' if k == 2 else ''}): {dt_s:.3f} s, bit-identical to "
                f"render_frame ({card})")
        if torch.equal(frames[0], frames[1]) or torch.equal(frames[0], frames[2]):
            raise AssertionError("two session frames are equal")

        gcfg = cfg._replace(max_bounces=GRAD_BOUNCES)
        targets = DiffTargets.from_scene(scene, cam)
        (loss1, grads1), dt_1 = _wall(lambda: grad_image_loss(scene, gcfg, targets, 0, dev),
                                      dev)
        single = (loss1, grads1)
        (loss, grads), dt_g, n_g = _launched(
            lambda: grad_step_sharded(scene, gcfg, targets, 0, mesh), dev)
        _need(n_g, PAIR, "sharded gradient step", dev)
        launches.update(n_g)
        say(f"[15 dist] grad_step_sharded max_bounces {GRAD_BOUNCES}: {dt_g:.3f} s, leaf-row "
            f"launches {dict(n_g)}; grad_image_loss {dt_1:.3f} s; "
            f"{_grad_gate(loss, tree_flatten(grads)[0], loss1, grads1, 'sharded step')} "
            f"({card})")

        sweep = scaling_sweep(scene, cfg, cam, (1,), repeats=2)
        if set(sweep) != {1} or not sweep[1] > 0:
            raise AssertionError(f"scaling_sweep gave {sweep}")
        say(f"[15 dist] scaling_sweep {sweep} s ({card})")

        outs = {}
        with tempfile.TemporaryDirectory() as tmp:
            for shard in (True, False):
                out, log = f"{tmp}/{shard}.npy", f"{tmp}/{shard}.jsonl"
                args = ["--device", dev.type, "--scene", "indoor", "--width", str(w),
                        "--height", str(h), "--spp", "1", "--frames", str(CLI_FRAMES),
                        "--animate", *(["--shard"] if shard else [])]
                rc, dt_c, n_c = _launched(
                    lambda: cli.main([*args, "--output", out, "--metrics-jsonl", log]), dev)
                if rc != 0:
                    raise AssertionError(f"the CLI {args} returned {rc}")
                _need(n_c, PAIR, "CLI run", dev)
                if shard:
                    launches.update(n_c)
                outs[shard] = np.load(out)
                with open(log) as fh:
                    frame_s = [json.loads(ln)["frame_time_s"] for ln in fh]
                say(f"[15 cli] {' '.join(args)}: {dt_c:.3f} s (scene build included), frame "
                    f"times {frame_s} s, leaf-row launches {dict(n_c)} ({card})")
        if not np.array_equal(outs[True], outs[False]):
            raise AssertionError("the CLI's image with --shard differs from the one without")
        say("[15 cli] the --shard image equals the unsharded one")
    finally:
        dist.destroy_process_group()

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_local_ranks(_dist_rank, DIST_RANKS, tmp, DIST_DEADLINE, device=str(dev),
                                w=w, h=h)
    for r, out in enumerate(ranks):
        for what, n_r in (("frame", out["launches"]), ("gradient step", out["grad_launches"])):
            _need(n_r, PAIR, f"rank {r}'s sharded {what}", dev)
            launches.update(n_r)
        say(f"[15 dist] rank {r} of {DIST_RANKS} ({out['backend']}, {dev}, lanes "
            f"{out['lanes']}): frame {out['frame_s']:.3f} s, leaf-row launches "
            f"{dict(out['launches'])}, {_image_gate(ref.cpu(), out['image'], f'rank {r}')}; "
            f"gradient step {out['grad_s']:.3f} s, leaf-row launches "
            f"{dict(out['grad_launches'])}, "
            f"{_grad_gate(out['loss'], out['grads'], *single, f'rank {r} step')} ({card})")
    return launches


KERNELS = {
    "leaf_rows_closest": ("surf_tpu_torch/csrc/leaf_rows.cu", "surf_tpu/accel/pallas_wide.py:1287"),
    "leaf_rows_any": ("surf_tpu_torch/csrc/leaf_rows.cu", "surf_tpu/accel/pallas_wide.py:1287"),
    **{name: ("surf_tpu_torch/csrc/leaf_rows.cu", "surf_tpu/accel/pallas_wide.py:1287")
       for name in (*VARIANTS, *VARIANT_FIRST)},
    **{name: ("surf_tpu_torch/csrc/inst_rows.cu", "surf_tpu/accel/pallas_instanced.py:260")
       for name in (*inst_rows.FIRST_DESIGNS, *INST_FIRST)},
    **{f"stream_walk_skip_{m}": ("surf_tpu_torch/csrc/stream_walk.cu",
                                 "surf_tpu/accel/pallas_wide.py:862")
       for m in ("closest", "any")},
    # the stack walk (_walk_block_stack, pallas_wide.py:672) and its first
    # design, the yardstick
    **{f"stream_walk_stack_{m}": ("surf_tpu_torch/csrc/stream_walk_stack.cu",
                                  "surf_tpu/accel/pallas_wide.py:672") for m in ("closest", "any")},
    **{name: ("surf_tpu_torch/csrc/stream_walk.cu", "surf_tpu/accel/pallas_wide.py:672")
       for name in STACK_FIRST},
    # the binary walk and its first design, the yardstick
    **{name: ("surf_tpu_torch/csrc/bvh_walk_live.cu", "surf_tpu/accel/pallas_traverse.py:193")
       for name in bvh_walk.ENTRY_POINTS},
    **{name: ("surf_tpu_torch/csrc/bvh_walk.cu", "surf_tpu/accel/pallas_traverse.py:193")
       for name in BVH_FIRST},
    # ilv serves skip2 (_walk_block_pair, pallas_wide.py:314) as ilv2, and
    # skip (_walk_block, :120) as ilv1; stream_walk_skip_* are its first
    # design, the yardstick
    **{f"stream_walk_ilv_{m}": ("surf_tpu_torch/csrc/stream_walk_ilv.cu",
                                "surf_tpu/accel/pallas_wide.py:264") for m in ("closest", "any")},
    **{f"stream_walk_{a}_{m}": ("surf_tpu_torch/csrc/stream_walk_spec.cu",
                                f"surf_tpu/accel/pallas_wide.py:{line}")
       for a, line in (("spec", 339), ("specb", 514)) for m in ("closest", "any")},
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
    timed("3i bf16 frame", phase_bf16_frame, dev)
    timed("3m f32 frames", phase_f32_frames, dev)
    timed("3j stack frame", phase_stack_frame, dev)
    timed("3k inst frame", phase_inst_frame, dev)
    timed("3l binary frame", phase_bvh_frame, dev)
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
    waves = timed("3g capture", _walk_waves, compile_scene(builtin.make_indoor_scene(), dev),
                  dev, W, H, "ilv2")
    works = timed("3g ilv frame", phase_ilv_frame, dev, waves)
    timed("3h spec frame", phase_spec_frame, dev, waves, works)
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
    timed("12 defer", phase_defer, dev)
    timed("13 grad", phase_grad, dev)
    for name, n in timed("14 animate / twolevel", phase_animate, dev).items():
        launches[name] += n
    for name, n in timed("15 dist / cli", phase_dist, dev).items():
        launches[name] += n
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

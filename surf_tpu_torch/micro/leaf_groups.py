"""The leaf-group microbenchmarks: the card's version of
``scripts/tpu_leaf_variants_micro.py`` (``make_kernel``, its
``pl.pallas_call`` at ``:157``) and of ``scripts/tpu_leaf_kernel_micro.py``
(its call at ``:69``).

Sixteen packets of 1024 rays each get a list of CAP8 groups of 8 leaf-row
ids (``arange(CAP8 * 8) % n_rows`` of the indoor scene's leaf table); a
packet tests min(count, cap8) groups, rows in list order and records
0..7 within a row, and keeps the strictly closest hit, its record id
``row * 8 + j``.  The scripts time two trip counts (32 and 256 groups a
packet) and take the slope, in ns per group and per row.  Four variants
take a group's cost apart:

- ``full``: the Möller–Trumbore test (``:81-86``: |a| >= eps, u in [0, 1],
  v >= 0, u + v <= 1, eps <= t < best_t);
- ``nodiv``: f = a in place of 1 / a (wrong on purpose: the division);
- ``noext``: every list entry tests row 0's records, fetched once, its own
  row id kept in the record id (the row fetch and staging);
- ``halftri``: list entries 0-3 of each group, all 8 records of each.  The
  script's docstring says "4 of 8 tris per row"; its code (``:46-47``)
  loops over the group's list entries, and the port follows the code.

``tpu_leaf_kernel_micro.py`` times ``pallas_wide._leaf_list_kernel``, which
the JAX package no longer has; that kernel was line for line
``make_kernel("full")``, so ``full`` serves both scripts.

On the TPU the 16 packets ran one after another on one core; on the card
their 64 blocks (256 rays each) run at once, one an SM.  So ``measure``
prints the script's slope (the run's time over all packets' groups) and
also that slope times the blocks in flight: what one SM pays for a group
of 1024 rays, the TPU core's unit.  Run on the card:

    python -m surf_tpu_torch.micro.leaf_groups

(``chip_smoke.py`` phase 7 calls ``measure`` too).
"""

from __future__ import annotations

import ctypes
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from ..accel import _build
from ..accel.leaf_rows import PLAIN_PAIRS, mt_records
from ..scene import builtin
from ..scene.compile import compile_scene
from .leaf_visit import events_ms

VARIANTS = ("full", "nodiv", "noext", "halftri")
CAP8 = 256             # list capacity in groups
PACKETS = 16
RAYS = 1024            # rays per packet
GROUP = 8              # row ids per group
TRIS = 8               # records per row
REC = 16
TRIPS = (32, CAP8)     # groups a packet, the two sizes of the slope
BLOCK_RAYS = 256       # rays per block of the kernel
FAR = 1e30

# Kernel launches since the last reset, per entry point of leaf_micro.cu.
LAUNCHES = dict.fromkeys(_build.GROUP_ENTRY_POINTS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Data(NamedTuple):
    table: torch.Tensor   # [E, 128] f32, the indoor scene's leaf table
    lists: torch.Tensor   # [PACKETS, CAP8, 8] int32
    rays: torch.Tensor    # [6, PACKETS, RAYS] f32: ox, oy, oz, dx, dy, dz
    t_max: torch.Tensor   # [PACKETS, RAYS] f32


def entries(variant: str) -> int:
    """List entries tested per group."""
    return GROUP // 2 if variant == "halftri" else GROUP


def make_data(device: torch.device) -> Data:
    """The scripts' data: the indoor scene's leaf table (the trace's
    ``ltab``), lists ``arange(CAP8 * 8) % n_rows`` (``n_rows`` the trace's
    ``anc`` rows) for every packet, and rays from ``default_rng(0)``:
    o ~ U(-4, 4), d normal and normalised, each packet the (8, 128) block
    of the script's (PACKETS, 8, 128, 3) arrays, flattened."""
    trace = compile_scene(builtin.make_indoor_scene(), device).trace
    n_rows = int(trace.anc.shape[0])
    lst = np.arange(CAP8 * GROUP, dtype=np.int32).reshape(1, CAP8, GROUP) % n_rows
    lists = np.ascontiguousarray(np.tile(lst, (PACKETS, 1, 1)))
    rng = np.random.default_rng(0)
    o = rng.uniform(-4, 4, (PACKETS, 8, 128, 3)).astype(np.float32)
    d = rng.normal(size=(PACKETS, 8, 128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d], axis=-1).transpose(3, 0, 1, 2).reshape(6, PACKETS, RAYS)
    return Data(trace.ltab.contiguous(), torch.from_numpy(lists).to(device),
                torch.from_numpy(np.ascontiguousarray(rays)).to(device),
                torch.full((PACKETS, RAYS), FAR, device=device))


def _check(table, lists, counts, rays, t_max, variant, cap8):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    if table.dim() != 2 or table.shape[1] != 128 or table.dtype != torch.float32:
        raise ValueError(f"table must be [E, 128] float32, got {tuple(table.shape)} {table.dtype}")
    if lists.dim() != 3 or lists.shape[2] != GROUP or lists.dtype != torch.int32 \
            or lists.shape[0] == 0:
        raise ValueError(f"lists must be [packets, cap8, {GROUP}] int32 with a packet, got "
                         f"{tuple(lists.shape)} {lists.dtype}")
    if cap8 <= 0 or lists.shape[1] != cap8:
        raise ValueError(f"cap8={cap8} must be positive and equal the lists' width "
                         f"{lists.shape[1]}")
    g = lists.shape[0]
    if counts.shape != (g,) or counts.dtype != torch.int32:
        raise ValueError(f"counts must be [{g}] int32, got {tuple(counts.shape)} {counts.dtype}")
    if rays.shape != (6, g, RAYS) or rays.dtype != torch.float32:
        raise ValueError(f"rays must be [6, {g}, {RAYS}] float32, got {tuple(rays.shape)}")
    if t_max.shape != (g, RAYS) or t_max.dtype != torch.float32:
        raise ValueError(f"t_max must be [{g}, {RAYS}] float32, got {tuple(t_max.shape)}")
    xs = (table, lists, counts, rays, t_max)
    if len({x.device for x in xs}) != 1:
        raise ValueError("inputs lie on several devices")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("inputs must be contiguous")


def leaf_groups(table: torch.Tensor, lists: torch.Tensor, counts: torch.Tensor,
                rays: torch.Tensor, t_max: torch.Tensor, variant: str, cap8: int):
    """(t, r, u, v), each [packets, 1024]: each ray's strictly closest hit
    over its packet's first min(count, cap8) groups (r = row * 8 + j; on a
    miss t_max, -1, 0, 0).  Row ids must lie in [0, E).  The kernel for
    CUDA tensors, the plain version for CPU ones."""
    _check(table, lists, counts, rays, t_max, variant, cap8)
    device = table.device
    if device.type == "cpu":
        return leaf_groups_plain(table, lists, counts, rays, t_max, variant, cap8)
    if device.type != "cuda":
        raise ValueError(f"leaf_groups runs on cpu or cuda, not {device}")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"{device} is not the current CUDA device")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (rows are read as float4)")
    lib = _build.library()
    g = lists.shape[0]
    t = torch.empty(g, RAYS, dtype=torch.float32, device=device)
    r = torch.empty(g, RAYS, dtype=torch.int32, device=device)
    u = torch.empty(g, RAYS, dtype=torch.float32, device=device)
    v = torch.empty(g, RAYS, dtype=torch.float32, device=device)
    name = f"leaf_groups_{variant}"
    err = getattr(lib, name)(table.data_ptr(), lists.data_ptr(), cap8, counts.data_ptr(),
                             rays.data_ptr(), t_max.data_ptr(), g * RAYS, t.data_ptr(),
                             r.data_ptr(), u.data_ptr(), v.data_ptr(),
                             ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return t, r, u, v


def leaf_groups_plain(table: torch.Tensor, lists: torch.Tensor, counts: torch.Tensor,
                      rays: torch.Tensor, t_max: torch.Tensor, variant: str, cap8: int):
    """Plain PyTorch version of the kernels.  The tested entries of every
    packet's list, flattened in order, are taken a chunk at a time
    (PLAIN_PAIRS bounds the pairs per op); in each chunk the first record
    with the least t below the running best wins, which is the winner of
    the kernels' one-by-one strictly-closer updates."""
    _check(table, lists, counts, rays, t_max, variant, cap8)
    g, dev, e = lists.shape[0], table.device, entries(variant)
    trip = counts.clamp(0, cap8)
    width = int(trip.max()) * e
    ids = lists[:, :, :e].reshape(g, -1)[:, :width]
    live = (torch.arange(width, device=dev) // e)[None, :] < trip[:, None]   # [g, width]
    o3 = tuple(x[:, :, None] for x in rays[0:3])
    d3 = tuple(x[:, :, None] for x in rays[3:6])
    recip = (lambda a: a) if variant == "nodiv" else None
    best_t = t_max.clone()
    best_r = torch.full((g, RAYS), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((g, RAYS), device=dev)
    best_v = torch.zeros((g, RAYS), device=dev)
    j8 = torch.arange(TRIS, dtype=torch.int32, device=dev)
    step = max(1, PLAIN_PAIRS // (g * RAYS * TRIS))
    for k0 in range(0, width, step):
        idk = ids[:, k0:k0 + step]                                  # [g, K]
        k = idk.shape[1]
        rows = table[0].expand(g, k, 128) if variant == "noext" else table[idk.long()]
        rec = rows.reshape(g, 1, k * TRIS, REC)
        t, u, v, ok = mt_records(rec, o3, d3, recip)                  # [g, RAYS, K * 8]
        hit = ok & (t < best_t[..., None]) & live[:, None, k0:k0 + k].repeat_interleave(TRIS, 2)
        t_min, j = torch.where(hit, t, torch.inf).min(dim=2)
        upd = hit.any(dim=2)
        rid = (idk[:, :, None] * TRIS + j8).reshape(g, k * TRIS)
        best_t = torch.where(upd, t_min, best_t)
        best_r = torch.where(upd, rid.gather(1, j), best_r)
        best_u = torch.where(upd, u.gather(2, j[..., None])[..., 0], best_u)
        best_v = torch.where(upd, v.gather(2, j[..., None])[..., 0], best_v)
    return best_t, best_r, best_u, best_v


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def blocks_in_flight(device: torch.device) -> int:
    """The kernel's blocks that run at once, one an SM: all of them while
    they are fewer than the SMs."""
    return min(PACKETS * RAYS // BLOCK_RAYS,
               torch.cuda.get_device_properties(device).multi_processor_count)


def measure(device: torch.device, say=print) -> dict:
    """Per variant: the kernel against its plain version at both TRIPS
    (bit-equal t, r, u, v, or ValueError), the plain version timed at the
    larger; then the kernel timed at both trips as the script times them
    (5 rounds over the variants, CUDA events around one call, the least ms
    of each), its launches in those rounds (the counts reset just before
    them), and the slope: the script's ns per group (its groups summed
    over the packets) and per row, and that slope times the blocks in
    flight, the ns one SM pays for a 1024-ray group (its four 256-ray
    blocks' groups one after another, as the TPU's one core took them).
    ``rows`` counts the distinct table rows the larger trip reads."""
    data = make_data(device)
    counts = {n: torch.full((PACKETS,), n, dtype=torch.int32, device=device) for n in TRIPS}
    out = {}
    for v in VARIANTS:
        for n in TRIPS:
            args = (data.table, data.lists, counts[n], data.rays, data.t_max, v, CAP8)
            got = leaf_groups(*args)
            t0 = time.perf_counter()
            want = leaf_groups_plain(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise ValueError(f"leaf_groups {v} at {n} groups: kernel differs from its "
                                 "plain version")
        rows = 1 if v == "noext" else int(torch.unique(
            data.lists[:, :TRIPS[1], :entries(v)]).numel())
        out[v] = dict(plain_ms=plain_ms, hits=int((got[1] >= 0).sum()), rows=rows)
    times = {(v, n): [] for v in VARIANTS for n in TRIPS}
    reset_launches()
    for _ in range(5):
        for v in VARIANTS:
            for n in TRIPS:
                times[v, n].append(events_ms(lambda: leaf_groups(
                    data.table, data.lists, counts[n], data.rays, data.t_max, v, CAP8)))
    flight = blocks_in_flight(device)
    for v in VARIANTS:
        ms = [min(times[v, n]) for n in TRIPS]
        slope = (ms[1] - ms[0]) * 1e6 / (PACKETS * (TRIPS[1] - TRIPS[0]))
        out[v].update(ms=ms, slope_ns=slope, sm_ns=slope * flight,
                      launches=LAUNCHES[f"leaf_groups_{v}"])
        say(f"[leaf_groups] {v}: bit-identical to plain at {TRIPS} groups ({out[v]['hits']} "
            f"rays hit; plain {out[v]['plain_ms']:.1f} ms at {TRIPS[1]}); small {ms[0]:.4f} ms, "
            f"big {ms[1]:.4f} ms; slope {slope:.2f} ns/group ({slope / GROUP:.3f} ns/row); "
            f"x {flight} blocks in flight: {slope * flight:.1f} ns per 1024-ray group on one SM")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("leaf_groups: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

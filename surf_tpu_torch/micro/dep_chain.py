"""The dependent-cursor microbenchmark: the card's version of
``scripts/tpu_dep_micro.py`` (its ``pl.pallas_call`` at ``:222``).

A packet of 1024 rays walks a 512-row table whose next row comes from
memory, the fetched row's int32 lanes 9/10 (both row + 1, or row + 8
wrapped at 504 for the window variants, which read them from a window's
last row, so that windows start 15 rows apart: the trip is fixed in value
but opaque to the compiler).  Six variants take the chain apart link by link:

- ``dep0``: fetch -> cursor (a chain of dependent loads, nothing else);
- ``dep1``: dep0 + the row's 8 slab and 8 Möller–Trumbore tests, off the
  chain;
- ``dep1red``: dep1 + the cursor picked by the packet's vote "some ray
  hits some box" (the skip walk's chain);
- ``dep1lean``: dep1red with the plane-form record test (lanes
  [n, d0, U, u0, V, v0] per record);
- ``depb8``: 8 rows a step, the cursor from the last row's vote;
- ``depb8all``: 8 rows a step, all 8 rows' votes taken.  As in the TPU
  script (``tpu_dep_micro.py:165-168``), each pass of its resolve
  overwrites the cursor, so the cursor is the last row's pick, as in
  ``depb8``: the same function with seven more votes a step, not specb's
  chained resolve.

On the card the TPU's ``jnp.any`` feeding the address is the block vote
(``__syncthreads_or``; ``depb8all``: one 8-bit block OR), and the packet
stays in one block.  The data is the TPU script's, from
``default_rng(0)``.  Run on the card:

    python -m surf_tpu_torch.micro.dep_chain

which holds each variant's kernel to its plain version at CHECK_ROWS
rows and times both there, then times the kernel at the two SIZES and
prints the slope in ns per row (``measure``; ``chip_smoke.py`` phase 6
calls it too).
"""

from __future__ import annotations

import ctypes
import subprocess
import time

import numpy as np
import torch

from ..accel import _build
from ..accel.leaf_rows import EPS, mt_records

VARIANTS = ("dep0", "dep1", "dep1red", "dep1lean", "depb8", "depb8all")
SIZES = (131072, 393216)  # rows walked, the two sizes of the slope
CHECK_ROWS = 512          # rows walked for the kernel-vs-plain check
D_ROWS = 512
LANE = 128
RAYS = 1024
REC = 16
SKA, SKB = 9, 10          # int32 skip lanes (equal values)
FAR = 1e30

# Kernel launches since the last reset, per entry point of dep_micro.cu.
LAUNCHES = dict.fromkeys(_build.DEP_ENTRY_POINTS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def window(variant: str) -> int:
    """Rows a step: 8 for the window variants, else 1."""
    return 8 if variant.startswith("depb") else 1


def make_data(device: torch.device):
    """(rows_b, rows_w, rays) as ``tpu_dep_micro.main`` draws them from
    ``default_rng(0)``: the [512, 128] f32 table with skip lanes +1
    (rows_b) or +8 wrapped at 504 (rows_w), and [6, 1024] f32 rays (ox,
    oy, oz, dx, dy, dz, each the TPU's (8, 128) block flattened)."""
    rng = np.random.default_rng(0)
    rows = rng.uniform(-1, 1, (D_ROWS, LANE)).astype(np.float32)
    tables = []
    for step, wrap in ((1, D_ROWS), (8, D_ROWS - 8)):
        meta = np.zeros((D_ROWS, 2), np.int32)
        meta[:, 0] = (np.arange(D_ROWS) + step) % wrap
        meta[:, 1] = meta[:, 0]
        t = rows.copy()
        t[:, SKA:SKB + 1] = meta.view(np.float32).reshape(D_ROWS, 2)
        tables.append(torch.from_numpy(t).to(device))
    rays = np.stack([rng.uniform(0.1, 1, (8, 128)).astype(np.float32).reshape(-1)
                     for _ in range(6)])
    return tables[0], tables[1], torch.from_numpy(rays).to(device)


def _check(table, rays, variant, rows_total):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    if table.dim() != 2 or table.shape[1] != LANE or table.dtype != torch.float32 \
            or not table.is_contiguous():
        raise ValueError(f"table must be contiguous [D, {LANE}] float32")
    if rays.shape != (6, RAYS) or rays.dtype != torch.float32 or not rays.is_contiguous():
        raise ValueError(f"rays must be contiguous [6, {RAYS}] float32")
    if table.device != rays.device:
        raise ValueError("table and rays lie on different devices")
    if rows_total <= 0 or rows_total % window(variant):
        raise ValueError(f"rows_total must be a positive multiple of {window(variant)}")
    if table.shape[0] < window(variant):
        raise ValueError(f"the table has fewer rows than a window of {window(variant)}")


def _clamp(p: int, n_rows: int, bw: int) -> int:
    """The cursor kept inside the table, its window whole: a guard, as the
    walks' max(nxt, p + 1); the tables of ``make_data`` never reach it."""
    return min(max(p, 0), n_rows - bw)


def dep_chain(table: torch.Tensor, rays: torch.Tensor, variant: str, rows_total: int):
    """(best_t [1024], best_r [1024], end [1]) after walking ``rows_total``
    rows from row 0, ``end`` the row the cursor ends at (an output, so that
    no compiler drops the chain of a variant whose hits do not depend on
    it): the kernel for CUDA tensors, the plain version for CPU ones."""
    _check(table, rays, variant, rows_total)
    device = table.device
    if device.type == "cpu":
        return dep_chain_plain(table, rays, variant, rows_total)
    if device.type != "cuda":
        raise ValueError(f"dep_chain runs on cpu or cuda, not {device}")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"{device} is not the current CUDA device")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (rows are read as float4)")
    lib = _build.library()
    t = torch.empty(RAYS, dtype=torch.float32, device=device)
    r = torch.empty(RAYS, dtype=torch.int32, device=device)
    end = torch.empty(1, dtype=torch.int32, device=device)
    name = f"dep_chain_{variant}"
    err = getattr(lib, name)(table.data_ptr(), table.shape[0], rays.data_ptr(),
                             rows_total // window(variant), t.data_ptr(), r.data_ptr(),
                             end.data_ptr(),
                             ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return t, r, end


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------

def _boxes_hit(rec, o, inv, best_t):
    """[R] bool: some ray x box slab test of the row's 8 records (lanes
    0-5 as a box) passes against the running best_t, with
    NaN-propagating min/max (``tpu_dep_micro.py:69-90``)."""
    box = rec[:, None, :6]
    tmin = tmax = None
    for c in range(3):
        tn = (box[..., c] - o[c]) * inv[c]
        tf = (box[..., 3 + c] - o[c]) * inv[c]
        lo = torch.minimum(tn, tf)
        hi = torch.maximum(tn, tf)
        tmin = lo if tmin is None else torch.maximum(tmin, lo)
        tmax = hi if tmax is None else torch.minimum(tmax, hi)
    return ((tmax >= tmin) & (tmin < best_t) & (tmax > 0.0)).any(0)


def _lean_records(rec, o3, d3):
    """The plane-form test of the row's 8 records (``tpu_dep_micro.py:91-
    120``): (t, ok) of [R, 8], ok every test but t < best_t."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    nx, ny, nz, d0 = rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]
    den = nx * dx + ny * dy + nz * dz
    t = (d0 - (nx * ox + ny * oy + nz * oz)) / den
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    u = rec[:, 4] * px + rec[:, 5] * py + rec[:, 6] * pz + rec[:, 7]
    v = rec[:, 8] * px + rec[:, 9] * py + rec[:, 10] * pz + rec[:, 11]
    ok = (den.abs() >= EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= EPS)
    return t, ok


def _merge(t, ok, best_t, best_r, rec0):
    """The records in order, each replacing the best on a strictly smaller
    t: the first record with the least t below the running best."""
    cand = ok & (t < best_t[:, None])
    j = torch.where(cand, t, torch.inf).min(dim=1).indices
    upd = cand.any(dim=1)
    return (torch.where(upd, t.gather(1, j[:, None])[:, 0], best_t),
            torch.where(upd, (rec0 + j).to(torch.int32), best_r))


def dep_chain_plain(table: torch.Tensor, rays: torch.Tensor, variant: str,
                    rows_total: int):
    """Plain PyTorch version of the kernels: the TPU kernel's visits one by
    one, the cursor read back to the host at every step."""
    _check(table, rays, variant, rows_total)
    bw = window(variant)
    o, d = rays[0:3], rays[3:6]
    inv = 1.0 / d
    o3 = tuple(x[:, None] for x in o)
    d3 = tuple(x[:, None] for x in d)
    best_t = torch.full((RAYS,), FAR, device=table.device)
    best_r = torch.full((RAYS,), -1, dtype=torch.int32, device=table.device)
    rows_i = table.view(torch.int32)
    n_rows = table.shape[0]
    p = 0
    for _ in range(rows_total // bw):
        if variant == "dep0":
            p = _clamp(int(rows_i[p, SKA]), n_rows, bw)
            continue
        votes = []
        for r in range(bw):
            rec = table[p + r].view(8, REC)
            votes.append(_boxes_hit(rec, o, inv, best_t).any())
            if variant == "dep1lean":
                t, ok = _lean_records(rec, o3, d3)
            else:
                t, _, _, ok = mt_records(rec, o3, d3)
            best_t, best_r = _merge(t, ok, best_t, best_r, (p + r) * 8)
        if variant == "dep1":
            nxt = rows_i[p, SKA]
        elif variant == "depb8all":
            # the TPU script's resolve: each pass overwrites nxt, so the
            # last row's vote picks it, as in depb8
            nxt = rows_i[p, SKA]
            for r in range(bw):
                nxt = torch.where(votes[r], rows_i[p + r, SKA], rows_i[p + r, SKB])
        else:  # dep1red, dep1lean (bw 1), depb8: the last row's vote
            last = p + bw - 1
            nxt = torch.where(votes[-1], rows_i[last, SKA], rows_i[last, SKB])
        p = _clamp(int(nxt), n_rows, bw)
    return best_t, best_r, torch.tensor([p], dtype=torch.int32, device=table.device)


def visited_rows(table: torch.Tensor, variant: str, rows_total: int) -> int:
    """The distinct rows the walk of ``rows_total`` rows reads, its cursor
    followed through lane SKA.  The tables of ``make_data`` hold equal
    values in lanes SKA and SKB, so that no vote can change the path."""
    rows_i = table.view(torch.int32).cpu()
    if not torch.equal(rows_i[:, SKA], rows_i[:, SKB]):
        raise ValueError("visited_rows needs equal skip lanes")
    bw, n_rows, p, seen = window(variant), table.shape[0], 0, set()
    for _ in range(rows_total // bw):
        seen.update(range(p, p + bw))
        p = _clamp(int(rows_i[p + bw - 1, SKA]), n_rows, bw)
    return len(seen)


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def _time_ms(fn, reps: int) -> float:
    """Least ms of ``reps`` calls after a warm-up, CUDA events around each
    (the TPU script took the best of 3)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def measure(device: torch.device, say=print) -> dict:
    """Per variant: the kernel against its plain version at CHECK_ROWS
    rows (bit-equal t, record and end row, or ValueError); the kernel's
    and the plain version's ms there, with the kernel's launches in that
    timing (its count reset just before it) and the distinct rows that
    walk reads; then the kernel's ms at each of SIZES (best of 3) and the
    slope in ns per row."""
    rows_b, rows_w, rays = make_data(device)
    out = {}
    for v in VARIANTS:
        table = rows_w if v.startswith("depb") else rows_b
        got = dep_chain(table, rays, v, CHECK_ROWS)
        t0 = time.perf_counter()
        want = dep_chain_plain(table, rays, v, CHECK_ROWS)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise ValueError(f"dep_chain {v}: kernel differs from its plain version")
        reset_launches()
        check_ms = _time_ms(lambda: dep_chain(table, rays, v, CHECK_ROWS), 5)
        out[v] = dict(check_ms=check_ms, launches=LAUNCHES[f"dep_chain_{v}"],
                      plain_ms=plain_ms, hits=int((got[1] >= 0).sum()),
                      rows=visited_rows(table, v, CHECK_ROWS))
    for v in VARIANTS:
        table = rows_w if v.startswith("depb") else rows_b
        ms = [_time_ms(lambda: dep_chain(table, rays, v, n), 3) for n in SIZES]
        slope = (ms[1] - ms[0]) * 1e6 / (SIZES[1] - SIZES[0])
        out[v].update(ms=ms, slope_ns=slope)
        say(f"[dep_chain] {v}: bit-identical to plain at {CHECK_ROWS} rows "
            f"(kernel {out[v]['check_ms']:.4f} ms, plain {out[v]['plain_ms']:.1f} ms, "
            f"{out[v]['hits']} rays hit); {SIZES[0]} rows {ms[0]:.3f} ms, {SIZES[1]} rows "
            f"{ms[1]:.3f} ms; slope {slope:.2f} ns/row")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("dep_chain: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

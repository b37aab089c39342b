"""The leaf-visit microbenchmark: the card's version of
``scripts/tpu_leaf_micro.py`` (``make``, its ``pl.pallas_call`` at
``:141``).

One packet of 1024 rays visits the rows of a random 512-row table in
blocks of K_VISITS visits while its cursor p < iters (so ``ceil(iters /
32) * 32`` visits).  A visit reads row ``(p if p < iters else 0) % 512``,
tests its records (``leaf_mt``, ``:36-80``), takes the packet's vote "some
ray's best t is below 1e29" and moves p to p + 1 when the row's int32
lane 9 is 1 or the vote is set, else to max(lane 10, p + 1).  Six
variants take a visit's cost apart:

- ``empty``: no test (the loop, the fetch, the vote and the cursor);
- ``full``: the Möller–Trumbore test of the row's 8 records;
- ``recip``: f from an approximate reciprocal: the kernel's
  ``rcp.approx.ftz.f32`` (MUFU.RCP, within 1 ulp), the card's counterpart
  of the script's ``pl.reciprocal(approx=True)``.  No plain version
  computes it: the plain version divides, the function an approximate
  reciprocal approximates, so ``recip``'s plain version is ``full``'s and
  its kernel is held to it by a gate (``RECIP_GATE``), not bit for bit;
- ``nodiv``: f = a * 0.5;
- ``extonly``: t = (the sum of the record's 9 lanes) * dx, a hit when
  t < best_t, with no eps test (``:51-56``);
- ``half``: records 0-3 of the row.

Every entry point also returns the cursor it ends at, so that no
compiler drops a loop whose hits do not depend on it (``empty``'s).  The
table's skip lanes are all 1 (``:133``), so the cursor steps by one, and
512 visits (CHECK_ITERS) read every row; later visits re-test rows
whose records can no longer beat a running best, so 32768 visits give
the hits of 512.  The data is the script's, from ``default_rng(0)``.  Run
on the card:

    python -m surf_tpu_torch.micro.leaf_visit

which holds each kernel to its plain version at CHECK_ITERS visits,
times the kernels as the script does at ITERS visits (4 round-robin
rounds of a warm-up and 5 calls, the least mean) and prints ms, ns per
visit and the checksum sum(best_t), then the slope between the two
SLOPE_ITERS, which leaves the launch out (``measure``; ``chip_smoke.py``
phase 7 calls it too).
"""

from __future__ import annotations

import ctypes
import subprocess
import time

import numpy as np
import torch

from ..accel import _build
from ..accel.leaf_rows import mt_records
from .dep_chain import merge_records

VARIANTS = ("empty", "full", "recip", "nodiv", "extonly", "half")
ITERS = 32768              # the script's visits
CHECK_ITERS = 512          # visits of the kernel-vs-plain check
SLOPE_ITERS = (ITERS, 98304)
K_VISITS = 32              # visits between two tests of p < iters
D_ROWS = 512
LANE = 128
RAYS = 1024
REC = 16
LEAF_LANE, SKIP_LANE = 9, 10
FAR = 1e30
VOTE_T = 1e29
# recip's kernel against its plain version (1 / a divided): best_r equal on
# all but RECIP_GATE["r_frac"] of the rays, best_t within rtol
# RECIP_GATE["t_rtol"] where best_r agrees, the end cursor equal.  An
# approximate reciprocal within 1 ulp moves f, and so t = f (...), by at
# most ~2 ulp (2.4e-7 relative); a ray whose two best records' t, or whose
# u, v or u + v and its bound, lie that close may take another record.  On
# an H100 at 512 visits no ray did, and t moved by 1.61e-7 at most
# (PERF.md §6), so the gate allows 2 of 1024 rays and 5e-7.
RECIP_GATE = dict(r_frac=2 / RAYS, t_rtol=5e-7)

# Kernel launches since the last reset, per entry point of leaf_micro.cu.
LAUNCHES = dict.fromkeys(_build.VISIT_ENTRY_POINTS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def tests(variant: str) -> int:
    """Records tested per visit."""
    return {"empty": 0, "half": 4}.get(variant, 8)


def make_data(device: torch.device):
    """(table, rays) as ``tpu_leaf_micro.main`` draws them from
    ``default_rng(0)`` (``:127-137``): the [512, 128] f32 U(-1, 1) table with
    int32 lanes 9 (is_leaf, integers(0, 2)) and 10 (skip, 1), then six
    (8, 128) U(0.1, 1) arrays: rays [6, 1024] (ox, oy, oz, dx, dy, dz)."""
    rng = np.random.default_rng(0)
    rows = np.zeros((D_ROWS, LANE), np.float32)
    rows[:, :] = rng.uniform(-1, 1, (D_ROWS, LANE))
    meta = np.zeros((D_ROWS, 2), np.int32)
    meta[:, 0] = rng.integers(0, 2, D_ROWS)
    meta[:, 1] = 1
    rows[:, LEAF_LANE:SKIP_LANE + 1] = meta.view(np.float32).reshape(D_ROWS, 2)
    rays = np.stack([rng.uniform(0.1, 1, (8, 128)).astype(np.float32).reshape(-1)
                     for _ in range(6)])
    return torch.from_numpy(rows).to(device), torch.from_numpy(rays).to(device)


def _check(table, rays, variant, iters):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    if table.dim() != 2 or table.shape[1] != LANE or table.shape[0] == 0 \
            or table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError(f"table must be contiguous [D, {LANE}] float32 with a row")
    if rays.shape != (6, RAYS) or rays.dtype != torch.float32 or not rays.is_contiguous():
        raise ValueError(f"rays must be contiguous [6, {RAYS}] float32")
    if table.device != rays.device:
        raise ValueError("table and rays lie on different devices")
    if iters <= 0:
        raise ValueError(f"iters must be positive, not {iters}")


def leaf_visit(table: torch.Tensor, rays: torch.Tensor, variant: str, iters: int = ITERS):
    """(best_t [1024], best_r [1024], end [1]) after the visit loop of
    ``iters`` (r = row * 8 + j, or -1; end the cursor after the loop): the
    kernel for CUDA tensors, the plain version for CPU ones."""
    _check(table, rays, variant, iters)
    device = table.device
    if device.type == "cpu":
        return leaf_visit_plain(table, rays, variant, iters)
    if device.type != "cuda":
        raise ValueError(f"leaf_visit runs on cpu or cuda, not {device}")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"{device} is not the current CUDA device")
    lib = _build.library()
    t = torch.empty(RAYS, dtype=torch.float32, device=device)
    r = torch.empty(RAYS, dtype=torch.int32, device=device)
    end = torch.empty(1, dtype=torch.int32, device=device)
    name = f"leaf_visit_{variant}"
    err = getattr(lib, name)(table.data_ptr(), table.shape[0], rays.data_ptr(), iters,
                             t.data_ptr(), r.data_ptr(), end.data_ptr(),
                             ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return t, r, end


def _records(rec, o3, d3, variant):
    """(t, ok) of [1024, M] for the row's first M records."""
    if variant == "extonly":
        s = rec[:, 0]
        for lane in range(1, 9):
            s = s + rec[:, lane]
        t = s * d3[0]
        return t, torch.ones_like(t, dtype=torch.bool)
    recip = (lambda a: a * 0.5) if variant == "nodiv" else None
    t, _, _, ok = mt_records(rec, o3, d3, recip)
    return t, ok


def leaf_visit_plain(table: torch.Tensor, rays: torch.Tensor, variant: str,
                     iters: int = ITERS):
    """Plain PyTorch version of the kernels (``recip`` divides: see the
    module's docstring): the visits one by one, the cursor a device
    tensor, read back to the host once every K_VISITS visits for the
    loop's test."""
    _check(table, rays, variant, iters)
    dev = table.device
    o3 = tuple(x[:, None] for x in rays[0:3])
    d3 = tuple(x[:, None] for x in rays[3:6])
    rows_i = table.view(torch.int32)
    best_t = torch.full((RAYS,), FAR, device=dev)
    best_r = torch.full((RAYS,), -1, dtype=torch.int32, device=dev)
    p = torch.zeros((), dtype=torch.int64, device=dev)
    m = tests(variant)
    while int(p) < iters:
        for _ in range(K_VISITS):
            pc = torch.where(p < iters, p, 0) % table.shape[0]
            meta = rows_i.index_select(0, pc.view(1))[0]
            if m:
                rec = table.index_select(0, pc.view(1))[0].view(8, REC)[:m]
                t, ok = _records(rec, o3, d3, variant)
                best_t, best_r = merge_records(t, ok, best_t, best_r, pc * 8)
            vote = (best_t < VOTE_T).any()
            p = torch.where((meta[LEAF_LANE] == 1) | vote, p + 1,
                            torch.maximum(meta[SKIP_LANE].long(), p + 1))
    return best_t, best_r, p.view(1).to(torch.int32)


def recip_gate(got, want) -> dict:
    """``recip``'s kernel output against its plain version: the share of
    rays whose record differs, the largest relative |dt| where it agrees
    (both hit), and whether RECIP_GATE holds (the end cursors equal too)."""
    same = got[1] == want[1]
    both = same & (want[1] >= 0)
    rel = ((got[0] - want[0]).abs() / want[0].abs())[both]
    r_frac = 1.0 - float(same.float().mean())
    t_rel = float(rel.max()) if rel.numel() else 0.0
    ok = (r_frac <= RECIP_GATE["r_frac"] and t_rel <= RECIP_GATE["t_rtol"]
          and torch.equal(got[2], want[2]))
    return dict(r_frac=r_frac, t_rel=t_rel, ok=ok)


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def events_ms(fn, calls: int = 1) -> float:
    """Mean ms of ``calls`` calls between two CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


def measure(device: torch.device, say=print) -> dict:
    """Per variant: the kernel against its plain version at CHECK_ITERS
    visits (bit-equal best_t, best_r and end, or for ``recip`` RECIP_GATE,
    else ValueError), the plain version timed there; then the kernels at
    ITERS visits in the script's rounds (4 rounds over the variants of a
    warm-up and 5 calls, the least mean ms), with their launches in those
    rounds (the counts reset just before them), their hits equal to those
    at CHECK_ITERS and their end cursor; then each kernel's least ms of 3
    calls at both SLOPE_ITERS and the slope in ns per visit."""
    table, rays = make_data(device)
    out, checked = {}, {}
    for v in VARIANTS:
        got = leaf_visit(table, rays, v, CHECK_ITERS)
        t0 = time.perf_counter()
        want = leaf_visit_plain(table, rays, v, CHECK_ITERS)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if v == "recip":
            gate = recip_gate(got, want)
            if not gate["ok"]:
                raise ValueError(f"leaf_visit recip: kernel outside RECIP_GATE {RECIP_GATE} "
                                 f"of its plain version: {gate}")
            agree = (got[1] == want[1]) & (want[1] >= 0)
            err = float((got[0] - want[0]).abs()[agree].max()) if bool(agree.any()) else 0.0
            check = (f"within RECIP_GATE of plain (records differ on {gate['r_frac']:.4%} of "
                     f"rays, max rel dt {gate['t_rel']:.3g})")
        elif not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise ValueError(f"leaf_visit {v}: kernel differs from its plain version")
        else:
            err, check = 0.0, "bit-identical to plain"
        checked[v] = got
        out[v] = dict(plain_ms=plain_ms, max_abs_err=err,
                      msg=f"{check} at {CHECK_ITERS} visits (plain {plain_ms:.1f} ms)")
    best = dict.fromkeys(VARIANTS, float("inf"))
    reset_launches()
    for _ in range(4):
        for v in VARIANTS:
            leaf_visit(table, rays, v, ITERS)
            best[v] = min(best[v], events_ms(lambda: leaf_visit(table, rays, v, ITERS), 5))
    for v in VARIANTS:
        res = leaf_visit(table, rays, v, ITERS)
        if not (torch.equal(res[0], checked[v][0]) and torch.equal(res[1], checked[v][1])
                and int(res[2]) == ITERS):
            raise ValueError(f"leaf_visit {v}: the hits at {ITERS} visits differ from those "
                             f"at {CHECK_ITERS}, or the end cursor is not {ITERS}")
        ms = [min(events_ms(lambda: leaf_visit(table, rays, v, n)) for _ in range(3))
              for n in SLOPE_ITERS]
        slope = (ms[1] - ms[0]) * 1e6 / (SLOPE_ITERS[1] - SLOPE_ITERS[0])
        checksum = float(res[0].sum())
        out[v].update(ms=best[v], launches=LAUNCHES[f"leaf_visit_{v}"], slope_ns=slope,
                      checksum=checksum, hits=int((res[1] >= 0).sum()))
        say(f"[leaf_visit] {v}: {out[v].pop('msg')}; {ITERS} visits {best[v]:.4f} ms "
            f"({best[v] * 1e6 / ITERS:.1f} ns/visit), checksum={checksum:.3f}, "
            f"{out[v]['hits']} rays hit; {SLOPE_ITERS[0]} / {SLOPE_ITERS[1]} visits {ms[0]:.4f} / "
            f"{ms[1]:.4f} ms, slope {slope:.2f} ns/visit")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("leaf_visit: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

"""Quantized child boxes against f32 slabs in the walk's visit: the card's
version of ``scripts/tpu_quant_micro.py`` (``make``, its
``pl.pallas_call`` at ``:203``).

One packet of 1024 rays visits rows in blocks of K_VISITS visits while
its cursor p < iters.  A visit reads row ``(p if p < iters else 0) %
512``, runs the slab test of its 8 child boxes against the running best
t, optionally the Möller–Trumbore test of its 8 records, takes the
packet's vote "some ray hits some box" and sets p to p + 1 when the row's
int32 lane 9 is 1 or the vote is set, else to max(lane 10, p + 1).
Variants, in the script's order:

- ``node_f32``: the f32 slab (``slab_f32`` ``:38``, lanes 16k + 0..5);
- ``node_q8``: the slab from u8-quantized children (``slab_q8`` ``:65``):
  the parent's lo and scale in lanes 0-5, byte c of int32 lane 12 + 2m + h
  the plane m (lo x, y, z, hi x, y, z) of child 4h + c, each plane's t
  dequantized as (lo - o) inv + q (scale inv);
- ``full_f32`` / ``full_q8``: + the records (``leaf_mt`` ``:99``).

Outputs: ``best_t``, ``best_r`` (row * 8 + j, or -1) and the end cursor.
The script's table (``make_data``) is copied bit for bit: it reads packed
int32 words as floats and clips lanes 16-18 to at most 1.0 as floats, so
record 1 of a row is made of denormals, NaNs and large values; the port
keeps NaN-propagating min/max and denormals.  Every skip lane of it is 1,
so the vote never moves the cursor, and its u8 children are hit at every
row: ``make_jump_data`` is the same table with skip lanes that jump
forward (row r's to r + JUMP) and every JUMP-th row's parent box (child 0
of the f32 slab) behind the rays, so that both slabs' votes move it.
On the card the byte unpack is one PRMT (``__byte_perm``) and an I2F
(``csrc/visit_micro.cu``).  Run on the card:

    python -m surf_tpu_torch.micro.quant_visit

which holds each kernel to its plain version at CHECK_ITERS visits on both
tables, then times it on the script's at ITERS and SLOPE_ITERS[1] visits
and prints ms, ns a visit by slope and the checksum sum(best_t)
(``measure``; ``chip_smoke.py`` phase 8 calls it too).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..accel import _build
from ..accel.leaf_rows import mt_records
from . import _visit
from ._visit import D_ROWS, FAR, LANE, LEAF_LANE, RAYS, REC, SKIP_LANE
from .dep_chain import merge_records

VARIANTS = ("node_f32", "node_q8", "full_f32", "full_q8")
ITERS = 4096                  # the script's visits
SLOPE_ITERS = (ITERS, 3 * ITERS)
CHECK_ITERS = 512             # visits of the kernel-vs-plain check
K_VISITS = 32                 # visits between two tests of p < iters
JUMP = 4                      # make_jump_data: row r's skip lane is r + JUMP

# Kernel launches since the last reset, per entry point of visit_micro.cu.
LAUNCHES = dict.fromkeys(_build.QUANT_ENTRY_POINTS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def lanes(variant: str) -> set:
    """The lanes of a row the variant reads."""
    out = {LEAF_LANE, SKIP_LANE}
    if variant.endswith("q8"):
        out |= set(range(6)) | set(range(12, 24))
    else:
        out |= {REC * k + i for k in range(8) for i in range(6)}
    if variant.startswith("full"):
        out |= {REC * k + i for k in range(8) for i in range(9)}
    return out


def make_data(device: torch.device):
    """(table, rays) as ``tpu_quant_micro.main`` draws them from
    ``default_rng(0)`` (``:182-200``), bit for bit: parent lo U(-5, 5) and
    scale U(0.01, 0.1) in lanes 0-5, random int32 words in lanes 12-23,
    int32 lanes 9 (is_leaf, integers(0, 2)) and 10 (skip, 1), then lanes
    16k + 0..2 clipped to at most 1.0 as floats; rays [6, 1024] (ox, oy,
    oz, dx, dy, dz) from six (8, 128) U(0.1, 1) arrays."""
    rng = np.random.default_rng(0)
    rows = np.zeros((D_ROWS, LANE), np.float32)
    rows[:, 0:3] = rng.uniform(-5, 5, (D_ROWS, 3))
    rows[:, 3:6] = rng.uniform(0.01, 0.1, (D_ROWS, 3))
    packed = rng.integers(0, 2**31, (D_ROWS, 12), dtype=np.int32)
    rows[:, 12:24] = packed.view(np.float32).reshape(D_ROWS, 12)
    meta = np.zeros((D_ROWS, 2), np.int32)
    meta[:, 0] = rng.integers(0, 2, D_ROWS)
    meta[:, 1] = 1
    rows[:, 9:11] = meta.view(np.float32).reshape(D_ROWS, 2)
    for k in range(8):
        b = REC * k
        rows[:, b:b + 3] = np.minimum(rows[:, b:b + 3], 1.0)
    rays = np.stack([rng.uniform(0.1, 1, (8, 128)).astype(np.float32).reshape(-1)
                     for _ in range(6)])
    return torch.from_numpy(rows).to(device), torch.from_numpy(rays).to(device)


def make_jump_data(device: torch.device):
    """``make_data`` with row r's skip lane r + JUMP, and on the rows r % JUMP
    == 0 lanes 0-2 set to -5 and lanes 3-5 to 0.001: the parent box of the
    u8 children, and the f32 slab's child 0, lie behind every ray (origins
    and directions are positive), so that the vote is unset on some rows
    of either slab, and a row that is no leaf and whose vote is unset moves
    the cursor JUMP rows on (while p < 512)."""
    table, rays = make_data(device)
    n = table.shape[0]
    table.view(torch.int32)[:, SKIP_LANE] = torch.arange(n, dtype=torch.int32,
                                                         device=device) + JUMP
    table[::JUMP, 0:3] = -5.0
    table[::JUMP, 3:6] = 0.001
    return table, rays


def quant_visit(table: torch.Tensor, rays: torch.Tensor, variant: str, iters: int = ITERS):
    """(best_t [1024], best_r [1024], end [1]) after the visit loop of
    ``iters``: the kernel for CUDA tensors, the plain version for CPU
    ones."""
    _visit.check(table, rays, (6, RAYS), variant, VARIANTS, iters, "rays")
    if not _visit.on_card(table.device, "quant_visit"):
        return quant_visit_plain(table, rays, variant, iters)
    dev = table.device
    t = torch.empty(RAYS, dtype=torch.float32, device=dev)
    r = torch.empty(RAYS, dtype=torch.int32, device=dev)
    end = torch.empty(1, dtype=torch.int32, device=dev)
    _visit.launch(f"quant_visit_{variant}", LAUNCHES, dev, table, table.shape[0], rays, iters,
                  t, r, end)
    return t, r, end


# Child k, plane m of slab_q8: int32 lane 12 + 2m + k // 4, byte k % 4.
_Q8_LANE = torch.tensor([[12 + 2 * m + k // 4 for m in range(6)] for k in range(8)])
_Q8_SHIFT = torch.tensor([[8 * (k % 4)] * 6 for k in range(8)], dtype=torch.int32)


def _slab_q8(row, o, inv, best_t):
    """[R, 8]: slab_q8's test of the rays against the row's 8 quantized
    children: per axis a = (parent lo - o) * inv and b = scale * inv, then
    each plane's t = a + q * b."""
    words = row.view(torch.int32)[_Q8_LANE.to(row.device)]
    q = ((words >> _Q8_SHIFT.to(row.device)) & 0xFF).float()  # [8, 6]
    a = (row[0:3] - o) * inv    # [R, 3]
    b = row[3:6] * inv
    tn = a[:, None] + q[None, :, 0:3] * b[:, None]
    tf = a[:, None] + q[None, :, 3:6] * b[:, None]
    return _visit.slab_hits(tn, tf, best_t)


def quant_visit_plain(table: torch.Tensor, rays: torch.Tensor, variant: str,
                      iters: int = ITERS):
    """Plain PyTorch version of the kernels: the visits one by one, the
    cursor a device tensor read back to the host once every K_VISITS
    visits for the loop's test."""
    _visit.check(table, rays, (6, RAYS), variant, VARIANTS, iters, "rays")
    dev = table.device
    o, d = rays[0:3].T, rays[3:6].T
    inv = 1.0 / d
    o3 = tuple(x[:, None] for x in rays[0:3])
    d3 = tuple(x[:, None] for x in rays[3:6])
    rows_i = table.view(torch.int32)
    best_t = torch.full((RAYS,), FAR, device=dev)
    best_r = torch.full((RAYS,), -1, dtype=torch.int32, device=dev)
    p = torch.zeros((), dtype=torch.int64, device=dev)
    while int(p) < iters:
        for _ in range(K_VISITS):
            pc = torch.where(p < iters, p, 0) % table.shape[0]
            row = table.index_select(0, pc.view(1))[0]
            meta = rows_i.index_select(0, pc.view(1))[0]
            if variant.endswith("q8"):
                hit = _slab_q8(row, o, inv, best_t)
            else:
                hit = _visit.slab8(row, o, inv, best_t)
            if variant.startswith("full"):
                t, _, _, ok = mt_records(row.view(8, REC), o3, d3)
                best_t, best_r = merge_records(t, ok, best_t, best_r, pc * 8)
            p = torch.where((meta[LEAF_LANE] == 1) | hit.any(),
                            p + 1, torch.maximum(meta[SKIP_LANE].long(), p + 1))
    return best_t, best_r, p.view(1).to(torch.int32)


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def measure(device: torch.device, say=print) -> dict:
    """Per variant: the kernel against its plain version at CHECK_ITERS
    visits on the script's table and on ``make_jump_data``'s (every output
    bit-equal, else ValueError), the plain version timed on the script's;
    then, with the launch counts reset just before, the kernel's least ms
    of 3 calls at both SLOPE_ITERS on the script's table, its launches in
    those runs and the slope in ns a visit.  Returns per variant ms (at
    ITERS), plain_ms, launches, slope_ns, checksum (sum of best_t), visits
    and rows (the distinct rows read at ITERS)."""
    data = make_data(device)
    jump = make_jump_data(device)
    out = {}
    for v in VARIANTS:
        got = quant_visit(*data, v, CHECK_ITERS)
        t0 = time.perf_counter()
        want = quant_visit_plain(*data, v, CHECK_ITERS)
        torch.cuda.synchronize()
        out[v] = dict(plain_ms=(time.perf_counter() - t0) * 1e3)
        _visit.same(got, want, f"quant_visit {v} at {CHECK_ITERS} visits")
        got_j = quant_visit(*jump, v, CHECK_ITERS)
        _visit.same(got_j, quant_visit_plain(*jump, v, CHECK_ITERS),
                    f"quant_visit {v} on the jump table")
        out[v]["msg"] = (f"bit-identical to plain at {CHECK_ITERS} visits on both tables (plain "
                         f"{out[v]['plain_ms']:.1f} ms; jump table: end {int(got_j[2])}, "
                         f"{int((got_j[1] >= 0).sum())} rays hit)")
    reset_launches()
    for v in VARIANTS:
        ms = [_visit.least_ms(lambda n=n: quant_visit(*data, v, n)) for n in SLOPE_ITERS]
        res = quant_visit(*data, v, ITERS)
        visits = -(-ITERS // K_VISITS) * K_VISITS
        if int(res[2]) != visits:  # every skip lane is 1: a step of 1 a visit
            raise ValueError(f"quant_visit {v}: end cursor {int(res[2])}, not {visits}")
        slope = _visit.slope_ns(ms, SLOPE_ITERS)
        out[v].update(ms=ms[0], launches=LAUNCHES[f"quant_visit_{v}"], slope_ns=slope,
                      checksum=float(res[0].sum()), visits=visits,
                      rows=min(visits, data[0].shape[0]))
        say(f"[quant_visit] {v}: {out[v].pop('msg')}; {SLOPE_ITERS[0]} / {SLOPE_ITERS[1]} "
            f"visits {ms[0]:.4f} / {ms[1]:.4f} ms, slope {slope:.2f} ns/visit, "
            f"checksum={out[v]['checksum']:.3f}, {int((res[1] >= 0).sum())} rays hit")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("quant_visit: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

"""The per-visit cost decomposition: the card's version of
``scripts/tpu_cost_micro.py`` (``make``, its ``pl.pallas_call`` at
``:227``).

One packet of 1024 rays runs a fixed trip of ``rows_total // bw`` visits
over the script's random 512-row table.  Visit p reads row ``p % 512``,
adds the row's int32 lane 9 (1) to ``acc``, then (``eval_row``) the sum of
its first 48 or 120 lanes to ``acc``, the slab test of its 8 child boxes
against the running best t, and the Möller–Trumbore test of its 8
records.  Variants, in the script's order:

- ``shell``: the loop, the fetch and the lane-9 add;
- ``ext48`` / ``ext120``: + the sum of 48 / 120 lanes (lanes 9 and 10, the
  int32 value 1, read as the float32 denormal 1.4e-45; kept, no -ftz);
- ``slab`` / ``slabfma``: + the slab test, planes as (lo - o) * inv or as
  lo * inv - o * inv;
- ``mt``: + the records; ``full``: slab and records;
- ``fullred``: ``full`` with the packet's vote "some ray hits some box" in
  the cursor's chain (its two cursors are equal, ``:174-176``);
- ``bf4`` / ``bf8``: one fetch of 4 / 8 rows a visit, ``full`` on each
  (``p`` moves by 4 / 8; row ``min(p % 512, 512 - bw)``).

Outputs: ``t_out = best_t + acc`` and ``best_r`` (row * 8 + j, or -1), as
the script's, so t is swamped by acc (~n_visits), and where no record
hits, 1e30 + acc is 1e30: the port also returns ``acc``.  In the script
the slab test feeds no output and ``fullred``'s vote picks between equal
cursors, so a compiler drops both; the port also returns per ray the rows
whose some child box it hits (``boxes``, 0 without a slab test) and
``state`` = (the end cursor, the visits whose vote was set: ``fullred``
only).  The
data is the script's, from ``default_rng(0)``.  On the card the TPU's
scalar extracts are broadcast loads, and ``bf4``/``bf8``'s block fetch is
one cooperative load into shared memory (``csrc/visit_micro.cu``).  Run
on the card:

    python -m surf_tpu_torch.micro.visit_cost

which holds each kernel to its plain version at CHECK_ROWS rows, then
times it at the script's SIZES (least of 3 calls) and prints ms, ns a row
by slope and the checksum sum(t_out) (``measure``; ``chip_smoke.py``
phase 8 calls it at SMOKE_SIZES).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..accel import _build
from ..accel.leaf_rows import mt_records
from . import _visit
from ._visit import D_ROWS, FAR, LANE, LEAF_LANE, RAYS, REC
from .dep_chain import merge_records

VARIANTS = ("shell", "ext48", "ext120", "slab", "slabfma", "mt", "full", "fullred", "bf4",
            "bf8")
SIZES = (131072, 393216)      # the script's rows (visits x bw)
SMOKE_SIZES = (32768, 98304)  # chip_smoke.py phase 8's
CHECK_ROWS = 512              # rows of the kernel-vs-plain check: every row once

# Kernel launches since the last reset, per entry point of visit_micro.cu.
LAUNCHES = dict.fromkeys(_build.COST_ENTRY_POINTS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def window(variant: str) -> int:
    """Rows a visit reads (bw)."""
    return {"bf4": 4, "bf8": 8}.get(variant, 1)


def n_ext(variant: str) -> int:
    return {"ext48": 48, "ext120": 120}.get(variant, 0)


def has_slab(variant: str) -> bool:
    return variant in ("slab", "slabfma", "full", "fullred", "bf4", "bf8")


def has_mt(variant: str) -> bool:
    return variant in ("mt", "full", "fullred", "bf4", "bf8")


def lanes(variant: str) -> set:
    """The lanes of a row the variant reads."""
    out = {LEAF_LANE} | set(range(n_ext(variant)))
    if has_slab(variant):
        out |= {REC * k + i for k in range(8) for i in range(6)}
    if has_mt(variant):
        out |= {REC * k + i for k in range(8) for i in range(9)}
    return out


def make_data(device: torch.device):
    """(table, rays) as ``tpu_cost_micro.main`` draws them from
    ``default_rng(0)`` (``:207-213``): the [512, 128] f32 U(-1, 1) table with
    int32 lanes 9 and 10 set to 1, then six (8, 128) U(0.1, 1) arrays: rays
    [6, 1024] (ox, oy, oz, dx, dy, dz)."""
    rng = np.random.default_rng(0)
    rows = rng.uniform(-1, 1, (D_ROWS, LANE)).astype(np.float32)
    meta = np.ones((D_ROWS, 2), np.int32)
    rows[:, 9:11] = meta.view(np.float32).reshape(D_ROWS, 2)
    rays = np.stack([rng.uniform(0.1, 1, (8, 128)).astype(np.float32).reshape(-1)
                     for _ in range(6)])
    return torch.from_numpy(rows).to(device), torch.from_numpy(rays).to(device)


def visit_cost(table: torch.Tensor, rays: torch.Tensor, variant: str, rows_total: int):
    """(t_out [1024], best_r [1024], acc [1024], boxes [1024] int32, state
    [2] int32 = (end cursor, visits whose vote was set)) after the fixed trip over
    ``rows_total`` rows: the kernel for CUDA tensors, the plain version for
    CPU ones."""
    _visit.check(table, rays, (6, RAYS), variant, VARIANTS, rows_total // window(variant),
                 "rays", window(variant))
    if not _visit.on_card(table.device, "visit_cost"):
        return visit_cost_plain(table, rays, variant, rows_total)
    dev = table.device
    t = torch.empty(RAYS, dtype=torch.float32, device=dev)
    r = torch.empty(RAYS, dtype=torch.int32, device=dev)
    acc = torch.empty(RAYS, dtype=torch.float32, device=dev)
    boxes = torch.empty(RAYS, dtype=torch.int32, device=dev)
    state = torch.empty(2, dtype=torch.int32, device=dev)
    _visit.launch(f"visit_cost_{variant}", LAUNCHES, dev, table, table.shape[0], rays,
                  rows_total, t, r, acc, boxes, state)
    return t, r, acc, boxes, state


def _ext_sums(table, n):
    """[D]: each row's first n lanes summed one by one in float32, the
    script's scalar loop (``:81-84``)."""
    s = torch.zeros(table.shape[0], device=table.device)
    for i in range(n):
        s = s + table[:, i]
    return s


def visit_cost_plain(table: torch.Tensor, rays: torch.Tensor, variant: str, rows_total: int):
    """Plain PyTorch version of the kernels: the visits one by one (the
    cursor is data-independent, a Python int)."""
    bw = window(variant)
    _visit.check(table, rays, (6, RAYS), variant, VARIANTS, rows_total // bw, "rays", bw)
    dev = table.device
    o, d = rays[0:3].T, rays[3:6].T
    inv = 1.0 / d
    oinv = o * inv if variant == "slabfma" else None
    o3 = tuple(x[:, None] for x in rays[0:3])
    d3 = tuple(x[:, None] for x in rays[3:6])
    best_t = torch.full((RAYS,), FAR, device=dev)
    best_r = torch.full((RAYS,), -1, dtype=torch.int32, device=dev)
    acc = torch.zeros(RAYS, device=dev)
    boxes = torch.zeros(RAYS, dtype=torch.int32, device=dev)
    votes = torch.zeros((), dtype=torch.int32, device=dev)
    leaf = table.view(torch.int32)[:, LEAF_LANE].float()
    ext = _ext_sums(table, n_ext(variant)) if n_ext(variant) else None
    n_rows = table.shape[0]
    p = 0
    for _ in range(rows_total // bw):
        pc = min(p % n_rows, n_rows - bw) if bw > 1 else p % n_rows
        for row_id in range(pc, pc + bw):
            row = table[row_id]
            acc = acc + leaf[row_id]
            if ext is not None:
                acc = acc + ext[row_id]
            if has_slab(variant):
                anyh = _visit.slab8(row, o, inv, best_t, oinv).any(1)
                boxes += anyh.int()
                if variant == "fullred":
                    votes += anyh.any().int()
            if has_mt(variant):
                t, _, _, ok = mt_records(row.view(8, REC), o3, d3)
                best_t, best_r = merge_records(t, ok, best_t, best_r, row_id * 8)
        p += bw
    state = torch.stack([torch.tensor(p, dtype=torch.int32, device=dev), votes])
    return best_t + acc, best_r, acc, boxes, state


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def measure(device: torch.device, say=print, sizes=SMOKE_SIZES) -> dict:
    """Per variant: the kernel against its plain version at CHECK_ROWS rows
    (every output bit-equal, else ValueError), the plain version timed
    there; then, with the launch counts reset just before, the kernel's
    least ms of 3 calls at both ``sizes``, its launches in those runs, the
    slope in ns a row, its end cursor (the rows walked) and its record
    hits (equal to CHECK_ROWS's: later visits re-test rows whose records
    can no longer beat a running best).  Returns per variant ms (at
    sizes[0]), plain_ms, launches, slope_ns, checksum (sum of t_out) and
    rows (the distinct rows read)."""
    table, rays = make_data(device)
    out = {}
    for v in VARIANTS:
        got = visit_cost(table, rays, v, CHECK_ROWS)
        t0 = time.perf_counter()
        want = visit_cost_plain(table, rays, v, CHECK_ROWS)
        torch.cuda.synchronize()
        out[v] = dict(plain_ms=(time.perf_counter() - t0) * 1e3, check=got)
        _visit.same(got, want, f"visit_cost {v} at {CHECK_ROWS} rows")
    reset_launches()
    for v in VARIANTS:
        ms = [_visit.least_ms(lambda n=n: visit_cost(table, rays, v, n)) for n in sizes]
        res = visit_cost(table, rays, v, sizes[0])
        check = out[v].pop("check")
        if int(res[4][0]) != sizes[0] or not torch.equal(res[1], check[1]):
            raise ValueError(f"visit_cost {v}: the end cursor at {sizes[0]} rows is not "
                             f"{sizes[0]}, or its hits differ from those at {CHECK_ROWS}")
        slope = _visit.slope_ns(ms, sizes)
        out[v].update(ms=ms[0], launches=LAUNCHES[f"visit_cost_{v}"], slope_ns=slope,
                      checksum=float(res[0].sum()), rows=min(sizes[0], table.shape[0]))
        say(f"[visit_cost] {v}: bit-identical to plain at {CHECK_ROWS} rows (plain "
            f"{out[v]['plain_ms']:.1f} ms, boxes hit {int(check[3].sum())}, votes "
            f"{int(check[4][1])}); {sizes[0]} / {sizes[1]} rows {ms[0]:.4f} / {ms[1]:.4f} ms, "
            f"slope {slope:.2f} ns/row, checksum={out[v]['checksum']:.3f}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("visit_cost: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0), sizes=SIZES)


if __name__ == "__main__":
    main()

"""Speculative visits of W rows: the card's version of
``scripts/tpu_spec_micro.py`` (``eval_row`` ``:35``, ``make_cur`` ``:99``,
``make(w)`` ``:199``, its ``pl.pallas_call`` at ``:270``).

One packet of 1024 rays walks a stream of ``rows_total`` rows (row p of the
stream is table row p % 512) in bodies of 32 visits, while the cursor
p < rows_total.  A row holds 8 boxes (lanes 16k + 0..5) and 8
Möller–Trumbore records (lanes 16k + 0..8) over the same lanes, its int32
lane 9 a leaf flag (== 1) and lane 10 a skip.  Variants:

- ``cur``: one row a visit (the stream walk's visit): the slab test of
  its boxes against the visit-start best t votes on "descend" (one bit),
  the records of a leaf row update the best in order, and p moves to
  p + 1 on a leaf or a descend, else to max(skip, p + 1); p stays at
  rows_total once there (the rest of the body tests row 0's boxes);
- ``w1``..``w6`` (``make(W)``, W = 1, 2, 3, 4, 6): rows (base + w) % 512,
  base = p (0 once p >= rows_total), each tested against the visit-start
  best (the records of every row, leaf or not); their W votes are one
  W-bit block OR on the card, then one scalar resolution: a row is on
  the path while the cursor built so far equals its index, an off-path
  row's t is penalised by 1e30, and p = max(nxt, p + 1).

The port follows the code: where W does not divide rows_total, the last
window reads up to W - 1 rows past the end, and the rest of the last body
re-tests rows 0..W-1 with base 0 (at the script's 32,768 rows W3 makes
10,944 visits and W6 5,472; the script's printout says the walk covers
rows_total rows whatever W).  On the script's data (every row a leaf,
skip 1) every variant moves by 1 a row; on ``make_jump_data`` (leaf and
node rows, skips of 2..8) the skip and the off-path penalty act, and the
``wN`` depart from ``cur``: a window's rows are tested against the best
at its start, not after the rows before them, and their records count on
node rows too.

Outputs: ``t`` (best t, 1e30 where no record hit), ``r`` = best record
(row * 8 + j, -1 for none) + visits, the script's checksum fold, and
``state`` = (the end cursor, the visits).  On the card (``csrc/
op_micro.cu``) IEEE divisions and separately rounded products and sums,
the slab and record tests of ``csrc/mt.cuh``.  Run on the card:

    python -m surf_tpu_torch.micro.spec_visit

which holds each kernel to its plain version at CHECK_ROWS rows on the
script's data and on ``make_jump_data``'s, then times it at both
SLOPE_ROWS and prints ms, ns a row tested by slope and the checksum
(``measure``; ``chip_smoke.py`` phase 11 calls it too).
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel import _build
from ..accel.leaf_rows import mt_records
from . import _visit
from ._visit import D_ROWS, FAR, LANE, LEAF_LANE, RAYS, REC, SKIP_LANE

VARIANTS = ("cur", "w1", "w2", "w3", "w4", "w6")
ROWS_TOTAL = 32768            # the script's stream
SLOPE_ROWS = (ROWS_TOTAL, 3 * ROWS_TOTAL)
CHECK_ROWS = 512              # stream rows of the kernel-vs-plain check
K_VISITS = 32                 # visits between two tests of the cursor

# Kernel launches since the last reset, per entry point of op_micro.cu.
LAUNCHES = dict.fromkeys(_build.SPEC_ENTRY_POINTS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def window(variant: str) -> int:
    """Rows a visit tests: W of ``w<W>``, 1 for ``cur``."""
    return 1 if variant == "cur" else int(variant[1:])


def _rays(rng) -> np.ndarray:
    """[6, 1024]: ox, oy, oz, dx, dy, dz, each the script's (8, 128)
    U(0.1, 1) block (``:264-266``) flattened."""
    return np.stack([rng.uniform(0.1, 1, (8, 128)).astype(np.float32).reshape(-1)
                     for _ in range(6)])


def _table(rows: np.ndarray, leaf: np.ndarray, skip: np.ndarray) -> np.ndarray:
    meta = np.stack([leaf, skip], axis=1).astype(np.int32)
    rows[:, LEAF_LANE:SKIP_LANE + 1] = meta.view(np.float32)
    return rows


def make_data(device: torch.device):
    """(table [512, 128], rays [6, 1024]) as ``tpu_spec_micro.main`` draws
    them (``:256-266``) from ``default_rng(0)``: rows U(-1, 1), every row a
    leaf with skip 1, then the six ray blocks."""
    rng = np.random.default_rng(0)
    rows = rng.uniform(-1, 1, (D_ROWS, LANE)).astype(np.float32)
    ones = np.ones(D_ROWS, np.int32)
    table = _table(rows, ones, ones)
    return torch.from_numpy(table).to(device), torch.from_numpy(_rays(rng)).to(device)


def make_jump_data(device: torch.device):
    """(table, rays) on which the walk jumps: from ``default_rng(1)``, rows
    U(-1, 1), half of them leaves; a node row's skip is its index + 2..8
    (a stream position, so it acts in the first 512 rows), and half of
    the node rows have every box below -0.5 on each axis, behind every
    ray (origins and directions are positive), so that nothing descends
    there and the walk takes the skip.  Then the rays as the script's."""
    rng = np.random.default_rng(1)
    rows = rng.uniform(-1, 1, (D_ROWS, LANE)).astype(np.float32)
    leaf = rng.random(D_ROWS) < 0.5
    skip = np.arange(D_ROWS) + rng.integers(2, 9, D_ROWS)
    behind = ~leaf & (rng.random(D_ROWS) < 0.5)
    boxes = rows.reshape(D_ROWS, 8, REC)
    boxes[behind, :, :6] = rng.uniform(-1, -0.5, (int(behind.sum()), 8, 6))
    table = _table(rows, leaf, np.where(leaf, 1, skip))
    return torch.from_numpy(table).to(device), torch.from_numpy(_rays(rng)).to(device)


def spec_visit(table: torch.Tensor, rays: torch.Tensor, variant: str,
               rows_total: int = ROWS_TOTAL):
    """(t [1024], r [1024] int32 = best record + visits, state [2] int32 =
    (end cursor, visits)) after walking ``rows_total`` stream rows: the
    kernel for CUDA tensors, the plain version for CPU ones."""
    _visit.check(table, rays, (6, RAYS), variant, VARIANTS, rows_total, "rays")
    if not _visit.on_card(table.device, "spec_visit"):
        return spec_visit_plain(table, rays, variant, rows_total)
    dev = table.device
    t = torch.empty(RAYS, dtype=torch.float32, device=dev)
    r = torch.empty(RAYS, dtype=torch.int32, device=dev)
    state = torch.empty(2, dtype=torch.int32, device=dev)
    _visit.launch(f"spec_visit_{variant}", LAUNCHES, dev, table, table.shape[0], rays,
                  rows_total, t, r, state)
    return t, r, state


def _rows_hits(table, pcs, o, inv, o3, d3, best_t):
    """The W rows ``pcs`` against the visit-start best: ([W] bool, some
    ray hits some box of row w; t_w [R, W], the least t of row w's records
    that hit below best_t, first at ties, FAR for none; r_w [R, W], its
    record, -1 for none)."""
    idx = torch.tensor(pcs, device=table.device)
    rows = table.index_select(0, idx)
    w = len(pcs)
    desc = _visit.slab8(rows.reshape(-1), o, inv, best_t).view(-1, w, 8).any(2).any(0)
    t, _, _, ok = mt_records(rows.view(w * 8, REC), o3, d3)
    t, ok = t.view(-1, w, 8), ok.view(-1, w, 8)
    cand = ok & (t < best_t[:, None, None])
    j = torch.where(cand, t, torch.inf).min(dim=2).indices
    hit = cand.any(2)
    t_w = torch.where(hit, t.gather(2, j[..., None])[..., 0], FAR)
    r_w = torch.where(hit, idx[None] * 8 + j, -1).to(torch.int32)
    return desc.tolist(), t_w, r_w


def spec_visit_plain(table: torch.Tensor, rays: torch.Tensor, variant: str,
                     rows_total: int = ROWS_TOTAL):
    """Plain PyTorch version of the kernels: the visits one by one, a
    window's W rows tested at once ([W, 8] boxes and records on the 1024
    rays), the cursor resolved on the host."""
    _visit.check(table, rays, (6, RAYS), variant, VARIANTS, rows_total, "rays")
    dev, n_rows = table.device, table.shape[0]
    o, d = rays[0:3].T, rays[3:6].T
    inv = 1.0 / d
    o3 = tuple(v[:, None] for v in rays[0:3])
    d3 = tuple(v[:, None] for v in rays[3:6])
    leaf, skip = (v.tolist() for v in table.view(torch.int32)[:, LEAF_LANE:SKIP_LANE + 1].T)
    best_t = torch.full((RAYS,), FAR, device=dev)
    best_r = torch.full((RAYS,), -1, dtype=torch.int32, device=dev)
    w_rows = window(variant)
    p = it = 0
    while p < rows_total:
        for _ in range(K_VISITS):
            if variant == "cur":
                valid = p < rows_total
                pc = (p if valid else 0) % n_rows
                (desc,), t_w, r_w = _rows_hits(table, [pc], o, inv, o3, d3, best_t)
                if leaf[pc] == 1 and valid:
                    upd = t_w[:, 0] < best_t  # t_w's records already lie below best_t
                    best_t = torch.where(upd, t_w[:, 0], best_t)
                    best_r = torch.where(upd, r_w[:, 0], best_r)
                nxt = p + 1 if leaf[pc] == 1 or desc else max(skip[pc], p + 1)
                p = nxt if valid else p
            else:
                base = p if p < rows_total else 0
                pcs = [(base + w) % n_rows for w in range(w_rows)]
                desc, t_w, r_w = _rows_hits(table, pcs, o, inv, o3, d3, best_t)
                nxt = base
                for w, pc in enumerate(pcs):
                    on = nxt == base + w
                    if on:
                        nxt = (base + w + 1 if leaf[pc] == 1 or desc[w]
                               else max(skip[pc], base + w + 1))
                    t_eff = t_w[:, w] + (0.0 if on else FAR)
                    better = t_eff < best_t
                    best_t = torch.where(better, t_eff, best_t)
                    best_r = torch.where(better, r_w[:, w], best_r)
                p = max(nxt, p + 1)
            it += 1
    return best_t, best_r + it, torch.tensor([p, it], dtype=torch.int32, device=dev)


def rows_tested(variant: str, res, _n=None) -> int:
    """The stream rows a run tested: its visits (state[1]) times W."""
    return int(res[-1][1]) * window(variant)


def measure(device: torch.device, say=print) -> dict:
    """``_visit.measure_checked`` at CHECK_ROWS on the script's data and on
    ``make_jump_data``'s, timed at SLOPE_ROWS, the slope in ns a row
    tested."""
    return _visit.measure_checked(
        "spec_visit", spec_visit, spec_visit_plain, VARIANTS,
        (make_data(device), make_jump_data(device)), CHECK_ROWS, SLOPE_ROWS, LAUNCHES, say,
        work=rows_tested, unit="row")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("spec_visit: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

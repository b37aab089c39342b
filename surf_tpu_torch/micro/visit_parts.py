"""The parts of a walk visit's shape: the card's version of
``scripts/tpu_visit_micro.py`` (``make`` ``:38``, ``visit_math`` ``:29``,
its ``pl.pallas_call`` at ``:88``).

One packet of 1024 values x visits rows of a 512-row U(0, 1) table.  A
visit at cursor i reads lanes 0-8 of row i % 512 and runs ``visit_math``,
a chain of 9 links, r = r + f * x', x' = (r > f ? x' : r), from r = acc and
x' = x.  Variants, in the script's order, each adding one part to ``base``
(a ``fori`` loop over i = 0 .. iters - 1):

- ``roll``: the row's lanes rolled by 16 (i & 7), so link j reads lane
  (16 (i & 7) + j) mod 128 (the TPU's dynamic lane roll; on the card an
  indexed read of those lanes);
- ``any``: the packet's vote "some value's r > x", whose next index the
  ``fori`` loop drops (a compiler removes it: the port counts the visits
  whose vote was set, so that the card keeps the vote's barrier);
- ``fori0``: an inner loop of min(0, i + 1) = 0 trips (the card's kernel
  takes the 0 as a launch argument, so that nvcc cannot fold the loop);
- ``while``: a ``while`` loop on the cursor, i = max(i + 1, i + 1);
- ``full``: all four: the rolled read, the vote picking the next cursor
  (i + 1 when set, else i + 2), the zero-trip loop, and the ``while``.

Outputs: ``o`` (acc after the loop) and ``state`` = (the end cursor, the
visits whose vote was set: ``any`` and ``full`` only).  The script's data
is unseeded (``np.random.rand``, ``:84-85``): ``make_data`` draws it from
``default_rng(0)`` in the script's order.  On it ``full``'s vote is
always set (r only grows); ``make_vote_data``'s is not.  Run on the card:

    python -m surf_tpu_torch.micro.visit_parts

which holds each kernel to its plain version at CHECK_ITERS visits on the
script's data and on ``make_vote_data``'s, and at ITERS, then times it at
both SLOPE_ITERS and prints ms, ns a visit by slope and the checksum
(``measure``; ``chip_smoke.py`` phase 9 calls it too).
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel import _build
from . import _visit
from ._visit import D_ROWS, LANE, RAYS

VARIANTS = ("base", "roll", "any", "fori0", "while", "full")
ITERS = 4096                  # the script's visits
SLOPE_ITERS = (ITERS, 3 * ITERS)
CHECK_ITERS = 64              # visits of the kernel-vs-plain check
LINKS = 9                     # lanes a visit reads, links of its chain

# Kernel launches since the last reset, per entry point of shape_micro.cu.
LAUNCHES = dict.fromkeys(_build.PARTS_ENTRY_POINTS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rolls(variant: str) -> bool:
    return variant in ("roll", "full")


def votes(variant: str) -> bool:
    return variant in ("any", "full")


def fori0(variant: str) -> bool:
    return variant in ("fori0", "full")


def lanes(variant: str, i: int) -> list:
    """The lanes of its row that the visit at cursor i reads."""
    off = 16 * (i & 7) if rolls(variant) else 0
    return [(off + j) % LANE for j in range(LINKS)]


def make_data(device: torch.device):
    """(table [512, 128], x [1024]) drawn as ``tpu_visit_micro.main`` draws
    them (``:84-85``, U(0, 1) in float64, then float32), from
    ``default_rng(0)`` in place of its unseeded ``np.random.rand``."""
    rng = np.random.default_rng(0)
    rows = rng.random((D_ROWS, LANE)).astype(np.float32)
    x = rng.random((8, 128)).astype(np.float32).reshape(-1)
    return torch.from_numpy(rows).to(device), torch.from_numpy(x).to(device)


def make_vote_data(device: torch.device):
    """(table, x) on which ``full``'s vote moves the cursor: rows U(-1, 0.5)
    and x U(0, 1), from ``default_rng(0)`` (rows first), drawn in float64
    and rounded to float32 once.  The rows' lanes sum to below 0 on
    average, so r falls below every x on some visits: at 64 visits ``full``
    makes 51 visits, 38 with the vote set and 13 steps of 2 (4096: 2831
    visits, 1566 set)."""
    rng = np.random.default_rng(0)
    rows = rng.uniform(-1, 0.5, (D_ROWS, LANE)).astype(np.float32)
    x = rng.random((8, 128)).astype(np.float32).reshape(-1)
    return torch.from_numpy(rows).to(device), torch.from_numpy(x).to(device)


def visit_parts(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS):
    """(o [1024], state [2] int32 = (end cursor, visits whose vote was set))
    after the visit loop of ``iters``: the kernel for CUDA tensors, the
    plain version for CPU ones."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    if not _visit.on_card(table.device, "visit_parts"):
        return visit_parts_plain(table, x, variant, iters)
    dev = table.device
    o = torch.empty(RAYS, dtype=torch.float32, device=dev)
    state = torch.empty(2, dtype=torch.int32, device=dev)
    _visit.launch(f"visit_parts_{variant}", LAUNCHES, dev, table, table.shape[0], x, iters, o,
                  state)
    return o, state


def visit_math(row: torch.Tensor, lanes_: list, x: torch.Tensor, acc: torch.Tensor):
    """``visit_math`` (``:29-35``): (r, x') after the chain of links over
    the row's ``lanes_``; x' is the last link's x (the script's
    ``visit_math`` drops it, ``tpu_body_micro.py``'s ``bin_sroll`` votes
    on it)."""
    r = acc
    for lane in lanes_:
        f = row[lane]
        r = r + f * x
        x = torch.where(r > f, x, r)
    return r, x


def visit_parts_plain(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS,
                      seen: torch.Tensor | None = None):
    """Plain PyTorch version of the kernels: the visits one by one.  The
    cursor of ``full`` is a device tensor, its ``while`` a fixed trip of
    ``iters`` visits that leaves acc as it is from the visit at which the
    cursor reaches ``iters`` on; ``fori0``'s trip count min(0, next) is read
    on the host.  Where ``seen`` ([D, 16] bool: a row's 32-byte sectors) is
    given, marks the sectors read."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    dev, n_rows = table.device, table.shape[0]
    acc = x * 0.0
    n_votes = torch.zeros((), dtype=torch.int64, device=dev)
    if variant == "full":
        cur = torch.zeros((), dtype=torch.int64, device=dev)
        gather = torch.arange(LINKS, device=dev)
        for _ in range(iters):
            live = cur < iters
            row = table.index_select(0, cur.reshape(1) % n_rows)[0]
            lane_ids = (16 * (cur & 7) + gather) % LANE
            if seen is not None:
                seen[cur % n_rows, lane_ids // 8] |= live
            r, _ = visit_math(row.index_select(0, lane_ids), range(LINKS), x, acc)
            vote = (r > x).any()
            nxt = torch.where(vote, cur + 1, cur + 2)
            for k in range(int(torch.clamp(nxt, max=0))):
                r, _ = visit_math(table[int(cur + k) % n_rows], range(LINKS), x, r)
            acc = torch.where(live, r, acc)
            n_votes += (live & vote).long()
            cur = torch.where(live, torch.maximum(nxt, cur + 1), cur)
        return acc, torch.stack([cur, n_votes]).to(torch.int32)
    for i in range(iters):
        row = table[i % n_rows]
        if seen is not None:
            seen[i % n_rows, [lane // 8 for lane in lanes(variant, i)]] = True
        r, _ = visit_math(row, lanes(variant, i), x, acc)
        if votes(variant):
            n_votes += (r > x).any().long()
        for k in range(min(0, i + 1) if fori0(variant) else 0):
            r, _ = visit_math(table[(i + k) % n_rows], range(LINKS), x, r)
        acc = r
    end = torch.tensor(iters, dtype=torch.int64, device=dev)
    return acc, torch.stack([end, n_votes]).to(torch.int32)


def visits(variant: str, state) -> int:
    """The visits a run made, from its state (end cursor, votes):
    ``full``'s visits each move the cursor by 1 (vote set) or 2, so its
    end = 2 visits - votes; the others visit every cursor up to the end."""
    if variant == "full":
        return (int(state[0]) + int(state[1])) // 2
    return int(state[0])


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def measure(device: torch.device, say=print) -> dict:
    """``_visit.measure_variants`` at CHECK_ITERS, ITERS and SLOPE_ITERS
    on ``make_data``'s and ``make_vote_data``'s tables; adds visits (those
    made at ITERS) to its results."""
    out = _visit.measure_variants("visit_parts", visit_parts, visit_parts_plain, VARIANTS,
                                  make_data(device), make_vote_data(device),
                                  (CHECK_ITERS, ITERS, SLOPE_ITERS), LAUNCHES, say)
    for v, r in out.items():
        r["visits"] = visits(v, r["state"])
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("visit_parts: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

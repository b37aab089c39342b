"""Candidate bodies of a walk visit: the card's version of
``scripts/tpu_body_micro.py`` (``outer`` ``:30``, the bodies ``:54-131``,
its ``pl.pallas_call`` at ``:140``).

One packet of 1024 values x visits a 512-row U(0, 1) table in blocks of
16 visits (``_visit.K_VISITS``) while the visit counter < iters, from
cursor 3.  A visit at cursor i runs one body, which returns acc and the
next cursor:

- ``bin_sroll`` (``:54``): lanes (16 (i & 7) + j) mod 128, j < 9, of row
  (i >> 3) % 512 (a binary record: the TPU's 8 static rolls and selects
  by i & 7; on the card an indexed read of those lanes), the chain of
  ``visit_parts.visit_math``; the next cursor i + 1 if some value's r >
  the chain's last x', else i + 2;
- ``wide_x`` (``:85``): row i % 512, the toy slab of ``_slab8_extract``
  (``:69``; r = acc + the sum over the 8 boxes of x where the planes
  cross, else acc), then i + 1 if some value's r > x, else i + 2;
- ``wide_bc`` (``:92``): the tile of rows 8 (i % 64) .. + 8, value (s, l)
  (s = index // 128, l = index % 128) testing box s (lanes 0-5 of the
  tile's row s) against x[0, l] and adding x or acc; the next cursor
  i + 1 if more than 4 of the 1024 tests cross, else i + 2;
- ``smem_stack`` (``:115``): ``wide_x``'s body, then a store of 2 i at
  sp = max(i % 64, 1) and a load of entry sp - 1 of a 256-entry int32
  stack; the next cursor (popped mod 512) + 1 (a floor modulo) if some
  value's r > x, else i + 2.

Outputs: ``o`` (acc after the loop) and ``state`` = (the end cursor, the
visits whose vote was set; ``wide_bc``: whose count was above 4).  The
script's data is unseeded (``np.random.rand``, ``:136-137``) and drawn
as ``tpu_visit_micro.py``'s: ``make_data`` is ``visit_parts.make_data``.
The stack is never initialised in the script: Pallas's interpret mode
fills it with -2147483648, and the port fills it so.  The cursor stays
odd (it starts at 3 and moves by 2, or to an even popped value mod 512 +
1), so sp is odd and every pop reads an even entry, which no visit
stores: it gives cursor 1, on any data.  ``wide_x``'s and
``smem_stack``'s acc grows by a factor of about 1 + the misses a visit
and overflows: all 1024 values are finite at 32 visits (CHECK_ITERS),
most are inf at the script's 2048, where kernel and plain version must
still agree (inf included: no -ftz, IEEE adds).  Run on the card:

    python -m surf_tpu_torch.micro.visit_bodies

which holds each kernel to its plain version at CHECK_ITERS visits on
both data sets and at ITERS, then times it at both SLOPE_ITERS and prints
ms, ns a visit by slope and the end state (``measure``; ``chip_smoke.py``
phase 9 calls it too).
"""

from __future__ import annotations

import torch

from ..accel import _build
from . import _visit
from ._visit import LANE, RAYS, REC
from . import visit_parts
from .visit_parts import LINKS, make_data, visit_math

VARIANTS = ("bin_sroll", "wide_x", "wide_bc", "smem_stack")
ITERS = 2048                  # the script's visits
SLOPE_ITERS = (ITERS, 3 * ITERS)
CHECK_ITERS = 32              # visits of the kernel-vs-plain check: acc finite
START = 3                     # the cursor's start
STACK = 256                   # the scratch's entries
SP_SPAN = 64                  # sp = max(i % SP_SPAN, 1)
TILE = 8                      # wide_bc's rows a visit
UNSTORED = -2**31             # an entry never stored

# Kernel launches since the last reset, per entry point of shape_micro.cu.
LAUNCHES = dict.fromkeys(_build.BODY_ENTRY_POINTS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def make_vote_data(device: torch.device):
    """(table, x) on which every variant's vote fails on some visits:
    ``visit_parts.make_vote_data``'s, its odd rows below 32 made
    non-positive.  ``wide_x``'s and ``smem_stack``'s acc stays 0 while
    their cursor (3, 5, ...) walks those rows, ``bin_sroll``'s chain falls
    below x' on some visits and ``wide_bc``'s count stays at most 4 on
    some: at 32 visits the votes fail 2, 16, 4 and 16 times (in the order
    of VARIANTS)."""
    table, x = visit_parts.make_vote_data(torch.device("cpu"))
    table[1:32:2] = -table[1:32:2].abs()
    return table.to(device), x.to(device)


def visit_body(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS):
    """(o [1024], state [2] int32 = (end cursor, visits whose vote was set))
    after the visit loop of ``iters``: the kernel for CUDA tensors, the
    plain version for CPU ones."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x", TILE)
    if not _visit.on_card(table.device, "visit_body"):
        return visit_body_plain(table, x, variant, iters)
    dev = table.device
    o = torch.empty(RAYS, dtype=torch.float32, device=dev)
    state = torch.empty(2, dtype=torch.int32, device=dev)
    _visit.launch(f"visit_body_{variant}", LAUNCHES, dev, table, table.shape[0], x, iters, o,
                  state)
    return o, state


def visit_body_plain(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS,
                     seen: torch.Tensor | None = None):
    """Plain PyTorch version of the kernels: the visits one by one, the
    cursor and the stack device tensors (no host read).  Where ``seen``
    ([D, 16] bool: a row's 32-byte sectors) is given, marks the sectors
    read."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x", TILE)
    dev, n_rows = table.device, table.shape[0]
    links = torch.arange(LINKS, device=dev)
    tile_rows = torch.arange(TILE, device=dev)
    boxes = table.view(n_rows, 8, REC)[:, :, :6]
    box_sectors = torch.arange(0, LANE, REC, device=dev) // 8   # of lanes 16k + 0..5
    stack = torch.full((STACK,), UNSTORED, dtype=torch.int32, device=dev)
    acc = x * 0.0
    cur = torch.tensor(START, dtype=torch.int64, device=dev)
    n_votes = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(_visit.block_visits(iters)):
        if variant == "bin_sroll":
            pc = (cur >> 3) % n_rows
            lane_ids = (16 * (cur & 7) + links) % LANE
            if seen is not None:
                seen[pc, lane_ids // 8] = True
            row = table.index_select(0, pc.reshape(1))[0].index_select(0, lane_ids)
            r, xl = visit_math(row, range(LINKS), x, acc)
            vote = (r > xl).any()
            nxt = torch.where(vote, cur + 1, cur + 2)
        elif variant == "wide_bc":
            rows = TILE * (cur % (n_rows // TILE)) + tile_rows
            if seen is not None:
                seen[rows, 0] = True
            tile = table.index_select(0, rows)
            hit = _visit.toy_cross(tile[:, :6], x[:LANE]).T.reshape(-1)   # value s * 128 + l
            r = acc + torch.where(hit, x, acc)
            vote = hit.sum() > 4
            nxt = torch.where(vote, cur + 1, cur + 2)
        else:
            pc = cur % n_rows
            if seen is not None:
                seen[pc, box_sectors] = True
            r = _visit.slab8_extract(boxes.index_select(0, pc.reshape(1))[0], x, acc)
            vote = (r > x).any()
            if variant == "wide_x":
                nxt = torch.where(vote, cur + 1, cur + 2)
            else:
                sp = torch.clamp(cur % SP_SPAN, min=1).reshape(1)
                stack.index_put_((sp,), (cur * 2).to(torch.int32).reshape(1))
                popped = stack.index_select(0, sp - 1)[0].long()
                nxt = torch.where(vote, torch.remainder(popped, n_rows) + 1, cur + 2)
        acc = r
        n_votes += vote.long()
        cur = nxt
    return acc, torch.stack([cur, n_votes]).to(torch.int32)


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def measure(device: torch.device, say=print) -> dict:
    """``_visit.measure_variants`` at CHECK_ITERS, ITERS and SLOPE_ITERS
    on ``make_data``'s and ``make_vote_data``'s tables (``wide_x``'s and
    ``smem_stack``'s values overflow at ITERS; ValueError unless all are
    finite at CHECK_ITERS); adds visits (those made at ITERS) to its
    results."""
    out = _visit.measure_variants("visit_body", visit_body, visit_body_plain, VARIANTS,
                                  make_data(device), make_vote_data(device),
                                  (CHECK_ITERS, ITERS, SLOPE_ITERS), LAUNCHES, say)
    for v, r in out.items():
        if r["check_finite"] != RAYS:
            raise ValueError(f"visit_body {v}: o is not finite at {CHECK_ITERS} visits")
        r["visits"] = _visit.block_visits(ITERS)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("visit_bodies: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

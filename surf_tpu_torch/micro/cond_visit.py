"""A branch between a visit's two bodies: the card's version of
``scripts/tpu_cond_micro.py`` (``make`` ``:64``, ``slab8`` ``:29``, ``mt8``
``:45``, its ``pl.pallas_call`` at ``:110``).

One packet of 1024 values x visits rows of a 512-row U(0, 1) table whose
int32 lane 9 is a 0/1 leaf flag, in blocks of 16 visits while the
visit counter < iters, from cursor 3.  A visit at cursor i reads row
i % 512 and runs, on a leaf row, ``mt8`` (8 toy Möller–Trumbore tests,
lanes 16k + 0..8: acc += t where one hits), else ``slab8`` (8 toy slab
tests, lanes 16k + 0..5: acc += x where the planes cross); then the
packet's vote "some value's acc > x" sets the cursor to i + 1, else
i + 2.  Variants:

- ``both``: every visit runs both bodies and selects by the flag (the
  shipped kernel's shape);
- ``cond``: a branch on the flag runs one body (``lax.cond``; on the card
  an ``if`` on the block-uniform flag).

Outputs: ``o`` (acc after the loop) and ``state`` = (the end cursor, the
visits whose vote was set).  The data is the script's (``make_data``,
``default_rng(0)``, ``:100-106``), on which the vote fails only on the
first visits, while acc is 0; on ``make_vote_data``'s it fails often.  Run
on the card:

    python -m surf_tpu_torch.micro.cond_visit

which holds each kernel to its plain version at CHECK_ITERS visits on both
data sets and at ITERS, then times it at both SLOPE_ITERS and prints ms,
ns a visit by slope and the checksum (``measure``; ``chip_smoke.py`` phase
9 calls it too).
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel import _build
from . import _visit
from ._visit import D_ROWS, LANE, LEAF_LANE, RAYS, REC

VARIANTS = ("both", "cond")
ITERS = 2048                  # the script's visits
SLOPE_ITERS = (ITERS, 3 * ITERS)
CHECK_ITERS = 64              # visits of the kernel-vs-plain check
START = 3                     # the cursor's start
EPS = 1e-5                    # the script's float32 constant
MISS_ROWS = 64                # make_vote_data's rows that miss every value

# Kernel launches since the last reset, per entry point of shape_micro.cu.
LAUNCHES = dict.fromkeys(_build.COND_ENTRY_POINTS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def lanes(variant: str, leaf: bool) -> set:
    """The lanes of a row a visit reads: the flag and both bodies' (``both``)
    or its flag's body's."""
    n = 9 if leaf or variant == "both" else 6
    return {LEAF_LANE} | {REC * k + j for k in range(8) for j in range(n)}


def make_data(device: torch.device):
    """(table [512, 128], x [1024]) as ``tpu_cond_micro.main`` draws them
    from ``default_rng(0)`` (``:100-106``): U(0, 1) rows, lane 9 the int32
    0/1 flag, then x U(0, 1)."""
    rng = np.random.default_rng(0)
    rows = rng.random((D_ROWS, LANE)).astype(np.float32)
    rows[:, LEAF_LANE] = np.frombuffer(
        rng.integers(0, 2, D_ROWS, dtype=np.int32).tobytes(), dtype=np.float32)
    x = rng.random((8, LANE)).astype(np.float32).reshape(-1)
    return torch.from_numpy(rows).to(device), torch.from_numpy(x).to(device)


def make_vote_data(device: torch.device):
    """(table, x) on which the vote fails often: the script's data with rows
    0 .. MISS_ROWS - 1 made to miss every value (boxes [10, 10] x [0, 0] x
    [0, 0], records whose determinant is 0; lane 9, the flag, kept).  acc
    then stays 0 and the vote fails, stepping the cursor by 2, until it
    leaves those rows: at 64 visits 34 votes fail (acc only grows, so
    once some value's acc > x the vote holds)."""
    table, x = make_data(torch.device("cpu"))
    rec = table[:MISS_ROWS].view(MISS_ROWS, 8, REC)
    rec[:, :, :9] = 0.0
    rec[:, :, 0] = rec[:, :, 3] = 10.0
    return table.to(device), x.to(device)


def cond_visit(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS):
    """(o [1024], state [2] int32 = (end cursor, visits whose vote was set))
    after the visit loop of ``iters``: the kernel for CUDA tensors, the
    plain version for CPU ones."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    if not _visit.on_card(table.device, "cond_visit"):
        return cond_visit_plain(table, x, variant, iters)
    dev = table.device
    o = torch.empty(RAYS, dtype=torch.float32, device=dev)
    state = torch.empty(2, dtype=torch.int32, device=dev)
    _visit.launch(f"cond_visit_{variant}", LAUNCHES, dev, table, table.shape[0], x, iters, o,
                  state)
    return o, state


def slab8(row: torch.Tensor, x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``slab8`` (``:29-42``): acc + x for each of the row's 8 boxes that
    the planes cross, added one by one."""
    hit = _visit.toy_cross(row.view(8, REC)[:, :6], x)
    r = acc
    for k in range(8):
        r = torch.where(hit[:, k], r + x, r)
    return r


def mt8(row: torch.Tensor, x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``mt8`` (``:45-61``): acc + t for each of the row's 8 toy records
    that hits, added one by one; every op rounded on its own, the
    division IEEE."""
    f = row.view(8, REC)[:, :9]
    xc = x[:, None]
    one = torch.ones((), device=x.device)
    eps = torch.tensor(EPS, dtype=torch.float32, device=x.device)
    hx = xc * f[:, 7] - xc * f[:, 8]
    hy = xc * f[:, 6] - xc * f[:, 5]
    hz = xc * f[:, 3] - xc * f[:, 4]
    a = f[:, 0] * hx + f[:, 1] * hy + f[:, 2] * hz
    det = one / a
    u = det * (hx + hy - hz)
    v = det * (hx * f[:, 6] + hy * f[:, 7] + hz * f[:, 8])
    t = det * (u + v)
    ok = (a.abs() > eps) & (u >= 0) & (v >= 0) & (u + v <= one) & (t > eps)
    r = acc
    for k in range(8):
        r = torch.where(ok[:, k], r + t[:, k], r)
    return r


def cond_visit_plain(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS,
                     seen: torch.Tensor | None = None, leaf_visits: torch.Tensor | None = None):
    """Plain PyTorch version of the kernels: the visits one by one, the
    cursor a device tensor.  ``both`` selects between both bodies with
    ``torch.where``; ``cond`` reads the flag on the host and runs one.
    Where ``seen`` ([D, 16] bool: a row's 32-byte sectors) is given, marks
    the sectors read; where ``leaf_visits`` (0-d int64) is, adds the visits
    to leaf rows."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    dev, n_rows = table.device, table.shape[0]
    flags = (table.view(torch.int32)[:, LEAF_LANE] & 1) == 1
    sectors = {leaf: torch.tensor(sorted({lane // 8 for lane in lanes(variant, leaf)}),
                                  device=dev) for leaf in (False, True)}
    acc = x * 0.0
    cur = torch.tensor(START, dtype=torch.int64, device=dev)
    n_votes = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(_visit.block_visits(iters)):
        pc = cur % n_rows
        row = table.index_select(0, pc.reshape(1))[0]
        is_leaf = flags[pc]
        if leaf_visits is not None:
            leaf_visits += is_leaf.long()
        if variant == "both":
            if seen is not None:
                seen[pc, sectors[True]] = True
            acc = torch.where(is_leaf, mt8(row, x, acc), slab8(row, x, acc))
        else:
            leaf = bool(is_leaf)
            if seen is not None:
                seen[pc, sectors[leaf]] = True
            acc = mt8(row, x, acc) if leaf else slab8(row, x, acc)
        vote = (acc > x).any()
        n_votes += vote.long()
        cur = torch.where(vote, cur + 1, cur + 2)
    return acc, torch.stack([cur, n_votes]).to(torch.int32)


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def measure(device: torch.device, say=print) -> dict:
    """``_visit.measure_variants`` at CHECK_ITERS, ITERS and SLOPE_ITERS
    on ``make_data``'s and ``make_vote_data``'s tables, counting the
    visits to leaf rows at ITERS (leaf_visits); adds visits (those made at
    ITERS) to its results."""
    out = _visit.measure_variants("cond_visit", cond_visit, cond_visit_plain, VARIANTS,
                                  make_data(device), make_vote_data(device),
                                  (CHECK_ITERS, ITERS, SLOPE_ITERS), LAUNCHES, say,
                                  counters=("leaf_visits",))
    for r in out.values():
        r["visits"] = _visit.block_visits(ITERS)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("cond_visit: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

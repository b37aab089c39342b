"""What reading a lane of a row and a vector op cost: the card's version
of ``scripts/tpu_extract_micro.py`` (``make(n_extract, n_vop)`` ``:26``,
its ``pl.pallas_call`` at ``:65``, the cases ``:61-62``).

One packet of 1024 values x makes ``iters`` visits in blocks of 16 from
cursor 3.  A visit at cursor i reads lanes 0..n_e-1 of row i % 512 and adds
each as r = r + f * x, then runs n_v links r = r * 0.9999 + x; the packet's
vote "some value's r > x" moves the cursor by 1, else by 2.  Variants
``e<n_e>_v<n_v>``, the script's cases: n_e 8, 32, 64, 128 with n_v 0, and
n_v 56, 120, 248 with n_e 8.  The TPU's vector-to-scalar extracts are, on
the card, loads of the row's lanes that every thread makes (float4 loads
through the read-only path, ``csrc/op_micro.cu``); every multiply and add
rounds on its own (no FFMA, checked in the SASS by ``chip_smoke.py``).

Outputs: ``o`` (acc after the loop) and, what the script lacks, ``state``
= (the end cursor, the visits whose vote was set).  The data is the
script's (rows U(0, 1) * 1e-3, x U(0, 1), from ``default_rng(0)``).  On it
r/x is the same on every lane, so the vote is false (a step of 2) until
the visits' sums pass 1 and set from then on: after 15 visits at n_e 128
and 31 at 64 (at 32 visits 17 and 1 votes set, none at 8 and 32), about
250 at 8.  On ``make_vote_data``'s signed rows the vote changes from visit
to visit where n_v is 0.  Run on the card:

    python -m surf_tpu_torch.micro.lane_extract

which holds each kernel to its plain version at CHECK_ITERS visits on
both data sets, then times it at both SLOPE_ITERS and prints ms, ns a
visit by slope and the checksum (``measure``; ``chip_smoke.py`` phase 11
calls it too).
"""

from __future__ import annotations

import numpy as np
import torch

from ..accel import _build
from . import _visit
from ._visit import D_ROWS, LANE, RAYS

CASES = ((8, 0), (32, 0), (64, 0), (128, 0), (8, 56), (8, 120), (8, 248))
VARIANTS = tuple(f"e{e}_v{v}" for e, v in CASES)
ITERS = 2048                  # the script's visits
SLOPE_ITERS = (ITERS, 3 * ITERS)
CHECK_ITERS = 32              # visits of the kernel-vs-plain check
START = 3                     # the first cursor
DECAY = 0.9999                # a vector op's factor

# Kernel launches since the last reset, per entry point of op_micro.cu.
LAUNCHES = dict.fromkeys(_build.EXTRACT_ENTRY_POINTS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def case(variant: str) -> tuple[int, int]:
    """(n_e, n_v) of a variant."""
    return CASES[VARIANTS.index(variant)]


def make_data(device: torch.device):
    """(table [512, 128], x [1024]) as ``tpu_extract_micro.main`` draws them
    (``:50-51``): rows U(0, 1) in float32 times 1e-3, then x, from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    rows = rng.random((D_ROWS, LANE)).astype(np.float32) * np.float32(1e-3)
    x = rng.random((8, 128)).astype(np.float32).reshape(-1)
    return torch.from_numpy(rows).to(device), torch.from_numpy(x).to(device)


def make_vote_data(device: torch.device):
    """(table, x) on which the vote of the n_v = 0 cases changes from visit
    to visit: rows U(-1, 1), then x U(0, 1), from ``default_rng(0)``, drawn
    in float64 and rounded to float32 once.  r is x times the running sum
    S of the lanes read (one S for every value), so the vote is S > 1, and
    S wanders across 1 (the n_v = 0 cases set 32, 5, 3 and 7 votes in 32
    visits, 40, 20, 7 and 7 in 64); where n_v > 0 the links add about n_v x
    a visit and the vote is set from the first visit on."""
    rng = np.random.default_rng(0)
    rows = rng.uniform(-1, 1, (D_ROWS, LANE)).astype(np.float32)
    x = rng.random((8, 128)).astype(np.float32).reshape(-1)
    return torch.from_numpy(rows).to(device), torch.from_numpy(x).to(device)


def lane_extract(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS):
    """(o [1024], state [2] int32 = (end cursor, visits whose vote was set))
    after the visits of ``iters`` (whole blocks of 16): the kernel for CUDA
    tensors, the plain version for CPU ones."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    if not _visit.on_card(table.device, "lane_extract"):
        return lane_extract_plain(table, x, variant, iters)
    dev = table.device
    o = torch.empty(RAYS, dtype=torch.float32, device=dev)
    state = torch.empty(2, dtype=torch.int32, device=dev)
    _visit.launch(f"lane_extract_{variant}", LAUNCHES, dev, table, table.shape[0], x, iters, o,
                  state)
    return o, state


def lane_extract_plain(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS):
    """Plain PyTorch version of the kernels: the visits one by one, the
    cursor read back to the host at every visit."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    n_e, n_v = case(variant)
    decay = torch.tensor(DECAY, dtype=torch.float32, device=x.device)
    acc = x * 0.0
    cur, votes = START, 0
    for _ in range(_visit.block_visits(iters)):
        row = table[cur % table.shape[0]]
        for j in range(n_e):
            acc = acc + row[j] * x
        for _ in range(n_v):
            acc = acc * decay + x
        vote = bool((acc > x).any())
        votes += vote
        cur = cur + 1 if vote else cur + 2
    return acc, torch.tensor([cur, votes], dtype=torch.int32, device=x.device)


def measure(device: torch.device, say=print) -> dict:
    """``_visit.measure_checked`` at CHECK_ITERS on the script's data and
    on ``make_vote_data``'s, timed at SLOPE_ITERS (whole blocks: the visits
    are the size)."""
    return _visit.measure_checked(
        "lane_extract", lane_extract, lane_extract_plain, VARIANTS,
        (make_data(device), make_vote_data(device)), CHECK_ITERS, SLOPE_ITERS, LAUNCHES, say)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("lane_extract: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

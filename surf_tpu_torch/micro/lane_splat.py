"""Ways to hand one lane of a fetched row to every thread: the card's
version of ``scripts/tpu_splat_micro.py`` (``make_kernel`` ``:26``, the
six splats ``:42-67``, its ``pl.pallas_call`` at ``:85``).

All six splats compute one function, ``tpu_visit_micro.py``'s ``base``
(``visit_parts``): ``iters`` visits, visit i reading lanes 0-8 of row
i % 512 and running the chain r = r + f * x', x' = (r > f ? x' : r) from
r = acc, x' = x.  So the plain version is ``visit_parts_plain(table, x,
"base", iters)``.  The TPU's ways of splatting a lane over its (8, 128)
tile have no counterpart on the card; each entry point hands the lane to
every thread another way (``csrc/op_micro.cu``, ``Splat``):

- ``scalar_extract``: a plain load with a warp-uniform address (LDG.E);
- ``bcast_1x128``: the read-only path, ``__ldg`` (LDG.E.CONSTANT);
- ``rep_then_slice``: lanes 0-8 staged in shared memory once a visit
  behind one block barrier, then read by every thread (an LDS broadcast);
- ``concat_then_slice``: one shared copy per warp behind ``__syncwarp``,
  no block barrier;
- ``repeat_prim``: lanes 0-8 spread over a warp's lanes, then
  ``__shfl_sync(v, j)``;
- ``roll_lane0``: the TPU's rotate-then-lane-0, ``__shfl_down_sync`` by j
  and then a shuffle from lane 0 (the script's own ``roll_lane0`` rolls by
  a static negative shift, which ``pltpu.roll`` refuses; ROADMAP queue 3).

Outputs: ``o`` (acc after the loop) and ``state`` = (the end cursor, 0),
as ``visit_parts``.  The script's data is unseeded (``np.random.rand``,
``:81-82``); ``make_data`` is ``visit_parts.make_data``, the same draw from
``default_rng(0)``.  Run on the card:

    python -m surf_tpu_torch.micro.lane_splat

which holds each kernel to the plain version at CHECK_ITERS visits on
the script's data and on ``visit_parts.make_vote_data``'s signed rows,
then times it at both SLOPE_ITERS and prints ms, ns a visit by slope and
the checksum (``measure``; ``chip_smoke.py`` phase 11 calls it too).
"""

from __future__ import annotations

import torch

from ..accel import _build
from . import _visit, visit_parts
from ._visit import RAYS

VARIANTS = ("scalar_extract", "bcast_1x128", "rep_then_slice", "concat_then_slice",
            "repeat_prim", "roll_lane0")
ITERS = 4096                  # the script's visits
SLOPE_ITERS = (ITERS, 3 * ITERS)
CHECK_ITERS = 64              # visits of the kernel-vs-plain check

# Kernel launches since the last reset, per entry point of op_micro.cu.
LAUNCHES = dict.fromkeys(_build.SPLAT_ENTRY_POINTS, 0)

make_data = visit_parts.make_data


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def lane_splat(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS):
    """(o [1024], state [2] int32 = (end cursor, 0)) after ``iters`` visits:
    the kernel of ``variant`` for CUDA tensors, the plain version for CPU
    ones."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    if not _visit.on_card(table.device, "lane_splat"):
        return lane_splat_plain(table, x, variant, iters)
    dev = table.device
    o = torch.empty(RAYS, dtype=torch.float32, device=dev)
    state = torch.empty(2, dtype=torch.int32, device=dev)
    _visit.launch(f"lane_splat_{variant}", LAUNCHES, dev, table, table.shape[0], x, iters, o,
                  state)
    return o, state


def lane_splat_plain(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS):
    """The plain version of every variant: ``visit_parts``' ``base``."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    return visit_parts.visit_parts_plain(table, x, "base", iters)


def measure(device: torch.device, say=print) -> dict:
    """``_visit.measure_checked`` at CHECK_ITERS on the script's data and
    the signed rows of ``visit_parts.make_vote_data``, timed at
    SLOPE_ITERS."""
    return _visit.measure_checked(
        "lane_splat", lane_splat, lane_splat_plain, VARIANTS,
        (make_data(device), visit_parts.make_vote_data(device)), CHECK_ITERS, SLOPE_ITERS,
        LAUNCHES, say)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("lane_splat: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

"""Building the per-child hit mask in the walk's visit: the card's version
of ``scripts/tpu_reduce_micro.py`` (``make``, its ``pl.pallas_call`` at
``:80``).

One packet of 1024 values x and accumulators a (a = 0.001 x at the start)
visits rows in blocks of 16 visits while the visit counter < iters.
A visit at cursor i reads row i % 512; child k < 8 hits for a value where
a * row[k] > x; the packet's 8-bit mask is built three ways (the modes,
in the script's order):

- ``eight_any``: one any-reduce per child (the card: 8 block votes,
  ``__syncthreads_or``);
- ``or_reduce``: one bitwise-OR reduce of a per-value packed word (the
  card: a warp ``__reduce_or_sync`` and an OR across warps in shared
  memory);
- ``max_byte``: one max-reduce of the word (the card: ``__reduce_max_sync``
  and a max across warps), which equals the OR only where the values'
  words are nested;

then a += 0.001 x mask and the cursor moves by 1 if mask > 4, else by 2.
Outputs: ``o`` (a after the loop) and the end cursor.  On the script's
data (``make_data``: rows and x U(0, 1) from ``default_rng(0)``) no child
ever hits (a * row[k] > x needs row[k] > 1000 at the start), every mask
is 0 and the three modes give one result; ``make_mixed_data`` (rows 2000
U(0, 1), x U(-1, 1)) gives masks that are non-zero and not nested: a
value with x < 0 hits the children with row[k] < 1000 at the start, one
with x > 0 those above, so ``max_byte`` departs there.  Run on the card:

    python -m surf_tpu_torch.micro.mask_reduce

which holds each kernel to its plain version at ITERS visits on both
data sets, then times it on the script's at both SLOPE_ITERS and prints
ms, ns a visit by slope and the checksum sum(o) (``measure``;
``chip_smoke.py`` phase 8 calls it too).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..accel import _build
from . import _visit
from ._visit import D_ROWS, LANE, RAYS

VARIANTS = ("eight_any", "or_reduce", "max_byte")
ITERS = 2048                  # the script's visits
SLOPE_ITERS = (ITERS, 3 * ITERS)
MILLI = 0.001                 # the script's float32 constant

# Kernel launches since the last reset, per entry point of visit_micro.cu.
LAUNCHES = dict.fromkeys(_build.MASK_ENTRY_POINTS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def lanes(variant: str) -> set:
    """The lanes of a row a visit reads."""
    return set(range(8))


def make_data(device: torch.device):
    """(table [512, 128], x [1024]) as ``tpu_reduce_micro.main`` draws them
    from ``default_rng(0)`` (``:75-77``): U(0, 1) in float64, then
    float32."""
    rng = np.random.default_rng(0)
    rows = rng.random((D_ROWS, LANE)).astype(np.float32)
    x = rng.random((8, 128)).astype(np.float32).reshape(-1)
    return torch.from_numpy(rows).to(device), torch.from_numpy(x).to(device)


def make_mixed_data(device: torch.device):
    """(table, x) on which the masks are non-zero and not nested: rows 2000
    U(0, 1) and x U(-1, 1), from ``default_rng(0)`` (rows first), drawn in
    float64 and rounded to float32 once."""
    rng = np.random.default_rng(0)
    rows = (2000 * rng.random((D_ROWS, LANE))).astype(np.float32)
    x = rng.uniform(-1, 1, (8, 128)).astype(np.float32).reshape(-1)
    return torch.from_numpy(rows).to(device), torch.from_numpy(x).to(device)


def mask_reduce(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS):
    """(o [1024], end [1]) after the visit loop of ``iters``: the kernel for
    CUDA tensors, the plain version for CPU ones."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    if not _visit.on_card(table.device, "mask_reduce"):
        return mask_reduce_plain(table, x, variant, iters)
    dev = table.device
    o = torch.empty(RAYS, dtype=torch.float32, device=dev)
    end = torch.empty(1, dtype=torch.int32, device=dev)
    _visit.launch(f"mask_reduce_{variant}", LAUNCHES, dev, table, table.shape[0], x, iters, o,
                  end)
    return o, end


def mask_reduce_plain(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS,
                      seen: torch.Tensor | None = None):
    """Plain PyTorch version of the kernels: the visits one by one, the
    cursor a device tensor (no host read).  ``eight_any``'s sum of one bit
    per child that some value hits and ``or_reduce``'s OR of the values'
    words are both the bits that some value sets.  Where ``seen`` ([D]
    bool) is given, marks the rows read."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    dev = table.device
    bit = 1 << torch.arange(8, dtype=torch.int32, device=dev)
    milli = torch.tensor(MILLI, dtype=torch.float32, device=dev)
    a = x * milli
    ax = milli * x
    cur = torch.tensor([3], dtype=torch.int64, device=dev)
    for _ in range(_visit.block_visits(iters)):
        pc = cur % table.shape[0]
        if seen is not None:
            seen[pc] = True
        f = table.index_select(0, pc)[0, :8]
        hits = a[:, None] * f > x[:, None]                # [R, 8]
        if variant == "max_byte":
            mask = (hits.int() * bit).sum(1).max()
        else:
            mask = (hits.any(0).int() * bit).sum()
        a = a + ax * mask.float()
        cur = torch.where(mask > 4, cur + 1, cur + 2)
    return a, cur.to(torch.int32)


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def measure(device: torch.device, say=print) -> dict:
    """Per variant: the kernel against its plain version at ITERS visits on
    the script's data and on ``make_mixed_data``'s (every output bit-equal,
    else ValueError), the plain version timed on the script's; then, with
    the launch counts reset just before, the kernel's least ms of 3 calls at
    both SLOPE_ITERS on the script's data, its launches in those runs and
    the slope in ns a visit.  Returns per variant ms (at ITERS), plain_ms,
    launches, slope_ns, checksum (sum of o), visits and rows (the distinct
    rows read at ITERS)."""
    data = make_data(device)
    mixed = make_mixed_data(device)
    out = {}
    for v in VARIANTS:
        got = mask_reduce(*data, v, ITERS)
        seen = torch.zeros(data[0].shape[0], dtype=torch.bool, device=device)
        t0 = time.perf_counter()
        want = mask_reduce_plain(*data, v, ITERS, seen)
        torch.cuda.synchronize()
        out[v] = dict(plain_ms=(time.perf_counter() - t0) * 1e3, rows=int(seen.sum()),
                      checksum=float(got[0].sum()))
        _visit.same(got, want, f"mask_reduce {v} at {ITERS} visits")
        got_m = mask_reduce(*mixed, v, ITERS)
        _visit.same(got_m, mask_reduce_plain(*mixed, v, ITERS),
                    f"mask_reduce {v} on the mixed data")
        out[v]["mixed"] = (float(got_m[0].sum()), int(got_m[1]))
    reset_launches()
    for v in VARIANTS:
        ms = [_visit.least_ms(lambda n=n: mask_reduce(*data, v, n)) for n in SLOPE_ITERS]
        slope = _visit.slope_ns(ms, SLOPE_ITERS)
        out[v].update(ms=ms[0], launches=LAUNCHES[f"mask_reduce_{v}"], slope_ns=slope,
                      visits=_visit.block_visits(ITERS))
        mixed_sum, mixed_end = out[v].pop("mixed")
        say(f"[mask_reduce] {v}: bit-identical to plain at {ITERS} visits on both data sets "
            f"(plain {out[v]['plain_ms']:.1f} ms; mixed data: sum(o) {mixed_sum!r}, end "
            f"{mixed_end}); {SLOPE_ITERS[0]} / {SLOPE_ITERS[1]} visits {ms[0]:.4f} / "
            f"{ms[1]:.4f} ms, slope {slope:.2f} ns/visit, checksum={out[v]['checksum']!r}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mask_reduce: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

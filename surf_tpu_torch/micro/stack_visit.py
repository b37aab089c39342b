"""A stack push and pop in the walk's visit: the card's version of
``scripts/tpu_stack_micro.py`` (``make``, its ``pl.pallas_call`` at
``:81``, scratch ``(256, 128)`` int32 at ``:86``).

One packet of 1024 values x visits rows of a 512-row U(0, 1) table in
blocks of 16 visits while the visit counter < iters.  A visit at
cursor i reads row i % 512, runs a toy 8-child slab that accumulates into
acc (``_slab8_extract``: r = acc + the sum over children of x where the
child's planes cross, else acc), takes the packet's vote "some value's
r > x", pushes the n values i * 8 + q at min(sp + q, 255), sets sp =
min(sp + (vote ? n : 1), 200), pops the entry at max(sp - 1, 0), moves
the cursor to (top + i) mod 4096 + 1 and sets sp = max(sp - 1, 1).
Variants ``push0``, ``push1``, ``push2``, ``push4``: n = 0, 1, 2, 4.

Outputs: ``o`` (acc after the loop) and ``state`` = (the end cursor, the
stack pointer).  Only the scratch's row 0 is zeroed (``:42``), so a pop
can read an entry never written: Pallas's interpret mode fills scratch
with -2147483648, and the port fills entries 1-255 with the same value,
so that the plain version and the kernel agree on any data; the modulo is
a floor modulo, as JAX's ``%``.  ``acc`` grows about ninefold a visit and
overflows: all 1024 values are finite at 32 visits (CHECK_ITERS), not at
the script's 2048, so outputs are compared at 32.  The script's data is
unseeded (``np.random.rand``, ``:77-78``): the port draws it from
``default_rng(0)`` in the script's order.  On the card the TPU's VMEM row
stack is a 256-entry int32 stack in shared memory, one copy a warp
(``csrc/visit_micro.cu``).  Run on the card:

    python -m surf_tpu_torch.micro.stack_visit

which holds each kernel to its plain version at CHECK_ITERS visits, then
times it at ITERS and SLOPE_ITERS[1] visits and prints ms, ns a visit by
slope and the end state (``measure``; ``chip_smoke.py`` phase 8 calls it
too).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..accel import _build
from . import _visit
from ._visit import D_ROWS, LANE, RAYS, REC

VARIANTS = ("push0", "push1", "push2", "push4")
ITERS = 2048                  # the script's visits
SLOPE_ITERS = (ITERS, 3 * ITERS)
CHECK_ITERS = 32              # visits of the kernel-vs-plain check
STACK = 256                   # the scratch's rows
SP_MAX = 200
UNWRITTEN = -2**31            # an entry never pushed

# Kernel launches since the last reset, per entry point of visit_micro.cu.
LAUNCHES = dict.fromkeys(_build.STACK_ENTRY_POINTS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pushes(variant: str) -> int:
    return int(variant[len("push"):])


def lanes(variant: str) -> set:
    """The lanes of a row a visit reads."""
    return {REC * k + i for k in range(8) for i in range(6)}


def make_data(device: torch.device):
    """(table [512, 128], x [1024]) drawn as ``tpu_stack_micro.main`` draws
    them (``:77-78``, U(0, 1) in float64, then float32), from
    ``default_rng(0)`` in place of its unseeded ``np.random.rand``."""
    rng = np.random.default_rng(0)
    rows = rng.random((D_ROWS, LANE)).astype(np.float32)
    x = rng.random((8, 128)).astype(np.float32).reshape(-1)
    return torch.from_numpy(rows).to(device), torch.from_numpy(x).to(device)


def stack_visit(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS):
    """(o [1024], state [2] int32 = (end cursor, stack pointer)) after the
    visit loop of ``iters``: the kernel for CUDA tensors, the plain version
    for CPU ones."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    if not _visit.on_card(table.device, "stack_visit"):
        return stack_visit_plain(table, x, variant, iters)
    dev = table.device
    o = torch.empty(RAYS, dtype=torch.float32, device=dev)
    state = torch.empty(2, dtype=torch.int32, device=dev)
    _visit.launch(f"stack_visit_{variant}", LAUNCHES, dev, table, table.shape[0], x, iters, o,
                  state)
    return o, state


def stack_visit_plain(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS,
                      seen: torch.Tensor | None = None):
    """Plain PyTorch version of the kernels: the visits one by one, the
    cursor, the stack pointer and the stack device tensors (no host
    read).  Where ``seen`` ([D] bool) is given, marks the rows read."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    dev = table.device
    n = pushes(variant)
    boxes = table.view(table.shape[0], 8, REC)[:, :, :6]
    acc = x * 0.0
    stack = torch.full((STACK,), UNWRITTEN, dtype=torch.int32, device=dev)
    stack[0] = 0
    cur = torch.tensor([3], dtype=torch.int64, device=dev)
    sp = torch.tensor([1], dtype=torch.int64, device=dev)
    for _ in range(_visit.block_visits(iters)):
        pc = cur % table.shape[0]
        if seen is not None:
            seen[pc] = True
        r = _visit.slab8_extract(boxes.index_select(0, pc)[0], x, acc)
        hot = (r > x).any()
        for q in range(n):
            stack.index_put_(((sp + q).clamp(max=STACK - 1),), (cur * 8 + q).to(torch.int32))
        sp = (sp + torch.where(hot, n, 1)).clamp(max=SP_MAX)
        top = stack.index_select(0, (sp - 1).clamp(min=0))
        cur = torch.remainder(top.long() + cur, table.shape[0] * 8) + 1
        sp = (sp - 1).clamp(min=1)
        acc = r
    return acc, torch.cat([cur, sp]).to(torch.int32)


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def measure(device: torch.device, say=print) -> dict:
    """Per variant: the kernel against its plain version at CHECK_ITERS
    visits (every output bit-equal, else ValueError), the plain version
    timed there; then, with the launch counts reset just before, the
    kernel's least ms of 3 calls at both SLOPE_ITERS, its launches in those
    runs and the slope in ns a visit; then the plain version at ITERS for
    the rows it reads and its end state, which the kernel's must equal.
    Returns per variant ms (at ITERS), plain_ms, launches, slope_ns,
    visits and rows (the distinct rows read at ITERS)."""
    table, x = make_data(device)
    out = {}
    for v in VARIANTS:
        got = stack_visit(table, x, v, CHECK_ITERS)
        t0 = time.perf_counter()
        want = stack_visit_plain(table, x, v, CHECK_ITERS)
        torch.cuda.synchronize()
        out[v] = dict(plain_ms=(time.perf_counter() - t0) * 1e3)
        _visit.same(got, want, f"stack_visit {v} at {CHECK_ITERS} visits")
        if not bool(torch.isfinite(got[0]).all()):
            raise ValueError(f"stack_visit {v}: o is not finite at {CHECK_ITERS} visits")
    reset_launches()
    for v in VARIANTS:
        ms = [_visit.least_ms(lambda n=n: stack_visit(table, x, v, n)) for n in SLOPE_ITERS]
        out[v].update(ms=ms[0], launches=LAUNCHES[f"stack_visit_{v}"],
                      slope_ns=_visit.slope_ns(ms, SLOPE_ITERS), ms_slope=ms)
    for v in VARIANTS:
        res = stack_visit(table, x, v, ITERS)
        seen = torch.zeros(table.shape[0], dtype=torch.bool, device=device)
        plain = stack_visit_plain(table, x, v, ITERS, seen)
        if not torch.equal(res[1], plain[1]):
            raise ValueError(f"stack_visit {v}: end state {res[1].tolist()} at {ITERS} visits, "
                             f"plain {plain[1].tolist()}")
        ms = out[v].pop("ms_slope")
        out[v].update(visits=_visit.block_visits(ITERS), rows=int(seen.sum()))
        say(f"[stack_visit] {v}: bit-identical to plain at {CHECK_ITERS} visits (plain "
            f"{out[v]['plain_ms']:.1f} ms); {SLOPE_ITERS[0]} / {SLOPE_ITERS[1]} visits "
            f"{ms[0]:.4f} / {ms[1]:.4f} ms, slope {out[v]['slope_ns']:.2f} ns/visit; end "
            f"(cursor, sp) {res[1].tolist()} as plain's, {out[v]['rows']} rows read, "
            f"{int(torch.isfinite(res[0]).sum())} of {RAYS} values finite")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("stack_visit: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

"""Independent walks interleaved in one loop, and the lane roll's rate: the
card's version of ``scripts/tpu_interleave_micro.py``
(``make_interleaved(n)`` ``:39``, ``make_roll_tput`` ``:71``,
``visit_math`` ``:30``, its ``pl.pallas_call`` at ``:96``).

``serial_any`` and ``inter2``/``4``/``8``/``16``: n walks in one loop of
``iters`` steps.  Walk b starts at cursor 7 b with acc = x (b + 1); each
step runs ``visit_math`` (the chain r = r + f * x', x' = (r > f ? x' :
r) over lanes 0-8 of row cursor % 512, ``visit_parts.visit_math``) from its
acc and moves its cursor by 1 if the packet's vote "some value's r > x" is
set, else by 2; o = the walks' accs summed in order.  On the card the n
walks' votes of a step go into one n-bit block OR (``csrc/vote.cuh``):
one barrier a step whatever n, so the step's cost says whether
interleaving hides the vote's drain.  ``roll_tput``: ``iters`` visits,
visit i reading lane (l + 16 (i & 7)) mod 128 of row i % 512 for lane l
(the TPU's roll by -16 (i & 7): an indexed read on the card, as
``visit_parts``' ``roll``) and adding it times x[l] to acc[l]; value e of o
is acc[e mod 128] (the script's broadcast over 8 sublanes).  No vote.

Outputs: ``o`` and, per walk, ``state`` [walks, 2] = (the end cursor, the
steps whose vote was set) (``roll_tput``: one walk, (iters, 0)).  The
script's data is unseeded (``np.random.rand``, ``:86-87``): ``make_data``
is ``visit_parts.make_data``, the same draw from ``default_rng(0)``.  On it
every vote is set (acc starts at x (b + 1) and r only grows);
``make_vote_data`` is ``visit_parts.make_vote_data``'s signed rows, on
which the votes change.  Run on the card:

    python -m surf_tpu_torch.micro.walk_interleave

which holds each kernel to its plain version at CHECK_ITERS steps on
both data sets, then times it at both SLOPE_ITERS and prints ms, ns a
step by slope and the checksum (``measure``; ``chip_smoke.py`` phase 11
calls it too).
"""

from __future__ import annotations

import torch

from ..accel import _build
from . import _visit, visit_parts
from ._visit import LANE, RAYS

VARIANTS = ("serial_any", "inter2", "inter4", "inter8", "inter16", "roll_tput")
ITERS = 2048                  # the script's steps
SLOPE_ITERS = (ITERS, 3 * ITERS)
CHECK_ITERS = 32              # steps of the kernel-vs-plain check
LINKS = visit_parts.LINKS
ROLL = 16                     # roll_tput's lane offset a step (times i & 7)

# Kernel launches since the last reset, per entry point of op_micro.cu.
LAUNCHES = dict.fromkeys(_build.INTERLEAVE_ENTRY_POINTS, 0)

make_data = visit_parts.make_data
make_vote_data = visit_parts.make_vote_data


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def walks(variant: str) -> int:
    """The walks of a variant: n of ``inter<n>``, else 1."""
    return int(variant[5:]) if variant.startswith("inter") else 1


def walk_interleave(table: torch.Tensor, x: torch.Tensor, variant: str, iters: int = ITERS):
    """(o [1024], state [walks, 2] int32 = (end cursor, votes set) a walk)
    after ``iters`` steps: the kernel for CUDA tensors, the plain version
    for CPU ones."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    if not _visit.on_card(table.device, "walk_interleave"):
        return walk_interleave_plain(table, x, variant, iters)
    dev = table.device
    o = torch.empty(RAYS, dtype=torch.float32, device=dev)
    state = torch.empty(walks(variant), 2, dtype=torch.int32, device=dev)
    _visit.launch(f"walk_interleave_{variant}", LAUNCHES, dev, table, table.shape[0], x, iters,
                  o, state)
    return o, state


def walk_interleave_plain(table: torch.Tensor, x: torch.Tensor, variant: str,
                          iters: int = ITERS):
    """Plain PyTorch version of the kernels: the steps one by one, the
    cursors read back to the host at every step."""
    _visit.check(table, x, (RAYS,), variant, VARIANTS, iters, "x")
    dev, n_rows = table.device, table.shape[0]
    if variant == "roll_tput":
        lanes = torch.arange(LANE, device=dev)
        x0 = x[:LANE]
        acc = x0 * 0.0
        for i in range(iters):
            acc = acc + table[i % n_rows][(lanes + ROLL * (i & 7)) % LANE] * x0
        state = torch.tensor([[iters, 0]], dtype=torch.int32, device=dev)
        return acc.repeat(RAYS // LANE), state
    n = walks(variant)
    cur = [7 * b for b in range(n)]
    votes = [0] * n
    accs = [x * torch.tensor(float(b + 1), device=dev) for b in range(n)]
    for _ in range(iters):
        for b in range(n):
            accs[b], _ = visit_parts.visit_math(table[cur[b] % n_rows], range(LINKS), x, accs[b])
            vote = bool((accs[b] > x).any())
            votes[b] += vote
            cur[b] += 1 if vote else 2
    o = accs[0]
    for a in accs[1:]:
        o = o + a
    return o, torch.tensor(list(zip(cur, votes)), dtype=torch.int32, device=dev)


def measure(device: torch.device, say=print) -> dict:
    """``_visit.measure_checked`` at CHECK_ITERS on the script's data and
    on ``make_vote_data``'s, timed at SLOPE_ITERS (the slope in ns a
    step; a step makes ``walks`` visits)."""
    return _visit.measure_checked(
        "walk_interleave", walk_interleave, walk_interleave_plain, VARIANTS,
        (make_data(device), make_vote_data(device)), CHECK_ITERS, SLOPE_ITERS, LAUNCHES, say,
        unit="step")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("walk_interleave: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

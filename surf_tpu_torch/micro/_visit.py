"""What the walk-visit microbenchmarks (``visit_cost``, ``quant_visit``,
``stack_visit``, ``mask_reduce``; kernels in ``csrc/visit_micro.cu``), the
visit-shape ones (``visit_parts``, ``cond_visit``, ``visit_bodies``;
``csrc/shape_micro.cu``) and the op-cost ones (``lane_splat``,
``lane_extract``, ``walk_interleave``, ``spec_visit``;
``csrc/op_micro.cu``) share: the table's shape, the input checks, the
launch, the slab test's reduction in their plain versions, the
measurement on the card, and, for the kernel an entry point launches,
the count of instructions in its SASS and the readers of a predicate
there."""

from __future__ import annotations

import ctypes
import re
import subprocess
import time
from pathlib import Path

import torch

from ..accel import _build
from .leaf_visit import events_ms

D_ROWS = 512               # the scripts' table rows
LANE = 128
RAYS = 1024                # one (8, 128) packet
REC = 16
LEAF_LANE, SKIP_LANE = 9, 10
FAR = 1e30
K_VISITS = 16              # visits between two tests of the counter


def check(table, vec, vec_shape, variant, variants, n, what, min_rows=1):
    """Raises ValueError unless ``variant`` is one of ``variants``, table is
    a contiguous 16-byte-aligned [D >= min_rows, 128] float32 tensor, ``vec``
    (the rays or x) a contiguous float32 tensor of ``vec_shape`` on the same
    device, and ``n`` (visits or rows) positive."""
    if variant not in variants:
        raise ValueError(f"variant must be one of {variants}, not {variant!r}")
    if table.dim() != 2 or table.shape[1] != LANE or table.shape[0] < min_rows \
            or table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError(f"table must be contiguous [D >= {min_rows}, {LANE}] float32")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    if tuple(vec.shape) != vec_shape or vec.dtype != torch.float32 or not vec.is_contiguous():
        raise ValueError(f"{what} must be contiguous {list(vec_shape)} float32")
    if table.device != vec.device:
        raise ValueError(f"table and {what} lie on different devices")
    if n <= 0:
        raise ValueError(f"the visit count must be positive, not {n}")


def on_card(device: torch.device, what: str) -> bool:
    """False for the CPU (the plain version runs); True for the current
    CUDA device (the kernel runs); raises for any other device."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {device}")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"{device} is not the current CUDA device")
    return True


def launch(name: str, launches: dict, device: torch.device, *args) -> None:
    """Calls entry point ``name`` of the kernel library with ``args``
    (tensors as their pointers) on the current stream, raises if the
    launch failed, and counts it."""
    lib = _build.library()
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(lib, name)(*ptrs, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    launches[name] += 1


def same(got, want, what: str) -> None:
    """Raises ValueError unless every output of a kernel equals its plain
    version's bit for bit."""
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise ValueError(f"{what}: kernel differs from its plain version")


def slab_hits(tn, tf, best_t):
    """The slab test of each ray against each box from its planes' t (tn, tf
    [R, 8, 3], the x, y, z planes): the ray enters before it leaves, before
    best_t [R], and the box is not behind it; [R, 8] bool.  The three axes
    reduce at once: a max or min is exact and a NaN propagates through
    torch's as through the kernels' NaN-propagating min / max, so the
    booleans equal the scripts' x-then-y-then-z order."""
    tmin = torch.minimum(tn, tf).amax(-1)
    tmax = torch.maximum(tn, tf).amin(-1)
    return (tmax >= tmin) & (tmin < best_t[:, None]) & (tmax > 0.0)


def slab8(row, o, inv, best_t, oinv=None):
    """[R, 8 W]: the slab test of the rays against the 8 child boxes (lanes
    16k + 0..5) of each of the W rows in ``row`` ([128 W], W rows end to
    end) with the running best_t; o, inv, oinv are [R, 3].  The planes are
    (lo - o) * inv, or lo * inv - o * inv when ``oinv`` is given
    (``visit_cost``'s ``slabfma``)."""
    box = row.view(-1, REC)[:, :6]
    lo, hi = box[None, :, 0:3], box[None, :, 3:6]
    if oinv is None:
        tn = (lo - o[:, None]) * inv[:, None]
        tf = (hi - o[:, None]) * inv[:, None]
    else:
        tn = lo * inv[:, None] - oinv[:, None]
        tf = hi * inv[:, None] - oinv[:, None]
    return slab_hits(tn, tf, best_t)


def toy_cross(box: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[R, n]: the scripts' toy slab test of each value x [R] against each
    box (box [n, 6]: lo, hi), planes lo0 - x, lo1 * x, lo2 - x and hi's, in
    the scripts' order, NaN-propagating: the planes cross."""
    xc = x[:, None]
    lo0, lo1, lo2, hi0, hi1, hi2 = (box[:, j] for j in range(6))
    tmin = torch.minimum(lo0 - xc, hi0 - xc)
    tmax = torch.maximum(lo0 - xc, hi0 - xc)
    tmin = torch.maximum(tmin, torch.minimum(lo1 * xc, hi1 * xc))
    tmax = torch.minimum(tmax, torch.maximum(lo1 * xc, hi1 * xc))
    tmin = torch.maximum(tmin, torch.minimum(lo2 - xc, hi2 - xc))
    tmax = torch.minimum(tmax, torch.maximum(lo2 - xc, hi2 - xc))
    return tmax >= tmin


def slab8_extract(box: torch.Tensor, x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``_slab8_extract`` (``tpu_stack_micro.py:23``, ``tpu_body_micro.py:69``):
    acc plus, box by box (box [8, 6]), x where the planes cross, else acc."""
    cross = toy_cross(box, x)
    r = acc
    for k in range(box.shape[0]):
        r = r + torch.where(cross[:, k], x, acc)
    return r


def block_visits(iters: int) -> int:
    """The visits of a run of ``iters`` whose loop tests the visit counter
    once a block: whole blocks of K_VISITS."""
    return -(-iters // K_VISITS) * K_VISITS


def row_bytes(lanes) -> int:
    """Bytes of a row that reading ``lanes`` needs: its 32-byte sectors."""
    return 32 * len({lane // 8 for lane in lanes})


def least_ms(fn, calls: int = 3) -> float:
    """The least ms of ``calls`` calls after a warm-up call."""
    fn()
    return min(events_ms(fn) for _ in range(calls))


def slope_ns(ms, sizes) -> float:
    """ns per visit (or row) between two sizes: the launch drops out."""
    return (ms[1] - ms[0]) * 1e6 / (sizes[1] - sizes[0])


def measure_variants(name: str, fn, plain, variants, data, vote_data, sizes, launches: dict,
                     say=print, counters=()) -> dict:
    """The measurement of a visit-shape microbenchmark (``fn`` its wrapper,
    ``plain`` its plain version, entry points ``{name}_{variant}`` counted
    in ``launches``; sizes = (check, iters, (slope0, slope1)) visits).  Per
    variant: the kernel against its plain version (every output bit-equal,
    else ValueError) at ``check`` visits on ``data`` (a second plain call
    timed there) and on ``vote_data``, and at ``iters``, where the plain
    version marks the 32-byte sectors it reads (``seen``) and adds to each
    of ``counters`` (0-d int64 keyword arguments); then, with the launch
    counts reset just before, the kernel's least ms of 3 calls at both
    slope sizes, its launches in those runs and the slope in ns a visit.
    Returns per variant ms (at iters), plain_ms, launches, slope_ns,
    checksum (sum of o at iters), state (end cursor, votes at iters),
    finite and check_finite (o's finite values at iters and at check),
    sectors (distinct sectors read at iters) and the counters."""
    check, iters, slope_sizes = sizes
    device = data[0].device
    out = {}
    for v in variants:
        got = fn(*data, v, check)
        same(got, plain(*data, v, check), f"{name} {v} at {check} visits")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain(*data, v, check)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got_v = fn(*vote_data, v, check)
        same(got_v, plain(*vote_data, v, check), f"{name} {v} on the vote data")
        res = fn(*data, v, iters)
        seen = torch.zeros(data[0].shape[0], 16, dtype=torch.bool, device=device)
        counts = {c: torch.zeros((), dtype=torch.int64, device=device) for c in counters}
        same(res, plain(*data, v, iters, seen=seen, **counts), f"{name} {v} at {iters} visits")
        out[v] = dict(plain_ms=plain_ms, checksum=float(res[0].sum()), state=res[1].tolist(),
                      finite=int(torch.isfinite(res[0]).sum()),
                      check_finite=int(torch.isfinite(got[0]).sum()), sectors=int(seen.sum()),
                      vote_state=got_v[1].tolist(), **{c: int(n) for c, n in counts.items()})
    for k in launches:
        launches[k] = 0
    for v in variants:
        ms = [least_ms(lambda n=n: fn(*data, v, n)) for n in slope_sizes]
        slope = slope_ns(ms, slope_sizes)
        r = out[v]
        r.update(ms=ms[0], launches=launches[f"{name}_{v}"], slope_ns=slope)
        extra = "".join(f", {c} {r[c]}" for c in counters)
        say(f"[{name}] {v}: bit-identical to plain at {check} visits on both data sets and at "
            f"{iters} (plain {r['plain_ms']:.1f} ms; vote data (end, votes) "
            f"{r.pop('vote_state')}; at {iters} (end, votes) {r['state']}, {r['finite']} of "
            f"{RAYS} values finite{extra}); {slope_sizes[0]} / {slope_sizes[1]} visits "
            f"{ms[0]:.4f} / {ms[1]:.4f} ms, slope {slope:.2f} ns/visit, "
            f"checksum={r['checksum']!r}")
    return out


def measure_checked(name: str, fn, plain, variants, data_sets, check: int, sizes, launches: dict,
                    say=print, work=None, unit: str = "visit") -> dict:
    """The measurement of an op-cost microbenchmark (``fn`` its wrapper,
    ``plain`` its plain version, both called as (*data, variant, n);
    entry points ``{name}_{variant}`` counted in ``launches``).  Per
    variant: the kernel against its plain version at ``check`` on each of
    ``data_sets`` (every output bit-equal, else ValueError; the plain call
    on the first set timed); then, with the launch counts reset just
    before, the kernel's least ms of 3 single calls at both ``sizes`` on
    the first set, its launches in those runs, and the slope in ns a
    ``unit`` of ``work(variant, outputs, n)`` (default n) between them.
    Returns per variant ms (at sizes[0]), plain_ms, launches, slope_ns,
    checksum (the sum of the first output at sizes[0]), finite (its
    finite values), state (the last output there, as a list), work (at
    sizes[0]) and checks (the last output at ``check`` per data set)."""
    work = work or (lambda v, res, n: n)
    out = {}
    for v in variants:
        checks = []
        for k, data in enumerate(data_sets):
            got = fn(*data, v, check)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain(*data, v, check)
            torch.cuda.synchronize()
            if k == 0:
                plain_ms = (time.perf_counter() - t0) * 1e3
            same(got, want, f"{name} {v} at {check} on data set {k}")
            checks.append(got[-1].tolist())
        out[v] = dict(plain_ms=plain_ms, checks=checks)
    for k in launches:
        launches[k] = 0
    data = data_sets[0]
    for v in variants:
        ms = [least_ms(lambda n=n: fn(*data, v, n)) for n in sizes]
        res = [fn(*data, v, n) for n in sizes]
        w = [work(v, r, n) for r, n in zip(res, sizes)]
        slope = slope_ns(ms, w)
        r = out[v]
        r.update(ms=ms[0], launches=launches[f"{name}_{v}"], slope_ns=slope,
                 checksum=float(res[0][0].sum()), finite=int(torch.isfinite(res[0][0]).sum()),
                 state=res[0][-1].tolist(), work=w[0])
        say(f"[{name}] {v}: bit-identical to plain at {check} on {len(data_sets)} data sets "
            f"(their states {r['checks']}; plain {r['plain_ms']:.1f} ms); {w[0]} / {w[1]} "
            f"{unit}s {ms[0]:.4f} / {ms[1]:.4f} ms, slope {slope:.2f} ns a {unit}, state "
            f"{r['state']}, {r['finite']} finite, checksum={r['checksum']!r}")
    return out


_SASS: dict = {}
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def kernel_name(entry: str) -> str:
    """The device (mangled) name of the kernel that the C entry point
    ``entry`` launches, from the handle its ``{entry}_kernel()`` returns
    (``csrc/entry.cuh``): found by the entry's name, not by a template
    argument's value."""
    lib = _build.library()
    name = ctypes.c_char_p()
    err = lib.surf_kernel_name(getattr(lib, f"{entry}_kernel")(), ctypes.byref(name))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetName for {entry} failed with CUDA error {err}")
    return name.value.decode()


def _sass(entry: str, addresses: bool = False) -> list:
    """The instructions, in order, of the kernel that entry point ``entry``
    launches (``cuobjdump -sass`` of the kernel library), each (guard
    predicate or "", opcode, [operands]), with ``addresses`` (address,
    guard, opcode, [operands])."""
    so = _build.build()
    if so not in _SASS:
        tool = Path(_build._nvcc()).with_name("cuobjdump")
        _SASS[so] = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                                   check=True, timeout=300).stdout
    kernel = kernel_name(entry)
    fns = [fn for fn in _SASS[so].split("Function : ")[1:] if fn.split(None, 1)[0] == kernel]
    if len(fns) != 1:
        raise RuntimeError(f"{len(fns)} kernels named {kernel} ({entry}) in the SASS")
    out = [(int(at, 16), g.strip().lstrip("@"), op,
            [a.strip() for a in args.split(",") if a.strip()])
           for at, g, op, args in _INSTRUCTION.findall(fns[0])]
    return out if addresses else [x[1:] for x in out]


def _matches(op: str, key: str) -> bool:
    """An opcode matches a key when its first part is the key's (or that
    with an immediate operand, FMUL32I for FMUL) and it has every later
    part of the key among its own: ``BAR`` counts ``BAR.SYNC`` and
    ``BAR.RED.OR``, ``LDG.CONSTANT`` counts ``LDG.E.128.CONSTANT``, and ""
    every instruction."""
    head, *rest = key.split(".")
    first, *parts = op.split(".")
    return (not head or first in (head, head + "32I")) and set(rest) <= set(parts)


def _words(op: str) -> int:
    """The 32-bit words a load or store moves: .64 two, .128 four, else one."""
    parts = op.split(".")
    return 4 if "128" in parts else 2 if "64" in parts else 1


def sass_counts(entry: str, opcodes, words: bool = False) -> dict:
    """{opcode: count} in the SASS of the kernel that entry point ``entry``
    launches (``_matches``); with ``words`` a load or store counts the
    32-bit words it moves, so a vector load counts as the lanes it reads."""
    counts = dict.fromkeys(opcodes, 0)
    for _, op, _ in _sass(entry):
        for k in counts:
            if _matches(op, k):
                counts[k] += _words(op) if words else 1
    return counts


def loop_bodies(entry: str) -> list:
    """Every loop of the kernel that entry point ``entry`` launches: for
    each backward branch (a BRA to a lower address), (its target's address,
    its own address, the opcodes from the one to the other, in order)."""
    fn = _sass(entry, addresses=True)
    loops = []
    for at, _, op, args in fn:
        if op.startswith("BRA") and args and args[-1].startswith("0x"):
            target = int(args[-1], 16)
            if target < at:
                loops.append((target, at, [o for a, _, o, _ in fn if target <= a <= at]))
    return loops


def _reg(operand: str) -> str:
    """The register or predicate an operand names: R8.reuse -> R8, !P0 -> P0."""
    return operand.lstrip("!-|").split(".")[0].rstrip("|")


def flag_uses(entry: str, offset: int) -> list:
    """The opcodes of the instructions, in order, that read the predicate
    tested from the word the kernel of entry point ``entry`` loads at byte
    ``offset`` of its row (the first load with that offset, the first ISETP
    or LOP3 that reads its register into a predicate), up to the
    straight-line write that replaces the predicate: a BRA among them is a
    branch on the word."""
    fn = _sass(entry)
    load = next(k for k, (_, op, a) in enumerate(fn)
                if op.startswith("LDG") and a[1].endswith(f"+{offset:#x}]"))
    reg = fn[load][2][0]
    test = next(k for k in range(load + 1, len(fn)) if fn[k][1].startswith(("ISETP", "LOP3"))
                and re.fullmatch(r"U?P\d", fn[k][2][0])
                and reg in (_reg(a) for a in fn[k][2][1:]))
    pred = fn[test][2][0]
    uses = []
    for guard, op, args in fn[test + 1:]:
        if guard.lstrip("!") == pred or pred in (_reg(a) for a in args[1:]):
            uses.append(op)
        if args and args[0] == pred:
            break
    return uses


def card_line(query: str = "name,power.limit") -> str:
    """The card's name and power limit (or another ``--query-gpu``), as
    nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()

"""What the walk-visit microbenchmarks (``visit_cost``, ``quant_visit``,
``stack_visit``, ``mask_reduce``; kernels in ``csrc/visit_micro.cu``)
share: the table's shape, the input checks, the launch, the slab test's
reduction in their plain versions, and the timing on the card."""

from __future__ import annotations

import ctypes
import subprocess

import torch

from ..accel import _build
from .leaf_visit import events_ms

D_ROWS = 512               # the scripts' table rows
LANE = 128
RAYS = 1024                # one (8, 128) packet
REC = 16
LEAF_LANE, SKIP_LANE = 9, 10
FAR = 1e30


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
    """[R, 8]: the slab test of the rays against a row's 8 child boxes
    (lanes 16k + 0..5) with the running best_t; o, inv, oinv are [R, 3].
    The planes are (lo - o) * inv, or lo * inv - o * inv when ``oinv`` is
    given (``visit_cost``'s ``slabfma``)."""
    box = row.view(8, REC)[:, :6]
    lo, hi = box[None, :, 0:3], box[None, :, 3:6]
    if oinv is None:
        tn = (lo - o[:, None]) * inv[:, None]
        tf = (hi - o[:, None]) * inv[:, None]
    else:
        tn = lo * inv[:, None] - oinv[:, None]
        tf = hi * inv[:, None] - oinv[:, None]
    return slab_hits(tn, tf, best_t)


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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()

"""Profiling helpers (port of ``surf_tpu.app.profiling``): per-stage wall
clock ending in a device sync, ``torch.profiler`` traces, and the device's
memory use."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def stage_timer(name: str, results: dict | None = None, device=None):
    """Wall-clock bracket; synchronises ``device`` (a CUDA device; nothing
    to wait for on the CPU) at exit, so the stage's device work is in it."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        if results is not None:
            results[name] = time.perf_counter() - t0


@contextlib.contextmanager
def torch_trace(logdir: str):
    """``torch.profiler`` over the block (the card's kernels too when CUDA
    is available); writes a Chrome trace to ``logdir/trace.json`` (view in
    Perfetto or chrome://tracing) and yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats(device) -> dict:
    """Memory of a CUDA device: bytes the allocator holds for tensors, its
    peak, and the card's total; Nones on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"bytes_in_use": None, "peak_bytes_in_use": None, "bytes_limit": None}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.mem_get_info(device)[1],
    }

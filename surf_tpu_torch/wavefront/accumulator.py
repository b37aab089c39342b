"""Progressive-refinement accumulator (port of
``surf_tpu.wavefront.accumulator``; NumPy only).

Mirrors the reference AccumulatorState + finalize semantics
(renderer.cpp:33-46, 142-146, 188; shaders/wavefront_finalize.comp):
radiance sums accumulate across frames, ``total_samples`` grows
monotonically (it also advances the per-pixel seed stream), and any
camera/config change clears the accumulator.
"""

from __future__ import annotations

import numpy as np


class Accumulator:
    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.clear()

    def clear(self) -> None:
        """clearAccumulator (renderer.cpp:142-146)."""
        self.buffer = np.zeros((self.height, self.width, 3), np.float32)
        self.total_samples = 0

    def add_frame(self, radiance_sum: np.ndarray, spp: int) -> None:
        self.buffer += np.asarray(radiance_sum, np.float32)
        self.total_samples += spp

    def resolve(self) -> np.ndarray:
        """finalize: accumulator / totalSamples (wavefront_finalize.comp:18)."""
        if self.total_samples == 0:
            return self.buffer
        return self.buffer / np.float32(self.total_samples)

    def energy(self) -> float:
        """The 'Lumen' checksum: sum(r+g+b) of the resolved image
        (renderer.cpp:191-201)."""
        return float(self.resolve().sum())

    # -- checkpoint / resume ------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(
            path, buffer=self.buffer,
            total_samples=np.int64(self.total_samples),
            shape=np.asarray([self.height, self.width]),
        )

    @classmethod
    def load(cls, path: str) -> "Accumulator":
        data = np.load(path)
        h, w = data["shape"]
        acc = cls(int(w), int(h))
        acc.buffer = data["buffer"].astype(np.float32)
        acc.total_samples = int(data["total_samples"])
        return acc

"""Frame metrics & structured logging (port of ``surf_tpu.app.metrics``;
the standard library only).

Replaces the reference's printf instrumentation (main.cpp:381-443: EWMA
frame time over 20 frames, fps, Mrays/s = W*H*spp/frametime, cumulative
samples, energy 'Lumen') with a structured per-frame record + JSONL output
(SURVEY.md §5.5)."""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field


@dataclass
class FrameMetrics:
    frame: int
    frame_time_s: float
    avg_frame_time_ms: float
    fps: float
    mrays_per_s: float
    total_samples: int
    spp: int
    energy: float
    extra: dict = field(default_factory=dict)

    def format_line(self) -> str:
        """The reference's per-frame stdout line shape (main.cpp:434-442)."""
        return (
            f"{self.avg_frame_time_ms:08.2f}ms ({self.fps:05.1f} fps) - "
            f"{self.mrays_per_s:08.2f}Mrays/s - {self.total_samples:05d} samples "
            f"({self.spp} spp) - {self.energy:010.2f} Lumen"
        )


class MetricsLog:
    """EWMA-smoothed frame timing + optional JSONL sink.

    EWMA replicates main.cpp:383-427: alpha starts at 1 and halves until it
    reaches 1/NUM_SMOOTH_FRAMES."""

    NUM_SMOOTH_FRAMES = 20

    def __init__(self, width: int, height: int, jsonl_path: str | None = None):
        self.width = width
        self.height = height
        self.jsonl_path = jsonl_path
        self.avg_frame_time_ms = 10.0
        self.alpha = 1.0
        self.frame = 0
        self._last_tick = time.perf_counter()
        self.history: list[FrameMetrics] = []

    def tick(self, spp: int, total_samples: int, energy: float,
             **extra) -> FrameMetrics:
        now = time.perf_counter()
        dt = now - self._last_tick
        self._last_tick = now

        self.avg_frame_time_ms = (
            (1.0 - self.alpha) * self.avg_frame_time_ms + self.alpha * dt * 1e3
        )
        if self.alpha > 1.0 / self.NUM_SMOOTH_FRAMES:
            self.alpha *= 0.5

        inv_avg = 1.0 / self.avg_frame_time_ms
        m = FrameMetrics(
            frame=self.frame,
            frame_time_s=dt,
            avg_frame_time_ms=self.avg_frame_time_ms,
            fps=inv_avg * 1e3,
            mrays_per_s=(self.width * self.height * spp) * inv_avg / 1e3,
            total_samples=total_samples,
            spp=spp,
            energy=energy,
            extra=extra,
        )
        self.frame += 1
        self.history.append(m)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as fh:
                fh.write(json.dumps(asdict(m)) + "\n")
        return m

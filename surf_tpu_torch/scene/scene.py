"""Scene graph: background + instances + lights + TLAS, with animation (the
port's copy of ``surf_tpu.scene.scene``, NumPy only).

Emissive instances are collected into a light list at construction
(scene.cpp:23-33); the background is solid or a vertical gradient;
``update(dt)`` rotates instance 3 about WORLD_UP and refits the TLAS
(scene.cpp:53-59).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..accel.builder import build_tlas, refit
from ..core import transform as tf
from .instance import Instance

BG_SOLID = 0
BG_GRADIENT = 1


@dataclass
class SceneBackground:
    type: int = BG_SOLID
    color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    gradient_a: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    gradient_b: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))

    def __post_init__(self):
        self.color = np.asarray(self.color, np.float32).reshape(3)
        self.gradient_a = np.asarray(self.gradient_a, np.float32).reshape(3)
        self.gradient_b = np.asarray(self.gradient_b, np.float32).reshape(3)


class Scene:
    def __init__(self, background: SceneBackground, instances: list[Instance]):
        self.background = background
        self.instances = list(instances)
        self.light_indices = [
            i for i, inst in enumerate(self.instances) if inst.material.is_light()
        ]
        self.tlas = build_tlas(*self._instance_bounds())
        self.version = 0  # bumped on update

    def _instance_bounds(self):
        lo = np.stack([inst.bounds_min for inst in self.instances])
        hi = np.stack([inst.bounds_max for inst in self.instances])
        return lo, hi

    def update(self, delta_time: float) -> None:
        """Animate instance 3 (a rotation of delta_time rad about WORLD_UP,
        scene.cpp:53-59) and refit the TLAS over the instances' bounds.
        Scenes with fewer instances animate their last instance instead."""
        inst = self.instances[min(3, len(self.instances) - 1)]
        inst.set_transform(
            tf.rotate(inst.transform, 1.0 * float(delta_time), [0.0, 1.0, 0.0]))
        self.tlas = refit(self.tlas, *self._instance_bounds())
        self.version += 1

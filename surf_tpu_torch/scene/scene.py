"""Scene graph: background + instances + light list (the NumPy description
layer of ``surf_tpu.scene.scene``, carried over without the TLAS and the
animation, which the ported render paths do not read).

Emissive instances are collected into a light list at construction
(scene.cpp:23-33); the background is solid or a vertical gradient.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

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

"""Materials — the primary gradient targets of the differentiable renderer.

Mirrors the reference's flat 64-byte Material struct
(material.h:6-19).  Lobe selection is stochastic by
(reflectivity, refractivity) fractions; ``is_light`` uses the CPU semantics
(strength > 0 AND emission color != 0, material.h:16) — the reference's GLSL
uses OR (wavefront_common.glsl:169-175) but both agree on the test scene and
SURVEY.md §7.0.4 picks the CPU behavior.

Carried over from ``surf_tpu.scene.material`` (NumPy only): that package's
``scene/__init__`` imports its JAX camera, so this module cannot be
imported from there without JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np


def _rgb(x) -> np.ndarray:
    return np.asarray(x, np.float32).reshape(3)


@dataclass
class Material:
    emission_strength: float = 0.0
    reflectivity: float = 0.0
    refractivity: float = 0.0
    index_of_refraction: float = 1.0
    emission_color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    albedo: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    absorption: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))

    def __post_init__(self):
        self.emission_color = _rgb(self.emission_color)
        self.albedo = _rgb(self.albedo)
        self.absorption = _rgb(self.absorption)

    def is_light(self) -> bool:
        return self.emission_strength > 0.0 and bool(np.any(self.emission_color > 0.0))


class MaterialTable(NamedTuple):
    """SoA device layout of the deduped material set (the analog of the
    reference's material SSBO, scene.cpp:171-178). All arrays [M, ...]."""

    albedo: np.ndarray            # [M,3]
    emission_color: np.ndarray    # [M,3]
    absorption: np.ndarray        # [M,3]
    emission_strength: np.ndarray # [M]
    reflectivity: np.ndarray      # [M]
    refractivity: np.ndarray      # [M]
    ior: np.ndarray               # [M]
    is_light: np.ndarray          # [M] bool


def build_material_table(materials: list[Material]) -> MaterialTable:
    return MaterialTable(
        albedo=np.stack([m.albedo for m in materials]).astype(np.float32),
        emission_color=np.stack([m.emission_color for m in materials]).astype(
            np.float32
        ),
        absorption=np.stack([m.absorption for m in materials]).astype(np.float32),
        emission_strength=np.array(
            [m.emission_strength for m in materials], np.float32
        ),
        reflectivity=np.array([m.reflectivity for m in materials], np.float32),
        refractivity=np.array([m.refractivity for m in materials], np.float32),
        ior=np.array([m.index_of_refraction for m in materials], np.float32),
        is_light=np.array([m.is_light() for m in materials], bool),
    )

"""Scene instances: mesh + material + 4x4 transform.

Mirrors the reference Instance (bvh.cpp:467-594) as far as the flattened
render needs it: the world-space triangles and the total *transformed*
surface area used as the light PDF normalizer.  Smooth normals are
transformed by the plain matrix (not the inverse transpose) to match
bvh.cpp:515-522.

Carried over from ``surf_tpu.scene.instance`` (NumPy only, without the
inverse transform and world bounds that only the TLAS reads): that package's
``scene/__init__`` imports its JAX camera, so this module cannot be
imported from there without JAX.
"""

from __future__ import annotations

import numpy as np

from ..core import transform as tf
from .material import Material
from .mesh import Mesh


class Instance:
    def __init__(self, mesh: Mesh, material: Material, transform: np.ndarray):
        self.mesh = mesh
        self.material = material
        self.transform = np.asarray(transform, np.float32)
        self._calculate_mesh_area()

    def _calculate_mesh_area(self) -> None:
        """Total transformed triangle area (bvh.cpp:577-594)."""
        v0 = tf.apply_point(self.transform, self.mesh.v0)
        v1 = tf.apply_point(self.transform, self.mesh.v1)
        v2 = tf.apply_point(self.transform, self.mesh.v2)
        c = np.cross(v1 - v0, v2 - v0)
        self.area = float(np.float32(0.5) * np.sum(np.linalg.norm(c, axis=1), dtype=np.float32))

    def world_triangles(self):
        """Pre-transformed world-space triangle SoA for the flattened render
        scene: positions via apply_point, normals via the plain matrix
        (unnormalized — interpolation then normalize matches
        normalize(M @ interp(n)), bvh.cpp:515-522)."""
        m = self.transform
        return (
            tf.apply_point(m, self.mesh.v0),
            tf.apply_point(m, self.mesh.v1),
            tf.apply_point(m, self.mesh.v2),
            tf.apply_vector(m, self.mesh.n0),
            tf.apply_vector(m, self.mesh.n1),
            tf.apply_vector(m, self.mesh.n2),
        )

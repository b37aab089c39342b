"""Scene instances: mesh + material + 4x4 transform.

Mirrors the reference Instance (bvh.cpp:467-594): cached inverse
transform, world-space AABB from the 8 transformed corners of the mesh
bounds, and the total *transformed* surface area used as the light PDF
normalizer.  Smooth normals are transformed by the plain matrix (not the
inverse transpose) to match bvh.cpp:515-522.

The port's own copy of ``surf_tpu.scene.instance`` (NumPy only).
"""

from __future__ import annotations

import numpy as np

from ..core import transform as tf
from .material import Material
from .mesh import Mesh


def world_bounds(transform: np.ndarray, v0, v1, v2):
    """8-corner world AABB (bvh.cpp:554-575): the mesh's object-space
    bounds, its 8 corners transformed, and their (min, max)."""
    pts = np.concatenate([v0, v1, v2])
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    corners = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
        np.float32,
    )
    world = tf.apply_point(transform, corners)
    return world.min(axis=0).astype(np.float32), world.max(axis=0).astype(np.float32)


class Instance:
    def __init__(self, mesh: Mesh, material: Material, transform: np.ndarray):
        self.mesh = mesh
        self.material = material
        self.set_transform(np.asarray(transform, np.float32))

    def set_transform(self, transform: np.ndarray) -> None:
        """setTransform (bvh.cpp:524-531): cache inverse, world bounds, area.
        Bumps ``version`` on every call."""
        self.transform = transform.astype(np.float32)
        self.inv_transform = tf.inverse(self.transform)
        self.version = getattr(self, "version", 0) + 1
        self.bounds_min, self.bounds_max = world_bounds(
            self.transform, self.mesh.v0, self.mesh.v1, self.mesh.v2)
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

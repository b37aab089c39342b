"""OBJ mesh loading into SoA NumPy arrays.

Replaces the reference's tinyobjloader-based Mesh (sources/mesh.cpp:69-154)
with a small self-contained parser.  Two reference quirks are replicated
because image parity depends on them:

1. Vertex swap — the Triangle constructor's parameter order swaps the first
   two vertices (mesh.h:19 ``Triangle(Float3 v1, Float3 v0, Float3 v2)``,
   mesh.cpp:13-21), so stored v0 = file vertex 1, v1 = file vertex 0,
   v2 = file vertex 2.  Normals/UVs are NOT swapped (mesh.cpp:119-151).
2. Centroid uses 0.333f, not 1/3 (mesh.cpp:20).

Barycentric conventions (mesh.h:56-75): interpolation weight u goes to
index 0, v to index 2, (1-u-v) to index 1 of the *stored* arrays.

Carried over from ``surf_tpu.scene.mesh`` (NumPy only): that package's
``scene/__init__`` imports its JAX camera, so this module cannot be
imported from there without JAX.
"""

from __future__ import annotations

import numpy as np


class Mesh:
    """Triangle soup in SoA layout: v0/v1/v2/centroid [T,3] (swapped order),
    n0/n1/n2 [T,3], uv0/uv1/uv2 [T,2] (file order)."""

    def __init__(self, v0, v1, v2, n0, n1, n2, uv0=None, uv1=None, uv2=None):
        self.v0 = np.asarray(v0, np.float32)
        self.v1 = np.asarray(v1, np.float32)
        self.v2 = np.asarray(v2, np.float32)
        self.n0 = np.asarray(n0, np.float32)
        self.n1 = np.asarray(n1, np.float32)
        self.n2 = np.asarray(n2, np.float32)
        t = len(self.v0)
        z2 = np.zeros((t, 2), np.float32)
        self.uv0 = z2 if uv0 is None else np.asarray(uv0, np.float32)
        self.uv1 = z2 if uv1 is None else np.asarray(uv1, np.float32)
        self.uv2 = z2 if uv2 is None else np.asarray(uv2, np.float32)
        # 0.333f centroid, mesh.cpp:20
        self.centroid = ((self.v0 + self.v1 + self.v2) * np.float32(0.333)).astype(
            np.float32
        )

    @property
    def tri_count(self) -> int:
        return len(self.v0)

    @classmethod
    def from_obj(cls, path: str) -> "Mesh":
        return load_obj(path)

    @classmethod
    def from_file_triangles(cls, fv, fn, fuv=None) -> "Mesh":
        """Build from file-ordered per-triangle vertex arrays [T,3,3]:
        applies the reference's v0/v1 swap for positions only."""
        fv = np.asarray(fv, np.float32)
        fn = np.asarray(fn, np.float32)
        uv = None if fuv is None else np.asarray(fuv, np.float32)
        return cls(
            fv[:, 1], fv[:, 0], fv[:, 2],
            fn[:, 0], fn[:, 1], fn[:, 2],
            None if uv is None else uv[:, 0],
            None if uv is None else uv[:, 1],
            None if uv is None else uv[:, 2],
        )


def _parse_index(token: str, n_items: int) -> int:
    i = int(token)
    return i - 1 if i > 0 else n_items + i


def load_obj(path: str) -> Mesh:
    """Parse v/vn/vt/f records; triangulate polygons as a fan (0, i, i+1),
    matching tinyobjloader's ``triangulate = true`` (mesh.cpp:74)."""
    positions: list[list[float]] = []
    normals: list[list[float]] = []
    texcoords: list[list[float]] = []
    fv: list[list[list[float]]] = []
    fn: list[list[list[float]]] = []
    fuv: list[list[list[float]]] = []

    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                positions.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                normals.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                texcoords.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                corners = []
                for token in line.split()[1:]:
                    parts = token.split("/")
                    vi = _parse_index(parts[0], len(positions))
                    ti = (
                        _parse_index(parts[1], len(texcoords))
                        if len(parts) > 1 and parts[1]
                        else -1
                    )
                    ni = (
                        _parse_index(parts[2], len(normals))
                        if len(parts) > 2 and parts[2]
                        else -1
                    )
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):
                    tri = [corners[0], corners[k], corners[k + 1]]
                    fv.append([positions[c[0]] for c in tri])
                    fn.append(
                        [
                            normals[c[2]] if c[2] >= 0 else [0.0, 0.0, 0.0]
                            for c in tri
                        ]
                    )
                    fuv.append(
                        [
                            texcoords[c[1]] if c[1] >= 0 else [0.0, 0.0]
                            for c in tri
                        ]
                    )

    if not fv:
        raise ValueError(f"no faces found in OBJ file: {path}")
    return Mesh.from_file_triangles(
        np.asarray(fv, np.float32), np.asarray(fn, np.float32), np.asarray(fuv, np.float32)
    )


# ---------------------------------------------------------------------------
# Procedural meshes — used by tests and as fallbacks when the reference asset
# pack is not available (the built-in scene prefers real assets, see
# scene/builtin.py).
# ---------------------------------------------------------------------------

def make_plane() -> Mesh:
    """Unit plane [-1,1]^2 at y=0, quad fan-triangulated exactly like the
    reference's assets/plane.obj (f 1 2 4 3 -> (1,2,4), (1,4,3))."""
    p = np.array(
        [[-1, 0, 1], [1, 0, 1], [-1, 0, -1], [1, 0, -1]], np.float32
    )
    n = np.array([0, 1, 0], np.float32)
    quad = [0, 1, 3, 2]  # f 1 2 4 3
    tris = [[quad[0], quad[1], quad[2]], [quad[0], quad[2], quad[3]]]
    fv = np.array([[p[a], p[b], p[c]] for a, b, c in tris], np.float32)
    fn = np.broadcast_to(n, (2, 3, 3)).copy()
    return Mesh.from_file_triangles(fv, fn)


def make_cube() -> Mesh:
    """Simple 12-triangle unit cube [-1,1]^3 with face normals."""
    fv, fn = [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            normal = np.zeros(3, np.float32)
            normal[axis] = sign
            u_ax, v_ax = (axis + 1) % 3, (axis + 2) % 3
            corners = []
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                c = np.zeros(3, np.float32)
                c[axis] = sign
                c[u_ax] = du * sign
                c[v_ax] = dv
                corners.append(c)
            for a, b, c in ((0, 1, 2), (0, 2, 3)):
                fv.append([corners[a], corners[b], corners[c]])
                fn.append([normal, normal, normal])
    return Mesh.from_file_triangles(np.asarray(fv), np.asarray(fn))


def make_icosphere(subdivisions: int = 2, radius: float = 1.0) -> Mesh:
    """Icosphere with smooth normals — test stand-in for curved meshes."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [v for v in verts]

    def midpoint(a, b):
        m = (verts[a] + verts[b]) / 2.0
        m /= np.linalg.norm(m)
        verts.append(m)
        return len(verts) - 1

    for _ in range(subdivisions):
        new_faces = []
        cache: dict[tuple[int, int], int] = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                cache[key] = midpoint(a, b)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces

    va = np.asarray(verts, np.float64)
    fv = np.array([[va[a] * radius, va[b] * radius, va[c] * radius] for a, b, c in faces])
    fn = np.array([[va[a], va[b], va[c]] for a, b, c in faces])
    return Mesh.from_file_triangles(fv.astype(np.float32), fn.astype(np.float32))

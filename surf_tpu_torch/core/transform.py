"""Host-side 4x4 affine transforms with glm semantics (column vectors, M @ v).

The port's own copy of ``surf_tpu.core.transform`` (NumPy only).

Replaces the reference's use of glm (surf_math.h:91: ``Mat4 = glm::mat4``)
for instance transforms (sources/main.cpp:173-341).  Stored as float32 NumPy
[4, 4] arrays in mathematical (row-major) layout; ``apply_*`` helpers multiply
column vectors: world = M @ [x, y, z, w]^T.

glm builder semantics replicated exactly:
  glm::translate(M, t) == M @ T,  glm::scale(M, s) == M @ S,
  glm::rotate(M, a, axis) == M @ R (Rodrigues axis-angle).
GLM_FORCE_LEFT_HANDED only alters projection/lookAt builders, which the
reference never uses, so plain Rodrigues rotation is bit-compatible.
"""

from __future__ import annotations

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def translate(m: np.ndarray, t) -> np.ndarray:
    tm = np.eye(4, dtype=np.float32)
    tm[:3, 3] = np.asarray(t, dtype=np.float32)
    return (m @ tm).astype(np.float32)


def scale(m: np.ndarray, s) -> np.ndarray:
    sm = np.eye(4, dtype=np.float32)
    sm[0, 0], sm[1, 1], sm[2, 2] = np.asarray(s, dtype=np.float32)
    return (m @ sm).astype(np.float32)


def rotate(m: np.ndarray, angle_rad: float, axis) -> np.ndarray:
    """glm::rotate(M, angle, axis): Rodrigues rotation, axis normalized."""
    a = np.asarray(axis, dtype=np.float32)
    a = a / np.linalg.norm(a)
    c = np.float32(np.cos(angle_rad))
    s = np.float32(np.sin(angle_rad))
    x, y, z = a
    rm = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s, 0],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s, 0],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c), 0],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )
    return (m @ rm).astype(np.float32)


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


def apply_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Transform [..., 3] points (w=1) incl. the reference's /w divide
    (sources/bvh.cpp:489, 545)."""
    p = np.asarray(p, dtype=np.float32)
    out = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3].T + m[3, 3]
    return (out / w[..., None]).astype(np.float32)


def apply_vector(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Transform [..., 3] directions/normals (w=0). The reference transforms
    normals by the plain matrix, NOT the inverse transpose (bvh.cpp:515-522);
    replicate for image parity."""
    v = np.asarray(v, dtype=np.float32)
    return (v @ m[:3, :3].T).astype(np.float32)

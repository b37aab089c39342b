"""3-vector math on [..., 3] float32 tensors (port of surf_tpu.core.vecmath).

Constants are float32-rounded values of the reference's (surf_math.h:17-18,
camera.h:8-9), held as Python floats so they combine with tensors on any
device.
"""

from __future__ import annotations

import numpy as np
import torch

F32_FAR_AWAY = float(np.float32(1e30))
F32_EPSILON = float(np.float32(1e-5))
F32_PI = float(np.float32(3.14159265358979323846264))
F32_INV_PI = float(np.float32(0.31830988618379067153777))
F32_2PI = float(np.float32(6.28318530717958647692528))

WORLD_RIGHT = (1.0, 0.0, 0.0)
WORLD_UP = (0.0, 1.0, 0.0)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing xyz axis, summed x + y + z in order."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def normalize(a: torch.Tensor) -> torch.Tensor:
    """a * (1 / sqrt(a.a)), as Float3::normalize (surf_math.h:197-199)."""
    inv_len = 1.0 / torch.sqrt(dot(a, a))
    return a * inv_len[..., None]


def reflect(direction: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """reflect (surf_math.h:227): d - 2 (n.d) n."""
    return direction - 2.0 * dot(normal, direction)[..., None] * normal


def radians(deg: torch.Tensor) -> torch.Tensor:
    """deg * pi * 0.005555555555555f — the reference's truncated 1/180
    (surf_math.h:233)."""
    return (deg * F32_PI) * float(np.float32(0.005555555555555))

"""Rejection samplers with reference-identical RNG consumption (port of
surf_tpu.core.sampling: ``cosine_hemisphere`` and ``unit_disk``).

Each lane redraws only while IT is unaccepted (masked seed advance), so
every lane's stream consumes exactly the draws the sequential CPU code
would.  The loop condition ``need.any()`` is read on the host: one device
sync per redraw round (most calls need no redraw, so one sync per call).
"""

from __future__ import annotations

import torch

from . import rng
from .vecmath import F32_2PI, F32_EPSILON, WORLD_RIGHT, WORLD_UP, cross, dot, normalize


def _tangent_frame_dir(r0, r1, normal):
    """Cosine-weighted direction from two uniforms in the reference's
    tangent frame (surf_math.cpp:119-129)."""
    r = torch.sqrt(r0)
    theta = F32_2PI * r1
    dx = r * torch.cos(theta)
    dy = r * torch.sin(theta)
    dz = torch.sqrt(1.0 - r0)
    x_max = 1.0 - F32_EPSILON
    up = normal.new_tensor(WORLD_UP)
    right = normal.new_tensor(WORLD_RIGHT)
    tmp = torch.where(normal[..., 0:1].abs() > x_max, up, right)
    b = normalize(cross(normal, tmp))
    t = cross(b, normal)
    return dx[..., None] * t + dy[..., None] * b + dz[..., None] * normal


def cosine_hemisphere(seed: torch.Tensor, normal: torch.Tensor,
                      active: torch.Tensor):
    """randomOnHemisphereCosineWeighted (surf_math.cpp:116-134): two f32
    draws, redrawn while dot(out, n) == 0.  Only ``active`` lanes consume
    randoms.  Returns (seed, direction).  As in JAX, the rejection test
    reads a detached normal and the returned direction is built from the
    live one, so d(direction)/d(normal) flows and the redraws record no
    graph."""
    n_det = normal.detach()
    seed, r0 = rng.next_f32_masked(seed, active)
    seed, r1 = rng.next_f32_masked(seed, active)
    need = active & (dot(_tangent_frame_dir(r0, r1, n_det), n_det) == 0.0)
    while bool(need.any()):
        seed, r0n = rng.next_f32_masked(seed, need)
        seed, r1n = rng.next_f32_masked(seed, need)
        r0 = torch.where(need, r0n, r0)
        r1 = torch.where(need, r1n, r1)
        need = need & (dot(_tangent_frame_dir(r0, r1, n_det), n_det) == 0.0)
    return seed, _tangent_frame_dir(r0, r1, normal)


def unit_disk(seed: torch.Tensor, active: torch.Tensor):
    """Rejection-sampled point in the unit disk, 2 draws per attempt
    (camera.h:74-87 sampleDefocusDisk).  Returns (seed, u, v)."""
    seed, u = rng.next_f32_range_masked(seed, active, -1.0, 1.0)
    seed, v = rng.next_f32_range_masked(seed, active, -1.0, 1.0)
    need = active & (u * u + v * v > 1.0)
    while bool(need.any()):
        seed, u2 = rng.next_f32_range_masked(seed, need, -1.0, 1.0)
        seed, v2 = rng.next_f32_range_masked(seed, need, -1.0, 1.0)
        u = torch.where(need, u2, u)
        v = torch.where(need, v2, v)
        need = need & (u * u + v * v > 1.0)
    return seed, u, v

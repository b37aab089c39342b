"""Thin-lens camera (port of surf_tpu.scene.camera).

The host ``Camera`` (NumPy) holds the reference Camera's pose (camera.cpp,
camera.h): a look-at basis built with WORLD_UP, fovY in degrees, focal
length and defocus angle.  ``CameraParams`` holds the raw pose as tensors
on a device and ``view_plane`` derives generateViewPlane
(camera.cpp:28-46) from it in torch, as ``view_plane_jnp`` does in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.vecmath import cross, radians

VIEWPORT_HEIGHT = 2.0  # camera.cpp:7

_WORLD_UP = np.array([0.0, 1.0, 0.0], np.float32)


def _normalize(v: np.ndarray) -> np.ndarray:
    return (v / np.linalg.norm(v)).astype(np.float32)


class Camera:
    def __init__(
        self,
        position,
        target,
        screen_width: int,
        screen_height: int,
        fov_y: float = 70.0,
        focal_length: float = 1.5,
        defocus_angle: float = 0.0,
    ):
        self.position = np.asarray(position, np.float32)
        self.forward = _normalize(np.asarray(target, np.float32) - self.position)
        right = _normalize(np.cross(_WORLD_UP, self.forward))
        self.up = _normalize(np.cross(self.forward, right))
        self.screen_width = int(screen_width)
        self.screen_height = int(screen_height)
        self.fov_y = float(fov_y)
        self.focal_length = float(focal_length)
        self.defocus_angle = float(defocus_angle)


class CameraParams(NamedTuple):
    """Raw camera pose as float32 tensors on one device."""

    position: torch.Tensor       # [3]
    forward: torch.Tensor        # [3] (unit)
    up: torch.Tensor             # [3] (unit)
    fov_y: torch.Tensor          # [] degrees
    focal_length: torch.Tensor   # []
    defocus_angle: torch.Tensor  # [] degrees

    @classmethod
    def from_camera(cls, cam: Camera, device: torch.device) -> "CameraParams":
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return cls(
            position=f32(cam.position),
            forward=f32(cam.forward),
            up=f32(cam.up),
            fov_y=f32(cam.fov_y),
            focal_length=f32(cam.focal_length),
            defocus_angle=f32(cam.defocus_angle),
        )


class ViewPlane(NamedTuple):
    first_pixel: torch.Tensor  # [3]
    u_vector: torch.Tensor     # [3]
    v_vector: torch.Tensor     # [3]
    right: torch.Tensor        # [3]
    up: torch.Tensor           # [3]
    position: torch.Tensor     # [3]
    focal_length: torch.Tensor
    defocus_angle: torch.Tensor


def view_plane(params: CameraParams, width: int, height: int) -> ViewPlane:
    """generateViewPlane (camera.cpp:28-46) from the tensor pose, op for op
    as ``surf_tpu.scene.camera.view_plane_jnp``."""
    f = params.forward
    u_axis = params.up
    right = cross(u_axis, f)
    right = right / torch.sqrt(torch.sum(right * right))
    height_scale = torch.tan(radians(params.fov_y) / 2.0)
    aspect = float(np.float32(width) / np.float32(height))
    viewport_h = VIEWPORT_HEIGHT * height_scale * params.focal_length
    viewport_w = aspect * viewport_h
    u_vector = right * viewport_w
    v_vector = -1.0 * u_axis * viewport_h
    # Divide by device tensors: torch turns division by a Python scalar on
    # CUDA into a multiply by its reciprocal, which is not IEEE division.
    u_delta = u_vector / u_vector.new_tensor(float(width))
    v_delta = v_vector / v_vector.new_tensor(float(height))
    top_left = (
        params.position
        + f * params.focal_length
        - 0.5 * u_vector
        - 0.5 * v_vector
    )
    first_pixel = top_left + 0.5 * (u_delta + v_delta)
    return ViewPlane(
        first_pixel=first_pixel,
        u_vector=u_vector,
        v_vector=v_vector,
        right=right,
        up=u_axis,
        position=params.position,
        focal_length=params.focal_length,
        defocus_angle=params.defocus_angle,
    )

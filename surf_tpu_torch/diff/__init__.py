"""Differentiable rendering: the gradient of an image loss with respect to
the material table and the camera pose (``estimator``), and its
finite-difference check (``fd``).  ``targets_from_arrays`` builds the
port's ``DiffTargets`` from JAX's, handed over as NumPy arrays."""

from __future__ import annotations

import numpy as np
import torch

from ..scene.camera import CameraParams
from .estimator import (  # noqa: F401
    DiffTargets,
    apply_targets,
    grad_image_loss,
    image_loss,
    render_image_diff,
)
from .fd import finite_difference, tree_flatten  # noqa: F401


def targets_from_arrays(arrays: dict[str, np.ndarray],
                        device: torch.device) -> DiffTargets:
    """``DiffTargets`` on ``device`` from the leaves of JAX's, given as
    NumPy arrays keyed by JAX's field names (``albedo``, ...,
    ``camera.position``, ``camera.fov_y``, ...); extra keys are ignored."""

    def put(key):
        return torch.tensor(np.asarray(arrays[key], np.float32), device=device)

    camera = CameraParams(*(put(f"camera.{f}") for f in CameraParams._fields))
    return DiffTargets(*(put(f) for f in DiffTargets._fields if f != "camera"),
                       camera=camera)

"""Differentiable rendering (port of ``surf_tpu.diff.estimator``): the
gradient of an image loss with respect to the material table and the
camera pose, through the whole wavefront estimator.

The estimator is JAX's:

- every discrete sampling decision (lobe, light and triangle picks,
  Russian roulette and its 1/p weight, the Fresnel branch, the rejection
  samplers' tests) reads detached values, so with the sampling measure
  fixed at the linearization point the gradient of the per-sample
  radiance is an unbiased estimate of the gradient of the expected
  radiance for targets that do not move that measure (albedo, emission,
  absorption, camera pose, vertices);
- traversal is detached: it only picks the triangle, which the integrator
  intersects again differentiably (``integrator._reintersect``), so
  gradients reach the camera and the vertices through hit points, normals
  and the NEE sample points.  No hand-written kernel has a backward;
- the wave count is static (``RenderConfig.max_bounces``), as JAX's
  reverse mode needs.  Autograd could follow the host loop without it,
  but the estimator is held to JAX's.

JAX's ``jax.jit`` has no counterpart here: autograd records the loop as
it runs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..scene.camera import CameraParams
from ..scene.compile import PureScene, TorchScene
from ..wavefront.integrator import RenderConfig, render_frame
from .fd import tree_flatten


class DiffTargets(NamedTuple):
    """The differentiable parameters of BASELINE config 3."""

    albedo: torch.Tensor             # [M, 3]
    emission_color: torch.Tensor     # [M, 3]
    emission_strength: torch.Tensor  # [M]
    absorption: torch.Tensor         # [M, 3]
    camera: CameraParams

    @classmethod
    def from_scene(cls, scene: TorchScene | PureScene,
                   camera: CameraParams) -> "DiffTargets":
        return cls(
            albedo=scene.mat_albedo,
            emission_color=scene.mat_emission_color,
            emission_strength=scene.mat_emission_strength,
            absorption=scene.mat_absorption,
            camera=camera,
        )


def apply_targets(scene: TorchScene | PureScene,
                  targets: DiffTargets) -> TorchScene | PureScene:
    return scene._replace(
        mat_albedo=targets.albedo,
        mat_emission_color=targets.emission_color,
        mat_emission_strength=targets.emission_strength,
        mat_absorption=targets.absorption,
    )


def render_image_diff(scene: TorchScene | PureScene, cfg: RenderConfig,
                      targets: DiffTargets, total_samples: int,
                      device: torch.device) -> torch.Tensor:
    """The frame's radiance mean over cfg.spp samples [H, W, 3], on
    autograd's tape when a target requires grad."""
    if cfg.max_bounces is None:
        raise ValueError("differentiable rendering needs a static bounce cap "
                         "(RenderConfig.max_bounces)")
    img = render_frame(apply_targets(scene, targets), cfg, targets.camera,
                       total_samples, device)
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal
    return img / img.new_tensor(float(cfg.spp))


def image_loss(scene: TorchScene | PureScene, cfg: RenderConfig,
               targets: DiffTargets, total_samples: int, device: torch.device,
               loss_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
               reference_image: torch.Tensor | None = None) -> torch.Tensor:
    """Scalar objective over the rendered image: ``loss_fn(img)`` if
    given, else the mean squared difference to ``reference_image`` (the
    inverse-rendering objective), else the mean radiance (a smooth probe
    for finite differences)."""
    img = render_image_diff(scene, cfg, targets, total_samples, device)
    if loss_fn is not None:
        return loss_fn(img)
    if reference_image is not None:
        d = img - reference_image
        return (d * d).mean()
    return img.mean()


def grad_image_loss(scene: TorchScene | PureScene, cfg: RenderConfig,
                    targets: DiffTargets, total_samples: int,
                    device: torch.device, reference_image: torch.Tensor | None = None):
    """(loss, dloss/dtargets): the loss detached and the gradient as a
    ``DiffTargets``.  Differentiates copies of the targets' leaves, so the
    caller's tensors are left as they are; a leaf the loss does not reach
    gets zeros, as JAX's ``grad`` gives."""
    leaves, unflatten = tree_flatten(targets)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss = image_loss(scene, cfg, unflatten(leaves), total_samples, device,
                      reference_image=reference_image)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return loss.detach(), unflatten(grads)

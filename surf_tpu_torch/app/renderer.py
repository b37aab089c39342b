"""Renderer orchestration facade (port of ``surf_tpu.app.renderer``).

Mirrors the reference's renderer interface (IRenderer: clearAccumulator /
render(deltaTime) / config() / frameInfo(), renderer.h:87-97).
``WavefrontRenderer`` is the analog of WaveFrontRenderer
(renderer.h:207-436): a progressive renderer over a compiled scene on one
device, with cross-frame deferral on request.  Given a ``HostCompiled``, as
JAX's takes one, it renders the host's current scene each frame, so an
``update`` between frames is seen."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..scene.camera import Camera, CameraParams
from ..scene.compile import HostCompiled, HybridScene, PureScene, TorchScene
from ..wavefront.accumulator import Accumulator
from ..wavefront.integrator import (
    RenderConfig,
    empty_frame_carry,
    initial_seeds,
    render_frame,
    render_frame_carry,
)


@dataclass
class RendererConfigHost:
    """RendererConfig (renderer.h:24-28)."""

    max_bounces: int | None = None   # None = unbounded (RR-terminated)
    samples_per_frame: int = 1


@dataclass
class FrameInstrumentationData:
    """FrameInstrumentationData (renderer.h:30-34)."""

    energy: float = 0.0
    total_samples: int = 0


class WavefrontRenderer:
    """Progressive wavefront renderer over a scene compiled on ``device``,
    or over a ``HostCompiled``'s current scene (read each frame).  Each
    frame is seeded from the accumulated sample count.  With
    ``defer`` the paths alive at the wave cap persist in a FrameCarry and
    resume next frame (renderer.cpp:1101-1104), so an aggressive wave cap
    costs no estimator bias."""

    def __init__(self, scene: TorchScene | HybridScene | PureScene | HostCompiled,
                 camera: Camera,
                 config: RendererConfigHost, device: torch.device,
                 compact: bool = False, defer: bool = False,
                 wave_limit: int | None = None, algo: str | None = None):
        self._source = scene
        scene = self._current_scene()
        self._camera = camera
        self._config = config
        self._device = device
        self._cam_params = CameraParams.from_camera(camera, device)
        # chip_smoke.py's phase 12 sets _rcfg and reads _carry and _acc.buffer
        self._rcfg = RenderConfig.for_scene(
            scene, camera.screen_width, camera.screen_height,
            config.samples_per_frame,
            use_defocus=camera.defocus_angle != 0.0,
            max_bounces=config.max_bounces,
        )._replace(compact=compact)
        if wave_limit is not None:
            self._rcfg = self._rcfg._replace(wave_limit=wave_limit)
        if algo is not None:
            self._rcfg = self._rcfg._replace(algo=algo)
        self._acc = Accumulator(camera.screen_width, camera.screen_height)
        self._frame_info = FrameInstrumentationData()
        self._defer = defer
        self._carry = empty_frame_carry(self._rcfg, device) if defer else None

    def _current_scene(self) -> TorchScene | HybridScene | PureScene:
        src = self._source
        return src.scene if isinstance(src, HostCompiled) else src

    # -- IRenderer surface (renderer.h:87-97) ------------------------------
    def clear_accumulator(self) -> None:
        self._acc.clear()

    def config(self) -> RendererConfigHost:
        return self._config

    def frame_info(self) -> FrameInstrumentationData:
        return self._frame_info

    def render(self, delta_time: float = 0.0) -> np.ndarray:
        """One frame of samples_per_frame samples; returns the resolved
        (accumulated / totalSamples) image."""
        total = self._acc.total_samples
        scene = self._current_scene()
        if self._defer:
            seed0 = initial_seeds(self._rcfg, total, self._device)
            radiance, _, self._carry = render_frame_carry(
                scene, self._rcfg, self._cam_params, seed0, self._carry)
        else:
            radiance = render_frame(scene, self._rcfg, self._cam_params,
                                    total, self._device)
        self._acc.add_frame(radiance.cpu().numpy(), self._config.samples_per_frame)
        self._frame_info.energy = self._acc.energy()
        self._frame_info.total_samples = self._acc.total_samples
        return self._acc.resolve()

    def notify_camera_changed(self) -> None:
        """A camera/UI change invalidates the accumulator (main.cpp:411-419)
        and any deferred paths (they belong to the discarded frames)."""
        self._cam_params = CameraParams.from_camera(self._camera, self._device)
        self.clear_accumulator()
        if self._defer:
            self._carry = empty_frame_carry(self._rcfg, self._device)

"""The application layer (port of ``surf_tpu.app``): the progressive
renderer facade, ``renderer.WavefrontRenderer``."""

from .renderer import (  # noqa: F401
    FrameInstrumentationData,
    RendererConfigHost,
    WavefrontRenderer,
)

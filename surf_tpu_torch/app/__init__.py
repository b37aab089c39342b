"""The application layer (port of ``surf_tpu.app``): the progressive
renderer facade (``renderer.WavefrontRenderer``), the CLI
(``python -m surf_tpu_torch.app.cli``) with its configuration, metrics,
image output and profiling helpers."""

from . import image_io  # noqa: F401
from .config import AppConfig  # noqa: F401
from .metrics import FrameMetrics, MetricsLog  # noqa: F401
from .renderer import (  # noqa: F401
    FrameInstrumentationData,
    RendererConfigHost,
    WavefrontRenderer,
)

"""The wavefront integrator."""

from .integrator import RenderConfig, render_frame  # noqa: F401

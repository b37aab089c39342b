"""Data-parallel distribution over ``torch.distributed`` ranks (port of
``surf_tpu.dist``): lanes split over a mesh of ranks, images all-gathered,
gradients all-reduced (``sharding``), and the process group's start-up
(``multihost``)."""

from .multihost import init_multihost, make_host_chip_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    Mesh,
    ShardedSession,
    grad_step_sharded,
    make_mesh,
    make_mesh_2d,
    render_frame_sharded,
    scaling_sweep,
    weak_scaling_sweep,
)

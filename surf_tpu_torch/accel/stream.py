"""The ``skip`` and ``stack`` traversals of the 8-wide stream (port of the
non-``bits`` branch of ``pallas_wide.traverse_wide``,
``pallas_wide.py:1940-1960, 2051-2075``).

Rays are padded into packets of ``block_rays`` (pad rays are inactive,
with direction (1, 1, 1)), exactly-zero direction components are nudged
to +-1e-20 so that 1/d is finite, and ``accel.stream_walk`` walks the
stream once per packet, in one launch for every packet (the TPU's
64-packet VMEM chunks are gone).  The walk's record id ``row * 8 + j``
maps through ``rec_slot`` to the leaf-order triangle slot.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .bits import Hit, nudge
from .stream_walk import stream_walk


class StreamTrace(NamedTuple):
    """The 8-wide stream on a device (accel/wide.py)."""

    stream: torch.Tensor    # [E, 128] f32 node and leaf rows
    rec_slot: torch.Tensor  # [E * 8] int32 record -> leaf-order slot (-1)
    max_depth: int          # node-tree depth: sizes the stack walk's stack


def pack_rays(origin: torch.Tensor, direction: torch.Tensor, t_max: torch.Tensor,
              active: torch.Tensor, block_rays: int):
    """Rays padded to whole packets: (rays [7, n_pad] f32 with rows ox, oy,
    oz, dx, dy, dz, t_max; act [n_pad] int32).  Pad rays have origin 0,
    direction (1, 1, 1), t_max 0 and are inactive."""
    n = origin.shape[0]
    pad = (-n) % block_rays
    rays = torch.cat([origin.T, direction.T, t_max.to(torch.float32)[None]], dim=0)
    act = active.to(torch.int32)
    if pad:
        fill = torch.tensor([0, 0, 0, 1, 1, 1, 0], dtype=torch.float32, device=rays.device)
        rays = torch.cat([rays, fill[:, None].expand(7, pad)], dim=1)
        act = torch.cat([act, act.new_zeros(pad)])
    return rays.contiguous(), act.contiguous()


def traverse_stream(trace: StreamTrace, origin: torch.Tensor, direction: torch.Tensor,
                    t_max: torch.Tensor, active: torch.Tensor, any_hit: bool = False,
                    block_rays: int = 1024, algo: str = "skip",
                    return_visits: bool = False):
    """Closest-hit (or any-hit) traversal of [N] rays with the ``skip`` or
    ``stack`` walk; ``prim`` is the leaf-order triangle slot, -1 for a miss
    or an inactive ray.  With ``return_visits`` returns the [g] rows each
    packet visited instead (``traverse_wide(return_visits=True)``)."""
    n = origin.shape[0]
    rays, act = pack_rays(origin, nudge(direction), t_max, active, block_rays)
    t, rec, u, v, visits = stream_walk(trace.stream, rays, act, block_rays, algo,
                                       any_hit, trace.max_depth)
    if return_visits:
        return visits[:, 0]
    rec = rec[:n]
    prim = torch.where(rec >= 0, trace.rec_slot[rec.clamp(min=0)], -1)
    return Hit(prim=torch.where(active, prim, -1), t=t[:n], u=u[:n], v=v[:n])

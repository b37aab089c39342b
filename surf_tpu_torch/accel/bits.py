"""The ``bitsru8`` three-phase traversal (port of ``pallas_wide.traverse_wide``
with ``algo="bitsru8"`` and ``_traverse_bits_padded`` with row_lists=True).

Rays are padded into packets of ``block_rays``; then, per packet:

- phase 1: slab-test every box of the leaf table's hierarchy (leaf rows
  first, then the 8-ary levels) against all the packet's rays at their
  initial t_max, giving one "some ray hits this box" bit per box;
- phase 1.5: a leaf row is a candidate only if its own box and every
  ancestor box is hit (AND down the levels), and the candidates form the
  packet's exact, ascending row list, padded with the inert row;
- phase 2: ``accel.leaf_rows`` intersects each ray with its packet's
  listed rows.  A packet with more candidates than the list capacity
  sweeps the whole table instead (same winner: rows are in leaf order
  either way).

Phases 1 and 1.5 are batched torch ops.  Phase 1 is a [packets, boxes,
rays] slab test, so it is evaluated a chunk of packets at a time to keep
each intermediate under ``PHASE1_ELEMS`` floats (256 MB).  The TPU-only
pieces are gone: the bf16 one-hot contraction that built the lists (and its
16384-row limit) is a cumsum plus one scatter, and the sweep is one pass
over the table instead of VMEM-sized chunks.  Inactive rays carry
t_max = -1e30, which fails every box and triangle test.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vecmath import F32_FAR_AWAY
from .leaf_rows import leaf_rows

BITS_CAP_ROWS = 1536   # default list capacity, as pallas_wide.BITS_CAP_ROWS
PHASE1_ELEMS = 1 << 26


class LeafTrace(NamedTuple):
    """The dense leaf table the bits traversal reads (accel/wide.py)."""

    ltab: torch.Tensor    # [E, 128] f32: 8 triangles per row, 16 lanes each
    box_lo: torch.Tensor  # [3, EB] f32: leaf-row boxes, then 8-ary levels
    box_hi: torch.Tensor  # [3, EB] f32
    anc: torch.Tensor     # [L, MAXD] int32: each leaf row's box chain
    inert_row: int        # an all-zero row (ltab.shape[0] - 1): list padding


class Hit(NamedTuple):
    prim: torch.Tensor  # [N] int32 leaf-order slot, -1 on a miss
    t: torch.Tensor     # [N] f32
    u: torch.Tensor     # [N] f32
    v: torch.Tensor     # [N] f32


def nudge(direction: torch.Tensor) -> torch.Tensor:
    """Exactly-zero direction components to +-1e-20, so 1/d is finite and
    a slab test never meets 0 * inf (pallas_wide.py:1949-1953)."""
    tiny = torch.where(direction < 0, -1e-20, 1e-20)
    return torch.where(direction.abs() < 1e-20, tiny, direction)


def _packet_bits(box_lo, box_hi, o3, inv3, tm):
    """Slab test of every box against every ray of P packets: box_lo/hi
    [3, EB], o3/inv3 [3, P, R], tm [P, R] -> [P, EB] bool (some ray hits)."""
    tmin = tmax = None
    for c in range(3):
        oc = o3[c][:, None, :]
        ic = inv3[c][:, None, :]
        tn = (box_lo[c][None, :, None] - oc) * ic
        tf = (box_hi[c][None, :, None] - oc) * ic
        lo_c = torch.minimum(tn, tf)
        hi_c = torch.maximum(tn, tf)
        tmin = lo_c if tmin is None else torch.maximum(tmin, lo_c)
        tmax = hi_c if tmax is None else torch.minimum(tmax, hi_c)
    hit = (tmax >= tmin) & (tmin < tm[:, None, :]) & (tmax > 0.0)
    return hit.any(dim=2)


def _level_sizes(n_leaf_rows: int) -> list[int]:
    sizes = [n_leaf_rows]
    while sizes[-1] > 1:
        sizes.append(-(-sizes[-1] // 8))
    return sizes


def _leaf_vis(bits: torch.Tensor, sizes: list[int]) -> torch.Tensor:
    """Leaf rows whose own box and every ancestor box are hit: [g, L]."""
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    v = bits[:, offs[-2]:offs[-1]]  # the root level
    for k in range(len(sizes) - 2, -1, -1):
        parent = v.repeat_interleave(8, dim=1)[:, :sizes[k]]
        v = bits[:, offs[k]:offs[k] + sizes[k]] & parent
    return v


def list_capacity(trace: LeafTrace, cap_rows: int = 0) -> int:
    """Rows per packet list: cap_rows (default BITS_CAP_ROWS) bounded by the
    table, rounded up to 8 and bounded by the 8-row groups of leaf rows —
    the capacity rule of _traverse_bits_padded."""
    E = trace.ltab.shape[0]
    sizes = _level_sizes(trace.anc.shape[0])
    L1 = sizes[1] if len(sizes) > 1 else 1
    cap8 = min(-(-min(cap_rows or BITS_CAP_ROWS, E) // 8), L1)
    return cap8 * 8


def prepare(trace: LeafTrace, origin: torch.Tensor, direction: torch.Tensor,
            t_max: torch.Tensor, active: torch.Tensor, block_rays: int,
            cap_rows: int = 0):
    """Phases 1 and 1.5: pad the rays into packets and build each packet's
    row list.  Returns the leaf-row kernel's inputs (rays [7, n_pad],
    lists [g, cap] int32, n_rows [g] int32 with -1 for a sweep)."""
    n = origin.shape[0]
    pad = (-n) % block_rays
    g = (n + pad) // block_rays
    dev = origin.device
    direction = nudge(direction)
    tmf = torch.where(active, t_max.to(torch.float32), -F32_FAR_AWAY)
    rays = torch.cat([origin.T, direction.T, tmf[None]], dim=0)
    if pad:
        fill = torch.tensor([0, 0, 0, 1, 1, 1, -F32_FAR_AWAY],
                            dtype=torch.float32, device=dev)
        rays = torch.cat([rays, fill[:, None].expand(7, pad)], dim=1)
    rays = rays.contiguous()

    # phase 1, a chunk of packets at a time
    R = block_rays
    o3 = rays[0:3].reshape(3, g, R)
    inv3 = 1.0 / rays[3:6].reshape(3, g, R)
    tm = rays[6].reshape(g, R)
    EB = trace.box_lo.shape[1]
    step = max(1, PHASE1_ELEMS // (EB * R))
    bits = torch.cat([
        _packet_bits(trace.box_lo, trace.box_hi, o3[:, s:s + step],
                     inv3[:, s:s + step], tm[s:s + step])
        for s in range(0, g, step)])

    # phase 1.5: candidate rows, then exact ascending lists (cumsum + scatter)
    L = trace.anc.shape[0]
    vis = _leaf_vis(bits, _level_sizes(L))
    cap = list_capacity(trace, cap_rows)
    counts = vis.sum(dim=1, dtype=torch.int32)
    key = vis.cumsum(dim=1, dtype=torch.int32) - 1
    pid = torch.arange(g, device=dev, dtype=torch.int64)[:, None]
    dest = torch.where(vis & (key < cap), pid * cap + key, g * cap)
    buf = torch.full((g * cap + 1,), trace.inert_row, dtype=torch.int32,
                     device=dev)
    row_id = torch.arange(L, device=dev, dtype=torch.int32)
    buf.scatter_(0, dest.reshape(-1), row_id.expand(g, L).reshape(-1))
    lists = buf[:g * cap].reshape(g, cap)
    n_rows = torch.where(counts > cap, -1, counts).to(torch.int32)
    return rays, lists, n_rows


def traverse_bits(trace: LeafTrace, origin: torch.Tensor,
                  direction: torch.Tensor, t_max: torch.Tensor,
                  active: torch.Tensor, any_hit: bool = False,
                  block_rays: int = 2048, cap_rows: int = 0) -> Hit:
    """Closest-hit (or any-hit) traversal of [N] rays; ``prim`` is the
    leaf-order triangle slot (map through scene.perm for the original id),
    -1 for a miss or an inactive ray."""
    n = origin.shape[0]
    rays, lists, n_rows = prepare(trace, origin, direction, t_max, active,
                                  block_rays, cap_rows)
    t, r, u, v = leaf_rows(trace.ltab, lists, n_rows, rays, block_rays,
                           any_hit)
    return Hit(prim=torch.where(active, r[:n], -1), t=t[:n], u=u[:n], v=v[:n])

"""``algo="bitsp"``: per-ray pair lists (port of
``pallas_wide._traverse_pairs_padded``, which is plain XLA on the TPU too).

Each ray gets its own list of candidate 8-row groups: phase 1 slab-tests
every box of the leaf table's hierarchy against the ray alone, a leaf row
is a candidate if its box and every ancestor box are hit, and a group is
listed if any of its 8 rows is.  The first ``pair_groups`` listed groups
(default PAIR_GROUPS), in ascending order and padded with the inert group,
are gathered row by row, and Möller–Trumbore runs over the ray's
[groups * 8 rows, 8 records] at once; the first record with the least t
below t_max wins (a first-win argmin over groups, then rows, then records:
the order of the sequential strictly-closer updates).  A ray with more
listed groups than fit overflows and is resolved by ``traverse_bits`` with
row lists (``bitsr``) and only the overflowed rays active, which goes
through the leaf-row kernel; so with the any-hit trim its prim is 0 for an
occluded ray, while the others keep their closest slot.

Only live rays are tested (a ray's result does not depend on its packet),
a chunk at a time: PAIR_ELEMS bounds the gathered row floats (256 MiB;
one 2048-ray packet at 16 groups is 128 MiB) and PHASE1_ELEMS the slab
test.
"""

from __future__ import annotations

import torch

from ..core.vecmath import F32_FAR_AWAY
from .bits import (PHASE1_ELEMS, Hit, LeafTrace, _box_hits, _leaf_vis,
                   _level_sizes, group_any, group_lists, nudge, traverse_bits)
from .leaf_rows import REC, SLOT_LANE, mt_records

PAIR_GROUPS = 16     # per-ray group capacity, as pallas_wide.PAIR_GROUPS
PAIR_ELEMS = 1 << 26


def pair_hits(trace: LeafTrace, rays: torch.Tensor, capg: int):
    """Per-ray lists for rays [7, m] (live, nudged): returns (t, r, u, v,
    overflow), each [m]; t_max, -1, 0, 0 where nothing is hit."""
    m = rays.shape[1]
    o3, tm = rays[0:3], rays[6]
    hits = _box_hits(trace.box_lo, trace.box_hi, o3[:, None], 1.0 / rays[3:6, None],
                     tm[None])[0]                                  # [EB, m]
    vis = _leaf_vis(hits.T, _level_sizes(trace.anc.shape[0]))       # [m, L]
    vis_g = group_any(trace, vis)                                   # [m, L1]
    rows, counts, _ = group_lists(trace, vis_g, capg)               # [m, capg * 8]
    rec = trace.ltab[rows.long()].reshape(m, -1, REC)               # [m, capg * 64, 16]
    o = tuple(x[:, None] for x in rays[0:3])
    d = tuple(x[:, None] for x in rays[3:6])
    t, u, v, ok = mt_records(rec, o, d)
    tc = torch.where(ok & (t < tm[:, None]), t, torch.inf)
    best = tc.argmin(dim=1, keepdim=True)                           # first win
    tb = tc.gather(1, best)[:, 0]
    found = tb < tm
    sid = rec.view(torch.int32)[..., SLOT_LANE["mt"]].gather(1, best)[:, 0]
    return (torch.where(found, tb, tm), torch.where(found, sid, -1),
            torch.where(found, u.gather(1, best)[:, 0], 0.0),
            torch.where(found, v.gather(1, best)[:, 0], 0.0), counts > capg)


def traverse_pairs(trace: LeafTrace, origin: torch.Tensor, direction: torch.Tensor,
                   t_max: torch.Tensor, active: torch.Tensor, any_hit: bool = False,
                   block_rays: int = 2048, cap_rows: int = 0,
                   pair_groups: int = 0) -> Hit:
    """``bitsp`` traversal of [N] rays (as ``traverse_bits``); block_rays
    and cap_rows size the overflow fallback's packets and lists."""
    capg = pair_groups or PAIR_GROUPS
    n = origin.shape[0]
    dev = origin.device
    tmf = torch.where(active, t_max.to(torch.float32), -F32_FAR_AWAY)
    rays = torch.cat([origin.T, nudge(direction).T, tmf[None]], dim=0)
    t = tmf.clone()
    r = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, device=dev)
    v = torch.zeros(n, device=dev)
    ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    live = torch.nonzero(tmf > -F32_FAR_AWAY).flatten()
    EB = trace.box_lo.shape[1]
    step = max(1, min(PAIR_ELEMS // (capg * 8 * 128), PHASE1_ELEMS // EB))
    for s in range(0, live.shape[0], step):
        idx = live[s:s + step]
        t[idx], r[idx], u[idx], v[idx], ovf[idx] = pair_hits(trace, rays[:, idx], capg)
    if bool(ovf.any()):
        fb = traverse_bits(trace, origin, direction, t_max, ovf, any_hit,
                           block_rays, cap_rows, algo="bitsr")
        t = torch.where(ovf, fb.t, t)
        r = torch.where(ovf, fb.prim, r)
        u = torch.where(ovf, fb.u, u)
        v = torch.where(ovf, fb.v, v)
    return Hit(prim=torch.where(active, r, -1), t=t, u=u, v=v)

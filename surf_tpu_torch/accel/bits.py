"""The ``bits*`` three-phase traversals (port of ``pallas_wide.traverse_wide``
with ``algo="bits..."``: ``_traverse_bits_padded``, and through
``accel.pairs`` ``_traverse_pairs_padded``).

Rays are padded into packets of ``block_rays``; then, per candidate list
(a packet, or with the ``8`` flag each 1024-ray sub-list of one):

- phase 1: slab-test every box of the leaf table's hierarchy (leaf rows
  first, then the 8-ary levels) against all the list's rays at their
  t_max, giving one "some ray hits this box" bit per box;
- phase 1.5: a leaf row is a candidate only if its own box and every
  ancestor box is hit (AND down the levels).  The candidates form the
  list: exact ascending rows (``r``), or by default ascending 8-row groups
  (the hierarchy's first level) with all 8 rows of each listed group,
  padded with the inert group;
- phase 2: ``accel.leaf_rows`` intersects each ray with its list's rows.
  A list with more candidates than its capacity sweeps the whole table
  instead (same winner: rows are in leaf order either way).

The algo string's flags choose the list and the kernel, with JAX's rules
(``parse_algo``): ``r`` row lists, ``w`` Baldwin–Weber records, ``i`` the
ILP merge, ``h`` bf16 record math, ``2`` the t-refresh round, ``8``
sub-lists, ``p`` per-ray pair lists (``accel.pairs``), ``a`` any-hit
without the trim, and the TPU fetch and unroll schedules ``b`` and ``uN``,
which give the same result and are parsed only.

``2`` (t-refresh): round A processes the first ``ceil(refine_rows / 8)``
groups of each list; its running best t re-runs phase 1 (for any-hit,
rays that found a hit get t_max = -FAR instead), and round B processes the
groups that survive and lie past round A's prefix, resuming from round A's
best through the kernel's carry-in.  Culled groups cannot hold a closer
hit, and the order of rows is kept, so the result equals one round's.

Phases 1 and 1.5 are batched torch ops.  Phase 1 is a [lists, boxes, rays]
slab test, so it is evaluated a chunk of lists at a time to keep each
intermediate under ``PHASE1_ELEMS`` floats (256 MB).  The TPU-only pieces
are gone: the bf16 one-hot contraction that built row lists (and its
16384-row limit) is a cumsum plus one scatter, and the sweep is one pass
over the table instead of VMEM-sized chunks carried through carry-in.
Inactive rays carry t_max = -1e30, which fails every box and triangle test.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import torch

from ..core.vecmath import F32_FAR_AWAY
from .leaf_rows import leaf_rows

BITS_CAP_ROWS = 1536     # default list capacity, as pallas_wide.BITS_CAP_ROWS
BITS_REFINE_ROWS = 192   # rows of round A of "2", as pallas_wide.BITS_REFINE_ROWS
SUB_LIST_RAYS = 1024     # rays of one "8" sub-list (a TPU (8, 128) sub-block)
PHASE1_ELEMS = 1 << 26
FLAG_CHARS = "28whripab"
_UNROLL = re.compile(r"u(16|1|2|4|8)(?!\d)")


class LeafTrace(NamedTuple):
    """The dense leaf tables the bits traversals read (accel/wide.py)."""

    ltab: torch.Tensor    # [E, 128] f32: 8 triangles per row, 16 lanes each
    ltabw: torch.Tensor   # [E, 128] f32: the same rows as Baldwin–Weber records
    box_lo: torch.Tensor  # [3, EB] f32: leaf-row boxes, then 8-ary levels
    box_hi: torch.Tensor  # [3, EB] f32
    anc: torch.Tensor     # [L, MAXD] int32: each leaf row's box chain
    inert_row: int        # an all-zero row (ltab.shape[0] - 1): list padding


class Hit(NamedTuple):
    prim: torch.Tensor  # [N] int32 leaf-order slot, -1 on a miss
    t: torch.Tensor     # [N] f32
    u: torch.Tensor     # [N] f32
    v: torch.Tensor     # [N] f32


class BitsFlags(NamedTuple):
    """The flags of a ``bits*`` algo string (``pallas_wide.py:1961-1996``)."""

    row_lists: bool = False    # r: exact row lists (else 8-row group lists)
    bw: bool = False           # w: Baldwin–Weber records (LeafTrace.ltabw)
    ilp: bool = False          # i: the min-tree merge of a row's 8 tests
    bf16: bool = False         # h: bf16 record math
    refine: bool = False       # 2: the t-refresh round
    sub_lists: bool = False    # 8: one list per 1024 rays of a packet
    pairs: bool = False        # p: per-ray pair lists (accel.pairs)
    full_any: bool = False     # a: any-hit through the closest-hit kernel
    block_fetch: bool = False  # b: a TPU fetch schedule (same result)
    unroll: int = 1            # uN: a TPU unroll schedule (same result)

    def kernel(self) -> dict:
        """The leaf-row kernel's record, merge and precision.  ``h`` with
        ``w`` or ``i`` runs the f32 test on a bf16-rounded ray (``_bf16_rays``)."""
        return dict(record="bw" if self.bw else "mt", merge="ilp" if self.ilp else "seq",
                    precision="bf16" if self.bf16 and not (self.bw or self.ilp) else "f32")

    def trims(self) -> bool:
        """Whether any-hit takes the trim (``pallas_wide.py:1774-1776``)."""
        return not (self.bw or self.bf16 or self.ilp or self.full_any or self.refine)


def parse_algo(algo: str) -> BitsFlags:
    """The flags of ``algo``, or ValueError where JAX's parse rejects it:
    an unknown flag, ``uN`` without ``r`` (N one of 1, 2, 4, 8, 16, not
    followed by a digit), ``b`` without ``r`` or with ``w`` or ``i``, ``r``
    with ``2`` or ``8``, and ``p`` with any other flag."""
    if not algo.startswith("bits"):
        raise ValueError(f"{algo!r} is not a bits* algo")
    flag_str = algo[4:]
    unroll = 1
    m = _UNROLL.search(flag_str)
    if m:
        unroll = int(m.group(1))
        flag_str = flag_str[:m.start()] + flag_str[m.end():]
    flags = set(flag_str)
    if not flags <= set(FLAG_CHARS):
        raise ValueError(f"unknown algo {algo!r}: flags are {FLAG_CHARS} and uN")
    if unroll != 1 and "r" not in flags:
        raise ValueError(f"{algo!r}: uN unroll needs exact row lists (r)")
    if "b" in flags and ("r" not in flags or flags & {"w", "i"}):
        raise ValueError(f"{algo!r}: block fetch (b) needs row lists and the "
                         f"plain Möller–Trumbore kernel")
    if "r" in flags and flags & {"2", "8"}:
        raise ValueError(f"{algo!r}: row lists are packet-wide (no 2, no 8)")
    if "p" in flags and flags - {"p"}:
        raise ValueError(f"{algo!r}: p composes with no other flag")
    return BitsFlags(row_lists="r" in flags, bw="w" in flags, ilp="i" in flags,
                     bf16="h" in flags, refine="2" in flags, sub_lists="8" in flags,
                     pairs="p" in flags, full_any="a" in flags,
                     block_fetch="b" in flags, unroll=unroll)


def nudge(direction: torch.Tensor) -> torch.Tensor:
    """Exactly-zero direction components to +-1e-20, so 1/d is finite and
    a slab test never meets 0 * inf (pallas_wide.py:1949-1953)."""
    tiny = torch.where(direction < 0, -1e-20, 1e-20)
    return torch.where(direction.abs() < 1e-20, tiny, direction)


def pack_rays(origin: torch.Tensor, direction: torch.Tensor, t_max: torch.Tensor,
              active: torch.Tensor, block_rays: int) -> torch.Tensor:
    """[7, n_pad] rays (ox, oy, oz, dx, dy, dz, t_max) padded to whole
    packets: directions nudged, inactive and pad rays at t_max = -FAR (pad
    rays with origin 0 and direction (1, 1, 1))."""
    pad = (-origin.shape[0]) % block_rays
    tmf = torch.where(active, t_max.to(torch.float32), -F32_FAR_AWAY)
    rays = torch.cat([origin.T, nudge(direction).T, tmf[None]], dim=0)
    if pad:
        fill = torch.tensor([0, 0, 0, 1, 1, 1, -F32_FAR_AWAY],
                            dtype=torch.float32, device=origin.device)
        rays = torch.cat([rays, fill[:, None].expand(7, pad)], dim=1)
    return rays.contiguous()


def _box_hits(box_lo, box_hi, o3, inv3, tm):
    """Slab test of every box against every ray: box_lo/hi [3, EB], o3/inv3
    [3, P, R], tm [P, R] -> [P, EB, R] bool."""
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
    return (tmax >= tmin) & (tmin < tm[:, None, :]) & (tmax > 0.0)


def _packet_bits(box_lo, box_hi, o3, inv3, tm):
    """[P, EB] bool: some ray of the packet hits the box."""
    return _box_hits(box_lo, box_hi, o3, inv3, tm).any(dim=2)


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


def n_groups(trace: LeafTrace) -> int:
    """L1: the 8-row groups of leaf rows (the hierarchy's first level)."""
    sizes = _level_sizes(trace.anc.shape[0])
    return sizes[1] if len(sizes) > 1 else 1


def list_capacity(trace: LeafTrace, cap_rows: int = 0) -> int:
    """Rows per list: cap_rows (default BITS_CAP_ROWS) bounded by the
    table, rounded up to 8 and bounded by the 8-row groups of leaf rows —
    the capacity rule of _traverse_bits_padded."""
    E = trace.ltab.shape[0]
    cap8 = min(-(-min(cap_rows or BITS_CAP_ROWS, E) // 8), n_groups(trace))
    return cap8 * 8


def packet_vis(trace: LeafTrace, rays: torch.Tensor, list_rays: int,
               tm: torch.Tensor | None = None) -> torch.Tensor:
    """Phases 1 and 1.5a: [lists, L] bool, the candidate leaf rows of each
    list of ``list_rays`` consecutive rays, at t_max ``tm`` ([n_pad],
    default the rays' own)."""
    g = rays.shape[1] // list_rays
    R = list_rays
    o3 = rays[0:3].reshape(3, g, R)
    inv3 = 1.0 / rays[3:6].reshape(3, g, R)
    tm = (rays[6] if tm is None else tm).reshape(g, R)
    EB = trace.box_lo.shape[1]
    step = max(1, PHASE1_ELEMS // (EB * R))
    bits = torch.cat([
        _packet_bits(trace.box_lo, trace.box_hi, o3[:, s:s + step],
                     inv3[:, s:s + step], tm[s:s + step])
        for s in range(0, g, step)])
    return _leaf_vis(bits, _level_sizes(trace.anc.shape[0]))


def row_lists(trace: LeafTrace, vis: torch.Tensor, cap: int):
    """Phase 1.5b, ``r``: each list's candidate rows in ascending order
    (cumsum + one scatter), padded with the inert row.  Returns (lists
    [g, cap] int32, n_rows [g] int32, -1 where the candidates exceed cap)."""
    g, L = vis.shape
    dev = vis.device
    counts = vis.sum(dim=1, dtype=torch.int32)
    key = vis.cumsum(dim=1, dtype=torch.int32) - 1
    pid = torch.arange(g, device=dev, dtype=torch.int64)[:, None]
    dest = torch.where(vis & (key < cap), pid * cap + key, g * cap)
    buf = torch.full((g * cap + 1,), trace.inert_row, dtype=torch.int32, device=dev)
    row_id = torch.arange(L, device=dev, dtype=torch.int32)
    buf.scatter_(0, dest.reshape(-1), row_id.expand(g, L).reshape(-1))
    lists = buf[:g * cap].reshape(g, cap)
    return lists, torch.where(counts > cap, -1, counts).to(torch.int32)


def group_any(trace: LeafTrace, vis: torch.Tensor) -> torch.Tensor:
    """[g, L] candidate rows -> [g, L1] candidate 8-row groups."""
    g, L = vis.shape
    L1 = n_groups(trace)
    vis = torch.nn.functional.pad(vis, (0, L1 * 8 - L))
    return vis.reshape(g, L1, 8).any(dim=2)


def group_lists(trace: LeafTrace, vis_g: torch.Tensor, cap8: int):
    """Phase 1.5b, group lists: each list's candidate groups in ascending
    order (``compact_groups``, ``pallas_wide.py:1665-1674``), padded with
    the inert group, as the rows of those groups in order.  Returns (rows
    [g, cap8 * 8] int32, counts [g] int32 in groups, key [g, L1] int32:
    each group's position among its list's candidates)."""
    g, L1 = vis_g.shape
    dev = vis_g.device
    counts = vis_g.sum(dim=1, dtype=torch.int32)
    key = vis_g.cumsum(dim=1, dtype=torch.int32) - 1
    pid = torch.arange(g, device=dev, dtype=torch.int64)[:, None]
    dest = torch.where(vis_g & (key < cap8), pid * cap8 + key, g * cap8)
    buf = torch.full((g * cap8 + 1,), trace.inert_row // 8, dtype=torch.int32,
                     device=dev)
    grp = torch.arange(L1, device=dev, dtype=torch.int32)
    buf.scatter_(0, dest.reshape(-1), grp.expand(g, L1).reshape(-1))
    groups = buf[:g * cap8].reshape(g, cap8, 1)
    rows = groups * 8 + torch.arange(8, device=dev, dtype=torch.int32)
    return rows.reshape(g, cap8 * 8), counts, key


def prepare(trace: LeafTrace, origin: torch.Tensor, direction: torch.Tensor,
            t_max: torch.Tensor, active: torch.Tensor, block_rays: int,
            cap_rows: int = 0):
    """Phases 1 and 1.5 of ``bitsru8``: pad the rays into packets and build
    each packet's row list.  Returns the leaf-row kernel's inputs (rays
    [7, n_pad], lists [g, cap] int32, n_rows [g] int32 with -1 for a
    sweep)."""
    rays = pack_rays(origin, direction, t_max, active, block_rays)
    vis = packet_vis(trace, rays, block_rays)
    lists, n_rows = row_lists(trace, vis, list_capacity(trace, cap_rows))
    return rays, lists, n_rows


def _bf16_rays(rays: torch.Tensor) -> torch.Tensor:
    """The ray rounded to bf16 (t_max kept): with ``h`` JAX's kernel casts
    the ray to bf16 (``pallas_wide.py:1318-1323``) also where the record
    test it runs, Baldwin–Weber or the ILP merge, computes in f32."""
    return torch.cat([rays[:6].to(torch.bfloat16).float(), rays[6:]]).contiguous()


def traverse_bits(trace: LeafTrace, origin: torch.Tensor,
                  direction: torch.Tensor, t_max: torch.Tensor,
                  active: torch.Tensor, any_hit: bool = False,
                  block_rays: int = 2048, cap_rows: int = 0,
                  algo: str = "bitsru8", refine_rows: int = 0,
                  pair_groups: int = 0) -> Hit:
    """Closest-hit (or any-hit) traversal of [N] rays by a ``bits*`` algo;
    ``prim`` is the leaf-order triangle slot (map through scene.perm for
    the original id), -1 for a miss or an inactive ray.  With the any-hit
    trim (any-hit and none of ``w``, ``h``, ``i``, ``a``, ``2``) prim is 0
    for an occluded ray; otherwise any-hit returns the closest hit below
    t_max.  ``refine_rows`` (default BITS_REFINE_ROWS) sizes round A of
    ``2``, ``pair_groups`` the per-ray lists of ``p``."""
    f = parse_algo(algo)
    if f.pairs:
        from .pairs import traverse_pairs

        return traverse_pairs(trace, origin, direction, t_max, active, any_hit,
                              block_rays, cap_rows, pair_groups)
    n = origin.shape[0]
    H = max(1, block_rays // SUB_LIST_RAYS) if f.sub_lists else 1
    if block_rays % H:
        raise ValueError(f"block_rays={block_rays} does not split into {H} sub-lists")
    R = block_rays // H
    rays = pack_rays(origin, direction, t_max, active, block_rays)
    vis = packet_vis(trace, rays, R)
    table = trace.ltabw if f.bw else trace.ltab
    krays = _bf16_rays(rays) if f.bf16 and (f.bw or f.ilp) else rays
    kw = f.kernel()
    trim = any_hit and f.trims()
    cap = list_capacity(trace, cap_rows)
    if f.row_lists:
        lists, n_rows = row_lists(trace, vis, cap)
        t, r, u, v = leaf_rows(table, lists, n_rows, krays, R, trim, **kw)
    else:
        cap8 = cap // 8
        rows, counts, key = group_lists(trace, group_any(trace, vis), cap8)
        overflow = counts > cap8
        if not f.refine:
            n_rows = torch.where(overflow, -1, counts * 8).to(torch.int32)
            t, r, u, v = leaf_rows(table, rows, n_rows, krays, R, trim, **kw)
        else:
            # Round A also sweeps the overflowed lists (round B lists none
            # of theirs), where JAX sweeps them in a call of its own.
            k1 = min(-(-(refine_rows or BITS_REFINE_ROWS) // 8), cap8)
            n_a = torch.where(overflow, -1, counts.clamp(max=k1) * 8).to(torch.int32)
            best = leaf_rows(table, rows, n_a, krays, R, False, **kw)
            tm2 = (torch.where(best[1] >= 0, -F32_FAR_AWAY, rays[6]) if any_hit
                   else best[0])
            vis_b = group_any(trace, packet_vis(trace, rays, R, tm2)) & (key >= k1)
            rows_b, counts_b, _ = group_lists(trace, vis_b, cap8)
            n_b = torch.where(overflow, 0, counts_b * 8).to(torch.int32)
            t, r, u, v = leaf_rows(table, rows_b, n_b, krays, R, False, carry=best, **kw)
    return Hit(prim=torch.where(active, r[:n], -1), t=t[:n], u=u[:n], v=v[:n])

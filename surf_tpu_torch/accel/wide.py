"""The dense leaf table the traversals read (the port's copy of
``surf_tpu.accel.wide.build_leaf_table`` and what it needs).

Leaf-ordered triangles are packed 8 to a 128-lane row, each in a 16-lane
record: v0 at lanes 0-2, e1 = v1 - v0 at 3-5, e2 = v2 - v0 at 6-8, and the
record's leaf-order triangle slot as int32 bits in lane 9 (-1 for
padding).  Zero records fail the Möller–Trumbore |det| >= eps test, so no
count field is needed.  Over the rows sits an arithmetic 8-ary box
hierarchy: each level boxes 8 consecutive entries of the level below.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .builder import triangle_bounds

LEAF_TRIS = 8        # triangles per leaf row
LANE = 128
REC = 16


class LeafTable(NamedTuple):
    table: np.ndarray     # [n_pad, 128] f32 (v0/e1/e2 per 16-lane record)
    rec_slot: np.ndarray  # [n_pad * 8] int32 -> leaf-order tri slot (-1)
    box_lo: np.ndarray    # [E, 3] f32 (rows then hierarchy levels)
    box_hi: np.ndarray    # [E, 3]
    anc: np.ndarray       # [n_rows, MAXD] int32 (self, parent, ..., root)
    n_rows: int           # real leaf rows


def _fill_leaf_rows(table, rec_slot, tv0, tv1, tv2):
    """Vectorized in-place write of every leaf record's (v0, e1, e2) from
    leaf-ordered vertices."""
    valid = rec_slot >= 0
    rows_idx = np.nonzero(valid)[0] // LEAF_TRIS
    lane0 = (np.nonzero(valid)[0] % LEAF_TRIS) * REC
    slots = rec_slot[valid]
    for c in range(3):
        table[rows_idx, lane0 + 0 + c] = tv0[slots, c]
        table[rows_idx, lane0 + 3 + c] = tv1[slots, c] - tv0[slots, c]
        table[rows_idx, lane0 + 6 + c] = tv2[slots, c] - tv0[slots, c]


def build_leaf_table(tv0, tv1, tv2) -> LeafTable:
    """Pack leaf-ordered triangles densely (8/row) and build the 8-ary
    box hierarchy over consecutive rows."""
    tv0 = np.asarray(tv0, np.float32)
    tv1 = np.asarray(tv1, np.float32)
    tv2 = np.asarray(tv2, np.float32)
    T = len(tv0)
    n0 = -(-T // LEAF_TRIS)
    # Pad with one FULL inert 8-row group beyond the last (possibly
    # partial) real group: list padding points at it (all-zero rows fail
    # every MT |det| test).
    n_pad = (-(-n0 // 8) + 1) * 8
    rec = np.full(n_pad * LEAF_TRIS, -1, np.int32)
    rec[:T] = np.arange(T, dtype=np.int32)
    table = np.zeros((n_pad, LANE), np.float32)
    _fill_leaf_rows(table, rec, tv0, tv1, tv2)
    # Spare lane 9 of each 16-lane record carries the record's leaf-order
    # tri slot (int32; -1 for padding), so the intersection kernels emit
    # prim ids straight from the fetched row.
    rec2d = rec.reshape(n_pad, LEAF_TRIS)
    for j in range(LEAF_TRIS):
        table[:, REC * j + 9] = np.ascontiguousarray(
            rec2d[:, j]).view(np.float32)

    tlo, thi = triangle_bounds(tv0, tv1, tv2)
    lo0 = np.full((n0, 3), np.inf, np.float32)
    hi0 = np.full((n0, 3), -np.inf, np.float32)
    idx = np.arange(T) // LEAF_TRIS
    np.minimum.at(lo0, idx, tlo)
    np.maximum.at(hi0, idx, thi)
    levels_lo, levels_hi = [lo0], [hi0]
    while len(levels_lo[-1]) > 1:
        cur_lo, cur_hi = levels_lo[-1], levels_hi[-1]
        n = len(cur_lo)
        npar = -(-n // 8)
        plo = np.full((npar, 3), np.inf, np.float32)
        phi = np.full((npar, 3), -np.inf, np.float32)
        gid = np.arange(n) // 8
        np.minimum.at(plo, gid, cur_lo)
        np.maximum.at(phi, gid, cur_hi)
        levels_lo.append(plo)
        levels_hi.append(phi)
    box_lo = np.concatenate(levels_lo)
    box_hi = np.concatenate(levels_hi)
    offs = np.cumsum([0] + [len(x) for x in levels_lo])
    maxd = len(levels_lo)
    r = np.arange(n0)
    anc = np.empty((n0, maxd), np.int32)
    for k in range(maxd):
        anc[:, k] = offs[k] + r // (8 ** k)
    return LeafTable(table, rec, box_lo, box_hi, anc, n0)

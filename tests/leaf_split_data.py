"""Adversarial inputs of the leaf-row kernels' split merge (and their
Baldwin–Weber form), the bf16 tie set and the bf16 rounding pairs, shared
by the CPU emulation tests
(test_torch_leaf_split.py, test_torch_bf16_split.py) and the card's tests
(test_torch_cuda.py).  Made with numpy from a seed; imports no JAX."""

import numpy as np
import torch

REC = 16
TRIS = 8
FAR = 3.4e38


def _tri_record(v0, v1, v2, sid):
    rec = np.zeros(REC, np.float32)
    rec[0:3] = v0
    rec[3:6] = np.subtract(v1, v0)
    rec[6:9] = np.subtract(v2, v0)
    rec[9] = np.array([sid], np.int32).view(np.float32)[0]
    return rec


def adversarial(seed=0, live_share=1.0, block_rays=512):
    """(table, lists, n_rows, rays, block_rays) of four lists.

    A table of 24 rows (row 23 all zero, inert) with one triangle X copied
    under other slot ids: twice in row 2 (j 1 and j 6; slot ids 1000,
    1001), in row 5 (1002), row 6 (1003) and row 11 (1004).  List 0 holds
    rows 5 and 6 at positions 3 and 4, either side of a 4-row split
    boundary, row 11 at position 1 and row 2 at position 9, and an inert
    row (4, zeroed) inside, and rows 7 and 8, whose triangles of edges
    1.2e19 (slot id 2000, hit from below X) and 1e20 put |det| past 2^126;
    list 1 is an all-dead packet; list 2 has 0 rows;
    list 3 sweeps the table (n_rows = -1).  Rays aim at X from both sides;
    t_max covers 1e-5 (dead), 1.00001e-5 (live), 0, -FAR, NaN, +inf and 2.
    ``live_share`` keeps that share of the other lanes of lists 0, 2 and 3
    live (t_max = 1e30) and makes the rest dead (-FAR)."""
    rng = np.random.default_rng(seed)
    E = 24
    table = np.zeros((E, TRIS, REC), np.float32)
    sid = 0
    for r in range(E - 1):
        for j in range(TRIS):
            c = rng.uniform(-2, 2, 3)
            table[r, j] = _tri_record(c, c + rng.uniform(-1, 1, 3), c + rng.uniform(-1, 1, 3),
                                      sid)
            sid += 1
    x = ([0.0, -0.5, 0.5], [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5])  # plane z = 0.5
    for k, (r, j) in enumerate([(2, 1), (2, 6), (5, 3), (6, 0), (11, 7)]):
        table[r, j] = _tri_record(*x, 1000 + k)
    # a triangle of edges 1.2e19 across the rays' path below X (|det| about
    # 1.4e38 >= 2^126, out of the in-range reciprocal's range; slot id
    # 2000) and one of edges 1e20 (det = inf; no hit; 2001)
    table[7, 3] = _tri_record([-1.0, -1.0, 0.3], [1.2e19, -1.0, 0.3], [-1.0, 1.2e19, 0.3],
                              2000)
    table[8, 5] = _tri_record([-1.0, -1.0, 0.2], [1e20, -1.0, 0.2], [-1.0, 1e20, 0.2], 2001)
    table[4] = 0.0   # another inert row, inside the lists
    table = torch.from_numpy(table.reshape(E, 128))

    R = block_rays
    g = 4
    n = g * R
    rng_t = np.random.default_rng(seed + 1)
    aim = np.stack([rng_t.uniform(-0.2, 0.2, n), rng_t.uniform(0.0, 0.4, n),
                    np.full(n, 0.5)], 1)
    side = np.where(rng_t.random(n) < 0.5, -1.0, 1.0)
    o = aim + np.stack([rng_t.normal(0, 0.3, n), rng_t.normal(0, 0.3, n),
                        side * rng_t.uniform(0.5, 3.0, n)], 1)
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.where(rng_t.random(n) < live_share, 1e30, -FAR).astype(np.float32)
    tm[7::50] = 1e-5
    tm[8::50] = 1.00001e-5
    tm[9::50] = 0.0
    tm[10::50] = -FAR
    tm[11::50] = np.nan
    tm[12::50] = np.inf
    tm[13::50] = 2.0
    tm[R:2 * R] = -FAR                          # list 1: all dead
    rays = np.concatenate([o.T, d.T, tm[None]]).astype(np.float32)

    cap = 16
    lists = np.full((g, cap), E - 1, np.int32)
    lists[0, :12] = [0, 11, 1, 5, 6, 4, 7, 8, 9, 2, 3, 10]
    lists[1, :6] = [2, 5, 6, 11, 0, 1]
    lists[3, :3] = [6, 5, 2]                    # ignored: a sweep
    n_rows = torch.tensor([16, 6, 0, -1], dtype=torch.int32)
    return (table, torch.from_numpy(lists), n_rows, torch.from_numpy(rays).contiguous(), R)


def bw_table(table: torch.Tensor) -> torch.Tensor:
    """The Baldwin–Weber records (``LeafTable.tablew``'s layout: n, d0, a1,
    a1w, a2, a2w, slot id in lane 12) of a table of Möller–Trumbore records
    (v0, e1, e2, slot id in lane 9), derived in float64 as
    ``accel/wide.py`` ``_fill_bw_rows`` derives them; an all-zero (inert)
    record stays all zero.  The triangles of edges 1.2e19 and 1e20 of
    ``adversarial`` give |n| near 1.4e38 and inf: |den| past 2^126."""
    rec = table.numpy().reshape(-1, TRIS, REC)
    out = np.zeros_like(rec)
    for r, j in zip(*np.nonzero(rec.any(axis=2))):
        v0 = rec[r, j, 0:3].astype(np.float64)
        e1 = rec[r, j, 3:6].astype(np.float64)
        e2 = rec[r, j, 6:9].astype(np.float64)
        n = np.cross(e1, e2)
        k = int(np.argmax(np.abs(n)))
        i_, j_ = (k + 1) % 3, (k + 2) % 3
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            inv = 1.0 / n[k]
            a1 = np.zeros(3)
            a2 = np.zeros(3)
            a1[i_], a1[j_] = e2[j_] * inv, -e2[i_] * inv
            a1w = (e2[i_] * v0[j_] - e2[j_] * v0[i_]) * inv
            a2[i_], a2[j_] = -e1[j_] * inv, e1[i_] * inv
            a2w = (e1[j_] * v0[i_] - e1[i_] * v0[j_]) * inv
            out[r, j, 0:12] = np.concatenate([n, [n @ v0], a1, [a1w], a2, [a2w]])
        out[r, j, 12] = rec[r, j, 9]
    return torch.from_numpy(out.reshape(table.shape))


# --- bf16: equal t at different positions, and the rounding pairs ----------

TIE_DZ = 2.0 ** -6  # a closer plane: a sixth of the rays get the same bf16 t


def _plane_record(cx, cy, z, sid, size=0.42):
    """A triangle of the plane z covering [cx - size/2, cx + size/2] x
    [cy - size/2, cy + size/2], and no point past cx + 1.5 size or cy +
    1.5 size; slot id sid."""
    h = size / 2
    v0 = [cx - h, cy - h, z]
    return _tri_record(v0, [cx + 3 * h, cy - h, z], [cx - h, cy + 3 * h, z], sid)


# The tie groups: (region centre x, (row, j) of the farther plane, (row, j)
# of the closer one, TIE_DZ above it).  In list 0 the farther plane comes
# first: within a pair (j 2, 3), within a row across pairs (j 1, 6), across
# rows (positions 3 and 9), and across a 16-row split boundary (positions
# 15 and 16).
TIE_GROUPS = {"pair": (-1.5, (2, 2), (2, 3)), "row": (-0.5, (2, 1), (2, 6)),
              "rows": (0.5, (3, 4), (9, 0)), "split": (1.5, (10, 5), (11, 2))}
TIE_LIST = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 13, 14, 15, 16, 10, 11, 17, 18, 19]


def bf16_ties(seed=0, live_share=1.0, block_rays=512):
    """(table, lists, n_rows, rays, block_rays) of four lists whose rays
    meet, in each of four regions, two planes TIE_DZ apart (t about 2.5,
    where a bf16 step is 2^-6): many rays get the same bf16 t from both,
    and the first list position must win.  List 0 puts the farther plane
    first (TIE_GROUPS), list 1 the same rows in reverse order, list 2
    sweeps the table (n_rows = -1), list 3 has 0 rows.  Slot ids: the
    farther plane 3000 + group, the closer 3100 + group; other records are
    small triangles out of the rays' way (row 23 inert).  t_max as
    ``adversarial``'s: live_share of the lanes at 1e30, the rest -FAR, and
    dead, barely live, NaN, +inf and 2 lanes."""
    rng = np.random.default_rng(seed)
    E = 24
    table = np.zeros((E, TRIS, REC), np.float32)
    for r in range(E - 1):
        for j in range(TRIS):
            c = np.array([rng.uniform(4, 8), rng.uniform(-2, 2), rng.uniform(-2, 2)])
            table[r, j] = _tri_record(c, c + rng.uniform(-1, 1, 3), c + rng.uniform(-1, 1, 3),
                                      r * TRIS + j)
    for k, (cx, far, near) in enumerate(TIE_GROUPS.values()):
        table[far] = _plane_record(cx, 0.0, 0.5, 3000 + k)
        table[near] = _plane_record(cx, 0.0, 0.5 + TIE_DZ, 3100 + k)
    table = torch.from_numpy(table.reshape(E, 128))

    R = block_rays
    g = 4
    n = g * R
    rng_t = np.random.default_rng(seed + 1)
    region = np.array([v[0] for v in TIE_GROUPS.values()])[rng_t.integers(0, 4, n)]
    aim = np.stack([region + rng_t.uniform(-0.2, 0.2, n), rng_t.uniform(-0.2, 0.2, n),
                    np.full(n, 0.5)], 1)
    o = aim + np.stack([rng_t.normal(0, 0.2, n), rng_t.normal(0, 0.2, n),
                        rng_t.uniform(1.5, 3.5, n)], 1)
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.where(rng_t.random(n) < live_share, 1e30, -FAR).astype(np.float32)
    tm[7::50] = 1e-5
    tm[8::50] = 1.00001e-5
    tm[11::50] = np.nan
    tm[12::50] = np.inf
    tm[13::50] = 2.0
    rays = np.concatenate([o.T, d.T, tm[None]]).astype(np.float32)

    cap = 24
    lists = np.full((g, cap), E - 1, np.int32)
    lists[0, :len(TIE_LIST)] = TIE_LIST
    lists[1, :len(TIE_LIST)] = TIE_LIST[::-1]
    n_rows = torch.tensor([len(TIE_LIST), len(TIE_LIST), -1, 0], dtype=torch.int32)
    return (table, torch.from_numpy(lists), n_rows, torch.from_numpy(rays).contiguous(), R)


def carry_starts(t, r, u, v, seed=0):
    """A carry-in (t, r, u, v) from a round A's result with some start t
    replaced by the liveness rule's edge cases: 1e-5 and 0 (dead), NaN
    (dead), -inf (dead), +inf (live), 1.00001e-5 (live)."""
    t = t.clone()
    rng = np.random.default_rng(seed)
    for val in (1e-5, 0.0, float("nan"), float("-inf"), float("inf"), 1.00001e-5):
        t[torch.from_numpy(rng.choice(t.numel(), max(1, t.numel() // 40), replace=False))] = val
    return t, r.clone(), u.clone(), v.clone()


def bf16_pairs(n=4096, seed=0):
    """(x, y), two [m] bfloat16 tensors (m even): n pairs of random bit
    patterns over every exponent (subnormals, inf and NaN among them), then
    chosen ones: +-0, +-inf, NaN, the least subnormal, the largest finite
    value, products and sums that land on a tie between two bf16 values,
    sums past the largest finite value, and products below 2^-126."""
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, 1 << 16, n).astype(np.uint16)
    yb = rng.integers(0, 1 << 16, n).astype(np.uint16)
    x = list(torch.from_numpy(xb.view(np.int16)).view(torch.bfloat16).float().tolist())
    y = list(torch.from_numpy(yb.view(np.int16)).view(torch.bfloat16).float().tolist())
    inf, nan = float("inf"), float("nan")
    tiny, big = 2.0 ** -133, (2 - 2 ** -7) * 2.0 ** 127
    special = [0.0, -0.0, inf, -inf, nan, tiny, -tiny, big, -big, 1.0, -1.0, 2.0 ** -126]
    for a in special:
        for b in special:
            x.append(a)
            y.append(b)
    for k in range(128):                     # ties: sums at half a step, products
        x += [1 + k / 128, 1 + k / 128, 3.0, big, 2.0 ** -70 * (1 + k / 128)]
        y += [2.0 ** -8, -2.0 ** -8, 1 + (2 * (k % 64) + 1) / 128, big * (k % 2 * 2 - 1),
              2.0 ** -66 * (1 + (127 - k) / 128)]
    if len(x) % 2:
        x.append(1.0)
        y.append(1.0)
    return (torch.tensor(x, dtype=torch.float32).to(torch.bfloat16),
            torch.tensor(y, dtype=torch.float32).to(torch.bfloat16))

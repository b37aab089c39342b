"""Adversarial inputs of the leaf-row kernel's split merge, shared by the
CPU emulation tests (test_torch_leaf_split.py) and the card's tests
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

"""The leaf test as a matrix product with a fused epilogue: the card's
version of ``scripts/tpu_mxu_pallas_micro.py`` (``kernel`` ``:42`` inside
``main`` ``:33``, ``make(B, ntiles, dyn)`` ``:83``, its
``pl.pallas_call`` at ``:101``).

Per block p of B: 256 rays' 8 features (rays [B, 256, 8]) against
``ntiles`` tiles of 128 triangles (rows [B, ntiles, 8, 768]): per tile
out = rays x panel [256, 768], the Möller–Trumbore epilogue on its six
blocks (``_mxu.epilogue_plain``), and per (ray, lane) the least t < tmax
and its tile (t [B, 256, 128] float32, k int32, -1 where nothing hits).
``static`` runs every tile (the script unrolls them); ``dyn`` the first
min(trips[p], ntiles) (a ``fori_loop``; on the card a loop to a count read
in the kernel).  The script runs four cases at 4096 tiles in all: ntiles
8 (B 512) and 16 (B 256), each static and dyn; its trips equal ntiles
(``:121``), so dyn equals static there: ``make_trips_data`` shows them
apart, ``make_tmax_data`` makes t < tmax decide some tests.  Run on the
card:

    python -m surf_tpu_torch.micro.mxu_tiles

which holds each kernel to its plain version under ``_mxu.MXU_GATE`` on
the first CHECK_BLOCKS blocks of the script's data, on the trips data
and on the tmax data, and on the script's whole case, then times it
there (``measure``; ``chip_smoke.py`` phase 10 calls it too).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _mxu, _visit
from ._mxu import COLS, FAR, K, NT, R

CASES = ((8, "static"), (8, "dyn"), (16, "static"), (16, "dyn"))  # the script's order
TOTAL_TILES = 4096            # the script's tiles of each case
CHECK_BLOCKS = 4              # blocks of the small checks
TRIPS_SEED, TMAX_SEED = 1, 2

# Kernel launches since the last reset, per entry point of mxu_micro.cu.
LAUNCHES = {f"mxu_tiles{n}_{m}": 0 for n, m in CASES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def script_blocks(ntiles: int) -> int:
    return TOTAL_TILES // ntiles


def make_data(case: int, device: torch.device, blocks=None, tiles=None):
    """(rays, rows, tmax, trips) of the script's case ``case`` (CASES),
    drawn as ``main`` draws them (``:119-124``: per case rays, then rows,
    normal, from one ``default_rng(0)``), cut to the first ``blocks``
    blocks and ``tiles`` tiles; tmax 1e30, trips the tile count."""
    earlier = []
    for ntiles, _ in CASES[:case]:
        b = script_blocks(ntiles)
        earlier += [(b, R, K), (b, ntiles, K, COLS)]
    rng = _mxu.rng_after(*earlier)
    ntiles = CASES[case][0]
    b = script_blocks(ntiles)
    rays = _mxu.normals(rng, (b, R, K), blocks)
    rows = _mxu.normals(rng, (b, ntiles, K, COLS), blocks, tiles)
    n = rays.shape[0]
    tmax = np.full((n, R, NT), FAR, np.float32)
    trips = np.full(n, rows.shape[1], np.int32)
    return tuple(torch.from_numpy(x).to(device) for x in (rays, rows, tmax, trips))


def trips_of(ntiles: int) -> tuple:
    """The trips data's per-block trips: none, one, half, all, and more
    than there are tiles (clamped)."""
    return (0, 1, ntiles // 2, ntiles, ntiles + 3)


def make_trips_data(ntiles: int, device: torch.device):
    """(rays, rows, tmax, trips) of 5 blocks, normal from
    ``default_rng(TRIPS_SEED)``, trips ``trips_of(ntiles)``: ``dyn``
    departs from ``static`` on the blocks whose trips are below ntiles."""
    rng = np.random.default_rng(TRIPS_SEED)
    trips = np.array(trips_of(ntiles), np.int32)
    n = trips.shape[0]
    rays = rng.normal(size=(n, R, K)).astype(np.float32)
    rows = rng.normal(size=(n, ntiles, K, COLS)).astype(np.float32)
    tmax = np.full((n, R, NT), FAR, np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (rays, rows, tmax, trips))


def make_tmax_data(case: int, device: torch.device, blocks=CHECK_BLOCKS, tiles=None):
    """``make_data``'s arrays with a finite tmax near each pair's best hit
    (``_mxu.tmax_near`` of the plain static result on the CPU), so that
    t < tmax decides some tests."""
    rays, rows, tmax, trips = make_data(case, torch.device("cpu"), blocks, tiles)
    bt = mxu_tiles_plain(rays, rows, tmax, trips, False)[0]
    tmax = _mxu.tmax_near(bt, TMAX_SEED)
    return tuple(x.to(device) for x in (rays, rows, tmax, trips))


def _check(rays, rows, tmax, trips):
    _mxu.check(rays, rows, tmax, (R, K), (R, NT), trips)


def mxu_tiles(rays: torch.Tensor, rows: torch.Tensor, tmax: torch.Tensor, trips: torch.Tensor,
              dyn: bool):
    """(t [B, 256, 128], k [B, 256, 128] int32): the best hit per (ray,
    lane) over the tiles (``dyn``: the first min(trips[p], ntiles) of block
    p): the kernel for CUDA tensors (8 or 16 tiles a block), the plain
    version for CPU ones."""
    _check(rays, rows, tmax, trips)
    if not _visit.on_card(rows.device, "mxu_tiles"):
        return mxu_tiles_plain(rays, rows, tmax, trips, dyn)
    _mxu.need_tiles(rows, (8, 16), "mxu_tiles")
    name = f"mxu_tiles{rows.shape[1]}_{'dyn' if dyn else 'static'}"
    t, k, _ = _mxu.launch(name, LAUNCHES, rays, rows, tmax, trips)
    return t, k


def mxu_tiles_plain(rays, rows, tmax, trips, dyn: bool):
    """Plain PyTorch version of the kernels (``_mxu.rows_plain``)."""
    _check(rays, rows, tmax, trips)
    bt, bk, _ = _mxu.rows_plain(rays, rows, tmax, "epi", trips if dyn else None)
    return bt, bk


def n_bytes(rays, rows, tmax, trips, dyn: bool) -> int:
    """Bytes the function needs: the rays, the panels of the tiles run, tmax
    and trips once, t and k written once."""
    run = tiles_run(rows, trips, dyn)
    return 4 * (rays.numel() + run * K * COLS + trips.numel() + 3 * tmax.numel())


def tiles_run(rows, trips, dyn: bool) -> int:
    """The tiles the kernel runs: min(trips[p], ntiles) a block for dyn."""
    return int(trips.clamp(0, rows.shape[1]).sum()) if dyn else rows.shape[0] * rows.shape[1]


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def measure(device: torch.device, say=print) -> dict:
    """Per entry point, ``_mxu.measure`` on the first CHECK_BLOCKS blocks of
    the script's case, on ``make_trips_data``, on ``make_tmax_data`` and on
    the script's whole case (timed there, the dot alone as ``torch.bmm`` of
    rays x the panels side by side)."""
    out = {}
    for case, (ntiles, mode) in enumerate(CASES):
        name = f"mxu_tiles{ntiles}_{mode}"
        dyn = mode == "dyn"
        whole = make_data(case, device)
        sets = dict(script=make_data(case, device, CHECK_BLOCKS),
                    trips=make_trips_data(ntiles, device), tmax=make_tmax_data(case, device),
                    whole=whole)
        rays, rows, _, trips = whole
        rhs = rows.permute(0, 2, 1, 3).reshape(rows.shape[0], K, ntiles * COLS)
        out[name] = _mxu.measure(
            name, LAUNCHES, lambda d: mxu_tiles(*d, dyn), lambda d: mxu_tiles_plain(*d, dyn),
            lambda got, want, d: _mxu.compare(got, want, d[0], d[1], "epi"), sets,
            (rays, rhs, False), tiles_run(rows, trips, dyn), n_bytes(*whole, dyn), say)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mxu_tiles: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

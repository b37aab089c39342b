"""The matrix-product leaf test transposed: the card's version of
``scripts/tpu_mxu_micro3.py``'s ``pltd_kernel`` (``:73`` inside ``main``
``:30``, ``make_pltd`` ``:105``, its ``pl.pallas_call`` at ``:124``).

``mxu_tiles``' static test with rays and triangles swapped: rays_t
[B, 8, 256] (features by rays), rows [B, ntiles, 8, 768], tmax_t
[B, 128, 256]; per tile out^T = panel^T x rays_t [768, 256], the
epilogue on its six blocks of 128 rows, and per (lane, ray) the least
t < tmax and its tile (t, k [B, 128, 256]).  Elementwise the product is
the rows layout's (the same 8 products summed in the same order), so the
plain version is ``_mxu.rows_plain`` on the transposed arrays.  The
script's ``make_xla`` (``:39``) is XLA, not a kernel, and is not ported;
its draws come first (``:142-145``), so ``make_data`` makes and discards
them.  The script deletes trips (``:75``): there is no trips data.  Run on
the card:

    python -m surf_tpu_torch.micro.mxu_pltd

which holds the kernel to its plain version under ``_mxu.MXU_GATE`` on
the first CHECK_BLOCKS blocks of the script's data, on the tmax data and
on the whole script data, then times it there (``measure``;
``chip_smoke.py`` phase 10 calls it too).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _mxu, _visit
from ._mxu import COLS, FAR, K, NT, R

B = 256                       # the script's blocks
NTILES = 16                   # and tiles a block (NTT)
XLA_CASES = ((256, 256), (32, 2048))  # make_xla's (B, R) of xlaA, xlaB, drawn first
CHECK_BLOCKS = 4
TMAX_SEED = 4

# Kernel launches since the last reset (mxu_micro.cu's entry point).
LAUNCHES = {"mxu_pltd": 0}


def reset_launches() -> None:
    LAUNCHES["mxu_pltd"] = 0


def make_data(device: torch.device, blocks=None, tiles=None):
    """(rays_t, rows, tmax_t) as ``main`` draws them (``:142-153``): the
    xlaA and xlaB rays and rhs are drawn and discarded, then raysT and
    rows, normal, from ``default_rng(0)``; cut to the first ``blocks``
    blocks and ``tiles`` tiles; tmax_t 1e30."""
    rng = _mxu.rng_after(*[shape for b, r in XLA_CASES
                           for shape in ((b, r, K), (b, K, NTILES * COLS))])
    rays_t = _mxu.normals(rng, (B, K, R), blocks)
    rows = _mxu.normals(rng, (B, NTILES, K, COLS), blocks, tiles)
    tmax_t = np.full((rays_t.shape[0], NT, R), FAR, np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (rays_t, rows, tmax_t))


def make_tmax_data(device: torch.device, blocks=CHECK_BLOCKS, tiles=None):
    """``make_data``'s arrays with a finite tmax_t near each pair's best hit
    (``_mxu.tmax_near`` of the plain result on the CPU)."""
    rays_t, rows, tmax_t = make_data(torch.device("cpu"), blocks, tiles)
    bt = mxu_pltd_plain(rays_t, rows, tmax_t)[0]
    return tuple(x.to(device) for x in (rays_t, rows, _mxu.tmax_near(bt, TMAX_SEED)))


def _check(rays_t, rows, tmax_t):
    _mxu.check(rays_t, rows, tmax_t, (K, R), (NT, R))


def mxu_pltd(rays_t: torch.Tensor, rows: torch.Tensor, tmax_t: torch.Tensor):
    """(t [B, 128, 256], k [B, 128, 256] int32): the best hit per (lane,
    ray) over the tiles: the kernel for CUDA tensors (16 tiles a block),
    the plain version for CPU ones."""
    _check(rays_t, rows, tmax_t)
    if not _visit.on_card(rows.device, "mxu_pltd"):
        return mxu_pltd_plain(rays_t, rows, tmax_t)
    _mxu.need_tiles(rows, (NTILES,), "mxu_pltd")
    t = torch.empty_like(tmax_t)
    k = torch.empty(tmax_t.shape, dtype=torch.int32, device=rows.device)
    _visit.launch("mxu_pltd", LAUNCHES, rows.device, rays_t, rows, tmax_t, rows.shape[0], t, k)
    return t, k


def to_rows(x: torch.Tensor) -> torch.Tensor:
    """[B, a, b] -> [B, b, a], contiguous: the transposed layout to the rows
    layout and back."""
    return x.transpose(1, 2).contiguous()


def mxu_pltd_plain(rays_t, rows, tmax_t):
    """Plain PyTorch version of the kernel: ``_mxu.rows_plain`` on the
    transposed arrays, its outputs transposed back."""
    _check(rays_t, rows, tmax_t)
    bt, bk, _ = _mxu.rows_plain(to_rows(rays_t), rows, to_rows(tmax_t), "epi")
    return to_rows(bt), to_rows(bk)


def compare(got, want, rays_t, rows) -> dict:
    """``_mxu.compare`` of two results in the rows layout."""
    return _mxu.compare([to_rows(x) for x in got], [to_rows(x) for x in want], to_rows(rays_t),
                        rows, "epi")


def n_bytes(rays_t, rows, tmax_t) -> int:
    """Bytes the function needs: rays, rows, tmax once, t and k written once."""
    return 4 * (rays_t.numel() + rows.numel() + 3 * tmax_t.numel())


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def measure(device: torch.device, say=print) -> dict:
    """``_mxu.measure`` on the first CHECK_BLOCKS blocks of the script's
    data, on ``make_tmax_data`` and on the whole script data (timed there,
    the dot alone as ``torch.bmm`` of panel^T [B, 16 x 768, 8] x rays_t)."""
    whole = make_data(device)
    sets = dict(script=make_data(device, CHECK_BLOCKS), tmax=make_tmax_data(device),
                whole=whole)
    rays_t, rows, _ = whole
    lhs = rows.permute(0, 1, 3, 2).reshape(B, NTILES * COLS, K)
    return {"mxu_pltd": _mxu.measure(
        "mxu_pltd", LAUNCHES, lambda d: mxu_pltd(*d), lambda d: mxu_pltd_plain(*d),
        lambda got, want, d: compare(got, want, d[0], d[1]), sets, (lhs, rays_t, False),
        B * NTILES, n_bytes(*whole), say)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mxu_pltd: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

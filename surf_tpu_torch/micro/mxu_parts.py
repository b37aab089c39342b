"""The parts of the matrix-product leaf test's cost: the card's version of
``scripts/tpu_mxu_pallas_micro2.py`` (``epilogue`` ``:39``, ``kernel``
``:57`` inside ``main`` ``:30``, ``make(variant)`` ``:102``, its
``pl.pallas_call`` at ``:121``).

B = 64 blocks of 256 rays, 16 tiles each, the arrays of ``mxu_tiles``.
Variants, in the script's order:

- ``full``: dot and epilogue (``mxu_tiles``' static at 16 tiles);
- ``dotonly``: the dot, then bt = min(bt, den) (a NaN-propagating min);
  k stays -1 (the script never writes it);
- ``epionly``: no dot: ray r's value of column c is panel[r % 8, c], then
  the whole epilogue;
- ``dotbf16``: ``dotonly`` with both operands rounded to bf16 and an f32
  accumulation;
- ``bigdot``: one [256, 8] x [8, 16 x 768] dot over the tiles' panels side
  by side, then the min of each tile's den: ``dotonly``'s function (the
  script's ``pan`` is unused, ``:65-66``, ``:76``).  On the card every
  tile's panel columns are staged in shared memory by ``cp.async``, all
  issued before the first product (csrc/mxu_micro.cu).

Outputs (t, k, chk): chk [B, 256, 4] (``dotonly``, ``dotbf16``,
``bigdot``; else None), the sum of the dead blocks' values, which keeps
their products in the kernels (an output the script lacks).  Run on the
card:

    python -m surf_tpu_torch.micro.mxu_parts

which holds each kernel to its plain version (``epionly`` bit for bit,
the others under ``_mxu.MXU_GATE`` or ``BF16_GATE``) on the first
CHECK_BLOCKS blocks of the script's data and on the tmax data (the
script deletes trips, ``:59``: there is no trips data), and on the whole
script data, then times it there (``measure``; ``chip_smoke.py`` phase 10
calls it too).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _mxu, _visit
from ._mxu import COLS, DEAD, FAR, K, NT, R

VARIANTS = ("full", "dotonly", "epionly", "dotbf16", "bigdot")
B = 64                        # the script's blocks
NTILES = 16                   # and tiles a block
CHECK_BLOCKS = 4
TMAX_SEED = 3

# Kernel launches since the last reset, per entry point of mxu_micro.cu.
LAUNCHES = {f"mxu_parts_{v}": 0 for v in VARIANTS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def mode(variant: str) -> str:
    """``_mxu.rows_plain``'s mode and ``_mxu.compare``'s of a variant."""
    return {"full": "epi", "epionly": "epionly"}.get(variant, variant)


def make_data(device: torch.device, blocks=None, tiles=None):
    """(rays, rows, tmax) as ``main`` draws them (``:125-128``: rays, then
    rows, normal, from ``default_rng(0)``), cut to the first ``blocks``
    blocks and ``tiles`` tiles; tmax 1e30."""
    rng = _mxu.rng_after()
    rays = _mxu.normals(rng, (B, R, K), blocks)
    rows = _mxu.normals(rng, (B, NTILES, K, COLS), blocks, tiles)
    tmax = np.full((rays.shape[0], R, NT), FAR, np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (rays, rows, tmax))


def make_tmax_data(device: torch.device, blocks=CHECK_BLOCKS, tiles=None):
    """``make_data``'s arrays with a finite tmax near each pair's best hit
    (``_mxu.tmax_near`` of the plain ``full`` result on the CPU)."""
    rays, rows, tmax = make_data(torch.device("cpu"), blocks, tiles)
    bt = mxu_parts_plain(rays, rows, tmax, "full")[0]
    return tuple(x.to(device) for x in (rays, rows, _mxu.tmax_near(bt, TMAX_SEED)))


def _check(rays, rows, tmax, variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    _mxu.check(rays, rows, tmax, (R, K), (R, NT))


def mxu_parts(rays: torch.Tensor, rows: torch.Tensor, tmax: torch.Tensor, variant: str):
    """(t [B, 256, 128], k [B, 256, 128] int32, chk [B, 256, 4] or None)
    of ``variant``: the kernel for CUDA tensors (16 tiles a block), the
    plain version for CPU ones."""
    _check(rays, rows, tmax, variant)
    if not _visit.on_card(rows.device, "mxu_parts"):
        return mxu_parts_plain(rays, rows, tmax, variant)
    _mxu.need_tiles(rows, (NTILES,), "mxu_parts")
    return _mxu.launch(f"mxu_parts_{variant}", LAUNCHES, rays, rows, tmax,
                       dead=variant in DEAD)


def mxu_parts_plain(rays, rows, tmax, variant: str):
    """Plain PyTorch version of the kernels (``_mxu.rows_plain``)."""
    _check(rays, rows, tmax, variant)
    return _mxu.rows_plain(rays, rows, tmax, mode(variant))


def n_bytes(rays, rows, variant: str) -> int:
    """Bytes the function needs: the rays (not ``epionly``), the panels and
    tmax (not the DEAD variants) once, t, k (and chk) written once."""
    n_out = 2 * rows.shape[0] * R * NT + (rows.shape[0] * R * _mxu.CHK_GROUPS
                                          if variant in DEAD else 0)
    reads = rows.numel() + (0 if variant == "epionly" else rays.numel()) + (
        0 if variant in DEAD else rows.shape[0] * R * NT)
    return 4 * (reads + n_out)


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def measure(device: torch.device, say=print) -> dict:
    """Per variant, ``_mxu.measure`` on the first CHECK_BLOCKS blocks of the
    script's data, on ``make_tmax_data`` and on the whole script data
    (timed there, the dot alone as ``torch.bmm``: none for ``epionly``)."""
    sets = dict(script=make_data(device, CHECK_BLOCKS), tmax=make_tmax_data(device),
                whole=make_data(device))
    rays, rows, _ = sets["whole"]
    rhs = rows.permute(0, 2, 1, 3).reshape(B, K, NTILES * COLS)
    out = {}
    for v in VARIANTS:
        name = f"mxu_parts_{v}"
        how = "exact" if v == "epionly" else mode(v)
        out[name] = _mxu.measure(
            name, LAUNCHES, lambda d: mxu_parts(*d, v), lambda d: mxu_parts_plain(*d, v),
            lambda got, want, d: _mxu.compare(got, want, d[0], d[1], how), sets,
            None if v == "epionly" else (rays, rhs, v == "dotbf16"), B * NTILES,
            n_bytes(rays, rows, v), say)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mxu_parts: no CUDA device")
    print(_visit.card_line())
    measure(torch.device("cuda", 0))


if __name__ == "__main__":
    main()

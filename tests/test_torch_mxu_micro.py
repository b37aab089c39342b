"""The matrix-unit microbenchmarks' plain versions (surf_tpu_torch/micro/
mxu_tiles.py, mxu_parts.py, mxu_pltd.py) against the TPU scripts' own
kernels, run through ``pl.pallas_call`` in interpret mode, and against a
NumPy oracle of each script written here (float32, every op rounded on
its own, as the port's).

The scripts define their kernels inside ``main``, so no test can import
them: ``_load`` parses the script, executes its module constants, then
the ``def``s it names from ``main``'s body (the kernels and the script's
own ``make``), in one namespace whose ``pl.pallas_call`` adds
``interpret=True``; ``B`` and ``NTILES`` are set small there.  The
scripts stay as they are.  Data: the port's ``make_data`` cut to 2 blocks
and 3 or 4 tiles (the scripts' first blocks and tiles), its
``make_trips_data`` (C1, 4 tiles, trips 0, 1, 2, 4, 7) and its
``make_tmax_data``.

Gates.  Every plain output equals the NumPy oracle's bit for bit (t, k
and the dead blocks' checksum).  Against JAX: XLA's CPU dot sums the 8
products in its own order with FMAs (ROADMAP queue 3), so k must be
equal and t within JAX_T_REL of |t| (S_num / |num| + S_den / |den|) (S:
the sum of the products' magnitudes; ``_mxu.compare``), the min of den
within JAX_T_REL of the largest S_den; measured at most 1.35e-7 (C1,
on the trips data), 2.08e-7 (C2 ``dotonly`` and ``bigdot``; ``full``
8.5e-8, ``dotbf16`` 1.12e-7) and 8.9e-8 (C3), with no k differing.
``epionly`` has no dot; XLA may contract u = b1 + t c1 into an FMA, which
could flip a test at its bound: k must be equal on all pairs (it is) and
t equal where k agrees.  A jitted call is reused across data sets of one
shape (``make`` is cached), and the data is made once.
"""

import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from surf_tpu_torch.micro import _mxu, mxu_parts, mxu_pltd, mxu_tiles

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
CPU = torch.device("cpu")
F32 = np.float32
BLOCKS = 2
TILES = {8: 3, 16: 4}        # C1's small tile counts for its 8- and 16-tile cases
PARTS_TILES = 3
JAX_T_REL = 1e-6


def _load(script: str, names, **consts) -> dict:
    """The ``def``s ``names`` of ``script``'s ``main`` executed with its
    module constants (``consts`` over them) and jax, jnp, np, functools and
    a ``pl`` whose ``pallas_call`` runs in interpret mode."""
    tree = ast.parse((SCRIPTS / f"{script}.py").read_text())
    interp = types.SimpleNamespace(**vars(pl))
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = dict(jax=jax, jnp=jnp, np=np, functools=functools, pl=interp, pltpu=pltpu)
    top = [n for n in tree.body if isinstance(n, ast.Assign)]
    exec(compile(ast.Module(top, []), script, "exec"), ns)
    ns.update(consts)
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [n for n in main.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {d.name for d in defs} == set(names)
    exec(compile(ast.Module(defs, []), script, "exec"), ns)
    return ns


def _cached_make(ns: dict, name: str) -> dict:
    ns[name] = functools.lru_cache(maxsize=None)(ns[name])
    return ns


@pytest.fixture(scope="module")
def c1():
    return _cached_make(_load("tpu_mxu_pallas_micro", ("kernel", "make")), "make")


@pytest.fixture(scope="module")
def c2():
    return _cached_make(_load("tpu_mxu_pallas_micro2", ("epilogue", "kernel", "make"),
                              B=BLOCKS, NTILES=PARTS_TILES), "make")


@pytest.fixture(scope="module")
def c3():
    return _cached_make(_load("tpu_mxu_micro3", ("pltd_kernel", "make_pltd")), "make_pltd")


def _jnp(*xs):
    return [jnp.asarray(x.numpy()) for x in xs]


def _torch(outs):
    return [torch.from_numpy(np.array(x)) for x in outs]


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _c1_data(case, which):
    ntiles = mxu_tiles.CASES[case][0]
    if which == "trips":
        return mxu_tiles.make_trips_data(4, CPU)
    if which == "tmax":
        return mxu_tiles.make_tmax_data(case, CPU, BLOCKS, TILES[ntiles])
    return mxu_tiles.make_data(case, CPU, BLOCKS, TILES[ntiles])


@functools.lru_cache(maxsize=None)
def _c2_data(which):
    if which == "tmax":
        return mxu_parts.make_tmax_data(CPU, BLOCKS, PARTS_TILES)
    return mxu_parts.make_data(CPU, BLOCKS, PARTS_TILES)


@functools.lru_cache(maxsize=None)
def _c3_data(which):
    if which == "tmax":
        return mxu_pltd.make_tmax_data(CPU, BLOCKS, PARTS_TILES)
    return mxu_pltd.make_data(CPU, BLOCKS, PARTS_TILES)


# --------------------------------------------------------------------------
# The NumPy oracle: float32, every op rounded on its own
# --------------------------------------------------------------------------

def _bf16(x):
    """x rounded to bf16 (to nearest even), as float32."""
    u = x.astype(F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(F32)


def _dot(a, pan):
    """a [M, 8] x pan [8, N]: products and sums rounded to float32, k = 0..7."""
    s = a[:, 0, None] * pan[None, 0, :]
    for k in range(1, 8):
        s = s + a[:, k, None] * pan[None, k, :]
    return s


def _epilogue(out, tmax, bt, bk, kt):
    """The scripts' epilogue on out [M, 768] (the six blocks along axis 1)."""
    den, num, b1, c1, b2, c2 = (out[:, i * 128:(i + 1) * 128] for i in range(6))
    with np.errstate(divide="ignore", invalid="ignore"):
        t = num / den
        u = b1 + t * c1
        v = b2 + t * c2
        ok = ((np.abs(den) >= F32(1e-8)) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
              & (t >= F32(1e-8)) & (t < tmax))
    tc = np.where(ok, t, F32(np.inf))
    w = tc < bt
    return np.where(w, tc, bt), np.where(w, np.int32(kt), bk)


def _oracle(rays, rows, tmax, variant, trip=None):
    """One block: (bt, bk, chk) of the rows layout; variant full (the test;
    ``trip`` tiles where given), epionly, dotonly, dotbf16, bigdot."""
    bt = np.full((256, 128), np.inf, F32)
    bk = np.full((256, 128), -1, np.int32)
    dead = np.zeros((256, 640))
    nt = rows.shape[0]
    for kt in range(nt if trip is None else min(max(trip, 0), nt)):
        pan = rows[kt]
        if variant == "epionly":
            out = pan[np.arange(256) % 8]
        elif variant == "dotbf16":
            out = _dot(_bf16(rays), _bf16(pan))
        else:
            out = _dot(rays, pan)
        if variant in _mxu.DEAD:
            bt = np.where(np.isnan(out[:, :128]) | (out[:, :128] < bt), out[:, :128], bt)
            dead += out[:, 128:]
        else:
            bt, bk = _epilogue(out, tmax, bt, bk, kt)
    chk = dead.reshape(256, 5, 4, 32).sum((1, 3)).astype(F32)
    return bt, bk, chk


def _oracle_blocks(rays, rows, tmax, variant, trips=None):
    outs = [_oracle(rays[p], rows[p], tmax[p], variant, None if trips is None else trips[p])
            for p in range(rows.shape[0])]
    return [np.stack(x) for x in zip(*outs)]


def _bit_equal(port, oracle):
    for got, want in zip(port, oracle):
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# C1: tpu_mxu_pallas_micro.py
# --------------------------------------------------------------------------

C1_CASES = [(case, which) for case in range(4) for which in ("script", "trips", "tmax")]
C1_IDS = [f"{n}_{m}-{w}" for (c, w) in C1_CASES for n, m in [mxu_tiles.CASES[c]]]


@pytest.mark.parametrize("case,which", C1_CASES, ids=C1_IDS)
def test_c1_plain_matches_jax(c1, case, which):
    rays, rows, tmax, trips = _c1_data(case, which)
    dyn = mxu_tiles.CASES[case][1] == "dyn"
    f = c1["make"](rows.shape[0], rows.shape[1], dyn)
    got = _torch(f(*_jnp(trips, rays, rows, tmax)))
    want = mxu_tiles.mxu_tiles(rays, rows, tmax, trips, dyn)
    res = _mxu.compare(got, want, rays, rows, "epi")
    assert res["k_pairs"] == 0 and res["t_rel"] <= JAX_T_REL, res
    assert int((want[1] >= 0).sum()) > 0


@pytest.mark.parametrize("case,which", C1_CASES, ids=C1_IDS)
def test_c1_plain_matches_oracle(case, which):
    rays, rows, tmax, trips = _c1_data(case, which)
    dyn = mxu_tiles.CASES[case][1] == "dyn"
    port = mxu_tiles.mxu_tiles_plain(rays, rows, tmax, trips, dyn)
    _bit_equal(port, _oracle_blocks(rays.numpy(), rows.numpy(), tmax.numpy(), "full",
                                    trips.numpy() if dyn else None))


def test_c1_dyn_departs_from_static_on_trips_data():
    """Block p of the trips data runs trips[p] = 0, 1, 2, 4, 7 of 4 tiles:
    dyn equals static where trips >= 4 and departs below (nothing at all
    at 0 trips)."""
    data = mxu_tiles.make_trips_data(4, CPU)
    dyn = mxu_tiles.mxu_tiles_plain(*data, True)
    static = mxu_tiles.mxu_tiles_plain(*data, False)
    for p, trip in enumerate(data[3].tolist()):
        same = torch.equal(dyn[0][p], static[0][p]) and torch.equal(dyn[1][p], static[1][p])
        assert same == (trip >= 4), (p, trip)
    assert torch.isinf(dyn[0][0]).all() and (dyn[1][0] == -1).all()
    assert int(dyn[1][1].max()) == 0 and int(dyn[1][2].max()) == 1


# --------------------------------------------------------------------------
# C2: tpu_mxu_pallas_micro2.py
# --------------------------------------------------------------------------

C2_CASES = [(v, w) for v in mxu_parts.VARIANTS for w in ("script", "tmax")]


@pytest.mark.parametrize("variant,which", C2_CASES, ids=[f"{v}-{w}" for v, w in C2_CASES])
def test_c2_plain_matches_jax(c2, variant, which):
    rays, rows, tmax = _c2_data(which)
    trips = torch.full((BLOCKS,), PARTS_TILES, dtype=torch.int32)
    got = _torch(c2["make"](variant)(*_jnp(trips, rays, rows, tmax))) + [None]
    want = mxu_parts.mxu_parts(rays, rows, tmax, variant)
    if variant == "epionly":
        same = got[1] == want[1]
        assert bool(same.all())
        assert torch.equal(got[0][same], want[0][same])
        return
    res = _mxu.compare(got, want, rays, rows,
                       "epi" if variant == "full" else variant)
    assert res["k_pairs"] == 0 and res["t_rel"] <= JAX_T_REL, res


@pytest.mark.parametrize("variant,which", C2_CASES, ids=[f"{v}-{w}" for v, w in C2_CASES])
def test_c2_plain_matches_oracle(variant, which):
    rays, rows, tmax = _c2_data(which)
    port = mxu_parts.mxu_parts_plain(rays, rows, tmax, variant)
    assert (port[2] is None) == (variant not in _mxu.DEAD)
    _bit_equal(port, _oracle_blocks(rays.numpy(), rows.numpy(), tmax.numpy(), variant))


@pytest.mark.parametrize("which", ["script", "tmax"])
def test_c2_bigdot_equals_dotonly(which):
    """One dot over the tiles side by side is the tile loop's function:
    every output bit for bit."""
    data = _c2_data(which)
    big = mxu_parts.mxu_parts_plain(*data, "bigdot")
    only = mxu_parts.mxu_parts_plain(*data, "dotonly")
    assert all(torch.equal(x, y) for x, y in zip(big, only))
    assert (big[1] == -1).all()


# --------------------------------------------------------------------------
# C3: tpu_mxu_micro3.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["script", "tmax"])
def test_c3_plain_matches_jax(c3, which):
    rays_t, rows, tmax_t = _c3_data(which)
    trips = torch.full((BLOCKS,), PARTS_TILES, dtype=torch.int32)
    f = c3["make_pltd"](BLOCKS, PARTS_TILES)
    got = _torch(f(*_jnp(trips, rays_t, rows, tmax_t)))
    want = mxu_pltd.mxu_pltd(rays_t, rows, tmax_t)
    res = mxu_pltd.compare(got, want, rays_t, rows)
    assert res["k_pairs"] == 0 and res["t_rel"] <= JAX_T_REL, res
    assert int((want[1] >= 0).sum()) > 0


@pytest.mark.parametrize("which", ["script", "tmax"])
def test_c3_plain_matches_oracle(which):
    """The oracle in the script's own layout: out^T = panel^T x rays_t."""
    rays_t, rows, tmax_t = (x.numpy() for x in _c3_data(which))
    port = mxu_pltd.mxu_pltd_plain(*(torch.from_numpy(x) for x in (rays_t, rows, tmax_t)))
    for p in range(BLOCKS):
        bt = np.full((128, 256), np.inf, F32)
        bk = np.full((128, 256), -1, np.int32)
        for kt in range(PARTS_TILES):
            pan = rows[p, kt]
            out = pan[0][:, None] * rays_t[p, 0][None, :]
            for k in range(1, 8):
                out = out + pan[k][:, None] * rays_t[p, k][None, :]
            bt, bk = _epilogue(out.T, tmax_t[p].T, bt.T, bk.T, kt)
            bt, bk = bt.T, bk.T
        np.testing.assert_array_equal(port[0][p].numpy(), bt)
        np.testing.assert_array_equal(port[1][p].numpy(), bk)


# --------------------------------------------------------------------------
# The precision of the card's f32 dot
# --------------------------------------------------------------------------

def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero:
    ``cvt.rna.tf32.f32``), as float32."""
    u = x.astype(F32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(F32)


def _tf32_dot(a, pan, passes):
    """a [M, 8] x pan [8, N] as the tensor cores form it from TF32 operands:
    exact products summed (here in float64), rounded once to float32;
    ``passes`` 1 (hi x hi) or 3 (lo x hi + hi x lo + hi x hi)."""
    a_hi, p_hi = _tf32(a).astype(np.float64), _tf32(pan).astype(np.float64)
    out = a_hi @ p_hi
    if passes == 3:
        a_lo = _tf32(a - a_hi.astype(F32)).astype(np.float64)
        p_lo = _tf32(pan - p_hi.astype(F32)).astype(np.float64)
        out = out + a_lo @ p_hi + a_hi @ p_lo
    return out.astype(F32)


@pytest.mark.parametrize("passes", [1, 3])
def test_tf32_passes(passes):
    """Why the kernels' f32 dot is 3xTF32 (csrc/mxu_micro.cu): on C1's
    first 2 blocks and 4 tiles (65,536 pairs) one TF32 pass takes another
    best tile than the exactly rounded f32 dot on some pairs (measured: 5)
    and moves t by 4.3e-4 of its terms' scale (TF32's rounding; 34% of t
    where den cancels); a 3xTF32 split keeps every k, t within 1e-6 of that
    scale (measured 1.3e-7, the plain version's own rounding; 1.6e-4 of
    t)."""
    rays, rows, tmax, _ = mxu_tiles.make_data(0, CPU, BLOCKS, 4)
    r, pn, tm = rays.numpy(), rows.numpy(), tmax.numpy()
    outs = []
    for p in range(BLOCKS):
        bt = np.full((256, 128), np.inf, F32)
        bk = np.full((256, 128), -1, np.int32)
        for kt in range(4):
            bt, bk = _epilogue(_tf32_dot(r[p], pn[p, kt], passes), tm[p], bt, bk, kt)
        outs.append((bt, bk))
    got = [torch.from_numpy(np.stack(x)) for x in zip(*outs)]
    res = _mxu.compare(got, mxu_tiles.mxu_tiles_plain(rays, rows, tmax, None, False), rays,
                       rows, "epi")
    if passes == 1:
        assert res["k_pairs"] > 0 and res["t_rel"] > 1e-4, res
    else:
        assert res["k_pairs"] == 0 and res["t_rel"] <= JAX_T_REL, res


# --------------------------------------------------------------------------
# Generators and checks
# --------------------------------------------------------------------------

def test_generators_reproduce_the_scripts_draws():
    """C1's second case (after the first case's arrays), C2's arrays and
    C3's ``pltd`` arrays (after the xlaA / xlaB draws) equal the scripts'
    draws from ``default_rng(0)``, made here as the scripts make them."""
    rng = np.random.default_rng(0)
    rng.normal(size=(512, 256, 8))                          # C1 case 0 (:122-123)
    rng.normal(size=(512, 8, 8, 768))
    rays = rng.normal(size=(512, 256, 8)).astype(F32)       # C1 case 1
    rows0 = rng.normal(size=(1, 8, 8, 768)).astype(F32)
    got = mxu_tiles.make_data(1, CPU, 1)
    assert np.array_equal(got[0].numpy(), rays[:1]) and np.array_equal(got[1].numpy(), rows0)
    assert got[3].tolist() == [8]
    rng = np.random.default_rng(0)                          # C2 (:126-127)
    rays = rng.normal(size=(64, 256, 8)).astype(F32)
    rows0 = rng.normal(size=(1, 16, 8, 768)).astype(F32)
    got = mxu_parts.make_data(CPU, 1)
    assert np.array_equal(got[0].numpy(), rays[:1]) and np.array_equal(got[1].numpy(), rows0)
    rng = np.random.default_rng(0)                          # C3 (:143-144, :151-152)
    for b, r in ((256, 256), (32, 2048)):
        rng.normal(size=(b, r, 8))
        rng.normal(size=(b, 8, 16 * 768))
    rays_t = rng.normal(size=(256, 8, 256)).astype(F32)
    rows0 = rng.normal(size=(1, 16, 8, 768)).astype(F32)
    got = mxu_pltd.make_data(CPU, 1)
    assert np.array_equal(got[0].numpy(), rays_t[:1]) and np.array_equal(got[1].numpy(), rows0)
    assert (got[2] == 1e30).all()


def test_tmax_data_decides_some_tests():
    """On the tmax data some pairs' best hit lies behind tmax: fewer hits
    than with tmax 1e30, and every t below tmax."""
    data = mxu_tiles.make_data(0, CPU, BLOCKS, 3)
    near = mxu_tiles.make_tmax_data(0, CPU, BLOCKS, 3)
    far_hits = int((mxu_tiles.mxu_tiles_plain(*data, False)[1] >= 0).sum())
    t, k = mxu_tiles.mxu_tiles_plain(*near, False)
    assert torch.isfinite(near[2]).all()
    assert 0 < int((k >= 0).sum()) < far_hits
    assert bool((t[k >= 0] < near[2][k >= 0]).all())


def test_wrappers_reject_bad_inputs():
    rays, rows, tmax, trips = mxu_tiles.make_data(0, CPU, 1, 2)
    with pytest.raises(ValueError):
        mxu_tiles.mxu_tiles(rays[:, :128], rows, tmax, trips, False)
    with pytest.raises(ValueError):
        mxu_tiles.mxu_tiles(rays, rows, tmax, trips.long(), True)
    with pytest.raises(ValueError):
        mxu_parts.mxu_parts(rays, rows, tmax, "nodot")
    with pytest.raises(ValueError):
        mxu_parts.mxu_parts(rays.double(), rows, tmax, "full")
    with pytest.raises(ValueError):
        mxu_pltd.mxu_pltd(rays, rows, tmax)
    with pytest.raises(ValueError):
        mxu_parts.mxu_parts(rays, rows[:, :, :, :640].contiguous(), tmax, "full")

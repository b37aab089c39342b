"""The visit-shape microbenchmarks' plain versions (surf_tpu_torch/micro/
visit_parts.py, cond_visit.py, visit_bodies.py) against the TPU scripts'
own kernels, run through ``pl.pallas_call`` in interpret mode on the
port's ``make_data`` arrays, and against a NumPy oracle of each script
written here (float32, every op rounded on its own, as the port's):

- ``scripts/tpu_visit_micro.py``'s ``make(variant)`` with the loaded
  module's ITERS = 64, all six variants, on the script's data and on
  ``make_vote_data``'s, where ``full``'s vote moves the cursor;
- ``scripts/tpu_cond_micro.py``'s ``make(variant)`` with ITERS = 64 on
  both data sets;
- ``scripts/tpu_body_micro.py``'s ``outer(body, None)`` with ITERS = 16
  and 32 (``wide_x``'s and ``smem_stack``'s acc overflows later) on both
  data sets.  ``bin_sroll`` rolls by a static negative shift, which
  ``pltpu.roll`` refuses: it runs with the loaded module's ``pltpu``
  replaced by a namespace whose ``roll(x, s, axis)`` is ``pltpu.roll(x,
  s % x.shape[axis], axis)`` (the same roll), every other name kept.

Gates.  Every output of the plain version equals the NumPy oracle's bit
for bit, the outputs the scripts lack too (the end cursor and the count
of visits whose vote was set).  Against JAX: XLA's CPU backend contracts
the chain's r + f * x into an FMA (ROADMAP queue 3), so for
``visit_parts`` and ``bin_sroll`` JAX's o equals the oracle with that
FMA (``fused``) bit for bit, on both data sets, and the port's o lies
within rtol 1e-6 of JAX's on the script's data (measured at most 2.3e-7
at 64 visits; the vote data's signed rows cancel, so no relative gate
holds there).  XLA contracts ``mt8``'s products and sums too, in an
order not emulated here: ``cond_visit`` within rtol 1e-5 (measured 5.6e-7
at 64 visits on the script's data).  ``wide_x``, ``wide_bc`` and
``smem_stack`` have no multiply feeding an add: their o equals JAX's
bit for bit.
"""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from surf_tpu_torch.micro import _visit, cond_visit, visit_bodies, visit_parts

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
CPU = torch.device("cpu")
F32 = np.float32
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)
PARTS_ITERS = 64
COND_ITERS = 64
BODY_ITERS = (16, 32)


def _load(name, iters):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.ITERS = iters
    return mod


def _with_modular_roll(mod):
    """``mod`` with its ``pltpu`` a namespace whose roll takes its shift
    modulo the axis length, every other name as it was."""
    mod.pltpu = types.SimpleNamespace(**vars(pltpu))
    mod.pltpu.roll = lambda x, shift, axis: pltpu.roll(x, shift % x.shape[axis], axis)
    return mod


@pytest.fixture(scope="module")
def parts_micro():
    return _load("tpu_visit_micro", PARTS_ITERS)


@pytest.fixture(scope="module")
def cond_micro():
    return _load("tpu_cond_micro", COND_ITERS)


@pytest.fixture(scope="module", params=BODY_ITERS)
def body_micro(request):
    return _with_modular_roll(_load("tpu_body_micro", request.param))


def _interpret(kernel, table, x, scratch=()):
    """The kernel through pl.pallas_call in interpret mode, table and x
    (8, 128) in VMEM: o as a flat numpy array."""
    f = pl.pallas_call(kernel, in_specs=[VMEM, VMEM], out_specs=VMEM,
                       out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                       scratch_shapes=list(scratch), interpret=True)
    return np.asarray(f(jnp.asarray(table.numpy()), jnp.asarray(x.numpy().reshape(8, 128))))\
        .reshape(-1)


# --------------------------------------------------------------------------
# NumPy oracles: float32, every op rounded on its own
# --------------------------------------------------------------------------

def _fma(a, b, c):
    """a * b + c rounded once to float32, as XLA's contracted FMA: the
    float64 product is exact, the float64 sum rounds once more."""
    return (np.float64(a) * b.astype(np.float64) + c.astype(np.float64)).astype(F32)


def _chain(row, lanes, x, acc, fused=False):
    """visit_math (tpu_visit_micro.py:29): (r, the last link's x); with
    ``fused`` each r + f * x as one FMA."""
    r = acc
    for lane in lanes:
        f = row[lane]
        r = _fma(f, x, r) if fused else r + f * x
        x = np.where(r > f, x, r)
    return r, x


def _oracle_parts(table, x, variant, iters, fused=False):
    tab, x = table.numpy(), x.numpy()
    acc = x * F32(0)
    i = votes = 0
    while i < iters:
        off = 16 * (i & 7) if variant in ("roll", "full") else 0
        r, _ = _chain(tab[i % 512], [(off + j) % 128 for j in range(9)], x, acc, fused)
        nxt = i + 1
        if variant in ("any", "full"):
            vote = bool((r > x).any())
            votes += vote
            nxt = i + 1 if vote else i + 2
        acc = r  # fori0's inner loop: min(0, nxt) = 0 trips
        i = max(nxt, i + 1) if variant in ("while", "full") else i + 1
    return acc, np.array([i, votes], np.int32)


def _cross(box, x):
    """[R, n]: the toy slab test of each value x against each box (box
    [n, 6]: lo, hi), planes lo0 - x, lo1 * x, lo2 - x in the scripts'
    order."""
    xc = x[:, None]
    lo, hi = box[:, 0:3], box[:, 3:6]
    tmin = np.minimum(lo[:, 0] - xc, hi[:, 0] - xc)
    tmax = np.maximum(lo[:, 0] - xc, hi[:, 0] - xc)
    tmin = np.maximum(tmin, np.minimum(lo[:, 1] * xc, hi[:, 1] * xc))
    tmax = np.minimum(tmax, np.maximum(lo[:, 1] * xc, hi[:, 1] * xc))
    tmin = np.maximum(tmin, np.minimum(lo[:, 2] - xc, hi[:, 2] - xc))
    tmax = np.minimum(tmax, np.maximum(lo[:, 2] - xc, hi[:, 2] - xc))
    return tmax >= tmin


def _slab8(row, x, acc):
    cross = _cross(row.reshape(8, 16)[:, :6], x)
    r = acc
    for k in range(8):
        r = np.where(cross[:, k], r + x, r)
    return r


def _mt8(row, x, acc):
    r = acc
    for k in range(8):
        f = row[16 * k:16 * k + 9]
        with np.errstate(all="ignore"):  # 1 / 0 on the vote data's missing records
            hx = x * f[7] - x * f[8]
            hy = x * f[6] - x * f[5]
            hz = x * f[3] - x * f[4]
            a = f[0] * hx + f[1] * hy + f[2] * hz
            det = F32(1) / a
            u = det * (hx + hy - hz)
            v = det * (hx * f[6] + hy * f[7] + hz * f[8])
            t = det * (u + v)
        ok = (np.abs(a) > F32(1e-5)) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > F32(1e-5))
        r = np.where(ok, r + t, r)
    return r


def _oracle_cond(table, x, variant, iters):
    tab, x = table.numpy(), x.numpy()
    acc = x * F32(0)
    cur, votes = 3, 0
    for _ in range(_visit.block_visits(iters)):
        row = tab[cur % 512]
        is_leaf = row.view(np.int32)[9] & 1 == 1
        if variant == "both":
            acc = np.where(is_leaf, _mt8(row, x, acc), _slab8(row, x, acc))
        else:
            acc = _mt8(row, x, acc) if is_leaf else _slab8(row, x, acc)
        vote = bool((acc > x).any())
        votes += vote
        cur = cur + 1 if vote else cur + 2
    return acc, np.array([cur, votes], np.int32)


def _oracle_body(table, x, variant, iters, fused=False):
    tab, x = table.numpy(), x.numpy()
    acc = x * F32(0)
    stack = [-2**31] * 256
    cur, votes = 3, 0
    for _ in range(_visit.block_visits(iters)):
        if variant == "bin_sroll":
            g = cur & 7
            r, xl = _chain(tab[(cur >> 3) % 512], [(16 * g + j) % 128 for j in range(9)], x, acc,
                           fused)
            vote = bool((r > xl).any())
            nxt = cur + 1 if vote else cur + 2
        elif variant == "wide_bc":
            tile = tab[8 * (cur % 64):8 * (cur % 64) + 8]
            cross = _cross(tile[:, :6], x[:128]).T.reshape(-1)   # value s * 128 + l
            r = acc + np.where(cross, x, acc)
            vote = int(cross.sum()) > 4
            nxt = cur + 1 if vote else cur + 2
        else:
            cross = _cross(tab[cur % 512].reshape(8, 16)[:, :6], x)
            r = acc
            for k in range(8):
                r = r + np.where(cross[:, k], x, acc)
            vote = bool((r > x).any())
            nxt = cur + 1 if vote else cur + 2
            if variant == "smem_stack":
                sp = max(cur % 64, 1)
                stack[sp] = cur * 2
                nxt = stack[sp - 1] % 512 + 1 if vote else cur + 2
        acc = r
        votes += vote
        cur = nxt
    return acc, np.array([cur, votes], np.int32)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# --------------------------------------------------------------------------
# The tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("data_kind", ["script", "vote"])
@pytest.mark.parametrize("variant", visit_parts.VARIANTS)
def test_visit_parts_matches_tpu_kernel(parts_micro, variant, data_kind):
    make = visit_parts.make_data if data_kind == "script" else visit_parts.make_vote_data
    table, x = make(CPU)
    want = _interpret(parts_micro.make(variant), table, x)
    got = [v.numpy() for v in visit_parts.visit_parts(table, x, variant, PARTS_ITERS)]
    _same(got, _oracle_parts(table, x, variant, PARTS_ITERS))
    assert np.isfinite(got[0]).all()
    assert np.array_equal(want, _oracle_parts(table, x, variant, PARTS_ITERS, fused=True)[0])
    if data_kind == "script":
        assert np.allclose(got[0], want, rtol=1e-6, atol=0)
    end, votes = got[1]
    assert (votes > 0) == visit_parts.votes(variant)
    if variant == "full" and data_kind == "vote":  # the vote moves the cursor
        assert votes < visit_parts.visits(variant, got[1]) < PARTS_ITERS
    else:
        assert end == PARTS_ITERS


def test_visit_parts_variants_that_compute_one_o():
    """base, any, fori0 and while compute one o on the script's data, and
    roll and full another (the vote never fails there: r only grows)."""
    table, x = visit_parts.make_data(CPU)
    o = {v: visit_parts.visit_parts(table, x, v, PARTS_ITERS)[0] for v in visit_parts.VARIANTS}
    assert all(torch.equal(o["base"], o[v]) for v in ("any", "fori0", "while"))
    assert torch.equal(o["roll"], o["full"]) and not torch.equal(o["base"], o["roll"])


@pytest.mark.parametrize("data_kind", ["script", "vote"])
@pytest.mark.parametrize("variant", cond_visit.VARIANTS)
def test_cond_visit_matches_tpu_kernel(cond_micro, variant, data_kind):
    make = cond_visit.make_data if data_kind == "script" else cond_visit.make_vote_data
    table, x = make(CPU)
    want = _interpret(cond_micro.make(variant), table, x)
    got = [v.numpy() for v in cond_visit.cond_visit(table, x, variant, COND_ITERS)]
    _same(got, _oracle_cond(table, x, variant, COND_ITERS))
    assert np.isfinite(got[0]).all()
    assert np.allclose(got[0], want, rtol=1e-5, atol=0)
    end, votes = got[1]
    # each visit moves the cursor by 1 (vote set) or 2
    assert end == 3 + votes + 2 * (COND_ITERS - votes)
    assert COND_ITERS - votes == (2 if data_kind == "script" else 34)


def test_cond_variants_agree():
    """both and cond compute one function: every output equal."""
    for make in (cond_visit.make_data, cond_visit.make_vote_data):
        table, x = make(CPU)
        both, cond = (cond_visit.cond_visit(table, x, v, COND_ITERS) for v in cond_visit.VARIANTS)
        assert all(torch.equal(a, b) for a, b in zip(both, cond))


@pytest.mark.parametrize("data_kind", ["script", "vote"])
@pytest.mark.parametrize("variant", visit_bodies.VARIANTS)
def test_visit_body_matches_tpu_kernel(body_micro, variant, data_kind):
    make = visit_bodies.make_data if data_kind == "script" else visit_bodies.make_vote_data
    table, x = make(CPU)
    iters = body_micro.ITERS
    visit, scratch = {name: (fn, s) for name, fn, s in body_micro.CASES}[variant]
    want = _interpret(body_micro.outer(visit, None), table, x, scratch or ())
    got = [v.numpy() for v in visit_bodies.visit_body(table, x, variant, iters)]
    _same(got, _oracle_body(table, x, variant, iters))
    assert np.isfinite(got[0]).all()
    if variant == "bin_sroll":
        assert np.array_equal(want, _oracle_body(table, x, variant, iters, fused=True)[0])
        if data_kind == "script":
            assert np.allclose(got[0], want, rtol=1e-6, atol=0)
    else:
        assert np.array_equal(got[0], want)
    end, votes = got[1]
    if variant == "smem_stack" and votes:  # a pop reads an entry never stored
        assert end == 1
    if data_kind == "vote" and iters == 32:
        assert votes == iters - {"bin_sroll": 2, "wide_x": 16, "wide_bc": 4,
                                 "smem_stack": 16}[variant]


def test_shape_micro_rejects_bad_inputs():
    table, x = visit_parts.make_data(CPU)
    with pytest.raises(ValueError):
        visit_parts.visit_parts(table, x, "unrolled", 64)
    with pytest.raises(ValueError):
        visit_parts.visit_parts(table, x, "base", 0)
    with pytest.raises(ValueError):
        cond_visit.cond_visit(table[:, :64].contiguous(), x, "both", 64)
    with pytest.raises(ValueError):
        cond_visit.cond_visit(table, x[:512].contiguous(), "cond", 64)
    with pytest.raises(ValueError):
        visit_bodies.visit_body(table[:4].contiguous(), x, "wide_bc", 32)
    with pytest.raises(ValueError):
        visit_bodies.visit_body(table, x.double(), "wide_x", 32)

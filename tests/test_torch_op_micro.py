"""The op-cost microbenchmarks' plain versions (surf_tpu_torch/micro/
lane_splat.py, lane_extract.py, walk_interleave.py, spec_visit.py) against
the TPU scripts' own kernels, run through ``pl.pallas_call`` in interpret
mode on the port's ``make_data`` arrays (the scripts loaded with importlib,
their ITERS or ROWS_TOTAL set on the loaded module), and against a NumPy
oracle of each script written here (float32, every op rounded on its own,
as the port's):

- ``scripts/tpu_splat_micro.py``: all six splats at ITERS 64.
  ``roll_lane0`` rolls by a static negative shift, which ``pltpu.roll``
  refuses: it runs with the loaded module's ``pltpu`` replaced by a
  namespace whose roll takes its shift modulo the axis length (the same
  roll), every other name kept;
- ``scripts/tpu_extract_micro.py``: all seven cases at ITERS 32, on the
  script's data (where the vote flips during the run at n_e 64 and 128)
  and on ``make_vote_data``'s;
- ``scripts/tpu_interleave_micro.py``: ``serial_any``, ``inter2``,
  ``inter4`` and ``roll_tput`` at ITERS 32, ``inter8`` and ``inter16`` at
  ITERS 8, on the script's data and on the vote data;
- ``scripts/tpu_spec_micro.py``: all six variants at ROWS_TOTAL 64 on the
  script's data (where W3 and W6 read past the end and find 831 hits of
  1024 rays, the others 787), ``cur`` and ``w2`` on ``make_jump_data``
  at ROWS_TOTAL 32.

Gates.  Every output of the plain version equals the NumPy oracle's bit
for bit, the outputs the scripts lack too (the end cursor, the votes set,
the visits).  Against JAX: XLA's CPU backend contracts r + f * x and
r * 0.9999 + x into FMAs (ROADMAP queue 3), so for the splats, the
extracts and the interleaved walks JAX's o equals the oracle with those
FMAs (``fused``) bit for bit, the oracle takes one cursor path with
and without them, and the port's o lies within rtol 1e-6 of JAX's on the
script's data (measured at most 3.5e-7), plus 2e-8 a link r * 0.9999 + x
made (measured 1.47e-8 at 7,936 links: 1.16e-4), 5e-6 plus the same on
the extracts' vote data (measured 2.0e-6); the walks' vote data sums
signed rows that cancel, so no relative gate holds there.  The splats'
JAX o also equals ``tpu_visit_micro.py``'s ``base`` bit for bit.
For the W-row visits XLA contracts the record test's sums in an order not
emulated here: r (best record + visits) equals JAX's, and t lies within
5e-6 of the magnitude of the terms that sum to it, as
``tests/test_torch_dep_micro.py`` holds it.
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

from surf_tpu_torch.micro import (_visit, lane_extract, lane_splat, spec_visit, visit_parts,
                                  walk_interleave)

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
CPU = torch.device("cpu")
F32 = np.float32
FAR = F32(1e30)
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)
SPLAT_ITERS = 64
EXTRACT_ITERS = 32
SPEC_ROWS = 64
JUMP_ROWS = 32


def _load(name, **consts):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in consts.items():
        setattr(mod, k, v)
    return mod


def _with_modular_roll(mod):
    """``mod`` with its ``pltpu`` a namespace whose roll takes its shift
    modulo the axis length, every other name as it was."""
    mod.pltpu = types.SimpleNamespace(**vars(pltpu))
    mod.pltpu.roll = lambda x, shift, axis: pltpu.roll(x, shift % x.shape[axis], axis)
    return mod


@pytest.fixture(scope="module")
def splat_micro():
    return _with_modular_roll(_load("tpu_splat_micro", ITERS=SPLAT_ITERS))


@pytest.fixture(scope="module")
def extract_micro():
    return _load("tpu_extract_micro", ITERS=EXTRACT_ITERS)


@pytest.fixture(scope="module")
def interleave_micro():
    return _load("tpu_interleave_micro")


@pytest.fixture(scope="module")
def spec_micro():
    return _load("tpu_spec_micro")


def _interpret(kernel, table, x):
    """The kernel through pl.pallas_call in interpret mode, table and x
    (8, 128) in VMEM: o as a flat numpy array."""
    f = pl.pallas_call(kernel, in_specs=[VMEM, VMEM], out_specs=VMEM,
                       out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32), interpret=True)
    return np.asarray(f(jnp.asarray(table.numpy()), jnp.asarray(x.numpy().reshape(8, 128))))\
        .reshape(-1)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# --------------------------------------------------------------------------
# NumPy oracles: float32, every op rounded on its own
# --------------------------------------------------------------------------

def _fma(a, b, c):
    """a * b + c rounded once to float32, as XLA's contracted FMA: the
    float64 product is exact, the float64 sum rounds once more."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(F32)


def _chain(row, x, acc, fused=False):
    """visit_math over lanes 0-8 (tpu_splat_micro.py:27-36,
    tpu_interleave_micro.py:30): r, with each r + f * x as one FMA where
    ``fused``."""
    r = acc
    for f in row[:9]:
        r = _fma(f, x, r) if fused else r + f * x
        x = np.where(r > f, x, r)
    return r


def _oracle_splat(table, x, iters, fused=False):
    tab, x = table.numpy(), x.numpy()
    acc = x * F32(0)
    for i in range(iters):
        acc = _chain(tab[i % 512], x, acc, fused)
    return acc, np.array([iters, 0], np.int32)


def _oracle_extract(table, x, variant, iters, fused=False):
    tab, x = table.numpy(), x.numpy()
    n_e, n_v = lane_extract.case(variant)
    acc = x * F32(0)
    cur, votes = 3, 0
    for _ in range(_visit.block_visits(iters)):
        row = tab[cur % 512]
        for f in row[:n_e]:
            acc = _fma(f, x, acc) if fused else acc + f * x
        for _ in range(n_v):
            acc = _fma(acc, F32(0.9999), x) if fused else acc * F32(0.9999) + x
        vote = bool((acc > x).any())
        votes += vote
        cur = cur + 1 if vote else cur + 2
    return acc, np.array([cur, votes], np.int32)


def _oracle_interleave(table, x, variant, iters, fused=False):
    tab, x = table.numpy(), x.numpy()
    if variant == "roll_tput":
        x0 = x[:128]
        acc = x0 * F32(0)
        for i in range(iters):
            row = np.roll(tab[i % 512], -16 * (i & 7))
            acc = _fma(row, x0, acc) if fused else acc + row * x0
        return np.tile(acc, 8), np.array([[iters, 0]], np.int32)
    n = walk_interleave.walks(variant)
    cur = [7 * b for b in range(n)]
    votes = [0] * n
    accs = [x * F32(b + 1) for b in range(n)]
    for _ in range(iters):
        for b in range(n):
            accs[b] = _chain(tab[cur[b] % 512], x, accs[b], fused)
            vote = bool((accs[b] > x).any())
            votes[b] += vote
            cur[b] += 1 if vote else 2
    o = accs[0]
    for a in accs[1:]:
        o = o + a
    return o, np.array(list(zip(cur, votes)), np.int32)


def _mt(row, j, rays):
    """(t, ok) of record j of the row against the rays (eval_row :66-93
    but its t bounds)."""
    ox, oy, oz, dx, dy, dz = rays
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row[16 * j:16 * j + 9]
    with np.errstate(all="ignore"):
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        f = F32(1) / a
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        u = f * (sx * hx + sy * hy + sz * hz)
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = f * (dx * qx + dy * qy + dz * qz)
        t = f * (e2x * qx + e2y * qy + e2z * qz)
        ok = ((np.abs(a) >= F32(1e-5)) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
              & (t >= F32(1e-5)))
    return t, ok


def _descend(row, rays, best_t):
    """Some ray hits some box of the row before best_t (eval_row :44-65)."""
    ox, oy, oz, dx, dy, dz = rays
    inv = [F32(1) / d for d in (dx, dy, dz)]
    hit = False
    for k in range(8):
        b = row[16 * k:16 * k + 6]
        tmin = tmax = None
        for c, o in enumerate((ox, oy, oz)):
            tn = (b[c] - o) * inv[c]
            tf = (b[3 + c] - o) * inv[c]
            lo, hi = np.minimum(tn, tf), np.maximum(tn, tf)
            tmin = lo if tmin is None else np.maximum(tmin, lo)
            tmax = hi if tmax is None else np.minimum(tmax, hi)
        hit |= bool(((tmax >= tmin) & (tmin < best_t) & (tmax > 0)).any())
    return hit


def _oracle_spec(table, rays, variant, rows_total):
    tab, rays = table.numpy(), list(rays.numpy())
    meta = tab.view(np.int32)
    best_t = np.full(1024, FAR, F32)
    best_r = np.full(1024, -1, np.int32)
    w_rows = spec_visit.window(variant)
    p = it = 0
    while p < rows_total:
        for _ in range(32):
            if variant == "cur":
                valid = p < rows_total
                pc = (p if valid else 0) % 512
                row = tab[pc]
                leaf, skip = meta[pc, 9] == 1, int(meta[pc, 10])
                desc = _descend(row, rays, best_t)
                if leaf and valid:
                    for j in range(8):
                        t, ok = _mt(row, j, rays)
                        hit = ok & (t < best_t)
                        best_t = np.where(hit, t, best_t)
                        best_r = np.where(hit, pc * 8 + j, best_r).astype(np.int32)
                nxt = p + 1 if leaf or desc else max(skip, p + 1)
                p = nxt if valid else p
            else:
                base = p if p < rows_total else 0
                evals = []
                for w in range(w_rows):
                    pc = (base + w) % 512
                    row = tab[pc]
                    t_w = np.full(1024, FAR, F32)
                    r_w = np.full(1024, -1, np.int32)
                    for j in range(8):
                        t, ok = _mt(row, j, rays)
                        hit = ok & (t < best_t) & (t < t_w)
                        t_w = np.where(hit, t, t_w)
                        r_w = np.where(hit, pc * 8 + j, r_w).astype(np.int32)
                    evals.append((t_w, r_w, _descend(row, rays, best_t), meta[pc, 9] == 1,
                                  int(meta[pc, 10])))
                nxt = base
                for w, (t_w, r_w, desc, leaf, skip) in enumerate(evals):
                    on = nxt == base + w
                    if on:
                        nxt = base + w + 1 if leaf or desc else max(skip, base + w + 1)
                    t_eff = t_w + (F32(0) if on else FAR)
                    better = t_eff < best_t
                    best_t = np.where(better, t_eff, best_t)
                    best_r = np.where(better, r_w, best_r)
                p = max(nxt, p + 1)
            it += 1
    return best_t, best_r + np.int32(it), np.array([p, it], np.int32)


def _record_t(table, rays, rec):
    """Per ray, the t of its record ``rec`` (row * 8 + j) in float32 with
    every op rounded (the port's arithmetic), and the magnitude of the
    terms that sum to it in float64, |f| (|e2x qx| + |e2y qy| + |e2z qz|)."""
    c = table.reshape(-1, 8, 16)[rec.clip(0) // 8, rec.clip(0) % 8]
    out = []
    with np.errstate(all="ignore"):
        for dt in (np.float32, np.float64):
            x = c.astype(dt)
            ox, oy, oz, dx, dy, dz = rays.astype(dt)
            v0, e1, e2 = x[:, 0:3].T, x[:, 3:6].T, x[:, 6:9].T
            hx = dy * e2[2] - dz * e2[1]
            hy = dz * e2[0] - dx * e2[2]
            hz = dx * e2[1] - dy * e2[0]
            f = dt(1) / (e1[0] * hx + e1[1] * hy + e1[2] * hz)
            sx, sy, sz = ox - v0[0], oy - v0[1], oz - v0[2]
            qx = sy * e1[2] - sz * e1[1]
            qy = sz * e1[0] - sx * e1[2]
            qz = sx * e1[1] - sy * e1[0]
            terms = (e2[0] * qx, e2[1] * qy, e2[2] * qz)
            out.append((f * (terms[0] + terms[1] + terms[2]),
                        np.abs(f) * sum(np.abs(z) for z in terms)))
    return out[0][0], out[1][1]


# --------------------------------------------------------------------------
# The tests
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def visit_base():
    """tpu_visit_micro.py's ``base`` at SPLAT_ITERS on the script's data,
    in interpret mode: the function every splat computes."""
    table, x = lane_splat.make_data(CPU)
    return _interpret(_load("tpu_visit_micro", ITERS=SPLAT_ITERS).make("base"), table, x)


@pytest.mark.parametrize("variant", lane_splat.VARIANTS)
def test_lane_splat_matches_tpu_kernel(splat_micro, visit_base, variant):
    assert [name for name, _ in splat_micro.VARIANTS] == list(lane_splat.VARIANTS)
    table, x = lane_splat.make_data(CPU)
    want = _interpret(splat_micro.make_kernel(dict(splat_micro.VARIANTS)[variant]), table, x)
    got = [v.numpy() for v in lane_splat.lane_splat(table, x, variant, SPLAT_ITERS)]
    _same(got, _oracle_splat(table, x, SPLAT_ITERS))
    _same(got, [v.numpy() for v in visit_parts.visit_parts_plain(table, x, "base", SPLAT_ITERS)])
    assert np.array_equal(want, visit_base)
    assert np.array_equal(want, _oracle_splat(table, x, SPLAT_ITERS, fused=True)[0])
    assert np.isfinite(got[0]).all()
    assert np.allclose(got[0], want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("data_kind", ["script", "vote"])
@pytest.mark.parametrize("variant", lane_extract.VARIANTS)
def test_lane_extract_matches_tpu_kernel(extract_micro, variant, data_kind):
    make = lane_extract.make_data if data_kind == "script" else lane_extract.make_vote_data
    table, x = make(CPU)
    want = _interpret(extract_micro.make(*lane_extract.case(variant)), table, x)
    got = [v.numpy() for v in lane_extract.lane_extract(table, x, variant, EXTRACT_ITERS)]
    _same(got, _oracle_extract(table, x, variant, EXTRACT_ITERS))
    fused = _oracle_extract(table, x, variant, EXTRACT_ITERS, fused=True)
    assert np.array_equal(want, fused[0])
    assert np.array_equal(fused[1], got[1])  # one cursor path with and without FMAs
    assert np.isfinite(got[0]).all()
    end, votes = got[1]
    assert end == 3 + 2 * EXTRACT_ITERS - votes
    # each link rounds once more than its FMA: 2e-8 of o a link made
    links = lane_extract.case(variant)[1] * EXTRACT_ITERS
    rtol = (1e-6 if data_kind == "script" else 5e-6) + 2e-8 * links
    assert np.allclose(got[0], want, rtol=rtol, atol=0)
    if data_kind == "script":
        # the vote is false until the lanes' sums pass 1, then set
        assert votes == {"e64_v0": 1, "e128_v0": 17}.get(
            variant, 0 if variant.endswith("_v0") else EXTRACT_ITERS)


@pytest.mark.parametrize("variant,first", [("e64_v0", 32), ("e128_v0", 16)])
def test_lane_extract_vote_flips_mid_run(variant, first):
    """On the script's data the vote of n_e 64 (128) is false up to the
    31st (15th) visit and set from the 32nd (16th) on: after k visits,
    max(0, k - first + 1) votes."""
    table, x = lane_extract.make_data(CPU)
    for k in (16, 32, 48, 64):
        votes = max(0, k - first + 1)
        assert lane_extract.lane_extract(table, x, variant, k)[1].tolist() == [
            3 + 2 * (k - votes) + votes, votes]


INTERLEAVE_CASES = [("serial_any", 32), ("inter2", 32), ("inter4", 32), ("roll_tput", 32),
                    ("inter8", 8), ("inter16", 8)]


@pytest.mark.parametrize("data_kind", ["script", "vote"])
@pytest.mark.parametrize("variant,iters", INTERLEAVE_CASES)
def test_walk_interleave_matches_tpu_kernel(interleave_micro, variant, iters, data_kind):
    make = walk_interleave.make_data if data_kind == "script" else walk_interleave.make_vote_data
    table, x = make(CPU)
    interleave_micro.ITERS = iters
    kernel = (interleave_micro.make_roll_tput() if variant == "roll_tput" else
              interleave_micro.make_interleaved(walk_interleave.walks(variant)))[0]
    want = _interpret(kernel, table, x)
    got = [v.numpy() for v in walk_interleave.walk_interleave(table, x, variant, iters)]
    _same(got, _oracle_interleave(table, x, variant, iters))
    fused = _oracle_interleave(table, x, variant, iters, fused=True)
    assert np.array_equal(want, fused[0])
    assert np.array_equal(fused[1], got[1])  # one cursor path with and without FMAs
    assert np.isfinite(got[0]).all()
    if data_kind == "script":  # the vote data's signed rows cancel: no relative gate there
        assert np.allclose(got[0], want, rtol=1e-6, atol=0)
        if variant != "roll_tput":  # r only grows: every vote is set
            assert (got[1][:, 1] == iters).all()


@pytest.mark.parametrize("variant", spec_visit.VARIANTS)
def test_spec_visit_matches_tpu_kernel(spec_micro, variant):
    _spec_case(spec_micro, variant, spec_visit.make_data, SPEC_ROWS)


@pytest.mark.parametrize("variant", ["cur", "w2"])
def test_spec_visit_jump_data_matches_tpu_kernel(spec_micro, variant):
    _spec_case(spec_micro, variant, spec_visit.make_jump_data, JUMP_ROWS)


def _spec_case(spec_micro, variant, make, rows_total):
    table, rays = make(CPU)
    spec_micro.ROWS_TOTAL = rows_total
    kernel = spec_micro.make_cur() if variant == "cur" else spec_micro.make(
        spec_visit.window(variant))
    f = pl.pallas_call(kernel, in_specs=[VMEM] * 7, out_specs=[VMEM] * 2,
                       out_shape=[jax.ShapeDtypeStruct((8, 128), jnp.float32),
                                  jax.ShapeDtypeStruct((8, 128), jnp.int32)], interpret=True)
    want_t, want_r = (np.asarray(v).reshape(-1) for v in f(
        jnp.asarray(table.numpy()), *(jnp.asarray(r.reshape(8, 128)) for r in rays.numpy())))
    got = [v.numpy() for v in spec_visit.spec_visit(table, rays, variant, rows_total)]
    _same(got, _oracle_spec(table, rays, variant, rows_total))
    got_t, got_r, (end, visits) = got
    assert np.array_equal(got_r, want_r)
    hit = got_t < FAR
    assert np.array_equal(hit, want_t < FAR)
    t32, scale = _record_t(table.numpy(), rays.numpy(), got_r - visits)
    assert np.array_equal(got_t[hit], t32[hit])
    assert (np.abs(got_t - want_t)[hit] <= 5e-6 * scale[hit]).all()
    if make is spec_visit.make_data:
        # every row a leaf with skip 1: a visit moves the cursor W rows, and
        # a body runs out its 32 visits past the end (cur's cursor stays
        # there, a window's moves on by 1 a visit)
        w = spec_visit.window(variant)
        windows = -(-rows_total // w)
        assert visits == 32 * -(-windows // 32)
        assert end == (rows_total if variant == "cur" else windows * w + visits - windows)
        assert hit.sum() == (831 if rows_total % w else 787)


def test_op_micro_rejects_bad_inputs():
    table, x = lane_splat.make_data(CPU)
    with pytest.raises(ValueError):
        lane_splat.lane_splat(table, x, "splat", 8)
    with pytest.raises(ValueError):
        lane_extract.lane_extract(table, x, "e16_v0", 8)
    with pytest.raises(ValueError):
        walk_interleave.walk_interleave(table[:, :64].contiguous(), x, "inter2", 8)
    rows, rays = spec_visit.make_data(CPU)
    with pytest.raises(ValueError):
        spec_visit.spec_visit(rows, rays[:, :512].contiguous(), "cur", 64)
    with pytest.raises(ValueError):
        spec_visit.spec_visit(rows, rays, "w5", 64)
    with pytest.raises(ValueError):
        spec_visit.spec_visit(rows, rays.double(), "w1", 64)

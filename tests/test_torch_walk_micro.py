"""The walk-visit microbenchmarks' plain versions (surf_tpu_torch/micro/
visit_cost.py, quant_visit.py, stack_visit.py, mask_reduce.py) against the
TPU scripts' own kernels, run through ``pl.pallas_call`` in interpret mode
on the port's ``make_data`` arrays, and against a NumPy oracle of each
script written here (float32, every op rounded on its own, as the port's):

- ``scripts/tpu_cost_micro.py``'s ``make(variant, 64)``, all ten variants;
- ``scripts/tpu_quant_micro.py``'s ``make(variant)`` with the loaded
  module's ITERS = 64, on the script's table and on ``make_jump_data``'s,
  whose skip lanes jump, so that the vote moves the cursor;
- ``scripts/tpu_stack_micro.py``'s ``make(n_push)`` with ITERS = 32 (its
  accumulator is finite there, not at the script's 2048);
- ``scripts/tpu_reduce_micro.py``'s ``make(mode)`` with ITERS = 64, on the
  script's data (no child ever hits, every mask 0) and on
  ``make_mixed_data``'s (masks non-zero and not nested).

Gates.  Every output of the plain version equals the NumPy oracle's bit
for bit, the outputs the scripts lack too (the cost micro's acc, boxes hit
and votes, every end cursor, the stack pointer).  Against JAX: best_r
equal; t equal, or within 5e-6 of the magnitude of the terms that sum to
it (``tests/test_torch_dep_micro.py``'s gate: XLA's CPU backend contracts
multiply-adds into FMAs, ROADMAP queue 3), plus one rounding of t_out =
best_t + acc for the cost micro.  On the quant micro's table, whose record
1 of each row is made of packed words, two rays of 866 take another
record at 64 visits (t 1.3320792 against 1.3320793): there the gate of
``tests/test_torch_leaf_micro.py`` for near ties holds, on at most 1% of
rays.  The stack micro's o and the reduce
micro's o on the script's data are bit-equal to JAX's.  On the mixed data
XLA computes the reduce micro's ``a + 0.001 * x * mask`` as one FMA of x
and 0.001 * mask (measured: JAX's o equals a NumPy emulation of that FMA
bit for bit at 64 visits), so there the port keeps the script's order with
each op rounded, and JAX's o lies within 5e-6 of the sum of the update's
terms' magnitudes.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from surf_tpu_torch.micro import _visit, mask_reduce, quant_visit, stack_visit, visit_cost

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
CPU = torch.device("cpu")
F32 = np.float32
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)
COST_ROWS = 64
QUANT_ITERS = 64
STACK_ITERS = 32
MASK_ITERS = 64


def _load(name, iters=None):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if iters is not None:
        mod.ITERS = iters
    return mod


@pytest.fixture(scope="module")
def cost_micro():
    return _load("tpu_cost_micro")


@pytest.fixture(scope="module")
def quant_micro():
    return _load("tpu_quant_micro", QUANT_ITERS)


@pytest.fixture(scope="module")
def stack_micro():
    return _load("tpu_stack_micro", STACK_ITERS)


@pytest.fixture(scope="module")
def reduce_micro():
    return _load("tpu_reduce_micro", MASK_ITERS)


def _interpret(kernel, arrays, n_out, scratch=()):
    """The kernel through pl.pallas_call in interpret mode, every array in
    VMEM: outputs f32 (8, 128) (and an int32 one when n_out is 2), as
    flat numpy arrays."""
    shapes = [jax.ShapeDtypeStruct((8, 128), jnp.float32),
              jax.ShapeDtypeStruct((8, 128), jnp.int32)][:n_out]
    f = pl.pallas_call(kernel, in_specs=[VMEM] * len(arrays),
                       out_specs=[VMEM] * n_out if n_out > 1 else VMEM,
                       out_shape=shapes if n_out > 1 else shapes[0],
                       scratch_shapes=list(scratch), interpret=True)
    out = f(*(jnp.asarray(a) for a in arrays))
    return [np.asarray(x).reshape(-1) for x in (out if n_out > 1 else [out])]


def _packet(table, vec):
    """The kernel's inputs: the table, then each [1024] row of vec as (8, 128)."""
    return [table.numpy()] + [x.reshape(8, 128) for x in vec.numpy().reshape(-1, 1024)]


# --------------------------------------------------------------------------
# NumPy oracles: float32, every op rounded on its own
# --------------------------------------------------------------------------

def _slab_reduce(tn, tf, bt):
    """[R, 8] from the planes' t (tn, tf: x, y, z lists of [R, 8]) in the
    scripts' order, NaN-propagating."""
    tmin = np.minimum(tn[0], tf[0])
    tmax = np.maximum(tn[0], tf[0])
    for m in (1, 2):
        tmin = np.maximum(tmin, np.minimum(tn[m], tf[m]))
        tmax = np.minimum(tmax, np.maximum(tn[m], tf[m]))
    return (tmax >= tmin) & (tmin < bt[:, None]) & (tmax > 0)


def _np_slab(row, o, inv, bt, oinv=None):
    box = row.reshape(8, 16)
    if oinv is None:
        tn = [(box[:, m] - o[m][:, None]) * inv[m][:, None] for m in range(3)]
        tf = [(box[:, 3 + m] - o[m][:, None]) * inv[m][:, None] for m in range(3)]
    else:
        tn = [box[:, m] * inv[m][:, None] - oinv[m][:, None] for m in range(3)]
        tf = [box[:, 3 + m] * inv[m][:, None] - oinv[m][:, None] for m in range(3)]
    return _slab_reduce(tn, tf, bt)


def _np_slab_q8(row, o, inv, bt):
    words = row.view(np.int32)[12:24]
    q = np.array([[(words[2 * m + k // 4] >> (8 * (k % 4))) & 0xFF for m in range(6)]
                  for k in range(8)], F32)
    a = [(row[m] - o[m]) * inv[m] for m in range(3)]
    b = [row[3 + m] * inv[m] for m in range(3)]
    tn = [a[m][:, None] + q[:, m] * b[m][:, None] for m in range(3)]
    tf = [a[m][:, None] + q[:, 3 + m] * b[m][:, None] for m in range(3)]
    return _slab_reduce(tn, tf, bt)


def _np_mt(row, o, d, bt, br, rec0):
    """The row's 8 Möller–Trumbore records in order, each replacing the best
    on a strictly smaller t."""
    c = row.reshape(8, 16)
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (c[:, i] for i in range(9))
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
    for j in range(8):
        hit = ok[:, j] & (t[:, j] < bt)
        bt = np.where(hit, t[:, j], bt)
        br = np.where(hit, rec0 + j, br).astype(np.int32)
    return bt, br


def _rays(rays):
    o, d = rays.numpy()[0:3], rays.numpy()[3:6]
    return o, d, F32(1) / d


def _oracle_cost(table, rays, variant, rows_total):
    tab = table.numpy()
    o, d, inv = _rays(rays)
    oinv = o * inv if variant == "slabfma" else None
    bw, n_ext = visit_cost.window(variant), visit_cost.n_ext(variant)
    bt = np.full(1024, F32(1e30))
    br = np.full(1024, -1, np.int32)
    acc = np.zeros(1024, F32)
    boxes = np.zeros(1024, np.int32)
    votes = 0
    p = 0
    for _ in range(rows_total // bw):
        pc = min(p % 512, 512 - bw)
        for rid in range(pc, pc + bw):
            row = tab[rid]
            acc = acc + F32(row.view(np.int32)[9])
            if n_ext:
                s = F32(0)
                for i in range(n_ext):
                    s = F32(s + row[i])
                acc = acc + s
            if visit_cost.has_slab(variant):
                anyh = _np_slab(row, o, inv, bt, oinv).any(1)
                boxes = boxes + anyh
                votes += int(anyh.any()) if variant == "fullred" else 0
            if visit_cost.has_mt(variant):
                bt, br = _np_mt(row, o, d, bt, br, rid * 8)
        p += bw
    return bt + acc, br, acc, boxes.astype(np.int32), np.array([p, votes], np.int32)


def _oracle_quant(table, rays, variant, iters):
    tab = table.numpy()
    o, d, inv = _rays(rays)
    bt = np.full(1024, F32(1e30))
    br = np.full(1024, -1, np.int32)
    p = 0
    while p < iters:
        for _ in range(quant_visit.K_VISITS):
            pc = (p if p < iters else 0) % 512
            row = tab[pc]
            leaf, skip = row.view(np.int32)[9:11]
            hit = (_np_slab_q8(row, o, inv, bt) if variant.endswith("q8")
                   else _np_slab(row, o, inv, bt))
            if variant.startswith("full"):
                bt, br = _np_mt(row, o, d, bt, br, pc * 8)
            p = p + 1 if leaf == 1 or hit.any() else max(int(skip), p + 1)
    return bt, br, np.array([p], np.int32)


def _oracle_stack(table, x, n_push, iters):
    tab, x = table.numpy(), x.numpy()
    acc = x * F32(0)
    stack = [0] + [-2**31] * 255
    cur, sp = 3, 1
    for _ in range(_visit.block_visits(iters)):
        box = tab[cur % 512].reshape(8, 16)
        r = acc
        for k in range(8):
            lo, hi = box[k, 0:3], box[k, 3:6]
            tmin = np.minimum(lo[0] - x, hi[0] - x)
            tmax = np.maximum(lo[0] - x, hi[0] - x)
            tmin = np.maximum(tmin, np.minimum(lo[1] * x, hi[1] * x))
            tmax = np.minimum(tmax, np.maximum(lo[1] * x, hi[1] * x))
            tmin = np.maximum(tmin, np.minimum(lo[2] - x, hi[2] - x))
            tmax = np.minimum(tmax, np.maximum(lo[2] - x, hi[2] - x))
            r = r + np.where(tmax >= tmin, x, acc)
        hot = bool((r > x).any())
        for q in range(n_push):
            stack[min(sp + q, 255)] = cur * 8 + q
        sp = min(sp + (n_push if hot else 1), 200)
        cur = (stack[max(sp - 1, 0)] + cur) % 4096 + 1
        sp = max(sp - 1, 1)
        acc = r
    return acc, np.array([cur, sp], np.int32)


def _oracle_mask(table, x, variant, iters):
    """(o, end, scale): scale per value is |a0| + the sum over visits of
    |0.001 x| mask, the magnitude of the update's terms."""
    tab, x = table.numpy(), x.numpy()
    a = x * F32(0.001)
    ax = F32(0.001) * x
    scale = np.abs(a).astype(np.float64)
    cur = 3
    for _ in range(_visit.block_visits(iters)):
        hits = (a[:, None] * tab[cur % 512, :8]) > x[:, None]
        words = (hits * (1 << np.arange(8))).sum(1)
        mask = words.max() if variant == "max_byte" else np.bitwise_or.reduce(words)
        a = a + ax * F32(mask)
        scale += np.abs(ax).astype(np.float64) * mask
        cur = cur + 1 if mask > 4 else cur + 2
    return a, np.array([cur], np.int32), scale


def _record_t(table, rays, rid):
    """Per ray, the t of its record ``rid`` (row * 8 + j) in float32 with
    every op rounded (the port's arithmetic), and the magnitude of the
    terms that sum to it in float64, |f| (|e2x qx| + |e2y qy| + |e2z qz|)
    (0 where rid < 0)."""
    c = table.numpy().reshape(-1, 8, 16)[rid.clip(0) // 8, rid.clip(0) % 8]
    out = []
    with np.errstate(all="ignore"):
        for dt in (np.float32, np.float64):
            x = c.astype(dt)
            (ox, oy, oz), (dx, dy, dz) = rays.numpy()[0:3].astype(dt), rays.numpy()[3:6].astype(dt)
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
    return out[0][0], np.where(rid >= 0, out[1][1], 0.0)


def _t_gate(table, rays, got_t, got_r, want_t, want_r):
    """The same rays hit; where the record is equal, JAX's t within 5e-6 of
    the terms' magnitude of the port's; where JAX took another record (a
    near tie that its FMAs flip), the port's t of that record is no smaller
    than its pick's and within 5e-6 of the larger magnitude, on at most 1%
    of rays."""
    assert np.array_equal(got_r >= 0, want_r >= 0)
    _, scale = _record_t(table, rays, got_r)
    same = got_r == want_r
    assert (np.abs(got_t - want_t)[same] <= 5e-6 * scale[same]).all()
    other = ~same
    t_alt, scale_alt = _record_t(table, rays, want_r)
    assert (t_alt[other] >= got_t[other]).all()
    assert (t_alt - got_t <= 5e-6 * np.maximum(scale, scale_alt))[other].all()
    assert other.mean() <= 0.01


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# --------------------------------------------------------------------------
# The tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", visit_cost.VARIANTS)
def test_visit_cost_matches_tpu_kernel(cost_micro, variant):
    table, rays = visit_cost.make_data(CPU)
    assert cost_micro.VARIANTS == visit_cost.VARIANTS
    want_t, want_r = _interpret(cost_micro.make(variant, COST_ROWS), _packet(table, rays), 2)
    got = [x.numpy() for x in visit_cost.visit_cost(table, rays, variant, COST_ROWS)]
    with np.errstate(all="ignore"):
        _same(got, _oracle_cost(table, rays, variant, COST_ROWS))
    got_t, got_r, acc, boxes, state = got
    assert np.array_equal(got_r, want_r)
    gate = 5e-6 * _record_t(table, rays, got_r)[1] + np.spacing(np.abs(got_t))
    assert (np.abs(got_t - want_t) <= gate).all()
    assert state[0] == COST_ROWS
    if not visit_cost.n_ext(variant):
        assert (acc == COST_ROWS).all()  # lane 9 adds 1 a row
    assert (boxes > 0).any() == visit_cost.has_slab(variant)
    assert (got_r >= 0).any() == visit_cost.has_mt(variant)
    assert (state[1] > 0) == (variant == "fullred")


@pytest.mark.parametrize("table_kind", ["script", "jump"])
@pytest.mark.parametrize("variant", quant_visit.VARIANTS)
def test_quant_visit_matches_tpu_kernel(quant_micro, variant, table_kind):
    make = quant_visit.make_data if table_kind == "script" else quant_visit.make_jump_data
    table, rays = make(CPU)
    want_t, want_r = _interpret(quant_micro.make(variant), _packet(table, rays), 2)
    got = [x.numpy() for x in quant_visit.quant_visit(table, rays, variant, QUANT_ITERS)]
    with np.errstate(all="ignore"):
        _same(got, _oracle_quant(table, rays, variant, QUANT_ITERS))
    got_t, got_r, end = got
    _t_gate(table, rays, got_t, got_r, want_t, want_r)
    # the script's skip lanes are all 1: the cursor steps by one; the jump
    # table's vote leaves it further on
    assert (end[0] == QUANT_ITERS) == (table_kind == "script")
    assert (got_r >= 0).any() == variant.startswith("full")
    if variant.startswith("full") and table_kind == "script":
        assert (got_r[got_r >= 0] % 8 == 1).all()  # record 1, made of the packed words


@pytest.mark.parametrize("variant", stack_visit.VARIANTS)
def test_stack_visit_matches_tpu_kernel(stack_micro, variant):
    table, x = stack_visit.make_data(CPU)
    n_push = stack_visit.pushes(variant)
    (want,) = _interpret(stack_micro.make(n_push), _packet(table, x), 1,
                         [pltpu.VMEM((256, 128), jnp.int32)])
    got = [v.numpy() for v in stack_visit.stack_visit(table, x, variant, STACK_ITERS)]
    _same(got, _oracle_stack(table, x, n_push, STACK_ITERS))
    assert np.array_equal(got[0], want) and np.isfinite(got[0]).all()
    assert 1 <= got[1][1] <= stack_visit.SP_MAX


@pytest.mark.parametrize("data_kind", ["script", "mixed"])
@pytest.mark.parametrize("variant", mask_reduce.VARIANTS)
def test_mask_reduce_matches_tpu_kernel(reduce_micro, variant, data_kind):
    make = mask_reduce.make_data if data_kind == "script" else mask_reduce.make_mixed_data
    table, x = make(CPU)
    (want,) = _interpret(reduce_micro.make(variant), _packet(table, x), 1)
    got = [v.numpy() for v in mask_reduce.mask_reduce(table, x, variant, MASK_ITERS)]
    o, end, scale = _oracle_mask(table, x, variant, MASK_ITERS)
    _same(got, (o, end))
    if data_kind == "script":  # no child hits: every mask 0, the cursor steps by 2
        assert np.array_equal(got[0], want) and end[0] == 3 + 2 * MASK_ITERS
        assert np.array_equal(got[0], x.numpy() * F32(0.001))
    else:
        assert (np.abs(got[0] - want) <= 5e-6 * scale).all()
        assert end[0] < 3 + 2 * MASK_ITERS  # some mask > 4


def test_mixed_masks_are_not_nested():
    """On the mixed data max_byte departs from the OR of the words."""
    table, x = mask_reduce.make_mixed_data(CPU)
    o_or = mask_reduce.mask_reduce(table, x, "or_reduce", MASK_ITERS)[0]
    o_any = mask_reduce.mask_reduce(table, x, "eight_any", MASK_ITERS)[0]
    o_max = mask_reduce.mask_reduce(table, x, "max_byte", MASK_ITERS)[0]
    assert torch.equal(o_or, o_any) and not torch.equal(o_or, o_max)


def test_walk_micro_rejects_bad_inputs():
    table, rays = visit_cost.make_data(CPU)
    x = rays[0].contiguous()
    with pytest.raises(ValueError):
        visit_cost.visit_cost(table, rays, "bf16", 64)
    with pytest.raises(ValueError):
        visit_cost.visit_cost(table[:4].contiguous(), rays, "bf8", 64)
    with pytest.raises(ValueError):
        visit_cost.visit_cost(table, rays, "bf8", 4)
    with pytest.raises(ValueError):
        quant_visit.quant_visit(table, rays[:, :512].contiguous(), "node_f32", 64)
    with pytest.raises(ValueError):
        stack_visit.stack_visit(table, x[:100].contiguous(), "push1", 32)
    with pytest.raises(ValueError):
        mask_reduce.mask_reduce(table[:, :64].contiguous(), x, "or_reduce", 64)
    with pytest.raises(ValueError):
        mask_reduce.mask_reduce(table, x, "or_reduce", 0)

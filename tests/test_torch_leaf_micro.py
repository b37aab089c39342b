"""The leaf-row microbenchmarks' plain versions (surf_tpu_torch/micro/
leaf_groups.py, leaf_visit.py) against the TPU scripts' own kernels, run
through ``pl.pallas_call`` in interpret mode on the same data:

- ``scripts/tpu_leaf_variants_micro.py``'s ``make_kernel(variant, cap8=4)``
  for its four variants, on two packets of the script's data (the indoor
  leaf table, lists ``arange % n_rows``) with counts [3, 9] (9 checks the
  ``min(count, cap8)`` clamp), and ``full`` with a packet whose count is 0.
  ``scripts/tpu_leaf_kernel_micro.py`` cannot run on this tree: it names
  ``pallas_wide._leaf_list_kernel``, which the JAX package no longer has.
  That kernel was line for line ``make_kernel("full")``, so the port serves
  both scripts with ``full``, and this test of ``full`` covers both.
- ``scripts/tpu_leaf_micro.py``'s ``make(variant)`` for its six variants,
  with the loaded module's ITERS set to 64.

Gates, those of tests/test_torch_dep_micro.py with its bound on t made a
running-error bound (``_record_t``): the same rays hit; the port's t
bit-equal to NumPy's separately rounded float32 evaluation of its record's
t; the record equal, with JAX's t within 5e-6 of the bound on how far
rounding can move t (XLA's CPU backend contracts multiply-adds into FMAs,
ROADMAP queue 3), except at near ties that the contraction flips: there
the port's own t of JAX's record lies within the same distance above the
port's pick, on at most 1% of rays.  ``nodiv``'s f = a needs both: its
hits crowd where t = a (...) is small, often with a far smaller than its
terms.  The end cursor equals the one walked in NumPy.

``recip``: the port's plain ``recip`` divides (the function an approximate
reciprocal approximates), so it equals its plain ``full`` bit for bit and
is held to JAX's ``full`` by the gates above.  JAX's ``recip`` in interpret
mode computes ``pl.reciprocal(approx=True)`` at about bf16 precision
(1/0.1234567 gives 8.094862, where 1/x is 8.100006), so against it the
gate is looser: the record equal on at least 99% of rays (2 of 1024 differ
at 64 visits), and those rays' t within the bf16 reciprocal's 2**-8
relative error.
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

from surf_tpu_torch.micro import leaf_groups, leaf_visit

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
CAP8 = 4
VISITS = 64


def _load(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def variants_micro():
    return _load("tpu_leaf_variants_micro")


@pytest.fixture(scope="module")
def visit_micro():
    mod = _load("tpu_leaf_micro")
    mod.ITERS = VISITS
    return mod


@pytest.fixture(scope="module")
def groups_data():
    d = leaf_groups.make_data(torch.device("cpu"))
    return leaf_groups.Data(d.table, d.lists[:2, :CAP8].contiguous(),
                            d.rays[:, :2].contiguous(), d.t_max[:2].contiguous())


@pytest.fixture(scope="module")
def visit_data():
    return leaf_visit.make_data(torch.device("cpu"))


def _jax_groups(micro, data, variant, counts):
    """The script's kernel at cap8=CAP8 on ``data``'s packets, as its
    ``build`` calls it (``tpu_leaf_variants_micro.py:138-161``)."""
    g, e = data.lists.shape[0], data.table.shape[0]
    blk = pl.BlockSpec((1, 8, 128), lambda p, s: (p, 0, 0))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(g,),
        in_specs=[blk] * 7 + [pl.BlockSpec((1, CAP8, 8), lambda p, s: (p, 0, 0)),
                              pl.BlockSpec((e, 128), lambda p, s: (0, 0))],
        out_specs=[blk] * 4)
    out_shape = [jax.ShapeDtypeStruct((g, 8, 128), d)
                 for d in (jnp.float32, jnp.int32, jnp.float32, jnp.float32)]
    f = pl.pallas_call(micro.make_kernel(variant, CAP8), grid_spec=grid_spec,
                       out_shape=out_shape, interpret=True)
    rays = [jnp.asarray(x.reshape(g, 8, 128)) for x in data.rays.numpy()]
    out = f(jnp.asarray(np.asarray(counts, np.int32)), *rays,
            jnp.asarray(data.t_max.numpy().reshape(g, 8, 128)),
            jnp.asarray(data.lists.numpy()), jnp.asarray(data.table.numpy()))
    return [np.asarray(x).reshape(g, -1) for x in out]


def _record_t(table, o, d, rid, recip="div"):
    """Per ray, the t of record ``rid`` (row * 8 + j) in float32 with every
    op rounded (the port's arithmetic), and in float64 a first-order bound
    on how far rounding can move it, in units of one rounding: the
    polynomial run on the absolute values of its terms (each product and
    sum of |.|), through t = f S as |f| |S|abs + |S| |f|err, where f's error
    is |f| |a|abs / |a| for f = 1 / a and |a|abs (times 0.5) for f = a
    (a * 0.5).  With f = 1 / a the second term is small on rays that hit;
    the division-free variants' hits crowd where t = a S is small, often
    with a a difference of terms far larger than itself."""
    c = table.reshape(-1, 8, 16)[rid.clip(0) // 8, rid.clip(0) % 8]
    out = []
    for dt in (np.float32, np.float64):
        x = c.astype(dt)
        ox, oy, oz = o.astype(dt)
        dx, dy, dz = d.astype(dt)
        v0, e1, e2 = x[:, 0:3].T, x[:, 3:6].T, x[:, 6:9].T
        hx = dy * e2[2] - dz * e2[1]
        hy = dz * e2[0] - dx * e2[2]
        hz = dx * e2[1] - dy * e2[0]
        a = e1[0] * hx + e1[1] * hy + e1[2] * hz
        f = {"div": dt(1) / a, "none": a, "half": a * dt(0.5)}[recip]
        sx, sy, sz = ox - v0[0], oy - v0[1], oz - v0[2]
        qx = sy * e1[2] - sz * e1[1]
        qy = sz * e1[0] - sx * e1[2]
        qz = sx * e1[1] - sy * e1[0]
        big_s = e2[0] * qx + e2[1] * qy + e2[2] * qz
        out.append(f * big_s)
    A = np.abs
    hx_a = A(dy * e2[2]) + A(dz * e2[1])
    hy_a = A(dz * e2[0]) + A(dx * e2[2])
    hz_a = A(dx * e2[1]) + A(dy * e2[0])
    a_abs = A(e1[0]) * hx_a + A(e1[1]) * hy_a + A(e1[2]) * hz_a
    sx_a, sy_a, sz_a = A(ox) + A(v0[0]), A(oy) + A(v0[1]), A(oz) + A(v0[2])
    qx_a = sy_a * A(e1[2]) + sz_a * A(e1[1])
    qy_a = sz_a * A(e1[0]) + sx_a * A(e1[2])
    qz_a = sx_a * A(e1[1]) + sy_a * A(e1[0])
    s_abs = A(e2[0]) * qx_a + A(e2[1]) * qy_a + A(e2[2]) * qz_a
    f_err = {"div": A(f) * a_abs / A(a), "none": a_abs, "half": 0.5 * a_abs}[recip]
    return out[0], A(f) * s_abs + A(big_s) * f_err


def _gates(table, o, d, got_t, got_r, want_t, want_r, recip="div"):
    """The same rays hit; the port's t equal to NumPy's float32 t of its
    record; the record equal, with JAX's t within 5e-6 of the rounding
    bound of ``_record_t``, except at ties that the FMAs can flip: where
    JAX took another record, the port's own t of that record is no smaller
    than its pick's and within 5e-6 of the larger bound of the two, on at
    most 1% of rays.  Returns the mask of rays that hit."""
    hit = got_r >= 0
    assert np.array_equal(hit, want_r >= 0)
    t32, scale = _record_t(table, o, d, got_r, recip)
    assert np.array_equal(got_t[hit], t32[hit])
    same = hit & (got_r == want_r)
    assert (np.abs(got_t - want_t)[same] <= 5e-6 * scale[same]).all()
    other = hit & ~same
    t_alt, scale_alt = _record_t(table, o[:, other], d[:, other], want_r[other], recip)
    assert (t_alt >= got_t[other]).all()
    assert (t_alt - got_t[other] <= 5e-6 * np.maximum(scale[other], scale_alt)).all()
    assert other.mean() <= 0.01
    return hit


@pytest.mark.parametrize("variant,counts", [(v, (3, 9)) for v in leaf_groups.VARIANTS]
                         + [("full", (0, 2))])
def test_groups_plain_matches_tpu_kernel(variants_micro, groups_data, variant, counts):
    data = groups_data
    want_t, want_r, want_u, want_v = _jax_groups(variants_micro, data, variant, counts)
    got = leaf_groups.leaf_groups(data.table, data.lists, torch.tensor(counts, dtype=torch.int32),
                                  data.rays, data.t_max, variant, CAP8)
    got_t, got_r, got_u, got_v = (x.numpy() for x in got)
    rays = data.rays.numpy()
    for p in range(2):
        table = data.table.numpy()
        if variant == "noext":  # every entry tests row 0's records under its own row id
            table = np.repeat(table[:1], table.shape[0], axis=0)
        hit = _gates(table, rays[0:3, p], rays[3:6, p], got_t[p], got_r[p], want_t[p],
                     want_r[p], "none" if variant == "nodiv" else "div")
        if counts[p] == 0:
            assert not hit.any() and (got_t[p] == leaf_groups.FAR).all()
            assert (got_u[p] == 0).all() and (got_v[p] == 0).all()
            continue
        assert hit.any()
        # the records each ray may take: the tested entries of its groups
        trip = min(counts[p], CAP8)
        ids = data.lists[p, :trip, :leaf_groups.entries(variant)].numpy().reshape(-1)
        assert np.isin(got_r[p][hit] // 8, ids).all()
        same = got_r[p] == want_r[p]
        assert np.allclose(got_u[p][same], want_u[p][same], rtol=0, atol=1e-5)
        assert np.allclose(got_v[p][same], want_v[p][same], rtol=0, atol=1e-5)
    if counts == (3, 9):
        # 9 groups clamp to cap8: as many as a count of cap8
        clamp = leaf_groups.leaf_groups(data.table, data.lists,
                                        torch.tensor((3, CAP8), dtype=torch.int32),
                                        data.rays, data.t_max, variant, CAP8)
        assert all(torch.equal(x, y) for x, y in zip(got, clamp))


def _jax_visit(micro, table, rays, variant):
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    f = pl.pallas_call(micro.make(variant), in_specs=[vmem] * 7, out_specs=[vmem] * 2,
                       out_shape=[jax.ShapeDtypeStruct((8, 128), jnp.float32),
                                  jax.ShapeDtypeStruct((8, 128), jnp.int32)],
                       interpret=True)
    ray = [jnp.asarray(x.reshape(8, 128)) for x in rays.numpy()]
    return [np.asarray(x).reshape(-1) for x in f(jnp.asarray(table.numpy()), *ray)]


def _walk_end(table, iters):
    """The cursor after the script's loop, walked in NumPy."""
    meta = table.view(torch.int32)[:, 9:11].numpy()
    p = 0
    while p < iters:
        for _ in range(leaf_visit.K_VISITS):
            pc = (p if p < iters else 0) % table.shape[0]
            # the vote matters only where skip > p + 1, never on this table
            p = p + 1 if meta[pc, 0] == 1 else max(int(meta[pc, 1]), p + 1)
    return p


@pytest.mark.parametrize("variant", leaf_visit.VARIANTS)
def test_visit_plain_matches_tpu_kernel(visit_micro, visit_data, variant):
    table, rays = visit_data
    assert visit_micro.VARIANTS == leaf_visit.VARIANTS
    want_t, want_r = _jax_visit(visit_micro, table, rays, "full" if variant == "recip" else variant)
    got_t, got_r, end = (x.numpy() for x in leaf_visit.leaf_visit(table, rays, variant, VISITS))
    assert end.tolist() == [_walk_end(table, VISITS)] == [VISITS]
    o, d = rays[0:3].numpy(), rays[3:6].numpy()
    if variant == "empty":
        assert (got_r == -1).all() and (got_t == leaf_visit.FAR).all()
        assert (want_r == -1).all() and (want_t == leaf_visit.FAR).all()
        return
    if variant == "extonly":
        # t = (the 9 lanes summed in order) * dx; no eps test, every ray hits
        c = table.numpy().reshape(-1, 8, 16)[got_r // 8, got_r % 8]
        s = c[:, 0]
        for lane in range(1, 9):
            s = s + c[:, lane]
        assert np.array_equal(got_t, s * d[0])
        assert np.array_equal(got_t, want_t) and np.array_equal(got_r, want_r)
        return
    hit = _gates(table.numpy(), o, d, got_t, got_r, want_t, want_r,
                 "half" if variant == "nodiv" else "div")
    assert hit.any()
    if variant == "half":
        assert (got_r[hit] % 8 < 4).all()


def test_visit_recip_against_tpu_recip(visit_micro, visit_data):
    """The port's plain recip is its plain full, bit for bit; JAX's recip
    (a bf16-precision reciprocal in interpret mode) keeps the record of at
    least 99% of rays, and the t of those rays within 2**-8 relative."""
    table, rays = visit_data
    full = leaf_visit.leaf_visit(table, rays, "full", VISITS)
    recip = leaf_visit.leaf_visit(table, rays, "recip", VISITS)
    assert all(torch.equal(x, y) for x, y in zip(full, recip))
    want_t, want_r = _jax_visit(visit_micro, table, rays, "recip")
    got_t, got_r = full[0].numpy(), full[1].numpy()
    same = got_r == want_r
    assert same.mean() >= 0.99
    hit = same & (got_r >= 0)
    assert (np.abs(want_t - got_t)[hit] <= 2.0 ** -8 * np.abs(got_t[hit])).all()


def test_recip_gate():
    """RECIP_GATE counts differing records and t's relative error where the
    records agree, and requires the end cursors to be equal."""
    t = torch.tensor([1.0, 2.0, 1e30, 4.0] * 256)
    r = torch.tensor([0, 1, -1, 3] * 256, dtype=torch.int32)
    end = torch.tensor([64], dtype=torch.int32)
    assert leaf_visit.recip_gate((t, r, end), (t, r, end))["ok"]
    r2 = r.clone()
    r2[:2] = 7   # 2 of 1024 rays
    t2 = t * (1 + 3e-7)
    g = leaf_visit.recip_gate((t2, r2, end), (t, r, end))
    assert g["ok"] and g["r_frac"] == pytest.approx(2 / 1024) and g["t_rel"] > 0
    r2[:3] = 7
    assert not leaf_visit.recip_gate((t, r2, end), (t, r, end))["ok"]
    assert not leaf_visit.recip_gate((t * (1 + 1e-6), r, end), (t, r, end))["ok"]
    assert not leaf_visit.recip_gate((t, r, end + 32), (t, r, end))["ok"]


def test_data_and_bad_inputs(groups_data, visit_data):
    """The scripts' data; bad inputs raise ValueError."""
    full = leaf_groups.make_data(torch.device("cpu"))
    assert full.table.shape == (376, 128) and full.lists.shape == (16, 256, 8)
    assert torch.equal(full.lists[0].reshape(-1), torch.arange(2048, dtype=torch.int32) % 365)
    norm = full.rays[3:6].double().norm(dim=0)
    assert torch.allclose(norm, torch.ones_like(norm), atol=1e-6)
    assert bool((full.rays[0:3].abs() <= 4).all()) and bool((full.t_max == 1e30).all())
    table, rays = visit_data
    meta = table.view(torch.int32)[:, 9:11]
    assert set(meta[:, 0].tolist()) == {0, 1} and bool((meta[:, 1] == 1).all())
    assert bool((rays >= 0.1).all() & (rays < 1).all())

    d = groups_data
    counts = torch.tensor((3, 9), dtype=torch.int32)
    ok = (d.table, d.lists, counts, d.rays, d.t_max)
    bad = [
        ((d.table, d.lists, counts, d.rays, d.t_max, "half", CAP8), "variant"),
        ((*ok, "full", CAP8 - 1), "cap8 below the lists' width"),
        ((*ok, "full", CAP8 + 1), "cap8 above the lists' width"),
        ((d.table, d.lists, counts[:1], d.rays, d.t_max, "full", CAP8), "counts"),
        ((d.table, d.lists, counts.long(), d.rays, d.t_max, "full", CAP8), "counts dtype"),
        ((d.table, d.lists, counts, d.rays[:, :1].contiguous(), d.t_max, "full", CAP8), "rays"),
        ((d.table[:, :64].contiguous(), d.lists, counts, d.rays, d.t_max, "full", CAP8),
         "table"),
        ((d.table, d.lists.long(), counts, d.rays, d.t_max, "full", CAP8), "lists dtype"),
    ]
    for args, what in bad:
        with pytest.raises(ValueError):
            leaf_groups.leaf_groups(*args)
            pytest.fail(what)
    for args in ((table, rays, "empty", 0), (table, rays, "nodiv2", 8),
                 (table, rays[:, :512].contiguous(), "full", 8),
                 (table[:, :64].contiguous(), rays, "full", 8), (table, rays, "full", -32)):
        with pytest.raises(ValueError):
            leaf_visit.leaf_visit(*args)

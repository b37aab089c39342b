"""The dependent-cursor microbenchmark's plain version
(surf_tpu_torch/micro/dep_chain.py) against the TPU script's own kernel,
``scripts/tpu_dep_micro.py``'s ``make(variant, 64)`` run through
``pl.pallas_call`` in interpret mode on the same data, for all six
variants.

Gates: best_r equal except at coincident-t ties.  The port's best_t is
bit-equal to NumPy's separately rounded float32 evaluation of its record's
t; JAX's is within 5e-6 of the magnitude of the terms that sum to t (XLA's
CPU backend contracts multiply-adds into FMAs, ROADMAP queue 3).  That is
rtol 5e-6 where t is as large as its terms; on this table's random
triangles many rays start next to a triangle, and t, a difference of terms
up to 2.3e4 times larger on this data, loses the digits the contraction
moves.
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

from surf_tpu_torch.micro import dep_chain

torch.set_num_threads(1)

ROWS = 64
SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "tpu_dep_micro.py"


@pytest.fixture(scope="module")
def tpu_micro():
    spec = importlib.util.spec_from_file_location("tpu_dep_micro", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data():
    return dep_chain.make_data(torch.device("cpu"))


@pytest.mark.parametrize("variant", dep_chain.VARIANTS)
def test_plain_matches_tpu_kernel(tpu_micro, data, variant):
    rows_b, rows_w, rays = data
    assert tpu_micro.VARIANTS == dep_chain.VARIANTS
    table = rows_w if variant.startswith("depb") else rows_b
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    f = pl.pallas_call(
        tpu_micro.make(variant, ROWS), in_specs=[vmem] * 7, out_specs=[vmem] * 2,
        out_shape=[jax.ShapeDtypeStruct((8, 128), jnp.float32),
                   jax.ShapeDtypeStruct((8, 128), jnp.int32)],
        interpret=True)
    ray = [jnp.asarray(x.numpy().reshape(8, 128)) for x in rays]
    want_t, want_r = (np.asarray(x).reshape(-1) for x in f(jnp.asarray(table.numpy()), *ray))
    got_t, got_r, end = (x.numpy() for x in dep_chain.dep_chain(table, rays, variant, ROWS))
    p, skips = 0, table.view(torch.int32)[:, 9].numpy()
    for _ in range(ROWS // dep_chain.window(variant)):
        p = skips[p + dep_chain.window(variant) - 1]
    assert end.tolist() == [p]
    assert ((got_r == want_r) | (got_t == want_t)).all()
    hit = got_r >= 0
    assert np.array_equal(hit, want_r >= 0)
    t32, scale = _record_t(table.numpy(), rays.numpy(), got_r, variant == "dep1lean")
    assert np.array_equal(got_t[hit], t32[hit])
    assert (np.abs(got_t - want_t)[hit] <= 5e-6 * scale[hit]).all()
    if variant == "dep0":
        assert not hit.any() and (got_t == dep_chain.FAR).all()
    else:
        assert hit.any()


def _record_t(table, rays, rec, lean):
    """Per ray, the t of its record ``rec`` (row * 8 + j) in float32 with
    every op rounded (the port's arithmetic), and the magnitude of the
    terms that sum to it in float64: |f| (|e2x qx| + |e2y qy| + |e2z qz|)
    for Möller–Trumbore, (|d0| + |n . o| termwise) / |den| for the plane
    form."""
    c = table.reshape(-1, 8, 16)[rec.clip(0) // 8, rec.clip(0) % 8]
    out = []
    for dt in (np.float32, np.float64):
        x = c.astype(dt)
        ox, oy, oz, dx, dy, dz = rays.astype(dt)
        if lean:
            nx, ny, nz, d0 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
            den = nx * dx + ny * dy + nz * dz
            terms = (d0, nx * ox, ny * oy, nz * oz)
            t = (d0 - (nx * ox + ny * oy + nz * oz)) / den
            inv = 1 / np.abs(den)
        else:
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
            t = f * (terms[0] + terms[1] + terms[2])
            inv = np.abs(f)
        out.append((t, inv * sum(np.abs(z) for z in terms)))
    return out[0][0], out[1][1]


def test_data_and_inputs(data):
    """The TPU script's tables: skip lanes +1 (or +8 wrapped at 504), equal
    in both lanes; the rays in [0.1, 1); bad inputs raise."""
    rows_b, rows_w, rays = data
    for table, step, wrap in ((rows_b, 1, 512), (rows_w, 8, 504)):
        skips = table.view(torch.int32)[:, 9:11]
        assert torch.equal(skips[:, 0], skips[:, 1])
        assert torch.equal(skips[:, 0], (torch.arange(512, dtype=torch.int32) + step) % wrap)
    assert rays.shape == (6, 1024) and bool((rays >= 0.1).all() & (rays < 1).all())
    with pytest.raises(ValueError):
        dep_chain.dep_chain(rows_b, rays, "dep2", 8)
    with pytest.raises(ValueError):
        dep_chain.dep_chain(rows_w, rays, "depb8", 12)
    with pytest.raises(ValueError):
        dep_chain.dep_chain(rows_b, rays[:, :512].contiguous(), "dep0", 8)

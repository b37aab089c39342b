"""The port's bits* algos whose record test rounds otherwise than bitsru8's:
Baldwin–Weber (``bitsw``) and bf16 Möller–Trumbore (``bitsh``), against
surf_tpu's ``traverse_wide`` with the same algo in interpret mode, against
the port's own ``bits``, and against a NumPy evaluation of the record test
at the winning record, on the indoor scene with numpy-made rays.

Gates and what they rest on (measured on these rays, on a CPU):
- ``bitsw`` vs JAX ``bitsw``: prim equal on at least 99.9% of rays (100%
  measured); t within rtol 5e-5 where the prims agree: the plane's
  num = d0 - n.o cancels, which magnifies XLA's FMA contraction up to
  2.0e-5 relative (the MT algos stay within 5e-6).  The port's own
  arithmetic is exact: its t, u, v are bit-equal to a float32 NumPy
  evaluation of ``_bw8`` (pallas_wide.py:1155-1162) at the winning record.
  Against the port's ``bits`` the gates of tests/test_wide_kernel.py:
  226-247 (prim on 99.9%, t within 1e-4).
- ``bitsh`` vs JAX ``bitsh``: prim on at least 99.5% of rays (99.88%
  measured), t within rtol 1e-2 where the prims agree (3.8e-3 measured):
  XLA may keep some intermediate products in f32.  The port's t, u, v are
  bit-equal to a NumPy evaluation of ``_mt8`` with every op rounded to
  bf16 (round to nearest even).  Against the port's ``bits``: rounding the
  ray's origin to bf16 (a step of 2^-6 at 2 to 4 units) moves ~1.7% of
  the winners, for JAX's ``bitsh`` as for the port's (98.36% and 98.34%
  agree), so the gate is 98% of rays, and the port's agreement within 0.5
  points of JAX's; ``bits``'s 99% would fail the reference itself.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bits import _rays, scenes  # noqa: F401  (scenes is a fixture)

from surf_tpu.accel.pallas_wide import traverse_wide
from surf_tpu_torch.accel.bits import nudge, traverse_bits

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

N = 4096
f32 = np.float32


@pytest.fixture(scope="module")
def rays():
    o, d = _rays(N, seed=29)
    return o, d, np.full(N, 1e30, f32), np.ones(N, bool)


def _port(ts, o, d, tmax, act, algo):
    h = traverse_bits(ts.trace, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(tmax), torch.from_numpy(act), algo=algo)
    return [x.numpy() for x in h]


def _jax(wt, o, d, tmax, act, algo):
    h = traverse_wide(wt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
                      jnp.asarray(act), False, interpret=True, algo=algo, block_rays=2048)
    return [np.asarray(x) for x in h]


def _winning_records(trace, table, prim):
    """[k, 16] records of ``table`` (``ltab`` or ``ltabw``, same record
    slots) at the hit slots; the slot ids are read from ``ltab``'s lane 9,
    where padding records hold -1."""
    slots = trace.ltab.numpy().reshape(-1, 16)[:, 9].view(np.int32)
    where = np.full(slots.max() + 1, -1)
    where[slots[slots >= 0]] = np.nonzero(slots >= 0)[0]
    return table.numpy().reshape(-1, 16)[where[prim]]


def test_bitsw_matches_jax_and_its_formula(scenes, rays):  # noqa: F811
    _, wt, ts = scenes
    o, d, tmax, act = rays
    got = _port(ts, o, d, tmax, act, "bitsw")
    want = _jax(wt, o, d, tmax, act, "bitsw")
    agree = got[0] == want[0]
    assert agree.mean() >= 0.999
    both = agree & (got[0] >= 0)
    assert both.mean() > 0.5
    np.testing.assert_allclose(got[1][both], want[1][both], rtol=5e-5)

    # the port's t, u, v are _bw8's expression in float32, op by op
    hit = got[0] >= 0
    r = _winning_records(ts.trace, ts.trace.ltabw, got[0][hit])
    ox, oy, oz = o[hit].T
    dx, dy, dz = nudge(torch.from_numpy(d[hit])).numpy().T
    den = r[:, 0] * dx + r[:, 1] * dy + r[:, 2] * dz
    num = r[:, 3] - (r[:, 0] * ox + r[:, 1] * oy + r[:, 2] * oz)
    t = num * (f32(1.0) / den)
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    u = r[:, 7] + r[:, 4] * px + r[:, 5] * py + r[:, 6] * pz
    v = r[:, 11] + r[:, 8] * px + r[:, 9] * py + r[:, 10] * pz
    for x, y in zip((t, u, v), got[1:]):
        assert np.array_equal(x, y[hit])

    bits = _port(ts, o, d, tmax, act, "bits")
    agree = got[0] == bits[0]
    assert agree.mean() >= 0.999
    both = agree & (got[0] >= 0)
    np.testing.assert_allclose(got[1][both], bits[1][both], rtol=1e-4, atol=1e-4)


def _bf(x):
    """float32 -> the nearest bf16 value (ties to even), as float32."""
    b = np.asarray(x, f32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(f32)


def assert_bf16_formula(ts, o, d, got):
    """The port's t, u, v at its hits are _mt8's expression with every op
    rounded to bf16 (round to nearest even), evaluated with NumPy at the
    winning record."""
    hit = got[0] >= 0
    r = _bf(_winning_records(ts.trace, ts.trace.ltab, got[0][hit]))
    ox, oy, oz = _bf(o[hit]).T
    dx, dy, dz = _bf(nudge(torch.from_numpy(d[hit])).numpy()).T
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = r[:, :9].T

    def dot3(a, b, c, x, y, z):
        return _bf(_bf(_bf(a * x) + _bf(b * y)) + _bf(c * z))

    def cross(a, b, c, x):
        return _bf(_bf(a * b) - _bf(c * x))

    hx, hy, hz = cross(dy, e2z, dz, e2y), cross(dz, e2x, dx, e2z), cross(dx, e2y, dy, e2x)
    a = dot3(e1x, e1y, e1z, hx, hy, hz)
    f = _bf(f32(1.0) / a)
    sx, sy, sz = _bf(ox - v0x), _bf(oy - v0y), _bf(oz - v0z)
    u = _bf(f * dot3(sx, sy, sz, hx, hy, hz))
    qx, qy, qz = cross(sy, e1z, sz, e1y), cross(sz, e1x, sx, e1z), cross(sx, e1y, sy, e1x)
    v = _bf(f * dot3(dx, dy, dz, qx, qy, qz))
    t = _bf(f * dot3(e2x, e2y, e2z, qx, qy, qz))
    for x, y in zip((t, u, v), got[1:]):
        assert np.array_equal(x, y[hit])


def test_bitsh_matches_jax_and_its_formula(scenes, rays):  # noqa: F811
    _, wt, ts = scenes
    o, d, tmax, act = rays
    got = _port(ts, o, d, tmax, act, "bitsh")
    want = _jax(wt, o, d, tmax, act, "bitsh")
    agree = got[0] == want[0]
    assert agree.mean() >= 0.995
    both = agree & (got[0] >= 0)
    assert both.mean() > 0.5
    np.testing.assert_allclose(got[1][both], want[1][both], rtol=1e-2)
    assert_bf16_formula(ts, o, d, got)

    bits = _port(ts, o, d, tmax, act, "bits")
    port_agree = (got[0] == bits[0]).mean()
    jax_agree = (want[0] == bits[0]).mean()  # the port's bits prim is JAX's
    assert port_agree >= 0.98 and port_agree >= jax_agree - 0.005

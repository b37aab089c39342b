"""surf_tpu_torch.core against surf_tpu.core and the NumPy RNG oracle:
the same numpy-made seeds and normals go through both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surf_tpu.core import rng as jrng
from surf_tpu.core import sampling as jsampling
from surf_tpu.core import vecmath as jvec
from surf_tpu.reference import rng_np
from surf_tpu_torch.core import rng, sampling, vecmath

N = 4096


def _seeds(seed=0, n=N):
    s = np.random.default_rng(seed).integers(1, 2**32, n, dtype=np.uint64)
    s[:4] = [1, 2**31, 2**32 - 1, 0x27D4EB2D]
    return s.astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(x):
    x = x.numpy()
    return x.astype(np.uint32) if x.dtype == np.int64 else x


@pytest.mark.parametrize("fn", ["wang_hash", "init_seed", "xorshift32"])
def test_rng_mix_bit_exact(fn):
    s = _seeds(1)
    got = _np(getattr(rng, fn)(_t(s)))
    assert np.array_equal(got, np.asarray(getattr(jrng, fn)(jnp.asarray(s))))
    assert np.array_equal(got, getattr(rng_np, fn)(s))


@pytest.mark.parametrize("total", [0, 1, 17, 2**20, 2**32 - 1])
def test_pixel_seed_bit_exact(total):
    idx = np.arange(N, dtype=np.uint32) * np.uint32(977)
    got = _np(rng.pixel_seed(_t(idx), total))
    assert np.array_equal(got, np.asarray(jrng.pixel_seed(jnp.asarray(idx), total)))
    assert np.array_equal(got, rng_np.pixel_seed(idx, total))


def test_next_f32_bit_exact():
    """u32 -> f32 rounds as astype(float32) and the scale is the reference's
    f32 constant; the floats agree bit for bit."""
    s = _seeds(2)
    s_t, u_t = rng.next_f32(_t(s))
    s_j, u_j = jrng.next_f32(jnp.asarray(s))
    s_n, u_n = rng_np.next_f32(s)
    assert np.array_equal(_np(s_t), np.asarray(s_j))
    assert np.array_equal(u_t.numpy().view(np.int32), np.asarray(u_j).view(np.int32))
    assert np.array_equal(u_t.numpy().view(np.int32), u_n.view(np.int32))
    _, r_t = rng.next_f32_range(_t(s), -1.0, 1.0)
    _, r_j = jrng.next_f32_range(jnp.asarray(s), -1.0, 1.0)
    assert np.array_equal(r_t.numpy(), np.asarray(r_j))


@pytest.mark.parametrize("lo,hi", [(0, 7), (5, 1000), (2**32 - 3, 11)])
def test_next_u32_range_biased_wrap(lo, hi):
    """(rand + lo) % hi with the uint32 wrap of the add, kept for parity."""
    s = _seeds(3)
    s_t, r_t = rng.next_u32_range(_t(s), lo, hi)
    s_j, r_j = jrng.next_u32_range(jnp.asarray(s), lo, hi)
    _, r_n = rng_np.next_u32_range(s, lo, hi)
    assert np.array_equal(_np(s_t), np.asarray(s_j))
    assert np.array_equal(_np(r_t), np.asarray(r_j))
    assert np.array_equal(_np(r_t), r_n)


def test_masked_advance_bit_exact():
    s = _seeds(4)
    m = np.random.default_rng(4).random(N) < 0.5
    for name in ("next_f32_masked", "next_u32_masked"):
        s_t, v_t = getattr(rng, name)(_t(s), torch.from_numpy(m))
        s_j, v_j = getattr(jrng, name)(jnp.asarray(s), jnp.asarray(m))
        assert np.array_equal(_np(s_t), np.asarray(s_j))
        assert np.array_equal(_np(v_t), np.asarray(v_j))
    assert np.array_equal(_np(s_t)[~m], s[~m])


def _normals(n=N, seed=5):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:8] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
             [0, 0, 1], [0, 0, -1], [0.6, 0.8, 0], [0, 0.6, 0.8]]
    return v


def test_unit_disk_matches_jax():
    """Seeds exact (each lane redraws exactly as often), values within 1e-6."""
    s = _seeds(6)
    act = np.random.default_rng(6).random(N) < 0.8
    s_t, u_t, v_t = sampling.unit_disk(_t(s), torch.from_numpy(act))
    s_j, u_j, v_j = jsampling.unit_disk(jnp.asarray(s), jnp.asarray(act))
    assert np.array_equal(_np(s_t), np.asarray(s_j))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0, atol=1e-6)
    assert (u_t ** 2 + v_t ** 2 <= 1.0)[torch.from_numpy(act)].all()


def test_cosine_hemisphere_matches_jax():
    s = _seeds(7)
    nrm = _normals()
    act = np.random.default_rng(7).random(N) < 0.8
    s_t, d_t = sampling.cosine_hemisphere(_t(s), torch.from_numpy(nrm),
                                          torch.from_numpy(act))
    s_j, d_j = jsampling.cosine_hemisphere(jnp.asarray(s), jnp.asarray(nrm),
                                           jnp.asarray(act))
    assert np.array_equal(_np(s_t), np.asarray(s_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("fn", ["normalize", "reflect", "cross", "dot"])
def test_vecmath_matches_jax(fn):
    a = _normals(seed=8) * 3.0
    b = _normals(seed=9)
    args = (a,) if fn == "normalize" else (a, b)
    got = getattr(vecmath, fn)(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(getattr(jvec, fn)(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

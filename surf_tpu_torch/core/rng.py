"""Counter-free per-lane RNG: WangHash seeding + xorshift32 streams.

Bit-exact port of ``surf_tpu.core.rng``.  Torch has no full uint32
arithmetic and ``>>`` on int32 is arithmetic, so a seed is an int64 tensor
holding a value in [0, 2**32): every multiply, add and left shift is masked
back to 32 bits, and right shifts of non-negative int64 values are logical.
The int64 -> float32 conversion rounds to nearest-even, as uint32 ->
float32 does in ``astype(float32)``.

Masked variants advance only the lanes where the mask holds, so lanes that
do not take a branch consume no random numbers (the per-pixel stream parity
the oracle tests rely on).
"""

from __future__ import annotations

import numpy as np
import torch

# randomF32's scale (surf_math.cpp:9), rounded to float32 as the reference
# stores it; NOT 1/2^32 exactly.
U32_TO_FLOAT_SCALE = float(np.float32(2.3283064365387e-10))
MASK32 = 0xFFFFFFFF


def wang_hash(seed: torch.Tensor) -> torch.Tensor:
    """WangHash mix (surf_math.cpp:31-42). seed: int64 in [0, 2**32)."""
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = (seed * 9) & MASK32
    seed = seed ^ (seed >> 4)
    seed = (seed * 0x27D4EB2D) & MASK32
    return seed ^ (seed >> 15)


def init_seed(index: torch.Tensor) -> torch.Tensor:
    """initSeed (surf_math.cpp:44-47): wangHash((idx + 1) * 0x11)."""
    return wang_hash((((index + 1) & MASK32) * 0x11) & MASK32)


def pixel_seed(pixel_index: torch.Tensor, total_samples: int) -> torch.Tensor:
    """initSeed(pixelIdx + totalSamples * 1799) (renderer.cpp:169)."""
    off = (int(total_samples) * 1799) & MASK32
    return init_seed((pixel_index + off) & MASK32)


def xorshift32(seed: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step (surf_math.cpp:56-62)."""
    seed = seed ^ ((seed << 13) & MASK32)
    seed = seed ^ (seed >> 17)
    return seed ^ ((seed << 5) & MASK32)


def next_u32(seed: torch.Tensor):
    """Advance the stream; the new seed IS the random value."""
    s = xorshift32(seed)
    return s, s


def next_f32(seed: torch.Tensor):
    """randomF32 (surf_math.cpp:69-72): f32(u32) * 2.3283064365387e-10f."""
    s = xorshift32(seed)
    return s, s.to(torch.float32) * U32_TO_FLOAT_SCALE


def next_f32_range(seed: torch.Tensor, lo: float, hi: float):
    """randomRange for f32 (surf_math.cpp:81-85): u * (hi - lo) + lo."""
    s, u = next_f32(seed)
    span = float(np.float32(hi) - np.float32(lo))
    return s, u * span + float(np.float32(lo))


def next_u32_range(seed: torch.Tensor, lo: int, hi: int):
    """randomRange for U32 (surf_math.cpp:92-95): (rand + lo) % hi with the
    uint32 wrap of the add — slightly biased, kept for parity."""
    s, u = next_u32(seed)
    return s, ((u + lo) & MASK32) % hi


def next_f32_masked(seed: torch.Tensor, mask: torch.Tensor):
    s, u = next_f32(seed)
    return torch.where(mask, s, seed), u


def next_u32_masked(seed: torch.Tensor, mask: torch.Tensor):
    s, u = next_u32(seed)
    return torch.where(mask, s, seed), u


def next_f32_range_masked(seed: torch.Tensor, mask: torch.Tensor,
                          lo: float, hi: float):
    s, u = next_f32_range(seed, lo, hi)
    return torch.where(mask, s, seed), u

// The matrix-unit microbenchmarks (micro/mxu_tiles.py, micro/mxu_parts.py,
// micro/mxu_pltd.py): the Möller–Trumbore leaf test of 256 rays against
// tiles of 128 triangles as a matrix product on the tensor cores, with the
// test's division and compares as a fused epilogue.
//
// mxu_tiles{8,16}_{static,dyn} replace scripts/tpu_mxu_pallas_micro.py's
// kernel (`kernel` :42 inside `main` :33, `make(B, ntiles, dyn)` :83, its
// pl.pallas_call at :101); mxu_parts_<variant> replace
// scripts/tpu_mxu_pallas_micro2.py's (`epilogue` :39, `kernel` :57,
// `make(variant)` :102, call at :121); mxu_pltd replaces
// scripts/tpu_mxu_micro3.py's `pltd_kernel` (:73, `make_pltd` :105, call
// at :124).  A grid step p of the TPU kernels holds 256 rays' 8 features
// (rays [B, 256, 8]) and ntiles panels of 8 coefficients x 768 columns
// (rows [B, ntiles, 8, 768]); out = rays x panel is [256, 768], six blocks
// of 128 columns: den, num, b1, c1, b2, c2.  The epilogue forms t = num /
// den, u = b1 + t c1, v = b2 + t c2, the test |den| >= 1e-8, u >= 0,
// u <= 1, v >= 0, u + v <= 1, t >= 1e-8, t < tmax, and keeps per (ray,
// lane) the least t and its tile (a strictly smaller t wins: the first
// tile wins ties).  kStatic unrolls kTiles tiles; kDyn loops min(trips[p],
// kTiles) times at run time.  C2's parts: kStatic at 16 tiles (`full`);
// kDotOnly (bt = min(bt, den), bk stays -1); kEpiOnly (no product: the
// block value of ray r, column c is panel[r % 8][c], then the whole
// epilogue); kDotBf16 (kDotOnly with bf16 operands and f32 accumulation);
// kBigDot (the function of kDotOnly: on the TPU one [256, 16 x 768]
// product; the card's nearest mechanism is every tile's panel columns
// staged into shared memory by cp.async, all issued before the first
// product, then the products and the min from shared memory).  mxu_pltd
// is kStatic transposed: out^T = panel^T [768, 8] x rays [8, 256], the
// epilogue on [128, 256] (rays_t [B, 8, 256], tmax_t and the outputs
// [B, 128, 256]).
//
// Precision.  The TPU kernels' f32 dot is an exact float32 product.  One
// TF32 pass (10 mantissa bits) flips the best tile of some pairs and moves
// t by a third where den cancels (tests/test_torch_mxu_micro.py
// test_tf32_passes: 5 of 65,536 pairs); a 3xTF32 split computes what an
// exactly rounded f32 dot does, within its rounding: a_hi = cvt.rna.tf32(a),
// a_lo = cvt.rna.tf32(a - a_hi) for both operands, and three
// mma.sync.m16n8k8 TF32 products per fragment, the small terms first
// (lo x hi, hi x lo, then hi x hi; lo x lo is below f32's rounding).  The
// bf16 variant rounds both operands to bf16 (to nearest even) and issues
// one mma.sync.m16n8k16 bf16 per fragment with K padded from 8 to 16 by
// zeros (exact).  The tensor cores' float32 accumulation is not the plain
// version's separately rounded sum, so these kernels are held to their
// plain versions by gates (micro/_mxu.py MXU_GATE, BF16_GATE), not bit for
// bit; kEpiOnly has no product and is bit-identical (--fmad=false, IEEE
// division).
//
// Layout.  A grid step is 8 CTAs of 8 warps.  Rows layout: CTA (h, q)
// takes rays 128 h .. 128 h + 127 and lanes 32 q .. 32 q + 31; warp w the
// 16 rays 128 h + 16 w onward (one m16 tile of A = rays, loaded and split
// once) against 4 n8 tiles of lanes.  The m16n8 accumulator gives lane l
// rows l / 4 and l / 4 + 8 and columns 2 (l % 4) and 2 (l % 4) + 1, so the
// six products at the same 8-column offset in each of the six coefficient
// blocks (c, c + 128, ..., c + 640) leave den, num, b1, c1, b2 and c2 of
// the same 4 (ray, lane) pairs in the same registers of one thread: the
// epilogue needs no shuffle and no shared memory.  Each thread keeps 16
// running (t, tile) pairs.  The TPU's sequential grid becomes parallel
// CTAs; no state crosses a CTA.  mxu_pltd: CTA m takes lanes 16 m ..
// 16 m + 15 (one m16 tile of A = panel^T, the six blocks along M), warp w
// the rays 32 w .. 32 w + 31 (4 n8 tiles of B = rays, split once).
//
// Keeping the dead columns.  kDotOnly, kDotBf16 and kBigDot use only den;
// on the TPU the whole [256, 768] product is formed all the same, and its
// cost is what they measure.  Their other five blocks are added, tile by
// tile, into two running sums a thread (its rows g and g + 8: 2 adds a
// value) and written to chk [B, 256, 4]: chk[p, r, q] is the sum over
// tiles, blocks 1-5 and lanes 32 q .. 32 q + 31 of out[r, column], an
// output the scripts lack.  (Carrying the five blocks over the tiles in
// the products' C operand instead costs no add but 80 registers a thread:
// 202 in all, one CTA an SM, and dotonly ran 1.5x full's time; PERF.md §6.)
// chip_smoke.py counts the HMMA instructions of each kernel in its SASS.
//
// What bounds them: the products (3 x 2 x 256 x 8 x 768 TF32 FLOP a tile
// at 495 TFLOP/s), the epilogue (~18 FP32 operations a test at 67 TFLOP/s)
// or the bytes (rows, rays, tmax and the outputs once, at 3.35 TB/s),
// whichever is larger; at these shapes the bytes and the products are
// close (PERF.md §6).  The design is a simple, correct one: mma.sync from
// registers, the panel read through L1 (8 warps of a CTA read the same
// columns), no wgmma, no TMA, no software pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr int kR = 256;          // rays of a grid step
constexpr int kNt = 128;         // triangles (lanes) of a tile
constexpr int kCols = 6 * kNt;   // a panel's columns: six coefficient blocks
constexpr int kK = 8;            // the product's depth
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCtas = 8;         // CTAs a grid step
constexpr float kEps = 1e-8f;
// kBigDot's shared memory: per (tile, k) row the CTA's 32 lanes of each of
// the six blocks, padded by 8 floats so that the B fragment's 32 loads
// (k = l % 4 or + 4, column l / 4) fall in 32 banks.
constexpr int kSmemRow = 6 * 32 + 8;
constexpr int kBigTiles = 16;
constexpr int kBigSmem = kBigTiles * kK * kSmemRow * 4;

// Fixed values: chip_smoke.py's MXU_SASS finds each entry point's SASS
// by the mangled name of mxu_kernel<mode, tiles>, which holds them.
enum Mode { kStatic = 0, kDyn = 1, kDotOnly = 2, kEpiOnly = 3, kDotBf16 = 4, kBigDot = 5 };

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 relative, each a TF32 value.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: lo x hi, hi x lo, hi x hi.
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                     unsigned bl0, unsigned bl1) {
  mma_tf32(d, al[0], al[1], al[2], al[3], bh0, bh1);
  mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bl0, bl1);
  mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bh0, bh1);
}

// d += a b, bf16 operands, K = 16 of which 8..15 are zero.
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(0u), "r"(0u), "r"(b0), "r"(0u));
}

// Two floats rounded to bf16 (to nearest even), the first in the low half.
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// The scripts' epilogue of one (ray, lane) pair of tile kt, in their order.
__device__ __forceinline__ void epilogue(float den, float num, float b1, float c1, float b2,
                                         float c2, float tmax, int kt, float& bt, int& bk) {
  const float t = __fdiv_rn(num, den);
  const float u = b1 + t * c1;
  const float v = b2 + t * c2;
  const bool ok = (fabsf(den) >= kEps) & (u >= 0.0f) & (u <= 1.0f) & (v >= 0.0f) &
                  (u + v <= 1.0f) & (t >= kEps) & (t < tmax);
  const float tc = ok ? t : __int_as_float(0x7f800000);
  const bool w = tc < bt;
  bt = w ? tc : bt;
  bk = w ? kt : bk;
}

// A warp's rays (rows layout): 16 rays x 8 features as a TF32 m16k8 A
// fragment split hi / lo, or as bf16 pairs (k = 2 (l % 4), + 1).
struct RayFrag {
  unsigned hi[4], lo[4];
  unsigned bf[2];
};

// One tile of the rows layout for one warp: 4 n8 tiles x 6 blocks of
// products (none for kEpiOnly), then the epilogue or the min.  The panel's
// element (k, block, column c of the warp's 32) is at
// pan[k * row_stride + block * blk_stride + c], in global memory or, for
// kBigDot, in shared memory (plain loads: no __ldg).
template <int kMode>
__device__ __forceinline__ void rows_tile(const float* __restrict__ pan, int row_stride,
                                          int blk_stride, int g, int t, const RayFrag& a,
                                          const float (&tm)[4][4], float (&bt)[4][4],
                                          int (&bk)[4][4], float (&dead)[2], int kt) {
  constexpr bool kDead = kMode == kDotOnly || kMode == kDotBf16 || kMode == kBigDot;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float acc[6][4];
#pragma unroll
    for (int blk = 0; blk < 6; ++blk) {
      const float* col = pan + blk * blk_stride + 8 * j;
      if constexpr (kMode == kEpiOnly) {
        // out[r, c] = panel[r % 8, c]: rows g and g + 8 both read panel row g.
        const float2 v = *reinterpret_cast<const float2*>(col + g * row_stride + 2 * t);
        acc[blk][0] = acc[blk][2] = v.x;
        acc[blk][1] = acc[blk][3] = v.y;
      } else {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if constexpr (kMode == kDotBf16) {
          mma_bf16(d, a.bf[0], a.bf[1],
                   bf16x2(col[2 * t * row_stride + g], col[(2 * t + 1) * row_stride + g]));
        } else {
          unsigned bh0, bl0, bh1, bl1;
          split(col[t * row_stride + g], bh0, bl0);
          split(col[(t + 4) * row_stride + g], bh1, bl1);
          mma3(d, a.hi, a.lo, bh0, bh1, bl0, bl1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[blk][e] = d[e];
        if (kDead && blk > 0) {
          dead[0] += d[0] + d[1];
          dead[1] += d[2] + d[3];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kDead) {
        bt[j][e] = surf::nan_min(bt[j][e], acc[0][e]);
      } else {
        epilogue(acc[0][e], acc[1][e], acc[2][e], acc[3][e], acc[4][e], acc[5][e], tm[j][e], kt,
                 bt[j][e], bk[j][e]);
      }
    }
  }
}

// C1 (kStatic, kDyn) and C2: grid step p = blockIdx.x / 8.
template <int kMode, int kTiles>
__global__ void __launch_bounds__(kThreads)
    mxu_kernel(const int* __restrict__ trips, const float* __restrict__ rays,
               const float* __restrict__ rows, const float* __restrict__ tmax,
               float* __restrict__ t_out, int* __restrict__ k_out, float* __restrict__ chk) {
  constexpr bool kDead = kMode == kDotOnly || kMode == kDotBf16 || kMode == kBigDot;
  const int p = blockIdx.x / kCtas, cta = blockIdx.x % kCtas;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q = cta % 4, l0 = 32 * q;
  const int r0 = (cta / 4) * 128 + (threadIdx.x / 32) * 16;
  const float* ray = rays + (static_cast<size_t>(p) * kR + r0) * kK;
  const float* pan = rows + static_cast<size_t>(p) * kTiles * kK * kCols;

  RayFrag a;
  if constexpr (kMode == kDotBf16) {
    a.bf[0] = bf16x2(ray[g * kK + 2 * t], ray[g * kK + 2 * t + 1]);
    a.bf[1] = bf16x2(ray[(g + 8) * kK + 2 * t], ray[(g + 8) * kK + 2 * t + 1]);
  } else if constexpr (kMode != kEpiOnly) {
    split(ray[g * kK + t], a.hi[0], a.lo[0]);
    split(ray[(g + 8) * kK + t], a.hi[1], a.lo[1]);
    split(ray[g * kK + t + 4], a.hi[2], a.lo[2]);
    split(ray[(g + 8) * kK + t + 4], a.hi[3], a.lo[3]);
  }
  // Pair (j, e): ray r0 + g + 8 (e >> 1), lane l0 + 8 j + 2 t + (e & 1).
  const size_t out0 = (static_cast<size_t>(p) * kR + r0 + g) * kNt + l0 + 2 * t;
  float tm[4][4], bt[4][4], dead[2] = {0.0f, 0.0f};
  int bk[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      tm[j][e] = kDead ? 0.0f : tmax[out0 + (e >> 1) * 8 * kNt + 8 * j + (e & 1)];
      bt[j][e] = __int_as_float(0x7f800000);
      bk[j][e] = -1;
    }
  }

  if constexpr (kMode == kBigDot) {
    extern __shared__ float4 smem4[];
    float* sp = reinterpret_cast<float*>(smem4);
    constexpr int kChunks = kTiles * kK * 6 * 8;  // 16-byte pieces of the CTA's columns
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int part = c % 8, blk = (c / 8) % 6, row = c / 48;  // row = kt * 8 + k
      cp_async16(sp + row * kSmemRow + blk * 32 + 4 * part,
                 pan + static_cast<size_t>(row) * kCols + blk * kNt + l0 + 4 * part);
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
#pragma unroll
    for (int kt = 0; kt < kTiles; ++kt) {
      rows_tile<kMode>(sp + kt * kK * kSmemRow, kSmemRow, 32, g, t, a, tm, bt, bk, dead, kt);
    }
  } else if constexpr (kMode == kDyn) {
    const int trip = min(trips[p], kTiles);
    for (int kt = 0; kt < trip; ++kt) {
      rows_tile<kMode>(pan + static_cast<size_t>(kt) * kK * kCols + l0, kCols, kNt, g, t, a, tm,
                       bt, bk, dead, kt);
    }
  } else {
#pragma unroll
    for (int kt = 0; kt < kTiles; ++kt) {
      rows_tile<kMode>(pan + static_cast<size_t>(kt) * kK * kCols + l0, kCols, kNt, g, t, a, tm,
                       bt, bk, dead, kt);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t o = out0 + h * 8 * kNt + 8 * j;
      *reinterpret_cast<float2*>(t_out + o) = make_float2(bt[j][2 * h], bt[j][2 * h + 1]);
      *reinterpret_cast<int2*>(k_out + o) = make_int2(bk[j][2 * h], bk[j][2 * h + 1]);
    }
  }
  if constexpr (kDead) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dead[h] += __shfl_xor_sync(0xffffffffu, dead[h], 1);
      dead[h] += __shfl_xor_sync(0xffffffffu, dead[h], 2);
      if (t == 0) chk[(static_cast<size_t>(p) * kR + r0 + g + 8 * h) * 4 + q] = dead[h];
    }
  }
}

// C3: out^T = panel^T x rays; grid step p = blockIdx.x / 8, CTA m of it
// the lanes 16 m .. 16 m + 15, warp w the rays 32 w .. 32 w + 31.
template <int kTiles>
__global__ void __launch_bounds__(kThreads)
    mxu_pltd_kernel(const float* __restrict__ rays_t, const float* __restrict__ rows,
                    const float* __restrict__ tmax_t, float* __restrict__ t_out,
                    int* __restrict__ k_out) {
  const int p = blockIdx.x / kCtas, m0 = 16 * (blockIdx.x % kCtas);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n0 = (threadIdx.x / 32) * 32;
  const float* ray = rays_t + static_cast<size_t>(p) * kK * kR;
  unsigned bh[4][2], bl[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(ray[t * kR + n0 + 8 * j + g], bh[j][0], bl[j][0]);
    split(ray[(t + 4) * kR + n0 + 8 * j + g], bh[j][1], bl[j][1]);
  }
  // Pair (j, e): lane m0 + g + 8 (e >> 1), ray n0 + 8 j + 2 t + (e & 1).
  const size_t out0 = (static_cast<size_t>(p) * kNt + m0 + g) * kR + n0 + 2 * t;
  float tm[4][4], bt[4][4];
  int bk[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      tm[j][e] = tmax_t[out0 + (e >> 1) * 8 * kR + 8 * j + (e & 1)];
      bt[j][e] = __int_as_float(0x7f800000);
      bk[j][e] = -1;
    }
  }
#pragma unroll
  for (int kt = 0; kt < kTiles; ++kt) {
    const float* pan = rows + (static_cast<size_t>(p) * kTiles + kt) * kK * kCols + m0;
    unsigned ah[6][4], al[6][4];
#pragma unroll
    for (int blk = 0; blk < 6; ++blk) {
      const float* col = pan + blk * kNt;
      split(__ldg(col + t * kCols + g), ah[blk][0], al[blk][0]);
      split(__ldg(col + t * kCols + g + 8), ah[blk][1], al[blk][1]);
      split(__ldg(col + (t + 4) * kCols + g), ah[blk][2], al[blk][2]);
      split(__ldg(col + (t + 4) * kCols + g + 8), ah[blk][3], al[blk][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc[6][4];
#pragma unroll
      for (int blk = 0; blk < 6; ++blk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[blk][e] = 0.0f;
        mma3(acc[blk], ah[blk], al[blk], bh[j][0], bh[j][1], bl[j][0], bl[j][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        epilogue(acc[0][e], acc[1][e], acc[2][e], acc[3][e], acc[4][e], acc[5][e], tm[j][e], kt,
                 bt[j][e], bk[j][e]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t o = out0 + h * 8 * kR + 8 * j;
      *reinterpret_cast<float2*>(t_out + o) = make_float2(bt[j][2 * h], bt[j][2 * h + 1]);
      *reinterpret_cast<int2*>(k_out + o) = make_int2(bk[j][2 * h], bk[j][2 * h + 1]);
    }
  }
}

template <int kMode, int kTiles>
int launch_rows(const int* trips, const float* rays, const float* rows, const float* tmax,
                int n_blocks, float* t, int* k, float* chk, cudaStream_t cs) {
  int smem = 0;
  if constexpr (kMode == kBigDot) {
    static_assert(kTiles == kBigTiles, "kBigDot's shared memory holds 16 tiles");
    smem = kBigSmem;
    const cudaError_t e = cudaFuncSetAttribute(
        mxu_kernel<kMode, kTiles>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mxu_kernel<kMode, kTiles><<<n_blocks * kCtas, kThreads, smem, cs>>>(trips, rays, rows, tmax, t,
                                                                       k, chk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rows layout's entry points: (trips or NULL, rays, rows, tmax,
// n_blocks, t, k, chk or NULL, stream); mxu_pltd: (rays_t, rows, tmax_t,
// n_blocks, t, k, stream).  Each returns cudaGetLastError() after the
// launch.
#define SURF_MXU_ENTRY(NAME, MODE, TILES)                                                   \
  extern "C" int NAME(const int* trips, const float* rays, const float* rows,              \
                      const float* tmax, int n_blocks, float* t, int* k, float* chk,       \
                      cudaStream_t cs) {                                                   \
    return launch_rows<MODE, TILES>(trips, rays, rows, tmax, n_blocks, t, k, chk, cs);     \
  }

SURF_MXU_ENTRY(mxu_tiles8_static, kStatic, 8)
SURF_MXU_ENTRY(mxu_tiles8_dyn, kDyn, 8)
SURF_MXU_ENTRY(mxu_tiles16_static, kStatic, 16)
SURF_MXU_ENTRY(mxu_tiles16_dyn, kDyn, 16)
SURF_MXU_ENTRY(mxu_parts_full, kStatic, 16)
SURF_MXU_ENTRY(mxu_parts_dotonly, kDotOnly, 16)
SURF_MXU_ENTRY(mxu_parts_epionly, kEpiOnly, 16)
SURF_MXU_ENTRY(mxu_parts_dotbf16, kDotBf16, 16)
SURF_MXU_ENTRY(mxu_parts_bigdot, kBigDot, 16)

extern "C" int mxu_pltd(const float* rays_t, const float* rows, const float* tmax_t,
                        int n_blocks, float* t, int* k, cudaStream_t cs) {
  mxu_pltd_kernel<16><<<n_blocks * kCtas, kThreads, 0, cs>>>(rays_t, rows, tmax_t, t, k);
  return static_cast<int>(cudaGetLastError());
}

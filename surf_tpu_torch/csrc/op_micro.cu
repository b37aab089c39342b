// The op-cost microbenchmarks (micro/lane_splat.py, micro/lane_extract.py,
// micro/walk_interleave.py, micro/spec_visit.py): what one operation of a
// walk's visit costs on the card.
//
// lane_splat_* replaces scripts/tpu_splat_micro.py's kernel (`make_kernel`
// :26, the six splats :42-67, its pl.pallas_call at :85).  All six compute
// one function, tpu_visit_micro.py's `base` (shape_micro.cu kBase): visit i
// reads lanes 0-8 of row i % n_rows and runs the chain r = r + f * x',
// x' = (r > f ? x' : r) from r = acc, x' = x.  The TPU's ways of splatting
// a lane over the (8, 128) tile have no counterpart here; each entry point
// takes one of the card's ways of handing one value of a row to every
// thread (Splat):
//   kScalarExtract  a plain load with a warp-uniform address (LDG.E);
//   kBcast          the read-only path, __ldg (LDG.E.CONSTANT);
//   kRepSlice       lanes 0-8 staged in shared memory once a visit behind
//                   one block barrier, then an LDS broadcast;
//   kConcatSlice    one shared copy per warp behind __syncwarp, no block
//                   barrier;
//   kRepeatPrim     lanes 0-8 spread over a warp's lanes, then
//                   __shfl_sync(v, j);
//   kRollLane0      the TPU's rotate-then-lane-0: __shfl_down_sync by j,
//                   then a shuffle from lane 0.
// The staged copies are double-buffered by the visit's parity, so one
// barrier (or __syncwarp) a visit orders both the copy's writes before its
// reads and the reads before the next write to that buffer.
//
// lane_extract_e<NE>_v<NV> replaces scripts/tpu_extract_micro.py's kernel
// (`make` :26, its call at :65): visits in blocks of 16 from cursor 3 while
// the visit counter < iters; a visit at cursor i reads lanes 0..NE-1 of row
// i % n_rows (as float4 loads) and runs r = r + f * x for each, then NV
// links r = r * 0.9999 + x; the vote "some value's r > x" moves the cursor
// by 1, else by 2.
//
// walk_interleave_* replaces scripts/tpu_interleave_micro.py's kernels
// (`make_interleaved` :39, `make_roll_tput` :71, its call at :96).
// walk_interleave_kernel<N>: N independent walks in one loop of iters
// steps; walk b starts at cursor 7 b with acc = x (b + 1), and each step
// runs visit_math (the chain above) on row idx_b % n_rows and moves idx_b
// by 1 if its vote "some value's r > x" is set, else by 2; o = the walks'
// accs summed in order.  The N votes of a step go into one N-bit block OR
// (vote.cuh): one barrier a step whatever N, the card's answer to "does
// interleaving hide the vote's drain".  roll_tput_kernel: visit i reads
// lane (l + 16 (i & 7)) mod 128 of row i % n_rows for lane l (the TPU's
// roll by -16 (i & 7), an indexed read here, as shape_micro.cu's kRoll)
// and adds it times x[l] to acc[l]; value e of o is acc[e mod 128].  No
// vote.
//
// spec_visit_* replaces scripts/tpu_spec_micro.py's kernels (`make_cur`
// :99, `make(w)` :199, `eval_row` :35, its call at :270): the stream walk's
// visit over rows_total rows in bodies of 32 visits, while the cursor p <
// rows_total.  A row holds 8 boxes (lanes 16k + 0..5) and 8 Möller–Trumbore
// records (lanes 16k + 0..8) over the same lanes, int32 lane 9 its leaf
// flag (== 1) and lane 10 its skip.  W = 0 (cur) is one row a visit: the
// slab test of its boxes against the visit-start best_t votes on
// "descend", the records of a leaf row (p < rows_total) update the best
// in order, and p moves to p + 1 on a leaf or a descend, else to
// max(skip, p + 1), and stays at rows_total once there.  W = 1..6 is
// `make(W)`: rows (base + w) % n_rows, base = p < rows_total ? p : 0,
// each tested against the visit-start best (records of every row, leaf or
// not), their W votes one W-bit block OR, then the scalar resolution: a
// row is on the path while the cursor built so far equals its index,
// an off-path row's t is penalised by 1e30, and p = max(nxt, p + 1).  So
// rows past rows_total are read where W does not divide it, and a body's
// visits after the end re-test rows 0..W-1 (the script's code, followed
// here).  Outputs t = best_t, r = best_r + visits (the script's checksum
// fold) and (end cursor, visits).
//
// What bounds them: latency, by design.  A visit's work (1024 values x a
// chain, or 1024 rays x 16 tests a row) is far below the card's rate and
// the 256 KB table stays in L1 and L2; each visit waits for its row's load
// and, where it votes, for a barrier.  Design: shape_micro.cu's: one
// 512-thread block for the (8, 128) packet, 2 values a thread (value
// r * 512 + thread), the cursors and loop counters block-uniform.
// Semantics as the TPU kernels: NaN-propagating min/max, IEEE divisions
// with denormals kept (no -ftz), and --fmad=false so that every multiply
// and add rounds on its own, as the plain PyTorch versions' ops do.

#include <cuda_runtime.h>

#include "entry.cuh"
#include "mt.cuh"
#include "vote.cuh"

namespace {

constexpr int kLane = 128;     // floats per table row
constexpr int kRec = 16;       // floats per record
constexpr int kThreads = 512;  // one block: the packet
constexpr int kWarps = kThreads / 32;
constexpr int kRays = 2;       // values per thread: 1024 in all
constexpr int kLinks = 9;      // lanes of a chain
constexpr int kBlock = 16;     // lane_extract's visits between tests of the counter
constexpr int kStart = 3;      // lane_extract's first cursor
constexpr int kSpecBody = 32;  // spec_visit's visits between tests of the cursor
constexpr int kLeafLane = 9, kSkipLane = 10;
constexpr float kFar = 1e30f;

__device__ __forceinline__ const float* row_at(const float* table, int r) {
  return table + static_cast<size_t>(r) * kLane;
}

__device__ __forceinline__ int lane_int(const float* row, int lane) {
  return __float_as_int(__ldg(row + lane));
}

// A plain global load (ld.global: LDG.E, not the read-only path).
__device__ __forceinline__ float ld_plain(const float* p) {
  float v;
  asm("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// tpu_visit_micro.py visit_math (:29-35) over the links f: r (acc on
// entry), x' restarting from x.
__device__ __forceinline__ void chain(const float (&f)[kLinks], const float* x, float* r) {
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    float a = r[k], xx = x[k];
#pragma unroll
    for (int j = 0; j < kLinks; ++j) {
      a = a + f[j] * xx;
      xx = a > f[j] ? xx : a;
    }
    r[k] = a;
  }
}

__device__ __forceinline__ void load_x(const float* __restrict__ x_in, float* x) {
#pragma unroll
  for (int k = 0; k < kRays; ++k) x[k] = x_in[k * kThreads + threadIdx.x];
}

__device__ __forceinline__ void store_o(float* __restrict__ o_out, const float* acc) {
#pragma unroll
  for (int k = 0; k < kRays; ++k) o_out[k * kThreads + threadIdx.x] = acc[k];
}

__device__ __forceinline__ bool any_above(const float* r, const float* x) {
  int hot = 0;
#pragma unroll
  for (int k = 0; k < kRays; ++k) hot |= r[k] > x[k];
  return __syncthreads_or(hot) != 0;
}

// ---------------------------------------------------------------------------
// lane_splat (tpu_splat_micro.py)
// ---------------------------------------------------------------------------

enum Splat { kScalarExtract, kBcast, kRepSlice, kConcatSlice, kRepeatPrim, kRollLane0 };

template <int S>
__global__ void __launch_bounds__(kThreads)
lane_splat_kernel(const float* table, int n_rows, const float* __restrict__ x_in, int iters,
                  float* __restrict__ o_out, int* __restrict__ state_out) {
  __shared__ float s_block[2][kLinks];          // kRepSlice
  __shared__ float s_warp[kWarps][2][kLinks];   // kConcatSlice
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float x[kRays], acc[kRays];
  load_x(x_in, x);
#pragma unroll
  for (int k = 0; k < kRays; ++k) acc[k] = x[k] * 0.0f;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    const float* row = row_at(table, i % n_rows);
    const int buf = i & 1;
    float f[kLinks];
    if constexpr (S == kScalarExtract) {
#pragma unroll
      for (int j = 0; j < kLinks; ++j) f[j] = ld_plain(row + j);
    } else if constexpr (S == kBcast) {
#pragma unroll
      for (int j = 0; j < kLinks; ++j) f[j] = __ldg(row + j);
    } else if constexpr (S == kRepSlice) {
      if (threadIdx.x < kLinks) s_block[buf][threadIdx.x] = __ldg(row + threadIdx.x);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kLinks; ++j) f[j] = s_block[buf][j];
    } else if constexpr (S == kConcatSlice) {
      if (lane < kLinks) s_warp[warp][buf][lane] = __ldg(row + lane);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kLinks; ++j) f[j] = s_warp[warp][buf][j];
    } else {
      const float v = lane < kLinks ? __ldg(row + lane) : 0.0f;
#pragma unroll
      for (int j = 0; j < kLinks; ++j) {
        if constexpr (S == kRepeatPrim) {
          f[j] = __shfl_sync(0xffffffffu, v, j);
        } else {
          f[j] = __shfl_sync(0xffffffffu, __shfl_down_sync(0xffffffffu, v, j), 0);
        }
      }
    }
    chain(f, x, acc);
  }
  store_o(o_out, acc);
  if (threadIdx.x == 0) {
    state_out[0] = iters;
    state_out[1] = 0;
  }
}

// ---------------------------------------------------------------------------
// lane_extract (tpu_extract_micro.py)
// ---------------------------------------------------------------------------

template <int NE, int NV>
__global__ void __launch_bounds__(kThreads)
lane_extract_kernel(const float* __restrict__ table, int n_rows, const float* __restrict__ x_in,
                    int iters, float* __restrict__ o_out, int* __restrict__ state_out) {
  static_assert(NE % 4 == 0, "lanes are read as float4");
  float x[kRays], acc[kRays];
  load_x(x_in, x);
#pragma unroll
  for (int k = 0; k < kRays; ++k) acc[k] = x[k] * 0.0f;
  int it = 0, i = kStart, votes = 0;
  while (it < iters) {
#pragma unroll 1
    for (int v = 0; v < kBlock; ++v) {
      const float4* row = reinterpret_cast<const float4*>(row_at(table, i % n_rows));
#pragma unroll
      for (int q = 0; q < NE / 4; ++q) {
        const float4 f4 = __ldg(row + q);
        const float f[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int k = 0; k < kRays; ++k) acc[k] = acc[k] + f[e] * x[k];
        }
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
#pragma unroll
        for (int k = 0; k < kRays; ++k) acc[k] = acc[k] * 0.9999f + x[k];
      }
      const bool vote = any_above(acc, x);
      votes += vote ? 1 : 0;
      i = vote ? i + 1 : i + 2;
    }
    it += kBlock;
  }
  store_o(o_out, acc);
  if (threadIdx.x == 0) {
    state_out[0] = i;
    state_out[1] = votes;
  }
}

// ---------------------------------------------------------------------------
// walk_interleave (tpu_interleave_micro.py)
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(kThreads)
walk_interleave_kernel(const float* __restrict__ table, int n_rows,
                       const float* __restrict__ x_in, int iters, float* __restrict__ o_out,
                       int* __restrict__ state_out) {
  static_assert(N <= 32, "one bit a walk");
  __shared__ unsigned slots[3];
  if (threadIdx.x < 3) slots[threadIdx.x] = 0u;
  __syncthreads();
  float x[kRays], acc[N][kRays];
  int idx[N], votes[N];
  load_x(x_in, x);
#pragma unroll
  for (int b = 0; b < N; ++b) {
    idx[b] = 7 * b;
    votes[b] = 0;
#pragma unroll
    for (int k = 0; k < kRays; ++k) acc[b][k] = x[k] * static_cast<float>(b + 1);
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    unsigned bits = 0u;
#pragma unroll
    for (int b = 0; b < N; ++b) {
      const float* row = row_at(table, idx[b] % n_rows);
      float f[kLinks];
#pragma unroll
      for (int j = 0; j < kLinks; ++j) f[j] = __ldg(row + j);
      chain(f, x, acc[b]);
#pragma unroll
      for (int k = 0; k < kRays; ++k) bits |= static_cast<unsigned>(acc[b][k] > x[k]) << b;
    }
    bits = surf::block_or(bits, slots, it);
#pragma unroll
    for (int b = 0; b < N; ++b) {
      const bool vote = (bits >> b) & 1u;
      votes[b] += vote ? 1 : 0;
      idx[b] = vote ? idx[b] + 1 : idx[b] + 2;
    }
  }
  float o[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) o[k] = acc[0][k];
#pragma unroll
  for (int b = 1; b < N; ++b) {
#pragma unroll
    for (int k = 0; k < kRays; ++k) o[k] = o[k] + acc[b][k];
  }
  store_o(o_out, o);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < N; ++b) {
      state_out[2 * b] = idx[b];
      state_out[2 * b + 1] = votes[b];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
roll_tput_kernel(const float* __restrict__ table, int n_rows, const float* __restrict__ x_in,
                 int iters, float* __restrict__ o_out, int* __restrict__ state_out) {
  const int l = threadIdx.x & (kLane - 1);  // both values of a thread lie on lane l
  const float x0 = x_in[l];
  float acc = x0 * 0.0f;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    const float f = __ldg(row_at(table, i % n_rows) + ((l + 16 * (i & 7)) & (kLane - 1)));
    acc = acc + f * x0;
  }
  const float o[kRays] = {acc, acc};
  store_o(o_out, o);
  if (threadIdx.x == 0) {
    state_out[0] = iters;
    state_out[1] = 0;
  }
}

// ---------------------------------------------------------------------------
// spec_visit (tpu_spec_micro.py)
// ---------------------------------------------------------------------------

struct SpecRays {
  float ox[kRays], oy[kRays], oz[kRays];
  float dx[kRays], dy[kRays], dz[kRays];
  float ix[kRays], iy[kRays], iz[kRays];
  float bt[kRays];
  int br[kRays];

  __device__ __forceinline__ void load(const float* __restrict__ rays) {
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int g = k * kThreads + threadIdx.x;
      const int n = kRays * kThreads;
      ox[k] = rays[g];
      oy[k] = rays[n + g];
      oz[k] = rays[2 * n + g];
      dx[k] = rays[3 * n + g];
      dy[k] = rays[4 * n + g];
      dz[k] = rays[5 * n + g];
      ix[k] = 1.0f / dx[k];
      iy[k] = 1.0f / dy[k];
      iz[k] = 1.0f / dz[k];
      bt[k] = kFar;
      br[k] = -1;
    }
  }

  // eval_row's slab half (tpu_spec_micro.py:44-65): some box of the row hit
  // by one of this thread's rays, against the visit-start best bt.
  __device__ __forceinline__ bool boxes(const float* row) const {
    bool anyh = false;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float* b = row + kRec * c;
      const float l0 = __ldg(b), l1 = __ldg(b + 1), l2 = __ldg(b + 2);
      const float h0 = __ldg(b + 3), h1 = __ldg(b + 4), h2 = __ldg(b + 5);
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        anyh |= surf::slab_hit(ox[k], oy[k], oz[k], ix[k], iy[k], iz[k], bt[k], l0, l1, l2, h0,
                               h1, h2);
      }
    }
    return anyh;
  }

  // The row's 8 records in order, each taking (t, rec) where it hits with
  // t below lim[k] and below the t taken so far.
  __device__ __forceinline__ void records(const float* row, int rec0, const float* lim, float* t_w,
                                          int* r_w) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* c = row + kRec * j;
      const float v0x = __ldg(c), v0y = __ldg(c + 1), v0z = __ldg(c + 2);
      const float e1x = __ldg(c + 3), e1y = __ldg(c + 4), e1z = __ldg(c + 5);
      const float e2x = __ldg(c + 6), e2y = __ldg(c + 7), e2z = __ldg(c + 8);
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        float t, u, v;
        const float below = t_w[k] < lim[k] ? t_w[k] : lim[k];
        if (surf::mt_hit(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, ox[k], oy[k], oz[k], dx[k],
                         dy[k], dz[k], below, t, u, v)) {
          t_w[k] = t;
          r_w[k] = rec0 + j;
        }
      }
    }
  }
};

// W == 0: make_cur; W = 1..6: make(W).
template <int W>
__global__ void __launch_bounds__(kThreads)
spec_visit_kernel(const float* __restrict__ table, int n_rows, const float* __restrict__ rays,
                  int rows_total, float* __restrict__ t_out, int* __restrict__ r_out,
                  int* __restrict__ state_out) {
  __shared__ unsigned slots[3];
  if (threadIdx.x < 3) slots[threadIdx.x] = 0u;
  __syncthreads();
  SpecRays R;
  R.load(rays);
  int p = 0, it = 0;
  while (p < rows_total) {
#pragma unroll 1
    for (int v = 0; v < kSpecBody; ++v) {
      if constexpr (W == 0) {
        const bool valid = p < rows_total;
        const int pc = (valid ? p : 0) % n_rows;
        const float* row = row_at(table, pc);
        const bool leaf = lane_int(row, kLeafLane) == 1;
        const int skip = lane_int(row, kSkipLane);
        const bool anyh = R.boxes(row);  // against the visit-start best
        if (leaf && valid) {
          float lim[kRays];
#pragma unroll
          for (int k = 0; k < kRays; ++k) lim[k] = kFar;  // t_w = bt bounds the hits
          R.records(row, pc * 8, lim, R.bt, R.br);
        }
        const bool descend = __syncthreads_or(anyh) != 0;
        const int nxt = leaf || descend ? p + 1 : max(skip, p + 1);
        p = valid ? nxt : p;
      } else {
        const int base = p < rows_total ? p : 0;
        float t_w[W][kRays];
        int r_w[W][kRays];
        bool leaf[W];
        int skip[W];
        unsigned bits = 0u;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int pcw = (base + w) % n_rows;
          const float* row = row_at(table, pcw);
          leaf[w] = lane_int(row, kLeafLane) == 1;
          skip[w] = lane_int(row, kSkipLane);
          bits |= static_cast<unsigned>(R.boxes(row)) << w;
#pragma unroll
          for (int k = 0; k < kRays; ++k) {
            t_w[w][k] = kFar;
            r_w[w][k] = -1;
          }
          R.records(row, pcw * 8, R.bt, t_w[w], r_w[w]);
        }
        bits = surf::block_or(bits, slots, it);
        int nxt = base;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const bool on = nxt == base + w;
          const bool desc = (bits >> w) & 1u;
          const int step = leaf[w] || desc ? base + w + 1 : max(skip[w], base + w + 1);
          nxt = on ? step : nxt;
          const float pen = on ? 0.0f : kFar;
#pragma unroll
          for (int k = 0; k < kRays; ++k) {
            const float t_eff = t_w[w][k] + pen;
            if (t_eff < R.bt[k]) {
              R.bt[k] = t_eff;
              R.br[k] = r_w[w][k];
            }
          }
        }
        p = max(nxt, p + 1);
      }
      ++it;
    }
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    t_out[k * kThreads + threadIdx.x] = R.bt[k];
    r_out[k * kThreads + threadIdx.x] = R.br[k] + it;
  }
  if (threadIdx.x == 0) {
    state_out[0] = p;
    state_out[1] = it;
  }
}

}  // namespace

// The device name of the kernel behind a handle of SURF_KERNEL_OF
// (entry.cuh); cudaFuncGetName's error code.
extern "C" int surf_kernel_name(const void* kernel, const char** name) {
  return static_cast<int>(cudaFuncGetName(name, kernel));
}

// Plain C entry points for ctypes; each returns cudaGetLastError() after its
// launch.  lane_splat, lane_extract, walk_interleave: table [n_rows, 128]
// f32 (16-byte aligned), x [1024], iters > 0, o [1024], state = (end
// cursor, votes set) a walk ([2] each; walk_interleave [2 N]).  spec_visit:
// table (int32 lanes 9, 10 the leaf flag and skip), rays [6, 1024] (ox, oy,
// oz, dx, dy, dz), rows_total > 0, t [1024], r [1024] int32, state [2] =
// (end cursor, visits).
#define SURF_OP_ENTRY(NAME, ...)                                                             \
  extern "C" int NAME(const float* table, int n_rows, const float* x, int iters, float* o,   \
                      int* state, cudaStream_t cs) {                                         \
    __VA_ARGS__<<<1, kThreads, 0, cs>>>(table, n_rows, x, iters, o, state);                  \
    return static_cast<int>(cudaGetLastError());                                             \
  }                                                                                          \
  SURF_KERNEL_OF(NAME, __VA_ARGS__)

SURF_OP_ENTRY(lane_splat_scalar_extract, lane_splat_kernel<kScalarExtract>)
SURF_OP_ENTRY(lane_splat_bcast_1x128, lane_splat_kernel<kBcast>)
SURF_OP_ENTRY(lane_splat_rep_then_slice, lane_splat_kernel<kRepSlice>)
SURF_OP_ENTRY(lane_splat_concat_then_slice, lane_splat_kernel<kConcatSlice>)
SURF_OP_ENTRY(lane_splat_repeat_prim, lane_splat_kernel<kRepeatPrim>)
SURF_OP_ENTRY(lane_splat_roll_lane0, lane_splat_kernel<kRollLane0>)

SURF_OP_ENTRY(lane_extract_e8_v0, lane_extract_kernel<8, 0>)
SURF_OP_ENTRY(lane_extract_e32_v0, lane_extract_kernel<32, 0>)
SURF_OP_ENTRY(lane_extract_e64_v0, lane_extract_kernel<64, 0>)
SURF_OP_ENTRY(lane_extract_e128_v0, lane_extract_kernel<128, 0>)
SURF_OP_ENTRY(lane_extract_e8_v56, lane_extract_kernel<8, 56>)
SURF_OP_ENTRY(lane_extract_e8_v120, lane_extract_kernel<8, 120>)
SURF_OP_ENTRY(lane_extract_e8_v248, lane_extract_kernel<8, 248>)

SURF_OP_ENTRY(walk_interleave_serial_any, walk_interleave_kernel<1>)
SURF_OP_ENTRY(walk_interleave_inter2, walk_interleave_kernel<2>)
SURF_OP_ENTRY(walk_interleave_inter4, walk_interleave_kernel<4>)
SURF_OP_ENTRY(walk_interleave_inter8, walk_interleave_kernel<8>)
SURF_OP_ENTRY(walk_interleave_inter16, walk_interleave_kernel<16>)
SURF_OP_ENTRY(walk_interleave_roll_tput, roll_tput_kernel)

#define SURF_SPEC_ENTRY(NAME, W)                                                             \
  extern "C" int NAME(const float* table, int n_rows, const float* rays, int rows_total,     \
                      float* t, int* r, int* state, cudaStream_t cs) {                       \
    spec_visit_kernel<W><<<1, kThreads, 0, cs>>>(table, n_rows, rays, rows_total, t, r,      \
                                                 state);                                     \
    return static_cast<int>(cudaGetLastError());                                             \
  }                                                                                          \
  SURF_KERNEL_OF(NAME, spec_visit_kernel<W>)

SURF_SPEC_ENTRY(spec_visit_cur, 0)
SURF_SPEC_ENTRY(spec_visit_w1, 1)
SURF_SPEC_ENTRY(spec_visit_w2, 2)
SURF_SPEC_ENTRY(spec_visit_w3, 3)
SURF_SPEC_ENTRY(spec_visit_w4, 4)
SURF_SPEC_ENTRY(spec_visit_w6, 6)

// The visit-shape microbenchmarks (micro/visit_parts.py, micro/cond_visit.py,
// micro/visit_bodies.py): the shape of one walk visit, body and loop.
//
// visit_parts_* replaces scripts/tpu_visit_micro.py's kernel (`make` :38,
// `visit_math` :29, its pl.pallas_call at :88): a visit at cursor i reads
// lanes 0-8 of row i % n_rows and runs the chain r = r + f * x',
// x' = (r > f ? x' : r) from r = acc, x' = x.  Variants (PartsVariant),
// each adding one part to kBase (a for loop over i = 0 .. iters - 1):
// kRoll reads lanes (16 (i & 7) + j) mod 128 (the TPU's dynamic lane roll
// by -16 (i & 7) is, on the card, an indexed read of the row); kAny takes
// the packet's vote "some value's r > x" (a __syncthreads_or), whose next
// cursor the script's fori loop drops, so that a compiler drops the vote
// too: here the visits whose vote was set are counted (state[1]); kFori0
// runs an inner loop of min(0, i + 1) = 0 trips, whose 0 comes in as a
// kernel parameter (`zero`): nvcc would fold min(0, i + 1) <= 0 and drop
// the loop, as it cannot fold a parameter; kWhile loops while i < iters
// with i = max(i + 1, i + 1); kFull has all four, its vote picking the
// next cursor i + 1 (set) or i + 2.
//
// cond_visit_* replaces scripts/tpu_cond_micro.py's kernel (`make` :64,
// `slab8` :29, `mt8` :45, its call at :110): visits in blocks of 16 from
// cursor 3 while the visit counter < iters; a visit at cursor i reads row
// i % n_rows, whose int32 lane 9 is a 0/1 leaf flag, and runs mt8 (8 toy
// Möller–Trumbore tests of x against lanes 16k + 0..8: acc += t where one
// hits; t from an IEEE division) on a leaf, else slab8 (8 toy slab tests,
// lanes 16k + 0..5: acc += x where the planes cross); the vote "some
// value's acc > x" moves the cursor by 1, else by 2.  kBoth runs both
// bodies and selects by the flag; an empty asm that takes both results
// keeps nvcc from sinking either body into a branch.  kCond branches on
// the flag, which is block-uniform (every thread reads the same row): no
// divergence.
//
// visit_body_* replaces scripts/tpu_body_micro.py's kernel (`outer` :30,
// the bodies :54-131, its call at :140), the same loop of blocks of 16
// from cursor 3: kBinSroll reads lanes (16 (i & 7) + j) mod 128, j < 9,
// of row (i >> 3) % n_rows (the script's 8 static rolls and selects by
// g == i & 7 are one indexed read here), runs the chain and votes on
// r > the chain's last x'; kWideX runs the toy slab of `_slab8_extract`
// on row i % n_rows (r = acc + per box (planes cross ? x : acc)) and
// votes on r > x; kWideBc reads the tile of rows 8 (i % (n_rows / 8))
// onward: value e = 128 s + l tests box s (lanes 0-5 of the tile's row s)
// against x[l] and adds x[e] or acc[e], and the cursor moves by 1 if more
// than 4 tests cross (the TPU's sum of the (8, 128) mask is two
// __syncthreads_count here, one per value of a thread); kSmemStack is
// kWideX plus a 256-entry int32 stack in shared memory, every entry
// INT_MIN at the start (the script's scratch is never initialised, and
// Pallas's interpret mode fills it so): thread 0 stores 2 i at sp =
// max(i % 64, 1), every thread loads entry sp - 1, and the cursor moves to
// (popped mod n_rows) + 1 (a floor modulo, as JAX's %) if the vote is set,
// else by 2.  A visit's load and store lie between the previous visit's
// vote barrier and its own, and touch different entries, so the barriers
// order every store before the loads of later visits and every load before
// the stores of later visits.
//
// What bounds them: latency, by design.  A visit's work (1024 values x at
// most 8 toy tests) is far below the card's rate and the 256 KB table
// stays in L1 and L2; each visit waits for its row's broadcast load and,
// where it votes, for a barrier.  Design: dep_micro.cu's and
// visit_micro.cu's: one 512-thread block for the (8, 128) packet, 2 values
// a thread (value r * 512 + thread), the cursor and the loop counters
// block-uniform, the TPU's scalar extracts broadcast loads through the
// read-only path.  Semantics as the TPU kernels: NaN-propagating min/max,
// IEEE adds and divisions with denormals kept (no -ftz, so wide_x's and
// smem_stack's overflow to inf matches the plain versions), and
// --fmad=false so that every multiply and add rounds as the plain PyTorch
// versions' separate ops do.

#include <climits>

#include <cuda_runtime.h>

#include "entry.cuh"
#include "mt.cuh"

namespace {

constexpr int kLane = 128;     // floats per table row
constexpr int kRec = 16;       // floats per record
constexpr int kThreads = 512;  // one block: the packet
constexpr int kRays = 2;       // values per thread: 1024 in all
constexpr int kLinks = 9;      // lanes of a chain
constexpr int kBlock = 16;     // visits between two tests of the counter
constexpr int kStart = 3;      // cond_visit's and visit_body's first cursor
constexpr int kLeafLane = 9;
constexpr float kEps = 1e-5f;
constexpr int kStack = 256;    // smem_stack's entries
constexpr int kSpSpan = 64;    // sp = max(i % kSpSpan, 1)
constexpr int kTile = 8;       // wide_bc's rows a visit

__device__ __forceinline__ const float* row_at(const float* table, int r) {
  return table + static_cast<size_t>(r) * kLane;
}

// The packet's values x and accumulators acc, kRays a thread: value r of
// thread t is value r * kThreads + t.
struct Packet {
  float x[kRays], acc[kRays];

  __device__ __forceinline__ void load(const float* __restrict__ x_in) {
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      x[r] = x_in[r * kThreads + threadIdx.x];
      acc[r] = x[r] * 0.0f;
    }
  }

  __device__ __forceinline__ bool any_above(const float* r, const float* than) const {
    int hot = 0;
#pragma unroll
    for (int k = 0; k < kRays; ++k) hot |= r[k] > than[k];
    return __syncthreads_or(hot) != 0;
  }

  __device__ __forceinline__ void store(float* __restrict__ o_out, int* __restrict__ state_out,
                                        int end, int votes) const {
#pragma unroll
    for (int r = 0; r < kRays; ++r) o_out[r * kThreads + threadIdx.x] = acc[r];
    if (threadIdx.x == 0) {
      state_out[0] = end;
      state_out[1] = votes;
    }
  }
};

// tpu_visit_micro.py visit_math (:29-35) over lanes (off + j) mod 128 of
// the row: r (acc on entry) and xl, the chain's last x'.
__device__ __forceinline__ void chain(const float* row, int off, const float* x, float* r,
                                      float* xl) {
  float f[kLinks];
#pragma unroll
  for (int j = 0; j < kLinks; ++j) f[j] = __ldg(row + ((off + j) & (kLane - 1)));
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    float a = r[k], xx = x[k];
#pragma unroll
    for (int j = 0; j < kLinks; ++j) {
      a = a + f[j] * xx;
      xx = a > f[j] ? xx : a;
    }
    r[k] = a;
    xl[k] = xx;
  }
}

// The row's 8 toy slab tests (lanes 16k + 0..5), box by box into r: kExtract
// (tpu_body_micro.py _slab8_extract :69) r = r + (cross ? x : acc), else
// (tpu_cond_micro.py slab8 :29) r = cross ? r + x : r; r is acc on entry.
template <bool kExtract>
__device__ __forceinline__ void toy_slab8(const float* row, const float* x, const float* acc,
                                          float* r) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float* b = row + kRec * c;
    const float l0 = __ldg(b), l1 = __ldg(b + 1), l2 = __ldg(b + 2);
    const float h0 = __ldg(b + 3), h1 = __ldg(b + 4), h2 = __ldg(b + 5);
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const bool cross = surf::toy_cross(l0, l1, l2, h0, h1, h2, x[k]);
      if constexpr (kExtract) {
        r[k] = r[k] + (cross ? x[k] : acc[k]);
      } else {
        r[k] = cross ? r[k] + x[k] : r[k];
      }
    }
  }
}

// tpu_cond_micro.py mt8 (:45-61): the row's 8 toy records (lanes 16k +
// 0..8), each adding its t to r where it hits.
__device__ __forceinline__ void toy_mt8(const float* row, const float* x, float* r) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float* b = row + kRec * c;
    float f[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) f[j] = __ldg(b + j);
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const float xx = x[k];
      const float hx = xx * f[7] - xx * f[8];
      const float hy = xx * f[6] - xx * f[5];
      const float hz = xx * f[3] - xx * f[4];
      const float a = f[0] * hx + f[1] * hy + f[2] * hz;
      const float det = 1.0f / a;
      const float u = det * (hx + hy - hz);
      const float v = det * (hx * f[6] + hy * f[7] + hz * f[8]);
      const float t = det * (u + v);
      const bool ok = (fabsf(a) > kEps) & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) &
                      (t > kEps);
      r[k] = ok ? r[k] + t : r[k];
    }
  }
}

// ---------------------------------------------------------------------------
// visit_parts (tpu_visit_micro.py)
// ---------------------------------------------------------------------------

enum PartsVariant { kBase, kRoll, kAny, kFori0, kWhile, kFull };

// One visit at cursor i: acc, the vote count, and the next cursor.
template <int V>
__device__ __forceinline__ int parts_visit(const float* table, int n_rows, int zero, int i,
                                           Packet& P, int& votes) {
  constexpr bool kRollOn = V == kRoll || V == kFull;
  constexpr bool kVote = V == kAny || V == kFull;
  constexpr bool kInner = V == kFori0 || V == kFull;
  float r[kRays], xl[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) r[k] = P.acc[k];
  chain(row_at(table, i % n_rows), kRollOn ? 16 * (i & 7) : 0, P.x, r, xl);
  int nxt = i + 1;
  if constexpr (kVote) {
    const bool vote = P.any_above(r, P.x);
    votes += vote ? 1 : 0;
    nxt = vote ? i + 1 : i + 2;
  }
  if constexpr (kInner) {
    const int n = min(zero, nxt);  // 0 trips
#pragma unroll 1
    for (int k = 0; k < n; ++k) chain(row_at(table, (i + k) % n_rows), 0, P.x, r, xl);
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) P.acc[k] = r[k];
  return nxt;
}

// zero is 0 at every launch; as a parameter it is unknown to nvcc, which
// would otherwise fold fori0's trip count min(0, i + 1) and drop the loop.
template <int V>
__global__ void __launch_bounds__(kThreads)
visit_parts_kernel(const float* __restrict__ table, int n_rows, const float* __restrict__ x_in,
                   int iters, float* __restrict__ o_out, int* __restrict__ state_out,
                   int zero = 0) {
  Packet P;
  P.load(x_in);
  int i = 0, votes = 0;
  if constexpr (V == kWhile || V == kFull) {
#pragma unroll 1
    while (i < iters) {
      const int nxt = parts_visit<V>(table, n_rows, zero, i, P, votes);
      i = max(nxt, i + 1);
    }
  } else {
#pragma unroll 1
    for (; i < iters; ++i) parts_visit<V>(table, n_rows, zero, i, P, votes);
  }
  P.store(o_out, state_out, i, votes);
}

// ---------------------------------------------------------------------------
// cond_visit (tpu_cond_micro.py)
// ---------------------------------------------------------------------------

enum CondVariant { kBoth, kCond };

template <int V>
__global__ void __launch_bounds__(kThreads)
cond_visit_kernel(const float* __restrict__ table, int n_rows, const float* __restrict__ x_in,
                  int iters, float* __restrict__ o_out, int* __restrict__ state_out) {
  Packet P;
  P.load(x_in);
  int it = 0, i = kStart, votes = 0;
  while (it < iters) {
#pragma unroll 1
    for (int k = 0; k < kBlock; ++k) {
      const float* row = row_at(table, i % n_rows);
      const bool leaf = (__float_as_int(__ldg(row + kLeafLane)) & 1) == 1;
      if constexpr (V == kBoth) {
        float rs[kRays], rm[kRays];
#pragma unroll
        for (int q = 0; q < kRays; ++q) rs[q] = rm[q] = P.acc[q];
        toy_slab8<false>(row, P.x, P.acc, rs);
        toy_mt8(row, P.x, rm);
#pragma unroll
        for (int q = 0; q < kRays; ++q) {
          asm volatile("" : "+f"(rs[q]), "+f"(rm[q]));  // both bodies, every visit
          P.acc[q] = leaf ? rm[q] : rs[q];
        }
      } else {
        if (leaf) {
          toy_mt8(row, P.x, P.acc);
        } else {
          toy_slab8<false>(row, P.x, P.acc, P.acc);
        }
      }
      const bool vote = P.any_above(P.acc, P.x);
      votes += vote ? 1 : 0;
      i = vote ? i + 1 : i + 2;
    }
    it += kBlock;
  }
  P.store(o_out, state_out, i, votes);
}

// ---------------------------------------------------------------------------
// visit_body (tpu_body_micro.py)
// ---------------------------------------------------------------------------

enum BodyVariant { kBinSroll, kWideX, kWideBc, kSmemStack };

template <int V>
__global__ void __launch_bounds__(kThreads)
visit_body_kernel(const float* __restrict__ table, int n_rows, const float* __restrict__ x_in,
                  int iters, float* __restrict__ o_out, int* __restrict__ state_out) {
  __shared__ int s_stack[kStack];
  Packet P;
  P.load(x_in);
  if constexpr (V == kSmemStack) {
    for (int j = threadIdx.x; j < kStack; j += kThreads) s_stack[j] = INT_MIN;
    __syncthreads();
  }
  const float x_ray = x_in[threadIdx.x & (kLane - 1)];  // wide_bc: x[0, l]
  int it = 0, i = kStart, votes = 0;
  while (it < iters) {
#pragma unroll 1
    for (int k = 0; k < kBlock; ++k) {
      float r[kRays];
#pragma unroll
      for (int q = 0; q < kRays; ++q) r[q] = P.acc[q];
      bool vote;
      int nxt;
      if constexpr (V == kBinSroll) {
        float xl[kRays];
        chain(row_at(table, (i >> 3) % n_rows), 16 * (i & 7), P.x, r, xl);
        vote = P.any_above(r, xl);
        nxt = vote ? i + 1 : i + 2;
      } else if constexpr (V == kWideBc) {
        const float* tile = row_at(table, kTile * (i % (n_rows / kTile)));
        int cross[kRays];
#pragma unroll
        for (int q = 0; q < kRays; ++q) {
          const float* b = tile + ((q * kThreads + threadIdx.x) >> 7) * kLane;
          cross[q] = surf::toy_cross(__ldg(b), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3),
                                     __ldg(b + 4), __ldg(b + 5), x_ray);
          r[q] = P.acc[q] + (cross[q] ? P.x[q] : P.acc[q]);
        }
        vote = __syncthreads_count(cross[0]) + __syncthreads_count(cross[1]) > 4;
        nxt = vote ? i + 1 : i + 2;
      } else {
        toy_slab8<true>(row_at(table, i % n_rows), P.x, P.acc, r);
        if constexpr (V == kSmemStack) {
          const int sp = max(i % kSpSpan, 1);
          const int popped = s_stack[sp - 1];
          if (threadIdx.x == 0) s_stack[sp] = i * 2;
          vote = P.any_above(r, P.x);  // its barrier orders this visit's store and load
          nxt = vote ? surf::floor_mod(popped, n_rows) + 1 : i + 2;
        } else {
          vote = P.any_above(r, P.x);
          nxt = vote ? i + 1 : i + 2;
        }
      }
#pragma unroll
      for (int q = 0; q < kRays; ++q) P.acc[q] = r[q];
      votes += vote ? 1 : 0;
      i = nxt;
    }
    it += kBlock;
  }
  P.store(o_out, state_out, i, votes);
}

}  // namespace

// Plain C entry points for ctypes; each returns cudaGetLastError() after its
// launch.  table is [n_rows, 128] f32 (16-byte aligned; cond_visit: int32
// lane 9 the leaf flag; visit_body: n_rows >= 8); x [1024]; iters > 0; o
// [1024]; state [2] = the end cursor, the visits whose vote was set.
// NAME_kernel() gives the kernel NAME launches (entry.cuh).
#define SURF_SHAPE_ENTRY(NAME, KERNEL)                                                       \
  extern "C" int NAME(const float* table, int n_rows, const float* x, int iters, float* o,   \
                      int* state, cudaStream_t cs) {                                         \
    KERNEL<<<1, kThreads, 0, cs>>>(table, n_rows, x, iters, o, state);                       \
    return static_cast<int>(cudaGetLastError());                                             \
  }                                                                                          \
  SURF_KERNEL_OF(NAME, KERNEL)

SURF_SHAPE_ENTRY(visit_parts_base, visit_parts_kernel<kBase>)
SURF_SHAPE_ENTRY(visit_parts_roll, visit_parts_kernel<kRoll>)
SURF_SHAPE_ENTRY(visit_parts_any, visit_parts_kernel<kAny>)
SURF_SHAPE_ENTRY(visit_parts_fori0, visit_parts_kernel<kFori0>)
SURF_SHAPE_ENTRY(visit_parts_while, visit_parts_kernel<kWhile>)
SURF_SHAPE_ENTRY(visit_parts_full, visit_parts_kernel<kFull>)

SURF_SHAPE_ENTRY(cond_visit_both, cond_visit_kernel<kBoth>)
SURF_SHAPE_ENTRY(cond_visit_cond, cond_visit_kernel<kCond>)

SURF_SHAPE_ENTRY(visit_body_bin_sroll, visit_body_kernel<kBinSroll>)
SURF_SHAPE_ENTRY(visit_body_wide_x, visit_body_kernel<kWideX>)
SURF_SHAPE_ENTRY(visit_body_wide_bc, visit_body_kernel<kWideBc>)
SURF_SHAPE_ENTRY(visit_body_smem_stack, visit_body_kernel<kSmemStack>)

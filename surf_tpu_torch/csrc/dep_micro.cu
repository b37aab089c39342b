// The dependent-cursor microbenchmark (micro/dep_chain.py).
//
// Replaces scripts/tpu_dep_micro.py's kernel (`make`, its pl.pallas_call at
// :222): one packet of 1024 rays walks a table whose next row is read from
// the fetched row (int32 lanes 9/10), so each step waits for its fetch.
// The kernel returns the rays' best hits and the cursor it ends at, so
// that every variant's chain is live (without the cursor, dep0's loop
// would feed no output and the compiler would drop it).
// Variants (kVariant):
//   kDep0      fetch -> cursor = lane 9, nothing else;
//   kDep1      + the row's 8 slab and 8 Möller–Trumbore tests per ray, off
//              the chain (their results feed only best_t / best_r);
//   kDep1Red   + the cursor picked by the block vote "some ray hits some
//              box of the row": the skip walk's chain;
//   kDep1Lean  kDep1Red with the plane-form record test;
//   kDepB8     8 rows a step, the cursor from the last row's vote;
//   kDepB8All  8 rows a step, all 8 rows' votes taken (one 8-bit block OR,
//              vote.cuh).  Its resolve is the TPU script's
//              (tpu_dep_micro.py:165-168): each pass overwrites the
//              cursor, so the last row's vote picks it, as in kDepB8 (the
//              same function with seven more votes a step, not specb's
//              chained resolve).
//
// What bounds it: latency, by design.  The work per step is 1024 rays x
// 16 tests, far below the card's rate, and the table (256 KB) stays in L1
// and L2; the chain load -> test -> vote -> next load is what the slope of
// time over rows measures.  Design: one block of kThreads threads, kRays
// rays each in registers, every thread following the same cursor (a
// broadcast load); the TPU's jnp.any feeding the address is the block
// barrier's OR (__syncthreads_or).  The cursor is clamped inside the table
// with its window whole, as the plain version does (a guard the benchmark's
// tables never reach).  Semantics as the TPU kernel: slab test with
// NaN-propagating min/max against the running best_t, then the records in
// order, each replacing the best on a strictly smaller t; best_t starts at
// 1e30, the record id is row * 8 + j.  Build with --fmad=false so the
// arithmetic rounds as the plain PyTorch version's.

#include <cuda_runtime.h>

#include "mt.cuh"
#include "vote.cuh"

namespace {

constexpr int kLane = 128;     // floats per table row
constexpr int kRec = 16;       // floats per record
constexpr int kThreads = 512;  // one block: the packet
constexpr int kRays = 2;       // rays per thread: 1024 in all
constexpr int kSka = 9, kSkb = 10;

enum Variant { kDep0, kDep1, kDep1Red, kDep1Lean, kDepB8, kDepB8All };

struct Rays {
  float ox[kRays], oy[kRays], oz[kRays];
  float dx[kRays], dy[kRays], dz[kRays];
  float ix[kRays], iy[kRays], iz[kRays];
  float bt[kRays];
  int br[kRays];

  // Row `p` (at `row`) against this thread's rays: the slab tests with the
  // running best_t, then the records in order.  Returns whether some ray
  // hits some box.
  template <bool kLean>
  __device__ __forceinline__ bool eval(const float* __restrict__ row, int p) {
    bool anyh = false;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float* b = row + kRec * k;
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        anyh |= surf::slab_hit(ox[r], oy[r], oz[r], ix[r], iy[r], iz[r], bt[r], __ldg(b),
                               __ldg(b + 1), __ldg(b + 2), __ldg(b + 3), __ldg(b + 4),
                               __ldg(b + 5));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* c = row + kRec * j;
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        float t;
        bool hit;
        if constexpr (kLean) {
          // tpu_dep_micro.py:91-120: lanes [n, d0, U, u0, V, v0]
          const float nx = __ldg(c), ny = __ldg(c + 1), nz = __ldg(c + 2);
          const float den = nx * dx[r] + ny * dy[r] + nz * dz[r];
          t = (__ldg(c + 3) - (nx * ox[r] + ny * oy[r] + nz * oz[r])) / den;
          const float px = ox[r] + t * dx[r];
          const float py = oy[r] + t * dy[r];
          const float pz = oz[r] + t * dz[r];
          const float u = __ldg(c + 4) * px + __ldg(c + 5) * py + __ldg(c + 6) * pz + __ldg(c + 7);
          const float v = __ldg(c + 8) * px + __ldg(c + 9) * py + __ldg(c + 10) * pz + __ldg(c + 11);
          hit = (fabsf(den) >= surf::kEps) & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) &
                (t >= surf::kEps) & (t < bt[r]);
        } else {
          float u, v;
          hit = surf::mt_hit(__ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3), __ldg(c + 4),
                             __ldg(c + 5), __ldg(c + 6), __ldg(c + 7), __ldg(c + 8), ox[r],
                             oy[r], oz[r], dx[r], dy[r], dz[r], bt[r], t, u, v);
        }
        if (hit) {
          bt[r] = t;
          br[r] = p * 8 + j;
        }
      }
    }
    return anyh;
  }
};

__device__ __forceinline__ int lane_int(const float* table, int p, int lane) {
  return __float_as_int(__ldg(table + static_cast<size_t>(p) * kLane + lane));
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
dep_chain_kernel(const float* __restrict__ table, int n_rows,
                 const float* __restrict__ rays, int n_steps, float* __restrict__ t_out,
                 int* __restrict__ r_out, int* __restrict__ end_out) {
  constexpr int kN = kThreads * kRays;
  constexpr int kBw = (kVariant == kDepB8 || kVariant == kDepB8All) ? 8 : 1;
  __shared__ unsigned s_vote[3];
  Rays R;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = r * kThreads + threadIdx.x;
    R.ox[r] = rays[i];
    R.oy[r] = rays[kN + i];
    R.oz[r] = rays[2 * kN + i];
    R.dx[r] = rays[3 * kN + i];
    R.dy[r] = rays[4 * kN + i];
    R.dz[r] = rays[5 * kN + i];
    R.ix[r] = 1.0f / R.dx[r];
    R.iy[r] = 1.0f / R.dy[r];
    R.iz[r] = 1.0f / R.dz[r];
    R.bt[r] = 1e30f;
    R.br[r] = -1;
  }
  if (threadIdx.x == 0) {
    s_vote[0] = 0u;
    s_vote[1] = 0u;
    s_vote[2] = 0u;
  }
  __syncthreads();
  int p = 0;
  for (int step = 0; step < n_steps; ++step) {
    const float* row = table + static_cast<size_t>(p) * kLane;
    int nxt;
    if constexpr (kVariant == kDep0) {
      nxt = lane_int(table, p, kSka);
    } else if constexpr (kVariant == kDep1) {
      R.eval<false>(row, p);
      nxt = lane_int(table, p, kSka);
    } else if constexpr (kVariant == kDep1Red || kVariant == kDep1Lean) {
      const bool vote = __syncthreads_or(R.eval<kVariant == kDep1Lean>(row, p));
      nxt = lane_int(table, p, vote ? kSka : kSkb);
    } else if constexpr (kVariant == kDepB8) {
      bool last = false;
#pragma unroll 1
      for (int r = 0; r < kBw; ++r) last = R.eval<false>(row + r * kLane, p + r);
      const bool vote = __syncthreads_or(last);
      nxt = lane_int(table, p + kBw - 1, vote ? kSka : kSkb);
    } else {
      unsigned votes = 0u;
#pragma unroll 1
      for (int r = 0; r < kBw; ++r) {
        if (R.eval<false>(row + r * kLane, p + r)) votes |= 1u << r;
      }
      votes = surf::block_or(votes, s_vote, step);
      // tpu_dep_micro.py:165-168: each pass overwrites nxt
      nxt = lane_int(table, p, kSka);
      for (int r = 0; r < kBw; ++r) {
        nxt = lane_int(table, p + r, ((votes >> r) & 1u) ? kSka : kSkb);
      }
    }
    p = min(max(nxt, 0), n_rows - kBw);
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = r * kThreads + threadIdx.x;
    t_out[i] = R.bt[r];
    r_out[i] = R.br[r];
  }
  if (threadIdx.x == 0) *end_out = p;
}

template <int kVariant>
int launch(const float* table, int n_rows, const float* rays, int n_steps, float* t,
           int* r, int* end, cudaStream_t cs) {
  dep_chain_kernel<kVariant><<<1, kThreads, 0, cs>>>(table, n_rows, rays, n_steps, t, r,
                                                     end);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  table is [n_rows, 128] f32 (int32 skip
// lanes 9/10); rays is [6, 1024] (ox, oy, oz, dx, dy, dz); n_steps is the
// rows walked over the rows a step (8 for the depb variants); t and r are
// [1024], end [1] the row the cursor ends at.  Returns cudaGetLastError()
// after the launch.
#define SURF_DEP_ENTRY(NAME, VARIANT)                                                  \
  extern "C" int NAME(const float* table, int n_rows, const float* rays, int n_steps,  \
                      float* t, int* r, int* end, cudaStream_t cs) {                   \
    return launch<VARIANT>(table, n_rows, rays, n_steps, t, r, end, cs);               \
  }

SURF_DEP_ENTRY(dep_chain_dep0, kDep0)
SURF_DEP_ENTRY(dep_chain_dep1, kDep1)
SURF_DEP_ENTRY(dep_chain_dep1red, kDep1Red)
SURF_DEP_ENTRY(dep_chain_dep1lean, kDep1Lean)
SURF_DEP_ENTRY(dep_chain_depb8, kDepB8)
SURF_DEP_ENTRY(dep_chain_depb8all, kDepB8All)

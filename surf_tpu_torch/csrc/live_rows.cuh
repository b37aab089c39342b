// The pieces that the live leaf-row kernels share: leaf_rows.cu's
// leaf_rows_live_kernel and leaf_rows_bf16_live_kernel (row 1 and its bf16
// pair) and inst_rows.cu's inst_rows_live_kernel (the instanced rows).  A
// live kernel tests only a list's live rays (start t > 1e-5), kLiveThreads
// of them a block, splits the list's rows into work items on the grid's y,
// and merges the work items' best hits through an exact key:
//
// - `compact_live`: one block scan ranks the live lanes of a list;
// - `merge_splits`: each work item's key goes into its ray's scratch slot
//   by atomicMax, and the last work item of the list to arrive (a counter
//   and __threadfence, the threadfence-reduction pattern) takes the merged
//   key and leaves the slot and the counter zero;
// - `live_hit`: one staged record's test, Möller–Trumbore or Baldwin–Weber,
//   by the in-range reciprocal (mt.cuh rcp_in_range) or the IEEE division;
// - `row_exact`: one row's 8 record tests with the IEEE division, the rare
//   path of a row in which some |det| (|den|) is out of the in-range
//   reciprocal's range, sequential or by the ILP merge.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "mt.cuh"

namespace surf {

constexpr int kLiveThreads = 256;  // live rays a block
constexpr int kLiveTris = 8;       // records a row
constexpr int kLiveUnroll = 8;     // start t loads in flight a thread (compaction)

enum Record { kMT = 0, kBW = 1 };  // Möller–Trumbore, Baldwin–Weber records

// One record test of a staged record (lanes 0-11: three float4) against
// best_t, 1 / a (1 / den) by the in-range path, or by the IEEE division
// with kExact; `wide` is set when the in-range path may differ from it.
template <int kRecord, bool kExact>
__device__ __forceinline__ bool live_hit(const float4* rec, float ox, float oy, float oz,
                                         float dx, float dy, float dz, float best_t, float& t,
                                         bool& wide) {
  constexpr Recip kRecip = kExact ? Recip::kDivide : Recip::kInRange;
  const float4 a = rec[0], b = rec[1], c = rec[2];
  float u, v, det;
  bool hit;
  if constexpr (kRecord == kBW) {
    hit = bw_hit_a<kRecip>(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w, ox, oy,
                           oz, dx, dy, dz, best_t, t, u, v, det);
  } else {
    hit = mt_hit_a<kRecip>(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ox, oy, oz, dx, dy, dz,
                           best_t, t, u, v, det);
  }
  wide |= fabsf(det) >= kInRangeMax;
  return hit;
}

// The rare path of a row in which some reciprocal left the in-range path:
// the row's 8 record tests again from its start with the IEEE division,
// inlined as a loop of its own (not unrolled; as a __noinline__ call it
// cost the hot loop registers and time).  Sequential: strictly-closer
// updates of (best_t, best_pos) from position pos0.  ILP: the first least
// t of the row's tests against +inf (a scan with strict <, the min-tree's
// pick: the tree keeps the left candidate at every tie, so its result is
// the leftmost least t), then one strict < against best_t.
template <int kRecord, bool kIlp>
__device__ __forceinline__ void row_exact(const float4* row, int pos0, float ox, float oy,
                                          float oz, float dx, float dy, float dz,
                                          float& best_t, int& best_pos) {
  float tw = CUDART_INF_F;
  int jw = 0;
#pragma unroll 1
  for (int j = 0; j < kLiveTris; ++j) {
    float t;
    bool wide = false;
    if (live_hit<kRecord, true>(row + j * 4, ox, oy, oz, dx, dy, dz,
                                kIlp ? CUDART_INF_F : best_t, t, wide)) {
      if (!kIlp) {
        best_t = t;
        best_pos = pos0 + j;
      } else if (t < tw) {
        tw = t;
        jw = j;
      }
    }
  }
  if (kIlp && tw < best_t) {
    best_t = tw;
    best_pos = pos0 + jw;
  }
}

// Live-ray compaction of one list (a packet): thread i owns lanes
// [i * slices, (i + 1) * slices) of the list; one block scan of the
// per-thread live counts (start t > 1e-5; NaN is not live) ranks the live
// lanes, and the lanes of rank [slice * 256, slice * 256 + 256) go to
// live_lane in rank order.  The start t loads go kLiveUnroll at a time, all
// in flight together.  dead(lane, start t) is called for every dead lane
// when writes_dead.  Returns the list's live count; every thread of the
// block calls it.
template <class Dead>
__device__ __forceinline__ int compact_live(const float* __restrict__ start_of, int slices,
                                            int slice, bool writes_dead, int* live_lane,
                                            int* warp_live, Dead dead) {
  const int lane0 = threadIdx.x * slices;
  int mine = 0;
  for (int i0 = 0; i0 < slices; i0 += kLiveUnroll) {
    float tmv[kLiveUnroll];
#pragma unroll
    for (int i = 0; i < kLiveUnroll; ++i)
      tmv[i] = i0 + i < slices ? start_of[lane0 + i0 + i] : 0.0f;
#pragma unroll
    for (int i = 0; i < kLiveUnroll; ++i) mine += tmv[i] > kEps;
  }
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lid >= o) incl += x;
  }
  if (lid == 31) warp_live[wid] = incl;
  __syncthreads();
  int before = 0, n_live = 0;
#pragma unroll
  for (int w = 0; w < kLiveThreads / 32; ++w) {
    const int c = warp_live[w];
    before += w < wid ? c : 0;
    n_live += c;
  }
  int rank = before + incl - mine;
  const int lo_rank = slice * kLiveThreads;
  for (int i = 0; i < slices; ++i) {  // the loads above left these in L1
    const int lane = lane0 + i;
    const float tm = start_of[lane];
    if (tm > kEps) {
      if (rank >= lo_rank && rank < lo_rank + kLiveThreads) live_lane[rank - lo_rank] = lane;
      ++rank;
    } else if (writes_dead) {
      dead(lane, tm);
    }
  }
  return n_live;
}

// The split merge: each thread's key goes into its ray's slot by
// atomicMax; the last of the list's `parts` work items to arrive takes the
// merged key and resets the slot and the counter.  Returns false in every
// other block.  Every thread of the block calls it.
template <class Key>
__device__ __forceinline__ bool merge_splits(Key& key, bool has_ray, Key* slot,
                                             unsigned* arrival, int parts, bool* last) {
  if (parts == 1) return true;
  if (key != 0) atomicMax(slot, key);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(arrival, 1u) == static_cast<unsigned>(parts - 1);
  __syncthreads();
  if (!*last) return false;
  __threadfence();
  if (has_ray) key = atomicExch(slot, Key(0));
  if (threadIdx.x == 0) *arrival = 0u;
  return true;
}

}  // namespace surf

// Leaf-row intersection for the bits* traversals.
//
// Replaces surf_tpu/accel/pallas_wide.py `_leaf_rows_kernel` with every body
// it runs: the Möller–Trumbore rows `_mt8` (f32, and bf16 with the `h` flag)
// and `_mt8_any` (the any-hit trim for shadow rays), the Baldwin–Weber rows
// `_bw8` (`w`), the ILP min-tree merges `_mt8_ilp` and `_bw8_ilp` (`i`), and
// the `carry_in` path that resumes from an earlier call's running best (the
// t-refresh round B of `bits2`).  A packet's rows come from its candidate
// list, or, for a list length below zero, from the whole table in row order
// (the overflow sweep, which the TPU chunks through carry_in and which
// this kernel runs in one pass).
//
// What bounds it on the card: a Möller–Trumbore test is ~45 FLOPs plus an
// IEEE division, a Baldwin–Weber test ~31, against a 64-byte record that
// every ray of the packet reads.  A packet reuses each 512-byte row once
// per ray, so the loop is compute-bound once rows are staged on chip;
// fetching them per ray from L2 would make it bound by L2 bandwidth instead.
//
// Two designs.  Every entry point that an algo reaches runs a live kernel:
// the f32 ones (leaf_rows_closest, leaf_rows_any, which every bitsru8 frame
// runs, and leaf_rows_{mt,bw}[_ilp][_carry]_closest: bitsi, bitsw, bitswi,
// bits2*) leaf_rows_live_kernel, and the bf16 test's pair
// (leaf_rows_mt_bf16_closest, leaf_rows_mt_bf16_carry_closest: bitsh,
// bits2h) the same structure with packed bf16x2 arithmetic,
// leaf_rows_bf16_live_kernel (both below).  The first design,
// leaf_rows_kernel, stays for timing the designs side by side, as
// leaf_rows_{closest,any}_pr1 and the _pr4 entry points of the other nine
// (reached only by accel/leaf_rows.py leaf_rows_first_design):
// one thread per ray, 256 rays per block; a list of block_rays rays
// (a packet, or one sub-list of it) is served by block_rays / 256 blocks
// that all walk the list.  Rows are read by row id straight from the table
// (no gathered copy of the list's rows), staged kChunk rows at a time
// through shared memory with 16-byte loads, and then read by every thread
// of the block at the same address (a broadcast, free of bank conflicts).
// One template serves every variant:
//   kRecord  Möller–Trumbore (v0, e1, e2; slot id in lane 9) or
//            Baldwin–Weber (n, d0, a1, a2; slot id in lane 12);
//   kIlp     sequential strictly-closer updates, record by record, or the
//            8 records of a row tested independently (a failed test gets
//            t = +inf), merged by the left-preferring min-tree
//            ((0,1),(2,3)),((4,5),(6,7)) that keeps the left candidate on
//            ties, and one strict < against the running best per row;
//   kBf16    the record test in bf16 (mt.cuh mt_hit_bf16): the ray and the
//            record's lanes are rounded to bf16 as they are read;
//   kCarry   the running best starts from four [n_rays] inputs (t, r, u,
//            v) instead of (t_max, -1, 0, 0);
//   kAny     the any-hit trim: only t is carried, and r is 0 (occluded) or
//            -1, u = v = 0.
// The ILP merge picks the same record as the sequential updates (the
// first record with the least t below the running best), so the two agree
// bit for bit.  Semantics kept from the TPU kernel: rows in list order,
// records j = 0..7 within a row; the NaNs of all-zero (inert) rows fail
// every compare; the slot id is the int32 bit pattern of its lane.  A
// packet whose length is 0 (no live ray) reads no rows.  Build with
// --fmad=false so the arithmetic rounds exactly as the plain PyTorch
// versions' separate ops do.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "entry.cuh"
#include "live_rows.cuh"
#include "mt.cuh"

namespace {

constexpr int kLane = 128;    // floats per leaf-table row
constexpr int kRec = 16;      // floats per triangle record
constexpr int kTris = 8;      // triangles per row
constexpr int kThreads = surf::kLiveThreads; // rays per block
constexpr int kChunk = 32;    // rows staged in shared memory at a time

using surf::kBW;
using surf::kMT;

struct Cand {
  float t, u, v;
  int r;
};

// The record test against `best_t`: true on a hit, with t, u, v written.
template <int kRecord, bool kBf16>
__device__ __forceinline__ bool record_hit(const float* rec, float ox, float oy,
                                           float oz, float dx, float dy, float dz,
                                           float best_t, float& t, float& u,
                                           float& v) {
  if constexpr (kRecord == kBW) {
    return surf::bw_hit(rec, ox, oy, oz, dx, dy, dz, best_t, t, u, v);
  } else if constexpr (kBf16) {
    using surf::bf16;
    return surf::mt_hit_bf16(bf16(rec[0]), bf16(rec[1]), bf16(rec[2]),
                             bf16(rec[3]), bf16(rec[4]), bf16(rec[5]),
                             bf16(rec[6]), bf16(rec[7]), bf16(rec[8]), ox, oy,
                             oz, dx, dy, dz, best_t, t, u, v);
  } else {
    return surf::mt_hit(rec[0], rec[1], rec[2], rec[3], rec[4], rec[5], rec[6],
                        rec[7], rec[8], ox, oy, oz, dx, dy, dz, best_t, t, u, v);
  }
}

// Left-preferring merge: b wins only when strictly closer.
__device__ __forceinline__ Cand merge(const Cand& a, const Cand& b) {
  return b.t < a.t ? b : a;
}

template <int kRecord, bool kIlp, bool kBf16, bool kCarry, bool kAny>
__global__ void __launch_bounds__(kThreads)
leaf_rows_kernel(const float* __restrict__ table, int table_rows,
                 const int* __restrict__ lists, int cap,
                 const int* __restrict__ n_rows,
                 const float* __restrict__ rays, int n_rays, int block_rays,
                 const float* __restrict__ t_in, const int* __restrict__ r_in,
                 const float* __restrict__ u_in, const float* __restrict__ v_in,
                 float* __restrict__ t_out, int* __restrict__ r_out,
                 float* __restrict__ u_out, float* __restrict__ v_out) {
  constexpr int kSlotLane = kRecord == kBW ? 12 : 9;
  __shared__ float4 staged[kChunk * kLane / 4];
  const int first = blockIdx.x * kThreads;
  const int ray = first + threadIdx.x;
  const int packet = first / block_rays;
  int count = n_rows[packet];
  const bool sweep = count < 0;
  if (sweep) count = table_rows;

  const size_t stride = static_cast<size_t>(n_rays);  // rays is [7, n_rays]
  float ox = rays[ray];
  float oy = rays[stride + ray];
  float oz = rays[2 * stride + ray];
  float dx = rays[3 * stride + ray];
  float dy = rays[4 * stride + ray];
  float dz = rays[5 * stride + ray];
  if constexpr (kBf16) {
    ox = surf::bf16(ox);
    oy = surf::bf16(oy);
    oz = surf::bf16(oz);
    dx = surf::bf16(dx);
    dy = surf::bf16(dy);
    dz = surf::bf16(dz);
  }
  const float tm = rays[6 * stride + ray];
  float best_t = kCarry ? t_in[ray] : tm;
  int best_r = kCarry ? r_in[ray] : -1;
  float best_u = kCarry ? u_in[ray] : 0.0f;
  float best_v = kCarry ? v_in[ray] : 0.0f;

  const float4* table4 = reinterpret_cast<const float4*>(table);
  const int* list = lists + static_cast<size_t>(packet) * cap;
  const float* rows = reinterpret_cast<const float*>(staged);
  for (int base = 0; base < count; base += kChunk) {
    const int m = min(kChunk, count - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < m * (kLane / 4); i += kThreads) {
      const int k = i / (kLane / 4);
      const int row = sweep ? base + k : list[base + k];
      staged[i] = table4[static_cast<size_t>(row) * (kLane / 4) + i % (kLane / 4)];
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float* row = rows + k * kLane;
      if constexpr (kIlp) {
        Cand c[kTris];
#pragma unroll
        for (int j = 0; j < kTris; ++j) {
          const float* rec = row + j * kRec;
          const bool ok = record_hit<kRecord, kBf16>(rec, ox, oy, oz, dx, dy, dz,
                                                     CUDART_INF_F, c[j].t, c[j].u,
                                                     c[j].v);
          if (!ok) c[j].t = CUDART_INF_F;
          c[j].r = __float_as_int(rec[kSlotLane]);
        }
        const Cand w = merge(merge(merge(c[0], c[1]), merge(c[2], c[3])),
                             merge(merge(c[4], c[5]), merge(c[6], c[7])));
        if (w.t < best_t) {
          best_t = w.t;
          best_r = w.r;
          best_u = w.u;
          best_v = w.v;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kTris; ++j) {
          const float* rec = row + j * kRec;
          float t, u, v;
          if (record_hit<kRecord, kBf16>(rec, ox, oy, oz, dx, dy, dz, best_t, t,
                                         u, v)) {
            best_t = t;
            if (!kAny) {
              best_r = __float_as_int(rec[kSlotLane]);
              best_u = u;
              best_v = v;
            }
          }
        }
      }
    }
  }
  t_out[ray] = best_t;
  if (kAny) {
    // Occlusion only: r = 0 (occluded) or -1, u = v = 0.
    r_out[ray] = best_t < tm ? 0 : -1;
    u_out[ray] = 0.0f;
    v_out[ray] = 0.0f;
  } else {
    r_out[ray] = best_r;
    u_out[ray] = best_u;
    v_out[ray] = best_v;
  }
}

template <int kRecord, bool kIlp, bool kBf16, bool kCarry, bool kAny>
int launch(const float* table, int table_rows, const int* lists, int cap,
           const int* n_rows, const float* rays, int n_rays, int block_rays,
           const float* t_in, const int* r_in, const float* u_in,
           const float* v_in, float* t, int* r, float* u, float* v,
           cudaStream_t stream) {
  static_assert(!(kBf16 && (kRecord == kBW || kIlp)),
                "the bf16 record test is the sequential Möller–Trumbore one");
  static_assert(!(kAny && (kRecord == kBW || kIlp || kBf16 || kCarry)),
                "the any-hit trim is the plain Möller–Trumbore kernel's");
  leaf_rows_kernel<kRecord, kIlp, kBf16, kCarry, kAny>
      <<<n_rays / kThreads, kThreads, 0, stream>>>(
          table, table_rows, lists, cap, n_rows, rays, n_rays, block_rays,
          t_in, r_in, u_in, v_in, t, r, u, v);
  return static_cast<int>(cudaGetLastError());
}

// leaf_rows_live_kernel: the f32 record tests, with the function of
// leaf_rows_kernel<kRecord, kIlp, false, kCarry, kAny> bit for bit: the
// sequential Möller–Trumbore closest hit and any-hit trim (row 1), and the
// seven entry points of Baldwin–Weber (kRecord kBW), the ILP merge (kIlp)
// and the carry-in (kCarry).  What held the first design back: every lane
// did the full work, dead ones too (a dead lane has t_max = -FAR; a frame's
// later waves and its shadow rays are mostly dead lanes), and one block
// walked a whole list, so a launch ended with its longest list and the
// ladder's narrow tail waves left most of the card idle.  So:
//
// 1. Live-ray compaction.  A lane's start t is t_max, or t_in with
//    carry-in; it is live when that is above 1e-5 (NaN is not live): a
//    start t <= 1e-5 fails `t >= eps & t < best_t` for every record, so
//    the lane's result is its start value, (t_max, -1, 0, 0) or (t_in,
//    r_in, u_in, v_in), which the block of slice 0, split 0 of its list
//    writes.  Each block counts its list's live lanes with one block scan
//    and takes the live lanes of rank [256 s, 256 s + 256) for its slice
//    s; a slice with none exits.
// 2. Row-split work items.  The grid is (lists x slices, splits): split y
//    tests rows [y K, y K + K) of the list (K = split_rows, staged kChunk
//    rows at a time); the host sizes the splits from max(cap, table rows),
//    so it never reads n_rows, and a split past the list's rows exits.
//    Split 0 always takes part, so a list of 0 rows still writes its rays.
// 3. An exact merge.  The sequential result is the least (t, list position
//    x 8 + j) over the hits below the start t; the ILP merge's is the same
//    (its min-tree keeps the first least t of a row, its strict < the first
//    such row).  A split's running best gives its share of that; the
//    splits of a list merge through a 64-bit atomicMax of the inverted key
//    (float bits of t above the position: t >= 1e-5 > 0, so the bits order
//    as the values) into a per-call scratch (keys[ray], 0 = no hit), and
//    the last split to arrive (a counter and __threadfence, the
//    threadfence-reduction pattern) reads the key, resets it and the
//    counter to 0, recomputes u and v with the record's own test (mt_hit or
//    bw_hit, same ops, same bits) on the winning record and reads r from
//    its slot lane.  The trim keeps only t: a 32-bit key.  A list of one
//    split skips the scratch.  One launch a call: the scratch is all zero
//    before and after it.
// 4. Inside a block: a record is read as three float4 (lanes 0-11, LDS.128
//    broadcasts), and only (t, position) is carried through the loop.  The
//    record test takes 1 / a (Baldwin–Weber: 1 / den) by the in-range path
//    of nvcc's reciprocal (mt.cuh rcp_in_range: the same bits for |a| <
//    2^126) without nvcc's per-test range check and branch; a row in which
//    some |a| >= 2^126 (or inf) runs again from its start with the IEEE
//    division.
// The compaction, the record test, the exact row and the merge are
// live_rows.cuh's, shared with inst_rows.cu's live kernel.

// A live kernel's block (points 1 and 2 above): list list_id, whose lanes
// start at first, its slice of the list's live lanes (slices of them a
// list), and the list's rows, count of them (the whole table with sweep),
// in parts splits of split_rows rows.
struct LiveBlock {
  int slices, list_id, slice, count, parts;
  bool sweep;
  size_t first;
};

__device__ __forceinline__ LiveBlock live_block(const int* __restrict__ n_rows, int table_rows,
                                                int block_rays, int split_rows) {
  LiveBlock b;
  b.slices = block_rays / kThreads;  // also the lanes per thread
  b.list_id = blockIdx.x / b.slices;
  b.slice = blockIdx.x % b.slices;
  b.count = n_rows[b.list_id];
  b.sweep = b.count < 0;
  if (b.sweep) b.count = table_rows;
  b.parts = max(1, (b.count + split_rows - 1) / split_rows);
  b.first = static_cast<size_t>(b.list_id) * block_rays;
  return b;
}

// A lane's start values, its result when no record hits below its start t
// t0: (t_max, -1, 0, 0), or with carry-in (t_in, r_in, u_in, v_in).
template <bool kCarry>
__device__ __forceinline__ void write_start(size_t at, float t0, const int* __restrict__ r_in,
                                            const float* __restrict__ u_in,
                                            const float* __restrict__ v_in,
                                            float* __restrict__ t_out, int* __restrict__ r_out,
                                            float* __restrict__ u_out,
                                            float* __restrict__ v_out) {
  t_out[at] = t0;
  r_out[at] = kCarry ? r_in[at] : -1;
  u_out[at] = kCarry ? u_in[at] : 0.0f;
  v_out[at] = kCarry ? v_in[at] : 0.0f;
}

// The ILP merge of a staged row: each record tested against +inf (a failed
// test counts as t = +inf), the left-preferring min-tree
// ((0,1),(2,3)),((4,5),(6,7)) over (t, j), and one strict < against
// best_t.  Returns whether some record's reciprocal left the in-range path.
template <int kRecord>
__device__ __forceinline__ bool ilp_row(const float4* row, int pos0, float ox, float oy,
                                        float oz, float dx, float dy, float dz, float& best_t,
                                        int& best_pos) {
  float t8[kTris];
  bool wide = false;
#pragma unroll
  for (int j = 0; j < kTris; ++j) {
    float t;
    const bool hit = surf::live_hit<kRecord, false>(row + j * 4, ox, oy, oz, dx, dy, dz,
                                                    CUDART_INF_F, t, wide);
    t8[j] = hit ? t : CUDART_INF_F;
  }
  float t4[kTris / 2];
  int j4[kTris / 2];
#pragma unroll
  for (int j = 0; j < kTris / 2; ++j) {
    const bool r = t8[2 * j + 1] < t8[2 * j];
    t4[j] = r ? t8[2 * j + 1] : t8[2 * j];
    j4[j] = 2 * j + r;
  }
  const bool r01 = t4[1] < t4[0], r23 = t4[3] < t4[2];
  const float ta = r01 ? t4[1] : t4[0], tb = r23 ? t4[3] : t4[2];
  const int ja = r01 ? j4[1] : j4[0], jb = r23 ? j4[3] : j4[2];
  const float tw = tb < ta ? tb : ta;
  const int jw = tb < ta ? jb : ja;
  if (tw < best_t) {
    best_t = tw;
    best_pos = pos0 + jw;
  }
  return wide;
}

// A staged row's sequential tests: strictly-closer updates record by
// record.  Returns whether some record's reciprocal left the in-range path.
template <int kRecord, bool kAny>
__device__ __forceinline__ bool seq_row(const float4* row, int pos0, float ox, float oy,
                                        float oz, float dx, float dy, float dz, float& best_t,
                                        int& best_pos) {
  bool wide = false;
#pragma unroll
  for (int j = 0; j < kTris; ++j) {
    float t;
    if (surf::live_hit<kRecord, false>(row + j * 4, ox, oy, oz, dx, dy, dz, best_t, t, wide)) {
      best_t = t;
      if (!kAny) best_pos = pos0 + j;
    }
  }
  return wide;
}

// t_in, r_in, u_in and v_in are read only with kCarry: the kernel takes them
// to share leaf_rows_bf16_live_kernel's signature and launcher.
template <int kRecord, bool kIlp, bool kCarry, bool kAny>
__global__ void __launch_bounds__(kThreads)
leaf_rows_live_kernel(const float* __restrict__ table, int table_rows,
                      const int* __restrict__ lists, int cap,
                      const int* __restrict__ n_rows,
                      const float* __restrict__ rays, int n_rays, int block_rays,
                      int split_rows, const float* __restrict__ t_in,
                      const int* __restrict__ r_in, const float* __restrict__ u_in,
                      const float* __restrict__ v_in, float* __restrict__ t_out,
                      int* __restrict__ r_out, float* __restrict__ u_out,
                      float* __restrict__ v_out,
                      unsigned long long* __restrict__ keys,
                      unsigned* __restrict__ arrivals) {
  static_assert(!(kAny && (kRecord == kBW || kIlp || kCarry)),
                "the any-hit trim is the sequential Möller–Trumbore test's, without carry-in");
  using Key = std::conditional_t<kAny, unsigned, unsigned long long>;
  constexpr int kSlotLane = kRecord == kBW ? 12 : 9;
  __shared__ float4 staged[kChunk * kLane / 4];
  __shared__ int live_lane[kThreads];
  __shared__ int warp_live[kThreads / 32];
  __shared__ bool last;

  const LiveBlock b = live_block(n_rows, table_rows, block_rays, split_rows);
  if (static_cast<int>(blockIdx.y) >= b.parts) return;

  const size_t stride = static_cast<size_t>(n_rays);  // rays is [7, n_rays]
  const size_t first = b.first;
  const float* start_t = kCarry ? t_in : rays + 6 * stride;
  const int n_live = surf::compact_live(
      start_t + first, b.slices, b.slice, b.slice == 0 && blockIdx.y == 0, live_lane,
      warp_live, [&](int lane, float t0) {
        write_start<kCarry>(first + lane, t0, r_in, u_in, v_in, t_out, r_out, u_out, v_out);
      });
  const int lo_rank = b.slice * kThreads;
  if (n_live <= lo_rank) return;
  __syncthreads();

  const int wid = threadIdx.x >> 5;
  const bool has_ray = lo_rank + static_cast<int>(threadIdx.x) < n_live;
  const bool warp_has = lo_rank + wid * 32 < n_live;
  const size_t ray = has_ray ? first + live_lane[threadIdx.x] : first;
  const float ox = rays[ray];
  const float oy = rays[stride + ray];
  const float oz = rays[2 * stride + ray];
  const float dx = rays[3 * stride + ray];
  const float dy = rays[4 * stride + ray];
  const float dz = rays[5 * stride + ray];
  const float t0 = start_t[ray];
  float best_t = t0;
  int best_pos = -1;

  const float4* table4 = reinterpret_cast<const float4*>(table);
  const int* list = lists + static_cast<size_t>(b.list_id) * cap;
  const int lo = blockIdx.y * split_rows;
  const int hi = min(b.count, lo + split_rows);
  for (int base = lo; base < hi; base += kChunk) {
    const int m = min(kChunk, hi - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < m * (kLane / 4); i += kThreads) {
      const int k = i / (kLane / 4);
      const int row = b.sweep ? base + k : list[base + k];
      staged[i] = table4[static_cast<size_t>(row) * (kLane / 4) + i % (kLane / 4)];
    }
    __syncthreads();
    if (!warp_has) continue;  // a warp without rays only keeps the barriers
    for (int k = 0; k < m; ++k) {
      const float4* row = staged + k * (kLane / 4);
      const int pos0 = (base + k) * kTris;
      const float row_t = best_t;
      const int row_pos = best_pos;
      const bool wide =
          kIlp ? ilp_row<kRecord>(row, pos0, ox, oy, oz, dx, dy, dz, best_t, best_pos)
               : seq_row<kRecord, kAny>(row, pos0, ox, oy, oz, dx, dy, dz, best_t, best_pos);
      if (wide) {  // a reciprocal out of the in-range path's range (never in
                   // a real scene): the row again with the IEEE division
        best_t = row_t;
        best_pos = row_pos;
        surf::row_exact<kRecord, kIlp>(row, pos0, ox, oy, oz, dx, dy, dz, best_t, best_pos);
      }
    }
  }

  // The merge: key = ~(t bits << 32 | position) (closest) or ~(t bits)
  // (trim); 0 = no hit.
  Key key = 0;
  if (has_ray && best_t < t0) {
    const unsigned tb = __float_as_uint(best_t);
    if constexpr (kAny) {
      key = ~tb;
    } else {
      key = ~((static_cast<unsigned long long>(tb) << 32) | static_cast<unsigned>(best_pos));
    }
  }
  if (!surf::merge_splits(key, has_ray, reinterpret_cast<Key*>(keys) + ray,
                          &arrivals[blockIdx.x], b.parts, &last))
    return;
  if (!has_ray) return;
  if (key == 0) {
    write_start<kCarry>(ray, t0, r_in, u_in, v_in, t_out, r_out, u_out, v_out);
    return;
  }
  if constexpr (kAny) {
    t_out[ray] = __uint_as_float(~key);
    r_out[ray] = 0;
    u_out[ray] = 0.0f;
    v_out[ray] = 0.0f;
  } else {
    const unsigned long long k = ~key;
    const int pos = static_cast<int>(k & 0xffffffffu);
    const int p = pos / kTris;
    const int row = b.sweep ? p : list[p];
    const float* rec = table + static_cast<size_t>(row) * kLane + (pos % kTris) * kRec;
    float t, u, v;
    record_hit<kRecord, false>(rec, ox, oy, oz, dx, dy, dz, CUDART_INF_F, t, u, v);
    t_out[ray] = __uint_as_float(static_cast<unsigned>(k >> 32));
    r_out[ray] = __float_as_int(rec[kSlotLane]);
    u_out[ray] = u;
    v_out[ray] = v;
  }
}

// leaf_rows_bf16_live_kernel: the bf16 sequential Möller–Trumbore closest
// hit (the `h` flag's record test, mt.cuh mt_hit_bf16), without (kCarry
// false) and with carry-in, with the function of leaf_rows_kernel<kMT,
// false, true, kCarry, false> bit for bit.  The first design (kept as the
// entry points leaf_rows_mt_bf16{,_carry}_closest_pr4) had every lane do
// the full work and one block walk a whole list, as row 1's did, and its
// arithmetic rounded each of ~45 f32 ops with a conversion to bf16 and one
// back (plus the record's nine lanes again at every test): a test cost
// about three times an f32 one.  This design takes row 1's structure
// (compaction, row splits, the (t, position) merge) and does the
// arithmetic as the TPU's bf16 path meant it, two results an instruction:
//
// 1. Live-ray compaction (compact_live).  A lane's start t is t_max, or
//    t_in with carry-in; it is live when that is above 1e-5 (NaN is not
//    live): a start t <= 1e-5 cannot pass `t >= eps & t < best_t`.  Dead
//    lanes get their start values, (t_max, -1, 0, 0) or (t_in, r_in, u_in,
//    v_in), from the block of slice 0, split 0.
// 2. Row splits and the exact merge, as leaf_rows_live_kernel: the least
//    (t, list position x 8 + j) below the start t.  bf16 t has 8
//    significant bits, so equal t at two positions is common here; the
//    position in the key keeps the first, as the sequential updates do.
//    The last split decodes the key, recomputes u and v with mt_hit_bf16 on
//    the winning record (the same rounded ops, the same bits) and reads r
//    from its lane 9; with no key the lane keeps its start values.
// 3. Records converted once, when staged.  A row is staged as 4 pairs of
//    records (j, j + 1), j = 0, 2, 4, 6: for each of lanes 0-8 one bf16x2
//    word, record j in the low half, padded to 12 words (three 16-byte
//    loads a pair): 192 bytes a row instead of 512.  The ray's six lanes
//    are rounded once at load and splatted into both halves.
// 4. The polynomial of two records in one packed op each (mt.cuh bmul2,
//    badd2, bsub2 in mt_hit_bf16's operand order, 44 for the two tests),
//    never contracted into an fma.  The reciprocal f = 1 / a is taken in
//    f32 on the widened a by the in-range path (mt.cuh rcp_in_range: the
//    IEEE bits for |a| < 2^126) and rounded by one cvt.rn.bf16x2.f32; a row
//    in which some |a| >= 2^126 (or inf) runs again with the IEEE division.
//    a, u, v and t are widened (a shift or a mask) for the compares, which
//    stay f32 as in mt_hit_bf16, record j's update before record j + 1's:
//    the polynomial does not read best_t, so the sequential strictly-closer
//    rule is kept.

constexpr int kPairWords = 12;               // a record pair: 9 bf16x2 lanes, 3 pad
constexpr int kRowQuads = kTris / 2 * kPairWords / 4;  // uint4 loads a staged row

struct RayBf2 {
  unsigned ox, oy, oz, dx, dy, dz;  // each lane rounded to bf16, in both halves
};

// The Möller–Trumbore polynomial of a record pair (w: lanes 0-8 as bf16x2
// words) against a ray: a, u, v, t of both records, as bf16x2 words.
// kExact takes f = 1 / a by the IEEE division.
template <bool kExact>
__device__ __forceinline__ void mt_pair_bf16x2(const unsigned* w, const RayBf2& r,
                                               unsigned& a, unsigned& u, unsigned& v,
                                               unsigned& t) {
  using surf::badd2;
  using surf::bmul2;
  using surf::bsub2;
  const unsigned v0x = w[0], v0y = w[1], v0z = w[2];
  const unsigned e1x = w[3], e1y = w[4], e1z = w[5];
  const unsigned e2x = w[6], e2y = w[7], e2z = w[8];
  const unsigned hx = bsub2(bmul2(r.dy, e2z), bmul2(r.dz, e2y));
  const unsigned hy = bsub2(bmul2(r.dz, e2x), bmul2(r.dx, e2z));
  const unsigned hz = bsub2(bmul2(r.dx, e2y), bmul2(r.dy, e2x));
  a = badd2(badd2(bmul2(e1x, hx), bmul2(e1y, hy)), bmul2(e1z, hz));
  const float a0 = surf::blo(a), a1 = surf::bhi(a);
  const unsigned f = kExact ? surf::bpack2(1.0f / a0, 1.0f / a1)
                            : surf::bpack2(surf::rcp_in_range(a0), surf::rcp_in_range(a1));
  const unsigned sx = bsub2(r.ox, v0x);
  const unsigned sy = bsub2(r.oy, v0y);
  const unsigned sz = bsub2(r.oz, v0z);
  u = bmul2(f, badd2(badd2(bmul2(sx, hx), bmul2(sy, hy)), bmul2(sz, hz)));
  const unsigned qx = bsub2(bmul2(sy, e1z), bmul2(sz, e1y));
  const unsigned qy = bsub2(bmul2(sz, e1x), bmul2(sx, e1z));
  const unsigned qz = bsub2(bmul2(sx, e1y), bmul2(sy, e1x));
  v = bmul2(f, badd2(badd2(bmul2(r.dx, qx), bmul2(r.dy, qy)), bmul2(r.dz, qz)));
  t = bmul2(f, badd2(badd2(bmul2(e2x, qx), bmul2(e2y, qy)), bmul2(e2z, qz)));
}

// mt_hit_bf16's compares of one record (f32, u + v an f32 add) and the
// strictly-closer update of (best_t, best_pos).
__device__ __forceinline__ void update_bf16(float a, float u, float v, float t, int pos,
                                            float& best_t, int& best_pos) {
  if ((fabsf(a) >= surf::kEps) & (u >= 0.0f) & (u <= 1.0f) & (v >= 0.0f) &
      (u + v <= 1.0f) & (t >= surf::kEps) & (t < best_t)) {
    best_t = t;
    best_pos = pos;
  }
}

// The tests of record pair p of a staged row, record 2p's update first;
// returns whether some |a| is out of the in-range reciprocal's range.
template <bool kExact>
__device__ __forceinline__ bool pair_tests(const uint4* row, int p, const RayBf2& ray,
                                           int pos0, float& best_t, int& best_pos) {
  const uint4 q0 = row[3 * p], q1 = row[3 * p + 1], q2 = row[3 * p + 2];
  const unsigned w[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
  unsigned a, u, v, t;
  mt_pair_bf16x2<kExact>(w, ray, a, u, v, t);
  const float a0 = surf::blo(a), a1 = surf::bhi(a);
  update_bf16(a0, surf::blo(u), surf::blo(v), surf::blo(t), pos0 + 2 * p, best_t, best_pos);
  update_bf16(a1, surf::bhi(u), surf::bhi(v), surf::bhi(t), pos0 + 2 * p + 1, best_t,
              best_pos);
  return (fabsf(a0) >= surf::kInRangeMax) | (fabsf(a1) >= surf::kInRangeMax);
}

template <bool kCarry>
__global__ void __launch_bounds__(kThreads)
leaf_rows_bf16_live_kernel(const float* __restrict__ table, int table_rows,
                           const int* __restrict__ lists, int cap,
                           const int* __restrict__ n_rows,
                           const float* __restrict__ rays, int n_rays, int block_rays,
                           int split_rows, const float* __restrict__ t_in,
                           const int* __restrict__ r_in, const float* __restrict__ u_in,
                           const float* __restrict__ v_in, float* __restrict__ t_out,
                           int* __restrict__ r_out, float* __restrict__ u_out,
                           float* __restrict__ v_out, unsigned long long* __restrict__ keys,
                           unsigned* __restrict__ arrivals) {
  __shared__ uint4 staged[kChunk * kRowQuads];
  __shared__ int live_lane[kThreads];
  __shared__ int warp_live[kThreads / 32];
  __shared__ bool last;

  const LiveBlock b = live_block(n_rows, table_rows, block_rays, split_rows);
  if (static_cast<int>(blockIdx.y) >= b.parts) return;

  const size_t stride = static_cast<size_t>(n_rays);  // rays is [7, n_rays]
  const size_t first = b.first;
  const float* start_t = kCarry ? t_in : rays + 6 * stride;
  const int n_live = surf::compact_live(
      start_t + first, b.slices, b.slice, b.slice == 0 && blockIdx.y == 0, live_lane,
      warp_live, [&](int lane, float t0) {
        write_start<kCarry>(first + lane, t0, r_in, u_in, v_in, t_out, r_out, u_out, v_out);
      });
  const int lo_rank = b.slice * kThreads;
  if (n_live <= lo_rank) return;
  __syncthreads();

  const int wid = threadIdx.x >> 5;
  const bool has_ray = lo_rank + static_cast<int>(threadIdx.x) < n_live;
  const bool warp_has = lo_rank + wid * 32 < n_live;
  const size_t ray = has_ray ? first + live_lane[threadIdx.x] : first;
  const float ox = surf::bf16(rays[ray]);
  const float oy = surf::bf16(rays[stride + ray]);
  const float oz = surf::bf16(rays[2 * stride + ray]);
  const float dx = surf::bf16(rays[3 * stride + ray]);
  const float dy = surf::bf16(rays[4 * stride + ray]);
  const float dz = surf::bf16(rays[5 * stride + ray]);
  const RayBf2 ray2{surf::bpack2(ox, ox), surf::bpack2(oy, oy), surf::bpack2(oz, oz),
                    surf::bpack2(dx, dx), surf::bpack2(dy, dy), surf::bpack2(dz, dz)};
  const float t0 = start_t[ray];
  float best_t = t0;
  int best_pos = -1;

  const float4* table4 = reinterpret_cast<const float4*>(table);
  const int* list = lists + static_cast<size_t>(b.list_id) * cap;
  __nv_bfloat16* halves = reinterpret_cast<__nv_bfloat16*>(staged);
  const int lo = blockIdx.y * split_rows;
  const int hi = min(b.count, lo + split_rows);
  for (int base = lo; base < hi; base += kChunk) {
    const int m = min(kChunk, hi - base);
    __syncthreads();  // every thread is done with the previous chunk
    // Item i of a row: record i / 3, its float4 i % 3 (lanes 0-11; 9-11
    // are not staged), each lane rounded to bf16 into its pair's word.
    for (int i = threadIdx.x; i < m * kTris * 3; i += kThreads) {
      const int k = i / (kTris * 3), j = i / 3 % kTris, part = i % 3;
      const int row = b.sweep ? base + k : list[base + k];
      const float4 x = table4[static_cast<size_t>(row) * (kLane / 4) + j * 4 + part];
      __nv_bfloat16* word = halves + 2 * (k * kRowQuads * 4 + (j / 2) * kPairWords +
                                          part * 4) + (j & 1);
      word[0] = __float2bfloat16_rn(x.x);
      if (part < 2) {
        word[2] = __float2bfloat16_rn(x.y);
        word[4] = __float2bfloat16_rn(x.z);
        word[6] = __float2bfloat16_rn(x.w);
      }
    }
    __syncthreads();
    if (!warp_has) continue;  // a warp without rays only keeps the barriers
    for (int k = 0; k < m; ++k) {
      const uint4* row = staged + k * kRowQuads;
      const int pos0 = (base + k) * kTris;
      const float row_t = best_t;
      const int row_pos = best_pos;
      bool wide = false;
#pragma unroll
      for (int p = 0; p < kTris / 2; ++p)
        wide |= pair_tests<false>(row, p, ray2, pos0, best_t, best_pos);
      if (wide) {  // a determinant out of the in-range reciprocal's range
                   // (never in a real scene): the row again with 1 / a
        best_t = row_t;
        best_pos = row_pos;
#pragma unroll 1
        for (int p = 0; p < kTris / 2; ++p)
          pair_tests<true>(row, p, ray2, pos0, best_t, best_pos);
      }
    }
  }

  // The merge: key = ~(t bits << 32 | position); 0 = no hit.
  unsigned long long key = 0;
  if (has_ray && best_t < t0)
    key = ~((static_cast<unsigned long long>(__float_as_uint(best_t)) << 32) |
            static_cast<unsigned>(best_pos));
  if (!surf::merge_splits(key, has_ray, keys + ray, &arrivals[blockIdx.x], b.parts, &last))
    return;
  if (!has_ray) return;
  if (key == 0) {
    write_start<kCarry>(ray, t0, r_in, u_in, v_in, t_out, r_out, u_out, v_out);
    return;
  }
  const unsigned long long k = ~key;
  const int pos = static_cast<int>(k & 0xffffffffu);
  const int p = pos / kTris;
  const int row = b.sweep ? p : list[p];
  const float4* rec = table4 + static_cast<size_t>(row) * (kLane / 4) + (pos % kTris) * 4;
  const float4 x = rec[0], y = rec[1], c = rec[2];
  using surf::bf16;
  float t, u, v;
  surf::mt_hit_bf16(bf16(x.x), bf16(x.y), bf16(x.z), bf16(x.w), bf16(y.x), bf16(y.y),
                    bf16(y.z), bf16(y.w), bf16(c.x), ox, oy, oz, dx, dy, dz, CUDART_INF_F, t,
                    u, v);
  t_out[ray] = __uint_as_float(static_cast<unsigned>(k >> 32));
  r_out[ray] = __float_as_int(c.y);
  u_out[ray] = u;
  v_out[ray] = v;
}

// The grid of the live kernels (leaf_rows_live_kernel,
// leaf_rows_bf16_live_kernel; one signature): (lists x slices, splits), the
// splits from max(cap, table_rows), which bounds every list's rows.
template <class Kernel>
int launch_live(Kernel kernel, const float* table, int table_rows, const int* lists, int cap,
                const int* n_rows, const float* rays, int n_rays, int block_rays,
                int split_rows, const float* t_in, const int* r_in, const float* u_in,
                const float* v_in, float* t, int* r, float* u, float* v,
                unsigned long long* keys, unsigned* arrivals, cudaStream_t stream) {
  if (split_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (max(cap, table_rows) + split_rows - 1) / split_rows;
  const dim3 grid(n_rays / kThreads, max(1, splits));
  kernel<<<grid, kThreads, 0, stream>>>(table, table_rows, lists, cap, n_rows, rays, n_rays,
                                        block_rays, split_rows, t_in, r_in, u_in, v_in, t, r,
                                        u, v, keys, arrivals);
  return static_cast<int>(cudaGetLastError());
}

// The packed ops alone, for the tests: out[i] = a[i] op b[i] on bf16x2
// words (op 0 mul, 1 add, 2 sub), one word a thread.
__global__ void bf16x2_probe_kernel(int op, const unsigned* __restrict__ a,
                                    const unsigned* __restrict__ b, unsigned* __restrict__ out,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = op == 0 ? surf::bmul2(a[i], b[i]) : op == 1 ? surf::badd2(a[i], b[i])
                                                       : surf::bsub2(a[i], b[i]);
}

}  // namespace

// Plain C entry points for ctypes, one per instantiation that a valid algo
// string reaches.  rays is [7, n_rays] (ox, oy, oz, dx, dy, dz, t_max);
// lists is [n_rays / block_rays, cap]; n_rows has one entry per list;
// t_in, r_in, u_in, v_in are [n_rays] and read only by the *_carry_*
// entry points (pass null elsewhere).  n_rays must be a positive multiple
// of block_rays, and block_rays a multiple of 256.  Returns
// cudaGetLastError() after the launch.
extern "C" int leaf_rows_threads_per_block() { return kThreads; }

#define SURF_LEAF_ROWS_ENTRY(name, rec, ilp, bf, carry, any)                   \
  extern "C" int name(const float* table, int table_rows, const int* lists,    \
                      int cap, const int* n_rows, const float* rays,           \
                      int n_rays, int block_rays, const float* t_in,           \
                      const int* r_in, const float* u_in, const float* v_in,   \
                      float* t, int* r, float* u, float* v,                    \
                      cudaStream_t stream) {                                   \
    return launch<rec, ilp, bf, carry, any>(table, table_rows, lists, cap,     \
                                            n_rows, rays, n_rays, block_rays,  \
                                            t_in, r_in, u_in, v_in, t, r, u,   \
                                            v, stream);                        \
  }

// The first design (reached only to time it beside the live kernels'
// entry points of the same function): Möller–Trumbore, f32, sequential,
// closest hit and any-hit trim (_pr1) and with carry-in; in bf16 (h),
// without and with carry-in; with the ILP merge (i); Baldwin–Weber (w),
// sequential and with the ILP merge (wi), each without and with carry-in.
SURF_LEAF_ROWS_ENTRY(leaf_rows_closest_pr1, kMT, false, false, false, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_any_pr1, kMT, false, false, false, true)
SURF_LEAF_ROWS_ENTRY(leaf_rows_mt_carry_closest_pr4, kMT, false, false, true, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_mt_bf16_closest_pr4, kMT, false, true, false, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_mt_bf16_carry_closest_pr4, kMT, false, true, true, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_mt_ilp_closest_pr4, kMT, true, false, false, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_mt_ilp_carry_closest_pr4, kMT, true, false, true, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_bw_closest_pr4, kBW, false, false, false, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_bw_carry_closest_pr4, kBW, false, false, true, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_bw_ilp_closest_pr4, kBW, true, false, false, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_bw_ilp_carry_closest_pr4, kBW, true, false, true, false)

// The live kernels.  The arguments of the entry points above, and:
// split_rows (K, > 0), the rows of a split, after block_rays; keys, [n_rays]
// 64-bit words, and arrivals, [n_rays / 256] 32-bit words, the merge's
// scratch, all zero before the launch and left all zero after it (a scratch
// serves one stream: accel/leaf_rows.py merge_scratch).
#define SURF_LEAF_ROWS_LIVE_ENTRY(name, ...)                                         \
  extern "C" int name(const float* table, int table_rows, const int* lists,         \
                      int cap, const int* n_rows, const float* rays, int n_rays,    \
                      int block_rays, int split_rows, const float* t_in,            \
                      const int* r_in, const float* u_in, const float* v_in,        \
                      float* t, int* r, float* u, float* v, unsigned long long* keys, \
                      unsigned* arrivals, cudaStream_t stream) {                    \
    return launch_live(__VA_ARGS__, table, table_rows, lists, cap, n_rows, rays,    \
                       n_rays, \
                       block_rays, split_rows, t_in, r_in, u_in, v_in, t, r, u, v,  \
                       keys, arrivals, stream);                                     \
  }

// The f32 record tests, through leaf_rows_live_kernel<kRecord, kIlp,
// kCarry, kAny>: Möller–Trumbore, sequential, closest hit and the any-hit
// trim (bitsru8, bits, bits8; bitsp's overflow fallback), and with
// carry-in (bits2's round B); with the ILP merge (bitsi, bits2i);
// Baldwin–Weber, sequential (bitsw, bits2w) and with the ILP merge
// (bitswi, bits2wi).
SURF_LEAF_ROWS_LIVE_ENTRY(leaf_rows_closest, leaf_rows_live_kernel<kMT, false, false, false>)
SURF_LEAF_ROWS_LIVE_ENTRY(leaf_rows_any, leaf_rows_live_kernel<kMT, false, false, true>)
SURF_LEAF_ROWS_LIVE_ENTRY(leaf_rows_mt_carry_closest,
                          leaf_rows_live_kernel<kMT, false, true, false>)
SURF_LEAF_ROWS_LIVE_ENTRY(leaf_rows_mt_ilp_closest, leaf_rows_live_kernel<kMT, true, false, false>)
SURF_LEAF_ROWS_LIVE_ENTRY(leaf_rows_mt_ilp_carry_closest,
                          leaf_rows_live_kernel<kMT, true, true, false>)
SURF_LEAF_ROWS_LIVE_ENTRY(leaf_rows_bw_closest, leaf_rows_live_kernel<kBW, false, false, false>)
SURF_LEAF_ROWS_LIVE_ENTRY(leaf_rows_bw_carry_closest,
                          leaf_rows_live_kernel<kBW, false, true, false>)
SURF_LEAF_ROWS_LIVE_ENTRY(leaf_rows_bw_ilp_closest, leaf_rows_live_kernel<kBW, true, false, false>)
SURF_LEAF_ROWS_LIVE_ENTRY(leaf_rows_bw_ilp_carry_closest,
                          leaf_rows_live_kernel<kBW, true, true, false>)
// Möller–Trumbore in bf16, sequential, through leaf_rows_bf16_live_kernel:
// without and with carry-in (bitsh; bits2h's round B).
SURF_LEAF_ROWS_LIVE_ENTRY(leaf_rows_mt_bf16_closest, leaf_rows_bf16_live_kernel<false>)
SURF_LEAF_ROWS_LIVE_ENTRY(leaf_rows_mt_bf16_carry_closest, leaf_rows_bf16_live_kernel<true>)

// bf16x2_probe_kernel on n words (op 0 mul, 1 add, 2 sub).
extern "C" int leaf_rows_bf16x2_probe(int op, const unsigned* a, const unsigned* b,
                                      unsigned* out, int n, cudaStream_t stream) {
  if (op < 0 || op > 2 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  bf16x2_probe_kernel<<<(n + 255) / 256, 256, 0, stream>>>(op, a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}

// The kernel each of the designs' entry points launches (entry.cuh).
SURF_KERNEL_OF(leaf_rows_closest, leaf_rows_live_kernel<kMT, false, false, false>)
SURF_KERNEL_OF(leaf_rows_any, leaf_rows_live_kernel<kMT, false, false, true>)
SURF_KERNEL_OF(leaf_rows_mt_carry_closest, leaf_rows_live_kernel<kMT, false, true, false>)
SURF_KERNEL_OF(leaf_rows_mt_ilp_closest, leaf_rows_live_kernel<kMT, true, false, false>)
SURF_KERNEL_OF(leaf_rows_mt_ilp_carry_closest, leaf_rows_live_kernel<kMT, true, true, false>)
SURF_KERNEL_OF(leaf_rows_bw_closest, leaf_rows_live_kernel<kBW, false, false, false>)
SURF_KERNEL_OF(leaf_rows_bw_carry_closest, leaf_rows_live_kernel<kBW, false, true, false>)
SURF_KERNEL_OF(leaf_rows_bw_ilp_closest, leaf_rows_live_kernel<kBW, true, false, false>)
SURF_KERNEL_OF(leaf_rows_bw_ilp_carry_closest, leaf_rows_live_kernel<kBW, true, true, false>)
SURF_KERNEL_OF(leaf_rows_mt_bf16_closest, leaf_rows_bf16_live_kernel<false>)
SURF_KERNEL_OF(leaf_rows_mt_bf16_carry_closest, leaf_rows_bf16_live_kernel<true>)
SURF_KERNEL_OF(leaf_rows_closest_pr1, leaf_rows_kernel<kMT, false, false, false, false>)
SURF_KERNEL_OF(leaf_rows_any_pr1, leaf_rows_kernel<kMT, false, false, false, true>)
SURF_KERNEL_OF(leaf_rows_mt_carry_closest_pr4, leaf_rows_kernel<kMT, false, false, true, false>)
SURF_KERNEL_OF(leaf_rows_mt_bf16_closest_pr4, leaf_rows_kernel<kMT, false, true, false, false>)
SURF_KERNEL_OF(leaf_rows_mt_bf16_carry_closest_pr4,
               leaf_rows_kernel<kMT, false, true, true, false>)
SURF_KERNEL_OF(leaf_rows_mt_ilp_closest_pr4, leaf_rows_kernel<kMT, true, false, false, false>)
SURF_KERNEL_OF(leaf_rows_mt_ilp_carry_closest_pr4, leaf_rows_kernel<kMT, true, false, true, false>)
SURF_KERNEL_OF(leaf_rows_bw_closest_pr4, leaf_rows_kernel<kBW, false, false, false, false>)
SURF_KERNEL_OF(leaf_rows_bw_carry_closest_pr4, leaf_rows_kernel<kBW, false, false, true, false>)
SURF_KERNEL_OF(leaf_rows_bw_ilp_closest_pr4, leaf_rows_kernel<kBW, true, false, false, false>)
SURF_KERNEL_OF(leaf_rows_bw_ilp_carry_closest_pr4, leaf_rows_kernel<kBW, true, false, true, false>)

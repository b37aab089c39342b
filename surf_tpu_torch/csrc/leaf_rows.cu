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
// Two designs.  The closest-hit and any-hit trim entry points of the f32
// sequential Möller–Trumbore test (leaf_rows_closest, leaf_rows_any), which
// every bitsru8 frame runs, use leaf_rows_live_kernel (below).  The other
// nine entry points, and the same two as leaf_rows_{closest,any}_pr1 (kept
// to time the designs side by side), use leaf_rows_kernel:
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
#include "mt.cuh"

namespace {

constexpr int kLane = 128;    // floats per leaf-table row
constexpr int kRec = 16;      // floats per triangle record
constexpr int kTris = 8;      // triangles per row
constexpr int kThreads = 256; // rays per block
constexpr int kChunk = 32;    // rows staged in shared memory at a time
constexpr int kUnroll = 8;    // t_max loads in flight a thread (compaction)

enum Record { kMT = 0, kBW = 1 };

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

// leaf_rows_live_kernel: the closest hit (kAny false) or the any-hit trim
// (kAny true) of the f32 sequential Möller–Trumbore test, with the function
// of leaf_rows_kernel<kMT, false, false, false, kAny> bit for bit.  What held
// the first design back: every lane did the full work, dead ones too (a
// dead lane has t_max = -FAR; a frame's later waves and its shadow rays are
// mostly dead lanes), and one block walked a whole list, so a launch ended
// with its longest list and the ladder's narrow tail waves left most of the
// card idle.  So:
//
// 1. Live-ray compaction.  A lane is live when its t_max > 1e-5 (NaN is not
//    live); a dead lane fails `t >= eps & t < t_max` for every record, so
//    its result is its start value (t_max, -1, 0, 0), which the block of
//    slice 0, split 0 of its list writes.  Each block counts its list's
//    live lanes with one block scan and takes the live lanes of rank
//    [256 s, 256 s + 256) for its slice s; a slice with none exits.
// 2. Row-split work items.  The grid is (lists x slices, splits): split y
//    tests rows [y K, y K + K) of the list (K = split_rows, staged kChunk
//    rows at a time); the host sizes the splits from max(cap, table rows),
//    so it never reads n_rows, and a split past the list's rows exits.
//    Split 0 always takes part, so a list of 0 rows still writes its rays.
// 3. An exact merge.  The sequential result is the least (t, list position
//    x 8 + j) over the hits below t_max.  A split's running best gives its
//    share of that; the splits of a list merge through a 64-bit atomicMax
//    of the inverted key (float bits of t above the position: t >= 1e-5 > 0,
//    so the bits order as the values) into a per-call scratch (keys[ray],
//    0 = no hit), and the last split to arrive (a counter and
//    __threadfence, the threadfence-reduction pattern) reads the key,
//    resets it and the counter to 0, recomputes u and v with the same
//    mt_hit on the winning record (same ops, same bits) and reads r from
//    its lane 9.  The trim keeps only t: a 32-bit key.  A list of one split
//    skips the scratch.  One launch a call: the scratch is all zero before
//    and after it.
// 4. Inside a block: a record is read as three float4 (lanes 0-11, LDS.128
//    broadcasts), and only (t, position) is carried through the loop.  The
//    record test takes 1 / a by the in-range path of nvcc's reciprocal
//    (mt.cuh rcp_in_range: the same bits for |a| < 2^126) without nvcc's
//    per-test range check and branch; a row in which some |a| >= 2^126
//    (or inf) runs again from its start with the IEEE division.

// One row's 8 record tests with the IEEE division, sequential
// strictly-closer updates of (best_t, best_pos) from position pos0: the
// rare path of leaf_rows_live_kernel, inlined as a loop of its own (not
// unrolled; as a __noinline__ call it cost the hot loop registers and time).
__device__ __forceinline__ void row_exact(const float4* row, int pos0, float ox, float oy,
                                          float oz, float dx, float dy, float dz,
                                          float& best_t, int& best_pos) {
#pragma unroll 1
  for (int j = 0; j < kTris; ++j) {
    const float4 a = row[j * 4], b = row[j * 4 + 1], c = row[j * 4 + 2];
    float t, u, v;
    if (surf::mt_hit(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ox, oy, oz, dx, dy,
                     dz, best_t, t, u, v)) {
      best_t = t;
      best_pos = pos0 + j;
    }
  }
}

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
leaf_rows_live_kernel(const float* __restrict__ table, int table_rows,
                      const int* __restrict__ lists, int cap,
                      const int* __restrict__ n_rows,
                      const float* __restrict__ rays, int n_rays, int block_rays,
                      int split_rows, float* __restrict__ t_out,
                      int* __restrict__ r_out, float* __restrict__ u_out,
                      float* __restrict__ v_out,
                      unsigned long long* __restrict__ keys,
                      unsigned* __restrict__ arrivals) {
  using Key = std::conditional_t<kAny, unsigned, unsigned long long>;
  __shared__ float4 staged[kChunk * kLane / 4];
  __shared__ int live_lane[kThreads];
  __shared__ int warp_live[kThreads / 32];
  __shared__ bool last;

  const int slices = block_rays / kThreads;  // also the lanes per thread
  const int list_id = blockIdx.x / slices;
  const int slice = blockIdx.x % slices;
  int count = n_rows[list_id];
  const bool sweep = count < 0;
  if (sweep) count = table_rows;
  const int parts = max(1, (count + split_rows - 1) / split_rows);
  if (static_cast<int>(blockIdx.y) >= parts) return;
  const bool writes_dead = slice == 0 && blockIdx.y == 0;

  // Compaction: thread i owns lanes [i * slices, (i + 1) * slices) of the
  // list; one block scan of the per-thread live counts ranks the live lanes.
  // The t_max loads go kUnroll at a time, all in flight together.
  const size_t stride = static_cast<size_t>(n_rays);  // rays is [7, n_rays]
  const size_t first = static_cast<size_t>(list_id) * block_rays;
  const float* tm_of = rays + 6 * stride + first;
  const int lane0 = threadIdx.x * slices;
  int mine = 0;
  for (int i0 = 0; i0 < slices; i0 += kUnroll) {
    float tmv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) tmv[i] = i0 + i < slices ? tm_of[lane0 + i0 + i] : 0.0f;
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) mine += tmv[i] > surf::kEps;
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
  for (int w = 0; w < kThreads / 32; ++w) {
    const int c = warp_live[w];
    before += w < wid ? c : 0;
    n_live += c;
  }
  int rank = before + incl - mine;
  const int lo_rank = slice * kThreads;
  for (int i = 0; i < slices; ++i) {  // the loads above left these in L1
    const int lane = lane0 + i;
    const float tm = tm_of[lane];
    if (tm > surf::kEps) {
      if (rank >= lo_rank && rank < lo_rank + kThreads) live_lane[rank - lo_rank] = lane;
      ++rank;
    } else if (writes_dead) {
      t_out[first + lane] = tm;
      r_out[first + lane] = -1;
      u_out[first + lane] = 0.0f;
      v_out[first + lane] = 0.0f;
    }
  }
  if (n_live <= lo_rank) return;
  __syncthreads();

  const bool has_ray = lo_rank + static_cast<int>(threadIdx.x) < n_live;
  const bool warp_has = lo_rank + wid * 32 < n_live;
  const size_t ray = has_ray ? first + live_lane[threadIdx.x] : first;
  const float ox = rays[ray];
  const float oy = rays[stride + ray];
  const float oz = rays[2 * stride + ray];
  const float dx = rays[3 * stride + ray];
  const float dy = rays[4 * stride + ray];
  const float dz = rays[5 * stride + ray];
  const float tm = rays[6 * stride + ray];
  float best_t = tm;
  int best_pos = -1;

  const float4* table4 = reinterpret_cast<const float4*>(table);
  const int* list = lists + static_cast<size_t>(list_id) * cap;
  const int lo = blockIdx.y * split_rows;
  const int hi = min(count, lo + split_rows);
  for (int base = lo; base < hi; base += kChunk) {
    const int m = min(kChunk, hi - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < m * (kLane / 4); i += kThreads) {
      const int k = i / (kLane / 4);
      const int row = sweep ? base + k : list[base + k];
      staged[i] = table4[static_cast<size_t>(row) * (kLane / 4) + i % (kLane / 4)];
    }
    __syncthreads();
    if (!warp_has) continue;  // a warp without rays only keeps the barriers
    for (int k = 0; k < m; ++k) {
      const float4* row = staged + k * (kLane / 4);
      const float row_t = best_t;
      const int row_pos = best_pos;
      bool wide = false;
#pragma unroll
      for (int j = 0; j < kTris; ++j) {
        const float4 a = row[j * 4], b = row[j * 4 + 1], c = row[j * 4 + 2];
        float t, u, v, det;
        if (surf::mt_hit_a<surf::Recip::kInRange>(a.x, a.y, a.z, a.w, b.x, b.y, b.z,
                                                  b.w, c.x, ox, oy, oz, dx, dy, dz,
                                                  best_t, t, u, v, det)) {
          best_t = t;
          if (!kAny) best_pos = (base + k) * kTris + j;
        }
        wide |= fabsf(det) >= surf::kInRangeMax;
      }
      if (wide) {  // a determinant out of the in-range reciprocal's range
                   // (never in a real scene): the row again with 1 / a
        best_t = row_t;
        best_pos = row_pos;
        row_exact(row, (base + k) * kTris, ox, oy, oz, dx, dy, dz, best_t, best_pos);
      }
    }
  }

  // The merge: key = ~(t bits << 32 | position) (closest) or ~(t bits)
  // (trim); 0 = no hit.
  Key key = 0;
  if (has_ray && best_t < tm) {
    const unsigned tb = __float_as_uint(best_t);
    if constexpr (kAny) {
      key = ~tb;
    } else {
      key = ~((static_cast<unsigned long long>(tb) << 32) | static_cast<unsigned>(best_pos));
    }
  }
  if (parts > 1) {
    Key* slot = reinterpret_cast<Key*>(keys) + ray;
    if (key != 0) atomicMax(slot, key);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&arrivals[blockIdx.x], 1u) == static_cast<unsigned>(parts - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (has_ray) key = atomicExch(slot, Key(0));
    if (threadIdx.x == 0) arrivals[blockIdx.x] = 0u;
  }
  if (!has_ray) return;
  if (key == 0) {
    t_out[ray] = tm;
    r_out[ray] = -1;
    u_out[ray] = 0.0f;
    v_out[ray] = 0.0f;
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
    const int row = sweep ? p : list[p];
    const float4* rec = table4 + static_cast<size_t>(row) * (kLane / 4) + (pos % kTris) * 4;
    const float4 a = rec[0], b = rec[1], c = rec[2];
    float t, u, v;
    surf::mt_hit(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ox, oy, oz, dx, dy, dz,
                 CUDART_INF_F, t, u, v);
    t_out[ray] = __uint_as_float(static_cast<unsigned>(k >> 32));
    r_out[ray] = __float_as_int(c.y);
    u_out[ray] = u;
    v_out[ray] = v;
  }
}

// The grid of leaf_rows_live_kernel: (lists x slices, splits), the splits
// from max(cap, table_rows), which bounds every list's rows.
template <bool kAny>
int launch_live(const float* table, int table_rows, const int* lists, int cap,
                const int* n_rows, const float* rays, int n_rays, int block_rays,
                int split_rows, float* t, int* r, float* u, float* v,
                unsigned long long* keys, unsigned* arrivals, cudaStream_t stream) {
  if (split_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (max(cap, table_rows) + split_rows - 1) / split_rows;
  const dim3 grid(n_rays / kThreads, max(1, splits));
  leaf_rows_live_kernel<kAny><<<grid, kThreads, 0, stream>>>(
      table, table_rows, lists, cap, n_rows, rays, n_rays, block_rays, split_rows,
      t, r, u, v, keys, arrivals);
  return static_cast<int>(cudaGetLastError());
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

// Möller–Trumbore, f32, sequential: the first design's closest hit and
// any-hit trim (reached only to time it beside leaf_rows_closest and
// leaf_rows_any), and with carry-in (bits2).
SURF_LEAF_ROWS_ENTRY(leaf_rows_closest_pr1, kMT, false, false, false, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_any_pr1, kMT, false, false, false, true)
SURF_LEAF_ROWS_ENTRY(leaf_rows_mt_carry_closest, kMT, false, false, true, false)
// Möller–Trumbore in bf16 (h), without and with carry-in.
SURF_LEAF_ROWS_ENTRY(leaf_rows_mt_bf16_closest, kMT, false, true, false, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_mt_bf16_carry_closest, kMT, false, true, true, false)
// Möller–Trumbore with the ILP merge (i).
SURF_LEAF_ROWS_ENTRY(leaf_rows_mt_ilp_closest, kMT, true, false, false, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_mt_ilp_carry_closest, kMT, true, false, true, false)
// Baldwin–Weber (w), sequential and with the ILP merge (wi).
SURF_LEAF_ROWS_ENTRY(leaf_rows_bw_closest, kBW, false, false, false, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_bw_carry_closest, kBW, false, false, true, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_bw_ilp_closest, kBW, true, false, false, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_bw_ilp_carry_closest, kBW, true, false, true, false)

// Möller–Trumbore, f32, sequential, through leaf_rows_live_kernel: closest
// hit and the any-hit trim (bitsru8, bits, bits8; bitsp's overflow
// fallback).  The arguments of the entry points above without the carry-in,
// and: split_rows (K, > 0), the rows of a split; keys, [n_rays] 64-bit
// words, and arrivals, [n_rays / 256] 32-bit words, the merge's scratch,
// all zero before the launch and left all zero after it (one stream at a
// time).
#define SURF_LEAF_ROWS_LIVE_ENTRY(name, any)                                      \
  extern "C" int name(const float* table, int table_rows, const int* lists,       \
                      int cap, const int* n_rows, const float* rays, int n_rays,  \
                      int block_rays, int split_rows, float* t, int* r, float* u, \
                      float* v, unsigned long long* keys, unsigned* arrivals,     \
                      cudaStream_t stream) {                                      \
    return launch_live<any>(table, table_rows, lists, cap, n_rows, rays, n_rays,  \
                            block_rays, split_rows, t, r, u, v, keys, arrivals,   \
                            stream);                                              \
  }

SURF_LEAF_ROWS_LIVE_ENTRY(leaf_rows_closest, false)
SURF_LEAF_ROWS_LIVE_ENTRY(leaf_rows_any, true)

// The kernel each of the two designs' entry points launches (entry.cuh).
SURF_KERNEL_OF(leaf_rows_closest, leaf_rows_live_kernel<false>)
SURF_KERNEL_OF(leaf_rows_any, leaf_rows_live_kernel<true>)
SURF_KERNEL_OF(leaf_rows_closest_pr1, leaf_rows_kernel<kMT, false, false, false, false>)
SURF_KERNEL_OF(leaf_rows_any_pr1, leaf_rows_kernel<kMT, false, false, false, true>)

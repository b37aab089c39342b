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
// Design: one thread per ray, 256 rays per block; a list of block_rays rays
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

#include "mt.cuh"

namespace {

constexpr int kLane = 128;    // floats per leaf-table row
constexpr int kRec = 16;      // floats per triangle record
constexpr int kTris = 8;      // triangles per row
constexpr int kThreads = 256; // rays per block
constexpr int kChunk = 32;    // rows staged in shared memory at a time

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

// Möller–Trumbore, f32, sequential: closest hit and the any-hit trim
// (bitsru8, bits, bits8; bitsp's overflow fallback), and with carry-in (bits2).
SURF_LEAF_ROWS_ENTRY(leaf_rows_closest, kMT, false, false, false, false)
SURF_LEAF_ROWS_ENTRY(leaf_rows_any, kMT, false, false, false, true)
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

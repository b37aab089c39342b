// Leaf-row Möller–Trumbore intersection for the bitsru8 traversal.
//
// Replaces surf_tpu/accel/pallas_wide.py `_leaf_rows_kernel` (with `_mt8`
// and `_mt8_any`) in its three modes on the bench path: closest hit over a
// packet's exact candidate-row list, the any-hit trim for shadow rays, and
// the sweep over the whole leaf table for packets whose list overflowed.
//
// What bounds it on the card: every (ray, triangle) test is ~45 FLOPs plus
// an IEEE division, against 40 bytes of the triangle's record (v0, e1, e2,
// slot id) that every ray of the packet reads.  A 2048-ray packet reuses
// each 512-byte row 2048 times, so the loop is compute-bound once rows are
// staged on chip; fetching them per ray from L2 would make it bound by L2
// bandwidth instead.
//
// Design: one thread per ray, 256 rays per block; a packet of block_rays
// rays is served by block_rays / 256 blocks that all walk the packet's
// list.  Rows are read by row id straight from the leaf table (no gathered
// copy of the list's rows), staged kChunk rows at a time through shared
// memory with 16-byte loads, and then read by every thread of the block at
// the same address (a broadcast, free of bank conflicts).
//
// Semantics kept from the TPU kernel: rows in list order, triangles j = 0..7
// within a row, replacement only on a strictly closer t; the arithmetic is
// mt.cuh's (f = 1 / a is an IEEE division); the NaNs of all-zero (inert)
// rows fail every compare; the slot id is the int32 bit pattern of lane 9
// of the record.  A list length
// below zero selects the sweep over all table rows, and a packet whose
// length is 0 (no live ray) reads no rows.  Build with --fmad=false so the
// arithmetic rounds exactly as the plain PyTorch version's separate ops do.

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr int kLane = 128;    // floats per leaf-table row
constexpr int kRec = 16;      // floats per triangle record
constexpr int kTris = 8;      // triangles per row
constexpr int kThreads = 256; // rays per block
constexpr int kChunk = 32;    // rows staged in shared memory at a time

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
leaf_rows_kernel(const float* __restrict__ table, int table_rows,
                 const int* __restrict__ lists, int cap,
                 const int* __restrict__ n_rows,
                 const float* __restrict__ rays, int n_rays, int block_rays,
                 float* __restrict__ t_out, int* __restrict__ r_out,
                 float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float4 staged[kChunk * kLane / 4];
  const int first = blockIdx.x * kThreads;
  const int ray = first + threadIdx.x;
  const int packet = first / block_rays;
  int count = n_rows[packet];
  const bool sweep = count < 0;
  if (sweep) count = table_rows;

  const size_t stride = static_cast<size_t>(n_rays);  // rays is [7, n_rays]
  const float ox = rays[ray];
  const float oy = rays[stride + ray];
  const float oz = rays[2 * stride + ray];
  const float dx = rays[3 * stride + ray];
  const float dy = rays[4 * stride + ray];
  const float dz = rays[5 * stride + ray];
  const float tm = rays[6 * stride + ray];
  float best_t = tm;
  int best_r = -1;
  float best_u = 0.0f;
  float best_v = 0.0f;

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
#pragma unroll
      for (int j = 0; j < kTris; ++j) {
        const float* rec = rows + k * kLane + j * kRec;
        float t, u, v;
        const bool hit = surf::mt_hit(rec[0], rec[1], rec[2], rec[3], rec[4],
                                      rec[5], rec[6], rec[7], rec[8], ox, oy,
                                      oz, dx, dy, dz, best_t, t, u, v);
        if (hit) {
          best_t = t;
          if (!kAny) {
            best_r = __float_as_int(rec[9]);
            best_u = u;
            best_v = v;
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

template <bool kAny>
int launch(const float* table, int table_rows, const int* lists, int cap,
           const int* n_rows, const float* rays, int n_rays, int block_rays,
           float* t, int* r, float* u, float* v, cudaStream_t stream) {
  leaf_rows_kernel<kAny><<<n_rays / kThreads, kThreads, 0, stream>>>(
      table, table_rows, lists, cap, n_rows, rays, n_rays, block_rays, t, r,
      u, v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  rays is [7, n_rays] (ox, oy, oz, dx, dy,
// dz, t_max); lists is [n_rays / block_rays, cap]; n_rows has one entry per
// packet.  n_rays must be a positive multiple of block_rays, and block_rays
// a multiple of 256.  Returns cudaGetLastError() after the launch.
extern "C" int leaf_rows_threads_per_block() { return kThreads; }

extern "C" int leaf_rows_closest(const float* table, int table_rows,
                                 const int* lists, int cap, const int* n_rows,
                                 const float* rays, int n_rays, int block_rays,
                                 float* t, int* r, float* u, float* v,
                                 cudaStream_t stream) {
  return launch<false>(table, table_rows, lists, cap, n_rows, rays, n_rays,
                       block_rays, t, r, u, v, stream);
}

extern "C" int leaf_rows_any(const float* table, int table_rows,
                             const int* lists, int cap, const int* n_rows,
                             const float* rays, int n_rays, int block_rays,
                             float* t, int* r, float* u, float* v,
                             cudaStream_t stream) {
  return launch<true>(table, table_rows, lists, cap, n_rows, rays, n_rays,
                      block_rays, t, r, u, v, stream);
}

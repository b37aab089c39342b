// Instanced leaf-row Möller–Trumbore intersection for the pure two-level
// traversal (algo="twolevelp").
//
// Replaces surf_tpu/accel/pallas_instanced.py `_inst_rows_kernel` (with
// `_mt8i`): per packet, one segment per instance in ascending instance
// order, each transforming the ray into the instance's object space with
// the 12 scalars of its inverse 3x4 and intersecting the rows of the shared
// mesh table that the segment lists, carrying (t, slot, u, v, instance).
//
// What bounds it on the card: as leaf_rows.cu, every (ray, triangle) test
// is ~45 FLOPs plus an IEEE division against a 40-byte record that every
// ray of the packet reads, so with rows staged on chip the loop is
// compute-bound.  The object-space transform is 15 multiplies and adds per
// ray and segment, small beside the 8 tests of even one row.
//
// Design: leaf_rows.cu's shape.  One thread per ray, 256 rays per block; a
// packet of block_rays rays is served by block_rays / 256 blocks that each
// walk the packet's segments.  The instance count is a runtime loop bound:
// the TPU kernel unrolled one segment per instance at trace time, which
// made its compile time grow with the instance count; here the instance
// id, its segment and its transform are data.  A segment's count is the
// same for every thread of the block, so a block skips a segment with no
// listed rows as a whole and the __syncthreads() of the staging loop stay
// uniform.  Rows are read by id from the table, staged kChunk rows at a
// time through shared memory with 16-byte loads, and read back by every
// thread at one address (a broadcast).  The 12 transform scalars of a
// segment are read at one address by all threads (a broadcast in L1).
//
// Semantics kept from the TPU kernel: the object-space ray is computed per
// segment as ((a0*x + a1*y) + a2*z) + a3 (direction without a3, not
// normalised, so t is the world parameter), in the order of the torch
// phase 1; instances ascending, rows ascending, the 8 records in order,
// replacement only on a strictly closer t; the arithmetic is mt.cuh's;
// NaNs of all-zero rows fail every compare; the slot is the int32 bit
// pattern of lane 9.  A negative count sweeps the instance's whole mesh
// (its first table row and row count rounded up to 8) in leaf order, which
// gives the list's winner.  Build with --fmad=false so the arithmetic
// rounds as the plain PyTorch version's separate ops do.

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
inst_rows_kernel(const float* __restrict__ table,
                 const int* __restrict__ lists, int cap_tot,
                 const int* __restrict__ counts, int n_inst,
                 const int* __restrict__ segs, const float* __restrict__ inv,
                 const float* __restrict__ rays, int n_rays, int block_rays,
                 float* __restrict__ t_out, int* __restrict__ r_out,
                 float* __restrict__ u_out, float* __restrict__ v_out,
                 int* __restrict__ i_out) {
  __shared__ float4 staged[kChunk * kLane / 4];
  const int first = blockIdx.x * kThreads;
  const int ray = first + threadIdx.x;
  const int packet = first / block_rays;

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
  int best_i = -1;

  const int* seg_off = segs;           // segs is [3, n_inst]
  const int* row0 = segs + n_inst;
  const int* rows8 = segs + 2 * n_inst;
  const int* list = lists + static_cast<size_t>(packet) * cap_tot;
  const int* count_of = counts + static_cast<size_t>(packet) * n_inst;
  const float4* table4 = reinterpret_cast<const float4*>(table);
  const float* rows = reinterpret_cast<const float*>(staged);

  for (int inst = 0; inst < n_inst; ++inst) {
    int count = count_of[inst];  // the same for the whole block
    if (count == 0) continue;
    const bool sweep = count < 0;
    if (sweep) count = rows8[inst];
    const int base = sweep ? row0[inst] : seg_off[inst];
    const float* a = inv + 12 * inst;
    const float a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];
    const float a4 = a[4], a5 = a[5], a6 = a[6], a7 = a[7];
    const float a8 = a[8], a9 = a[9], a10 = a[10], a11 = a[11];
    const float oxi = a0 * ox + a1 * oy + a2 * oz + a3;
    const float oyi = a4 * ox + a5 * oy + a6 * oz + a7;
    const float ozi = a8 * ox + a9 * oy + a10 * oz + a11;
    const float dxi = a0 * dx + a1 * dy + a2 * dz;
    const float dyi = a4 * dx + a5 * dy + a6 * dz;
    const float dzi = a8 * dx + a9 * dy + a10 * dz;

    for (int b = 0; b < count; b += kChunk) {
      const int m = min(kChunk, count - b);
      __syncthreads();  // every thread is done with the previous chunk
      for (int i = threadIdx.x; i < m * (kLane / 4); i += kThreads) {
        const int k = i / (kLane / 4);
        const int row = sweep ? base + b + k : list[base + b + k];
        staged[i] = table4[static_cast<size_t>(row) * (kLane / 4) + i % (kLane / 4)];
      }
      __syncthreads();
      for (int k = 0; k < m; ++k) {
#pragma unroll
        for (int j = 0; j < kTris; ++j) {
          const float* rec = rows + k * kLane + j * kRec;
          float t, u, v;
          const bool hit = surf::mt_hit(
              rec[0], rec[1], rec[2], rec[3], rec[4], rec[5], rec[6], rec[7],
              rec[8], oxi, oyi, ozi, dxi, dyi, dzi, best_t, t, u, v);
          if (hit) {
            best_t = t;
            best_i = inst;
            if (!kAny) {
              best_r = __float_as_int(rec[9]);
              best_u = u;
              best_v = v;
            }
          }
        }
      }
    }
  }
  t_out[ray] = best_t;
  i_out[ray] = best_i;
  if (kAny) {
    // Occlusion only: slot 0 (occluded) or -1, u = v = 0.
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
int launch(const float* table, const int* lists, int cap_tot,
           const int* counts, int n_inst, const int* segs, const float* inv,
           const float* rays, int n_rays, int block_rays, float* t, int* r,
           float* u, float* v, int* i, cudaStream_t stream) {
  inst_rows_kernel<kAny><<<n_rays / kThreads, kThreads, 0, stream>>>(
      table, lists, cap_tot, counts, n_inst, segs, inv, rays, n_rays,
      block_rays, t, r, u, v, i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  rays is [7, n_rays] (ox, oy, oz, dx, dy,
// dz, t_max); lists is [n_rays / block_rays, cap_tot]; counts is
// [n_rays / block_rays, n_inst]; segs is [3, n_inst]; inv is [n_inst, 12].
// n_rays must be a positive multiple of block_rays, and block_rays a
// multiple of 256.  Returns cudaGetLastError() after the launch.
extern "C" int inst_rows_threads_per_block() { return kThreads; }

extern "C" int inst_rows_closest(const float* table, const int* lists,
                                 int cap_tot, const int* counts, int n_inst,
                                 const int* segs, const float* inv,
                                 const float* rays, int n_rays, int block_rays,
                                 float* t, int* r, float* u, float* v, int* i,
                                 cudaStream_t stream) {
  return launch<false>(table, lists, cap_tot, counts, n_inst, segs, inv, rays,
                       n_rays, block_rays, t, r, u, v, i, stream);
}

extern "C" int inst_rows_any(const float* table, const int* lists, int cap_tot,
                             const int* counts, int n_inst, const int* segs,
                             const float* inv, const float* rays, int n_rays,
                             int block_rays, float* t, int* r, float* u,
                             float* v, int* i, cudaStream_t stream) {
  return launch<true>(table, lists, cap_tot, counts, n_inst, segs, inv, rays,
                      n_rays, block_rays, t, r, u, v, i, stream);
}

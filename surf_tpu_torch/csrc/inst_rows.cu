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
// is ~45 FLOPs plus a division against a 40-byte record that every ray of
// the packet reads, so with rows staged on chip the loop is compute-bound.
// The object-space transform is 15 multiplies and adds per ray and
// segment, small beside the 8 tests of even one row.
//
// Semantics kept from the TPU kernel: the object-space ray is computed per
// segment as ((a0*x + a1*y) + a2*z) + a3 (direction without a3, not
// normalised, so t is the world parameter), in the order of the torch
// phase 1; instances ascending, rows ascending, the 8 records in order,
// replacement only on a strictly closer t (so at equal t the first
// instance, row and record wins); the arithmetic is mt.cuh's; NaNs of
// all-zero rows fail every compare; the slot is the int32 bit pattern of
// lane 9.  A negative count sweeps the instance's whole mesh (its first
// table row and row count rounded up to 8) in leaf order, which gives the
// list's winner.  The any-hit entry point keeps the closest hit's t and
// instance and returns slot 0 (occluded) or -1 with u = v = 0.  Build with
// --fmad=false so the arithmetic rounds as the plain PyTorch version's
// separate ops do.
//
// Two designs.  inst_rows_closest / inst_rows_any launch
// inst_rows_live_kernel (below); the first design, inst_rows_kernel, stays
// as inst_rows_{closest,any}_pr2, which only the timing and the tests
// reach (accel/inst_rows.py inst_rows_first_design).  The first design is
// leaf_rows.cu's first shape: one thread per ray, 256 rays a block, each
// block walking all of its packet's segments in order, its rows staged
// kChunk at a time through shared memory.  What held it back: a dead lane
// (t_max = -1e30, most of a frame's later waves and shadow rays) did the
// full work; a packet with long lists was one long block, so a launch
// ended with its longest packet; and every test took the IEEE division
// (~43% of a leaf group, PERF.md).  In both designs the instance count
// is a runtime bound (the TPU kernel unrolled one segment an instance at
// trace time).  The live design takes row 1's (leaf_rows.cu
// leaf_rows_live_kernel) on the packet's concatenated segments:
//
// 1. Live-ray compaction (live_rows.cuh compact_live).  A lane is live when
//    its t_max > 1e-5 (NaN is not live): a dead lane cannot pass `t >= eps
//    & t < t_max`, so its result is (t_max, -1, 0, 0, -1), which the block
//    of slice 0, work item 0 of its packet writes.  Each block takes the
//    live lanes of rank [256 s, 256 s + 256) for its slice s.
// 2. Row splits across the packet's segments.  The packet's rows, segment
//    after segment in instance order (a sweep segment holds its mesh's
//    rows), are numbered by one position q, and cut into chunks of K =
//    split_rows rows.  The grid's y holds `splits` work items a packet; a
//    block counts the packet's rows (one pass over its counts), and with
//    parts = min(splits, chunks) work items, item y takes the chunks y, y +
//    parts, y + 2 parts, ...; an item past them exits.  The host sizes
//    `splits` without reading the counts.  A block finds each staged row's
//    instance and row id by walking the segments forward, and transforms
//    its rays only when the instance changes: only for the instances its
//    rows belong to.
// 3. An exact merge (live_rows.cuh merge_splits).  The sequential result is
//    the least (t, q x 8 + j) over the hits below t_max, and q orders
//    instance before row before record.  Each work item's best goes in as
//    the 64-bit inverted key ~(t bits << 32 | q x 8 + j) by atomicMax into a
//    per-call scratch; the last item to arrive decodes it, finds q's
//    instance and row, recomputes u and v with the same transform and
//    mt_hit on the winning record (same ops, same bits), and reads the slot
//    from its lane 9.  The any-hit entry point merges the same key: its t
//    and instance are the closest hit's.
// 4. The record test takes 1 / a by the in-range path of nvcc's reciprocal
//    (mt.cuh rcp_in_range: the same bits for |a| < 2^126); a row in which
//    some |a| >= 2^126 (or inf) runs again from its start with the IEEE
//    division (live_rows.cuh row_exact).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "entry.cuh"
#include "live_rows.cuh"
#include "mt.cuh"

namespace {

constexpr int kLane = 128;    // floats per leaf-table row
constexpr int kRec = 16;      // floats per triangle record
constexpr int kTris = 8;      // triangles per row
constexpr int kThreads = surf::kLiveThreads;  // rays per block
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

// The packet's instance segments, read from its counts: instance i holds
// rows(i) positions (its count, or with a negative count its mesh's rows8),
// the segments follow each other in instance order.
struct Segments {
  const int* count_of;  // [n_inst] the packet's counts
  const int* seg_off;   // [n_inst] segment offset in a list row
  const int* row0;      // [n_inst] the mesh's first table row (a sweep)
  const int* rows8;     // [n_inst] the mesh's rows rounded up to 8 (a sweep)
  const int* list;      // [cap_tot] the packet's list row

  __device__ __forceinline__ int rows(int i) const {
    const int c = count_of[i];
    return c < 0 ? rows8[i] : c;
  }

  // The table row at position q of the segment of instance i that starts
  // at position off.
  __device__ __forceinline__ int row_id(int i, int off, int q) const {
    return count_of[i] < 0 ? row0[i] + (q - off) : list[seg_off[i] + (q - off)];
  }
};

// A position in the segments: instance `inst`, whose segment starts at
// position `off` and holds `n` rows.  seek moves it forward to the segment
// that holds position q (q below the packet's total rows).
struct Cursor {
  int inst, off, n;

  __device__ __forceinline__ void seek(const Segments& s, int q) {
    while (off + n <= q) {
      off += n;
      n = s.rows(++inst);
    }
  }
};

// The instance's object-space ray: ((a0*x + a1*y) + a2*z) + a3 per
// component, the direction without the translation (--fmad=false).
struct ObjRay {
  float ox, oy, oz, dx, dy, dz;

  __device__ __forceinline__ void transform(const float* __restrict__ a, float x, float y,
                                            float z, float u, float v, float w) {
    ox = a[0] * x + a[1] * y + a[2] * z + a[3];
    oy = a[4] * x + a[5] * y + a[6] * z + a[7];
    oz = a[8] * x + a[9] * y + a[10] * z + a[11];
    dx = a[0] * u + a[1] * v + a[2] * w;
    dy = a[4] * u + a[5] * v + a[6] * w;
    dz = a[8] * u + a[9] * v + a[10] * w;
  }
};

// The live design (points 1-4 above).  keys [n_rays] and arrivals [n_rays /
// 256] are the merge's scratch, zero before the launch and after it.
template <bool kAny>
__global__ void __launch_bounds__(kThreads)
inst_rows_live_kernel(const float* __restrict__ table, const int* __restrict__ lists,
                      int cap_tot, const int* __restrict__ counts, int n_inst,
                      const int* __restrict__ segs, const float* __restrict__ inv,
                      const float* __restrict__ rays, int n_rays, int block_rays,
                      int split_rows, int splits, float* __restrict__ t_out,
                      int* __restrict__ r_out, float* __restrict__ u_out,
                      float* __restrict__ v_out, int* __restrict__ i_out,
                      unsigned long long* __restrict__ keys, unsigned* __restrict__ arrivals) {
  __shared__ float4 staged[kChunk * kLane / 4];
  __shared__ int live_lane[kThreads];
  __shared__ int warp_live[kThreads / 32];
  __shared__ int warp_rows[kThreads / 32];
  __shared__ bool last;

  const int slices = block_rays / kThreads;  // also the lanes per thread
  const int packet = blockIdx.x / slices;
  const int slice = blockIdx.x % slices;
  const int y = blockIdx.y;
  const int tid = threadIdx.x, wid = tid >> 5;
  const Segments sg{counts + static_cast<size_t>(packet) * n_inst, segs, segs + n_inst,
                    segs + 2 * n_inst, lists + static_cast<size_t>(packet) * cap_tot};

  // The packet's rows, and this block's share of their chunks.
  int mine = 0;
  for (int i = tid; i < n_inst; i += kThreads) mine += sg.rows(i);
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((tid & 31) == 0) warp_rows[wid] = mine;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += warp_rows[w];
  const int chunks = (total + split_rows - 1) / split_rows;
  const int parts = max(1, min(splits, chunks));
  if (y >= parts) return;

  const size_t stride = static_cast<size_t>(n_rays);  // rays is [7, n_rays]
  const size_t first = static_cast<size_t>(packet) * block_rays;
  const int n_live = surf::compact_live(
      rays + 6 * stride + first, slices, slice, slice == 0 && y == 0, live_lane, warp_live,
      [&](int lane, float tm) {
        const size_t at = first + lane;
        t_out[at] = tm;
        r_out[at] = -1;
        u_out[at] = 0.0f;
        v_out[at] = 0.0f;
        i_out[at] = -1;
      });
  const int lo_rank = slice * kThreads;
  if (n_live <= lo_rank) return;
  __syncthreads();

  const bool has_ray = lo_rank + tid < n_live;
  const bool warp_has = lo_rank + wid * 32 < n_live;
  const size_t ray = has_ray ? first + live_lane[tid] : first;
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
  Cursor at{0, 0, n_inst > 0 ? sg.rows(0) : 0};  // the first row of this block's chunk
  Cursor tested = at;                              // the row under test
  ObjRay r{};
  int r_inst = -1;  // the instance r belongs to
  for (int c = y; c < chunks; c += parts) {
    const int lo = c * split_rows;
    const int m = min(split_rows, total - lo);
    at.seek(sg, lo);
    __syncthreads();  // every thread is done with the previous chunk
    // Row k of the chunk, a warp's 32 threads at a time (one 16-byte piece
    // each), from its segment: a walk forward from the chunk's first row,
    // the same in every thread of the warp.
    for (int i = tid; i < m * (kLane / 4); i += kThreads) {
      const int q = lo + i / (kLane / 4);
      Cursor s = at;
      s.seek(sg, q);
      const int row = sg.row_id(s.inst, s.off, q);
      staged[i] = table4[static_cast<size_t>(row) * (kLane / 4) + i % (kLane / 4)];
    }
    __syncthreads();
    if (!warp_has) continue;  // a warp without rays only keeps the barriers
    for (int k = 0; k < m; ++k) {
      const int q = lo + k;
      tested.seek(sg, q);
      if (tested.inst != r_inst) {
        r_inst = tested.inst;
        r.transform(inv + 12 * r_inst, ox, oy, oz, dx, dy, dz);
      }
      const float4* row = staged + k * (kLane / 4);
      const float row_t = best_t;
      const int row_pos = best_pos;
      bool wide = false;
#pragma unroll
      for (int j = 0; j < kTris; ++j) {
        const float4 a = row[j * 4], b = row[j * 4 + 1], c4 = row[j * 4 + 2];
        float t, u, v, det;
        if (surf::mt_hit_a<surf::Recip::kInRange>(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                                                  c4.x, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz,
                                                  best_t, t, u, v, det)) {
          best_t = t;
          best_pos = q * kTris + j;
        }
        wide |= fabsf(det) >= surf::kInRangeMax;
      }
      if (wide) {  // a determinant out of the in-range reciprocal's range
                   // (never in a real scene): the row again with 1 / a
        best_t = row_t;
        best_pos = row_pos;
        surf::row_exact<surf::kMT, false>(row, q * kTris, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz,
                                          best_t, best_pos);
      }
    }
  }

  // The merge: key = ~(t bits << 32 | position); 0 = no hit.
  unsigned long long key = 0;
  if (has_ray && best_t < tm)
    key = ~((static_cast<unsigned long long>(__float_as_uint(best_t)) << 32) |
            static_cast<unsigned>(best_pos));
  if (!surf::merge_splits(key, has_ray, keys + ray, &arrivals[blockIdx.x], parts, &last))
    return;
  // The winning position's instance: one pass over the segments, the same
  // in every thread.
  const unsigned long long k = ~key;
  const int pos = static_cast<int>(k & 0xffffffffu);
  const int q = pos / kTris;
  int inst = -1, off = 0;
  for (int i = 0, o = 0; i < n_inst; ++i) {
    const int n = sg.rows(i);
    if (q >= o && q < o + n) {
      inst = i;
      off = o;
    }
    o += n;
  }
  if (!has_ray) return;
  if (key == 0) {
    t_out[ray] = tm;
    r_out[ray] = -1;
    u_out[ray] = 0.0f;
    v_out[ray] = 0.0f;
    i_out[ray] = -1;
    return;
  }
  t_out[ray] = __uint_as_float(static_cast<unsigned>(k >> 32));
  i_out[ray] = inst;
  if (kAny) {
    r_out[ray] = 0;
    u_out[ray] = 0.0f;
    v_out[ray] = 0.0f;
    return;
  }
  const int row = sg.row_id(inst, off, q);
  const float4* rec = table4 + static_cast<size_t>(row) * (kLane / 4) + (pos % kTris) * 4;
  const float4 a = rec[0], b = rec[1], c4 = rec[2];
  ObjRay w;
  w.transform(inv + 12 * inst, ox, oy, oz, dx, dy, dz);
  float t, u, v;
  surf::mt_hit(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c4.x, w.ox, w.oy, w.oz, w.dx, w.dy,
               w.dz, CUDART_INF_F, t, u, v);
  r_out[ray] = __float_as_int(c4.y);
  u_out[ray] = u;
  v_out[ray] = v;
}

template <bool kAny>
int launch_pr2(const float* table, const int* lists, int cap_tot, const int* counts,
               int n_inst, const int* segs, const float* inv, const float* rays, int n_rays,
               int block_rays, float* t, int* r, float* u, float* v, int* i,
               cudaStream_t stream) {
  inst_rows_kernel<kAny><<<n_rays / kThreads, kThreads, 0, stream>>>(
      table, lists, cap_tot, counts, n_inst, segs, inv, rays, n_rays, block_rays, t, r, u, v,
      i);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAny>
int launch_live(const float* table, const int* lists, int cap_tot, const int* counts,
                int n_inst, const int* segs, const float* inv, const float* rays, int n_rays,
                int block_rays, int split_rows, int splits, float* t, int* r, float* u,
                float* v, int* i, unsigned long long* keys, unsigned* arrivals,
                cudaStream_t stream) {
  if (split_rows < 1 || split_rows > kChunk || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_rays / kThreads, splits);
  inst_rows_live_kernel<kAny><<<grid, kThreads, 0, stream>>>(
      table, lists, cap_tot, counts, n_inst, segs, inv, rays, n_rays, block_rays, split_rows,
      splits, t, r, u, v, i, keys, arrivals);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  rays is [7, n_rays] (ox, oy, oz, dx, dy,
// dz, t_max); lists is [n_rays / block_rays, cap_tot]; counts is
// [n_rays / block_rays, n_inst]; segs is [3, n_inst]; inv is [n_inst, 12].
// n_rays must be a positive multiple of block_rays, and block_rays a
// multiple of 256.  Returns cudaGetLastError() after the launch.
extern "C" int inst_rows_threads_per_block() { return kThreads; }

// The first design (reached only to time it beside the live kernel).
extern "C" int inst_rows_closest_pr2(const float* table, const int* lists, int cap_tot,
                                     const int* counts, int n_inst, const int* segs,
                                     const float* inv, const float* rays, int n_rays,
                                     int block_rays, float* t, int* r, float* u, float* v,
                                     int* i, cudaStream_t stream) {
  return launch_pr2<false>(table, lists, cap_tot, counts, n_inst, segs, inv, rays, n_rays,
                           block_rays, t, r, u, v, i, stream);
}

extern "C" int inst_rows_any_pr2(const float* table, const int* lists, int cap_tot,
                                 const int* counts, int n_inst, const int* segs,
                                 const float* inv, const float* rays, int n_rays,
                                 int block_rays, float* t, int* r, float* u, float* v, int* i,
                                 cudaStream_t stream) {
  return launch_pr2<true>(table, lists, cap_tot, counts, n_inst, segs, inv, rays, n_rays,
                          block_rays, t, r, u, v, i, stream);
}

// The live kernel.  The arguments of the entry points above, and:
// split_rows (K, 1..32), the rows of a chunk, and splits (1..65535), the
// work items a packet, after block_rays; keys, [n_rays] 64-bit words, and
// arrivals, [n_rays / 256] 32-bit words, the merge's scratch, all zero
// before the launch and left all zero after it (one stream at a time).
extern "C" int inst_rows_closest(const float* table, const int* lists, int cap_tot,
                                 const int* counts, int n_inst, const int* segs,
                                 const float* inv, const float* rays, int n_rays,
                                 int block_rays, int split_rows, int splits, float* t, int* r,
                                 float* u, float* v, int* i, unsigned long long* keys,
                                 unsigned* arrivals, cudaStream_t stream) {
  return launch_live<false>(table, lists, cap_tot, counts, n_inst, segs, inv, rays, n_rays,
                            block_rays, split_rows, splits, t, r, u, v, i, keys, arrivals,
                            stream);
}

extern "C" int inst_rows_any(const float* table, const int* lists, int cap_tot,
                             const int* counts, int n_inst, const int* segs, const float* inv,
                             const float* rays, int n_rays, int block_rays, int split_rows,
                             int splits, float* t, int* r, float* u, float* v, int* i,
                             unsigned long long* keys, unsigned* arrivals,
                             cudaStream_t stream) {
  return launch_live<true>(table, lists, cap_tot, counts, n_inst, segs, inv, rays, n_rays,
                           block_rays, split_rows, splits, t, r, u, v, i, keys, arrivals,
                           stream);
}

// The kernel each entry point launches (entry.cuh), for the SASS checks.
SURF_KERNEL_OF(inst_rows_closest, inst_rows_live_kernel<false>)
SURF_KERNEL_OF(inst_rows_any, inst_rows_live_kernel<true>)
SURF_KERNEL_OF(inst_rows_closest_pr2, inst_rows_kernel<false>)
SURF_KERNEL_OF(inst_rows_any_pr2, inst_rows_kernel<true>)

// The leaf-row microbenchmarks (micro/leaf_groups.py, micro/leaf_visit.py).
//
// leaf_groups_* replaces scripts/tpu_leaf_variants_micro.py's kernel
// (`make_kernel`, its pl.pallas_call at :157); leaf_groups_full also
// replaces scripts/tpu_leaf_kernel_micro.py's (its call at :69), whose
// pallas_wide._leaf_list_kernel is gone from the JAX package and was line
// for line make_kernel("full").  Packets of 1024 rays, each with a list of
// cap8 groups of 8 leaf-row ids: a packet tests min(count, cap8) groups,
// rows in list order and records j = 0..7 of each row, and keeps the
// strictly closest hit, its record id row * 8 + j.  Variants (GroupVariant):
//   kFull     the Möller–Trumbore test of mt.cuh (with its u <= 1 test);
//   kNoDiv    f = a in place of f = 1 / a (wrong on purpose: the cost of the
//             division);
//   kNoExt    every entry tests row 0's records, fetched once, and keeps the
//             entry's own row id in the record id (the cost of fetching and
//             staging rows);
//   kHalfTri  list entries 0-3 of each group only, all 8 records of each:
//             what the TPU script's code does (its docstring says 4 of 8
//             triangles a row).
// What bounds it: operations.  A group is 64 tests (~48 FLOPs each) a ray
// against 4 KB of rows that every ray of the block reads, so once a row is
// staged on chip the loop is the tests' arithmetic.  Design: leaf_rows.cu's,
// so that kFull costs what the port's own leaf kernel pays for a row: one
// thread per ray, 256-ray blocks (4 a packet), kChunkGroups groups' rows
// staged at a time in shared memory with 16-byte loads and read by every
// thread at one address (a broadcast).  kNoExt stages no row: row 0's 72
// record lanes stay in registers, and an empty asm statement per entry
// hides from the compiler that they do not change, so that it cannot hoist
// the tests out of the loop (that would time a loop without its work).
//
// leaf_visit_* replaces scripts/tpu_leaf_micro.py's kernel (`make`, its
// pl.pallas_call at :141): one packet of 1024 rays visits a table's rows in
// blocks of kVisits visits while the cursor p < iters.  A visit reads row
// (p < iters ? p : 0) % n_rows, tests its records, takes the packet's vote
// "some ray's best t is below 1e29", and moves p to p + 1 when the row's
// int32 lane 9 is 1 or the vote is set, else to max(lane 10, p + 1).
// Variants (VisitVariant):
//   kEmpty    no test: the loop, the fetch, the vote and the cursor alone;
//   kVFull    the Möller–Trumbore test of the row's 8 records;
//   kRecip    f from the approximate reciprocal rcp.approx.ftz.f32
//             (MUFU.RCP), the card's counterpart of pl.reciprocal(approx=
//             True); the one entry point that does not round as its plain
//             version (micro/leaf_visit.py states its gate);
//   kVNoDiv   f = a * 0.5;
//   kExtOnly  t = (the sum of the record's 9 lanes) * dx, a hit when
//             t < best_t: the reads, with ~10 FLOPs a record;
//   kHalf     records 0-3 of the row.
// What bounds it: latency, by design.  A visit's chain is load -> tests ->
// vote -> next load; its work (1024 rays x 8 tests) is far below the card's
// rate and the 256 KB table stays in L1 and L2.  Design: dep_micro.cu's:
// one 512-thread block, 2 rays a thread, every thread following the same
// cursor (broadcast loads), the vote __syncthreads_or.  The kernel returns
// the cursor it ends at, so that no variant's loop is dead (kEmpty's would
// otherwise feed no output).
//
// Build with --fmad=false so the arithmetic rounds as the plain PyTorch
// versions' separate ops do.

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr int kLane = 128;        // floats per table row
constexpr int kRec = 16;          // floats per triangle record
constexpr int kTris = 8;          // records per row
constexpr int kGroup = 8;         // row ids per list group
constexpr int kPacketRays = 1024; // rays per packet
constexpr int kGroupThreads = 256;
constexpr int kChunkGroups = 4;   // groups staged in shared memory at a time
constexpr int kVisitThreads = 512;
constexpr int kVisitRays = 2;     // rays per thread: one 1024-ray packet
constexpr int kVisits = 32;       // visits per block of the visit loop
constexpr int kLeafLane = 9, kSkipLane = 10;

enum GroupVariant { kFull, kNoDiv, kNoExt, kHalfTri };
enum VisitVariant { kEmpty, kVFull, kRecip, kVNoDiv, kExtOnly, kHalf };

struct Best {
  float t, u, v;
  int r;
};

template <surf::Recip kR>
__device__ __forceinline__ void test_record(const float* c, float ox, float oy, float oz,
                                            float dx, float dy, float dz, int id, Best& b) {
  float t, u, v;
  if (surf::mt_hit<kR>(c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], ox, oy, oz, dx,
                       dy, dz, b.t, t, u, v)) {
    b.t = t;
    b.r = id;
    b.u = u;
    b.v = v;
  }
}

template <int kVariant>
__global__ void __launch_bounds__(kGroupThreads)
leaf_groups_kernel(const float* __restrict__ table, const int* __restrict__ lists, int cap8,
                   const int* __restrict__ counts, const float* __restrict__ rays,
                   const float* __restrict__ t_max, int n_rays, float* __restrict__ t_out,
                   int* __restrict__ r_out, float* __restrict__ u_out,
                   float* __restrict__ v_out) {
  constexpr surf::Recip kR = kVariant == kNoDiv ? surf::Recip::kNone : surf::Recip::kDivide;
  constexpr int kEntries = kVariant == kHalfTri ? kGroup / 2 : kGroup;  // tested per group
  constexpr int kChunk = kChunkGroups * kEntries;                       // entries a chunk
  constexpr int kStaged = kVariant == kNoExt ? 1 : kChunk;
  __shared__ float4 staged[kStaged * kLane / 4];
  __shared__ int ids[kChunk];
  const int ray = blockIdx.x * kGroupThreads + threadIdx.x;
  const int packet = ray / kPacketRays;
  const int trip = max(0, min(counts[packet], cap8));
  const float ox = rays[ray], oy = rays[n_rays + ray], oz = rays[2 * n_rays + ray];
  const float dx = rays[3 * n_rays + ray], dy = rays[4 * n_rays + ray];
  const float dz = rays[5 * n_rays + ray];
  Best b{t_max[ray], 0.0f, 0.0f, -1};
  const int* list = lists + static_cast<size_t>(packet) * cap8 * kGroup;
  const float4* table4 = reinterpret_cast<const float4*>(table);
  const float* rows = reinterpret_cast<const float*>(staged);
  float r0[kTris * 9];  // kNoExt: row 0's record lanes 0-8
  if constexpr (kVariant == kNoExt) {
#pragma unroll
    for (int i = 0; i < kTris * 9; ++i) r0[i] = __ldg(table + (i / 9) * kRec + i % 9);
  }
  for (int g0 = 0; g0 < trip; g0 += kChunkGroups) {
    const int m = min(kChunkGroups, trip - g0) * kEntries;
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < m; i += kGroupThreads) {
      ids[i] = list[(g0 + i / kEntries) * kGroup + i % kEntries];
    }
    if constexpr (kVariant != kNoExt) {
      for (int i = threadIdx.x; i < m * (kLane / 4); i += kGroupThreads) {
        const int k = i / (kLane / 4);
        const int row = list[(g0 + k / kEntries) * kGroup + k % kEntries];
        staged[i] = table4[static_cast<size_t>(row) * (kLane / 4) + i % (kLane / 4)];
      }
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const int id = ids[k] * kTris;
      if constexpr (kVariant == kNoExt) {
#pragma unroll
        for (int i = 0; i < kTris * 9; ++i) asm volatile("" : "+f"(r0[i]));
#pragma unroll
        for (int j = 0; j < kTris; ++j) {
          test_record<kR>(r0 + j * 9, ox, oy, oz, dx, dy, dz, id + j, b);
        }
      } else {
        const float* row = rows + k * kLane;
#pragma unroll
        for (int j = 0; j < kTris; ++j) {
          test_record<kR>(row + j * kRec, ox, oy, oz, dx, dy, dz, id + j, b);
        }
      }
    }
  }
  t_out[ray] = b.t;
  r_out[ray] = b.r;
  u_out[ray] = b.u;
  v_out[ray] = b.v;
}

template <int kVariant>
__global__ void __launch_bounds__(kVisitThreads)
leaf_visit_kernel(const float* __restrict__ table, int n_rows, const float* __restrict__ rays,
                  int iters, float* __restrict__ t_out, int* __restrict__ r_out,
                  int* __restrict__ end_out) {
  constexpr int kN = kVisitThreads * kVisitRays;
  constexpr int kTests = kVariant == kEmpty ? 0 : (kVariant == kHalf ? kTris / 2 : kTris);
  constexpr surf::Recip kR = kVariant == kRecip    ? surf::Recip::kApprox
                             : kVariant == kVNoDiv ? surf::Recip::kHalf
                                                   : surf::Recip::kDivide;
  float ox[kVisitRays], oy[kVisitRays], oz[kVisitRays];
  float dx[kVisitRays], dy[kVisitRays], dz[kVisitRays];
  float bt[kVisitRays];
  int br[kVisitRays];
#pragma unroll
  for (int r = 0; r < kVisitRays; ++r) {
    const int i = r * kVisitThreads + threadIdx.x;
    ox[r] = rays[i];
    oy[r] = rays[kN + i];
    oz[r] = rays[2 * kN + i];
    dx[r] = rays[3 * kN + i];
    dy[r] = rays[4 * kN + i];
    dz[r] = rays[5 * kN + i];
    bt[r] = 1e30f;
    br[r] = -1;
  }
  int p = 0;
  while (p < iters) {
#pragma unroll 1
    for (int k = 0; k < kVisits; ++k) {
      const int pc = (p < iters ? p : 0) % n_rows;
      const float* row = table + static_cast<size_t>(pc) * kLane;
      const bool is_leaf = __float_as_int(__ldg(row + kLeafLane)) == 1;
      const int skip = __float_as_int(__ldg(row + kSkipLane));
#pragma unroll
      for (int j = 0; j < kTests; ++j) {
        const float* c = row + kRec * j;
#pragma unroll
        for (int r = 0; r < kVisitRays; ++r) {
          float t;
          bool hit;
          if constexpr (kVariant == kExtOnly) {
            t = (__ldg(c) + __ldg(c + 1) + __ldg(c + 2) + __ldg(c + 3) + __ldg(c + 4) +
                 __ldg(c + 5) + __ldg(c + 6) + __ldg(c + 7) + __ldg(c + 8)) *
                dx[r];
            hit = t < bt[r];
          } else {
            float u, v;
            hit = surf::mt_hit<kR>(__ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3),
                                   __ldg(c + 4), __ldg(c + 5), __ldg(c + 6), __ldg(c + 7),
                                   __ldg(c + 8), ox[r], oy[r], oz[r], dx[r], dy[r], dz[r],
                                   bt[r], t, u, v);
          }
          if (hit) {
            bt[r] = t;
            br[r] = pc * kTris + j;
          }
        }
      }
      bool low = false;
#pragma unroll
      for (int r = 0; r < kVisitRays; ++r) low |= bt[r] < 1e29f;
      const bool vote = __syncthreads_or(low);
      p = (is_leaf || vote) ? p + 1 : max(skip, p + 1);
    }
  }
#pragma unroll
  for (int r = 0; r < kVisitRays; ++r) {
    const int i = r * kVisitThreads + threadIdx.x;
    t_out[i] = bt[r];
    r_out[i] = br[r];
  }
  if (threadIdx.x == 0) *end_out = p;
}

}  // namespace

// Plain C entry points for ctypes; each returns cudaGetLastError() after
// its launch.  extern "C" int leaf_groups_<variant>: table is [E, 128] f32
// (16-byte aligned); lists [packets, cap8, 8] int32 row ids below E; counts
// [packets] int32; rays [6, n_rays] (ox, oy, oz, dx, dy, dz) and t_max
// [n_rays], n_rays = packets * 1024; t, r, u, v are [n_rays].
#define SURF_GROUP_ENTRY(NAME, VARIANT)                                                      \
  extern "C" int NAME(const float* table, const int* lists, int cap8, const int* counts,     \
                      const float* rays, const float* t_max, int n_rays, float* t, int* r,   \
                      float* u, float* v, cudaStream_t cs) {                                 \
    leaf_groups_kernel<VARIANT><<<n_rays / kGroupThreads, kGroupThreads, 0, cs>>>(           \
        table, lists, cap8, counts, rays, t_max, n_rays, t, r, u, v);                        \
    return static_cast<int>(cudaGetLastError());                                             \
  }

SURF_GROUP_ENTRY(leaf_groups_full, kFull)
SURF_GROUP_ENTRY(leaf_groups_nodiv, kNoDiv)
SURF_GROUP_ENTRY(leaf_groups_noext, kNoExt)
SURF_GROUP_ENTRY(leaf_groups_halftri, kHalfTri)

// extern "C" int leaf_visit_<variant>: table is [n_rows, 128] f32 (int32
// lanes 9/10: leaf flag, skip); rays [6, 1024]; iters > 0; t and r are
// [1024], end [1] the cursor after the loop.
#define SURF_VISIT_ENTRY(NAME, VARIANT)                                                      \
  extern "C" int NAME(const float* table, int n_rows, const float* rays, int iters, float* t, \
                      int* r, int* end, cudaStream_t cs) {                                   \
    leaf_visit_kernel<VARIANT><<<1, kVisitThreads, 0, cs>>>(table, n_rows, rays, iters, t,   \
                                                           r, end);                          \
    return static_cast<int>(cudaGetLastError());                                             \
  }

SURF_VISIT_ENTRY(leaf_visit_empty, kEmpty)
SURF_VISIT_ENTRY(leaf_visit_full, kVFull)
SURF_VISIT_ENTRY(leaf_visit_recip, kRecip)
SURF_VISIT_ENTRY(leaf_visit_nodiv, kVNoDiv)
SURF_VISIT_ENTRY(leaf_visit_extonly, kExtOnly)
SURF_VISIT_ENTRY(leaf_visit_half, kHalf)

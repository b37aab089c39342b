// The binary-BVH skip-link packet walk (use_wide=False): the entry points
// bvh_walk_closest and bvh_walk_any.
//
// Replaces surf_tpu/accel/pallas_traverse.py `_traverse_kernel_multiblock`
// with its `_walk_block`, closest hit and any-hit.  The tree is a DFS
// preorder list of 16-lane node records (box lo, box hi, then leaf_first,
// leaf_count and the skip link as int32); the triangles are 16-lane records
// (v0, e1, e2) in leaf order.  One cursor walks the list for a 1024-ray
// packet.
//
// What bounds it: a visit costs each live ray one slab test, and a hit leaf
// up to 256 Möller–Trumbore tests per ray, against 64-byte records that
// every ray reads, so the work is operations; the next node depends on a
// packet-wide vote, so every visit ends in a barrier, and the chain of
// visits, not the arithmetic, sets the time.  The first design
// (bvh_walk.cu, kept as the entry points bvh_walk_{closest,any}_pr3) made
// each visit a serial chain of three global loads of the node record, the
// slab test, the vote and only then the next cursor's load; tested a hit
// leaf's triangles one at a time with each record loaded inside the loop
// and the IEEE division; ran every lane's tests, dead ones too; and took a
// second barrier after every tested leaf for the any-hit stop.  This
// design:
//
// 1. One packet a block of 512 threads, two rays a thread, in registers,
//    with 1/d divided once at load.  Measured against each other over a
//    frame's 64 calls (PERF.md §6, a one-off harness): an 8-block cluster
//    of 128 threads a packet lost to one block at every width (a cluster
//    barrier costs more than a binary step's work), and one ray a thread in
//    a block of 1024 ran each step's bookkeeping on twice the threads.
// 2. Live-ray compaction (cluster.cuh `scan_active`, `split_active`): one
//    block scan ranks the packet's active lanes, and thread i takes the
//    rays of rank i and i + 512, so a warp without rays skips its tests
//    with a warp-uniform branch and only keeps the barriers.  Inactive
//    lanes return (t_max, -1, 0, 0), written directly.  Which thread holds
//    which ray changes no bit: the vote is an OR, and each ray's updates
//    come in node and triangle order.
// 3. Both successors staged.  A step reads its node record from shared
//    memory: while it runs, warp 0 copies the records the cursor can take
//    next, dfs + 1 and the skip link, into the other half of a double
//    buffer with cp.async, and at a leaf a thread a triangle copies the
//    leaf's triangle records (at most 256, lanes 0-11) into a buffer of the
//    step's parity; each thread waits for its own copies before the vote's
//    barrier, which makes them visible.  So no global load lies on the
//    chain from one cursor to the next, and the triangle loop reads shared
//    memory, each record once for both of a thread's rays.
// 4. The in-range reciprocal (mt.cuh rcp_in_range: 1 / a bit for bit for
//    2^-126 <= |a| < 2^126, and |a| < 1e-5 fails the test anyway); a record
//    whose |a| >= 2^126 (or inf) is tested again with the IEEE division.
// 5. One barrier a step, `__syncthreads_or` of "some live ray hits the
//    node's box".  Any-hit folds its stop ("no active ray lacks a hit")
//    into the next step's barrier: after a leaf's tests each warp writes
//    its __any_sync into a flag of the step's parity, and the next step
//    ORs the flags after its barrier and, if all are clear, ends the walk
//    uncounted, as the first design stopped after that leaf (with a second
//    barrier).  Only the step after a tested leaf reads the flags: no
//    other step changes a hit.
//
// Semantics kept from the TPU kernel: the slab test's min/max are C-style,
// a < b ? a : b and a > b ? a : b in that operand order (the TPU kernel's
// jnp.where chains), which keep or absorb a NaN by position, neither IEEE
// rule; directions are not nudged, so 1 / 0 = inf and 0 * inf = NaN as on
// the TPU (IEEE division, no fast math); at most 256 triangles a leaf,
// tested in order; the cursor goes to dfs + 1 on a hit internal node, else
// to the skip link, and never backwards; replacement only on a strictly
// closer t; with any-hit a ray stops at its first hit and the packet stops
// once every active ray has one; the per-packet counts (nodes visited,
// triangle records tested).  A packet with no active ray visits nothing.
// Build with --fmad=false so the arithmetic rounds as the plain PyTorch
// version's.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "entry.cuh"
#include "mt.cuh"

namespace {

constexpr int kRec4 = 4;          // float4s per 16-lane record (lanes 0-11 are read)
constexpr int kBlock = 1024;      // rays per packet
constexpr int kRays = 2;          // rays a thread
constexpr int kThreads = kBlock / kRays;
constexpr int kMaxLeaf = 256;     // triangles tested per leaf at most
static_assert(kThreads >= kMaxLeaf, "a thread stages one triangle of a leaf");

using surf::c_max;
using surf::c_min;

// The slab test of one ray against the record's box (lo: ra.xyz, hi: ra.w,
// rb.xy), with the C-style min/max.
__device__ __forceinline__ bool box_hit(float4 ra, float4 rb, float ox, float oy, float oz,
                                        float ix, float iy, float iz, float bt) {
  const float txn = (ra.x - ox) * ix;
  const float txf = (ra.w - ox) * ix;
  float tmin = c_min(txn, txf);
  float tmax = c_max(txn, txf);
  const float tyn = (ra.y - oy) * iy;
  const float tyf = (rb.x - oy) * iy;
  tmin = c_max(tmin, c_min(tyn, tyf));
  tmax = c_min(tmax, c_max(tyn, tyf));
  const float tzn = (ra.z - oz) * iz;
  const float tzf = (rb.y - oz) * iz;
  tmin = c_max(tmin, c_min(tzn, tzf));
  tmax = c_min(tmax, c_max(tzn, tzf));
  return (tmax >= tmin) & (tmin < bt) & (tmax > 0.0f);
}

// One ray's state, in registers.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, bt, bu, bv;
  int bp;
};

// One triangle record's test (lanes 0-11: ta, tb, tc.x) for ray r, with the
// in-range reciprocal, again with the IEEE division where |det| is out of
// its range; a hit updates r.
__device__ __forceinline__ void tri_test(float4 ta, float4 tb, float4 tc, int id, Ray& r) {
  float t, u, v, det;
  bool hit = surf::mt_hit_a<surf::Recip::kInRange>(ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z,
                                                   tb.w, tc.x, r.ox, r.oy, r.oz, r.dx, r.dy,
                                                   r.dz, r.bt, t, u, v, det);
  if (fabsf(det) >= surf::kInRangeMax) {
    hit = surf::mt_hit(ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w, tc.x, r.ox, r.oy, r.oz,
                       r.dx, r.dy, r.dz, r.bt, t, u, v);
  }
  if (hit) {
    r.bt = t;
    r.bp = id;
    r.bu = u;
    r.bv = v;
  }
}

// One packet a block of kThreads threads; thread i holds the live rays of
// rank i and i + kThreads.
template <bool kAny>
__global__ void __launch_bounds__(kThreads)
bvh_walk_live_kernel(const float* __restrict__ nodes, int n_nodes,
                     const float* __restrict__ tris, const float* __restrict__ rays,
                     const int* __restrict__ act, int n_rays, float* __restrict__ t_out,
                     int* __restrict__ p_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, int* __restrict__ counts_out) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float4 recs[2][2][3];             // [step parity][dfs + 1, skip link]
  __shared__ float4 leaf[2][kMaxLeaf * 3];     // [step parity] the leaf's triangle records
  __shared__ int live_lane[kBlock];
  __shared__ int warp_live[kWarps];
  __shared__ __align__(16) int unfinished[2][kWarps];  // any-hit: [step parity][warp]
  const int packet = blockIdx.x;
  const size_t n = static_cast<size_t>(n_rays);  // rays is [7, n_rays]
  const size_t first = static_cast<size_t>(packet) * kBlock;
  const int* a = act + first;
  const int tid = threadIdx.x, wid = tid >> 5;
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);

  if (tid < 3) surf::copy16(&recs[0][0][tid], n4 + tid);  // the first record

  // Compaction (cluster.cuh, a cluster of one block): rank q of the
  // packet's active lanes goes to live_lane[q].
  int incl = 0;
  const int mine = surf::scan_active<kRays>(a, kThreads, warp_live, incl);
  surf::staged_wait();
  __syncthreads();
  int n_live = 0;
  surf::split_active<kRays, 1>(a, kThreads, 0, warp_live, mine, incl, live_lane, n_live,
                               [&](int lane) {
                                 const size_t i = first + lane;
                                 t_out[i] = rays[6 * n + i];
                                 p_out[i] = -1;
                                 u_out[i] = 0.0f;
                                 v_out[i] = 0.0f;
                               });
  __syncthreads();

  // This thread's rays, ranks tid + k kThreads.  Every thread of a warp
  // whose first thread holds no ray k holds none (warp_on[k] is
  // warp-uniform), and a warp without ray 0 has no ray 1.
  Ray ray[kRays];
  bool on[kRays], warp_on[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    on[k] = tid + k * kThreads < n_live;
    warp_on[k] = (wid << 5) + k * kThreads < n_live;
    const size_t i = first + (on[k] ? live_lane[tid + k * kThreads] : 0);
    Ray& r = ray[k];
    r.ox = rays[i];
    r.oy = rays[n + i];
    r.oz = rays[2 * n + i];
    r.dx = rays[3 * n + i];
    r.dy = rays[4 * n + i];
    r.dz = rays[5 * n + i];
    r.ix = 1.0f / r.dx;
    r.iy = 1.0f / r.dy;
    r.iz = 1.0f / r.dz;
    r.bt = rays[6 * n + i];
    r.bu = 0.0f;
    r.bv = 0.0f;
    r.bp = -1;
  }

  int dfs = n_live > 0 ? 0 : n_nodes;
  int visits = 0, tests = 0;
  int sel = 0;          // record dfs lies in recs[step & 1][sel]
  bool tested = false;  // the previous step tested a leaf (any-hit: flags to read)
  for (int step = 0; dfs < n_nodes; ++step) {
    const int par = step & 1;
    const float4* rec = recs[par][sel];
    const float4 ra = rec[0];  // lo x, y, z; hi x
    const float4 rb = rec[1];  // hi y, z; leaf_first, leaf_count
    const int skip = __float_as_int(rec[2].x);
    const int leaf_first = __float_as_int(rb.z);
    const int n_tris = min(__float_as_int(rb.w), kMaxLeaf);
    const bool is_leaf = __float_as_int(rb.w) > 0;
    // The records the cursor can take next (warp 0: lanes 0-2 record
    // dfs + 1, lanes 3-5 the skip link's), and a leaf's triangles (a thread
    // a triangle), staged while this step runs: recs[par ^ 1] was last read
    // at the start of the previous step, leaf[par] before the previous
    // step's barrier; each thread waits for its own copies, and this step's
    // barrier makes them visible.
    const bool stages_nodes = wid == 0;
    const bool stages_leaf = is_leaf && tid < n_tris;
    if (stages_nodes) {
      const int q = tid < 3 ? dfs + 1 : skip;
      if (tid < 6 && q < n_nodes && (tid < 3 || skip > dfs + 1)) {
        const int part = tid < 3 ? tid : tid - 3;
        surf::copy16(&recs[par ^ 1][tid < 3 ? 0 : 1][part],
                     n4 + static_cast<size_t>(q) * kRec4 + part);
      }
    }
    if (stages_leaf) {
      const float4* src = t4 + static_cast<size_t>(leaf_first + tid) * kRec4;
      float4* dst = &leaf[par][3 * tid];
      surf::copy16(dst, src);
      surf::copy16(dst + 1, src + 1);
      surf::copy16(dst + 2, src + 2);
    }
    bool hit = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      if (warp_on[k]) {
        const Ray& r = ray[k];
        hit |= on[k] && (!kAny || r.bp < 0) &&
               box_hit(ra, rb, r.ox, r.oy, r.oz, r.ix, r.iy, r.iz, r.bt);
      }
    }
    if (stages_nodes || stages_leaf) surf::staged_wait();
    const bool packet_hit = __syncthreads_or(hit) != 0;
    if (kAny && tested) {  // the flags of the previous step's leaf tests
      int any = 0;
#pragma unroll
      for (int w = 0; w < kWarps; w += 4) {
        const int4 f = *reinterpret_cast<const int4*>(&unfinished[par ^ 1][w]);
        any |= f.x | f.y | f.z | f.w;
      }
      if (!any) break;  // every active ray had its hit at that leaf
    }
    tested = packet_hit && is_leaf;
    if (tested) {
      if (warp_on[0]) {  // one loop: a triangle's record read once for both rays
        const float4* tri = leaf[par];
        for (int q = 0; q < n_tris; ++q) {
          const float4 ta = tri[3 * q], tb = tri[3 * q + 1], tc = tri[3 * q + 2];
          bool more = false;
#pragma unroll
          for (int k = 0; k < kRays; ++k) {
            if (on[k] && (!kAny || ray[k].bp < 0)) {
              tri_test(ta, tb, tc, leaf_first + q, ray[k]);
              more |= !kAny || ray[k].bp < 0;
            }
          }
          if (kAny && !more) break;  // a ray stops at its first hit
        }
      }
      tests += n_tris;
      if (kAny) {  // does some active ray of this warp still lack a hit?
        bool lacks = false;
#pragma unroll
        for (int k = 0; k < kRays; ++k) lacks |= on[k] && ray[k].bp < 0;
        lacks = __any_sync(0xffffffffu, lacks);
        if ((tid & 31) == 0) unfinished[par][wid] = lacks;
      }
    }
    int next = (packet_hit && !is_leaf) ? dfs + 1 : skip;
    next = max(next, dfs + 1);
    sel = next == dfs + 1 ? 0 : 1;
    ++visits;
    dfs = next;
  }

#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    if (on[k]) {
      const size_t i = first + live_lane[tid + k * kThreads];
      t_out[i] = ray[k].bt;
      p_out[i] = ray[k].bp;
      u_out[i] = ray[k].bu;
      v_out[i] = ray[k].bv;
    }
  }
  if (tid == 0) {
    counts_out[2 * packet] = visits;
    counts_out[2 * packet + 1] = tests;
  }
}

template <bool kAny>
int launch(const float* nodes, int n_nodes, const float* tris, const float* rays,
           const int* act, int n_rays, float* t, int* p, float* u, float* v, int* counts,
           cudaStream_t cs) {
  if (n_rays <= 0 || n_rays % kBlock != 0 || n_nodes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bvh_walk_live_kernel<kAny><<<n_rays / kBlock, kThreads, 0, cs>>>(
      nodes, n_nodes, tris, rays, act, n_rays, t, p, u, v, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes, the arguments of bvh_walk.cu's: nodes and
// tris are packed record tables ([rows, 128], 8 records a row); the walk
// ends at node n_nodes.  rays is [7, n_rays] (ox, oy, oz, dx, dy, dz, t_max)
// and act [n_rays], n_rays a positive multiple of 1024.  counts is [n_rays /
// 1024, 2]: nodes visited and triangle records tested per packet.  Return
// cudaGetLastError() after the launch, or the error that kept it from
// launching.
extern "C" int bvh_walk_closest(const float* nodes, int n_nodes, const float* tris,
                                const float* rays, const int* act, int n_rays, float* t,
                                int* p, float* u, float* v, int* counts, cudaStream_t cs) {
  return launch<false>(nodes, n_nodes, tris, rays, act, n_rays, t, p, u, v, counts, cs);
}

extern "C" int bvh_walk_any(const float* nodes, int n_nodes, const float* tris,
                            const float* rays, const int* act, int n_rays, float* t, int* p,
                            float* u, float* v, int* counts, cudaStream_t cs) {
  return launch<true>(nodes, n_nodes, tris, rays, act, n_rays, t, p, u, v, counts, cs);
}

// The kernel of each entry point (entry.cuh), for the SASS checks.
SURF_KERNEL_OF(bvh_walk_closest, bvh_walk_live_kernel<false>)
SURF_KERNEL_OF(bvh_walk_any, bvh_walk_live_kernel<true>)

// Binary-BVH skip-link packet walk (use_wide=False): the first design,
// kept as the entry points bvh_walk_closest_pr3 and bvh_walk_any_pr3,
// reached only by accel/bvh_walk.py bvh_walk_pr3 to time it beside the
// walk that use_wide=False runs (bvh_walk_live.cu).
//
// Replaces surf_tpu/accel/pallas_traverse.py `_traverse_kernel_multiblock`
// with its `_walk_block`, closest hit and any-hit.  The tree is a DFS
// preorder list of 16-lane node records (box lo, box hi, then leaf_first,
// leaf_count and the skip link as int32); the triangles are 16-lane
// records (v0, e1, e2) in leaf order.
//
// What bounds it on the card: a visit costs each ray one slab test, and a
// hit leaf up to 8 Möller–Trumbore tests per ray, against 64-byte records
// every ray reads, so the work is operations; as in stream_walk.cu, every
// visit ends in a block-wide vote, so a packet's walk is a chain of
// barriers and its latency, not the arithmetic, sets the time.
//
// Design: one block per 1024-ray packet (the TPU kernel's fixed packet),
// kThreads threads with kRays rays each in registers.  Every thread reads
// the visited record at the same address as float4 loads (a broadcast in
// L1); `__syncthreads_or` gives "some live ray hits the node's box".  On a
// hit leaf every thread tests the leaf's triangles in order, reading each
// record the same way; with any-hit a second vote asks whether some active
// ray still lacks a hit.
//
// Semantics kept from the TPU kernel: the slab test's min/max are C-style,
// a < b ? a : b and a > b ? a : b in that operand order (the TPU kernel's
// jnp.where chains), which keep or absorb a NaN by position, neither IEEE
// rule; directions are not nudged, so 1 / 0 = inf and 0 * inf = NaN as on
// the TPU (IEEE division, no fast math); at most 256 triangles per leaf;
// the cursor goes to dfs + 1 on a hit internal node, else to the skip
// link, and never backwards; replacement only on a strictly closer t;
// with any-hit a ray stops at its first hit and the packet stops once
// every active ray has one.  Möller–Trumbore is mt.cuh's.  A packet with
// no active ray visits nothing.  Build with --fmad=false so the arithmetic
// rounds as the plain PyTorch version's.

#include <cuda_runtime.h>

#include "entry.cuh"
#include "mt.cuh"

namespace {

constexpr int kRec4 = 4;          // float4s per 16-lane record
constexpr int kBlock = 1024;      // rays per packet
constexpr int kThreads = 512;     // threads per block (= per packet)
constexpr int kRays = kBlock / kThreads;
constexpr int kMaxLeaf = 256;     // triangles tested per leaf at most

using surf::c_max;
using surf::c_min;

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ nodes, int n_nodes,
                const float* __restrict__ tris, const float* __restrict__ rays,
                const int* __restrict__ act_in, int n_rays, float* __restrict__ t_out,
                int* __restrict__ p_out, float* __restrict__ u_out,
                float* __restrict__ v_out, int* __restrict__ counts_out) {
  const int first = blockIdx.x * kBlock;
  const size_t s = static_cast<size_t>(n_rays);
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float ix[kRays], iy[kRays], iz[kRays], bt[kRays], bu[kRays], bv[kRays];
  int bp[kRays];
  bool act[kRays];
  bool mine = false;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = first + r * kThreads + threadIdx.x;
    ox[r] = rays[i];
    oy[r] = rays[s + i];
    oz[r] = rays[2 * s + i];
    dx[r] = rays[3 * s + i];
    dy[r] = rays[4 * s + i];
    dz[r] = rays[5 * s + i];
    ix[r] = 1.0f / dx[r];
    iy[r] = 1.0f / dy[r];
    iz[r] = 1.0f / dz[r];
    bt[r] = rays[6 * s + i];
    bp[r] = -1;
    bu[r] = 0.0f;
    bv[r] = 0.0f;
    act[r] = act_in[i] != 0;
    mine |= act[r];
  }
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  int dfs = __syncthreads_or(mine) ? 0 : n_nodes;
  int visits = 0, tests = 0;
  while (dfs < n_nodes) {
    const float4* rec = n4 + static_cast<size_t>(dfs) * kRec4;
    const float4 a = __ldg(rec);      // lo x, y, z; hi x
    const float4 b = __ldg(rec + 1);  // hi y, z; leaf_first, leaf_count
    const float4 c = __ldg(rec + 2);  // skip
    const int leaf_first = __float_as_int(b.z);
    const int leaf_count = __float_as_int(b.w);
    bool vote = false;
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const float txn = (a.x - ox[r]) * ix[r];
      const float txf = (a.w - ox[r]) * ix[r];
      float tmin = c_min(txn, txf);
      float tmax = c_max(txn, txf);
      const float tyn = (a.y - oy[r]) * iy[r];
      const float tyf = (b.x - oy[r]) * iy[r];
      tmin = c_max(tmin, c_min(tyn, tyf));
      tmax = c_min(tmax, c_max(tyn, tyf));
      const float tzn = (a.z - oz[r]) * iz[r];
      const float tzf = (b.y - oz[r]) * iz[r];
      tmin = c_max(tmin, c_min(tzn, tzf));
      tmax = c_min(tmax, c_max(tzn, tzf));
      const bool live = act[r] && (!kAny || bp[r] < 0);
      vote |= live & (tmax >= tmin) & (tmin < bt[r]) & (tmax > 0.0f);
    }
    const bool packet_hit = __syncthreads_or(vote) != 0;
    const bool is_leaf = leaf_count > 0;
    // Without a leaf test no hit changes, so every active ray lacking a hit
    // still does (it did at the last vote, or at the start).
    bool unfinished = true;
    if (packet_hit && is_leaf) {
      const int n_tris = min(leaf_count, kMaxLeaf);
      for (int k = 0; k < n_tris; ++k) {
        const float4* tri = t4 + static_cast<size_t>(leaf_first + k) * kRec4;
        const float4 ta = __ldg(tri);      // v0 x, y, z; e1 x
        const float4 tb = __ldg(tri + 1);  // e1 y, z; e2 x, y
        const float4 tc = __ldg(tri + 2);  // e2 z
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          float t, u, v;
          const bool hit = surf::mt_hit(ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w,
                                        tc.x, ox[r], oy[r], oz[r], dx[r], dy[r], dz[r],
                                        bt[r], t, u, v);
          if (hit && act[r] && (!kAny || bp[r] < 0)) {
            bt[r] = t;
            bp[r] = leaf_first + k;
            bu[r] = u;
            bv[r] = v;
          }
        }
      }
      tests += n_tris;
      if (kAny) {
        bool q = false;
#pragma unroll
        for (int r = 0; r < kRays; ++r) q |= act[r] && bp[r] < 0;
        unfinished = __syncthreads_or(q) != 0;
      }
    }
    int next = (packet_hit && !is_leaf) ? dfs + 1 : __float_as_int(c.x);
    next = max(next, dfs + 1);
    if (kAny && !unfinished) next = n_nodes;
    ++visits;
    dfs = next;
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = first + r * kThreads + threadIdx.x;
    t_out[i] = bt[r];
    p_out[i] = bp[r];
    u_out[i] = bu[r];
    v_out[i] = bv[r];
  }
  if (threadIdx.x == 0) {
    counts_out[2 * blockIdx.x] = visits;
    counts_out[2 * blockIdx.x + 1] = tests;
  }
}

template <bool kAny>
int launch(const float* nodes, int n_nodes, const float* tris, const float* rays,
           const int* act, int n_rays, float* t, int* p, float* u, float* v,
           int* counts, cudaStream_t cs) {
  bvh_walk_kernel<kAny><<<n_rays / kBlock, kThreads, 0, cs>>>(
      nodes, n_nodes, tris, rays, act, n_rays, t, p, u, v, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes, with bvh_walk_live.cu's arguments: nodes
// and tris are packed record tables ([rows, 128], 8 records a row); the
// walk ends at node n_nodes.  rays is [7, n_rays] (ox, oy, oz, dx, dy, dz,
// t_max) and act [n_rays], n_rays a positive multiple of 1024.  counts is
// [n_rays / 1024, 2]: nodes visited and triangle records tested per
// packet.  Returns cudaGetLastError() after the launch.
extern "C" int bvh_walk_closest_pr3(const float* nodes, int n_nodes, const float* tris,
                                const float* rays, const int* act, int n_rays, float* t,
                                int* p, float* u, float* v, int* counts,
                                cudaStream_t cs) {
  return launch<false>(nodes, n_nodes, tris, rays, act, n_rays, t, p, u, v, counts, cs);
}

extern "C" int bvh_walk_any_pr3(const float* nodes, int n_nodes, const float* tris,
                                const float* rays, const int* act, int n_rays, float* t,
                                int* p, float* u, float* v, int* counts, cudaStream_t cs) {
  return launch<true>(nodes, n_nodes, tris, rays, act, n_rays, t, p, u, v, counts, cs);
}

// The kernel of each entry point (entry.cuh), for the SASS checks.
SURF_KERNEL_OF(bvh_walk_closest_pr3, bvh_walk_kernel<false>)
SURF_KERNEL_OF(bvh_walk_any_pr3, bvh_walk_kernel<true>)

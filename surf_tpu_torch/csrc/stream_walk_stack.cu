// The stack walk of the 8-wide DFS stream, algo="stack": the entry points
// stream_walk_stack_closest and stream_walk_stack_any.
//
// Replaces surf_tpu/accel/pallas_wide.py `_kernel_multiblock` with its walk
// `_walk_block_stack`, closest hit and any-hit.  One cursor and one stack a
// packet: a node row descends to its first child box that some live ray of
// the packet hits and pushes (row, the other hit children) when there are
// any; a row with no hit child (every leaf row) pops to the next pending
// child of the top entry.  Only hit children are visited.
//
// What bounds it: every visit costs each live ray 8 slab tests (a node row)
// or 8 Möller–Trumbore tests (a leaf row) against 512 bytes of row that
// every ray reads, so the work is operations; the next row depends on a
// packet-wide vote, so a visit is a latency chain.  The first design
// (stream_walk.cu `stream_walk_stack_kernel`, kept as the entry points
// stream_walk_stack_{closest,any}_pr3, which only the timing and the tests
// reach: accel/stream_walk.py stream_walk_stack_pr3) walked a packet in one
// 512-thread block, 4 rays a thread: a narrow wave ran 4-16 blocks on 132
// SMs, dead lanes did every test, each visit took two block barriers, and
// the next row came from device memory after the vote.  This design is the
// cluster walk of stream_walk_ilv.cu on cluster.cuh:
//
// 1. One packet a work item over a cluster of kCluster = 8 blocks, with
//    live-ray compaction (cluster.cuh scan_active / split_active) and one
//    ray a thread, 1/d divided once at load: T = block_rays / 8 threads a
//    block.  Inactive lanes get (t_max, -1, 0, 0) directly.  Only block 0
//    writes the packet's visits row.
// 2. The vote of a node row is its 8-bit child mask, each warp's OR
//    (__reduce_or_sync) OR-ed across the cluster by cluster_or: one cluster
//    barrier a step.  Every block then holds the same mask and applies the
//    same push or pop to its own copy of the stack in its own shared
//    memory, so the blocks agree on every push and pop without exchanging
//    entries.  A leaf row votes only with any-hit (some active ray still
//    lacks a hit); with closest hit its next row is the pop target, known
//    before the tests, and the step's barrier is the block's own.
// 3. The stack cannot race.  The top entry's pending-children mask
//    (`tmask`) and the (child, leaf) pointer of its next pending child
//    (`tnext`) live in every thread's registers, uniform as the cursor is;
//    the entries below the top keep their masks in shared memory
//    (s_mask[0, sp - 1)), and every entry keeps the 8 (child, leaf)
//    pointers of its row (s_ptr[entry]).  A push writes s_ptr[sp] (threads
//    0-7, the pointers of the row being left) and s_mask[sp - 1] (thread 0,
//    the old top's mask); a pop reads s_ptr[sp - 1] or, when it empties
//    the top, s_mask[sp - 2] and s_ptr[sp - 2].  Both happen after a step's
//    barrier, and a step pushes or pops, never both: a slot written at step
//    s is read no earlier than step s + 1 (after barrier s + 1, which the
//    writer reached after writing), and a slot read at step s is written
//    no earlier than step s + 1 (after barrier s + 1, which the reader
//    reached after reading).  No thread reads the stack before a step's
//    barrier: the pop target is already in registers.
// 4. The next row from shared memory.  The pop target is known before the
//    vote, so a step stages its row with cp.async while it tests (the
//    vote's barrier makes it visible); a descend's child is known only
//    after the vote, and threads 0-31 copy its row then, behind the
//    block's barrier.  Staging every candidate before the tests (a node
//    row's up to 8 real children as well) was measured against this on a
//    stack frame's 64 calls and gained nothing over the spp (slower at
//    full width, where it moves 9 rows a node step; the 1 MB stream sits
//    in L1 and L2), so the one row is copied.  Two buffers, by step % 2:
//    step s reads rows[s % 2] before its vote and, at a descend, before
//    the copy's barrier; rows[s % 2] is next written at step s + 1, after
//    those barriers.
//
// Semantics kept from the TPU kernel, as in stream_walk.cu: a node row's
// mask bit k is set when some live ray (active, and for any-hit without a
// hit) hits child box k; push (row, the mask without its lowest bit) when
// it has more than one bit; a pop descends to the next pending child of
// the top entry and drops the entry with its last child; a push beyond the
// stack depth is lost, and a pop from beyond it goes to row 0 (the plain
// version's, never reached at stack_depth(max_depth)); at most n_entries +
// kBelt visits; with any-hit a ray stops testing at its first hit and the
// walk stops at a leaf row once every active ray has one; replacement only
// on a strictly closer t; record id row * 8 + j; NaN-propagating slab
// min/max; a packet with no active ray visits nothing.  Build with
// --fmad=false so the arithmetic rounds as the plain PyTorch version's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "entry.cuh"
#include "mt.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLane = surf::kLane;                 // floats per stream row
constexpr int kWidth = 8;                          // children (triangles) per row
constexpr int kCluster = 8;                        // blocks a packet (portable cluster size)
constexpr int kMaxLanes = 2048;                    // rays per packet at most
constexpr int kMinLanes = 512;                     // rays per packet at least
constexpr int kMaxThreads = kMaxLanes / kCluster;  // threads a block at most
constexpr int kMaxStack = 64;                      // stack entries at most
constexpr int kBelt = 32;                          // at most n_entries + kBelt visits
constexpr int kDown = 0;                           // rows[b][kDown]: a descend's child
constexpr int kPop = 1;                            // rows[b][kPop]: the pop target

// The (child, is leaf) pointer of slot k of a staged node row.
__device__ __forceinline__ int2 child_of(const float4* row, int k) {
  const float4 p = row[4 * k + 1];  // hi y, z; child, is leaf
  return make_int2(__float_as_int(p.z), __float_as_int(p.w));
}

// One packet a cluster of kCluster blocks, one ray a thread; blockDim.x =
// block_rays / kCluster; depth is the stack depth (1..kMaxStack).
template <bool kAny>
__global__ void __launch_bounds__(kMaxThreads, 4)
stream_walk_stack_split_kernel(const float* __restrict__ stream, int n_entries,
                               const float* __restrict__ rays, const int* __restrict__ act,
                               int n_rays, int block_rays, int depth,
                               float* __restrict__ t_out, int* __restrict__ r_out,
                               float* __restrict__ u_out, float* __restrict__ v_out,
                               int* __restrict__ visits_out) {
  __shared__ float4 rows[2][2][kLane / 4];            // [step % 2][kDown, kPop]
  __shared__ int2 s_ptr[kMaxStack][kWidth];          // each entry's row's (child, leaf)
  __shared__ unsigned s_mask[kMaxStack];             // pending children below the top
  __shared__ int live_lane[kMaxThreads];
  __shared__ int warp_live[kMaxThreads / 32];
  __shared__ unsigned slot[3];
  const cg::cluster_group cluster = cg::this_cluster();
  const int T = blockDim.x;
  const int s = static_cast<int>(cluster.block_rank());
  const int packet = blockIdx.x / kCluster;
  const size_t n = static_cast<size_t>(n_rays);  // rays is [7, n_rays]
  const size_t first = static_cast<size_t>(packet) * block_rays;
  const int* a = act + first;
  const int tid = threadIdx.x, wid = tid >> 5;

  // The root, read after the barriers below, in the pop target's slot.
  surf::stage_row(rows[0][kPop], stream, 0, 0);

  // Compaction (cluster.cuh), as stream_walk_ilv.cu's.
  int incl = 0;
  const int mine = surf::scan_active<kCluster>(a, T, warp_live, incl);
  if (tid == 0) {
    slot[0] = 0u;
    slot[1] = 0u;
    slot[2] = 0u;
  }
  surf::staged_wait();
  __syncthreads();
  int n_live = 0;
  const int cnt = surf::split_active<kCluster, kCluster>(
      a, T, s, warp_live, mine, incl, live_lane, n_live, [&](int lane) {
        const size_t i = first + lane;
        t_out[i] = rays[6 * n + i];
        r_out[i] = -1;
        u_out[i] = 0.0f;
        v_out[i] = 0.0f;
      });  // this block's rays, at most T
  __syncthreads();

  const bool on = tid < cnt;
  const bool warp_on = (wid << 5) < cnt;  // warp-uniform
  const size_t i = first + (on ? live_lane[tid] : 0);
  const float ox = rays[i], oy = rays[n + i], oz = rays[2 * n + i];
  const float dx = rays[3 * n + i], dy = rays[4 * n + i], dz = rays[5 * n + i];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  float bt = rays[6 * n + i], bu = 0.0f, bv = 0.0f;
  int br = -1;

  cluster.sync();  // every block runs, slots zero
  // The walk's state, the same in every thread of the cluster.
  int cur = n_live > 0 ? 0 : -1;  // the row visited, a node row at the root
  bool cleaf = false;             // whether it is a leaf row
  int sel = kPop;                 // where it lies: rows[step % 2][sel]
  int sp = 0;                     // stack entries (those past depth are lost)
  unsigned tmask = 0u;            // the top entry's pending children; 0: no top in range
  int2 tnext = make_int2(0, 0);   // the pointer of its next pending child
  int visits = 0, leaf_visits = 0, votes = 0;
  const int belt = n_entries + kBelt;
  for (int step = 0; cur >= 0 && visits < belt; ++step) {
    const float4* row = rows[step & 1][sel];
    float4(*next)[kLane / 4] = rows[(step & 1) ^ 1];
    // The pop target's row (point 4): the top's next pending child, or
    // row 0 with the top past the stack depth.
    if (sp > 0) surf::stage_row(next[kPop], stream, tmask != 0u ? tnext.x : 0, 0);
    unsigned bits = 0u;
    if (warp_on) {
      if (cleaf) {
        const int rec0 = cur * kWidth;
#pragma unroll
        for (int j = 0; j < kWidth; ++j) {
          const float4 va = row[4 * j];      // v0 x, y, z; e1 x
          const float4 vb = row[4 * j + 1];  // e1 y, z; e2 x, y
          const float4 vc = row[4 * j + 2];  // e2 z
          float t, u, v;
          const bool hit = surf::mt_hit(va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w, vc.x,
                                        ox, oy, oz, dx, dy, dz, bt, t, u, v);
          if (hit && on && (!kAny || br < 0)) {
            bt = t;
            br = rec0 + j;
            bu = u;
            bv = v;
          }
        }
        if (kAny && on && br < 0) bits = 1u;
      } else if (on && (!kAny || br < 0)) {
#pragma unroll
        for (int k = 0; k < kWidth; ++k) {
          const float4 lo4 = row[4 * k];      // lo x, y, z; hi x
          const float4 hi4 = row[4 * k + 1];  // hi y, z; child, is leaf
          if (surf::slab_hit(ox, oy, oz, ix, iy, iz, bt, lo4.x, lo4.y, lo4.z, lo4.w, hi4.x,
                             hi4.y)) {
            bits |= 1u << k;
          }
        }
      }
    }
    surf::staged_wait();
    // A node row: the children some live ray hits.  A leaf row (any-hit):
    // does some active ray still lack a hit?  A leaf row (closest hit): no
    // vote, the block's barrier makes the staged rows visible.
    unsigned vote = 0u;
    if (cleaf && !kAny) {
      __syncthreads();
    } else {
      vote = surf::cluster_or<kCluster>(__reduce_or_sync(0xffffffffu, bits), slot, votes++,
                                        cluster);
    }
    const unsigned mask = cleaf ? 0u : vote;
    int nxt = -1;
    bool nleaf = false;
    if (mask != 0u) {  // descend to the first hit child
      const int k = __ffs(mask) - 1;
      const int2 c = child_of(row, k);
      nxt = c.x;
      nleaf = c.y == 1;
      sel = kDown;
      const unsigned rem = mask & (mask - 1u);
      if (rem != 0u) {  // push (row, rem)
        if (tid == 0 && sp >= 1 && sp <= depth) s_mask[sp - 1] = tmask;
        if (sp < depth) {
          if (tid < kWidth) s_ptr[sp][tid] = child_of(row, tid);
          tmask = rem;
          tnext = child_of(row, __ffs(rem) - 1);
        } else {
          tmask = 0u;
        }
        ++sp;
      }
      if (tid < kLane / 4) next[kDown][tid] = surf::row_at(stream, nxt)[tid];
      __syncthreads();  // the child's row is in place; every read of `row` is done
    } else if (sp > 0) {  // pop: the top's next pending child, or row 0
      nxt = tmask != 0u ? tnext.x : 0;
      nleaf = tmask != 0u && tnext.y == 1;
      sel = kPop;
      const unsigned prem = tmask & (tmask - 1u);
      if (prem != 0u) {
        tmask = prem;
        tnext = s_ptr[sp - 1][__ffs(prem) - 1];
      } else {
        --sp;
        tmask = sp >= 1 && sp <= depth ? s_mask[sp - 1] : 0u;
        if (tmask != 0u) tnext = s_ptr[sp - 1][__ffs(tmask) - 1];
      }
    }
    ++visits;
    leaf_visits += cleaf;
    cur = kAny && cleaf && vote == 0u ? -1 : nxt;
    cleaf = nleaf;
  }

  if (on) {
    t_out[i] = bt;
    r_out[i] = br;
    u_out[i] = bu;
    v_out[i] = bv;
  }
  if (s == 0 && tid == 0) {
    visits_out[3 * packet] = visits;
    visits_out[3 * packet + 1] = leaf_visits;
    visits_out[3 * packet + 2] = visits;
  }
}

template <bool kAny>
int launch(const float* stream, int n_entries, const float* rays, const int* act, int n_rays,
           int block_rays, int depth, float* t, int* r, float* u, float* v, int* visits,
           cudaStream_t cs) {
  if (depth < 1 || depth > kMaxStack || block_rays < kMinLanes || block_rays > kMaxLanes ||
      block_rays % (kCluster * 32) != 0 || n_rays <= 0 || n_rays % block_rays != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Whether a cluster of kCluster blocks of kMaxThreads threads fits the
  // device, asked once a device (cluster.cuh).
  static std::atomic<int> fits[surf::kMaxDevices];
  auto* kernel = stream_walk_stack_split_kernel<kAny>;
  const int err =
      surf::check_cluster(reinterpret_cast<const void*>(kernel), kCluster, kMaxThreads, fits);
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = surf::cluster_config(n_rays / block_rays * kCluster,
                                                      block_rays / kCluster, kCluster, cs, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, stream, n_entries, rays, act, n_rays,
                                           block_rays, depth, t, r, u, v, visits);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes, the arguments of stream_walk.cu's: stream
// is [n_entries, 128]; rays is [7, n_rays] (ox, oy, oz, dx, dy, dz, t_max);
// act is [n_rays]; n_rays is a positive multiple of block_rays (512, 1024
// or 2048); arg is the stack depth (1..64); visits is [n_rays / block_rays,
// 3].  Return cudaGetLastError() after the launch, or the error that kept
// it from launching.
extern "C" int stream_walk_stack_closest(const float* stream, int n_entries, const float* rays,
                                         const int* act, int n_rays, int block_rays, int arg,
                                         float* t, int* r, float* u, float* v, int* visits,
                                         cudaStream_t cs) {
  return launch<false>(stream, n_entries, rays, act, n_rays, block_rays, arg, t, r, u, v,
                       visits, cs);
}

extern "C" int stream_walk_stack_any(const float* stream, int n_entries, const float* rays,
                                     const int* act, int n_rays, int block_rays, int arg,
                                     float* t, int* r, float* u, float* v, int* visits,
                                     cudaStream_t cs) {
  return launch<true>(stream, n_entries, rays, act, n_rays, block_rays, arg, t, r, u, v,
                      visits, cs);
}

// The kernel of each entry point (entry.cuh), for the SASS checks.
SURF_KERNEL_OF(stream_walk_stack_closest, stream_walk_stack_split_kernel<false>)
SURF_KERNEL_OF(stream_walk_stack_any, stream_walk_stack_split_kernel<true>)

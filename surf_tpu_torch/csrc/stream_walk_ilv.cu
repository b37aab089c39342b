// The interleaved skip walk, algo="skip2" and "ilvN" (N = 1..4), and the
// skip walk itself, algo="skip" (ilv1's function): the entry points
// stream_walk_ilv_closest and stream_walk_ilv_any.
//
// Replaces surf_tpu/accel/pallas_wide.py `_kernel_multiblock` with its walks
// `_walk_block_pair` (skip2), `_walk_block_multi` (ilvN) and `_walk_block`
// (skip), closest hit and any-hit.  The TPU kernel walks N packets side by side in one program, so
// that one packet's vector work hides another's fetch -> reduce -> cursor
// chain; each packet keeps its own cursor, and its result and visit counts
// are the skip walk's (`_walk_block` / `_make_skip_visit`).  N names the
// TPU's schedule whose function this kernel computes and is checked to be
// 1..4; it does not shape the launch.  On this card the warp schedulers
// already interleave independent warps and blocks, so the card's form of
// the idea is independent packets: one packet a work item, with its own
// barrier, and blocks of several packets sharing an SM.
//
// What bounds it: every visit of a row costs each live ray 8 slab tests (a
// node row) or 8 Möller–Trumbore tests (a leaf row) against 512 bytes of
// row that every ray reads, so the work is operations; the next row
// depends on a packet-wide vote, so each visit also ends in a barrier.
// The first design (stream_walk.cu `stream_walk_ilv_kernel`, kept as the
// entry points stream_walk_ilv_{closest,any}_pr5) put N packets behind one
// barrier in one block with their rays in shared memory: the grid shrank
// with N, a packet that had left the stream waited for the block's slowest,
// 1/d was divided again at every node row, and dead lanes did full work.
// This design:
//
// 1. One packet a work item.  The grid is packets x kCluster blocks; the
//    kCluster = 8 blocks of a packet form a thread-block cluster.  A block
//    whose packet has left the stream exits.
// 2. Live-ray compaction (cluster.cuh).  Every block of the cluster reads
//    the packet's act with one block scan (the same ranks in every block:
//    thread i reads lanes j * T + i, in j order); the active rays of rank
//    [s n / 8, (s + 1) n / 8) go to block s, rank q of them to thread q.
//    A warp that holds no ray skips its tests with a warp-uniform branch
//    and still takes part in the vote.  The inactive lanes' results
//    (t_max, -1, 0, 0) are written directly.  Which thread holds which ray
//    changes no bit: the vote is an OR, and each ray's updates come in row
//    order.
// 3. One ray a thread, in registers, with 1/d divided once at load, as the
//    skip walk's Packet does: T = block_rays / 8 threads a block.
// 4. Rows staged ahead.  A step reads its row from shared memory: while it
//    tests row p, threads 0-63 copy the rows the cursor can take next, p + 1
//    and (at a node row) the skip link, into the other half of a double
//    buffer with cp.async; each waits for its copies before the vote's
//    barrier, which makes them visible.  So no global load lies on the
//    chain from one cursor to the next, which at a narrow wave's few live
//    rays is most of a step.
// 5. The vote (cluster.cuh `cluster_or`).  Each warp ORs its bit
//    (`__any_sync`) into slot step % 3 of every block of the cluster through
//    distributed shared memory, then one cluster barrier, and each block
//    reads its own slot: every block sees the same OR and computes the same
//    cursor.  The any-hit stop ("some active ray still lacks a hit") is
//    the same OR over the cluster.  Only block 0 of a cluster writes the
//    packet's visits row.
// The shape, 8 blocks a packet and one ray a thread, is fixed by a sweep of
// 1, 2, 4 or 8 blocks x 1, 2 or 4 rays a thread on 11 waves of an ilv2
// frame (PERF.md §6, H100 80GB HBM3 at 700.00 W): 8 x 1 was the
// fastest on 21 of the 22 calls and over a spp's 64 calls (78.15 ms, the
// next 4 x 1 at 84.30).  The exception, the full-width any-hit call, took
// 1.679 ms at 8 x 2 against 1.828 ms at 8 x 1.
//
// Semantics kept from the TPU kernel, as in stream_walk.cu: one cursor per
// packet; a node row descends when some live ray hits some child box, else
// takes its skip link; the cursor is max(next, p + 1); with any-hit a ray
// stops testing at its first hit and the packet stops at a leaf row once
// every active ray has one; replacement only on a strictly closer t; record
// id row * 8 + j; NaN-propagating slab min/max; a packet with no active ray
// visits nothing; an inactive ray returns (t_max, -1, 0, 0).  Build with
// --fmad=false so the arithmetic rounds as the plain PyTorch version's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "entry.cuh"
#include "mt.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLane = surf::kLane;               // floats per stream row
constexpr int kWidth = 8;                        // children (triangles) per row
constexpr int kCluster = 8;                      // blocks a packet (portable cluster size)
constexpr int kMaxLanes = 2048;                  // rays per packet at most
constexpr int kMinLanes = 512;                   // rays per packet at least
constexpr int kMaxThreads = kMaxLanes / kCluster;  // threads a block at most
constexpr int kMaxIlv = 4;                       // ilvN: N at most

// One packet a cluster of kCluster blocks, one ray a thread; blockDim.x =
// block_rays / kCluster.  At most 64 registers a thread (4 blocks of 256
// threads an SM), enough for the kernel without spills (ptxas -v).
template <bool kAny>
__global__ void __launch_bounds__(kMaxThreads, 4)
stream_walk_ilv_split_kernel(const float* __restrict__ stream, int n_entries,
                             const float* __restrict__ rays, const int* __restrict__ act,
                             int n_rays, int block_rays, float* __restrict__ t_out,
                             int* __restrict__ r_out, float* __restrict__ u_out,
                             float* __restrict__ v_out, int* __restrict__ visits_out) {
  __shared__ float4 rows[2][2][kLane / 4];  // [step parity][p + 1, skip link]
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

  surf::stage_row(rows[0][0], stream, 0, 0);  // the first row, read after the barriers below

  // Compaction (cluster.cuh): one block scan of the per-thread active
  // counts ranks the packet's active lanes, alike in every block.
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

  // This thread's ray: rank tid of the block's.  Every thread of a warp
  // whose first thread holds none holds none (warp_on is warp-uniform).
  const bool on = tid < cnt;
  const bool warp_on = (wid << 5) < cnt;
  const size_t i = first + (on ? live_lane[tid] : 0);
  const float ox = rays[i], oy = rays[n + i], oz = rays[2 * n + i];
  const float dx = rays[3 * n + i], dy = rays[4 * n + i], dz = rays[5 * n + i];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  float bt = rays[6 * n + i], bu = 0.0f, bv = 0.0f;
  int br = -1;

  cluster.sync();  // every block runs, slots zero
  int p = n_live > 0 ? 0 : n_entries;
  int visits = 0, leaf_visits = 0;
  int sel = 0;  // row p lies in rows[step & 1][sel]
  for (int step = 0; p < n_entries; ++step) {
    const float4* row = rows[step & 1][sel];
    const float4 meta = row[2];  // lanes 8-11: lane 9 is_leaf, lane 10 skip
    const bool is_leaf = __float_as_int(meta.y) == 1;
    const int skip = __float_as_int(meta.z);
    // The rows the cursor can take next, staged while this one is tested:
    // rows[step & 1 ^ 1] was last read before the previous step's barrier,
    // and this step's barrier makes the copies visible.
    if (p + 1 < n_entries) surf::stage_row(rows[(step & 1) ^ 1][0], stream, p + 1, 0);
    if (!is_leaf && skip > p + 1 && skip < n_entries) {
      surf::stage_row(rows[(step & 1) ^ 1][1], stream, skip, 32);
    }
    bool vote = false;
    if (warp_on) {
      if (is_leaf) {
        const int rec0 = p * kWidth;
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
        if (kAny) vote = on && br < 0;
      } else {
#pragma unroll
        for (int k = 0; k < kWidth; ++k) {
          const float4 lo4 = row[4 * k];      // lo x, y, z; hi x
          const float4 hi4 = row[4 * k + 1];  // hi y, z; child, is leaf
          if (on && (!kAny || br < 0) &&
              surf::slab_hit(ox, oy, oz, ix, iy, iz, bt, lo4.x, lo4.y, lo4.z, lo4.w, hi4.x,
                             hi4.y)) {
            vote = true;
          }
        }
      }
    }
    surf::staged_wait();
    // A node row: does some live ray hit some child?  A leaf row (any-hit):
    // does some active ray still lack a hit?  (At a node row that is true:
    // no hit changed since the last leaf row's vote, or since the start.)
    const bool any =
        surf::cluster_or<kCluster>(__any_sync(0xffffffffu, vote) ? 1u : 0u, slot, step,
                                   cluster) != 0u;
    int next = (is_leaf || any) ? p + 1 : skip;
    next = max(next, p + 1);
    if (kAny && is_leaf && !any) next = n_entries;
    sel = next == p + 1 ? 0 : 1;
    ++visits;
    leaf_visits += is_leaf;
    p = next;
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
           int block_rays, int arg, float* t, int* r, float* u, float* v, int* visits,
           cudaStream_t cs) {
  if (arg < 1 || arg > kMaxIlv || block_rays < kMinLanes || block_rays > kMaxLanes ||
      block_rays % (kCluster * 32) != 0 || n_rays <= 0 || n_rays % block_rays != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Whether a cluster of kCluster blocks of kMaxThreads threads fits the
  // device, asked once a device (cluster.cuh).
  static std::atomic<int> fits[surf::kMaxDevices];
  auto* kernel = stream_walk_ilv_split_kernel<kAny>;
  const int err =
      surf::check_cluster(reinterpret_cast<const void*>(kernel), kCluster, kMaxThreads, fits);
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = surf::cluster_config(n_rays / block_rays * kCluster,
                                                      block_rays / kCluster, kCluster, cs, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, stream, n_entries, rays, act, n_rays,
                                           block_rays, t, r, u, v, visits);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes, the arguments of stream_walk.cu's: stream
// is [n_entries, 128]; rays is [7, n_rays] (ox, oy, oz, dx, dy, dz, t_max);
// act is [n_rays]; n_rays is a positive multiple of block_rays (512, 1024
// or 2048); arg is N of ilvN (1..4, skip2 is 2, skip 1); visits is [n_rays /
// block_rays, 3].  Return cudaGetLastError() after the launch, or the error
// that kept it from launching.
extern "C" int stream_walk_ilv_closest(const float* stream, int n_entries, const float* rays,
                                       const int* act, int n_rays, int block_rays, int arg,
                                       float* t, int* r, float* u, float* v, int* visits,
                                       cudaStream_t cs) {
  return launch<false>(stream, n_entries, rays, act, n_rays, block_rays, arg, t, r, u, v,
                       visits, cs);
}

extern "C" int stream_walk_ilv_any(const float* stream, int n_entries, const float* rays,
                                   const int* act, int n_rays, int block_rays, int arg,
                                   float* t, int* r, float* u, float* v, int* visits,
                                   cudaStream_t cs) {
  return launch<true>(stream, n_entries, rays, act, n_rays, block_rays, arg, t, r, u, v, visits,
                      cs);
}

// The kernel of each entry point (entry.cuh), for the SASS checks.
SURF_KERNEL_OF(stream_walk_ilv_closest, stream_walk_ilv_split_kernel<false>)
SURF_KERNEL_OF(stream_walk_ilv_any, stream_walk_ilv_split_kernel<true>)

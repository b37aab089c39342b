// The machinery of the cluster walks, which spread one packet's rays over a
// thread-block cluster and keep one cursor for it (stream_walk_ilv.cu,
// stream_walk_spec.cu):
//
// - rows of the stream staged into shared memory with cp.async
//   (`row_at`, `stage_row`, `stage_rows`, `staged_wait`);
// - live-ray compaction (`scan_active`, `split_active`): every block of
//   the cluster ranks the packet's active lanes with the same block scan
//   (thread i reads lanes j * T + i, in j order, so ranks go thread by
//   thread), and the active rays of rank [s n / C, (s + 1) n / C) go to
//   block s, rank q of them to slot q of `live_lane`;
// - the cluster OR (`cluster_or`): each warp ORs its bits into slot
//   step % 3 of every block of the cluster through distributed shared
//   memory (lane k < C to block k), then one cluster barrier (release /
//   acquire), and each block reads its own slot: every block sees the same
//   OR.  Thread 0 zeroes slot (step + 1) % 3 of its own block before the
//   barrier: it was last read at step - 2, before the barrier of step - 1,
//   and is next written after this step's barrier (vote.cuh's three-slot
//   reset).  All three slots must be zero, in every block, before step 0;
// - the launch (`cluster_config`) and the check that a cluster fits the
//   device (`check_cluster`, asked once a device and kernel).

#pragma once

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace surf {

namespace cg = cooperative_groups;

constexpr int kLane = 128;       // floats per stream row
constexpr int kMaxDevices = 64;  // devices whose cluster check is kept

__device__ __forceinline__ const float4* row_at(const float* stream, int p) {
  return reinterpret_cast<const float4*>(stream) + static_cast<size_t>(p) * (kLane / 4);
}

__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(to), "l"(src) : "memory");
}

// Row q of the stream into shared memory `dst` (512 bytes) with cp.async,
// 16 bytes a thread for threads [lo, lo + 32) of the block.
__device__ __forceinline__ void stage_row(float4* dst, const float* stream, int q, int lo) {
  const int k = static_cast<int>(threadIdx.x) - lo;
  if (k >= 0 && k < kLane / 4) copy16(dst + k, row_at(stream, q) + k);
}

// Rows [q, q + m) of the stream (contiguous) into shared memory `dst` with
// cp.async, 16 bytes at a time, spread over the block's threads.
__device__ __forceinline__ void stage_rows(float4* dst, const float* stream, int q, int m) {
  const float4* src = row_at(stream, q);
  for (int k = threadIdx.x; k < m * (kLane / 4); k += blockDim.x) copy16(dst + k, src + k);
}

__device__ __forceinline__ void staged_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The first half of the compaction: this thread's active count over the
// lanes j * T + tid, j < kScan, of act `a`, and its inclusive scan over
// the warp (`incl`); lane 31 writes the warp's total to warp_live.  A
// barrier must come before `split_active` reads warp_live.
template <int kScan>
__device__ __forceinline__ int scan_active(const int* __restrict__ a, int T, int* warp_live,
                                           int& incl) {
  const int tid = threadIdx.x, lid = tid & 31;
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kScan; ++j) mine += a[j * T + tid] != 0;
  incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lid >= o) incl += x;
  }
  if (lid == 31) warp_live[tid >> 5] = incl;
  return mine;
}

// The second half: the packet's active lanes (n_live), this block's share
// of ranks [lo, lo + cnt) into live_lane[0, cnt), and `dead(lane)` for
// each inactive lane j * T + tid with j % kCluster == s, so that every
// inactive lane is handed to one block.  Returns cnt.  A barrier must
// come before live_lane is read.
template <int kScan, int kCluster, class Dead>
__device__ __forceinline__ int split_active(const int* __restrict__ a, int T, int s,
                                            const int* warp_live, int mine, int incl,
                                            int* live_lane, int& n_live, Dead dead) {
  const int tid = threadIdx.x, wid = tid >> 5;
  int before = 0;
  n_live = 0;
  for (int w = 0; w < (T >> 5); ++w) {
    const int c = warp_live[w];
    before += w < wid ? c : 0;
    n_live += c;
  }
  const int lo = s * n_live / kCluster;
  const int cnt = (s + 1) * n_live / kCluster - lo;  // this block's rays
  int rank = before + incl - mine;
  for (int j = 0; j < kScan; ++j) {  // the scan's loads left these in L1
    const int lane = j * T + tid;
    if (a[lane] != 0) {
      if (rank >= lo && rank < lo + cnt) live_lane[rank - lo] = lane;
      ++rank;
    } else if (j % kCluster == s) {
      dead(lane);
    }
  }
  return cnt;
}

// The OR of `bits` over the cluster at vote `step` (see above); `bits` is
// the warp's OR, the same in every lane of the warp.
template <int kCluster>
__device__ __forceinline__ unsigned cluster_or(unsigned bits, unsigned* slot, int step,
                                               cg::cluster_group cluster) {
  const int k = step % 3;
  if (threadIdx.x == 0) slot[(step + 1) % 3] = 0u;
  const int lid = threadIdx.x & 31;
  if (bits != 0u && lid < kCluster) atomicOr(cluster.map_shared_rank(slot + k, lid), bits);
  cluster.sync();
  return *static_cast<volatile unsigned*>(slot + k);
}

// The launch of `blocks` blocks of `threads` threads in clusters of
// `cluster` blocks on stream cs; attr is the cluster attribute it points at.
inline cudaLaunchConfig_t cluster_config(int blocks, int threads, int cluster,
                                         cudaStream_t cs, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = cs;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// 0 if a cluster of `cluster` blocks of `threads` threads of `kernel` fits
// the current device (cudaOccupancyMaxActiveClusters), else a CUDA error
// code; a smaller block needs no more of any resource.  Asked once a
// device: `fits` (one array a kernel, kMaxDevices long) holds 1 + the
// answer, 0 before the first ask, and two threads that ask at once store
// the same answer.
inline int check_cluster(const void* kernel, int cluster, int threads,
                         std::atomic<int>* fits) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device < kMaxDevices) {
    const int known = fits[device].load(std::memory_order_relaxed);
    if (known != 0) return known - 1;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, threads, cluster, nullptr, &attr);
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  const int err = e != cudaSuccess ? static_cast<int>(e)
                  : active < 1     ? static_cast<int>(cudaErrorInvalidConfiguration)
                                   : 0;
  if (device < kMaxDevices) fits[device].store(err + 1, std::memory_order_relaxed);
  return err;
}

}  // namespace surf

// The speculative window walks, algo="specN" and "specbN" (N = 1..8): the
// entry points stream_walk_spec_{closest,any} and
// stream_walk_specb_{closest,any}.
//
// Replaces surf_tpu/accel/pallas_wide.py `_kernel_multiblock` with its walks
// `_walk_block_spec` (specN) and `_walk_block_specb` (specbN), closest hit
// and any-hit.  One step (a window) tests N consecutive rows in stream
// order against the running state, then resolves the packet's cursor from
// the rows' (descend, leaf, skip) once, so the fetch -> vote -> cursor
// chain is paid once for N rows.  The function (accel/stream_walk.py
// `_spec_walk`, JAX's code): spec tests rows min(base + w, n - 1) with base
// = min(p, n - 1); specb the rows [base, base + N) with base = clip(p, 0,
// n - N), which may re-test rows before p.  The cursor starts at base
// (spec) or p (specb); row base + w steers while the cursor equals it and
// lies in the stream, to base + w + 1 on a leaf row or a descend, else to
// its skip link; then max(cursor, p + 1).  Visits count the rows that
// steered, the leaf rows among them and the windows.  Windows run in groups
// of kSpecVisits (spec) or kSpecbVisits (specb), and the stop tests (cursor
// in the stream; any-hit: some active ray lacks a hit) come only between
// groups, as JAX's while condition.
//
// The first design (stream_walk.cu `stream_walk_spec_kernel`, kept as the
// entry points stream_walk_spec{,b}_{closest,any}_pr5) ran one 512-thread
// block a packet with 1, 2 or 4 rays a thread: a narrow wave of 4096 rays
// was 2 blocks on 132 SMs, every thread read every row from device memory,
// dead lanes did full work, and once a packet's cursor had left the stream
// its group went on re-testing the clamped last window.  This design:
//
// 1. One packet a work item over a cluster of kCluster = 8 blocks
//    (cudaLaunchKernelEx; the cluster checked once a device), with the
//    packet's active rays compacted over the cluster's blocks (cluster.cuh
//    `scan_active`, `split_active`), each ray in registers with 1/d divided
//    once at load.  A warp that holds no ray skips its tests with a
//    warp-uniform branch and still takes part in the vote.
// 2. A ray on L lanes.  A block of T threads that holds c rays gives each
//    ray L = 1, 2, 4 or 8 lanes, the most with c L <= T; lane sub of a ray
//    tests children (triangles) sub, sub + L, ... in order, and at a leaf
//    row the lanes' bests reduce to the least (t, record) (any-hit: the
//    least record that hits), which is the in-order pass's result (`Ray::
//    leaf_row`).  A narrow wave's window is then a few tests deep, not 8
//    rows x 8 tests on one lane.  L = 1 has its own code path, with the
//    children at constant offsets.
// 3. The vote is a mask: bit w (w < N) "some live ray hits some child box
//    of the window's row w", and for any-hit bit kMaxSpec "some active ray
//    still lacks a hit".  Each warp ORs its mask with __reduce_or_sync into
//    every block of the cluster (cluster.cuh `cluster_or`), then one
//    cluster barrier, and every block resolves the same cursor from the
//    same mask and the window's staged rows.  The any-hit stop between
//    groups reads the last window's bit kMaxSpec: no state changes between
//    a group's last window and its end.
// 4. The window's rows come from shared memory: a window is min(N, n -
//    base) contiguous rows of 512 B, at most 4 KB, copied after the vote
//    with cp.async by every thread of each block (cluster.cuh
//    `stage_rows`) into the other of two buffers (its last reader, the
//    window before, was done before this window's barrier).  spec's
//    clamped rows min(base + w, n - 1), w >= n - base, are not staged and
//    not tested: they re-test row n - 1, tested at w = n - 1 - base (see
//    5.), and their bits are read by no row (row base + w steers only when
//    base + w < n).
// 5. No group overshoot.  Re-testing a row that this packet has tested
//    before changes no bit: a leaf row's triangle j hit at t_j gave every
//    ray bt <= t_j (strictly closer replaces, and bt only falls), so t_j <
//    bt fails again; an any-hit ray that had no hit then has the same bt
//    now, and one with a hit is not live; a node row changes no state.  So
//    once the cursor has left the stream mid-group, the group's remaining
//    windows, which all test the same clamped window (spec: row n - 1;
//    specb: rows [n - N, n)), need only the rows of that window that the
//    last window did not test, [max(n - 1 or n - N, base + N), n), tested
//    once, in order; of those only the leaf rows (a node row sets only bits
//    that nobody reads: the cursor has left).  They are read from device
//    memory (a stream's last rows are mostly pad node rows), and the
//    remaining windows are added to the count.  An any-hit packet whose
//    active rays all have hits mid-group changes no state either, but its
//    cursor still walks to the group's end, because the visits count it:
//    with no live ray no descend bit is set, so warp 0 of block 0 walks the
//    cursor through the remaining windows from each row's leaf flag and
//    skip link alone (32 rows' at a time, one per lane), and the other
//    blocks end.
// The shape and the staging are fixed by sweeps over an ilv2 frame's 64
// walk calls (PERF.md §6, H100 80GB HBM3 at 700.00 W), ms a spp for spec4
// / specb8: 8 blocks x 1 ray a thread 85.09 / 91.44, against 4 x 1 91.43 /
// 98.18, 2 x 1 106.02 / 111.59, 8 x 2 114.40 / 126.69, 4 x 2 122.62 /
// 136.20, 8 x 4 210.59 / 241.17; the rows staged ahead (the fall-through
// window, copied while a window is tested) 85.09 / 91.44 against after
// the vote 85.84 / 91.07, and with L lanes a ray 74.60 / 79.85 against
// 75.00 / 79.03: within the noise, so the simpler copy after the vote
// ships; a warp that stops a node row at its first hit child 85.09 /
// 91.44 against 84.14 / 90.48 without (dropped).  L lanes a ray: 74.60 /
// 79.85 against 83.55 / 91.17 with one lane; at full width it costs 1-3.5%
// (bounce/closest 4.656 against 4.600 ms, specb8 5.388 against 5.206).
//
// Semantics kept from the TPU kernel, as in stream_walk.cu: NaN-propagating
// slab min/max; Möller–Trumbore as mt.cuh's; record id row * 8 + j;
// replacement only on a strictly closer t; with any-hit a ray stops testing
// at its first hit; a packet with no active ray visits nothing; an inactive
// ray returns (t_max, -1, 0, 0).  Build with --fmad=false so the arithmetic
// rounds as the plain PyTorch version's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "entry.cuh"
#include "mt.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRow = surf::kLane / 4;  // float4s per stream row
constexpr int kWidth = 8;              // children (triangles) per row
constexpr int kCluster = 8;            // blocks a packet (portable cluster size)
constexpr int kMaxLanes = 2048;        // rays per packet at most
constexpr int kMinLanes = 512;         // rays per packet at least
constexpr int kMaxThreads = kMaxLanes / kCluster;  // threads a block at most
constexpr int kMinBlocks = 4;          // blocks an SM the registers must allow
constexpr int kMaxSpec = 8;            // rows a window at most
constexpr int kSpecVisits = 32;        // spec: windows between any-hit checks
constexpr int kSpecbVisits = 8;        // specb: windows between any-hit checks
constexpr unsigned kUnfinished = 1u << kMaxSpec;  // the vote's any-hit bit

// This thread's ray, in registers: rank tid / L of its block's, lane sub =
// tid % L of the ray's L lanes (L = 1, 2, 4 or 8, the same in the block).
// Lane sub tests the ray against children (triangles) c = sub, sub + L, ...
struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  float bt, bu, bv;
  int br;
  bool on;

  template <bool kAny>
  __device__ __forceinline__ bool live() const {
    return on && (!kAny || br < 0);
  }

  // The triangles c = sub, sub + L, ... of a leaf row in order (rec0 is
  // row * 8), then the ray's best over its L lanes: for closest hit the
  // least (t, record), for any-hit the least record with a hit.  Each
  // lane's own pass keeps its first hit with the least t below bt, or
  // (any-hit) its first hit, so the result is the in-order pass over all
  // 8: a triangle of this row replaces the ray's best only on a strictly
  // closer t, and its record is larger than that of any earlier best (the
  // rows a walk tests for the first time come in stream order; a row
  // tested again hits nothing new, 5. above).  Every lane of the warp
  // calls it (the shuffles).
  // kSplit false: one lane a ray (L = 1, sub = 0 at compile time).
  template <bool kAny, bool kSplit>
  __device__ __forceinline__ void leaf_row(const float4* row, int rec0, int sub, int L) {
    if (!kSplit) {
      sub = 0;
      L = 1;
    }
#pragma unroll
    for (int k = 0; k < kWidth; ++k) {
      if (k * L >= kWidth) break;
      const int c = sub + k * L;
      const float4 va = row[4 * c];      // v0 x, y, z; e1 x
      const float4 vb = row[4 * c + 1];  // e1 y, z; e2 x, y
      const float4 vc = row[4 * c + 2];  // e2 z
      float t, u, v;
      const bool hit = surf::mt_hit(va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w, vc.x, ox,
                                    oy, oz, dx, dy, dz, bt, t, u, v);
      if (hit && live<kAny>()) {
        bt = t;
        br = rec0 + c;
        bu = u;
        bv = v;
      }
    }
    for (int o = 1; o < L; o <<= 1) {  // the ray's lanes are tid ^ o, o < L
      const float t2 = __shfl_xor_sync(0xffffffffu, bt, o);
      const int r2 = __shfl_xor_sync(0xffffffffu, br, o);
      const float u2 = __shfl_xor_sync(0xffffffffu, bu, o);
      const float v2 = __shfl_xor_sync(0xffffffffu, bv, o);
      if (kAny ? r2 >= 0 && (br < 0 || r2 < br) : t2 < bt || (t2 == bt && r2 < br)) {
        bt = t2;
        br = r2;
        bu = u2;
        bv = v2;
      }
    }
  }

  // The ray, if live, hits one of the child boxes c = sub, sub + L, ... of
  // a node row (the row's bit of the vote is the OR over every lane).
  template <bool kAny, bool kSplit>
  __device__ __forceinline__ bool node_row(const float4* row, int sub, int L) const {
    if (!kSplit) {
      sub = 0;
      L = 1;
    }
    bool hit = false;
#pragma unroll
    for (int k = 0; k < kWidth; ++k) {
      if (k * L >= kWidth) break;
      const int c = sub + k * L;
      const float4 lo4 = row[4 * c];      // lo x, y, z; hi x
      const float4 hi4 = row[4 * c + 1];  // hi y, z; child, is leaf
      if (live<kAny>() && surf::slab_hit(ox, oy, oz, ix, iy, iz, bt, lo4.x, lo4.y, lo4.z,
                                         lo4.w, hi4.x, hi4.y)) {
        hit = true;
      }
    }
    return hit;
  }
};

// A window's tests: rows [base, base + m) of `win` in order against the
// thread's ray; returns bit w for each node row w that the ray hits
// (kSplit: L lanes a ray).
template <bool kAny, bool kSplit>
__device__ __forceinline__ unsigned test_window(Ray& R, const float4* win, int m, int base,
                                                int sub, int L) {
  unsigned mask = 0u;
#pragma unroll 1
  for (int w = 0; w < m; ++w) {
    const float4* row = win + w * kRow;
    if (__float_as_int(row[2].y) == 1) {  // lane 9: is_leaf
      R.leaf_row<kAny, kSplit>(row, (base + w) * kWidth, sub, L);
    } else if (R.node_row<kAny, kSplit>(row, sub, L)) {
      mask |= 1u << w;
    }
  }
  return mask;
}

// The base of the window that cursor q (< n) tests: spec min(q, n - 1) = q,
// specb clip(q, 0, n - width).
template <bool kBlock>
__device__ __forceinline__ int window_base(int q, int n, int width) {
  return kBlock ? max(min(q, n - width), 0) : q;
}

// Any-hit, once no active ray lacks a hit: the cursor's walk through the
// group's remaining `tail` windows (5. above), by one warp.  Lane l holds
// the leaf flag and skip link of row p0 + l; a window's steering rows lie
// in [p, p + width), so a window past p0 + 32 reloads from p0 = p.
template <bool kBlock>
__device__ __forceinline__ void walk_untested(const float* __restrict__ stream, int n,
                                              int width, int tail, int& p, int& visits,
                                              int& leaf_visits, int& windows) {
  const int lid = threadIdx.x & 31;
  int p0 = -kMaxSpec - 32, leaf = 0, skip = 0;
  for (int g = 0; g < tail; ++g) {
    if (p >= n) {
      windows += tail - g;
      return;
    }
    if (p < p0 || p + width > p0 + 32) {
      p0 = p;
      if (p0 + lid < n) {
        const float4 meta = __ldg(surf::row_at(stream, p0 + lid) + 2);
        leaf = __float_as_int(meta.y) == 1;
        skip = __float_as_int(meta.z);
      }
    }
    const int base = window_base<kBlock>(p, n, width);
    int nxt = kBlock ? p : base;
    for (int w = 0; w < width; ++w) {
      const int r = base + w;
      const int is_leaf = __shfl_sync(0xffffffffu, leaf, (r - p0) & 31);
      const int link = __shfl_sync(0xffffffffu, skip, (r - p0) & 31);
      if (nxt != r || r >= n) continue;
      nxt = is_leaf ? r + 1 : link;
      ++visits;
      leaf_visits += is_leaf;
    }
    ++windows;
    p = max(nxt, p + 1);
  }
}

// One packet a cluster of kCluster blocks; blockDim.x = block_rays /
// kCluster.  At most 64 registers a thread (kMinBlocks = 4 blocks of 256
// threads an SM).
template <bool kAny, bool kBlock>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
stream_walk_spec_split_kernel(const float* __restrict__ stream, int n_entries,
                              const float* __restrict__ rays, const int* __restrict__ act,
                              int n_rays, int block_rays, int width,
                              float* __restrict__ t_out, int* __restrict__ r_out,
                              float* __restrict__ u_out, float* __restrict__ v_out,
                              int* __restrict__ visits_out) {
  __shared__ float4 rows[2][kMaxSpec * kRow];  // this window and the next
  __shared__ int live_lane[kMaxLanes / kCluster];
  __shared__ int warp_live[kMaxThreads / 32];
  __shared__ unsigned slot[3];
  constexpr int kGroup = kBlock ? kSpecbVisits : kSpecVisits;
  const cg::cluster_group cluster = cg::this_cluster();
  const int T = blockDim.x;
  const int s = static_cast<int>(cluster.block_rank());
  const int packet = blockIdx.x / kCluster;
  const size_t n = static_cast<size_t>(n_rays);  // rays is [7, n_rays]
  const size_t first = static_cast<size_t>(packet) * block_rays;
  const int* a = act + first;
  const int tid = threadIdx.x, wid = tid >> 5;
  const int ne = n_entries;

  // the first window, read after the barriers below
  surf::stage_rows(rows[0], stream, 0, min(width, ne));

  // Compaction: the same ranks in every block of the cluster.
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

  // Lanes a ray: as many as the block's threads allow, up to one a child.
  int L = 1;
  while (L < kWidth && cnt * 2 * L <= T) L *= 2;
  const int sub = tid & (L - 1);
  Ray R;
  R.on = tid / L < cnt;
  const size_t i = first + (R.on ? live_lane[tid / L] : 0);
  R.ox = rays[i];
  R.oy = rays[n + i];
  R.oz = rays[2 * n + i];
  R.dx = rays[3 * n + i];
  R.dy = rays[4 * n + i];
  R.dz = rays[5 * n + i];
  R.ix = 1.0f / R.dx;
  R.iy = 1.0f / R.dy;
  R.iz = 1.0f / R.dz;
  R.bt = rays[6 * n + i];
  R.bu = 0.0f;
  R.bv = 0.0f;
  R.br = -1;
  // Every thread of a warp whose first thread holds no ray holds none.
  const bool warp_on = (wid << 5) < cnt * L;

  cluster.sync();  // every block runs, slots zero
  int p = n_live > 0 ? 0 : ne;
  bool unfinished = n_live > 0;  // any-hit: some active ray lacks a hit
  int visits = 0, leaf_visits = 0, windows = 0;
  int step = 0;  // windows tested: the vote's step
  int buf = 0;   // the window's rows lie in rows[buf]
  int base = 0;  // the base of the last window tested
  int tail = 0;  // windows of the last group that test nothing
  while (p < ne && (!kAny || unfinished)) {
    int g = 0;
    do {
      base = window_base<kBlock>(p, ne, width);
      const int m = min(width, ne - base);
      const float4* win = rows[buf];
      unsigned mask = 0u;
      if (warp_on) {
        mask = L == 1 ? test_window<kAny, false>(R, win, m, base, sub, L)
                      : test_window<kAny, true>(R, win, m, base, sub, L);
      }
      if (kAny && R.on && R.br < 0) mask |= kUnfinished;
      mask = surf::cluster_or<kCluster>(__reduce_or_sync(0xffffffffu, mask), slot, step,
                                        cluster);
      int nxt = kBlock ? p : base;
      for (int w = 0; w < m; ++w) {
        const int r = base + w;
        if (nxt != r) continue;
        const float4 meta = win[w * kRow + 2];  // lane 9 is_leaf, lane 10 skip
        const bool is_leaf = __float_as_int(meta.y) == 1;
        nxt = (is_leaf || ((mask >> w) & 1u)) ? r + 1 : __float_as_int(meta.z);
        ++visits;
        leaf_visits += is_leaf;
      }
      p = max(nxt, p + 1);
      if (kAny) unfinished = (mask & kUnfinished) != 0u;
      ++windows;
      ++g;
      ++step;
      if (p < ne) {  // the next window
        buf ^= 1;
        const int next = window_base<kBlock>(p, ne, width);
        surf::stage_rows(rows[buf], stream, next, min(width, ne - next));
        surf::staged_wait();
        __syncthreads();
      }
    } while (g < kGroup && p < ne && (!kAny || unfinished));
    tail = kGroup - g;
    if (tail > 0) break;
  }

  if (tail > 0 && p >= ne) {
    // The cursor left the stream mid-group (5. above): the rows of the
    // clamped window that the last window did not test, once.
    if (warp_on && (!kAny || unfinished)) {
      for (int r = max(ne - (kBlock ? width : 1), base + width); r < ne; ++r) {
        const float4* row = surf::row_at(stream, r);
        if (__float_as_int(__ldg(row + 2).y) == 1) {
          R.leaf_row<kAny, true>(row, r * kWidth, sub, L);
        }
      }
    }
    windows += tail;
  } else if (kAny && tail > 0 && s == 0 && wid == 0) {
    walk_untested<kBlock>(stream, ne, width, tail, p, visits, leaf_visits, windows);
  }

  if (R.on && sub == 0) {
    t_out[i] = R.bt;
    r_out[i] = R.br;
    u_out[i] = R.bu;
    v_out[i] = R.bv;
  }
  if (s == 0 && tid == 0) {
    visits_out[3 * packet] = visits;
    visits_out[3 * packet + 1] = leaf_visits;
    visits_out[3 * packet + 2] = windows;
  }
}

template <bool kAny, bool kBlock>
int launch(const float* stream, int n_entries, const float* rays, const int* act, int n_rays,
           int block_rays, int arg, float* t, int* r, float* u, float* v, int* visits,
           cudaStream_t cs) {
  if (arg < 1 || arg > kMaxSpec || n_entries < 1 || (kBlock && arg > n_entries) ||
      block_rays < kMinLanes || block_rays > kMaxLanes ||
      block_rays % (kCluster * 32) != 0 || n_rays <= 0 || n_rays % block_rays != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Whether a cluster of kCluster blocks of kMaxThreads threads fits the
  // device, asked once a device (cluster.cuh).
  static std::atomic<int> fits[surf::kMaxDevices];
  auto* kernel = stream_walk_spec_split_kernel<kAny, kBlock>;
  const int err =
      surf::check_cluster(reinterpret_cast<const void*>(kernel), kCluster, kMaxThreads, fits);
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      surf::cluster_config(n_rays / block_rays * kCluster, block_rays / kCluster, kCluster,
                           cs, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, stream, n_entries, rays, act, n_rays,
                                           block_rays, arg, t, r, u, v, visits);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes, the arguments of stream_walk.cu's: stream
// is [n_entries, 128]; rays is [7, n_rays] (ox, oy, oz, dx, dy, dz, t_max);
// act is [n_rays]; n_rays is a positive multiple of block_rays (512, 1024
// or 2048); arg is N, the rows a window (1..8; specb: at most n_entries);
// visits is [n_rays / block_rays, 3]: rows that steered, leaf rows among
// them, windows.  Return cudaGetLastError() after the launch, or the error
// that kept it from launching.
#define SURF_SPEC_ENTRY(NAME, ANY, BLOCK)                                                  \
  extern "C" int NAME(const float* stream, int n_entries, const float* rays, const int* act, \
                      int n_rays, int block_rays, int arg, float* t, int* r, float* u,      \
                      float* v, int* visits, cudaStream_t cs) {                             \
    return launch<ANY, BLOCK>(stream, n_entries, rays, act, n_rays, block_rays, arg, t, r, \
                              u, v, visits, cs);                                            \
  }                                                                                         \
  SURF_KERNEL_OF(NAME, stream_walk_spec_split_kernel<ANY, BLOCK>)

SURF_SPEC_ENTRY(stream_walk_spec_closest, false, false)
SURF_SPEC_ENTRY(stream_walk_spec_any, true, false)
SURF_SPEC_ENTRY(stream_walk_specb_closest, false, true)
SURF_SPEC_ENTRY(stream_walk_specb_any, true, true)

// Packet walks of the 8-wide DFS stream: algo="skip" and algo="stack".
//
// Replaces surf_tpu/accel/pallas_wide.py `_kernel_multiblock` with its walks
// `_walk_block` / `_make_skip_visit` (skip) and `_walk_block_stack`
// (stack), closest hit and any-hit.  The stream (accel/wide.py) holds node
// rows (8 child boxes and child pointers) and leaf rows (8 triangles);
// lane 9 of a row says which, lane 10 is its skip link.
//
// What bounds it on the card: every visit of a row costs each ray of the
// packet 8 slab tests (a node row) or 8 Möller–Trumbore tests (a leaf
// row), against 512 bytes of row that every ray reads, so the work is
// operations, not bytes.  What a packet walk adds is latency: the next row
// depends on a packet-wide vote, so each visit ends in a block barrier.
//
// Design: one block per packet, the function the TPU kernel computes.
// kThreads threads hold block_rays / kThreads rays each in registers (a
// 2048-ray packet exceeds 1024 threads).  The packet's cursor is the same
// in every thread: each thread reads the visited row from device memory at
// the same addresses as float4 loads (a broadcast in L1), tests its rays,
// and `__syncthreads_or` gives the packet-wide "some live ray hits", which
// is also the visit's barrier.  The stack walk needs a vote per child: an
// 8-bit mask per thread, OR-ed over the warp (`__reduce_or_sync`) and over
// the block with one shared-memory atomicOr per warp, double-buffered by
// visit parity so that one barrier orders its reset; its (row, remaining
// children) stack lives in shared memory, read by every thread after a
// barrier and written by thread 0 after the vote.  A pop re-reads the
// parent row's child pointer from device memory, as the TPU kernel does.
//
// Semantics kept from the TPU kernel: the slab test's min/max propagate
// NaN as jnp.minimum/maximum do (empty child slots and pad rows are NaN
// boxes and never hit; fminf/fmaxf would drop the NaN); the caller nudges
// zero direction components, so 1/d is an IEEE division of finite values;
// Möller–Trumbore is mt.cuh's; the record id is row * 8 + j; replacement
// only on a strictly closer t; with any-hit a ray stops testing at its
// first hit and the packet stops once every active ray has one.  The TPU
// kernel evaluates both interpretations of every row and kills the wrong
// one (a NaN added to a node row's t); here a branch on the row kind,
// uniform in the block, runs only the right one: the two agree bit for
// bit, since the TPU's leaf-row t + 0.0 equals t for every t that can pass
// t >= 1e-5.  A packet with no active ray visits nothing.  Build with
// --fmad=false so the arithmetic rounds as the plain PyTorch version's.

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr int kLane = 128;      // floats per stream row
constexpr int kWidth = 8;       // children (triangles) per row
constexpr int kThreads = 512;   // threads per block (= per packet)
constexpr int kMaxStack = 64;   // stack capacity of the stack walk
constexpr int kBelt = 32;       // stack walk: at most n_entries + kBelt visits

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// One packet's rays, kRays of them per thread, in registers.
template <int kRays>
struct Packet {
  float ox[kRays], oy[kRays], oz[kRays];
  float dx[kRays], dy[kRays], dz[kRays];
  float ix[kRays], iy[kRays], iz[kRays];
  bool act[kRays];
  float bt[kRays], bu[kRays], bv[kRays];
  int br[kRays];

  // Loads the rays of the packet starting at ray `first`; returns whether
  // this thread holds an active ray.  rays is [7, n_rays].
  __device__ __forceinline__ bool load(const float* __restrict__ rays,
                                       const int* __restrict__ a, int n_rays,
                                       int first) {
    const size_t s = static_cast<size_t>(n_rays);
    bool any = false;
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
      br[r] = -1;
      bu[r] = 0.0f;
      bv[r] = 0.0f;
      act[r] = a[i] != 0;
      any |= act[r];
    }
    return any;
  }

  __device__ __forceinline__ void store(float* __restrict__ t, int* __restrict__ rec,
                                        float* __restrict__ u, float* __restrict__ v,
                                        int first) const {
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const int i = first + r * kThreads + threadIdx.x;
      t[i] = bt[r];
      rec[i] = br[r];
      u[i] = bu[r];
      v[i] = bv[r];
    }
  }

  template <bool kAny>
  __device__ __forceinline__ bool live(int r) const {
    return act[r] && (!kAny || br[r] < 0);
  }

  // Some active ray of this thread still lacks a hit.
  __device__ __forceinline__ bool unfinished() const {
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRays; ++r) any |= act[r] && br[r] < 0;
    return any;
  }

  // Slab test of ray r against a child box (pallas_wide.py:194-209).
  __device__ __forceinline__ bool slab(int r, float lox, float loy, float loz,
                                       float hix, float hiy, float hiz) const {
    const float txn = (lox - ox[r]) * ix[r];
    const float txf = (hix - ox[r]) * ix[r];
    float tmin = nan_min(txn, txf);
    float tmax = nan_max(txn, txf);
    const float tyn = (loy - oy[r]) * iy[r];
    const float tyf = (hiy - oy[r]) * iy[r];
    tmin = nan_max(tmin, nan_min(tyn, tyf));
    tmax = nan_min(tmax, nan_max(tyn, tyf));
    const float tzn = (loz - oz[r]) * iz[r];
    const float tzf = (hiz - oz[r]) * iz[r];
    tmin = nan_max(tmin, nan_min(tzn, tzf));
    tmax = nan_min(tmax, nan_max(tzn, tzf));
    return (tmax >= tmin) & (tmin < bt[r]) & (tmax > 0.0f);
  }

  // Bit k set when some live ray of this thread hits child box k of a node
  // row.
  template <bool kAny>
  __device__ __forceinline__ unsigned child_hits(const float4* __restrict__ row) const {
    unsigned m = 0u;
#pragma unroll
    for (int k = 0; k < kWidth; ++k) {
      const float4 a = __ldg(row + 4 * k);      // lo x, y, z; hi x
      const float4 b = __ldg(row + 4 * k + 1);  // hi y, z; child, is leaf
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        if (live<kAny>(r) && slab(r, a.x, a.y, a.z, a.w, b.x, b.y)) m |= 1u << k;
      }
    }
    return m;
  }

  // The 8 triangles of a leaf row, in order; rec0 is row * 8.
  template <bool kAny>
  __device__ __forceinline__ void leaf_row(const float4* __restrict__ row, int rec0) {
#pragma unroll
    for (int j = 0; j < kWidth; ++j) {
      const float4 a = __ldg(row + 4 * j);      // v0 x, y, z; e1 x
      const float4 b = __ldg(row + 4 * j + 1);  // e1 y, z; e2 x, y
      const float4 c = __ldg(row + 4 * j + 2);  // e2 z
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        float t, u, v;
        const bool hit = surf::mt_hit(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x,
                                      ox[r], oy[r], oz[r], dx[r], dy[r], dz[r],
                                      bt[r], t, u, v);
        if (hit && live<kAny>(r)) {
          bt[r] = t;
          br[r] = rec0 + j;
          bu[r] = u;
          bv[r] = v;
        }
      }
    }
  }
};

// Skip-link walk (pallas_wide.py:142-261).
template <int kRays, bool kAny>
__global__ void __launch_bounds__(kThreads)
stream_walk_skip_kernel(const float* __restrict__ stream, int n_entries,
                        const float* __restrict__ rays, const int* __restrict__ act,
                        int n_rays, int block_rays, float* __restrict__ t_out,
                        int* __restrict__ r_out, float* __restrict__ u_out,
                        float* __restrict__ v_out, int* __restrict__ visits_out) {
  const int first = blockIdx.x * block_rays;
  Packet<kRays> P;
  int p = __syncthreads_or(P.load(rays, act, n_rays, first)) ? 0 : n_entries;
  int visits = 0, leaf_visits = 0;
  const float4* s4 = reinterpret_cast<const float4*>(stream);
  while (p < n_entries) {
    const float4* row = s4 + static_cast<size_t>(p) * (kLane / 4);
    const float4 meta = __ldg(row + 2);  // lanes 8-11: lane 9 is_leaf, lane 10 skip
    const bool is_leaf = __float_as_int(meta.y) == 1;
    bool vote = false;
    if (is_leaf) {
      P.template leaf_row<kAny>(row, p * kWidth);
      vote = kAny && P.unfinished();
    } else {
      vote = P.template child_hits<kAny>(row) != 0u;
    }
    // A node row: does some live ray hit some child?  A leaf row (any-hit):
    // does some active ray still lack a hit?  (At a node row that is true:
    // no hit changed since the last leaf row's vote, or since the start.)
    const bool any = __syncthreads_or(vote) != 0;
    int next = (is_leaf || any) ? p + 1 : __float_as_int(meta.z);
    next = max(next, p + 1);
    if (kAny && is_leaf && !any) next = n_entries;
    ++visits;
    leaf_visits += is_leaf;
    p = next;
  }
  P.store(t_out, r_out, u_out, v_out, first);
  if (threadIdx.x == 0) {
    visits_out[2 * blockIdx.x] = visits;
    visits_out[2 * blockIdx.x + 1] = leaf_visits;
  }
}

// Register-stack walk (pallas_wide.py:672-859), the stack in shared memory.
template <int kRays, bool kAny>
__global__ void __launch_bounds__(kThreads)
stream_walk_stack_kernel(const float* __restrict__ stream, int n_entries,
                         const float* __restrict__ rays, const int* __restrict__ act,
                         int n_rays, int block_rays, int stack_depth,
                         float* __restrict__ t_out, int* __restrict__ r_out,
                         float* __restrict__ u_out, float* __restrict__ v_out,
                         int* __restrict__ visits_out) {
  __shared__ int s_row[kMaxStack];
  __shared__ unsigned s_mask[kMaxStack];
  __shared__ unsigned s_hits[2];
  const int first = blockIdx.x * block_rays;
  Packet<kRays> P;
  const bool mine = P.load(rays, act, n_rays, first);
  if (threadIdx.x == 0) {
    s_hits[0] = 0u;
    s_hits[1] = 0u;
  }
  int cur = __syncthreads_or(mine) ? 0 : -1;  // the root, a node row
  bool cleaf = false;
  int sp = 0, visits = 0, leaf_visits = 0;
  const float4* s4 = reinterpret_cast<const float4*>(stream);
  const int belt = n_entries + kBelt;
  while (cur >= 0 && visits < belt) {
    const int b = visits & 1;
    __syncthreads();  // the previous visit's stack writes are visible
    const bool top_ok = sp >= 1 && sp <= stack_depth;
    const int trow = top_ok ? s_row[sp - 1] : 0;
    const unsigned tmask = top_ok ? s_mask[sp - 1] : 0u;
    if (threadIdx.x == 0) s_hits[b ^ 1] = 0u;  // read by all before the barrier above
    const float4* row = s4 + static_cast<size_t>(cur) * (kLane / 4);
    bool vote = false;
    if (cleaf) {
      P.template leaf_row<kAny>(row, cur * kWidth);
      vote = kAny && P.unfinished();
    } else {
      const unsigned m = __reduce_or_sync(0xffffffffu, P.template child_hits<kAny>(row));
      if ((threadIdx.x & 31) == 0 && m != 0u) atomicOr(&s_hits[b], m);
    }
    // Leaf row (any-hit): does some active ray still lack a hit?  At a node
    // row that is true, as in the skip walk.
    const bool alive = __syncthreads_or(vote) != 0;
    const unsigned mask = cleaf ? 0u : s_hits[b];
    const unsigned rem = mask & (mask - 1u);
    const bool go = mask != 0u;
    const bool push = go && rem != 0u;
    const bool pop = !go && sp > 0;
    const unsigned prem = tmask & (tmask - 1u);
    int nxt = -1;
    bool nleaf = false;
    if (go || pop) {
      // descend to the first hit child, or to the next pending child of the
      // row on top of the stack (none if its mask is empty: child 0 of row 0)
      const unsigned pick = go ? mask : tmask;
      const int from = go ? cur : max(trow, 0);
      nxt = 0;
      if (pick != 0u) {
        const int k = __ffs(pick) - 1;
        const float4 c = __ldg(s4 + static_cast<size_t>(from) * (kLane / 4) + 4 * k + 1);
        nxt = __float_as_int(c.z);
        nleaf = __float_as_int(c.w) == 1;
      }
    }
    if (threadIdx.x == 0) {
      if (push && sp < stack_depth) {
        s_row[sp] = cur;
        s_mask[sp] = rem;
      }
      if (pop && top_ok) s_mask[sp - 1] = prem;
    }
    sp += (push ? 1 : 0) - ((pop && prem == 0u) ? 1 : 0);
    ++visits;
    leaf_visits += cleaf;
    cur = (kAny && cleaf && !alive) ? -1 : nxt;
    cleaf = nleaf;
  }
  P.store(t_out, r_out, u_out, v_out, first);
  if (threadIdx.x == 0) {
    visits_out[2 * blockIdx.x] = visits;
    visits_out[2 * blockIdx.x + 1] = leaf_visits;
  }
}

template <int kRays, bool kAny, bool kStack>
int launch(const float* stream, int n_entries, const float* rays, const int* act,
           int n_rays, int block_rays, int stack_depth, float* t, int* r, float* u,
           float* v, int* visits, cudaStream_t cs) {
  const int packets = n_rays / block_rays;
  if constexpr (kStack) {
    stream_walk_stack_kernel<kRays, kAny><<<packets, kThreads, 0, cs>>>(
        stream, n_entries, rays, act, n_rays, block_rays, stack_depth, t, r, u, v,
        visits);
  } else {
    stream_walk_skip_kernel<kRays, kAny><<<packets, kThreads, 0, cs>>>(
        stream, n_entries, rays, act, n_rays, block_rays, t, r, u, v, visits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kAny, bool kStack>
int dispatch(const float* stream, int n_entries, const float* rays, const int* act,
             int n_rays, int block_rays, int stack_depth, float* t, int* r, float* u,
             float* v, int* visits, cudaStream_t cs) {
  if (kStack && (stack_depth < 1 || stack_depth > kMaxStack)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (block_rays / kThreads) {
    case 1:
      return launch<1, kAny, kStack>(stream, n_entries, rays, act, n_rays, block_rays,
                                     stack_depth, t, r, u, v, visits, cs);
    case 2:
      return launch<2, kAny, kStack>(stream, n_entries, rays, act, n_rays, block_rays,
                                     stack_depth, t, r, u, v, visits, cs);
    case 4:
      return launch<4, kAny, kStack>(stream, n_entries, rays, act, n_rays, block_rays,
                                     stack_depth, t, r, u, v, visits, cs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes.  stream is [n_entries, 128]; rays is
// [7, n_rays] (ox, oy, oz, dx, dy, dz, t_max); act is [n_rays]; n_rays is a
// positive multiple of block_rays, which is 1, 2 or 4 times kThreads.
// visits is [n_rays / block_rays, 2]: rows visited, leaf rows among them.
// stack_depth (1..64) bounds the stack walk's stack; the skip walk ignores
// it.  Returns cudaGetLastError() after the launch.
extern "C" int stream_walk_threads_per_block() { return kThreads; }

#define SURF_STREAM_ENTRY(NAME, ANY, STACK)                                          \
  extern "C" int NAME(const float* stream, int n_entries, const float* rays,         \
                      const int* act, int n_rays, int block_rays, int stack_depth,   \
                      float* t, int* r, float* u, float* v, int* visits,             \
                      cudaStream_t cs) {                                             \
    return dispatch<ANY, STACK>(stream, n_entries, rays, act, n_rays, block_rays,    \
                                stack_depth, t, r, u, v, visits, cs);                \
  }

SURF_STREAM_ENTRY(stream_walk_skip_closest, false, false)
SURF_STREAM_ENTRY(stream_walk_skip_any, true, false)
SURF_STREAM_ENTRY(stream_walk_stack_closest, false, true)
SURF_STREAM_ENTRY(stream_walk_stack_any, true, true)

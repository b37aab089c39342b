// Packet walks of the 8-wide DFS stream: algo="skip", "stack", and the TPU's
// schedules of the skip walk, "skip2" / "ilvN" and "specN" / "specbN".
//
// Replaces surf_tpu/accel/pallas_wide.py `_kernel_multiblock` with its walks
// `_walk_block` / `_make_skip_visit` (skip), `_walk_block_stack` (stack),
// `_walk_block_pair` / `_walk_block_multi` (skip2, ilvN),
// `_walk_block_spec` (specN) and `_walk_block_specb` (specbN), closest hit
// and any-hit.  The stream (accel/wide.py) holds node rows (8 child boxes
// and child pointers) and leaf rows (8 triangles); lane 9 of a row says
// which, lane 10 is its skip link.
//
// What bounds it on the card: every visit of a row costs each ray of the
// packet 8 slab tests (a node row) or 8 Möller–Trumbore tests (a leaf
// row), against 512 bytes of row that every ray reads, so the work is
// operations, not bytes.  What a packet walk adds is latency: the next row
// depends on a packet-wide vote, so each visit ends in a block barrier.
// The TPU schedules attack that chain: ilvN lets N packets share one vote
// and barrier a step; specN / specbN test N consecutive rows a step and
// resolve the cursor from their N votes after one barrier.
//
// Design: one block per packet (ilvN: per N packets), the function the TPU
// kernel computes.  No algo runs these kernels any more: skip, skip2 and
// ilvN run stream_walk_ilv.cu's kernel (skip is ilv1's function), specN /
// specbN stream_walk_spec.cu's and stack stream_walk_stack.cu's (one
// packet a work item over a cluster).  These first designs stay as the
// entry points stream_walk_skip_{closest,any},
// stream_walk_stack_{closest,any}_pr3 and
// stream_walk_{ilv,spec,specb}_{closest,any}_pr5, which only the timing in
// chip_smoke.py and the CUDA tests reach (accel/stream_walk.py
// stream_walk_skip_pr3, stream_walk_stack_pr3, stream_walk_ilv_pr5,
// stream_walk_spec_pr5).  kThreads threads hold block_rays / kThreads rays
// each (a 2048-ray packet exceeds 1024 threads).  The packet's cursor is the
// same in every thread: each thread reads the visited row from device
// memory at the same addresses as float4 loads (a broadcast in L1), tests
// its rays, and a block vote gives the packet-wide "some live ray hits",
// which is also the visit's barrier: `__syncthreads_or` for one bit, else
// (`surf::block_or`, vote.cuh) a bit mask per thread OR-ed over the warp
// (`__reduce_or_sync`) and over the block with one shared-memory atomicOr
// per warp, in one of three slots by step so that one barrier a step
// orders both the ORs and the next slot's reset.  The stack walk votes one
// bit per child; its (row, remaining children) stack lives in shared
// memory, read by every thread after a barrier and written by thread 0
// after the vote.  A pop re-reads the parent row's child pointer from
// device memory, as the TPU kernel does.  ilvN keeps the rays of its N
// packets (up to 8,192: too many for registers) as (o, d) in dynamic
// shared memory, 24 bytes a ray, computes 1/d at each node row, keeps each
// ray's best hit in registers, and votes one bit per packet; a packet
// whose cursor has left the stream loads no rows but stays in the
// barrier.  specN / specbN keep the skip walk's registers, test the
// window's rows in stream order (a node row sets its bit of the window's
// descend mask) and resolve the same cursor in every thread.
//
// Semantics kept from the TPU kernel: the slab test's min/max propagate
// NaN as jnp.minimum/maximum do (empty child slots and pad rows are NaN
// boxes and never hit; fminf/fmaxf would drop the NaN); the caller nudges
// zero direction components, so 1/d is an IEEE division of finite values;
// Möller–Trumbore is mt.cuh's; the record id is row * 8 + j; replacement
// only on a strictly closer t; with any-hit a ray stops testing at its
// first hit and the packet stops once every active ray has one (spec /
// specb: checked only between groups of kSpecVisits / kSpecbVisits
// windows, as JAX's while condition is).  The TPU kernel evaluates both
// interpretations of every row and kills the wrong one (a NaN added to a
// node row's t); here a branch on the row kind, uniform in the block, runs
// only the right one: the two agree bit for bit, since the TPU's leaf-row
// t + 0.0 equals t for every t that can pass t >= 1e-5.  A packet with no
// active ray visits nothing.  Build with --fmad=false so the arithmetic
// rounds as the plain PyTorch version's.

#include <cuda_runtime.h>

#include "entry.cuh"
#include "mt.cuh"
#include "vote.cuh"

namespace {

constexpr int kLane = 128;      // floats per stream row
constexpr int kWidth = 8;       // children (triangles) per row
constexpr int kThreads = 512;   // threads per block
constexpr int kMaxStack = 64;   // stack capacity of the stack walk
constexpr int kBelt = 32;       // stack walk: at most n_entries + kBelt visits
constexpr int kMaxIlv = 4;      // ilvN: packets per block
constexpr int kMaxSpec = 8;     // specN / specbN: rows per window
constexpr int kSpecVisits = 32;   // spec: windows between any-hit checks
constexpr int kSpecbVisits = 8;   // specb: windows between any-hit checks
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can have

enum Walk { kSkip, kStack, kIlv, kSpec, kSpecb };

__device__ __forceinline__ const float4* row_at(const float* stream, int p) {
  return reinterpret_cast<const float4*>(stream) + static_cast<size_t>(p) * (kLane / 4);
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
        if (live<kAny>(r) && surf::slab_hit(ox[r], oy[r], oz[r], ix[r], iy[r], iz[r],
                                            bt[r], a.x, a.y, a.z, a.w, b.x, b.y)) {
          m |= 1u << k;
        }
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

__device__ __forceinline__ void store_visits(int* visits_out, int packet, int visits,
                                             int leaf_visits, int windows) {
  visits_out[3 * packet] = visits;
  visits_out[3 * packet + 1] = leaf_visits;
  visits_out[3 * packet + 2] = windows;
}

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
  while (p < n_entries) {
    const float4* row = row_at(stream, p);
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
  if (threadIdx.x == 0) store_visits(visits_out, blockIdx.x, visits, leaf_visits, visits);
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
  if (threadIdx.x == 0) store_visits(visits_out, blockIdx.x, visits, leaf_visits, visits);
}

// ilvN / skip2 (pallas_wide.py:264-335): kM packets of kPer * kThreads rays
// walk the skip walk side by side, each with its own cursor, one vote bit
// per packet and one barrier a step for all of them.  Each packet's result
// and visits are the skip walk's.  The rays' (o, d) lie in dynamic shared
// memory, [6][kM * block_rays]; ray j of this thread is the block's ray
// j * kThreads + threadIdx.x, of packet j / kPer.
template <int kM, int kPer, bool kAny>
__global__ void __launch_bounds__(kThreads)
stream_walk_ilv_kernel(const float* __restrict__ stream, int n_entries,
                       const float* __restrict__ rays, const int* __restrict__ act,
                       int n_rays, int block_rays, float* __restrict__ t_out,
                       int* __restrict__ r_out, float* __restrict__ u_out,
                       float* __restrict__ v_out, int* __restrict__ visits_out) {
  extern __shared__ float s_ray[];
  __shared__ unsigned s_vote[3];
  constexpr int kR = kM * kPer;
  constexpr int nb = kR * kThreads;  // == kM * block_rays
  const int packets = n_rays / block_rays;
  const int pk0 = blockIdx.x * kM;
  const int first = pk0 * block_rays;
  const size_t s = static_cast<size_t>(n_rays);
  float bt[kR], bu[kR], bv[kR];
  int br[kR];
  unsigned act_bits = 0u;  // bit j: ray j is active
  unsigned mine = 0u;      // bit m: this thread holds an active ray of packet m
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int loc = j * kThreads + threadIdx.x;
    const int i = first + loc;
    const bool real = pk0 + j / kPer < packets;
#pragma unroll
    for (int c = 0; c < 6; ++c) s_ray[c * nb + loc] = real ? rays[c * s + i] : 1.0f;
    bt[j] = real ? rays[6 * s + i] : 0.0f;
    br[j] = -1;
    bu[j] = 0.0f;
    bv[j] = 0.0f;
    if (real && act[i] != 0) {
      act_bits |= 1u << j;
      mine |= 1u << (j / kPer);
    }
  }
  if (threadIdx.x == 0) {
    s_vote[0] = 0u;
    s_vote[1] = 0u;
    s_vote[2] = 0u;
  }
  __syncthreads();  // the slots are zero, the rays in shared memory
  const unsigned started = surf::block_or(mine, s_vote, 0);
  int p[kM], visits[kM], leaf_visits[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    p[m] = (started >> m) & 1u ? 0 : n_entries;
    visits[m] = 0;
    leaf_visits[m] = 0;
  }
  for (int step = 1;; ++step) {
    bool on = false;
#pragma unroll
    for (int m = 0; m < kM; ++m) on |= p[m] < n_entries;
    if (!on) break;
    unsigned vote = 0u;
    bool leaf[kM];
    int skip[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      leaf[m] = false;
      skip[m] = 0;
      if (p[m] >= n_entries) continue;
      const float4* row = row_at(stream, p[m]);
      const float4 meta = __ldg(row + 2);
      leaf[m] = __float_as_int(meta.y) == 1;
      skip[m] = __float_as_int(meta.z);
      bool v = false;
      if (leaf[m]) {
        const int rec0 = p[m] * kWidth;
#pragma unroll
        for (int k = 0; k < kWidth; ++k) {
          const float4 a = __ldg(row + 4 * k);
          const float4 b = __ldg(row + 4 * k + 1);
          const float4 c = __ldg(row + 4 * k + 2);
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const int j = m * kPer + q;
            const int loc = j * kThreads + threadIdx.x;
            float t, u, v_;
            const bool hit = surf::mt_hit(
                a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, s_ray[loc],
                s_ray[nb + loc], s_ray[2 * nb + loc], s_ray[3 * nb + loc],
                s_ray[4 * nb + loc], s_ray[5 * nb + loc], bt[j], t, u, v_);
            if (hit && ((act_bits >> j) & 1u) && (!kAny || br[j] < 0)) {
              bt[j] = t;
              br[j] = rec0 + k;
              bu[j] = u;
              bv[j] = v_;
            }
          }
        }
        if (kAny) {
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const int j = m * kPer + q;
            v |= ((act_bits >> j) & 1u) && br[j] < 0;
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int j = m * kPer + q;
          if (!((act_bits >> j) & 1u) || (kAny && br[j] >= 0)) continue;
          const int loc = j * kThreads + threadIdx.x;
          const float ox = s_ray[loc], oy = s_ray[nb + loc], oz = s_ray[2 * nb + loc];
          const float ix = 1.0f / s_ray[3 * nb + loc];
          const float iy = 1.0f / s_ray[4 * nb + loc];
          const float iz = 1.0f / s_ray[5 * nb + loc];
#pragma unroll
          for (int k = 0; k < kWidth; ++k) {
            const float4 a = __ldg(row + 4 * k);
            const float4 b = __ldg(row + 4 * k + 1);
            v |= surf::slab_hit(ox, oy, oz, ix, iy, iz, bt[j], a.x, a.y, a.z, a.w, b.x,
                                b.y);
          }
        }
      }
      if (v) vote |= 1u << m;
    }
    // Per packet, as the skip walk's vote: a node row, some live ray hits
    // some child; a leaf row (any-hit), some active ray still lacks a hit.
    vote = surf::block_or(vote, s_vote, step);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      if (p[m] >= n_entries) continue;
      const bool any = (vote >> m) & 1u;
      int next = (leaf[m] || any) ? p[m] + 1 : skip[m];
      next = max(next, p[m] + 1);
      if (kAny && leaf[m] && !any) next = n_entries;
      ++visits[m];
      leaf_visits[m] += leaf[m];
      p[m] = next;
    }
  }
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int i = first + j * kThreads + threadIdx.x;
    if (pk0 + j / kPer < packets) {
      t_out[i] = bt[j];
      r_out[i] = br[j];
      u_out[i] = bu[j];
      v_out[i] = bv[j];
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      if (pk0 + m < packets) {
        store_visits(visits_out, pk0 + m, visits[m], leaf_visits[m], visits[m]);
      }
    }
  }
}

// specN (pallas_wide.py:339-511) and specbN (kBlock, :514-666): a window of
// `width` rows a step, tested in stream order against the running state;
// one block_or gives every thread the window's descend mask, and every
// thread resolves the same cursor.  spec tests rows min(base + w, n - 1)
// with base = min(p, n - 1); specb the rows [base, base + width) with base
// = clip(p, 0, n - width).  The cursor starts at base (spec) or p (specb);
// row base + w steers while the cursor equals it and lies in the stream,
// to base + w + 1 on a leaf row or a descend, else to its skip link; then
// max(cursor, p + 1).  Windows run in groups of kSpecVisits (kSpecbVisits)
// and the stop tests come between groups, as JAX's while condition: a
// group goes on after the cursor has left the stream, re-testing the
// clamped window (those rows steer nothing).  Visits count the rows that
// steered.
template <int kRays, bool kAny, bool kBlock>
__global__ void __launch_bounds__(kThreads)
stream_walk_spec_kernel(const float* __restrict__ stream, int n_entries,
                        const float* __restrict__ rays, const int* __restrict__ act,
                        int n_rays, int block_rays, int width,
                        float* __restrict__ t_out, int* __restrict__ r_out,
                        float* __restrict__ u_out, float* __restrict__ v_out,
                        int* __restrict__ visits_out) {
  __shared__ unsigned s_vote[3];
  const int first = blockIdx.x * block_rays;
  Packet<kRays> P;
  const bool mine = P.load(rays, act, n_rays, first);
  if (threadIdx.x == 0) {
    s_vote[0] = 0u;
    s_vote[1] = 0u;
    s_vote[2] = 0u;
  }
  int p = __syncthreads_or(mine) ? 0 : n_entries;
  int visits = 0, leaf_visits = 0, windows = 0;
  constexpr int kGroup = kBlock ? kSpecbVisits : kSpecVisits;
  while (p < n_entries && (!kAny || __syncthreads_or(P.unfinished()))) {
    for (int g = 0; g < kGroup; ++g) {
      const int base = kBlock ? max(min(p, n_entries - width), 0) : min(p, n_entries - 1);
      unsigned desc = 0u;
#pragma unroll 1
      for (int w = 0; w < width; ++w) {
        const int r = kBlock ? base + w : min(base + w, n_entries - 1);
        const float4* row = row_at(stream, r);
        if (__float_as_int(__ldg(row + 2).y) == 1) {
          P.template leaf_row<kAny>(row, r * kWidth);
        } else if (P.template child_hits<kAny>(row) != 0u) {
          desc |= 1u << w;
        }
      }
      desc = surf::block_or(desc, s_vote, windows);
      ++windows;
      if (p >= n_entries) continue;
      int nxt = kBlock ? p : base;
      for (int w = 0; w < width; ++w) {
        const int r = base + w;
        if (nxt != r || r >= n_entries) continue;
        const float4 meta = __ldg(row_at(stream, r) + 2);
        const bool is_leaf = __float_as_int(meta.y) == 1;
        nxt = (is_leaf || ((desc >> w) & 1u)) ? r + 1 : __float_as_int(meta.z);
        ++visits;
        leaf_visits += is_leaf;
      }
      p = max(nxt, p + 1);
    }
  }
  P.store(t_out, r_out, u_out, v_out, first);
  if (threadIdx.x == 0) store_visits(visits_out, blockIdx.x, visits, leaf_visits, windows);
}

struct Args {
  const float* stream;
  int n_entries;
  const float* rays;
  const int* act;
  int n_rays, block_rays, arg;
  float* t;
  int* r;
  float* u;
  float* v;
  int* visits;
  cudaStream_t cs;
};

template <int kM, int kPer, bool kAny>
int launch_ilv(const Args& a) {
  const int packets = a.n_rays / a.block_rays;
  const int smem = 6 * static_cast<int>(sizeof(float)) * kM * a.block_rays;
  auto* kernel = stream_walk_ilv_kernel<kM, kPer, kAny>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(packets + kM - 1) / kM, kThreads, smem, a.cs>>>(
      a.stream, a.n_entries, a.rays, a.act, a.n_rays, a.block_rays, a.t, a.r, a.u, a.v,
      a.visits);
  return static_cast<int>(cudaGetLastError());
}

template <int kPer, bool kAny>
int dispatch_ilv(const Args& a) {
  switch (a.arg) {
    case 1: return launch_ilv<1, kPer, kAny>(a);
    case 2: return launch_ilv<2, kPer, kAny>(a);
    case 3: return launch_ilv<3, kPer, kAny>(a);
    case 4: return launch_ilv<4, kPer, kAny>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kWalk, int kPer, bool kAny>
int launch(const Args& a) {
  const int packets = a.n_rays / a.block_rays;
  if constexpr (kWalk == kIlv) {
    return dispatch_ilv<kPer, kAny>(a);
  } else if constexpr (kWalk == kStack) {
    stream_walk_stack_kernel<kPer, kAny><<<packets, kThreads, 0, a.cs>>>(
        a.stream, a.n_entries, a.rays, a.act, a.n_rays, a.block_rays, a.arg, a.t, a.r,
        a.u, a.v, a.visits);
  } else if constexpr (kWalk == kSkip) {
    stream_walk_skip_kernel<kPer, kAny><<<packets, kThreads, 0, a.cs>>>(
        a.stream, a.n_entries, a.rays, a.act, a.n_rays, a.block_rays, a.t, a.r, a.u,
        a.v, a.visits);
  } else {
    stream_walk_spec_kernel<kPer, kAny, kWalk == kSpecb><<<packets, kThreads, 0, a.cs>>>(
        a.stream, a.n_entries, a.rays, a.act, a.n_rays, a.block_rays, a.arg, a.t, a.r,
        a.u, a.v, a.visits);
  }
  (void)packets;
  return static_cast<int>(cudaGetLastError());
}

template <int kWalk, bool kAny>
int dispatch(const Args& a) {
  const bool ok = kWalk == kSkip ||
                  (kWalk == kStack && a.arg >= 1 && a.arg <= kMaxStack) ||
                  (kWalk == kIlv && a.arg >= 1 && a.arg <= kMaxIlv &&
                   6 * static_cast<long>(sizeof(float)) * a.arg * a.block_rays <= kMaxSmem) ||
                  (kWalk == kSpec && a.arg >= 1 && a.arg <= kMaxSpec) ||
                  (kWalk == kSpecb && a.arg >= 1 && a.arg <= kMaxSpec &&
                   a.arg <= a.n_entries);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  switch (a.block_rays / kThreads) {
    case 1: return launch<kWalk, 1, kAny>(a);
    case 2: return launch<kWalk, 2, kAny>(a);
    case 4: return launch<kWalk, 4, kAny>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes.  stream is [n_entries, 128]; rays is
// [7, n_rays] (ox, oy, oz, dx, dy, dz, t_max); act is [n_rays]; n_rays is a
// positive multiple of block_rays, which is 1, 2 or 4 times kThreads.
// visits is [n_rays / block_rays, 3]: rows on the path, leaf rows among
// them, windows walked (one row each but for spec / specb).  arg is the
// stack walk's stack depth (1..64), ilv's packets per block (1..4), or
// spec's / specb's rows per window (1..8; specb: at most n_entries); the
// skip walk ignores it.  Returns cudaGetLastError() after the launch.
extern "C" int stream_walk_threads_per_block() { return kThreads; }

#define SURF_STREAM_ENTRY(NAME, WALK, ANY)                                           \
  extern "C" int NAME(const float* stream, int n_entries, const float* rays,         \
                      const int* act, int n_rays, int block_rays, int arg, float* t, \
                      int* r, float* u, float* v, int* visits, cudaStream_t cs) {    \
    return dispatch<WALK, ANY>(Args{stream, n_entries, rays, act, n_rays,            \
                                    block_rays, arg, t, r, u, v, visits, cs});       \
  }

SURF_STREAM_ENTRY(stream_walk_skip_closest, kSkip, false)
SURF_STREAM_ENTRY(stream_walk_skip_any, kSkip, true)
// The stack walk's first design (stream_walk_stack.cu serves the algo).
SURF_STREAM_ENTRY(stream_walk_stack_closest_pr3, kStack, false)
SURF_STREAM_ENTRY(stream_walk_stack_any_pr3, kStack, true)
// skip2 / ilvN's first design (stream_walk_ilv.cu serves the algos).
SURF_STREAM_ENTRY(stream_walk_ilv_closest_pr5, kIlv, false)
SURF_STREAM_ENTRY(stream_walk_ilv_any_pr5, kIlv, true)
// specN / specbN's first design (stream_walk_spec.cu serves the algos).
SURF_STREAM_ENTRY(stream_walk_spec_closest_pr5, kSpec, false)
SURF_STREAM_ENTRY(stream_walk_spec_any_pr5, kSpec, true)
SURF_STREAM_ENTRY(stream_walk_specb_closest_pr5, kSpecb, false)
SURF_STREAM_ENTRY(stream_walk_specb_any_pr5, kSpecb, true)

// The kernel of the first skip, stack, ilv and spec designs at 2048-ray
// packets (skip2: two packets a block), for the SASS checks (entry.cuh).
SURF_KERNEL_OF(stream_walk_skip_closest, stream_walk_skip_kernel<4, false>)
SURF_KERNEL_OF(stream_walk_skip_any, stream_walk_skip_kernel<4, true>)
SURF_KERNEL_OF(stream_walk_stack_closest_pr3, stream_walk_stack_kernel<4, false>)
SURF_KERNEL_OF(stream_walk_stack_any_pr3, stream_walk_stack_kernel<4, true>)
SURF_KERNEL_OF(stream_walk_ilv_closest_pr5, stream_walk_ilv_kernel<2, 4, false>)
SURF_KERNEL_OF(stream_walk_ilv_any_pr5, stream_walk_ilv_kernel<2, 4, true>)
SURF_KERNEL_OF(stream_walk_spec_closest_pr5, stream_walk_spec_kernel<4, false, false>)
SURF_KERNEL_OF(stream_walk_spec_any_pr5, stream_walk_spec_kernel<4, true, false>)
SURF_KERNEL_OF(stream_walk_specb_closest_pr5, stream_walk_spec_kernel<4, false, true>)
SURF_KERNEL_OF(stream_walk_specb_any_pr5, stream_walk_spec_kernel<4, true, true>)

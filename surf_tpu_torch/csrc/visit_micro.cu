// The walk-visit microbenchmarks (micro/visit_cost.py, micro/quant_visit.py,
// micro/stack_visit.py, micro/mask_reduce.py): one visit of the 8-wide
// stream walk taken apart.
//
// visit_cost_* replaces scripts/tpu_cost_micro.py's kernel (`make`, its
// pl.pallas_call at :227): one packet of 1024 rays runs a fixed trip of
// rows_total / bw visits over a table; visit p reads row p % n_rows (bf4/
// bf8: rows min(p % n_rows, n_rows - bw) ..+bw), adds the row's int32
// lane 9 to acc, then (eval_row) the sum of its first 48 / 120 lanes to
// acc, the slab test of its 8 child boxes (lanes 16k+0..5) against the
// running best_t, and the Möller–Trumbore test of its 8 records (lanes
// 16j+0..8).  t_out = best_t + acc, r_out the record row * 8 + j.
// Variants (CostVariant): kShell, kExt48, kExt120, kSlab, kSlabFma (the box
// planes as lo * inv - o * inv), kMt, kFull (slab + MT), kFullRed (kFull
// with the packet's vote "some ray hits some box" in the cursor's chain),
// kBf4 / kBf8 (4 / 8 rows a visit).  In the TPU script the slab test
// feeds no output (eval_row's anyh is dropped) and kFullRed's vote picks
// between two equal cursors, so a compiler removes both: here every slab
// variant also counts per ray the rows whose some child box it hits
// (box_out), and kFullRed the visits whose vote was set (state_out[1]),
// neither of which changes t_out or r_out.  acc is returned too (acc_out):
// where no record hits, t_out = 1e30 + acc rounds to 1e30 and would show
// nothing of the lanes' sums.  The TPU's scalar extracts of
// a row's lanes are broadcast loads here: every thread reads the same
// address through the read-only path (L1).  kBf4 / kBf8's one (bw, 128)
// block fetch is one cooperative 16-byte-a-thread load of the bw rows into
// shared memory (double-buffered, one barrier a visit), then broadcast
// reads of it.
//
// quant_visit_* replaces scripts/tpu_quant_micro.py's kernel (`make`, its
// call at :203): the packet visits rows in blocks of 32 visits while its
// cursor p < iters.  A visit reads row (p < iters ? p : 0) % n_rows, runs
// the 8-child slab test in f32 (lanes 16k+0..5) or from u8-quantized
// children (kQ8: the parent's lo and scale in lanes 0-5, 12 int32 lanes
// 12..23 of packed bytes, dequantized as t = a + q * b), optionally the
// row's 8 Möller–Trumbore records, takes the vote and sets p to p + 1
// when the row's lane 9 is 1 or the vote is set, else max(lane 10, p + 1).
// The TPU's shift-and-mask unpack of a byte is one PRMT (__byte_perm)
// here, and its int-to-float convert an I2F.
//
// stack_visit_* replaces scripts/tpu_stack_micro.py's kernel (`make`, its
// call at :81, scratch (256, 128) int32): visits in blocks of 16; each
// runs a toy 8-child slab that accumulates into acc, takes the vote
// hot = some ray's r > x, pushes kPush values i * 8 + q at min(sp + q,
// 255), sets sp = min(sp + (hot ? kPush : 1), 200), pops the entry at
// max(sp - 1, 0) and moves the cursor to (top + i) mod 4096 + 1 (floor
// modulo: an entry never written holds INT_MIN, as Pallas's interpret
// mode fills scratch), then sp = max(sp - 1, 1).  The TPU's VMEM row
// stack is a 256-entry int32 stack in shared memory (lane 0 of a row is
// all the script reads).  It is kept once per warp (16 copies, 16 KB):
// the warp's lane 0 pushes, the block barrier that the vote needs anyway
// orders the pushes before the pop, and a __syncwarp before the next
// visit's pushes orders the warp's pops before them.  One copy for the
// block would need a second block barrier a visit, since a push usually
// lands on the slot just popped.
//
// mask_reduce_* replaces scripts/tpu_reduce_micro.py's kernel (`make`, its
// call at :80): visits in blocks of 16; the hit of child k is a * row[k] >
// x, and the packet's 8-bit mask is built by (MaskMode) kEightAny: 8 block
// votes (__syncthreads_or), kOrReduce: a per-thread word, a warp
// __reduce_or_sync and an OR across warps in shared memory, kMaxByte: the
// same with __reduce_max_sync and a max (the TPU's one reduce of a packed
// word); then a += 0.001 * x * mask and the cursor moves by 1 if mask > 4,
// else by 2.
//
// What bounds them: latency, by design.  A visit's work (1024 rays x at
// most 16 tests) is far below the card's rate and the 256 KB table stays
// in L1 and L2; each visit ends at a barrier (the vote) or, in the
// fixed-trip variants without one, at the next row's broadcast load.
// Design: dep_micro.cu's: one 512-thread block, 2 rays a thread, every
// thread following the same cursor.  Every kernel returns the cursor it
// ends at.  Semantics as the TPU kernels: NaN-propagating min/max (the
// table of quant_visit holds NaN bit patterns), denormals kept (no -ftz),
// and --fmad=false so that every multiply and add rounds as the plain
// PyTorch versions' separate ops do.

#include <climits>

#include <cuda_runtime.h>

#include "mt.cuh"
#include "vote.cuh"

namespace {

constexpr int kLane = 128;     // floats per table row
constexpr int kRec = 16;       // floats per record
constexpr int kThreads = 512;  // one block: the packet
constexpr int kRays = 2;       // rays per thread: 1024 in all
constexpr int kN = kThreads * kRays;
constexpr int kWarps = kThreads / 32;
constexpr int kLeafLane = 9, kSkipLane = 10;
constexpr float kFar = 1e30f;

template <bool kSmem>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (kSmem) {
    return *p;
  } else {
    return __ldg(p);
  }
}

template <bool kSmem>
__device__ __forceinline__ int ld_int(const float* p) {
  return __float_as_int(ld<kSmem>(p));
}

// The packet's rays, kRays a thread: ray r of thread x is ray r * kThreads + x.
struct Rays {
  float ox[kRays], oy[kRays], oz[kRays];
  float dx[kRays], dy[kRays], dz[kRays];
  float ix[kRays], iy[kRays], iz[kRays];
  float bt[kRays];
  int br[kRays];

  __device__ __forceinline__ void load(const float* __restrict__ rays) {
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const int i = r * kThreads + threadIdx.x;
      ox[r] = rays[i];
      oy[r] = rays[kN + i];
      oz[r] = rays[2 * kN + i];
      dx[r] = rays[3 * kN + i];
      dy[r] = rays[4 * kN + i];
      dz[r] = rays[5 * kN + i];
      ix[r] = 1.0f / dx[r];
      iy[r] = 1.0f / dy[r];
      iz[r] = 1.0f / dz[r];
      bt[r] = kFar;
      br[r] = -1;
    }
  }

  // The row's 8 Möller–Trumbore records in order, each replacing the best
  // on a strictly smaller t; record id row * 8 + j.
  template <bool kSmem>
  __device__ __forceinline__ void records(const float* row, int pc) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* c = row + kRec * j;
      const float v0x = ld<kSmem>(c), v0y = ld<kSmem>(c + 1), v0z = ld<kSmem>(c + 2);
      const float e1x = ld<kSmem>(c + 3), e1y = ld<kSmem>(c + 4), e1z = ld<kSmem>(c + 5);
      const float e2x = ld<kSmem>(c + 6), e2y = ld<kSmem>(c + 7), e2z = ld<kSmem>(c + 8);
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        float t, u, v;
        if (surf::mt_hit(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, ox[r], oy[r], oz[r],
                         dx[r], dy[r], dz[r], bt[r], t, u, v)) {
          bt[r] = t;
          br[r] = pc * 8 + j;
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ t_out, int* __restrict__ r_out,
                                        const float* acc) const {
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const int i = r * kThreads + threadIdx.x;
      t_out[i] = acc == nullptr ? bt[r] : bt[r] + acc[r];
      r_out[i] = br[r];
    }
  }
};

// The slab test's reduction of one box from its six planes' t (the TPU
// scripts' order: x, then y, then z), NaN-propagating.
__device__ __forceinline__ bool slab_planes(float txn, float txf, float tyn, float tyf,
                                            float tzn, float tzf, float best_t) {
  float tmin = surf::nan_min(txn, txf);
  float tmax = surf::nan_max(txn, txf);
  tmin = surf::nan_max(tmin, surf::nan_min(tyn, tyf));
  tmax = surf::nan_min(tmax, surf::nan_max(tyn, tyf));
  tmin = surf::nan_max(tmin, surf::nan_min(tzn, tzf));
  tmax = surf::nan_min(tmax, surf::nan_max(tzn, tzf));
  return (tmax >= tmin) & (tmin < best_t) & (tmax > 0.0f);
}

// ---------------------------------------------------------------------------
// visit_cost (tpu_cost_micro.py)
// ---------------------------------------------------------------------------

enum CostVariant { kShell, kExt48, kExt120, kSlab, kSlabFma, kMt, kFull, kFullRed, kBf4, kBf8 };

template <int V>
struct Cost {
  static constexpr int kExt = V == kExt48 ? 48 : (V == kExt120 ? 120 : 0);
  static constexpr bool kSlabOn = V == kSlab || V == kSlabFma || V == kFull || V == kFullRed ||
                                  V == kBf4 || V == kBf8;
  static constexpr bool kMtOn = V == kMt || V == kFull || V == kFullRed || V == kBf4 ||
                                V == kBf8;
  static constexpr int kBw = V == kBf4 ? 4 : (V == kBf8 ? 8 : 1);
};

// tpu_cost_micro.py eval_row (:78-153) on one row: acc += the sum of its
// first kExt lanes, the slab test of its 8 boxes (counted into boxes per
// ray), then its records.  Returns whether some ray of the thread hits
// some box.
template <int V, bool kSmem>
__device__ __forceinline__ bool eval_row(Rays& R, const float* row, int pc, float* acc,
                                         int* boxes, const float* oix, const float* oiy,
                                         const float* oiz) {
  using C = Cost<V>;
  bool any = false;
  if constexpr (C::kExt > 0) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < C::kExt; ++i) s = s + ld<kSmem>(row + i);
#pragma unroll
    for (int r = 0; r < kRays; ++r) acc[r] = acc[r] + s;
  }
  if constexpr (C::kSlabOn) {
    bool anyh[kRays];
#pragma unroll
    for (int r = 0; r < kRays; ++r) anyh[r] = false;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float* b = row + kRec * k;
      const float lx = ld<kSmem>(b), ly = ld<kSmem>(b + 1), lz = ld<kSmem>(b + 2);
      const float hx = ld<kSmem>(b + 3), hy = ld<kSmem>(b + 4), hz = ld<kSmem>(b + 5);
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        if constexpr (V == kSlabFma) {
          anyh[r] |= slab_planes(lx * R.ix[r] - oix[r], hx * R.ix[r] - oix[r],
                                 ly * R.iy[r] - oiy[r], hy * R.iy[r] - oiy[r],
                                 lz * R.iz[r] - oiz[r], hz * R.iz[r] - oiz[r], R.bt[r]);
        } else {
          anyh[r] |= surf::slab_hit(R.ox[r], R.oy[r], R.oz[r], R.ix[r], R.iy[r], R.iz[r],
                                    R.bt[r], lx, ly, lz, hx, hy, hz);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      boxes[r] += anyh[r];
      any |= anyh[r];
    }
  }
  if constexpr (C::kMtOn) R.records<kSmem>(row, pc);
  return any;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
visit_cost_kernel(const float* __restrict__ table, int n_rows, const float* __restrict__ rays,
                  int rows_total, float* __restrict__ t_out, int* __restrict__ r_out,
                  float* __restrict__ acc_out, int* __restrict__ box_out,
                  int* __restrict__ state_out) {
  using C = Cost<V>;
  __shared__ __align__(16) float s_rows[2][C::kBw * kLane];
  Rays R;
  R.load(rays);
  float acc[kRays], oix[kRays], oiy[kRays], oiz[kRays];
  int boxes[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    acc[r] = 0.0f;
    boxes[r] = 0;
    oix[r] = R.ox[r] * R.ix[r];
    oiy[r] = R.oy[r] * R.iy[r];
    oiz[r] = R.oz[r] * R.iz[r];
  }
  int p = 0, votes = 0;
  const int n_vis = rows_total / C::kBw;
#pragma unroll 1
  for (int vis = 0; vis < n_vis; ++vis) {
    if constexpr (C::kBw == 1) {
      const int pc = p % n_rows;
      const float* row = table + static_cast<size_t>(pc) * kLane;
      const float leaf = static_cast<float>(ld_int<false>(row + kLeafLane));
#pragma unroll
      for (int r = 0; r < kRays; ++r) acc[r] = acc[r] + leaf;
      const bool any = eval_row<V, false>(R, row, pc, acc, boxes, oix, oiy, oiz);
      if constexpr (V == kFullRed) {
        // the script's select (:174-176) between p + 1 and
        // min(skip * 0 + p + 1, p + 1), equal: the vote is counted instead
        votes += __syncthreads_or(any) ? 1 : 0;
      }
      p += 1;
    } else {
      const int pc = min(p % n_rows, n_rows - C::kBw);
      float* buf = s_rows[vis & 1];
      const float4* src = reinterpret_cast<const float4*>(table + static_cast<size_t>(pc) * kLane);
      for (int i = threadIdx.x; i < C::kBw * kLane / 4; i += kThreads) {
        reinterpret_cast<float4*>(buf)[i] = __ldg(src + i);
      }
      __syncthreads();
#pragma unroll 1
      for (int rr = 0; rr < C::kBw; ++rr) {
        const float* row = buf + rr * kLane;
        const float leaf = static_cast<float>(ld_int<true>(row + kLeafLane));
#pragma unroll
        for (int r = 0; r < kRays; ++r) acc[r] = acc[r] + leaf;
        eval_row<V, true>(R, row, pc + rr, acc, boxes, oix, oiy, oiz);
      }
      p += C::kBw;
    }
  }
  R.store(t_out, r_out, acc);
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    acc_out[r * kThreads + threadIdx.x] = acc[r];
    box_out[r * kThreads + threadIdx.x] = boxes[r];
  }
  if (threadIdx.x == 0) {
    state_out[0] = p;
    state_out[1] = votes;
  }
}

// ---------------------------------------------------------------------------
// quant_visit (tpu_quant_micro.py)
// ---------------------------------------------------------------------------

enum QuantVariant { kNodeF32, kNodeQ8, kFullF32, kFullQ8 };

template <int V>
__global__ void __launch_bounds__(kThreads)
quant_visit_kernel(const float* __restrict__ table, int n_rows, const float* __restrict__ rays,
                   int iters, float* __restrict__ t_out, int* __restrict__ r_out,
                   int* __restrict__ end_out) {
  constexpr bool kQ8 = V == kNodeQ8 || V == kFullQ8;
  constexpr bool kLeaf = V == kFullF32 || V == kFullQ8;
  Rays R;
  R.load(rays);
  int p = 0;
  while (p < iters) {
#pragma unroll 1
    for (int k = 0; k < 32; ++k) {
      const int pc = (p < iters ? p : 0) % n_rows;
      const float* row = table + static_cast<size_t>(pc) * kLane;
      const bool is_leaf = ld_int<false>(row + kLeafLane) == 1;
      const int skip = ld_int<false>(row + kSkipLane);
      bool anyh = false;
      if constexpr (kQ8) {
        // slab_q8 (:65-96): t = a + q * b per plane, a = (parent lo - o) *
        // inv and b = scale * inv per axis, q byte c of int32 lane
        // 12 + 2 * m + h for child 4h + c and plane m (lo x, y, z, hi x, y, z)
        const float plx = __ldg(row), ply = __ldg(row + 1), plz = __ldg(row + 2);
        const float psx = __ldg(row + 3), psy = __ldg(row + 4), psz = __ldg(row + 5);
        unsigned w[12];
#pragma unroll
        for (int j = 0; j < 12; ++j) w[j] = static_cast<unsigned>(ld_int<false>(row + 12 + j));
        float ax[kRays], ay[kRays], az[kRays], bx[kRays], by[kRays], bz[kRays];
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          ax[r] = (plx - R.ox[r]) * R.ix[r];
          ay[r] = (ply - R.oy[r]) * R.iy[r];
          az[r] = (plz - R.oz[r]) * R.iz[r];
          bx[r] = psx * R.ix[r];
          by[r] = psy * R.iy[r];
          bz[r] = psz * R.iz[r];
        }
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) {
          const int h = c8 >> 2;
          const unsigned sel = 0x4440u | static_cast<unsigned>(c8 & 3);  // byte c8 % 4, zero-filled
          float q[6];
#pragma unroll
          for (int m = 0; m < 6; ++m) {
            q[m] = static_cast<float>(__byte_perm(w[2 * m + h], 0u, sel));
          }
#pragma unroll
          for (int r = 0; r < kRays; ++r) {
            anyh |= slab_planes(ax[r] + q[0] * bx[r], ax[r] + q[3] * bx[r],
                                ay[r] + q[1] * by[r], ay[r] + q[4] * by[r],
                                az[r] + q[2] * bz[r], az[r] + q[5] * bz[r], R.bt[r]);
          }
        }
      } else {
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) {
          const float* b = row + kRec * c8;
          const float lx = __ldg(b), ly = __ldg(b + 1), lz = __ldg(b + 2);
          const float hx = __ldg(b + 3), hy = __ldg(b + 4), hz = __ldg(b + 5);
#pragma unroll
          for (int r = 0; r < kRays; ++r) {
            anyh |= surf::slab_hit(R.ox[r], R.oy[r], R.oz[r], R.ix[r], R.iy[r], R.iz[r],
                                   R.bt[r], lx, ly, lz, hx, hy, hz);
          }
        }
      }
      if constexpr (kLeaf) R.records<false>(row, pc);
      const bool vote = __syncthreads_or(anyh);
      p = (is_leaf || vote) ? p + 1 : max(skip, p + 1);
    }
  }
  R.store(t_out, r_out, nullptr);
  if (threadIdx.x == 0) *end_out = p;
}

// ---------------------------------------------------------------------------
// stack_visit (tpu_stack_micro.py)
// ---------------------------------------------------------------------------

constexpr int kStack = 256;  // the scratch's rows
constexpr int kSpMax = 200;

template <int kPush>
__global__ void __launch_bounds__(kThreads)
stack_visit_kernel(const float* __restrict__ table, int n_rows, const float* __restrict__ x_in,
                   int iters, float* __restrict__ o_out, int* __restrict__ state_out) {
  __shared__ int s_stack[kWarps][kStack];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float x[kRays], acc[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    x[r] = x_in[r * kThreads + threadIdx.x];
    acc[r] = x[r] * 0.0f;
  }
  for (int i = lane; i < kStack; i += 32) s_stack[warp][i] = i == 0 ? 0 : INT_MIN;
  __syncwarp();
  int it = 0, cur = 3, sp = 1;
  while (it < iters) {
#pragma unroll 1
    for (int k = 0; k < 16; ++k) {
      const float* row = table + static_cast<size_t>(cur % n_rows) * kLane;
      // _slab8_extract (:23-36): r = acc + sum_k (box k's planes cross ? x : acc)
      float res[kRays];
      bool hot = false;
#pragma unroll
      for (int r = 0; r < kRays; ++r) res[r] = acc[r];
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const float* b = row + kRec * c8;
        const float l0 = __ldg(b), l1 = __ldg(b + 1), l2 = __ldg(b + 2);
        const float h0 = __ldg(b + 3), h1 = __ldg(b + 4), h2 = __ldg(b + 5);
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          res[r] = res[r] + (surf::toy_cross(l0, l1, l2, h0, h1, h2, x[r]) ? x[r] : acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        hot |= res[r] > x[r];
        acc[r] = res[r];
      }
      if constexpr (kPush > 0) {
        __syncwarp();  // the warp's pops of the last visit are done
        if (lane == 0) {
#pragma unroll
          for (int q = 0; q < kPush; ++q) s_stack[warp][min(sp + q, kStack - 1)] = cur * 8 + q;
        }
      }
      const bool vote = __syncthreads_or(hot);  // also orders the pushes before the pop
      sp = min(sp + (vote ? kPush : 1), kSpMax);
      const int top = s_stack[warp][max(sp - 1, 0)];
      cur = surf::floor_mod(top + cur, n_rows * 8) + 1;
      sp = max(sp - 1, 1);
    }
    it += 16;
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) o_out[r * kThreads + threadIdx.x] = acc[r];
  if (threadIdx.x == 0) {
    state_out[0] = cur;
    state_out[1] = sp;
  }
}

// ---------------------------------------------------------------------------
// mask_reduce (tpu_reduce_micro.py)
// ---------------------------------------------------------------------------

enum MaskMode { kEightAny, kOrReduce, kMaxByte };

template <int M>
__global__ void __launch_bounds__(kThreads)
mask_reduce_kernel(const float* __restrict__ table, int n_rows, const float* __restrict__ x_in,
                   int iters, float* __restrict__ o_out, int* __restrict__ end_out) {
  __shared__ unsigned s_slots[3];
  float x[kRays], a[kRays], ax[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    x[r] = x_in[r * kThreads + threadIdx.x];
    a[r] = x[r] * 0.001f;
    ax[r] = 0.001f * x[r];
  }
  if (threadIdx.x < 3) s_slots[threadIdx.x] = 0u;
  __syncthreads();
  int it = 0, cur = 3, step = 0;
  while (it < iters) {
#pragma unroll 1
    for (int k = 0; k < 16; ++k) {
      const float* row = table + static_cast<size_t>(cur % n_rows) * kLane;
      float f[8];
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) f[c8] = __ldg(row + c8);
      unsigned mask = 0u;
      if constexpr (M == kEightAny) {
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) {
          bool h = false;
#pragma unroll
          for (int r = 0; r < kRays; ++r) h |= a[r] * f[c8] > x[r];
          if (__syncthreads_or(h)) mask += 1u << c8;
        }
      } else {
        unsigned word = 0u;
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          unsigned wr = 0u;
#pragma unroll
          for (int c8 = 0; c8 < 8; ++c8) wr |= a[r] * f[c8] > x[r] ? 1u << c8 : 0u;
          word = M == kOrReduce ? (word | wr) : max(word, wr);
        }
        mask = M == kOrReduce ? surf::block_or(word, s_slots, step)
                              : surf::block_max(word, s_slots, step);
        ++step;
      }
      const float m = static_cast<float>(mask);
#pragma unroll
      for (int r = 0; r < kRays; ++r) a[r] = a[r] + ax[r] * m;
      cur = mask > 4u ? cur + 1 : cur + 2;
    }
    it += 16;
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) o_out[r * kThreads + threadIdx.x] = a[r];
  if (threadIdx.x == 0) *end_out = cur;
}

}  // namespace

// Plain C entry points for ctypes; each returns cudaGetLastError() after its
// launch.  table is [n_rows, 128] f32 (16-byte aligned; int32 lanes 9/10:
// leaf flag, skip); rays [6, 1024] (ox, oy, oz, dx, dy, dz); x [1024].
//   visit_cost_<variant>: rows_total > 0 (a multiple of bw is walked, n_rows
//     >= bw); t, r, acc, boxes [1024]; state [2] = the end cursor, the
//     visits whose vote was set.
//   quant_visit_<variant>: iters > 0; t, r [1024]; end [1].
//   stack_visit_push<n>: iters > 0; o [1024]; state [2] = the end cursor,
//     the stack pointer.
//   mask_reduce_<mode>: iters > 0; o [1024]; end [1].
#define SURF_COST_ENTRY(NAME, V)                                                             \
  extern "C" int NAME(const float* table, int n_rows, const float* rays, int rows_total,     \
                      float* t, int* r, float* acc, int* boxes, int* state,                  \
                      cudaStream_t cs) {                                                     \
    visit_cost_kernel<V><<<1, kThreads, 0, cs>>>(table, n_rows, rays, rows_total, t, r, acc, \
                                                 boxes, state);                             \
    return static_cast<int>(cudaGetLastError());                                             \
  }

SURF_COST_ENTRY(visit_cost_shell, kShell)
SURF_COST_ENTRY(visit_cost_ext48, kExt48)
SURF_COST_ENTRY(visit_cost_ext120, kExt120)
SURF_COST_ENTRY(visit_cost_slab, kSlab)
SURF_COST_ENTRY(visit_cost_slabfma, kSlabFma)
SURF_COST_ENTRY(visit_cost_mt, kMt)
SURF_COST_ENTRY(visit_cost_full, kFull)
SURF_COST_ENTRY(visit_cost_fullred, kFullRed)
SURF_COST_ENTRY(visit_cost_bf4, kBf4)
SURF_COST_ENTRY(visit_cost_bf8, kBf8)

#define SURF_QUANT_ENTRY(NAME, V)                                                             \
  extern "C" int NAME(const float* table, int n_rows, const float* rays, int iters, float* t, \
                      int* r, int* end, cudaStream_t cs) {                                   \
    quant_visit_kernel<V><<<1, kThreads, 0, cs>>>(table, n_rows, rays, iters, t, r, end);    \
    return static_cast<int>(cudaGetLastError());                                             \
  }

SURF_QUANT_ENTRY(quant_visit_node_f32, kNodeF32)
SURF_QUANT_ENTRY(quant_visit_node_q8, kNodeQ8)
SURF_QUANT_ENTRY(quant_visit_full_f32, kFullF32)
SURF_QUANT_ENTRY(quant_visit_full_q8, kFullQ8)

#define SURF_STACK_ENTRY(NAME, N)                                                            \
  extern "C" int NAME(const float* table, int n_rows, const float* x, int iters, float* o,   \
                      int* state, cudaStream_t cs) {                                         \
    stack_visit_kernel<N><<<1, kThreads, 0, cs>>>(table, n_rows, x, iters, o, state);        \
    return static_cast<int>(cudaGetLastError());                                             \
  }

SURF_STACK_ENTRY(stack_visit_push0, 0)
SURF_STACK_ENTRY(stack_visit_push1, 1)
SURF_STACK_ENTRY(stack_visit_push2, 2)
SURF_STACK_ENTRY(stack_visit_push4, 4)

#define SURF_MASK_ENTRY(NAME, M)                                                             \
  extern "C" int NAME(const float* table, int n_rows, const float* x, int iters, float* o,   \
                      int* end, cudaStream_t cs) {                                           \
    mask_reduce_kernel<M><<<1, kThreads, 0, cs>>>(table, n_rows, x, iters, o, end);          \
    return static_cast<int>(cudaGetLastError());                                             \
  }

SURF_MASK_ENTRY(mask_reduce_eight_any, kEightAny)
SURF_MASK_ENTRY(mask_reduce_or_reduce, kOrReduce)
SURF_MASK_ENTRY(mask_reduce_max_byte, kMaxByte)

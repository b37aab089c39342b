// The block vote of the packet walks: the OR of every thread's bit mask
// over the block, behind one barrier.  Each warp ORs its threads' masks
// with __reduce_or_sync, then one lane per warp ORs the warp's into a
// shared-memory slot with atomicOr.  Step k uses slot k % 3 and thread 0
// zeroes slot (k + 1) % 3, last read at step k - 2, before the barrier of
// step k - 1 that thread 0 has passed; so one barrier a step orders both
// the ORs and the reset.  All three slots must be zero before step 0, and
// every thread of the block must call it at every step.  block_max is the
// same with max in place of OR (the microbenchmark of mask reductions,
// visit_micro.cu), and may share its slots with block_or's steps.

#pragma once

#include <cuda_runtime.h>

namespace surf {

__device__ __forceinline__ unsigned block_or(unsigned bits, unsigned* slots, int step) {
  if (threadIdx.x == 0) slots[(step + 1) % 3] = 0u;
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0 && bits != 0u) atomicOr(&slots[step % 3], bits);
  __syncthreads();
  return slots[step % 3];
}

__device__ __forceinline__ unsigned block_max(unsigned bits, unsigned* slots, int step) {
  if (threadIdx.x == 0) slots[(step + 1) % 3] = 0u;
  bits = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0 && bits != 0u) atomicMax(&slots[step % 3], bits);
  __syncthreads();
  return slots[step % 3];
}

}  // namespace surf

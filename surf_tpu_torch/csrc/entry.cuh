// The kernel that an entry point launches, found by the entry's name.
// SURF_KERNEL_OF(NAME, kernel) defines NAME_kernel(), which returns the
// host-side handle of the kernel that entry point NAME launches, and
// surf_kernel_name (op_micro.cu) gives that kernel's device name, the one
// `cuobjdump -sass` prints (micro/_visit.py kernel_name).  So a check of a
// kernel's SASS names the entry point, and a reordered enum or template
// argument cannot make it read another kernel.

#pragma once

#include <cuda_runtime.h>

#define SURF_KERNEL_OF(NAME, ...) \
  extern "C" const void* NAME##_kernel() { return (const void*)(__VA_ARGS__); }

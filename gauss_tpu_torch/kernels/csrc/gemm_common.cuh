// What the GEMM-shaped kernels share: the operand modes, the cp.async
// copies of their shared-memory rings, the occupancy query of their
// launchers, and the error string every library exports.
//
// Operand modes (the TPU kernel's precision names):
//   GTT_MODE_F32    true f32 FMAs on CUDA cores ("highest");
//   GTT_MODE_BF16X3 each f32 element split into bf16 hi = rn(x) and
//                   lo = rn(x - hi); hi*lo, lo*hi and hi*hi summed in that
//                   order with f32 accumulation ("high" on f32);
//   GTT_MODE_BF16   one hi*hi pass ("default").
// sgemm_common.cuh carries GTT_MODE_F32, stripe_common.cuh all three.
#pragma once

#include <cuda_runtime.h>

enum { GTT_MODE_F32 = 0, GTT_MODE_BF16X3 = 1, GTT_MODE_BF16 = 2 };

// One cp.async of VEC floats; src_bytes < 4 * VEC zero-fills the rest.
template <int VEC>
__device__ __forceinline__ void gtt_cp_async(float* dst, const float* src,
                                             int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void gtt_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void gtt_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Lets kern take smem bytes of dynamic shared memory and stores in *cache
// how many of its blocks of `threads` an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). A cache >= 0 is kept:
// each launcher passes a static of its own, so the query runs once per
// process and kernel.
static int gtt_kernel_occupancy(const void* kern, int threads, int smem,
                                int* cache) {
  if (*cache >= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  *cache = n;
  return 0;
}

// The message of a CUDA error code (each library exports its own copy).
extern "C" const char* gtt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

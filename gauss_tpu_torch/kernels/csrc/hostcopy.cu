// Pinned host memory and strided host <-> device copies for the
// out-of-core stream (gauss_tpu_torch/outofcore/stream.py).
//
// Replaces no TPU kernel. The JAX package moves each trailing tile with
// jax.device_put(np.ascontiguousarray(m_host[gs:, c0:c1])): a host gather
// into a contiguous buffer, then a synchronous transfer. In PyTorch a copy
// from a strided CPU view to the card first gathers into a pageable
// temporary, which makes the copy synchronous and loses the pipeline. So
// the host matrix is allocated page-locked here (cudaHostAlloc, exactly
// the bytes asked for: PyTorch's pinned allocator rounds a request up to a
// power of two and keeps it cached), and a (rows, width) window of it
// moves with one cudaMemcpy2DAsync on the caller's copy stream: the DMA
// engine walks the row pitch itself, with no host gather and no staging.
//
// Every entry point returns the CUDA error code (0 on success);
// gtt_error_string names it.
#include <cuda_runtime.h>

// Allocate `bytes` of page-locked host memory into *out.
extern "C" int gtt_host_alloc(void** out, long long bytes) {
  *out = nullptr;
  return static_cast<int>(cudaHostAlloc(out, static_cast<size_t>(bytes),
                                        cudaHostAllocDefault));
}

extern "C" int gtt_host_free(void* ptr) {
  return static_cast<int>(cudaFreeHost(ptr));
}

// Copy `height` rows of `width` bytes from src (row pitch spitch bytes) to
// dst (row pitch dpitch bytes) on `stream`, asynchronously. kind 1: host
// to device; 2: device to host.
extern "C" int gtt_copy2d(void* dst, long long dpitch, const void* src,
                          long long spitch, long long width,
                          long long height, int kind, void* stream) {
  if (kind != 1 && kind != 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaMemcpyKind k =
      kind == 1 ? cudaMemcpyHostToDevice : cudaMemcpyDeviceToHost;
  return static_cast<int>(cudaMemcpy2DAsync(
      dst, static_cast<size_t>(dpitch), src, static_cast<size_t>(spitch),
      static_cast<size_t>(width), static_cast<size_t>(height), k,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* gtt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

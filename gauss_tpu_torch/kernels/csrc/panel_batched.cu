// Batched panel-factor kernel: partial-pivot LU of every member of a
// (B, h, panel) stack of column blocks, in one launch.
//
// Replaces: gauss_tpu/kernels/panel_pallas.py::panel_factor_pallas under
// jax.vmap, the form the block-diagonal lane runs
// (gauss_tpu/serve/cache.py, BatchedExecutable: jax.vmap of
// lu_factor_blocked over a (B, bucket, bucket) stack; a bucket is at most
// one panel wide there, so each member is one panel_factor_pallas call and
// the vmap makes them one batched kernel).
//
// Design: one thread block per member (the grid's x dimension runs over
// the members), each walking the member's pivot steps with the ONE
// one-block step loop of panel_common.cuh (gtt_factor_panel), so every
// member's factor is bit for bit the plain version's
// (kernels/panel.py::panel_factor_plain) and the single-strip kernels'.
// Where the transposed member fits a block's shared memory (a (128, 128)
// float32 member is 64 KiB) the block loads it there, factors it there and
// writes it out once; a larger member is factored in place in its slice
// of the global output scratch, as the one-block kernel does.
//
// The bfloat16 form (gtt_panel_factor_batched_bf16, launch key
// panel_factor_batched_bf16) runs the same loop at bfloat16 storage with
// the per-operation rounding of panel_factor_bf16 (panel_common.cuh), bit
// for bit the plain version at bfloat16; a (128, 128) member is 32 KiB of
// shared memory there. It serves the lowered (bfloat16) lane's one-panel
// buckets and the last panel of its wider ones.
//
// What bounds it: each member is the chain of `panel` dependent steps of
// the one-block kernel (a block-wide argmax, the pivot row, a rank-1
// update), on one SM; members run side by side on up to 132 SMs, so a
// stack of at most 132 members takes about one member's time.
#include "panel_common.cuh"

// Dynamic shared memory the in-smem route may take per block: the sm_90
// opt-in maximum (227 KiB) less room for the step loop's static arrays.
// gtt_panel_batched_info reports the route it gives a member.
#define GTT_BATCHED_SMEM_MAX (227 * 1024 - 8 * 1024)

template <bool SMEM, typename T>
__device__ __forceinline__ void gtt_panel_batched_body(
    const T* __restrict__ src, long long sstride, int ld, int h, int panel,
    int kb, T* __restrict__ pt, int* __restrict__ ipiv, int* __restrict__ inv,
    int* __restrict__ chosen, T* __restrict__ minpiv) {
  extern __shared__ float4 gtt_batched_smem[];
  const int b = blockIdx.x;
  const size_t words = (size_t)panel * h;
  T* out = pt + (size_t)b * words;
  T* work = SMEM ? reinterpret_cast<T*>(gtt_batched_smem) : out;
  gtt_load_panel_t(src + (size_t)b * sstride, ld, h, panel, work);
  gtt_factor_panel(work, h, panel, kb, ipiv + (size_t)b * panel,
                   inv + (size_t)b * h, chosen + (size_t)b * h, minpiv + b);
  if (SMEM) {
    // gtt_factor_panel ends on a barrier: every step's stores are done.
    for (size_t e = threadIdx.x; e < words; e += blockDim.x) out[e] = work[e];
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(GTT_THREADS)
gtt_panel_batched_kernel(const float* __restrict__ src, long long sstride,
                         int ld, int h, int panel, int kb,
                         float* __restrict__ pt, int* __restrict__ ipiv,
                         int* __restrict__ inv, int* __restrict__ chosen,
                         float* __restrict__ minpiv) {
  gtt_panel_batched_body<SMEM>(src, sstride, ld, h, panel, kb, pt, ipiv, inv,
                               chosen, minpiv);
}

template <bool SMEM>
__global__ void __launch_bounds__(GTT_THREADS)
gtt_panel_batched_bf16_kernel(const gtt_bf16* __restrict__ src,
                              long long sstride, int ld, int h, int panel,
                              int kb, gtt_bf16* __restrict__ pt,
                              int* __restrict__ ipiv, int* __restrict__ inv,
                              int* __restrict__ chosen,
                              gtt_bf16* __restrict__ minpiv) {
  gtt_panel_batched_body<SMEM>(src, sstride, ld, h, panel, kb, pt, ipiv, inv,
                               chosen, minpiv);
}

// The route of an (h, panel) member of `itemsize`-byte words (4: float32,
// 2: bfloat16): out[0] 1 when a block factors it in shared memory, 0 when
// in place in global memory; out[1] the dynamic shared memory bytes per
// block (0 on the global route).
extern "C" int gtt_panel_batched_info(int h, int panel, int itemsize,
                                      int* out) {
  if (panel < 1 || panel > GTT_PANEL_MAX || h < 1 ||
      (itemsize != 4 && itemsize != 2))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)panel * h * itemsize;
  out[0] = smem <= GTT_BATCHED_SMEM_MAX;
  out[1] = out[0] ? (int)smem : 0;
  return 0;
}

template <typename T, typename K>
static int gtt_batched_launch(K smem_kernel, K global_kernel, const T* src,
                              long long sstride, int ld, int batch, int h,
                              int panel, int kb, T* pt, int* ipiv, int* inv,
                              int* chosen, T* minpiv, void* stream) {
  if (panel < 1 || panel > GTT_PANEL_MAX || h < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)panel * h * sizeof(T);
  cudaStream_t s = (cudaStream_t)stream;
  if (smem <= GTT_BATCHED_SMEM_MAX) {
    cudaError_t e = cudaFuncSetAttribute(
        smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_kernel<<<batch, GTT_THREADS, smem, s>>>(
        src, sstride, ld, h, panel, kb, pt, ipiv, inv, chosen, minpiv);
  } else {
    global_kernel<<<batch, GTT_THREADS, 0, s>>>(
        src, sstride, ld, h, panel, kb, pt, ipiv, inv, chosen, minpiv);
  }
  return (int)cudaGetLastError();
}

// src: B members of (h, panel), row stride ld, member stride sstride
// (elements). pt: (B, panel, h) scratch that returns each factored member
// transposed; ipiv (B, panel), inv and chosen (B, h), minpiv (B).
// Returns cudaGetLastError().
extern "C" int gtt_panel_factor_batched(const float* src, long long sstride,
                                        int ld, int batch, int h, int panel,
                                        int kb, float* pt, int* ipiv,
                                        int* inv, int* chosen, float* minpiv,
                                        void* stream) {
  return gtt_batched_launch(gtt_panel_batched_kernel<true>,
                            gtt_panel_batched_kernel<false>, src, sstride, ld,
                            batch, h, panel, kb, pt, ipiv, inv, chosen,
                            minpiv, stream);
}

// The same at bfloat16 storage: src, pt and minpiv are bfloat16, the step
// loop the bfloat16 one of panel_common.cuh.
extern "C" int gtt_panel_factor_batched_bf16(
    const gtt_bf16* src, long long sstride, int ld, int batch, int h,
    int panel, int kb, gtt_bf16* pt, int* ipiv, int* inv, int* chosen,
    gtt_bf16* minpiv, void* stream) {
  return gtt_batched_launch(gtt_panel_batched_bf16_kernel<true>,
                            gtt_panel_batched_bf16_kernel<false>, src,
                            sstride, ld, batch, h, panel, kb, pt, ipiv, inv,
                            chosen, minpiv, stream);
}

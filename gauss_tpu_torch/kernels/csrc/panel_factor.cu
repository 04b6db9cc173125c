// Panel-factor kernel: partial-pivot LU of one (h, panel) column block.
//
// Replaces: gauss_tpu/kernels/panel_pallas.py::panel_factor_pallas
// (_factor_body, _panel_kernel), the classic per-step rank-1 form. The
// TPU's two-level deferred form exists for VMEM and MXU limits and is not
// carried over; its different rounding is covered by the tests' tolerance.
//
// Route: only strips that neither a thread-block cluster of up to 16
// blocks nor a grid of up to 132 co-resident blocks holds in shared memory
// (kernels/panel.py::panel_geometry; e.g. panel 1024 above 6,864 rows).
// Every other strip runs the cluster kernel of panel_cluster.cu or the
// grid kernel of panel_grid.cu, which compute the same values bit for
// bit; kernels/panel.py::panel_factor_one_block reaches this kernel on any
// strip, to time it beside them.
//
// What bounds it on the H100: not bytes or FLOPs (a (4096, 256) strip is
// 4 MB and ~0.27 GFLOP, microseconds of either) but the chain of `panel`
// dependent steps, each a block-wide argmax, a broadcast of the pivot row
// and a rank-1 update, separated by barriers, all on ONE SM: each step
// reads and writes every live element right of the step through L2
// (about 2 MB each way at (4096, 256)): 8.13 ms for the 256 steps of a
// (2048, 256) strip on an H100 SXM at 700 W (chip_smoke.py).
//
// What the design does about it: one block of 512 threads walks all steps
// in one launch (no launch per step, no host round trip), over the panel
// in a global scratch, transposed, where it stays in the 50 MB L2; rows
// stay in place (done mask, no swaps), each thread owns fixed rows, and
// the rank-1 update keeps GTT_BATCH loads in flight. The fused kernel's
// phase A (panel_fused.cu) and the batched kernels run this same step
// loop, gtt_factor_panel, on the strips no other route of theirs holds.
//
// The bfloat16 form (gtt_panel_factor_bf16, kernel
// gtt_panel_factor_bf16_kernel) runs the same loop on a bfloat16 scratch
// with the reference's per-operation rounding (panel_common.cuh); it moves
// half the bytes through L2 per step, and the chain of steps bounds it the
// same way.
#include "panel_common.cuh"

template <typename T>
__device__ __forceinline__ void gtt_panel_factor_body(
    const T* __restrict__ src, int ld, int h, int panel, int kb,
    T* __restrict__ pt, int* __restrict__ ipiv, int* __restrict__ inv,
    int* __restrict__ chosen, T* __restrict__ minpiv) {
  gtt_load_panel_t(src, ld, h, panel, pt);
  gtt_factor_panel(pt, h, panel, kb, ipiv, inv, chosen, minpiv);
}

__global__ void __launch_bounds__(GTT_THREADS)
gtt_panel_factor_kernel(const float* __restrict__ src, int ld, int h,
                        int panel, int kb, float* __restrict__ pt,
                        int* __restrict__ ipiv, int* __restrict__ inv,
                        int* __restrict__ chosen, float* __restrict__ minpiv) {
  gtt_panel_factor_body(src, ld, h, panel, kb, pt, ipiv, inv, chosen, minpiv);
}

__global__ void __launch_bounds__(GTT_THREADS)
gtt_panel_factor_bf16_kernel(const gtt_bf16* __restrict__ src, int ld, int h,
                             int panel, int kb, gtt_bf16* __restrict__ pt,
                             int* __restrict__ ipiv, int* __restrict__ inv,
                             int* __restrict__ chosen,
                             gtt_bf16* __restrict__ minpiv) {
  gtt_panel_factor_body(src, ld, h, panel, kb, pt, ipiv, inv, chosen, minpiv);
}

// src: the (h, panel) block, row stride ld. pt: (panel, h) scratch that
// returns the factored panel transposed. Returns cudaGetLastError().
extern "C" int gtt_panel_factor(const float* src, int ld, int h, int panel,
                                int kb, float* pt, int* ipiv, int* inv,
                                int* chosen, float* minpiv, void* stream) {
  if (panel < 1 || panel > GTT_PANEL_MAX || h < 1)
    return (int)cudaErrorInvalidValue;
  gtt_panel_factor_kernel<<<1, GTT_THREADS, 0, (cudaStream_t)stream>>>(
      src, ld, h, panel, kb, pt, ipiv, inv, chosen, minpiv);
  return (int)cudaGetLastError();
}

// The same at bfloat16 storage: src, pt and minpiv are bfloat16.
extern "C" int gtt_panel_factor_bf16(const gtt_bf16* src, int ld, int h,
                                     int panel, int kb, gtt_bf16* pt,
                                     int* ipiv, int* inv, int* chosen,
                                     gtt_bf16* minpiv, void* stream) {
  if (panel < 1 || panel > GTT_PANEL_MAX || h < 1)
    return (int)cudaErrorInvalidValue;
  gtt_panel_factor_bf16_kernel<<<1, GTT_THREADS, 0, (cudaStream_t)stream>>>(
      src, ld, h, panel, kb, pt, ipiv, inv, chosen, minpiv);
  return (int)cudaGetLastError();
}

// Panel-factor kernel: partial-pivot LU of one (h, panel) column block.
//
// Replaces: gauss_tpu/kernels/panel_pallas.py::panel_factor_pallas
// (_factor_body, _panel_kernel), the classic per-step rank-1 form. The
// TPU's two-level deferred form exists for VMEM and MXU limits and is not
// carried over; its different rounding is covered by the tests' tolerance.
//
// What bounds it on the H100: not bytes or FLOPs (a (256, 256) panel is
// 256 KB and ~11 MFLOP, well under a microsecond of either) but the chain
// of `panel` dependent steps — each a block-wide argmax, a broadcast of the
// pivot row and a rank-1 update, separated by barriers. The panel does not
// fit one SM's shared memory at the main path's widths (256 x 256 x 4 B =
// 256 KB > 227 KB), so it lives in a global scratch, transposed, where it
// stays resident in the 50 MB L2.
//
// What the design does about it: ONE thread block of 512 threads walks all
// steps in one launch (no launch per step, no host round trip); rows stay
// in place (done mask, no physical swaps) and each thread owns a fixed set
// of rows, so the only cross-thread traffic per step is the argmax and the
// pivot row, which is staged in shared memory. The transposed layout makes
// every per-step column read and rank-1 update coalesced. A cooperative
// multi-block version that holds the panel in the SMs' shared memory is a
// later optimisation.
#include "panel_common.cuh"

__global__ void __launch_bounds__(GTT_THREADS)
gtt_panel_factor_kernel(const float* __restrict__ src, int ld, int h,
                        int panel, int kb, float* __restrict__ pt,
                        int* __restrict__ ipiv, int* __restrict__ inv,
                        int* __restrict__ chosen, float* __restrict__ minpiv) {
  gtt_load_panel_t(src, ld, h, panel, pt);
  gtt_factor_panel(pt, h, panel, kb, ipiv, inv, chosen, minpiv, nullptr);
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

// Fused panel-factor + trailing-update kernel, and the standalone trailing
// kernel (the unfused pair's second launch).
//
// Replaces: gauss_tpu/kernels/panel_fused_pallas.py
//   - panel_trailing_fused_pallas (_fused_kernel, _trailing_tile_update):
//     gtt_panel_fused_kernel below;
//   - trailing_update_pallas (_trailing_kernel): gtt_trailing_kernel below.
//
// What bounds it on the H100: phase A (the panel factor) is one block
// walking `panel` dependent steps, latency-bound as in panel_factor.cu;
// phase B (the trailing update) is 2*h*panel*(wtot-col0-panel) FLOPs of
// FP32 FMA over one read and one write of the trailing block — at
// h = 2048, panel = 256 about 1.9 GFLOP against ~30 MB, so FP32 CUDA-core
// throughput (67 TFLOP/s peak) bounds phase B, not memory.
//
// What the design does about it: ONE cooperative launch. Block 0 factors
// the panel (the same gtt_factor_panel step loop as the panel kernel) and
// records each step's multiplier row into a global (panel, h) scratch;
// grid.sync(); then every block of a persistent grid (no larger than the
// co-resident block count — the launch fails rather than deadlock
// otherwise) takes 32-column trailing chunks. Per fseg-wide segment a chunk
// gathers the pivot rows, solves the small unit-triangular coupling by
// forward substitution (the TPU's Neumann series was a way around
// data-dependent loops), and applies the rank-fseg update with each thread
// owning one row and 32 column sums in registers, multipliers read
// coalesced and the pivot-row values broadcast from shared memory. The
// factored panel never makes a round trip to the host or a second launch.
// Tensor-core (wgmma) trailing updates are a later optimisation.
#include <cooperative_groups.h>

#include "panel_common.cuh"

namespace cg = cooperative_groups;

__global__ void __launch_bounds__(GTT_THREADS)
gtt_panel_fused_kernel(float* __restrict__ block, int ld, int h, int wtot,
                       int col0, int kbrow, int panel, int fseg,
                       float* __restrict__ pt, float* __restrict__ mult,
                       int* __restrict__ ipiv, int* __restrict__ inv,
                       int* __restrict__ chosen, float* __restrict__ minpiv) {
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0) {
    gtt_load_panel_t(block + col0, ld, h, panel, pt);
    gtt_factor_panel(pt, h, panel, kbrow, ipiv, inv, chosen, minpiv, mult);
  }
  grid.sync();
  gtt_trailing_all(block, ld, h, wtot, col0, panel, fseg, mult, ipiv);
}

__global__ void __launch_bounds__(GTT_THREADS)
gtt_trailing_kernel(float* __restrict__ block, int ld, int h, int wtot,
                    int col0, int panel, int fseg,
                    const float* __restrict__ mult,
                    const int* __restrict__ ipiv) {
  gtt_trailing_all(block, ld, h, wtot, col0, panel, fseg, mult, ipiv);
}

static int gtt_check(int h, int wtot, int col0, int panel, int fseg) {
  if (h < 1 || panel < 1 || panel > GTT_PANEL_MAX || fseg < 1 ||
      fseg > GTT_FSEG_MAX || col0 < 0 || col0 + panel > wtot)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The persistent grid of the fused kernel: one block per trailing chunk,
// capped at the co-resident block count. Returns <= 0 on failure.
extern "C" int gtt_panel_fused_grid(int wtot, int col0, int panel) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) !=
          cudaSuccess || !coop)
    return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gtt_panel_fused_kernel, GTT_THREADS, 0) != cudaSuccess ||
      per_sm < 1)
    return -1;
  const int chunks = gtt_trailing_chunks(wtot, col0, panel);
  const int cap = per_sm * sms;
  return chunks < 1 ? 1 : (chunks < cap ? chunks : cap);
}

// block: (h, wtot) row-major, row stride ld, updated IN PLACE right of
// col0 + panel. pt/mult: (panel, h) scratch; pt returns the factored panel
// transposed. `grid` comes from gtt_panel_fused_grid. Returns the launch's
// error code (cudaErrorCooperativeLaunchTooLarge when the grid is not
// co-resident), else cudaGetLastError().
extern "C" int gtt_panel_fused(float* block, int ld, int h, int wtot,
                               int col0, int kbrow, int panel, int fseg,
                               float* pt, float* mult, int* ipiv, int* inv,
                               int* chosen, float* minpiv, int grid,
                               void* stream) {
  const int bad = gtt_check(h, wtot, col0, panel, fseg);
  if (bad) return bad;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&block, &ld, &h, &wtot, &col0, &kbrow, &panel, &fseg,
                  &pt, &mult, &ipiv, &inv, &chosen, &minpiv};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)gtt_panel_fused_kernel, dim3(grid), dim3(GTT_THREADS), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The unfused pair's trailing launch: the same gtt_trailing_all as the
// fused kernel's phase B, from (panel, h) multipliers and the ipiv rows.
extern "C" int gtt_trailing_update(float* block, int ld, int h, int wtot,
                                   int col0, int panel, int fseg,
                                   const float* mult, const int* ipiv,
                                   void* stream) {
  const int bad = gtt_check(h, wtot, col0, panel, fseg);
  if (bad) return bad;
  const int chunks = gtt_trailing_chunks(wtot, col0, panel);
  if (chunks < 1) return 0;  // nothing right of the panel: no launch
  gtt_trailing_kernel<<<chunks, GTT_THREADS, 0, (cudaStream_t)stream>>>(
      block, ld, h, wtot, col0, panel, fseg, mult, ipiv);
  return (int)cudaGetLastError();
}

// Grid-resident panel-factor kernel: partial-pivot LU of one (h, panel)
// strip too tall for one thread-block cluster, by G co-resident blocks
// that hold it in their shared memory and exchange each pivot step
// through L2.
//
// Replaces: gauss_tpu/kernels/panel_pallas.py::panel_factor_pallas
// (_factor_body, _panel_kernel), the classic per-step rank-1 form, for
// every strip that no cluster of 16 blocks holds (at panel 256 above 3,392
// rows at float32, 6,848 at bfloat16) and G <= 132 blocks do (the rule is
// gtt_grid_route in panel_grid.cuh; kernels/panel.py::panel_geometry
// states it in Python). Shorter strips run the cluster kernel of
// panel_cluster.cu, taller ones the one-block kernel of panel_factor.cu.
// Same outputs as gtt_panel_factor, bit for bit (panel_grid.cuh says why).
//
// What bounds it on the H100, and what the design does about it:
// panel_grid.cuh. The launch is cooperative
// (cudaLaunchAttributeCooperative) with exactly G blocks: a G the card
// cannot hold at once fails to launch, and the launcher checks it first
// with the occupancy the card reports, returning
// cudaErrorCooperativeLaunchTooLarge; the wrapper raises, and nothing
// falls back.
//
// The bfloat16 form (gtt_panel_factor_grid_bf16, kernel
// gtt_panel_grid_bf16_kernel) keeps the strip in bfloat16 with the
// reference's per-operation rounding, as the cluster kernel does: twice
// the rows a block.
#include <mutex>

#include "panel_grid.cuh"

template <typename T>
__device__ __forceinline__ void gtt_panel_grid_body(
    const T* __restrict__ src, int ld, int h, int panel, int kb, int rows,
    const GttGridX& x, T* __restrict__ pt, int* __restrict__ ipiv,
    int* __restrict__ inv, int* __restrict__ chosen, T* __restrict__ minpiv) {
  extern __shared__ float4 gtt_grid_smem[];
  const GttClusterStrip<T> s =
      gtt_cluster_layout<T>(gtt_grid_smem, h, panel, kb, rows, x.rank);
  gtt_cluster_load(s, src, ld);
  const float minp = gtt_grid_factor(s, x, ipiv);
  gtt_cluster_store(s, h, pt, inv, chosen);
  if (x.rank == 0 && threadIdx.x == 0) *minpiv = gtt_to<T>(minp);
}

__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_panel_grid_kernel(const float* __restrict__ src, int ld, int h,
                      int panel, int kb, int rows,
                      unsigned long long* __restrict__ rec,
                      float* __restrict__ slot, float* __restrict__ pt,
                      int* __restrict__ ipiv, int* __restrict__ inv,
                      int* __restrict__ chosen, float* __restrict__ minpiv) {
  const GttGridX x = {rec, slot, (int)gridDim.x, (int)blockIdx.x};
  gtt_panel_grid_body(src, ld, h, panel, kb, rows, x, pt, ipiv, inv, chosen,
                      minpiv);
}

__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_panel_grid_bf16_kernel(const gtt_bf16* __restrict__ src, int ld, int h,
                           int panel, int kb, int rows,
                           unsigned long long* __restrict__ rec,
                           float* __restrict__ slot,
                           gtt_bf16* __restrict__ pt, int* __restrict__ ipiv,
                           int* __restrict__ inv, int* __restrict__ chosen,
                           gtt_bf16* __restrict__ minpiv) {
  const GttGridX x = {rec, slot, (int)gridDim.x, (int)blockIdx.x};
  gtt_panel_grid_body(src, ld, h, panel, kb, rows, x, pt, ipiv, inv, chosen,
                      minpiv);
}

// The kernel of a storage type.
static const void* gtt_grid_kernel(int itemsize) {
  return itemsize == 2 ? (const void*)gtt_panel_grid_bf16_kernel
                       : (const void*)gtt_panel_grid_kernel;
}

// The blocks the card holds at once for the kernel of `itemsize`-byte
// storage at `smem` bytes a block: blocks an SM times SMs (0: none fits).
// Sets both kernels' shared-memory attribute the first time; caches each
// answer per (itemsize, smem).
static int gtt_grid_fit(int itemsize, size_t smem, int* resident) {
  static std::mutex mu;
  static bool attrs_set = false;
  static long long keys[64];
  static int vals[64];
  static int used = 0;
  std::lock_guard<std::mutex> lock(mu);
  const long long key = (long long)itemsize << 48 | (long long)smem;
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) { *resident = vals[i]; return 0; }
  cudaError_t e;
  if (!attrs_set) {
    for (int isz : {4, 2}) {
      e = cudaFuncSetAttribute(gtt_grid_kernel(isz),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GTT_SMEM_MAX);
      if (e != cudaSuccess) return (int)e;
    }
    attrs_set = true;
  }
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gtt_grid_kernel(itemsize), GTT_THREADS, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (used < 64) {
    keys[used] = key;
    vals[used] = per_sm * sms;
    ++used;
  }
  *resident = per_sm * sms;
  return 0;
}

// The launch facts at `grid` blocks (0: the rule's G): G, rows per block
// and dynamic shared memory, or cudaErrorInvalidValue for a shape or G the
// kernel does not take (the rule's 0 included: that strip belongs to
// another route).
static int gtt_grid_plan(int h, int panel, int itemsize, int grid, int* g,
                         int* rows, size_t* smem) {
  if (panel < 1 || panel > GTT_PANEL_MAX || h < 1 || h > GTT_GRID_H_MAX)
    return (int)cudaErrorInvalidValue;
  *g = grid > 0 ? grid : gtt_grid_route(h, panel, itemsize);
  if (*g < 1 || *g > GTT_GRID_MAX) return (int)cudaErrorInvalidValue;
  *rows = (h + *g - 1) / *g;
  *smem = gtt_cluster_smem_bytes(*rows, panel, itemsize);
  return *smem > GTT_SMEM_MAX ? (int)cudaErrorInvalidValue : 0;
}

// The grid kernel at `grid` blocks (0: the rule's G). rec: 2 x G step
// records, ZEROED; slot: 2 x G x panel floats. Returns the plan's error,
// cudaErrorCooperativeLaunchTooLarge when the card cannot hold G such
// blocks at once, else the launch's error code.
template <typename T>
static int gtt_grid_launch(const T* src, int ld, int h, int panel, int kb,
                           T* pt, int* ipiv, int* inv, int* chosen,
                           T* minpiv, unsigned long long* rec, float* slot,
                           int grid, void* stream) {
  if (kb < 0 || h - kb < panel) return (int)cudaErrorInvalidValue;
  const int itemsize = (int)sizeof(T);
  int g = 0, rows = 0, resident = 0;
  size_t smem = 0;
  int rc = gtt_grid_plan(h, panel, itemsize, grid, &g, &rows, &smem);
  if (rc) return rc;
  rc = gtt_grid_fit(itemsize, smem, &resident);
  if (rc) return rc;
  if (resident < g) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g);
  cfg.blockDim = dim3(GTT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&src, (void*)&ld, (void*)&h, (void*)&panel,
                  (void*)&kb, (void*)&rows, (void*)&rec, (void*)&slot,
                  (void*)&pt, (void*)&ipiv, (void*)&inv, (void*)&chosen,
                  (void*)&minpiv};
  const cudaError_t e =
      cudaLaunchKernelExC(&cfg, gtt_grid_kernel(itemsize), args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// src: the (h, panel) block, row stride ld. pt: (panel, h) scratch that
// returns the factored panel transposed; ipiv (panel,), inv and chosen
// (h,), minpiv (1,), as gtt_panel_factor's; rec and slot as above.
extern "C" int gtt_panel_factor_grid(const float* src, int ld, int h,
                                     int panel, int kb, float* pt, int* ipiv,
                                     int* inv, int* chosen, float* minpiv,
                                     unsigned long long* rec, float* slot,
                                     int grid, void* stream) {
  return gtt_grid_launch(src, ld, h, panel, kb, pt, ipiv, inv, chosen,
                         minpiv, rec, slot, grid, stream);
}

// The same at bfloat16 storage: src, pt and minpiv are bfloat16 (the slot
// stays float).
extern "C" int gtt_panel_factor_grid_bf16(const gtt_bf16* src, int ld, int h,
                                          int panel, int kb, gtt_bf16* pt,
                                          int* ipiv, int* inv, int* chosen,
                                          gtt_bf16* minpiv,
                                          unsigned long long* rec,
                                          float* slot, int grid,
                                          void* stream) {
  return gtt_grid_launch(src, ld, h, panel, kb, pt, ipiv, inv, chosen,
                         minpiv, rec, slot, grid, stream);
}

// The launch facts of an (h, panel) strip of `itemsize`-byte elements (4:
// float32, 2: bfloat16) at `grid` blocks (0: the rule's G): out[0] G (0
// when the rule sends the strip to another route), out[1] rows per block,
// out[2] dynamic shared memory bytes per block, out[3] the blocks the card
// holds at once at that shared memory (0 on another route).
extern "C" int gtt_panel_grid_info(int h, int panel, int grid, int itemsize,
                                   int* out) {
  if (itemsize != 4 && itemsize != 2) return (int)cudaErrorInvalidValue;
  out[0] = out[1] = out[2] = out[3] = 0;
  if (grid < 1 && gtt_grid_route(h, panel, itemsize) < 1) return 0;
  int g = 0, rows = 0;
  size_t smem = 0;
  const int rc = gtt_grid_plan(h, panel, itemsize, grid, &g, &rows, &smem);
  if (rc) return rc;
  out[0] = g;
  out[1] = rows;
  out[2] = (int)smem;
  return gtt_grid_fit(itemsize, smem, &out[3]);
}

// Cluster-resident panel-factor kernel: partial-pivot LU of one (h, panel)
// strip by one thread-block cluster that holds the strip in its blocks'
// shared memory.
//
// Replaces: gauss_tpu/kernels/panel_pallas.py::panel_factor_pallas
// (_factor_body, _panel_kernel), the classic per-step rank-1 form, for
// every strip that a cluster of at most 16 blocks holds (the rule is
// gtt_cluster_size in panel_cluster.cuh; kernels/panel.py::panel_geometry
// states it in Python). Taller strips run the one-block kernel of
// panel_factor.cu. Same C signature and outputs as gtt_panel_factor, and
// bit for bit the same values (panel_cluster.cuh says why).
//
// What bounds it on the H100: not bytes or FLOPs (a (2048, 256) strip is
// 2 MB and ~0.13 GFLOP: a few microseconds of either) but the chain of
// `panel` dependent pivot steps, each an argmax over every live row, a
// broadcast of the pivot row and a rank-1 update. The one-block kernel
// pays a block-wide reduction and a pass of the whole live strip through
// L2 from one SM per step.
//
// What the design does about it: the strip is read from global memory
// once and written once; in between it lives in the shared memory of C
// blocks on C SMs (up to 212 rows a block at panel 256), so a step's
// rank-1 update is split C ways and never leaves the SM. A step costs one
// cluster barrier, two __syncthreads and one copy of the pivot row from
// its owner's slot through distributed shared memory; each block pushes
// its candidate into every block's shared memory, so the pivot search
// reads only local memory, and the barrier completes while the blocks
// run the bulk of the rank-1 update. The launcher checks with
// cudaOccupancyMaxActiveClusters that the cluster fits, and returns an
// error code when it does not: the wrapper raises, and nothing falls back.
//
// The bfloat16 form (gtt_panel_factor_cluster_bf16 and _at_bf16, kernel
// gtt_panel_cluster_bf16_kernel) keeps the strip in bfloat16, with the
// reference's per-operation rounding (panel_cluster.cuh): half the shared
// memory per row, so a cluster of 16 holds strips up to 6,848 rows at
// panel 256, and the strips of an n=8192 factorization that the float32
// kernel leaves to the one-block route up to that height take the cluster.
#include <mutex>

#include "panel_cluster.cuh"

template <typename T>
__device__ __forceinline__ void gtt_panel_cluster_body(
    const T* __restrict__ src, int ld, int h, int panel, int kb, int rows,
    T* __restrict__ pt, int* __restrict__ ipiv, int* __restrict__ inv,
    int* __restrict__ chosen, T* __restrict__ minpiv) {
  extern __shared__ float4 gtt_smem[];
  const int rank = (int)gtt_cg::this_cluster().block_rank();
  const GttClusterStrip<T> s =
      gtt_cluster_layout<T>(gtt_smem, h, panel, kb, rows, rank);
  gtt_cluster_load(s, src, ld);
  const float minp = gtt_cluster_factor(s, ipiv);
  gtt_cluster_store(s, h, pt, inv, chosen);
  if (rank == 0 && threadIdx.x == 0) *minpiv = gtt_to<T>(minp);
}

__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_panel_cluster_kernel(const float* __restrict__ src, int ld, int h,
                         int panel, int kb, int rows, float* __restrict__ pt,
                         int* __restrict__ ipiv, int* __restrict__ inv,
                         int* __restrict__ chosen,
                         float* __restrict__ minpiv) {
  gtt_panel_cluster_body(src, ld, h, panel, kb, rows, pt, ipiv, inv, chosen,
                         minpiv);
}

__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_panel_cluster_bf16_kernel(const gtt_bf16* __restrict__ src, int ld,
                              int h, int panel, int kb, int rows,
                              gtt_bf16* __restrict__ pt,
                              int* __restrict__ ipiv, int* __restrict__ inv,
                              int* __restrict__ chosen,
                              gtt_bf16* __restrict__ minpiv) {
  gtt_panel_cluster_body(src, ld, h, panel, kb, rows, pt, ipiv, inv, chosen,
                         minpiv);
}

// The kernel of a storage type.
template <typename T>
static const void* gtt_cluster_kernel();
template <>
const void* gtt_cluster_kernel<float>() {
  return (const void*)gtt_panel_cluster_kernel;
}
template <>
const void* gtt_cluster_kernel<gtt_bf16>() {
  return (const void*)gtt_panel_cluster_bf16_kernel;
}

static cudaLaunchConfig_t gtt_cluster_config(int c, size_t smem,
                                             cudaStream_t st,
                                             cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(GTT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of c blocks at `smem` bytes each the card holds at
// once for the kernel of `itemsize`-byte storage
// (cudaOccupancyMaxActiveClusters; 0: none fits). Cached per (itemsize,
// c, smem) in a small table.
static int gtt_cluster_fit(int itemsize, int c, size_t smem, int* clusters) {
  static std::mutex mu;
  static bool attrs_set = false;
  static long long keys[64];
  static int vals[64];
  static int used = 0;
  std::lock_guard<std::mutex> lock(mu);
  const long long key =
      (long long)itemsize << 48 | (long long)c << 32 | (long long)smem;
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) { *clusters = vals[i]; return 0; }
  cudaError_t e;
  if (!attrs_set) {
    const void* kerns[] = {gtt_cluster_kernel<float>(),
                           gtt_cluster_kernel<gtt_bf16>()};
    for (const void* k : kerns) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GTT_SMEM_MAX);
      if (e != cudaSuccess) return (int)e;
      e = cudaFuncSetAttribute(
          k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
    }
    attrs_set = true;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gtt_cluster_config(c, smem, 0, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(
      &n, itemsize == 2 ? gtt_cluster_kernel<gtt_bf16>()
                        : gtt_cluster_kernel<float>(),
      &cfg);
  if (e != cudaSuccess) return (int)e;
  if (used < 64) {
    keys[used] = key;
    vals[used] = n;
    ++used;
  }
  *clusters = n;
  return 0;
}

// The cluster kernel at cluster size `cluster` (0: the rule's). Returns
// cudaErrorInvalidValue for a shape or size the kernel does not take (the
// rule's 0 included: that strip belongs to the one-block kernel),
// cudaErrorLaunchOutOfResources when no such cluster fits on the card,
// else the launch's error code.
template <typename T>
static int gtt_cluster_launch(const T* src, int ld, int h, int panel, int kb,
                              T* pt, int* ipiv, int* inv, int* chosen,
                              T* minpiv, int cluster, void* stream) {
  if (panel < 1 || panel > GTT_PANEL_MAX || h < 1 || kb < 0)
    return (int)cudaErrorInvalidValue;
  const int itemsize = (int)sizeof(T);
  const int c = cluster > 0 ? cluster : gtt_cluster_size(h, panel, itemsize);
  if (c < 1 || c > GTT_CLUSTER_MAX) return (int)cudaErrorInvalidValue;
  const int rows = (h + c - 1) / c;
  const size_t smem = gtt_cluster_smem_bytes(rows, panel, itemsize);
  if (smem > GTT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  int clusters = 0;
  const int rc = gtt_cluster_fit(itemsize, c, smem, &clusters);
  if (rc) return rc;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      gtt_cluster_config(c, smem, (cudaStream_t)stream, &attr);
  void* args[] = {(void*)&src, (void*)&ld, (void*)&h, (void*)&panel,
                  (void*)&kb, (void*)&rows, (void*)&pt, (void*)&ipiv,
                  (void*)&inv, (void*)&chosen, (void*)&minpiv};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, gtt_cluster_kernel<T>(),
                                            args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int gtt_panel_factor_cluster_at(const float* src, int ld, int h,
                                           int panel, int kb, float* pt,
                                           int* ipiv, int* inv, int* chosen,
                                           float* minpiv, int cluster,
                                           void* stream) {
  return gtt_cluster_launch(src, ld, h, panel, kb, pt, ipiv, inv, chosen,
                            minpiv, cluster, stream);
}

extern "C" int gtt_panel_factor_cluster_at_bf16(
    const gtt_bf16* src, int ld, int h, int panel, int kb, gtt_bf16* pt,
    int* ipiv, int* inv, int* chosen, gtt_bf16* minpiv, int cluster,
    void* stream) {
  return gtt_cluster_launch(src, ld, h, panel, kb, pt, ipiv, inv, chosen,
                            minpiv, cluster, stream);
}

// gtt_panel_factor's signature and outputs, at the rule's cluster size.
extern "C" int gtt_panel_factor_cluster(const float* src, int ld, int h,
                                        int panel, int kb, float* pt,
                                        int* ipiv, int* inv, int* chosen,
                                        float* minpiv, void* stream) {
  return gtt_cluster_launch(src, ld, h, panel, kb, pt, ipiv, inv, chosen,
                            minpiv, 0, stream);
}

// The same at bfloat16 storage.
extern "C" int gtt_panel_factor_cluster_bf16(const gtt_bf16* src, int ld,
                                             int h, int panel, int kb,
                                             gtt_bf16* pt, int* ipiv,
                                             int* inv, int* chosen,
                                             gtt_bf16* minpiv, void* stream) {
  return gtt_cluster_launch(src, ld, h, panel, kb, pt, ipiv, inv, chosen,
                            minpiv, 0, stream);
}

// The launch facts of an (h, panel) strip of `itemsize`-byte elements (4:
// float32, 2: bfloat16) at cluster size `cluster` (0: the rule's): out[0]
// the cluster size (0 when the rule sends the strip to the one-block
// kernel), out[1] rows per block, out[2] dynamic shared memory bytes per
// block, out[3] clusters the card holds at once (0 on the one-block
// route).
extern "C" int gtt_panel_cluster_info(int h, int panel, int cluster,
                                      int itemsize, int* out) {
  if (itemsize != 4 && itemsize != 2) return (int)cudaErrorInvalidValue;
  const int c = cluster > 0 ? cluster : gtt_cluster_size(h, panel, itemsize);
  out[0] = c;
  out[1] = out[2] = out[3] = 0;
  if (c < 1) return 0;
  if (c > GTT_CLUSTER_MAX || h < 1 || panel < 1 || panel > GTT_PANEL_MAX)
    return (int)cudaErrorInvalidValue;
  out[1] = (h + c - 1) / c;
  const size_t smem = gtt_cluster_smem_bytes(out[1], panel, itemsize);
  out[2] = (int)smem;
  if (smem > GTT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  return gtt_cluster_fit(itemsize, c, smem, &out[3]);
}

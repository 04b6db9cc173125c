// Tiled matmul kernel and row-stripe matmul kernel: C = A @ B in f32.
//
// Replaces: gauss_tpu/kernels/matmul_pallas.py
//   - matmul_pallas (:131, _mm_kernel on a 3-D (m, n, k) grid):
//     gtt_matmul_tiled_{f32,mma}_kernel below, a 2-D grid of output tiles,
//     each block walking K (the TPU's sequential k grid axis and its VMEM
//     accumulator become the block's cp.async ring and registers).
//     "highest" runs the f32 routine of sgemm_common.cuh on (64, 128)
//     tiles of 128 threads, 4 blocks an SM; "high" and "default" run the
//     stripe's tile routine (stripe_common.cuh: mma.sync.m16n8k16 bf16,
//     hi*lo, lo*hi, hi*hi per K step of 16) on (64, 128) tiles, 3 blocks
//     an SM. What tells it from the stripe kernel: every output tile is a
//     block of its own, scheduled in any order, with no cluster;
//   - matmul_pallas_stripe (:245, the same accumulate kernel on a 2-D
//     grid, one full-width (bm, N) output stripe per program with a
//     sequential K axis, the reference's CUDA Version-1 layout):
//     gtt_matmul_stripe_kernel below, on the routine of stripe_common.cuh.
//
// What bounds them on the H100: operations. At 2048^3 "highest" is
// 2*2048^3 = 17.2 GFLOP of f32 FMA against 50 MB of operands and result
// (67 TFLOP/s f32 on CUDA cores and 3.35 TB/s: 0.256 ms of operations,
// 0.015 ms of bytes); "high" is three bf16 products, 51.5 GFLOP, whose
// floor is the bf16 tensor-core peak (989 TFLOP/s: 0.052 ms); "default"
// one bf16 product (0.017 ms).
//
// The stripe's design: "one program owns a stripe" becomes one
// thread-block cluster of GTT_STRIPE_CL = 8 blocks per (64, N) stripe,
// block r of the cluster taking column tiles r, r + 8, ...: the blocks
// of a stripe run side by side, and at m = 2048 the grid is 256 blocks
// of 128 threads, one wave on 132 SMs (cudaOccupancyMaxActiveClusters:
// 45 clusters at once at 3 blocks an SM). Each block walks K through a
// 4-stage cp.async ring of (64 x 16) A and (16 x 128) B tiles in 57 KB of
// dynamic shared memory, so the next tiles arrive while one is computed;
// operands whose rows are not all 16-byte aligned (any row stride, sliced
// tensors) take the 4-byte cp.async variant of the same kernel. "highest"
// accumulates true f32 FMAs in an 8x8 register micro-tile per thread on
// the CUDA cores; "high" and "default" run mma.sync.m16n8k16 bf16 on the
// tensor cores, splitting each staged f32 element into bf16 hi/lo while
// the fragments are built. The blocks of a cluster read the same A tiles;
// sharing them over distributed shared memory was left out (by count,
// ~1 MB of A beside ~2 MB of B of L2 traffic per block at 2048^3).
// ptxas -v (nvcc 12.9, sm_90a; chip_smoke.py phase 3b prints it), the
// stripe kernel by mode with 16-byte / 4-byte copies: "highest" 168
// registers, no spills / 168, 56 bytes of spill stores; "high" 168, 4
// bytes / 168, 60 bytes; "default" 162, none / 168, 32 bytes.
#include <stdint.h>

#include "gemm_common.cuh"
#include "sgemm_common.cuh"
#include "stripe_common.cuh"

// Kernel 4, "highest": one block per (GTT_SGEMM_BM, GTT_SGEMM_BN) output
// tile on the f32 routine of sgemm_common.cuh.
template <int VEC>
__global__ void __launch_bounds__(GTT_SGEMM_THREADS, GTT_SGEMM_MIN_BLOCKS)
gtt_matmul_tiled_f32_kernel(const float* __restrict__ A, int lda,
                            const float* __restrict__ B, int ldb,
                            float* __restrict__ C, int ldc, int M, int N,
                            int K, int cvec) {
  extern __shared__ __align__(16) unsigned char gtt_sgemm_smem[];
  GttSgemmStage* ring = reinterpret_cast<GttSgemmStage*>(gtt_sgemm_smem);
  const int row0 = blockIdx.y * GTT_SGEMM_BM, col0 = blockIdx.x * GTT_SGEMM_BN;
  float acc[64];
  gtt_sgemm_tile<VEC>(A, lda, B, ldb, M, N, K, row0, col0, ring, acc);
  gtt_sgemm_store<false>(C, ldc, nullptr, 0, M, N, row0, col0, cvec, acc);
}

// Kernel 4, "high" and "default": one block per (GTT_STRIPE_BM,
// GTT_STRIPE_BN) output tile on the stripe's tile routine
// (stripe_common.cuh: the same ring, mma.sync bf16 fragments), with the
// stripe kernel's launch bound.
template <int MODE, int VEC>
__global__ void __launch_bounds__(GTT_STRIPE_THREADS, 3)
gtt_matmul_tiled_mma_kernel(const float* __restrict__ A, int lda,
                            const float* __restrict__ B, int ldb,
                            float* __restrict__ C, int ldc, int M, int N,
                            int K, int cvec) {
  extern __shared__ __align__(16) unsigned char gtt_stripe_smem[];
  GttStripeStage* ring = reinterpret_cast<GttStripeStage*>(gtt_stripe_smem);
  gtt_stripe_tile<MODE, VEC>(A, lda, B, ldb, C, ldc, M, N, K,
                             blockIdx.y * GTT_STRIPE_BM,
                             blockIdx.x * GTT_STRIPE_BN, cvec, ring);
}

// One thread-block cluster of GTT_STRIPE_CL blocks owns one (BM, N) row
// stripe (cluster index = stripe); block r of it (%cluster_ctarank)
// computes the stripe's column tiles r, r + CL, ... one after another.
// Registers for 3 blocks an SM (168 a thread): the card then holds 45
// clusters at once, and the 32 of m = 2048 run in one wave (at 2 blocks an
// SM it holds 30).
template <int MODE, int VEC>
__global__ void __launch_bounds__(GTT_STRIPE_THREADS, 3)
gtt_matmul_stripe_kernel(const float* __restrict__ A, int lda,
                         const float* __restrict__ B, int ldb,
                         float* __restrict__ C, int ldc, int M, int N, int K,
                         int cvec) {
  extern __shared__ __align__(16) unsigned char gtt_stripe_smem[];
  GttStripeStage* ring = reinterpret_cast<GttStripeStage*>(gtt_stripe_smem);
  unsigned rank, stripe;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(stripe));
  const int row0 = (int)stripe * GTT_STRIPE_BM;
  for (int col0 = (int)rank * GTT_STRIPE_BN; col0 < N;
       col0 += GTT_STRIPE_CL * GTT_STRIPE_BN)
    gtt_stripe_tile<MODE, VEC>(A, lda, B, ldb, C, ldc, M, N, K, row0, col0,
                               cvec, ring);
}

static int gtt_check_mm(int m, int n, int k, int lda, int ldb, int ldc,
                        int mode) {
  if (m < 1 || n < 1 || k < 1 || lda < k || ldb < n || ldc < n ||
      mode < GTT_MODE_F32 || mode > GTT_MODE_BF16)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// 4 when A's and B's rows all start on 16-byte boundaries (16-byte
// cp.async), else 1 (4-byte cp.async).
static int gtt_stripe_vec(const void* a, int lda, const void* b, int ldb) {
  return (lda % 4 == 0 && ldb % 4 == 0 && (uintptr_t)a % 16 == 0 &&
          (uintptr_t)b % 16 == 0)
             ? 4
             : 1;
}

// The tiled kernel of a mode and copy width: its tile, threads, dynamic
// shared memory and (once per process, through gtt_kernel_occupancy) the
// blocks an SM holds.
template <int MODE, int VEC>
static int gtt_tiled_occupancy(int* bm, int* bn, int* threads, int* smem,
                               int* blocks) {
  static int cache = -1;
  const void* kern;
  if constexpr (MODE == GTT_MODE_F32) {
    kern = (const void*)gtt_matmul_tiled_f32_kernel<VEC>;
    *bm = GTT_SGEMM_BM, *bn = GTT_SGEMM_BN;
    *threads = GTT_SGEMM_THREADS, *smem = GTT_SGEMM_SMEM;
  } else {
    kern = (const void*)gtt_matmul_tiled_mma_kernel<MODE, VEC>;
    *bm = GTT_STRIPE_BM, *bn = GTT_STRIPE_BN;
    *threads = GTT_STRIPE_THREADS, *smem = GTT_STRIPE_SMEM;
  }
  const int rc = gtt_kernel_occupancy(kern, *threads, *smem, &cache);
  *blocks = cache;
  return rc;
}

template <int MODE, int VEC>
static int gtt_tiled_launch(const float* a, int lda, const float* b,
                            int ldb, float* c, int ldc, int m, int n, int k,
                            int cvec, cudaStream_t st) {
  int bm, bn, threads, smem, blocks;
  const int rc =
      gtt_tiled_occupancy<MODE, VEC>(&bm, &bn, &threads, &smem, &blocks);
  if (rc) return rc;
  if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  if constexpr (MODE == GTT_MODE_F32)
    gtt_matmul_tiled_f32_kernel<VEC><<<grid, threads, smem, st>>>(
        a, lda, b, ldb, c, ldc, m, n, k, cvec);
  else
    gtt_matmul_tiled_mma_kernel<MODE, VEC><<<grid, threads, smem, st>>>(
        a, lda, b, ldb, c, ldc, m, n, k, cvec);
  return (int)cudaGetLastError();
}

template <int VEC>
static int gtt_tiled_mode(const float* a, int lda, const float* b, int ldb,
                          float* c, int ldc, int m, int n, int k, int mode,
                          int cvec, cudaStream_t st) {
  if (mode == GTT_MODE_F32)
    return gtt_tiled_launch<GTT_MODE_F32, VEC>(a, lda, b, ldb, c, ldc, m, n,
                                               k, cvec, st);
  if (mode == GTT_MODE_BF16X3)
    return gtt_tiled_launch<GTT_MODE_BF16X3, VEC>(a, lda, b, ldb, c, ldc, m,
                                                  n, k, cvec, st);
  return gtt_tiled_launch<GTT_MODE_BF16, VEC>(a, lda, b, ldb, c, ldc, m, n,
                                              k, cvec, st);
}

// a: (m, k), b: (k, n), c: (m, n), all f32 row-major with row strides
// lda/ldb/ldc; mode: GTT_MODE_*. A 2-D grid of output tiles, each walking
// K: "highest" on sgemm_common.cuh (16-byte copies of B when its rows are
// aligned, gtt_sgemm_vec), the bf16 modes on the stripe's tile routine
// (16-byte copies when the rows of A and B are, gtt_stripe_vec). Returns
// cudaGetLastError().
extern "C" int gtt_matmul_tiled(const float* a, int lda, const float* b,
                                int ldb, float* c, int ldc, int m, int n,
                                int k, int mode, void* stream) {
  const int bad = gtt_check_mm(m, n, k, lda, ldb, ldc, mode);
  if (bad) return bad;
  const int cvec = ldc % 4 == 0 && (uintptr_t)c % 16 == 0;
  const int vec = mode == GTT_MODE_F32 ? gtt_sgemm_vec(b, ldb)
                                       : gtt_stripe_vec(a, lda, b, ldb);
  cudaStream_t st = (cudaStream_t)stream;
  return vec == 4 ? gtt_tiled_mode<4>(a, lda, b, ldb, c, ldc, m, n, k, mode,
                                      cvec, st)
                  : gtt_tiled_mode<1>(a, lda, b, ldb, c, ldc, m, n, k, mode,
                                      cvec, st);
}

template <int VEC>
static int gtt_tiled_info(int mode, int* o) {
  if (mode == GTT_MODE_F32)
    return gtt_tiled_occupancy<GTT_MODE_F32, VEC>(&o[4], &o[5], &o[2], &o[0],
                                                  &o[1]);
  if (mode == GTT_MODE_BF16X3)
    return gtt_tiled_occupancy<GTT_MODE_BF16X3, VEC>(&o[4], &o[5], &o[2],
                                                     &o[0], &o[1]);
  return gtt_tiled_occupancy<GTT_MODE_BF16, VEC>(&o[4], &o[5], &o[2], &o[0],
                                                 &o[1]);
}

// The tiled kernel's launch facts for a mode and copy width (4 or 1):
// out[0] dynamic shared memory bytes, out[1] blocks an SM holds at once,
// out[2] threads per block, out[3] 1 when the mode runs on the tensor
// cores, out[4] and out[5] the output tile's rows and columns.
extern "C" int gtt_matmul_tiled_info(int mode, int vec, int* out) {
  if (mode < GTT_MODE_F32 || mode > GTT_MODE_BF16 || (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  const int rc = vec == 4 ? gtt_tiled_info<4>(mode, out)
                          : gtt_tiled_info<1>(mode, out);
  out[3] = mode != GTT_MODE_F32;
  return rc;
}

static cudaLaunchConfig_t gtt_stripe_config(int blocks, cudaStream_t st,
                                            cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = GTT_STRIPE_CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(GTT_STRIPE_THREADS);
  cfg.dynamicSmemBytes = GTT_STRIPE_SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of the <MODE, VEC> kernel the card holds at once, from
// cudaOccupancyMaxActiveClusters at the ring's dynamic shared memory
// (queried once per process; 0 means none fits).
template <int MODE, int VEC>
static int gtt_stripe_clusters(int* clusters) {
  static int cached = -1;
  if (cached < 0) {
    auto kern = gtt_matmul_stripe_kernel<MODE, VEC>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GTT_STRIPE_SMEM);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = gtt_stripe_config(GTT_STRIPE_CL, 0, &attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, (void*)kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    cached = n;
  }
  *clusters = cached;
  return 0;
}

template <int MODE, int VEC>
static int gtt_stripe_launch(const float* a, int lda, const float* b,
                             int ldb, float* c, int ldc, int m, int n, int k,
                             int cvec, cudaStream_t st) {
  int clusters = 0;
  const int rc = gtt_stripe_clusters<MODE, VEC>(&clusters);
  if (rc) return rc;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  cudaLaunchAttribute attr;
  const int stripes = (m + GTT_STRIPE_BM - 1) / GTT_STRIPE_BM;
  const cudaLaunchConfig_t cfg =
      gtt_stripe_config(stripes * GTT_STRIPE_CL, st, &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gtt_matmul_stripe_kernel<MODE, VEC>, a, lda, b, ldb, c, ldc, m,
      n, k, cvec);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int VEC>
static int gtt_stripe_mode(const float* a, int lda, const float* b, int ldb,
                           float* c, int ldc, int m, int n, int k, int mode,
                           int cvec, cudaStream_t st) {
  if (mode == GTT_MODE_F32)
    return gtt_stripe_launch<GTT_MODE_F32, VEC>(a, lda, b, ldb, c, ldc, m, n,
                                                k, cvec, st);
  if (mode == GTT_MODE_BF16X3)
    return gtt_stripe_launch<GTT_MODE_BF16X3, VEC>(a, lda, b, ldb, c, ldc, m,
                                                   n, k, cvec, st);
  return gtt_stripe_launch<GTT_MODE_BF16, VEC>(a, lda, b, ldb, c, ldc, m, n,
                                               k, cvec, st);
}

// The same contract on the cluster-owned row-stripe grid:
// ceil(m / GTT_STRIPE_BM) clusters of GTT_STRIPE_CL blocks. Returns
// cudaErrorLaunchOutOfResources when no cluster fits on the card.
extern "C" int gtt_matmul_stripe(const float* a, int lda, const float* b,
                                 int ldb, float* c, int ldc, int m, int n,
                                 int k, int mode, void* stream) {
  const int bad = gtt_check_mm(m, n, k, lda, ldb, ldc, mode);
  if (bad) return bad;
  const int cvec = ldc % 4 == 0 && (uintptr_t)c % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (gtt_stripe_vec(a, lda, b, ldb) == 4)
    return gtt_stripe_mode<4>(a, lda, b, ldb, c, ldc, m, n, k, mode, cvec, st);
  return gtt_stripe_mode<1>(a, lda, b, ldb, c, ldc, m, n, k, mode, cvec, st);
}

// The stripe kernel's launch facts for a mode and copy width (4 or 1):
// out[0] dynamic shared memory bytes, out[1] clusters the card holds at
// once, out[2] blocks per cluster, out[3] threads per block, out[4] 1 when
// the mode runs on the tensor cores.
extern "C" int gtt_matmul_stripe_info(int mode, int vec, int* out) {
  if (mode < GTT_MODE_F32 || mode > GTT_MODE_BF16 || (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  int rc;
  if (vec == 4)
    rc = mode == GTT_MODE_F32      ? gtt_stripe_clusters<GTT_MODE_F32, 4>(&out[1])
         : mode == GTT_MODE_BF16X3 ? gtt_stripe_clusters<GTT_MODE_BF16X3, 4>(&out[1])
                                   : gtt_stripe_clusters<GTT_MODE_BF16, 4>(&out[1]);
  else
    rc = mode == GTT_MODE_F32      ? gtt_stripe_clusters<GTT_MODE_F32, 1>(&out[1])
         : mode == GTT_MODE_BF16X3 ? gtt_stripe_clusters<GTT_MODE_BF16X3, 1>(&out[1])
                                   : gtt_stripe_clusters<GTT_MODE_BF16, 1>(&out[1]);
  out[0] = GTT_STRIPE_SMEM;
  out[2] = GTT_STRIPE_CL;
  out[3] = GTT_STRIPE_THREADS;
  out[4] = mode != GTT_MODE_F32;
  return rc;
}

// Tiled matmul kernel and row-stripe matmul kernel: C = A @ B in f32.
//
// Replaces: gauss_tpu/kernels/matmul_pallas.py
//   - matmul_pallas (_mm_kernel on a 3-D (m, n, k) grid):
//     gtt_matmul_tiled_kernel below, one block per (128, 128) output tile,
//     walking K inside the block (the TPU's sequential k grid axis and its
//     VMEM accumulator become a loop and registers);
//   - matmul_pallas_stripe (the same accumulate kernel on a 2-D grid, one
//     full-width (bm, N) output stripe per program, the reference's CUDA
//     Version-1 layout): gtt_matmul_stripe_kernel below, one block per
//     (32, N) row stripe, walking its 128-wide column tiles and, for each,
//     K. The stripe has no width limit: each column tile's sums live in
//     registers only while that tile is computed.
//
// What bounds it on the H100: operations. At 2048^3 "highest" is
// 2*2048^3 = 17.2 GFLOP of f32 FMA against 50 MB of operands and result
// (67 TFLOP/s f32 and 3.35 TB/s: 0.256 ms of operations, 0.015 ms of
// bytes); "high" is three bf16 products, 51.5 GFLOP, whose floor is the
// bf16 tensor-core peak (989 TFLOP/s: 0.052 ms).
//
// What the design does about it: the shared tile routine of
// gemm_common.cuh, a shared-memory-staged SGEMM with an 8x8 (tiled) or
// 4x4 (stripe) register micro-tile per thread, so each staged operand is
// reused TM or TN times from registers. The bf16 splits run on CUDA cores
// (exact products, f32 sums); moving them onto the tensor cores (wgmma
// with TMA-fed shared-memory tiles) is the later optimisation.
#include "gemm_common.cuh"

#define GTT_TILED_BM 128
#define GTT_TILED_BN 128
#define GTT_STRIPE_BM 32
#define GTT_STRIPE_BN 128

template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void gtt_store_tile(float* __restrict__ C,
                                               int ldc, int M, int N,
                                               int row0, int col0,
                                               const float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int r, c;
      gtt_tile_coords<BN, TM, TN>(row0, col0, i, j, r, c);
      if (r < M && c < N) C[(size_t)r * ldc + c] = acc[i][j];
    }
}

template <int MODE>
__global__ void __launch_bounds__(GTT_GEMM_THREADS)
gtt_matmul_tiled_kernel(const float* __restrict__ A, int lda,
                        const float* __restrict__ B, int ldb,
                        float* __restrict__ C, int ldc, int M, int N, int K) {
  constexpr int BM = GTT_TILED_BM, BN = GTT_TILED_BN, TM = 8, TN = 8;
  __shared__ GttGemmSmem<BM, BN> s;
  float acc[TM][TN];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  gtt_gemm_tile<BM, BN, TM, TN, MODE>(A, lda, B, ldb, M, N, K, row0, col0, s,
                                      acc);
  gtt_store_tile<BM, BN, TM, TN>(C, ldc, M, N, row0, col0, acc);
}

template <int MODE>
__global__ void __launch_bounds__(GTT_GEMM_THREADS)
gtt_matmul_stripe_kernel(const float* __restrict__ A, int lda,
                         const float* __restrict__ B, int ldb,
                         float* __restrict__ C, int ldc, int M, int N,
                         int K) {
  constexpr int BM = GTT_STRIPE_BM, BN = GTT_STRIPE_BN, TM = 4, TN = 4;
  __shared__ GttGemmSmem<BM, BN> s;
  float acc[TM][TN];
  const int row0 = blockIdx.x * BM;
  for (int col0 = 0; col0 < N; col0 += BN) {
    gtt_gemm_tile<BM, BN, TM, TN, MODE>(A, lda, B, ldb, M, N, K, row0, col0,
                                        s, acc);
    gtt_store_tile<BM, BN, TM, TN>(C, ldc, M, N, row0, col0, acc);
  }
}

static int gtt_check_mm(int m, int n, int k, int lda, int ldb, int ldc,
                        int mode) {
  if (m < 1 || n < 1 || k < 1 || lda < k || ldb < n || ldc < n ||
      mode < GTT_MODE_F32 || mode > GTT_MODE_BF16)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// a: (m, k), b: (k, n), c: (m, n), all f32 row-major with row strides
// lda/ldb/ldc; mode: GTT_MODE_*. Returns cudaGetLastError().
extern "C" int gtt_matmul_tiled(const float* a, int lda, const float* b,
                                int ldb, float* c, int ldc, int m, int n,
                                int k, int mode, void* stream) {
  const int bad = gtt_check_mm(m, n, k, lda, ldb, ldc, mode);
  if (bad) return bad;
  const dim3 grid((n + GTT_TILED_BN - 1) / GTT_TILED_BN,
                  (m + GTT_TILED_BM - 1) / GTT_TILED_BM);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == GTT_MODE_F32)
    gtt_matmul_tiled_kernel<GTT_MODE_F32><<<grid, GTT_GEMM_THREADS, 0, st>>>(
        a, lda, b, ldb, c, ldc, m, n, k);
  else if (mode == GTT_MODE_BF16X3)
    gtt_matmul_tiled_kernel<GTT_MODE_BF16X3>
        <<<grid, GTT_GEMM_THREADS, 0, st>>>(a, lda, b, ldb, c, ldc, m, n, k);
  else
    gtt_matmul_tiled_kernel<GTT_MODE_BF16><<<grid, GTT_GEMM_THREADS, 0, st>>>(
        a, lda, b, ldb, c, ldc, m, n, k);
  return (int)cudaGetLastError();
}

// The same contract on the row-stripe grid.
extern "C" int gtt_matmul_stripe(const float* a, int lda, const float* b,
                                 int ldb, float* c, int ldc, int m, int n,
                                 int k, int mode, void* stream) {
  const int bad = gtt_check_mm(m, n, k, lda, ldb, ldc, mode);
  if (bad) return bad;
  const dim3 grid((m + GTT_STRIPE_BM - 1) / GTT_STRIPE_BM);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == GTT_MODE_F32)
    gtt_matmul_stripe_kernel<GTT_MODE_F32>
        <<<grid, GTT_GEMM_THREADS, 0, st>>>(a, lda, b, ldb, c, ldc, m, n, k);
  else if (mode == GTT_MODE_BF16X3)
    gtt_matmul_stripe_kernel<GTT_MODE_BF16X3>
        <<<grid, GTT_GEMM_THREADS, 0, st>>>(a, lda, b, ldb, c, ldc, m, n, k);
  else
    gtt_matmul_stripe_kernel<GTT_MODE_BF16>
        <<<grid, GTT_GEMM_THREADS, 0, st>>>(a, lda, b, ldb, c, ldc, m, n, k);
  return (int)cudaGetLastError();
}

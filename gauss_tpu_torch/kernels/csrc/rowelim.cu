// Row-elimination kernels: one pivot step, and the rank-k update of the
// batched form.
//
// Replaces: gauss_tpu/kernels/rowelim_pallas.py
//   - eliminate_step_pallas (_elim_kernel): gtt_eliminate_step_kernel;
//   - rankk_update_pallas (_rankk_kernel): gtt_rankk_update_kernel.
//
// Pivot step. What bounds it on the H100: bytes. Each step reads the
// (R, W) matrix once and writes it once (2 * 2048 * 2304 * 4 B = 37.7 MB at
// n = 2048, 0.0113 ms at 3.35 TB/s) for one multiply and one subtract per
// element. What the design does about it: one pass, one thread per column
// and GTT_ELIM_ROWS rows, so every row is read and written coalesced and
// the pivot row's scaled value is computed once per thread and kept in a
// register. The step writes a NEW matrix (the wrapper's `out`): every
// block reads the pivot row and the pivot column of the input, which no
// block writes, so no block can see a half-updated pivot row or column.
// The arithmetic is explicitly rounded (__fdiv_rn for the reciprocal,
// __fmul_rn, __fsub_rn) so nvcc cannot contract it into an FMA: the kernel
// equals the plain PyTorch version bit for bit. Rows above the pivot take
// m - 0 * prow, as the TPU kernel does, so an infinite scaled pivot row (a
// zero pivot) turns them into NaN there too.
//
// Rank-k update out = m - f @ u. What bounds it: operations. At n = 2048,
// k = 256 one launch is 2 * 2048 * 2304 * 256 = 2.42 GFLOP of f32 FMA
// against 42 MB (0.036 ms of operations at 67 TFLOP/s, 0.0126 ms of
// bytes). What the design does about it: the shared f32 tile routine of
// gemm_common.cuh (true f32, the TPU kernel's Precision.HIGHEST), with the
// product accumulated in full in registers and subtracted from m once in
// the epilogue, as the TPU kernel does.
#include "gemm_common.cuh"

#define GTT_ELIM_THREADS 256
#define GTT_ELIM_ROWS 8
#define GTT_RANKK_BM 128
#define GTT_RANKK_BN 128

__global__ void __launch_bounds__(GTT_ELIM_THREADS)
gtt_eliminate_step_kernel(const float* __restrict__ m, int ldm,
                          float* __restrict__ out, int ldo, int rows,
                          int cols, int i) {
  const int c = blockIdx.x * GTT_ELIM_THREADS + threadIdx.x;
  if (c >= cols) return;
  const float* prow = m + (size_t)i * ldm;
  const float inv = __fdiv_rn(1.0f, prow[i]);
  // The scaled pivot row, its diagonal pinned to exactly 1.
  const float ps = c == i ? 1.0f : __fmul_rn(prow[c], inv);
  const int r0 = blockIdx.y * GTT_ELIM_ROWS;
  const int r1 = min(rows, r0 + GTT_ELIM_ROWS);
  for (int r = r0; r < r1; ++r) {
    const float* row = m + (size_t)r * ldm;
    const float f = r > i ? row[i] : 0.0f;
    const float v = __fsub_rn(row[c], __fmul_rn(f, ps));
    out[(size_t)r * ldo + c] = r == i ? ps : v;
  }
}

__global__ void __launch_bounds__(GTT_GEMM_THREADS)
gtt_rankk_update_kernel(const float* __restrict__ m, int ldm,
                        const float* __restrict__ f, int ldf,
                        const float* __restrict__ u, int ldu,
                        float* __restrict__ out, int ldo, int R, int C,
                        int k) {
  constexpr int BM = GTT_RANKK_BM, BN = GTT_RANKK_BN, TM = 8, TN = 8;
  __shared__ GttGemmSmem<BM, BN> s;
  float acc[TM][TN];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  gtt_gemm_tile<BM, BN, TM, TN, GTT_MODE_F32>(f, ldf, u, ldu, R, C, k, row0,
                                              col0, s, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int r, c;
      gtt_tile_coords<BN, TM, TN>(row0, col0, i, j, r, c);
      if (r < R && c < C)
        out[(size_t)r * ldo + c] = __fsub_rn(m[(size_t)r * ldm + c], acc[i][j]);
    }
}

// m: (rows, cols) row stride ldm, read only; out: a different (rows, cols)
// buffer, row stride ldo; i: the pivot row and column (0 <= i < min(rows,
// cols)). Returns cudaGetLastError().
extern "C" int gtt_eliminate_step(const float* m, int ldm, float* out,
                                  int ldo, int rows, int cols, int i,
                                  void* stream) {
  if (rows < 1 || cols < 1 || ldm < cols || ldo < cols || i < 0 ||
      i >= rows || i >= cols || m == out)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + GTT_ELIM_THREADS - 1) / GTT_ELIM_THREADS,
                  (rows + GTT_ELIM_ROWS - 1) / GTT_ELIM_ROWS);
  gtt_eliminate_step_kernel<<<grid, GTT_ELIM_THREADS, 0,
                              (cudaStream_t)stream>>>(m, ldm, out, ldo, rows,
                                                      cols, i);
  return (int)cudaGetLastError();
}

// out = m - f @ u: m and out (R, C), f (R, k), u (k, C), f32 row-major with
// row strides; out is a buffer of its own (it overlaps none of the inputs).
// Returns cudaGetLastError().
extern "C" int gtt_rankk_update(const float* m, int ldm, const float* f,
                                int ldf, const float* u, int ldu, float* out,
                                int ldo, int R, int C, int k, void* stream) {
  if (R < 1 || C < 1 || k < 1 || ldm < C || ldo < C || ldf < k ||
      ldu < C || m == out)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + GTT_RANKK_BN - 1) / GTT_RANKK_BN,
                  (R + GTT_RANKK_BM - 1) / GTT_RANKK_BM);
  gtt_rankk_update_kernel<<<grid, GTT_GEMM_THREADS, 0,
                            (cudaStream_t)stream>>>(m, ldm, f, ldf, u, ldu,
                                                    out, ldo, R, C, k);
  return (int)cudaGetLastError();
}

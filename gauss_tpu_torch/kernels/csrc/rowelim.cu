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
// bytes). What the design does about it: the f32 routine of
// sgemm_common.cuh (true f32, the TPU kernel's Precision.HIGHEST: a
// cp.async ring, K-major A, 16-byte conflict-free fragments, 8x8 sums a
// thread) on a 2-D grid of (64, 128) output tiles of 128 threads, 4 blocks
// an SM; the product is accumulated in full in registers and subtracted
// from m once in the epilogue, as the TPU kernel does, m read and out
// written as float4s where the rows allow it. At (2048, 2304) the grid is
// 576 tiles on 528 block slots, 1.09 waves. An SM computes at one rate
// however many of its 4 slots are filled, so the time follows the tiles an
// SM takes, ceil(576 / 132) = 5 here; (128, 128) tiles take 3 of twice
// the work, and 5 blocks an SM (one wave) spill (scripts/probe_sgemm.py).
#include "gemm_common.cuh"
#include "sgemm_common.cuh"

#define GTT_ELIM_THREADS 256
#define GTT_ELIM_ROWS 8

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

template <int VEC>
__global__ void __launch_bounds__(GTT_SGEMM_THREADS, GTT_SGEMM_MIN_BLOCKS)
gtt_rankk_update_kernel(const float* __restrict__ m, int ldm,
                        const float* __restrict__ f, int ldf,
                        const float* __restrict__ u, int ldu,
                        float* __restrict__ out, int ldo, int R, int C,
                        int k, int ovec) {
  extern __shared__ __align__(16) unsigned char gtt_sgemm_smem[];
  GttSgemmStage* ring = reinterpret_cast<GttSgemmStage*>(gtt_sgemm_smem);
  const int row0 = blockIdx.y * GTT_SGEMM_BM, col0 = blockIdx.x * GTT_SGEMM_BN;
  float acc[64];
  gtt_sgemm_tile<VEC>(f, ldf, u, ldu, R, C, k, row0, col0, ring, acc);
  gtt_sgemm_store<true>(out, ldo, m, ldm, R, C, row0, col0, ovec, acc);
}

// The rank-k kernel of a copy width (once per process, through
// gtt_kernel_occupancy): the blocks an SM holds.
template <int VEC>
static int gtt_rankk_occupancy(int* blocks) {
  static int cache = -1;
  const int rc = gtt_kernel_occupancy(
      (const void*)gtt_rankk_update_kernel<VEC>, GTT_SGEMM_THREADS,
      GTT_SGEMM_SMEM, &cache);
  *blocks = cache;
  return rc;
}

template <int VEC>
static int gtt_rankk_launch(const float* m, int ldm, const float* f, int ldf,
                            const float* u, int ldu, float* out, int ldo,
                            int R, int C, int k, int ovec, cudaStream_t st) {
  int blocks = 0;
  const int rc = gtt_rankk_occupancy<VEC>(&blocks);
  if (rc) return rc;
  if (blocks < 1) return (int)cudaErrorLaunchOutOfResources;
  const dim3 grid((C + GTT_SGEMM_BN - 1) / GTT_SGEMM_BN,
                  (R + GTT_SGEMM_BM - 1) / GTT_SGEMM_BM);
  gtt_rankk_update_kernel<VEC><<<grid, GTT_SGEMM_THREADS, GTT_SGEMM_SMEM,
                                 st>>>(m, ldm, f, ldf, u, ldu, out, ldo, R,
                                       C, k, ovec);
  return (int)cudaGetLastError();
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
  // out and m as float4s where both have rows on 16-byte boundaries; u's
  // rows copied 16 bytes at a time where they are (gtt_sgemm_vec).
  const int ovec = ldo % 4 == 0 && ldm % 4 == 0 &&
                   (uintptr_t)out % 16 == 0 && (uintptr_t)m % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (gtt_sgemm_vec(u, ldu) == 4)
    return gtt_rankk_launch<4>(m, ldm, f, ldf, u, ldu, out, ldo, R, C, k,
                               ovec, st);
  return gtt_rankk_launch<1>(m, ldm, f, ldf, u, ldu, out, ldo, R, C, k, ovec,
                             st);
}

// The rank-k kernel's launch facts for a copy width of u (4 or 1), laid
// out as gtt_matmul_tiled_info's: out[0] dynamic shared memory bytes,
// out[1] blocks an SM holds at once, out[2] threads per block, out[3] 0
// (CUDA cores), out[4] and out[5] the output tile's rows and columns.
extern "C" int gtt_rankk_update_info(int vec, int* out) {
  if (vec != 1 && vec != 4) return (int)cudaErrorInvalidValue;
  const int rc = vec == 4 ? gtt_rankk_occupancy<4>(&out[1])
                          : gtt_rankk_occupancy<1>(&out[1]);
  out[0] = GTT_SGEMM_SMEM;
  out[2] = GTT_SGEMM_THREADS;
  out[3] = 0;
  out[4] = GTT_SGEMM_BM;
  out[5] = GTT_SGEMM_BN;
  return rc;
}

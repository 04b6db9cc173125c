// The f32 GEMM routine of the tiled matmul's "highest" mode (kernel 4,
// gtt_matmul_tiled, matmul.cu) and of the rank-k update (kernel 7,
// gtt_rankk_update, rowelim.cu).
//
// gtt_sgemm_tile computes acc = A[row0:row0 + BM, :] @ B[:, col0:col0 + BN]
// over all of K with true f32 FMAs in K order: the TPU kernels'
// Precision.HIGHEST. Hopper's tensor cores take TF32 at best, so the bound
// is the CUDA cores' 67 TFLOP/s, and the design keeps them fed:
//
// - Copies overlap compute. A ring of GTT_SGEMM_STAGES shared-memory
//   stages, each A's (BM, BK) and B's (BK, BN) tile, is filled by
//   cp.async; the copy of K tile kt + STAGES - 1 is in flight while tile
//   kt is computed, with one __syncthreads per K tile. Copies past the
//   matrix edges zero-fill.
// - A is staged K-major, a[k][row], transposed by the copy itself: 4-byte
//   copies, a warp reading 4 rows x 8 consecutive k (four 32-byte sectors)
//   and writing them to 32 distinct banks (the row stride BM + 4 is 4
//   words mod 32). Why K-major: one K step's fragment is then two float4
//   of A and two of B, 16 registers; a row-major A read as float4 along K
//   keeps eight float4 of A (32 registers) live across four K steps, which
//   the 64 sums do not leave room for at 128 registers a thread (4 blocks
//   an SM). B's rows are copied 16 bytes at a time when ldb and B's base
//   keep every row on a 16-byte boundary (VEC = 4, gtt_sgemm_vec), 4 bytes
//   otherwise (VEC = 1); A's copy does not depend on its alignment.
// - Fragments are 16 bytes and free of bank conflicts without padding B:
//   thread (ty, tx) = (tid / 16, tid % 16) owns an 8x8 micro-tile as 2 x 2
//   quads of 4x4, rows {ty*4 + i, BM/2 + ty*4 + i} and columns
//   {tx*4 + j, BN/2 + tx*4 + j}, i, j < 4. Every fragment read is an
//   LDS.128: the 8 threads of a quarter-warp read one A address (a
//   broadcast) and 128 contiguous bytes of B.
// - The epilogue (gtt_sgemm_store) stores float4s, and in the rank-k
//   update reads m as float4s, where the rows allow it; per element at the
//   ragged edge. A warp's store covers two rows of 256 contiguous bytes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_common.cuh"  // gtt_cp_async

#define GTT_SGEMM_BM 64         // rows of an output tile
#define GTT_SGEMM_BN 128        // columns of an output tile
#define GTT_SGEMM_BK 16         // K depth of one ring stage
#define GTT_SGEMM_STAGES 4      // stages of the cp.async ring
#define GTT_SGEMM_THREADS 128   // 2 * BM: (BM / 8) x 16 threads of 8 x 8 sums
#define GTT_SGEMM_MIN_BLOCKS 4  // launch bound: blocks an SM, 128 registers
#define GTT_SGEMM_APAD 4        // A's K-major rows of BM + 4 floats

static_assert(GTT_SGEMM_THREADS == 2 * GTT_SGEMM_BM,
              "one 8x8 micro-tile per thread covers the tile");
static_assert(GTT_SGEMM_BK % 8 == 0, "A's copy takes K in runs of 8");

struct GttSgemmStage {
  float a[GTT_SGEMM_BK][GTT_SGEMM_BM + GTT_SGEMM_APAD];  // a[k][row]
  float b[GTT_SGEMM_BK][GTT_SGEMM_BN];                   // b[k][col]
};

#define GTT_SGEMM_SMEM ((int)(GTT_SGEMM_STAGES * sizeof(GttSgemmStage)))

// 4 when every row of B starts on a 16-byte boundary (16-byte copies of
// B), else 1.
static int gtt_sgemm_vec(const void* b, int ldb) {
  return ldb % 4 == 0 && (uintptr_t)b % 16 == 0 ? 4 : 1;
}

// Issue the copies of K tile [k0, k0 + BK) of A's rows [row0, row0 + BM)
// and of B's columns [col0, col0 + BN) into stage s.
template <int VEC>
__device__ __forceinline__ void gtt_sgemm_load(
    GttSgemmStage& s, const float* __restrict__ A, int lda,
    const float* __restrict__ B, int ldb, int M, int N, int K, int row0,
    int col0, int k0) {
  constexpr int T = GTT_SGEMM_THREADS, BM = GTT_SGEMM_BM;
  constexpr int BK = GTT_SGEMM_BK, BW = GTT_SGEMM_BN / VEC;
  static_assert(GTT_SGEMM_BK * BW % T == 0, "B's copies divide evenly");
  const int tid = threadIdx.x;
  // Copy i: the K run i / 4 of 8 (k = (i / 4) * 8 + tid % 8), row
  // tid / 8 + (i % 4) * T / 8.
#pragma unroll
  for (int i = 0; i < BM * BK / T; ++i) {
    const int r = tid / 8 + (i % 4) * (T / 8), c = (i / 4) * 8 + tid % 8;
    const int gr = row0 + r, gc = k0 + c;
    const bool ok = gr < M && gc < K;
    gtt_cp_async<1>(&s.a[c][r], ok ? A + (size_t)gr * lda + gc : A,
                    ok ? 4 : 0);
  }
#pragma unroll
  for (int i = 0; i < BK * BW / T; ++i) {
    const int e = tid + i * T;
    const int r = e / BW, c = (e % BW) * VEC;
    const int gr = k0 + r, gc = col0 + c;
    const int ok = gr < K ? min(max(N - gc, 0), VEC) : 0;
    gtt_cp_async<VEC>(&s.b[r][c], ok ? B + (size_t)gr * ldb + gc : B,
                      4 * ok);
  }
}

// The tile row of the thread's sum i (of 8) and the tile column of its
// sum j (of 8).
__device__ __forceinline__ int gtt_sgemm_row(int i) {
  return (i < 4 ? 0 : GTT_SGEMM_BM / 2) + (threadIdx.x / 16) * 4 + (i & 3);
}
__device__ __forceinline__ int gtt_sgemm_col(int j) {
  return (j < 4 ? 0 : GTT_SGEMM_BN / 2) + (threadIdx.x % 16) * 4 + (j & 3);
}

// acc[i * 8 + j] += sum over the stage's K of A[row i][k] * B[k][col j].
__device__ __forceinline__ void gtt_sgemm_fma(const GttSgemmStage& s,
                                              float (&acc)[64]) {
  const int ar = (threadIdx.x / 16) * 4, bc = (threadIdx.x % 16) * 4;
#pragma unroll
  for (int kk = 0; kk < GTT_SGEMM_BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&s.a[kk][ar]);
    const float4 a1 = *reinterpret_cast<const float4*>(
        &s.a[kk][GTT_SGEMM_BM / 2 + ar]);
    const float4 b0 = *reinterpret_cast<const float4*>(&s.b[kk][bc]);
    const float4 b1 = *reinterpret_cast<const float4*>(
        &s.b[kk][GTT_SGEMM_BN / 2 + bc]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i * 8 + j] = fmaf(a[i], b[j], acc[i * 8 + j]);
  }
}

// acc = the (BM, BN) tile at (row0, col0) of A @ B, A (M, K) with row
// stride lda, B (K, N) with row stride ldb. Every thread of the block must
// call it; ring holds GTT_SGEMM_STAGES stages of dynamic shared memory.
template <int VEC>
__device__ __forceinline__ void gtt_sgemm_tile(
    const float* __restrict__ A, int lda, const float* __restrict__ B,
    int ldb, int M, int N, int K, int row0, int col0, GttSgemmStage* ring,
    float (&acc)[64]) {
  constexpr int S = GTT_SGEMM_STAGES, BK = GTT_SGEMM_BK;
  const int kt_n = (K + BK - 1) / BK;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < kt_n)
      gtt_sgemm_load<VEC>(ring[s], A, lda, B, ldb, M, N, K, row0, col0,
                          s * BK);
    gtt_cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    // Tile kt has landed for every thread, and every thread is done with
    // the stage that tile kt - 1 used, which the next copy refills.
    gtt_cp_async_wait<S - 2>();
    __syncthreads();
    const int next = kt + S - 1;
    if (next < kt_n)
      gtt_sgemm_load<VEC>(ring[next % S], A, lda, B, ldb, M, N, K, row0,
                          col0, next * BK);
    gtt_cp_async_commit();
    gtt_sgemm_fma(ring[kt % S], acc);
  }
  gtt_cp_async_wait<0>();
}

// out[r][c] = acc (SUB false) or __fsub_rn(m[r][c], acc) (SUB true: the
// product accumulated in full, subtracted once) for the tile at (row0,
// col0), rows < M and columns < N. vec: out's rows (and m's) start on
// 16-byte boundaries.
template <bool SUB>
__device__ __forceinline__ void gtt_sgemm_store(
    float* __restrict__ out, int ldo, const float* __restrict__ m, int ldm,
    int M, int N, int row0, int col0, int vec, const float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + gtt_sgemm_row(i);
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + gtt_sgemm_col(4 * h);
      const float* v = &acc[i * 8 + 4 * h];
      float* dst = out + (size_t)r * ldo + c;
      const float* src = SUB ? m + (size_t)r * ldm + c : nullptr;
      if (vec && c + 3 < N) {
        float4 x = make_float4(v[0], v[1], v[2], v[3]);
        if (SUB) {
          const float4 y = *reinterpret_cast<const float4*>(src);
          x = make_float4(__fsub_rn(y.x, x.x), __fsub_rn(y.y, x.y),
                          __fsub_rn(y.z, x.z), __fsub_rn(y.w, x.w));
        }
        *reinterpret_cast<float4*>(dst) = x;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) dst[j] = SUB ? __fsub_rn(src[j], v[j]) : v[j];
      }
    }
  }
}

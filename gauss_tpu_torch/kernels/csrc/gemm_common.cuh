// The f32 tile-GEMM routine shared by the tiled and row-stripe matmul
// kernels (matmul.cu) and the rank-k update (rowelim.cu).
//
// gtt_gemm_tile accumulates one (BM, BN) output tile of A @ B over all of
// K into a per-thread register micro-tile of TM x TN sums. Per BK-deep
// step the block stages A's (BM, BK) tile (transposed, so that a thread's
// TM rows are contiguous) and B's (BK, BN) tile in shared memory, zero
// past the matrix edges, then each thread runs BK rank-1 updates of its
// micro-tile from registers. Operand modes (the TPU kernel's precision
// names):
//   GTT_MODE_F32    true f32 FMAs on CUDA cores ("highest");
//   GTT_MODE_BF16X3 each staged element split into bf16 hi = rn(x) and
//                   lo = rn(x - hi); per k the products hi*lo, lo*hi and
//                   hi*hi are added in that order (the TPU kernel's order,
//                   kernels/matmul_pallas.py:_mm_kernel) with f32
//                   accumulation ("high" on f32);
//   GTT_MODE_BF16   one hi*hi pass ("default").
// A product of two bf16 values is exact in f32, so the CUDA cores compute
// the values a bf16 tensor-core pass would, up to summation order.
//
// This is a classic SGEMM: no wgmma, no TMA, no double buffering yet.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define GTT_GEMM_THREADS 256
#define GTT_GEMM_BK 16
#define GTT_GEMM_PAD 4  // keeps the transposed A tile's columns off one bank

enum { GTT_MODE_F32 = 0, GTT_MODE_BF16X3 = 1, GTT_MODE_BF16 = 2 };

__device__ __forceinline__ float gtt_bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The staged tiles; a_lo/b_lo are read in GTT_MODE_BF16X3 only. At the
// 256-thread, ~128-register blocks here registers, not these <= 33 KB,
// cap the blocks per SM.
template <int BM, int BN>
struct GttGemmSmem {
  float a[GTT_GEMM_BK][BM + GTT_GEMM_PAD];  // A tile transposed: a[k][row]
  float b[GTT_GEMM_BK][BN];
  float a_lo[GTT_GEMM_BK][BM + GTT_GEMM_PAD];
  float b_lo[GTT_GEMM_BK][BN];
};

// Stage one element in the mode's operand form.
template <int MODE>
__device__ __forceinline__ void gtt_stage(float v, float& hi, float& lo) {
  if (MODE == GTT_MODE_F32) {
    hi = v;
  } else {
    hi = gtt_bf16_rn(v);
    if (MODE == GTT_MODE_BF16X3) lo = gtt_bf16_rn(__fsub_rn(v, hi));
  }
}

// acc[TM][TN] = the (BM, BN) tile at (row0, col0) of A @ B, A (M, K) with
// row stride lda, B (K, N) with row stride ldb. Every thread of the block
// (GTT_GEMM_THREADS of them, laid out (BM/TM) x (BN/TN)) must call it.
template <int BM, int BN, int TM, int TN, int MODE>
__device__ void gtt_gemm_tile(const float* __restrict__ A, int lda,
                              const float* __restrict__ B, int ldb, int M,
                              int N, int K, int row0, int col0,
                              GttGemmSmem<BM, BN>& s,
                              float (&acc)[TM][TN]) {
  static_assert((BM / TM) * (BN / TN) == GTT_GEMM_THREADS,
                "micro-tile layout must cover the block");
  constexpr int BK = GTT_GEMM_BK;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += GTT_GEMM_THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      const float v = (gr < M && gc < K) ? A[(size_t)gr * lda + gc] : 0.0f;
      gtt_stage<MODE>(v, s.a[c][r], s.a_lo[c][r]);
    }
    for (int e = tid; e < BK * BN; e += GTT_GEMM_THREADS) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      const float v = (gr < K && gc < N) ? B[(size_t)gr * ldb + gc] : 0.0f;
      gtt_stage<MODE>(v, s.b[r][c], s.b_lo[r][c]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s.a[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s.b[kk][tx * TN + j];
      if (MODE == GTT_MODE_BF16X3) {
        float al[TM], bl[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          al[i] = s.a_lo[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bl[j] = s.b_lo[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = fmaf(a[i], bl[j], acc[i][j]);
            acc[i][j] = fmaf(al[i], b[j], acc[i][j]);
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// The output element (row, col) that acc[i][j] of this thread holds.
template <int BN, int TM, int TN>
__device__ __forceinline__ void gtt_tile_coords(int row0, int col0, int i,
                                                int j, int& r, int& c) {
  const int tid = threadIdx.x;
  r = row0 + (tid / (BN / TN)) * TM + i;
  c = col0 + (tid % (BN / TN)) * TN + j;
}

// The message of a CUDA error code (each library exports its own copy).
extern "C" const char* gtt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

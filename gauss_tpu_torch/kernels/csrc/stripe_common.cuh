// The cluster-owned row-stripe GEMM routine of kernel 5
// (gtt_matmul_stripe_kernel, matmul.cu).
//
// gtt_stripe_tile computes one (GTT_STRIPE_BM, GTT_STRIPE_BN) tile of
// C = A @ B over all of K and stores it. A ring of GTT_STRIPE_STAGES
// shared-memory stages, each holding A's (BM, BK) and B's (BK, BN) tiles,
// is filled by cp.async: 16-byte copies where every row of A and B starts
// on a 16-byte boundary (VEC = 4), 4-byte copies of the same layout
// otherwise (VEC = 1); copies past the matrix edges zero-fill. The copy
// of K tile kt + STAGES - 1 is in flight while tile kt is computed.
//
// Operand modes (the TPU kernel's precision names, GTT_MODE_*):
//   GTT_MODE_F32    true f32 FMAs on CUDA cores, an 8x8 register
//                   micro-tile per thread ("highest");
//   GTT_MODE_BF16X3 each f32 element split into bf16 hi = rn(x) and
//                   lo = rn(x - hi) while its fragment is built; per K step
//                   of 16 the products hi*lo, lo*hi and hi*hi are summed in
//                   that order and the step's sum is added to the running
//                   f32 sum (the TPU kernel's acc += hl + lh + hh per K
//                   block, matmul_pallas.py:_mm_kernel) ("high");
//   GTT_MODE_BF16   one hi*hi pass ("default").
// The bf16 modes run on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
// accumulate; each warp a 32x64 quarter of the tile as 2 x 8 m16n8
// tiles).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_common.cuh"  // GTT_MODE_*

#define GTT_STRIPE_BM 64       // rows of one stripe
#define GTT_STRIPE_BN 128      // columns of one tile
#define GTT_STRIPE_CL 8        // blocks of the cluster that owns a stripe
#define GTT_STRIPE_BK 16       // K depth of one ring stage
#define GTT_STRIPE_STAGES 4    // stages of the cp.async ring
#define GTT_STRIPE_THREADS 128
#define GTT_STRIPE_APAD 8      // A rows of 24 floats: fragment reads miss bank conflicts
#define GTT_STRIPE_BPAD 4      // B rows of 132 floats: the same for B

struct GttStripeStage {
  float a[GTT_STRIPE_BM][GTT_STRIPE_BK + GTT_STRIPE_APAD];  // a[row][k]
  float b[GTT_STRIPE_BK][GTT_STRIPE_BN + GTT_STRIPE_BPAD];  // b[k][col]
};

#define GTT_STRIPE_SMEM ((int)(GTT_STRIPE_STAGES * sizeof(GttStripeStage)))

// One cp.async of VEC floats; src_bytes < 4 * VEC zero-fills the rest.
template <int VEC>
__device__ __forceinline__ void gtt_cp_async(float* dst, const float* src,
                                             int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void gtt_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void gtt_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Issue the copies of K tile [k0, k0 + BK) of A's rows [row0, row0 + BM)
// and of B's columns [col0, col0 + BN) into stage s.
template <int VEC>
__device__ __forceinline__ void gtt_stripe_load(
    GttStripeStage& s, const float* __restrict__ A, int lda,
    const float* __restrict__ B, int ldb, int M, int N, int K, int row0,
    int col0, int k0) {
  constexpr int T = GTT_STRIPE_THREADS;
  constexpr int AW = GTT_STRIPE_BK / VEC, BW = GTT_STRIPE_BN / VEC;
  static_assert(GTT_STRIPE_BM * AW % T == 0 && GTT_STRIPE_BK * BW % T == 0,
                "copies must divide among the threads");
#pragma unroll
  for (int i = 0; i < GTT_STRIPE_BM * AW / T; ++i) {
    const int e = threadIdx.x + i * T;
    const int r = e / AW, c = (e % AW) * VEC;
    const int gr = row0 + r, gc = k0 + c;
    const int ok = gr < M ? min(max(K - gc, 0), VEC) : 0;
    gtt_cp_async<VEC>(&s.a[r][c], ok ? A + (size_t)gr * lda + gc : A,
                      4 * ok);
  }
#pragma unroll
  for (int i = 0; i < GTT_STRIPE_BK * BW / T; ++i) {
    const int e = threadIdx.x + i * T;
    const int r = e / BW, c = (e % BW) * VEC;
    const int gr = k0 + r, gc = col0 + c;
    const int ok = gr < K ? min(max(N - gc, 0), VEC) : 0;
    gtt_cp_async<VEC>(&s.b[r][c], ok ? B + (size_t)gr * ldb + gc : B,
                      4 * ok);
  }
}

// CUDA-core micro-tile: thread (ty, tx) = (tid / 16, tid % 16) owns rows
// {ty*4 + i, BM/2 + ty*4 + i} and columns {tx*4 + j, BN/2 + tx*4 + j},
// i, j < 4, so a quarter-warp reads 128 contiguous bytes of B.
__device__ __forceinline__ int gtt_stripe_row(int i) {
  return (i < 4 ? 0 : GTT_STRIPE_BM / 2) + (threadIdx.x / 16) * 4 + (i & 3);
}
__device__ __forceinline__ int gtt_stripe_col(int j) {
  return (j < 4 ? 0 : GTT_STRIPE_BN / 2) + (threadIdx.x % 16) * 4 + (j & 3);
}

__device__ __forceinline__ float gtt_f4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// acc[i * 8 + j] += sum over the stage's K of A[row i][k] * B[k][col j],
// true f32 FMAs in K order.
__device__ __forceinline__ void gtt_stripe_fma(const GttStripeStage& s,
                                               float (&acc)[64]) {
#pragma unroll
  for (int k4 = 0; k4 < GTT_STRIPE_BK; k4 += 4) {
    float4 a4[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a4[i] = *reinterpret_cast<const float4*>(&s.a[gtt_stripe_row(i)][k4]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float b[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            &s.b[k4 + q][gtt_stripe_col(4 * h)]);
        b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z,
        b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = gtt_f4(a4[i], q);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i * 8 + j] = fmaf(a, b[j], acc[i * 8 + j]);
      }
    }
  }
}

// Tensor-core fragments: warp w computes rows (w / 2) * 32 + [0, 32) and
// columns (w % 2) * 64 + [0, 64) of the tile as 2 x 8 tiles of 16 x 8;
// acc[(mi * 8 + ni) * 4 + q] is the m16n8 accumulator's element q.
__device__ __forceinline__ void gtt_split_bf16x2(float x0, float x1,
                                                 uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void gtt_mma_bf16(float* d, const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The stage's K step of 16 on the tensor cores. The n8 tiles go in pairs,
// each product issued for the 2 x 2 (mi, ni) sums of the pair before the
// next product, so consecutive mma.sync are independent while the
// fragments fit the registers of 3 blocks an SM.
template <int MODE>
__device__ __forceinline__ void gtt_stripe_mma(const GttStripeStage& s,
                                               float (&acc)[64]) {
  constexpr int NG = 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 64;
  static_assert(GTT_STRIPE_BK == 16, "one m16n8k16 step per stage");
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < 4; ++f) {  // a0..a3: (+0, +0), (+8, +0), (+0, +8), (+8, +8)
      const float2 x = *reinterpret_cast<const float2*>(
          &s.a[wr + mi * 16 + g + (f & 1) * 8][2 * t + (f >> 1) * 8]);
      gtt_split_bf16x2(x.x, x.y, ah[mi][f], al[mi][f]);
    }
#pragma unroll
  for (int n0 = 0; n0 < 8; n0 += NG) {
    uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int f = 0; f < 2; ++f)  // b0, b1: k = 2t + {0, 1} and + 8
        gtt_split_bf16x2(s.b[2 * t + f * 8][wc + (n0 + n) * 8 + g],
                         s.b[2 * t + f * 8 + 1][wc + (n0 + n) * 8 + g],
                         bh[n][f], bl[n][f]);
    float d[2][NG][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[mi][n][q] = 0.0f;
    if (MODE == GTT_MODE_BF16X3) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < NG; ++n) gtt_mma_bf16(d[mi][n], ah[mi], bl[n]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < NG; ++n) gtt_mma_bf16(d[mi][n], al[mi], bh[n]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < NG; ++n) gtt_mma_bf16(d[mi][n], ah[mi], bh[n]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float& c = acc[(mi * 8 + n0 + n) * 4 + q];
          c = __fadd_rn(c, d[mi][n][q]);
        }
  }
}

// C[(row0, col0) tile] = A @ B over all of K. Every thread of the block
// must call it; ring holds GTT_STRIPE_STAGES stages of dynamic shared
// memory. cvec: C's rows start on 16-byte boundaries.
template <int MODE, int VEC>
__device__ __forceinline__ void gtt_stripe_tile(
    const float* __restrict__ A, int lda, const float* __restrict__ B,
    int ldb, float* __restrict__ C, int ldc, int M, int N, int K, int row0,
    int col0, int cvec, GttStripeStage* ring) {
  constexpr int S = GTT_STRIPE_STAGES, BK = GTT_STRIPE_BK;
  const int kt_n = (K + BK - 1) / BK;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < kt_n)
      gtt_stripe_load<VEC>(ring[s], A, lda, B, ldb, M, N, K, row0, col0,
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
      gtt_stripe_load<VEC>(ring[next % S], A, lda, B, ldb, M, N, K, row0,
                           col0, next * BK);
    gtt_cp_async_commit();
    if (MODE == GTT_MODE_F32)
      gtt_stripe_fma(ring[kt % S], acc);
    else
      gtt_stripe_mma<MODE>(ring[kt % S], acc);
  }
  gtt_cp_async_wait<0>();
  __syncthreads();  // the next tile's copies refill the ring

  if (MODE != GTT_MODE_F32) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + (warp / 2) * 32 + mi * 16 + h * 8 + g;
        if (r >= M) continue;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int c = col0 + (warp % 2) * 64 + ni * 8 + 2 * t;
          const float* v = &acc[(mi * 8 + ni) * 4 + 2 * h];
          float* dst = C + (size_t)r * ldc + c;
          if (cvec && c + 1 < N) {
            *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
          } else {
            if (c < N) dst[0] = v[0];
            if (c + 1 < N) dst[1] = v[1];
          }
        }
      }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + gtt_stripe_row(i);
      if (r >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col0 + gtt_stripe_col(4 * h);
        const float* v = &acc[i * 8 + 4 * h];
        float* dst = C + (size_t)r * ldc + c;
        if (cvec && c + 3 < N) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < N) dst[j] = v[j];
        }
      }
    }
  }
}

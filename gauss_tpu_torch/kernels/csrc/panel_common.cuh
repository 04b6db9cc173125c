// Device routines shared by the one-block panel-factor kernel
// (panel_factor.cu), the one-block route of the fused panel+trailing
// kernel (panel_fused.cu) and the batched kernels.
//
// gtt_factor_panel is the ONE one-block pivot-step loop: the panel-factor
// kernel and the fused kernel's one-block phase A both run it, so their
// factored panels are bit-identical (and equal to the cluster loop of
// panel_cluster.cuh and the grid loop of panel_grid.cuh, which compute the
// same values).
//
// Arithmetic contract of the step loop: every multiply, subtract and
// divide is an explicitly rounded IEEE operation (__fmul_rn, __fsub_rn,
// __fdiv_rn) — no FMA contraction — so the loop computes exactly what the
// plain PyTorch version (separate mul, sub, div kernels) computes on the
// same inputs, and both choose the same pivots.
//
// Storage type T: float, or __nv_bfloat16 for the lowered factor
// (core/lowered.py). At bfloat16 each of those operations is done in
// float32 and its result rounded to bfloat16 at once (gtt_r), in the plain
// version's order: the division, the product (exact in float32, so one
// rounding) and the subtraction — what PyTorch's bfloat16 arithmetic does
// op by op. Values held outside the strip (the pivot row, multipliers,
// candidates) stay float, which holds every bfloat16 value exactly. At
// float32 gtt_r and gtt_to are identities and the loop is the float32
// one. Conversions go through the bf16 intrinsics only.
#pragma once

#include <cfloat>
#include <climits>
#include <cstddef>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 gtt_bf16;

// A stored value as float, a float as the storage type (rounded to
// nearest even), and the rounding of a float to the storage type.
__device__ __forceinline__ float gtt_f(float x) { return x; }
__device__ __forceinline__ float gtt_f(gtt_bf16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T gtt_to(float x);
template <>
__device__ __forceinline__ float gtt_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ gtt_bf16 gtt_to<gtt_bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T>
__device__ __forceinline__ float gtt_r(float x) {
  return gtt_f(gtt_to<T>(x));
}

// Four consecutive stored values (16 bytes of float, 8 of bfloat16, at
// that alignment) as a float4, and back.
__device__ __forceinline__ float4 gtt_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void gtt_st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 gtt_ld4(const gtt_bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(
      __bfloat162float(__ushort_as_bfloat16((unsigned short)(w.x & 0xffffu))),
      __bfloat162float(__ushort_as_bfloat16((unsigned short)(w.x >> 16))),
      __bfloat162float(__ushort_as_bfloat16((unsigned short)(w.y & 0xffffu))),
      __bfloat162float(__ushort_as_bfloat16((unsigned short)(w.y >> 16))));
}
__device__ __forceinline__ void gtt_st4(gtt_bf16* p, float4 v) {
  uint2 w;
  w.x = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.x)) |
        (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.y)) << 16;
  w.y = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.z)) |
        (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.w)) << 16;
  *reinterpret_cast<uint2*>(p) = w;
}

#define GTT_THREADS 512     // threads per block, every kernel
#define GTT_PANEL_MAX 1024  // widest panel the step loop stages in smem
#define GTT_BATCH 16        // rank-1 update columns in flight per thread

// The argmax order of jnp.argmax / torch.argmax: a NaN beats every number
// (the first NaN wins), otherwise the larger value, ties to the lower index.
__device__ __forceinline__ bool gtt_better(float av, int ai, float bv,
                                           int bi) {
  const bool an = av != av, bn = bv != bv;
  if (an || bn) return (an && bn) ? ai < bi : an;
  if (av != bv) return av > bv;
  return ai < bi;
}

// Block-wide argmax of (value, index) pairs; every thread gets the winner.
__device__ int gtt_block_argmax(float v, int i) {
  __shared__ float s_v[32];
  __shared__ int s_i[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (gtt_better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { s_v[warp] = v; s_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? s_v[lane] : -INFINITY;
    i = lane < nw ? s_i[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (gtt_better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) s_i[0] = i;
  }
  __syncthreads();
  const int p = s_i[0];
  __syncthreads();  // s_i is reused by the next call
  return p;
}

// Copy the (h, panel) row-major column block at `src` (row stride ld) into
// the transposed scratch pt (panel rows of h): column j of the panel is
// then one contiguous row, so each step's column reads and rank-1 updates
// are coalesced across the threads that own consecutive rows.
template <typename T>
__device__ void gtt_load_panel_t(const T* __restrict__ src, int ld, int h,
                                 int panel, T* __restrict__ pt) {
  const size_t total = (size_t)h * panel;
  for (size_t e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = (int)(e / panel), c = (int)(e % panel);
    pt[(size_t)c * h + r] = src[(size_t)r * ld + c];
  }
  __syncthreads();
}

// Partial-pivot LU of the transposed panel pt (panel, h), in place, by ONE
// thread block. Rows are never swapped: a row is "done" when it lies above
// the diagonal block (r < kb) or was chosen as a pivot (chosen[r] != 0).
// Step j: argmax of |column j| over live rows -> pivot p; ipiv[j] = p,
// inv[p] = kb + j, chosen[p] = 1; the pivot row is staged in smem; live
// rows take multipliers col/piv in column j and the rank-1 update
// T[c] - u[c] * mult in every column c > j. Outputs inv/chosen are (h,),
// ipiv (panel,), minpiv one value (a NaN pivot counts as 0: a zero pivot
// already poisoned the trailing rows).
template <typename T>
__device__ void gtt_factor_panel(T* __restrict__ pt, int h, int panel,
                                 int kb, int* __restrict__ ipiv,
                                 int* __restrict__ inv,
                                 int* __restrict__ chosen,
                                 T* __restrict__ minpiv) {
  __shared__ float s_u[GTT_PANEL_MAX];
  __shared__ float s_min;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int r = tid; r < h; r += nt) { inv[r] = r; chosen[r] = 0; }
  if (tid == 0) s_min = INFINITY;
  __syncthreads();
  for (int j = 0; j < panel; ++j) {
    T* col = pt + (size_t)j * h;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int r = tid; r < h; r += nt) {
      const bool done = r < kb || chosen[r] != 0;
      const float c = done ? -INFINITY : fabsf(gtt_f(col[r]));
      if (gtt_better(c, r, bv, bi)) { bv = c; bi = r; }
    }
    const int p = gtt_block_argmax(bv, bi);
    for (int c = tid; c < panel; c += nt)
      s_u[c] = gtt_f(pt[(size_t)c * h + p]);
    if (tid == 0) {
      ipiv[j] = p;
      inv[p] = kb + j;
      chosen[p] = 1;
    }
    __syncthreads();
    const float piv = s_u[j];
    if (tid == 0) {
      const float a = fabsf(piv);
      s_min = fminf(s_min, a != a ? 0.0f : a);
    }
    for (int r = tid; r < h; r += nt) {
      const bool done = r < kb || chosen[r] != 0;  // includes p
      const float cv = gtt_f(col[r]);
      const float q = gtt_r<T>(__fdiv_rn(cv, piv));
      const float m = done ? 0.0f : q;
      col[r] = gtt_to<T>(done ? cv : q);
      // Rank-1 update, GTT_BATCH columns at a time: all the batch's loads
      // issue before its stores, so GTT_BATCH L2 round trips overlap
      // instead of serialising load-store pairs.
      int c = j + 1;
      for (; c + GTT_BATCH <= panel; c += GTT_BATCH) {
        float v[GTT_BATCH];
#pragma unroll
        for (int k = 0; k < GTT_BATCH; ++k)
          v[k] = gtt_f(pt[(size_t)(c + k) * h + r]);
#pragma unroll
        for (int k = 0; k < GTT_BATCH; ++k)
          pt[(size_t)(c + k) * h + r] = gtt_to<T>(
              __fsub_rn(v[k], gtt_r<T>(__fmul_rn(s_u[c + k], m))));
      }
      for (; c < panel; ++c) {
        T* a = pt + (size_t)c * h + r;
        *a = gtt_to<T>(__fsub_rn(gtt_f(*a), gtt_r<T>(__fmul_rn(s_u[c], m))));
      }
      if (!(fabsf(m) <= FLT_MAX)) {
        // The plain version subtracts 0 * mult from the finished columns
        // too; that is an identity unless the multiplier is inf/NaN.
        for (int c = 0; c < j; ++c) {
          T* a = pt + (size_t)c * h + r;
          *a = gtt_to<T>(__fsub_rn(gtt_f(*a), gtt_r<T>(__fmul_rn(0.0f, m))));
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) *minpiv = gtt_to<T>(s_min);
}

// The message of a CUDA error code (each library exports its own copy).
extern "C" const char* gtt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

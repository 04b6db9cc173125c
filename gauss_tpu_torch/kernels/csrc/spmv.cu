// ELL (padded-row) sparse matrix-vector product y = A @ x.
//
// Replaces: gauss_tpu/sparse/spmv.py
//   - spmv_ell_pallas (_spmv_kernel): gtt_spmv_ell_kernel<float|double>.
//
// What it computes: y[r] = sum_j vals[r, j] * x[cols[r, j]] over the k
// padded slots of row r; padding (column 0, value 0) adds exactly 0. cols
// is int32 and vals is T, both row-major (n, k) as CsrMatrix.ell() lays
// them; x and y are T vectors. The column indices must lie in [0, len(x)):
// the kernel does not check them (the CSR assembly does).
//
// Summation order (the plain version, spmv_ell_plain, repeats it): per
// row, acc = 0, then for j = 0 .. k-1 in order
//   acc = round(acc + round(vals[r, j] * x[cols[r, j]])),
// with __dmul_rn/__dadd_rn (__fmul_rn/__fadd_rn) so nvcc cannot contract a
// product and a sum into an FMA. The kernel equals the plain version bit
// for bit.
//
// What bounds it on the H100: bytes. A launch reads n*k*(4 + sizeof(T))
// bytes of cols and vals once, n*sizeof(T) of x and writes n*sizeof(T) of y
// for 2*n*k operations: 12 bytes per multiply-add in f64 (44.8 MB, 0.0134 ms
// at 3.35 TB/s, for the (100000, 36) operand; 460 MB, 0.137 ms, for
// (1000000, 37)). What the design does about it: the TPU kernel's bm-row
// VMEM block and resident copy of x are gone. The sum's order ties a row
// to one thread, and a thread that read its own row from global memory
// would sit k elements from its neighbour; so the work is split in two.
// The products carry no order, and every thread of the block computes
// them: a block takes GTT_SPMV_ROWS consecutive rows, whose slots are one
// contiguous run of cols and vals, reads that run coalesced, gathers x
// through the read-only path (__ldg; x lives in L2), and parks each
// rounded product in shared memory. Then one thread per row adds its
// row's products in slot order out of shared memory (row stride odd: no
// bank conflicts). Four times as many threads gather as add, which is
// where the memory parallelism comes from. A row wider than the shared
// tile is walked in passes of at most kcmax slots with the running sum in
// a register, so any k fits and the order above holds. Rows past n are
// neither read nor written; offsets are 64-bit.
#include <cuda_runtime.h>

#define GTT_SPMV_ROWS 32
#define GTT_SPMV_THREADS 128
// Dynamic shared memory a launch may ask for without opting in.
#define GTT_SPMV_SMEM (48 * 1024)

__device__ __forceinline__ float gtt_mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float gtt_add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double gtt_mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double gtt_add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(GTT_SPMV_THREADS)
gtt_spmv_ell_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                    const T* __restrict__ x, T* __restrict__ y, int n, int k,
                    int kcmax) {
  extern __shared__ __align__(16) unsigned char gtt_spmv_smem[];
  T* prod = reinterpret_cast<T*>(gtt_spmv_smem);
  const long long r0 = (long long)blockIdx.x * GTT_SPMV_ROWS;
  const int rows = (int)min((long long)GTT_SPMV_ROWS, (long long)n - r0);
  const int t = threadIdx.x;
  T acc = (T)0;
  for (int j0 = 0; j0 < k; j0 += kcmax) {
    const int kc = min(kcmax, k - j0);
    const int kp = kc | 1;  // odd row stride of the shared tile
    // Products: element i of the pass is (row i / kc, slot j0 + i % kc),
    // walked with a running (r, j) instead of a division per element.
    int r = t / kc, j = t % kc;
    const int dr = GTT_SPMV_THREADS / kc, dj = GTT_SPMV_THREADS % kc;
    for (int i = t; i < rows * kc; i += GTT_SPMV_THREADS) {
      const long long off = (r0 + r) * (long long)k + j0 + j;
      prod[r * kp + j] = gtt_mul_rn(vals[off], __ldg(x + cols[off]));
      r += dr;
      j += dj;
      if (j >= kc) {
        j -= kc;
        ++r;
      }
    }
    __syncthreads();
    if (t < rows) {
      const T* p = prod + t * kp;
#pragma unroll 8
      for (int jj = 0; jj < kc; ++jj) acc = gtt_add_rn(acc, p[jj]);
    }
    __syncthreads();
  }
  if (t < rows) y[r0 + t] = acc;
}

template <typename T>
static int gtt_spmv_ell_launch(const int* cols, const T* vals, const T* x,
                               T* y, int n, int k, void* stream) {
  if (n < 1 || k < 1 || (const void*)x == (const void*)y)
    return (int)cudaErrorInvalidValue;
  // The widest pass whose (ROWS, kc | 1) tile of T fits the shared memory.
  const int limit = (GTT_SPMV_SMEM / (GTT_SPMV_ROWS * (int)sizeof(T)) - 1) | 1;
  const int kcmax = k < limit ? k : limit - 1;
  const size_t smem = (size_t)GTT_SPMV_ROWS * (kcmax | 1) * sizeof(T);
  const unsigned grid = (unsigned)(((long long)n + GTT_SPMV_ROWS - 1) /
                                   GTT_SPMV_ROWS);
  gtt_spmv_ell_kernel<T><<<grid, GTT_SPMV_THREADS, smem,
                           (cudaStream_t)stream>>>(cols, vals, x, y, n, k,
                                                   kcmax);
  return (int)cudaGetLastError();
}

// cols: (n, k) int32, vals: (n, k) T, both row-major and contiguous; x: the
// operand vector (every column index < its length); y: (n,) output, a
// buffer of its own. Returns cudaGetLastError().
extern "C" int gtt_spmv_ell_f32(const int* cols, const float* vals,
                                const float* x, float* y, int n, int k,
                                void* stream) {
  return gtt_spmv_ell_launch<float>(cols, vals, x, y, n, k, stream);
}

extern "C" int gtt_spmv_ell_f64(const int* cols, const double* vals,
                                const double* x, double* y, int n, int k,
                                void* stream) {
  return gtt_spmv_ell_launch<double>(cols, vals, x, y, n, k, stream);
}

// The message of a CUDA error code (each library exports its own copy).
extern "C" const char* gtt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

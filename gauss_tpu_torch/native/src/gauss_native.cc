// Native host-side runtime for gauss-tpu: CPU baseline engines + fast .dat I/O.
//
// The reference implements its CPU engines as 10 standalone C programs
// (reference Pthreads/Version-{1,2,3}/*.c, OpenMP_and_MPI/gauss_{openmp,mpi}/*.c);
// this library provides the same engine taxonomy behind one C ABI so the
// Python CLI can dispatch `--backend={seq,omp,threads}` to true native code:
//
//   seq     — sequential partial-pivot elimination (the reference's baseline,
//             upgraded from swap-on-zero to partial pivoting per SURVEY.md §7c)
//   omp     — OpenMP `parallel for` over elimination rows (reference C4)
//   threads — persistent std::thread workers, cyclic row striping, barrier
//             synchronization: the modern-C++ re-expression of reference C3's
//             persistent pthreads + hand-rolled condvar barrier (and of C1's
//             cyclic striping); threads are spawned once, not n*T times
//
// All engines operate in-place on caller-owned row-major float64 buffers and
// share one elimination step helper, de-duplicating what the reference copies
// into every translation unit. Return codes: 0 ok, -1 singular, -2 bad args.

#include <atomic>
#if defined(__has_include)
#if __has_include(<barrier>)
#include <barrier>
#define GT_HAVE_STD_BARRIER 1
#endif
#endif
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#ifdef __linux__
#include <pthread.h>
#include <sched.h>
#endif
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

#ifdef GT_HAVE_STD_BARRIER
using Barrier = std::barrier<>;
#else
// libstdc++ < 11 ships C++20 without <barrier>; this condvar barrier has the
// same arrive_and_wait contract (and is exactly the hand-rolled barrier the
// reference C3 uses, Pthreads/Version-3/gauss_internal_input.c).
class Barrier {
 public:
  explicit Barrier(long count) : threshold_(count), count_(count) {}
  void arrive_and_wait() {
    std::unique_lock<std::mutex> lk(m_);
    const unsigned long gen = generation_;
    if (--count_ == 0) {
      ++generation_;
      count_ = threshold_;
      cv_.notify_all();
    } else {
      cv_.wait(lk, [&] { return generation_ != gen; });
    }
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  const long threshold_;
  long count_;
  unsigned long generation_ = 0;
};
#endif

// Select the partial pivot for column i, swap rows of A and b, scale the
// pivot row to unit diagonal. Returns false if the column is exactly singular.
bool pivot_and_scale(double* A, double* b, long n, long i) {
  long best = i;
  double best_abs = std::fabs(A[i * n + i]);
  for (long r = i + 1; r < n; ++r) {
    double v = std::fabs(A[r * n + i]);
    if (v > best_abs) {
      best_abs = v;
      best = r;
    }
  }
  if (best_abs == 0.0) return false;
  if (best != i) {
    for (long k = 0; k < n; ++k) std::swap(A[i * n + k], A[best * n + k]);
    std::swap(b[i], b[best]);
  }
  const double piv = A[i * n + i];
  double* row = A + i * n;
  for (long k = i; k < n; ++k) row[k] /= piv;
  row[i] = 1.0;  // exact, mirroring the JAX core's pinned diagonal
  b[i] /= piv;
  return true;
}

// Eliminate one target row j against the scaled pivot row i.
inline void eliminate_row(double* A, double* b, long n, long i, long j) {
  double* tgt = A + j * n;
  const double* piv = A + i * n;
  const double f = tgt[i];
  if (f == 0.0) return;
  for (long k = i; k < n; ++k) tgt[k] -= f * piv[k];
  tgt[i] = 0.0;
  b[j] -= f * b[i];
}

void back_substitute(const double* A, const double* b, double* x, long n) {
  for (long i = n - 1; i >= 0; --i) {
    double acc = b[i];
    const double* row = A + i * n;
    for (long j = i + 1; j < n; ++j) acc -= row[j] * x[j];
    x[i] = acc / row[i];
  }
}

}  // namespace

extern "C" {

int gt_gauss_solve_seq(double* A, double* b, double* x, long n) {
  if (!A || !b || !x || n <= 0) return -2;
  for (long i = 0; i < n; ++i) {
    if (!pivot_and_scale(A, b, n, i)) return -1;
    for (long j = i + 1; j < n; ++j) eliminate_row(A, b, n, i, j);
  }
  back_substitute(A, b, x, n);
  return 0;
}

int gt_gauss_solve_omp(double* A, double* b, double* x, long n, int nthreads) {
  if (!A || !b || !x || n <= 0) return -2;
#ifdef _OPENMP
  if (nthreads > 0) omp_set_num_threads(nthreads);
  for (long i = 0; i < n; ++i) {
    if (!pivot_and_scale(A, b, n, i)) return -1;
#pragma omp parallel for schedule(static)
    for (long j = i + 1; j < n; ++j) eliminate_row(A, b, n, i, j);
  }
  back_substitute(A, b, x, n);
  return 0;
#else
  (void)nthreads;
  return gt_gauss_solve_seq(A, b, x, n);
#endif
}

// Fork-join engine (reference C1, Pthreads Version-1): threads are created
// and joined anew for EVERY pivot step — n*T thread spawns total. Kept for
// engine-taxonomy parity and as a benchmarkable demonstration of why the
// persistent-pool engine (gt_gauss_solve_threads) exists; the reference's own
// Version-3 draws the same conclusion.
int gt_gauss_solve_forkjoin(double* A, double* b, double* x, long n, int nthreads) {
  if (!A || !b || !x || n <= 0) return -2;
  if (nthreads < 1) nthreads = 1;
  for (long i = 0; i < n; ++i) {
    if (!pivot_and_scale(A, b, n, i)) return -1;
    std::vector<std::thread> pool;
    pool.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) {
      pool.emplace_back([&, t]() {
        for (long j = i + 1 + t; j < n; j += nthreads) eliminate_row(A, b, n, i, j);
      });
    }
    for (auto& th : pool) th.join();
  }
  back_substitute(A, b, x, n);
  return 0;
}

// Cache-tiled engine (reference C2, Pthreads Version-2): the elimination
// column range is processed in block_size chunks, all target rows visiting a
// chunk before advancing, keeping the pivot-row slice cache-resident
// (reference Version-2/gauss_internal_input.c:18,162-173 uses block_size=16;
// 64 doubles = one 512-byte prefetch-friendly run works better on modern
// cores). Persistent pool + barrier like the threads engine.
int gt_gauss_solve_tiled(double* A, double* b, double* x, long n, int nthreads) {
  if (!A || !b || !x || n <= 0) return -2;
  if (nthreads < 1) nthreads = 1;
  constexpr long kBlock = 64;

  std::atomic<bool> singular{false};
  Barrier sync(nthreads);

  auto worker = [&](int tid) {
    for (long i = 0; i < n; ++i) {
      if (tid == 0) {
        if (!pivot_and_scale(A, b, n, i)) singular.store(true);
      }
      sync.arrive_and_wait();
      if (singular.load()) return;
      const double* piv = A + i * n;
      // RHS update + multiplier capture first (the tiled passes destroy
      // column i last, mirroring the reference's deferred zeroing).
      for (long j = i + 1 + tid; j < n; j += nthreads) b[j] -= A[j * n + i] * b[i];
      for (long k0 = i; k0 < n; k0 += kBlock) {
        const long k1 = std::min(n, k0 + kBlock);
        for (long j = i + 1 + tid; j < n; j += nthreads) {
          double* tgt = A + j * n;
          const double f = tgt[i];
          if (f == 0.0) continue;
          for (long k = std::max(k0, i + 1); k < k1; ++k) tgt[k] -= f * piv[k];
        }
      }
      for (long j = i + 1 + tid; j < n; j += nthreads) A[j * n + i] = 0.0;
      sync.arrive_and_wait();
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker, t);
  for (auto& th : pool) th.join();
  if (singular.load()) return -1;
  back_substitute(A, b, x, n);
  return 0;
}

// CPU-affinity pinning for the persistent-pool engine, mirroring the
// reference C3's pthread_attr_setaffinity_np path: pin thread t to core t
// only when the pool fits the machine (Version-3/gauss_internal_input.c:
// 238,278-279,297-301). Linux-only; a no-op elsewhere.
static void pin_to_core(std::thread& th, int core, int nthreads) {
#ifdef __linux__
  // Respect the PROCESS affinity mask (taskset/cgroup cpusets), not raw
  // hardware_concurrency: pin thread t to the t-th ALLOWED core, and only
  // when the whole pool fits the allowed set — a partial pinning under a
  // restricted mask would skew measurements asymmetrically.
  cpu_set_t allowed;
  CPU_ZERO(&allowed);
  if (sched_getaffinity(0, sizeof(allowed), &allowed) != 0) return;
  std::vector<int> cores;
  for (int c = 0; c < CPU_SETSIZE; ++c)
    if (CPU_ISSET(c, &allowed)) cores.push_back(c);
  if (cores.empty() || nthreads > (int)cores.size()) return;
  cpu_set_t set;
  CPU_ZERO(&set);
  CPU_SET(cores[core % cores.size()], &set);
  pthread_setaffinity_np(th.native_handle(), sizeof(set), &set);
#else
  (void)th; (void)core; (void)nthreads;
#endif
}

int gt_gauss_solve_threads(double* A, double* b, double* x, long n, int nthreads) {
  if (!A || !b || !x || n <= 0) return -2;
  if (nthreads < 1) nthreads = 1;
  if (nthreads == 1) return gt_gauss_solve_seq(A, b, x, n);

  std::atomic<bool> singular{false};
  Barrier sync(nthreads);

  auto worker = [&](int tid) {
    for (long i = 0; i < n; ++i) {
      if (tid == 0) {
        if (!pivot_and_scale(A, b, n, i)) singular.store(true);
      }
      sync.arrive_and_wait();  // pivot row ready (or failure flagged)
      if (singular.load()) return;
      // Cyclic row striping, the reference C1/C3 load-balance scheme.
      for (long j = i + 1 + tid; j < n; j += nthreads) eliminate_row(A, b, n, i, j);
      sync.arrive_and_wait();  // all rows eliminated before the next pivot
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    pool.emplace_back(worker, t);
    pin_to_core(pool.back(), t, nthreads);
  }
  for (auto& th : pool) th.join();
  if (singular.load()) return -1;
  back_substitute(A, b, x, n);
  return 0;
}

void gt_matmul_seq(const double* A, const double* B, double* C, long n) {
  // i-k-j loop order: streams B rows, keeps C row hot — cache-friendly
  // without tiling (the reference's seq_matmul uses naive i-j-k).
  std::memset(C, 0, sizeof(double) * n * n);
  for (long i = 0; i < n; ++i) {
    double* crow = C + i * n;
    for (long k = 0; k < n; ++k) {
      const double a = A[i * n + k];
      const double* brow = B + k * n;
      for (long j = 0; j < n; ++j) crow[j] += a * brow[j];
    }
  }
}

void gt_matmul_omp(const double* A, const double* B, double* C, long n, int nthreads) {
#ifdef _OPENMP
  if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; ++i) {
    double* crow = C + i * n;
    std::memset(crow, 0, sizeof(double) * n);
    for (long k = 0; k < n; ++k) {
      const double a = A[i * n + k];
      const double* brow = B + k * n;
      for (long j = 0; j < n; ++j) crow[j] += a * brow[j];
    }
  }
#else
  (void)nthreads;
  gt_matmul_seq(A, B, C, n);
#endif
}

// ---- .dat coordinate-format I/O ------------------------------------------
// Format (reference matrix_gen.cc:13-22): header "n n nnz", 1-indexed body
// lines "row col value", optional "0 0 0" terminator. Whole-file buffered
// parse with strtol/strtod — ~50x faster than line-by-line Python for the
// larger dataset matrices (memplus: 126k entries).

namespace {

struct FileBuf {
  char* data = nullptr;
  size_t size = 0;
  ~FileBuf() { std::free(data); }
  bool read(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (sz < 0) {
      std::fclose(f);
      return false;
    }
    data = static_cast<char*>(std::malloc(sz + 1));
    if (!data) {
      std::fclose(f);
      return false;
    }
    size = std::fread(data, 1, sz, f);
    data[size] = '\0';
    std::fclose(f);
    return true;
  }
};

}  // namespace

int gt_dat_read_header(const char* path, long* n, long* nnz) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -2;
  long a = 0, b = 0, c = 0;
  int got = std::fscanf(f, "%ld %ld %ld", &a, &b, &c);
  std::fclose(f);
  if (got != 3 || a != b || a <= 0 || c < 0) return -3;
  *n = a;
  *nnz = c;
  return 0;
}

// out must hold n*n doubles; it is zero-filled then scattered into.
int gt_dat_read_dense(const char* path, double* out, long n) {
  FileBuf buf;
  if (!buf.read(path)) return -2;
  char* p = buf.data;
  char* end;
  long hn = std::strtol(p, &end, 10);
  p = end;
  long hn2 = std::strtol(p, &end, 10);
  p = end;
  long nnz = std::strtol(p, &end, 10);
  p = end;
  if (hn != n || hn2 != n || nnz < 0) return -3;
  std::memset(out, 0, sizeof(double) * n * n);
  long count = 0;
  while (count < nnz) {
    long r = std::strtol(p, &end, 10);
    if (end == p) break;  // EOF / garbage
    p = end;
    long c = std::strtol(p, &end, 10);
    p = end;
    double v = std::strtod(p, &end);
    p = end;
    if (r == 0 && c == 0) break;  // terminator
    if (r < 1 || r > n || c < 1 || c > n) return -4;
    out[(r - 1) * n + (c - 1)] = v;
    ++count;
  }
  if (count != nnz) return -5;
  return 0;
}

}  // extern "C"

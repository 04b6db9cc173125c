// Batched panel-factor kernel: partial-pivot LU of every member of a
// (B, h, panel) stack of column blocks, in one launch.
//
// Replaces: gauss_tpu/kernels/panel_pallas.py::panel_factor_pallas under
// jax.vmap, the form the block-diagonal lane runs
// (gauss_tpu/serve/cache.py, BatchedExecutable: jax.vmap of
// lu_factor_blocked over a (B, bucket, bucket) stack; a bucket is at most
// one panel wide there, so each member is one panel_factor_pallas call and
// the vmap makes them one batched kernel). The serving lanes launch it on
// the last panel of every batched factor: (B, 128, 128) for buckets of 128
// to 512, (B, 256, 256) for 1024 to 4096.
//
// Two step loops, chosen by the member's shape (gtt_batched_rule; the C
// launcher decides and reports the route it took, and
// kernels/panel.py::panel_batched_geometry mirrors the rule):
//
// 1. The register loop (routes "regs" and "cluster"), for members of up to
//    256 rows and 256 columns: every element of the member lives in a
//    register of one thread from the load to the store, and every thread
//    works every pivot step. A member is held by CS blocks of NW warps
//    (CS = 1: route "regs", one block; CS > 1: route "cluster", a thread
//    block cluster). Column-warp g = rank * NW + warp owns the columns
//    c = g + G k (G = CS * NW, k < CK) of ALL rows; lane l of it holds the
//    rows l + 32 i (i < RI). So the pivot row's values for a warp's
//    columns are in its own lane p % 32 (one shuffle each), and column j
//    lies in one warp. Pivot step j:
//      a. wait at the step's barrier (an mbarrier at CS = 1, the cluster
//         barrier at CS > 1), then read p, piv and this lane's rows'
//         multipliers from the step's buffer (double-buffered by parity);
//      b. the warp that owns column j + 1 updates that column first, finds
//         its argmax over live rows with two warp reductions (redux.sync
//         max of an order key, min of the row: the order of gtt_better),
//         divides the column by the pivot into the multipliers of step
//         j + 1 and writes them, p and piv into the other buffer of every
//         block of the member, then arrives; the other warps arrive as
//         soon as they have read the buffer;
//      c. every warp updates its other live columns (and the owner of
//         column j writes the multipliers into it).
//    One barrier a step, and no warp waits for another's update: the
//    barrier completes when the next column's owner has published it. The
//    buffer written in step j was last read in step j - 1, and every
//    thread arrives at the barrier of step j only after reading it.
//    Members are loaded through a 32-row stage in shared memory (coalesced
//    reads) and stored through it, already row-permuted (each row's final
//    position from a ballot a row group), with their gather indices: the
//    wrapper neither builds the permutation nor gathers the rows.
//
// 2. The one-block loop of panel_common.cuh (gtt_factor_panel, routes
//    "smem" and "global"), for taller members: one block per member, in
//    its shared memory where the transposed member fits there, else in
//    place in its slice of the global scratch, as the one-block kernel
//    does.
//
// Arithmetic contract (both loops): the elementwise operations of
// gtt_factor_panel, element by element — __fdiv_rn for the multiplier,
// __fmul_rn and __fsub_rn for the update (no FMA), done rows updated with
// m = 0, an inf/NaN multiplier touching the finished columns as 0 * m, a
// NaN pivot counted as 0 in min |pivot|. The order key is a total order
// equal to gtt_better's, so any reduction tree picks the same pivot. So
// every member is bit for bit the plain version
// (kernels/panel.py::panel_factor_plain) and the single-strip kernel 1.
//
// The bfloat16 forms (launch key panel_factor_batched_bf16) run the same
// loops at bfloat16 storage, each operation rounded to bfloat16 at once in
// the plain version's order (gtt_r); the register loop keeps the rounded
// values as float, which holds them exactly. They serve the lowered
// (bfloat16) lane's one-panel buckets and the last panel of its wider
// ones.
//
// What bounds it: each member is a chain of `panel` dependent pivot steps
// (the member's bytes and operations are microseconds of the card's
// rates). The register loop's step is one warp's column update, two warp
// reductions, one column's divisions and one barrier's arrive-to-wake
// latency (~1 us at one block, ~2 us across a cluster, measured); members
// run side by side on B * CS SMs.
#include <cooperative_groups.h>

#include "panel_common.cuh"

namespace gtt_bcg = cooperative_groups;

// Dynamic shared memory the old loop's in-smem route may take per block:
// the sm_90 opt-in maximum (227 KiB) less room for the step loop's static
// arrays.
#define GTT_BATCHED_SMEM_MAX (227 * 1024 - 8 * 1024)

// ---------------------------------------------------------------------------
// The one-block loop (routes "smem" and "global").

template <bool SMEM, typename T>
__device__ __forceinline__ void gtt_panel_batched_body(
    const T* __restrict__ src, long long sstride, int ld, int h, int panel,
    int kb, T* __restrict__ pt, int* __restrict__ ipiv, int* __restrict__ inv,
    int* __restrict__ chosen, T* __restrict__ minpiv) {
  extern __shared__ float4 gtt_batched_smem[];
  const int b = blockIdx.x;
  const size_t words = (size_t)panel * h;
  T* out = pt + (size_t)b * words;
  T* work = SMEM ? reinterpret_cast<T*>(gtt_batched_smem) : out;
  gtt_load_panel_t(src + (size_t)b * sstride, ld, h, panel, work);
  gtt_factor_panel(work, h, panel, kb, ipiv + (size_t)b * panel,
                   inv + (size_t)b * h, chosen + (size_t)b * h, minpiv + b);
  if (SMEM) {
    // gtt_factor_panel ends on a barrier: every step's stores are done.
    for (size_t e = threadIdx.x; e < words; e += blockDim.x) out[e] = work[e];
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(GTT_THREADS)
gtt_panel_batched_kernel(const float* __restrict__ src, long long sstride,
                         int ld, int h, int panel, int kb,
                         float* __restrict__ pt, int* __restrict__ ipiv,
                         int* __restrict__ inv, int* __restrict__ chosen,
                         float* __restrict__ minpiv) {
  gtt_panel_batched_body<SMEM>(src, sstride, ld, h, panel, kb, pt, ipiv, inv,
                               chosen, minpiv);
}

template <bool SMEM>
__global__ void __launch_bounds__(GTT_THREADS)
gtt_panel_batched_bf16_kernel(const gtt_bf16* __restrict__ src,
                              long long sstride, int ld, int h, int panel,
                              int kb, gtt_bf16* __restrict__ pt,
                              int* __restrict__ ipiv, int* __restrict__ inv,
                              int* __restrict__ chosen,
                              gtt_bf16* __restrict__ minpiv) {
  gtt_panel_batched_body<SMEM>(src, sstride, ld, h, panel, kb, pt, ipiv, inv,
                               chosen, minpiv);
}

// ---------------------------------------------------------------------------
// The register loop (routes "regs" and "cluster").

// The argmax order of gtt_better on |value| as one unsigned key: 0 for a
// done row (below every live one), |v|'s bits + 1 for a number (the bits
// of a non-negative float order as unsigned), above +inf one key for every
// NaN (the first NaN wins by the row). Ties go to the lower row.
__device__ __forceinline__ unsigned gtt_order_key(float v, bool done) {
  const float a = fabsf(v);
  return done ? 0u : (a != a ? 0x7f800002u : __float_as_uint(a) + 1u);
}

__device__ __forceinline__ unsigned gtt_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The step barrier, arrived at and waited on apart. At CS = 1 an
// mbarrier in shared memory that every warp arrives at once a step (lane
// 0, after __syncwarp, with release semantics); at CS > 1 the cluster
// barrier, every thread with release semantics. The mbarrier's wait spins
// on try_wait, looks at the clock every 4096 failed rounds and traps after
// GTT_STEP_WAIT_LIMIT_NS, so a fault ends in an error, not a hang.
#define GTT_STEP_WAIT_LIMIT_NS 20000000000ull

template <int CS>
__device__ __forceinline__ void gtt_step_arrive(unsigned long long* bar) {
  if constexpr (CS == 1) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0)
      asm volatile(
          "{\n\t.reg .b64 st;\n\t"
          "mbarrier.arrive.release.cta.shared::cta.b64 st, [%0];\n\t}"
          ::"r"(gtt_smem_addr(bar)) : "memory");
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
}

template <int CS>
__device__ __forceinline__ void gtt_step_wait(unsigned long long* bar,
                                              int parity) {
  if constexpr (CS == 1) {
    const unsigned addr = gtt_smem_addr(bar);
    unsigned long long t0 = 0;
    for (unsigned round = 1;; ++round) {
      unsigned ok;
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%1], "
          "%2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(ok) : "r"(addr), "r"(parity) : "memory");
      if (ok) return;
      if ((round & 4095u) == 0) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
        if (t0 == 0)
          t0 = t;
        else if (t - t0 > GTT_STEP_WAIT_LIMIT_NS)
          __trap();
      }
    }
  } else {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

// Dynamic shared memory of one block of the register loop: the step
// barrier, p and piv by step parity, the multipliers by parity (32 RI
// floats each), the step that chose each row, each row's final position
// and the 32-row stage of the load and the store.
__host__ __device__ inline size_t gtt_regs_smem_bytes(int ri, int panel) {
  return 32 + 4 * (size_t)(4 * 32 * ri) + 4 * (size_t)32 * (panel + 1);
}

// One member on CS blocks of NT threads (module comment, loop 1).
template <typename T, int RI, int CK, int CS, int NT>
__device__ __forceinline__ void gtt_regs_body(
    const T* __restrict__ src, long long sstride, int ld, int h, int panel,
    int kb, T* __restrict__ out, long long* __restrict__ perm,
    int* __restrict__ ipiv, T* __restrict__ minpiv) {
  constexpr int NW = NT / 32;
  constexpr int G = CS * NW;
  constexpr int HP = 32 * RI;
  extern __shared__ __align__(16) unsigned char gtt_regs_smem[];
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(gtt_regs_smem);
  int* s_p = reinterpret_cast<int*>(gtt_regs_smem + 8);         // [2]
  float* s_piv = reinterpret_cast<float*>(gtt_regs_smem + 16);  // [2]
  float* s_m = reinterpret_cast<float*>(gtt_regs_smem + 32);    // [2][HP]
  int* s_pos = reinterpret_cast<int*>(s_m + 2 * HP);            // [HP]
  int* s_dest = s_pos + HP;                                     // [HP]
  float* s_stage = reinterpret_cast<float*>(s_dest + HP);  // [32][panel+1]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int rank = 0;
  if constexpr (CS > 1) rank = (int)gtt_bcg::this_cluster().block_rank();
  const int b = blockIdx.x / CS;
  const int g = rank * NW + warp;
  const int live = (h + 31) >> 5;  // row groups that hold rows of the member
  const T* msrc = src + (size_t)b * sstride;

  // The thread's element of row group i in column slot k (k is a
  // constant wherever the loops are unrolled).
  float a[RI][CK];
  // Load: 32 rows at a time through the stage (row stride panel + 1 words,
  // so the lanes' reads of one column hit 32 banks).
  const int sld = panel + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    if (i < live) {
      const int r0 = 32 * i, nr = min(32, h - r0);
      for (int e = tid; e < nr * panel; e += NT) {
        const int rr = e / panel, c = e - rr * panel;
        s_stage[rr * sld + c] = gtt_f(msrc[(size_t)(r0 + rr) * ld + c]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < CK; ++k) {
        const int c = g + G * k;
        a[i][k] = (c < panel && lane < nr) ? s_stage[lane * sld + c] : 0.0f;
      }
      __syncthreads();
    } else {
#pragma unroll
      for (int k = 0; k < CK; ++k) a[i][k] = 0.0f;
    }
  }
  // Rows above the diagonal block and the pad rows are done from the start.
  unsigned done = 0;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = lane + 32 * i;
    if (r < kb || r >= h) done |= 1u << i;
  }
  for (int r = tid; r < HP; r += NT) s_pos[r] = -1;
  if constexpr (CS == 1) {
    if (tid == 0)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       gtt_smem_addr(bar)),
                   "r"(NW)
                   : "memory");
    __syncthreads();
  } else {
    gtt_bcg::this_cluster().sync();  // every block's buffers exist
  }

  // Column slot k's update by the multipliers m of step j, whose pivot row
  // p is lane p % 32's row group p / 32.
  auto update = [&](int k, const float (&m)[RI], int pi, int ps) {
    float x = a[0][k];
#pragma unroll
    for (int i = 1; i < RI; ++i) x = i == pi ? a[i][k] : x;
    const float u = __shfl_sync(0xffffffffu, x, ps);
#pragma unroll
    for (int i = 0; i < RI; ++i)
      if (i < live)
        a[i][k] = gtt_r<T>(__fsub_rn(a[i][k], gtt_r<T>(__fmul_rn(u, m[i]))));
  };
  // The owner warp of column jn (its slot k): its argmax over live rows
  // and the multipliers of step jn, into buffer jn % 2 of every block of
  // the member.
  auto publish = [&](int jn, int k) {
    const int par = jn & 1;
    float v[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) v[i] = a[i][k];
    unsigned key = 0u, row = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const unsigned kk =
          i < live ? gtt_order_key(v[i], (done >> i) & 1u) : 0u;
      if (kk > key) { key = kk; row = lane + 32 * i; }
    }
    const unsigned kmax = __reduce_max_sync(0xffffffffu, key);
    const int p = (int)__reduce_min_sync(0xffffffffu,
                                         key == kmax ? row : 0xffffffffu);
    float pv = v[0];
#pragma unroll
    for (int i = 1; i < RI; ++i) pv = i == (p >> 5) ? v[i] : pv;
    const float piv = __shfl_sync(0xffffffffu, pv, p & 31);
    float m[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const bool dn = ((done >> i) & 1u) || lane + 32 * i == p;
      m[i] = dn ? 0.0f : gtt_r<T>(__fdiv_rn(v[i], piv));
    }
#pragma unroll
    for (int t = 0; t < CS; ++t) {
      float* dm = s_m;
      int* dp = s_p;
      float* dpiv = s_piv;
      if constexpr (CS > 1) {
        gtt_bcg::cluster_group cl = gtt_bcg::this_cluster();
        dm = cl.map_shared_rank(s_m, t);
        dp = cl.map_shared_rank(s_p, t);
        dpiv = cl.map_shared_rank(s_piv, t);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
        if (i < live) dm[par * HP + lane + 32 * i] = m[i];
      if (lane == 0) {
        dp[par] = p;
        dpiv[par] = piv;
      }
    }
  };

  // Step jj's update of every live column right of jj but slot skip (the
  // column its owner updated first), and, where a multiplier is inf/NaN,
  // of the finished columns left of jj: the plain version subtracts
  // 0 * mult from those too, an identity unless the multiplier is inf/NaN.
  auto apply = [&](int jj, const float (&m)[RI], int pi, int ps, int skip) {
#pragma unroll
    for (int k = 0; k < CK; ++k) {
      const int c = g + G * k;
      if (c > jj && c < panel && k != skip) update(k, m, pi, ps);
    }
    bool odd = false;
#pragma unroll
    for (int i = 0; i < RI; ++i) odd |= !(fabsf(m[i]) <= FLT_MAX);
    if (odd) {
#pragma unroll
      for (int k = 0; k < CK; ++k) {
        if (g + G * k < jj) {
#pragma unroll
          for (int i = 0; i < RI; ++i)
            if (!(fabsf(m[i]) <= FLT_MAX))
              a[i][k] = gtt_r<T>(
                  __fsub_rn(a[i][k], gtt_r<T>(__fmul_rn(0.0f, m[i]))));
        }
      }
    }
  };

  if (g == 0) publish(0, 0);
  gtt_step_arrive<CS>(bar);
  float mp = INFINITY;
  for (int j = 0; j < panel; ++j) {
    const int par = j & 1;
    gtt_step_wait<CS>(bar, par);
    const int p = s_p[par];
    const float piv = s_piv[par];
    float m[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      m[i] = i < live ? s_m[par * HP + lane + 32 * i] : 0.0f;
    const int jn = j + 1;
    const bool owner_next = jn < panel && g == jn % G;
    const int kn = jn / G;
    // A warp that publishes nothing arrives as soon as it has read.
    if (jn < panel && !owner_next) gtt_step_arrive<CS>(bar);
    const int pi = p >> 5, ps = p & 31;
    if (ps == lane) done |= 1u << pi;
    if (tid == 0) {
      s_pos[p] = j;
      const float ap = fabsf(piv);
      mp = fminf(mp, ap != ap ? 0.0f : ap);
    }
    if (owner_next) {
#pragma unroll
      for (int k = 0; k < CK; ++k)
        if (k == kn) {
          update(k, m, pi, ps);
          publish(jn, k);
        }
      gtt_step_arrive<CS>(bar);
    }
    // Column j: its owner writes the multipliers into it (a done row keeps
    // its value).
    if (g == j % G) {
      const int kj = j / G;
#pragma unroll
      for (int k = 0; k < CK; ++k)
        if (k == kj) {
#pragma unroll
          for (int i = 0; i < RI; ++i)
            if (!((done >> i) & 1u)) a[i][k] = m[i];
        }
    }
    apply(j, m, pi, ps, owner_next ? kn : -1);
  }

  // Each row's final position (what the wrapper's perm_from_inv computes
  // from inv and chosen on the one-block loop's routes): a row above the
  // diagonal block stays, a pivot goes to kb + its step, an unchosen row
  // after the pivots in its original order (a ballot and a count a row
  // group, then the counts of the groups before it).
  __shared__ int s_cnt[8];
  __syncthreads();  // thread 0's step records
  const int r = 32 * warp + lane;
  const int st = r < h ? s_pos[r] : 0;
  const bool unch = r >= kb && r < h && st < 0;
  unsigned before = 0;
  if (warp < RI) {
    const unsigned ball = __ballot_sync(0xffffffffu, unch);
    if (lane == 0) s_cnt[warp] = __popc(ball);
    before = __popc(ball & ((1u << lane) - 1u));
  }
  __syncthreads();
  if (warp < RI && r < h) {
    int base = 0;
    for (int w = 0; w < warp; ++w) base += s_cnt[w];
    const int dest = r < kb ? r : st >= 0 ? kb + st
                                          : kb + panel + base + (int)before;
    s_dest[r] = dest;
    if (rank == 0) {
      perm[(size_t)b * h + dest] = r;
      if (st >= 0) ipiv[(size_t)b * panel + st] = r;
    }
  }
  if (rank == 0 && tid == 0) minpiv[b] = gtt_to<T>(mp);
  __syncthreads();
  // Store: the factored member row-permuted, a row group at a time through
  // the stage, each destination row written contiguously (a block writes
  // its own columns).
  T* dst = out + (size_t)b * h * panel;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    if (i < live) {
#pragma unroll
      for (int k = 0; k < CK; ++k) {
        const int c = g + G * k;
        if (c < panel) s_stage[lane * sld + c] = a[i][k];
      }
      __syncthreads();
      const int nr = min(32, h - 32 * i);
      for (int e = tid; e < nr * panel; e += NT) {
        const int rr = e / panel, c = e - rr * panel;
        if (CS == 1 || (c % G) / NW == rank)
          dst[(size_t)s_dest[32 * i + rr] * panel + c] =
              gtt_to<T>(s_stage[rr * sld + c]);
      }
      __syncthreads();
    }
  }
  // No block leaves while another may still arrive at its barriers.
  if constexpr (CS > 1) gtt_bcg::this_cluster().sync();
}

// The kernels by route and storage type (the names the traces show).
template <int RI, int CK, int NT>
__global__ void __launch_bounds__(NT, 1)
gtt_batched_regs_kernel(const float* __restrict__ src, long long sstride,
                        int ld, int h, int panel, int kb,
                        float* __restrict__ out, long long* __restrict__ perm,
                        int* __restrict__ ipiv, float* __restrict__ minpiv) {
  gtt_regs_body<float, RI, CK, 1, NT>(src, sstride, ld, h, panel, kb, out,
                                      perm, ipiv, minpiv);
}

template <int RI, int CK, int NT>
__global__ void __launch_bounds__(NT, 1)
gtt_batched_regs_bf16_kernel(const gtt_bf16* __restrict__ src,
                             long long sstride, int ld, int h, int panel,
                             int kb, gtt_bf16* __restrict__ out,
                             long long* __restrict__ perm,
                             int* __restrict__ ipiv,
                             gtt_bf16* __restrict__ minpiv) {
  gtt_regs_body<gtt_bf16, RI, CK, 1, NT>(src, sstride, ld, h, panel, kb, out,
                                         perm, ipiv, minpiv);
}

template <int RI, int CK, int CS, int NT>
__global__ void __launch_bounds__(NT, 1)
gtt_batched_cluster_kernel(const float* __restrict__ src, long long sstride,
                           int ld, int h, int panel, int kb,
                           float* __restrict__ out,
                           long long* __restrict__ perm,
                           int* __restrict__ ipiv,
                           float* __restrict__ minpiv) {
  gtt_regs_body<float, RI, CK, CS, NT>(src, sstride, ld, h, panel, kb, out,
                                       perm, ipiv, minpiv);
}

template <int RI, int CK, int CS, int NT>
__global__ void __launch_bounds__(NT, 1)
gtt_batched_cluster_bf16_kernel(const gtt_bf16* __restrict__ src,
                                long long sstride, int ld, int h, int panel,
                                int kb, gtt_bf16* __restrict__ out,
                                long long* __restrict__ perm,
                                int* __restrict__ ipiv,
                                gtt_bf16* __restrict__ minpiv) {
  gtt_regs_body<gtt_bf16, RI, CK, CS, NT>(src, sstride, ld, h, panel, kb,
                                          out, perm, ipiv, minpiv);
}

// ---------------------------------------------------------------------------
// The rule and the launcher.

// Route codes, as kernels/panel.py::BATCHED_ROUTES names them.
enum { GTT_ROUTE_GLOBAL = 0, GTT_ROUTE_SMEM = 1, GTT_ROUTE_REGS = 2,
       GTT_ROUTE_CLUSTER = 3 };

// The register loop's two mappings: rows a lane holds / 32 (RI), column
// slots a warp holds (CK), blocks a member (CS, the cluster route's) and
// threads a block (NT). A mapping holds members of up to 32 RI rows and
// CS NT / 32 CK columns. Chosen by measurement against the other mappings
// of the same reach (scripts/probe_panel_batched.py --forms builds and
// times them as edits of these two lines).
#define GTT_REGS_MAP 4, 8, 512         // (128, 128): one block of 16 warps
#define GTT_CLUSTER_MAP 8, 8, 4, 256   // (256, 256): 4 blocks of 8 warps
static constexpr int gtt_regs_map[] = {GTT_REGS_MAP};
static constexpr int gtt_cluster_map[] = {GTT_CLUSTER_MAP};

// The rule: the register loop on one block or a cluster for members they
// hold, else the one-block loop, in shared memory where the transposed
// member fits there. out[0] the route code, out[1] blocks a member, out[2]
// threads a block, out[3] dynamic shared memory bytes a block (0 on the
// global route).
static void gtt_batched_rule(int h, int panel, int itemsize, int* out) {
  const int* r = gtt_regs_map;
  const int* c = gtt_cluster_map;
  if (h <= 32 * r[0] && panel <= r[2] / 32 * r[1]) {
    out[0] = GTT_ROUTE_REGS;
    out[1] = 1;
    out[2] = r[2];
    out[3] = (int)gtt_regs_smem_bytes(r[0], panel);
  } else if (h <= 32 * c[0] && panel <= c[2] * c[3] / 32 * c[1]) {
    out[0] = GTT_ROUTE_CLUSTER;
    out[1] = c[2];
    out[2] = c[3];
    out[3] = (int)gtt_regs_smem_bytes(c[0], panel);
  } else {
    const size_t smem = (size_t)panel * h * itemsize;
    const bool fits = smem <= GTT_BATCHED_SMEM_MAX;
    out[0] = fits ? GTT_ROUTE_SMEM : GTT_ROUTE_GLOBAL;
    out[1] = 1;
    out[2] = GTT_THREADS;
    out[3] = fits ? (int)smem : 0;
  }
}

// What the launcher does with an (h, panel) member of `itemsize`-byte
// words (4: float32, 2: bfloat16): out as gtt_batched_rule writes it.
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int gtt_panel_batched_info(int h, int panel, int itemsize,
                                      int* out) {
  if (panel < 1 || panel > GTT_PANEL_MAX || h < 1 ||
      (itemsize != 4 && itemsize != 2))
    return (int)cudaErrorInvalidValue;
  gtt_batched_rule(h, panel, itemsize, out);
  return 0;
}

template <typename K, typename T>
static cudaError_t gtt_launch_regs(K kern, int cs, int nt, size_t smem,
                                   const T* src, long long sstride, int ld,
                                   int batch, int h, int panel, int kb,
                                   T* out, long long* perm, int* ipiv,
                                   T* minpiv, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cs);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kern, src, sstride, ld, h, panel, kb, out,
                            perm, ipiv, minpiv);
}

template <typename T, typename R, typename K>
static int gtt_batched_launch(R regs_kernel, R cluster_kernel, K smem_kernel,
                              K global_kernel, const T* src,
                              long long sstride, int ld, int batch, int h,
                              int panel, int kb, T* pt, int* ipiv, int* inv,
                              int* chosen, T* minpiv, T* out,
                              long long* perm, int* route, void* stream) {
  if (batch < 1 || kb < 0) return (int)cudaErrorInvalidValue;
  int geo[4];
  const int rc = gtt_panel_batched_info(h, panel, (int)sizeof(T), geo);
  if (rc) return rc;
  // Every output of the route taken must be given: nothing is launched
  // that would write through a null pointer.
  const bool regs = geo[0] == GTT_ROUTE_REGS || geo[0] == GTT_ROUTE_CLUSTER;
  if (!src || !ipiv || !minpiv || !route ||
      (regs ? !out || !perm : !pt || !inv || !chosen))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (regs) {
    e = gtt_launch_regs(geo[0] == GTT_ROUTE_REGS ? regs_kernel
                                                 : cluster_kernel,
                        geo[1], geo[2], (size_t)geo[3], src, sstride, ld,
                        batch, h, panel, kb, out, perm, ipiv, minpiv, s);
  } else if (geo[0] == GTT_ROUTE_SMEM) {
    e = cudaFuncSetAttribute(
        smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo[3]);
    if (e == cudaSuccess)
      smem_kernel<<<batch, GTT_THREADS, geo[3], s>>>(
          src, sstride, ld, h, panel, kb, pt, ipiv, inv, chosen, minpiv);
  } else {
    global_kernel<<<batch, GTT_THREADS, 0, s>>>(
        src, sstride, ld, h, panel, kb, pt, ipiv, inv, chosen, minpiv);
    e = cudaSuccess;
  }
  if (e != cudaSuccess) return (int)e;
  *route = geo[0];
  return (int)cudaGetLastError();
}

// src: B members of (h, panel), row stride ld, member stride sstride
// (elements). ipiv (B, panel) and minpiv (B) on every route. The register
// routes write out (B, h, panel), each factored member row-permuted, and
// perm (B, h), its gather indices; the one-block loop's routes write pt
// (B, panel, h), each member transposed in its original row order, and
// inv and chosen (B, h), from which the wrapper builds the permutation.
// The outputs of the route gtt_panel_batched_info names must be given
// (cudaErrorInvalidValue before any launch otherwise); the others may be
// null. route: the route code the launch took. Returns the launch's CUDA
// error.
extern "C" int gtt_panel_factor_batched(const float* src, long long sstride,
                                        int ld, int batch, int h, int panel,
                                        int kb, float* pt, int* ipiv,
                                        int* inv, int* chosen, float* minpiv,
                                        float* out, long long* perm,
                                        int* route, void* stream) {
  return gtt_batched_launch(gtt_batched_regs_kernel<GTT_REGS_MAP>,
                            gtt_batched_cluster_kernel<GTT_CLUSTER_MAP>,
                            gtt_panel_batched_kernel<true>,
                            gtt_panel_batched_kernel<false>, src, sstride, ld,
                            batch, h, panel, kb, pt, ipiv, inv, chosen,
                            minpiv, out, perm, route, stream);
}

// The same at bfloat16 storage: src, pt, out and minpiv are bfloat16, the
// step loops the bfloat16 ones.
extern "C" int gtt_panel_factor_batched_bf16(
    const gtt_bf16* src, long long sstride, int ld, int batch, int h,
    int panel, int kb, gtt_bf16* pt, int* ipiv, int* inv, int* chosen,
    gtt_bf16* minpiv, gtt_bf16* out, long long* perm, int* route,
    void* stream) {
  return gtt_batched_launch(gtt_batched_regs_bf16_kernel<GTT_REGS_MAP>,
                            gtt_batched_cluster_bf16_kernel<GTT_CLUSTER_MAP>,
                            gtt_panel_batched_bf16_kernel<true>,
                            gtt_panel_batched_bf16_kernel<false>, src,
                            sstride, ld, batch, h, panel, kb, pt, ipiv, inv,
                            chosen, minpiv, out, perm, route, stream);
}

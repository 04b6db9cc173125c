// Fused panel-factor + trailing-update kernel (kernel 2), and the
// standalone trailing kernel (kernel 3, the unfused pair's second launch).
//
// Replaces: gauss_tpu/kernels/panel_fused_pallas.py
//   - panel_trailing_fused_pallas (_fused_kernel, _trailing_tile_update):
//     gtt_fused_kernel below;
//   - trailing_update_pallas (_trailing_kernel): gtt_trailing_kernel below.
//
// What bounds it on the H100: phase A (the panel factor) is `panel`
// dependent pivot steps, latency-bound as in panel_cluster.cu; phase B
// (the trailing update) is 2*h*panel*ncols FLOPs of FP32 FMA over one read
// and one write of the trailing block: at h = 2048, panel = 256 about
// 1.9 GFLOP against ~30 MB, so FP32 CUDA-core throughput (67 TFLOP/s
// peak) bounds phase B, not memory. Phase B must fill the card's 132 SMs;
// one block per 32-column chunk (the previous design) gave it 8 to 56.
// Its serial part is the segments' forward substitutions on the pivot
// rows, `panel / fseg` of them one after another for each chunk.
//
// What the design does about it: ONE launch of 512-thread blocks that
// share work through counters in global memory (ctr, zeroed by the
// wrapper) instead of a grid-wide barrier:
//   - Phase A goes to the first cluster that starts (a ticket taken by
//     each cluster's rank 0). On the cluster route (gtt_cluster_size(h,
//     panel) > 0: every strip of the n=2048 path, C = 16 at panel 256) the
//     launch is a thread-block-cluster launch and that cluster runs the
//     panel_cluster.cuh step loop unchanged: load, factor, store. Taller
//     strips launch without clusters and one block runs the one-block loop
//     gtt_factor_panel. Either way the phase-A blocks then DERIVE the
//     (panel, h) multiplier record from the factored strip by the rule of
//     kernels/panel_fused.py::reconstruct_mult_pt (row r's value in column
//     j when r was still live at step j, else 0), so the record is what
//     the unfused pair reconstructs, and each block adds one to
//     ctr[FACTORED] with release semantics.
//   - Every block then takes jobs by ticket (ctr[JOB]) until none is left.
//     B1, job q < chunks: for the 64-column chunk q, the panel's pivot rows
//     alone walk the segments: the forward substitution of the segment's
//     rows (one thread a column, the rows in registers, for fseg <= 32;
//     one warp per four columns above), whose U rows go to the (panel,
//     chunks * 64) scratch u and are published at once (one more on
//     ctr[CHUNK + q], release); then the later pivot rows take T - acc,
//     the next segment's rows also into shared memory for its
//     substitution. B2, every later job: one (256 rows x 64 columns) tile
//     of the block, which runs the segments with the multipliers and U
//     staged in shared memory by a two-stage cp.async ring, 8 x 4 elements
//     a thread in registers, each segment's U copied once B1 has published
//     it: the tiles run a segment behind B1. At n=2048, kb = 0 that is
//     28 + 224 jobs for 112 blocks.
//   A block waits only for work whose ticket was taken earlier, by a block
//   that is running, so the launch cannot deadlock whatever the card holds
//   at once, and needs no grid-wide barrier. (The runtime does take
//   cudaLaunchAttributeCooperative beside a cluster dimension of 16 on the
//   H100, up to the 7 clusters it holds at once; a grid.sync() would make
//   every tile wait for every B1, and the flags do not.) The grid fills
//   the card: C * min(1 + ceil(jobs / C), clusters it holds at once) on
//   the cluster route, min(1 + jobs, SMs) on the one-block route.
//
// Arithmetic contract: every trailing element sees, per fseg-wide segment
// of steps in order, acc = the fmaf chain over the segment's steps from 0,
// then __fsub_rn(T, acc), and the segment's pivot rows then take U, where
// U is the forward substitution's own fmaf chains (each row's terms in
// step order from 0), the sequence of the previous one-block-per-chunk
// routine. Kernel 3 runs the same jobs from the caller's (mult, ipiv), so
// fused == panel + reconstruct_mult_pt + trailing, bit for bit, at
// matching fseg, on NaN and inf too.
//
// The bfloat16 forms (gtt_panel_fused_bf16 / gtt_fused_bf16_kernel and
// gtt_trailing_update_bf16 / gtt_trailing_bf16_kernel) take a bfloat16
// block: phase A is the bfloat16 step loop of either route (its strip is
// half the bytes, so the cluster route reaches 6,848 rows at panel 256),
// and phase B keeps the JAX kernel's precision contract: the multiplier
// record, the U rows and every accumulation stay float32 (the record and
// scratch are float32 at either storage); a segment's U is rounded to
// bfloat16 (ulow) when its forward substitution is done, before any row
// applies it, and every trailing element is rounded to bfloat16 once per
// segment, after __fsub_rn(T, acc). Tiles and pivot rows read and write
// bfloat16 and do the same float32 arithmetic as the float32 forms, so
// fused == pair bit for bit there too.
#include <mutex>

#include "panel_cluster.cuh"

#define GTT_FSEG_MAX 64  // widest trailing segment
#define GTT_TM 256       // rows of a B2 tile and of a B1 pivot-row pass
#define GTT_TN 64        // columns of a chunk (B1) and of a tile (B2)
// A wait longer than this is a fault (no phase lasts a fraction of it):
// the kernel traps, and the launch reports an error instead of hanging.
#define GTT_WAIT_LIMIT_NS 20000000000ull

// Counters (int32, zeroed before the launch); chunk q's flag at CHUNK + q.
enum { GTT_CTR_CLUSTER = 0, GTT_CTR_JOB = 1, GTT_CTR_FACTORED = 2,
       GTT_CTR_CHUNK = 3 };

template <typename T>
struct GttFusedArgs {
  T* block;      // (h, wtot) row-major, row stride ld, updated in place
  int ld, h, wtot, col0, kbrow, panel, fseg;
  T* pt;         // (panel, h): the factored panel, transposed (phase A)
  float* mult;   // (panel, h): the multiplier record (float32 at any T)
  int* ipiv;     // (panel,) pivot rows
  int* inv;      // (h,) phase A's outputs
  int* chosen;
  T* minpiv;
  float* u;      // (panel, chunks * GTT_TN): each chunk's U rows (B1)
  int* ctr;
  int chunks, row_tiles, rows;  // rows: of a phase-A cluster block
  int factored;  // phase-A arrivals the trailing jobs wait for (0: none)
};

__host__ __device__ inline int gtt_trailing_chunks(int wtot, int col0,
                                                   int panel) {
  const int n = wtot - col0 - panel;
  return n > 0 ? (n + GTT_TN - 1) / GTT_TN : 0;
}

// The trailing phase's shared memory: a ticket (4 words), the pivot rows
// (panel ints) and a tile's row steps (GTT_TM ints), padded to 4 words,
// then two stages of (fseg, GTT_TM) multipliers and (fseg, GTT_TN) U.
__host__ __device__ inline int gtt_trail_head_words(int panel) {
  return (4 + panel + GTT_TM + 3) & ~3;
}
__host__ __device__ inline size_t gtt_trailing_smem_bytes(int panel,
                                                          int fseg) {
  return 4 * ((size_t)gtt_trail_head_words(panel) +
              2 * (size_t)fseg * (GTT_TM + GTT_TN));
}

struct GttTrailSmem {
  int* ticket;
  int* piv;    // (panel,)
  int* rstep;  // (GTT_TM,) the step that chose each tile row, -1 if none
  float* stage;
};

__device__ inline GttTrailSmem gtt_trail_layout(float* dyn, int panel) {
  GttTrailSmem m;
  int* base = reinterpret_cast<int*>(dyn);
  m.ticket = base;
  m.piv = base + 4;
  m.rstep = m.piv + panel;
  m.stage = dyn + gtt_trail_head_words(panel);  // 16-byte aligned
  return m;
}

extern __shared__ float4 gtt_dyn4[];

// ---- synchronisation through global counters -----------------------------

__device__ __forceinline__ int gtt_ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long gtt_now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// One pause of a spin that began at t0 (0: now); traps past the limit.
__device__ __forceinline__ void gtt_pause(unsigned long long& t0) {
  if (t0 == 0) t0 = gtt_now_ns();
  __nanosleep(128);
  if (gtt_now_ns() - t0 > GTT_WAIT_LIMIT_NS) __trap();
}

// Block-wide: wait until *p >= target, then let every thread go on.
__device__ __forceinline__ void gtt_wait(const int* p, int target) {
  if (threadIdx.x == 0) {
    unsigned long long t0 = 0;
    while (gtt_ld_acquire(p) < target) gtt_pause(t0);
  }
  __syncthreads();
}

// Thread 0, after a block barrier that follows the block's writes: add
// one to *p with release semantics (the block's writes are seen by whoever
// acquires the new value).
__device__ __forceinline__ void gtt_release_add(int* p) {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  atomicAdd(p, 1);
}

// Block-wide: once the block's writes are done, add one to *p (release).
__device__ __forceinline__ void gtt_signal(int* p) {
  __syncthreads();
  if (threadIdx.x == 0) gtt_release_add(p);
}

// One 4-byte cp.async (zero-filled when !ok; src must still be mapped).
__device__ __forceinline__ void gtt_cp4(float* dst, const float* src,
                                        bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// One 16-byte cp.async through L2 only.
__device__ __forceinline__ void gtt_cp16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void gtt_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void gtt_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// ---- phase A: the multiplier record --------------------------------------

// A cluster block's rows of the record, from its factored rows and step
// record: mult[j][r] = the factored value at (r, j) when row r was live at
// step j (r >= kb, unchosen or chosen after j), else 0. Coalesced along
// each column, as gtt_cluster_store writes pt.
template <typename T>
__device__ void gtt_cluster_store_mult(const GttClusterStrip<T>& s, int h,
                                       float* __restrict__ mult) {
  const int total = s.nr * s.panel;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e / s.nr, rl = e - c * s.nr;
    const int st = s.step[rl];
    const bool live = s.row0 + rl >= s.kb && (st < 0 || st > c);
    mult[(size_t)c * h + s.row0 + rl] =
        live ? gtt_f(s.t[c * s.lds + rl]) : 0.0f;
  }
}

// The same record from the one-block loop's outputs (pt, inv, chosen).
template <typename T>
__device__ void gtt_block_store_mult(const T* __restrict__ pt, int h,
                                     int panel, int kb,
                                     const int* __restrict__ inv,
                                     const int* __restrict__ chosen,
                                     float* __restrict__ mult) {
  for (int j = 0; j < panel; ++j)
    for (int r = threadIdx.x; r < h; r += blockDim.x) {
      const bool live = r >= kb && (!chosen[r] || inv[r] > kb + j);
      mult[(size_t)j * h + r] = live ? gtt_f(pt[(size_t)j * h + r]) : 0.0f;
    }
}

// ---- phase B -------------------------------------------------------------

// acc[a][b] = the fmaf chain over i = 0 .. w-1, from 0, of
// m[i][8 tr + a] * u[i][4 tc + b]; m rows GTT_TM, u rows GTT_TN apart.
__device__ __forceinline__ void gtt_seg_chain(float (&acc)[8][4],
                                              const float* __restrict__ m,
                                              const float* __restrict__ u,
                                              int w, int tr, int tc) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  const float4* m4 = reinterpret_cast<const float4*>(m) + 2 * tr;
  const float4* u4 = reinterpret_cast<const float4*>(u) + tc;
#pragma unroll 2
  for (int i = 0; i < w; ++i) {
    const float4 ma = m4[i * (GTT_TM / 4)], mb = m4[i * (GTT_TM / 4) + 1];
    const float4 uu = u4[i * (GTT_TN / 4)];
    const float mv[8] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w};
    const float uv[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(mv[a], uv[b], acc[a][b]);
  }
}

// Forward substitution of one segment's w (<= 64) pivot rows through the
// unit lower coupling L[jj][i] = lt[i * GTT_TM + jj] (i < jj), for the
// chunk columns c4 + 16 j (j < 4), by one warp: lane l holds segment rows
// l and l + 32. Row jj's U0 is u0[jj * GTT_TN + c]; its U goes to
// su[jj * GTT_TN + c] and ug[jj * us + c]. Right-looking: once row i is
// final, every later row adds its term i, so each row's sum still runs
// over i ascending from 0 in one fmaf chain, and row jj > 0 takes U0 - sum
// (row 0 keeps U0). Selects, not branches, keep the warp converged. The
// rows leave rounded to the storage type T (ulow; an identity at float32).
template <typename T>
__device__ __forceinline__ void gtt_fsub_warp(const float* __restrict__ lt,
                                              const float* __restrict__ u0,
                                              float* __restrict__ su,
                                              float* __restrict__ ug, int us,
                                              int w, int c4, int lane) {
  float v[4][2], acc[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int jj = lane + 32 * hh;
      v[j][hh] = jj < w ? u0[jj * GTT_TN + c4 + 16 * j] : 0.0f;
      acc[j][hh] = 0.0f;
    }
  for (int i = 0; i < w; ++i) {
    const int src = i & 31;
    const bool hi = i >= 32;
    const bool own0 = lane == src && i > 0 && !hi, own1 = lane == src && hi;
    const float l0 = lt[i * GTT_TM + lane], l1 = lt[i * GTT_TM + lane + 32];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j][0] = own0 ? __fsub_rn(v[j][0], acc[j][0]) : v[j][0];
      v[j][1] = own1 ? __fsub_rn(v[j][1], acc[j][1]) : v[j][1];
      const float ui = __shfl_sync(0xffffffffu, hi ? v[j][1] : v[j][0], src);
      const float a0 = fmaf(l0, ui, acc[j][0]), a1 = fmaf(l1, ui, acc[j][1]);
      acc[j][0] = lane > i ? a0 : acc[j][0];
      acc[j][1] = lane + 32 > i ? a1 : acc[j][1];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int jj = lane + 32 * hh;
      if (jj < w) {
        const float ulow = gtt_r<T>(v[j][hh]);
        su[jj * GTT_TN + c4 + 16 * j] = ulow;
        ug[(size_t)jj * us + c4 + 16 * j] = ulow;
      }
    }
}

// The same substitution for w <= 32 rows, for chunk column c, by one
// thread: the segment's rows in registers, fully unrolled, the coupling
// read as float4 broadcasts. Row jj's chain takes its terms i = 0 .. jj-1
// in order, as in gtt_fsub_warp, in fewer instructions: the form the
// main path (fseg 32) runs.
template <typename T>
__device__ __forceinline__ void gtt_fsub_col32(const float* __restrict__ lt,
                                               const float* __restrict__ u0,
                                               float* __restrict__ su,
                                               float* __restrict__ ug, int us,
                                               int w, int c) {
  float v[32], acc[32];
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    v[jj] = jj < w ? u0[jj * GTT_TN + c] : 0.0f;
    acc[jj] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i >= w) break;
    if (i > 0) v[i] = __fsub_rn(v[i], acc[i]);
    const float4* l4 = reinterpret_cast<const float4*>(lt + i * GTT_TM);
#pragma unroll
    for (int q4 = (i + 1) / 4; q4 < 8; ++q4) {
      const float4 l = l4[q4];
      const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q4 + e > i)
          acc[4 * q4 + e] = fmaf(lv[e], v[i], acc[4 * q4 + e]);
    }
  }
#pragma unroll
  for (int jj = 0; jj < 32; ++jj)
    if (jj < w) {
      const float ulow = gtt_r<T>(v[jj]);
      su[jj * GTT_TN + c] = ulow;
      ug[(size_t)jj * us + c] = ulow;
    }
}

// A segment's forward substitution by the block (its U rows, rounded to
// T, in su and ug): one thread a column for fseg <= 32, else one warp per
// four columns.
template <typename T>
__device__ __forceinline__ void gtt_fsub(const float* __restrict__ lt,
                                         const float* __restrict__ u0,
                                         float* __restrict__ su,
                                         float* __restrict__ ug, int us,
                                         int w, int fseg) {
  if (fseg <= 32) {
    if (threadIdx.x < GTT_TN)
      gtt_fsub_col32<T>(lt, u0, su, ug, us, w, threadIdx.x);
  } else {
    gtt_fsub_warp<T>(lt, u0, su, ug, us, w, threadIdx.x >> 5,
                     threadIdx.x & 31);
  }
}

// B1: chunk q's U rows. The panel's pivot rows of the chunk are gathered
// into u, then per segment: the coupling and the later pivot rows'
// multipliers are gathered (GTT_TM pivot rows a pass; the first pass of
// the next segment is prefetched into the other stage while this one
// runs), the segment's rows are forward-substituted and published (one
// more on the chunk's flag), and the later pivot rows take T - acc: the
// sequence every trailing element sees, on the pivot rows alone. The next
// segment's rows also go to u0 in shared memory, where its forward
// substitution reads them. At bfloat16 the pivot rows are read from the
// block as float, and every T - acc is rounded to bfloat16.
template <typename T>
__device__ void gtt_pivot_rows(const GttFusedArgs<T>& a,
                               const GttTrailSmem& sm, int q) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int c0 = a.col0 + a.panel + q * GTT_TN;
  const int nc = min(GTT_TN, a.wtot - c0);
  const int us = a.chunks * GTT_TN;
  const int sfloats = a.fseg * (GTT_TM + GTT_TN);
  const int nseg = (a.panel + a.fseg - 1) / a.fseg;
  float* ug = a.u + q * GTT_TN;
  float* su = sm.stage + a.fseg * GTT_TM;  // stage 0's U rows
  float* u0 = su + sfloats;                // stage 1's U rows
  int* flag = a.ctr + GTT_CTR_CHUNK + q;

  // The multipliers of pivot rows k0 .. k0 + GTT_TM at segment si's steps
  // (0 past the panel), by 4-byte copies.
  auto gather = [&](float* lt, int si, int k0) {
    const int s0 = si * a.fseg, w = min(a.fseg, a.panel - s0);
    for (int e = tid; e < w * GTT_TM; e += nt) {
      const int i = e / GTT_TM, k = k0 + e - i * GTT_TM;
      const bool ok = k < a.panel;
      gtt_cp4(lt + e,
              ok ? a.mult + (size_t)(s0 + i) * a.h + sm.piv[k] : a.mult, ok);
    }
    gtt_cp_commit();
  };

  for (int k = tid; k < a.panel; k += nt) sm.piv[k] = __ldcg(a.ipiv + k);
  __syncthreads();
  gather(sm.stage, 0, 0);
  // The pivot rows of the chunk, 8 loads in flight a thread; the first
  // segment's also to u0 (zero past the panel).
  for (int e0 = tid; e0 < GTT_PANEL_MAX * GTT_TN; e0 += 8 * nt) {
    if (e0 >= max(a.panel, a.fseg) * GTT_TN) break;
    float v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int e = e0 + m * nt, k = e / GTT_TN, c = e - k * GTT_TN;
      v[m] = k < a.panel && c < nc
                 ? gtt_f(a.block[(size_t)sm.piv[k] * a.ld + c0 + c]) : 0.0f;
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int e = e0 + m * nt, k = e / GTT_TN, c = e - k * GTT_TN;
      if (k < a.panel) ug[(size_t)k * us + c] = v[m];
      if (k < a.fseg) u0[e] = v[m];
    }
  }
  for (int si = 0; si < nseg; ++si) {
    const int s0 = si * a.fseg, w = min(a.fseg, a.panel - s0);
    const int s1 = s0 + w, w1 = min(a.fseg, a.panel - s1);
    float* lt = sm.stage + (si & 1) * sfloats;
    if (si + 1 < nseg) {
      gather(sm.stage + ((si + 1) & 1) * sfloats, si + 1, s1);
      gtt_cp_wait<1>();
    } else {
      gtt_cp_wait<0>();
    }
    __syncthreads();  // lt is in; u0 holds the segment's rows
    gtt_fsub<T>(lt, u0, su, ug + (size_t)s0 * us, us, w, a.fseg);
    __syncthreads();
    if (tid == 0) gtt_release_add(flag);  // the segment's U rows, to tiles
    for (int k0 = s0; k0 < a.panel; k0 += GTT_TM) {
      if (k0 > s0) {
        __syncthreads();  // every read of lt's last pass is done
        gather(lt, si, k0);
        gtt_cp_wait<0>();
        __syncthreads();
      }
      const int k = k0 + 8 * tr;  // the thread's first row
      if (k + 7 < s1 || k >= a.panel) continue;
      float4 t[8];
#pragma unroll
      for (int ra = 0; ra < 8; ++ra)
        if (k + ra >= s1 && k + ra < a.panel)
          t[ra] = reinterpret_cast<const float4*>(ug + (size_t)(k + ra) *
                                                  us)[tc];
      float acc[8][4];
      gtt_seg_chain(acc, lt, su, w, tr, tc);
#pragma unroll
      for (int ra = 0; ra < 8; ++ra) {
        const int kr = k + ra;
        if (kr >= s1 && kr < a.panel) {
          t[ra].x = gtt_r<T>(__fsub_rn(t[ra].x, acc[ra][0]));
          t[ra].y = gtt_r<T>(__fsub_rn(t[ra].y, acc[ra][1]));
          t[ra].z = gtt_r<T>(__fsub_rn(t[ra].z, acc[ra][2]));
          t[ra].w = gtt_r<T>(__fsub_rn(t[ra].w, acc[ra][3]));
          reinterpret_cast<float4*>(ug + (size_t)kr * us)[tc] = t[ra];
          if (kr < s1 + w1)
            reinterpret_cast<float4*>(u0 + (kr - s1) * GTT_TN)[tc] = t[ra];
        }
      }
    }
    __syncthreads();  // lt's stage is refilled two segments on
  }
}

// B2: rows [rt * GTT_TM, +GTT_TM) x chunk q's columns of the block.
template <typename T>
__device__ void gtt_trailing_tile(const GttFusedArgs<T>& a,
                                  const GttTrailSmem& sm, int q, int rt) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int c0 = a.col0 + a.panel + q * GTT_TN;
  const int nc = min(GTT_TN, a.wtot - c0);
  const int r0 = rt * GTT_TM;
  const int us = a.chunks * GTT_TN;
  const float* ug = a.u + q * GTT_TN;
  const int sfloats = a.fseg * (GTT_TM + GTT_TN);
  const int nseg = (a.panel + a.fseg - 1) / a.fseg;
  unsigned long long t_wait = 0;

  auto stage = [&](int si) {
    const int s0 = si * a.fseg, w = min(a.fseg, a.panel - s0);
    float* dm = sm.stage + (si & 1) * sfloats;
    float* du = dm + a.fseg * GTT_TM;
    for (int e = tid; e < w * GTT_TM; e += nt) {
      const int i = e / GTT_TM, rr = e - i * GTT_TM;
      const bool ok = r0 + rr < a.h;
      gtt_cp4(dm + e, ok ? a.mult + (size_t)(s0 + i) * a.h + r0 + rr : a.mult,
              ok);
    }
    for (int e = tid; e < w * (GTT_TN / 4); e += nt) {
      const int i = e / (GTT_TN / 4), c = 4 * (e - i * (GTT_TN / 4));
      gtt_cp16(du + i * GTT_TN + c, ug + (size_t)(s0 + i) * us + c);
    }
    gtt_cp_commit();
  };

  // Thread 0's last reading of the chunk's flag: B1's published segments.
  const int* flag = a.ctr + GTT_CTR_CHUNK + q;
  int seen = 0;
  if (tid == 0)
    while ((seen = gtt_ld_acquire(flag)) < 1) gtt_pause(t_wait);
  for (int rr = tid; rr < GTT_TM; rr += nt) sm.rstep[rr] = -1;
  __syncthreads();
  stage(0);
  for (int k = tid; k < a.panel; k += nt) {
    const int rr = __ldcg(a.ipiv + k) - r0;
    if (rr >= 0 && rr < GTT_TM) sm.rstep[rr] = k;
  }
  float t[8][4];
#pragma unroll
  for (int ra = 0; ra < 8; ++ra) {
    const int r = r0 + 8 * tr + ra;
    const T* row = a.block + (size_t)r * a.ld + c0 + 4 * tc;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      t[ra][b] = r < a.h && 4 * tc + b < nc ? gtt_f(row[b]) : 0.0f;
  }
  for (int si = 0; si < nseg; ++si) {
    const int s0 = si * a.fseg, w = min(a.fseg, a.panel - s0);
    if (si + 1 < nseg) {
      // Segment si + 1's U rows must be published before they are copied:
      // thread 0 polls once, and the block waits only when B1 is behind.
      if (tid == 0 && seen < si + 2) seen = gtt_ld_acquire(flag);
      if (__syncthreads_or(tid == 0 && seen < si + 2)) {
        if (tid == 0)
          while ((seen = gtt_ld_acquire(flag)) < si + 2) gtt_pause(t_wait);
        __syncthreads();
      }
      stage(si + 1);
      gtt_cp_wait<1>();
    } else {
      gtt_cp_wait<0>();
    }
    __syncthreads();
    const float* dm = sm.stage + (si & 1) * sfloats;
    const float* du = dm + a.fseg * GTT_TM;
    float acc[8][4];
    gtt_seg_chain(acc, dm, du, w, tr, tc);
#pragma unroll
    for (int ra = 0; ra < 8; ++ra) {
      const int k = sm.rstep[8 * tr + ra] - s0;
      if (k >= 0 && k < w) {
        const float4 uu =
            reinterpret_cast<const float4*>(du + k * GTT_TN)[tc];
        t[ra][0] = uu.x;
        t[ra][1] = uu.y;
        t[ra][2] = uu.z;
        t[ra][3] = uu.w;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          t[ra][b] = gtt_r<T>(__fsub_rn(t[ra][b], acc[ra][b]));
      }
    }
    __syncthreads();  // this stage is refilled two segments on
  }
#pragma unroll
  for (int ra = 0; ra < 8; ++ra) {
    const int r = r0 + 8 * tr + ra;
    T* row = a.block + (size_t)r * a.ld + c0 + 4 * tc;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (r < a.h && 4 * tc + b < nc) row[b] = gtt_to<T>(t[ra][b]);
  }
}

// Take jobs until none is left: B1 of chunk q for tickets q < chunks
// (after phase A), then the B2 tiles chunk by chunk, each segment after
// its chunk's B1 has published that segment's U rows.
template <typename T>
__device__ void gtt_trailing_jobs(const GttFusedArgs<T>& a,
                                  const GttTrailSmem& sm) {
  const int jobs = a.chunks * (1 + a.row_tiles);
  for (;;) {
    __syncthreads();  // the previous ticket has been read
    if (threadIdx.x == 0) *sm.ticket = atomicAdd(a.ctr + GTT_CTR_JOB, 1);
    __syncthreads();
    const int job = *sm.ticket;
    if (job >= jobs) return;
    if (job < a.chunks) {
      if (a.factored) gtt_wait(a.ctr + GTT_CTR_FACTORED, a.factored);
      gtt_pivot_rows(a, sm, job);
    } else {
      const int t = job - a.chunks, q = t / a.row_tiles;
      gtt_trailing_tile(a, sm, q, t - q * a.row_tiles);
    }
  }
}

// ---- the kernels ---------------------------------------------------------

// CLUSTER: launched with a cluster dimension; phase A on the cluster step
// loop. Else launched without clusters; phase A on the one-block loop.
template <bool CLUSTER, typename T>
__device__ __forceinline__ void gtt_fused_body(const GttFusedArgs<T>& a) {
  float* dyn = reinterpret_cast<float*>(gtt_dyn4);
  const GttTrailSmem sm = gtt_trail_layout(dyn, a.panel);
  bool first;
  if constexpr (CLUSTER) {
    gtt_cg::cluster_group cl = gtt_cg::this_cluster();
    if (cl.block_rank() == 0 && threadIdx.x == 0)
      *sm.ticket = atomicAdd(a.ctr + GTT_CTR_CLUSTER, 1);
    cl.sync();
    first = *cl.map_shared_rank(sm.ticket, 0) == 0;
    cl.sync();  // read before phase A or a job overwrites rank 0's word
  } else {
    if (threadIdx.x == 0) *sm.ticket = atomicAdd(a.ctr + GTT_CTR_CLUSTER, 1);
    __syncthreads();
    first = *sm.ticket == 0;
  }
  if (first) {
    if constexpr (CLUSTER) {
      const int rank = (int)gtt_cg::this_cluster().block_rank();
      const GttClusterStrip<T> s =
          gtt_cluster_layout<T>(dyn, a.h, a.panel, a.kbrow, a.rows, rank);
      gtt_cluster_load(s, a.block + a.col0, a.ld);
      const float minp = gtt_cluster_factor(s, a.ipiv);
      gtt_cluster_store(s, a.h, a.pt, a.inv, a.chosen);
      gtt_cluster_store_mult(s, a.h, a.mult);
      if (rank == 0 && threadIdx.x == 0) *a.minpiv = gtt_to<T>(minp);
    } else {
      gtt_load_panel_t(a.block + a.col0, a.ld, a.h, a.panel, a.pt);
      gtt_factor_panel(a.pt, a.h, a.panel, a.kbrow, a.ipiv, a.inv, a.chosen,
                       a.minpiv);
      __syncthreads();
      gtt_block_store_mult(a.pt, a.h, a.panel, a.kbrow, a.inv, a.chosen,
                           a.mult);
    }
    gtt_signal(a.ctr + GTT_CTR_FACTORED);
  }
  gtt_trailing_jobs(a, sm);
}

template <bool CLUSTER>
__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_fused_kernel(const GttFusedArgs<float> a) {
  gtt_fused_body<CLUSTER>(a);
}

template <bool CLUSTER>
__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_fused_bf16_kernel(const GttFusedArgs<gtt_bf16> a) {
  gtt_fused_body<CLUSTER>(a);
}

__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_trailing_kernel(const GttFusedArgs<float> a) {
  gtt_trailing_jobs(a, gtt_trail_layout(reinterpret_cast<float*>(gtt_dyn4),
                                        a.panel));
}

__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_trailing_bf16_kernel(const GttFusedArgs<gtt_bf16> a) {
  gtt_trailing_jobs(a, gtt_trail_layout(reinterpret_cast<float*>(gtt_dyn4),
                                        a.panel));
}

// The kernels of a storage type: fused on the cluster route, fused on the
// one-block route, trailing.
template <typename T>
struct GttFusedKernels;
template <>
struct GttFusedKernels<float> {
  static const void* get(int kind) {
    return kind == 0   ? (const void*)gtt_fused_kernel<true>
           : kind == 1 ? (const void*)gtt_fused_kernel<false>
                       : (const void*)gtt_trailing_kernel;
  }
};
template <>
struct GttFusedKernels<gtt_bf16> {
  static const void* get(int kind) {
    return kind == 0   ? (const void*)gtt_fused_bf16_kernel<true>
           : kind == 1 ? (const void*)gtt_fused_bf16_kernel<false>
                       : (const void*)gtt_trailing_bf16_kernel;
  }
};

// ---- launchers -----------------------------------------------------------

// The launch geometry (kernels/panel_fused.py::fused_geometry states it in
// Python); a cluster size of 0 sends phase A to the one-block loop.
struct GttFusedGeom {
  int cluster, rows, grid, chunks, row_tiles;
  size_t smem;
};

static GttFusedGeom gtt_fused_geom(int h, int wtot, int col0, int panel,
                                   int fseg, int itemsize) {
  GttFusedGeom g;
  g.cluster = gtt_cluster_size(h, panel, itemsize);
  g.chunks = gtt_trailing_chunks(wtot, col0, panel);
  g.row_tiles = (h + GTT_TM - 1) / GTT_TM;
  const size_t tb = gtt_trailing_smem_bytes(panel, fseg);
  if (g.cluster > 0) {
    g.rows = (h + g.cluster - 1) / g.cluster;
    const size_t sa = gtt_cluster_smem_bytes(g.rows, panel, itemsize);
    g.smem = sa > tb ? sa : tb;
  } else {
    g.rows = h;
    g.smem = tb;
  }
  g.grid = 0;
  return g;
}

// The grid: on the cluster route C * min(1 + ceil(jobs / C), fit), phase
// A's cluster and then a block per job, no more clusters than the card
// holds at once; on the one-block route min(1 + jobs, sms).
static void gtt_fused_grid(GttFusedGeom& g, int fit, int sms) {
  const int jobs = g.chunks * (1 + g.row_tiles);
  if (g.cluster > 0) {
    const int c = g.cluster, want = 1 + (jobs + c - 1) / c;
    g.grid = c * (want < fit ? want : fit);
  } else {
    g.grid = 1 + jobs < sms ? 1 + jobs : sms;
  }
}

static int gtt_check(int h, int wtot, int col0, int panel, int fseg) {
  if (h < 1 || panel < 1 || panel > GTT_PANEL_MAX || fseg < 1 ||
      fseg > GTT_FSEG_MAX || col0 < 0 || col0 + panel > wtot)
    return (int)cudaErrorInvalidValue;
  return 0;
}

static int gtt_sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

static cudaLaunchConfig_t gtt_fused_config(const GttFusedGeom& g,
                                           cudaStream_t st,
                                           cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.grid);
  cfg.blockDim = dim3(GTT_THREADS);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel of (kind, itemsize): kind 0 fused on the cluster route, 1
// fused on the one-block route, 2 trailing.
static const void* gtt_fused_kernel_of(int kind, int itemsize) {
  return itemsize == 2 ? GttFusedKernels<gtt_bf16>::get(kind)
                       : GttFusedKernels<float>::get(kind);
}

// How many of the launch's clusters (cluster route) or blocks per SM
// (otherwise) the card holds at once; 0: none fits. Sets the kernels'
// attributes on first use and caches each answer in a small table.
static int gtt_fused_fit(int kind, int itemsize, const GttFusedGeom& g,
                         int* fit) {
  static std::mutex mu;
  static bool attrs_set = false;
  static long long keys[64];
  static int vals[64];
  static int used = 0;
  std::lock_guard<std::mutex> lock(mu);
  const long long key = (long long)kind << 56 | (long long)itemsize << 52 |
                        (long long)g.cluster << 40 | (long long)g.smem;
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) { *fit = vals[i]; return 0; }
  cudaError_t e;
  if (!attrs_set) {
    // The cluster kernels may need a whole block's shared memory for their
    // strip; the others at most the trailing jobs' widest.
    const int most[] = {GTT_SMEM_MAX,
                        (int)gtt_trailing_smem_bytes(GTT_PANEL_MAX,
                                                     GTT_FSEG_MAX),
                        (int)gtt_trailing_smem_bytes(GTT_PANEL_MAX,
                                                     GTT_FSEG_MAX)};
    for (int size : {4, 2}) {
      for (int k = 0; k < 3; ++k) {
        e = cudaFuncSetAttribute(gtt_fused_kernel_of(k, size),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most[k]);
        if (e != cudaSuccess) return (int)e;
      }
      e = cudaFuncSetAttribute(gtt_fused_kernel_of(0, size),
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
      if (e != cudaSuccess) return (int)e;
    }
    attrs_set = true;
  }
  int n = 0;
  if (kind == 0) {
    GttFusedGeom one = g;
    one.grid = g.cluster;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = gtt_fused_config(one, 0, &attr);
    e = cudaOccupancyMaxActiveClusters(&n, gtt_fused_kernel_of(0, itemsize),
                                       &cfg);
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, gtt_fused_kernel_of(kind, itemsize), GTT_THREADS, g.smem);
  }
  if (e != cudaSuccess) return (int)e;
  if (used < 64) {
    keys[used] = key;
    vals[used] = n;
    ++used;
  }
  *fit = n;
  return 0;
}

// The launch of a fused call: cudaErrorLaunchOutOfResources when the card
// holds no such cluster or block, else 0 with the geometry in *g and, in
// *fit, the clusters the card holds at once (cluster route) or the blocks
// an SM holds (one-block route).
static int gtt_fused_plan(int h, int wtot, int col0, int panel, int fseg,
                          int itemsize, GttFusedGeom* g, int* fit) {
  int sms = 0;
  int rc = gtt_sm_count(&sms);
  if (rc) return rc;
  *g = gtt_fused_geom(h, wtot, col0, panel, fseg, itemsize);
  rc = gtt_fused_fit(g->cluster > 0 ? 0 : 1, itemsize, *g, fit);
  if (rc) return rc;
  if (*fit < 1) return (int)cudaErrorLaunchOutOfResources;
  gtt_fused_grid(*g, *fit, sms);
  return 0;
}

// The launch facts of a fused call on a block of `itemsize`-byte elements
// (4: float32, 2: bfloat16): out[0] the cluster size (0 on the one-block
// route), out[1] rows per phase-A block, out[2] the grid, out[3] dynamic
// shared memory bytes per block, out[4] column chunks, out[5] row tiles,
// out[6] clusters the card holds at once (cluster route) or blocks an SM
// holds (one-block route).
extern "C" int gtt_panel_fused_info(int h, int wtot, int col0, int panel,
                                    int fseg, int itemsize, int* out) {
  const int bad = gtt_check(h, wtot, col0, panel, fseg);
  if (bad) return bad;
  if (itemsize != 4 && itemsize != 2) return (int)cudaErrorInvalidValue;
  GttFusedGeom g;
  const int rc =
      gtt_fused_plan(h, wtot, col0, panel, fseg, itemsize, &g, &out[6]);
  if (rc) return rc;
  out[0] = g.cluster;
  out[1] = g.rows;
  out[2] = g.grid;
  out[3] = (int)g.smem;
  out[4] = g.chunks;
  out[5] = g.row_tiles;
  return 0;
}

template <typename T>
static int gtt_fused_launch(T* block, int ld, int h, int wtot, int col0,
                            int kbrow, int panel, int fseg, T* pt,
                            float* mult, int* ipiv, int* inv, int* chosen,
                            T* minpiv, float* u, int* ctr, void* stream) {
  int bad = gtt_check(h, wtot, col0, panel, fseg);
  if (bad) return bad;
  if (kbrow < 0 || h - kbrow < panel) return (int)cudaErrorInvalidValue;
  const int itemsize = (int)sizeof(T);
  GttFusedGeom g;
  int fit = 0;
  bad = gtt_fused_plan(h, wtot, col0, panel, fseg, itemsize, &g, &fit);
  if (bad) return bad;
  const GttFusedArgs<T> a = {block, ld, h, wtot, col0, kbrow, panel, fseg,
                             pt, mult, ipiv, inv, chosen, minpiv, u, ctr,
                             g.chunks, g.row_tiles, g.rows,
                             g.cluster > 0 ? g.cluster : 1};
  void* args[] = {(void*)&a};
  cudaError_t e;
  if (g.cluster > 0) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        gtt_fused_config(g, (cudaStream_t)stream, &attr);
    e = cudaLaunchKernelExC(&cfg, gtt_fused_kernel_of(0, itemsize), args);
  } else {
    e = cudaLaunchKernel(gtt_fused_kernel_of(1, itemsize), dim3(g.grid),
                         dim3(GTT_THREADS), args, g.smem,
                         (cudaStream_t)stream);
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// block: (h, wtot) row-major, row stride ld, updated IN PLACE right of
// col0 + panel. pt: (panel, h); mult: (panel, h) float32; ipiv (panel,);
// inv, chosen (h,); minpiv (1,); u: (panel, chunks * 64) float32 scratch;
// ctr: (3 + chunks,) int32, ZEROED. Returns cudaErrorLaunchOutOfResources
// when the card holds no such cluster or block, else the launch's error
// code.
extern "C" int gtt_panel_fused(float* block, int ld, int h, int wtot,
                               int col0, int kbrow, int panel, int fseg,
                               float* pt, float* mult, int* ipiv, int* inv,
                               int* chosen, float* minpiv, float* u,
                               int* ctr, void* stream) {
  return gtt_fused_launch(block, ld, h, wtot, col0, kbrow, panel, fseg, pt,
                          mult, ipiv, inv, chosen, minpiv, u, ctr, stream);
}

// The same at bfloat16 storage: block, pt and minpiv are bfloat16; mult
// and u stay float32.
extern "C" int gtt_panel_fused_bf16(gtt_bf16* block, int ld, int h, int wtot,
                                    int col0, int kbrow, int panel, int fseg,
                                    gtt_bf16* pt, float* mult, int* ipiv,
                                    int* inv, int* chosen, gtt_bf16* minpiv,
                                    float* u, int* ctr, void* stream) {
  return gtt_fused_launch(block, ld, h, wtot, col0, kbrow, panel, fseg, pt,
                          mult, ipiv, inv, chosen, minpiv, u, ctr, stream);
}

// The unfused pair's trailing launch: the same jobs as the fused kernel's
// phase B, from the caller's (panel, h) float32 multipliers and pivot
// rows. u and ctr as for gtt_panel_fused. No launch when nothing lies
// right of the panel.
template <typename T>
static int gtt_trailing_launch(T* block, int ld, int h, int wtot, int col0,
                               int panel, int fseg, const float* mult,
                               const int* ipiv, float* u, int* ctr,
                               void* stream) {
  int bad = gtt_check(h, wtot, col0, panel, fseg);
  if (bad) return bad;
  int sms = 0;
  bad = gtt_sm_count(&sms);
  if (bad) return bad;
  const int itemsize = (int)sizeof(T);
  GttFusedGeom g = gtt_fused_geom(h, wtot, col0, panel, fseg, itemsize);
  const int jobs = g.chunks * (1 + g.row_tiles);
  if (jobs < 1) return 0;
  g.cluster = 0;
  g.smem = gtt_trailing_smem_bytes(panel, fseg);
  g.grid = jobs < sms ? jobs : sms;
  int fit = 0;
  bad = gtt_fused_fit(2, itemsize, g, &fit);
  if (bad) return bad;
  if (fit < 1) return (int)cudaErrorLaunchOutOfResources;
  const GttFusedArgs<T> a = {block, ld, h, wtot, col0, 0, panel, fseg,
                             nullptr, const_cast<float*>(mult),
                             const_cast<int*>(ipiv), nullptr, nullptr,
                             nullptr, u, ctr, g.chunks, g.row_tiles, 0, 0};
  void* args[] = {(void*)&a};
  const cudaError_t e =
      cudaLaunchKernel(gtt_fused_kernel_of(2, itemsize), dim3(g.grid),
                       dim3(GTT_THREADS), args, g.smem, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int gtt_trailing_update(float* block, int ld, int h, int wtot,
                                   int col0, int panel, int fseg,
                                   const float* mult, const int* ipiv,
                                   float* u, int* ctr, void* stream) {
  return gtt_trailing_launch(block, ld, h, wtot, col0, panel, fseg, mult,
                             ipiv, u, ctr, stream);
}

// The same at bfloat16 storage (mult stays float32).
extern "C" int gtt_trailing_update_bf16(gtt_bf16* block, int ld, int h,
                                        int wtot, int col0, int panel,
                                        int fseg, const float* mult,
                                        const int* ipiv, float* u, int* ctr,
                                        void* stream) {
  return gtt_trailing_launch(block, ld, h, wtot, col0, panel, fseg, mult,
                             ipiv, u, ctr, stream);
}

// The cluster-resident pivot-step loop: partial-pivot LU of one (h, panel)
// strip held in the shared memory of one thread-block cluster.
//
// Block b of a cluster of C owns rows [b * rows, b * rows + nr) of the
// strip, nr <= rows = ceil(h / C), as a column-major (panel, lds) array of
// the storage type T in its dynamic shared memory (lds: rows rounded up to
// 4, kept off a multiple of 8, so the rank-1 update moves four rows at a
// time — a float4, or 8 bytes of bfloat16 — and the transposing load and
// store stay at most 4-way bank-conflicted at float32, 2-way at bfloat16,
// whose column stride lds / 2 words is 2 mod 4). At bfloat16 the strip
// takes half the bytes, so a block holds about twice the rows (428 at
// panel 256 against 212). Warp 0 of a block
// owns the block's pivot column work; the other warps share the rest of
// the rank-1 update. Pivot step j:
//   1. wait at the cluster barrier of step j;
//   2. every warp reduces the C candidates of step j that the blocks
//      pushed into its own shared memory (|value| as an ordered key, row,
//      signed value), so all blocks reach the same pivot p and piv with
//      no read of another block;
//   3. warp 0 computes the multipliers (0 on done rows) and writes column
//      j; the other warps copy p's row (columns > j) from the slot of p's
//      owner through distributed shared memory into u;
//   4. __syncthreads; warp 0 updates column j + 1 of the block's rows,
//      finds the block's candidate for step j + 1, pushes it into every
//      block of the cluster and writes that row's columns > j + 1,
//      updated by step j, into its slot;
//   5. __syncthreads; all warps arrive at the barrier of step j + 1
//      (warp 0 with release semantics) and the others update columns
//      > j + 1 while the barrier completes.
// The slot copy is why no block waits for p's owner before updating its
// own rows. Slots, candidates, u and the multipliers are double-buffered
// by step parity: a block passes the barrier of step j + 1 only after
// every block has arrived at it, which each does after it has read the
// buffers of step j - 1.
//
// Arithmetic contract, the same as gtt_factor_panel (panel_common.cuh):
// every element sees __fsub_rn(v, __fmul_rn(u, m)) in step order (each
// result rounded to bfloat16 at bfloat16 storage), the multiplier is
// __fdiv_rn(col, piv), done rows take m = 0 (and are updated all the
// same), and an inf/NaN multiplier also touches the finished columns as
// 0 * m. Candidates compare the stored (rounded) values. The argmax's reduction order cannot matter, because
// (key, index) with the key below is the same total order as gtt_better.
// So this loop is bit for bit equal to gtt_factor_panel and to the plain
// PyTorch version (panel_factor_plain), and the trailing kernel, which
// only reads the multipliers, stays bit for bit equal to the fused kernel.
#pragma once

#include <cooperative_groups.h>

#include "panel_common.cuh"

#define GTT_CLUSTER_MAX 16     // widest cluster (non-portable above 8)
#define GTT_CLUSTER_ROWS 16    // rows a block aims to hold (measured)
#define GTT_SMEM_MAX 232448    // dynamic shared memory of one sm_90 block
#define GTT_CAND_WORDS 4       // one pushed candidate: key, row, value, pad

namespace gtt_cg = cooperative_groups;

// Rows of a block rounded up to quads of rows, and the strip's column
// stride in elements.
__host__ __device__ inline int gtt_cluster_r4(int rows) {
  return (rows + 3) & ~3;
}
__host__ __device__ inline int gtt_cluster_lds(int rows) {
  return gtt_cluster_r4(rows) | 4;
}

// Bytes of a block's strip of `itemsize`-byte elements, rounded up to 16
// (a no-op at float32, whose panel * lds * 4 is a multiple of 16).
__host__ __device__ inline size_t gtt_cluster_strip_bytes(int rows,
                                                          int panel,
                                                          int itemsize) {
  return ((size_t)itemsize * panel * gtt_cluster_lds(rows) + 15) &
         ~(size_t)15;
}

// Dynamic shared memory of one block holding `rows` rows of a panel-wide
// strip of `itemsize`-byte elements: the strip, then two slots and two
// pivot rows (panel floats each), two multiplier columns (r4 floats each),
// the step records (rows) and two parities of GTT_CLUSTER_MAX pushed
// candidates.
__host__ __device__ inline size_t gtt_cluster_smem_bytes(int rows, int panel,
                                                         int itemsize) {
  return gtt_cluster_strip_bytes(rows, panel, itemsize) +
         4 * (4 * (size_t)panel + 2 * (size_t)gtt_cluster_r4(rows) + rows +
              2 * GTT_CLUSTER_MAX * GTT_CAND_WORDS);
}

// The routing rule (kernels/panel.py::panel_geometry states it in Python):
// the cluster size for an (h, panel) strip of `itemsize`-byte elements, or
// 0 when no cluster of at most GTT_CLUSTER_MAX blocks holds it and the
// grid route (panel_grid.cuh) or the one-block kernel runs. C starts at
// ceil(h / GTT_CLUSTER_ROWS), at most GTT_CLUSTER_MAX, and grows until a
// block's rows fit its shared memory.
__host__ inline int gtt_cluster_size(int h, int panel, int itemsize) {
  if (panel < 1 || panel > GTT_PANEL_MAX || h < 1) return 0;
  int c = (h + GTT_CLUSTER_ROWS - 1) / GTT_CLUSTER_ROWS;
  c = c < 1 ? 1 : (c > GTT_CLUSTER_MAX ? GTT_CLUSTER_MAX : c);
  for (; c <= GTT_CLUSTER_MAX; ++c)
    if (gtt_cluster_smem_bytes((h + c - 1) / c, panel, itemsize) <=
        GTT_SMEM_MAX)
      return c;
  return 0;
}

// One block's share of the strip, laid out in its dynamic shared memory.
template <typename T>
struct GttClusterStrip {
  T* t;         // (panel, lds): t[c * lds + rl] is row row0 + rl, column c
  float* slot;  // 2 x panel: the block's candidate row, by step parity
  float* u;     // 2 x panel: the pivot row
  float* m;     // 2 x r4: the multipliers (0 on the pad rows)
  int* step;    // (rows,) the step that chose the row, -1 while unchosen
  float* cand;  // 2 x GTT_CLUSTER_MAX x GTT_CAND_WORDS, pushed by rank
  int lds, rows, r4, nr, row0, panel, kb;
};

template <typename T>
__device__ inline GttClusterStrip<T> gtt_cluster_layout(void* smem, int h,
                                                        int panel, int kb,
                                                        int rows, int rank) {
  GttClusterStrip<T> s;
  s.lds = gtt_cluster_lds(rows);
  s.rows = rows;
  s.r4 = gtt_cluster_r4(rows);
  s.row0 = rank * rows;
  s.nr = max(0, min(rows, h - s.row0));
  s.panel = panel;
  s.kb = kb;
  s.t = reinterpret_cast<T*>(smem);
  // 16-byte aligned: float4 reads of the multipliers.
  s.m = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem) +
      gtt_cluster_strip_bytes(rows, panel, (int)sizeof(T)));
  s.slot = s.m + 2 * s.r4;
  s.u = s.slot + 2 * panel;
  s.step = reinterpret_cast<int*>(s.u + 2 * panel);
  s.cand = reinterpret_cast<float*>(s.step + rows);
  return s;
}

// The ordered key of a candidate: a NaN above every number, larger |x|
// above smaller, a done row (-inf) at 0. With ties to the lower row this
// is gtt_better's order.
__device__ __forceinline__ unsigned gtt_cand_key(float a) {
  return a != a ? 0xffffffffu
                : (a == -INFINITY ? 0u : __float_as_uint(a) + 1u);
}

// The warp's best (key, row) in every lane, and the value of the lane
// that held it.
__device__ __forceinline__ void gtt_warp_best(unsigned& key, int& idx,
                                              float& val) {
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  const int win = __reduce_min_sync(0xffffffffu, key == top ? idx : INT_MAX);
  const unsigned hit = __ballot_sync(0xffffffffu, key == top && idx == win);
  val = __shfl_sync(0xffffffffu, val, hit ? __ffs(hit) - 1 : 0);
  key = top;
  idx = win;
}

// Load the block's rows of the (h, panel) row-major strip at src (row
// stride ld), coalesced along each row; zero the pad rows; mark every row
// unchosen and every pad row's multiplier 0.
template <typename T>
__device__ void gtt_cluster_load(const GttClusterStrip<T>& s,
                                 const T* __restrict__ src, int ld) {
  const int total = s.r4 * s.panel;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int rl = e / s.panel, c = e - rl * s.panel;
    s.t[c * s.lds + rl] =
        rl < s.nr ? src[(size_t)(s.row0 + rl) * ld + c] : gtt_to<T>(0.0f);
  }
  for (int rl = threadIdx.x; rl < s.rows; rl += blockDim.x) s.step[rl] = -1;
  for (int rl = threadIdx.x; rl < 2 * s.r4; rl += blockDim.x) s.m[rl] = 0.0f;
}

// Warp 0, step jn's candidate in the block: update column jn of the
// block's rows by step jn - 1 (pivot row u, multipliers m; no update when
// m is null) and reduce the live rows' |column| to the block's best
// (key, row, signed value), in every lane. The row is INT_MAX when the
// block holds no live row.
template <typename T>
__device__ __forceinline__ void gtt_strip_best(const GttClusterStrip<T>& s,
                                               int jn,
                                               const float* __restrict__ u,
                                               const float* __restrict__ m,
                                               unsigned& key, int& idx,
                                               float& val) {
  const int lane = threadIdx.x & 31;
  key = 0;
  idx = INT_MAX;
  val = 0.0f;
  T* col = s.t + jn * s.lds;
#pragma unroll 4
  for (int rl = lane; rl < s.nr; rl += 32) {
    float v = gtt_f(col[rl]);
    if (m != nullptr) {
      v = gtt_r<T>(__fsub_rn(v, gtt_r<T>(__fmul_rn(u[jn], m[rl]))));
      col[rl] = gtt_to<T>(v);
    }
    const int r = s.row0 + rl;
    const bool done = r < s.kb || s.step[rl] >= 0;
    const unsigned k = gtt_cand_key(done ? -INFINITY : fabsf(v));
    if (k > key) { key = k; idx = r; val = v; }  // rows ascend: ties keep
  }
  gtt_warp_best(key, idx, val);
}

// Warp 0: row idx's columns > jn after step jn - 1 into slot (shared or
// global memory), before the other warps update them; nothing when idx is
// INT_MAX.
template <typename T>
__device__ __forceinline__ void gtt_strip_slot_row(
    const GttClusterStrip<T>& s, int jn, int idx, const float* __restrict__ u,
    const float* __restrict__ m, float* __restrict__ slot) {
  if (idx == INT_MAX) return;
  const int lane = threadIdx.x & 31;
  const int bl = idx - s.row0;
  const float mb = m != nullptr ? m[bl] : 0.0f;
#pragma unroll 4
  for (int c = jn + 1 + lane; c < s.panel; c += 32) {
    const float v = gtt_f(s.t[c * s.lds + bl]);
    slot[c] = m != nullptr
                  ? gtt_r<T>(__fsub_rn(v, gtt_r<T>(__fmul_rn(u[c], mb))))
                  : v;
  }
}

// Warp 0, step jn's candidate: the block's best row (gtt_strip_best), its
// columns > jn into slot[jn & 1], and the candidate (key, row, signed
// value) pushed into cand[jn & 1][rank] of every block of the cluster.
template <typename T>
__device__ __forceinline__ void gtt_cluster_candidate(
    const GttClusterStrip<T>& s, int jn, int rank,
    const float* __restrict__ u, const float* __restrict__ m) {
  const int lane = threadIdx.x & 31;
  unsigned key;
  int idx;
  float val;
  gtt_strip_best(s, jn, u, m, key, idx, val);
  // Push the candidate first: the stores drain while the slot is written.
  gtt_cg::cluster_group cluster = gtt_cg::this_cluster();
  if (lane < (int)cluster.num_blocks()) {
    float* rc = (lane == rank ? s.cand : cluster.map_shared_rank(s.cand, lane))
                + ((jn & 1) * GTT_CLUSTER_MAX + rank) * GTT_CAND_WORDS;
    rc[0] = __uint_as_float(key);
    rc[1] = __int_as_float(idx);
    rc[2] = val;
  }
  gtt_strip_slot_row(s, jn, idx, u, m, s.slot + (jn & 1) * s.panel);
  __syncwarp();
}

// Arrive at the cluster barrier: warp 0 with release semantics (its slot
// and pushed candidate must be seen); the other warps relaxed, since no
// other block reads what they write, and the loads they made of other
// blocks' slots have returned (their values are stored) before they
// arrive.
__device__ __forceinline__ void gtt_cluster_arrive(bool release) {
  if (release)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// v - uc * m, elementwise, each product and difference rounded (to the
// storage type T).
template <typename T>
__device__ __forceinline__ void gtt_sub4(float4& v, float uc, float4 m) {
  v.x = gtt_r<T>(__fsub_rn(v.x, gtt_r<T>(__fmul_rn(uc, m.x))));
  v.y = gtt_r<T>(__fsub_rn(v.y, gtt_r<T>(__fmul_rn(uc, m.y))));
  v.z = gtt_r<T>(__fsub_rn(v.z, gtt_r<T>(__fmul_rn(uc, m.z))));
  v.w = gtt_r<T>(__fsub_rn(v.w, gtt_r<T>(__fmul_rn(uc, m.w))));
}

// The rank-1 update of columns [c0, panel) of every row (four rows at a
// time, the pad rows included), and the finished columns [0, j) of rows
// whose multiplier is inf/NaN, by the block's warps but warp 0.
template <typename T>
__device__ __forceinline__ void gtt_cluster_update(
    const GttClusterStrip<T>& s, int j, int c0, const float* __restrict__ u,
    const float* __restrict__ m) {
  const int tid = threadIdx.x - 32, nt = blockDim.x - 32, nq = s.r4 >> 2;
  if (tid < 0) return;
  const int G = nq >= nt ? 1 : nt / nq;
  const int g = nq >= nt ? 0 : tid / nq;
  if (g >= G) return;
  for (int q = nq >= nt ? tid : tid - g * nq; q < nq; q += nt) {
    const float4 mv = reinterpret_cast<const float4*>(m)[q];
    T* base = s.t + 4 * q;
    int c = c0 + g;
    for (; c + G < s.panel; c += 2 * G) {
      T* a0 = base + c * s.lds;
      T* a1 = base + (c + G) * s.lds;
      float4 v0 = gtt_ld4(a0), v1 = gtt_ld4(a1);
      gtt_sub4<T>(v0, u[c], mv);
      gtt_sub4<T>(v1, u[c + G], mv);
      gtt_st4(a0, v0);
      gtt_st4(a1, v1);
    }
    if (c < s.panel) {
      T* a = base + c * s.lds;
      float4 v = gtt_ld4(a);
      gtt_sub4<T>(v, u[c], mv);
      gtt_st4(a, v);
    }
    const float mk[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(fabsf(mk[k]) <= FLT_MAX)) {
        // The plain version subtracts 0 * mult from the finished columns
        // too; that is an identity unless the multiplier is inf/NaN.
        for (int cf = g; cf < j; cf += G) {
          T* a = base + cf * s.lds + k;
          *a = gtt_to<T>(
              __fsub_rn(gtt_f(*a), gtt_r<T>(__fmul_rn(0.0f, mk[k]))));
        }
      }
    }
  }
}

// The pivot-step loop over the whole strip, by every block of the cluster
// (blockDim.x threads each, a multiple of 32). ipiv[j] is written by rank
// 0; the returned min |pivot| (a NaN pivot counts as 0) is valid in every
// thread. On return the block's rows are factored in s.t and s.step holds
// the step that chose each row.
template <typename T>
__device__ float gtt_cluster_factor(const GttClusterStrip<T>& s,
                                    int* __restrict__ ipiv) {
  gtt_cg::cluster_group cluster = gtt_cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const bool lead = tid < 32;  // warp 0
  const int panel = s.panel, lds = s.lds;
  float minp = INFINITY;

  // Every block has started and loaded before the first push.
  cluster.sync();
  if (lead) gtt_cluster_candidate(s, 0, rank, nullptr, nullptr);
  gtt_cluster_arrive(lead);
  for (int j = 0; j < panel; ++j) {
    const int par = j & 1;
    float* u = s.u + par * panel;
    float* m = s.m + par * s.r4;
    const bool next = j + 1 < panel;
    // 1-2. The step's barrier; the cluster's pivot, in every warp.
    cluster.barrier_wait();
    unsigned key = 0;
    int idx = INT_MAX;
    float val = 0.0f;
    if (lane < C) {
      const float* rc =
          s.cand + (par * GTT_CLUSTER_MAX + lane) * GTT_CAND_WORDS;
      key = __float_as_uint(rc[0]);
      idx = __float_as_int(rc[1]);
      val = rc[2];
    }
    gtt_warp_best(key, idx, val);
    const int p = idx;
    const float piv = val;
    {
      const float a = fabsf(piv);
      minp = fminf(minp, a != a ? 0.0f : a);
    }
    // 3. Warp 0 computes the multipliers and writes column j (which no
    // other warp touches: their update of step j - 1 may still run); the
    // other warps copy the pivot row from its owner's slot.
    if (lead) {
      if (rank == 0 && lane == 0) ipiv[j] = p;
      T* col = s.t + j * lds;
#pragma unroll 4
      for (int rl = lane; rl < s.nr; rl += 32) {
        const int r = s.row0 + rl;
        if (r == p) s.step[rl] = j;
        const bool done = r < s.kb || s.step[rl] >= 0;  // includes p
        const float cv = gtt_f(col[rl]);
        const float q = gtt_r<T>(__fdiv_rn(cv, piv));
        m[rl] = done ? 0.0f : q;
        col[rl] = gtt_to<T>(done ? cv : q);
      }
    } else {
      const float* ps =
          cluster.map_shared_rank(s.slot, p / s.rows) + par * panel;
      for (int c = j + 1 + tid - 32; c < panel; c += nt - 32) u[c] = ps[c];
    }
    __syncthreads();  // u and m; the update of step j - 1 is done
    // 4. Step j + 1's candidate, from column j + 1 updated first, and its
    // row into the slot before the update.
    if (lead && next) gtt_cluster_candidate(s, j + 1, rank, u, m);
    __syncthreads();
    // 5. Arrive, and update the rest while the barrier completes.
    if (next) gtt_cluster_arrive(lead);
    gtt_cluster_update(s, j, j + 2, u, m);
  }
  // Every block is done reading the others' slots before any leaves.
  cluster.sync();
  return minp;
}

// Write the block's factored rows into pt (panel, h), coalesced along each
// column, and its rows' inv (new position) and chosen flags.
template <typename T>
__device__ void gtt_cluster_store(const GttClusterStrip<T>& s, int h,
                                  T* __restrict__ pt, int* __restrict__ inv,
                                  int* __restrict__ chosen) {
  const int total = s.nr * s.panel;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e / s.nr, rl = e - c * s.nr;
    pt[(size_t)c * h + s.row0 + rl] = s.t[c * s.lds + rl];
  }
  for (int rl = threadIdx.x; rl < s.nr; rl += blockDim.x) {
    const int r = s.row0 + rl, st = s.step[rl];
    chosen[r] = st >= 0;
    inv[r] = st >= 0 ? s.kb + st : r;
  }
}

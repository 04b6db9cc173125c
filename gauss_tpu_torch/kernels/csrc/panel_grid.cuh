// The grid pivot-step loop: partial-pivot LU of one (h, panel) strip too
// tall for one thread-block cluster's shared memory, held in the shared
// memory of G co-resident blocks that exchange each step's candidates
// through L2. Kernel 1's grid route (panel_grid.cu) and kernel 2's phase A
// on that route (panel_fused.cu) both run it.
//
// What bounds the route on the H100: the chain of `panel` dependent pivot
// steps, as on the cluster route, but across blocks that share no memory
// but L2. The one-block loop it replaces (gtt_factor_panel) read and wrote
// every live element right of the step through one SM's port to L2 at
// every step: ~110 us a step at (7424, 256). Here a step's elements never
// leave shared memory, so a step costs what the exchange costs: one
// release store and one acquire poll through L2, the pivot row read from
// L2, and two __syncthreads.
//
// The design: the cluster loop's step structure (panel_cluster.cuh) over
// G blocks, with the exchange moved from distributed shared memory to L2.
// Block b owns rows [b * rows, b * rows + nr), rows = ceil(h / G), in the
// cluster loop's layout (GttClusterStrip). Pivot step j, warp 0:
//   1. polls the G step records of parity j & 1 (ld.acquire, one lane per
//      record) until every one carries step j's tag, and reduces them in
//      every lane in gtt_better's total order (the key makes the order of
//      the reduction irrelevant, as in the cluster loop), so every block
//      reaches the same pivot p and piv;
//   2. reads p's row (columns > j) from its owner's slot in L2 into u and
//      computes the multipliers (0 on done rows) and column j; then
//      __syncthreads (u, m; the others' update of step j - 1 is done);
//   3. updates column j + 1 of the block's rows, finds the block's
//      candidate for step j + 1 and writes that row's columns > j + 1,
//      updated by step j, into the block's slot of parity (j + 1) & 1;
//      __syncthreads (the slot row is read before the others update it);
//   4. lane 0 publishes the block's record of step j + 1 (st.release: its
//      slot row is seen by whoever acquires the record) and warp 0 goes on
//      to poll, while the other warps update columns > j + 1.
// A record is 64 bits, read and written whole: the candidate's signed
// value, its row (GTT_GRID_NONE when the block holds no live row) and the
// tag j + 1 (never 0: the records are zeroed before the launch). One
// arrival per step and no second wait: the slot copy means no block waits
// for the pivot's owner. Records and slots are double-buffered by step
// parity: block b writes its buffers of parity j & 1 for step j during step
// j - 1, after it has seen every block's record of step j - 1, which each
// block publishes after it has read the buffers of step j - 2.
//
// Co-residency: every block waits on every other, so all G must run at
// once. Kernel 1 launches exactly G blocks with
// cudaLaunchAttributeCooperative: a grid the card cannot hold at once
// fails to launch (the wrapper raises) instead of spinning. Every spin
// traps after GTT_WAIT_LIMIT_NS, so a fault ends in an error, not a hang.
//
// Arithmetic contract, the cluster loop's: every element sees
// __fsub_rn(v, __fmul_rn(u, m)) in step order (each result rounded to
// bfloat16 at bfloat16 storage), the multiplier is __fdiv_rn(col, piv),
// done rows take m = 0, and an inf/NaN multiplier touches the finished
// columns as 0 * m (gtt_cluster_update). So the grid loop is bit for bit
// the cluster loop, gtt_factor_panel and panel_factor_plain.
#pragma once

#include "panel_cluster.cuh"

#define GTT_GRID_MAX 132        // most blocks of the route: the H100's SMs
#define GTT_GRID_ROWS 64        // rows a block aims to hold (measured)
#define GTT_GRID_START_MAX 100  // most blocks the rule starts at (measured)
#define GTT_GRID_NONE 0xfffffu  // a record's row when the block has none
#define GTT_GRID_H_MAX 0xffffe  // tallest strip a record's 20 bits name
#define GTT_GRID_PER_LANE ((GTT_GRID_MAX + 31) / 32)
// A wait longer than this is a fault (no phase lasts a fraction of it):
// the kernel traps, and the launch reports an error instead of hanging.
#define GTT_WAIT_LIMIT_NS 20000000000ull

// The routing rule's grid size (kernels/panel.py::grid_size states it in
// Python): G for an (h, panel) strip of `itemsize`-byte elements, or 0
// when no G up to GTT_GRID_MAX holds it. G starts at ceil(h /
// GTT_GRID_ROWS), at most GTT_GRID_START_MAX, and grows until a block's
// rows fit its shared memory. (On the H100 a step took 10-20% longer at
// (4096, 256) with 128 rows a block than with 64, and 15% longer at
// (12800, 128) with G = 132 than with 100: scripts/probe_grid.py.) The
// route takes it only where no cluster holds the strip (gtt_cluster_size
// is 0).
__host__ inline int gtt_grid_size(int h, int panel, int itemsize) {
  if (panel < 1 || panel > GTT_PANEL_MAX || h < 1 || h > GTT_GRID_H_MAX)
    return 0;
  int g = (h + GTT_GRID_ROWS - 1) / GTT_GRID_ROWS;
  g = g > GTT_GRID_START_MAX ? GTT_GRID_START_MAX : g;
  for (; g <= GTT_GRID_MAX; ++g)
    if (gtt_cluster_smem_bytes((h + g - 1) / g, panel, itemsize) <=
        GTT_SMEM_MAX)
      return g;
  return 0;
}

// The route's G: gtt_grid_size where no cluster holds the strip, else 0.
// (Strips that neither holds take the one-block loop, gtt_factor_panel.)
__host__ inline int gtt_grid_route(int h, int panel, int itemsize) {
  return gtt_cluster_size(h, panel, itemsize) > 0
             ? 0
             : gtt_grid_size(h, panel, itemsize);
}

// The exchange of one grid launch, in global memory.
struct GttGridX {
  unsigned long long* rec;  // 2 x G step records by parity (zeroed)
  float* slot;              // 2 x G x panel: each block's candidate row
  int G, rank;
};

__device__ __forceinline__ unsigned long long gtt_now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// One more round of a spin that began at t0 (0: now); traps past the
// limit. No sleep: the loop's waits are microseconds.
__device__ __forceinline__ void gtt_spin(unsigned long long& t0) {
  const unsigned long long t = gtt_now_ns();
  if (t0 == 0)
    t0 = t;
  else if (t - t0 > GTT_WAIT_LIMIT_NS)
    __trap();
}

__device__ __forceinline__ unsigned long long gtt_ld_acquire64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void gtt_st_release64(unsigned long long* p,
                                                 unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// A step record: tag j + 1 in bits 32-43, the row in bits 44-63, the
// signed value in bits 0-31.
__device__ __forceinline__ unsigned long long gtt_grid_record(float v,
                                                              int row,
                                                              int j) {
  const unsigned r = row == INT_MAX ? GTT_GRID_NONE : (unsigned)row;
  return (unsigned long long)(r << 12 | ((unsigned)(j + 1) & 0xfffu)) << 32 |
         __float_as_uint(v);
}

__device__ __forceinline__ unsigned gtt_grid_tag(unsigned long long r) {
  return (unsigned)(r >> 32) & 0xfffu;
}

// Warp 0: wait until every block's record of step j is published and
// reduce them to the pivot row p and its value piv, in every lane.
__device__ __forceinline__ void gtt_grid_pivot(const GttGridX& x, int j,
                                               int& p, float& piv) {
  const int lane = threadIdx.x & 31;
  const unsigned want = (unsigned)(j + 1) & 0xfffu;
  const unsigned long long* rec = x.rec + (j & 1) * x.G;
  unsigned long long r[GTT_GRID_PER_LANE];
#pragma unroll
  for (int k = 0; k < GTT_GRID_PER_LANE; ++k) {
    const int b = lane + 32 * k;
    r[k] = b < x.G ? gtt_ld_acquire64(rec + b) : 0ull;
  }
  unsigned long long t0 = 0;
  for (;;) {
    bool ok = true;
#pragma unroll
    for (int k = 0; k < GTT_GRID_PER_LANE; ++k)
      ok = ok && (lane + 32 * k >= x.G || gtt_grid_tag(r[k]) == want);
    if (__all_sync(0xffffffffu, ok)) break;
    gtt_spin(t0);
#pragma unroll
    for (int k = 0; k < GTT_GRID_PER_LANE; ++k) {
      const int b = lane + 32 * k;
      if (b < x.G && gtt_grid_tag(r[k]) != want)
        r[k] = gtt_ld_acquire64(rec + b);
    }
  }
  // Blocks ascend with k and their rows with the blocks: ties keep the
  // lower row, and gtt_warp_best keeps it across lanes.
  unsigned key = 0;
  int idx = INT_MAX;
  float val = 0.0f;
#pragma unroll
  for (int k = 0; k < GTT_GRID_PER_LANE; ++k) {
    const unsigned row = (unsigned)(r[k] >> 44);
    if (lane + 32 * k < x.G && row != GTT_GRID_NONE) {
      const float v = __uint_as_float((unsigned)r[k]);
      const unsigned kk = gtt_cand_key(fabsf(v));
      if (kk > key) { key = kk; idx = (int)row; val = v; }
    }
  }
  gtt_warp_best(key, idx, val);
  __syncwarp();  // every lane's acquire before any lane reads a slot
  p = idx;
  piv = val;
}

// Warp 0, step jn's candidate: the block's best row (gtt_strip_best) and
// its columns > jn into the block's slot of parity jn & 1 in L2; returns
// the record, to be published once the block's warps have synchronised.
template <typename T>
__device__ __forceinline__ unsigned long long gtt_grid_candidate(
    const GttClusterStrip<T>& s, const GttGridX& x, int jn,
    const float* __restrict__ u, const float* __restrict__ m) {
  unsigned key;
  int idx;
  float val;
  gtt_strip_best(s, jn, u, m, key, idx, val);
  gtt_strip_slot_row(s, jn, idx, u, m,
                     x.slot + (size_t)((jn & 1) * x.G + x.rank) * s.panel);
  return gtt_grid_record(val, idx, jn);
}

// The pivot-step loop over the whole strip, by every block of the group
// (blockDim.x threads each, a multiple of 32). ipiv[j] is written by rank
// 0; the returned min |pivot| (a NaN pivot counts as 0) is valid in warp
// 0. On return the block's rows are factored in s.t and s.step holds the
// step that chose each row.
template <typename T>
__device__ float gtt_grid_factor(const GttClusterStrip<T>& s,
                                 const GttGridX& x, int* __restrict__ ipiv) {
  const int tid = threadIdx.x, lane = tid & 31;
  const bool lead = tid < 32;  // warp 0
  const int panel = s.panel, lds = s.lds;
  float minp = INFINITY;

  __syncthreads();  // the block's rows are loaded
  if (lead) {
    const unsigned long long r = gtt_grid_candidate(s, x, 0, nullptr,
                                                    nullptr);
    __syncwarp();
    if (lane == 0) gtt_st_release64(x.rec + x.rank, r);
  }
  for (int j = 0; j < panel; ++j) {
    const int par = j & 1;
    float* u = s.u + par * panel;
    float* m = s.m + par * s.r4;
    const bool next = j + 1 < panel;
    unsigned long long rec = 0;
    if (lead) {
      // 1. The step's pivot.
      int p;
      float piv;
      gtt_grid_pivot(x, j, p, piv);
      const float a = fabsf(piv);
      minp = fminf(minp, a != a ? 0.0f : a);
      if (x.rank == 0 && lane == 0) ipiv[j] = p;
      // 2. The pivot row from its owner's slot (the first 256 columns'
      // loads in flight while the multipliers are computed), the
      // multipliers and column j.
      const float* ps = x.slot + (size_t)(par * x.G + p / s.rows) * panel;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = j + 1 + lane + 32 * k;
        v[k] = c < panel ? __ldcg(ps + c) : 0.0f;
      }
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
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = j + 1 + lane + 32 * k;
        if (c < panel) u[c] = v[k];
      }
      for (int c = j + 1 + 256 + lane; c < panel; c += 32)
        u[c] = __ldcg(ps + c);
    }
    __syncthreads();  // u and m; the update of step j - 1 is done
    // 3. Step j + 1's candidate, from column j + 1 updated first, and its
    // row into the slot before the update.
    if (lead && next) rec = gtt_grid_candidate(s, x, j + 1, u, m);
    __syncthreads();
    // 4. Publish, and update the rest while the other blocks poll.
    if (lead && next && lane == 0)
      gtt_st_release64(x.rec + ((j + 1) & 1) * x.G + x.rank, rec);
    gtt_cluster_update(s, j, j + 2, u, m);
  }
  __syncthreads();  // the last update is done before the rows are stored
  return minp;
}

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
//     strips take the grid route (gtt_grid_route(h, panel) > 0: at panel
//     256 up to 27,984 rows at float32): the launch is cooperative, the
//     first G blocks to take a phase-A ticket form the group (rank =
//     ticket) and run the panel_grid.cuh step loop, each block's rows in
//     its shared memory, the step records and pivot rows exchanged through
//     L2. Strips beyond the grid's reach (e.g. panel 1024 above 6,864
//     rows) launch without either and one block runs the one-block loop
//     gtt_factor_panel. Every route's phase-A blocks then DERIVE the
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
//   at once, and needs no grid-wide barrier; on the grid route the group's
//   blocks also wait on each other, which the cooperative launch makes
//   safe (gtt_fused_group_body states the argument). (The runtime does take
//   cudaLaunchAttributeCooperative beside a cluster dimension of 16 on the
//   H100, up to the 7 clusters it holds at once; a grid.sync() would make
//   every tile wait for every B1, and the flags do not.) The grid fills
//   the card: C * min(1 + ceil(jobs / C), clusters it holds at once) on
//   the cluster route, min(G + jobs, SMs) on the grid route, min(1 + jobs,
//   SMs) on the one-block route.
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
// block: phase A is the bfloat16 step loop of its route (its strip is
// half the bytes, so the cluster route reaches 6,848 rows at panel 256),
// and phase B keeps the JAX kernel's precision contract: the multiplier
// record, the U rows and every accumulation stay float32 (the record and
// scratch are float32 at either storage); a segment's U is rounded to
// bfloat16 (ulow) when its forward substitution is done, before any row
// applies it, and every trailing element is rounded to bfloat16 once per
// segment, after __fsub_rn(T, acc). Tiles and pivot rows read and write
// bfloat16 and do the same float32 arithmetic as the float32 forms, so
// fused == pair bit for bit there too.
#include "panel_fused.cuh"

// ---- the kernels ---------------------------------------------------------

// One call is a stack of one (GttFusedBatchedArgs, batch 1): on every
// route the body is the batched kernel's (panel_fused_batched.cu), which at
// B = 1 runs phase A on the first cluster, group or block to start and the
// trailing jobs of that call.
// CLUSTER: launched with a cluster dimension; phase A on the cluster step
// loop. Else launched without clusters; phase A on the one-block loop.
template <bool CLUSTER>
__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_fused_kernel(const GttFusedBatchedArgs<float> ba) {
  gtt_fused_body<CLUSTER>(ba);
}

template <bool CLUSTER>
__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_fused_bf16_kernel(const GttFusedBatchedArgs<gtt_bf16> ba) {
  gtt_fused_body<CLUSTER>(ba);
}

// Launched cooperatively, without clusters; phase A on the grid step loop
// (panel_grid.cuh) over the first G blocks to start: the batched kernel's
// group body at K = 1, B = 1.
__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_fused_grid_kernel(const GttFusedBatchedArgs<float> ba) {
  gtt_fused_group_body(ba);
}

__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_fused_grid_bf16_kernel(const GttFusedBatchedArgs<gtt_bf16> ba) {
  gtt_fused_group_body(ba);
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

// ---- launchers -----------------------------------------------------------

// The fused kernel of (route, itemsize).
static const void* gtt_fused_kernel_of(int route, int itemsize) {
  if (itemsize == 2)
    return route == GTT_ROUTE_GRID ? (const void*)gtt_fused_grid_bf16_kernel
           : route == GTT_ROUTE_CLUSTER
               ? (const void*)gtt_fused_bf16_kernel<true>
               : (const void*)gtt_fused_bf16_kernel<false>;
  return route == GTT_ROUTE_GRID      ? (const void*)gtt_fused_grid_kernel
         : route == GTT_ROUTE_CLUSTER ? (const void*)gtt_fused_kernel<true>
                                      : (const void*)gtt_fused_kernel<false>;
}

// The launch facts of a fused call (out as gtt_fused_info's, panel_fused.cuh).
extern "C" int gtt_panel_fused_info(int h, int wtot, int col0, int panel,
                                    int fseg, int itemsize, int* out) {
  return gtt_fused_info(gtt_fused_kernel_of, 1, h, wtot, col0, panel, fseg,
                        itemsize, out);
}

// block: (h, wtot) row-major, row stride ld, updated IN PLACE right of
// col0 + panel. pt: (panel, h); mult: (panel, h) float32; ipiv (panel,);
// inv, chosen (h,); minpiv (1,); u: (panel, chunks * 64) float32 scratch;
// ctr: (3 + chunks,) int32, ZEROED (its CLUSTER and JOB words are the
// launch's tickets); rec (2 x G, ZEROED) and slot (2 x G x panel floats):
// the grid route's exchange (G: gtt_panel_fused_info's out[7]), ignored
// on the other routes. Returns cudaErrorLaunchOutOfResources when the card
// holds no such cluster or block, cudaErrorCooperativeLaunchTooLarge when
// it cannot hold the grid route's group at once, else the launch's error
// code.
extern "C" int gtt_panel_fused(float* block, int ld, int h, int wtot,
                               int col0, int kbrow, int panel, int fseg,
                               float* pt, float* mult, int* ipiv, int* inv,
                               int* chosen, float* minpiv, float* u,
                               int* ctr, unsigned long long* rec,
                               float* slot, void* stream) {
  return gtt_fused_launch(gtt_fused_kernel_of, block, 0, ld, 1, h, wtot,
                          col0, kbrow, panel, fseg, pt, mult, ipiv, inv,
                          chosen, minpiv, u, ctr, ctr, rec, slot, -1, 0, 0,
                          nullptr, stream);
}

// The same at bfloat16 storage: block, pt and minpiv are bfloat16; mult,
// u and slot stay float32.
extern "C" int gtt_panel_fused_bf16(gtt_bf16* block, int ld, int h, int wtot,
                                    int col0, int kbrow, int panel, int fseg,
                                    gtt_bf16* pt, float* mult, int* ipiv,
                                    int* inv, int* chosen, gtt_bf16* minpiv,
                                    float* u, int* ctr,
                                    unsigned long long* rec, float* slot,
                                    void* stream) {
  return gtt_fused_launch(gtt_fused_kernel_of, block, 0, ld, 1, h, wtot,
                          col0, kbrow, panel, fseg, pt, mult, ipiv, inv,
                          chosen, minpiv, u, ctr, ctr, rec, slot, -1, 0, 0,
                          nullptr, stream);
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
  GttFusedGeom g = {};
  g.chunks = gtt_trailing_chunks(wtot, col0, panel);
  g.row_tiles = (h + GTT_TM - 1) / GTT_TM;
  const int jobs = g.chunks * (1 + g.row_tiles);
  if (jobs < 1) return 0;
  gtt_route_geom(&g, GTT_ROUTE_BLOCK, 0, 0, 0, h, panel, fseg,
                 (int)sizeof(T));
  const void* kernel = sizeof(T) == 2 ? (const void*)gtt_trailing_bf16_kernel
                                      : (const void*)gtt_trailing_kernel;
  int fit = 0;
  bad = gtt_fit(kernel, g, &fit);
  if (bad) return bad;
  if (fit < 1) return (int)cudaErrorLaunchOutOfResources;
  gtt_fused_grid(g, 0, jobs, fit, sms);
  const GttFusedArgs<T> a = {block, ld, h, wtot, col0, 0, panel, fseg,
                             nullptr, const_cast<float*>(mult),
                             const_cast<int*>(ipiv), nullptr, nullptr,
                             nullptr, u, ctr, g.chunks, g.row_tiles, 0, 0};
  void* args[] = {(void*)&a};
  const cudaError_t e =
      cudaLaunchKernel(kernel, dim3(g.grid), dim3(GTT_THREADS), args, g.smem,
                       (cudaStream_t)stream);
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

// Batched fused panel-factor + trailing-update kernel: kernel 2 on every
// member of a (B, h, wtot) stack of blocks, in one launch.
//
// Replaces: gauss_tpu/kernels/panel_fused_pallas.py::
// panel_trailing_fused_pallas under jax.vmap, the form every panel step of
// a bucket wider than one panel runs in the serving lane
// (gauss_tpu/serve/cache.py, BatchedExecutable: jax.vmap of
// lu_factor_blocked over a (B, bucket, bucket) stack).
//
// What bounds it: per member what bounds kernel 2 (panel_fused.cu): phase
// A is `panel` dependent pivot steps on one cluster or one block, phase B
// is 2 * h * panel * ncols FP32 FMA per member over one read and one write
// of the member's trailing block. B members give B independent phase A
// chains and B times the phase B work.
//
// Design (a simple one: each member computes exactly what kernel 2
// computes on it, through kernel 2's own routines, panel_fused.cuh):
//   - Phase A by member ticket (gctr[0]): the first clusters (cluster
//     route, where a cluster holds the strip, as kernel 2 decides by the
//     strip's height) or blocks (one-block route, the strip factored by
//     gtt_factor_panel in its member's slice of the global scratch) to
//     start each take a member, factor its strip, write its multiplier
//     record and add one to that member's ctr[FACTORED]; then take the next
//     member's ticket until none is left.
//   - Then every block takes jobs by ticket (gctr[1]) over the stack's job
//     list, member after member, each member's jobs in kernel 2's order
//     (its B1 chunks, then its B2 tiles); a B1 job waits on its member's
//     ctr[FACTORED], a B2 tile on its chunk's flag, both in the member's own
//     counters. A block waits only for work whose ticket was taken earlier
//     by a running block (all phase A tickets are taken before any job
//     ticket), so the launch cannot deadlock.
//   - Member b's slices start at b times their per-member size; the block
//     offset is the stack's member stride, in 64-bit (a (8, 4096, 4096)
//     stack is 2^27 floats).
// The arithmetic per member is kernel 2's sequence, so every member's
// trailing block, factored panel, pivots and min |pivot| are bit for bit
// what kernel 2 gives on that member alone. The bfloat16 form
// (gtt_panel_fused_batched_bf16) keeps kernel 2's bfloat16 contract.
#include "panel_fused.cuh"

// The body, the tickets, the member slices and the launcher are kernel 2's
// (panel_fused.cuh: gtt_fused_body, GttFusedBatchedArgs, gtt_fused_launch);
// kernel 2 is this launch at B = 1. These are the stack's own symbols, so a
// trace tells the serving lane's launches from kernel 2's.
template <bool CLUSTER>
__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_fused_batched_kernel(const GttFusedBatchedArgs<float> ba) {
  gtt_fused_body<CLUSTER>(ba);
}

template <bool CLUSTER>
__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_fused_batched_bf16_kernel(const GttFusedBatchedArgs<gtt_bf16> ba) {
  gtt_fused_body<CLUSTER>(ba);
}

// The kernel of (route, itemsize); none on the grid route: a tall member
// takes the one-block loop at every B (an (8, 4096, 4096) stack's members
// cannot each take a group of G blocks at once).
static const void* gtt_batched_kernel_of(int route, int itemsize) {
  if (route == GTT_ROUTE_GRID) return nullptr;
  const bool cluster = route == GTT_ROUTE_CLUSTER;
  if (itemsize == 2)
    return cluster ? (const void*)gtt_fused_batched_bf16_kernel<true>
                   : (const void*)gtt_fused_batched_bf16_kernel<false>;
  return cluster ? (const void*)gtt_fused_batched_kernel<true>
                 : (const void*)gtt_fused_batched_kernel<false>;
}

// The launch facts of a batched call (out as gtt_fused_info's): kernel 2's
// geometry per member, the grid C * min(B + ceil(jobs / C), fit) on the
// cluster route and min(B + jobs, SMs) on the one-block route, with jobs
// the whole stack's.
extern "C" int gtt_panel_fused_batched_info(int batch, int h, int wtot,
                                            int col0, int panel, int fseg,
                                            int itemsize, int* out) {
  return gtt_fused_info(gtt_batched_kernel_of, batch, h, wtot, col0, panel,
                        fseg, itemsize, out);
}

// block: B members of (h, wtot), row stride ld, member stride bstride
// (elements), updated IN PLACE right of col0 + panel. pt (B, panel, h);
// mult (B, panel, h) float32; ipiv (B, panel); inv, chosen (B, h); minpiv
// (B,); u (B, panel, chunks * 64) float32; ctr (B, 3 + chunks) and gctr
// (2,) int32, ZEROED. Returns cudaErrorLaunchOutOfResources when the card
// holds no such cluster or block, else the launch's error code.
extern "C" int gtt_panel_fused_batched(float* block, long long bstride,
                                       int ld, int batch, int h, int wtot,
                                       int col0, int kbrow, int panel,
                                       int fseg, float* pt, float* mult,
                                       int* ipiv, int* inv, int* chosen,
                                       float* minpiv, float* u, int* ctr,
                                       int* gctr, void* stream) {
  return gtt_fused_launch(gtt_batched_kernel_of, block, bstride, ld, batch,
                          h, wtot, col0, kbrow, panel, fseg, pt, mult, ipiv,
                          inv, chosen, minpiv, u, ctr, gctr, nullptr,
                          nullptr, stream);
}

// The same at bfloat16 storage: block, pt and minpiv are bfloat16; mult
// and u stay float32.
extern "C" int gtt_panel_fused_batched_bf16(
    gtt_bf16* block, long long bstride, int ld, int batch, int h, int wtot,
    int col0, int kbrow, int panel, int fseg, gtt_bf16* pt, float* mult,
    int* ipiv, int* inv, int* chosen, gtt_bf16* minpiv, float* u, int* ctr,
    int* gctr, void* stream) {
  return gtt_fused_launch(gtt_batched_kernel_of, block, bstride, ld, batch,
                          h, wtot, col0, kbrow, panel, fseg, pt, mult, ipiv,
                          inv, chosen, minpiv, u, ctr, gctr, nullptr,
                          nullptr, stream);
}

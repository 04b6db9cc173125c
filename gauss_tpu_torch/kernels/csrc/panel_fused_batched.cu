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
// A is `panel` dependent pivot steps, phase B is 2 * h * panel * ncols
// FP32 FMA per member over one read and one write of the member's trailing
// block. B members give B independent phase A chains and B times the phase
// B work. On the H100 a 16-block cluster's step takes ~2.85 us and a grid
// group's ~3-4.5 us, but the card holds only 7 such clusters at once (a
// cluster is bound to one GPC), so eight members on the cluster route
// take two waves of phase A; and no cluster holds a strip above 3,392 rows
// at panel 256 in float32.
//
// Design (each member computes exactly what kernel 2 computes on it,
// through kernel 2's own routines, panel_fused.cuh). Phase A takes one of
// three routes, by one rule of (B, h, panel, itemsize, SMs, clusters the
// card holds at once) (gtt_fused_plan; kernels/panel_fused.py::
// fused_batched_geometry in Python):
//   - cluster, where a cluster holds the strip and the card holds the B
//     members' clusters at once (one wave): the first clusters to start
//     each take a member by ticket (gctr[0]), factor its strip on the
//     cluster step loop, write its multiplier record and add one to that
//     member's ctr[FACTORED]; then the next member's ticket until none is
//     left;
//   - grid, else, where a group holds the strip (gtt_group_size): a
//     cooperative launch whose first K * G blocks form K groups of G
//     co-resident blocks; group k factors members k, k + K, ... in turn on
//     the grid step loop (panel_grid.cuh), each member on its own exchange
//     in L2 (gtt_fused_group_body). K is as many groups of the smallest
//     fitting G as the card holds, at most B; G the widest that K groups
//     leave: (8, 4096) is 6 groups of 22 (members 0-5, then 6 and 7, while
//     the idle blocks take the first six members' trailing jobs), (8,
//     2048) 8 groups of 16 in one round;
//   - one block, beyond the grid's reach: gtt_factor_panel in the member's
//     slice of the global scratch.
//   Then every block takes jobs by ticket (gctr[1]) over the stack's job
//     list, member after member, each member's jobs in kernel 2's order
//     (its B1 chunks, then its B2 tiles); a B1 job waits on its member's
//     ctr[FACTORED], a B2 tile on its chunk's flag, both in the member's own
//     counters. A block waits only for work whose ticket was taken earlier
//     by a running block (all phase A tickets are taken before any job
//     ticket; gtt_fused_group_body states the grid route's argument), so
//     the launch cannot deadlock.
//   - Member b's slices start at b times their per-member size; the block
//     offset is the stack's member stride, in 64-bit (a (8, 4096, 4096)
//     stack is 2^27 floats).
// The arithmetic per member is kernel 2's sequence, and the grid loop's is
// the cluster loop's whatever G, so every member's trailing block,
// factored panel, pivots and min |pivot| are bit for bit what kernel 2
// gives on that member alone, on any route. The bfloat16 form
// (gtt_panel_fused_batched_bf16) keeps kernel 2's bfloat16 contract.
#include "panel_fused.cuh"

// The bodies, the tickets, the member slices and the launcher are kernel
// 2's (panel_fused.cuh: gtt_fused_body, gtt_fused_group_body,
// GttFusedBatchedArgs, gtt_fused_launch); kernel 2 is this launch at B = 1.
// These are the stack's own symbols, so a trace tells the serving lane's
// launches from kernel 2's.
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

// The grid route: launched cooperatively, without clusters.
__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_fused_batched_grid_kernel(const GttFusedBatchedArgs<float> ba) {
  gtt_fused_group_body(ba);
}

__global__ void __launch_bounds__(GTT_THREADS, 1)
gtt_fused_batched_grid_bf16_kernel(const GttFusedBatchedArgs<gtt_bf16> ba) {
  gtt_fused_group_body(ba);
}

// The kernel of (route, itemsize).
static const void* gtt_batched_kernel_of(int route, int itemsize) {
  if (itemsize == 2)
    return route == GTT_ROUTE_GRID
               ? (const void*)gtt_fused_batched_grid_bf16_kernel
           : route == GTT_ROUTE_CLUSTER
               ? (const void*)gtt_fused_batched_bf16_kernel<true>
               : (const void*)gtt_fused_batched_bf16_kernel<false>;
  return route == GTT_ROUTE_GRID ? (const void*)gtt_fused_batched_grid_kernel
         : route == GTT_ROUTE_CLUSTER
             ? (const void*)gtt_fused_batched_kernel<true>
             : (const void*)gtt_fused_batched_kernel<false>;
}

// The launch facts of a batched call by the rule (out as gtt_fused_info's,
// panel_fused.cuh, with out[9] the grid route's groups K): the grid C *
// min(B + ceil(jobs / C), fit) on the cluster route, min(K * G + jobs,
// SMs) on the grid route, min(B + jobs, SMs) on the one-block route, with
// jobs the whole stack's.
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
// (2,) int32, ZEROED; on the grid route rec (B, 2 x G) 64-bit, ZEROED, and
// slot (B, 2 x G, panel) float32, each member's exchange (ignored on the
// other routes). route: GTT_ROUTE_* or -1 for the rule's; groups, group:
// the grid route's K and G, 0 for the rule's. taken (3 ints, or null):
// the route, K and G launched. Returns
// cudaErrorInvalidValue when the route does not hold the strip,
// cudaErrorLaunchOutOfResources when the card holds no such cluster or
// block, cudaErrorCooperativeLaunchTooLarge when it cannot hold the grid
// route's K * G blocks at once, else the launch's error code.
extern "C" int gtt_panel_fused_batched(float* block, long long bstride,
                                       int ld, int batch, int h, int wtot,
                                       int col0, int kbrow, int panel,
                                       int fseg, float* pt, float* mult,
                                       int* ipiv, int* inv, int* chosen,
                                       float* minpiv, float* u, int* ctr,
                                       int* gctr, unsigned long long* rec,
                                       float* slot, int route, int groups,
                                       int group, int* taken, void* stream) {
  return gtt_fused_launch(gtt_batched_kernel_of, block, bstride, ld, batch,
                          h, wtot, col0, kbrow, panel, fseg, pt, mult, ipiv,
                          inv, chosen, minpiv, u, ctr, gctr, rec, slot,
                          route, groups, group, taken, stream);
}

// The same at bfloat16 storage: block, pt and minpiv are bfloat16; mult,
// u and slot stay float32.
extern "C" int gtt_panel_fused_batched_bf16(
    gtt_bf16* block, long long bstride, int ld, int batch, int h, int wtot,
    int col0, int kbrow, int panel, int fseg, gtt_bf16* pt, float* mult,
    int* ipiv, int* inv, int* chosen, gtt_bf16* minpiv, float* u, int* ctr,
    int* gctr, unsigned long long* rec, float* slot, int route, int groups,
    int group, int* taken, void* stream) {
  return gtt_fused_launch(gtt_batched_kernel_of, block, bstride, ld, batch,
                          h, wtot, col0, kbrow, panel, fseg, pt, mult, ipiv,
                          inv, chosen, minpiv, u, ctr, gctr, rec, slot,
                          route, groups, group, taken, stream);
}

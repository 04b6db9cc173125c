#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``gauss_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--reps N]

Phases (each prints its lines; any failure raises and exits non-zero):

1. Toolchain and card: torch / CUDA versions, ``nvcc``, ``CUDA_HOME``,
   whether ``triton`` imports, the card's name and power limit; asserts
   TF32 is off for float32 matmuls.
2. Build: compiles ``gauss_tpu_torch/kernels/csrc/*.cu`` with ``nvcc``
   for ``sm_90a`` (one process per source, in parallel).
3. Kernels vs plain versions at the shapes of the n=2048 main path: the
   panel factor's routes bit for bit (the cluster kernel at (256, 256)
   and (2048, 256), the grid kernel at (4096, 256), with the one-block
   kernel on the same strip beside it, bit for bit and timed), each with
   its geometry (the C launcher's beside the Python rule), clusters or
   blocks at once, ptxas usage, us per pivot step and
   ``torch.linalg.lu_factor`` beside it, the cluster kernel at the sizes
   of PANEL_CLUSTER_SWEEP and the grid kernel at the G of
   PANEL_GRID_SWEEP; the fused panel+trailing
   kernel and the standalone trailing kernel at all 7 fused launch shapes
   (h = 2048 - kb, kb = 0, 256, ..., 1536) and the fused kernel at a
   (4096, 4096) block, whose strip takes phase A's grid route, each
   with the C launcher's geometry (route, grid, shared memory, clusters at
   once) held against ``fused_geometry`` and its ptxas usage. Checks
   identical pivots, values within the stated tolerances, and fused ==
   panel + trailing bit for bit; times each with CUDA events (median of
   --reps launches) beside the panel kernel on the same strip (phase A
   alone) and the trailing kernel (phase B alone), and one whole n=2048
   factorization the same way beside ``torch.linalg.lu_factor`` on the
   same matrix.
3b. The same for the row-elimination and matmul kernels: the tiled and
   row-stripe matmul at (2048, 2048, 2048) in "high", "highest" and
   "default" within MM_TOL; the stripe's launch geometry (blocks, cluster
   size, dynamic shared memory, copy width, clusters the card holds at
   once), its TFLOP/s and share of its bound in each mode, its registers
   and spills from ``nvcc -Xptxas -v``, and the stripe against its plain
   version at STRIPE_SHAPES in every mode, contiguous and as misaligned
   column slices; the elimination step on the (2048, 2304) augmented
   shape at i = 0, 1023, 2047 bit for bit, and the rank-k update at
   (2048, 2304), k = 256, within RANKK_TOL; the tiled kernel's and the
   rank-k update's geometry (grid, tile, ring, copy width, waves), the
   blocks an SM the card holds, registers and spills, TFLOP/s and share
   of the bound, the tiled kernel at STRIPE_SHAPES in every mode and the
   rank-k update at RANKK_SHAPES, contiguous and as misaligned column
   slices, one launch each; each timed (device time of --reps queued
   launches, see device_ms) beside its plain version, its library call
   and its bound; the panel kernel at the 8 live-row strips of one
   batched solve (two of them bit for bit) beside ``lu_factor_ex`` on the
   same strips, and one whole batched and one whole step solve (CUDA
   events per call, host work included).
3c. The ELL sparse matrix-vector kernel against its plain version, bit for
   bit, in float64 and float32, at the two operand shapes the sparse
   generator gives with 20 entries per row: (100000, 36) and
   (1000000, 37); each timed (device_ms) beside its plain version, the
   stock gather-and-sum, ``torch.mv`` of the same matrix as a
   ``sparse_csr_tensor`` (the library call) and its bound (bytes). Also
   n = 130 and a matrix with an empty row.
4. The main paths through the port's entry points, each driven with the
   launch counts set to 0 just before it and read just after (the dense
   paths at n=2048):
   - blocked: the internal system host-refined and double-single-refined,
     and a .dat external system; every solve verified at the 1e-4 gate,
     7 fused + 1 cluster-panel launches per factorization. Then a random system
     solved on the card against a float64 reference.
   - rowelim: ``--backend cuda-rowelim`` on the internal system
     (``--verify``) and on the .dat system: 8 cluster-panel + 8 rank-k
     launches per solve; then the internal system at n=4096, whose three
     tallest live strips take the grid kernel and the other 13 the
     cluster kernel. The backend does not refine (as in the JAX package), so
     the .dat system is held to a float32 backward error (BACKWARD_TOL),
     not to the 1e-4 forward gate.
   - rowelim-step: ``--backend cuda-rowelim-step`` on the internal system
     (``--verify``): 2048 step launches per solve.
   - matmul: ``matmul 2048 --engines cuda,cuda-kernel,cuda-kernel-v1``,
     then the same with ``--precision highest``; every engine verifies,
     and each kernel engine launches twice per run.
   Each CLI run solves twice (the warm-up at shape, then the timed run).
   - sparse: ``gauss_tpu_torch.sparse.check`` with its smoke leg (n = 640:
     the routed ``solve_auto`` served by CG, then CG, GMRES, BiCGStab)
     and its giant leg (CG at n = 100,000), then the same with
     ``--giant-n 1000000`` (19 M stored entries, 444 MB of ELL state on
     the card); each preconditioner kind once at the smoke size;
     one ``.dat`` round trip; and one n = 1,000,000 solve taken apart
     (certificate, staging, iterations, host residual). Every solve is
     verified at the 1e-4 gate by a host residual, and the SpMV kernel's
     launch count must equal what the iteration counts imply: CG
     ``iterations + 1`` per solve, BiCGStab ``2 * iterations + 1``, GMRES
     ``1 + cycles * (restart + 2)``; no other kernel runs on this path.
5. Telemetry at n=2048, through the entry points with the obs flags:
   (a) ``gauss_internal --verify --metrics-out --profile --phase-profile
   --trace``: the stream holds the JAX package's spans (the port's warm-up
   label, no XLA cost span) and a health event with a positive min
   |pivot|, a growth factor and a residual under 1e-4; the port's
   ``summarize`` renders it; the Chrome trace holds as many panel and
   fused kernel events as the wrappers counted in the traced window, and
   its device busy time is printed; one timed solve traced alone gives
   device busy ms against host ms (the idle share). (b) ``Application
   time`` without flags and with ``--metrics-out`` alone, in turns, three
   each: both medians, and the same launches and residual in all six. (c)
   ``lu_factor_blocked_phased`` == ``lu_factor_blocked_unrolled(
   panel_impl="pallas")`` bit for bit, with the phase table. (d)
   ``gauss_external --debug``, ``matmul`` (three engines, ``--trace``:
   kernel events == launches) and the sparse check's smoke leg, each with
   ``--metrics-out``: ``sparse.solves`` == the ``sparse_solve`` events,
   and the SpMV launches their iteration counts imply. The run (a) is the
   path's launch counts; a ``{"telemetry": ...}`` JSON line carries the
   phase's figures.
6. Large-n routes (the chunked and flat factor forms, ``resolve_factor``'s
   size routing and ``solve_handoff``'s single-card lane):
   (a) ``resolve_factor`` on the card picks the unrolled form at 4096,
   chunk 4 at 8192 (panel 256) and chunk 8 at 12,800 (panel 128). (b)
   The chunked form at n=1024, panel 128, chunk 2 and 3 (a ragged last
   group), with every launch of the panel and fused kernels held against
   its plain version on the same input (the panel bit for bit, the fused
   kernel's block within TOL and bit for bit against the unfused pair):
   the fused kernel on the group's strided live rows, the panel kernel on
   each group's last panel; one fused launch with no trailing columns on a
   strided view; the whole factor with the same pivots as the same call
   on the CPU, and its ``m``/``linv``/``uinv`` no further from the
   float64 factor with those pivots (``lu_f64``, numpy) than F64_RATIO
   times the CPU's and than F64_CAP, in max |m| (TOL_FACTOR lies below
   float32 rounding at this size), again with the strip form forced. (c)
   n=8192 and n=12,800 at full size: launches by kernel and phase-A route
   against the form's plan; every launch of one factorization held
   against its plain version as in (b), the grid routes on strided
   group views among them (no launch of either cell on the one-block
   route); the factor's float64 backward error within
   BACKWARD_RATIO of ``torch.linalg.lu_factor``'s; a whole
   ``lu_factor_blocked_chunked`` call (CUDA events, median of 3) beside
   ``lu_factor`` on the same matrix, and one traced call: each kernel's
   device ms, each grid-route launch's ms by strip height, device busy
   and idle share. (d) The counted path:
   ``gauss_internal -s 8192 --verify``, ``solve_refined`` on the n=12,800
   internal system, the flat form at n=2048 (``unroll=False`` through the
   1e-4 gate; ``abft=True`` bit for bit equal to ``panel_impl="pallas"``
   with every checksum entry under the JAX package's threshold;
   ``zero_pivot_safe`` on a singular matrix: finite, min |pivot| 0), and
   ``solve_handoff`` at n=2048 (its ``route`` event), with exact launch
   counts; ``fits_single_chip`` at the card's budget (the ``dist`` lane
   runs in phase 14, apart from this process's card). A
   ``{"large_n": ...}`` JSON line carries the phase's figures.
7. The lowered-precision solve (``core/lowered``) on the bfloat16 forms
   of kernels 1-3: (a) kernel 1 at bfloat16 bit for bit against its plain
   version on the cluster route at (N, PANEL) and on the grid route
   at the first height past a bfloat16 cluster's reach (6,849 rows at
   panel 256; the C launchers' ``panel_cluster_info`` and
   ``panel_grid_info`` printed beside the Python rule), kernels 1 and 2
   at the n=8192 form's tallest strips ((7424, 256) and (8192, 1024)) on
   the grid route and the one-block route, both dtypes, bit for bit
   (``one_block_figures``), kernel 2 at (N, N) and on its grid route,
   kernel 3
   at (N, N), their blocks within TOL_BF16 and TOL_BF16_SHARE
   (bf16_block_check) and fused == pair bit for bit,
   each timed (CUDA events, median of --reps) beside the float32 kernel
   on the same input, the plain version and ``lu_factor`` on the float32
   strip; (b) ``solve_lowered`` at N on the dominant system ``a + N I``,
   each rung (``bfloat16``, ``bf16x3``, ``float32``): the factor's ms, the
   refinement steps used, the relative residual (<= 1e-4), the call's
   seconds and its launches against the plan; (c) each rung alone and
   ``solve_lowered_auto`` on the internal system and the cond ~1e6 system
   at N, each with its launches against the plans of the rungs it ran
   (a rung that fails typed included), the walk with a tune store written by the port's ``TuneStore``
   (start bfloat16, 6 steps): the served dtype, the demotions (at least
   one on the cond ~1e6 system), the answer verified; (d) the bfloat16
   chunked form at LOWERED_CHECK with every launch against its plain
   version and the factor against the float64 factor on its pivots
   (``lu_f64``; within F64_RATIO times the CPU's and F64_CAP_BF16), then
   at n=8192 (``resolve_factor``'s chunked form):
   every launch of one factorization against its plain version, launches
   by phase-A route beside the float32 form's, one factorization (median
   of 3) beside the float32 one and ``lu_factor``, one traced call, and
   ``solve_lowered(dtype="bfloat16")`` through the 1e-4 gate. The counted
   solves of (b)-(d) are the phase's launch counts; a ``{"lowered": ...}``
   JSON line carries its figures.
8. The structure router (``structure.solve_auto`` on the recovery
   ladder) on the card: (a) the batched panel kernel (kernel 1 over a
   (B, h, panel) stack, one launch) bit for bit against its plain version
   on a random (64, 128, 128) stack (the register step loop on one
   block), a stack of members taller than that loop takes (the one-block
   loop in global scratch) and a one-member stack against the
   single-strip kernel; (b) one ``solve_auto`` per class, each with the
   launch counts set to 0 just before and read just after: spd
   (``synthetic.spd_matrix`` at STRUCT_SPD, served by ``cholesky``, the
   class named by the caller where the detector calls the generator's
   matrix banded (n=8192: its entries are exact zeros past |i-j| = 537);
   and at each size a dense diagonally dominant SPD matrix (``spd_dense``)
   that the detector must call spd, routed with no class named; each
   factor's ms beside ``torch.linalg.cholesky`` and the port's LU on the
   same matrix), dense (``synthetic.dense_matrix(N)``, served by
   ``blocked`` with one factorization's kernel-1/kernel-2 plan), banded
   (STRUCT_BANDED: the tridiagonal scan and the block LU), blockdiag
   (STRUCT_BLOCKDIAG, 64 members in one bucket: one batched launch per
   factor, the cache's warm-up factor included, every launch held bit for
   bit against its plain version, the launches counted by the route each
   took, none on the one-block loop, the launch timed beside
   ``torch.linalg.lu_factor`` on the same stack and its bound); each
   served at rung 0 by its engine and verified by a float64 residual at
   the 1e-4 gate; (c) the demotions at STRUCT_DEMOTE_N: the spd system
   (at DEMOTE_RHO) tagged ``banded``, the dense system tagged ``spd``
   (both through a ``structure.detect`` plan) and a
   ``core.blocked.factor=nan`` plan on the dense system, each served verified by the rung DEMOTIONS names,
   with its ``recovery`` triggers printed. The routed leg of the sparse
   check runs in phases 4 and 5. A ``{"structure": ...}`` JSON line
   carries the phase's figures.
9. The solver service (``serve``: ``SolverServer``, admission, the
   load generator, ``serve.cli``) on the card: (a) the three batched
   kernels against their plain versions, one launch per stack: the
   batched fused kernel (kernel 2 over a (B, h, w) stack) at
   SERVE_FUSED_CHECK — (8, 4096, 4096) (tall members: phase A's grid
   route, 6 groups of 22 blocks: members 0-5, then 6 and 7), (8, 2048,
   2048) (more
   members than the 7 clusters the card holds at once: 8 groups of 16),
   (8, 512, 512) at panel 128, (8, 2048, 2048) in bfloat16, and
   (4, 1024, 1024) (one wave of clusters) — the route the launch took
   (``_build.ROUTE_LAUNCHES``) and the C launcher's route, K and G equal
   to ``fused_batched_geometry``'s, each member's pivots equal and
   its block within TOL (float32) or TOL_BF16/TOL_BF16_SHARE (bfloat16) of
   the plain version and bit for bit kernel 2 on that member alone; the
   batched panel kernel at SERVE_K1_CHECK (the service's last panels,
   (8, 256, 256) on a cluster of 4 and (8, 128, 128) on one block's
   registers, float32 and bfloat16) on the route the rule names (the C
   launcher's report and its count by route), bit for bit its plain
   version and kernel 1 on each member; each timed (CUDA
   events, median of --reps) beside the single-stack kernel looped over
   the members, the one-block route on the same stack (the fused kernel;
   ``panel_trailing_fused_one_block``), its plain version,
   ``torch.linalg.lu_factor`` on the (float32) stack and its bound (B
   times one member's); (b)
   ``lu_factor_blocked_batched`` on a (8, n, n) stack at every rung of
   the default ladder in float32 and at SERVE_BF16_N in bfloat16:
   launches equal to the plan (nb - 1 batched fused + 1 batched panel),
   the fused launches by the phase-A route each took, counted at the
   launch, equal to the rule's plan (each launch's C geometry equal to
   it, none on the one-block route), each
   member's ``m``/``perm``/``min_abs_pivot`` bit for bit
   ``lu_factor_blocked`` on it, ``linv``/``uinv`` within TOL_FACTOR,
   timed beside ``lu_factor`` on the stack; (c) the service at its
   default width (ladder 128-4096, batch 8, one refinement step, cache
   32, the 1e-4 verify gate, structure-aware), driven by
   ``loadgen.run_load`` closed-loop on SERVE_MIX (every rung and every
   lane: float32, bfloat16, bf16x3, spd, sparse) plus one n=6000
   request on the handoff lane: every request ``ok`` and verified, the
   ``numpy`` lane at 0, the launch counts equal to the plan of every
   factor the cache ran (warm-ups included) and of the handoff
   factorization, the batched fused launches by the route each took equal
   to the rule's plan, none on the one-block route, and the batched panel
   launches by the step loop each took equal to the rule's plan, none on
   the one-block loop; every batched panel launch of (c) and (e) recorded
   by (B, h, panel, dtype) and route, held bit for bit against its plain
   version after the run, each shape timed beside its bound and
   ``lu_factor``; lanes, cache, solves/s, p50/p99, occupancy; one full
   4096 batch taken apart (padding, staging, factor, solves, the host
   residual: the host staging share) and traced in a fresh process (its
   16 kernels as planned, a trace missing some taken again as in phase 6;
   device busy against host ms, the idle share), and in the server's own
   process, recording what it lost (queue-3 fault 1); (d) a transient
   ``serve.cache.compile`` fault retried and served, ``poison:nan`` and
   ``poison:singular`` rejected typed; (e) ``python -m gauss_tpu_torch.serve.cli --requests
   40 --metrics-out``: exit 0, the port's ``summarize`` renders ok = 40,
   ``requesttrace --check`` exits 0. The service run (c) is the path's
   launch counts; a ``{"serve": ...}`` JSON line carries the figures.
10. The checksum-carrying and checkpointed factorizations
   (``resilience/abft``, ``checkpoint``, ``abftcheck``, ``chaos``), each
   counted call with the launch counts set to 0 just before it and read
   just after: (a) ``lu_factor_abft`` on phase 6's random matrix at
   RES_LU (n=8192, panel 256, chunk 4): kernel 1 on every panel (the
   rider pins the unfused pair), its launches equal to the plan
   (``abft_plan``: 19 grid, 13 cluster, plus each replayed group), the
   factor bit for bit ``lu_factor_blocked_chunked`` with ``abft=True`` and
   with ``panel_impl="pallas"``, no detection on the clean run (its largest
   group mismatch over ``tol`` printed), every launch of one factorization
   held against its plain version (``checked_launches``); one transient
   ``sdc_bitflip`` in group RES_FLIP_GROUP right of the group's columns
   (the plan seed picked by ``planned_flip``), detected in that group at
   the flipped column and replayed to the clean bits; one flip in the last
   group (which check caught it printed), replayed to the clean bits; a U
   flip that only the final identity reads (a stand-in flips it in the
   identity's first input): in the last group's columns replayed once
   from the rollback point to the clean bits, in group 0's escalated; one
   persistent flip: ``SDCUnrecoverableError`` at its group, and
   ``solve_resilient(abft=True)`` escalating past it to a verified answer;
   ``solve_lu_abft`` on the internal system; the runner's ms (CUDA events,
   median of 3) beside the chunked form's plain, ``abft=True`` and
   ``"pallas"`` ms. (b) ``lu_factor_blocked_chunked_checkpointed`` at the
   same cell: bit for bit the chunked factor, kernel 1 by key and kernel
   2 by phase-A route equal to ``factor_plan``'s, the seconds and bytes of each save, its wall
   ms; a child process killed (``GAUSS_FAULTS=checkpoint.group=kill``) at
   the third group boundary with the kernels this process built (its
   ``build_all`` seconds all 0), resumed here bit for bit with the rest of
   the plan's launches. (c) ``cholesky_factor_abft`` at RES_CHOL on
   ``spd_matrix``: bit for bit the flat form with and without the rider,
   one transient flip replayed, ms beside the flat and unrolled forms. (d)
   ``abft_matmul`` at (RES_MM,)^3 in "highest" and "high": the clean
   product equal to ``core.matmul``'s, single flips until one is corrected
   in place (each flip past ``tol`` detected and fixed within it, each
   below it harmless), a flipped row recomputed, ms beside ``core.matmul``.
   (e) one ``lu_factor_abft`` at each campaign size (abftcheck's
   ``LU_SIZES``, chaos's ``SOLVER_SIZES``, at RES_CAMPAIGN_PANEL) and at
   RES_SERVE_N with every kernel-1 launch held against its plain version
   and the checked launches equal to the plan's; ``abftcheck`` at its
   defaults (110 cases: 100% detection, every replay bit for bit, exit 0)
   and ``chaos --no-fleet`` at RES_CHAOS_ARGS (exit 0, no silent wrong
   answer; its durable phase's four kill/resume cases, one per
   ``durablecheck.CASE_KINDS``, without a violation), the input of each
   of their calls of the
   single-strip panel, batched panel and SpMV kernels kept
   (``kept_launches``) and held bit for bit against the plain version
   after them, every launch of theirs among the kept calls; and a
   ``SolverServer`` with ``abft=True`` on RES_SERVE_REQUESTS + 1 systems
   at RES_SERVE_N past the ladder top (the ``abft`` route, ``ok`` at 1e-4, the last one with
   a flip tagged ``sdc_detected``; launches equal to the plan). A
   ``{"resilience": ...}`` JSON line carries the figures and the phase's
   wall time.
11. The host-streamed out-of-core solve (``outofcore/stream``,
   ``outofcore/check``, the ``outofcore`` rung and the handoff lanes),
   each counted call with the launch counts set to 0 just before it and
   read just after, against the streamed factor's plan (the in-core
   chunked form's at the same panel and chunk). Step 0 prints the host's
   budget, ``torch.cuda.mem_get_info()``, the seconds to pin OOC_PIN_BYTES
   and one contiguous pinned copy's GB/s each way. (a) ``python -m
   gauss_tpu_torch.outofcore.check`` at its defaults (smoke n=2048, chunk
   4, ct 256; routing n=192): verified at 1e-4, tiles >= 2, the ledger's
   peak under 50% of 3 n^2 4, one ``route`` event with
   ``lane=outofcore`` on its ``--metrics-out`` stream. (b) The JAX
   package's acceptance scale, OOC_N (n=32768, the check's
   ``_seeded_system`` in float32, panel 128, chunk 16, ct OOC_CT): the
   streamed factor, then the streamed solve with three refinement steps,
   each timed with nothing around its launches; the residual at 1e-4; the
   ledger's and the allocator's peaks under 50% of 3 n^2 4; a second
   streamed factor, bit for bit the first, with every launch of the first
   group and each route's tallest and shortest launch kept and held
   against the plain version after it (``checked_launches`` with
   ``held`` and ``deferred``), every launch timed by CUDA events; the
   pivots equal to the in-core ``lu_factor_blocked_chunked``'s, its bits
   compared (printed), both factors' float64 backward error within BACKWARD_RATIO
   of ``lu_factor``'s (``ooc_backward_err``); the ``StreamStats`` with the
   GB and GB/s each way, beside the in-core factor's and ``lu_factor``'s
   seconds. (c) ``solve_handoff(a, b)`` with no budget and no engine on a
   float32 system of OOC_BIG_N (``big_system``, made in row blocks),
   past the card's budget: the ``route`` event ``lane=outofcore``, the
   residual at 1e-4, the launches against the plan, those on the one-block
   routes (strips past the grid route's 57,575 rows) counted and timed,
   and each route's tallest and shortest launch of kernels 1 and 2 kept
   and held against the plain version after the call.
   (d) At OOC_RIDERS (phase 6/10's n=8192 cell, ct 1024): ``abft=True``
   clean (its largest group mismatch over ``tol``), an ``outofcore.tile``
   nan plan raising ``SDCDetectedError`` at the group and column the plan
   poisons (``planned_tile_fault``; the CPU tests hold the group against
   the JAX package's), and a child killed (``GAUSS_FAULTS=
   outofcore.group=kill``) at the third group boundary resumed here from
   its checkpoint bit for bit. (e) ``solve_resilient(rungs=("outofcore",
   "numpy_f64"))`` served by ``outofcore``, and a ``SolverServer`` with
   ``outofcore_handoff=True`` and a ``device_budget`` one byte below the
   request's working set serving one n=6000 request ``ok`` at 1e-4 on
   lane ``outofcore`` (its ``serve_handoff`` route event). An
   ``{"outofcore": ...}`` JSON line carries the figures.
12. The durable and network service (``serve/durable``, ``serve/net``,
   ``serve/durablecheck`` and the journaled server); no CPU fallback.
   (b) runs first and alone: its timed run (the loadgen plan) shares the
   card and the host with nothing else; in a whole run phase 13 (a)'s
   timed run follows it, alone too. Then (c) and (a), each in a process
   of its own, run beside the rest of (b) (its oversized request and its
   checks; their figures are taken with the others running, phase 13's
   campaigns among them), and last (a)'s overhead leg.
   (a) ``python -m gauss_tpu_torch.serve.durablecheck`` at NET_CAMPAIGN
   (the JAX package's CI configuration, seed 258458, cut from 28 cases to
   8 and without its subprocess legs: chaos's durable phase in phase 10
   and replicacheck's failover cases in phase 13 run the same case
   runners, and (c), phase 13 (c)'s crash-loop and supervised legs and
   13 (e)'s kill leg the same real deaths) on the card with
   ``--no-overhead``: its four recovery kinds; 0 lost, 0 duplicate
   terminals, 0 duplicate solves, 0 unverified, exit 0; every
   batched-kernel launch of its
   in-process cases held against the plain version at once
   (``held_batched_launches``). Its overhead leg
   (``durablecheck.run_overhead_phase``: journal-off, then journal-on,
   seconds per request and their ratio) runs in this process at the end
   of the phase (``net_overhead``). (b) The wire, at phase 9's
   configuration (SERVE_LADDER, batch, one refinement step, SERVE_MIX:
   bf16, bf16x3, spd and sparse tokens) with a journal in a temporary
   directory: a ``SolverServer`` behind ``ReplicaApp`` + ``RequestApi``
   on 127.0.0.1, port 0, driven by ``loadgen.run_load`` through a
   ``SolveClient`` (``net_load``: the mix's weights, NET_WARMUP warm-up
   requests as a burst, then NET_REQUESTS keyed ones closed loop x
   SERVE_CONCURRENCY, its request count cut, its sizes not; every
   operand above 4 MiB by chunked upload), then one keyed SERVE_OVERSIZE
   request (the handoff lane); the launch counts are this run's (path
   ``net``). Every batched factor of the run is kept (its host stack and
   its factor) and run again after it with every launch held against the
   plain version at once, bit for bit the same factor; the handoff's
   kernel-1/2 launches are held after the run (``checked_launches``).
   Every ``ok`` answer verified at 1e-4 from the journaled operands
   (``durablecheck.audit``: one terminal per key); each system submitted
   again in process to the same server (its worker solves them while the
   held re-run runs on this thread; only that thread's launches are
   held), the largest difference relative to |x| printed and whether the
   two are equal bit for bit; then every
   key resubmitted over the wire, SERVE_CONCURRENCY at once: its
   journaled terminal, bit for bit, with no kernel launch and no new
   batch. Printed: solves/s beside phase 9's; each measured request's seconds seen from the client
   (p50, p99, mean, and its uploads' share) and from the server
   (admission to terminal); upload MB/s of the 4096-bucket operands; the
   journal's appends, fsyncs, bytes, seconds of appends per key and the
   scan's seconds. (c) A replica child (``python -m
   gauss_tpu_torch.serve.net --replica``, port fixed for its restarts)
   under ``durable.supervise`` (a supervisor process of its own) with
   ``GAUSS_FAULTS=serve.server.batch=server_kill`` at a seeded boundary
   (NET_KILL_SKIP, past every batch the warm-up can make, so after its
   4096-bucket batch, in the measured waves): a
   ``SolveClient`` that reads ``endpoint.json`` drives the start of
   (b)'s plan (the warm-up and NET_KILL_REQUESTS) through ``run_load``,
   through the kill and the restart; the audit (every key admitted once,
   one terminal per key, every ``ok`` at 1e-4), restarts = 1, a 4096
   batch done before the kill (its blame record), the replayed count,
   the seconds from the kill to the first replayed terminal; SIGTERM
   drains the replica to exit 116 and a clean-shutdown marker; one more
   start replays nothing; each incarnation's build seconds (0: it loaded
   this checkout's libraries). A ``{"net": ...}`` JSON line carries the
   figures.
13. The replicated service behind the router (``serve/router``,
   ``serve/replicacheck``, ``serve/poisoncheck``, ``obs/flight``,
   ``obs/postmortem``, ``obs/debug``, ``obs/flightcheck``,
   ``obs/regress``); no CPU fallback. (a)'s timed run runs alone, right
   after phase 12 (b)'s (the router then stays up until phase 12 is
   done; its seconds count to phase 13): a
   ``Router`` + ``RouterFront`` over ROUTER_REPLICAS replica processes on
   the card (``python -m gauss_tpu_torch.serve.net --replica``, each with
   a journal and its ``flight/`` ring), at phase 12 (b)'s configuration
   and plan (``net_load``), driven by ``loadgen.run_load`` through a
   ``SolveClient``; once the warm-up is back, the replica with the deepest
   queue is SIGKILLed (its launches read from its ``/healthz`` just
   before) and the router fails its journal over to a peer and respawns
   it. Then one probe to the respawned replica (a key whose ring position
   falls on it), every key resubmitted through the router (its journaled
   terminal, bit for bit; the replicas serve nothing more), the audit of
   the union of the live and retired journals (``replicacheck
   .audit_union``: 0 lost, 0 duplicate terminals, every ``ok`` at 1e-4),
   ``journal-failed-1`` adopted, one failover, the dead replica's bundle
   passing ``python -m gauss_tpu_torch.obs.debug --check``; the launches
   are the replicas' (``/healthz``: the victim's before the kill, the live
   ones' at the end; path ``router``). Every system of the run is solved
   again in this process with every batched launch held against its plain
   version (``held_batched_launches``), beside the journaled answers.
   Printed: solves/s through the router beside phase 12's one replica and
   phase 9's in process, and its ratio to phase 12's (three replicas
   against one at the service's ladder, same plan, same run; no gate:
   (a)'s window also holds the kill and its failover), the client's
   p50/p99, the failover's seconds and the kill-to-live seconds. Then,
   each in a process of its own, started
   after (a)'s timed run, beside phase 12's checks and (a)'s on the card
   (in turn after them on the CPU): (b) ``replicacheck`` at
   REPLICA_CAMPAIGN (the JAX package's CI configuration) with its
   ``--history`` in a file of its own, then ``obs.regress check`` of its
   summary against that file (verdicts stamped with the card); (c)
   ``poisoncheck`` at POISON_CAMPAIGN
   ``--no-mesh`` (0 replica restarts, the crash loop broken); (e)
   ``flightcheck`` (the SIGKILLed child's bundle passes ``--check``); the
   in-process cases of (b) and (c) with every batched launch held. (d)
   is ``chaos``'s durable phase, in phase 10. A ``{"router": ...}`` JSON
   line carries the figures.
14. The distributed and native engines (``dist/``, ``native/``), every
   distributed leg in a process of its own (NCCL's init and teardown
   touch no other phase): (a) ``cuda-dist-blocked`` and
   ``cuda-dist-blocked2d`` at DIST_N (n=8192, float32, a random system)
   on a world of one over NCCL (no NCCL: the phase fails; it never takes
   gloo), after a warm-up at DIST_WARM_N: each engine's staging, factor
   and solve seconds (the 1-D engine's factor carries the augmented
   right-hand side) and two host-f64 refinement steps to the 1e-4 gate,
   its collectives by kind, beside the port's ``cuda`` backend's factor
   and solve on the same system; kernel 1's launches by route on the 1-D
   engine's panel strips (counts set to 0 just before, read just after:
   one per panel, no other kernel), every one held bit for bit against
   its plain version on a re-run (``held_kernel1``), and
   ``recommend_engine(8192)`` the 2-D engine. (b) every distributed
   backend through ``gauss_internal -s 2048 --verify`` and ``matmul 2048
   --engines cuda-dist`` on (a)'s world, and ``gauss_external`` on the
   generator matrix (phase 4's file) through ``cuda-dist-blocked`` in a
   process of its own beside (a) (``dist_external``: the Python parse of
   4.2 M lines takes seconds), held, as it does not refine, to phase 4's
   float32 backward error on a re-run. (c) ``gauss_internal
   --backend cuda-dist-blocked`` with ``--coordinator 127.0.0.1:<port>
   --num-processes 1 --process-id 0 --metrics-out``: the stream is
   ``<base>.p0.jsonl``, ``python -m gauss_tpu_torch.obs.aggregate`` merges
   it, and it holds the ``collective`` events; (b)'s and (c)'s kernel-1
   launches six times one n=2048 solve's (the CLIs solve twice), that
   solve's held on a re-run. (d) in a process of its own beside
   (a)-(c) (``native_child``): ``make`` of the native library into an
   empty build dir (its seconds printed), then every native gauss engine
   at NATIVE_N through ``gauss_internal --verify`` and ``matmul --engines
   cuda,seq,omp`` on the card's host, on NATIVE_THREADS threads (cut to
   n=512 for the phase's budget, DIST_BUDGET_S). In a whole run the phase
   starts with phase 8, whose checks hold no time, runs beside it, and
   ends after it (beside phase 13's campaigns it starved their stall
   leg's deadline).
   A ``{"dist": ...}`` JSON line carries the figures.
15. The ``kernels`` JSON line, the card line, and the final
   ``{"ok": true, "device": ...}`` line.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N = 2048
PANEL = 256
SEED = 258458
DEVICE = "cuda"  # the card; the tests rehearse the script on "cpu"
# Published H100 SXM peaks: HBM bandwidth, float32 outside the tensor
# cores (the kernels run FP32 on CUDA cores), and dense bf16 on the tensor
# cores (the floor of the bf16x3 "high" matmul's three bf16 products).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12
# float64 outside the tensor cores (NVIDIA's H100 SXM data sheet): the
# SpMV kernel's float64 products and sums run there.
PEAK_F64_FLOP_S = 34e12
TOL = 5e-5  # relative to the operand's scale (f32 summation order)
# A bfloat16 block of the fused and trailing kernels against the plain
# version, relative to max |plain|: four bfloat16 ulps (2^-7 each) at that
# scale. Both sum in float32 and round once per segment, in another order,
# so a sum may round to the other bfloat16 neighbour, and such a flip in a
# pivot row's U enters every later row through |m| <= 1, once per segment.
TOL_BF16 = 4 * 2.0 ** -7
# The share of a bfloat16 block's trailing elements that may differ from
# the plain version at all. An order flip needs a float32 sum to straddle
# a bfloat16 rounding boundary, which few do; a kernel that breaks the
# contract (U applied unrounded, one rounding per panel, a bfloat16
# accumulator) moves most elements by about an ulp of their own size,
# which TOL_BF16 alone, at the block's largest, may not see.
# scripts/probe_bf16_faults.py plants those faults and reads both limits.
TOL_BF16_SHARE = 0.05
# Kernel vs plain, relative to max |plain|: the matmul kernels' FMA chains
# over K = 2048 against cuBLAS's blocked sums, and the rank-k update's over
# k = 256.
MM_TOL = 1e-5
# (m, k, n) shapes kernel 5 is also held to its plain version at: one row,
# ragged rows, columns and K (lda = 777: the 4-byte copy), and a K under
# one ring stage.
STRIPE_SHAPES = ((1, 2048, 2048), (2049, 777, 1000), (130, 17, 130))
# Cluster sizes kernel 1's cluster route is timed at, by strip height
# (width PANEL): the rule's size among them.
PANEL_CLUSTER_SWEEP = {256: (2, 3, 4, 8, 16), 1024: (5, 8, 12, 16),
                       2048: (10, 12, 14, 16)}
# Group sizes G kernel 1's grid route is timed at, by strip shape: the
# rule's G among them.
PANEL_GRID_SWEEP = {(2 * N, PANEL): (32, 128), (7424, PANEL): (58, 116),
                    (12800, PANEL // 2): (67, 132)}
RANKK_TOL = 1e-5
# (R, k, C) shapes kernel 7 is also held to its plain version at: ragged
# rows, K and columns, one row, and a K that is no multiple of a ring
# stage with 129 columns (4-byte copies of u).
RANKK_SHAPES = ((513, 17, 1000), (1, 256, 2304), (130, 300, 129))
# Normwise backward error ||b - Ax||_inf / (||A||_inf ||x||_inf + ||b||_inf)
# of a float32 solve without refinement: a few units of float32 rounding.
BACKWARD_TOL = 16 * 2.0 ** -24
# The sparse plane: the generator's entries per row in the giant legs, the
# orders whose ELL operands the SpMV kernel is checked and timed at (with
# the padded-row widths the generator gives there), the smoke order, and
# the residual gate.
SPARSE_NNZ = 20
SPARSE_NS = (100_000, 1_000_000)
SPARSE_ELL_K = {100_000: 36, 1_000_000: 37}
SPARSE_SMOKE_N = 640
GATE = 1e-4
# Device activity in a torch.profiler Chrome trace.
TRACE_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The telemetry phase's spans of one --phase-profile --verify run of the
# blocked backend: the JAX package's list, with the port's warm-up label
# and without its XLA cost span.
TELEMETRY_SPANS = {"setup_env", "initMatrix", "host_staging",
                   "compile:cuda_blocked_warmup", "computeGauss",
                   "health_monitors", "phase_profile", "pad_stage",
                   "panel_factor", "pivot_apply", "trailing_update", "verify"}
PHASES = ("pad_stage", "panel_factor", "pivot_apply", "trailing_update")
# Phase 6. resolve_factor's picks on the card: (n, form, chunk, panel).
ROUTES = ((4096, "unrolled", None, 256), (8192, "chunked", 4, 256),
          (12800, "chunked", 8, 128))
# The chunked form checked launch by launch: n, panel, the chunks (2:
# even groups; 3: a ragged last group), and the strip height that forces
# the deferred update's strip form (with its byte gate set to 0).
CHUNK_CHECK = (1024, 128, (2, 3))
CHUNK_CHECK_STRIP = 160
# The full-size cells: (n, panel, chunk) as ROUTES gives them.
LARGE_CELLS = ((8192, 256, 4), (12800, 128, 8))
FLAT_N = 2048
# Factor fields against the CPU: tests/test_torch_blocked.py's tolerance
# for m, linv and uinv, relative to max |m|. At n=1024 it lies below the
# float32 rounding of the factorization itself (the CPU's float32 factor
# is 1.1e-4 to 1.6e-4 of max |m| from the float64 factor with the same
# pivots, lu_f64), so there the card's factor is held to the float64
# factor: no further from it than F64_RATIO times the CPU's float32
# factor, and than F64_CAP.
TOL_FACTOR = 5e-5
F64_RATIO = 2.0
F64_CAP = 4e-4
# The same cap for phase 7's bfloat16 chunked factor of the dominant
# system against the float64 factor on its pivots, field by field over the
# field's max (the card and the CPU both read 4.1e-5 to 8.3e-5).
F64_CAP_BF16 = 2e-4
# The full-size factors' float64 backward error ||A[perm] - LU||_F /
# ||A||_F: at most BACKWARD_RATIO times torch.linalg.lu_factor's on the
# same matrix.
BACKWARD_RATIO = 4.0
# Phase 7: the bfloat16 chunked form held to the float64 factor on its
# pivots (n, panel, chunk), and the full-size cell resolve_factor picks.
LOWERED_CHECK = (1024, 128, 2)
LOWERED_LARGE = (8192, 256, 4)
# Phase 8's cells: the reference's structure sizes at full width.
STRUCT_SPD = (2048, 8192)
STRUCT_BANDED = ((8192, 1), (8192, 16))
STRUCT_BLOCKDIAG = ((2048, 32), (8192, 128))
STRUCT_DEMOTE_N = 2048
# The spd system of the demotions: the generator at rho = 0.7 (SPD, cond
# ~32). At the default rho = 0.25 its float32 entries are exactly 0 past
# |i-j| = 75, so at n=2048 the band engine (which stages float32) serves
# it at rung 0 in both packages and nothing demotes.
DEMOTE_RHO = 0.7
STRUCT_BATCH_CHECK = ((64, 128, 128), (3, 512, 128))
# The demotion cases: (name, true system, forced tag or fault plan, the
# rungs that fail in order, the serving rung).
DEMOTIONS = (
    ("spd tagged banded", "spd", "banded", ("banded",), "blocked"),
    ("dense tagged spd", "dense", "spd", ("cholesky",), "blocked"),
    ("dense, core.blocked.factor nan", "dense",
     "core.blocked.factor=nan:p=1:max=1", ("blocked",), "pivot_safe"),
)


# Phase 9's cells. (a) The batched fused kernel's stacks (B, n, panel,
# dtype): tall members (n=4096) and more members than the card's clusters
# at once (n=2048) on the grid route, a panel-128 rung, the bfloat16 form,
# and one wave of clusters (B = 4); the batched panel kernel's stacks
# (B, h, panel, dtype) at the service's last panels, both lanes. (b) The default serving ladder (the JAX package's
# serve/buckets.py), its batch, and the bfloat16 rung. (c) The service:
# its mix reaches every rung and lane; one oversized request takes the
# handoff lane. (d) The poison order. (e) The CLI run.
SERVE_FUSED_CHECK = ((8, 4096, 256, "float32"), (8, 2048, 256, "float32"),
                     (8, 512, 128, "float32"), (8, 2048, 256, "bfloat16"),
                     (4, 1024, 256, "float32"))
SERVE_K1_CHECK = ((8, 256, 256, "float32"), (8, 128, 128, "float32"),
                  (8, 256, 256, "bfloat16"), (8, 128, 128, "bfloat16"),
                  (64, 128, 128, "bfloat16"))
SERVE_LADDER = (128, 256, 512, 1024, 2048, 4096)
SERVE_BATCH = 8
SERVE_BF16_N = 2048
SERVE_MIX = ("random:100,random:250,random:500,random:1000,random:2000,"
             "random:4000*2,internal:3000,spd:1500,dtype:bfloat16/2048,"
             "dtype:bf16x3/1024,sparse:3000/20")
SERVE_OVERSIZE = 6000
SERVE_WARMUP, SERVE_REQUESTS, SERVE_CONCURRENCY = 16, 120, 8
SERVE_REFINE = 1
SERVE_POISON_N = 256
SERVE_CLI_REQUESTS = 40
SERVE_CLI_MIX = "random:100*2,random:300,spd:200,dtype:bfloat16/500"
SERVE_CLI_ARGS: tuple = ()
#: Phase 10: the checksum-carrying LU (phase 6's n=8192 cell), the groups
#: of its transient and persistent flips, the subprocess kill's skip (the
#: third group boundary), the Cholesky sizes, the matmul size, the
#: service's abft requests, and the chaos campaign's cut.
RES_LU = (8192, 256, 4)
RES_FLIP_GROUP = 3
RES_PERSIST_GROUP = 2
RES_KILL_SKIP = 2
RES_CHOL = (2048, 8192)
RES_MM = 2048
RES_SERVE_N = SERVE_OVERSIZE
RES_SERVE_REQUESTS = 3
RES_ABFTCHECK_ARGS: tuple = ()
RES_CAMPAIGN_PANEL = 16     # the campaigns' default --panel
#: chaos's solver cases cut from 100 to 40 to keep the whole run inside
#: its budget once phase 13 joined it (its durable phase now runs too).
RES_CHAOS_ARGS = ("--cases", "40", "--serve-requests", "20")
LU_FIELDS = ("m", "perm", "min_abs_pivot", "linv", "uinv")
#: Phase 11: the out-of-core solve. (a) the check CLI at its defaults (its
#: extra arguments); (b) the JAX package's acceptance scale
#: (``check.py --giant``) at its tile width (the card's 80 GB budget would
#: make the auto window one tile); (c) the smallest multiple of the
#: 128-column panel whose float32 working set 3 n^2 4 exceeds the card's
#: budget (0.85 of its memory: 72.3e9 B, so n > 77,621), and the bytes
#: pinned and copied in Step 0; (d) the riders at phase 6/10's n=8192 cell
#: (n, panel, chunk) with ct 1024, the tile fault's skip (the third tile
#: of group 1) and the kill's (the third group boundary); (e) the ladder's
#: n and the service's one request past the ladder top.
OOC_CHECK_ARGS: tuple = ()
OOC_N, OOC_CT = 32768, 2048
OOC_BIG_N = 77696
OOC_PIN_BYTES = 4 * 2**30
OOC_RIDERS = (8192, 256, 4, 1024)
OOC_TILE_SKIP = 9
OOC_KILL_SKIP = 2
OOC_LADDER_N = 4096
OOC_SERVE_N = SERVE_OVERSIZE
OOC_FIELDS = ("m", "perm", "linv", "uinv")
CHOL_FIELDS = ("m", "linv", "min_diag")
#: Phase 12: the durable campaign's CLI arguments (the JAX package's CI
#: configuration, its 28 cases cut to 8 and its subprocess legs left out:
#: phase 10's chaos and phase 13's replicacheck run the same recovery and
#: adoption cases, and (c), phase 13's crash-loop, supervised and flight
#: kill legs the same real deaths). The wire's
#: plan (``net_load``): phase 9's mix and
#: weights, NET_WARMUP warm-up requests, then NET_REQUESTS (one wave of
#: SERVE_CONCURRENCY) closed loop: phase 9's sizes, its request count cut
#: to keep the whole run inside its limit on a slower host (a 4096-bucket
#: operand costs seconds of encoding, upload and journal, and every key is
#: checked three times after the run; ``net_load`` picks its seed). (c)
#: drives the same plan. The range the kill's seeded batch boundary is drawn
#: from: past every batch the warm-up can make (one a request at most),
#: so the kill falls in the measured waves, after the warm-up's
#: 4096-bucket batch; the delay injected before each batch of the killed
#: incarnation, so that requests wait in its queue when it dies; the
#: supervisor's stall threshold.
NET_CAMPAIGN = ("--cases", "8", "--seed", str(SEED), "--no-subprocess")
NET_WARMUP, NET_REQUESTS, NET_KILL_REQUESTS = 4, 8, 8
NET_KILL_SKIP, NET_DELAY_S = (4, 6), 2.0
NET_STALL_S = 60.0
#: Phase 13: the router's replicas (at phase 12 (b)'s configuration and
#: plan), how long a replica may take to reach the card and publish its
#: endpoint, how long the kill after the warm-up waits for a queue to
#: form, and the size of the probe sent to the respawned replica; the
#: campaigns' CLI arguments (the JAX package's CI seeds, with 12 cases
#: each where its CI runs 30 and 28, so that the whole script stays well
#: inside its time limit; every kind and every leg still runs); the delay
#: injected before each batch of the child flightcheck kills.
ROUTER_REPLICAS, ROUTER_SPAWN_S, ROUTER_KILL_WAIT_S = 3, 600.0, 60.0
#: The host threads of each process ``start_own_process`` starts (and of
#: the servers and replicas those start): phases 12 and 13 run up to five
#: such processes, each spawning replicas, beside the main process on the
#: host's 8 cores, and every process's BLAS and torch pools would
#: otherwise take all 8.
BACKGROUND_THREADS = {"OMP_NUM_THREADS": "2", "OPENBLAS_NUM_THREADS": "2",
                      "MKL_NUM_THREADS": "2"}
ROUTER_PROBE_N = 200
REPLICA_CAMPAIGN = ("--cases", "12", "--seed", "190733")
POISON_CAMPAIGN = ("--cases", "12", "--seed", "777201")
FLIGHT_KILL_DELAY_S = 0.05


def require(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0] if out else ""


_SPIN_S_PER_CYCLE: list[float] = []


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of one ``fn()`` over ``reps`` back-to-back
    calls, by CUDA events around the whole run. A spin kernel
    (``torch.cuda._sleep``) queued first holds the card while the host
    enqueues every call, so the span holds the calls' device time and none
    of the host's launch gaps: the small kernels here take less time on
    the card than their wrappers take on the host."""
    import torch

    if not _SPIN_S_PER_CYCLE:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        torch.cuda._sleep(1 << 22)
        e.record()
        e.synchronize()
        _SPIN_S_PER_CYCLE.append(s.elapsed_time(e) / 1e3 / (1 << 22))
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int((3 * reps * host_s + 1e-3) / _SPIN_S_PER_CYCLE[0]))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def quiet_fd1():
    """Silence file descriptor 1 (C-level stdout) for a library call that
    prints there: MAGMA's batched LU warns on every tall strip."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(os.devnull, "w") as null:
        os.dup2(null.fileno(), 1)
        try:
            yield
        finally:
            os.dup2(saved, 1)
            os.close(saved)


def bound(nbytes: float, flops: float, peak_flop_s: float = PEAK_F32_FLOP_S):
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / peak_flop_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def bound_bf16(nbytes: float, step_ops: float, gemm_ops: float):
    """A bfloat16 kernel's bound: its bytes, or its operations, the step
    loop's elementwise ones at the float32 CUDA-core rate (each rounds on
    its own) and the trailing update's products at the bf16 tensor-core
    rate, the larger."""
    t_b = nbytes / PEAK_BYTES_S
    t_f = step_ops / PEAK_F32_FLOP_S + gemm_ops / PEAK_BF16_FLOP_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def panel_ops(h: int, panel: int, kb: int) -> float:
    """Operations of the panel factor on live rows: per step an argmax
    over the live column, one division per live row, and one multiply-add
    per live row and column right of the step."""
    ops = 0.0
    for j in range(panel):
        live = h - kb - j
        ops += live + (live - 1) + 2.0 * (live - 1) * (panel - j - 1)
    return ops


def trailing_ops(h: int, kbrow: int, panel: int, ncols: int) -> float:
    """U12 = L11^-1 A12 (panel^2 per column) and A22 -= L21 U12."""
    return ncols * (panel * panel + 2.0 * (h - kbrow - panel) * panel)


def phase_toolchain():
    import torch

    from gauss_tpu_torch.utils.device import resolve_device

    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    from gauss_tpu_torch.kernels import _build

    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"phase 1: nvcc {nvcc}: {ver[-1] if ver else '?'}; "
          f"CUDA_HOME={os.environ.get('CUDA_HOME')}")
    try:
        import triton  # noqa: F401  (reported only; the port does not use it)

        print(f"phase 1: triton {triton.__version__} imports")
    except ImportError as e:
        print(f"phase 1: triton does not import ({e})")
    card = smi_line()
    print(f"phase 1: card {card}; torch sees "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    resolve_device("cuda")
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 is on for cuBLAS matmuls")
    require(not torch.backends.cudnn.allow_tf32, "TF32 is on for cuDNN")
    print("phase 1: TF32 off (cuBLAS and cuDNN): float32 matmuls are true "
          "float32")


def phase_build():
    from gauss_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"phase 2: built {', '.join(f'csrc/{k}.cu ({v:.1f} s)' for k, v in secs.items())} "
          f"for sm_90a in {time.perf_counter() - t0:.1f} s wall")


def phase_kernels(reps: int):
    import torch

    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.kernels import panel_fused as kf
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    rng = np.random.default_rng(SEED)
    dev = torch.device(DEVICE)

    k1 = phase_panel(reps, rng)

    if DEVICE == "cuda":
        for kernel, (regs, spill, smem) in sorted(
                ptxas_usage("panel_fused").items()):
            print(f"phase 3: ptxas -v, csrc/panel_fused.cu {kernel}: "
                  f"{regs} registers, {spill} bytes of spill stores, "
                  f"{smem} bytes of static shared memory")

    # Kernels 2 and 3 at the 7 fused launch shapes of one factorization:
    # block = the live rows m[kb:] (h = N - kb, width N), panel at col0 = kb.
    k2 = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
          "flops": 0.0, "bytes": 0.0, "err": 0.0, "phase_a_ms": 0.0,
          "phase_a_device_ms": 0.0, "routes": set()}
    k3 = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
          "flops": 0.0, "bytes": 0.0, "err": 0.0}
    for kb in range(0, N - PANEL, PANEL):
        rec = fused_shape(reps, rng, N - kb, N, kb)
        k2["routes"].add(rec["route"])
        k2["phase_a_ms"] += rec["phase_a_ms"]
        k2["phase_a_device_ms"] += rec["phase_a_device_ms"]
        for acc, key in ((k2, "fused"), (k3, "trailing")):
            r = rec[key]
            for f in ("ms", "device_ms", "plain_ms", "bound_ms", "flops",
                      "bytes"):
                acc[f] += r[f]
            acc["err"] = max(acc["err"], r["err"])
    for acc in (k2, k3):
        acc["bound_by"] = bound(acc["bytes"], acc["flops"])[1]
    print(f"phase 3: the 7 fused launches: ms {k2['ms']:.4f} (phase A alone, "
          f"the panel kernel on each strip: {k2['phase_a_ms']:.4f}; phase B "
          f"alone, the trailing kernel: {k3['ms']:.4f}); device ms "
          f"{k2['device_ms']:.4f} (phase A {k2['phase_a_device_ms']:.4f}, "
          f"phase B {k3['device_ms']:.4f}); bound {k2['bound_ms']:.5f}")
    # The grid route of phase A: a strip taller than a cluster holds.
    k2["tall"] = fused_shape(max(3, reps // 4), rng, 2 * N, 2 * N, 0)
    k2["routes"].add(k2["tall"]["route"])
    require(DEVICE != "cuda" or k2["tall"]["route"] == "grid",
            "the tall strip's fused launch did not take the grid route")

    # One whole n=N factorization: the kernels plus the torch work between
    # launches (row gathers, diagonal-block inverses, the U-inverse pass),
    # beside torch.linalg.lu_factor on the same matrix.
    from gauss_tpu_torch.core import blocked

    a = torch.as_tensor(rng.standard_normal((N, N)), dtype=torch.float32,
                        device=dev)
    fac_ms = cuda_event_ms(lambda: blocked.lu_factor_blocked_unrolled(
        a, panel=PANEL, device=DEVICE), max(3, reps // 2))
    with quiet_fd1():
        lu_ms = cuda_event_ms(lambda: torch.linalg.lu_factor(a), reps)
    k2["factorization_ms"], k2["lu_factor_ms"] = fac_ms, lu_ms
    print(f"phase 3: one n={N} factorization (lu_factor_blocked_unrolled): "
          f"{fac_ms:.4f} ms; its kernels "
          f"{k1['ms'] + k2['ms']:.4f} ms "
          f"(panel at ({PANEL}, {PANEL}) + the 7 fused shapes); "
          f"torch.linalg.lu_factor on the same ({N}, {N}) matrix "
          f"{lu_ms:.4f} ms")
    from gauss_tpu_torch.kernels import _build

    print(f"phase 3: launch counts over these checks and timings: "
          f"{dict(_build.LAUNCHES)}")
    return k1, k2, k3


def fused_shape(reps: int, rng, h: int, wtot: int, kb: int) -> dict:
    """Kernels 2 and 3 on one (h, wtot) block with the panel at col0 = kb
    (kbrow 0): the fused kernel against its plain version (pivots equal,
    values within TOL, columns left of the panel's end untouched) and
    against the unfused pair bit for bit, the trailing kernel against its
    plain version; the C launcher's geometry against ``fused_geometry``;
    each timed (CUDA events, median of ``reps``) beside its plain version
    and bound, with the panel kernel on the same strip (phase A alone)."""
    import torch

    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.kernels import panel_fused as kf
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    dev = torch.device(DEVICE)
    geom = kf.fused_geometry(h, wtot, PANEL, kb)
    where = {"cluster": f"cluster route (phase A on a cluster of "
                        f"{geom.cluster}",
             "grid": f"grid route (phase A on a group of {geom.group} "
                     f"blocks x {geom.rows_per_block} rows",
             "block": "block route (phase A on one block"}[geom.route] + (
        f"), grid {geom.grid}, {geom.smem_bytes} B dynamic shared memory, "
        f"{geom.chunks} chunks x {geom.row_tiles} row tiles")
    if DEVICE == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        info = kf.fused_launch_info(h, wtot, PANEL, kb)
        want = kf.fused_geometry(h, wtot, PANEL, kb, sms=sms,
                                 clusters=info["fit"])._asdict()
        require({k: info[k] for k in want} == want and info["fit"] >= 1,
                f"fused launch at ({h}, {wtot}, kb={kb}): C launcher's "
                f"geometry {info} != {want}")
        unit = "clusters" if geom.route == "cluster" else "blocks an SM"
        where += f", {info['fit']} {unit} at once"
    orig = torch.as_tensor(rng.standard_normal((h, wtot)),
                           dtype=torch.float32, device=dev)
    work = orig.clone()
    before = _build.LAUNCHES["panel_trailing_fused"]
    p, ipiv, perm, mp, upd = kf.panel_trailing_fused(work, kb, 0,
                                                     panel=PANEL)
    require(_build.LAUNCHES["panel_trailing_fused"]
            == before + (DEVICE == "cuda"), "one fused launch per call")
    rp, ripiv, rperm, rmp, rupd = kf.panel_trailing_fused_plain(
        orig.clone(), kb, 0, panel=PANEL)
    sync()
    require(torch.equal(ipiv, ripiv) and torch.equal(perm, rperm),
            f"fused pivots differ from the plain version at ({h}, {wtot}), "
            f"kb={kb}")
    scale = float(rupd.abs().max())
    err = max(float((upd - rupd).abs().max()),
              float((p - rp).abs().max()))
    require(err <= TOL * scale, f"fused at ({h}, {wtot}), kb={kb}: max "
            f"|kernel - plain| {err} > {TOL} x {scale}")
    require(torch.equal(upd[:, :kb + PANEL], orig[:, :kb + PANEL]),
            f"fused wrote columns left of col0+panel at kb={kb}")
    # The unfused pair: panel kernel + reconstruction + trailing kernel.
    pair = orig.clone()
    strip = pair[:, kb:kb + PANEL]
    p2, ipiv2, perm2, mp2 = kp.panel_factor(strip, 0)
    mult, onehot = kf.reconstruct_mult_pt(p2, ipiv2, perm2, 0, PANEL)
    kf.trailing_update(pair, mult, onehot, kb)
    sync()
    require(torch.equal(pair, upd) and torch.equal(p2, p)
            and torch.equal(ipiv2, ipiv) and float(mp2) == float(mp),
            f"fused != panel + trailing bit for bit at ({h}, {wtot}), "
            f"kb={kb}")
    plain_pair = orig.clone()
    kf.trailing_update_plain(plain_pair, mult, ipiv2, kb, kf.FUSED_FSEG_SEED)
    err3 = float((pair - plain_pair).abs().max())
    require(err3 <= TOL * scale, f"trailing at kb={kb}: max |kernel - "
            f"plain| {err3} > {TOL} x {scale}")

    def reset():
        work.copy_(orig)

    plain_reps = max(3, reps // 4)
    calls = {"fused": lambda: kf.panel_trailing_fused(work, kb, 0,
                                                      panel=PANEL),
             "phase A": lambda: kp.panel_factor(strip, 0),
             "phase B": lambda: kf.trailing_update(work, mult, ipiv2, kb)}
    ms2 = cuda_event_ms(calls["fused"], reps, setup=reset)
    pms2 = cuda_event_ms(lambda: kf.panel_trailing_fused_plain(
        work, kb, 0, panel=PANEL), plain_reps, setup=reset)
    ms_a = cuda_event_ms(calls["phase A"], reps)
    ms3 = cuda_event_ms(calls["phase B"], reps, setup=reset)
    # Device time alone: launches queued behind a spin kernel (the values
    # they leave in `work` are not read).
    dev = ({k: device_ms(fn, reps) for k, fn in calls.items()}
           if DEVICE == "cuda" else {k: 0.0 for k in calls})
    pms3 = cuda_event_ms(lambda: kf.trailing_update_plain(
        work, mult, ipiv2, kb, kf.FUSED_FSEG_SEED), plain_reps,
        setup=reset)
    ncols = wtot - kb - PANEL
    f3 = trailing_ops(h, 0, PANEL, ncols)
    f2 = f3 + panel_ops(h, PANEL, 0)
    # The fused kernel reads and writes only columns col0 = kb onward
    # (panel out + trailing); columns left of kb hold L and are untouched.
    by2 = 8.0 * h * (wtot - kb) + 4 * PANEL + 8 * h + 4
    by3 = 4.0 * h * ncols * 2 + 4.0 * PANEL * h + 4 * PANEL
    b2 = bound(by2, f2)
    b3 = bound(by3, f3)
    print(f"phase 3: fused ({h}, {wtot}) kb={kb}, {where}: ms {ms2:.4f} "
          f"(phase A, the panel kernel on the strip: {ms_a:.4f}; phase B, "
          f"the trailing kernel: {ms3:.4f}), device ms {dev['fused']:.4f} "
          f"(phase A {dev['phase A']:.4f}, phase B {dev['phase B']:.4f}), "
          f"plain {pms2:.4f}, bound {b2[0]:.5f} ({b2[1]}), max_abs_err "
          f"{err:g}; trailing: plain {pms3:.4f}, bound {b3[0]:.5f} "
          f"({b3[1]}), max_abs_err {err3:g}; fused == pair bit for bit")
    return {"route": geom.route, "phase_a_ms": ms_a,
            "phase_a_device_ms": dev["phase A"],
            "fused": {"ms": ms2, "device_ms": dev["fused"], "plain_ms": pms2,
                      "bound_ms": b2[0], "flops": f2, "bytes": by2,
                      "err": err},
            "trailing": {"ms": ms3, "device_ms": dev["phase B"],
                         "plain_ms": pms3, "bound_ms": b3[0], "flops": f3,
                         "bytes": by3, "err": err3}}


def same_outputs(got, want) -> bool:
    """torch.equal on each of two tuples of outputs."""
    import torch

    return all(torch.equal(g, w) for g, w in zip(got, want))


def panel_launch_key(h: int, panel: int, itemsize: int = 4) -> str:
    """The launch count that a panel factor of an (h, panel) strip of
    ``itemsize``-byte words adds to: the route ``panel_geometry`` gives
    it, with the bfloat16 forms' suffix at 2 bytes."""
    from gauss_tpu_torch.kernels import panel as kp

    return {"cluster": "panel_factor_cluster", "grid": "panel_factor_grid",
            "block": "panel_factor"}[kp.panel_geometry(
                h, panel, itemsize).route] + ("_bf16" if itemsize == 2
                                              else "")


def batched_route(bsz: int, h: int, panel: int, itemsize: int = 4) -> str:
    """Phase A's route of a batched fused launch of ``bsz`` members of
    height ``h`` (``fused_batched_geometry``: the cluster route in one wave,
    else the grid route, else one block)."""
    from gauss_tpu_torch.kernels import panel_fused as kf

    return kf.fused_batched_geometry(bsz, h, h, panel,
                                     itemsize=itemsize).route


def panel_bound(h: int, panel: int, kb: int = 0):
    """Kernel 1's bound: the strip read and written once with the pivot
    vectors, and the operations on its live rows."""
    return bound(2.0 * h * panel * 4 + 4 * panel + 8 * h + 4,
                 panel_ops(h, panel, kb))


def phase_panel(reps: int, rng):
    """Kernel 1's routes against the plain version, bit for bit: the
    cluster kernel at (PANEL, PANEL) and (N, PANEL), the grid kernel at
    (2N, PANEL), each shape's route and geometry (the C launcher's beside
    the Python rule), clusters or blocks the card holds at once, ms and us
    per pivot step beside the plain version, ``torch.linalg.lu_factor``
    and the bound; on the grid shape also the one-block kernel
    (``panel_factor_one_block``, the route the rule took there before the
    grid route), bit for bit and timed; the cluster sizes of
    PANEL_CLUSTER_SWEEP and the G of PANEL_GRID_SWEEP; the three kernels'
    ptxas usage. Returns the record of the main path's (PANEL, PANEL)
    shape, with every shape's record under "shapes"."""
    import torch

    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    dev = torch.device(DEVICE)
    on_card = DEVICE == "cuda"
    if on_card:
        for source in ("panel_cluster", "panel_grid", "panel_factor"):
            for kernel, (regs, spill, smem) in sorted(
                    ptxas_usage(source).items()):
                print(f"phase 3: ptxas -v, csrc/{source}.cu {kernel}: "
                      f"{regs} registers, {spill} bytes of spill stores, "
                      f"{smem} bytes of static shared memory")
    records = {}
    for h, panel in ((PANEL, PANEL), (N, PANEL), (2 * N, PANEL)):
        geom = kp.panel_geometry(h, panel)
        key = panel_launch_key(h, panel)
        x = torch.as_tensor(rng.standard_normal((h, panel)),
                            dtype=torch.float32, device=dev)
        before = _build.LAUNCHES[key]
        got = kp.panel_factor(x, 0)
        ref = kp.panel_factor_plain(x, 0)
        sync()
        require(_build.LAUNCHES[key] == before + on_card,
                f"panel_factor at ({h}, {panel}) did not launch {key}")
        require(same_outputs(got, ref), f"{key} at ({h}, {panel}) differs "
                f"from the plain version")
        err = float((got[0] - ref[0]).abs().max())
        ms = cuda_event_ms(lambda: kp.panel_factor(x, 0), reps)
        plain_ms = cuda_event_ms(lambda: kp.panel_factor_plain(x, 0),
                                 max(3, reps // 4))
        with quiet_fd1():
            lib_ms = cuda_event_ms(lambda: torch.linalg.lu_factor(x), reps)
        b_ms, b_by = panel_bound(h, panel)
        if geom.route == "cluster":
            where = (f"a cluster of {geom.cluster} blocks x "
                     f"{geom.rows_per_block} rows, {geom.smem_bytes} B "
                     f"dynamic shared memory")
            if on_card:
                info = kp.panel_cluster_info(h, panel)
                require(info["cluster"] == geom.cluster
                        and info["rows_per_block"] == geom.rows_per_block
                        and info["smem_bytes"] == geom.smem_bytes
                        and info["max_active_clusters"] >= 1,
                        f"C launcher's geometry {info} != {geom}")
                where += f", {info['max_active_clusters']} clusters at once"
        elif geom.route == "grid":
            where = (f"a grid of {geom.blocks} co-resident blocks x "
                     f"{geom.rows_per_block} rows, {geom.smem_bytes} B "
                     f"dynamic shared memory")
            if on_card:
                info = kp.panel_grid_info(h, panel)
                require(info["grid"] == geom.blocks
                        and info["rows_per_block"] == geom.rows_per_block
                        and info["smem_bytes"] == geom.smem_bytes
                        and info["max_resident_blocks"] >= geom.blocks,
                        f"C launcher's geometry {info} != {geom}")
                where += (f", {info['max_resident_blocks']} such blocks at "
                          f"once")
        else:
            where = "one block over a global scratch"
        rec = {"key": key, "geom": geom, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "err": err}
        old = ""
        if geom.route == "grid" and on_card:
            # The one-block kernel, the route the rule took here before.
            b0 = _build.LAUNCHES["panel_factor"]
            one = kp.panel_factor_one_block(x, 0)
            sync()
            require(_build.LAUNCHES["panel_factor"] == b0 + 1
                    and same_outputs(one, ref), f"panel_factor_one_block "
                    f"at ({h}, {panel}) differs from the plain version")
            rec["one_block_ms"] = cuda_event_ms(
                lambda: kp.panel_factor_one_block(x, 0), max(3, reps // 4))
            rec["one_block_err"] = float((one[0] - ref[0]).abs().max())
            old = (f"; the one-block kernel on the same strip, bit for bit: "
                   f"{rec['one_block_ms']:.4f} ms")
        print(f"phase 3: {key} ({h}, {panel}) on {where}: bit for bit; ms "
              f"{ms:.4f} ({1e3 * ms / panel:.2f} us per pivot step), plain "
              f"{plain_ms:.4f}, lu_factor {lib_ms:.4f}, bound {b_ms:.5f} "
              f"({b_by}), max_abs_err {err:g}{old}")
        records[(h, panel)] = rec
    require(not on_card or (records[(PANEL, PANEL)]["key"] ==
                            records[(N, PANEL)]["key"] ==
                            "panel_factor_cluster" and
                            records[(2 * N, PANEL)]["key"] ==
                            "panel_factor_grid"),
            f"routes {[r['key'] for r in records.values()]}: expected the "
            f"cluster kernel at ({PANEL}, {PANEL}) and ({N}, {PANEL}), the "
            f"grid kernel at ({2 * N}, {PANEL})")
    if on_card:
        for h, sizes in PANEL_CLUSTER_SWEEP.items():
            x = torch.as_tensor(rng.standard_normal((h, PANEL)),
                                dtype=torch.float32, device=dev)
            ref = kp.panel_factor_plain(x, 0)
            times = {}
            for c in sizes:
                require(same_outputs(kp.panel_factor_cluster(x, 0, c), ref),
                        f"cluster of {c} at ({h}, {PANEL}) differs from the "
                        f"plain version")
                times[c] = cuda_event_ms(
                    lambda: kp.panel_factor_cluster(x, 0, c), reps)
            best = min(times, key=times.get)
            print(f"phase 3: cluster sizes at ({h}, {PANEL}), ms: "
                  + ", ".join(f"C={c} {t:.4f}" for c, t in times.items())
                  + f"; fastest C={best}, the rule's "
                  f"C={kp.panel_geometry(h, PANEL).cluster}")
        for (h, panel), sizes in PANEL_GRID_SWEEP.items():
            x = torch.as_tensor(rng.standard_normal((h, panel)),
                                dtype=torch.float32, device=dev)
            ref = kp.panel_factor_plain(x, 0)
            rule = kp.panel_geometry(h, panel).blocks
            times = {}
            for g in sorted(set(sizes) | {rule}):
                require(same_outputs(kp.panel_factor_grid(x, 0, g), ref),
                        f"grid of {g} at ({h}, {panel}) differs from the "
                        f"plain version")
                times[g] = cuda_event_ms(
                    lambda: kp.panel_factor_grid(x, 0, g), reps)
            best = min(times, key=times.get)
            print(f"phase 3: grid sizes at ({h}, {panel}), ms: "
                  + ", ".join(f"G={g} {t:.4f}" for g, t in times.items())
                  + f"; fastest G={best}, the rule's G={rule}")
    return dict(records[(PANEL, PANEL)], shapes=records)


def rowelim_shape(n: int):
    """(npad, wpad, k) of the batched row-elimination solve at n: the
    augmented matrix's rows and width, and the pivot steps per group."""
    from gauss_tpu_torch.kernels import rowelim

    k = rowelim.auto_rowelim_k(n)
    blk = max(rowelim.DEFAULT_BM, k)
    npad = -(-n // blk) * blk
    wpad = -(-(npad + 1) // rowelim.DEFAULT_BN) * rowelim.DEFAULT_BN
    return npad, wpad, k


def phase_elim_matmul_kernels(reps: int):
    """Kernels 4-7 against their plain versions at the n=N main path's
    shapes, each timed beside its plain version, its library call and its
    bound; and the panel kernel at the strips of one batched solve."""
    import torch

    from gauss_tpu_torch.core.matmul import matmul as core_matmul
    from gauss_tpu_torch.kernels import matmul as km
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.kernels import rowelim as kr
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    rng = np.random.default_rng(SEED + 1)
    dev = torch.device(DEVICE)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32, device=dev)

    out = {}
    # Kernels 4 and 5 at (N, N, N): "high" (the CLI default, three bf16
    # products: the bf16 tensor-core peak bounds it), "highest" (f32) and
    # "default" (one bf16 product).
    a, b = rand(N, N), rand(N, N)
    mm_bytes = 3.0 * N * N * 4
    modes = (("high", 6.0 * N ** 3, PEAK_BF16_FLOP_S),
             ("highest", 2.0 * N ** 3, PEAK_F32_FLOP_S),
             ("default", 2.0 * N ** 3, PEAK_BF16_FLOP_S))
    for name, fn, precs in (("matmul_tiled", km.matmul_tiled, modes),
                            ("matmul_stripe", km.matmul_stripe, modes)):
        out[name] = {}
        for prec, flops, peak in precs:
            got = fn(a, b, prec)
            want = km.matmul_plain(a, b, prec)
            sync()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            require(err <= MM_TOL * scale, f"{name} {prec} at ({N}, {N}, "
                    f"{N}): max |kernel - plain| {err} > {MM_TOL} x {scale}")
            ms = device_ms(lambda: fn(a, b, prec), reps)
            plain_ms = device_ms(lambda: km.matmul_plain(a, b, prec), reps)
            lib_ms = device_ms(lambda: core_matmul(a, b, prec), reps)
            b_ms, b_by = bound(mm_bytes, flops, peak)
            out[name][prec] = {"ms": ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "err": err}
            print(f"phase 3b: {name} {prec} ({N}, {N}, {N}): ms {ms:.4f} "
                  f"({2.0 * N ** 3 / ms / 1e9:.1f} TFLOP/s of the product), "
                  f"plain {plain_ms:.4f}, core.matmul(\"{prec}\") (cuBLAS) "
                  f"{lib_ms:.4f}, bound {b_ms:.5f} ({b_by}), max_abs_err "
                  f"{err:g}")
    phase_stripe_checks(out["matmul_stripe"], rand)

    # Kernel 6 on the batched path's augmented shape, bit for bit.
    npad, wpad, k = rowelim_shape(N)
    m = rand(npad, wpad)
    for i in (0, npad // 2 - 1, npad - 1):
        got = kr.eliminate_step(m, i)
        want = kr.eliminate_step_plain(m, i)
        sync()
        require(torch.equal(got, want), f"eliminate_step at i={i} on "
                f"({npad}, {wpad}) differs from the plain version")
    i = npad // 2 - 1
    ms = device_ms(lambda: kr.eliminate_step(m, i), reps)
    plain_ms = device_ms(lambda: kr.eliminate_step_plain(m, i), reps)
    b_ms, b_by = bound(2.0 * npad * wpad * 4, 2.0 * npad * wpad)
    out["eliminate_step"] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": None, "bound_ms": b_ms,
                             "bound_by": b_by, "err": 0.0}
    print(f"phase 3b: eliminate_step ({npad}, {wpad}) at i = 0, {i}, "
          f"{npad - 1}: bit for bit; ms {ms:.4f}, plain {plain_ms:.4f}, "
          f"library none, bound {b_ms:.5f} ({b_by}); {npad} steps per solve "
          f"= {ms * npad:.2f} ms of kernel")

    # Kernel 7 at the batched path's shape.
    f, u = rand(npad, k), rand(k, wpad)
    got = kr.rankk_update(m, f, u)
    want = kr.rankk_update_plain(m, f, u)
    sync()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    require(err <= RANKK_TOL * scale, f"rankk_update at ({npad}, {wpad}), "
            f"k={k}: max |kernel - plain| {err} > {RANKK_TOL} x {scale}")
    ms = device_ms(lambda: kr.rankk_update(m, f, u), reps)
    plain_ms = device_ms(lambda: kr.rankk_update_plain(m, f, u), reps)
    lib_ms = device_ms(lambda: torch.addmm(m, f, u, alpha=-1), reps)
    b_ms, b_by = bound(4.0 * (2 * npad * wpad + npad * k + k * wpad),
                       2.0 * npad * wpad * k)
    out["rankk_update"] = {"ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "err": err}
    print(f"phase 3b: rankk_update ({npad}, {wpad}), k={k}: ms {ms:.4f}, "
          f"plain {plain_ms:.4f}, addmm {lib_ms:.4f}, bound {b_ms:.5f} "
          f"({b_by}), max_abs_err {err:g}")
    phase_sgemm_checks(out, rand)

    # The panel kernel at the npad // k strips of one batched solve: the
    # live rows of each group, (npad - kb, k) at kb = 0, k, ...
    strip = rand(npad, k)
    kb_mid = (npad // k // 2) * k
    for kb in sorted({0, kb_mid}):
        live = strip[kb:]
        require(same_outputs(kp.panel_factor(live, 0),
                             kp.panel_factor_plain(live, 0)),
                f"panel_factor at the live strip ({npad - kb}, {k}) differs "
                f"from the plain version")
    kbs = range(0, npad, k)
    panel_ms = sum(device_ms(lambda: kp.panel_factor(strip[kb:], 0),
                             max(3, reps // 4)) for kb in kbs)
    with quiet_fd1():
        lib_ms = sum(device_ms(lambda: torch.linalg.lu_factor_ex(strip[kb:]),
                               max(3, reps // 4)) for kb in kbs)
    strip_bounds = [panel_bound(npad - kb, k) for kb in kbs]
    out["panel_batched_ms"] = panel_ms
    out["panel_batched_library_ms"] = lib_ms
    out["panel_batched_bound_ms"] = sum(b for b, _ in strip_bounds)
    routes = sorted({panel_launch_key(npad - kb, k) for kb in kbs})
    print(f"phase 3b: panel_factor at the {len(kbs)} live-row strips "
          f"({npad}..{npad - kbs[-1]}, {k}) of one batched solve "
          f"({', '.join(routes)}): {panel_ms:.4f} ms in all; strips "
          f"{npad} and {npad - kb_mid} bit for bit; lu_factor_ex "
          f"{lib_ms:.4f} ms; bound {out['panel_batched_bound_ms']:.5f} "
          f"({', '.join(sorted({by for _, by in strip_bounds}))})")

    # One whole solve of each form on a random system.
    a_sys, b_sys = rand(N, N), rand(N)
    out["batched_solve_ms"] = cuda_event_ms(
        lambda: kr.gauss_solve_rowelim_batched(a_sys, b_sys, device=DEVICE),
        max(3, reps // 4))
    out["step_solve_ms"] = cuda_event_ms(
        lambda: kr.gauss_solve_rowelim(a_sys, b_sys, device=DEVICE), 3,
        warmup=1)
    kern = panel_ms + (npad // k) * out["rankk_update"]["ms"]
    print(f"phase 3b: one n={N} batched solve {out['batched_solve_ms']:.4f} "
          f"ms (its kernels {kern:.4f} ms); one step solve "
          f"{out['step_solve_ms']:.4f} ms (its kernels "
          f"{npad * out['eliminate_step']['ms']:.4f} ms)")
    return out


@functools.lru_cache(maxsize=None)
def ptxas_usage(source: str) -> dict:
    """Registers, bytes of spill stores and bytes of static shared memory
    of each kernel of ``csrc/<source>.cu`` (by mangled name), as ``nvcc
    -Xptxas -v`` reports them under the port's build flags: a throwaway
    build in the build directory."""
    from gauss_tpu_torch.kernels import _build

    out = _build.build_dir() / f"ptxas-{source}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out), str(_build.CSRC / f"{source}.cu")],
        capture_output=True, text=True)
    out.unlink(missing_ok=True)
    require(proc.returncode == 0, f"nvcc -Xptxas -v csrc/{source}.cu: "
            f"{proc.stderr[-2000:]}")
    usage, kernel = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
            usage[kernel] = [0, 0, 0]
        elif kernel:
            for i, pattern in enumerate((r"Used (\d+) registers",
                                         r"(\d+) bytes spill stores",
                                         r"(\d+) bytes smem")):
                m = re.search(pattern, line)
                if m:
                    usage[kernel][i] = int(m.group(1))
    return usage


def sliced(x, off: int):
    """``x`` as a column slice of a wider matrix: row stride
    ``cols + off + 2`` and a base pointer ``off`` floats past an aligned
    allocation, so no row starts on a 16-byte boundary for off = 1, 2, 3."""
    import torch

    wide = torch.zeros((x.shape[0], x.shape[1] + off + 2), dtype=x.dtype,
                       device=x.device)
    wide[:, off:off + x.shape[1]] = x
    return wide[:, off:off + x.shape[1]]


def phase_stripe_checks(timed: dict, rand):
    """Kernel 5's launch geometry and its share of the bound in each mode
    (``timed``: its (N, N, N) results by precision), then the kernel
    against its plain version at STRIPE_SHAPES, contiguous and as column
    slices whose rows start off 16-byte boundaries (the kernel's 4-byte
    copy path), in every mode."""
    import torch

    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import matmul as km

    geom = km.stripe_geometry(N, N, N, N, N)
    print(f"phase 3b: matmul_stripe geometry at ({N}, {N}, {N}): "
          f"{geom.blocks} blocks = {geom.stripes} clusters x {geom.cl}, "
          f"{geom.threads} threads, {geom.smem_bytes} B dynamic shared "
          f"memory, {4 * geom.vec}-byte copies, {geom.k_tiles} K tiles")
    full = km.stripe_geometry(2048, 2048, 2048, 2048, 2048).blocks
    require(full >= km.H100_SMS, f"stripe grid of {full} blocks at "
            f"m=2048 leaves SMs idle")
    for prec, r in timed.items():
        line = (f"phase 3b: matmul_stripe {prec}: "
                f"{2.0 * N ** 3 / r['ms'] / 1e9:.1f} TFLOP/s of the product, "
                f"{100.0 * r['bound_ms'] / r['ms']:.1f}% of its bound")
        if DEVICE == "cuda":
            for vec in (4, 1):
                info = km.stripe_launch_info(prec, vec)
                require(info["smem_bytes"] == geom.smem_bytes
                        and info["max_active_clusters"] >= 1,
                        f"stripe launch info {info} ({4 * vec}-byte copy)")
                line += (f"; {4 * vec}-byte copy: "
                         f"{info['max_active_clusters']} clusters at once, "
                         f"tensor cores {info['tensor_cores']}")
        print(line)
    if DEVICE == "cuda":
        modes = {"0": "highest", "1": "high", "2": "default"}
        for kernel, (regs, spill, _) in sorted(
                ptxas_usage("matmul").items()):
            m = re.search(r"gtt_matmul_stripe_kernelILi(\d)ELi(\d)E", kernel)
            if m:
                print(f"phase 3b: ptxas -v, matmul_stripe {modes[m[1]]} "
                      f"with {4 * int(m[2])}-byte copies: {regs} registers, "
                      f"{spill} bytes of spill stores")

    for m, k, n in STRIPE_SHAPES:
        x, y = rand(m, k), rand(k, n)
        for layout, (a, b) in (("contiguous", (x, y)),
                               ("sliced", (sliced(x, 1), sliced(y, 3)))):
            g = km.stripe_geometry(m, n, k, a.stride(0), b.stride(0),
                                   a.data_ptr(), b.data_ptr())
            require(layout == "contiguous" or g.vec == 1,
                    f"sliced operands at ({m}, {k}, {n}) took the "
                    f"16-byte copy")
            errs = []
            for prec in ("highest", "high", "default"):
                _build.reset_launches()
                got = km.matmul_stripe(a, b, prec)
                want = km.matmul_plain(a, b, prec)
                sync()
                require(_build.LAUNCHES["matmul_stripe"] ==
                        (1 if DEVICE == "cuda" else 0),
                        f"stripe launches {_build.LAUNCHES}")
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                require(got.shape == (m, n) and err <= MM_TOL * scale,
                        f"matmul_stripe {prec} at ({m}, {k}, {n}) "
                        f"{layout}: max |kernel - plain| {err} > {MM_TOL} "
                        f"x {scale}")
                errs.append(f"{prec} {err / scale:.2e}")
            print(f"phase 3b: matmul_stripe ({m}, {k}, {n}) {layout} "
                  f"({g.blocks} blocks, {4 * g.vec}-byte copies): "
                  f"max |kernel - plain| / max |plain|: {', '.join(errs)} "
                  f"(limit {MM_TOL})")


def phase_sgemm_checks(timed: dict, rand):
    """Kernels 4 and 7 on the f32 routine of sgemm_common.cuh (kernel 4's
    bf16 modes on the stripe's tile routine): each launch's geometry, the
    blocks an SM the card holds and the waves, registers and spills,
    TFLOP/s and share of the bound at the n=N shapes (``timed``: phase
    3b's results); then kernel 4 at STRIPE_SHAPES in every mode and kernel
    7 at RANKK_SHAPES against their plain versions, contiguous and as
    column slices whose rows start off 16-byte boundaries, one launch
    each."""
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import matmul as km
    from gauss_tpu_torch.kernels import rowelim as kr

    npad, wpad, k = rowelim_shape(N)
    runs = [("matmul_tiled", prec, (N, N, N),
             km.gemm_geometry(N, N, N, N, N, precision=prec), r)
            for prec, r in timed["matmul_tiled"].items()]
    runs.append(("rankk_update", "highest", (npad, k, wpad),
                 km.gemm_geometry(npad, wpad, k, k, wpad),
                 timed["rankk_update"]))
    for name, prec, (m, kk, n), g, r in runs:
        line = (f"phase 3b: {name} {prec} ({m}, {kk}, {n}): grid "
                f"{g.grid[0]} x {g.grid[1]} = {g.blocks} blocks of "
                f"{g.threads} threads, tile ({g.bm}, {g.bn}), "
                f"{g.smem_bytes} B dynamic shared memory, {4 * g.vec}-byte "
                f"copies, {g.k_tiles} K tiles, {g.waves:.3f} waves at the "
                f"launch bound's {g.blocks_per_sm} blocks an SM; "
                f"{2.0 * m * kk * n / r['ms'] / 1e9:.1f} TFLOP/s of the "
                f"product, {100.0 * r['bound_ms'] / r['ms']:.1f}% of its "
                f"bound")
        if DEVICE == "cuda":
            info = km.launch_info(name, prec, g.vec)
            require(info["smem_bytes"] == g.smem_bytes
                    and info["threads"] == g.threads
                    and info["tile"] == (g.bm, g.bn)
                    and info["tensor_cores"] == g.tensor_cores
                    and info["blocks_per_sm"] >= g.blocks_per_sm,
                    f"{name} {prec}: launch info {info} against {g}")
            line += (f"; the card holds {info['blocks_per_sm']} blocks an "
                     f"SM")
        print(line)
    if DEVICE == "cuda":
        modes = {"0": "highest", "1": "high", "2": "default"}
        usage = {**ptxas_usage("matmul"), **ptxas_usage("rowelim")}
        for kernel, (regs, spill, _) in sorted(usage.items()):
            m = re.search(r"gtt_(matmul_tiled_f32|matmul_tiled_mma|"
                          r"rankk_update)_kernelI((?:Li\d+E)+)E", kernel)
            if m:
                args = re.findall(r"Li(\d+)E", m[2])
                label = ("rankk_update" if m[1] == "rankk_update" else
                         "matmul_tiled " + (modes[args[0]] if len(args) == 2
                                            else "highest"))
                print(f"phase 3b: ptxas -v, {label} with "
                      f"{4 * int(args[-1])}-byte copies: {regs} registers, "
                      f"{spill} bytes of spill stores")

    def one_launch(name, got, want, what, tol):
        sync()
        require(_build.LAUNCHES[name] == (1 if DEVICE == "cuda" else 0)
                and sum(_build.LAUNCHES.values()) == _build.LAUNCHES[name],
                f"{what}: launches {_build.LAUNCHES}")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        require(got.shape == want.shape and err <= tol * scale,
                f"{what}: max |kernel - plain| {err} > {tol} x {scale}")
        return err / scale

    for m, kk, n in STRIPE_SHAPES:
        x, y = rand(m, kk), rand(kk, n)
        for layout, (a, b) in (("contiguous", (x, y)),
                               ("sliced", (sliced(x, 1), sliced(y, 3)))):
            errs, copies = [], []
            for prec in ("highest", "high", "default"):
                g = km.gemm_geometry(m, n, kk, a.stride(0), b.stride(0),
                                     a.data_ptr(), b.data_ptr(), prec)
                require(layout == "contiguous" or g.vec == 1,
                        f"sliced operands at ({m}, {kk}, {n}) took the "
                        f"16-byte copy in {prec}")
                _build.reset_launches()
                rel = one_launch("matmul_tiled", km.matmul_tiled(a, b, prec),
                                 km.matmul_plain(a, b, prec),
                                 f"matmul_tiled {prec} at ({m}, {kk}, {n}) "
                                 f"{layout}", MM_TOL)
                errs.append(f"{prec} {rel:.2e}")
                copies.append(f"{prec} {g.blocks} blocks, {4 * g.vec}-byte")
            print(f"phase 3b: matmul_tiled ({m}, {kk}, {n}) {layout} "
                  f"({'; '.join(copies)} copies): max |kernel - plain| / "
                  f"max |plain|: {', '.join(errs)} (limit {MM_TOL})")
    for rows, kk, cols in RANKK_SHAPES:
        ops = rand(rows, cols), rand(rows, kk), rand(kk, cols)
        for layout, (mm, f, u) in (
                ("contiguous", ops),
                ("sliced", tuple(sliced(x, off)
                                 for x, off in zip(ops, (1, 2, 3))))):
            g = km.gemm_geometry(rows, cols, kk, f.stride(0), u.stride(0),
                                 f.data_ptr(), u.data_ptr())
            require(layout == "contiguous" or g.vec == 1,
                    f"sliced u at ({rows}, {kk}, {cols}) took the 16-byte "
                    f"copy")
            _build.reset_launches()
            rel = one_launch("rankk_update", kr.rankk_update(mm, f, u),
                             kr.rankk_update_plain(mm, f, u),
                             f"rankk_update at ({rows}, {cols}), k={kk} "
                             f"{layout}", RANKK_TOL)
            print(f"phase 3b: rankk_update ({rows}, {cols}), k={kk} "
                  f"{layout} ({g.blocks} blocks, {4 * g.vec}-byte copies of "
                  f"u): max |kernel - plain| / max |plain| {rel:.2e} "
                  f"(limit {RANKK_TOL})")


def sparse_system(n: int, nnz_per_row: int):
    """The sparse generator's system at order n as a CsrMatrix, and the
    right-hand side the sparse check solves it for."""
    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.sparse.csr import CsrMatrix

    rows, cols, vals = synthetic.sparse_coords(n, nnz_per_row, seed=SEED)
    a = CsrMatrix.from_coords(n, rows, cols, vals)
    rng = np.random.default_rng(np.random.SeedSequence((SEED, n)))
    return a, rng.standard_normal(n)


def spmv_bytes(n: int, k: int, itemsize: int) -> float:
    """Bytes one ELL product must move: cols and vals read once, x read
    once, y written once."""
    return float(n) * k * (4 + itemsize) + 2.0 * n * itemsize


def phase_spmv_kernel(reps: int):
    """Kernel 8 (the ELL SpMV) against its plain version, bit for bit, at
    the sparse main path's operand shapes; timed beside the plain version,
    the stock gather-and-sum, the library call and the bound. Returns the
    per-shape results and the assembled systems (the main path's breakdown
    reuses the largest)."""
    import torch

    from gauss_tpu_torch.core import convert
    from gauss_tpu_torch.sparse import spmv as ks
    from gauss_tpu_torch.sparse.csr import CsrMatrix

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 2)
    out, systems = {}, {}

    def check_equal(a, dtype, label):
        cols, vals = convert.ell_from_numpy(*a.ell(), device=dev, dtype=dtype)
        x = torch.as_tensor(rng.standard_normal(a.n), dtype=dtype, device=dev)
        got = ks.spmv_ell(cols, vals, x)
        want = ks.spmv_ell_plain(cols, vals, x)
        sync()
        require(torch.equal(got, want), f"spmv_ell {label} "
                f"{tuple(vals.shape)} {dtype}: kernel differs from the "
                f"plain version (max |diff| "
                f"{float((got - want).abs().max())})")
        ref = torch.as_tensor(a.matvec(x.double().cpu().numpy()))
        err = float((got.double().cpu() - ref).abs().max())
        scale = float(ref.abs().max())
        eps = 1e-5 if dtype == torch.float32 else 1e-13
        require(err <= eps * max(scale, 1.0), f"spmv_ell {label}: max "
                f"|kernel - host CSR matvec| {err} > {eps} x {scale}")
        return cols, vals, x

    for n in SPARSE_NS:
        t0 = time.perf_counter()
        a, b = sparse_system(n, SPARSE_NNZ)
        systems[n] = (a, b)
        k = max(a.max_row_nnz, 1)
        print(f"phase 3c: n={n}: {a.nnz} stored entries, ELL ({n}, {k}), "
              f"assembled on the host in {time.perf_counter() - t0:.2f} s")
        if n in SPARSE_ELL_K:
            require(k == SPARSE_ELL_K[n], f"ELL width at n={n} is {k}, "
                    f"expected {SPARSE_ELL_K[n]}")
        crow = torch.as_tensor(a.indptr, device=dev)
        ccol = torch.as_tensor(a.indices.astype(np.int64), device=dev)
        for dtype in (torch.float64, torch.float32):
            cols, vals, x = check_equal(a, dtype, "generator")
            itemsize = vals.element_size()
            with warnings.catch_warnings():
                # torch says CSR support is in beta; the call is timed as
                # the library's yardstick only.
                warnings.simplefilter("ignore", UserWarning)
                csr = torch.sparse_csr_tensor(
                    crow, ccol,
                    torch.as_tensor(a.data, dtype=dtype, device=dev),
                    size=(n, n))
            lib = torch.mv(csr, x)
            sync()
            lib_err = float((lib - ks.spmv_ell_plain(cols, vals, x))
                            .abs().max())
            ms = device_ms(lambda: ks.spmv_ell(cols, vals, x), reps)
            plain_ms = device_ms(lambda: ks.spmv_ell_plain(cols, vals, x),
                                 max(3, reps // 4))
            stock_ms = device_ms(lambda: (vals * x[cols]).sum(1), reps)
            lib_ms = device_ms(lambda: torch.mv(csr, x), reps)
            nbytes = spmv_bytes(n, k, itemsize)
            b_ms, b_by = bound(nbytes, 2.0 * n * k,
                               PEAK_F64_FLOP_S if itemsize == 8
                               else PEAK_F32_FLOP_S)
            name = "f64" if itemsize == 8 else "f32"
            out[(n, name)] = {
                "shape": [n, k], "dtype": name, "ms": ms,
                "plain_ms": plain_ms, "stock_ms": stock_ms,
                "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bytes": nbytes, "err": 0.0}
            l2 = ("fits the card's 50 MB L2, so repeated launches can run "
                  "under the HBM bound" if nbytes < 50e6 else
                  "exceeds the 50 MB L2: this shape reads HBM")
            print(f"phase 3c: spmv_ell {name} ({n}, {k}): bit for bit; ms "
                  f"{ms:.4f} ({nbytes / ms / 1e9:.3f} TB/s), plain "
                  f"{plain_ms:.4f}, stock gather-and-sum {stock_ms:.4f}, "
                  f"torch.mv on CSR {lib_ms:.4f} (max |mv - plain| "
                  f"{lib_err:.2e}), bound {b_ms:.5f} ({b_by}: "
                  f"{nbytes / 1e6:.1f} MB, {l2})")
            del cols, vals, x, csr, lib

    # A small odd shape and a matrix with an empty row.
    from gauss_tpu_torch.io import synthetic

    rows, cols, vals = synthetic.sparse_coords(130, 5, seed=1)
    small = CsrMatrix.from_coords(130, rows, cols, vals)
    keep = rows != 17
    holed = CsrMatrix.from_coords(130, rows[keep], cols[keep], vals[keep])
    for dtype in (torch.float64, torch.float32):
        check_equal(small, dtype, "n=130")
        check_equal(holed, dtype, "empty row")
    print("phase 3c: spmv_ell at n=130 and with an empty row (row 17), f64 "
          "and f32: bit for bit")
    return out, systems


def run_cli(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    out = buf.getvalue()
    for line in out.strip().splitlines():
        print(f"    | {line}")
    require(rc == 0, f"{mod.__name__} {' '.join(argv)} exited {rc}")
    return out


def phase_main_path():
    import torch

    from gauss_tpu_torch.cli import gauss_external, gauss_internal
    from gauss_tpu_torch.io import datfile, synthetic
    from gauss_tpu_torch.kernels import _build

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    dat = os.path.join(work, f"generator_{N}.dat")
    t0 = time.perf_counter()
    datfile.write_dat(dat, synthetic.generator_matrix(N))
    print(f"phase 4: wrote {dat} in {time.perf_counter() - t0:.1f} s")

    _build.reset_launches()
    runs = [
        ("internal, host f64 refinement", gauss_internal,
         ["-s", str(N), "--verify", "--device", DEVICE]),
        ("internal, double-single refinement", gauss_internal,
         ["-s", str(N), "--refine", "8", "--verify", "--device", DEVICE]),
        ("external .dat", gauss_external, [dat, "--device", DEVICE]),
    ]
    times = {}
    for label, mod, argv in runs:
        print(f"phase 4: {label}: {mod.__name__} {' '.join(argv)}")
        out = run_cli(mod, argv)
        if mod is gauss_internal:
            require("Verification: solution pattern (-0.5, 0...0, 0.5) OK"
                    in out, f"{label}: verification failed")
            res = float(re.search(r"Residual \|\|Ax-b\|\|: (\S+)",
                                  out).group(1))
            require(res < 1e-4, f"{label}: residual {res} >= 1e-4")
            times[label] = float(re.search(r"Application time: (\S+) Secs",
                                           out).group(1))
        else:
            err = float(re.search(r"Error: (\S+)", out).group(1))
            require(err <= 1e-4, f"{label}: error {err} > 1e-4")
            times[label] = float(re.search(r"Time: (\S+) seconds",
                                           out).group(1))
    launches = dict(_build.LAUNCHES)
    # Each CLI run factors twice: the warm-up at shape, then the timed solve.
    factorizations = 2 * len(runs)
    print(f"phase 4: launches over {factorizations} factorizations: "
          f"{launches}")
    per = N // PANEL - 1  # every panel but the last is fused
    require(launches["panel_trailing_fused"] == per * factorizations,
            f"expected {per} fused launches per factorization, got "
            f"{launches['panel_trailing_fused']} for {factorizations}")
    # The last (PANEL, PANEL) panel goes unfused, through the cluster
    # kernel; the grid and one-block kernels run no strip of this path.
    last = panel_launch_key(PANEL, PANEL)
    for key in ("panel_factor", "panel_factor_cluster", "panel_factor_grid"):
        want = factorizations if key == last else 0
        require(launches[key] == want, f"expected {want} {key} launches "
                f"over {factorizations} factorizations, got "
                f"{launches[key]}")
    for label, secs in times.items():
        print(f"phase 4: {label}: {secs:f} s")

    # A random system (n not a panel multiple: identity padding) on the
    # card against a float64 reference.
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.verify import checks

    rng = np.random.default_rng(SEED)
    n = 300
    a = rng.standard_normal((n, n))
    x_true = rng.standard_normal(n)
    b = a @ x_true
    x, fac = blocked.solve_refined(a, b, iters=3, device=DEVICE)
    ref = np.linalg.solve(a, b)
    rel = checks.max_rel_error(x, ref)
    resid = checks.residual_norm(a, x, b)
    print(f"phase 4: random n={n} on {fac.m.device}: max rel err vs f64 "
          f"{rel:.3e}, residual {resid:.3e}")
    require(fac.m.device.type == DEVICE and resid < 1e-4 and np.isfinite(x).all(),
            "random system on the card")
    return launches, dat


def drive_path(label: str, runs, expect: dict):
    """Run one main path's CLI runs with every launch count set to 0 just
    before and read just after; every count must be exactly ``expect``'s
    (0 where absent). Returns the runs' outputs and the counts."""
    from gauss_tpu_torch.kernels import _build

    _build.reset_launches()
    outs = []
    for mod, argv in runs:
        print(f"phase 4: {label}: {mod.__name__} {' '.join(argv)}")
        outs.append(run_cli(mod, argv))
    launches = dict(_build.LAUNCHES)
    print(f"phase 4: {label}: launches {launches}")
    for name, count in launches.items():
        require(count == expect.get(name, 0),
                f"path {label}: {name} launched {count} times, expected "
                f"{expect.get(name, 0)}")
    return outs, launches


def phase_elim_matmul_paths(dat: str):
    """The row-elimination and matmul main paths at n=N (module docstring,
    phase 4)."""
    from gauss_tpu_torch.cli import gauss_external, gauss_internal
    from gauss_tpu_torch.cli import matmul as mm_cli
    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.kernels import rowelim as kr

    npad, _, k = rowelim_shape(N)
    groups = npad // k
    times, by_path = {}, {}

    def strip_launches(n: int, solves: int) -> dict:
        """Panel and rank-k launches of ``solves`` batched solves at n:
        each group's live-row strip on the route the rule gives it."""
        npad_n, _, k_n = rowelim_shape(n)
        expect = {"rankk_update": solves * npad_n // k_n}
        for kb in range(0, npad_n, k_n):
            key = panel_launch_key(npad_n - kb, k_n)
            expect[key] = expect.get(key, 0) + solves
        return expect

    def internal_ok(label, out):
        require("Verification: solution pattern (-0.5, 0...0, 0.5) OK"
                in out, f"{label}: verification failed")
        res = float(re.search(r"Residual \|\|Ax-b\|\|: (\S+)",
                              out).group(1))
        require(res < 1e-4, f"{label}: residual {res} >= 1e-4")
        times[label] = float(re.search(r"Application time: (\S+) Secs",
                                       out).group(1))

    # Each CLI run solves twice: the warm-up at shape, then the timed run.
    outs, by_path["rowelim"] = drive_path("rowelim", [
        (gauss_internal, ["-s", str(N), "--backend", "cuda-rowelim",
                          "--verify", "--device", DEVICE]),
        (gauss_external, [dat, "--backend", "cuda-rowelim", "--device",
                          DEVICE]),
    ], strip_launches(N, 2 * 2))
    require(by_path["rowelim"]["panel_factor_cluster"] == 2 * 2 * groups,
            f"rowelim: the cluster kernel did not carry every strip")
    internal_ok("internal, cuda-rowelim", outs[0])
    times["external .dat, cuda-rowelim"] = float(
        re.search(r"Time: (\S+) seconds", outs[1]).group(1))
    # The external system. This backend does not refine, as in the JAX
    # package, whose bench says of it "no refinement path, cannot meet the
    # 1e-4 bar" (gauss_tpu/bench/grid.py:293): rounding b (entries ~n^3) to
    # float32 alone moves the generator system's answer past the 1e-4
    # forward gate from n=512 on. So the run is held to what a float32
    # solve can promise, backward stability: the same solve, repeated on
    # the card, is the exact answer of a system within BACKWARD_TOL of the
    # given one.
    err = float(re.search(r"Error: (\S+)", outs[1]).group(1))
    require(np.isfinite(err), f"external, cuda-rowelim: error {err}")
    a64 = synthetic.generator_matrix(N)
    b64 = synthetic.manufactured_rhs(a64, synthetic.manufactured_solution(N))
    x = kr.gauss_solve_rowelim_batched(a64, b64, device=DEVICE)
    x = x.cpu().numpy().astype(np.float64)
    eta = float(np.abs(b64 - a64 @ x).max() / (
        np.abs(a64).sum(1).max() * np.abs(x).max() + np.abs(b64).max()))
    print(f"phase 4: external .dat, cuda-rowelim: Error {err:e} (no "
          f"refinement: not held to 1e-4); backward error {eta:.3e} "
          f"(limit {BACKWARD_TOL:.3e})")
    require(eta <= BACKWARD_TOL, f"external, cuda-rowelim: backward error "
            f"{eta} > {BACKWARD_TOL}")

    # At n = 2N the tallest live strips exceed what a cluster holds: the
    # path takes both routes.
    outs, by_path[f"rowelim n={2 * N}"] = drive_path(
        f"rowelim n={2 * N}", [
            (gauss_internal, ["-s", str(2 * N), "--backend", "cuda-rowelim",
                              "--verify", "--device", DEVICE]),
        ], strip_launches(2 * N, 2))
    internal_ok(f"internal n={2 * N}, cuda-rowelim", outs[0])

    outs, by_path["rowelim-step"] = drive_path("rowelim-step", [
        (gauss_internal, ["-s", str(N), "--backend", "cuda-rowelim-step",
                          "--verify", "--device", DEVICE]),
    ], {"eliminate_step": 2 * npad})
    internal_ok("internal, cuda-rowelim-step", outs[0])

    engines = ["--engines", "cuda,cuda-kernel,cuda-kernel-v1"]
    outs, by_path["matmul"] = drive_path("matmul", [
        (mm_cli, [str(N), *engines, "--device", DEVICE]),
        (mm_cli, [str(N), *engines, "--precision", "highest", "--device",
                  DEVICE]),
    ], {"matmul_tiled": 4, "matmul_stripe": 4})
    for prec, out in zip(("high", "highest"), outs):
        lines = re.findall(r"^(\S+) time: (\S+) seconds \((\S+) GFLOP/s\) "
                           r"verify: (\S+)$", out, re.M)
        require(len(lines) == 3 and all(v == "OK" for *_, v in lines),
                f"matmul {prec}: not every engine verified: {lines}")
        for label, secs, _, _ in lines:
            times[f"matmul {label} {prec}"] = float(secs)
    for label, secs in times.items():
        print(f"phase 4: {label}: {secs:f} s")
    return by_path


def krylov_launches(method: str, iterations: int, restart: int = 32) -> int:
    """SpMV launches of one solve that reported ``iterations``: one for
    the initial residual, then one per CG iteration, two per BiCGStab
    iteration, ``restart + 2`` per GMRES cycle."""
    if method == "cg":
        return iterations + 1
    if method == "bicgstab":
        return 2 * iterations + 1
    return 1 + (iterations // restart) * (restart + 2)


def phase_sparse_path(spmv: dict, systems: dict):
    """The sparse main path (module docstring, phase 4). ``spmv`` holds
    phase 3c's kernel times by (n, dtype), ``systems`` its assembled
    systems by n. Returns the path's launch counts."""
    import torch

    from gauss_tpu_torch.io import datfile, synthetic
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.sparse import check, krylov, solve_sparse
    from gauss_tpu_torch.sparse.csr import CsrMatrix
    from gauss_tpu_torch.sparse.precond import (apply_precond,
                                                build_preconditioner)
    from gauss_tpu_torch.utils.device import resolve_device

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    dev = resolve_device(DEVICE)
    _build.reset_launches()
    expect = 0
    repeats = 3

    def kernel_note(n, launches):
        ms = spmv.get((n, "f64"), {}).get("ms")
        return (f"kernel {ms:.4f} ms x {launches} launches = "
                f"{ms * launches:.3f} ms" if ms is not None else
                f"{launches} launches")

    # The check's own legs: smoke + giant at each order.
    for n in SPARSE_NS:
        summary_path = os.path.join(work, f"sparse_check_{n}.json")
        argv = ["--smoke-n", str(SPARSE_SMOKE_N), "--giant-n", str(n),
                "--giant-nnz-per-row", str(SPARSE_NNZ), "--repeats",
                str(repeats), "--seed", str(SEED), "--gate", str(GATE),
                "--device", DEVICE, "--summary-json", summary_path]
        print(f"phase 4: sparse: {check.__name__} {' '.join(argv)}")
        before = _build.LAUNCHES["spmv_ell"]
        run_cli(check, argv)
        with open(summary_path) as f:
            summary = json.load(f)
        routed = summary["routed"]
        require(summary["ok"] and routed["detected"] == "sparse"
                and routed["engine"] == "cg" and not routed["demoted"]
                and routed["rel_residual"] <= GATE,
                f"sparse check at giant n={n}: {summary}")
        # The routed leg's CG rung solves the smoke system as the cg leg
        # does: the same iterations, once.
        leg = krylov_launches("cg", summary["methods"]["cg"]["iterations"])
        for method, row in summary["methods"].items():
            require(row["verified"] and row["rel_residual"] <= GATE,
                    f"sparse smoke {method}: {row}")
            leg += repeats * krylov_launches(method, row["iterations"])
        giant = summary["giant"]
        require(giant["verified"] and giant["no_densify_ok"]
                and giant["rel_residual"] <= GATE and giant["n"] == n,
                f"sparse giant n={n}: {giant}")
        g_launches = krylov_launches("cg", giant["iterations"])
        leg += g_launches
        got = _build.LAUNCHES["spmv_ell"] - before
        require(DEVICE != "cuda" or got == leg, f"sparse check at giant "
                f"n={n}: spmv_ell launched {got} times, the iteration "
                f"counts imply {leg}")
        expect += leg
        dpeak = giant["device_peak_bytes"]
        print(f"phase 4: sparse giant n={n}: ELL {giant['ell_shape']}, "
              f"{giant['iterations']} CG iterations, {giant['s_per_solve']} "
              f"s (assembly {giant['assembly_s']} s), {kernel_note(n, g_launches)}, "
              f"true relative residual {giant['rel_residual']:.3e}, host "
              f"peak RSS {giant['peak_rss_bytes'] / 2**30:.2f} GiB "
              f"(+{giant['host_added_bytes'] / 2**30:.2f} GiB over the "
              f"leg's start), device "
              f"peak {'n/a' if dpeak is None else f'{dpeak / 2**20:.0f} MiB'}")

    def solve_line(label, a, b, **kw):
        nonlocal expect
        sync()
        t0 = time.perf_counter()
        res = solve_sparse(a, b, gate=GATE, device=DEVICE, **kw)
        secs = time.perf_counter() - t0
        true_rel = float(np.linalg.norm(a.matvec(res.x) - b)
                         / np.linalg.norm(b))
        require(np.isfinite(res.x).all() and true_rel <= GATE,
                f"sparse {label}: true relative residual {true_rel}")
        launches = krylov_launches(res.method, res.iterations)
        expect += launches
        print(f"phase 4: sparse {label}: {res.method}/{res.precond} "
              f"n={a.n}: {res.iterations} iterations, {secs:.4f} s, "
              f"{launches} SpMV launches, true relative residual "
              f"{true_rel:.3e}")
        return res

    # Each preconditioner kind once at the smoke size.
    a, b = sparse_system(SPARSE_SMOKE_N, 6)
    for kind in ("none", "block_jacobi", "tridiag", "ilu0", "ic0"):
        solve_line(f"precond {kind}", a, b, method="cg", precond=kind)
    # The block-incomplete apply is two sequential sweeps over the blocks:
    # its host-clock time per apply at this size.
    for kind in ("jacobi", "block_jacobi", "tridiag", "ilu0"):
        prec = build_preconditioner(a, kind, device=DEVICE)
        r = torch.as_tensor(b, device=dev)
        apply_precond(prec, r)
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            apply_precond(prec, r)
        sync()
        print(f"phase 4: sparse apply_precond {kind} n={a.n} "
              f"(meta {prec.meta}): {(time.perf_counter() - t0) / 5 * 1e3:.3f}"
              f" ms per apply (host clock, synchronised)")

    # One .dat round trip at the smoke size.
    dat = os.path.join(work, f"sparse_{SPARSE_SMOKE_N}.dat")
    rows, cols, vals = synthetic.sparse_coords(SPARSE_SMOKE_N, 6, seed=SEED)
    datfile.write_dat(dat, n=SPARSE_SMOKE_N, rows=rows, cols=cols, vals=vals)
    from_dat = CsrMatrix.from_dat(dat, strict=True)
    require(from_dat.indices.tobytes() == a.indices.tobytes()
            and from_dat.data.tobytes() == a.data.tobytes(),
            ".dat round trip changed the matrix")
    res = solve_line(".dat round trip", from_dat, b)
    require(res.method == "cg", f".dat round trip took {res.method}")

    # One solve at the largest order taken apart: what a giant solve's
    # seconds are made of.
    n = max(systems)
    a, b = systems[n]
    t0 = time.perf_counter()
    require(a.gershgorin_spd(), f"n={n}: no SPD certificate")
    t_cert = time.perf_counter() - t0
    t0 = time.perf_counter()
    cols_t, vals_t = krylov._stage(a, dev)
    prec = build_preconditioner(a, "jacobi", device=DEVICE)
    bt = torch.as_tensor(b, device=dev)
    x0 = torch.zeros(n, dtype=torch.float64, device=dev)
    sync()
    t_stage = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, iters, _, rel = krylov.cg_run(cols_t, vals_t, bt, x0, prec, GATE,
                                     maxiter=krylov.DEFAULT_MAXITER)
    sync()
    t_iter = time.perf_counter() - t0
    launches = krylov_launches("cg", iters)
    expect += launches
    xh = x.cpu().numpy()
    t0 = time.perf_counter()
    true_rel = float(np.linalg.norm(a.matvec(xh) - b) / np.linalg.norm(b))
    t_res = time.perf_counter() - t0
    require(true_rel <= GATE, f"n={n} breakdown solve: residual {true_rel}")
    ms = spmv.get((n, "f64"), {}).get("ms")
    per_iter = t_iter / max(iters, 1) * 1e3
    print(f"phase 4: sparse breakdown n={n}: certificate {t_cert:.3f} s, "
          f"ELL staging + copy to the device {t_stage:.3f} s, cg_run "
          f"{t_iter * 1e3:.2f} ms for {iters} iterations ({per_iter:.3f} ms "
          f"per iteration, one host sync each"
          + (f"; the SpMV kernel is {ms:.4f} ms of it" if ms else "")
          + f"), host residual {t_res:.3f} s; true relative residual "
          f"{true_rel:.3e}")

    launches = dict(_build.LAUNCHES)
    print(f"phase 4: sparse: launches {launches} (the iteration counts "
          f"imply {expect} SpMV launches)")
    if DEVICE == "cuda":
        for name, count in launches.items():
            want = expect if name == "spmv_ell" else 0
            require(count == want, f"path sparse: {name} launched {count} "
                    f"times, expected {want}")
    return launches


def trace_device(path: str, since: float = float("-inf"),
                 until: float = float("inf")):
    """``(kernel names, busy ms, span ms)`` of a Chrome trace: the names of
    its kernel events, the length of the union of its device events'
    intervals, and the time from the first device event's start to the
    last one's end; only events that start at or after ``since`` and
    before ``until`` (trace microseconds) count."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in TRACE_DEVICE_CATS and e.get("ph") == "X"
           and since <= float(e["ts"]) < until]
    if not dev:
        return [], 0.0, 0.0
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in dev)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    names = [e["name"] for e in dev if e["cat"] == "kernel"]
    return names, busy / 1e3, (spans[-1][1] - spans[0][0]) / 1e3


def read_stream(path: str):
    """The events of one --metrics-out file (one run), its span names and
    its counters."""
    from gauss_tpu_torch import obs

    events = obs.read_events(path)
    require(len({ev["run"] for ev in events}) == 1,
            f"{path}: expected one run")
    spans = {ev["name"] for ev in events if ev["type"] == "span"}
    counters = {ev["name"]: ev["value"] for ev in events
                if ev["type"] == "metric" and ev["kind"] == "counter"}
    return events, spans, counters


def phase_telemetry(dat: str):
    """The telemetry path (module docstring, phase 5): returns the launch
    counts of the observed CLI run (a) and the figures the phase
    measured."""
    import statistics

    import torch

    from gauss_tpu_torch.cli import gauss_external, gauss_internal
    from gauss_tpu_torch.cli import matmul as mm_cli
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.obs import summarize
    from gauss_tpu_torch.sparse import check
    from gauss_tpu_torch.utils import profiling
    from gauss_tpu_torch.utils.device import as_tensor, resolve_device

    on_card = DEVICE == "cuda"
    work = os.path.join(REPO, "build", "chip_smoke", "telemetry")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    panel = blocked.auto_panel(N)
    panels = -(-N // panel)
    out = {"n": N, "panel": panel}
    # The phase profile's panel kernel launches: one per strip, each on the
    # route its height gives it.
    phased_expect = {}
    for kb in range(0, panels * panel, panel):
        key = panel_launch_key(panels * panel - kb, panel)
        phased_expect[key] = phased_expect.get(key, 0) + 1

    # (a) One observed run through every telemetry flag.
    metrics = os.path.join(work, "internal.jsonl")
    tdir = os.path.join(work, "trace")
    argv = ["-s", str(N), "--verify", "--metrics-out", metrics, "--profile",
            "--phase-profile", "--trace", tdir, "--device", DEVICE]
    print(f"phase 5: gauss_internal {' '.join(argv)}")
    _build.reset_launches()
    text = run_cli(gauss_internal, argv)
    launches = dict(_build.LAUNCHES)
    print(f"phase 5: launches {launches}")
    require("Verification: solution pattern (-0.5, 0...0, 0.5) OK" in text,
            "telemetry run: verification failed")
    require("Solver phase profile (instrumented re-factorization):" in text,
            "telemetry run: no phase table")
    events, spans, _ = read_stream(metrics)
    require(spans == TELEMETRY_SPANS, f"telemetry spans {sorted(spans)}, "
            f"expected {sorted(TELEMETRY_SPANS)}")
    (health,) = [ev for ev in events if ev["type"] == "health"]
    require(health["backend"] == "cuda" and health["min_abs_pivot"] > 0
            and health["growth_factor"] > 0 and health["residual"] < 1e-4,
            f"telemetry health event {health}")
    (compile_ev,) = [ev for ev in events if ev["type"] == "compile"]
    require(compile_ev["label"] == "cuda_blocked_warmup",
            f"compile event {compile_ev}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = summarize.main([metrics])
    require(rc == 0 and "flat profile (leaf spans):" in buf.getvalue()
            and "numerical health:" in buf.getvalue(),
            f"summarize exited {rc}")
    for line in buf.getvalue().strip().splitlines():
        print(f"    | {line}")
    # Launches: two factorizations in the traced solve (warm-up and timed:
    # fused on every panel but the last), then the phase profile's panel
    # kernel on every strip, outside the trace.
    expect = {panel_launch_key(panel, panel): 2,
              "panel_trailing_fused": 2 * (panels - 1)}
    for key, count in phased_expect.items():
        expect[key] = expect.get(key, 0) + count
    for name, count in launches.items():
        want = expect.get(name, 0) if on_card else 0
        require(count == want, f"telemetry run: {name} launched {count} "
                f"times, expected {want}")
    (tfile,) = os.listdir(tdir)
    kernels, busy_ms, span_ms = trace_device(os.path.join(tdir, tfile))
    traced = {"panel_factor_cluster": "gtt_panel_cluster_kernel",
              "panel_factor": "gtt_panel_factor_kernel",
              "panel_trailing_fused": "gtt_fused_kernel"}
    in_trace = {name: sum(1 for k in kernels if sym in k)
                for name, sym in traced.items()}
    # The phase profile ran after the trace closed.
    want_trace = dict(launches)
    for key, count in phased_expect.items():
        want_trace[key] -= count if on_card else 0
    names = {}
    for k in kernels:
        if "gtt_" in k:
            names[k] = names.get(k, 0) + 1
    print(f"phase 5: hand-written kernels in the trace: {names}")
    require(not on_card or len(kernels) > 0, "the trace holds no kernel")
    for name in traced:
        require(in_trace[name] == want_trace[name], f"trace: {in_trace[name]}"
                f" {name} kernel events, {want_trace[name]} launches in the "
                f"traced window")
    print(f"phase 5: trace {tfile}: {len(kernels)} kernel events "
          f"({in_trace} of the hand-written kernels, as launched); device "
          f"busy {busy_ms:.3f} ms over {span_ms:.3f} ms from first to last "
          f"device event (warm-up, staging, timed solve, health monitors)")
    out["cli_trace"] = {"kernel_events": len(kernels), "busy_ms": busy_ms,
                        "device_span_ms": span_ms, "by_kernel": in_trace}

    # One timed solve of the CLI (the same call) traced alone: its device
    # busy time against its host wall.
    dev = resolve_device(DEVICE)
    a64, b64 = synthetic.internal_matrix(N), synthetic.internal_rhs(N)
    a_dev, b_dev = as_tensor(a64, dev), as_tensor(b64, dev)

    def timed_solve():
        return blocked.solve_refined(a64, b64, a_dev=a_dev, b_dev=b_dev,
                                     tol=1e-5)

    timed_solve()
    sync()
    with profiling.trace(os.path.join(work, "solve_trace"), DEVICE) as tr:
        t0 = time.perf_counter()
        timed_solve()
        sync()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels, busy_ms, span_ms = trace_device(tr.path)
    idle = 1.0 - busy_ms / host_ms
    print(f"phase 5: one traced timed solve (n={N}): host {host_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({len(kernels)} kernels), idle "
          f"share {idle:.4f}")
    out["traced_solve"] = {"host_ms": host_ms, "busy_ms": busy_ms,
                           "device_span_ms": span_ms, "idle_share": idle,
                           "kernel_events": len(kernels)}

    # (b) Application time without flags and with --metrics-out alone, in
    # turns: the same launches, the same residual.
    plain = ["-s", str(N), "--verify", "--device", DEVICE]
    times = {"no flags": [], "--metrics-out": []}
    seen = {}
    for i in range(3):
        for label, extra in (("no flags", []), ("--metrics-out", [
                "--metrics-out", os.path.join(work, f"timed_{i}.jsonl")])):
            _build.reset_launches()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = gauss_internal.main(plain + extra)
            text = buf.getvalue()
            require(rc == 0, f"{label} run exited {rc}")
            times[label].append(float(re.search(
                r"Application time: (\S+) Secs", text).group(1)))
            residual = re.search(r"Residual \|\|Ax-b\|\|: (\S+)", text).group(1)
            seen.setdefault((tuple(sorted(_build.LAUNCHES.items())),
                             residual), []).append(label)
    require(len(seen) == 1, f"observed and unobserved runs differ in "
            f"launches or residual: {seen}")
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"phase 5: Application time, median of 3 in turns: no flags "
          f"{med['no flags']:f} s {times['no flags']}, --metrics-out "
          f"{med['--metrics-out']:f} s {times['--metrics-out']}; launches "
          f"and residual equal in all 6")
    out["application_time_s"] = {"no_flags": times["no flags"],
                                 "metrics_out": times["--metrics-out"],
                                 "median_no_flags": med["no flags"],
                                 "median_metrics_out": med["--metrics-out"]}
    # The solve's host time outside the factorization, by span, from the
    # last untraced observed run.
    events, _, _ = read_stream(os.path.join(work, "timed_2.jsonl"))
    spans_s = {}
    for ev in events:
        if ev["type"] == "span":
            spans_s[ev["name"]] = spans_s.get(ev["name"], 0.0) + ev["dur_s"]
    print(f"phase 5: spans of the last observed run, s: {spans_s}")
    out["spans_s"] = spans_s

    # (c) The phased factorization against the unrolled panel-kernel form,
    # bit for bit, and its phase table (the second of two runs).
    a = torch.as_tensor(np.random.default_rng(SEED).standard_normal((N, N)),
                        dtype=torch.float32, device=dev)
    blocked.lu_factor_blocked_phased(a, device=dev)
    pt = profiling.PhaseTimer(emit=False)
    _build.reset_launches()
    fp = blocked.lu_factor_blocked_phased(a, timer=pt, device=dev)
    phased_launches = dict(_build.LAUNCHES)
    fu = blocked.lu_factor_blocked_unrolled(a, panel=panel,
                                            panel_impl="pallas", device=dev)
    sync()
    for field, x, y in zip(fp._fields, fp, fu):
        require(x is y is None or torch.equal(x, y),
                f"phased != unrolled pallas: {field}")
    require(phased_launches == {k: phased_expect.get(k, 0) if on_card else 0
                                for k in phased_launches},
            f"phased launches {phased_launches}")
    print(f"phase 5: lu_factor_blocked_phased == lu_factor_blocked_unrolled"
          f"(panel_impl='pallas') bit for bit (m, perm, min_abs_pivot, linv, "
          f"uinv) at n={N}, panel {panel}; launches {phased_expect}")
    print(pt.report())
    out["phase_s"] = {k: pt.seconds[k] for k in PHASES}
    out["phase_share"] = {k: pt.seconds[k] / pt.total for k in PHASES}

    # (d) The other CLIs, observed once each.
    ext = os.path.join(work, "external.jsonl")
    print(f"phase 5: gauss_external {dat} --debug --metrics-out {ext}")
    text = run_cli(gauss_external, [dat, "--debug", "--metrics-out", ext,
                                    "--device", DEVICE])
    require("DEBUG: partial pivoting moved" in text, "external --debug line")
    events, spans, _ = read_stream(ext)
    require({"parse_dat", "manufacture_rhs", "verify", "computeGauss",
             "compile:cuda_blocked_warmup"} <= spans, f"external {spans}")
    errs = [ev["max_rel_error"] for ev in events
            if ev["type"] == "health" and "max_rel_error" in ev]
    require(len(errs) == 1 and errs[0] <= 1e-4, f"external errors {errs}")

    mm = os.path.join(work, "matmul.jsonl")
    mdir = os.path.join(work, "matmul_trace")
    argv = [str(N), "--engines", "cuda,cuda-kernel,cuda-kernel-v1",
            "--metrics-out", mm, "--trace", mdir, "--device", DEVICE]
    print(f"phase 5: matmul {' '.join(argv)}")
    _build.reset_launches()
    run_cli(mm_cli, argv)
    mm_launches = dict(_build.LAUNCHES)
    events, spans, _ = read_stream(mm)
    engines = ("cuda", "cuda-kernel", "cuda-kernel-v1")
    require(spans == {"prepare_inputs", "verify"}
            | {f"matmul:{e}" for e in engines}
            | {f"compile:matmul_warmup:{e}" for e in engines},
            f"matmul spans {spans}")
    healths = [ev for ev in events if ev["type"] == "health"]
    require(len(healths) == 3 and all(ev["verified"] for ev in healths),
            f"matmul health {healths}")
    (tfile,) = os.listdir(mdir)
    kernels, _, _ = trace_device(os.path.join(mdir, tfile))
    for name, sym in (("matmul_tiled", "gtt_matmul_tiled"),
                      ("matmul_stripe", "gtt_matmul_stripe_kernel")):
        got = sum(1 for k in kernels if sym in k)
        require(got == mm_launches[name] == (2 if on_card else 0),
                f"matmul trace: {got} {name} kernel events, "
                f"{mm_launches[name]} launches")

    sp = os.path.join(work, "sparse.jsonl")
    repeats = 3
    argv = ["--skip-giant", "--repeats", str(repeats), "--seed", str(SEED),
            "--metrics-out", sp, "--device", DEVICE]
    print(f"phase 5: sparse check {' '.join(argv)}")
    _build.reset_launches()
    run_cli(check, argv)
    events, spans, counters = read_stream(sp)
    solves = [ev for ev in events if ev["type"] == "sparse_solve"]
    require(spans == {"sparse_check_smoke"}, f"sparse spans {spans}")
    # Three methods per repeat, and the routed leg's one CG solve.
    require(len(solves) == 3 * repeats + 1 and counters.get("sparse.solves")
            == len(solves) and "sparse.stagnations" not in counters,
            f"sparse counters {counters}, {len(solves)} sparse_solve events")
    spmv = sum(krylov_launches(ev["method"], ev["iterations"])
               for ev in solves)
    require(_build.LAUNCHES["spmv_ell"] == (spmv if on_card else 0),
            f"sparse: {_build.LAUNCHES['spmv_ell']} SpMV launches, the "
            f"events' iteration counts imply {spmv}")
    print(f"phase 5: sparse.solves {counters['sparse.solves']} == "
          f"{len(solves)} sparse_solve events; {spmv} SpMV launches as the "
          f"events' iteration counts imply")
    print(json.dumps({"telemetry": out}))
    return launches, out


def factor_plan(n: int, panel: int, chunk: int | None = None,
                itemsize: int = 4, unfused: bool = False):
    """The kernel launches of one ``"auto"`` factorization on the card, in
    order, as ``(launch key, phase-A route, strip height)``: the chunked
    form at ``chunk`` (the fused kernel on each panel with columns right of
    it inside its group, the panel kernel on the group's last panel), or
    with ``chunk=None`` the unrolled (and flat) form, one group of every
    panel; ``itemsize`` 2 for the bfloat16 forms; ``unfused`` the
    ``"pallas"`` route (the panel kernel on every panel)."""
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.kernels import panel_fused as kf

    sfx = "_bf16" if itemsize == 2 else ""
    npad = -(-n // panel) * panel
    nb = npad // panel
    chunk = nb if chunk is None else chunk
    plan = []
    for g0 in range(0, nb, chunk):
        gh = npad - g0 * panel
        w = min(chunk, nb - g0) * panel
        for kb in range(0, w, panel):
            h = gh - kb
            if not unfused and panel >= 64 and w - kb > panel:
                plan.append(("panel_trailing_fused" + sfx, kf.fused_geometry(
                    h, w, panel, kb, itemsize=itemsize).route, h))
            else:
                plan.append((panel_launch_key(h, panel, itemsize),
                             kp.panel_geometry(h, panel, itemsize).route, h))
    return plan


def plan_counts(*plans) -> dict:
    """Launches per key over the plans, every key of the counts present."""
    from gauss_tpu_torch.kernels import _build

    out = dict.fromkeys(_build.LAUNCHES, 0)
    for plan in plans:
        for key, _, _ in plan:
            out[key] += 1
    return out


def plan_mismatch(got, plan) -> str:
    """Where a trace's ``(key, route, ...)`` kernels leave the plan's, with
    the summary last, where the end of an error stream still shows it."""
    got = [(k, r) for k, r, *_ in got]
    plan = [(k, r) for k, r, *_ in plan]
    i = next((i for i, (g, p) in enumerate(zip(got, plan)) if g != p),
             min(len(got), len(plan)))
    return (f"the trace's kernels {got} != the plan {plan}: the trace holds "
            f"{len(got)} of the plan's {len(plan)}, first difference at "
            f"{i}: trace {got[i:i + 3]}, plan {plan[i:i + 3]}")


def route_counts(plan) -> dict:
    out = {}
    for key, route, _ in plan:
        out[f"{key}/{route}"] = out.get(f"{key}/{route}", 0) + 1
    return out


@contextlib.contextmanager
def checked_launches(seen: dict, errs: dict | None = None, held=None,
                     deferred: bool = False, timing: dict | None = None):
    """Inside the block, the panel-kernel and fused-kernel launches that
    ``core/blocked`` makes are held against the plain version on a copy of
    their input: the panel kernel bit for bit; the fused kernel's panel,
    pivots, permutation and min |pivot| bit for bit, its updated block
    within TOL (a bfloat16 block: bf16_block_check) of the plain one and
    bit for bit equal to the unfused pair (panel kernel + reconstruction +
    trailing kernel) on the same input. ``held``, when given, is the set
    of places in launch order (from 0) of the launches held, else every
    launch is; with ``deferred`` a held launch keeps a copy of its input
    and of its outputs and is held when the block ends, outside whatever
    the block times. ``seen`` counts the held launches, the strided ones
    (leading dimension above the width), those on phase A's grid route
    and on its one-block route, and those with no trailing columns;
    ``errs``, when given, keeps the largest fused error over its scale by
    dtype; ``timing``, when given, gets every launch by key (kernel 1's
    launch key, which names its route; kernel 2's ``key/route``): its
    launches, strip heights and, on the card, its device ms from CUDA
    events around it (``ms`` summed, ``max_ms``)."""
    import torch

    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.kernels import panel_fused as kf

    real_pf, real_fused = blocked.panel_factor, blocked.panel_trailing_fused
    on_card = DEVICE == "cuda"
    order, kept, events = [0], [], []

    def note(kind, x, route, empty):
        for key, hit in ((kind, True),
                         (kind + " strided", x.stride(0) > x.shape[1]),
                         (kind + " grid", route == "grid"),
                         (kind + " one-block", route == "block"),
                         (kind + " no trailing", empty)):
            if hit:
                seen[key] = seen.get(key, 0) + 1

    def launch(key, h, src, run, check):
        """``run()`` -> (its return value, the outputs to hold), timed
        and, where its place is held, checked by ``check(input, outputs)``
        now or when the block ends."""
        i = order[0]
        order[0] += 1
        hit = held is None or i in held
        x = src.clone() if hit else None
        start = end = None
        if timing is not None and on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        got, outs = run()
        if start is not None:
            end.record()
        if timing is not None:
            events.append((key, h, start, end))
        if hit and deferred:
            kept.append((check, x, tuple(t.clone() if torch.is_tensor(t)
                                         else t for t in outs)))
        elif hit:
            check(x, outs)
        return got, hit

    def panel_factor(p, kb=0, seg=None):
        where = (f"panel kernel at {tuple(p.shape)} (ld {p.stride(0)}, "
                 f"kb={kb})")

        def check(x, outs):
            require(same_outputs(outs, kp.panel_factor_plain(x, kb)),
                    f"{where} differs from the plain version")

        def run():
            got = real_pf(p, kb, seg)
            return got, got

        got, hit = launch(panel_launch_key(*p.shape, p.element_size()),
                          p.shape[0], p, run, check)
        if hit:
            note("panel", p, kp.panel_geometry(
                *p.shape, p.element_size()).route, False)
        return got

    def fused(block, col0, kbrow, *, panel, **kw):
        route = kf.fused_geometry(*block.shape, panel, col0,
                                  itemsize=block.element_size()).route
        where = (f"fused kernel at {tuple(block.shape)} (ld "
                 f"{block.stride(0)}, col0={col0}, kbrow={kbrow})")

        def check(x, outs):
            after = outs[4]
            ref = kf.panel_trailing_fused_plain(x.clone(), col0, kbrow,
                                                panel=panel)
            require(same_outputs(outs[:4], ref[:4]),
                    f"{where}: panel or pivots differ from the plain version")
            if after.dtype == torch.bfloat16:
                _, rel, share = bf16_block_check(where, after, ref[4],
                                                 col0 + panel)
                if errs is not None:
                    errs["bfloat16 share"] = max(
                        errs.get("bfloat16 share", 0.0), share)
            else:
                scale = float(ref[4].abs().max())
                err = float((after - ref[4]).abs().max())
                require(err <= TOL * scale, f"{where}: max |kernel - plain| "
                        f"{err} > {TOL} x {scale}")
                rel = err / scale
            if errs is not None:
                key = str(after.dtype).replace("torch.", "")
                errs[key] = max(errs.get(key, 0.0), rel)
            pair = x.clone()
            p2, ipiv2, perm2, _ = kp.panel_factor(
                pair[:, col0:col0 + panel], kbrow)
            mult, onehot = kf.reconstruct_mult_pt(p2, ipiv2, perm2, kbrow,
                                                  panel)
            kf.trailing_update(pair, mult, onehot, col0)
            require(torch.equal(pair, after), f"{where}: != the unfused pair")

        def run():
            got = real_fused(block, col0, kbrow, panel=panel, **kw)
            return got, (*got[:4], block)

        sfx = "_bf16" if block.element_size() == 2 else ""
        got, hit = launch(f"panel_trailing_fused{sfx}/{route}",
                          block.shape[0], block, run, check)
        if hit:
            note("fused", block, route, col0 + panel == block.shape[1])
        return got

    blocked.panel_factor, blocked.panel_trailing_fused = panel_factor, fused
    try:
        yield fused
    finally:
        blocked.panel_factor = real_pf
        blocked.panel_trailing_fused = real_fused
    sync()
    for check, x, outs in kept:
        check(x, outs)
    kept.clear()
    if timing is not None:
        for key, h, start, end in events:
            r = timing.setdefault(key, {"launches": 0, "ms": 0.0,
                                        "max_ms": 0.0, "h_max": h,
                                        "h_min": h})
            r["launches"] += 1
            r["h_max"], r["h_min"] = max(r["h_max"], h), min(r["h_min"], h)
            if start is not None:
                ms = start.elapsed_time(end)
                r["ms"] += ms
                r["max_ms"] = max(r["max_ms"], ms)
        for r in timing.values():
            r["ms"], r["max_ms"] = round(r["ms"], 4), round(r["max_ms"], 4)


def bf16_block_check(where: str, got, ref, c1: int) -> tuple:
    """A bfloat16 block of the fused or trailing kernel against the plain
    version's: max |got - ref| within TOL_BF16 of max |ref|, and at most
    TOL_BF16_SHARE of the trailing elements (columns from ``c1``)
    differing. Returns (max error, max error over the scale, the share)."""
    err, scale, share = bf16_block_stats(got, ref, c1)
    require(err <= TOL_BF16 * scale, f"{where}: max |kernel - plain| {err} "
            f"> {TOL_BF16} x {scale}")
    require(share <= TOL_BF16_SHARE, f"{where}: {share:.4f} of the trailing "
            f"elements differ from the plain version (> {TOL_BF16_SHARE})")
    return err, err / scale if scale else 0.0, share


def bf16_block_stats(got, ref, c1: int) -> tuple:
    """max |got - ref|, max |ref|, and the share of the elements from
    column ``c1`` on where ``got`` and ``ref`` differ."""
    d = (got.float() - ref.float()).abs()
    tail = d[:, c1:]
    share = float((tail > 0).float().mean()) if tail.numel() else 0.0
    return float(d.max()), float(ref.float().abs().max()), share


def factor_err(f1, f2) -> float:
    """``perm`` equal, then the largest of ``m``/``linv``/``uinv``'s max
    |f1 - f2| over max |m|, on the CPU in float64."""
    import torch

    require(torch.equal(f1.perm.cpu(), f2.perm.cpu()), "perm differs")
    scale = float(f2.m.abs().max())
    return max(float((getattr(f1, f).cpu().double()
                      - getattr(f2, f).cpu().double()).abs().max())
               for f in ("m", "linv", "uinv")) / scale


def field_errs(f1, f2) -> dict:
    """``perm`` equal, then for each of ``m``/``linv``/``uinv`` max |f1 -
    f2| over max |f2| of that field, on the CPU in float64 (the bfloat16
    check: its inverses carry their own scale)."""
    import torch

    require(torch.equal(f1.perm.cpu(), f2.perm.cpu()), "perm differs")
    out = {}
    for f in ("m", "linv", "uinv"):
        x, y = (getattr(g, f).cpu().double() for g in (f1, f2))
        out[f] = float((x - y).abs().max() / y.abs().max())
    return out


def lu_f64(a, perm, panel: int):
    """The reference for :func:`factor_err`: ``a`` identity-padded to a
    multiple of ``panel``, its rows ordered by ``perm`` (the pivots of the
    factor under test), factored without pivoting in float64 by numpy,
    with the inverses of its diagonal blocks. Shares no code with the
    port."""
    import torch

    from gauss_tpu_torch.core.blocked import BlockedLU

    n = a.shape[0]
    npad = -(-n // panel) * panel
    m = np.eye(npad)
    m[:n, :n] = np.asarray(a, dtype=np.float64)
    m = m[np.asarray(perm.cpu())]
    for k in range(npad - 1):
        m[k + 1:, k] /= m[k, k]
        m[k + 1:, k + 1:] -= np.outer(m[k + 1:, k], m[k, k + 1:])
    low, up = np.tril(m, -1) + np.eye(npad), np.triu(m)

    def inv(t):
        return torch.as_tensor(np.stack(
            [np.linalg.inv(t[k:k + panel, k:k + panel])
             for k in range(0, npad, panel)]))

    return BlockedLU(torch.as_tensor(m), perm.cpu(),
                     torch.as_tensor(np.abs(np.diag(up)).min()), inv(low),
                     inv(up))


def backward_err(a, lu, perm) -> float:
    """``||A[perm] - LU||_F / ||A||_F`` in float64 on ``a``'s device: ``lu``
    the packed factor (L's multipliers below the diagonal, U on and
    above), ``a`` identity-padded to its size."""
    import torch

    n, npad = a.shape[0], lu.shape[0]
    eye = torch.eye(npad, dtype=torch.float64, device=a.device)
    ap = eye.clone()
    ap[:n, :n] = a
    lu = lu.double()
    r = ap[perm] - (torch.tril(lu, -1) + eye) @ torch.triu(lu)
    return float(torch.linalg.norm(r) / torch.linalg.norm(ap))


def lu_factor_perm(piv):
    """The row order of ``torch.linalg.lu_factor``'s pivots (LAPACK's
    1-based sequential exchanges)."""
    import torch

    perm = list(range(len(piv)))
    for i, p in enumerate(piv.cpu().tolist()):
        perm[i], perm[p - 1] = perm[p - 1], perm[i]
    return torch.as_tensor(perm, device=piv.device)


# The hand-written panel kernels' trace names, demangled and mangled
# (CUPTI may report either), with the launch key and phase-A route each
# stands for.
TRACE_KINDS = (
    (("gtt_fused_kernel<true>", "gtt_fused_kernelILb1E"),
     "panel_trailing_fused", "cluster"),
    (("gtt_fused_kernel<false>", "gtt_fused_kernelILb0E"),
     "panel_trailing_fused", "block"),
    (("gtt_fused_grid_kernel",), "panel_trailing_fused", "grid"),
    (("gtt_panel_cluster_kernel",), "panel_factor_cluster", "cluster"),
    (("gtt_panel_grid_kernel",), "panel_factor_grid", "grid"),
    (("gtt_panel_factor_kernel",), "panel_factor", "block"),
    (("gtt_fused_bf16_kernel<true>", "gtt_fused_bf16_kernelILb1E"),
     "panel_trailing_fused_bf16", "cluster"),
    (("gtt_fused_bf16_kernel<false>", "gtt_fused_bf16_kernelILb0E"),
     "panel_trailing_fused_bf16", "block"),
    (("gtt_fused_grid_bf16_kernel",), "panel_trailing_fused_bf16", "grid"),
    (("gtt_panel_cluster_bf16_kernel",), "panel_factor_cluster_bf16",
     "cluster"),
    (("gtt_panel_grid_bf16_kernel",), "panel_factor_grid_bf16", "grid"),
    (("gtt_panel_factor_bf16_kernel",), "panel_factor_bf16", "block"),
    (("gtt_fused_batched_kernel<true>", "gtt_fused_batched_kernelILb1E"),
     "panel_trailing_fused_batched", "cluster"),
    (("gtt_fused_batched_kernel<false>", "gtt_fused_batched_kernelILb0E"),
     "panel_trailing_fused_batched", "block"),
    (("gtt_fused_batched_grid_kernel",), "panel_trailing_fused_batched",
     "grid"),
    (("gtt_fused_batched_bf16_kernel<true>",
      "gtt_fused_batched_bf16_kernelILb1E"),
     "panel_trailing_fused_batched_bf16", "cluster"),
    (("gtt_fused_batched_bf16_kernel<false>",
      "gtt_fused_batched_bf16_kernelILb0E"),
     "panel_trailing_fused_batched_bf16", "block"),
    (("gtt_fused_batched_grid_bf16_kernel",),
     "panel_trailing_fused_batched_bf16", "grid"),
    (("gtt_batched_regs_kernel",), "panel_factor_batched", "regs"),
    (("gtt_batched_cluster_kernel",), "panel_factor_batched", "cluster"),
    (("gtt_panel_batched_kernel<true>", "gtt_panel_batched_kernelILb1E"),
     "panel_factor_batched", "smem"),
    (("gtt_panel_batched_kernel<false>", "gtt_panel_batched_kernelILb0E"),
     "panel_factor_batched", "global"),
    (("gtt_batched_regs_bf16_kernel",), "panel_factor_batched_bf16", "regs"),
    (("gtt_batched_cluster_bf16_kernel",), "panel_factor_batched_bf16",
     "cluster"),
    (("gtt_panel_batched_bf16_kernel<true>",
      "gtt_panel_batched_bf16_kernelILb1E"), "panel_factor_batched_bf16",
     "smem"),
    (("gtt_panel_batched_bf16_kernel<false>",
      "gtt_panel_batched_bf16_kernelILb0E"), "panel_factor_batched_bf16",
     "global"))


# About 10 ms of spin on the H100: the profiler keeps only the device
# events that its clock puts inside the profiling window, so a marker this
# long on each side of the call keeps the call's kernels well inside it.
TRACE_MARKER_CYCLES = 1 << 24
#: Spin markers queued, each to a synchronize, before a traced call. More
#: than one does not help: after a whole run a session drops every device
#: record up to its call's first kernel, however many markers lead it
#: (scripts/probe_trace_sessions.py --lead-markers 3; ROADMAP queue 3).
TRACE_LEAD_MARKERS = 1


def trace_launches(fn, path: str):
    """One traced call of ``fn``: its hand-written kernels in launch order
    as ``(key, route, device ms)``, the device busy ms, and the call's host
    ms (to a synchronize). TRACE_LEAD_MARKERS spin kernels finished inside
    the profile before the call, and one queued after the call's
    synchronize, hold the call's kernels away from the ends of the
    profiling window, where the profiler drops a device event whose clock
    reading falls outside it, and give a session that drops its first
    device records (ROADMAP queue 3, fault 1) markers to drop; only the
    events between the last leading marker and the trailing one count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
    with profile(activities=acts) as prof:
        if DEVICE == "cuda":
            for _ in range(TRACE_LEAD_MARKERS):
                torch.cuda._sleep(TRACE_MARKER_CYCLES)
                sync()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        host_ms = 1e3 * (time.perf_counter() - t0)
        if DEVICE == "cuda":
            torch.cuda._sleep(TRACE_MARKER_CYCLES)
        sync()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and e.get("ph") == "X"), key=lambda e: float(e["ts"]))
    until = float("inf")
    if kernels and "spin" in kernels[-1]["name"]:
        until = float(kernels.pop()["ts"])
    marks = [float(e["ts"]) + float(e.get("dur", 0)) for e in kernels
             if "spin" in e["name"]]
    since = marks[-1] if marks else float("-inf")
    out = []
    for e in kernels:
        if float(e["ts"]) < since:
            continue
        for syms, key, route in TRACE_KINDS:
            if any(sym in e["name"] for sym in syms):
                out.append((key, route, float(e.get("dur", 0)) / 1e3))
    _, busy, _ = trace_device(path, since, until)
    return out, busy, host_ms


def trace_kinds_anywhere(path: str) -> dict:
    """The hand-written kernels of a Chrome trace by key and route, with no
    marker window, and its kernel events in all: what a trace that lost a
    planned kernel holds (an event outside the window, or none at all)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    out = {"kernel_events": len(kernels)}
    for e in kernels:
        for syms, key, route in TRACE_KINDS:
            if any(sym in e["name"] for sym in syms):
                out[f"{key}/{route}"] = out.get(f"{key}/{route}", 0) + 1
    return out


def in_fresh_process(expr: str, timeout: int = 600):
    """``expr`` (this script imported as ``c``) evaluated in a fresh Python
    process on the card, its value as JSON: a traced call that the
    profiler lost kernels of after a whole run's earlier profiler sessions
    (ROADMAP queue 3, fault 1) is traced again where no session ran."""
    code = (f"import json, sys; sys.path.insert(0, {REPO!r}); "
            f"import chip_smoke as c; print(json.dumps({expr}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout)
    require(r.returncode == 0, f"the fresh process for {expr} exited "
            f"{r.returncode}: {(r.stdout + r.stderr)[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def trace_plan(fn, path: str, plan, fresh: str = None):
    """``trace_launches`` of a call whose kernels ``plan`` lists, with the
    number of traces taken. A trace that holds the plan with entries
    missing (events the profiler lost; a launch the call skipped would
    also fail the launch counts) is taken once more: in a fresh process
    where ``fresh`` gives the expression that traces the same call there
    (``in_fresh_process``), else in this one. A kernel out of the plan's
    order or on another route fails at once."""
    want = [(k, r) for k, r, *_ in plan]
    got, busy, host_ms = trace_launches(fn, path)
    seen = [(k, r) for k, r, _ in got]
    rest = iter(want)
    if seen != want and all(any(g == p for p in rest) for g in seen):
        print(f"trace of {os.path.basename(path)}: {len(seen)} of the plan's "
              f"{len(want)} kernels recorded, the rest missing (the whole "
              f"trace, no window: {trace_kinds_anywhere(path)}); tracing "
              f"once more" + (" in a fresh process" if fresh else ""))
        if fresh and DEVICE == "cuda":
            got, busy, host_ms = in_fresh_process(fresh)
            return [tuple(g) for g in got], busy, host_ms, 2
        return (*trace_launches(fn, path), 2)
    return got, busy, host_ms, 1


def chunked_factor_trace(n: int, panel: int, chunk: int, itemsize: int,
                         path: str):
    """``trace_launches`` of one chunked factorization of a traced cell,
    after one untraced call: phase 6 (c)'s random float32 matrix of seed
    SEED + n (itemsize 4), or phase 7 (d)'s dominant system of seed
    SEED + n at bfloat16 (itemsize 2)."""
    import torch

    from gauss_tpu_torch.core import blocked

    if itemsize == 4:
        a = torch.as_tensor(np.random.default_rng(SEED + n).standard_normal(
            (n, n)), dtype=torch.float32, device=torch.device(DEVICE))
    else:
        a = torch.as_tensor(dominant_system(n, SEED + n)[0],
                            dtype=torch.bfloat16, device=torch.device(DEVICE))

    def call():
        return blocked.lu_factor_blocked_chunked(a, panel=panel, chunk=chunk,
                                                 device=DEVICE)

    call()
    sync()
    return trace_launches(call, path)


def large_cell(n: int, panel: int, chunk: int, work: str) -> dict:
    """One full-size cell (module docstring, phase 6 (c))."""
    import torch

    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    on_card = DEVICE == "cuda"
    a = torch.as_tensor(np.random.default_rng(SEED + n).standard_normal(
        (n, n)), dtype=torch.float32, device=torch.device(DEVICE))

    def call():
        return blocked.lu_factor_blocked_chunked(a, panel=panel, chunk=chunk,
                                                 device=DEVICE)

    plan = factor_plan(n, panel, chunk)
    require(all(r != "block" for _, r, _ in plan), f"n={n}: the plan sends "
            f"a strip to the one-block route: {route_counts(plan)}")
    _build.reset_launches()
    fac = call()
    sync()
    want = plan_counts(plan) if on_card else plan_counts()
    require(dict(_build.LAUNCHES) == want, f"n={n}: launches "
            f"{dict(_build.LAUNCHES)}, the plan says {want}")
    require(bool(torch.isfinite(fac.m).all()) and float(fac.min_abs_pivot)
            > 0, f"n={n}: factor not finite or singular")
    nb = -(-n // panel)
    rec = {"n": n, "panel": panel, "chunk": chunk, "groups": -(-nb // chunk),
           "launches": route_counts(plan),
           "bound_ms": bound(8.0 * n * n, 2.0 * n ** 3 / 3)[0],
           "backward_err": backward_err(a, fac.m, fac.perm)}
    del fac
    with quiet_fd1():
        lu, piv = torch.linalg.lu_factor(a)
    rec["lu_factor_backward_err"] = backward_err(a, lu, lu_factor_perm(piv))
    del lu, piv
    require(rec["backward_err"] <= BACKWARD_RATIO
            * rec["lu_factor_backward_err"], f"n={n}: backward error "
            f"{rec['backward_err']}, lu_factor's "
            f"{rec['lu_factor_backward_err']}")
    # Every launch at this cell's own shapes against its plain version.
    seen = {}
    with checked_launches(seen):
        call()
        sync()
    fused = [r for k, r, _ in plan if k == "panel_trailing_fused"]
    panels = [r for k, r, _ in plan if k != "panel_trailing_fused"]
    # A group's block is a strided view of the matrix unless it is the
    # whole matrix; a panel always is.
    want = {"fused": len(fused),
            "fused strided": len(fused) if rec["groups"] > 1 else 0,
            "fused grid": fused.count("grid"),
            "fused one-block": fused.count("block"), "panel": len(panels),
            "panel strided": len(panels), "panel grid": panels.count("grid"),
            "panel one-block": panels.count("block")}
    require(seen == {k: v for k, v in want.items() if v},
            f"n={n}: checked launches {seen}, the plan gives {want}")
    rec["checked_launches"] = seen
    if on_card:
        rec["factor_ms"] = cuda_event_ms(call, 3, warmup=1)
        with quiet_fd1():
            rec["lu_factor_ms"] = cuda_event_ms(
                lambda: torch.linalg.lu_factor(a), 3, warmup=1)
        tpath = os.path.join(work, f"factor_{n}.json")
        got, busy, host_ms, traces = trace_plan(
            call, tpath, plan,
            fresh=f"c.chunked_factor_trace({n}, {panel}, {chunk}, 4, "
                  f"{tpath!r})")
        require([(k, r) for k, r, _ in got] == [(k, r) for k, r, _ in plan],
                f"n={n}: {plan_mismatch(got, plan)}")
        dev_ms = {}
        for (key, route, ms) in got:
            dev_ms[f"{key}/{route}"] = dev_ms.get(f"{key}/{route}", 0.0) + ms
        rec.update(
            device_ms=dev_ms, busy_ms=busy, traced_host_ms=host_ms,
            traces=traces,
            idle_share=1.0 - busy / host_ms,
            other_device_ms=busy - sum(dev_ms.values()),
            grid_route_ms_by_height=[
                [key, h, round(ms, 4)] for (key, route, h), (_, _, ms)
                in zip(plan, got) if route == "grid"])
    print(f"phase 6: n={n}, panel {panel}, chunk {chunk} "
          f"({rec['groups']} groups): launches {rec['launches']}; every "
          f"launch of one factorization against its plain version: {seen}; "
          f"backward error {rec['backward_err']:.3e} (lu_factor "
          f"{rec['lu_factor_backward_err']:.3e})"
          + (f"; factor {rec['factor_ms']:.3f} ms (median of 3), "
             f"lu_factor {rec['lu_factor_ms']:.3f} ms, bound "
             f"{rec['bound_ms']:.3f} ms; traced call: kernels "
             f"{ {k: round(v, 3) for k, v in rec['device_ms'].items()} } "
             f"ms, other device work {rec['other_device_ms']:.3f} ms, busy "
             f"{busy:.3f} of {host_ms:.3f} ms host (idle share "
             f"{rec['idle_share']:.4f}); grid-route launches [key, height, "
             f"ms]: {rec['grid_route_ms_by_height']}"
             if on_card else "") + f" [{smi_line() if on_card else 'cpu'}]")
    return rec


def phase_large_n():
    """The large-n routes (module docstring, phase 6): returns the launch
    counts of the counted path (d) and the phase's figures."""
    import torch

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.cli import gauss_internal
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.verify import checks

    on_card = DEVICE == "cuda"
    dev = torch.device(DEVICE)
    card = smi_line() if on_card else "cpu"
    work = os.path.join(REPO, "build", "chip_smoke", "large_n")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {"card": card}

    # (a) Routing, as the card sees it.
    forms = {blocked.lu_factor_blocked_unrolled: "unrolled",
             blocked.lu_factor_blocked_chunked: "chunked",
             blocked.lu_factor_blocked: "flat"}
    for n, form, chunk, panel in ROUTES:
        f = blocked.resolve_factor(n, "auto", device="cuda")
        got = (forms[getattr(f, "func", f)],
               getattr(f, "keywords", {}).get("chunk", blocked.CHUNK_DEFAULT)
               if form == "chunked" else None, blocked.auto_panel(n))
        require(got == (form, chunk, panel), f"resolve_factor({n}) on the "
                f"card: {got}, expected {(form, chunk, panel)}")
        print(f"phase 6: resolve_factor({n}, 'auto') on the card: {form}"
              + (f", chunk {chunk}" if chunk else "") + f", panel {panel}")

    # (b) The chunked form launch by launch at CHUNK_CHECK, against the CPU.
    n, panel, chunks = CHUNK_CHECK
    a = np.random.default_rng(SEED).standard_normal((n, n)).astype(
        np.float32)
    seen = {}
    errs = {}
    for strip in (None, CHUNK_CHECK_STRIP):
        saved = (blocked.GROUP_UPDATE_STRIP,
                 blocked.GROUP_UPDATE_UNSTRIPPED_MAX_BYTES)
        if strip:
            blocked.GROUP_UPDATE_STRIP = strip
            blocked.GROUP_UPDATE_UNSTRIPPED_MAX_BYTES = 0
        try:
            for chunk in chunks:
                with checked_launches(seen):
                    fg = blocked.lu_factor_blocked_chunked(
                        a, panel=panel, chunk=chunk, device=DEVICE)
                    sync()
                fc = blocked.lu_factor_blocked_chunked(
                    a, panel=panel, chunk=chunk, device="cpu")
                e = {"card_vs_cpu": factor_err(fg, fc)}
                f64 = lu_f64(a, fg.perm, panel)
                e.update(cpu_vs_f64=factor_err(fc, f64),
                         card_vs_f64=factor_err(fg, f64))
                require(e["card_vs_f64"] <= min(F64_CAP, F64_RATIO
                                                * e["cpu_vs_f64"]),
                        f"chunked n={n} chunk {chunk}"
                        f"{' strip form' if strip else ''}: {e} (x max|m|)")
                errs[f"chunk {chunk}" + (" strip" if strip else "")] = e
        finally:
            (blocked.GROUP_UPDATE_STRIP,
             blocked.GROUP_UPDATE_UNSTRIPPED_MAX_BYTES) = saved
    # One fused launch with no trailing columns, on a strided view.
    full = torch.as_tensor(np.random.default_rng(SEED + 1).standard_normal(
        (n, n)), dtype=torch.float32, device=dev)
    with checked_launches(seen) as fused:
        fused(full[panel:, panel:3 * panel], panel, 0, panel=panel)
    # Both update forms ran every launch of each chunk's plan, plus the
    # launch with no trailing columns.
    plans = sum(len(factor_plan(n, panel, c)) for c in chunks)
    require(seen.get("fused no trailing") == 1
            and seen.get("fused strided") == seen.get("fused")
            and seen["fused"] + seen.get("panel", 0) == 2 * plans + 1,
            f"checked launches {seen}, plans {plans}")
    out["chunk_check"] = {"n": n, "panel": panel, "launches": seen,
                          "whole_factor": errs}
    print(f"phase 6: chunked n={n}, panel {panel}, chunk {chunks}, unstripped "
          f"and strip form ({CHUNK_CHECK_STRIP}-row strips): checked "
          f"launches {seen}, each against its plain version; whole factor, "
          f"x max|m| (perm equal throughout): {errs} [{card}]")

    # (c) The full-size cells.
    out["cells"] = [large_cell(n, p, c, work) for n, p, c in LARGE_CELLS]

    # (d) The counted path.
    (n8, p8, c8), (n12, p12, c12) = LARGE_CELLS
    _build.reset_launches()
    print(f"phase 6: gauss_internal -s {n8} --verify")
    t0 = time.perf_counter()
    text = run_cli(gauss_internal, ["-s", str(n8), "--verify", "--device",
                                    DEVICE])
    require("Verification: solution pattern (-0.5, 0...0, 0.5) OK" in text,
            f"gauss_internal -s {n8}: verification failed")
    res = float(re.search(r"Residual \|\|Ax-b\|\|: (\S+)", text).group(1))
    require(res < GATE, f"gauss_internal -s {n8}: residual {res}")
    out["internal"] = {"n": n8, "residual": res, "application_time_s": float(
        re.search(r"Application time: (\S+) Secs", text).group(1)),
        "wall_s": time.perf_counter() - t0}
    print(f"phase 6: gauss_internal -s {n8}: Application time "
          f"{out['internal']['application_time_s']} s, residual {res:.3e}, "
          f"{out['internal']['wall_s']:.3f} s wall [{card}]")
    a12, b12 = synthetic.internal_matrix(n12), synthetic.internal_rhs(n12)
    t0 = time.perf_counter()
    x, fac = blocked.solve_refined(a12, b12, device=DEVICE)
    wall = time.perf_counter() - t0
    res = checks.residual_norm(a12, x, b12)
    require(checks.internal_pattern_ok(x, atol=1e-4) and res < GATE,
            f"solve_refined n={n12}: residual {res}")
    out["refined"] = {"n": n12, "residual": res, "wall_s": wall}
    print(f"phase 6: solve_refined internal n={n12}: pattern OK, residual "
          f"{res:.3e}, {wall:.3f} s wall [{card}]")
    del a12, b12, x, fac
    # The flat form at FLAT_N.
    af, bf = synthetic.internal_matrix(FLAT_N), synthetic.internal_rhs(
        FLAT_N)
    x, fac = blocked.solve_refined(af, bf, unroll=False, device=DEVICE)
    res = checks.residual_norm(af, x, bf)
    require(checks.internal_pattern_ok(x, atol=1e-4) and res < GATE
            and fac.abft_err is None, f"flat n={FLAT_N}: residual {res}")
    ar = torch.as_tensor(np.random.default_rng(SEED + 2).standard_normal(
        (FLAT_N, FLAT_N)), dtype=torch.float32, device=dev)
    fa = blocked.lu_factor_blocked(ar, panel=None, abft=True, device=DEVICE)
    fp = blocked.lu_factor_blocked(ar, panel=None, panel_impl="pallas",
                                   device=DEVICE)
    require(same_outputs([fa.m, fa.perm, fa.linv, fa.uinv],
                         [fp.m, fp.perm, fp.linv, fp.uinv]),
            "abft=True != panel_impl='pallas' bit for bit")
    tol = blocked.abft_default_tol(fa.m.shape[0], torch.float32,
                                   float(ar.sum(0).abs().max()))
    abft_max = float(fa.abft_err.max())
    require(bool(torch.isfinite(fa.abft_err).all()) and abft_max < tol,
            f"abft_err max {abft_max} >= {tol}")
    sing = ar.clone()
    sing[:, 7] = 0.0
    sing[40] = sing[3]
    fz = blocked.lu_factor_blocked(sing, panel=None, zero_pivot_safe=True,
                                   device=DEVICE)
    require(bool(torch.isfinite(fz.m).all()) and float(fz.min_abs_pivot)
            == 0.0, "zero_pivot_safe: factor not finite or min |pivot| != 0")
    out["flat"] = {"n": FLAT_N, "residual": res, "abft_err_max": abft_max,
                   "abft_tol": tol}
    print(f"phase 6: flat form n={FLAT_N}: unroll=False residual {res:.3e}; "
          f"abft=True == pallas bit for bit, abft_err max {abft_max:.3e} < "
          f"{tol:.3e} ({fa.abft_err.numel()} entries); zero_pivot_safe on a "
          f"singular matrix: finite, min |pivot| 0 [{card}]")
    # The handoff's single-card lane.
    stream = os.path.join(work, "handoff.jsonl")
    with obs.run(metrics_out=stream, tool="chip_smoke"):
        xh = blocked.solve_handoff(af, bf, device=DEVICE)
    (route,) = [ev for ev in obs.read_events(stream)
                if ev["type"] == "route"]
    budget = blocked.device_memory_budget(DEVICE)
    require({k: route[k] for k in ("tool", "n", "lane", "est_bytes",
                                   "budget", "itemsize")}
            == {"tool": "solve_handoff", "n": FLAT_N, "lane": "single_chip",
                "est_bytes": 3 * FLAT_N ** 2 * 4, "budget": budget,
                "itemsize": 4} and checks.residual_norm(af, xh, bf) < GATE,
            f"handoff route event {route}")
    n_max = int((budget // 12) ** 0.5)
    require(blocked.fits_single_chip(n_max, device=DEVICE)
            and not blocked.fits_single_chip(n_max + 1, device=DEVICE),
            f"fits_single_chip at n={n_max}")
    out["handoff"] = {"budget": budget, "largest_n": n_max}
    print(f"phase 6: solve_handoff n={FLAT_N}: route {route['lane']}, "
          f"est {route['est_bytes']} of budget {budget} B; fits_single_chip "
          f"admits n up to {n_max} at float32 [{card}]")
    launches = dict(_build.LAUNCHES)
    unrolled = factor_plan(FLAT_N, blocked.auto_panel(FLAT_N))
    # abft=True and its panel_impl="pallas" reference: the panel kernel
    # on every panel (the unfused pair), twice.
    fpanel = blocked.auto_panel(FLAT_N)
    abft_plan = [(panel_launch_key(FLAT_N - kb, fpanel), None, FLAT_N - kb)
                 for kb in range(0, FLAT_N, fpanel)]
    want = (plan_counts(factor_plan(n8, p8, c8), factor_plan(n8, p8, c8),
                        factor_plan(n12, p12, c12), unrolled, unrolled,
                        abft_plan, abft_plan) if on_card else plan_counts())
    print(f"phase 6: counted path launches {launches} [{card}]")
    require(launches == want, f"large-n path: launches {launches}, the "
            f"plans say {want}")
    print(json.dumps({"large_n": out}))
    return launches, out


# --- Phase 7: the lowered-precision solve ------------------------------


def bf16_reach(panel: int) -> int:
    """The tallest strip a bfloat16 cluster holds at ``panel`` (the rule of
    ``panel_geometry`` at 2 bytes a word)."""
    from gauss_tpu_torch.kernels import panel as kp

    lo, hi = 1, 1 << 17
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if kp.panel_geometry(mid, panel, 2).route == "cluster":
            lo = mid
        else:
            hi = mid - 1
    return lo


def dominant_system(n: int, seed: int = SEED):
    """The random dominant system ``a + n I`` and its right-hand side."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a, rng.standard_normal(n)


def ill_system(n: int, cond_exp: int = 6, seed: int = SEED):
    """tests/test_lowered.py's symmetric system of condition ~10^cond_exp
    (orthogonal Q from a QR of a random matrix, log-spaced spectrum)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.logspace(0, cond_exp, n)
    return (q * d) @ q.T, rng.standard_normal(n)


def lowered_panel_shape(reps: int, rng, h: int, reach: int) -> dict:
    """Kernel 1's bfloat16 form at (h, PANEL) against its plain version
    (bit for bit), with the C launcher's geometry beside the Python rule,
    timed beside the float32 kernel on the same strip and
    ``torch.linalg.lu_factor`` on the float32 strip."""
    import torch

    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    on_card = DEVICE == "cuda"
    x32 = torch.as_tensor(rng.standard_normal((h, PANEL)),
                          dtype=torch.float32, device=torch.device(DEVICE))
    x = x32.to(torch.bfloat16)
    geom = kp.panel_geometry(h, PANEL, 2)
    key = panel_launch_key(h, PANEL, 2)
    before = _build.LAUNCHES[key]
    got = kp.panel_factor(x, 0)
    ref = kp.panel_factor_plain(x, 0)
    sync()
    require(_build.LAUNCHES[key] == before + on_card,
            f"bf16 panel_factor at ({h}, {PANEL}) did not launch {key}")
    require(same_outputs(got, ref), f"{key} at ({h}, {PANEL}) differs from "
            f"the plain version")
    rule = (f"rule {geom.route}, {geom.blocks} blocks, "
            f"{geom.rows_per_block} rows")
    if on_card:
        for hh in sorted({h, reach}):
            info = kp.panel_cluster_info(hh, PANEL, itemsize=2)
            ginfo = kp.panel_grid_info(hh, PANEL, itemsize=2)
            g = kp.panel_geometry(hh, PANEL, 2)
            want = ((g.cluster, g.rows_per_block, g.smem_bytes)
                    if g.route == "cluster" else (0, 0, 0))
            gwant = ((g.blocks, g.rows_per_block, g.smem_bytes)
                     if g.route == "grid" else (0, 0, 0))
            require((info["cluster"], info["rows_per_block"],
                     info["smem_bytes"]) == want and
                    (ginfo["grid"], ginfo["rows_per_block"],
                     ginfo["smem_bytes"]) == gwant,
                    f"bf16 cluster / grid info at ({hh}, {PANEL}): {info}, "
                    f"{ginfo} != {g}")
            rule += (f"; panel_cluster_info({hh}, {PANEL}, itemsize=2) "
                     f"{info}, panel_grid_info {ginfo} beside panel_geometry "
                     f"{tuple(g)}")
    rec = {"key": key, "route": geom.route, "err": float(
        (got[0].float() - ref[0].float()).abs().max())}
    plain_reps = max(3, reps // 4)
    if on_card:
        rec["ms"] = cuda_event_ms(lambda: kp.panel_factor(x, 0), reps)
        rec["f32_ms"] = cuda_event_ms(lambda: kp.panel_factor(x32, 0), reps)
        rec["plain_ms"] = cuda_event_ms(lambda: kp.panel_factor_plain(x, 0),
                                        plain_reps)
        with quiet_fd1():
            rec["library_ms"] = cuda_event_ms(
                lambda: torch.linalg.lu_factor(x32), reps)
    b_ms, b_by = bound_bf16(2.0 * h * PANEL * 2 + 4 * PANEL + 8 * h + 2,
                            panel_ops(h, PANEL, 0), 0.0)
    rec.update(bound_ms=b_ms, bound_by=b_by)
    print(f"phase 7: {key} ({h}, {PANEL}) bfloat16, {rule}: bit for bit"
          + (f"; ms {rec['ms']:.4f} (float32 kernel on the same strip "
             f"{rec['f32_ms']:.4f}), plain {rec['plain_ms']:.4f}, lu_factor "
             f"(float32 strip) {rec['library_ms']:.4f}" if on_card else "")
          + f", bound {b_ms:.5f} ({b_by})")
    return rec


def lowered_fused_shape(reps: int, rng, h: int, wtot: int) -> dict:
    """Kernels 2 and 3 at bfloat16 on an (h, wtot) block, panel at column
    0: the fused kernel's panel and pivots bit for bit and its block
    within bf16_block_check's limits of the plain version, bit for bit
    equal to the unfused pair; the trailing kernel within the same of its
    plain version; the C
    launcher's geometry against ``fused_geometry``; each timed beside the
    float32 kernel on the same block."""
    import torch

    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.kernels import panel_fused as kf
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    on_card = DEVICE == "cuda"
    dev = torch.device(DEVICE)
    geom = kf.fused_geometry(h, wtot, PANEL, 0, itemsize=2)
    where = f"{geom.route} route, grid {geom.grid}"
    if on_card:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        info = kf.fused_launch_info(h, wtot, PANEL, 0, itemsize=2)
        want = kf.fused_geometry(h, wtot, PANEL, 0, sms=sms,
                                 clusters=info["fit"], itemsize=2)._asdict()
        require({k: info[k] for k in want} == want and info["fit"] >= 1,
                f"bf16 fused launch at ({h}, {wtot}): C launcher's geometry "
                f"{info} != {want}")
        where = f"{info['route']} route, grid {info['grid']}, {info['fit']} " \
                f"{'clusters' if info['route'] == 'cluster' else 'blocks an SM'}" \
                f" at once"
    orig32 = torch.as_tensor(rng.standard_normal((h, wtot)),
                             dtype=torch.float32, device=dev)
    orig = orig32.to(torch.bfloat16)
    work = orig.clone()
    key = "panel_trailing_fused_bf16"
    before = _build.LAUNCHES[key]
    p, ipiv, perm, mp, upd = kf.panel_trailing_fused(work, 0, 0, panel=PANEL)
    rp, ripiv, rperm, rmp, rupd = kf.panel_trailing_fused_plain(
        orig.clone(), 0, 0, panel=PANEL)
    sync()
    require(_build.LAUNCHES[key] == before + on_card, f"one {key} launch")
    require(same_outputs((p, ipiv, perm, mp), (rp, ripiv, rperm, rmp)),
            f"bf16 fused at ({h}, {wtot}): panel or pivots differ from the "
            f"plain version")
    err, rel, share = bf16_block_check(f"bf16 fused at ({h}, {wtot})", upd,
                                       rupd, PANEL)
    pair = orig.clone()
    p2, ipiv2, perm2, _ = kp.panel_factor(pair[:, :PANEL], 0)
    mult, onehot = kf.reconstruct_mult_pt(p2, ipiv2, perm2, 0, PANEL)
    kf.trailing_update(pair, mult, onehot, 0)
    plain_pair = orig.clone()
    kf.trailing_update_plain(plain_pair, mult, ipiv2, 0, kf.FUSED_FSEG_SEED)
    sync()
    require(torch.equal(pair, upd), f"bf16 fused != pair at ({h}, {wtot})")
    err3, rel3, share3 = bf16_block_check(
        f"bf16 trailing at ({h}, {wtot})", pair, plain_pair, PANEL)
    ncols = wtot - PANEL
    f3 = trailing_ops(h, 0, PANEL, ncols)
    b2 = bound_bf16(4.0 * h * wtot + 2 * PANEL + 8 * h + 2,
                    panel_ops(h, PANEL, 0), f3)
    b3 = bound_bf16(2.0 * h * ncols * 2 + 2.0 * PANEL * h + 4 * PANEL, 0.0,
                    f3)
    rec = {"route": geom.route, "err": err, "err3": err3, "err_rel": rel,
           "err3_rel": rel3, "share": share, "share3": share3,
           "bound_ms": b2[0], "bound_by": b2[1], "bound3_ms": b3[0],
           "bound3_by": b3[1]}
    if on_card:
        w32 = orig32.clone()

        def reset():
            work.copy_(orig)

        def reset32():
            w32.copy_(orig32)

        plain_reps = max(3, reps // 4)
        rec["ms"] = cuda_event_ms(lambda: kf.panel_trailing_fused(
            work, 0, 0, panel=PANEL), reps, setup=reset)
        rec["f32_ms"] = cuda_event_ms(lambda: kf.panel_trailing_fused(
            w32, 0, 0, panel=PANEL), reps, setup=reset32)
        rec["plain_ms"] = cuda_event_ms(lambda: kf.panel_trailing_fused_plain(
            work, 0, 0, panel=PANEL), plain_reps, setup=reset)
        rec["ms3"] = cuda_event_ms(lambda: kf.trailing_update(
            work, mult, ipiv2, 0), reps, setup=reset)
        m32 = mult.float()
        rec["f32_ms3"] = cuda_event_ms(lambda: kf.trailing_update(
            w32, m32, ipiv2, 0), reps, setup=reset32)
        rec["plain_ms3"] = cuda_event_ms(lambda: kf.trailing_update_plain(
            work, mult, ipiv2, 0, kf.FUSED_FSEG_SEED), plain_reps,
            setup=reset)
    print(f"phase 7: panel_trailing_fused_bf16 ({h}, {wtot}), {where}: "
          f"panel bit for bit, block max |kernel - plain| {rel:.3e} of its "
          f"scale ({share:.5f} of the trailing elements differ), == pair bit "
          f"for bit; trailing_update_bf16 {rel3:.3e} ({share3:.5f})"
          + (f"; ms {rec['ms']:.4f} (float32 {rec['f32_ms']:.4f}), plain "
             f"{rec['plain_ms']:.4f}; trailing ms {rec['ms3']:.4f} (float32 "
             f"{rec['f32_ms3']:.4f}), plain {rec['plain_ms3']:.4f}"
             if on_card else "")
          + f"; bound {b2[0]:.5f} ({b2[1]}), trailing {b3[0]:.5f} "
          f"({b3[1]})")
    return rec


def one_block_figures(reps: int, rng) -> dict:
    """Kernels 1 and 2 at the n=8192 chunked form's tallest phase-A
    launches, at both dtypes, on both routes: kernel 1 on the (7424, 256)
    strip (the first group's last panel) by the rule (the grid route) and
    on the one-block kernel (``panel_factor_one_block``), both bit for bit
    the plain version, beside ``lu_factor`` on the float32 strip; kernel 2
    on the (8192, 1024) group block (the first group's first panel) by the
    rule (the grid route), its panel and pivots bit for bit the plain
    version's, its block bit for bit the unfused pair's and within TOL
    (float32) or bf16_block_check's limits (bfloat16) of the plain one,
    beside kernel 2's one-block route on the same block
    (``panel_trailing_fused_one_block``, the route kernel 2 took before the
    grid route), bit for bit the same; each with its bound (bytes at the
    dtype's itemsize)."""
    import torch

    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.kernels import panel_fused as kf
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    dev = torch.device(DEVICE)
    hp, (hf, wf) = 7424, (8192, 4 * PANEL)
    strip = torch.as_tensor(rng.standard_normal((hp, PANEL)),
                            dtype=torch.float32, device=dev)
    block = torch.as_tensor(rng.standard_normal((hf, wf)),
                            dtype=torch.float32, device=dev)
    out = {}
    for name, dt in (("float32", torch.float32), ("bfloat16",
                                                  torch.bfloat16)):
        x, blk = strip.to(dt), block.to(dt)
        work = blk.clone()
        isz = x.element_size()
        where = f"{name} at ({hp}, {PANEL}) and ({hf}, {wf})"
        ref = kp.panel_factor_plain(x, 0)
        got, one = kp.panel_factor(x, 0), kp.panel_factor_one_block(x, 0)
        sync()
        require(same_outputs(got, ref) and same_outputs(one, ref),
                f"kernel 1 {where}: a route differs from the plain version")
        fused = kf.panel_trailing_fused(work, 0, 0, panel=PANEL)
        old = blk.clone()
        fold = kf.panel_trailing_fused_one_block(old, 0, 0, panel=PANEL)
        plain = kf.panel_trailing_fused_plain(blk.clone(), 0, 0, panel=PANEL)
        pair = blk.clone()
        p2, i2, q2, _ = kp.panel_factor(pair[:, :PANEL], 0)
        mult, onehot = kf.reconstruct_mult_pt(p2, i2, q2, 0, PANEL)
        kf.trailing_update(pair, mult, onehot, 0)
        sync()
        require(same_outputs(fused[:4], plain[:4])
                and torch.equal(pair, work) and torch.equal(old, work)
                and same_outputs(fused[:4], fold[:4]),
                f"kernel 2 {where}: panel or pivots differ from the plain "
                f"version, or the block from the pair's or the one-block "
                f"route's")
        if dt == torch.bfloat16:
            bf16_block_check(f"kernel 2 {where}", work, plain[4], PANEL)
        else:
            scale = float(plain[4].abs().max())
            require(float((work - plain[4]).abs().max()) <= TOL * scale,
                    f"kernel 2 {where}: max |kernel - plain| over TOL")
        f2 = trailing_ops(hf, 0, PANEL, wf - PANEL)
        rec = {"panel_route": kp.panel_geometry(hp, PANEL, isz).route,
               "fused_route": kf.fused_geometry(hf, wf, PANEL, 0,
                                                itemsize=isz).route,
               "panel_ms": cuda_event_ms(lambda: kp.panel_factor(x, 0),
                                         reps),
               "panel_one_block_ms": cuda_event_ms(
                   lambda: kp.panel_factor_one_block(x, 0), reps),
               "fused_ms": cuda_event_ms(
                   lambda: kf.panel_trailing_fused(work, 0, 0, panel=PANEL),
                   reps, setup=lambda: work.copy_(blk)),
               "fused_one_block_ms": cuda_event_ms(
                   lambda: kf.panel_trailing_fused_one_block(
                       old, 0, 0, panel=PANEL), reps,
                   setup=lambda: old.copy_(blk)),
               "panel_plain_ms": cuda_event_ms(
                   lambda: kp.panel_factor_plain(x, 0), 1, warmup=1),
               "panel_err": float((got[0].float() - ref[0].float())
                                  .abs().max()),
               "panel_one_block_err": float((one[0].float() - ref[0].float())
                                            .abs().max())}
        pb = (bound_bf16(2.0 * hp * PANEL * isz + 4 * PANEL + 8 * hp + isz,
                         panel_ops(hp, PANEL, 0), 0.0) if isz == 2 else
              panel_bound(hp, PANEL))
        fb = (bound_bf16(2.0 * hf * wf * isz, panel_ops(hf, PANEL, 0), f2)
              if isz == 2 else bound(8.0 * hf * wf,
                                     f2 + panel_ops(hf, PANEL, 0)))
        rec.update(panel_bound_ms=pb[0], panel_bound_by=pb[1],
                   fused_bound_ms=fb[0], fused_bound_by=fb[1])
        out[name] = rec
    with quiet_fd1():
        out["lu_factor_strip_ms"] = cuda_event_ms(
            lambda: torch.linalg.lu_factor(strip), reps)
    print(f"phase 7: the n=8192 form's tallest phase-A launches, kernel 1 "
          f"at ({hp}, {PANEL}) and kernel 2 at ({hf}, {wf}), by the rule "
          f"and on the one-block route, bit for bit: "
          + "; ".join(f"{k} {v}" for k, v in out.items()) + f" [{smi_line()}]")
    return out


def phase_lowered(reps: int):
    """The lowered-precision solve (module docstring, phase 7): returns the
    launch counts of its counted solves and the phase's figures."""
    import torch

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.core import lowered
    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.tune import apply as tapply
    from gauss_tpu_torch.tune import store as tstore
    from gauss_tpu_torch.utils.timing import cuda_event_ms
    from gauss_tpu_torch.verify import checks

    on_card = DEVICE == "cuda"
    dev = torch.device(DEVICE)
    card = smi_line() if on_card else "cpu"
    work = os.path.join(REPO, "build", "chip_smoke", "lowered")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(SEED + 7)
    out = {"card": card}
    path = dict.fromkeys(_build.LAUNCHES, 0)

    last = {}

    def counted(fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after into ``last``, and added to the phase's path counts,
        also when ``fn`` raises (a rung that fails typed)."""
        _build.reset_launches()
        try:
            return fn()
        finally:
            sync()
            last.clear()
            last.update(_build.LAUNCHES)
            for k, v in last.items():
                path[k] += v

    def rung_plan(dt: str) -> dict:
        """The launches of one solve_lowered call at N on rung ``dt``: one
        factorization's plan at the rung's storage."""
        if not on_card:
            return plan_counts()
        itemsize = 2 if dt == "bfloat16" else 4
        return plan_counts(factor_plan(N, blocked.auto_panel(N, itemsize),
                                       None, itemsize))

    # (a) The kernels at bfloat16 against their plain versions.
    reach = bf16_reach(PANEL)
    out["bf16_reach"] = reach
    out["panel"] = {h: lowered_panel_shape(reps, rng, h, reach)
                    for h in (N, reach + 1)}
    if on_card:
        out["one_block"] = one_block_figures(max(3, reps // 4), rng)
    tall = f"({reach + 1}, {4 * PANEL})"
    out["fused"] = {f"({N}, {N})": lowered_fused_shape(reps, rng, N, N),
                    tall: lowered_fused_shape(max(3, reps // 4), rng,
                                              reach + 1, 4 * PANEL)}
    require(not on_card or (out["panel"][N]["route"] == "cluster"
                            and out["panel"][reach + 1]["route"] == "grid"
                            and out["fused"][tall]["route"] == "grid"),
            "bf16 routes: expected the cluster at N and the grid past the "
            "reach")

    # (b) solve_lowered at N, each rung, on the dominant system.
    a, b = dominant_system(N)
    rungs = {}
    for dt in lowered.LOWERED_DTYPES:
        storage, gp = lowered._storage_and_precision(dt)
        t0 = time.perf_counter()
        x, fac, info = counted(
            lambda dt=dt: lowered.solve_lowered(a, b, dtype=dt,
                                                device=DEVICE))
        secs = time.perf_counter() - t0
        launches, want = dict(last), rung_plan(dt)
        require(launches == want, f"solve_lowered {dt}: launches {launches},"
                f" the plan says {want}")
        require(info["rel_residual"] <= GATE and fac.m.dtype == storage,
                f"solve_lowered {dt} at n={N}: {info}")
        rec = dict(info, seconds=secs, launches={
            k: v for k, v in launches.items() if v})
        if on_card:
            a_dev = torch.as_tensor(a, dtype=storage, device=dev)
            factor = blocked.resolve_factor(N, "auto", device=DEVICE)

            def call():
                return factor(a_dev, gemm_precision=gp, device=DEVICE)

            rec["factor_ms"] = cuda_event_ms(call, 5)
            got, busy, host_ms = trace_launches(
                call, os.path.join(work, f"factor_{dt}_{N}.json"))
            rec.update(kernel_device_ms=sum(ms for _, _, ms in got),
                       busy_ms=busy, traced_host_ms=host_ms,
                       idle_share=1.0 - busy / host_ms)
        rungs[dt] = rec
        print(f"phase 7: solve_lowered n={N} {dt}: "
              + (f"factor {rec['factor_ms']:.4f} ms (CUDA events, median of "
                 f"5; traced: kernels {rec['kernel_device_ms']:.3f} ms, busy "
                 f"{rec['busy_ms']:.3f} of {rec['traced_host_ms']:.3f} ms, "
                 f"idle share {rec['idle_share']:.3f}), " if on_card else "")
              + f"refine steps {info['refine_steps']}, rel_residual "
              f"{info['rel_residual']:.3e}, call {secs:.4f} s, launches "
              f"{rec['launches']} [{card}]")
    out["rungs"] = rungs

    # (c) The ladder on the internal system and the cond ~1e6 system.
    systems = {"internal": (synthetic.internal_matrix(N),
                            synthetic.internal_rhs(N)),
               "cond1e6": ill_system(N)}
    walks = {}
    for name, (sa, sb) in systems.items():
        walk = {}
        for dt in lowered.LOWERED_DTYPES:
            try:
                _, _, info = counted(lambda dt=dt: lowered.solve_lowered(
                    sa, sb, dtype=dt, device=DEVICE))
                walk[dt] = {"converged": True, **info}
            except lowered.PrecisionNotConvergedError as e:
                walk[dt] = {"converged": False, "refine_steps":
                            e.refine_steps, "rel_residual": e.rel_residual}
            require(last == rung_plan(dt), f"{name} system, {dt}: launches "
                    f"{last}, the plan says {rung_plan(dt)}")
        walks[name] = walk
        print(f"phase 7: n={N} {name} system, each rung alone: "
              + "; ".join(f"{dt} {'converged' if r['converged'] else 'failed typed'}"
                          f" ({r['refine_steps']} steps, rel_residual "
                          f"{r['rel_residual']:.3e})" for dt, r in walk.items())
              + f" [{card}]")
    store_path = os.path.join(work, "tune_store.json")
    st = tstore.TuneStore(fingerprint=tstore.store_fingerprint())
    st.put("lowered", N, {"dtype": "bfloat16", "refine_steps": 6})
    st.save(store_path)
    saved_env = os.environ.get(tstore.ENV_STORE)
    os.environ[tstore.ENV_STORE] = store_path
    tapply.reset_cache()
    tuned = {}
    try:
        require(tapply.store_status()["usable"] and lowered.lowered_params(
            N) == ("bfloat16", 6), f"tune store {tapply.store_status()}")
        for name, (sa, sb) in systems.items():
            stream = os.path.join(work, f"auto_{name}.jsonl")
            with obs.run(metrics_out=stream, tool="chip_smoke"):
                try:
                    x, _, info = counted(
                        lambda sa=sa, sb=sb: lowered.solve_lowered_auto(
                            sa, sb, device=DEVICE))
                    served = info["dtype"]
                except lowered.PrecisionNotConvergedError as e:
                    x, served, info = None, None, {"error": str(e)}
            counters = {ev["name"]: ev["value"] for ev in obs.read_events(
                stream) if ev["type"] == "metric" and ev["kind"] == "counter"}
            rel = (checks.residual_norm(sa, x, sb, relative=True)
                   if x is not None else None)
            require(rel is not None and rel <= GATE, f"auto walk on {name}: "
                    f"{info}, rel_residual {rel}")
            # The walk from bfloat16 down to the served rung: one
            # factorization per rung, the failed rungs' included.
            walked = lowered.LOWERED_DTYPES[
                :lowered.LOWERED_DTYPES.index(served) + 1]
            want = {k: sum(rung_plan(dt)[k] for dt in walked) for k in last}
            require(last == want, f"auto walk on {name}: launches {last}, "
                    f"the plans of {walked} say {want}")
            if name == "internal":
                require(checks.internal_pattern_ok(x, atol=GATE),
                        "auto walk on the internal system: pattern")
            tuned[name] = {"served": served, "demoted": info["demoted"],
                           "demotions": counters.get("precision.demotions",
                                                     0),
                           "rel_residual": rel}
            print(f"phase 7: solve_lowered_auto n={N} {name}, tune store "
                  f"start (bfloat16, 6): served {served}, demotions "
                  f"{tuned[name]['demotions']}, verified rel_residual "
                  f"{rel:.3e} [{card}]")
    finally:
        if saved_env is None:
            os.environ.pop(tstore.ENV_STORE, None)
        else:
            os.environ[tstore.ENV_STORE] = saved_env
        tapply.reset_cache()
    require(tuned["cond1e6"]["demotions"] >= 1, f"the cond ~1e6 system did "
            f"not demote: {tuned['cond1e6']}")
    out["walks"], out["tuned"] = walks, tuned

    # (d) The chunked form at bfloat16: the float64 check at n=1024, then
    # n=8192 at full size.
    n, panel, chunk = LOWERED_CHECK
    a16 = torch.as_tensor(np.random.default_rng(SEED).standard_normal(
        (n, n)), dtype=torch.bfloat16, device=dev)
    seen, errs = {}, {}
    with checked_launches(seen, errs):
        blocked.lu_factor_blocked_chunked(a16, panel=panel, chunk=chunk,
                                          device=DEVICE)
        sync()
    # The factor against the float64 factor on its pivots, field by field
    # over the field's own scale, on the dominant system: a bfloat16 LU of
    # a random matrix of this order is O(1) off in every field (n * 2^-8
    # times its growth), on the card and the CPU alike, so there the
    # comparison could not tell a fault from rounding.
    ad, _ = dominant_system(n)
    ad16 = torch.as_tensor(ad, dtype=torch.bfloat16)
    fg = blocked.lu_factor_blocked_chunked(ad16.to(dev), panel=panel,
                                           chunk=chunk, device=DEVICE)
    fc = blocked.lu_factor_blocked_chunked(ad16, panel=panel, chunk=chunk,
                                           device="cpu")
    f64 = lu_f64(ad16.float().numpy(), fc.perm, panel)
    e = {"card_vs_f64": field_errs(fg, f64), "cpu_vs_f64": field_errs(
        fc, f64)}
    require(all(e["card_vs_f64"][f] <= min(F64_CAP_BF16, F64_RATIO
                                           * e["cpu_vs_f64"][f])
                for f in ("m", "linv", "uinv")),
            f"bf16 chunked n={n}: {e}")
    out["check"] = {"n": n, "panel": panel, "chunk": chunk, "launches": seen,
                    "whole_factor": e}
    print(f"phase 7: bf16 chunked n={n}, panel {panel}, chunk {chunk}: "
          f"checked launches (random matrix) {seen}; the factor of the "
          f"dominant system against the float64 one on its pivots, field by "
          f"field over the field's max: {e} [{card}]")

    n, panel, chunk = LOWERED_LARGE
    a_big, b_big = dominant_system(n, SEED + n)
    a16 = torch.as_tensor(a_big, dtype=torch.bfloat16, device=dev)
    a32 = torch.as_tensor(a_big, dtype=torch.float32, device=dev)
    f = blocked.resolve_factor(n, "auto", device="cuda")
    require(getattr(f, "func", f) is blocked.lu_factor_blocked_chunked
            and getattr(f, "keywords", {}).get("chunk", blocked.CHUNK_DEFAULT)
            == chunk and blocked.auto_panel(n, 2) == panel,
            f"resolve_factor({n}) at bf16: {f}")
    plan = factor_plan(n, panel, chunk, 2)
    plan32 = factor_plan(n, panel, chunk, 4)
    rc16, rc32 = route_counts(plan), route_counts(plan32)
    require(all(r != "block" for _, r, _ in plan + plan32), f"bf16 n={n}: "
            f"a strip on the one-block route: {rc16}, float32 {rc32}")
    one16 = sum(v for k, v in rc16.items() if k.endswith("/grid"))
    one32 = sum(v for k, v in rc32.items() if k.endswith("/grid"))
    seen = {}
    with checked_launches(seen, errs):
        blocked.lu_factor_blocked_chunked(a16, panel=panel, chunk=chunk,
                                          device=DEVICE)
        sync()
    fused = [r for k, r, _ in plan if k.startswith("panel_trailing_fused")]
    panels = [r for k, r, _ in plan if not k.startswith("panel_trailing")]
    groups = -(-(-(-n // panel)) // chunk)
    want = {"fused": len(fused),
            "fused strided": len(fused) if groups > 1 else 0,
            "fused grid": fused.count("grid"),
            "fused one-block": fused.count("block"), "panel": len(panels),
            "panel strided": len(panels), "panel grid": panels.count("grid"),
            "panel one-block": panels.count("block")}
    require(seen == {k: v for k, v in want.items() if v},
            f"bf16 n={n}: checked launches {seen}, the plan gives {want}")
    big = {"n": n, "panel": panel, "chunk": chunk, "launches": rc16,
           "f32_launches": rc32, "grid_route": one16, "f32_grid_route": one32,
           "checked_launches": seen, "bound_ms": bound(
               4.0 * n * n, 2.0 * n ** 3 / 3, PEAK_BF16_FLOP_S)[0]}
    if on_card:
        big["factor_ms"] = cuda_event_ms(
            lambda: blocked.lu_factor_blocked_chunked(
                a16, panel=panel, chunk=chunk, device=DEVICE), 3, warmup=1)
        big["f32_factor_ms"] = cuda_event_ms(
            lambda: blocked.lu_factor_blocked_chunked(
                a32, panel=panel, chunk=chunk, device=DEVICE), 3, warmup=1)
        with quiet_fd1():
            big["lu_factor_ms"] = cuda_event_ms(
                lambda: torch.linalg.lu_factor(a32), 3, warmup=1)
        tpath = os.path.join(work, f"factor_bf16_{n}.json")
        got, busy, host_ms, traces = trace_plan(
            lambda: blocked.lu_factor_blocked_chunked(
                a16, panel=panel, chunk=chunk, device=DEVICE), tpath, plan,
            fresh=f"c.chunked_factor_trace({n}, {panel}, {chunk}, 2, "
                  f"{tpath!r})")
        require([(k, r) for k, r, _ in got] == [(k, r) for k, r, _ in plan],
                f"bf16 n={n}: {plan_mismatch(got, plan)}")
        dev_ms = {}
        for key, route, ms in got:
            dev_ms[f"{key}/{route}"] = dev_ms.get(f"{key}/{route}", 0.0) + ms
        big.update(device_ms=dev_ms, busy_ms=busy, traced_host_ms=host_ms,
                   idle_share=1.0 - busy / host_ms, traces=traces)
    del a32
    t0 = time.perf_counter()
    x, fac, info = counted(lambda: lowered.solve_lowered(
        a_big, b_big, dtype="bfloat16", device=DEVICE))
    big["solve_seconds"] = time.perf_counter() - t0
    launches = dict(last)
    want = plan_counts(plan) if on_card else plan_counts()
    require(launches == want and info["rel_residual"] <= GATE,
            f"solve_lowered bf16 n={n}: {info}, launches {launches}")
    big["solve"] = info
    out["large"] = big
    print(f"phase 7: bf16 n={n}, panel {panel}, chunk {chunk}: launches "
          f"{rc16} ({one16} on the grid route; float32: {one32}); every "
          f"launch of "
          f"one factorization against its plain version: {seen}"
          + (f"; factor {big['factor_ms']:.3f} ms (median of 3), float32 "
             f"{big['f32_factor_ms']:.3f}, lu_factor (float32) "
             f"{big['lu_factor_ms']:.3f}, bound {big['bound_ms']:.3f}; traced "
             f"kernels { {k: round(v, 3) for k, v in dev_ms.items()} } ms, "
             f"busy {busy:.3f} of {host_ms:.3f} ms (idle share "
             f"{big['idle_share']:.4f})" if on_card else "")
          + f"; solve_lowered bfloat16 refine steps {info['refine_steps']}, "
          f"rel_residual {info['rel_residual']:.3e}, "
          f"{big['solve_seconds']:.3f} s [{card}]")
    out["fused_errs"] = errs
    print(f"phase 7: counted solves' launches {path} [{card}]")
    print(json.dumps({"lowered": out}, default=lambda o: str(o)))
    return path, out


def call_ms(fn, reps: int):
    """Median ms of ``fn()`` by CUDA events on the card; None on the CPU."""
    if DEVICE != "cuda":
        return None
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    return cuda_event_ms(fn, reps=reps, warmup=1)


def batched_bound(shape, itemsize: int = 4) -> tuple:
    """The batched panel factor's bound: each member read and written once
    (plus its pivots), or the step loop's operations on every member (at
    the float32 CUDA-core rate at either storage: each rounds on its
    own)."""
    bsz, h, panel = shape
    nbytes = bsz * (2.0 * itemsize * h * panel + 4 * (panel + 2 * h)
                    + itemsize)
    return bound(nbytes, bsz * panel_ops(h, panel, 0))


def spd_dense(n: int, rng) -> np.ndarray:
    """A dense symmetric matrix, strictly diagonally dominant with a
    positive diagonal (so SPD, and detected ``spd``): a seeded symmetric
    uniform [-1, 1) matrix plus n I."""
    m = rng.uniform(-1.0, 1.0, (n, n))
    a = m + m.T
    a *= 0.5
    a[np.diag_indices(n)] += n
    return a


def phase_structure(reps: int):
    """The structure router on the card (module docstring, phase 8):
    returns the launch counts of its counted solves and its figures."""
    import torch

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.core import blocked, lowered
    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.resilience import inject
    from gauss_tpu_torch.structure import blockdiag, cholesky, solve_auto
    from gauss_tpu_torch.structure.detect import (STRUCTURE_KINDS,
                                                  detect_structure)
    from gauss_tpu_torch.utils.device import as_tensor, resolve_device
    from gauss_tpu_torch.verify import checks

    on_card = DEVICE == "cuda"
    dev = resolve_device(DEVICE)
    card = smi_line() if on_card else "cpu"
    work = os.path.join(REPO, "build", "chip_smoke", "structure")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(SEED + 8)
    path = dict.fromkeys(_build.LAUNCHES, 0)
    out = {"card": card, "batched": {}, "batched_err": 0.0, "classes": {},
           "demotions": {}, "batched_routes": {}}
    require(not lowered.lowered_enabled(N), "a tune store starts the dense "
            "lane below float32; phase 8 expects the float32 route")
    plan = plan_counts(factor_plan(N, PANEL)) if on_card else dict.fromkeys(
        _build.LAUNCHES, 0)
    none = dict.fromkeys(_build.LAUNCHES, 0)

    # (a) The batched kernel alone against its plain version.
    for shape in STRUCT_BATCH_CHECK:
        p = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev)
        got = kp.panel_factor_batched(p.clone())
        require(same_outputs(got, kp.panel_factor_batched_plain(p.clone())),
                f"batched panel kernel at {shape} differs from the plain "
                f"version")
        one = kp.panel_factor_batched(p[:1].clone())
        single = kp.panel_factor(p[0].clone())
        require(all(torch.equal(g[0], w) for g, w in zip(one, single)),
                f"one-member batched launch at {shape[1:]} differs from the "
                f"single-strip kernel")
        route = (kp.panel_batched_info(*shape[1:])["route"] if on_card
                 else "plain")
        print(f"phase 8: batched panel kernel at {shape} "
              f"({route} route) == plain bit for bit; "
              f"one member == the single-strip kernel [{card}]")

    stacks = {}
    real_batched = kp.panel_factor_batched

    def checked_batched(p, kb=0):
        x = p.clone()
        got = real_batched(p, kb)
        want = kp.panel_factor_batched_plain(x, kb)
        require(same_outputs(got, want),
                f"batched panel kernel on the main path at "
                f"{tuple(p.shape)} differs from the plain version")
        out["batched_err"] = max(out["batched_err"], float(
            (got[0] - want[0]).abs().max()))
        stacks[tuple(p.shape)] = x
        return got

    def routed(label, a, b, engine, expect, structure=None):
        """One counted solve_auto, served at rung 0 by ``engine`` with the
        launches ``expect`` (a callable of the blockdiag cache's misses in
        the call, whose new entry's warm-up factors once)."""
        cache = blockdiag._exe_cache(dev)
        misses = cache.misses
        _build.reset_launches()
        t0 = time.perf_counter()
        res = solve_auto(a, b, structure=structure, device=DEVICE)
        sync()
        secs = time.perf_counter() - t0
        got = dict(_build.LAUNCHES)
        want = expect(cache.misses - misses) if callable(expect) else expect
        for k in path:
            path[k] += got[k]
        for k, v in _build.ROUTE_LAUNCHES.items():
            if k.startswith("panel_factor_batched"):
                routes = out["batched_routes"]
                routes[k] = routes.get(k, 0) + v
        rel = checks.residual_norm(a, res.x, b, relative=True)
        require(res.rung == engine and res.rung_index == 0,
                f"{label}: served by {res.rung} at rung {res.rung_index} "
                f"({res.escalations}), expected {engine} at rung 0")
        require(np.isfinite(rel) and rel <= GATE,
                f"{label}: float64 relative residual {rel}")
        require(got == want, f"{label}: launches "
                f"{ {k: v for k, v in got.items() if v} }, expected "
                f"{ {k: v for k, v in want.items() if v} }")
        return {"n": a.shape[0], "engine": res.rung,
                "rung_index": res.rung_index, "s_per_solve": secs,
                "rel_residual": rel,
                "launches": {k: v for k, v in got.items() if v}}

    def b_for(n):
        return rng.standard_normal(n)

    # (b) One routed solve per class.
    spd_cells = []
    for n in STRUCT_SPD:
        # The generator's entries 0.25^|i-j| are exactly 0 past |i-j| =
        # 537 in float64, so above n = 8 x 537 the detector (the JAX
        # package's too) calls it banded: the caller names the class. The
        # dense diagonally dominant operand is detected spd at every size,
        # so its cell runs detect -> cholesky with no class named.
        spd_cells += [(f"spd n={n}", synthetic.spd_matrix(n), None),
                      (f"spd dense n={n}", spd_dense(n, rng), "spd")]
    for label, a, must_detect in spd_cells:
        n = a.shape[0]
        detected = detect_structure(a).kind
        require(must_detect is None or detected == must_detect,
                f"{label}: detected {detected}, expected {must_detect}")
        row = routed(label, a, b_for(n), "cholesky", none,
                     structure=None if detected == "spd" else "spd")
        row["detected"] = detected
        a_dev = as_tensor(a, dev)
        form = cholesky.resolve_chol_factor(n, device=dev).__name__
        row.update(
            form=form,
            factor_ms=call_ms(lambda: cholesky.cholesky_factor(
                a_dev, device=dev), 3),
            torch_cholesky_ms=call_ms(lambda: torch.linalg.cholesky(a_dev),
                                      3),
            lu_factor_ms=call_ms(lambda: blocked.resolve_factor(
                n, device=dev)(a_dev, device=dev), 3),
            torch_lu_factor_ms=call_ms(lambda: torch.linalg.lu_factor(a_dev),
                                       3))
        out["classes"][label] = row
        print(f"phase 8: {label} (detected {detected}): cholesky ({form}) "
              f"factor "
              f"{row['factor_ms']} ms, torch.linalg.cholesky "
              f"{row['torch_cholesky_ms']} ms, the port's LU "
              f"{row['lu_factor_ms']} ms (torch.linalg.lu_factor "
              f"{row['torch_lu_factor_ms']}); {row['s_per_solve']:.4f} s per "
              f"solve, rel_residual {row['rel_residual']:.3e} [{card}]")
    a = synthetic.dense_matrix(N)
    row = routed(f"dense n={N}", a, b_for(N), "blocked", plan)
    out["classes"][f"dense n={N}"] = row
    print(f"phase 8: dense n={N}: blocked at rung 0, launches "
          f"{row['launches']} (one factorization's plan), "
          f"{row['s_per_solve']:.4f} s, rel_residual "
          f"{row['rel_residual']:.3e} [{card}]")
    for n, bw in STRUCT_BANDED:
        a = synthetic.banded_matrix(n, bw)
        row = routed(f"banded n={n} bw={bw}", a, b_for(n), "banded", none)
        out["classes"][f"banded n={n} bw={bw}"] = row
        print(f"phase 8: banded n={n} bandwidth {bw} "
              f"({'tridiagonal scan' if bw == 1 else 'block LU'}): "
              f"{row['s_per_solve']:.4f} s, rel_residual "
              f"{row['rel_residual']:.3e} [{card}]")
    try:
        for n, blk in STRUCT_BLOCKDIAG:
            a = synthetic.blockdiag_matrix(n, blk)

            def expect(misses):
                # The warm-up factor of a new cache entry and the solve's.
                return {**none, "panel_factor_batched":
                        (misses + 1) if on_card else 0}

            label = f"blockdiag n={n} block={blk}"
            kp.panel_factor_batched = checked_batched
            row = routed(label, a, b_for(n), "blockdiag", expect)
            kp.panel_factor_batched = real_batched
            # A warm call: the cache hit factors once.
            row["s_per_solve_warm"] = routed(label + " (warm)", a, b_for(n),
                                             "blockdiag", expect)[
                "s_per_solve"]
            out["classes"][f"blockdiag n={n} block={blk}"] = row
            print(f"phase 8: blockdiag n={n} blocks of {blk}: launches "
                  f"{row['launches']} (a new cache entry's warm-up + the "
                  f"factor), warm call {expect(0)['panel_factor_batched']} "
                  f"launch, {row['s_per_solve']:.4f} s cold, "
                  f"{row['s_per_solve_warm']:.4f} s warm, rel_residual "
                  f"{row['rel_residual']:.3e} [{card}]")
    finally:
        kp.panel_factor_batched = real_batched
    require(not any(k.endswith(("/smem", "/global"))
                    for k in out["batched_routes"]),
            f"the block-diagonal lane's batched panel launches by route "
            f"{out['batched_routes']}: the one-block loop")
    for shape, stack in sorted(stacks.items()):
        bms, by = batched_bound(shape)
        rec = {"bound_ms": bms, "bound_by": by, "ms": None, "plain_ms": None,
               "library_ms": None,
               "route": (kp.panel_batched_info(*shape[1:])["route"]
                         if on_card else None)}
        if on_card:
            rec["ms"] = device_ms(lambda: kp.panel_factor_batched(stack),
                                  reps)
            with quiet_fd1():
                rec["library_ms"] = device_ms(
                    lambda: torch.linalg.lu_factor(stack), reps)
            rec["plain_ms"] = call_ms(
                lambda: kp.panel_factor_batched_plain(stack), 1)
        out["batched"][str(shape)] = rec
        print(f"phase 8: batched panel kernel at {shape}: {rec['ms']} ms "
              f"(one launch), plain {rec['plain_ms']} ms, "
              f"torch.linalg.lu_factor on the stack {rec['library_ms']} ms, "
              f"bound {bms:.5f} ms ({by}) [{card}]")

    # (c) The demotions.
    systems = {"spd": synthetic.spd_matrix(STRUCT_DEMOTE_N, rho=DEMOTE_RHO),
               "dense": synthetic.dense_matrix(STRUCT_DEMOTE_N)}
    b = b_for(STRUCT_DEMOTE_N)
    for name, system, fault, failed, serving in DEMOTIONS:
        a = systems[system]
        if "=" in fault:
            fplan = inject.FaultPlan.parse(fault)
        else:
            fplan = inject.FaultPlan([inject.FaultSpec(
                site="structure.detect", kind="mistag",
                param=float(STRUCTURE_KINDS.index(fault)), max_triggers=1)])
        stream = os.path.join(work, f"demotion_{len(out['demotions'])}.jsonl")
        _build.reset_launches()
        with obs.run(metrics_out=stream, tool="chip_smoke"):
            with inject.plan(fplan) as ap:
                res = solve_auto(a, b, device=DEVICE)
        got = dict(_build.LAUNCHES)
        for k in path:
            path[k] += got[k]
        events = [ev for ev in obs.read_events(stream)
                  if ev["type"] == "recovery"]
        rel = checks.residual_norm(a, res.x, b, relative=True)
        triggers = [(ev["rung"], ev["trigger"], ev["outcome"])
                    for ev in events]
        require(ap.stats()["triggered"] == 1, f"{name}: the plan fired "
                f"{ap.stats()}")
        require(res.rung == serving and [r for r, _ in res.escalations]
                == list(failed), f"{name}: served by {res.rung} after "
                f"{res.escalations}, expected {serving} after {failed}")
        require(np.isfinite(rel) and rel <= GATE, f"{name}: rel {rel}")
        require(got == plan, f"{name}: launches {got}, expected {plan}")
        out["demotions"][name] = {
            "rung": res.rung, "rung_index": res.rung_index,
            "escalations": res.escalations, "recovery": triggers,
            "rel_residual": rel}
        print(f"phase 8: demotion {name}: served by {res.rung} at rung "
              f"{res.rung_index}, recovery {triggers}, rel_residual "
              f"{rel:.3e} [{card}]")
    print(json.dumps({"structure": out}, default=str))
    return path, out


def fused_batched_bound(bsz: int, h: int, wtot: int, panel: int,
                        itemsize: int):
    """The batched fused kernel's bound: B times one member's (kernel 2's
    count at col0 = 0: the block read and written once with the pivot
    vectors; the panel factor's and the trailing update's operations), a
    bfloat16 stack by ``bound_bf16``."""
    nbytes = bsz * (2.0 * itemsize * h * wtot + 4 * panel + 8 * h
                    + itemsize)
    step = bsz * panel_ops(h, panel, 0)
    gemm = bsz * trailing_ops(h, 0, panel, wtot - panel)
    if itemsize == 2:
        return bound_bf16(nbytes, step, gemm)
    return bound(nbytes, step + gemm)


def serve_fused_check(reps: int, rng, bsz: int, n: int, panel: int,
                      dtype_name: str) -> dict:
    """Phase 9 (a): the batched fused kernel on a (B, n, n) stack, panel
    at column 0: one launch on the route of the rule, the C launcher's
    route, K and G equal to ``fused_batched_geometry``'s; each member's
    pivots equal to the plain version's, its block within TOL (float32) or
    TOL_BF16/TOL_BF16_SHARE (bfloat16) of it, and every output bit for bit
    kernel 2 on that member alone; timed beside kernel 2 looped over the
    members, the one-block route on the same stack
    (``panel_trailing_fused_one_block``: the route tall members took
    before the grid route), the plain version, ``torch.linalg.lu_factor``
    on the stack and the bound."""
    import torch

    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel_fused as kf

    dt = getattr(torch, dtype_name)
    key = "panel_trailing_fused_batched" + ("_bf16" if dt == torch.bfloat16
                                            else "")
    dev = torch.device(DEVICE)
    orig = torch.as_tensor(rng.standard_normal((bsz, n, n)),
                           dtype=torch.float32, device=dev).to(dt)
    work = orig.clone()
    before = _build.LAUNCHES[key]
    taken = dict(_build.ROUTE_LAUNCHES)
    got = kf.panel_trailing_fused_batched(work, 0, 0, panel=panel)
    sync()
    require(_build.LAUNCHES[key] == before + (DEVICE == "cuda"),
            f"{key}: one launch per stack")
    taken = [k.split("/")[1] for k, v in _build.ROUTE_LAUNCHES.items()
             if v != taken.get(k, 0)]
    where = f"{key} at ({bsz}, {n}, {n}) panel {panel}"
    err = rel = share = 0.0
    for i in range(bsz):
        ref = kf.panel_trailing_fused_plain(orig[i].clone(), 0, 0,
                                            panel=panel)
        require(torch.equal(got[1][i], ref[1]) and torch.equal(got[2][i],
                                                               ref[2]),
                f"{where}: member {i}'s pivots differ from the plain version")
        if dt == torch.bfloat16:
            e, r, s = bf16_block_check(f"{where}, member {i}", work[i],
                                       ref[4], panel)
            share = max(share, s)
        else:
            scale = float(ref[4].abs().max())
            e = max(float((work[i] - ref[4]).abs().max()),
                    float((got[0][i] - ref[0]).abs().max()))
            require(e <= TOL * scale, f"{where}, member {i}: max |kernel - "
                    f"plain| {e} > {TOL} x {scale}")
            r = e / scale
        err, rel = max(err, e), max(rel, r)
        single = orig[i].clone()
        one = kf.panel_trailing_fused(single, 0, 0, panel=panel)
        require(same_outputs(one[:4], [g[i] for g in got[:4]])
                and torch.equal(single, work[i]),
                f"{where}: member {i} differs from kernel 2 on it alone")
    geom = kf.fused_batched_geometry(bsz, n, n, panel,
                                     itemsize=orig.element_size())
    rec = {"stack": [bsz, n, n], "panel": panel, "dtype": dtype_name,
           "err": err, "err_rel": rel, "differing_share": share,
           "rule": {"route": geom.route, "groups": geom.groups,
                    "group": geom.group, "grid": geom.grid},
           "launched": taken[0] if taken else None,
           "route": None, "groups": None, "group": None, "grid": None,
           "ms": None, "loop_ms": None, "one_block_ms": None,
           "plain_ms": None, "library_ms": None}
    rec["bound_ms"], rec["bound_by"] = fused_batched_bound(
        bsz, n, n, panel, orig.element_size())
    if DEVICE == "cuda":
        from gauss_tpu_torch.utils.timing import cuda_event_ms

        info = kf.fused_batched_launch_info(bsz, n, n, panel,
                                            itemsize=orig.element_size())
        for k in ("route", "groups", "group", "grid"):
            rec[k] = info[k]
        require(rec["rule"] == {k: info[k] for k in rec["rule"]}
                and rec["launched"] == geom.route,
                f"{where}: the C launcher's route {info} (launched on "
                f"{rec['launched']}) is not the rule's {rec['rule']}")

        def reset():
            work.copy_(orig)

        rec["ms"] = cuda_event_ms(lambda: kf.panel_trailing_fused_batched(
            work, 0, 0, panel=panel), reps, setup=reset)
        rec["loop_ms"] = cuda_event_ms(lambda: [kf.panel_trailing_fused(
            work[i], 0, 0, panel=panel) for i in range(bsz)],
            max(3, reps // 4), setup=reset)
        rec["one_block_ms"] = cuda_event_ms(
            lambda: kf.panel_trailing_fused_one_block(work, 0, 0,
                                                      panel=panel),
            max(3, reps // 4), setup=reset)
        rec["plain_ms"] = cuda_event_ms(
            lambda: kf.panel_trailing_fused_batched_plain(
                work, 0, 0, panel=panel), 1, warmup=0, setup=reset)
        f32 = orig.float()
        with quiet_fd1():
            rec["library_ms"] = cuda_event_ms(
                lambda: torch.linalg.lu_factor(f32), reps)
    print(f"phase 9: {where} (launched on {rec['launched']}; C launcher: "
          f"{rec['route']} route, K "
          f"{rec['groups']}, G {rec['group']}, grid {rec['grid']}; rule "
          f"{rec['rule']}): one launch, members == plain (pivots equal, max "
          f"err {err:g}, {rel:.3g} of scale, differing share {share:.4f}) "
          f"and == kernel 2 on each member alone bit for bit; ms "
          f"{rec['ms']} (kernel 2 looped over the members "
          f"{rec['loop_ms']}, the one-block route {rec['one_block_ms']}), "
          f"plain {rec['plain_ms']}, lu_factor on the stack "
          f"{rec['library_ms']}, bound {rec['bound_ms']:.5f} "
          f"({rec['bound_by']})")
    return rec


def batched_launch_route(h: int, panel: int, itemsize: int = 4) -> str:
    """The batched panel kernel's step loop for an (h, panel) member of
    ``itemsize``-byte words (``panel_batched_geometry``: ``regs`` or
    ``cluster``, the register loop; ``smem`` or ``global``, the one-block
    loop); on the CPU the plain version."""
    from gauss_tpu_torch.kernels import panel as kp

    if DEVICE != "cuda":
        return "plain"
    return kp.panel_batched_geometry(h, panel, itemsize).route


def batched_launch_key(itemsize: int, route: str) -> str:
    return f"panel_factor_batched{'_bf16' if itemsize == 2 else ''}/{route}"


def serve_k1_check(reps: int, rng, shape) -> dict:
    """Phase 9 (a): the batched panel kernel on a (B, h, panel, dtype)
    stack: one launch, on the route the rule names (the C launcher's
    report and its count by route), bit for bit its plain version and
    kernel 1 on each member alone; timed beside kernel 1 looped over the
    members, the plain version, ``lu_factor`` on the float32 stack and the
    bound."""
    import torch

    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel as kp

    dev = torch.device(DEVICE)
    *dims, dt = shape
    p = torch.as_tensor(rng.standard_normal(dims), dtype=torch.float32,
                        device=dev).to(getattr(torch, dt))
    isz = p.element_size()
    key = "panel_factor_batched" + ("_bf16" if isz == 2 else "")
    route = batched_launch_route(*dims[1:], isz)
    before = _build.LAUNCHES[key]
    by_route = _build.ROUTE_LAUNCHES.get(batched_launch_key(isz, route), 0)
    got = kp.panel_factor_batched(p.clone())
    sync()
    on_card = DEVICE == "cuda"
    require(_build.LAUNCHES[key] == before + on_card
            and _build.ROUTE_LAUNCHES.get(batched_launch_key(isz, route), 0)
            == by_route + on_card, f"one batched launch on the {route} route "
            f"at {shape}: {_build.ROUTE_LAUNCHES}")
    if on_card:
        info = kp.panel_batched_info(*dims[1:], isz)
        require(info["route"] == route, f"batched panel kernel at {shape}: "
                f"the C launcher's route {info}, the rule's {route}")
    require(same_outputs(got, kp.panel_factor_batched_plain(p.clone())),
            f"batched panel kernel at {shape} differs from the plain "
            f"version")
    for i in range(dims[0]):
        one = kp.panel_factor(p[i].clone())
        require(all(torch.equal(g[i], w) for g, w in zip(got, one)),
                f"batched panel kernel at {shape}: member {i} differs "
                f"from kernel 1 on it alone")
    bms, by = batched_bound(dims, itemsize=isz)
    rec = {"stack": list(dims), "dtype": dt, "err": 0.0, "bound_ms": bms,
           "bound_by": by, "route": route, "ms": None, "loop_ms": None,
           "plain_ms": None, "library_ms": None}
    if on_card:
        rec["ms"] = device_ms(lambda: kp.panel_factor_batched(p), reps)
        rec["loop_ms"] = device_ms(lambda: [kp.panel_factor(p[i]) for i in
                                            range(dims[0])],
                                   max(3, reps // 4))
        rec["plain_ms"] = call_ms(lambda: kp.panel_factor_batched_plain(p),
                                  1)
        f32 = p.float()
        with quiet_fd1():
            rec["library_ms"] = device_ms(lambda: torch.linalg.lu_factor(f32),
                                          reps)
    print(f"phase 9: batched panel kernel at {shape} ({route} route): one "
          f"launch, == plain and == kernel 1 on each member bit for bit; ms "
          f"{rec['ms']} (kernel 1 looped {rec['loop_ms']}), plain "
          f"{rec['plain_ms']}, lu_factor on the float32 stack "
          f"{rec['library_ms']}, bound {bms:.5f} ({by})")
    return rec


def batched_panel_recorder(real, seen: dict, kept: list):
    """A stand-in for ``panel_factor_batched`` that counts every launch by
    (B, h, panel, dtype) and the route the rule names (``seen``) and keeps
    each launch's input (``kept``, one device copy a launch) for
    ``check_kept_batched``."""
    def recording(p, kb=0):
        kept.append((p.clone(), kb))
        shape = (*p.shape, str(p.dtype).replace("torch.", ""))
        rec = seen.setdefault(str(shape), {
            "shape": list(shape), "launches": 0,
            "route": batched_launch_route(*p.shape[1:], p.element_size())})
        rec["launches"] += 1
        return real(p, kb)
    return recording


def check_kept_batched(kept: list, where: str) -> None:
    """The kernel launched again on every kept input, after the run (it is
    deterministic: the same input gives the same bits), bit for bit its
    plain version."""
    from gauss_tpu_torch.kernels import panel as kp

    for x, kb in kept:
        require(same_outputs(kp.panel_factor_batched(x.clone(), kb),
                             kp.panel_factor_batched_plain(x, kb)),
                f"{where}: a batched panel launch at {tuple(x.shape)} "
                f"{x.dtype} differs from the plain version")


def time_launched_batched(reps: int, seen: dict, rng) -> None:
    """Each recorded (B, h, panel, dtype) of the batched panel kernel timed
    on a random stack (device ms of queued launches) beside its bound and
    ``lu_factor`` on the float32 stack."""
    import torch

    from gauss_tpu_torch.kernels import panel as kp

    for rec in seen.values():
        *dims, dt = rec["shape"]
        p = torch.as_tensor(rng.standard_normal(dims), dtype=torch.float32,
                            device=torch.device(DEVICE)).to(getattr(torch, dt))
        rec["bound_ms"], rec["bound_by"] = batched_bound(
            dims, itemsize=p.element_size())
        rec["ms"] = rec["library_ms"] = None
        if DEVICE == "cuda":
            rec["ms"] = device_ms(lambda: kp.panel_factor_batched(p), reps)
            f32 = p.float()
            with quiet_fd1():
                rec["library_ms"] = device_ms(
                    lambda: torch.linalg.lu_factor(f32), reps)


def batched_factor_plan(n: int, panel: int, itemsize: int = 4) -> dict:
    """The launches of one ``lu_factor_blocked_batched`` on the card: a
    batched fused launch per panel with columns right of it (panel >= 64),
    then one batched panel launch, whatever the stack's size."""
    from gauss_tpu_torch.kernels import _build

    sfx = "_bf16" if itemsize == 2 else ""
    nb = -(-n // panel)
    out = dict.fromkeys(_build.LAUNCHES, 0)
    if DEVICE != "cuda":
        return out
    fused = nb - 1 if panel >= 64 else 0
    out["panel_trailing_fused_batched" + sfx] = fused
    out["panel_factor_batched" + sfx] = 1
    if panel < 64:
        out["panel_factor_batched" + sfx] = nb
    return out


def batched_factor_routes(bsz: int, n: int, panel: int,
                          itemsize: int = 4) -> dict:
    """Phase A's routes of the batched fused launches of one
    ``lu_factor_blocked_batched`` on a (bsz, n, n) stack, by the rule
    (``fused_batched_geometry`` of each live block: the panel at column kb,
    h = n - kb): launches by route."""
    from gauss_tpu_torch.kernels import panel_fused as kf

    out = {}
    npad = -(-n // panel) * panel
    for kb in range(0, npad - panel if panel >= 64 else 0, panel):
        r = kf.fused_batched_geometry(bsz, npad - kb, npad, panel, kb,
                                      itemsize=itemsize).route
        out[r] = out.get(r, 0) + 1
    return out


def serve_rung(reps: int, n: int, dtype_name: str) -> dict:
    """Phase 9 (b): ``lu_factor_blocked_batched`` on a (SERVE_BATCH, n, n)
    dominant stack: launches equal to the plan, the batched fused launches
    by phase-A route (the rule's, each launch's C geometry equal to it on
    the card; none on the one-block route); each member's ``m``, ``perm``
    and ``min_abs_pivot`` bit for bit ``lu_factor_blocked`` on it alone,
    ``linv``/``uinv`` within TOL_FACTOR of max |m|; timed beside
    ``torch.linalg.lu_factor`` on the stack."""
    import torch

    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.kernels import _build

    dev = torch.device(DEVICE)
    dt = getattr(torch, dtype_name)
    rng = np.random.default_rng(SEED + n)
    a = rng.standard_normal((SERVE_BATCH, n, n))
    a[:, np.arange(n), np.arange(n)] += float(n)
    stack = torch.as_tensor(a, dtype=torch.float32, device=dev).to(dt)
    panel = blocked.auto_panel(n, stack.element_size())
    _build.reset_launches()
    fac = blocked.lu_factor_blocked_batched(stack, device=DEVICE)
    sync()
    got = {k: v for k, v in _build.LAUNCHES.items() if v}
    counted = {k.split("/")[1]: v for k, v in _build.ROUTE_LAUNCHES.items()
               if k.startswith("panel_trailing_fused_batched")}
    counted_k1 = {k: v for k, v in _build.ROUTE_LAUNCHES.items()
                  if k.startswith("panel_factor_batched")}
    isz = stack.element_size()
    if DEVICE == "cuda":
        k1_route = batched_launch_key(isz, batched_launch_route(panel, panel,
                                                                isz))
        require(counted_k1 == {k1_route: 1}, f"lu_factor_blocked_batched "
                f"n={n}: the batched panel launch by route {counted_k1}, "
                f"the rule's {k1_route}")
    want = {k: v for k, v in batched_factor_plan(
        n, panel, stack.element_size()).items() if v}
    require(got == want, f"lu_factor_blocked_batched n={n} {dtype_name}: "
            f"launches {got}, plan {want}")
    inv_err = 0.0
    for i in range(SERVE_BATCH):
        one = blocked.lu_factor_blocked(stack[i], panel=None, device=DEVICE)
        require(torch.equal(fac.m[i], one.m) and torch.equal(fac.perm[i],
                                                             one.perm)
                and torch.equal(fac.min_abs_pivot[i], one.min_abs_pivot),
                f"lu_factor_blocked_batched n={n} {dtype_name}: member {i} "
                f"differs from lu_factor_blocked on it alone")
        scale = float(one.m.float().abs().max())
        inv_err = max(inv_err, *(float((getattr(fac, f)[i] - getattr(
            one, f)).abs().max()) / scale for f in ("linv", "uinv")))
    require(inv_err <= TOL_FACTOR, f"lu_factor_blocked_batched n={n}: "
            f"linv/uinv {inv_err} of max |m| from the single factor")
    routes = batched_factor_routes(SERVE_BATCH, n, panel, isz)
    require("block" not in routes, f"lu_factor_blocked_batched n={n}: "
            f"the rule puts a batched fused launch on the one-block route: "
            f"{routes}")
    if DEVICE == "cuda":
        require(counted == routes, f"lu_factor_blocked_batched n={n}: "
                f"batched fused launches by the route the launcher took "
                f"{counted}, the rule's plan {routes}")
        from gauss_tpu_torch.kernels import panel_fused as kf

        npad = -(-n // panel) * panel
        for kb in range(0, npad - panel if panel >= 64 else 0, panel):
            info = kf.fused_batched_launch_info(SERVE_BATCH, npad - kb, npad,
                                                panel, kb, itemsize=isz)
            want_route = batched_route(SERVE_BATCH, npad - kb, panel, isz)
            require(info["route"] == want_route, f"lu_factor_blocked_batched "
                    f"n={n}, kb={kb}: the C launcher's route {info['route']}"
                    f", the rule's {want_route}")
    rec = {"n": n, "dtype": dtype_name, "panel": panel, "launches": got,
           "fused_routes": counted, "fused_routes_plan": routes,
           "panel_routes": counted_k1,
           "linv_uinv_err": inv_err, "ms": None,
           "library_ms": None}
    if DEVICE == "cuda":
        rec["ms"] = call_ms(lambda: blocked.lu_factor_blocked_batched(
            stack, device=DEVICE), max(3, reps // 4))
        f32 = stack.float()
        with quiet_fd1():
            rec["library_ms"] = call_ms(lambda: torch.linalg.lu_factor(f32),
                                        max(3, reps // 4))
    print(f"phase 9: lu_factor_blocked_batched ({SERVE_BATCH}, {n}, {n}) "
          f"{dtype_name} panel {panel}: launches {got} == plan (batched "
          f"fused by the phase-A route each took {counted} == the rule's "
          f"{routes}); members == "
          f"lu_factor_blocked bit for bit (m, perm, min |pivot|), linv/uinv "
          f"within {inv_err:.3g} of max |m|; {rec['ms']} ms, lu_factor on "
          f"the stack {rec['library_ms']} ms")
    return rec


def serve_batch_systems():
    """Phase 9 (c)'s batch: the cache key of a full batch of the ladder's
    top rung and its members, dominant systems of order top - top // 40
    (seeded)."""
    from gauss_tpu_torch.serve import cache

    top = max(SERVE_LADDER)
    key = cache.CacheKey(bucket_n=top, nrhs=1, batch=SERVE_BATCH,
                         dtype="float32", engine="blocked",
                         refine_steps=SERVE_REFINE)
    return key, [dominant_system(top - top // 40, SEED + 9 + i)
                 for i in range(SERVE_BATCH)]


def serve_batch_pad(key, systems):
    """The batch's float64 host stacks, padded as ``_serve_batched`` pads
    them."""
    from gauss_tpu_torch.serve import buckets

    a_pad = np.empty((key.batch, key.bucket_n, key.bucket_n))
    b_pad = np.zeros((key.batch, key.bucket_n, 1))
    for i, (a, b) in enumerate(systems):
        a_pad[i], b_pad[i] = buckets.pad_system(a, b, key.bucket_n, 1)
    return a_pad, b_pad


def serve_batch_trace(path: str, retake: bool = True) -> dict:
    """One traced ``exe.solve`` of phase 9 (c)'s batch, its 16 kernels as
    planned (a batched fused launch per panel with columns right of it,
    phase A's route by the rule for the batch and the live strip's height,
    then the batched panel launch on the route the rule names; a trace
    missing some is taken again):
    device busy ms against host ms. On the card ``serve_batch_figures``
    runs it in a fresh process: in earlier whole runs, before the tall
    steps left the one-block route, the trace lost the call's first kernel
    in both takes after the earlier phases' profiler runs (queue-3 fault
    1), and held all 16 in a process that ran phase 9 alone. With ``retake`` False (the take in the server's own
    process, which records whether the fault is still there) a trace
    missing kernels is recorded, not taken again: ``lost`` counts them,
    and ``anywhere`` says what the whole trace holds."""
    from gauss_tpu_torch.serve import cache

    key, systems = serve_batch_systems()
    a_pad, b_pad = serve_batch_pad(key, systems)
    exe = cache.BatchedExecutable(key, device=DEVICE)
    plan = []
    if DEVICE == "cuda":
        for kb in range(0, key.bucket_n - exe.panel, exe.panel):
            h = key.bucket_n - kb
            plan.append(("panel_trailing_fused_batched",
                         batched_route(key.batch, h, exe.panel), h))
        plan.append(("panel_factor_batched",
                     batched_launch_route(exe.panel, exe.panel), exe.panel))
    rec = {"planned_kernels": len(plan)}
    if retake:
        kernels, busy, host_ms, traces = trace_plan(
            lambda: exe.solve(a_pad, b_pad), path, plan)
        require([(k, r) for k, r, _ in kernels]
                == [(k, r) for k, r, _ in plan],
                f"the traced batch: {plan_mismatch(kernels, plan)}")
    else:
        kernels, busy, host_ms = trace_launches(
            lambda: exe.solve(a_pad, b_pad), path)
        traces, rest = 1, iter([(k, r) for k, r, _ in plan])
        require(all(any(g == p for p in rest)
                    for g in [(k, r) for k, r, _ in kernels]),
                f"the traced batch: {plan_mismatch(kernels, plan)}")
        rec["lost"] = len(plan) - len(kernels)
        if rec["lost"]:
            rec["anywhere"] = trace_kinds_anywhere(path)
    return {**rec, "traced_kernels": len(kernels), "traces": traces,
            "traced_host_ms": host_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / host_ms) if host_ms else None}


def serve_batch_figures(server, work: str) -> dict:
    """Phase 9 (c): one full batch of the ladder's top rung, through the
    server's cache, taken apart: the host padding, the staging of the
    float64 stack, the factor, the solves and the host refinement
    residual; then ``serve_batch_trace``."""
    from gauss_tpu_torch.utils.device import as_tensor

    t = {}
    key, systems = serve_batch_systems()
    n = systems[0][0].shape[0]
    t0 = time.perf_counter()
    a_pad, b_pad = serve_batch_pad(key, systems)
    t["pad"] = time.perf_counter() - t0
    exe = server.cache.get(key)
    t0 = time.perf_counter()
    as_tensor(a_pad, server.device)
    sync()
    t["stage"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fac = exe.factor(a_pad)
    sync()
    t["factor"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = exe.solve_factored(fac, b_pad)
    t["solve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.einsum("bij,bjk->bik", a_pad, x)
    t["residual"] = time.perf_counter() - t0
    batch_s = t["pad"] + t["factor"] + (1 + SERVE_REFINE) * t["solve"] \
        + SERVE_REFINE * t["residual"]
    host_s = t["pad"] + t["stage"] + SERVE_REFINE * t["residual"]
    path = os.path.join(work, "batch.json")
    own = serve_batch_trace(os.path.join(work, "batch_own.json"),
                            retake=False)
    if DEVICE == "cuda":
        code = (f"import json, sys; sys.path.insert(0, {REPO!r}); "
                f"import chip_smoke as c; "
                f"print(json.dumps(c.serve_batch_trace({path!r})))")
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=600)
        require(r.returncode == 0, f"the traced batch's process exited "
                f"{r.returncode}: {(r.stdout + r.stderr)[-3000:]}")
        tr = json.loads(r.stdout.strip().splitlines()[-1])
    else:
        tr = serve_batch_trace(path)
    rec = {"bucket_n": key.bucket_n, "n": n, "batch": SERVE_BATCH,
           "ms": {k: 1e3 * v for k, v in t.items()},
           "batch_ms": 1e3 * batch_s,
           "host_staging_share": host_s / batch_s, **tr,
           "own_process_trace": own}
    print(f"phase 9: one ({SERVE_BATCH}, {key.bucket_n}, {key.bucket_n}) "
          f"batch taken apart (ms): "
          f"{', '.join(f'{k} {1e3 * v:.1f}' for k, v in t.items())}; host "
          f"staging (padding, the float64 stack's staging, {SERVE_REFINE} "
          f"host residual) {rec['host_staging_share']:.3f} of the batch; "
          f"traced exe.solve in a fresh process ({tr['traced_kernels']} "
          f"kernels, as planned; {tr['traces']} take(s)): host "
          f"{tr['traced_host_ms']:.1f} ms, device busy "
          f"{tr['device_busy_ms']:.1f} ms, idle share {tr['idle_share']}; "
          f"in the server's own process {own['traced_kernels']} of "
          f"{own['planned_kernels']} kernels recorded (lost {own['lost']}"
          f"{', the whole trace: ' + str(own['anywhere']) if own['lost'] else ''}"
          f"), host {own['traced_host_ms']:.1f} ms, device busy "
          f"{own['device_busy_ms']:.1f} ms, idle share {own['idle_share']}")
    return rec


def phase_serve(reps: int):
    """The solver service on the card (module docstring, phase 9): returns
    the launch counts of the service run (c) and the phase's figures."""
    import torch

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.obs import requesttrace
    from gauss_tpu_torch.obs import summarize as summ
    from gauss_tpu_torch.resilience import inject
    from gauss_tpu_torch.serve import (STATUS_OK, STATUS_POISON, ServeConfig,
                                       SolverServer, cache)
    from gauss_tpu_torch.serve import cli as serve_cli
    from gauss_tpu_torch.serve import loadgen

    on_card = DEVICE == "cuda"
    card = smi_line() if on_card else "cpu"
    work = os.path.join(REPO, "build", "chip_smoke", "serve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(SEED + 9)
    out = {"card": card, "fused": {}, "k1": {}, "rungs": {}}

    # (a) The three new kernels against their plain versions.
    for bsz, n, panel, dt in SERVE_FUSED_CHECK:
        out["fused"][f"({bsz}, {n}, {n}) {dt}"] = serve_fused_check(
            reps, rng, bsz, n, panel, dt)
    for shape in SERVE_K1_CHECK:
        out["k1"][f"{tuple(shape[:3])} {shape[3]}"] = serve_k1_check(
            reps, rng, shape)

    # (b) The batched LU at every rung of the ladder.
    for n in SERVE_LADDER:
        out["rungs"][f"{n} float32"] = serve_rung(reps, n, "float32")
    out["rungs"][f"{SERVE_BF16_N} bfloat16"] = serve_rung(reps, SERVE_BF16_N,
                                                         "bfloat16")

    # (c) The service at its default width, driven by the load generator;
    # the launch counts are read against the plan of every factor the
    # cache ran (each new entry's warm-up factor included).
    cfg = ServeConfig(ladder=SERVE_LADDER, max_batch=SERVE_BATCH,
                      refine_steps=SERVE_REFINE, cache_capacity=32,
                      verify_gate=GATE, structure_aware=True, device=DEVICE)
    factors = []
    real_factor = cache.BatchedExecutable.factor
    # Every batched panel launch of (c) and (e), by shape and route, each
    # held against its plain version after the run.
    seen, kept = {}, []
    real_batched = kp.panel_factor_batched

    def counted_factor(exe, a_pad):
        factors.append((exe.key, exe.panel))
        return real_factor(exe, a_pad)

    stream = os.path.join(work, "service.jsonl")
    lcfg = loadgen.LoadgenConfig(
        mix=SERVE_MIX, requests=SERVE_REQUESTS, warmup=SERVE_WARMUP,
        concurrency=SERVE_CONCURRENCY, seed=SEED, serve=cfg)
    big = dominant_system(SERVE_OVERSIZE, SEED + 6)
    cache.BatchedExecutable.factor = counted_factor
    kp.panel_factor_batched = batched_panel_recorder(real_batched, seen, kept)
    try:
        with obs.run(metrics_out=stream, tool="chip_smoke_serve"), \
                SolverServer(cfg) as server:
            _build.reset_launches()
            summary = loadgen.run_load(server, lcfg)
            handoff = server.solve(*big, timeout=900)
            sync()
            got = dict(_build.LAUNCHES)
            counted = {k: v for k, v in _build.ROUTE_LAUNCHES.items()
                       if k.startswith("panel_trailing_fused_batched")}
            counted_k1 = {k: v for k, v in _build.ROUTE_LAUNCHES.items()
                          if k.startswith("panel_factor_batched")}
            served_factors = list(factors)
            kp.panel_factor_batched = real_batched
            out["batch"] = serve_batch_figures(server, work)
    finally:
        cache.BatchedExecutable.factor = real_factor
        kp.panel_factor_batched = real_batched
    require(handoff.status == STATUS_OK and handoff.lane == "handoff",
            f"the oversized request: {handoff.status} on {handoff.lane} "
            f"({handoff.error})")
    lanes = dict(summary["lanes"])
    lanes["handoff"] = lanes.get("handoff", 0) + 1
    counts = summary["counts"]
    require(counts["ok"] == SERVE_REQUESTS and summary["incorrect"] == 0
            and counts["failed"] == 0,
            f"service: {counts}, {summary['incorrect']} incorrect")
    require(not lanes.get("numpy") and {"batched", "sparse", "handoff"}
            <= set(lanes), f"service lanes {lanes}")
    events = obs.read_events(stream)
    served = {(ev["bucket_n"], ev.get("structure")) for ev in events
              if ev["type"] == "serve_batch"}
    require({b for b, _ in served} >= set(SERVE_LADDER),
            f"service: the batches reached the rungs "
            f"{sorted({b for b, _ in served})}, not all of {SERVE_LADDER}")
    dtypes = {k.dtype for k, _ in served_factors}
    spd = any(k.structure == "spd" for k, _ in served_factors)
    require(dtypes == {"float32", "bfloat16", "bf16x3"} and spd,
            f"service: the lanes factored {sorted(dtypes)}, spd: {spd}")
    plan = dict.fromkeys(_build.LAUNCHES, 0)
    routes, routes_k1 = {}, {}
    for key, panel in served_factors:
        if key.structure != "spd":
            isz = 2 if key.dtype == "bfloat16" else 4
            for k, v in batched_factor_plan(key.bucket_n, panel,
                                            isz).items():
                plan[k] += v
            sfx = "_bf16" if isz == 2 else ""
            for r, v in batched_factor_routes(key.batch, key.bucket_n,
                                              panel, isz).items():
                k = f"panel_trailing_fused_batched{sfx}/{r}"
                routes[k] = routes.get(k, 0) + v
            if on_card:
                k = batched_launch_key(isz, batched_launch_route(
                    panel, panel, isz))
                routes_k1[k] = routes_k1.get(k, 0) + 1
    require(not on_card or counted == routes, f"service: batched fused "
            f"launches by the "
            f"route the launcher took {counted}, the plan by the rule "
            f"{routes}")
    require(not any(k.endswith("/block") for k in counted), f"service: "
            f"batched fused launches on the one-block route: {counted}")
    require(not on_card or counted_k1 == routes_k1, f"service: batched "
            f"panel launches by the route the launcher took {counted_k1}, "
            f"the plan by the rule {routes_k1}")
    require(not any(k.endswith(("/smem", "/global")) for k in counted_k1),
            f"service: batched panel launches on the one-block loop: "
            f"{counted_k1}")
    hf = blocked.resolve_factor(SERVE_OVERSIZE, device=DEVICE)
    hpanel = blocked.auto_panel(SERVE_OVERSIZE)
    chunk = (getattr(hf, "keywords", {}).get("chunk", blocked.CHUNK_DEFAULT)
             if getattr(hf, "func", hf) is blocked.lu_factor_blocked_chunked
             else None)
    if on_card:
        for k, v in plan_counts(factor_plan(SERVE_OVERSIZE, hpanel,
                                            chunk)).items():
            plan[k] += v
    dense = [k for k in plan if k != "spmv_ell"]
    require({k: got[k] for k in dense} == {k: plan[k] for k in dense},
            f"service launches { {k: got[k] for k in dense if got[k]} } != "
            f"the plan of its factors "
            f"{ {k: plan[k] for k in dense if plan[k]} }")
    require(not on_card or got["spmv_ell"] > 0,
            "the sparse lane launched no SpMV")
    lat = summary["latency_s"]
    c = server.cache.stats()
    out["service"] = {
        "mix": SERVE_MIX, "requests": SERVE_REQUESTS, "warmup": SERVE_WARMUP,
        "concurrency": SERVE_CONCURRENCY, "refine_steps": SERVE_REFINE,
        "counts": counts, "lanes": lanes,
        "cache": {k: c[k] for k in ("hits", "misses", "evictions")},
        "solves_per_s": summary["throughput_rps"], "p50_s": lat["p50"],
        "p99_s": lat["p99"], "occupancy_mean":
            summary["batch_occupancy_mean"], "batches": summary["batches"],
        "factors": len(served_factors),
        "launches": {k: v for k, v in got.items() if v},
        "batched_fused_routes": counted, "batched_fused_routes_plan": routes,
        "batched_panel_routes": counted_k1}
    print(f"phase 9: service ({SERVE_REQUESTS} requests + {SERVE_WARMUP} "
          f"warm-up, closed loop x{SERVE_CONCURRENCY}, mix {SERVE_MIX}, plus "
          f"one n={SERVE_OVERSIZE}): {counts}, lanes {lanes}, cache "
          f"{out['service']['cache']}, {summary['throughput_rps']} solves/s, "
          f"p50 {lat['p50']} s, p99 {lat['p99']} s, mean occupancy "
          f"{summary['batch_occupancy_mean']}; launches "
          f"{out['service']['launches']} == the plan of its "
          f"{len(served_factors)} factors and the handoff factorization "
          f"(batched fused by the phase-A route each launch took {counted}"
          f" == the rule's plan; batched panel by step loop {counted_k1} =="
          f" the rule's plan) [{card}]")

    # (d) Faults: a transient build fault retried and served; poison.
    with SolverServer(ServeConfig(**{**cfg.__dict__,
                                     "structure_aware": False})) as srv:
        fplan = inject.FaultPlan.parse(
            "serve.cache.compile=compile_fail:max=1")
        with inject.plan(fplan) as ap:
            res = srv.solve(*dominant_system(SERVE_LADDER[1] - 6, SEED + 7),
                            timeout=600)
        require(res.status == STATUS_OK and res.lane == "batched"
                and srv.retries == 1 and ap.stats()["triggered"] == 1,
                f"transient fault: {res.status} on {res.lane}, "
                f"{srv.retries} retries ({res.error})")
        poisoned = {}
        for kind in ("nan", "singular"):
            spec = loadgen.WorkloadSpec("poison", f"{kind}/{SERVE_POISON_N}")
            r = srv.solve(*loadgen.materialize(spec, rng), timeout=600)
            require(r.status == STATUS_POISON, f"poison:{kind}: {r.status} "
                    f"({r.error})")
            poisoned[kind] = r.error[:80]
    out["faults"] = {"transient_retries": 1, "poison": poisoned}
    print(f"phase 9: a serve.cache.compile fault retried once and served on "
          f"the batched lane; poison: {poisoned} [{card}]")

    # (e) The CLI, its stream through the summarizer and requesttrace.
    cli_stream = os.path.join(work, "cli.jsonl")
    kp.panel_factor_batched = batched_panel_recorder(real_batched, seen, kept)
    try:
        run_cli(serve_cli, ["--requests", str(SERVE_CLI_REQUESTS),
                            "--warmup", "0", "--mix", SERVE_CLI_MIX,
                            "--device", DEVICE, "--metrics-out", cli_stream,
                            *SERVE_CLI_ARGS])
    finally:
        kp.panel_factor_batched = real_batched
    text = run_cli(summ, [cli_stream])
    m = re.search(r"serving:\n\s+requests: ok=(\d+)", text)
    require(m and int(m.group(1)) == SERVE_CLI_REQUESTS,
            f"summarize's serving section: {m and m.group(0)}")
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = requesttrace.main([cli_stream, "--check"])
    require(rc == 0, f"requesttrace --check: {buf.getvalue()}")
    print(f"phase 9: serve.cli exit 0; summarize: ok={m.group(1)}; "
          f"{buf.getvalue().strip()}")
    # Step 1's record: the batched panel launches of (c) and (e) by shape,
    # each held against its plain version, each shape timed.
    t0 = time.perf_counter()
    check_kept_batched(kept, "service and CLI")
    time_launched_batched(reps, seen, rng)
    out["batched_launched"] = seen
    for rec in seen.values():
        require(not on_card or rec["route"] in ("regs", "cluster"),
                f"service: a batched panel launch at {rec['shape']} on the "
                f"one-block loop ({rec['route']})")
        print(f"phase 9: batched panel launches at {tuple(rec['shape'])}: "
              f"{rec['launches']} on the {rec['route']} route, "
              f"{rec['ms']} ms, bound {rec['bound_ms']:.5f} "
              f"({rec['bound_by']}), lu_factor on the float32 stack "
              f"{rec['library_ms']} [{card}]")
    print(f"phase 9: {len(kept)} batched panel launches of the service and "
          f"the CLI == their plain versions bit for bit "
          f"({time.perf_counter() - t0:.1f} s with the timings)")
    print(json.dumps({"serve": out}, default=str))
    return {k: got[k] for k in _build.LAUNCHES}, out


# --- Phase 10: the checksum-carrying and checkpointed factorizations ------


def abft_plan(n: int, panel: int, chunk: int, replays=(),
              groups: int | None = None) -> list:
    """Kernel 1's launches of one ``lu_factor_abft`` (the checksum rider
    pins the unfused pair: the panel kernel on every panel, in group
    order) over its first ``groups`` groups (default all), then those of
    each replayed group in ``replays``, as ``(launch key, route, strip
    height)``."""
    plan = factor_plan(n, panel, chunk, unfused=True)
    out = plan[:None if groups is None else groups * chunk]
    for g in replays:
        out += plan[g * chunk:(g + 1) * chunk]
    return out


def launch_counts(plan) -> dict:
    """A plan's launches as phase 10 counts them: the single-strip panel
    kernel by its launch key, which names its route; the fused kernel by
    key and phase-A route."""
    out = {}
    for key, route, _ in plan:
        k = key if key.startswith("panel_factor") else f"{key}/{route}"
        out[k] = out.get(k, 0) + 1
    return out


def planned_flip(site: str, skip: int, seed: int, lo: int, npad: int):
    """The (row, column) that an ``sdc_bitflip`` plan of ``seed`` flips at
    its firing poll: the first draw of ``abft._poll_sdc_corrupt`` from the
    spec's generator (row, then column, over the active region from
    ``lo``)."""
    from gauss_tpu_torch.resilience import inject

    plan = inject.FaultPlan([inject.FaultSpec(
        site=site, kind="sdc_bitflip", skip=skip, max_triggers=1)],
        seed=seed)
    with inject.plan(plan):
        for _ in range(skip):
            inject.poll_sdc(site)
        _, rng = inject.poll_sdc(site)
        i = lo + int(rng.integers(0, max(1, npad - lo)))
        j = lo + int(rng.integers(0, max(1, npad - lo)))
    return i, j


def with_sdc_plan(site: str, fn, seed: int, **spec) -> dict:
    """``fn()`` under one ``sdc_bitflip`` spec at ``site``: its value, or
    the SDCUnrecoverableError it raised, the ``sdc_inject`` and ``sdc``
    events, and the plan's trigger count."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.resilience import abft, inject

    plan = inject.FaultPlan([inject.FaultSpec(site=site, kind="sdc_bitflip",
                                              **spec)], seed=seed)
    out = {"value": None, "error": None}
    with obs.run() as rec:
        with inject.plan(plan) as ap:
            try:
                out["value"] = fn()
            except abft.SDCUnrecoverableError as e:
                out["error"] = e
    out["injected"] = [e for e in rec.events if e["type"] == "sdc_inject"]
    out["sdc"] = [e for e in rec.events if e["type"] == "sdc"]
    out["triggered"] = ap.stats()["triggered"]
    return out


def bits_equal(f0, f1, fields) -> bool:
    import torch

    return all(torch.equal(getattr(f0, f), getattr(f1, f)) for f in fields)


def checked_abft_factor(a, panel: int, chunk: int) -> dict:
    """One ``lu_factor_abft`` of ``a`` with every kernel-1 launch held
    against its plain version (``checked_launches``), the checked launches
    equal to the plan's: returns them."""
    from gauss_tpu_torch.resilience import abft

    n = a.shape[0]
    seen = {}
    with checked_launches(seen):
        abft.lu_factor_abft(a, panel=panel, chunk=chunk, device=DEVICE)
        sync()
    plan = abft_plan(n, panel, chunk)
    want = {"panel": len(plan), "panel strided": len(plan),
            "panel grid": sum(r == "grid" for _, r, _ in plan),
            "panel one-block": sum(r == "block" for _, r, _ in plan)}
    require(seen == {k: v for k, v in want.items() if v},
            f"lu_factor_abft n={n}, panel {panel}: checked launches {seen}, "
            f"plan {want}")
    return seen


def resilience_lu(counted, a, n: int, panel: int, chunk: int) -> dict:
    """Phase 10 (a): the checksum-carrying LU at full size (module
    docstring)."""
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.resilience import abft, recover
    from gauss_tpu_torch.utils.timing import cuda_event_ms
    from gauss_tpu_torch.verify import checks

    on_card = DEVICE == "cuda"
    npad = -(-n // panel) * panel
    groups = -(-(npad // panel) // chunk)
    w = chunk * panel

    def factor():
        return abft.lu_factor_abft(a, panel=panel, chunk=chunk,
                                   device=DEVICE)

    def planned(*replays, upto=None):
        return (launch_counts(abft_plan(n, panel, chunk, replays, upto))
                if on_card else {})

    (clean, rep), got = counted(factor)
    require(got == planned(), f"lu_factor_abft n={n}: kernel launches by "
            f"route {got}, the plan says {planned()}")
    require(rep.detections == 0, f"lu_factor_abft n={n}: a clean run "
            f"tripped detection: {rep.to_dict()}")
    errs = clean.abft_err.cpu().numpy().astype(np.float64)
    rec = {"n": n, "panel": panel, "chunk": chunk, "groups": groups,
           "tol": rep.tol, "launches": got,
           "max_group_err_over_tol": float(errs[:-1].max()) / rep.tol,
           "final_err_over_tol": float(errs[-1]) / (
               rep.tol * abft.FINAL_TOL_FACTOR)}
    for label, kw in (("abft=True", {"abft": True}),
                      ("panel_impl='pallas'", {"panel_impl": "pallas"})):
        ref = blocked.lu_factor_blocked_chunked(a, panel=panel, chunk=chunk,
                                                device=DEVICE, **kw)
        require(bits_equal(clean, ref, LU_FIELDS), f"lu_factor_abft n={n} "
                f"!= lu_factor_blocked_chunked({label}) bit for bit")
        del ref
    # Every kernel-1 launch of one factorization against its plain version
    # (most of its strip heights run on no other path).
    rec["checked_launches"] = checked_abft_factor(a, panel, chunk)

    # A transient flip in a middle group, right of the group's columns:
    # detected in that group at that column, replayed to the clean bits.
    g = RES_FLIP_GROUP
    seed = next(s for s in range(64)
                if planned_flip(abft.SITE_LU, g, s, g * w, npad)[1]
                >= (g + 1) * w)
    run, got = counted(lambda: with_sdc_plan(
        abft.SITE_LU, factor, seed, max_triggers=1, skip=g))
    fac, rep_t = run["value"]
    (inj,) = run["injected"]
    require(run["triggered"] == 1 and inj["group"] == g
            and rep_t.detect_groups == [g] and rep_t.detect_cols
            == [inj["col"]] and rep_t.replays == 1 and not rep_t.escalated,
            f"transient flip in group {g}: injected {inj}, report "
            f"{rep_t.to_dict()}")
    require(bits_equal(fac, clean, LU_FIELDS), f"transient flip in group "
            f"{g}: the replayed factor differs from the clean one")
    require(got == planned(g), f"transient flip: launches {got}, the plan "
            f"with group {g} replayed says {planned(g)}")
    rec["transient"] = {"group": g, "row": inj["row"], "col": inj["col"],
                        "bit": inj["bit"], "magnitude": rep_t.max_err,
                        "replays": rep_t.replays,
                        "detect_latency_s": rep_t.detect_latency_s}
    del fac

    # A flip in the last group.
    last = groups - 1
    run, got = counted(lambda: with_sdc_plan(
        abft.SITE_LU, factor, 0, max_triggers=1, skip=last))
    fac, rep_l = run["value"]
    by_final = [e for e in run["sdc"] if e["latency_s"] == 0.0]
    require(run["triggered"] == 1 and rep_l.detections >= 1
            and set(rep_l.detect_groups) == {last} and not rep_l.escalated
            and bits_equal(fac, clean, LU_FIELDS) and got == planned(last),
            f"flip in the last group: report {rep_l.to_dict()}, launches "
            f"{got}")
    (run_l_inj,) = run["injected"]
    del fac
    # The last group's own column identity sees a flip of its active
    # region first; the final identity e^T P A = (e^T L) U is what sees a
    # flip that lands in U after the last group's check. A stand-in flips
    # one bit of U in the final identity's first input: in a column of the
    # last group the runner replays that group from its rollback point to
    # the clean bits; in group 0's columns, past the carry it keeps, it
    # escalates.
    real_final = blocked._csum_final_err_lu

    def final_flip(col):
        v = float(clean.m[1, col])
        bit = next(b for b in range(23, 31) if not abs(
            abft._flipped_host(v, b, np.float32) - v)
            <= 8 * rep.tol * abft.FINAL_TOL_FACTOR)
        calls = []

        def flipped_once(m, crow0):
            calls.append(col)
            if len(calls) == 1:
                m = abft.flip_bit(m.clone(), 1, col, bit)
            return real_final(m, crow0)

        def run():
            try:
                return factor()[0], None
            except abft.SDCUnrecoverableError as e:
                return None, e

        blocked._csum_final_err_lu = flipped_once
        try:
            (fac, err), got = counted(run)
        finally:
            blocked._csum_final_err_lu = real_final
        return fac, err, got, abft.last_report(), len(calls), bit

    def share(e):
        """A mismatch over ``tol``; None where the flip made an inf."""
        return e / rep.tol if np.isfinite(e) else None

    col = last * w + 1
    fac, err, got, rep_f, calls, bit = final_flip(col)
    require(err is None and rep_f.detect_groups == [last]
            and rep_f.detect_cols == [col] and rep_f.replays == 1
            and not rep_f.escalated and calls == 2
            and bits_equal(fac, clean, LU_FIELDS) and got == planned(last),
            f"a U flip in column {col} seen by the final identity: report "
            f"{rep_f.to_dict()}, identity calls {calls}, launches {got}")
    rec["last_group"] = {"group": last, "row": run_l_inj["row"],
                         "col": run_l_inj["col"],
                         "detections": rep_l.detections,
                         "by_final_identity": len(by_final),
                         "by_group_check": rep_l.detections - len(by_final),
                         "final_identity": {
                             "col": col, "bit": bit,
                             "replays": rep_f.replays,
                             "err_over_tol": share(rep_f.max_err)}}
    del fac
    fac, err, got, rep_f, calls, bit = final_flip(panel + 1)
    require(fac is None and err is not None and err.group == 0
            and err.col == panel + 1 and rep_f.escalated and calls == 1
            and got == planned(), f"a U flip in column {panel + 1} seen by "
            f"the final identity: raised {err!r}, report "
            f"{rep_f.to_dict()}, launches {got}")
    rec["last_group"]["factored_flip"] = {
        "col": panel + 1, "bit": bit, "escalated": True,
        "err_over_tol": share(err.magnitude)}

    # A persistent flip: typed, and the ladder escalates past it.
    g = RES_PERSIST_GROUP
    run, got = counted(lambda: with_sdc_plan(
        abft.SITE_LU, factor, 1, max_triggers=None, skip=g))
    err = run["error"]
    require(err is not None and err.group == g, f"persistent flip in group "
            f"{g}: {run['value'] and run['value'][1].to_dict()} raised "
            f"{err!r}")
    require(got == planned(g, g, upto=g + 1), f"persistent flip: launches "
            f"{got}, the plan up to group {g} with it twice more says "
            f"{planned(g, g, upto=g + 1)}")
    rng = np.random.default_rng(SEED + 3)
    a64 = a.cpu().numpy().astype(np.float64)
    b64 = rng.standard_normal(n)
    run, got = counted(lambda: with_sdc_plan(
        abft.SITE_LU, lambda: recover.solve_resilient(
            a64, b64, abft=True, panel=panel, device=DEVICE), 1,
        max_triggers=None,
        skip=g))
    res = run["value"]
    rel = checks.residual_norm(a64, res.x, b64, relative=True)
    require(res.rung_index >= 1
            and res.escalations[0] == ("abft",
                                       "exception:SDCUnrecoverableError")
            and res.sdc["escalated"] and rel <= GATE,
            f"persistent flip under solve_resilient: rung {res.rung}, "
            f"escalations {res.escalations}, residual {rel}")
    rec["persistent"] = {"group": g, "error_col": err.col,
                         "magnitude": err.magnitude, "served_by": res.rung,
                         "rel_residual": rel, "launches": got}
    del a64

    # solve_lu_abft on the internal system.
    ai, bi = synthetic.internal_matrix(n), synthetic.internal_rhs(n)
    (x, _, rep_i), got = counted(lambda: abft.solve_lu_abft(
        ai, bi, panel=panel, chunk=chunk, device=DEVICE))
    res_i = checks.residual_norm(ai, x, bi)
    require(checks.internal_pattern_ok(x, atol=1e-4) and res_i < GATE
            and rep_i.detections == 0 and got == planned(),
            f"solve_lu_abft internal n={n}: residual {res_i}, report "
            f"{rep_i.to_dict()}, launches {got}")
    rec["internal_residual"] = res_i
    del ai, bi, x
    if on_card:
        rec["factor_ms"] = cuda_event_ms(factor, 3, warmup=1)
        for key, kw in (("chunked_ms", {}), ("chunked_abft_ms",
                                             {"abft": True}),
                        ("chunked_pallas_ms", {"panel_impl": "pallas"})):
            rec[key] = cuda_event_ms(
                lambda kw=kw: blocked.lu_factor_blocked_chunked(
                    a, panel=panel, chunk=chunk, device=DEVICE, **kw), 3,
                warmup=1)
    return rec


def resilience_checkpoint(counted, a, n: int, panel: int, chunk: int,
                          work: str) -> dict:
    """Phase 10 (b): the checkpointed chunked LU at full size."""
    import torch

    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.resilience import checkpoint as ckpt
    from gauss_tpu_torch.resilience import inject

    on_card = DEVICE == "cuda"
    plan = factor_plan(n, panel, chunk)
    want = launch_counts(plan) if on_card else {}
    saves = []
    real_save = ckpt.save_state

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        nbytes = real_save(*args, **kw)
        saves.append((round(time.perf_counter() - t0, 4), nbytes))
        return nbytes

    path = os.path.join(work, "ck.npz")
    ckpt.save_state = timed_save
    try:
        t0 = time.perf_counter()
        fck, got = counted(lambda: ckpt.lu_factor_blocked_chunked_checkpointed(
            a, path, panel=panel, chunk=chunk, device=DEVICE))
        wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        ckpt.save_state = real_save
    require(got == want, f"checkpointed n={n}: launches by route {got}, the "
            f"plan says {want}")
    ref = blocked.lu_factor_blocked_chunked(a, panel=panel, chunk=chunk,
                                            device=DEVICE)
    require(bits_equal(fck, ref, LU_FIELDS), f"checkpointed n={n} != "
            f"lu_factor_blocked_chunked bit for bit")
    del ref
    groups = -(-(-(-n // panel)) // chunk)
    require(len(saves) == groups - 1 and not os.path.exists(path),
            f"checkpointed n={n}: {len(saves)} saves, file left: "
            f"{os.path.exists(path)}")
    rec = {"n": n, "saves_s_bytes": saves, "wall_ms": wall_ms,
           "launches": got}
    # A child process killed at the third group boundary (kind kill: a
    # real os._exit) with the kernels this process built; this process
    # resumes its file.
    kpath = os.path.join(work, "killed.npz")
    code = (f"import json, sys; sys.path.insert(0, {REPO!r}); "
            f"import numpy as np, torch; "
            f"from gauss_tpu_torch.kernels import _build; "
            f"print(json.dumps(_build.build_all() if {on_card} else {{}}), "
            f"flush=True); "
            f"from gauss_tpu_torch.resilience import checkpoint as c; "
            f"a = torch.as_tensor(np.random.default_rng({SEED + n})"
            f".standard_normal(({n}, {n})), dtype=torch.float32, "
            f"device={DEVICE!r}); "
            f"c.lu_factor_blocked_chunked_checkpointed(a, {kpath!r}, "
            f"panel={panel}, chunk={chunk}, device={DEVICE!r}); "
            f"print('finished')")
    env = {**os.environ,
           "GAUSS_FAULTS": f"checkpoint.group=kill:skip={RES_KILL_SKIP}"}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    require(r.returncode == inject.KILL_EXIT_CODE
            and "finished" not in r.stdout, f"the killed child exited "
            f"{r.returncode}: {(r.stdout + r.stderr)[-2000:]}")
    built = json.loads(r.stdout.splitlines()[0])
    require(not any(built.values()), f"the child rebuilt kernels: {built}")
    done = ckpt.load_state(kpath)["meta"]["next_group"]
    require(done == RES_KILL_SKIP * chunk, f"the killed child saved "
            f"next_group {done}")
    resumed, got = counted(lambda: ckpt.lu_factor_blocked_chunked_checkpointed(
        a, kpath, panel=panel, chunk=chunk, device=DEVICE))
    require(bits_equal(resumed, fck, LU_FIELDS), f"resumed n={n} != the "
            f"uninterrupted checkpointed factor bit for bit")
    rest = [x for x in plan if x[2] <= n - done * panel]
    require(got == (launch_counts(rest) if on_card else {}),
            f"resume from group {done}: launches {got}")
    rec["kill"] = {"next_group": done, "child_s": round(child_s, 3),
                   "child_build_s": built, "resume_launches": got}
    if on_card:
        t0 = time.perf_counter()
        ckpt.lu_factor_blocked_chunked_checkpointed(a, path, panel=panel,
                                                    chunk=chunk,
                                                    device=DEVICE)
        sync()
        rec["second_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    del fck, resumed
    if on_card:
        torch.cuda.empty_cache()
    return rec


def resilience_cholesky(n: int, reps: int) -> dict:
    """Phase 10 (c): the checksum-carrying Cholesky at ``n``."""
    import torch

    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.resilience import abft
    from gauss_tpu_torch.structure import cholesky
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    a = torch.as_tensor(synthetic.spd_matrix(n), dtype=torch.float32,
                        device=torch.device(DEVICE))
    f0 = cholesky.cholesky_factor_blocked(a, device=DEVICE)
    f1 = cholesky.cholesky_factor_blocked(a, abft=True, device=DEVICE)
    clean, rep = abft.cholesky_factor_abft(a, device=DEVICE)
    require(bits_equal(f0, f1, CHOL_FIELDS) and bits_equal(
        f0, clean, CHOL_FIELDS), f"Cholesky n={n}: the rider changed bits")
    require(rep.detections == 0 and float(clean.min_diag) > 0,
            f"Cholesky n={n}: a clean run tripped detection: "
            f"{rep.to_dict()}")
    errs = clean.abft_err.cpu().numpy().astype(np.float64)
    nb = rep.groups
    k = nb // 2
    run = with_sdc_plan(abft.SITE_CHOL, lambda: abft.cholesky_factor_abft(
        a, device=DEVICE), 0, max_triggers=1, skip=k)
    fac, rep_t = run["value"]
    require(run["triggered"] == 1 and rep_t.detect_groups == [k]
            and rep_t.replays == 1 and bits_equal(fac, clean, CHOL_FIELDS),
            f"Cholesky n={n}: flip at panel {k}: {rep_t.to_dict()}")
    rec = {"n": n, "panels": nb, "tol": rep.tol,
           "max_group_err_over_tol": float(errs[:-1].max()) / rep.tol,
           "final_err_over_tol": float(errs[-1]) / (
               rep.tol * abft.FINAL_TOL_FACTOR),
           "transient": {"panel": k, "row": run["injected"][0]["row"],
                         "col": run["injected"][0]["col"],
                         "magnitude": rep_t.max_err}}
    del fac, f1, f0, clean
    if DEVICE == "cuda":
        rec["abft_ms"] = cuda_event_ms(
            lambda: abft.cholesky_factor_abft(a, device=DEVICE), reps,
            warmup=1)
        rec["flat_ms"] = cuda_event_ms(
            lambda: cholesky.cholesky_factor_blocked(a, device=DEVICE), reps,
            warmup=1)
        rec["unrolled_ms"] = cuda_event_ms(
            lambda: cholesky.cholesky_factor_blocked_unrolled(a,
                                                              device=DEVICE),
            reps, warmup=1)
    return rec


def resilience_matmul(n: int, reps: int) -> dict:
    """Phase 10 (d): ``abft_matmul`` at (n,)^3 in "highest" and "high"."""
    import torch

    from gauss_tpu_torch.core.matmul import matmul
    from gauss_tpu_torch.resilience import abft
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    rng = np.random.default_rng(SEED + 10)
    dev = torch.device(DEVICE)
    a = torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32,
                        device=dev)
    b = torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32,
                        device=dev)
    out = {}
    real_poll = abft._poll_sdc_corrupt

    def flip_row(site, m, lo, engine, group, **kw):
        for j in range(m.shape[1]):
            abft.flip_bit(m, 5, j, 29)
        return m, True

    for prec in ("highest", "high"):
        clean, info = abft.abft_matmul(a, b, precision=prec, device=DEVICE)
        require(info["detections"] == 0 and torch.equal(
            clean, matmul(a, b, prec)), f"abft_matmul {prec}: clean product "
            f"flagged or != core.matmul: {info}")
        tol = info["tol"]
        tried = []
        for seed in range(16):
            run = with_sdc_plan(abft.SITE_MATMUL, lambda: abft.abft_matmul(
                a, b, precision=prec, device=DEVICE), seed, max_triggers=1)
            fixed, inf = run["value"]
            (inj,) = run["injected"]
            v = float(clean[inj["row"], inj["col"]])
            delta = abs(abft._flipped_host(v, inj["bit"], np.float32) - v)
            dev_max = float((fixed - clean).abs().max())
            if inf["detections"]:
                require((inf["corrected"] or inf["recomputed"])
                        and dev_max <= tol, f"abft_matmul {prec} seed "
                        f"{seed}: {inf}, max deviation {dev_max}")
            else:
                require(np.isfinite(delta) and delta <= tol,
                        f"abft_matmul {prec} seed {seed}: flip of "
                        f"{delta} > tol {tol} missed")
            tried.append({"seed": seed, "bit": inj["bit"], "delta": delta,
                          "corrected": inf["corrected"],
                          "recomputed": inf["recomputed"],
                          "max_dev": dev_max})
            if inf["corrected"]:
                break
        require(tried[-1]["corrected"], f"abft_matmul {prec}: no flip "
                f"corrected in place over {tried}")
        abft._poll_sdc_corrupt = flip_row
        try:
            wide, inf = abft.abft_matmul(a, b, precision=prec, device=DEVICE)
        finally:
            abft._poll_sdc_corrupt = real_poll
        require(inf["recomputed"] and not inf["corrected"]
                and torch.equal(wide, clean), f"abft_matmul {prec}: a "
                f"flipped row was not recomputed: {inf}")
        rec = {"tol": tol, "flips": tried, "row_recomputed": True}
        if DEVICE == "cuda":
            rec["abft_ms"] = cuda_event_ms(lambda: abft.abft_matmul(
                a, b, precision=prec, device=DEVICE), reps, warmup=1)
            rec["matmul_ms"] = cuda_event_ms(lambda: matmul(a, b, prec),
                                             reps, warmup=1)
        out[prec] = rec
    return out


def equal_nan(got, want) -> bool:
    """``torch.equal``, where NaN matches NaN: the campaigns corrupt
    operands with NaN and inf, which the kernels carry through."""
    import torch

    if not got.is_floating_point():
        return torch.equal(got, want)
    gn, wn = got.isnan(), want.isnan()
    return torch.equal(gn, wn) and torch.equal(got[~gn], want[~wn])


def strided_copy(t):
    """A copy of ``t`` at its strides (a view of a larger matrix keeps its
    leading dimension)."""
    import torch

    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


@contextlib.contextmanager
def kept_launches(kept: list):
    """Inside the block, the input of every call of the single-strip panel
    kernel, the batched panel kernel and the SpMV kernel is kept (a device
    copy at its strides) for ``check_kept_launches``."""
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.sparse import spmv as ks

    real = (blocked.panel_factor, kp.panel_factor_batched,
            ks.spmv_ell_kernel)

    def panel(p, kb=0, seg=None):
        kept.append(("panel", [strided_copy(p)], [kb]))
        return real[0](p, kb, seg)

    def batched(p, kb=0):
        kept.append(("batched", [strided_copy(p)], [kb]))
        return real[1](p, kb)

    def spmv(*args):
        kept.append(("spmv", [strided_copy(t) for t in args], []))
        return real[2](*args)

    blocked.panel_factor, kp.panel_factor_batched = panel, batched
    ks.spmv_ell_kernel = spmv
    try:
        yield kept
    finally:
        blocked.panel_factor, kp.panel_factor_batched = real[:2]
        ks.spmv_ell_kernel = real[2]


def check_kept_launches(kept: list, where: str) -> dict:
    """Each kept input launched again (the kernels are deterministic: the
    same input gives the same bits) and held bit for bit against its plain
    version: returns the calls and distinct shapes by kernel."""
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.sparse import spmv as ks

    fns = {"panel": (kp.panel_factor, kp.panel_factor_plain),
           "batched": (kp.panel_factor_batched, kp.panel_factor_batched_plain),
           "spmv": (ks.spmv_ell_kernel, ks.spmv_ell_plain)}
    shapes = {}
    for kind, inputs, kb in kept:
        launch, plain = fns[kind]
        got = launch(*map(strided_copy, inputs), *kb)
        want = plain(*inputs, *kb)
        if kind == "spmv":
            got, want = (got,), (want,)
        sig = tuple((tuple(t.shape), t.stride(), str(t.dtype))
                    for t in inputs)
        require(all(equal_nan(g, w) for g, w in zip(got, want)),
                f"{where}: the {kind} kernel at {sig} (kb={kb}) differs "
                f"from the plain version")
        shapes.setdefault(kind, []).append(sig)
    return {kind: {"calls": len(sigs), "shapes": len(set(sigs))}
            for kind, sigs in shapes.items()}


def resilience_campaigns(counted, work: str) -> dict:
    """Phase 10 (e): ``abftcheck`` at its defaults, ``chaos`` without the
    fleet phase (with its durable phase), and the service's abft lane."""
    import torch

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.resilience import abft, abftcheck, chaos, inject
    from gauss_tpu_torch.serve import ServeConfig, SolverServer
    from gauss_tpu_torch.verify import checks

    out = {}
    # Kernel 1 at the campaigns' strips (their panel, a width no earlier
    # phase launches) and at the abft service's n: one factorization at
    # each size, every launch held against its plain version.
    rng = np.random.default_rng(SEED + 30)
    out["checked_launches"] = {}
    for n, panel in ([(m, RES_CAMPAIGN_PANEL) for m in sorted(
            {*abftcheck.LU_SIZES, *chaos.SOLVER_SIZES})]
            + [(RES_SERVE_N, blocked.auto_panel(RES_SERVE_N))]):
        x = torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32,
                            device=torch.device(DEVICE))
        out["checked_launches"][f"n={n}, panel {panel}"] = \
            checked_abft_factor(x, panel, blocked.CHUNK_DEFAULT)
    del x
    # The campaigns' own launches: each input kept and, after them, held
    # against its plain version; every launch they made went through the
    # recorder.
    kept, runs = [], {}
    argv = {"abftcheck": (abftcheck.main, RES_ABFTCHECK_ARGS),
            "chaos": (chaos.main, ("--no-fleet", "--tmpdir", work,
                                   *RES_CHAOS_ARGS))}
    with kept_launches(kept):
        for name, (main, args) in argv.items():
            path = os.path.join(work, f"{name}.json")
            t0 = time.perf_counter()
            rc, got = counted(lambda: main(
                ["--device", DEVICE, "--summary-json", path, *args]))
            with open(path) as f:
                runs[name] = rc, round(time.perf_counter() - t0, 3), got, \
                    json.load(f)
    held = check_kept_launches(kept, "abftcheck and chaos")
    launched = sum(sum(got.values()) for _, _, got, _ in runs.values())
    require(DEVICE != "cuda" or launched == sum(
        k["calls"] for k in held.values()), f"abftcheck and chaos: "
        f"{launched} kernel launches, {held} through the recorder")
    out["held"] = held
    rc, wall, _, summ = runs["abftcheck"]
    sdc = summ["sdc"]
    require(rc == 0 and summ["invariant_ok"] and sdc["detect_rate"] == 1.0
            and sdc["bit_identity_failures"] == 0 and sdc["missed"] == 0
            and summ["identity"]["bit_identical"],
            f"abftcheck exited {rc}: {summ}")
    out["abftcheck"] = {"rc": rc, "wall_s": wall, "cases": sdc["cases"],
                        "injected": sdc["injected"],
                        "replayed": sdc["replayed"],
                        "escalated": sdc["escalated"],
                        "mean_detect_latency_s":
                            sdc["mean_detect_latency_s"],
                        "identity": summ["identity"],
                        "matmul": summ["matmul"]}
    rc, wall, _, summ = runs["chaos"]
    dur = summ["durable"]
    require(rc == 0 and summ["invariant_ok"]
            and summ["solver"]["counts"]["silent_wrong"] == 0
            and dur.get("crashes") == 4 and dur["violations"] == 0,
            f"chaos exited {rc}: {summ}")
    out["chaos"] = {"rc": rc, "wall_s": wall, "injected": summ["injected"],
                    "solver": summ["solver"]["counts"],
                    "serve": summ["serve"].get("counts"),
                    "durable": {k: dur[k] for k in ("crashes", "admitted",
                                                    "violations")},
                    "sdc_detect_rate": summ["sdc"].get("detect_rate")}
    # The service's abft lane: n=RES_SERVE_N requests past the ladder top.
    n = RES_SERVE_N
    cfg = ServeConfig(ladder=SERVE_LADDER, max_batch=SERVE_BATCH,
                      refine_steps=SERVE_REFINE, verify_gate=GATE, abft=True,
                      device=DEVICE)
    systems = [dominant_system(n, SEED + 20 + k)
               for k in range(RES_SERVE_REQUESTS + 1)]
    plan = inject.FaultPlan([inject.FaultSpec(
        site=abft.SITE_LU, kind="sdc_bitflip", max_triggers=1, skip=1)],
        seed=2)

    def serve():
        results = []
        with obs.run() as rec, SolverServer(cfg) as srv:
            for a, b in systems[:-1]:
                results.append(srv.solve(a, b, timeout=900))
            with inject.plan(plan):
                results.append(srv.solve(*systems[-1], timeout=900))
        return results, rec.events

    t0 = time.perf_counter()
    (results, events), got = counted(serve)
    wall = time.perf_counter() - t0
    routes = [e for e in events if e["type"] == "route"]
    rels = [checks.residual_norm(a, r.x, b, relative=True)
            for (a, b), r in zip(systems, results)]
    require(all(r.ok and r.lane == "handoff" for r in results)
            and max(rels) <= GATE and len(routes) == len(systems)
            and all(e["lane"] == "abft" for e in routes)
            and [r.sdc_detected for r in results]
            == [False] * RES_SERVE_REQUESTS + [True],
            f"abft service: {[(r.status, r.lane, r.sdc_detected) for r in results]}, "
            f"residuals {rels}, routes {routes}")
    panel, chunk = blocked.auto_panel(n), blocked.CHUNK_DEFAULT
    base = abft_plan(n, panel, chunk)
    want = (launch_counts(base * len(systems)
                         + abft_plan(n, panel, chunk, (1,))[len(base):])
            if DEVICE == "cuda" else {})
    require(got == want, f"abft service: launches by route {got}, the plan "
            f"says {want}")
    out["serve"] = {"n": n, "requests": len(systems), "wall_s": round(wall,
                                                                       3),
                    "rel_residuals": rels, "sdc_detected": [
                        r.sdc_detected for r in results], "launches": got}
    return out


def phase_resilience(reps: int):
    """The checksum-carrying and checkpointed factorizations, the ABFT
    matmul and the campaigns on the card (module docstring, phase 10):
    returns the launch counts of its counted calls and its figures."""
    import tempfile

    import torch

    from gauss_tpu_torch.kernels import _build

    t_phase = time.perf_counter()
    on_card = DEVICE == "cuda"
    card = smi_line() if on_card else "cpu"
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    counts = {}

    def counted(fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after: its value and its launches, both added to the phase's
        counts. A kernel whose key does not name its route is counted by
        route (``_build.ROUTE_LAUNCHES``), every other by its key."""
        _build.reset_launches()
        val = fn()
        sync()
        got = {k: v for k, v in _build.LAUNCHES.items() if v and not any(
            r.startswith(k + "/") for r in _build.ROUTE_LAUNCHES)}
        got.update(_build.ROUTE_LAUNCHES)
        for k, v in _build.LAUNCHES.items():
            launches[k] += v
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        return val, got

    out = {"card": card}
    n, panel, chunk = RES_LU
    a = torch.as_tensor(np.random.default_rng(SEED + n).standard_normal(
        (n, n)), dtype=torch.float32, device=torch.device(DEVICE))
    work = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    try:
        lu = out["lu"] = resilience_lu(counted, a, n, panel, chunk)
        print(f"phase 10 (a): lu_factor_abft n={n}, panel {panel}, chunk "
              f"{chunk}: kernel-1 launches {lu['launches']}, bits == "
              f"chunked abft=True == pallas; checked launches "
              f"{lu['checked_launches']}; clean err/tol max "
              f"{lu['max_group_err_over_tol']:.3e} (final "
              f"{lu['final_err_over_tol']:.3e} of 4 tol); transient flip "
              f"{lu['transient']}; last group {lu['last_group']}; "
              f"persistent {lu['persistent']}; internal residual "
              f"{lu['internal_residual']:.3e}"
              + (f"; factor {lu['factor_ms']:.3f} ms (median of 3), chunked "
                 f"{lu['chunked_ms']:.3f}, chunked abft=True "
                 f"{lu['chunked_abft_ms']:.3f}, chunked pallas "
                 f"{lu['chunked_pallas_ms']:.3f}" if on_card else "")
              + f" [{card}]")
        ck = out["checkpoint"] = resilience_checkpoint(counted, a, n, panel,
                                                       chunk, work)
        print(f"phase 10 (b): checkpointed n={n}: bits == chunked; launches "
              f"{ck['launches']}; saves [s, bytes] {ck['saves_s_bytes']}; "
              f"wall {ck['wall_ms']:.1f} ms"
              + (f" (again {ck['second_wall_ms']:.1f})" if on_card else "")
              + f" against the chunked factor's "
              f"{lu.get('chunked_ms', float('nan')):.3f} ms; killed child "
              f"{ck['kill']} resumed bit for bit [{card}]")
        del a
        if on_card:
            torch.cuda.empty_cache()
        out["cholesky"] = [resilience_cholesky(m, 3) for m in RES_CHOL]
        for rec in out["cholesky"]:
            print(f"phase 10 (c): cholesky_factor_abft n={rec['n']}: bits == "
                  f"flat abft=False; err/tol {rec['max_group_err_over_tol']:.3e} "
                  f"(final {rec['final_err_over_tol']:.3e}); transient "
                  f"{rec['transient']} replayed bit for bit"
                  + (f"; abft {rec['abft_ms']:.3f} ms, flat "
                     f"{rec['flat_ms']:.3f}, unrolled {rec['unrolled_ms']:.3f}"
                     if on_card else "") + f" [{card}]")
        out["matmul"] = resilience_matmul(RES_MM, reps)
        for prec, rec in out["matmul"].items():
            print(f"phase 10 (d): abft_matmul ({RES_MM},)^3 {prec}: clean; "
                  f"flips {rec['flips']}; a flipped row recomputed"
                  + (f"; {rec['abft_ms']:.4f} ms against core.matmul "
                     f"{rec['matmul_ms']:.4f}" if on_card else "")
                  + f" [{card}]")
        camp = out["campaigns"] = resilience_campaigns(counted, work)
        print(f"phase 10 (e): kernel 1 checked at "
              f"{camp['checked_launches']}; the campaigns' calls held by "
              f"shape {camp['held']}; abftcheck {camp['abftcheck']}; chaos "
              f"{camp['chaos']}; service {camp['serve']} [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = counts
    out["wall_s"] = round(time.perf_counter() - t_phase, 3)
    print(f"phase 10: launches {counts}; {out['wall_s']} s wall "
          f"[{card}]")
    print(json.dumps({"resilience": out}, default=str))
    return launches, out


def big_system(n: int, seed: int, rows: int = 4096):
    """A float32 system of order ``n`` made from ``seed`` in row blocks of
    ``rows``, each block from its own generator (``SeedSequence((seed, n,
    block))``) on a thread pool, never a float64 copy of the matrix; the
    diagonal dominance of ``outofcore.check._seeded_system``."""
    from concurrent.futures import ThreadPoolExecutor

    a = np.empty((n, n), dtype=np.float32)

    def fill(i):
        r0, r1 = i * rows, min(n, (i + 1) * rows)
        g = np.random.default_rng(np.random.SeedSequence((seed, n, i)))
        g.standard_normal(out=a[r0:r1], dtype=np.float32)
        idx = np.arange(r0, r1)
        a[idx, idx] += np.float32(n)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        list(ex.map(fill, range(-(-n // rows))))
    b = np.random.default_rng(np.random.SeedSequence((seed, n))) \
        .standard_normal(n).astype(np.float32)
    return a, b


def ooc_plan(n: int, panel: int, chunk: int, first_group: int = 0,
             unfused: bool = False):
    """The kernel launches of one streamed factorization: the in-core
    chunked form's plan (the group step is ``_factor_group`` on the
    group's own block, with the same heights and widths), from group
    ``first_group`` on."""
    return [x for x in factor_plan(n, panel, chunk, unfused=unfused)
            if x[2] <= -(-n // panel) * panel - first_group * panel]


def ooc_held(plan, first: int = 0) -> set:
    """The places in ``plan`` of the launches phase 11 holds against the
    plain version: the first ``first``, and each key and route's tallest
    and shortest launch."""
    ends = {}
    for i, (key, route, h) in enumerate(plan):
        tall, short = ends.setdefault((key, route), (i, i))
        ends[key, route] = (tall if plan[tall][2] >= h else i,
                            short if plan[short][2] <= h else i)
    return set(range(first)).union(*ends.values())


def held_counts(plan, held) -> dict:
    """``checked_launches``'s counts by kind and phase-A route of the
    launches of ``plan`` at the places ``held``."""
    out = {}
    for i in held:
        key, route, _ = plan[i]
        kind = "fused" if key.startswith("panel_trailing_fused") else "panel"
        for k, hit in ((kind, True), (kind + " grid", route == "grid"),
                       (kind + " one-block", route == "block")):
            if hit:
                out[k] = out.get(k, 0) + 1
    return out


def held_ooc_launches(plan, held, timing: dict, fn):
    """``fn()`` under ``checked_launches`` with the launches at the places
    ``held`` of ``plan`` kept and held against their plain version after
    it, every launch timed into ``timing``: returns ``fn``'s value and
    the held counts, required equal to the plan's."""
    seen = {}
    with checked_launches(seen, held=held, deferred=True, timing=timing):
        val = fn()
    got = {k: v for k, v in seen.items() if k in (
        "panel", "fused", "panel grid", "fused grid", "panel one-block",
        "fused one-block")}
    want = held_counts(plan, held)
    require(got == want, f"held launches {got}, the plan's places give "
            f"{want}")
    return val, got


def planned_tile_fault(n: int, panel: int, chunk: int, ct: int,
                       spec: str) -> tuple:
    """The (group, column) an ``outofcore.tile`` nan plan poisons in a
    streamed factorization: the plan's polls replayed on zero tiles of
    the factorization's tile shapes, in its order, up to the tile the
    plan corrupts; the group is its first panel (the JAX package's
    ``SDCDetectedError.group``), the column the first poisoned one."""
    from gauss_tpu_torch.resilience import inject

    npad = -(-n // panel) * panel
    nb = npad // panel
    with inject.plan(inject.FaultPlan.parse(spec)):
        for g0 in range(0, nb, chunk):
            gs = g0 * panel
            w = min(chunk, nb - g0) * panel
            for c0 in range(gs + w, npad, ct):
                tile = np.zeros((npad - gs, min(ct, npad - c0)), np.float32)
                got = inject.corrupt_operand("outofcore.tile", tile)
                if got is not tile:
                    return g0, c0 + int(np.isnan(got).any(axis=0).argmax())
    raise SystemExit(f"chip_smoke FAILED: the plan {spec} poisons no tile")


def ooc_backward_err(a, m, perm, cols: int = 4096) -> float:
    """``||A[perm] - LU||_F / ||A||_F`` in float64 on the card, by column
    blocks of U (``backward_err``'s at sizes where its whole float64
    products do not fit beside each other): ``a`` the unpadded operand
    (numpy, float32), ``m`` the packed factor, ``perm`` its row order."""
    import torch

    dev = torch.device(DEVICE)
    n, npad = a.shape[0], m.shape[0]
    ap = torch.eye(npad, dtype=torch.float32, device=dev)
    ap[:n, :n] = torch.as_tensor(a, device=dev)
    ap = ap[torch.as_tensor(perm, device=dev)]
    m = torch.as_tensor(m, device=dev)
    low = torch.tril(m, -1).double()
    low.diagonal().fill_(1.0)
    num = den = 0.0
    for c0 in range(0, npad, cols):
        c1 = min(npad, c0 + cols)
        r = ap[:, c0:c1].double() - low @ torch.triu(m[:, c0:c1],
                                                   -c0).double()
        num += float((r * r).sum())
        den += float((ap[:, c0:c1].double() ** 2).sum())
    del low, ap
    return (num / den) ** 0.5


def ooc_streamed(a, b, ct: int) -> dict:
    """Phase 11 (b)'s streamed factorization, then its streamed solve
    with ``solve_outofcore``'s refinement (3 steps), each timed: the
    factor, the solution and both ``StreamStats``."""
    from gauss_tpu_torch import outofcore
    from gauss_tpu_torch.outofcore import stream

    t0 = time.perf_counter()
    fac = outofcore.lu_factor_outofcore(a, ct=ct, device=DEVICE,
                                        alloc_peak=True)
    sync()
    factor_s = time.perf_counter() - t0
    fstats = outofcore.last_stream_stats()
    b64 = np.asarray(b, dtype=np.float64)[:, None]
    t0 = time.perf_counter()
    x = outofcore.lu_solve_outofcore(fac, b64, alloc_peak=True)
    sstats = [outofcore.last_stream_stats()]
    for _ in range(3):
        d = outofcore.lu_solve_outofcore(
            fac, stream._residual_chunked(a, x, b64), alloc_peak=True)
        x = x + d
        sstats.append(outofcore.last_stream_stats())
    solve_s = time.perf_counter() - t0
    return {"fac": fac, "x": x[:, 0], "factor_s": factor_s,
            "solve_s": solve_s, "stats": fstats, "solve_stats": sstats}


def stream_figures(st) -> dict:
    """A StreamStats record's figures, with the GB moved each way and
    their rates over the copies' device seconds."""
    d = st.to_dict()
    for way in ("h2d", "d2h"):
        gb = getattr(st, f"bytes_{way}") / 1e9
        dev_s = getattr(st, f"{way}_device_s")
        d[f"{way}_gb"] = round(gb, 3)
        d[f"{way}_gb_s"] = round(gb / dev_s, 2) if dev_s else None
    return d


def ooc_check_cli(counted, work: str) -> dict:
    """Phase 11 (a): ``python -m gauss_tpu_torch.outofcore.check`` at its
    defaults (smoke n=2048, chunk 4, ct 256; routing n=192), in this
    process, its stream and summary read back."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.outofcore import check
    from gauss_tpu_torch.tune import space

    metrics = os.path.join(work, "ooc.jsonl")
    summary = os.path.join(work, "ooc.json")
    argv = ["--metrics-out", metrics, "--summary-json", summary,
            "--device", DEVICE, *OOC_CHECK_ARGS]
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc, got = counted(lambda: check.main(argv))
    doc = json.load(open(summary))
    smoke, routing = doc["smoke"], doc["routing"]
    routes = [e for e in obs.read_events(metrics) if e["type"] == "route"]
    require(rc == 0 and doc["ok"], f"outofcore.check exited {rc}: "
            f"{buf.getvalue()[-2000:]}")
    require(smoke["verified"] and smoke["rel_residual"] <= GATE
            and smoke["tiles"] >= 2 and smoke["peak_device_frac"] < 0.5,
            f"outofcore.check smoke leg {smoke}")
    require(routing["verified"] and [r["lane"] for r in routes] == [
        "outofcore"], f"outofcore.check routing leg {routing}, routes "
            f"{routes}")
    args = check.build_parser().parse_args(argv)
    sp = blocked.auto_panel(args.n)
    rp = blocked.auto_panel(args.routing_n)
    want = (launch_counts(ooc_plan(args.n, args.panel or sp, args.chunk)
                          + ooc_plan(args.routing_n, rp,
                                     space.OUTOFCORE_CHUNK_SEED))
            if DEVICE == "cuda" else {})
    require(got == want, f"outofcore.check: launches {got}, the plan says "
            f"{want}")
    return {"smoke": {k: smoke[k] for k in (
        "n", "panel", "chunk", "ct", "s_per_solve", "rel_residual", "tiles",
        "groups", "peak_device_frac", "alloc_peak_device_frac",
        "overlap_fraction", "h2d_device_s", "d2h_device_s",
        "compute_device_s")},
            "routing": {k: routing[k] for k in ("n", "budget",
                                                "rel_residual")},
            "route_event": {k: routes[0][k] for k in (
                "lane", "est_bytes", "budget", "itemsize")},
            "launches": got}


def ooc_giant(counted) -> dict:
    """Phase 11 (b): the JAX package's acceptance scale, streamed at its
    tile width, against the in-core chunked factor and ``lu_factor``."""
    import torch

    from gauss_tpu_torch import outofcore
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.outofcore import check
    from gauss_tpu_torch.tune import space

    n, ct = OOC_N, OOC_CT
    t0 = time.perf_counter()
    a, b = check._seeded_system(n, SEED)
    gen_s = time.perf_counter() - t0
    panel, chunk = blocked.auto_panel(n), space.OUTOFCORE_CHUNK_SEED
    plan = ooc_plan(n, panel, chunk)
    first = len([x for x in plan if x[2] > n - chunk * panel])
    # The figures come from a run with nothing around its launches; then
    # a second streamed factor holds the first group's launches and each
    # route's tallest and shortest against the plain version, and times
    # every launch.
    res, got = counted(lambda: ooc_streamed(a, b, ct))
    on_card = DEVICE == "cuda"
    require(got == (launch_counts(plan) if on_card else {}),
            f"streamed n={n}: launches {got}, the plan says "
            f"{launch_counts(plan)}")
    log = {}
    (fac2, got2), held = held_ooc_launches(
        plan, ooc_held(plan, first), log, lambda: counted(
            lambda: outofcore.lu_factor_outofcore(a, ct=ct, device=DEVICE)))
    require(got2 == got and bits_equal(fac2, res["fac"], OOC_FIELDS),
            f"streamed n={n}: the held factor (launches {got2}) differs from "
            f"the timed one's")
    del fac2
    if on_card:
        torch.cuda.empty_cache()
    fac, st = res["fac"], res["stats"]
    rel = check._rel_residual(a, res["x"], b)
    workset = 3 * n * n * 4
    peak = max([st.peak_device_bytes] + [s.peak_device_bytes
                                         for s in res["solve_stats"]])
    alloc = max([st.alloc_peak_device_bytes] + [
        s.alloc_peak_device_bytes for s in res["solve_stats"]])
    require(rel <= GATE, f"streamed n={n}: rel residual {rel}")
    require(st.tiles >= 2 and peak < 0.5 * workset and alloc < 0.5 * workset,
            f"streamed n={n}: tiles {st.tiles}, peak {peak} (ledger), "
            f"{alloc} (allocator) of {workset}")
    out = {"n": n, "panel": panel, "chunk": chunk, "ct": ct,
           "gen_s": round(gen_s, 3), "rel_residual": rel,
           "factor_s": round(res["factor_s"], 3),
           "solve_s": round(res["solve_s"], 3),
           "peak_frac": round(peak / workset, 4),
           "alloc_peak_frac": round(alloc / workset, 4),
           "stream": stream_figures(st),
           "solve_stream": stream_figures(res["solve_stats"][0]),
           "launches": log, "held": held}
    # The in-core chunked factor at the same panel and chunk, and
    # lu_factor, on the card: pivots, bits, backward errors, times.
    dev = torch.device(DEVICE)
    a_dev = torch.as_tensor(a, device=dev)
    t0 = time.perf_counter()
    ref = blocked.lu_factor_blocked_chunked(a_dev, panel=panel, chunk=chunk,
                                            device=dev)
    sync()
    out["incore_factor_s"] = round(time.perf_counter() - t0, 4)
    require(torch.equal(fac.perm, ref.perm.cpu()), f"streamed n={n}: the "
            f"pivots differ from the in-core chunked factor's")
    diffs = {f: float((getattr(fac, f) - getattr(ref, f).cpu()).abs().max())
             for f in ("m", "linv", "uinv")}
    out["bits_equal_incore"] = all(v == 0.0 for v in diffs.values())
    out["max_diff_incore"] = diffs
    be = {"streamed": ooc_backward_err(a, fac.m, fac.perm),
          "incore": ooc_backward_err(a, ref.m, ref.perm)}
    del ref
    if on_card:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lu, piv = torch.linalg.lu_factor(a_dev)
        sync()
        out["lu_factor_s"] = round(time.perf_counter() - t0, 4)
        be["lu_factor"] = ooc_backward_err(a, lu, lu_factor_perm(piv))
        del lu, piv
        for k in ("streamed", "incore"):
            require(be[k] <= BACKWARD_RATIO * be["lu_factor"],
                    f"n={n}: the {k} factor's backward error {be[k]} > "
                    f"{BACKWARD_RATIO} x lu_factor's {be['lu_factor']}")
    out["backward_err"] = be
    del a_dev
    if on_card:
        torch.cuda.empty_cache()
    return out


def ooc_past_budget(counted, work: str) -> dict:
    """Phase 11 (c): ``solve_handoff(a, b)``, no budget and no engine, at
    the smallest panel multiple past the card's budget."""
    from gauss_tpu_torch import obs, outofcore
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.outofcore import check
    from gauss_tpu_torch.tune import space

    n = OOC_BIG_N
    t0 = time.perf_counter()
    a, b = big_system(n, SEED)
    gen_s = time.perf_counter() - t0
    stream_path = os.path.join(work, "handoff.jsonl")
    panel = blocked.auto_panel(n)
    plan = ooc_plan(n, panel, space.OUTOFCORE_CHUNK_SEED)

    def call():
        t0 = time.perf_counter()
        with obs.run(metrics_out=stream_path, tool="chip_smoke"):
            val = counted(lambda: blocked.solve_handoff(a, b, device=DEVICE))
        return val, time.perf_counter() - t0

    # Each route's tallest and shortest launch keeps its input and
    # outputs, held against the plain version after the call; the wall
    # holds those copies and the events around every launch.
    log = {}
    ((x, got), wall), held = held_ooc_launches(plan, ooc_held(plan), log,
                                               call)
    routes = [e for e in obs.read_events(stream_path)
              if e["type"] == "route"]
    require([r["lane"] for r in routes] == ["outofcore"],
            f"handoff n={n}: routes {routes}")
    budget = blocked.device_memory_budget(DEVICE)
    require(routes[0]["budget"] == budget and routes[0]["est_bytes"]
            == 3 * n * n * 4 > budget, f"handoff n={n}: route {routes[0]}")
    st = outofcore.last_stream_stats()
    rel = check._rel_residual(a, x, b)
    require(rel <= GATE, f"handoff n={n}: rel residual {rel}")
    require(st.panel == panel, f"handoff n={n}: panel {st.panel}, the plan "
            f"{panel}")
    require(got == (launch_counts(plan) if DEVICE == "cuda" else {}),
            f"handoff n={n}: launches {got}, the plan says "
            f"{launch_counts(plan)}")
    one_block = {k: v for k, v in log.items()
                 if k in ("panel_factor", "panel_trailing_fused/block")}
    return {"n": n, "gen_s": round(gen_s, 3), "wall_s": round(wall, 3),
            "rel_residual": rel, "route": {k: routes[0][k] for k in (
                "lane", "est_bytes", "budget", "itemsize")},
            "host_budget": outofcore.host_memory_budget(),
            "stream": stream_figures(st), "launches": log,
            "one_block": one_block, "held": held}


def ooc_riders(counted, work: str) -> dict:
    """Phase 11 (d): the checksum rider (clean, and a tile corruption
    localized), and a child killed at ``outofcore.group`` resumed from
    its checkpoint bit for bit, at phase 6/10's n=8192 cell."""
    import torch

    from gauss_tpu_torch import outofcore
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.resilience import checkpoint as ckpt
    from gauss_tpu_torch.resilience import inject

    n, panel, chunk, ct = OOC_RIDERS
    on_card = DEVICE == "cuda"
    a = np.random.default_rng(SEED + n).standard_normal((n, n)).astype(
        np.float32)
    kw = dict(panel=panel, chunk=chunk, ct=ct, device=DEVICE)
    fa, got = counted(lambda: outofcore.lu_factor_outofcore(a, abft=True,
                                                            **kw))
    uplan = ooc_plan(n, panel, chunk, unfused=True)
    require(got == (launch_counts(uplan) if on_card else {}),
            f"abft n={n}: launches {got}")
    npad = fa.m.shape[0]
    crow0 = np.eye(npad, dtype=np.float32)
    crow0[:n, :n] = a
    tol = blocked.abft_default_tol(npad, torch.float32,
                                   float(np.abs(crow0.sum(0)).max()))
    clean = float(fa.abft_err.max()) / tol
    require(clean < 1.0, f"abft n={n}: a clean run's mismatch {clean} of tol")
    ref = blocked.lu_factor_blocked_chunked(a, panel=panel, chunk=chunk,
                                            abft=True, device=DEVICE)
    bits_abft = all(torch.equal(getattr(fa, f), getattr(ref, f).cpu())
                    for f in OOC_FIELDS)
    del ref
    spec = f"outofcore.tile=nan:seed=7:skip={OOC_TILE_SKIP}"
    want = planned_tile_fault(n, panel, chunk, ct, spec)
    err = None
    with inject.plan(inject.FaultPlan.parse(spec)):
        try:
            counted(lambda: outofcore.lu_factor_outofcore(a, abft=True, **kw))
        except outofcore.SDCDetectedError as e:
            err = e
    require(err is not None and (err.group, err.col) == want,
            f"tile fault {spec}: raised {err!r} at "
            f"{getattr(err, 'group', None), getattr(err, 'col', None)}, "
            f"planned {want}")
    full, got_full = counted(lambda: outofcore.lu_factor_outofcore(a, **kw))
    kpath = os.path.join(work, "ooc_killed.npz")
    code = (f"import json, sys; sys.path.insert(0, {REPO!r}); "
            f"import numpy as np; "
            f"from gauss_tpu_torch.kernels import _build; "
            f"print(json.dumps(_build.build_all() if {on_card} else {{}}), "
            f"flush=True); "
            f"from gauss_tpu_torch import outofcore; "
            f"a = np.random.default_rng({SEED + n}).standard_normal(({n}, "
            f"{n})).astype(np.float32); "
            f"outofcore.lu_factor_outofcore(a, panel={panel}, chunk={chunk}, "
            f"ct={ct}, device={DEVICE!r}, checkpoint_path={kpath!r}); "
            f"print('finished')")
    env = {**os.environ,
           "GAUSS_FAULTS": f"outofcore.group=kill:skip={OOC_KILL_SKIP}"}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    require(r.returncode == inject.KILL_EXIT_CODE
            and "finished" not in r.stdout, f"the killed child exited "
            f"{r.returncode}: {(r.stdout + r.stderr)[-2000:]}")
    built = json.loads(r.stdout.splitlines()[0])
    require(not any(built.values()), f"the child rebuilt kernels: {built}")
    done = ckpt.load_state(kpath)["meta"]["next_group"]
    require(done == OOC_KILL_SKIP * chunk, f"the killed child saved "
            f"next_group {done}")
    resumed, got_res = counted(lambda: outofcore.lu_factor_outofcore(
        a, checkpoint_path=kpath, **kw))
    require(bits_equal(resumed, full, OOC_FIELDS)
            and not os.path.exists(kpath), f"resumed n={n} != the "
            f"uninterrupted streamed factor bit for bit")
    require(got_res == (launch_counts(ooc_plan(n, panel, chunk, done))
                        if on_card else {}),
            f"resume from group {done}: launches {got_res}")
    return {"n": n, "panel": panel, "chunk": chunk, "ct": ct,
            "clean_err_over_tol": clean, "tol": tol,
            "bits_equal_incore_abft": bits_abft,
            "tile_fault": {"spec": spec, "group": err.group, "col": err.col,
                           "err": err.err},
            "kill": {"next_group": done, "child_s": round(child_s, 3),
                     "child_build_s": built, "resume_launches": got_res}}


def ooc_ladder_service(counted) -> dict:
    """Phase 11 (e): the ``outofcore`` rung, then the service's
    out-of-core handoff lane on one n=6000 request."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.resilience import recover
    from gauss_tpu_torch.serve.admission import ServeConfig
    from gauss_tpu_torch.serve.server import SolverServer
    from gauss_tpu_torch.tune import space

    on_card = DEVICE == "cuda"
    chunk = space.OUTOFCORE_CHUNK_SEED
    n = OOC_LADDER_N
    a, b = dominant_system(n)
    t0 = time.perf_counter()
    rr, got = counted(lambda: recover.solve_resilient(
        a, b, rungs=("outofcore", "numpy_f64"), device=DEVICE))
    ladder_s = time.perf_counter() - t0
    require(rr.rung == "outofcore" and rr.rung_index == 0
            and rr.rel_residual <= GATE, f"ladder n={n}: served by "
            f"{rr.rung} ({rr.escalations}), residual {rr.rel_residual}")
    require(got == (launch_counts(ooc_plan(n, blocked.auto_panel(n), chunk))
                    if on_card else {}), f"ladder n={n}: launches {got}")
    ns = OOC_SERVE_N
    a, b = dominant_system(ns)
    budget = 3 * ns * ns * 4 - 1
    cfg = ServeConfig(ladder=SERVE_LADDER, outofcore_handoff=True,
                      device_budget=budget, verify_gate=GATE, device=DEVICE)
    with obs.run() as rec:
        def serve():
            with SolverServer(cfg) as srv:
                return srv.solve(a, b)
        res, got_s = counted(serve)
    routes = [e for e in rec.events if e["type"] == "route"
              and e.get("tool") == "serve_handoff"]
    rel = float(np.linalg.norm(a @ res.x - b) / np.linalg.norm(b))
    require(res.ok and res.lane == "outofcore" and rel <= GATE
            and [r["lane"] for r in routes] == ["outofcore"],
            f"service n={ns}: {res.status} on lane {res.lane}, residual "
            f"{rel}, routes {routes}")
    require(got_s == (launch_counts(ooc_plan(ns, blocked.auto_panel(ns),
                                             chunk)) if on_card else {}),
            f"service n={ns}: launches {got_s}")
    return {"ladder": {"n": n, "rung": rr.rung, "s": round(ladder_s, 3),
                       "rel_residual": rr.rel_residual, "launches": got},
            "service": {"n": ns, "lane": res.lane, "rel_residual": rel,
                        "budget": budget, "launches": got_s}}


def phase_outofcore():
    """The host-streamed out-of-core solve on the card (module docstring,
    phase 11): returns the launch counts of its counted calls and its
    figures."""
    import tempfile

    import torch

    from gauss_tpu_torch import outofcore
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.kernels import _build

    t_phase = time.perf_counter()
    on_card = DEVICE == "cuda"
    card = smi_line() if on_card else "cpu"
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    counts = {}

    def counted(fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after (as phase 10 counts them)."""
        _build.reset_launches()
        val = fn()
        sync()
        got = {k: v for k, v in _build.LAUNCHES.items() if v and not any(
            r.startswith(k + "/") for r in _build.ROUTE_LAUNCHES)}
        got.update(_build.ROUTE_LAUNCHES)
        for k, v in _build.LAUNCHES.items():
            launches[k] += v
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        return val, got

    out = {"card": card}
    # Step 0: the host's and the card's memory, and the cost of pinning.
    step0 = {"host_memory_budget": outofcore.host_memory_budget(),
             "device_memory_budget": blocked.device_memory_budget(DEVICE),
             "big_n_fits": outofcore.outofcore_fits(OOC_BIG_N,
                                                    device=DEVICE)}
    if on_card:
        from gauss_tpu_torch.outofcore import stream

        step0["mem_get_info"] = list(torch.cuda.mem_get_info())
        t0 = time.perf_counter()
        pinned = stream.pinned_empty((OOC_PIN_BYTES,), torch.uint8)
        step0["pin_s"] = round(time.perf_counter() - t0, 4)
        step0["pin_bytes"] = OOC_PIN_BYTES
        # The link's rate on one contiguous pinned copy each way, beside
        # which the stream's strided tile copies read.
        pinned.fill_(1)
        dev_buf = torch.empty_like(pinned, device=DEVICE)
        for way, dst, src in (("h2d", dev_buf, pinned),
                              ("d2h", pinned, dev_buf)):
            ms = call_ms(lambda: dst.copy_(src, non_blocking=True), 3)
            step0[f"{way}_contiguous_gb_s"] = round(
                OOC_PIN_BYTES / ms / 1e6, 2)
        del pinned, dev_buf
        torch.cuda.empty_cache()
    out["step0"] = step0
    print(f"phase 11 step 0: {json.dumps(step0)} [{card}]")
    require(step0["big_n_fits"], f"the host cannot admit n={OOC_BIG_N}: "
            f"{step0}")
    work = tempfile.mkdtemp(prefix="chip_smoke_outofcore_")
    try:
        t0 = time.perf_counter()
        cli = out["check"] = ooc_check_cli(counted, work)
        cli["wall_s"] = round(time.perf_counter() - t0, 3)
        print(f"phase 11 (a): outofcore.check: smoke {cli['smoke']}; "
              f"routing {cli['routing']}, route {cli['route_event']}; "
              f"launches {cli['launches']}; {cli['wall_s']} s [{card}]")
        t0 = time.perf_counter()
        g = out["giant"] = ooc_giant(counted)
        g["wall_s"] = round(time.perf_counter() - t0, 3)
        print(f"phase 11 (b): streamed n={g['n']} (panel {g['panel']}, "
              f"chunk {g['chunk']}, ct {g['ct']}): factor {g['factor_s']} s, "
              f"solve + 3 refinements {g['solve_s']} s (in-core chunked "
              f"factor {g.get('incore_factor_s')} s, lu_factor "
              f"{g.get('lu_factor_s')} s); residual {g['rel_residual']:.3e}; "
              f"peak {g['peak_frac']} (ledger), {g['alloc_peak_frac']} "
              f"(allocator) of 3n^2*4; bits == in-core: "
              f"{g['bits_equal_incore']} (max diff {g['max_diff_incore']}); "
              f"backward err {g['backward_err']}; stream {g['stream']}; "
              f"launches {g['launches']}; held {g['held']}; "
              f"{g['wall_s']} s wall [{card}]")
        t0 = time.perf_counter()
        big = out["past_budget"] = ooc_past_budget(counted, work)
        big["phase_wall_s"] = round(time.perf_counter() - t0, 3)
        print(f"phase 11 (c): solve_handoff n={big['n']}: route "
              f"{big['route']}; residual {big['rel_residual']:.3e}; "
              f"{big['wall_s']} s (matrix made in {big['gen_s']} s); stream "
              f"{big['stream']}; launches {big['launches']}; one-block "
              f"{big['one_block']} [{card}]")
        t0 = time.perf_counter()
        rid = out["riders"] = ooc_riders(counted, work)
        rid["wall_s"] = round(time.perf_counter() - t0, 3)
        print(f"phase 11 (d): n={rid['n']}, ct {rid['ct']}: abft clean "
              f"err/tol {rid['clean_err_over_tol']:.3e} (bits == in-core "
              f"abft: {rid['bits_equal_incore_abft']}); tile fault "
              f"{rid['tile_fault']}; killed child {rid['kill']} resumed bit "
              f"for bit; {rid['wall_s']} s [{card}]")
        t0 = time.perf_counter()
        ls = out["ladder_service"] = ooc_ladder_service(counted)
        ls["wall_s"] = round(time.perf_counter() - t0, 3)
        print(f"phase 11 (e): ladder {ls['ladder']}; service "
              f"{ls['service']}; {ls['wall_s']} s [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = counts
    out["wall_s"] = round(time.perf_counter() - t_phase, 3)
    print(f"phase 11: launches {counts}; {out['wall_s']} s wall [{card}]")
    print(json.dumps({"outofcore": out}, default=str))
    return launches, out


# --- Phase 12: the durable and network service ---------------------------


@contextlib.contextmanager
def held_batched_launches(seen: dict, thread=None):
    """Inside the block, every launch of the batched panel kernel (rows
    1c/1d) and of the batched fused kernel (rows 2c/2d) is held at once
    against its plain version on a copy of its input: the panel kernel bit
    for bit; the fused kernel's pivots and permutation bit for bit, and
    each member's panel and updated block within TOL of its scale (a
    bfloat16 member: ``bf16_block_check``). ``seen`` counts the held
    launches by key. Given ``thread``, only the launches made on it are
    held and counted; other threads launch as if outside the block.
    Non-finite values (a campaign's poisoned member) must sit where the
    plain version puts them, with the same value. A launch that differs
    is reported when the block ends, on the thread that opened it (the
    launches of a server's worker thread run on)."""
    import threading

    import torch

    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.kernels import panel_fused as kf

    real_pb, real_fb = kp.panel_factor_batched, kf.panel_trailing_fused_batched
    errors = []

    def check(cond, msg):
        if not cond:
            errors.append(msg)

    def finite_err(got, want):
        """max |got - want| over the finite entries; inf where the two
        differ in which entries are finite, or in a non-finite value."""
        gf, wf = torch.isfinite(got), torch.isfinite(want)
        if not (torch.equal(gf, wf) and equal_nan(got[~gf], want[~wf])):
            return float("inf")
        return float((got[gf] - want[wf]).abs().max()) if gf.any() else 0.0

    def count(key, x):
        key += "_bf16" if x.dtype == torch.bfloat16 else ""
        seen[key] = seen.get(key, 0) + 1

    def elsewhere():
        return thread is not None and threading.current_thread() is not thread

    def panel_batched(p, kb=0):
        if elsewhere():
            return real_pb(p, kb)
        x = p.clone()
        got = real_pb(p, kb)
        check(all(equal_nan(g, w) for g, w in zip(
            got, kp.panel_factor_batched_plain(x, kb))),
            f"a batched panel launch at {tuple(p.shape)} {p.dtype} "
            f"differs from the plain version")
        count("panel_factor_batched", p)
        return got

    def fused_batched(stack, col0, kbrow, *, panel, **kw):
        if elsewhere():
            return real_fb(stack, col0, kbrow, panel=panel, **kw)
        x = stack.clone()
        got = real_fb(stack, col0, kbrow, panel=panel, **kw)
        ref = kf.panel_trailing_fused_batched_plain(x, col0, kbrow,
                                                    panel=panel)
        where = (f"a batched fused launch at {tuple(stack.shape)} "
                 f"{stack.dtype}, col0={col0}")
        check(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]),
              f"{where}: pivots differ from the plain version")
        for i in range(stack.shape[0]):
            if stack.dtype == torch.bfloat16:
                try:
                    bf16_block_check(f"{where}, member {i}", stack[i], x[i],
                                     col0 + panel)
                except SystemExit as e:
                    errors.append(str(e))
                continue
            fin = torch.isfinite(x[i])
            scale = float(x[i][fin].abs().max()) if fin.any() else 0.0
            err = max(finite_err(stack[i], x[i]),
                      finite_err(got[0][i], ref[0][i]))
            check(err <= TOL * scale, f"{where}, member {i}: max |kernel "
                  f"- plain| {err} > {TOL} x {scale}")
        count("panel_trailing_fused_batched", stack)
        return got

    kp.panel_factor_batched = panel_batched
    kf.panel_trailing_fused_batched = fused_batched
    try:
        yield
    finally:
        kp.panel_factor_batched = real_pb
        kf.panel_trailing_fused_batched = real_fb
    require(not errors, "; ".join(errors[:3]))


def net_campaign(work: str, card: str) -> dict:
    """Phase 12 (a): the durable campaign's CLI in this process, its
    overhead leg left to ``net_overhead``, every batched launch of its
    in-process recovery cases held at once. ``phase_net`` runs it in a
    process of its own."""
    from gauss_tpu_torch.serve import durablecheck

    held = {}
    real_case = durablecheck.run_recovery_case

    def held_case(*args, **kw):
        with held_batched_launches(held):
            return real_case(*args, **kw)

    path = os.path.join(work, "campaign.json")
    t0 = time.perf_counter()
    durablecheck.run_recovery_case = held_case
    try:
        run_cli(durablecheck, [*NET_CAMPAIGN, "--no-overhead",
                               "--device", DEVICE,
                               "--tmpdir", os.path.join(work, "campaign"),
                               "--summary-json", path])
    finally:
        durablecheck.run_recovery_case = real_case
    with open(path) as f:
        doc = json.load(f)
    legs = doc["subprocess"].get("legs", [])
    faults = {k: doc[k] for k in ("lost", "duplicate_terminals",
                                  "duplicate_solves", "unverified")}
    require(doc["invariant_ok"] and not any(faults.values())
            and all(leg["outcome"] == "ok" for leg in legs),
            f"the durable campaign: {faults}, legs "
            f"{[(leg['leg'], leg['outcome']) for leg in legs]}")
    require(not DEVICE == "cuda" or held.get("panel_factor_batched"),
            f"the campaign's cases held no batched launch: {held}")
    rec = {"cases": doc["in_process_cases"], "legs": len(legs),
           "legs_ok": sum(leg["outcome"] == "ok" for leg in legs),
           "admitted": doc["admitted"], "statuses": doc["statuses"],
           "replayed": doc["replayed"], "deduped": doc["deduped"],
           "torn_dropped": doc["torn_dropped"], **faults,
           "held_launches": held,
           "legs_s": {leg["leg"]: leg["wall_s"] for leg in legs},
           "wall_s": round(time.perf_counter() - t0, 3)}
    print(f"phase 12 (a): durablecheck {' '.join(NET_CAMPAIGN)}: "
          f"{rec['cases']} cases and {rec['legs_ok']} of {rec['legs']} "
          f"subprocess legs passed, {rec['admitted']} admitted "
          f"({rec['statuses']}), {rec['replayed']} replayed; lost "
          f"{faults['lost']}, duplicate terminals "
          f"{faults['duplicate_terminals']}, duplicate solves "
          f"{faults['duplicate_solves']}, unverified {faults['unverified']};"
          f" batched launches held {held}; {rec['wall_s']} s [{card}]")
    return rec


def net_overhead(work: str, card: str) -> dict:
    """Phase 12 (a)'s overhead leg (``durablecheck.run_overhead_phase``:
    one loadgen plan journal-off, then journal-on), in this process once
    nothing else of the phase runs."""
    from gauss_tpu_torch.serve import durablecheck

    t0 = time.perf_counter()
    ov = durablecheck.run_overhead_phase(SEED, GATE,
                                         os.path.join(work, "overhead"),
                                         device=DEVICE)
    require(ov["off"]["incorrect"] == 0 and ov["on"]["incorrect"] == 0,
            f"the overhead leg: {ov}")
    rec = {k: ov[k] for k in ("off", "on", "overhead_ratio")}
    rec["wall_s"] = round(time.perf_counter() - t0, 3)
    print(f"phase 12 (a): overhead leg, alone: journal-off "
          f"{ov['off']['s_per_request']} s/req, journal-on "
          f"{ov['on']['s_per_request']} s/req (ratio "
          f"{ov['overhead_ratio']}); {rec['wall_s']} s [{card}]")
    return rec


def timed_calls(obj, name: str, log: list, size=None):
    """Wrap ``obj.<name>`` (an instance's method) so that each call
    appends ``(size(*args), seconds)`` to ``log``."""
    real = getattr(obj, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            log.append((size(*args, **kw) if size else None,
                        time.perf_counter() - t0))
    setattr(obj, name, timed)


def last_record(jd: str) -> dict:
    """The last record of a journal's live segment, read from its tail
    (a journal of large operands takes seconds to scan whole)."""
    from gauss_tpu_torch.serve import durable

    with open(durable.segment_paths(jd)[-1], "rb") as f:
        f.seek(max(0, f.seek(0, 2) - 4096))
        tail = f.read().rstrip(b"\n").rsplit(b"\n", 1)[-1]
    return durable.decode_line(tail + b"\n") or {}


def journal_systems(jd: str):
    """The journal's admits by key: ``{rid: (a, b, dtype, n)}``, and the
    scan's seconds."""
    from gauss_tpu_torch.serve import durable

    t0 = time.perf_counter()
    st = durable.scan(jd)
    scan_s = time.perf_counter() - t0
    out = {}
    for doc in st.admits.values():
        b = durable.decode_array(doc["b"])
        out[doc["rid"]] = (durable.decode_array(doc["a"]),
                           b.reshape(-1) if doc.get("was_vector") else b,
                           doc.get("dtype"), doc["n"])
    return st, out, scan_s


def net_load(requests: int):
    """Phase 12's plan: phase 9's mix and weights (SERVE_MIX), NET_WARMUP
    warm-up requests as a burst, then ``requests`` keyed ones closed loop,
    SERVE_CONCURRENCY at a time, made from the first seed from SEED on
    whose plan holds every lane of the mix (each token with a dtype, spd
    or sparse) and a dense system of the ladder's top bucket both in the
    warm-up (so (c)'s kill follows a top-bucket batch) and in the measured
    requests (the heaviest traffic is measured)."""
    from gauss_tpu_torch.serve import loadgen

    lanes = {(s.kind, s.dtype) for s, _ in loadgen.parse_mix(SERVE_MIX)
             if s.dtype or s.kind in ("spd", "sparse")}

    def top(spec):
        n = int(spec.arg.split("/")[0])
        return (spec.kind in ("random", "internal") and not spec.dtype
                and SERVE_LADDER[-2] < n <= SERVE_LADDER[-1])
    for seed in range(SEED, SEED + 1000):
        cfg = loadgen.LoadgenConfig(
            mix=SERVE_MIX, requests=requests, warmup=NET_WARMUP,
            mode="closed", concurrency=SERVE_CONCURRENCY, seed=seed,
            verify_gate=GATE, request_ids=True, timeout_s=900)
        rng = np.random.default_rng(seed)
        warm = loadgen.sample_plan(cfg, cfg.warmup, rng)
        plan = loadgen.sample_plan(cfg, requests, rng)
        if (lanes <= {(s.kind, s.dtype) for s in warm + plan}
                and any(map(top, warm)) and any(map(top, plan))):
            return cfg
    raise SystemExit("chip_smoke FAILED: no seed gives phase 12 a plan "
                     "with every lane")


def percentiles(vals) -> dict:
    vals = sorted(vals)
    return {"p50_s": float(np.percentile(vals, 50)),
            "p99_s": float(np.percentile(vals, 99)),
            "mean_s": float(np.mean(vals))}


def net_wire(work: str, card: str, service: dict, after_run=None):
    """Phase 12 (b) (module docstring): the wire run's launch counts, its
    launches by route, and the figures. ``after_run()`` is called once the
    timed run (the loadgen plan) is over, before the oversized request and
    the checks."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.serve import (STATUS_OK, ServeConfig, SolverServer,
                                       cache, durable, durablecheck, loadgen,
                                       net)
    from gauss_tpu_torch.verify import checks

    jd = os.path.join(work, "wire-journal")
    cfg = ServeConfig(ladder=SERVE_LADDER, max_batch=SERVE_BATCH,
                      refine_steps=SERVE_REFINE, cache_capacity=32,
                      verify_gate=GATE, structure_aware=True, device=DEVICE,
                      journal_dir=jd)
    lg = net_load(NET_REQUESTS)
    measured = f"lg{lg.seed}-"  # run_load's keys; the warm-up's are minted
    big = dominant_system(SERVE_OVERSIZE, SEED + 6)
    factors, uploads, solves, appends, seen_h = [], [], [], [], {}
    real_factor = cache.BatchedExecutable.factor

    def kept_factor(exe, a_pad):
        fac = real_factor(exe, a_pad)
        if exe.key.structure != "spd":
            factors.append((exe, a_pad, fac))
        return fac

    server = SolverServer(cfg).start()
    api = net.RequestApi(net.ReplicaApp(server)).start()
    client = net.SolveClient(api.url, seed=SEED, timeout_s=lg.timeout_s)
    timed_calls(client, "_upload", uploads,
                lambda uid, a, *r, **k: (a.shape[0], a.nbytes, k.get("rid")))
    timed_calls(client, "solve", solves,
                lambda *a, **k: k.get("request_id"))
    timed_calls(server.journal, "_append", appends)
    cache.BatchedExecutable.factor = kept_factor
    try:
        t0 = time.perf_counter()
        with obs.run(tool="chip_smoke_net"), \
                checked_launches(seen_h, deferred=True):
            _build.reset_launches()
            summary = loadgen.run_load(client, lg)
            run_s = time.perf_counter() - t0
            run_solves, run_uploads, run_batches = (solves[:], uploads[:],
                                                    server.batches)
            if after_run is not None:
                after_run()
            t0 = time.perf_counter()
            handoff = client.solve(*big, request_id="net-oversize",
                                   timeout=900)
            sync()
            got = dict(_build.LAUNCHES)
            routes = dict(_build.ROUTE_LAUNCHES)
    finally:
        cache.BatchedExecutable.factor = real_factor
    handoff_s = time.perf_counter() - t0
    counts = summary["counts"]
    require(counts == {**dict.fromkeys(counts, 0), STATUS_OK: lg.requests}
            and not summary["incorrect"] and handoff.status == STATUS_OK
            and handoff.lane == "handoff"
            and checks.residual_norm(big[0], handoff.x, big[1],
                                     relative=True) <= GATE,
            f"the wire run: {counts}, incorrect {summary['incorrect']}; the "
            f"oversized request {handoff.status} on {handoff.lane} "
            f"({handoff.error})")
    # The journal: one terminal per key, every ok verified at 1e-4 from
    # the journaled operands.
    st, systems, scan_s = journal_systems(jd)
    ledger = [(rid, v[3]) for rid, v in systems.items()]
    audit = durablecheck.audit(jd, ledger, GATE, state=st)
    require(len(ledger) == lg.warmup + lg.requests + 1
            and not (audit["missing"] or audit["duplicates"]
                     or audit["incorrect"])
            and audit["statuses"] == {STATUS_OK: len(ledger)},
            f"the wire run's journal audit: {len(ledger)} keys, "
            f"{ {k: audit[k] for k in ('missing', 'duplicates', 'incorrect', 'statuses')} }")
    # Each system submitted again in process to the same server, whose
    # worker solves them while this thread runs every batched factor of
    # the run again, each launch on this thread held, the same factor bit
    # for bit (the kernels are deterministic).
    wire_x = {rid: durable.decode_array(st.by_rid[rid]["x"])
              for rid in systems}
    t0 = time.perf_counter()
    handles = {rid: server.submit(a, b, dtype=dt)
               for rid, (a, b, dt, _) in systems.items()}
    held = {}
    with held_batched_launches(held, thread=threading.current_thread()):
        for exe, a_pad, fac in factors:
            again = real_factor(exe, a_pad)
            require(bits_equal(again, fac, LU_FIELDS),
                    f"a batched factor of the wire run at {exe.key} came "
                    f"out different when run again")
        sync()
    held_s = time.perf_counter() - t0
    factors.clear()
    diff, equal = 0.0, 0
    for rid, h in handles.items():
        res = h.result(900)
        require(res.status == STATUS_OK, f"in process, {rid}: {res.status}")
        x, ref = wire_x[rid], res.x
        diff = max(diff, float(np.linalg.norm(x - ref)
                               / np.linalg.norm(ref)))
        equal += bool(np.array_equal(x, ref))
    inproc_s = time.perf_counter() - t0
    bat = {k: got[k] for k in ("panel_factor_batched",
                               "panel_factor_batched_bf16",
                               "panel_trailing_fused_batched",
                               "panel_trailing_fused_batched_bf16")}
    require(not DEVICE == "cuda" or held == {k: v for k, v in bat.items()
                                             if v},
            f"held batched launches {held} != the run's {bat}")
    require(not DEVICE == "cuda"
            or seen_h.get("panel", 0) + seen_h.get("fused", 0)
            == sum(got[k] for k in ("panel_factor", "panel_factor_cluster",
                                    "panel_factor_grid",
                                    "panel_trailing_fused")),
            f"the handoff's held launches {seen_h} != its launches {got}")
    # Every key again over the wire: the journaled terminal, no launch.
    sync()
    before = (dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES),
              server.batches, server.requests_served)

    def resubmit(item):
        rid, (a, b, dt, _) = item
        res = client.solve(a, b, dtype=dt, request_id=rid, timeout=900)
        require(res.status == STATUS_OK
                and np.array_equal(res.x.reshape(wire_x[rid].shape),
                                   wire_x[rid]),
                f"the resubmitted key {rid}: {res.status}, not its "
                f"journaled terminal")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_CONCURRENCY) as pool:
        list(pool.map(resubmit, systems.items()))
    resubmit_s = time.perf_counter() - t0
    sync()
    after = (dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES),
             server.batches, server.requests_served)
    require(after == before, "the resubmissions launched a kernel or "
            "served a batch")
    jstats = server.journal.stats()
    api.stop()
    server.stop(drain=True, timeout=600)
    require(last_record(jd).get("rec") == "shutdown",
            "no clean-shutdown marker")
    # ((n, bytes, key), seconds) per upload: the top bucket's operands
    top = [(nb, t) for (n, nb, _), t in run_uploads
           if SERVE_LADDER[-2] < n <= SERVE_LADDER[-1]]
    up_mb_s = (sum(nb for nb, _ in top) / 1e6 / sum(t for _, t in top)
               if top else None)
    keys = len(ledger)
    # The measured requests' seconds, each seen from the client (upload,
    # POST and wait), from the server (admission to terminal) and in its
    # uploads; the journal's appends per key.
    client_lat = [t for rid, t in run_solves
                  if rid and rid.startswith(measured)]
    split = {"client": percentiles(client_lat),
             "server": {"p50_s": summary["latency_s"]["p50"],
                        "p99_s": summary["latency_s"]["p99"],
                        "mean_s": summary["latency_s"]["mean"]},
             "upload_s_per_request": sum(
                 t for (_, _, rid), t in run_uploads
                 if rid and rid.startswith(measured)) / lg.requests,
             "journal_append_s_per_key": sum(s for _, s in appends) / keys}
    rec = {"requests": lg.requests, "warmup": lg.warmup, "keys": keys,
           "seed": lg.seed,
           "waves": lg.requests / SERVE_CONCURRENCY,
           "counts": counts, "lanes": summary["lanes"],
           "batches": run_batches,
           "solves_per_s": summary["throughput_rps"],
           "wall_s": summary["wall_s"], "warmup_s": summary["warmup_s"],
           "split": split, "client_retries": summary["retries"],
           "in_process": {k: service[k] for k in ("solves_per_s", "p50_s",
                                                  "p99_s")},
           "upload_mb_s_4096": up_mb_s, "uploads_4096": len(top),
           "journal": {k: jstats[k] for k in ("appends", "fsyncs", "bytes",
                                              "segments", "rotations")},
           "scan_s": scan_s, "held_launches": held,
           "held_handoff": {k: v for k, v in seen_h.items()
                            if k in ("panel", "fused")},
           "held_s": held_s, "max_rel_diff_in_process": diff,
           "bit_equal_in_process": equal, "resubmit_s": resubmit_s,
           "run_s": run_s, "handoff_s": handoff_s,
           "in_process_s": inproc_s}
    c, sv = split["client"], split["server"]
    print(f"phase 12 (b): {keys} keyed requests over HTTP, alone on the "
          f"card ({lg.warmup} warm-up as a burst + {lg.requests} closed "
          f"loop x{SERVE_CONCURRENCY}, {rec['waves']:g} wave(s), of "
          f"{SERVE_MIX}, seed {lg.seed}; + one n={SERVE_OVERSIZE}): "
          f"{counts}, lanes "
          f"{summary['lanes']}, {summary['throughput_rps']} solves/s over "
          f"{summary['wall_s']:.1f} s; each measured request from the "
          f"client p50 {c['p50_s']:.3f} s, p99 {c['p99_s']:.3f} s, mean "
          f"{c['mean_s']:.3f} s, of which uploads "
          f"{split['upload_s_per_request']:.3f} s; from the server "
          f"(admission to terminal) p50 {sv['p50_s']:.3f} s, p99 "
          f"{sv['p99_s']:.3f} s, mean {sv['mean_s']:.3f} s (phase 9 in "
          f"process, no journal: {service['solves_per_s']} solves/s, p50 "
          f"{service['p50_s']} s, p99 {service['p99_s']} s); every ok at "
          f"1e-4, one terminal per key; batched launches held after the run"
          f" {held} ({held_s:.1f} s, every factor bit for bit again), the "
          f"handoff's {rec['held_handoff']}; in process again, beside the "
          f"held re-run ({inproc_s:.1f} s): max |x_wire - x| / |x| {diff:.3g}, {equal} "
          f"of {keys} bit for bit; every key resubmitted: its journaled "
          f"terminal, 0 launches, 0 batches ({resubmit_s:.1f} s, "
          f"x{SERVE_CONCURRENCY} at once); upload "
          f"{up_mb_s} MB/s over {len(top)} {SERVE_LADDER[-1]}-bucket "
          f"operands; journal {rec['journal']}, "
          f"{split['journal_append_s_per_key']:.4f} s of appends per key, "
          f"scan {scan_s:.2f} s; the loadgen run "
          f"{run_s:.1f} s, the oversized request with its held launches "
          f"{handoff_s:.1f} s [{card}]")
    return {k: got[k] for k in _build.LAUNCHES}, routes, rec


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def stop_supervised(sup, ep_path: str) -> None:
    """Leave no process of (c) behind: a supervisor still running gets
    SIGTERM (it forwards it to the replica, which drains), then SIGKILL;
    a replica still alive after that is killed by the pid it published."""
    import signal

    if sup.poll() is None:
        sup.send_signal(signal.SIGTERM)
        try:
            sup.wait(timeout=120)
        except subprocess.TimeoutExpired:
            sup.kill()
            sup.wait(timeout=60)
    try:
        with open(ep_path) as f:
            pid = json.load(f)["pid"]
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            if b"gauss_tpu_torch.serve.net" in f.read():
                os.kill(pid, signal.SIGKILL)
    except (OSError, ValueError, KeyError):
        pass  # no endpoint, or the replica is gone


def net_kill(work: str, card: str) -> dict:
    """Phase 12 (c) (module docstring)."""
    import signal

    from gauss_tpu_torch.serve import (STATUS_OK, ServeConfig, SolverServer,
                                       durable, durablecheck, loadgen, net)

    d = os.path.join(work, "replica")
    jd = os.path.join(d, "journal")
    skip = int(np.random.default_rng(SEED + 12).integers(*NET_KILL_SKIP))
    child = [sys.executable, "-m", "gauss_tpu_torch.serve.net", "--replica",
             "--dir", d, "--port", str(free_port()),
             "--ladder", ",".join(map(str, SERVE_LADDER)),
             "--max-batch", str(SERVE_BATCH), "--verify-gate", str(GATE),
             "--structure-aware", "--device", DEVICE]
    code = (f"import sys, time; sys.path.insert(0, {REPO!r}); "
            f"from gauss_tpu_torch.serve import durable; "
            f"sys.exit(durable.supervise({child!r}, "
            f"heartbeat_path={os.path.join(d, 'heartbeat.json')!r}, "
            f"journal_dir={jd!r}, max_restarts=1, "
            f"stall_after_s={NET_STALL_S!r}, log=lambda m: "
            f"print(f'{{time.time():.3f}} {{m}}', flush=True)))")
    env = dict(os.environ, GAUSS_FAULTS=(
        f"serve.server.batch=server_kill:skip={skip};"
        f"serve.worker.dispatch=delay:param={NET_DELAY_S}:max=1000000"))
    t0 = time.perf_counter()
    sup = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    ep_path = os.path.join(d, "endpoint.json")
    try:
        deadline = time.monotonic() + 300
        while not os.path.exists(ep_path):
            require(sup.poll() is None and time.monotonic() < deadline,
                    f"the replica published no endpoint: "
                    f"{(sup.stdout.read() if sup.poll() is not None else '')[-2000:]}")
            time.sleep(0.1)
        with open(ep_path) as f:
            first = json.load(f)
        lg = net_load(NET_KILL_REQUESTS)
        client = net.SolveClient(first["url"], seed=SEED + 1,
                                 timeout_s=lg.timeout_s)
        summary = loadgen.run_load(client, lg)
        with open(ep_path) as f:
            second = json.load(f)
        sup.send_signal(signal.SIGTERM)
        rc = sup.wait(timeout=600)
    finally:
        stop_supervised(sup, ep_path)
    log = sup.stdout.read()
    wall = time.perf_counter() - t0
    for line in log.strip().splitlines():
        print(f"    | {line}")
    restarts = sum("restarting against the same journal" in ln
                   for ln in log.splitlines())
    died = [float(ln.split()[0]) for ln in log.splitlines()
            if "died rc=" in ln]
    counts = summary["counts"]
    require(rc == net.DRAIN_EXIT and restarts == 1 and len(died) == 1
            and second["pid"] != first["pid"],
            f"the supervised replica: supervisor exit {rc} (want "
            f"{net.DRAIN_EXIT}), {restarts} restart(s), pids "
            f"{first['pid']} / {second['pid']}")
    require(counts == {**dict.fromkeys(counts, 0), STATUS_OK: lg.requests}
            and not summary["incorrect"],
            f"the run through the kill: {counts}, incorrect "
            f"{summary['incorrect']}")
    # Every key of the plan admitted once, and one terminal each.
    st = durable.scan(jd)
    by_rid = {doc["rid"]: doc for doc in st.admits.values()}
    keys = lg.warmup + lg.requests
    ledger = [(rid, doc["n"]) for rid, doc in by_rid.items()]
    audit = durablecheck.audit(jd, ledger, GATE, state=st)
    require(len(st.admits) == len(by_rid) == keys and not (
        audit["missing"] or audit["duplicates"] or audit["incorrect"])
            and audit["statuses"] == {STATUS_OK: keys}
            and st.clean_shutdown,
            f"the replica's journal audit: {len(st.admits)} admits of "
            f"{len(by_rid)} keys, {keys} sent, {audit}")
    top = {doc["id"] for doc in st.admits.values()
           if SERVE_LADDER[-2] < doc["n"] <= SERVE_LADDER[-1]
           and doc.get("structure") != "sparse"}
    boot1 = {i for bl in st.blames if bl.get("boot") == 1
             for i in bl.get("ids") or ()}
    require(top & boot1,
            f"no {SERVE_LADDER[-1]} batch before the kill (boundary "
            f"{skip + 1})")
    kill_t = died[0]
    replayed = sorted(t["t_unix"] for t in st.terminals.values()
                      if t["t_unix"] > kill_t
                      and st.admits[t["id"]]["t_unix"] < kill_t)
    resume = second["resume"]
    require(resume["replayed"] == len(replayed) and resume["replayed"] > 0,
            f"replayed {resume}, {len(replayed)} admitted before the kill "
            f"and served after it")
    # One more start replays nothing.
    with SolverServer(ServeConfig(ladder=SERVE_LADDER, device=DEVICE,
                                  journal_dir=jd)) as srv:
        again = dict(srv.last_resume)
    require(again["replayed"] == 0 and again["clean"],
            f"a start after the drain: {again}")
    rec = {"kill_boundary": skip + 1, "restarts": restarts,
           "replayed": resume["replayed"],
           "kill_to_first_replayed_s": replayed[0] - kill_t,
           "keys": keys, "counts": counts,
           "solves_per_s": summary["throughput_rps"],
           "p50_s": summary["latency_s"]["p50"],
           "p99_s": summary["latency_s"]["p99"],
           "client_retries": summary["retries"],
           "build_s": [first["build_s"], second["build_s"]],
           "drain_exit": rc, "restart_after_drain": again,
           "journal_bytes": sum(os.path.getsize(p)
                                for p in durable.segment_paths(jd)),
           "wall_s": wall}
    print(f"phase 12 (c): a replica under supervise killed at batch "
          f"boundary {skip + 1} (after a {SERVE_LADDER[-1]} batch), "
          f"{restarts} restart; {keys} keys ({lg.warmup} warm-up + "
          f"{lg.requests} of (b)'s plan), each admitted once and exactly one"
          f" terminal ({audit['statuses']}), every ok at 1e-4; "
          f"{resume['replayed']} replayed, the first "
          f"{rec['kill_to_first_replayed_s']:.2f} s after the kill; "
          f"{summary['throughput_rps']} solves/s through it, "
          f"{summary['retries']} client retries; SIGTERM: exit {rc}, clean-shutdown marker, a start after it "
          f"replays {again['replayed']}; the children's build seconds "
          f"{rec['build_s']}; {wall:.1f} s [{card}]")
    return rec


def start_own_process(expr: str, log: str, names=()):
    """``expr`` (this script imported as ``c``, each of ``names`` set to its
    value here) evaluated in a new process (never a fork of this one), its
    value printed as JSON on the last line of ``log``: the process. SIGTERM
    makes it exit through its ``finally`` blocks (the processes it started
    are stopped)."""
    sets = "".join(f"c.{n} = {globals()[n]!r}; " for n in names)
    code = (f"import json, signal, sys; sys.path.insert(0, {REPO!r}); "
            f"signal.signal(signal.SIGTERM, lambda *a: sys.exit(143)); "
            f"import chip_smoke as c; {sets}"
            f"print(json.dumps({expr}, default=str))")
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-c", code], stdout=f,
                                stderr=subprocess.STDOUT, cwd=REPO,
                                env=dict(os.environ, **BACKGROUND_THREADS))


def finish_own_process(proc, log: str, label: str) -> dict:
    """Wait for ``start_own_process``'s process, echo its output, and
    return its value."""
    rc = proc.wait(timeout=1200)
    with open(log) as f:
        text = f.read()
    print(text.rstrip())
    require(rc == 0, f"{label}: its process exited {rc}")
    return json.loads(text.strip().splitlines()[-1])


def phase_net(service: dict | None = None, beside=None):
    """The durable and network service on the card (module docstring,
    phase 12): returns the launch counts of the wire run (b) and the
    phase's figures; ``service``: phase 9's service figures, printed
    beside the wire's; ``beside()``, on the card, runs right after (b)'s
    timed run, before (c) and (a) start (phase 13's timed run, which then
    starts phase 13's campaigns); its seconds are not this phase's. Its
    journals live in a temporary directory that the phase removes."""
    import tempfile

    on_card = DEVICE == "cuda"
    card = smi_line() if on_card else "cpu"
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="gauss_net_")
    procs = {}
    logs = {k: os.path.join(work, f"{k}.log") for k in ("a", "c")}
    runs = {"c": ("kill", f"c.net_kill({work!r}, {card!r})",
                  ("DEVICE", "SERVE_LADDER", "SERVE_BATCH",
                   "SERVE_CONCURRENCY", "SERVE_MIX", "NET_WARMUP",
                   "NET_KILL_REQUESTS", "NET_KILL_SKIP", "NET_DELAY_S")),
            "a": ("campaign",
                  f"c.net_campaign({os.path.join(work, 'a')!r}, {card!r})",
                  ("DEVICE", "NET_CAMPAIGN"))}

    def start(k):
        procs[k] = start_own_process(runs[k][1], logs[k], runs[k][2])

    beside_s = [0.0]

    def start_beside():
        if beside is not None:
            t1 = time.perf_counter()
            beside()
            beside_s[0] = time.perf_counter() - t1
        for k in runs:
            start(k)
    try:
        # (b)'s timed run alone; on the card (c) and (a) then run beside
        # (b)'s checks, on the CPU (a host shared with other work) after
        # them, in turn; the overhead leg last, alone.
        os.makedirs(os.path.join(work, "a"))
        out = {"card": card}
        launches, routes, out["wire"] = net_wire(
            work, card, service or dict.fromkeys(("solves_per_s", "p50_s",
                                                  "p99_s")),
            after_run=start_beside if on_card else None)
        out["wire"]["launches"] = {k: v for k, v in launches.items() if v}
        out["wire"]["routes"] = routes
        for k, (key, _, _) in runs.items():
            if k not in procs:
                start(k)
            out[key] = finish_own_process(procs[k], logs[k],
                                          f"phase 12 ({k})")
        out["campaign"]["overhead"] = net_overhead(work, card)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=300)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=60)
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = round(time.perf_counter() - t0 - beside_s[0], 3)
    print(json.dumps({"net": out}, default=str))
    return launches, out


# --- Phase 13: the replicated service behind the router --------------------

def replica_health(rp) -> dict:
    """A replica's ``/healthz`` doc (its served and batch counts and its
    kernel launches by key and route)."""
    import urllib.request

    with urllib.request.urlopen(rp.url + "/healthz", timeout=30) as resp:
        return json.loads(resp.read())


def add_launches(total: dict, routes: dict, doc: dict) -> None:
    for k, v in (doc.get("launches") or {}).items():
        total[k] = total.get(k, 0) + v
    for k, v in (doc.get("route_launches") or {}).items():
        routes[k] = routes.get(k, 0) + v


def kill_busiest(router, solves: list, warmup: int, out: dict) -> None:
    """Once the warm-up's solves are back, SIGKILL the replica with the
    deepest queue (the first to hold one; any replica after
    ROUTER_KILL_WAIT_S), its launches read from it just before, and wait
    for the router to fail it over and respawn it."""
    from gauss_tpu_torch.serve import replicacheck

    while len(solves) < warmup:
        time.sleep(0.05)
    deadline = time.monotonic() + ROUTER_KILL_WAIT_S
    while True:
        live = router.live_replicas()
        depth = {name: replica_health(rp)["depth"]
                 for name, rp in sorted(live.items())}
        name = max(depth, key=depth.get)
        if depth[name] >= 1 or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    out["victim"], out["depth_at_kill"] = name, depth
    out["health_before_kill"] = replica_health(live[name])
    t0 = time.perf_counter()
    out["pid"] = router.kill_replica(name)
    replicacheck._wait_respawn(router, name, out["pid"],
                               timeout_s=ROUTER_SPAWN_S)
    out["kill_to_live_s"] = time.perf_counter() - t0


def router_run(work: str) -> dict:
    """Phase 13 (a)'s timed part (module docstring): a router over
    ROUTER_REPLICAS replicas started, phase 12 (b)'s plan driven through it
    by ``loadgen.run_load``, the busiest replica SIGKILLed after the
    warm-up and waited for until the router has failed it over and
    respawned it. Returns the state ``router_check`` takes over; the
    router keeps running."""
    import threading

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.serve import loadgen, net
    from gauss_tpu_torch.serve.router import Router, RouterConfig

    st = {"root": os.path.join(work, "router"), "solves": [], "kill": {},
          "lg": net_load(NET_REQUESTS)}
    cfg = RouterConfig(replicas=ROUTER_REPLICAS, dir=st["root"],
                       ladder=SERVE_LADDER, max_batch=SERVE_BATCH,
                       verify_gate=GATE, device=DEVICE,
                       structure_aware=True, spawn_timeout_s=ROUTER_SPAWN_S,
                       forward_timeout_s=900.0)
    t0 = time.perf_counter()
    with obs.run(tool="chip_smoke_router") as rec:
        st["router"] = router = Router(cfg).start()
        try:
            st["start_s"] = time.perf_counter() - t0
            st["client"] = client = net.SolveClient(
                router.url, seed=SEED, timeout_s=st["lg"].timeout_s)
            timed_calls(client, "solve", st["solves"],
                        lambda *a, **k: k.get("request_id"))
            killer = threading.Thread(target=kill_busiest, args=(
                router, st["solves"], st["lg"].warmup, st["kill"]))
            killer.start()
            t1 = time.perf_counter()
            st["summary"] = loadgen.run_load(client, st["lg"])
            st["run_s"] = time.perf_counter() - t1
            killer.join(timeout=ROUTER_SPAWN_S)
            require(not killer.is_alive() and "kill_to_live_s" in st["kill"],
                    f"the kill after the warm-up did not finish: "
                    f"{st['kill']}")
        except BaseException:
            router.stop(drain=False)
            raise
        st["events"] = [e for e in rec.events
                        if e["type"] == "replica_failover"]
    st["wall_s"] = time.perf_counter() - t0
    return st


def router_check(st: dict, card: str, figs: dict):
    """Phase 13 (a)'s checks on ``router_run``'s state (module
    docstring): the respawn probed, every key resubmitted, the journal
    union audited, the bundle checked, the run's systems solved again in
    this process with every batched launch held, the router stopped.
    Returns the router run's launches by key and by route, and its
    figures."""
    import glob
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from gauss_tpu_torch.obs import debug as gdebug
    from gauss_tpu_torch.serve import (STATUS_OK, ServeConfig, SolverServer,
                                       durable, net, replicacheck)

    router, client, kill, lg = (st["router"], st["client"], st["kill"],
                                st["lg"])
    root, solves, summary = st["root"], st["solves"], st["summary"]
    launches, routes, held = {}, {}, {}
    scfg = ServeConfig(ladder=SERVE_LADDER, max_batch=SERVE_BATCH,
                       refine_steps=SERVE_REFINE, verify_gate=GATE,
                       structure_aware=True, device=DEVICE)

    def held_rerun(systems):
        """The run's systems solved again in this process, every batched
        launch held (``held``: the counts by key, then the results and the
        seconds; a failure is raised on the caller's thread)."""
        try:
            t3 = time.perf_counter()
            with SolverServer(scfg) as srv, held_batched_launches(held):
                handles = {rid: srv.submit(a, b, dtype=dt)
                           for rid, (a, b, dt, _) in systems.items()}
                out = {rid: h.result(900) for rid, h in handles.items()}
                sync()
            held.update(results=out, s=time.perf_counter() - t3)
        except BaseException as e:  # noqa: BLE001 — re-raised by the caller
            held["error"] = e
    t0 = time.perf_counter()
    try:
        victim = kill["victim"]
        add_launches(launches, routes, kill["health_before_kill"])
        # The respawned replica serves: a key whose ring position falls on
        # it, sent through the router.
        rng = np.random.default_rng(SEED + 13)
        while True:
            a, b = dominant_system(ROUTER_PROBE_N,
                                   int(rng.integers(1 << 30)))
            if router.ring.lookup(net.matrix_digest(a)) == victim:
                break
        probe = client.solve(a, b, request_id="router-respawned",
                             timeout=900)
        healths = {name: replica_health(rp)
                   for name, rp in router.live_replicas().items()}
        require(probe.status == STATUS_OK
                and healths[victim]["served"] >= 1
                and healths[victim]["pid"] != kill["pid"],
                f"the respawned {victim}: {probe.status} ({probe.error}), "
                f"{healths[victim]}")
        # Every key again through the router: its journaled terminal, no
        # replica serves anything more (0 duplicate solves).
        before = sum(h["served"] for h in healths.values())
        jdirs = sorted(glob.glob(os.path.join(root, "r*", "journal*")))
        systems, terminals = {}, {}
        for jd in jdirs:
            js = durable.scan(jd)
            for doc in js.admits.values():
                if doc["rid"] not in systems:
                    bb = durable.decode_array(doc["b"])
                    systems[doc["rid"]] = (
                        durable.decode_array(doc["a"]),
                        bb.reshape(-1) if doc.get("was_vector") else bb,
                        doc.get("dtype"), doc["n"])
            for doc in js.terminals.values():
                if doc.get("rid") and doc.get("x") is not None:
                    terminals[doc["rid"]] = durable.decode_array(doc["x"])
        # Every batched launch held: each system of the run solved again
        # in this process, on a thread of its own beside the resubmission
        # (which only the replicas serve), with every batched-kernel
        # launch held against its plain version.
        rerun = threading.Thread(target=held_rerun, args=(systems,),
                                 daemon=True)
        rerun.start()

        def resubmit(rid):
            return rid, client.solve(*systems[rid][:2],
                                     dtype=systems[rid][2],
                                     request_id=rid, timeout=900)
        t2 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_CONCURRENCY) as pool:
            storm = dict(pool.map(resubmit, sorted(systems)))
        storm_s = time.perf_counter() - t2
        healths = {name: replica_health(rp)
                   for name, rp in router.live_replicas().items()}
        fresh = sum(h["served"] for h in healths.values()) - before
        for doc in healths.values():
            add_launches(launches, routes, doc)
        stats = router.stats()
    finally:
        stop = router.stop(drain=True, timeout=600)
    rerun.join()
    if "error" in held:
        raise held["error"]
    events = st["events"]
    bundle, bundle_ok = replicacheck._bundle_ok(os.path.join(root, victim))
    check_rc = gdebug.main([bundle, "--check"]) if bundle else None
    ledger = [(rid, v[3]) for rid, v in systems.items()]
    audit = replicacheck.audit_union(jdirs, ledger, GATE)
    counts = summary["counts"]
    mismatch = [rid for rid, res in storm.items()
                if res.status != STATUS_OK or not np.array_equal(
                    res.x.reshape(terminals[rid].shape), terminals[rid])]
    require(counts == {**dict.fromkeys(counts, 0), STATUS_OK: lg.requests}
            and not summary["incorrect"]
            and len(ledger) == lg.warmup + lg.requests + 1
            and not (audit["missing"] or audit["duplicates"]
                     or audit["incorrect"])
            and audit["statuses"] == {STATUS_OK: len(ledger)}
            and fresh == 0 and not mismatch,
            f"the router run: {counts}, incorrect {summary['incorrect']}; "
            f"{len(ledger)} keys; audit "
            f"{ {k: audit[k] for k in ('missing', 'duplicates', 'incorrect', 'statuses')} }; "
            f"the resubmission solved {fresh} fresh, {mismatch} differ")
    failed_dir = os.path.join(root, victim, "journal-failed-1")
    require(os.path.isdir(failed_dir) and len(events) == 1
            and events[0].get("adopter") and bundle_ok and check_rc == 0
            and stats["restarts_used"] == 1,
            f"the failover of {victim}: journal-failed-1 "
            f"{os.path.isdir(failed_dir)}, events {events}, bundle {bundle} "
            f"(--check rc {check_rc}), restarts {stats['restarts_used']}")
    results, held_s = held.pop("results"), held.pop("s")
    diff, equal = 0.0, 0
    for rid, res in results.items():
        require(res.status == STATUS_OK, f"in process, {rid}: {res.status}")
        x = terminals[rid].reshape(res.x.shape)
        diff = max(diff, float(np.linalg.norm(x - res.x)
                               / np.linalg.norm(res.x)))
        equal += bool(np.array_equal(x, res.x))
    bat = {k: v for k, v in launches.items() if "batched" in k}
    require(not DEVICE == "cuda" or (bat and set(bat) <= set(held)),
            f"the replicas' batched launches {bat}; held on the re-run "
            f"{held}")
    require(diff <= 1e-4, f"in process against the router: max |x_wire - "
            f"x| / |x| {diff}")
    measured = f"lg{lg.seed}-"
    cl = percentiles([t for rid, t in solves
                      if rid and rid.startswith(measured)])
    ev = events[0]
    one = figs.get("net_solves_per_s")
    ratio = (round(summary["throughput_rps"] / one, 4) if one else None)
    rec = {"replicas": ROUTER_REPLICAS, "requests": lg.requests,
           "warmup": lg.warmup, "seed": lg.seed, "keys": len(ledger),
           "counts": counts, "lanes": summary["lanes"],
           "solves_per_s": summary["throughput_rps"],
           "one_replica_solves_per_s": one, "vs_one_replica": ratio,
           "in_process_solves_per_s": figs.get("serve_solves_per_s"),
           "client": cl, "server": {
               "p50_s": summary["latency_s"]["p50"],
               "p99_s": summary["latency_s"]["p99"]},
           "client_retries": summary["retries"],
           "start_s": st["start_s"], "run_s": st["run_s"],
           "run_wall_s": st["wall_s"],
           "checks_s": time.perf_counter() - t0,
           "kill": {"victim": victim, "depth": kill["depth_at_kill"],
                    "kill_to_live_s": kill["kill_to_live_s"],
                    "recovery_s": ev.get("recovery_s"),
                    "adopter": ev.get("adopter"),
                    "replayed": ev.get("replayed"),
                    "imported": ev.get("imported"),
                    "pins_moved": ev.get("pins_moved")},
           "bundle": os.path.basename(bundle), "bundle_check_rc": check_rc,
           "audit": {k: audit[k] for k in ("admitted", "terminals",
                                           "statuses", "torn_dropped")},
           "lost": len(audit["missing"]),
           "duplicate_terminals": len(audit["duplicates"]),
           "duplicate_solves": fresh, "resubmit_s": storm_s,
           "held_launches": held, "held_s": held_s,
           "max_rel_diff_in_process": diff, "bit_equal_in_process": equal,
           "stop": stop["causes"]}
    print(f"phase 13 (a): {len(ledger)} keyed requests through a router over "
          f"{ROUTER_REPLICAS} replicas on the card ({lg.warmup} warm-up + "
          f"{lg.requests} closed loop x{SERVE_CONCURRENCY} of {SERVE_MIX}, "
          f"seed {lg.seed}; + one probe of the respawned replica), "
          f"{victim} SIGKILLed after the warm-up at queue depths "
          f"{kill['depth_at_kill']}: {counts}, lanes {summary['lanes']}; "
          f"{summary['throughput_rps']} solves/s through the router (phase "
          f"12's one replica {one}: x{ratio} for {ROUTER_REPLICAS} replicas "
          f"at the ladder, no gate; phase 9 in process "
          f"{figs.get('serve_solves_per_s')}; this run); the "
          f"client p50 {cl['p50_s']:.3f} s, p99 {cl['p99_s']:.3f} s; the "
          f"failover {ev.get('recovery_s')} s (adopter {ev.get('adopter')}, "
          f"{ev.get('replayed')} replayed, {ev.get('imported')} imported), "
          f"the kill to {victim} live again {kill['kill_to_live_s']:.2f} s; "
          f"lost {rec['lost']}, duplicate terminals "
          f"{rec['duplicate_terminals']}, duplicate solves {fresh} (every "
          f"key resubmitted: its journaled terminal, {storm_s:.1f} s); "
          f"journal-failed-1 adopted; bundle --check rc {check_rc}; "
          f"launches {launches}, by route {routes}; held on the in-process "
          f"re-run {held} ({held_s:.1f} s, max |x_wire - x| / |x| "
          f"{diff:.3g}, {equal} of {len(results)} bit for bit); replicas "
          f"started in {st['start_s']:.1f} s, the loadgen run "
          f"{st['run_s']:.1f} s, the checks {rec['checks_s']:.1f} s "
          f"[{card}]")
    return launches, routes, rec


def replica_campaign(work: str, card: str) -> dict:
    """Phase 13 (b): ``replicacheck`` at REPLICA_CAMPAIGN on the card in
    this process, every batched launch of its in-process cases held; its
    records into a history file of its own, then ``obs.regress check``
    against that file."""
    from gauss_tpu_torch.obs import regress
    from gauss_tpu_torch.serve import replicacheck

    held = {}
    real_case = replicacheck.run_failover_case

    def held_case(*args, **kw):
        with held_batched_launches(held):
            return real_case(*args, **kw)

    path = os.path.join(work, "replica.json")
    hist = os.path.join(work, "history.jsonl")
    t0 = time.perf_counter()
    replicacheck.run_failover_case = held_case
    try:
        run_cli(replicacheck, [*REPLICA_CAMPAIGN, "--device", DEVICE,
                               "--tmpdir", os.path.join(work, "replica"),
                               "--summary-json", path, "--history", hist])
    finally:
        replicacheck.run_failover_case = real_case
    wall = time.perf_counter() - t0
    with open(path) as f:
        doc = json.load(f)
    records = regress.ingest_file(path)
    out = run_cli(regress, ["check", path, "--history", hist,
                            "--min-samples", "1"])
    verdicts = regress.check_records(records, regress.load_history(hist),
                                     min_samples=1)
    tag = regress.device_tag(DEVICE)
    require(verdicts and all(v["status"] == "fast" and v["device"] == tag
                             for v in verdicts),
            f"regress check on the card's history: {verdicts}")
    legs = {leg["leg"]: leg for leg in doc["legs"]}
    faults = {k: doc[k] for k in ("lost", "duplicate_terminals",
                                  "duplicate_solves", "unverified")}
    require(doc["invariant_ok"] and not any(faults.values())
            and set(legs) == {"kill3", "drain_free", "stall"}
            and all(leg["outcome"] == "ok" for leg in legs.values())
            and doc["tput"]["ok"]
            and (not DEVICE == "cuda" or held.get("panel_factor_batched")),
            f"replicacheck: {faults}, legs "
            f"{[(k, v['outcome'], v.get('error')) for k, v in legs.items()]},"
            f" tput {doc['tput']}, held {held}")
    rec = {"cases": doc["in_process_cases"], "admitted": doc["admitted"],
           "statuses": doc["statuses"], **faults,
           "legs": {k: {"outcome": v["outcome"],
                        "recovery_s": v.get("recovery_s"),
                        "restarts_used": v.get("restarts_used")}
                    for k, v in legs.items()},
           "tput_injected": doc["tput"], "held_launches": held,
           "verdicts": [
               {k: v.get(k) for k in ("metric", "value", "status", "device")}
               for v in verdicts],
           "wall_s": round(wall, 3)}
    print(f"phase 13 (b): replicacheck {' '.join(REPLICA_CAMPAIGN)}: "
          f"{rec['cases']} cases and legs {rec['legs']}, {doc['admitted']} "
          f"admitted ({doc['statuses']}); {faults}; 1 -> 3 replicas with "
          f"{doc['tput']['delay_s']} s injected a batch "
          f"{doc['tput']['replicas_1']['throughput_rps']} -> "
          f"{doc['tput']['replicas_3']['throughput_rps']} req/s "
          f"(x{doc['tput']['speedup']}), gate x2; batched launches held "
          f"{held};"
          f" regress on the card's history: {rec['verdicts']}; "
          f"{rec['wall_s']} s [{card}]")
    print("\n".join(f"    | {ln}" for ln in out.strip().splitlines()[-2:]))
    return rec


def poison_campaign(work: str, card: str) -> dict:
    """Phase 13 (c): ``poisoncheck`` at POISON_CAMPAIGN on the card in this
    process (``--no-mesh``), every batched launch of its in-process cases
    held."""
    from gauss_tpu_torch.serve import poisoncheck

    held = {}
    real_case = poisoncheck.run_case

    def held_case(*args, **kw):
        with held_batched_launches(held):
            return real_case(*args, **kw)

    path = os.path.join(work, "poison.json")
    t0 = time.perf_counter()
    poisoncheck.run_case = held_case
    try:
        run_cli(poisoncheck, [*POISON_CAMPAIGN, "--device", DEVICE,
                              "--no-mesh",
                              "--tmpdir", os.path.join(work, "poison"),
                              "--summary-json", path])
    finally:
        poisoncheck.run_case = real_case
    with open(path) as f:
        doc = json.load(f)
    legs = {leg["leg"]: leg for leg in doc["legs"]}
    require(doc["invariant_ok"] and doc["crash_loops"] == 0
            and set(legs) == {"replica", "crashloop", "supervised"}
            and all(leg["outcome"] == "ok" for leg in legs.values())
            and legs["replica"]["restarts_used"] == 0
            and legs["crashloop"]["outcome"] == "ok"
            and (not DEVICE == "cuda" or held.get("panel_factor_batched")),
            f"poisoncheck: {doc['case_violations']}, legs "
            f"{[(k, v['outcome'], v.get('error')) for k, v in legs.items()]}"
            f", held {held}")
    rec = {"cases": doc["in_process_cases"], "requests": doc["requests"],
           "innocents": doc["innocents"], "poisoned": doc["poisoned"],
           "bisections": doc["bisections"],
           "replica_restarts": legs["replica"]["restarts_used"],
           "crashloop_rcs": [i["rc"] for i in
                             legs["crashloop"]["incarnations"]],
           "legs": {k: v["outcome"] for k, v in legs.items()},
           "held_launches": held,
           "wall_s": round(time.perf_counter() - t0, 3)}
    print(f"phase 13 (c): poisoncheck {' '.join(POISON_CAMPAIGN)} "
          f"--no-mesh: {rec['cases']} cases, {rec['requests']} requests "
          f"({rec['innocents']} innocents), {rec['poisoned']} typed poison, "
          f"{rec['bisections']} bisections; replica leg 0 restarts, crash "
          f"loop broken (incarnations exit {rec['crashloop_rcs']}), legs "
          f"{rec['legs']}; batched launches held {held}; {rec['wall_s']} s "
          f"[{card}]")
    return rec


def flight_campaign(work: str, card: str) -> dict:
    """Phase 13 (e): ``flightcheck`` on the card (its kill leg's child
    delayed FLIGHT_KILL_DELAY_S a batch, so the card's fast batches still
    die mid-load)."""
    from gauss_tpu_torch.obs import flightcheck

    path = os.path.join(work, "flight.json")
    t0 = time.perf_counter()
    run_cli(flightcheck, ["--device", DEVICE, "--kill-delay",
                          str(FLIGHT_KILL_DELAY_S),
                          "--tmpdir", os.path.join(work, "flight"),
                          "--summary-json", path])
    with open(path) as f:
        doc = json.load(f)
    kill, torn, ov = doc["kill"], doc["torn_tail"], doc["overhead"]
    require(doc["invariant_ok"] and kill["outcome"] == "ok"
            and kill["bundle_check_rc"] == 0,
            f"flightcheck: kill {kill}, torn {torn.get('error')}, overhead "
            f"{ov.get('outcome')}")
    rec = {"kill": {k: kill.get(k) for k in (
        "attempts", "cause", "batches_reconstructed", "in_flight_at_death",
        "trace_ids_ok", "in_flight_match", "bundle_check_rc", "wall_s")},
        "torn_offsets": torn["offsets_checked"],
        "overhead": {k: ov.get(k) for k in ("off", "on", "overhead_ratio")},
        "wall_s": round(time.perf_counter() - t0, 3)}
    print(f"phase 13 (e): flightcheck: the SIGKILLed child's bundle "
          f"({rec['kill']['cause']}) passes --check, "
          f"{rec['kill']['batches_reconstructed']} batches reconstructed, "
          f"{rec['kill']['in_flight_at_death']} in flight at death, all "
          f"matched; {rec['torn_offsets']} torn-tail cuts; flight-on/off "
          f"{ov.get('overhead_ratio')}; {rec['wall_s']} s [{card}]")
    return rec


#: Phase 13's campaigns, each run in a process of its own:
#: (its figures' key, the function of this script it evaluates).
ROUTER_CAMPAIGNS = {"b": ("replica", "replica_campaign"),
                    "c": ("poison", "poison_campaign"),
                    "e": ("flight", "flight_campaign")}


def start_router_campaigns(bg: dict) -> None:
    """Start phase 13's campaigns (b), (c) and (e), each in a process of
    its own (``start_own_process``), in a temporary directory; ``bg``
    keeps the directory and the processes."""
    import tempfile

    card = smi_line() if DEVICE == "cuda" else "cpu"
    bg["work"] = tempfile.mkdtemp(prefix="gauss_router_")
    bg["procs"] = {}
    keys = ("DEVICE", "SERVE_LADDER", "SERVE_BATCH", "SERVE_CONCURRENCY",
            "SERVE_MIX", "REPLICA_CAMPAIGN", "POISON_CAMPAIGN",
            "FLIGHT_KILL_DELAY_S")
    for k, (_, fn) in ROUTER_CAMPAIGNS.items():
        sub = os.path.join(bg["work"], k)
        os.makedirs(sub)
        bg["procs"][k] = start_own_process(
            f"c.{fn}({sub!r}, {card!r})", os.path.join(sub, "log"), keys)


def start_router_phase(bg: dict) -> None:
    """Phase 13's start on the card: (a)'s timed run (``router_run``, its
    router left running for ``router_check``), then the campaigns.
    Phase 12 calls it right after its own timed run, so that both timed
    runs have the card to themselves and every check after them runs
    beside the campaigns."""
    import tempfile

    bg["router_work"] = tempfile.mkdtemp(prefix="gauss_router_run_")
    bg["router"] = router_run(bg["router_work"])
    start_router_campaigns(bg)


def stop_router_phase(bg: dict) -> None:
    """Leave nothing of phase 13 behind: a router still up is stopped, a
    campaign still running is terminated, their directories removed."""
    st = bg.get("router")
    if st is not None and not st.get("stopped"):
        st["router"].stop(drain=False)
    for proc in bg.get("procs", {}).values():
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
    for key in ("work", "router_work"):
        if key in bg:
            shutil.rmtree(bg[key], ignore_errors=True)


def phase_router(figs: dict, bg: dict | None = None):
    """The replicated service behind the router on the card (module
    docstring, phase 13): returns the launch counts of the router run (a)
    and the phase's figures. ``figs``: phase 9's and phase 12's solves/s,
    printed beside the router's. ``bg``: what ``start_router_phase``
    started beside phase 12; else (a)'s timed run runs here, and the
    campaigns beside (a)'s checks on the card, after them on the CPU.
    Everything runs in temporary directories that the phase removes."""
    import tempfile

    from gauss_tpu_torch.kernels import _build

    on_card = DEVICE == "cuda"
    card = smi_line() if on_card else "cpu"
    t0 = time.perf_counter()
    bg = {} if bg is None else bg
    out = {"card": card}
    try:
        if "router" not in bg:
            bg["router_work"] = tempfile.mkdtemp(prefix="gauss_router_run_")
            bg["router"] = router_run(bg["router_work"])
            if on_card:
                start_router_campaigns(bg)
        launched, routes, out["router"] = router_check(bg["router"], card,
                                                       figs)
        bg["router"]["stopped"] = True
        out["router"]["launches"] = launched
        out["router"]["routes"] = routes
        if "procs" not in bg:
            start_router_campaigns(bg)
        for k, (key, _) in ROUTER_CAMPAIGNS.items():
            out[key] = finish_own_process(
                bg["procs"][k], os.path.join(bg["work"], k, "log"),
                f"phase 13 ({k})")
    finally:
        stop_router_phase(bg)
    # (a)'s timed run, where phase 12 ran it, counts to this phase.
    out["wall_s"] = round(time.perf_counter() - t0 + (
        bg["router"]["wall_s"] if "router" in bg and on_card else 0.0), 3)
    print(json.dumps({"router": out}, default=str))
    return {k: launched.get(k, 0) for k in _build.LAUNCHES}, out


def large_n_summary(large: dict, key: str) -> dict:
    """A kernel's launches by phase-A route and device ms in one
    factorization of each full-size cell (phase 6)."""
    out = {}
    for cell in large["cells"]:
        out[f"n={cell['n']}"] = {
            k.split("/")[1]: {"launches": v, "device_ms": cell.get(
                "device_ms", {}).get(k)}
            for k, v in cell["launches"].items() if k.split("/")[0] == key}
    return out


def dist_summary(fig: dict, key: str) -> dict:
    """Phase 14's launches of a kernel-1 route: (a)'s n=8192 1-D solve
    (each held on a re-run) and one n=2048 solve of (b)/(c)'s."""
    return {f"n={DIST_N} 1-D engine": fig["a"]["kernel1_launches"][key],
            f"n={DIST_CLI_N} solve (b), (c)": fig["c"]["held_per_solve"][key]}


def ooc_summary(ooc: dict, key: str) -> dict:
    """A kernel's launches, device ms and strip heights by route in phase
    11's streamed factorizations ((b) and (c))."""
    return {f"n={ooc[cell]['n']}": {
        k.split("/")[-1]: v for k, v in ooc[cell]["launches"].items()
        if k.split("/")[0] == key} for cell in ("giant", "past_budget")}


# --- phase 14: the distributed and native engines --------------------------

DIST_N = 8192          # (a): the blocked engines at full width
DIST_WARM_N = 512      # (a)'s warm-up, at the same code path
DIST_CLI_N = N         # (b), (c): the reference's NSIZE
DIST_BACKENDS = ("cuda-dist", "cuda-dist2d", "cuda-dist-blocked",
                 "cuda-dist-blocked2d")
NATIVE_N = 512         # (d): cut so that the phase fits its budget
NATIVE_THREADS = 8     # (d): the card host's cores (the CLIs' default, 32,
                       # makes forkjoin start 32 threads a step)
DIST_BUDGET_S = 60.0
KERNEL1_KEYS = ("panel_factor_cluster", "panel_factor_grid", "panel_factor")


def dist_system(n: int):
    rng = np.random.default_rng(SEED)
    return (rng.standard_normal((n, n), dtype=np.float32),
            rng.standard_normal(n, dtype=np.float32))


def rel_res(a64, x, b64) -> float:
    return float(np.linalg.norm(a64 @ np.asarray(x, np.float64) - b64)
                 / np.linalg.norm(b64))


@contextlib.contextmanager
def held_kernel1(seen: dict):
    """Every kernel-1 launch inside the block held against its plain
    version on the same strip, bit for bit (the factor, pivots,
    permutation and min |pivot|): ``seen`` counts the held launches by
    launch key and records the largest difference (``max_abs_err``) and
    any launch that differed (``bad``). The plain calls count no launch."""
    import torch

    from gauss_tpu_torch.kernels import panel as kp

    real = kp.panel_factor

    def held(p, kb=0, seg=None):
        out = real(p, kb)
        want = kp.panel_factor_plain(p, kb)
        key = panel_launch_key(*p.shape, p.element_size())
        seen[key] = seen.get(key, 0) + 1
        err = float((out[0] - want[0]).abs().max())
        seen["max_abs_err"] = max(seen.get("max_abs_err", 0.0), err)
        if not all(torch.equal(x, y) for x, y in zip(out, want)):
            seen.setdefault("bad", []).append(list(p.shape))
        return out

    kp.panel_factor = held
    try:
        yield seen
    finally:
        kp.panel_factor = real


def dist_leg(engine: str, mesh, a, b, a64, b64) -> dict:
    """One blocked engine at full width on ``mesh``: the factor's seconds
    (the 1-D engine's factor carries the augmented right-hand side, so its
    seconds hold that solve too), one solve against the factors, two
    host-f64 refinement steps through them, the collectives by kind."""
    from gauss_tpu_torch.dist import gauss_dist_blocked as gdb
    from gauss_tpu_torch.dist import gauss_dist_blocked2d as g2d
    from gauss_tpu_torch.obs import collectives

    if engine == "cuda-dist-blocked":
        prepare, solve = gdb.prepare_dist_blocked, gdb.lu_solve_dist_blocked

        def factor(staged):
            return gdb.factor_solve_dist_blocked_staged(staged, mesh)[1]
    else:
        prepare, solve = g2d.prepare_dist_blocked2d, \
            g2d.lu_solve_dist_blocked2d

        def factor(staged):
            return g2d.factor_dist_blocked2d(staged, mesh)
    t0 = time.perf_counter()
    staged = prepare(a, b, mesh)
    sync()
    stage_s = time.perf_counter() - t0
    with collectives.counting() as budget:
        t0 = time.perf_counter()
        fac = factor(staged)
        sync()
        factor_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        x = solve(fac, b64)
        sync()
        solve_s = time.perf_counter() - t0
    x = gdb.host_refine(a64, b64, x.cpu().numpy(),
                        lambda r: solve(fac, r), 2, 0.0)
    res = rel_res(a64, x, b64)
    require(np.isfinite(x).all() and res <= GATE,
            f"{engine} at n={len(b)}: residual {res}")
    return {"n": len(b), "panel": staged[-1], "stage_s": round(stage_s, 4),
            "factor_s": round(factor_s, 4), "solve_s": round(solve_s, 4),
            "rel_residual": res, "collectives": {
                op: v["count"] for op, v in sorted(budget.items())}}


def dist_engines(work: str) -> dict:
    """Phase 14 (a)-(c), in a process of its own (``dist_child``): NCCL's
    init and teardown touch no other phase."""
    import torch
    import torch.distributed as dist

    from gauss_tpu_torch import dist as tdist
    from gauss_tpu_torch.cli import gauss_internal, matmul
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.dist import gauss_dist_blocked as gdb
    from gauss_tpu_torch.dist import mesh as tmesh
    from gauss_tpu_torch.dist import multihost
    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.kernels import _build

    backend = "nccl" if DEVICE == "cuda" else "gloo"
    require(DEVICE != "cuda" or dist.is_nccl_available(), "torch.distributed "
            "has no NCCL: the distributed engines on the card need it (no "
            "switch to gloo)")
    out = {"card": smi_line() if DEVICE == "cuda" else "cpu"}
    t_a = time.perf_counter()
    multihost.initialize(device=DEVICE)
    require(dist.get_backend() == backend and dist.get_world_size() == 1,
            f"not a world of one over {backend}: {dist.get_backend()}")
    mesh1, mesh2 = tmesh.make_mesh(1), tmesh.make_mesh_2d(1, 1)
    rec = tdist.recommend_engine(DIST_N)
    want = ("gauss_solve_dist_blocked2d_refined"
            if DIST_N >= tdist.DIST_2D_CROSSOVER_N
            else "gauss_solve_dist_blocked_refined")
    require(rec.__name__ == want, f"recommend_engine({DIST_N}) is "
            f"{rec.__name__}")
    aw, bw = dist_system(DIST_WARM_N)
    aw64, bw64 = aw.astype(np.float64), bw.astype(np.float64)
    for eng, m in (("cuda-dist-blocked", mesh1),
                   ("cuda-dist-blocked2d", mesh2)):
        dist_leg(eng, m, aw, bw, aw64, bw64)          # warm-up
    blocked.solve_refined(aw, bw, iters=2, device=DEVICE)
    a, b = dist_system(DIST_N)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    # (a): the main path, counts set to 0 just before and read after.
    _build.reset_launches()
    legs = {"cuda-dist-blocked": dist_leg("cuda-dist-blocked", mesh1, a, b,
                                          a64, b64)}
    launches_1d = {k: _build.LAUNCHES[k] for k in KERNEL1_KEYS}
    legs["cuda-dist-blocked2d"] = dist_leg("cuda-dist-blocked2d", mesh2, a,
                                           b, a64, b64)
    out["launches_a"] = dict(_build.LAUNCHES)
    require(out["launches_a"] == {**{k: 0 for k in _build.LAUNCHES},
                                  **launches_1d},
            f"(a) launched other kernels: {out['launches_a']}")
    nb = -(-DIST_N // gdb.auto_panel_dist(DIST_N, 1))
    require(sum(launches_1d.values()) == (nb if DEVICE == "cuda" else 0),
            f"(a) kernel 1 launched {launches_1d}, not once a panel ({nb})")
    # The port's single-card backend on the same system, same run.
    t0 = time.perf_counter()
    fac = blocked.resolve_factor(DIST_N, "auto", device=DEVICE)(
        a, device=DEVICE)
    sync()
    cuda_factor_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocked.lu_solve(fac, b)
    sync()
    legs["cuda"] = {"factor_s": round(cuda_factor_s, 4),
                    "solve_s": round(time.perf_counter() - t0, 4)}
    del fac
    # Every kernel-1 launch of one 1-D solve held on a re-run.
    seen = {}
    with held_kernel1(seen):
        gdb.factor_solve_dist_blocked_staged(
            gdb.prepare_dist_blocked(a, b, mesh1), mesh1)
    held = {k: seen.get(k, 0) for k in KERNEL1_KEYS}
    require(not seen.get("bad") and sum(held.values()) == nb and (
        DEVICE != "cuda" or held == launches_1d),
        f"(a) held kernel-1 launches {seen} against {launches_1d}")
    out["a"] = {"legs": legs, "kernel1_launches": launches_1d,
                "held": held, "held_max_abs_err": seen.get("max_abs_err"),
                "recommend_engine": rec.__name__,
                "wall_s": round(time.perf_counter() - t_a, 1)}
    for eng, leg in legs.items():
        print(f"phase 14 (a): {eng}: {leg}")
    print(f"phase 14 (a): kernel 1 {launches_1d}, each held bit for bit "
          f"({held}); recommend_engine({DIST_N}) = {rec.__name__}")

    # (b) every distributed backend through the CLIs, on (a)'s world (the
    # external run is a process of its own: ``dist_external``), (c) the
    # multihost path on one card; their launches counted together.
    t_b = time.perf_counter()
    _build.reset_launches()
    lines, walls = {}, {}
    for be in DIST_BACKENDS:
        t0 = time.perf_counter()
        o = run_cli(gauss_internal, ["-s", str(DIST_CLI_N), "-t", "1",
                                     "--verify", "--backend", be,
                                     "--device", DEVICE])
        lines[be] = [ln for ln in o.splitlines()
                     if ln.startswith("Application time")][0]
        walls[be] = round(time.perf_counter() - t0, 2)
    o = run_cli(matmul, [str(DIST_CLI_N), "--engines", "cuda-dist", "-t",
                         "1", "--device", DEVICE])
    require("verify: OK" in o, "matmul cuda-dist did not verify")
    lines["matmul cuda-dist"] = o.strip().splitlines()[0]
    out["b"] = {"lines": lines, "cli_wall_s": walls,
                "wall_s": round(time.perf_counter() - t_b, 1)}
    multihost.shutdown()
    t_c = time.perf_counter()
    base = os.path.join(work, "multihost.jsonl")
    for f in os.listdir(work):
        if f.startswith("multihost."):
            os.remove(os.path.join(work, f))
    port = free_port()
    run_cli(gauss_internal, ["-s", str(DIST_CLI_N), "--verify", "--backend",
                             "cuda-dist-blocked", "--coordinator",
                             f"127.0.0.1:{port}", "--num-processes", "1",
                             "--process-id", "0", "--metrics-out", base,
                             "--device", DEVICE])
    stream = os.path.join(work, "multihost.p0.jsonl")
    require(os.path.isfile(stream) and not os.path.exists(base),
            f"(c) the stream is not {stream}")
    merged = os.path.join(work, "multihost.merged.jsonl")
    r = subprocess.run([sys.executable, "-m", "gauss_tpu_torch.obs.aggregate",
                        stream, "-o", merged], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    require(r.returncode == 0, f"(c) aggregate exited {r.returncode}: "
            f"{r.stderr[-2000:]}")
    events = [json.loads(ln) for ln in open(merged)]
    colls = {ev["op"]: ev["count"] for ev in events
             if ev["type"] == "collective"}
    require(colls.get("all_gather", 0) > 0 and all(
        ev["proc"] == 0 for ev in events), f"(c) merged stream: {colls}")
    out["c"] = {"stream": os.path.relpath(stream, REPO),
                "merged_events": len(events), "collectives": colls,
                "report": r.stdout.strip().splitlines()[0],
                "wall_s": round(time.perf_counter() - t_c, 1)}
    out["launches_bc"] = dict(_build.LAUNCHES)
    bc_k1 = {k: _build.LAUNCHES[k] for k in KERNEL1_KEYS}
    # (b)'s and (c)'s kernel-1 launches are the n=2048 1-D engine's: one
    # solve of it held on a re-run (each CLI run solves twice: the warm-up
    # at shape, then the timed solve), on the external system, whose
    # answer is held to a float32 backward error: the distributed backends
    # do not refine (as in the JAX package), so phase 4's criterion for
    # cuda-rowelim, not the 1e-4 forward gate.
    seen = {}
    multihost.ensure_world(DEVICE)
    try:
        g64 = synthetic.generator_matrix(DIST_CLI_N)
        gb64 = synthetic.manufactured_rhs(
            g64, synthetic.manufactured_solution(DIST_CLI_N))
        with held_kernel1(seen):
            xg = gdb.gauss_solve_dist_blocked(g64.astype(np.float32),
                                              gb64.astype(np.float32))
    finally:
        multihost.shutdown()
    xg = xg.cpu().numpy().astype(np.float64)
    eta = float(np.abs(gb64 - g64 @ xg).max() / (
        np.abs(g64).sum(1).max() * np.abs(xg).max() + np.abs(gb64).max()))
    require(eta <= BACKWARD_TOL, f"(b) external cuda-dist-blocked: "
            f"backward error {eta} > {BACKWARD_TOL}")
    lines["external backward error"] = f"{eta:.3e}"
    held_bc = {k: seen.get(k, 0) for k in KERNEL1_KEYS}
    per_solve = held_bc if DEVICE == "cuda" else {k: 0 for k in held_bc}
    require(not seen.get("bad") and sum(held_bc.values()) > 0 and all(
        bc_k1[k] == 4 * per_solve[k] for k in KERNEL1_KEYS),
        f"(b), (c) kernel-1 launches {bc_k1} against one held solve "
        f"{seen}")
    out["c"]["held_per_solve"] = held_bc
    out["c"]["held_max_abs_err"] = seen.get("max_abs_err")
    print(f"phase 14 (b): {json.dumps(lines)}")
    print(f"phase 14 (c): {json.dumps(out['c'])}")
    return out


def dist_external(dat: str) -> dict:
    """Phase 14 (b)'s external run, in a process of its own beside (a):
    ``gauss_external`` on the generator system (written to ``dat`` first
    where no earlier phase left it) through ``cuda-dist-blocked`` on a
    world of one; its stdout and kernel launches."""
    from gauss_tpu_torch.cli import gauss_external
    from gauss_tpu_torch.io import datfile, synthetic
    from gauss_tpu_torch.kernels import _build

    if not os.path.isfile(dat):
        os.makedirs(os.path.dirname(dat), exist_ok=True)
        datfile.write_dat(dat, synthetic.generator_matrix(DIST_CLI_N))
    _build.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = gauss_external.main([dat, "1", "--backend", "cuda-dist-blocked",
                                  "--device", DEVICE])
    return {"rc": rc, "out": buf.getvalue(), "launches": dict(_build.LAUNCHES)}


def dist_child(work: str) -> dict:
    """``dist_engines`` with its host figures, as one JSON value."""
    import torch

    if DEVICE == "cuda":
        torch.cuda.init()
    return dist_engines(work)


def native_engines(build_s: float, work: str) -> dict:
    """Phase 14 (d): the native engines on the card's host through the
    CLIs, from the clean build of ``native_build``."""
    from gauss_tpu_torch.cli import gauss_internal, matmul

    out = {"make_s": round(build_s, 3), "lines": {}}
    for engine in ("seq", "omp", "threads", "forkjoin", "tiled"):
        o = run_cli(gauss_internal, ["-s", str(NATIVE_N), "-t",
                                     str(NATIVE_THREADS), "--verify",
                                     "--backend", engine, "--device",
                                     DEVICE])
        out["lines"][engine] = [ln for ln in o.splitlines()
                                if ln.startswith("Application time")][0]
    o = run_cli(matmul, [str(NATIVE_N), "--engines", "cuda,seq,omp", "-t",
                         str(NATIVE_THREADS), "--device", DEVICE])
    require(o.count("verify: OK") == 3, "matmul cuda,seq,omp: a mismatch")
    out["lines"]["matmul"] = o.strip().splitlines()
    return out


def native_child(clean: str, work: str) -> dict:
    """Phase 14 (d) in a process of its own: ``make`` into the empty dir
    ``clean`` (its seconds), then ``native_engines`` on that build."""
    from gauss_tpu_torch import native

    shutil.rmtree(clean, ignore_errors=True)
    make_s = native.build(clean)
    os.environ["GAUSS_TPU_TORCH_NATIVE_DIR"] = clean
    return native_engines(make_s, work)


def _start_child(st: dict, key: str, call: str) -> None:
    """``call`` (an expression on this script imported as ``c``, with
    phase 14's sizes) in a new process, its output in ``<work>/<key>.log``
    and its value as JSON on the last line."""
    sets = "".join(f"c.{k} = {globals()[k]!r}; " for k in (
        "DEVICE", "DIST_N", "DIST_WARM_N", "DIST_CLI_N", "NATIVE_N",
        "NATIVE_THREADS"))
    code = (f"import json, sys; sys.path.insert(0, {REPO!r}); "
            f"import chip_smoke as c; {sets}"
            f"print(json.dumps({call}, default=str))")
    log = os.path.join(st["work"], f"{key}.log")
    with open(log, "w") as f:
        st[key] = (subprocess.Popen([sys.executable, "-c", code], stdout=f,
                                    stderr=subprocess.STDOUT, cwd=REPO),
                   log)


def _finish_child(st: dict, key: str, label: str) -> dict:
    """Wait for a part of phase 14; the seconds from the phase's start to
    its last output (its log's time) go to ``st["ended_s"]``."""
    proc, log = st[key]
    rc = proc.wait(timeout=900)
    with open(log) as f:
        text = f.read()
    require(rc == 0, f"phase 14 {label} exited {rc}: {text[-4000:]}")
    st.setdefault("ended_s", {})[key] = round(
        os.path.getmtime(log) - st["t0_unix"], 1)
    return text, json.loads(text.strip().splitlines()[-1])


def start_phase_dist() -> dict:
    """Phase 14's start, its three parts each in a process of its own:
    (a)-(c) (``dist_child``), (b)'s external run (``dist_external``, on
    phase 4's generator file where a whole run wrote it) and (d)
    (``native_child``, on the card's host). Returns what
    ``finish_phase_dist`` waits for; in a whole run it starts beside phase
    13's checks and campaigns."""
    st = {"t0": time.perf_counter(), "t0_unix": time.time(),
          "work": os.path.join(REPO, "build", "chip_smoke", "dist")}
    os.makedirs(st["work"], exist_ok=True)
    dat = os.path.join(REPO, "build", "chip_smoke",
                       f"generator_{DIST_CLI_N}.dat")
    _start_child(st, "child", f"c.dist_child({st['work']!r})")
    _start_child(st, "external", f"c.dist_external({dat!r})")
    _start_child(st, "native", f"c.native_child("
                 f"{os.path.join(st['work'], 'native')!r}, "
                 f"{st['work']!r})")
    return st


def stop_phase_dist(st: dict) -> None:
    """Leave nothing of phase 14 behind after a failure elsewhere."""
    for key in ("child", "external", "native"):
        proc = st[key][0]
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def finish_phase_dist(st: dict):
    """Phase 14's end: its processes waited for, their output printed.
    Returns the launch counts of (a)'s main path and of (b) + (c), and the
    phase's figures."""
    text, child = _finish_child(st, "child", "(a)-(c)")
    print(text.rstrip())
    _, ext = _finish_child(st, "external", "(b) external")
    for line in ext["out"].strip().splitlines():
        print(f"    | {line}")
    err = float(re.search(r"Error: (\S+)", ext["out"]).group(1))
    require(ext["rc"] == 0 and np.isfinite(err),
            f"gauss_external cuda-dist-blocked: rc {ext['rc']}, Error {err}")
    # Its kernel 1 is (b)/(c)'s n=2048 solve, held there on a re-run: two
    # solves (the warm-up at shape, then the timed one).
    per_solve = child["c"]["held_per_solve"] if DEVICE == "cuda" else {}
    require(all(ext["launches"][k] == 2 * per_solve.get(k, 0)
                for k in KERNEL1_KEYS), f"(b) external kernel-1 launches "
            f"{ext['launches']} against {per_solve} a solve")
    child["b"]["lines"]["external cuda-dist-blocked"] = (
        [ln for ln in ext["out"].splitlines() if ln.startswith("Time")][0]
        + f", Error {err:e}")
    for k, v in ext["launches"].items():
        child["launches_bc"][k] += v
    text, d = _finish_child(st, "native", "(d)")
    print(text.rstrip())
    print(f"phase 14 (d): make {d['make_s']} s (a clean build dir); "
          f"{json.dumps(d['lines'])}")
    # The phase's time: its start to the end of its last part (in a whole
    # run it waits for phase 8 after that).
    wall = max(st["ended_s"].values())
    span = time.perf_counter() - st["t0"]
    print(f"phase 14: {wall:.1f} s to its last part's end (budget "
          f"{DIST_BUDGET_S:.0f} s{'' if wall <= DIST_BUDGET_S else ', PAST IT'}"
          f"; parts {st['ended_s']}); {span:.1f} s to this line")
    figs = {"a": child["a"], "b": child["b"], "c": child["c"], "d": d,
            "wall_s": wall, "ended_s": st["ended_s"],
            "span_s": round(span, 1), "card": child["card"]}
    print(json.dumps({"dist": figs}))
    return child["launches_a"], child["launches_bc"], figs


def phase_dist():
    """The distributed and native engines (module docstring, phase 14),
    alone: returns what ``finish_phase_dist`` returns."""
    st = start_phase_dist()
    try:
        return finish_phase_dist(st)
    finally:
        stop_phase_dist(st)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20,
                    help="timed launches per kernel (median reported)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing run", file=sys.stderr)
        return 1
    t_main = time.perf_counter()

    def done(label):
        print(f"chip_smoke: {label} done at {time.perf_counter() - t_main:.1f}"
              f" s")
    sys.path.insert(0, REPO)
    phase_toolchain()
    phase_build()
    done("phases 1-2")
    k1, k2, k3 = phase_kernels(args.reps)
    km = phase_elim_matmul_kernels(args.reps)
    spmv, systems = phase_spmv_kernel(args.reps)
    done("phase 3")
    blocked_launches, dat = phase_main_path()
    by_path = {"blocked": blocked_launches, **phase_elim_matmul_paths(dat)}
    for path, counts in by_path.items():
        require(counts["spmv_ell"] == 0, f"path {path} launched the SpMV "
                f"kernel {counts['spmv_ell']} times")
    by_path["sparse"] = phase_sparse_path(spmv, systems)
    done("phase 4")
    by_path["telemetry"], tele = phase_telemetry(dat)
    done("phase 5")
    by_path["large_n"], large = phase_large_n()
    done("phase 6")
    by_path["lowered"], low = phase_lowered(args.reps)
    done("phase 7")
    # Phase 14 runs beside phase 8, whose checks hold no time (its three
    # parts in processes of their own; NCCL's init and teardown touch no
    # other phase), and ends after it.
    dist_st = start_phase_dist()
    try:
        by_path["structure"], struct = phase_structure(args.reps)
        require(by_path["structure"]["panel_factor_batched"] > 0,
                "the structure path launched no batched panel kernel")
        done("phase 8")
        by_path["dist"], by_path["dist_cli"], dist_fig = finish_phase_dist(
            dist_st)
    finally:
        stop_phase_dist(dist_st)
    done("phase 14")
    by_path["serve"], serve = phase_serve(args.reps)
    done("phase 9")
    by_path["resilience"], res = phase_resilience(args.reps)
    done("phase 10")
    by_path["outofcore"], ooc = phase_outofcore()
    done("phase 11")
    # Phase 13's timed run follows phase 12 (b)'s, each with the card to
    # itself; phase 13's campaigns then run beside both phases' checks.
    bg = {}
    try:
        by_path["net"], net_fig = phase_net(
            serve["service"], beside=lambda: start_router_phase(bg))
    except BaseException:
        stop_router_phase(bg)
        raise
    done("phase 12")
    by_path["router"], router_fig = phase_router({
        "serve_solves_per_s": serve["service"]["solves_per_s"],
        "net_solves_per_s": net_fig["wire"]["solves_per_s"]}, bg)
    done("phase 13")
    for path in ("dist", "dist_cli"):
        require(sum(by_path[path][k] for k in KERNEL1_KEYS) > 0,
                f"the {path} path launched no kernel 1")
    for name in ("panel_trailing_fused_batched", "panel_factor_batched",
                 "panel_trailing_fused_batched_bf16",
                 "panel_factor_batched_bf16", "spmv_ell"):
        require(by_path["router"][name] > 0, f"the router path launched no "
                f"{name}")
    for name in ("panel_trailing_fused_batched",
                 "panel_trailing_fused_batched_bf16",
                 "panel_factor_batched_bf16", "panel_factor_batched",
                 "panel_trailing_fused", "spmv_ell"):
        require(by_path["net"][name] > 0, f"the net path launched no "
                f"{name}")
    require(by_path["outofcore"]["panel_trailing_fused"] > 0
            and by_path["outofcore"]["panel_factor_grid"] > 0
            and by_path["outofcore"]["panel_factor"] > 0,
            "the out-of-core path launched no kernel-2, grid-route or "
            "one-block kernel-1 launch")
    require(by_path["resilience"]["panel_factor_grid"] > 0
            and by_path["resilience"]["panel_factor_cluster"] > 0,
            "the resilience path launched no grid- or cluster-route panel "
            "kernel")
    for name in ("panel_trailing_fused_batched",
                 "panel_trailing_fused_batched_bf16",
                 "panel_factor_batched_bf16", "panel_factor_batched"):
        require(by_path["serve"][name] > 0, f"the serve path launched no "
                f"{name}")
    for name in ("panel_factor_cluster_bf16", "panel_factor_grid_bf16",
                 "panel_trailing_fused_bf16"):
        require(by_path["lowered"][name] > 0, f"the lowered path launched "
                f"no {name}")
    # Queue-3 fault 1: the traced calls' takes (a second take follows a
    # first that lost a kernel record), and the batch traced in the
    # server's own process, which is not taken again.
    takes = {f"phase 6 (c) n={cell['n']}": cell.get("traces")
             for cell in large["cells"]}
    takes["phase 7 (d)"] = low["large"].get("traces")
    takes["phase 9 (c)"] = serve["batch"]["traces"]
    own = serve["batch"]["own_process_trace"]
    print(f"traced calls (queue-3 fault 1): takes {takes}; calls whose first "
          f"take lost a record: {sum(t == 2 for t in takes.values())} of "
          f"{len(takes)}; the batch in the server's own process lost "
          f"{own['lost']} of {own['planned_kernels']} kernel records")
    # A kernel's launches: the sum over the main paths that run it.
    launches = {name: sum(c[name] for c in by_path.values())
                for name in blocked_launches}

    def launch_keys(name):
        return {"launches": launches[name], "launches_by_path": {
            p: c[name] for p, c in by_path.items() if c[name]}}

    def res_routes(name):
        """Phase 10's launches of a kernel by route."""
        return {k.split("/")[1]: v for k, v in res["launches"].items()
                if k.split("/")[0] == name}

    src = "gauss_tpu_torch/kernels/csrc/"
    tall, grid = k1["shapes"][(N, PANEL)], k1["shapes"][(2 * N, PANEL)]
    ob32, ob16 = low["one_block"]["float32"], low["one_block"]["bfloat16"]
    strip_lib = low["one_block"]["lu_factor_strip_ms"]

    def tallest(rec, prefix):
        """Kernel 1's or 2's record at the n=8192 form's tallest strip."""
        return {k[len(prefix):]: v for k, v in rec.items()
                if k.startswith(prefix)}
    kernels = [
        {"name": "panel_factor_cluster", "route": "cuda",
         "source": src + "panel_cluster.cu",
         "replaces": "gauss_tpu/kernels/panel_pallas.py:253",
         **launch_keys("panel_factor_cluster"),
         "max_abs_err": k1["err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
         "shape": f"({PANEL}, {PANEL}), the last panel of n={N}, a cluster "
                  f"of {k1['geom'].cluster}",
         f"({N}, {PANEL})": {key: tall[key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "err")},
         "batched_solve_strips_ms": km["panel_batched_ms"],
         "batched_solve_strips_library_ms": km["panel_batched_library_ms"],
         "batched_solve_strips_bound_ms": km["panel_batched_bound_ms"],
         "phase_profile_share": tele["phase_share"],
         "large_n": large_n_summary(large, "panel_factor_cluster"),
         "outofcore": ooc_summary(ooc, "panel_factor_cluster"),
         "dist": dist_summary(dist_fig, "panel_factor_cluster")},
        {"name": "panel_factor_grid", "route": "cuda",
         "source": src + "panel_grid.cu",
         "sources": [src + "panel_grid.cu", src + "panel_grid.cuh",
                     src + "panel_cluster.cuh", src + "panel_common.cuh"],
         "replaces": "gauss_tpu/kernels/panel_pallas.py:253",
         **launch_keys("panel_factor_grid"),
         "max_abs_err": grid["err"], "ms": grid["ms"],
         "plain_ms": grid["plain_ms"], "bound_ms": grid["bound_ms"],
         "bound_by": grid["bound_by"], "library_ms": grid["library_ms"],
         "one_block_ms": grid["one_block_ms"],
         "shape": f"({2 * N}, {PANEL}), taller than a cluster holds: a grid "
                  f"of {grid['geom'].blocks} blocks (one_block_ms: the "
                  f"one-block kernel on the same strip)",
         "(7424, 256)": {
             "ms": ob32["panel_ms"], "one_block_ms":
             ob32["panel_one_block_ms"], "library_ms": strip_lib,
             "bound_ms": ob32["panel_bound_ms"], "err": ob32["panel_err"]},
         "large_n": large_n_summary(large, "panel_factor_grid"),
         "outofcore": ooc_summary(ooc, "panel_factor_grid"),
         "dist": dist_summary(dist_fig, "panel_factor_grid")},
        {"name": "panel_factor", "route": "cuda",
         "source": src + "panel_factor.cu",
         "replaces": "gauss_tpu/kernels/panel_pallas.py:253",
         **launch_keys("panel_factor"),
         "max_abs_err": grid["one_block_err"], "ms": grid["one_block_ms"],
         "plain_ms": grid["plain_ms"], "bound_ms": grid["bound_ms"],
         "bound_by": grid["bound_by"], "library_ms": grid["library_ms"],
         "shape": f"({2 * N}, {PANEL}) through panel_factor_one_block: the "
                  f"rule sends it only strips beyond the grid's reach, which "
                  f"only the out-of-core path factors (its launches and "
                  f"times there: outofcore)",
         "large_n": large_n_summary(large, "panel_factor"),
         "outofcore": ooc_summary(ooc, "panel_factor")},
        {"name": "panel_trailing_fused", "route": "cuda",
         "source": src + "panel_fused.cu",
         "sources": [src + "panel_fused.cu", src + "panel_fused.cuh",
                     src + "panel_grid.cuh", src + "panel_cluster.cuh",
                     src + "panel_common.cuh"],
         "phase_a_routes": sorted(k2["routes"]),
         "replaces": "gauss_tpu/kernels/panel_fused_pallas.py:192",
         **launch_keys("panel_trailing_fused"),
         "max_abs_err": max(k2["err"], k2["tall"]["fused"]["err"]),
         "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None,
         "shape": f"sum of the 7 launches of one n={N} factorization "
                  f"(phase A on the cluster route)",
         "phase_a_ms": k2["phase_a_ms"], "phase_b_ms": k3["ms"],
         "device_ms": k2["device_ms"],
         "phase_a_device_ms": k2["phase_a_device_ms"],
         "phase_b_device_ms": k3["device_ms"],
         f"({2 * N}, {2 * N}) grid route": {
             key: k2["tall"]["fused"][key] for key in (
                 "ms", "plain_ms", "bound_ms", "err")},
         "(8192, 1024) grid route": tallest(ob32, "fused_"),
         "factorization_ms": k2["factorization_ms"],
         "factorization_lu_factor_ms": k2["lu_factor_ms"],
         "large_n": large_n_summary(large, "panel_trailing_fused"),
         "resilience_by_route": res_routes("panel_trailing_fused"),
         "outofcore": ooc_summary(ooc, "panel_trailing_fused")},
        {"name": "trailing_update", "route": "cuda",
         "source": src + "panel_fused.cu",
         "replaces": "gauss_tpu/kernels/panel_fused_pallas.py:332",
         **launch_keys("trailing_update"),
         "max_abs_err": k3["err"], "ms": k3["ms"],
         "device_ms": k3["device_ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None,
         "shape": f"sum of the 7 trailing shapes of one n={N} "
                  f"factorization"},
    ]
    reach = low["bf16_reach"]
    p16, b16 = low["panel"][N], low["panel"][reach + 1]
    f16, t16 = low["fused"][f"({N}, {N})"], low["fused"][
        f"({reach + 1}, {4 * PANEL})"]
    for name, rec, shape in (
            ("panel_factor_cluster_bf16", p16,
             f"({N}, {PANEL}) bfloat16, the cluster route"),
            ("panel_factor_grid_bf16", b16,
             f"({reach + 1}, {PANEL}) bfloat16, the first height past a "
             f"bfloat16 cluster's reach: the grid route")):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": src + ("panel_cluster.cu" if "cluster" in name
                              else "panel_grid.cu"),
             "replaces": "gauss_tpu/kernels/panel_pallas.py:253",
             **launch_keys(name), "max_abs_err": rec["err"],
             "ms": rec["ms"], "plain_ms": rec["plain_ms"],
             "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
             "library_ms": rec["library_ms"], "f32_ms": rec["f32_ms"],
             "shape": shape + " (library: lu_factor on the float32 strip)",
             "large_n": {f"n={low['large']['n']}": {
                 k.split("/")[1]: v for k, v in low["large"][
                     "launches"].items() if k.split("/")[0] == name}}})
    kernels.append(
        {"name": "panel_factor_bf16", "route": "cuda",
         "source": src + "panel_factor.cu",
         "replaces": "gauss_tpu/kernels/panel_pallas.py:253",
         **launch_keys("panel_factor_bf16"),
         "max_abs_err": ob16["panel_one_block_err"],
         "ms": ob16["panel_one_block_ms"], "plain_ms": ob16["panel_plain_ms"],
         "bound_ms": ob16["panel_bound_ms"],
         "bound_by": ob16["panel_bound_by"], "library_ms": strip_lib,
         "grid_route_ms": ob16["panel_ms"],
         "shape": "(7424, 256) bfloat16 through panel_factor_one_block "
                  "(library: lu_factor on the float32 strip; grid_route_ms: "
                  "the rule's kernel on the same strip): the rule sends it "
                  "only strips beyond the grid's reach, which no main path "
                  "factors"})
    kernels.append(
        {"name": "panel_trailing_fused_bf16", "route": "cuda",
         "source": src + "panel_fused.cu",
         "sources": [src + "panel_fused.cu", src + "panel_fused.cuh",
                     src + "panel_grid.cuh", src + "panel_cluster.cuh",
                     src + "panel_common.cuh"],
         "replaces": "gauss_tpu/kernels/panel_fused_pallas.py:192",
         **launch_keys("panel_trailing_fused_bf16"),
         "max_abs_err": f16["err"], "ms": f16["ms"],
         "plain_ms": f16["plain_ms"], "bound_ms": f16["bound_ms"],
         "bound_by": f16["bound_by"], "library_ms": None,
         "f32_ms": f16["f32_ms"],
         "max_err_over_scale": f16["err_rel"],
         "differing_share": f16["share"],
         "shape": f"({N}, {N}) bfloat16, panel at column 0, phase A on the "
                  f"cluster route (tolerance {TOL_BF16} of the block's "
                  f"scale, at most {TOL_BF16_SHARE} of the trailing "
                  f"elements differing)",
         f"({reach + 1}, {4 * PANEL}) grid route": {
             key: t16[key] for key in ("ms", "f32_ms", "plain_ms",
                                       "bound_ms", "err", "err_rel")},
         "(8192, 1024) grid route": tallest(ob16, "fused_"),
         "factorization_n8192_ms": low["large"].get("factor_ms"),
         "factorization_n8192_f32_ms": low["large"].get("f32_factor_ms"),
         "factorization_n8192_lu_factor_ms": low["large"].get(
             "lu_factor_ms")})
    kernels.append(
        {"name": "trailing_update_bf16", "route": "cuda",
         "source": src + "panel_fused.cu",
         "replaces": "gauss_tpu/kernels/panel_fused_pallas.py:332",
         **launch_keys("trailing_update_bf16"),
         "max_abs_err": f16["err3"], "ms": f16["ms3"],
         "plain_ms": f16["plain_ms3"], "bound_ms": f16["bound3_ms"],
         "bound_by": f16["bound3_by"], "library_ms": None,
         "f32_ms": f16["f32_ms3"],
         "max_err_over_scale": f16["err3_rel"],
         "differing_share": f16["share3"],
         "shape": f"({N}, {N}) bfloat16, panel at column 0 (the unfused "
                  f"pair's leg)"})
    bat_routes = dict(struct["batched_routes"])
    for k, v in serve["service"]["batched_panel_routes"].items():
        bat_routes[k] = bat_routes.get(k, 0) + v
    for name, dt in (("panel_factor_batched", "float32"),
                     ("panel_factor_batched_bf16", "bfloat16")):
        checks = {k: r for k, r in serve["k1"].items() if r["dtype"] == dt}
        head = checks[f"(8, 256, 256) {dt}"]
        shapes = {k: r for k, r in serve["batched_launched"].items()
                  if r["shape"][3] == dt}
        if dt == "float32":
            shapes.update({f"{k} float32 (structure)": r
                           for k, r in struct["batched"].items()})
        kernels.append(
            {"name": name, "route": "cuda",
             "source": src + "panel_batched.cu",
             "sources": [src + "panel_batched.cu", src + "panel_common.cuh"],
             "symbols": {"regs": f"gtt_batched_regs{name[20:]}_kernel<...>",
                         "cluster":
                             f"gtt_batched_cluster{name[20:]}_kernel<...>",
                         "smem": f"gtt_panel_batched{name[20:]}_kernel<true>",
                         "global":
                             f"gtt_panel_batched{name[20:]}_kernel<false>"},
             "replaces": "gauss_tpu/kernels/panel_pallas.py:253",
             **launch_keys(name),
             "launches_by_route": {k.split("/")[1]: v for k, v in
                                   bat_routes.items()
                                   if k.split("/")[0] == name},
             "max_abs_err": max([r["err"] for r in checks.values()]
                                + ([struct["batched_err"]]
                                   if dt == "float32" else [])),
             "ms": head["ms"], "plain_ms": head["plain_ms"],
             "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
             "library_ms": head["library_ms"], "loop_ms": head["loop_ms"],
             "shape": f"(8, 256, 256) {dt}, a check shape of phase 9 (a) "
                      f"(the last panel of the 1024-4096 buckets at the "
                      f"ladder's full batch), on the {head['route']} route, "
                      f"one launch (library: torch.linalg.lu_factor on the "
                      f"float32 stack; loop_ms: kernel 1 looped over the "
                      f"members); the shapes the main paths launched, with "
                      f"their counts and times, are launched_shapes; every "
                      f"main-path launch held bit for bit against its plain "
                      f"version",
             "stacks": checks, "launched_shapes": shapes})
    for name, dt, sfx in (("panel_trailing_fused_batched", "float32", ""),
                          ("panel_trailing_fused_batched_bf16", "bfloat16",
                           "_bf16")):
        recs = {k: r for k, r in serve["fused"].items() if r["dtype"] == dt}
        head = next(r for r in recs.values() if r["stack"][:2] == [8, N])
        kernels.append(
            {"name": name, "route": "cuda",
             "source": src + "panel_fused_batched.cu",
             "sources": [src + "panel_fused_batched.cu",
                         src + "panel_fused.cuh", src + "panel_grid.cuh",
                         src + "panel_cluster.cuh",
                         src + "panel_common.cuh"],
             "symbols": {"cluster": f"gtt_fused_batched{sfx}_kernel<true>",
                         "grid": f"gtt_fused_batched_grid{sfx}_kernel",
                         "block": f"gtt_fused_batched{sfx}_kernel<false>"},
             "replaces": "gauss_tpu/kernels/panel_fused_pallas.py:192",
             **launch_keys(name),
             "launches_by_route": {
                 k.split("/")[1]: v for k, v in
                 serve["service"]["batched_fused_routes"].items()
                 if k.split("/")[0] == name},
             "max_abs_err": max(r["err"] for r in recs.values()),
             "ms": head["ms"], "plain_ms": head["plain_ms"],
             "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
             "library_ms": head["library_ms"], "loop_ms": head["loop_ms"],
             "one_block_ms": head["one_block_ms"],
             "phase_a": {k: head[k] for k in ("route", "groups", "group")},
             "shape": f"{tuple(head['stack'])} {dt}, panel {head['panel']} "
                      f"at column 0, one launch (library: "
                      f"torch.linalg.lu_factor on the float32 stack; "
                      f"loop_ms: kernel 2 looped over the members; "
                      f"one_block_ms: the one-block route on the stack)",
             "stacks": recs,
             "rungs": {k: r for k, r in serve["rungs"].items()
                       if r["dtype"] == dt}})
    npad, wpad, k = rowelim_shape(N)
    for name, line in (("matmul_tiled", 131), ("matmul_stripe", 245)):
        hi = km[name]["high"]
        kernels.append(
            {"name": name, "route": "cuda", "source": src + "matmul.cu",
             "replaces": f"gauss_tpu/kernels/matmul_pallas.py:{line}",
             **launch_keys(name),
             "max_abs_err": max(r["err"] for r in km[name].values()),
             "ms": hi["ms"],
             "plain_ms": hi["plain_ms"], "bound_ms": hi["bound_ms"],
             "bound_by": hi["bound_by"], "library_ms": hi["library_ms"],
             "shape": f"({N}, {N}, {N}), precision \"high\" (bf16x3)",
             **{prec: {key: r[key] for key in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "err")} for prec, r in km[name].items() if prec != "high"}})
    for name, line, shape in (
            ("eliminate_step", 71, f"({npad}, {wpad}), i={npad // 2 - 1}"),
            ("rankk_update", 160, f"({npad}, {wpad}), k={k}")):
        r = km[name]
        kernels.append(
            {"name": name, "route": "cuda", "source": src + "rowelim.cu",
             "replaces": f"gauss_tpu/kernels/rowelim_pallas.py:{line}",
             **launch_keys(name), "max_abs_err": r["err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "shape": shape})
    big = spmv[(max(SPARSE_NS), "f64")]
    kernels.append(
        {"name": "spmv_ell", "route": "cuda", "source": src + "spmv.cu",
         "replaces": "gauss_tpu/sparse/spmv.py:74", **launch_keys("spmv_ell"),
         "max_abs_err": big["err"], "ms": big["ms"],
         "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
         "bound_by": big["bound_by"], "library_ms": big["library_ms"],
         "shape": f"ELL {tuple(big['shape'])} float64 (torch.mv on the "
                  f"same matrix as CSR is the library call)",
         "stock_gather_sum_ms": big["stock_ms"],
         "shapes": [spmv[key] for key in sorted(spmv)]})
    print(f"chip_smoke: phases 1-14 in {time.perf_counter() - t_main:.1f} s "
          f"(phase 12: {net_fig['wall_s']} s, phase 13: "
          f"{router_fig['wall_s']} s, phase 14: {dist_fig['wall_s']} s)")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

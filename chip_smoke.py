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
   panel factor's two routes bit for bit (the cluster kernel at (256,
   256) and (2048, 256), the one-block kernel at (4096, 256)), each with
   its geometry, clusters at once, ptxas usage, us per pivot step and
   ``torch.linalg.lu_factor`` beside it, and the cluster kernel at the
   sizes of PANEL_CLUSTER_SWEEP; the fused panel+trailing
   kernel and the standalone trailing kernel at all 7 fused launch shapes
   (h = 2048 - kb, kb = 0, 256, ..., 1536) and the fused kernel at a
   (4096, 4096) block, whose strip takes phase A's one-block route, each
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
     tallest live strips take the one-block kernel and the other 13 the
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
     CG, GMRES, BiCGStab) and its giant leg (CG at n = 100,000), then the
     same with ``--giant-n 1000000`` (19 M stored entries, 444 MB of ELL
     state on the card); each preconditioner kind once at the smoke size;
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
6. The ``kernels`` JSON line, the card line, and the final
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
    # The one-block route of phase A: a strip taller than a cluster holds.
    k2["tall"] = fused_shape(max(3, reps // 4), rng, 2 * N, 2 * N, 0)
    k2["routes"].add(k2["tall"]["route"])
    require(DEVICE != "cuda" or k2["tall"]["route"] == "block",
            "the tall strip's fused launch did not take the one-block route")

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
    where = (f"{geom.route} route (phase A on a cluster of {geom.cluster}"
             if geom.route == "cluster" else
             "block route (phase A on one block") + (
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


def panel_launch_key(h: int, panel: int) -> str:
    """The launch count that a panel factor of an (h, panel) strip adds
    to: the route ``panel_geometry`` gives it."""
    from gauss_tpu_torch.kernels import panel as kp

    return ("panel_factor_cluster"
            if kp.panel_geometry(h, panel).route == "cluster"
            else "panel_factor")


def panel_bound(h: int, panel: int, kb: int = 0):
    """Kernel 1's bound: the strip read and written once with the pivot
    vectors, and the operations on its live rows."""
    return bound(2.0 * h * panel * 4 + 4 * panel + 8 * h + 4,
                 panel_ops(h, panel, kb))


def phase_panel(reps: int, rng):
    """Kernel 1's two routes against the plain version, bit for bit, at
    PANEL_SHAPES: each shape's route and geometry, clusters the card holds
    at once, ms and us per pivot step beside the plain version,
    ``torch.linalg.lu_factor`` and the bound; the cluster sizes of
    PANEL_CLUSTER_SWEEP; both kernels' ptxas usage. Returns the record of
    the main path's (PANEL, PANEL) shape, with every shape's record under
    "shapes"."""
    import torch

    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    dev = torch.device(DEVICE)
    on_card = DEVICE == "cuda"
    if on_card:
        for source in ("panel_cluster", "panel_factor"):
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
        else:
            where = "one block over a global scratch"
        print(f"phase 3: {key} ({h}, {panel}) on {where}: bit for bit; ms "
              f"{ms:.4f} ({1e3 * ms / panel:.2f} us per pivot step), plain "
              f"{plain_ms:.4f}, lu_factor {lib_ms:.4f}, bound {b_ms:.5f} "
              f"({b_by}), max_abs_err {err:g}")
        records[(h, panel)] = {"key": key, "geom": geom, "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": lib_ms,
                               "err": err}
    require(not on_card or (records[(PANEL, PANEL)]["key"] ==
                            records[(N, PANEL)]["key"] ==
                            "panel_factor_cluster" and
                            records[(2 * N, PANEL)]["key"] == "panel_factor"),
            f"routes {[r['key'] for r in records.values()]}: expected the "
            f"cluster kernel at ({PANEL}, {PANEL}) and ({N}, {PANEL}), one "
            f"block at ({2 * N}, {PANEL})")
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
    # kernel; the one-block kernel runs no strip of this path.
    last = panel_launch_key(PANEL, PANEL)
    for key in ("panel_factor", "panel_factor_cluster"):
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
        require(summary["ok"] and summary["routed"]["detected"] == "sparse",
                f"sparse check at giant n={n}: {summary}")
        leg = 0
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


def trace_device(path: str):
    """``(kernel names, busy ms, span ms)`` of a Chrome trace: the names of
    its kernel events, the length of the union of its device events'
    intervals, and the time from the first device event's start to the
    last one's end."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in TRACE_DEVICE_CATS and e.get("ph") == "X"]
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
        require(torch.equal(x, y), f"phased != unrolled pallas: {field}")
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
    require(len(solves) == 3 * repeats and counters.get("sparse.solves")
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
    sys.path.insert(0, REPO)
    phase_toolchain()
    phase_build()
    k1, k2, k3 = phase_kernels(args.reps)
    km = phase_elim_matmul_kernels(args.reps)
    spmv, systems = phase_spmv_kernel(args.reps)
    blocked_launches, dat = phase_main_path()
    by_path = {"blocked": blocked_launches, **phase_elim_matmul_paths(dat)}
    for path, counts in by_path.items():
        require(counts["spmv_ell"] == 0, f"path {path} launched the SpMV "
                f"kernel {counts['spmv_ell']} times")
    by_path["sparse"] = phase_sparse_path(spmv, systems)
    by_path["telemetry"], tele = phase_telemetry(dat)
    # A kernel's launches: the sum over the main paths that run it.
    launches = {name: sum(c[name] for c in by_path.values())
                for name in blocked_launches}

    def launch_keys(name):
        return {"launches": launches[name], "launches_by_path": {
            p: c[name] for p, c in by_path.items() if c[name]}}

    src = "gauss_tpu_torch/kernels/csrc/"
    tall, block = k1["shapes"][(N, PANEL)], k1["shapes"][(2 * N, PANEL)]
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
         "phase_profile_share": tele["phase_share"]},
        {"name": "panel_factor", "route": "cuda",
         "source": src + "panel_factor.cu",
         "replaces": "gauss_tpu/kernels/panel_pallas.py:253",
         **launch_keys("panel_factor"),
         "max_abs_err": block["err"], "ms": block["ms"],
         "plain_ms": block["plain_ms"], "bound_ms": block["bound_ms"],
         "bound_by": block["bound_by"], "library_ms": block["library_ms"],
         "shape": f"({2 * N}, {PANEL}), taller than a cluster holds"},
        {"name": "panel_trailing_fused", "route": "cuda",
         "source": src + "panel_fused.cu",
         "sources": [src + "panel_fused.cu", src + "panel_cluster.cuh",
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
         f"({2 * N}, {2 * N}) one-block route": {
             key: k2["tall"]["fused"][key] for key in (
                 "ms", "plain_ms", "bound_ms", "err")},
         "factorization_ms": k2["factorization_ms"],
         "factorization_lu_factor_ms": k2["lu_factor_ms"]},
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
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

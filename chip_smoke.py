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
   panel factor at (256, 256) (and (2048, 256)), the fused panel+trailing
   kernel and the standalone trailing kernel at all 7 fused launch shapes
   (h = 2048 - kb, kb = 0, 256, ..., 1536). Checks identical pivots,
   values within the stated tolerances, and fused == panel + trailing bit
   for bit; times each with CUDA events (median of --reps launches), and
   one whole n=2048 factorization the same way.
3b. The same for the row-elimination and matmul kernels: the tiled and
   row-stripe matmul at (2048, 2048, 2048) in "high" and "highest" (the
   stripe also in "default") within MM_TOL; the stripe's launch geometry
   (blocks, cluster size, dynamic shared memory, copy width, clusters the
   card holds at once), its TFLOP/s and share of its bound in each mode,
   its registers and spills from ``nvcc -Xptxas -v``, and the stripe
   against its plain version at STRIPE_SHAPES in every mode, contiguous
   and as misaligned column slices; the elimination step on the (2048,
   2304) augmented shape at i = 0, 1023, 2047 bit for bit, and the rank-k update at (2048, 2304),
   k = 256, within RANKK_TOL; each timed (device time of --reps queued
   launches, see device_ms) beside its plain version, its library call
   and its bound; the panel kernel at the 8 strips of one batched solve,
   and one whole batched and one whole step solve (CUDA events per call,
   host work included).
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
     7 fused + 1 panel launches per factorization. Then a random system
     solved on the card against a float64 reference.
   - rowelim: ``--backend cuda-rowelim`` on the internal system
     (``--verify``) and on the .dat system: 8 panel + 8 rank-k launches
     per solve. The backend does not refine (as in the JAX package), so
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
5. The ``kernels`` JSON line, the card line, and the final
   ``{"ok": true, "device": ...}`` line.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
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
RANKK_TOL = 1e-5
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

    # Kernel 1: the panel factor. (256, 256) is the main path's shape (the
    # last panel of every n=2048 factorization); (2048, 256) the tallest.
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
          "err": 0.0}
    for h in (PANEL, N):
        x = torch.as_tensor(rng.standard_normal((h, PANEL)),
                            dtype=torch.float32, device=dev)
        got = kp.panel_factor(x, 0)
        ref = kp.panel_factor_plain(x, 0)
        sync()
        require(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]),
                f"panel_factor pivots differ from the plain version at "
                f"({h}, {PANEL})")
        err = float((got[0] - ref[0]).abs().max())
        scale = float(ref[0].abs().max())
        require(err <= TOL * scale, f"panel_factor at ({h}, {PANEL}): "
                f"max |kernel - plain| {err} > {TOL} x {scale}")
        require(float(got[3]) == float(ref[3]), "panel_factor min |pivot|")
        ms = cuda_event_ms(lambda: kp.panel_factor(x, 0), reps)
        plain_ms = cuda_event_ms(lambda: kp.panel_factor_plain(x, 0),
                                 max(3, reps // 4))
        lib_ms = cuda_event_ms(lambda: torch.linalg.lu_factor(x), reps)
        b_ms, b_by = bound(2.0 * h * PANEL * 4 + 4 * PANEL + 8 * h + 4,
                           panel_ops(h, PANEL, 0))
        print(f"phase 3: panel_factor ({h}, {PANEL}): ms {ms:.4f}, plain "
              f"{plain_ms:.4f}, lu_factor {lib_ms:.4f}, bound {b_ms:.5f} "
              f"({b_by}), max_abs_err {err:g}")
        if h == PANEL:
            k1.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                      library_ms=lib_ms, err=err)

    # Kernels 2 and 3 at the 7 fused launch shapes of one factorization:
    # block = the live rows m[kb:] (h = N - kb, width N), panel at col0 = kb.
    k2 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "flops": 0.0,
          "bytes": 0.0, "err": 0.0}
    k3 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "flops": 0.0,
          "bytes": 0.0, "err": 0.0}
    for kb in range(0, N - PANEL, PANEL):
        h = N - kb
        orig = torch.as_tensor(rng.standard_normal((h, N)),
                               dtype=torch.float32, device=dev)
        work = orig.clone()
        p, ipiv, perm, mp, upd = kf.panel_trailing_fused(work, kb, 0,
                                                         panel=PANEL)
        rp, ripiv, rperm, rmp, rupd = kf.panel_trailing_fused_plain(
            orig.clone(), kb, 0, panel=PANEL)
        sync()
        require(torch.equal(ipiv, ripiv) and torch.equal(perm, rperm),
                f"fused pivots differ from the plain version at kb={kb}")
        scale = float(rupd.abs().max())
        err = max(float((upd - rupd).abs().max()),
                  float((p - rp).abs().max()))
        require(err <= TOL * scale, f"fused at kb={kb}: max |kernel - "
                f"plain| {err} > {TOL} x {scale}")
        require(torch.equal(upd[:, :kb + PANEL], orig[:, :kb + PANEL]),
                f"fused wrote columns left of col0+panel at kb={kb}")
        # The unfused pair: panel kernel + reconstruction + trailing kernel.
        pair = orig.clone()
        p2, ipiv2, perm2, mp2 = kp.panel_factor(pair[:, kb:kb + PANEL], 0)
        mult, onehot = kf.reconstruct_mult_pt(p2, ipiv2, perm2, 0, PANEL)
        kf.trailing_update(pair, mult, onehot, kb)
        sync()
        require(torch.equal(pair, upd) and torch.equal(p2, p)
                and torch.equal(ipiv2, ipiv) and float(mp2) == float(mp),
                f"fused != panel + trailing bit for bit at kb={kb}")
        plain_pair = orig.clone()
        kf.trailing_update_plain(plain_pair, mult, ipiv2, kb,
                                 kf.FUSED_FSEG_SEED)
        err3 = float((pair - plain_pair).abs().max())
        require(err3 <= TOL * scale, f"trailing at kb={kb}: max |kernel - "
                f"plain| {err3} > {TOL} x {scale}")

        def reset():
            work.copy_(orig)

        ms2 = cuda_event_ms(lambda: kf.panel_trailing_fused(work, kb, 0,
                                                            panel=PANEL),
                            reps, setup=reset)
        pms2 = cuda_event_ms(lambda: kf.panel_trailing_fused_plain(
            work, kb, 0, panel=PANEL), max(3, reps // 4), setup=reset)
        ms3 = cuda_event_ms(lambda: kf.trailing_update(work, mult, ipiv2,
                                                       kb), reps,
                            setup=reset)
        pms3 = cuda_event_ms(lambda: kf.trailing_update_plain(
            work, mult, ipiv2, kb, kf.FUSED_FSEG_SEED), max(3, reps // 4),
            setup=reset)
        ncols = N - kb - PANEL
        f3 = trailing_ops(h, 0, PANEL, ncols)
        f2 = f3 + panel_ops(h, PANEL, 0)
        # The fused kernel reads and writes only columns col0 = kb onward
        # (panel out + trailing); columns left of kb hold L and are untouched.
        by2 = 8.0 * h * (N - kb) + 4 * PANEL + 8 * h + 4
        by3 = 4.0 * h * ncols * 2 + 4.0 * PANEL * h + 4 * PANEL
        b2 = bound(by2, f2)
        b3 = bound(by3, f3)
        print(f"phase 3: fused h={h} kb={kb}: ms {ms2:.4f}, plain "
              f"{pms2:.4f}, bound {b2[0]:.5f} ({b2[1]}), max_abs_err "
              f"{err:g}; trailing: ms {ms3:.4f}, plain {pms3:.4f}, bound "
              f"{b3[0]:.5f} ({b3[1]}), max_abs_err {err3:g}; fused == pair "
              f"bit for bit")
        for acc, ms_, pms_, b_, fl, by, e in (
                (k2, ms2, pms2, b2, f2, by2, err),
                (k3, ms3, pms3, b3, f3, by3, err3)):
            acc["ms"] += ms_
            acc["plain_ms"] += pms_
            acc["bound_ms"] += b_[0]
            acc["flops"] += fl
            acc["bytes"] += by
            acc["err"] = max(acc["err"], e)
    for acc in (k2, k3):
        acc["bound_by"] = bound(acc["bytes"], acc["flops"])[1]

    # One whole n=N factorization: the kernels plus the torch work between
    # launches (row gathers, diagonal-block inverses, the U-inverse pass).
    from gauss_tpu_torch.core import blocked

    a = torch.as_tensor(rng.standard_normal((N, N)), dtype=torch.float32,
                        device=dev)
    fac_ms = cuda_event_ms(lambda: blocked.lu_factor_blocked_unrolled(
        a, panel=PANEL, device=DEVICE), max(3, reps // 2))
    print(f"phase 3: one n={N} factorization (lu_factor_blocked_unrolled): "
          f"{fac_ms:.4f} ms; its kernels {k1['ms'] + k2['ms']:.4f} ms "
          f"(panel at ({PANEL}, {PANEL}) + the 7 fused shapes)")
    from gauss_tpu_torch.kernels import _build

    print(f"phase 3: launch counts over these checks and timings: "
          f"{dict(_build.LAUNCHES)}")
    return k1, k2, k3


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
    # products: the bf16 tensor-core peak bounds it) and "highest" (f32);
    # the stripe also in "default" (one bf16 product).
    a, b = rand(N, N), rand(N, N)
    mm_bytes = 3.0 * N * N * 4
    modes = (("high", 6.0 * N ** 3, PEAK_BF16_FLOP_S),
             ("highest", 2.0 * N ** 3, PEAK_F32_FLOP_S))
    for name, fn, precs in (
            ("matmul_tiled", km.matmul_tiled, modes),
            ("matmul_stripe", km.matmul_stripe,
             modes + (("default", 2.0 * N ** 3, PEAK_BF16_FLOP_S),))):
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

    # The panel kernel at the npad // k strips of one batched solve: the
    # whole (npad, k) strip, rows above kb done.
    strip = rand(npad, k)
    kb_mid = (npad // k // 2) * k
    got = kp.panel_factor(strip, kb_mid)
    want = kp.panel_factor_plain(strip, kb_mid)
    sync()
    require(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
            and torch.equal(got[0], want[0]),
            f"panel_factor at ({npad}, {k}), kb={kb_mid} differs from the "
            f"plain version")
    panel_ms = sum(device_ms(lambda: kp.panel_factor(strip, kb),
                             max(3, reps // 4)) for kb in range(0, npad, k))
    # Its bound, strip by strip as phase 3 reckons it: the strip read and
    # written once (with the pivot vectors), and the operations on the
    # rows still live below kb.
    strip_bounds = [bound(2.0 * npad * k * 4 + 4 * k + 8 * npad + 4,
                          panel_ops(npad, k, kb))
                    for kb in range(0, npad, k)]
    out["panel_batched_ms"] = panel_ms
    out["panel_batched_bound_ms"] = sum(b for b, _ in strip_bounds)
    print(f"phase 3b: panel_factor at the {npad // k} strips ({npad}, {k}) "
          f"of one batched solve: {panel_ms:.4f} ms in all; kb={kb_mid} "
          f"bit for bit; bound {out['panel_batched_bound_ms']:.5f} "
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


def ptxas_usage(source: str) -> dict:
    """Registers and bytes of spill stores of each kernel of
    ``csrc/<source>.cu`` (by mangled name), as ``nvcc -Xptxas -v`` reports
    them under the port's build flags: a throwaway build in the build
    directory."""
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
            usage[kernel] = [0, 0]
        elif kernel:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage[kernel][0] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                usage[kernel][1] = int(m.group(1))
    return usage


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
        for kernel, (regs, spill) in sorted(ptxas_usage("matmul").items()):
            m = re.search(r"gtt_matmul_stripe_kernelILi(\d)ELi(\d)E", kernel)
            if m:
                print(f"phase 3b: ptxas -v, matmul_stripe {modes[m[1]]} "
                      f"with {4 * int(m[2])}-byte copies: {regs} registers, "
                      f"{spill} bytes of spill stores")

    def sliced(x, off):
        wide = torch.zeros((x.shape[0], x.shape[1] + off + 2),
                           dtype=x.dtype, device=x.device)
        wide[:, off:off + x.shape[1]] = x
        return wide[:, off:off + x.shape[1]]

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
    require(launches["panel_factor"] == factorizations,
            f"expected 1 panel launch per factorization, got "
            f"{launches['panel_factor']} for {factorizations}")
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
    ], {"panel_factor": 2 * 2 * groups, "rankk_update": 2 * 2 * groups})
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
    # A kernel's launches: the sum over the main paths that run it.
    launches = {name: sum(c[name] for c in by_path.values())
                for name in blocked_launches}

    def launch_keys(name):
        return {"launches": launches[name], "launches_by_path": {
            p: c[name] for p, c in by_path.items() if c[name]}}

    src = "gauss_tpu_torch/kernels/csrc/"
    kernels = [
        {"name": "panel_factor", "route": "cuda",
         "source": src + "panel_factor.cu",
         "replaces": "gauss_tpu/kernels/panel_pallas.py:253",
         **launch_keys("panel_factor"),
         "max_abs_err": k1["err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
         "shape": f"({PANEL}, {PANEL}), the last panel of n={N}",
         "batched_solve_strips_ms": km["panel_batched_ms"],
         "batched_solve_strips_bound_ms": km["panel_batched_bound_ms"]},
        {"name": "panel_trailing_fused", "route": "cuda",
         "source": src + "panel_fused.cu",
         "replaces": "gauss_tpu/kernels/panel_fused_pallas.py:192",
         **launch_keys("panel_trailing_fused"),
         "max_abs_err": k2["err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None,
         "shape": f"sum of the 7 launches of one n={N} factorization"},
        {"name": "trailing_update", "route": "cuda",
         "source": src + "panel_fused.cu",
         "replaces": "gauss_tpu/kernels/panel_fused_pallas.py:332",
         **launch_keys("trailing_update"),
         "max_abs_err": k3["err"], "ms": k3["ms"],
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

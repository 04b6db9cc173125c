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
4. The main path at n=2048 through the port's CLIs: the internal system
   host-refined and double-single-refined, and a .dat external system;
   every solve verified at the 1e-4 gate, and the launch counts must show
   7 fused + 1 panel launches per factorization. Then a random system
   solved on the card against a float64 reference.
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

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N = 2048
PANEL = 256
SEED = 258458
DEVICE = "cuda"  # the card; the tests rehearse the script on "cpu"
# Published H100 SXM peaks: HBM bandwidth and float32 outside the tensor
# cores (the kernels run FP32 on CUDA cores).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
TOL = 5e-5  # relative to the operand's scale (f32 summation order)


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


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
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
    launches = phase_main_path()

    src = "gauss_tpu_torch/kernels/csrc/"
    kernels = [
        {"name": "panel_factor", "route": "cuda",
         "source": src + "panel_factor.cu",
         "replaces": "gauss_tpu/kernels/panel_pallas.py:253",
         "launches": launches["panel_factor"],
         "max_abs_err": k1["err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
         "shape": f"({PANEL}, {PANEL}), the last panel of n={N}"},
        {"name": "panel_trailing_fused", "route": "cuda",
         "source": src + "panel_fused.cu",
         "replaces": "gauss_tpu/kernels/panel_fused_pallas.py:192",
         "launches": launches["panel_trailing_fused"],
         "max_abs_err": k2["err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None,
         "shape": f"sum of the 7 launches of one n={N} factorization"},
        {"name": "trailing_update", "route": "cuda",
         "source": src + "panel_fused.cu",
         "replaces": "gauss_tpu/kernels/panel_fused_pallas.py:332",
         "launches": launches["trailing_update"],
         "max_abs_err": k3["err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None,
         "shape": f"sum of the 7 trailing shapes of one n={N} "
                  f"factorization"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Which tile, ring depth and occupancy the f32 GEMM routine should take,
and what holds it.

    python3 scripts/probe_sgemm.py [--variants 64:128:4:4,128:256:3:2]
        [--forms full,no-copy,one-lds] [--reps 20]

Builds ``csrc/rowelim.cu`` and ``csrc/matmul.cu`` once per variant
``BM:THREADS:STAGES:MIN_BLOCKS[:BK]`` of ``csrc/sgemm_common.cuh`` (its
``GTT_SGEMM_*`` defines rewritten in a copy of ``csrc/``) and form, into
``build/sgemm_probe/``, all builds in parallel. The forms are the routine
as it is (``full``) and two ablations of a copy of it, whose results are
wrong and not checked: ``no-copy`` issues no copies after the ring's
prologue (the K loop computes on stale stages: what the copies cost), and
``one-lds`` reads every K step's fragments from the stage's first K row,
so the compiler loads them once a stage (what the shared-memory fragment
reads cost). For each build it prints: the registers and bytes of spill
stores of the rank-k kernel and the tiled "highest" kernel (``-Xptxas
-v``), the blocks an SM holds (``gtt_rankk_update_info``), the grid and
its waves, and the device time of 20 queued launches
(``chip_smoke.device_ms``) of the rank-k update at (2048, 2304), k = 256,
and of the tiled "highest" product at 2048^3, the full form checked
against its plain version (1e-5 of max |plain|), beside ``torch.addmm``
and ``torch.matmul`` on the same inputs; with ``--rows``, the rank-k
update also at (R, 2304) for each R given. Needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "gauss_tpu_torch" / "kernels" / "csrc"
SMS = 132
# form -> [(text in sgemm_common.cuh, its replacement)]
ABLATIONS = {
    "full": [],
    "no-copy": [("""    if (next < kt_n)
      gtt_sgemm_load<VEC>(ring[next % S], A, lda, B, ldb, M, N, K, row0,
                          col0, next * BK);
""", "")],
    "one-lds": [("s.a[kk]", "s.a[0]"), ("s.b[kk]", "s.b[0]")],
}


def sources(variant: str, form: str, work: Path) -> Path:
    """A copy of csrc/ whose sgemm_common.cuh has the variant's defines
    and the form's edits."""
    out = work / f"{variant.replace(':', '_')}-{form}"
    out.mkdir(parents=True, exist_ok=True)
    names = ("BM", "THREADS", "STAGES", "MIN_BLOCKS", "BK")
    for f in CSRC.iterdir():
        text = f.read_text()
        if f.name == "sgemm_common.cuh":
            for name, value in zip(names, variant.split(":")):
                text, n = re.subn(rf"#define GTT_SGEMM_{name} \d+",
                                  f"#define GTT_SGEMM_{name} {value}", text)
                if n != 1:
                    raise SystemExit(f"probe: GTT_SGEMM_{name} not found")
            for old, new in ABLATIONS[form]:
                if old not in text:
                    raise SystemExit(f"probe: {form}: {old!r} not found")
                text = text.replace(old, new)
        (out / f.name).write_text(text)
    return out


def build(src: Path, source: str, nvcc: str, flags):
    so = src / f"lib{source}.so"
    cmd = [nvcc, *flags, "-Xptxas", "-v", "-o", str(so),
           str(src / f"{source}.cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def ptxas(log: str, pattern: str) -> str:
    """'<registers> registers, <bytes> B spill' of the first kernel whose
    mangled name matches ``pattern``."""
    kernel = None
    regs = spill = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1) if re.search(pattern, m.group(1)) else None
        elif kernel:
            r = re.search(r"Used (\d+) registers", line)
            s = re.search(r"(\d+) bytes spill stores", line)
            if r:
                regs = int(r.group(1))
            if s:
                spill = int(s.group(1))
            if regs is not None and spill is not None:
                return f"{regs} registers, {spill} B spill"
    return "not reported"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="64:128:4:4,64:128:3:4,"
                    "64:128:3:5,128:256:3:2,128:256:4:2",
                    help="comma-separated BM:THREADS:STAGES:MIN_BLOCKS[:BK]")
    ap.add_argument("--forms", default="full",
                    help="comma-separated of " + ", ".join(ABLATIONS))
    ap.add_argument("--rows", default="",
                    help="comma-separated R: also time the rank-k update "
                         "at (R, 2304), k = 256 (how its time follows its "
                         "tile count and waves)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from chip_smoke import device_ms
    from gauss_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    work = REPO / "build" / "sgemm_probe"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    variants = args.variants.split(",")
    forms = args.forms.split(",")
    runs = [(v, form) for v in variants for form in forms]
    dirs = {run: sources(*run, work) for run in runs}
    jobs = {(v, form, s): build(dirs[(v, form)], s, nvcc, _build.NVCC_FLAGS)
            for v, form in runs for s in ("rowelim", "matmul")}
    logs = {}
    for key, (so, proc) in jobs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode:
            print(f"probe: nvcc {key} failed:\n{logs[key][-3000:]}",
                  file=sys.stderr)
            return 1

    rng = np.random.default_rng(258458)
    dev = torch.device("cuda")

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32, device=dev)

    R, C, K, N = 2048, 2304, 256, 2048
    m, f, u = rand(R, C), rand(R, K), rand(K, C)
    a, b = rand(N, N), rand(N, N)
    want_rk = m - f @ u
    want_mm = a @ b
    lib_rk = device_ms(lambda: torch.addmm(m, f, u, alpha=-1), args.reps)
    lib_mm = device_ms(lambda: torch.matmul(a, b), args.reps)
    print(f"probe: torch.addmm at ({R}, {C}), k={K}: {lib_rk:.4f} ms; "
          f"torch.matmul at {N}^3: {lib_mm:.4f} ms")
    stream = torch.cuda.current_stream().cuda_stream
    for v, form in runs:
        libs = {}
        for s in ("rowelim", "matmul"):
            lib = ctypes.CDLL(str(jobs[(v, form, s)][0]))
            for fn, types in _build._SIGNATURES[s].items():
                getattr(lib, fn).argtypes = types
                getattr(lib, fn).restype = ctypes.c_int
            lib.gtt_error_string.argtypes = [ctypes.c_int]
            lib.gtt_error_string.restype = ctypes.c_char_p
            libs[s] = lib
        info = (ctypes.c_int * 6)()
        _build.check(libs["rowelim"],
                     libs["rowelim"].gtt_rankk_update_info(4, info), "info")
        smem, per_sm, threads, _, bm, bn = list(info)
        out_rk = torch.empty_like(m)
        out_mm = torch.empty_like(a)

        def rankk():
            _build.check(libs["rowelim"], libs["rowelim"].gtt_rankk_update(
                m.data_ptr(), C, f.data_ptr(), K, u.data_ptr(), C,
                out_rk.data_ptr(), C, R, C, K, stream), "rankk")

        def tiled():
            _build.check(libs["matmul"], libs["matmul"].gtt_matmul_tiled(
                a.data_ptr(), N, b.data_ptr(), N, out_mm.data_ptr(), N, N, N,
                N, 0, stream), "tiled")

        rankk()
        tiled()
        torch.cuda.synchronize()
        err_rk = float((out_rk - want_rk).abs().max() / want_rk.abs().max())
        err_mm = float((out_mm - want_mm).abs().max() / want_mm.abs().max())
        ms_rk = device_ms(rankk, args.reps)
        ms_mm = device_ms(tiled, args.reps)
        tiles_rk = -(-R // bm) * -(-C // bn)
        tiles_mm = -(-N // bm) * -(-N // bn)
        ok = form != "full" or (err_rk <= 1e-5 and err_mm <= 1e-5)
        print(f"probe: {v} {form} (tile ({bm}, {bn}), {threads} threads, "
              f"{smem} B ring, {per_sm} blocks an SM): rank-k "
              f"[{ptxas(logs[(v, form, 'rowelim')], 'rankk_update_kernel')}] "
              f"{ms_rk:.4f} ms ({2.0 * R * C * K / ms_rk / 1e9:.1f} TFLOP/s, "
              f"{tiles_rk} tiles = {tiles_rk / (per_sm * SMS):.3f} waves, "
              f"err {err_rk:.2e}); tiled highest "
              f"[{ptxas(logs[(v, form, 'matmul')], 'tiled_f32_kernel')}] "
              f"{ms_mm:.4f} ms ({2.0 * N ** 3 / ms_mm / 1e9:.1f} TFLOP/s, "
              f"{tiles_mm / (per_sm * SMS):.3f} waves, err {err_mm:.2e})"
              f"{'' if ok else '  MISMATCH'}")
        for rows in filter(None, args.rows.split(",")):
            r = int(rows)
            mr, fr, outr = m[:r], f[:r], out_rk[:r]

            def rankk_rows():
                _build.check(libs["rowelim"], libs["rowelim"].gtt_rankk_update(
                    mr.data_ptr(), C, fr.data_ptr(), K, u.data_ptr(), C,
                    outr.data_ptr(), C, r, C, K, stream), "rankk")

            ms = device_ms(rankk_rows, args.reps)
            tiles = -(-r // bm) * -(-C // bn)
            print(f"probe:   rank-k at ({r}, {C}), k={K}: {ms:.4f} ms, "
                  f"{tiles} tiles = {tiles / (per_sm * SMS):.3f} waves, "
                  f"{1e3 * ms / tiles:.4f} us a tile")
        if not ok:
            return 1
    for so, _ in jobs.values():
        so.unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

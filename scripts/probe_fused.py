#!/usr/bin/env python3
"""Device time of the fused panel+trailing kernel, its two phases alone, and
one blocked factorization taken apart, on the card.

    python3 scripts/probe_fused.py [--root DIR] [--reps 20] [--n 2048]
        [--forms full,b2-no-math,...]

Imports ``gauss_tpu_torch`` from the checkout at ``--root`` (default: this
one; another checkout, for example a parent commit unpacked beside it,
compares two versions in one run on one card), builds its kernels, and on
random blocks seeded 258458, at the n / 256 - 1 fused launch shapes of an
n x n factorization at panel 256 (the live rows m[kb:] of width n, the
panel at col0 = kb):

- prints, per shape and summed, the device time of one launch of the
  fused kernel, of the panel kernel on the same strip (phase A alone), of
  the trailing kernel on the same eliminations (phase B alone) and, where
  the checkout has it, of the batched fused kernel on a stack of that one
  block (``panel_trailing_fused_batched``, B = 1): the
  mean over ``--reps`` launches queued behind a spin kernel, so no host
  gap between launches counts (``chip_smoke.device_ms``), and the median
  of ``--reps`` calls by CUDA events around each call, the wrapper's host
  time included;
- traces one more n x n ``lu_factor_blocked_unrolled`` call with
  ``torch.profiler`` and prints its host time, the device's busy time in
  the span from the first kernel's start to the last one's end, the idle
  share of that span, and the device time and launches of the kernels by
  name (the largest first).

With ``--forms``, it instead builds ``csrc/panel_fused.cu`` once per form
into ``build/fused_probe/<form>/`` (a copy of ``csrc/`` with the form's
text changes, all builds in parallel), loads each in place of the built
library, and prints the device times above for each: ``full`` is the
kernel as it is; the ablations compute wrong results (not checked) and
show what a part of phase B costs: ``b2-no-math`` drops the tiles' fmaf
chains, ``b1-no-fsub`` B1's forward substitution, ``b1-no-update`` B1's
update of the later pivot rows, ``b1-no-gather`` B1's first gather of the
pivot rows.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
PANEL = 256
# form -> [(text in csrc/panel_fused.cu or .cuh, its replacement)]
ABLATIONS = {
    "full": [],
    "b2-no-math": [("    gtt_seg_chain(acc, dm, du, w, tr, tc);\n",
                    "    for (auto& r : acc) for (float& x : r) x = 0.0f;\n")],
    "b1-no-fsub": [("    gtt_fsub<T>(lt, u0, su, ug + (size_t)s0 * us, us, w, "
                    "a.fseg);\n", "")],
    "b1-no-update": [("      if (k + 7 < s1 || k >= a.panel) continue;",
                      "      continue;")],
    "b1-no-gather": [("                 ? gtt_f(a.block[(size_t)sm.piv[k] * "
                      "a.ld + c0 + c]) : 0.0f;",
                      "                 ? 0.0f : 0.0f;")],
}


def build_forms(forms, nvcc, flags, edits=None, out="fused_probe"):
    """Build csrc/panel_fused.cu once per form (its text changes from
    ``edits``, by default :data:`ABLATIONS`, each made in whichever of
    ``panel_fused.cu`` and its header ``panel_fused.cuh`` holds the text)
    into ``build/<out>/<form>/``, in parallel; returns the libraries' paths
    by form."""
    import shutil
    import subprocess

    csrc = HERE / "gauss_tpu_torch" / "kernels" / "csrc"
    names = ("panel_fused.cu", "panel_fused.cuh")
    base = {name: (csrc / name).read_text() for name in names}
    edits = ABLATIONS if edits is None else edits
    sources = {}
    for form in forms:  # every form's text, before any build starts
        src = dict(base)
        for old, new in edits[form]:
            where = [name for name in names if src[name].count(old) == 1]
            if sum(src[name].count(old) for name in names) != 1:
                raise SystemExit(f"probe: form {form}: {old!r} not found once")
            src[where[0]] = src[where[0]].replace(old, new)
        sources[form] = src
    jobs = {}
    for form, src in sources.items():
        d = HERE / "build" / out / form
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        for name, text in src.items():
            (d / name).write_text(text)
        so = d / "libgtt_panel_fused.so"
        jobs[form] = (so, subprocess.Popen(
            [nvcc, *flags, "-o", str(so), str(d / "panel_fused.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for form, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: nvcc {form} failed:\n{log[-3000:]}")
    return {form: so for form, (so, _) in jobs.items()}


def load_form(so) -> None:
    """Load a built form of csrc/panel_fused.cu in place of the library
    that ``gauss_tpu_torch.kernels._build`` built."""
    import ctypes

    from gauss_tpu_torch.kernels import _build

    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build._SIGNATURES["panel_fused"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.gtt_error_string.argtypes = [ctypes.c_int]
    lib.gtt_error_string.restype = ctypes.c_char_p
    _build._libs["panel_fused"] = lib


def time_shapes(label: str, n: int, reps: int) -> None:
    """The per-shape and summed device and per-call times (module
    docstring) of the fused kernel and its two phases alone."""
    import torch

    from chip_smoke import device_ms
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.kernels import panel_fused as kf
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    rng = np.random.default_rng(258458)
    dev = torch.device("cuda")
    total = {"fused": [0.0, 0.0], "phase A": [0.0, 0.0],
             "phase B": [0.0, 0.0], "batched B=1": [0.0, 0.0]}
    head = f"probe: {label}: " if label else "probe: "
    for kb in range(0, n - PANEL, PANEL):
        h = n - kb
        orig = torch.as_tensor(rng.standard_normal((h, n)),
                               dtype=torch.float32, device=dev)
        work = orig.clone()
        strip = orig[:, kb:kb + PANEL]
        p, ipiv, perm, _ = kp.panel_factor(strip, 0)
        mult, _ = kf.reconstruct_mult_pt(p, ipiv, perm, 0, PANEL)
        calls = {
            "fused": lambda: kf.panel_trailing_fused(work, kb, 0,
                                                     panel=PANEL),
            "phase A": lambda: kp.panel_factor(strip, 0),
            "phase B": lambda: kf.trailing_update(work, mult, ipiv, kb),
        }
        if hasattr(kf, "panel_trailing_fused_batched"):
            calls["batched B=1"] = lambda: kf.panel_trailing_fused_batched(
                work[None], kb, 0, panel=PANEL)
        line = []
        for name, fn in calls.items():
            dms = device_ms(fn, reps)
            work.copy_(orig)
            cms = cuda_event_ms(fn, reps, setup=lambda: work.copy_(orig))
            total[name][0] += dms
            total[name][1] += cms
            line.append(f"{name} {dms:.4f} device, {cms:.4f} per call")
        print(f"{head}({h}, {n}) kb={kb}: " + "; ".join(line) + " (ms)")
    print(f"{head}the {len(range(0, n - PANEL, PANEL))} shapes summed: "
          + "; ".join(f"{name} {d:.4f} device, {c:.4f} per call"
                      for name, (d, c) in total.items() if d) + " (ms)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--forms", default="",
                    help="comma-separated forms of csrc/panel_fused.cu "
                         f"to time: {', '.join(ABLATIONS)}")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import smi_line
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel_fused as kf
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    print(f"probe: gauss_tpu_torch from {Path(kf.__file__).parents[2]}; "
          f"{smi_line()}")
    _build.build_all()
    forms = [f for f in args.forms.split(",") if f]
    if forms:
        built = build_forms(forms, _build.find_nvcc(), _build.NVCC_FLAGS)
        for form in forms:
            load_form(built[form])
            time_shapes(f"form {form}", args.n, args.reps)
        return 0
    time_shapes("", args.n, args.reps)
    rng = np.random.default_rng(258459)
    n, reps = args.n, args.reps
    dev = torch.device("cuda")
    a = torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32,
                        device=dev)
    for _ in range(2):
        blocked.lu_factor_blocked_unrolled(a, panel=PANEL, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        blocked.lu_factor_blocked_unrolled(a, panel=PANEL, device="cuda")
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("probe: the trace holds no device events")
        return 1
    by_name: dict[str, list] = {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    for e in kernels:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += (e.time_range.end - e.time_range.start) / 1e3
        entry[1] += 1
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3
    span = (spans[-1][1] - spans[0][0]) / 1e3
    print(f"probe: one n={n} factorization traced: {len(kernels)} kernels, "
          f"device busy {busy:.4f} ms of a {span:.4f} ms span (idle share "
          f"{1.0 - busy / span:.3f}); host {host_ms:.4f} ms")
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:args.top]:
        print(f"probe:   {ms:9.4f} ms {count:4d} x {name[:100]}")
    fac = cuda_event_ms(lambda: blocked.lu_factor_blocked_unrolled(
        a, panel=PANEL, device="cuda"), reps)
    print(f"probe: one n={n} factorization by CUDA events, median of "
          f"{reps}: {fac:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

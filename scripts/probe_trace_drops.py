#!/usr/bin/env python3
"""How often ``chip_smoke.trace_launches`` loses or misplaces a hand-written
kernel of one n=8192 chunked factorization, on the card.

    python3 scripts/probe_trace_drops.py [--reps 30] [--out DIR]

Builds the kernels, then traces ``lu_factor_blocked_chunked`` at n=8192,
panel 256, chunk 4 (the bfloat16 dominant system of chip_smoke phase 7 (d)
and the float32 random matrix of phase 6 (c)) ``--reps`` times for each
marker length (``TRACE_MARKER_CYCLES``, the spin kernel queued inside the
profile before the call) and holds each trace's kernels against
``factor_plan``. For a trace that differs it prints the lengths, the
first index that differs, whether the trace is the plan with entries
missing, whether the marker was recorded, and how many runtime launch
calls of the hand-written kernels the trace holds beside their kernel
events; the first two such traces are kept under ``--out``. Exits 0.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
N, PANEL, CHUNK = 8192, 256, 4
MARKERS = (1 << 16, 1 << 24)


def is_subsequence(got, plan) -> bool:
    it = iter(plan)
    return all(any(g == p for p in it) for g in got)


def runtime_launches(path: str, since_us: float) -> tuple[int, int]:
    """Runtime launch calls of the hand-written kernels after the marker
    (their flow links name the kernel), and the kernel events after it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["args"].get("correlation"): e for e in events
               if e.get("cat") == "kernel" and "gtt" in e.get("name", "")}
    calls = [e for e in events if e.get("cat") == "cuda_runtime"
             and "Launch" in e.get("name", "")
             and float(e["ts"]) >= since_us]
    hand = [e for e in calls if e["args"].get("correlation") in kernels]
    return len(calls), len(hand)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=str(HERE / "chiprun_out" / "trace_drops"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_trace_drops: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.kernels import _build

    _build.build_all()
    os.makedirs(args.out, exist_ok=True)
    work = os.path.join(args.out, "work")
    os.makedirs(work, exist_ok=True)
    a_np, _ = cs.dominant_system(N, cs.SEED + N)
    mats = {
        2: torch.as_tensor(a_np, dtype=torch.bfloat16, device="cuda"),
        4: torch.as_tensor(np.random.default_rng(cs.SEED + N).standard_normal(
            (N, N)), dtype=torch.float32, device="cuda")}
    for a in mats.values():
        blocked.lu_factor_blocked_chunked(a, panel=PANEL, chunk=CHUNK,
                                          device="cuda")
    torch.cuda.synchronize()
    kept = 0
    print(cs.smi_line())
    for cycles in MARKERS:
        cs.TRACE_MARKER_CYCLES = cycles
        bad = {2: 0, 4: 0}
        for rep in range(args.reps):
            for itemsize, a in mats.items():
                plan = [(k, r) for k, r, _ in cs.factor_plan(
                    N, PANEL, CHUNK, itemsize)]
                path = os.path.join(work, f"t{itemsize}.json")
                got, busy, host_ms = cs.trace_launches(
                    lambda: blocked.lu_factor_blocked_chunked(
                        a, panel=PANEL, chunk=CHUNK, device="cuda"), path)
                got = [(k, r) for k, r, _ in got]
                if got == plan:
                    continue
                bad[itemsize] += 1
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
                marks = [e for e in events if e.get("cat") == "kernel"
                         and "spin" in e.get("name", "")]
                since = (float(marks[-1]["ts"]) if marks else float("-inf"))
                calls, hand = runtime_launches(path, since)
                first = next((i for i, (g, p) in enumerate(zip(got, plan))
                              if g != p), min(len(got), len(plan)))
                print(f"marker {cycles} itemsize {itemsize} rep {rep}: "
                      f"traced {len(got)} of {len(plan)}, first difference "
                      f"at {first} (traced {got[first:first + 2]}, plan "
                      f"{plan[first:first + 2]}), entries missing only: "
                      f"{is_subsequence(got, plan)}, marker recorded: "
                      f"{bool(marks)}, runtime launch calls after it "
                      f"{calls} ({hand} linked to a hand kernel event), "
                      f"busy {busy:.3f} of {host_ms:.3f} ms")
                if kept < 2:
                    shutil.copy(path, os.path.join(
                        args.out, f"bad_{cycles}_{itemsize}_{rep}.json"))
                    kept += 1
        print(f"marker {cycles} cycles: traces differing from the plan: "
              f"bfloat16 {bad[2]} of {args.reps}, float32 {bad[4]} of "
              f"{args.reps}")
    shutil.rmtree(work)
    return 0


if __name__ == "__main__":
    sys.exit(main())

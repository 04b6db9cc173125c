#!/usr/bin/env python3
"""Whether a ``torch.profiler`` trace taken in a process that has served
loses kernel records, and which of the named causes explains it, on the
card (ROADMAP queue 3, fault 1).

    python3 scripts/probe_trace_loss.py [--root DIR] [--requests 120]

Imports ``gauss_tpu_torch`` from the checkout at ``--root`` (default: this
one), builds its kernels, runs ``chip_smoke.py`` phase 9 (c)'s load
(``loadgen.run_load`` on SERVE_MIX, as ``scripts/probe_service.py``), and
then traces one ``exe.solve`` of phase 9 (c)'s (8, 4096, 4096) batch
(``chip_smoke.trace_launches``: 16 hand-written kernels) in this process,
in turns:

- ``open``: with the server still open, the first call of a new
  executable, as ``serve_batch_trace(..., retake=False)`` takes it; then
  the same executable's second call;
- ``open_after_throwaway``: a new executable after one empty profiler
  session (the CUPTI activity buffers flushed of earlier records);
- ``closed``: after the server's worker thread has stopped, with every
  stream of the device synchronized; and again after a throwaway session;
- ``fresh``: in a fresh process that served nothing
  (``chip_smoke.in_fresh_process``; this checkout only).

For each take: the hand-written kernels recorded between the markers,
those anywhere in the trace, the runtime launch calls of the call whose
correlation has no kernel event (a record the profiler dropped), and the
spread between the first marker's end and the first recorded kernel
(the profiler's clock). One JSON line, with the card's name and power
limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PLANNED = 16  # the 4096 bucket at panel 256: 15 batched fused + 1 panel


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def trace_orphans(path: str) -> dict:
    """The runtime launch calls after a trace's first marker whose
    correlation has no kernel event (records the profiler dropped: a
    kernel misplaced by the profiler's clock keeps its event), and the
    microseconds from that marker's end to the next kernel event."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    marks = sorted(float(e["ts"]) + float(e.get("dur", 0)) for e in kern
                   if "spin" in e.get("name", ""))
    since = marks[0] if marks else float("-inf")
    corr = {e.get("args", {}).get("correlation") for e in kern}
    calls = [e for e in events if e.get("cat") == "cuda_runtime"
             and "Launch" in e.get("name", "") and float(e["ts"]) >= since]
    lost = [e["name"] for e in calls
            if e.get("args", {}).get("correlation") not in corr]
    after = sorted(float(e["ts"]) for e in kern
                   if float(e["ts"]) >= since and "spin" not in e["name"])
    return {"launch_calls": len(calls), "calls_without_kernel": len(lost),
            "names": lost[:4], "marker_to_first_kernel_us":
                (after[0] - since) if after else None}


def throwaway_profile() -> None:
    """One empty profiler session: a trace taken after it starts with the
    CUPTI activity buffers flushed of earlier sessions' records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--requests", type=int, default=None)
    args = ap.parse_args(argv)
    c = _smoke()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.serve import ServeConfig, SolverServer, cache, loadgen

    _build.build_all()
    work = HERE / "chiprun_out" / "trace_loss"
    os.makedirs(work, exist_ok=True)
    cfg = ServeConfig(ladder=c.SERVE_LADDER, max_batch=c.SERVE_BATCH,
                      refine_steps=c.SERVE_REFINE, cache_capacity=32,
                      verify_gate=c.GATE, structure_aware=True,
                      device="cuda")
    lcfg = loadgen.LoadgenConfig(
        mix=c.SERVE_MIX, requests=args.requests or c.SERVE_REQUESTS,
        warmup=c.SERVE_WARMUP, concurrency=c.SERVE_CONCURRENCY, seed=c.SEED,
        serve=cfg)
    key, systems = c.serve_batch_systems()
    a_pad, b_pad = c.serve_batch_pad(key, systems)
    takes = []

    def take(label: str, exe) -> None:
        path = str(work / f"{label}_{len(takes)}.json")
        got, busy, host_ms = c.trace_launches(
            lambda: exe.solve(a_pad, b_pad), path)
        rec = {"take": label, "recorded": len(got), "planned": PLANNED,
               "anywhere": c.trace_kinds_anywhere(path),
               **trace_orphans(path)}
        takes.append(rec)
        print(json.dumps(rec), flush=True)

    with SolverServer(cfg) as server:
        summary = loadgen.run_load(server, lcfg)
        torch.cuda.synchronize()
        exe = cache.BatchedExecutable(key, device="cuda")
        take("open", exe)
        take("open_same_executable", exe)
        throwaway_profile()
        take("open_after_throwaway", cache.BatchedExecutable(key,
                                                             device="cuda"))
    torch.cuda.synchronize()
    take("closed", cache.BatchedExecutable(key, device="cuda"))
    throwaway_profile()
    take("closed_after_throwaway", cache.BatchedExecutable(key,
                                                           device="cuda"))
    if root == HERE:
        fresh = c.in_fresh_process(
            f"c.serve_batch_trace({str(work / 'fresh.json')!r}, "
            f"retake=False)")
        takes.append({"take": "fresh", "recorded": fresh["traced_kernels"],
                      "planned": fresh["planned_kernels"]})
    print(json.dumps({"trace_loss": takes, "service_ok":
                      summary["counts"]["ok"], "card": c.smi_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

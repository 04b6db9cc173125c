#!/usr/bin/env python3
"""Whether the number of profiler sessions in one process explains the
kernel records that a whole ``chip_smoke.py`` run's traces lose, and
whether one long-lived session keeps them (ROADMAP queue 3, fault 1).

    python3 scripts/probe_trace_sessions.py [--whole-run] [--rounds 40]
                                            [--takes 20]

With ``--whole-run`` the process first runs ``chip_smoke.main()`` (every
phase, its own traced calls included), so the probe starts where the
whole run's later takes lost records. Then :func:`probe`: up to
``--rounds`` rounds of one empty profiler session and one traced take of
phase 6's n=8192 chunked factorization (``chip_smoke.trace_launches``,
its 32 planned kernels), counting the rounds before the first take that
lost a record; one profiler session open across ``--takes`` takes of
that call; and one across ``--takes`` takes of the calls phases 6 (c),
7 (d) and 9 (c) trace, in turn (:func:`phase_takes`). Each take of a
session lies between spin markers, and the session is exported once: the
markers and planned kernels recorded, and the takes short of their plan.
Every record a trace lacks is named (:func:`missing_records`: which
marker, or which take's kernel by position, key and route), and each
session opens with ``--lead-markers`` spin markers (default
``chip_smoke.TRACE_LEAD_MARKERS``, which ``trace_launches`` queues too),
to see whether the records a session drops are its first. One JSON line,
with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_takes(c) -> list:
    """The calls that ``chip_smoke.py`` traces in phases 6 (c), 7 (d) and
    9 (c), each with its planned kernels: ``(label, call, plan)``."""
    import torch

    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.serve import cache

    dev = torch.device("cuda")
    out = []
    for n, panel, chunk in c.LARGE_CELLS:
        a = torch.as_tensor(np.random.default_rng(c.SEED + n)
                            .standard_normal((n, n)), dtype=torch.float32,
                            device=dev)
        out.append((f"phase 6 (c) n={n}",
                    lambda a=a, p=panel, k=chunk:
                        blocked.lu_factor_blocked_chunked(
                            a, panel=p, chunk=k, device="cuda"),
                    c.factor_plan(n, panel, chunk)))
    n, panel, chunk = c.LOWERED_LARGE
    a16 = torch.as_tensor(c.dominant_system(n, c.SEED + n)[0],
                          dtype=torch.bfloat16, device=dev)
    out.append(("phase 7 (d)", lambda: blocked.lu_factor_blocked_chunked(
        a16, panel=panel, chunk=chunk, device="cuda"),
        c.factor_plan(n, panel, chunk, itemsize=2)))
    key, systems = c.serve_batch_systems()
    a_pad, b_pad = c.serve_batch_pad(key, systems)
    exe = cache.BatchedExecutable(key, device="cuda")
    plan = [("panel_trailing_fused_batched",
             c.batched_route(key.batch, key.bucket_n - kb, exe.panel),
             key.bucket_n - kb)
            for kb in range(0, key.bucket_n - exe.panel, exe.panel)]
    plan.append(("panel_factor_batched",
                 c.batched_launch_route(exe.panel, exe.panel), exe.panel))
    out.append(("phase 9 (c)", lambda: exe.solve(a_pad, b_pad), plan))
    for _, call, _ in out:
        call()
    torch.cuda.synchronize()
    return out


def _records(c, path: str) -> list:
    """A Chrome trace's spin markers and hand-written kernels in device
    order: ``"marker"`` or ``(key, route)``."""
    with open(path) as f:
        kernels = sorted((e for e in json.load(f)["traceEvents"]
                          if e.get("cat") == "kernel" and e.get("ph") == "X"),
                         key=lambda e: float(e["ts"]))
    out = []
    for e in kernels:
        if "spin" in e["name"]:
            out.append("marker")
            continue
        out += [(key, route) for syms, key, route in c.TRACE_KINDS
                if any(sym in e["name"] for sym in syms)]
    return out


def missing_records(c, path: str, lead: int, takes: list) -> list:
    """The records of a traced session that its trace lacks, named: the
    session's ``lead`` leading markers, then per take its kernels and one
    marker after it, aligned with what the trace holds (difflib); each
    missing record as ``"marker i"`` or ``"take t kernel i: key/route"``."""
    import difflib

    want, names = ["marker"] * lead, [f"marker {i}" for i in range(lead)]
    for t, (_, _, plan) in enumerate(takes):
        for i, (k, r, _) in enumerate(plan):
            want.append((k, r))
            names.append(f"take {t} kernel {i}: {k}/{r}")
        want.append("marker")
        names.append(f"marker {lead + t}")
    got = _records(c, path)
    out = []
    sm = difflib.SequenceMatcher(None, want, got, autojunk=False)
    for op, i0, i1, _, _ in sm.get_opcodes():
        if op in ("delete", "replace"):
            out += names[i0:i1]
    return out


def long_lived(c, takes: list, path: str) -> dict:
    """One profiler session over ``takes`` (``(label, call, plan)``), each
    between spin markers, exported once: per take, the planned kernels
    recorded between its markers; and the markers and planned kernels the
    whole trace holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def marker():
        torch.cuda._sleep(c.TRACE_MARKER_CYCLES)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(c.TRACE_LEAD_MARKERS - 1):
            marker()
        for _, call, _ in takes:
            marker()
            call()
            torch.cuda.synchronize()
        marker()
    prof.export_chrome_trace(path)
    with open(path) as f:
        kernels = sorted((e for e in json.load(f)["traceEvents"]
                          if e.get("cat") == "kernel" and e.get("ph") == "X"),
                         key=lambda e: float(e["ts"]))
    lead = c.TRACE_LEAD_MARKERS - 1
    marks = [i for i, e in enumerate(kernels) if "spin" in e["name"]][lead:]
    ours = [[(key, route) for syms, key, route in c.TRACE_KINDS
             if any(sym in e["name"] for sym in syms)] for e in kernels]
    planned = sum(len(p) for _, _, p in takes)
    rec = {"takes": len(takes),
           "markers": len(marks) + lead,
           "markers_planned": len(takes) + 1 + lead,
           "planned_kernels": planned,
           "kernels_anywhere": sum(len(o) for o in ours),
           "missing": missing_records(c, path, lead + 1, takes)}
    if len(marks) == len(takes) + 1:
        lost = {}
        for (label, _, plan), lo, hi in zip(takes, marks, marks[1:]):
            seg = [k for o in ours[lo + 1:hi] for k in o]
            if seg != [(k, r) for k, r, _ in plan]:
                lost[label] = lost.get(label, 0) + len(plan) - len(seg)
        rec["takes_short"] = lost
    return rec


def probe(c, sessions: int, takes: int, work: str) -> dict:
    """(a) Up to ``sessions`` rounds of one empty profiler session and one
    traced take (``trace_launches``) of phase 6's n=8192 chunked
    factorization, counting the rounds before the first take that lost a
    planned kernel record; (b) one profiler session holding ``takes``
    takes of that call; (c) one profiler session holding ``takes`` takes
    of phases 6, 7 and 9's traced calls in turn."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    calls = phase_takes(c)
    label, call, plan = calls[0]
    want = [(k, r) for k, r, _ in plan]
    first_loss = None
    for s in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        path = os.path.join(work, "loop.json")
        got, _, _ = c.trace_launches(call, path)
        if [(k, r) for k, r, _ in got] != want:
            first_loss = {"round": s + 1, "recorded": len(got),
                          "planned": len(want),
                          "missing": missing_records(
                              c, path, c.TRACE_LEAD_MARKERS, [calls[0]])}
            break
    return {"loop_rounds": sessions, "loop_first_loss": first_loss,
            "one_call": long_lived(c, [calls[0]] * takes,
                                   os.path.join(work, "one_call.json")),
            "phase_calls": long_lived(
                c, [calls[i % len(calls)] for i in range(takes)],
                os.path.join(work, "phase_calls.json"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--whole-run", action="store_true",
                    help="run chip_smoke.main() in this process first")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--takes", type=int, default=20)
    ap.add_argument("--lead-markers", type=int, default=None,
                    help="spin markers opening each session (default "
                         "chip_smoke.TRACE_LEAD_MARKERS)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    c = _smoke()
    if args.lead_markers is not None:
        c.TRACE_LEAD_MARKERS = args.lead_markers
    if args.whole_run:
        rc = c.main([])
        if rc:
            return rc
    else:
        c.phase_build()
    work = HERE / "build" / "trace_sessions"
    os.makedirs(work, exist_ok=True)
    print(json.dumps({"trace_sessions": probe(c, args.rounds, args.takes,
                                              str(work)),
                      "after_whole_run": args.whole_run,
                      "lead_markers": c.TRACE_LEAD_MARKERS,
                      "card": c.smi_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

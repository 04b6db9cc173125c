#!/usr/bin/env python3
"""Whether the number of profiler sessions in one process explains the
kernel records that a whole ``chip_smoke.py`` run's traces lose, and
whether one long-lived session keeps them (ROADMAP queue 3, fault 1).

    python3 scripts/probe_trace_sessions.py [--whole-run] [--rounds 40]
                                            [--takes 20] [--lead-op]
    python3 scripts/probe_trace_sessions.py --empty-sessions K [--session-op]
                                            [--between N] [--before-build]
                                            [--phase-kernels R]
                                            [--cudart-shared]
                                            [--load-only]
                                            [--sessions-after-load M]

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
to see whether the records a session drops are its first. With
``--lead-op`` every session (``trace_launches``' too) opens with a small
real torch op before its markers (:func:`lead_op_sessions`): if a real
kernel, not a spin, absorbs the loss of the session's opening, no marker
and no kernel of the call is missing. With ``--lead-op`` the probe also
reports, for each session that lost a record, whether the trace holds the
lead op's own kernels (:func:`lead_op_recorded`: the kernels whose
correlation ids match the launches made inside the trace's
``aten::cumsum``), and the profiler's state as each session opened
(:func:`session_state`: whether a profiler or Kineto session was still
active, the profiler type, and the environment's Kineto/CUPTI knobs,
where the activity buffers' size would be set). With ``--empty-sessions
K`` the process, fresh, opens K empty profiler sessions (with
``--session-op``, each running the lead op), runs ``--between N`` lead
ops outside any session, and then takes phase 6's n=8192 call once
(:func:`after_empty_sessions`); ``--before-build`` opens the sessions
before the hand-written kernels' libraries are built and loaded
(``chip_smoke.phase_build``), ``--phase-kernels R`` runs phase 3's
kernel checks between the build and the take, and ``--cudart-shared``
builds the libraries against the shared CUDA runtime (torch's) instead of
nvcc's static one: whether the sessions a process opened before a take,
the device work between them, or a second copy of the runtime decide
what it loses. ``--load-only`` builds the libraries in a process of its
own first, so that this process only loads them (``ctypes.CDLL``, no
``nvcc``) after its sessions; ``--sessions-after-load M`` opens and closes
M more empty sessions after the load, before the take: whether loading
alone reproduces the loss, and whether a session after the load clears
it. One JSON
line, with the card's name and power limit. Needs a CUDA device.
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


#: the profiler's state as each lead-op session opened, in order
SESSION_STATES: list = []


def session_state() -> dict:
    """The profiler's state now: whether the autograd profiler and Kineto
    report a session still active, the profiler type, and the Kineto /
    CUPTI environment knobs (none set: Kineto's default activity
    buffers)."""
    import torch

    a = torch._C._autograd
    st = {}
    for name in ("_profiler_enabled", "_is_kineto_stopped",
                 "_profiler_type", "kineto_available"):
        fn = getattr(a, name, None)
        try:
            st[name.strip("_")] = str(fn()) if fn is not None else None
        except Exception as e:  # noqa: BLE001 — a probe reports, never dies
            st[name.strip("_")] = f"{type(e).__name__}: {e}"
    st["env"] = {k: v for k, v in os.environ.items()
                 if k.startswith(("KINETO", "CUPTI", "TORCH_CUPTI",
                                  "TORCH_PROFILER"))}
    return st


def _lead_op():
    import torch

    torch.cumsum(torch.arange(1 << 16, device="cuda",
                              dtype=torch.float32), 0)
    torch.cuda.synchronize()


def lead_op_sessions() -> None:
    """From now on, every session that ``torch.profiler.profile`` opens
    (``chip_smoke.trace_launches``' and :func:`long_lived`'s) starts with
    a small real torch op on the card, a cumulative sum of 65,536 floats,
    to a synchronize, and appends :func:`session_state` taken just before
    it opens to :data:`SESSION_STATES`. :func:`probe`'s empty sessions
    keep the plain class (``profile.plain``)."""
    import torch.profiler

    plain = torch.profiler.profile

    class LeadOpProfile(plain):
        def __enter__(self):
            SESSION_STATES.append(session_state())
            prof = super().__enter__()
            _lead_op()
            return prof

    LeadOpProfile.plain = plain
    torch.profiler.profile = LeadOpProfile


def lead_op_recorded(path: str) -> dict:
    """The kernel launches the runtime recorded inside the trace's
    ``aten::cumsum`` ops (the lead op's, and any the traced call makes
    itself), and how many of their correlation ids have a kernel record.
    It opens no session of its own: a session opened before a traced call
    changes what that call's trace loses."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
           for e in events if e.get("cat") == "cpu_op"
           and e.get("name") == "aten::cumsum"]
    launched = {e["args"].get("correlation") for e in events
                if e.get("cat") == "cuda_runtime"
                and "Launch" in e.get("name", "")
                and any(lo <= float(e["ts"]) <= hi for lo, hi in ops)}
    recorded = {e["args"].get("correlation") for e in events
                if e.get("cat") == "kernel"} & launched
    return {"launched": len(launched), "recorded": len(recorded)}


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
           "lead_op_recorded": lead_op_recorded(path),
           "state_at_start": SESSION_STATES[-1] if SESSION_STATES else None,
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
    first_loss, opening, rounds = None, {}, []
    empty = getattr(profile, "plain", profile)
    for s in range(sessions):
        with empty(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        path = os.path.join(work, "loop.json")
        got, _, _ = c.trace_launches(call, path)
        missing = missing_records(c, path, c.TRACE_LEAD_MARKERS, [calls[0]])
        for name in missing:  # which opening records the rounds lost
            opening[name] = opening.get(name, 0) + 1
        rounds.append({"missing": len(missing),
                       "lead_op": (lead_op_recorded(path)
                                   if SESSION_STATES else None)})
        if [(k, r) for k, r, _ in got] != want:
            first_loss = {"round": s + 1, "recorded": len(got),
                          "planned": len(want), "missing": missing,
                          "lead_op_recorded": lead_op_recorded(path),
                          "state_at_start": (SESSION_STATES[-1]
                                             if SESSION_STATES else None)}
            break
    return {"loop_rounds": sessions, "loop_first_loss": first_loss,
            "loop_missing_by_record": opening, "loop_by_round": rounds,
            "one_call": long_lived(c, [calls[0]] * takes,
                                   os.path.join(work, "one_call.json")),
            "phase_calls": long_lived(
                c, [calls[i % len(calls)] for i in range(takes)],
                os.path.join(work, "phase_calls.json"))}


def after_empty_sessions(c, k: int, work: str, op: bool = False,
                         between: int = 0, before_build: bool = False,
                         kernels: int = 0, load_only: bool = False,
                         after_load: int = 0) -> dict:
    """``k`` profiler sessions (each around one synchronize; with ``op``,
    around the lead op), ``between`` lead ops outside any session, then
    one traced take of phase 6's n=8192 call: its planned kernels, the
    ones recorded, and the records missing by name. The sessions come
    after ``c.phase_build()`` and the calls' warm-up (``phase_takes``);
    ``before_build``: before both. ``kernels``: phase 3's kernel checks
    (``c.phase_kernels(kernels)``, that many timed launches each) run
    between the build and the take. ``load_only``: the libraries are
    built in a process of its own first, so ``c.phase_build()`` here only
    loads them; ``after_load``: that many more empty sessions after the
    load, before the take."""
    import subprocess

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gauss_tpu_torch.kernels import _build

    if load_only:
        subprocess.run([sys.executable, "-c",
                        f"import sys; sys.path.insert(0, {str(HERE)!r}); "
                        "from gauss_tpu_torch.kernels import _build; "
                        "_build.build_all()"], check=True, cwd=HERE)

    def sessions(count=k):
        for _ in range(count):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                if op:
                    _lead_op()
                torch.cuda.synchronize()
    if before_build:
        sessions()
    c.phase_build()
    built_here = sum(_build.BUILD_SECONDS.values()) > 0
    sessions(after_load)
    if kernels:
        c.phase_kernels(kernels)
    label, call, plan = phase_takes(c)[0]
    if not before_build:
        sessions()
    for _ in range(between):
        _lead_op()
    path = os.path.join(work, f"after_{k}.json")
    got, _, _ = c.trace_launches(call, path)
    return {"empty_sessions": k, "session_op": op, "between": between,
            "before_build": before_build, "phase_kernels": kernels,
            "load_only": load_only, "built_in_this_process": built_here,
            "sessions_after_load": after_load,
            "nvcc_flags": " ".join(_nvcc_flags()), "call": label,
            "planned": len(plan),
            "recorded": len(got),
            "missing": missing_records(c, path, c.TRACE_LEAD_MARKERS,
                                       [(label, call, plan)])}


def _nvcc_flags():
    from gauss_tpu_torch.kernels import _build

    return _build.NVCC_FLAGS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--whole-run", action="store_true",
                    help="run chip_smoke.main() in this process first")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--takes", type=int, default=20)
    ap.add_argument("--lead-markers", type=int, default=None,
                    help="spin markers opening each session (default "
                         "chip_smoke.TRACE_LEAD_MARKERS)")
    ap.add_argument("--lead-op", action="store_true",
                    help="open each session with a small real torch "
                         "op before its markers")
    ap.add_argument("--empty-sessions", type=int, default=None,
                    metavar="K",
                    help="open K empty sessions in this fresh process, "
                         "then take phase 6's call once")
    ap.add_argument("--session-op", action="store_true",
                    help="with --empty-sessions: run the lead op inside "
                         "each of them")
    ap.add_argument("--between", type=int, default=0, metavar="N",
                    help="with --empty-sessions: N lead ops outside any "
                         "session before the take")
    ap.add_argument("--before-build", action="store_true",
                    help="with --empty-sessions: open the sessions before "
                         "the kernels' libraries are built and loaded")
    ap.add_argument("--phase-kernels", type=int, default=0, metavar="R",
                    help="with --empty-sessions: run phase 3's kernel "
                         "checks (R timed launches each) between the build "
                         "and the take")
    ap.add_argument("--load-only", action="store_true",
                    help="with --empty-sessions: build the libraries in a "
                         "process of its own first, so this one only loads "
                         "them")
    ap.add_argument("--sessions-after-load", type=int, default=0,
                    metavar="M",
                    help="with --empty-sessions: M more empty sessions "
                         "after the libraries load, before the take")
    ap.add_argument("--cudart-shared", action="store_true",
                    help="build the kernels' libraries with `-cudart "
                         "shared` (the CUDA runtime torch loads) instead of "
                         "nvcc's static runtime, into libraries of their own")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    if args.cudart_shared:
        from gauss_tpu_torch.kernels import _build

        # The flags are part of the libraries' hash: these build beside
        # the static-runtime ones under names of their own.
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-cudart", "shared")
    c = _smoke()
    if args.lead_markers is not None:
        c.TRACE_LEAD_MARKERS = args.lead_markers
    work = HERE / "build" / "trace_sessions"
    os.makedirs(work, exist_ok=True)
    if args.lead_op:
        lead_op_sessions()
    if args.empty_sessions is not None:
        print(json.dumps({"trace_sessions": after_empty_sessions(
            c, args.empty_sessions, str(work), op=args.session_op,
            between=args.between, before_build=args.before_build,
            kernels=args.phase_kernels, load_only=args.load_only,
            after_load=args.sessions_after_load),
            "card": c.smi_line()}))
        return 0
    if args.whole_run:
        rc = c.main([])
        if rc:
            return rc
    else:
        c.phase_build()
    print(json.dumps({"trace_sessions": probe(c, args.rounds, args.takes,
                                              str(work)),
                      "sessions_opened": len(SESSION_STATES),
                      "states_seen": sorted({json.dumps(s, sort_keys=True)
                                             for s in SESSION_STATES}),
                      "after_whole_run": args.whole_run,
                      "lead_markers": c.TRACE_LEAD_MARKERS,
                      "lead_op": args.lead_op,
                      "card": c.smi_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

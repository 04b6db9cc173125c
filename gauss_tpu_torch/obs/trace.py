"""Chrome-trace export: the recorded spans as a visual timeline.

``python -m gauss_tpu_torch.obs.trace run.jsonl [-o trace.json] [--run ID]``

Converts a telemetry events file — a single-process stream or an
``obs.aggregate`` merge — into the Chrome Trace Event JSON format, loadable
in ``chrome://tracing``, Perfetto (ui.perfetto.dev), or ``about:tracing``.
The reference's gprof tables flatten time; this is the same data as a
timeline: every span becomes a complete ("X") event, nested spans stack by
containment, and each PROCESS of a merged multihost run gets its own lane
(pid), clock-aligned by the merge's ``t_aligned`` stamps — stragglers are
visible as ragged lane edges instead of a number in a table.

Mapping:

- ``span``  -> phase "X": ts = end − duration, dur = dur_s (µs). Chrome
  infers nesting from containment within a lane, which matches the
  recorder's stack discipline (a parent opens before and closes after its
  children on one thread). Multi-threaded producers (bench worker threads)
  share a lane; overlap renders stacked, not wrong.
- ``health`` / ``collective`` / ``vmem_estimate`` / ``compile`` -> instant
  ("i") markers with the event's fields as args, so numerical incidents
  and comms budgets sit on the same timeline as the phases.
- ``run_start`` -> process_name/process_sort_index metadata, labeling each
  lane "process N @ host".

Span timestamps are host wall-clock (the recorder's contract); device work
is bounded by completion fetches, so lanes reflect what each host waited
for — exactly the straggler question.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from gauss_tpu_torch.obs import registry

_US = 1e6
_INSTANT_TYPES = ("health", "collective", "vmem_estimate", "compile",
                  "reported_time")
_SKIP_ARGS = {"type", "run", "seq", "t", "t_aligned", "proc", "name",
              "dur_s", "parent", "depth"}


def _ev_time(ev: Dict[str, Any]) -> float:
    """Event time in seconds on the merged clock (t_aligned when the stream
    went through obs.aggregate, per-run t otherwise)."""
    t = ev.get("t_aligned")
    return float(t if t is not None else ev.get("t", 0.0))


def _args_of(ev: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in ev.items() if k not in _SKIP_ARGS}


def to_chrome_trace(events: List[Dict[str, Any]],
                    run_id: Optional[str] = None) -> Dict[str, Any]:
    """Build the Chrome trace dict for one run of an events list."""
    runs = []
    for ev in events:
        rid = ev.get("run")
        if rid and rid not in runs:
            runs.append(rid)
    if not runs:
        raise ValueError("no runs found in the events")
    rid = run_id or runs[0]
    if rid not in runs:
        raise ValueError(f"run '{rid}' not found; runs: {', '.join(runs)}")
    evs = [ev for ev in events if ev.get("run") == rid]

    trace: List[Dict[str, Any]] = []
    lanes: Dict[int, Dict[str, Any]] = {}
    for ev in evs:
        proc = int(ev.get("proc", 0))
        if ev.get("type") == "run_start":
            lanes[proc] = ev
    for proc in sorted({int(ev.get("proc", 0)) for ev in evs}):
        start = lanes.get(proc, {})
        host = start.get("host")
        name = f"process {proc}" + (f" @ {host}" if host else "")
        trace.append({"ph": "M", "name": "process_name", "pid": proc,
                      "args": {"name": name}})
        trace.append({"ph": "M", "name": "process_sort_index", "pid": proc,
                      "args": {"sort_index": proc}})

    for ev in evs:
        proc = int(ev.get("proc", 0))
        typ = ev.get("type")
        if typ == "span":
            dur = float(ev.get("dur_s", 0.0))
            end = _ev_time(ev)
            trace.append({
                "ph": "X", "name": str(ev.get("name")), "cat": "span",
                "pid": proc, "tid": 0,
                "ts": round(max(0.0, end - dur) * _US, 3),
                "dur": round(dur * _US, 3),
                "args": _args_of(ev),
            })
        elif typ in _INSTANT_TYPES:
            trace.append({
                "ph": "i", "name": str(ev.get("name") or typ), "cat": typ,
                "pid": proc, "tid": 0, "s": "p",
                "ts": round(_ev_time(ev) * _US, 3),
                "args": _args_of(ev),
            })
    meta = lanes.get(min(lanes), {}) if lanes else {}
    return {
        "traceEvents": trace,
        "displayTimeUnit": "ms",
        "otherData": {"run": rid,
                      "processes": sorted(lanes) or [0],
                      "tool": meta.get("tool"),
                      "source": "gauss_tpu_torch.obs.trace"},
    }


def write_trace(trace: Dict[str, Any], path) -> None:
    path = os.fspath(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.obs.trace",
        description="Export a telemetry JSONL file (single-process or an "
                    "obs.aggregate merge) as Chrome-trace/Perfetto JSON — "
                    "one timeline lane per process.")
    p.add_argument("path", help="JSONL events file")
    p.add_argument("--run", default=None,
                   help="run ID to export (default: first run in the file)")
    p.add_argument("-o", "--out", default=None, metavar="PATH",
                   help="output trace JSON (default: <input>.trace.json)")
    args = p.parse_args(argv)
    try:
        events = registry.read_events(args.path)
    except OSError as e:
        print(f"trace: cannot read '{args.path}': {e}", file=sys.stderr)
        return 1
    try:
        trace = to_chrome_trace(events, args.run)
    except ValueError as e:
        print(f"trace: {e}", file=sys.stderr)
        return 1
    out = args.out or (os.fspath(args.path) + ".trace.json")
    write_trace(trace, out)
    spans = sum(1 for ev in trace["traceEvents"] if ev.get("ph") == "X")
    print(f"trace: run {trace['otherData']['run']}: {spans} spans across "
          f"{len(trace['otherData']['processes'])} lane(s) -> {out}\n"
          f"open in chrome://tracing or https://ui.perfetto.dev",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

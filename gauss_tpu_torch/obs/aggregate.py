"""Merge multi-process telemetry streams into one clock-aligned run.

``python -m gauss_tpu_torch.obs.aggregate run.p0.jsonl run.p1.jsonl [-o merged.jsonl]``

The port of ``gauss_tpu/obs/aggregate.py``. A multi-process launch
(dist/multihost.py) writes one JSONL stream per process —
concurrent appends to a shared file would interleave partial lines — all
stamped with one shared run id (see ``multihost.resolve_metrics_stream``).
This module is the rank-0 gather the reference got for free from mpirun's
interleaved stdout, done properly:

- **Merge by run ID** across any number of files; each stream's process lane
  comes from its ``run_start`` fingerprint (``process_index``, stamped by
  ``registry.environment_fingerprint`` when a process group is up),
  falling back to distinct-stream
  order. Every merged event gains a ``proc`` field and duplicate (proc, seq)
  pairs collapse, so re-reading the same stream twice is harmless.
- **Clock alignment**: per-stream ``t`` is seconds since THAT process's run
  start; ``run_start.time_unix`` anchors each stream on the shared wall
  clock, and every merged event gains ``t_aligned`` = seconds since the
  EARLIEST process's start. (Host clocks are assumed NTP-close; skew shows
  up as a constant per-lane offset, not as wrong per-phase durations.)
- **Straggler statistics**: per span name, per-process totals plus
  max−min imbalance and relative skew ((max−min)/max) — the number that
  says which process the others waited for in each phase.

The merged stream is itself a valid events file: ``obs.summarize`` renders
it with per-lane coverage and ``obs.trace`` exports it with one timeline
lane per process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from gauss_tpu_torch.obs import registry


def _runs_in(events: List[Dict[str, Any]]) -> List[str]:
    seen: List[str] = []
    for ev in events:
        rid = ev.get("run")
        if rid and rid not in seen:
            seen.append(rid)
    return seen


def _pick_run(streams: Sequence[List[Dict[str, Any]]],
              run_id: Optional[str]) -> str:
    """The run to merge: explicit, else the id present in the MOST streams
    (ties broken by first appearance) — a multihost run's id is the one
    every per-process file shares."""
    if run_id:
        return run_id
    counts: Dict[str, int] = {}
    order: List[str] = []
    for evs in streams:
        for rid in _runs_in(evs):
            if rid not in counts:
                order.append(rid)
            counts[rid] = counts.get(rid, 0) + 1
    if not order:
        raise ValueError("no runs found in the input streams")
    return max(order, key=lambda rid: (counts[rid], -order.index(rid)))


def merge_streams(paths: Sequence, run_id: Optional[str] = None,
                  ) -> Tuple[str, List[Dict[str, Any]]]:
    """Read every stream, select one run, and return
    ``(run_id, merged_events)`` with ``proc`` and ``t_aligned`` stamped.

    Deterministic in file order: events sort by (t_aligned, proc, seq), all
    of which are content-derived, so the same streams in any argument order
    merge to the identical list.
    """
    streams = [registry.read_events(p) for p in paths]
    rid = _pick_run(streams, run_id)
    merged: Dict[Tuple[int, int], Dict[str, Any]] = {}
    fallback_proc = 0
    for evs in streams:
        run_evs = [ev for ev in evs if ev.get("run") == rid]
        if not run_evs:
            continue
        start = next((ev for ev in run_evs if ev.get("type") == "run_start"),
                     {})
        proc = start.get("process_index")
        if proc is None:
            proc = fallback_proc
        proc = int(proc)
        fallback_proc = max(fallback_proc, proc) + 1
        t_unix = float(start.get("time_unix") or 0.0)
        for ev in run_evs:
            key = (proc, int(ev.get("seq", -1)))
            if key in merged:
                continue
            ev = dict(ev)
            ev["proc"] = proc
            ev["_t_unix"] = t_unix + float(ev.get("t", 0.0))
            merged[key] = ev
    if not merged:
        raise ValueError(f"run '{rid}' not found in any input stream")
    t0 = min(ev["_t_unix"] for ev in merged.values())
    out = []
    for ev in merged.values():
        ev["t_aligned"] = round(ev.pop("_t_unix") - t0, 6)
        out.append(ev)
    out.sort(key=lambda ev: (ev["t_aligned"], ev["proc"], ev.get("seq", -1)))
    return rid, out


def straggler_stats(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-phase cross-process imbalance over a merged stream.

    Returns ``{"processes": [...], "wall_s": {proc: wall}, "phases":
    {name: {"per_proc_s": {proc: total}, "calls": N, "max_s", "min_s",
    "imbalance_s", "skew"}}}``. Phases missing on some process use 0 for
    the min — a phase only one process ran IS maximal imbalance (the
    others waited at the next collective).
    """
    procs = sorted({ev.get("proc", 0) for ev in events})
    wall = {p: None for p in procs}
    for ev in events:
        if ev.get("type") == "run_end" and ev.get("wall_s") is not None:
            wall[ev.get("proc", 0)] = float(ev["wall_s"])
    phases: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("type") != "span":
            continue
        ph = phases.setdefault(ev["name"],
                               {"per_proc_s": {p: 0.0 for p in procs},
                                "calls": 0})
        ph["per_proc_s"][ev.get("proc", 0)] += float(ev.get("dur_s", 0.0))
        ph["calls"] += 1
    for name, ph in phases.items():
        vals = list(ph["per_proc_s"].values())
        mx, mn = max(vals), min(vals)
        ph["max_s"] = round(mx, 6)
        ph["min_s"] = round(mn, 6)
        ph["imbalance_s"] = round(mx - mn, 6)
        ph["skew"] = round((mx - mn) / mx, 4) if mx > 0 else 0.0
        ph["per_proc_s"] = {p: round(v, 6)
                            for p, v in ph["per_proc_s"].items()}
    return {"processes": procs, "wall_s": wall, "phases": phases}


def aggregate_report(run_id: str, events: List[Dict[str, Any]],
                     stats: Optional[Dict[str, Any]] = None) -> str:
    """Human-readable straggler report for a merged run."""
    stats = stats or straggler_stats(events)
    procs = stats["processes"]
    out = [f"run {run_id}: {len(events)} events from "
           f"{len(procs)} process(es) {procs}"]
    hosts = {}
    for ev in events:
        if ev.get("type") == "run_start":
            hosts[ev.get("proc", 0)] = ev.get("host")
    for p in procs:
        w = stats["wall_s"].get(p)
        host = f" on {hosts[p]}" if hosts.get(p) else ""
        out.append(f"  process {p}{host}: wall "
                   f"{w:.6f} s" if w is not None else
                   f"  process {p}{host}: wall (no run_end)")
    if stats["phases"]:
        out.append("")
        out.append("per-phase straggler statistics (seconds by process):")
        header = "  phase".ljust(28) + "".join(f"p{p:<10}" for p in procs) \
            + "imbalance   skew"
        out.append(header)
        for name, ph in sorted(stats["phases"].items(),
                               key=lambda kv: -kv[1]["max_s"]):
            row = f"  {name}".ljust(28)
            row += "".join(f"{ph['per_proc_s'][p]:<11.6f}" for p in procs)
            row += f"{ph['imbalance_s']:<12.6f}{ph['skew']:.1%}"
            out.append(row)
    return "\n".join(out)


def write_merged(events: List[Dict[str, Any]], path) -> int:
    """Write a merged stream as JSONL (truncate, not append: a merge is a
    derived artifact, regenerated whole)."""
    path = os.fspath(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev, sort_keys=True) + "\n")
    return len(events)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.obs.aggregate",
        description="Merge per-process telemetry JSONL streams (one "
                    "multihost run) into a single clock-aligned stream "
                    "with per-phase straggler statistics.")
    p.add_argument("paths", nargs="+",
                   help="per-process JSONL streams (e.g. run.p0.jsonl "
                        "run.p1.jsonl)")
    p.add_argument("--run", default=None,
                   help="run ID to merge (default: the id shared by the "
                        "most streams)")
    p.add_argument("-o", "--out", default=None, metavar="PATH",
                   help="write the merged stream (JSONL) here; summarize/"
                        "trace it like any events file")
    p.add_argument("--json", action="store_true",
                   help="emit the straggler statistics as JSON instead of "
                        "the text report")
    args = p.parse_args(argv)
    try:
        rid, merged = merge_streams(args.paths, args.run)
    except (OSError, ValueError) as e:
        print(f"aggregate: {e}", file=sys.stderr)
        return 1
    stats = straggler_stats(merged)
    if args.out:
        n = write_merged(merged, args.out)
        print(f"aggregate: wrote {n} merged events to {args.out}",
              file=sys.stderr)
    if args.json:
        print(json.dumps({"run": rid, **stats}, indent=1, sort_keys=True))
    else:
        print(aggregate_report(rid, merged, stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())

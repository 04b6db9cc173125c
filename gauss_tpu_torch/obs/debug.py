"""``python -m gauss_tpu_torch.obs.debug`` — reconstruct a causal timeline
from a post-mortem bundle (the port of ``gauss_tpu/obs/debug.py``, the JAX
package's ``gauss-debug``; it reads either package's bundles).

The flight recorder (:mod:`gauss_tpu_torch.obs.flight`) keeps the final
seconds of a killed process on disk; the capture sites
(:mod:`gauss_tpu_torch.obs.postmortem`) freeze them into a bundle. This
CLI is the read side: point it
at a bundle (or the bundles/flight dir holding one) and it answers the
questions a 3 a.m. page asks —

- **what died, and why does the detector think so** — the bundle's single
  ``cause``, its detail, and the heartbeat age at capture;
- **what was the process doing** — the last N ``serve_batch`` dispatches
  out of the ring, each with its member trace ids, bucket, and duration;
- **who is still owed an answer** — the journal's unterminated admits (the
  in-flight request set a resumed server will replay) and the ring's open
  traces (admitted, no terminal recorded);
- **what did the queues/lanes look like at death** — the sidecar's last
  gauge snapshot (queue depth, lane occupancy) plus ring position.

``--stream run.jsonl`` folds a post-restart recorder stream into the ring
events (:func:`gauss_tpu_torch.obs.requesttrace.fold_ring_events`) so a
crash-spanning trace — admitted before the kill, resolved after the
resume — reads as ONE complete tree. ``--check`` runs the bundle
integrity + exactly-one-cause assertions (:func:`postmortem.check_bundle`)
and exits nonzero on any violation; the durable and replica chaos
campaigns run it on every bundle they capture. ``--capture`` writes a ``manual`` bundle
from a live flight dir (the scene-freeze you run BEFORE poking a sick
process).

Stdlib only; loads no torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from gauss_tpu_torch.obs import postmortem


def resolve_bundle(target: str) -> Optional[str]:
    """Map a CLI target onto one bundle path: a bundle file itself, a
    directory of bundles (latest wins), or a flight dir with a ``bundles/``
    subdirectory under it."""
    target = os.fspath(target)
    if os.path.isfile(target):
        return target
    if os.path.isdir(target):
        latest = postmortem.latest_bundle(target)
        if latest:
            return latest
        return postmortem.latest_bundle(postmortem.default_bundles_dir(target))
    return None


def _ring_events(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    fl = doc.get("flight") or {}
    out: List[Dict[str, Any]] = []
    for r in fl.get("rings", ()):
        out.extend(r.get("events", ()))
    return out


def _last_sidecar(doc: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    fl = doc.get("flight") or {}
    sidecars = [r.get("sidecar") for r in fl.get("rings", ())
                if r.get("sidecar")]
    return sidecars[-1] if sidecars else None


def reconstruct(doc: Dict[str, Any], batches: int = 5,
                stream_events: Optional[List[Dict[str, Any]]] = None,
                ) -> Dict[str, Any]:
    """Fold a bundle (plus an optional post-restart stream) into the
    timeline dict the text/JSON renderers print. Pure function of its
    inputs — the flight-check gate asserts on this shape."""
    from gauss_tpu_torch.obs import requesttrace

    ring = _ring_events(doc)
    events = requesttrace.fold_ring_events(stream_events or [], ring)
    last_batches = [ev for ev in events if ev.get("type") == "serve_batch"]
    last_batches = last_batches[-batches:] if batches else last_batches
    jn = doc.get("journal") or {}
    in_flight = list(jn.get("live_admits", ()))
    trees = requesttrace.request_traces(events)
    open_traces = sorted(t for t, tree in trees.items()
                         if tree["terminal_count"] == 0)
    completed = sum(1 for tree in trees.values()
                    if tree["terminal_count"] > 0)
    sidecar = _last_sidecar(doc)
    fl = doc.get("flight") or {}
    return {
        "cause": doc.get("cause"),
        "time_unix": doc.get("time_unix"),
        "captured_by": doc.get("captured_by"),
        "detail": doc.get("detail"),
        "heartbeats": doc.get("heartbeats"),
        "rings": [{"path": r.get("path"), "pid": r.get("pid"),
                   "stats": r.get("stats")} for r in fl.get("rings", ())],
        "ring_events": len(ring),
        "last_batches": last_batches,
        "in_flight": in_flight,
        "open_traces": open_traces,
        "traces": len(trees),
        "traces_completed": completed,
        "gauges": (sidecar or {}).get("gauges") or {},
        "sidecar": sidecar,
        "trees": trees,
    }


def _age(then: Optional[float], now: Optional[float] = None) -> str:
    if not isinstance(then, (int, float)):
        return "?"
    age = (time.time() if now is None else now) - then
    if age >= 3600:
        return f"{age / 3600:.1f}h"
    if age >= 60:
        return f"{age / 60:.1f}m"
    return f"{age:.1f}s"


def format_timeline(path: str, rec: Dict[str, Any]) -> str:
    cap = rec.get("captured_by") or {}
    lines = [f"post-mortem bundle: {path}",
             f"cause: {rec.get('cause')}  captured {_age(rec.get('time_unix'))} ago"
             f" by pid {cap.get('pid')}"]
    if rec.get("detail"):
        kv = " ".join(f"{k}={v}" for k, v in sorted(rec["detail"].items()))
        lines.append(f"detail: {kv}")
    for hb in rec.get("heartbeats") or ():
        age = hb.get("age_s")
        lines.append(
            f"heartbeat: {hb.get('path')} "
            + (f"age {age:.3f}s at capture" if isinstance(age, (int, float))
               else "absent"))
    for ring in rec.get("rings", ()):
        st = ring.get("stats") or {}
        lines.append(f"ring: {ring.get('path')}  pid={ring.get('pid')} "
                     f"records={st.get('records')} "
                     f"torn_dropped={st.get('torn_dropped')} "
                     f"wpos={st.get('wpos')}/{st.get('capacity')}")
    gauges = rec.get("gauges") or {}
    if gauges:
        lines.append("queue/lane state at death (last sidecar write):")
        for name in sorted(gauges):
            lines.append(f"  {name} = {gauges[name]:g}")
    batches = rec.get("last_batches") or []
    lines.append(f"last {len(batches)} batch(es):")
    if not batches:
        lines.append("  (none in ring)")
    for ev in batches:
        traces = ",".join(str(t) for t in (ev.get("traces") or ()))
        lines.append(
            f"  tu={ev.get('tu', ev.get('t'))} bucket={ev.get('bucket_n')} "
            f"requests={ev.get('requests')} "
            f"seconds={ev.get('seconds')} traces={traces or '-'}")
    in_flight = rec.get("in_flight") or []
    lines.append(f"in flight at death (journal unterminated admits): "
                 f"{len(in_flight)} request(s)")
    for adm in in_flight:
        lines.append(f"  id={adm.get('id')} trace={adm.get('trace')} "
                     f"n={adm.get('n')} deadline={adm.get('deadline_unix')}")
    open_traces = rec.get("open_traces") or []
    lines.append(f"open traces (no terminal in ring"
                 f"{'+stream' if rec.get('stream_folded') else ''}): "
                 f"{len(open_traces)}"
                 + (f"  {' '.join(open_traces)}" if open_traces else ""))
    lines.append(f"traces: {rec.get('traces')} seen, "
                 f"{rec.get('traces_completed')} completed")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.obs.debug",
        description="Reconstruct the causal timeline of a crash from a "
                    "post-mortem bundle: cause, last batches with trace "
                    "ids, in-flight requests, queue/lane state at death.")
    p.add_argument("target",
                   help="bundle json, a bundles dir (latest bundle wins), "
                        "or a flight dir holding bundles/")
    p.add_argument("--batches", type=int, default=5, metavar="N",
                   help="show the last N serve_batch dispatches "
                        "(default 5; 0 = all in ring)")
    p.add_argument("--stream", default=None, metavar="JSONL",
                   help="fold a post-restart recorder stream into the ring "
                        "events so crash-spanning traces complete")
    p.add_argument("--trace", default=None, metavar="ID",
                   help="print the folded request tree for one trace id")
    p.add_argument("--json", action="store_true",
                   help="emit the reconstruction as JSON (trees included)")
    p.add_argument("--check", action="store_true",
                   help="assert bundle integrity + exactly-one-cause "
                        "attribution (exit 1 on any violation)")
    p.add_argument("--capture", action="store_true",
                   help="capture a 'manual' bundle from --flight-dir "
                        "first, then reconstruct it (target is ignored; "
                        "pass the flight dir as target)")
    p.add_argument("--journal", default=None, metavar="DIR",
                   help="with --capture: include this request journal's "
                        "tail in the bundle")
    args = p.parse_args(argv)

    if args.capture:
        flight_dir = args.target
        path = postmortem.capture_bundle(
            postmortem.default_bundles_dir(flight_dir), "manual",
            flight_dir=flight_dir, journal_dir=args.journal)
        if path is None:
            print("gauss-debug: manual capture failed", file=sys.stderr)
            return 2
        print(f"captured: {path}")
    else:
        path = resolve_bundle(args.target)
        if path is None:
            print(f"gauss-debug: no bundle found at '{args.target}'",
                  file=sys.stderr)
            return 2
    try:
        doc = postmortem.read_bundle(path)
    except (OSError, ValueError) as e:
        print(f"gauss-debug: cannot read bundle '{path}': {e}",
              file=sys.stderr)
        return 2

    stream_events = None
    if args.stream:
        from gauss_tpu_torch.obs import registry

        try:
            stream_events = registry.read_events(args.stream)
        except OSError as e:
            print(f"gauss-debug: cannot read stream '{args.stream}': {e}",
                  file=sys.stderr)
            return 2
    rec = reconstruct(doc, batches=args.batches,
                      stream_events=stream_events)
    rec["stream_folded"] = bool(args.stream)

    if args.check:
        problems = postmortem.check_bundle(doc)
        for prob in problems:
            print(f"gauss-debug: {prob}", file=sys.stderr)
        print(f"gauss-debug: {path}: {len(problems)} problem(s)")
        return 1 if problems else 0

    if args.trace:
        from gauss_tpu_torch.obs import requesttrace

        tree = rec["trees"].get(args.trace)
        if tree is None:
            print(f"gauss-debug: trace '{args.trace}' not found "
                  f"({len(rec['trees'])} trace(s) in bundle)",
                  file=sys.stderr)
            return 2
        print(requesttrace.format_tree(tree))
        return 0

    if args.json:
        print(json.dumps(rec, indent=1, sort_keys=True, default=str))
    else:
        rec.pop("trees", None)
        print(format_timeline(path, rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

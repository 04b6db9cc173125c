"""End-to-end request tracing: one span tree per served request (a copy
of the JAX package's ``obs/requesttrace.py``).

``python -m gauss_tpu_torch.obs.requesttrace run.jsonl [--trace ID] [--json]``

Before this module, serving telemetry was BATCH-scoped: ``serve_batch_*``
spans carried no request identity, so "where did request 17's 40 ms go?"
was unanswerable from the stream. Now every request is minted a
``trace_id`` at ``submit()`` and the id rides the whole lifecycle:

- **admission** — the ``serve_admit`` event (queue depth at entry, bucket,
  deadline) and every synchronous rejection;
- **bucket/cache/dispatch** — batch-level spans and events
  (``serve_batch_pad`` / ``serve_batch_solve`` / ``serve_batch`` /
  ``serve_cache`` / ``serve_retry``) carry ``traces=[...]`` — the ids of
  every member request — plus ``requests=N``, so per-request numbers are
  computable from per-batch records (cost attribution: a batch span is
  shared by its members);
- **recovery / handoff** — the worker wraps per-request lanes in
  :func:`context`, so events emitted DEEP in library code with no trace
  parameter (``recovery`` rungs from recover.solve_resilient, ``route``
  from solve_handoff, fleet events) are stamped automatically via the
  thread-local in gauss_tpu_torch.obs.spans;
- **terminal** — exactly one ``serve_request`` terminal event per request
  (the resolve-CAS guarantee), carrying the trace id.

:func:`request_traces` folds a recorded stream back into one tree per
trace id — root = the request, children = its stages in stream order,
batch spans shared by several requests appear in each member's tree.
The invariant the tests pin: every terminal status has EXACTLY ONE trace.
"""

from __future__ import annotations

import argparse
import json
import sys
import uuid
from typing import Any, Dict, List, Optional

from gauss_tpu_torch.obs import registry
# Re-exported: the thread-local context lives in spans (next to the emit
# hooks that consult it) so library emits need no import of this module.
from gauss_tpu_torch.obs.spans import current_trace, trace_context  # noqa: F401

#: statuses that end a request (admission.py mirrors these; kept here so
#: the obs layer has no serve import)
TERMINAL_STATUSES = ("ok", "rejected", "expired", "failed", "cancelled")

#: event types that are per-request stages (single ``trace``) or shared
#: batch stages (``traces`` list) in a request tree
_STAGE_TYPES = ("serve_admit", "serve_request", "serve_batch", "serve_cache",
                "serve_retry", "serve_fallback", "serve_dedup", "span",
                "recovery", "route", "fault", "fleet", "health")


def mint() -> str:
    """A fresh trace id (hex, collision-safe across hosts)."""
    return uuid.uuid4().hex[:16]


def _trace_ids(ev: Dict[str, Any]) -> List[str]:
    tid = ev.get("trace")
    if tid:
        return [str(tid)]
    tids = ev.get("traces")
    if isinstance(tids, (list, tuple)):
        return [str(t) for t in tids]
    return []


def request_traces(events: List[Dict[str, Any]],
                   run_id: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """Fold a stream into ``{trace_id: tree}``. A tree is::

        {"trace": id, "request_id", "n", "status", "lane", "latency_s",
         "terminal_count", "stages": [ {stage, t, ...fields} ... ]}

    Stages are in stream order (the recorder's ``seq``); a batch-shared
    stage (``traces`` list) appears in every member tree with
    ``shared=N`` so per-request cost attribution can divide by it."""
    if run_id is not None:
        events = [ev for ev in events if ev.get("run") == run_id]
    trees: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        typ = ev.get("type")
        if typ not in _STAGE_TYPES:
            continue
        tids = _trace_ids(ev)
        if not tids:
            continue
        shared = len(tids)
        for tid in tids:
            tree = trees.get(tid)
            if tree is None:
                tree = trees[tid] = {
                    "trace": tid, "request_id": None, "n": None,
                    "status": None, "lane": None, "latency_s": None,
                    "terminal_count": 0, "stages": []}
            stage = {"stage": (ev.get("name") if typ == "span" else typ),
                     "t": ev.get("t")}
            for k, v in ev.items():
                if k in ("type", "run", "seq", "t", "trace", "traces",
                         "name"):
                    continue
                stage[k] = v
            if shared > 1:
                stage["shared"] = shared
            tree["stages"].append(stage)
            if typ == "serve_admit":
                tree["request_id"] = ev.get("id")
                tree["n"] = ev.get("n")
            elif (typ == "serve_request"
                    and ev.get("status") in TERMINAL_STATUSES):
                tree["terminal_count"] += 1
                tree["status"] = ev.get("status")
                tree["lane"] = ev.get("lane") or tree["lane"]
                tree["request_id"] = ev.get("id", tree["request_id"])
                tree["n"] = ev.get("n", tree["n"])
                if ev.get("latency_s") is not None:
                    tree["latency_s"] = ev.get("latency_s")
    return trees


def _fold_key(ev: Dict[str, Any]) -> str:
    """Content identity of an event, ignoring sink-specific stamps: the
    recorder adds run/seq/t, the flight ring adds tu — the same emit seen
    through both sinks must collapse to one stage."""
    skip = ("run", "seq", "t", "tu")
    return json.dumps({k: v for k, v in ev.items() if k not in skip},
                      sort_keys=True, default=str)


def fold_ring_events(events: List[Dict[str, Any]],
                     ring_events: List[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
    """Merge flight-ring records (:func:`gauss_tpu_torch.obs.flight.scan`,
    either package's ring) into a
    recorded stream so a crash-spanning trace completes: the dead
    incarnation's ring carries the admit/batch stages the recorder lost
    with the process, the survivor's stream carries the terminal the
    journal resume produced. Ring events come first (they predate the
    surviving stream); duplicates — both sinks saw the same emit — fold to
    one stage. Ring ``tu`` doubles as the stage ``t`` when absent."""
    out: List[Dict[str, Any]] = []
    seen = set()
    for ev in ring_events:
        if ev.get("type") not in _STAGE_TYPES:
            continue
        key = _fold_key(ev)
        if key in seen:
            continue
        seen.add(key)
        ev = dict(ev)
        if "t" not in ev and "tu" in ev:
            ev["t"] = ev["tu"]
        out.append(ev)
    for ev in events:
        key = _fold_key(ev)
        if key in seen:
            continue
        seen.add(key)
        out.append(ev)
    return out


def check_traces(trees: Dict[str, Dict[str, Any]]) -> List[str]:
    """The exactly-one-trace-per-terminal invariant, as a problem list
    (empty = healthy). Used by tests and ``make live-check``."""
    problems = []
    for tid, tree in trees.items():
        if tree["terminal_count"] == 0:
            problems.append(f"trace {tid}: no terminal status recorded")
        elif tree["terminal_count"] > 1:
            problems.append(f"trace {tid}: {tree['terminal_count']} "
                            f"terminal statuses (must be exactly 1)")
    return problems


def format_tree(tree: Dict[str, Any]) -> str:
    head = (f"trace {tree['trace']}  request={tree['request_id']} "
            f"n={tree['n']} status={tree['status']}")
    if tree.get("lane"):
        head += f" lane={tree['lane']}"
    if isinstance(tree.get("latency_s"), (int, float)):
        head += f" latency={tree['latency_s'] * 1e3:.3f} ms"
    lines = [head]
    for st in tree["stages"]:
        kv = " ".join(
            f"{k}={v}" for k, v in st.items()
            if k not in ("stage", "t") and v is not None)
        t = st.get("t")
        ts = f"{t:9.6f}" if isinstance(t, (int, float)) else "        ?"
        lines.append(f"  {ts}  {st['stage']}" + (f"  {kv}" if kv else ""))
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.obs.requesttrace",
        description="Reconstruct per-request span trees from a recorded "
                    "serving stream (one tree per trace_id, admission "
                    "through terminal status).")
    p.add_argument("path", help="JSONL events file (--metrics-out output)")
    p.add_argument("--run", default=None, help="restrict to this run ID")
    p.add_argument("--trace", default=None, help="print only this trace id")
    p.add_argument("--json", action="store_true",
                   help="emit the trees as JSON keyed by trace id")
    p.add_argument("--check", action="store_true",
                   help="verify every trace has exactly one terminal "
                        "status (exit 1 otherwise)")
    args = p.parse_args(argv)
    try:
        events = registry.read_events(args.path)
    except OSError as e:
        print(f"requesttrace: cannot read '{args.path}': {e}",
              file=sys.stderr)
        return 2
    trees = request_traces(events, args.run)
    if args.trace:
        if args.trace not in trees:
            print(f"requesttrace: trace '{args.trace}' not found "
                  f"({len(trees)} trace(s) in stream)", file=sys.stderr)
            return 2
        trees = {args.trace: trees[args.trace]}
    if args.json:
        print(json.dumps(trees, indent=1, sort_keys=True))
    else:
        print("\n\n".join(format_tree(trees[t]) for t in sorted(trees))
              or "(no traces found)")
    if args.check:
        problems = check_traces(trees)
        for prob in problems:
            print(f"requesttrace: {prob}", file=sys.stderr)
        print(f"requesttrace: {len(trees)} trace(s), "
              f"{len(problems)} problem(s)", file=sys.stderr)
        return 1 if problems else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())

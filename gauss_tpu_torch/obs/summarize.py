"""Render a recorded run: gprof-style flat profile + health + accounting.

``python -m gauss_tpu_torch.obs.summarize run.jsonl [--run ID] [--json]`` — the
offline consumer of the JSONL event stream (the gprof step of the reference's
workflow, SURVEY §5, replayed from persistent data instead of a one-shot
stdout table).

The flat profile aggregates LEAF spans (spans that are never some other
span's parent), so nested regions are not double-counted, and reports the
leaf total against the run's wall-clock — the coverage line is the honesty
check that the spans actually tile the run instead of sampling it. On a
MERGED multihost stream (``obs.aggregate`` stamps ``proc`` on every event)
coverage is computed PER PROCESS and reported per lane: each process has its
own wall-clock, and a single-stream formula dividing the summed span time of
P processes by one process's wall would read ~P00%.

``--json`` emits the complete summary (profile, lanes, health, collective
traffic, compile/cost, vmem, metrics) as machine-readable JSON keyed by run
— the form CI and the regression sentinel consume.

A copy of the JAX package's summarizer, so one renderer reads either
package's stream. The event producers its sections name (serving,
resilience, attribution, post-mortems) are the JAX package's modules; the
port emits the same events as it ports them.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from gauss_tpu_torch.obs import registry


def _runs(events: List[Dict[str, Any]]) -> List[str]:
    seen = []
    for ev in events:
        rid = ev.get("run")
        if rid and rid not in seen:
            seen.append(rid)
    return seen


def _fmt(v) -> str:
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1e5 or abs(v) < 1e-4:
            return f"{v:.3e}"
        return f"{v:.6g}"
    return str(v)


def _procs(events: List[Dict[str, Any]]) -> List[int]:
    return sorted({int(ev.get("proc", 0)) for ev in events})


def flat_profile(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate span events into {name: {seconds, calls}} over leaves, plus
    totals. Returns a dict so tests and JSON output share the numbers.

    ``lanes`` holds the per-process split of a merged multihost stream
    (span total, wall-clock and coverage PER process); on a single-process
    stream it has one lane and matches the totals. The top-level ``wall_s``
    is the max lane wall — the run's duration, not the sum of P clocks.
    """
    spans = [ev for ev in events if ev.get("type") == "span"]
    parents = {ev.get("parent") for ev in spans if ev.get("parent")}
    leaves = [ev for ev in spans if ev["name"] not in parents]
    agg: Dict[str, Dict[str, float]] = {}
    for ev in leaves:
        a = agg.setdefault(ev["name"], {"seconds": 0.0, "calls": 0})
        a["seconds"] += float(ev.get("dur_s", 0.0))
        a["calls"] += 1
    total = sum(a["seconds"] for a in agg.values())

    lanes: Dict[int, Dict[str, Any]] = {}
    for proc in _procs(events):
        lane_total = sum(float(ev.get("dur_s", 0.0)) for ev in leaves
                         if int(ev.get("proc", 0)) == proc)
        wall = None
        for ev in events:
            if (ev.get("type") == "run_end" and int(ev.get("proc", 0)) == proc
                    and ev.get("wall_s") is not None):
                wall = float(ev["wall_s"])
        lanes[proc] = {"span_total_s": lane_total, "wall_s": wall,
                       "coverage": (lane_total / wall if wall else None)}
    walls = [l["wall_s"] for l in lanes.values() if l["wall_s"]]
    return {"phases": agg, "span_total_s": total,
            "wall_s": max(walls) if walls else None, "lanes": lanes}


def _profile_lines(prof: Dict[str, Any]) -> List[str]:
    agg, total = prof["phases"], prof["span_total_s"]
    lines = ["  %time    seconds   calls  phase"]
    denom = total or 1.0
    for name, a in sorted(agg.items(), key=lambda kv: -kv[1]["seconds"]):
        lines.append(f"  {100.0 * a['seconds'] / denom:5.1f}  "
                     f"{a['seconds']:9.6f}  {a['calls']:6d}  {name}")
    lines.append(f"  span total {total:.6f} s")
    lanes = prof.get("lanes") or {}
    if len(lanes) > 1:
        # Merged multihost stream: one coverage line PER process lane —
        # each process has its own wall-clock (the single-stream formula
        # against one wall would report ~P00% and nonsense skew).
        for proc in sorted(lanes):
            lane = lanes[proc]
            if lane["wall_s"]:
                lines.append(
                    f"  process {proc}: wall-clock {lane['wall_s']:.6f} s "
                    f"({100.0 * lane['coverage']:.1f}% covered by its leaf "
                    f"spans)")
            else:
                lines.append(f"  process {proc}: (no run_end recorded)")
    elif prof["wall_s"]:
        cov = 100.0 * total / prof["wall_s"]
        lines.append(f"  run wall-clock {prof['wall_s']:.6f} s "
                     f"({cov:.1f}% covered by leaf spans)")
    return lines


def comms_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold ``collective`` events into per-engine traffic totals:
    ``{label: {"ops": {op: {count, bytes}}, "count", "bytes"}}``."""
    out: Dict[str, Any] = {}
    for ev in events:
        if ev.get("type") != "collective":
            continue
        label = str(ev.get("label", "?"))
        eng = out.setdefault(label, {"ops": {}, "count": 0, "bytes": 0})
        op = eng["ops"].setdefault(str(ev.get("op", "?")),
                                   {"count": 0, "bytes": 0})
        c = int(ev.get("count", 0) or 0)
        b = int(ev.get("bytes", 0) or 0)
        op["count"] += c
        op["bytes"] += b
        eng["count"] += c
        eng["bytes"] += b
    return out


def serving_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the serving layer's events (``serve_request`` / ``serve_batch``
    / ``serve_cache`` / ``serve_retry`` / ``serve_fallback`` / handoff
    ``route``) into one report: request counts by status and lane, latency
    percentiles, batch occupancy, and cache hit/miss — the summarizer-side
    mirror of the loadgen report, but computed from ANY recorded stream
    (a production server's run, not just a load test). Empty dict when the
    run did no serving."""
    reqs = [ev for ev in events if ev.get("type") == "serve_request"]
    batches = [ev for ev in events if ev.get("type") == "serve_batch"]
    caches = [ev for ev in events if ev.get("type") == "serve_cache"]
    retries = [ev for ev in events if ev.get("type") == "serve_retry"]
    fallbacks = [ev for ev in events if ev.get("type") == "serve_fallback"]
    steals = [ev for ev in events if ev.get("type") == "lane_steal"]
    scales = [ev for ev in events if ev.get("type") == "lane_scale"]
    routes = [ev for ev in events if ev.get("type") == "route"
              and ev.get("tool") == "solve_handoff"]
    if not (reqs or batches or caches):
        return {}
    by_status: Dict[str, int] = {}
    by_lane: Dict[str, int] = {}
    lat: List[float] = []
    for ev in reqs:
        st = str(ev.get("status", "?"))
        by_status[st] = by_status.get(st, 0) + 1
        lane = ev.get("lane")
        if lane:
            by_lane[str(lane)] = by_lane.get(str(lane), 0) + 1
        if st == "ok" and isinstance(ev.get("latency_s"), (int, float)):
            lat.append(float(ev["latency_s"]))
    lat.sort()

    def _pct(q: float):
        return lat[min(len(lat) - 1, int(q * len(lat)))] if lat else None

    occ = [float(ev["occupancy"]) for ev in batches
           if isinstance(ev.get("occupancy"), (int, float))]
    cache_counts = {"hit": 0, "miss": 0, "evict": 0}
    for ev in caches:
        k = str(ev.get("event", "?"))
        cache_counts[k] = cache_counts.get(k, 0) + 1
    lookups = cache_counts["hit"] + cache_counts["miss"]
    route_lanes: Dict[str, int] = {}
    for ev in routes:
        lane = str(ev.get("lane", "?"))
        route_lanes[lane] = route_lanes.get(lane, 0) + 1
    # Mesh-plane fold: serve_batch events carry ``lane`` when a LaneSet
    # dispatched them; steal/scale events exist only on the mesh plane.
    mesh_batches: Dict[str, int] = {}
    for ev in batches:
        if ev.get("lane") is not None:
            k = str(ev["lane"])
            mesh_batches[k] = mesh_batches.get(k, 0) + 1
    mesh = {}
    if mesh_batches or steals or scales:
        mesh = {"lane_batches": mesh_batches, "steals": len(steals),
                "stolen_requests": sum(int(ev.get("requests", 0) or 0)
                                       for ev in steals),
                "scale_events": len(scales)}
    return {
        "requests": by_status,
        "lanes": by_lane,
        "mesh": mesh,
        "retries": len(retries),
        "fallbacks": len(fallbacks),
        "latency_s": {"count": len(lat),
                      "mean": sum(lat) / len(lat) if lat else None,
                      "p50": _pct(0.50), "p95": _pct(0.95),
                      "p99": _pct(0.99)},
        "batches": {"count": len(batches),
                    "occupancy_mean": sum(occ) / len(occ) if occ else None},
        "cache": {**cache_counts,
                  "hit_rate": (cache_counts["hit"] / lookups
                               if lookups else None)},
        "handoff_routes": route_lanes,
    }


def _serving_lines(sv: Dict[str, Any]) -> List[str]:
    def _f(v):
        return "-" if v is None else _fmt(round(v, 6) if isinstance(v, float)
                                          else v)

    lines = []
    req = ", ".join(f"{k}={v}" for k, v in sorted(sv["requests"].items()))
    lane = ", ".join(f"{k}={v}" for k, v in sorted(sv["lanes"].items()))
    lines.append(f"  requests: {req or '-'}" + (f"  lanes: {lane}" if lane
                                                else ""))
    lat = sv["latency_s"]
    lines.append(f"  latency s: p50 {_f(lat['p50'])}  p95 {_f(lat['p95'])}  "
                 f"p99 {_f(lat['p99'])}  (n={lat['count']})")
    b = sv["batches"]
    c = sv["cache"]
    lines.append(f"  batches: {b['count']}, mean occupancy "
                 f"{_f(b['occupancy_mean'])}; cache: {c['hit']} hits / "
                 f"{c['miss']} misses (hit-rate {_f(c['hit_rate'])}), "
                 f"{c['evict']} evictions")
    mesh = sv.get("mesh")
    if mesh:
        per = ", ".join(f"L{k}={v}" for k, v in
                        sorted(mesh["lane_batches"].items(),
                               key=lambda kv: int(kv[0])))
        lines.append(f"  mesh: batches by lane: {per or '-'}; "
                     f"{mesh['steals']} steal(s) "
                     f"({mesh['stolen_requests']} request(s)), "
                     f"{mesh['scale_events']} autoscale event(s)")
    if sv["retries"] or sv["fallbacks"]:
        lines.append(f"  degradation: {sv['retries']} retried batch "
                     f"attempt(s), {sv['fallbacks']} fallback-lane trip(s)")
    if sv["handoff_routes"]:
        routes = ", ".join(f"{k} x{v}"
                           for k, v in sorted(sv["handoff_routes"].items()))
        lines.append(f"  solve_handoff routing: {routes}")
    return lines


def durability_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the durable-admission events (``journal`` lifecycle from
    gauss_tpu.serve.durable, ``serve_resume`` recovery reports,
    ``serve_dedup`` idempotent-resubmission hits, ``serve_supervisor``
    watchdog transitions) into one report. Empty dict when the run used no
    journal — journal-off runs carry no durability noise."""
    journal = [ev for ev in events if ev.get("type") == "journal"]
    resumes = [ev for ev in events if ev.get("type") == "serve_resume"]
    # Idempotent dedupe shows up two ways: a journaled-terminal hit emits
    # its terminal ``serve_request`` with deduped=True; an in-flight hit
    # (key already pending) emits a ``serve_dedup`` attach event.
    dedups = ([ev for ev in events if ev.get("type") == "serve_dedup"]
              + [ev for ev in events if ev.get("type") == "serve_request"
                 and ev.get("deduped")])
    sup = [ev for ev in events if ev.get("type") == "serve_supervisor"]
    if not (journal or resumes):
        return {}
    jevents: Dict[str, int] = {}
    torn = 0
    for ev in journal:
        k = str(ev.get("event", "?"))
        jevents[k] = jevents.get(k, 0) + 1
        if k == "torn_tail":
            torn += int(ev.get("dropped", 0) or 0)
    sup_events: Dict[str, int] = {}
    for ev in sup:
        k = str(ev.get("event", "?"))
        sup_events[k] = sup_events.get(k, 0) + 1
    return {
        "journal_events": jevents,
        "torn_dropped": torn,
        "resumes": {"count": len(resumes),
                    "replayed": sum(int(ev.get("replayed", 0) or 0)
                                    for ev in resumes),
                    "expired": sum(int(ev.get("expired", 0) or 0)
                                   for ev in resumes),
                    "clean": sum(1 for ev in resumes if ev.get("clean"))},
        "deduped": len(dedups),
        "supervisor": sup_events,
    }


def _durability_lines(du: Dict[str, Any]) -> List[str]:
    lines = []
    je = ", ".join(f"{k} x{v}"
                   for k, v in sorted(du["journal_events"].items()))
    lines.append(f"  journal: {je or '-'}"
                 + (f"; {du['torn_dropped']} torn record(s) dropped"
                    if du["torn_dropped"] else ""))
    r = du["resumes"]
    lines.append(f"  resumes: {r['count']} ({r['replayed']} replayed, "
                 f"{r['expired']} expired-in-recovery, {r['clean']} clean); "
                 f"{du['deduped']} idempotent dedupe(s)")
    if du["supervisor"]:
        sv = ", ".join(f"{k} x{v}"
                       for k, v in sorted(du["supervisor"].items()))
        lines.append(f"  supervisor: {sv}")
    return lines


def slo_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the live plane's ``alert`` transitions (obs.slo burn-rate
    alerts) into per-SLO fire/clear counts with the last observed burn
    rates. Empty dict when the run raised none — healthy runs carry no
    alert noise."""
    alerts = [ev for ev in events if ev.get("type") == "alert"]
    if not alerts:
        return {}
    per: Dict[str, Dict[str, Any]] = {}
    for ev in alerts:
        name = str(ev.get("slo", "?"))
        s = per.setdefault(name, {"fired": 0, "cleared": 0,
                                  "last_state": None, "worst_burn": 0.0})
        state = str(ev.get("state", "?"))
        if state == "firing":
            s["fired"] += 1
        elif state == "clear":
            s["cleared"] += 1
        s["last_state"] = state
        if isinstance(ev.get("burn_short"), (int, float)):
            s["worst_burn"] = max(s["worst_burn"], float(ev["burn_short"]))
    return {"slos": per,
            "alerts": sum(s["fired"] for s in per.values()),
            "unresolved": sum(1 for s in per.values()
                              if s["last_state"] == "firing")}


def _slo_lines(sl: Dict[str, Any]) -> List[str]:
    lines = [f"  {sl['alerts']} alert(s) fired, "
             f"{sl['unresolved']} still firing at run end"]
    for name, s in sorted(sl["slos"].items()):
        lines.append(f"  {name}: fired x{s['fired']}, cleared "
                     f"x{s['cleared']}, worst short-window burn "
                     f"{_fmt(s['worst_burn'])}x, last state "
                     f"{s['last_state']}")
    return lines


def resilience_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the resilience layer's events (``fault`` injections from
    gauss_tpu.resilience.inject, ``recovery`` ladder steps from
    recover.solve_resilient, ``checkpoint`` save/resume from the
    checkpointed factorization) into one report: injections by site and
    kind, recoveries by rung, escalation/unrecoverable counts, checkpoint
    activity. Empty dict when the run saw none of it — healthy runs carry
    no resilience noise."""
    faults = [ev for ev in events if ev.get("type") == "fault"]
    recov = [ev for ev in events if ev.get("type") == "recovery"]
    ckpts = [ev for ev in events if ev.get("type") == "checkpoint"]
    if not (faults or recov or ckpts):
        return {}
    by_site: Dict[str, int] = {}
    by_kind: Dict[str, int] = {}
    for ev in faults:
        site = str(ev.get("site", "?"))
        kind = str(ev.get("kind", "?"))
        by_site[site] = by_site.get(site, 0) + 1
        by_kind[kind] = by_kind.get(kind, 0) + 1
    recovered_by_rung: Dict[str, int] = {}
    escalations = 0
    unrecoverable = 0
    for ev in recov:
        outcome = ev.get("outcome")
        if outcome == "recovered":
            rung = str(ev.get("rung", "?"))
            recovered_by_rung[rung] = recovered_by_rung.get(rung, 0) + 1
        elif outcome == "escalate":
            escalations += 1
        elif outcome == "unrecoverable":
            unrecoverable += 1
    ckpt_counts: Dict[str, int] = {}
    for ev in ckpts:
        k = str(ev.get("event", "?"))
        ckpt_counts[k] = ckpt_counts.get(k, 0) + 1
    return {
        "injections": {"total": len(faults), "by_site": by_site,
                       "by_kind": by_kind},
        "recoveries": {"total": sum(recovered_by_rung.values()),
                       "by_rung": recovered_by_rung},
        "escalations": escalations,
        "unrecoverable": unrecoverable,
        "checkpoints": ckpt_counts,
    }


def _resilience_lines(rs: Dict[str, Any]) -> List[str]:
    inj = rs["injections"]
    rec = rs["recoveries"]
    lines = []
    sites = ", ".join(f"{k} x{v}" for k, v in sorted(inj["by_site"].items()))
    kinds = ", ".join(f"{k} x{v}" for k, v in sorted(inj["by_kind"].items()))
    lines.append(f"  injected faults: {inj['total']}"
                 + (f"  ({sites})" if sites else ""))
    if kinds:
        lines.append(f"  by kind: {kinds}")
    rungs = ", ".join(f"{k} x{v}" for k, v in sorted(rec["by_rung"].items()))
    lines.append(f"  recoveries: {rec['total']}"
                 + (f"  (by rung: {rungs})" if rungs else "")
                 + f"; {rs['escalations']} escalation step(s), "
                 f"{rs['unrecoverable']} unrecoverable")
    if rs["checkpoints"]:
        ck = ", ".join(f"{k} x{v}"
                       for k, v in sorted(rs["checkpoints"].items()))
        lines.append(f"  checkpoints: {ck}")
    return lines


def sdc_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the ABFT layer's events (``sdc`` checksum-mismatch detections
    from gauss_tpu.resilience.abft, ``sdc_inject`` on-device corruption
    injections) into one report: detections by engine and action
    (replay / escalate / correct / recompute), injected on-device faults,
    worst mismatch magnitude, and detection-latency stats. Empty dict when
    the run saw none of it — healthy runs carry no SDC noise."""
    dets = [ev for ev in events if ev.get("type") == "sdc"]
    injs = [ev for ev in events if ev.get("type") == "sdc_inject"]
    if not (dets or injs):
        return {}
    by_engine: Dict[str, int] = {}
    by_action: Dict[str, int] = {}
    lat = []
    max_mag = 0.0
    for ev in dets:
        eng = str(ev.get("engine", "?"))
        act = str(ev.get("action", "?"))
        by_engine[eng] = by_engine.get(eng, 0) + 1
        by_action[act] = by_action.get(act, 0) + 1
        if isinstance(ev.get("latency_s"), (int, float)):
            lat.append(float(ev["latency_s"]))
        mag = ev.get("magnitude")
        if isinstance(mag, (int, float)) and mag == mag:
            max_mag = max(max_mag, float(mag))
    inj_by_site: Dict[str, int] = {}
    for ev in injs:
        site = str(ev.get("site", "?"))
        inj_by_site[site] = inj_by_site.get(site, 0) + 1
    out = {
        "detections": {"total": len(dets), "by_engine": by_engine,
                       "by_action": by_action},
        "injected": {"total": len(injs), "by_site": inj_by_site},
        "max_magnitude": max_mag,
    }
    if lat:
        out["detect_latency_s"] = {
            "mean": round(sum(lat) / len(lat), 6),
            "max": round(max(lat), 6),
        }
    return out


def _sdc_lines(sd: Dict[str, Any]) -> List[str]:
    det = sd["detections"]
    inj = sd["injected"]
    engines = ", ".join(f"{k} x{v}"
                        for k, v in sorted(det["by_engine"].items()))
    actions = ", ".join(f"{k} x{v}"
                        for k, v in sorted(det["by_action"].items()))
    lines = [f"  detections: {det['total']}"
             + (f"  ({engines})" if engines else "")
             + (f"; actions: {actions}" if actions else "")]
    if inj["total"]:
        sites = ", ".join(f"{k} x{v}"
                          for k, v in sorted(inj["by_site"].items()))
        lines.append(f"  injected on-device faults: {inj['total']}"
                     + (f"  ({sites})" if sites else ""))
    lines.append(f"  worst |mismatch|: {_fmt(sd['max_magnitude'])}")
    if "detect_latency_s" in sd:
        ls = sd["detect_latency_s"]
        lines.append(f"  detect latency: mean {_fmt(ls['mean'])} s, "
                     f"max {_fmt(ls['max'])} s")
    return lines


def structure_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the structure router's events (``structure`` detections /
    routing tags, ``structure_solve`` engine outcomes) into per-structure
    lanes: what was detected, what was routed, which engine actually
    served, and how often a route demoted to general LU. Empty dict when
    the run routed nothing."""
    dets = [ev for ev in events if ev.get("type") == "structure"]
    solves = [ev for ev in events if ev.get("type") == "structure_solve"]
    if not (dets or solves):
        return {}
    detected: Dict[str, int] = {}
    routed: Dict[str, int] = {}
    for ev in dets:
        d = str(ev.get("detected", "?"))
        t = str(ev.get("tag", "?"))
        detected[d] = detected.get(d, 0) + 1
        routed[t] = routed.get(t, 0) + 1
    engines: Dict[str, int] = {}
    demotions = 0
    rels: List[float] = []
    for ev in solves:
        eng = str(ev.get("engine", "?"))
        engines[eng] = engines.get(eng, 0) + 1
        if ev.get("demoted"):
            demotions += 1
        if isinstance(ev.get("rel_residual"), (int, float)):
            rels.append(float(ev["rel_residual"]))
    return {
        "detected": detected, "routed": routed, "engines": engines,
        "solves": len(solves), "demotions": demotions,
        "worst_rel_residual": max(rels) if rels else None,
    }


def _structure_lines(st: Dict[str, Any]) -> List[str]:
    lines = []
    det = ", ".join(f"{k} x{v}" for k, v in sorted(st["detected"].items()))
    lines.append(f"  detected: {det or '-'}")
    eng = ", ".join(f"{k} x{v}" for k, v in sorted(st["engines"].items()))
    lines.append(f"  lanes: {eng or '-'}  ({st['solves']} solve(s), "
                 f"{st['demotions']} demotion(s) to general LU)")
    if st["worst_rel_residual"] is not None:
        lines.append(f"  worst rel residual: "
                     f"{_fmt(st['worst_rel_residual'])}")
    return lines


def sparse_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the Krylov plane's ``sparse_solve`` attempts
    (gauss_tpu.sparse.solve) into per-method lanes: attempts, converged
    count, iteration totals, worst verified residual, and how many
    attempts ran on a Gershgorin-certified operand. Empty dict when the
    run never touched the sparse plane."""
    solves = [ev for ev in events if ev.get("type") == "sparse_solve"]
    if not solves:
        return {}
    methods: Dict[str, Dict[str, Any]] = {}
    certified = 0
    rels: List[float] = []
    for ev in solves:
        m = methods.setdefault(str(ev.get("method", "?")), {
            "attempts": 0, "converged": 0, "iterations": 0,
            "wall_s": 0.0, "preconds": {}})
        m["attempts"] += 1
        if ev.get("converged"):
            m["converged"] += 1
        m["iterations"] += int(ev.get("iterations", 0) or 0)
        m["wall_s"] += float(ev.get("wall_s", 0.0) or 0.0)
        pk = str(ev.get("precond", "none"))
        m["preconds"][pk] = m["preconds"].get(pk, 0) + 1
        if ev.get("certified_spd"):
            certified += 1
        if ev.get("converged") and isinstance(ev.get("rel_residual"),
                                              (int, float)):
            rels.append(float(ev["rel_residual"]))
    return {
        "methods": methods, "attempts": len(solves),
        "certified_spd": certified,
        "max_n": max(int(ev.get("n", 0) or 0) for ev in solves),
        "max_nnz": max(int(ev.get("nnz", 0) or 0) for ev in solves),
        "worst_rel_residual": max(rels) if rels else None,
    }


def _sparse_lines(sp: Dict[str, Any]) -> List[str]:
    lines = []
    for name, m in sorted(sp["methods"].items()):
        pre = ", ".join(f"{k} x{v}"
                        for k, v in sorted(m["preconds"].items()))
        lines.append(f"  {name}: {m['converged']}/{m['attempts']} converged, "
                     f"{m['iterations']} iter(s), "
                     f"{_fmt(m['wall_s'])} s  [{pre}]")
    lines.append(f"  certified SPD: {sp['certified_spd']}/{sp['attempts']} "
                 f"attempt(s); largest n {sp['max_n']} "
                 f"({sp['max_nnz']} nnz)")
    if sp["worst_rel_residual"] is not None:
        lines.append(f"  worst converged rel residual: "
                     f"{_fmt(sp['worst_rel_residual'])}")
    return lines


def utilization_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the attribution plane's ``attr`` cell observations
    (gauss_tpu.obs.attr) into one report: device-seconds by phase and by
    engine, achieved-vs-peak roofline fractions per engine (against the
    peaks the run's ``attr_plane`` event recorded), seconds-weighted stall
    fractions, and amortized compile-seconds. Empty dict when the run had
    no attribution plane — attr-off streams carry no utilization noise."""
    cells = [ev for ev in events if ev.get("type") == "attr"]
    if not cells:
        return {}
    plane = next((ev for ev in events if ev.get("type") == "attr_plane"), {})
    peak_f = plane.get("flops_per_s")
    peak_b = plane.get("bytes_per_s")
    by_phase: Dict[str, Dict[str, float]] = {}
    engines: Dict[str, Dict[str, float]] = {}
    compile_s = 0.0
    for ev in cells:
        s = float(ev.get("seconds", 0.0) or 0.0)
        ph = by_phase.setdefault(str(ev.get("phase", "?")),
                                 {"seconds": 0.0, "calls": 0, "requests": 0})
        ph["seconds"] += s
        ph["calls"] += 1
        ph["requests"] += int(ev.get("requests", 0) or 0)
        eng = engines.setdefault(str(ev.get("engine", "?")),
                                 {"seconds": 0.0, "flops": 0.0,
                                  "bytes": 0.0, "stall_s": 0.0,
                                  "stall_w": 0.0})
        eng["seconds"] += s
        if isinstance(ev.get("flops"), (int, float)):
            eng["flops"] += float(ev["flops"])
        if isinstance(ev.get("bytes"), (int, float)):
            eng["bytes"] += float(ev["bytes"])
        if isinstance(ev.get("stall_frac"), (int, float)):
            eng["stall_s"] += float(ev["stall_frac"]) * s
            eng["stall_w"] += s
        if isinstance(ev.get("compile_s"), (int, float)):
            compile_s += float(ev["compile_s"])
    roofline: Dict[str, Dict[str, Any]] = {}
    for name, e in engines.items():
        row: Dict[str, Any] = {"device_s": round(e["seconds"], 6)}
        if e["seconds"] > 0 and e["flops"]:
            row["achieved_flops_per_s"] = round(e["flops"] / e["seconds"], 3)
            if isinstance(peak_f, (int, float)) and peak_f > 0:
                row["flops_frac"] = round(
                    row["achieved_flops_per_s"] / peak_f, 6)
        if e["seconds"] > 0 and e["bytes"]:
            row["achieved_bytes_per_s"] = round(e["bytes"] / e["seconds"], 3)
            if isinstance(peak_b, (int, float)) and peak_b > 0:
                row["bytes_frac"] = round(
                    row["achieved_bytes_per_s"] / peak_b, 6)
        if e["stall_w"] > 0:
            row["stall_frac"] = round(e["stall_s"] / e["stall_w"], 4)
        roofline[name] = row
    return {
        "observes": len(cells),
        "device_s_total": round(sum(e["seconds"]
                                    for e in engines.values()), 6),
        "compile_s": round(compile_s, 6),
        "by_phase": {k: {"seconds": round(v["seconds"], 6),
                         "calls": int(v["calls"]),
                         "requests": int(v["requests"])}
                     for k, v in by_phase.items()},
        "roofline": roofline,
        "peaks": ({"flops_per_s": peak_f, "bytes_per_s": peak_b,
                   "source": plane.get("source")} if plane else None),
    }


def _utilization_lines(ut: Dict[str, Any]) -> List[str]:
    lines = [f"  {ut['observes']} observation(s), "
             f"{_fmt(ut['device_s_total'])} device-s attributed, "
             f"{_fmt(ut['compile_s'])} s amortized compile"]
    for ph, d in sorted(ut["by_phase"].items(),
                        key=lambda kv: -kv[1]["seconds"]):
        lines.append(f"  {ph}: {d['seconds']:.6f} s over {d['calls']} "
                     f"call(s), {d['requests']} request(s)")
    for eng, row in sorted(ut["roofline"].items()):
        bits = [f"device_s {_fmt(row['device_s'])}"]
        if "achieved_flops_per_s" in row:
            bits.append(f"{_fmt(row['achieved_flops_per_s'])} flop/s")
        if "flops_frac" in row:
            bits.append(f"{100 * row['flops_frac']:.2f}% of peak flops")
        if "bytes_frac" in row:
            bits.append(f"{100 * row['bytes_frac']:.2f}% of peak bytes")
        if "stall_frac" in row:
            bits.append(f"stall {_fmt(row['stall_frac'])}")
        lines.append(f"  engine {eng}: " + ", ".join(bits))
    if ut.get("peaks"):
        p = ut["peaks"]
        lines.append(f"  peaks ({p.get('source', '?')}): "
                     f"{_fmt(p.get('flops_per_s'))} flop/s, "
                     f"{_fmt(p.get('bytes_per_s'))} B/s — CPU-proxy "
                     f"calibration, not chip datasheet numbers")
    return lines


def postmortem_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold ``postmortem`` capture events (gauss_tpu.obs.postmortem) and
    ``flight`` recorder lifecycle events into one report: bundles captured
    by cause, open-trace / in-flight counts at capture, and the last
    bundle's path — the pointer ``gauss-debug`` starts from. Empty dict
    when the run captured nothing — healthy runs carry no crash noise."""
    caps = [ev for ev in events if ev.get("type") == "postmortem"]
    fl = [ev for ev in events if ev.get("type") == "flight"]
    if not caps:
        return {}
    by_cause: Dict[str, int] = {}
    for ev in caps:
        cause = str(ev.get("cause", "?"))
        by_cause[cause] = by_cause.get(cause, 0) + 1
    last = caps[-1]
    return {
        "bundles": len(caps),
        "by_cause": by_cause,
        "open_traces": sum(int(ev.get("open_traces", 0) or 0)
                           for ev in caps),
        "in_flight": sum(int(ev.get("in_flight", 0) or 0) for ev in caps),
        "last_bundle": last.get("bundle"),
        "last_cause": last.get("cause"),
        "recording": bool(fl),
    }


def _postmortem_lines(pm: Dict[str, Any]) -> List[str]:
    causes = ", ".join(f"{k} x{v}"
                       for k, v in sorted(pm["by_cause"].items()))
    lines = [f"  {pm['bundles']} bundle(s) captured"
             + (f"  ({causes})" if causes else "")
             + f"; {pm['in_flight']} request(s) in flight, "
             f"{pm['open_traces']} open trace(s) at capture"]
    if pm["last_bundle"]:
        lines.append(f"  last: {pm['last_bundle']} "
                     f"(cause={pm['last_cause']}; inspect with gauss-debug)")
    return lines


def fleet_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the fleet supervisor's events (``fleet``: launch / worker_dead /
    worker_stalled / restart / shrink / local_finish / done, plus worker-side
    peer_lost) and ``watchdog`` deadline trips into one report: failure
    detections by cause, restarts and shrinks, the elastic rung reached,
    and resume latency. Empty dict when the run supervised nothing."""
    fl = [ev for ev in events if ev.get("type") == "fleet"]
    wd = [ev for ev in events if ev.get("type") == "watchdog"]
    if not (fl or wd):
        return {}
    by_event: Dict[str, int] = {}
    deaths_by_cause: Dict[str, int] = {}
    for ev in fl:
        k = str(ev.get("event", "?"))
        by_event[k] = by_event.get(k, 0) + 1
        if k == "worker_dead":
            cause = str(ev.get("cause", "?"))
            deaths_by_cause[cause] = deaths_by_cause.get(cause, 0) + 1
    dones = [ev for ev in fl if ev.get("event") == "done"]
    last = dones[-1] if dones else {}
    return {
        "events": by_event,
        "deaths": {"total": by_event.get("worker_dead", 0),
                   "by_cause": deaths_by_cause},
        "stalls": by_event.get("worker_stalled", 0),
        "restarts": by_event.get("restart", 0),
        "shrinks": by_event.get("shrink", 0),
        "local_finishes": by_event.get("local_finish", 0),
        "watchdog_timeouts": len(wd),
        "solves": len(dones),
        "rung": last.get("rung"),
        "resume_latency_s": last.get("resume_latency_s"),
    }


def _fleet_lines(fs: Dict[str, Any]) -> List[str]:
    lines = []
    causes = ", ".join(f"{k} x{v}"
                       for k, v in sorted(fs["deaths"]["by_cause"].items()))
    lines.append(f"  worker deaths: {fs['deaths']['total']}"
                 + (f"  ({causes})" if causes else "")
                 + f"; {fs['stalls']} stall detection(s), "
                 f"{fs['watchdog_timeouts']} watchdog timeout(s)")
    lines.append(f"  recovery: {fs['restarts']} restart(s), "
                 f"{fs['shrinks']} shrink(s), "
                 f"{fs['local_finishes']} local finish(es)")
    if fs["solves"]:
        tail = f"  supervised solves: {fs['solves']}"
        if fs["rung"]:
            tail += f", last rung {fs['rung']}"
        if isinstance(fs["resume_latency_s"], (int, float)):
            tail += f", resume latency {_fmt(fs['resume_latency_s'])} s"
        lines.append(tail)
    return lines


def replica_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the network replica tier's events (``router`` lifecycle from
    gauss_tpu.serve.router, per-replica ``replica`` spawn/listen/drain,
    ``replica_adopt`` journal adoptions, ``replica_failover`` handoff
    reports, and ``replica_campaign`` chaos-audit verdicts) into one
    report. Empty dict when the run served no replica fleet."""
    router = [ev for ev in events if ev.get("type") == "router"]
    replicas = [ev for ev in events if ev.get("type") == "replica"]
    adopts = [ev for ev in events if ev.get("type") == "replica_adopt"]
    fails = [ev for ev in events if ev.get("type") == "replica_failover"]
    camps = [ev for ev in events if ev.get("type") == "replica_campaign"]
    if not (router or replicas or fails or camps):
        return {}
    revents: Dict[str, int] = {}
    for ev in router:
        k = str(ev.get("event", "?"))
        revents[k] = revents.get(k, 0) + 1
    fail_causes: Dict[str, int] = {}
    recoveries = []
    for ev in fails:
        cause = str(ev.get("cause", "?"))
        fail_causes[cause] = fail_causes.get(cause, 0) + 1
        if isinstance(ev.get("recovery_s"), (int, float)):
            recoveries.append(float(ev["recovery_s"]))
    out: Dict[str, Any] = {
        "router_events": revents,
        "replica_events": len(replicas),
        "failovers": {
            "count": len(fails),
            "by_cause": fail_causes,
            "pins_moved": sum(int(ev.get("pins_moved", 0) or 0)
                              for ev in fails),
            "replayed": sum(int(ev.get("replayed", 0) or 0)
                            for ev in fails),
            "imported": sum(int(ev.get("imported", 0) or 0)
                            for ev in fails),
            "expired": sum(int(ev.get("expired", 0) or 0) for ev in fails),
            "max_recovery_s": max(recoveries) if recoveries else None,
        },
        "adoptions": len(adopts),
    }
    if camps:
        last = camps[-1]
        out["campaign"] = {k: last.get(k)
                           for k in ("cases", "admitted", "case_violations",
                                     "replayed_on_peer",
                                     "expired_in_failover",
                                     "invariant_ok")
                           if last.get(k) is not None}
        cv = out["campaign"].get("case_violations")
        if isinstance(cv, list):
            # The campaign event carries the violating cases themselves;
            # the summary only needs how many there were.
            out["campaign"]["case_violations"] = len(cv)
    return out


def _replica_lines(rp: Dict[str, Any]) -> List[str]:
    lines = []
    re_ = ", ".join(f"{k} x{v}"
                    for k, v in sorted(rp["router_events"].items()))
    lines.append(f"  router: {re_ or '-'}; "
                 f"{rp['replica_events']} replica event(s)")
    fo = rp["failovers"]
    if fo["count"]:
        causes = ", ".join(f"{k} x{v}"
                           for k, v in sorted(fo["by_cause"].items()))
        tail = (f"  failovers: {fo['count']}  ({causes}); "
                f"{fo['pins_moved']} pin(s) moved, "
                f"{fo['replayed']} replayed, {fo['imported']} imported, "
                f"{fo['expired']} expired-in-failover")
        if isinstance(fo["max_recovery_s"], (int, float)):
            tail += f"; worst recovery {_fmt(fo['max_recovery_s'])} s"
        lines.append(tail)
    if rp["adoptions"]:
        lines.append(f"  adoptions: {rp['adoptions']} journal(s) adopted")
    camp = rp.get("campaign")
    if camp:
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in camp.items())
        lines.append(f"  campaign: {kv}")
    return lines


def poison_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the poison-isolation plane's events into one report: typed
    poison terminals (``serve.poisoned``), batch bisections
    (``serve_bisect``), quarantine decisions (``quarantine`` events /
    ``serve.quarantined``), non-finite batch-member rescues, uncharged
    quarantined deaths, and the latest ``poison_campaign`` verdict.
    Empty dict when the run saw no poison activity."""
    counters = {ev.get("name"): ev.get("value") for ev in events
                if ev.get("type") == "metric"
                and ev.get("kind") == "counter"}
    quar = [ev for ev in events if ev.get("type") == "quarantine"]
    bisects = [ev for ev in events if ev.get("type") == "serve_bisect"]
    camps = [ev for ev in events if ev.get("type") == "poison_campaign"]

    def _c(name: str) -> int:
        return int(counters.get(name, 0) or 0)

    poisoned = _c("serve.poisoned")
    quarantined = _c("serve.quarantined")
    rescues = _c("serve.nonfinite_rescues")
    free_deaths = (_c("serve.quarantined_respawns")
                   + _c("router.quarantined_deaths"))
    if not (poisoned or quarantined or rescues or free_deaths
            or quar or bisects or camps):
        return {}
    out: Dict[str, Any] = {
        "poisoned": poisoned,
        "quarantined": quarantined,
        "bisections": {
            "count": len(bisects),
            "requests": sum(int(ev.get("requests", 0) or 0)
                            for ev in bisects),
        },
        "nonfinite_rescues": rescues,
        "quarantined_deaths_uncharged": free_deaths,
        "quarantine_events": [
            {k: ev.get(k) for k in ("id", "rid", "trace", "deaths",
                                    "action", "adopted")
             if ev.get(k) is not None}
            for ev in quar],
    }
    if camps:
        last = camps[-1]
        out["campaign"] = {k: last.get(k)
                           for k in ("cases", "innocents_verified",
                                     "culprits_typed", "violations",
                                     "crash_loops", "invariant_ok")
                           if last.get(k) is not None}
    return out


def _poison_lines(po: Dict[str, Any]) -> List[str]:
    bi = po["bisections"]
    lines = [
        f"  typed rejects: {po['poisoned']} poisoned, "
        f"{po['quarantined']} quarantined, "
        f"{po['nonfinite_rescues']} non-finite batch-member rescue(s)",
        f"  bisections: {bi['count']} split(s) over "
        f"{bi['requests']} batched request(s)",
    ]
    if po["quarantined_deaths_uncharged"]:
        lines.append(f"  deaths reclassified quarantined (budget "
                     f"uncharged): {po['quarantined_deaths_uncharged']}")
    for ev in po["quarantine_events"]:
        lines.append("  quarantine: " + _event_kv(ev))
    camp = po.get("campaign")
    if camp:
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in camp.items())
        lines.append(f"  campaign: {kv}")
    return lines


def tuning_summary(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the autotuner's events into one report: store consults with
    their provenance (``tune`` events: source=store|seed, reason on
    degraded fallbacks), sweep activity (``tune_sweep`` points/prunes),
    and the persistent-XLA-cache counters (``xla.cache_*`` — a miss is a
    real backend compile, a hit is a compile avoided). Empty dict when
    the run touched none of it."""
    tune = [ev for ev in events if ev.get("type") == "tune"]
    sweep = [ev for ev in events if ev.get("type") == "tune_sweep"]
    counters = {ev.get("name"): ev.get("value") for ev in events
                if ev.get("type") == "metric"
                and ev.get("kind") == "counter"}
    hits = counters.get("tune.store_hits", 0)
    misses = counters.get("tune.store_misses", 0)
    xla = {k.split(".", 1)[1]: int(v) for k, v in counters.items()
           if k and str(k).startswith("xla.")}
    if not (tune or sweep or xla):
        return {}
    consults = [{k: ev.get(k) for k in ("key", "source", "params",
                                        "reason", "sweep_run", "dir")
                 if ev.get(k) is not None}
                for ev in tune]
    points = [ev for ev in sweep if ev.get("event") == "point"]
    out: Dict[str, Any] = {
        "store": {"hits": int(hits), "misses": int(misses)},
        "consults": consults,
    }
    if xla:
        out["xla_cache"] = xla
    if sweep:
        out["sweep"] = {
            "points": len(points),
            "pruned": sum(1 for ev in sweep if ev.get("event") == "pruned"),
            "keys": [ev.get("key") for ev in points],
        }
    return out


def _tuning_lines(tn: Dict[str, Any]) -> List[str]:
    st = tn["store"]
    lines = [f"  store: {st['hits']} hit(s) / {st['misses']} miss(es)"]
    for c in tn["consults"]:
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in c.items() if k != "key")
        lines.append(f"    {c.get('key', '?')}: {kv}")
    xla = tn.get("xla_cache")
    if xla:
        lines.append(f"  xla compile cache: "
                     f"{xla.get('cache_hits', 0)} hit(s) / "
                     f"{xla.get('cache_misses', 0)} compile(s)")
    sw = tn.get("sweep")
    if sw:
        lines.append(f"  sweep: {sw['points']} point(s) "
                     f"({', '.join(str(k) for k in sw['keys'] if k)}), "
                     f"{sw['pruned']} candidate(s) pruned early")
    return lines


def _human_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n} B"


def _comms_lines(comms: Dict[str, Any]) -> List[str]:
    lines = []
    for label in sorted(comms):
        eng = comms[label]
        ops = ", ".join(
            f"{op} x{d['count']} ({_human_bytes(d['bytes'])})"
            for op, d in sorted(eng["ops"].items()))
        lines.append(f"  {label}: {ops}")
        lines.append(f"    total {eng['count']} collectives, "
                     f"{_human_bytes(eng['bytes'])} payload")
    return lines


_SKIP_FIELDS = {"type", "run", "seq", "t", "t_aligned", "proc"}


def _event_kv(ev: Dict[str, Any], skip=()) -> str:
    return " ".join(f"{k}={_fmt(v)}" for k, v in ev.items()
                    if k not in _SKIP_FIELDS and k not in skip
                    and v is not None)


def _strip(ev: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in ev.items()
            if k not in ("run", "seq") and v is not None}


def run_summary(events: List[Dict[str, Any]], run_id: str) -> Dict[str, Any]:
    """The complete machine-readable summary of one run — the ``--json``
    payload, and the single source the text renderer draws from."""
    evs = [ev for ev in events if ev.get("run") == run_id]
    start = next((ev for ev in evs if ev.get("type") == "run_start"), {})
    env = {k: start[k] for k in registry.ENV_FINGERPRINT_KEYS if k in start}
    meta = {k: v for k, v in start.items()
            if k not in _SKIP_FIELDS and k not in env
            and k not in ("time_unix", "schema")}
    return {
        "run": run_id,
        "meta": meta,
        "environment": env,
        "processes": _procs(evs),
        "reported": [_strip(ev) for ev in evs
                     if ev.get("type") == "reported_time"],
        "profile": flat_profile(evs),
        "health": [_strip(ev) for ev in evs if ev.get("type") == "health"],
        "serving": serving_summary(evs),
        "durability": durability_summary(evs),
        "poison": poison_summary(evs),
        "slo": slo_summary(evs),
        "structure": structure_summary(evs),
        "sparse": sparse_summary(evs),
        "utilization": utilization_summary(evs),
        "resilience": resilience_summary(evs),
        "sdc": sdc_summary(evs),
        "postmortems": postmortem_summary(evs),
        "fleet": fleet_summary(evs),
        "replica": replica_summary(evs),
        "tuning": tuning_summary(evs),
        "comms": comms_summary(evs),
        "compile": [_strip(ev) for ev in evs
                    if ev.get("type") in ("compile", "cost")],
        "vmem": [_strip(ev) for ev in evs
                 if ev.get("type") == "vmem_estimate"],
        "cells": [_strip(ev) for ev in evs if ev.get("type") == "cell"],
        "metrics": [_strip(ev) for ev in evs if ev.get("type") == "metric"
                    and not str(ev.get("name", "")).startswith("span.")],
    }


def summarize_run(events: List[Dict[str, Any]], run_id: str) -> str:
    evs = [ev for ev in events if ev.get("run") == run_id]
    out = []
    start = next((ev for ev in evs if ev.get("type") == "run_start"), {})
    env_skip = tuple(registry.ENV_FINGERPRINT_KEYS)
    meta = _event_kv(start, skip=("time_unix", "schema") + env_skip)
    out.append(f"run {run_id}" + (f"  [{meta}]" if meta else ""))
    env = {k: start[k] for k in registry.ENV_FINGERPRINT_KEYS if k in start}
    if env:
        out.append("  environment: "
                   + " ".join(f"{k}={_fmt(v)}" for k, v in env.items()))
    procs = _procs(evs)
    if len(procs) > 1:
        out.append(f"  merged multihost stream: {len(procs)} processes "
                   f"{procs}")

    reported = [ev for ev in evs if ev.get("type") == "reported_time"]
    for ev in reported:
        out.append(f"  reported: {ev.get('name')} = "
                   f"{_fmt(ev.get('seconds'))} s")

    prof = flat_profile(evs)
    if prof["phases"]:
        out.append("")
        out.append("flat profile (leaf spans):")
        out.extend(_profile_lines(prof))

    health = [ev for ev in evs if ev.get("type") == "health"]
    if health:
        out.append("")
        out.append("numerical health:")
        for ev in health:
            out.append("  " + _event_kv(ev))

    serving = serving_summary(evs)
    if serving:
        out.append("")
        out.append("serving:")
        out.extend(_serving_lines(serving))

    durability = durability_summary(evs)
    if durability:
        out.append("")
        out.append("durability (request journal):")
        out.extend(_durability_lines(durability))

    poison = poison_summary(evs)
    if poison:
        out.append("")
        out.append("poison isolation:")
        out.extend(_poison_lines(poison))

    slo = slo_summary(evs)
    if slo:
        out.append("")
        out.append("slo burn-rate alerts:")
        out.extend(_slo_lines(slo))

    structure = structure_summary(evs)
    if structure:
        out.append("")
        out.append("structure lanes:")
        out.extend(_structure_lines(structure))

    sparse = sparse_summary(evs)
    if sparse:
        out.append("")
        out.append("sparse (Krylov) solves:")
        out.extend(_sparse_lines(sparse))

    util = utilization_summary(evs)
    if util:
        out.append("")
        out.append("utilization (device-time attribution):")
        out.extend(_utilization_lines(util))

    resilience = resilience_summary(evs)
    if resilience:
        out.append("")
        out.append("resilience:")
        out.extend(_resilience_lines(resilience))

    sdc = sdc_summary(evs)
    if sdc:
        out.append("")
        out.append("sdc (abft checksum detections):")
        out.extend(_sdc_lines(sdc))

    pm = postmortem_summary(evs)
    if pm:
        out.append("")
        out.append("post-mortems:")
        out.extend(_postmortem_lines(pm))

    fleet = fleet_summary(evs)
    if fleet:
        out.append("")
        out.append("fleet:")
        out.extend(_fleet_lines(fleet))

    replica = replica_summary(evs)
    if replica:
        out.append("")
        out.append("replica tier (network serving):")
        out.extend(_replica_lines(replica))

    tuning = tuning_summary(evs)
    if tuning:
        out.append("")
        out.append("tuning:")
        out.extend(_tuning_lines(tuning))

    comms = comms_summary(evs)
    if comms:
        out.append("")
        out.append("collective traffic (per-execution budget):")
        out.extend(_comms_lines(comms))

    compiles = [ev for ev in evs if ev.get("type") in ("compile", "cost")]
    if compiles:
        out.append("")
        out.append("compile / cost accounting:")
        for ev in compiles:
            out.append("  " + _event_kv(ev))

    vmem = [ev for ev in evs if ev.get("type") == "vmem_estimate"]
    if vmem:
        out.append("")
        out.append("VMEM/HBM working-set estimates:")
        for ev in vmem:
            out.append("  " + _event_kv(ev))

    metrics = [ev for ev in evs if ev.get("type") == "metric"
               and not str(ev.get("name", "")).startswith("span.")]
    if metrics:
        out.append("")
        out.append("metrics:")
        for ev in metrics:
            out.append(f"  {ev.get('kind')} " + _event_kv(ev, skip=("kind",)))
    return "\n".join(out)


def summarize_events(events: List[Dict[str, Any]],
                     run_id: Optional[str] = None) -> str:
    run_ids = [run_id] if run_id else _runs(events)
    if not run_ids:
        return "(no runs found)"
    return "\n\n".join(summarize_run(events, rid) for rid in run_ids)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.obs.summarize",
        description="Render a metrics JSONL file (gprof-style flat profile, "
                    "numerical health, collective traffic, compile/memory "
                    "accounting).")
    p.add_argument("path", help="JSONL events file (--metrics-out output)")
    p.add_argument("--run", default=None, help="summarize only this run ID")
    p.add_argument("--json", action="store_true",
                   help="emit the full summary (profile, per-process lanes, "
                        "health, comms, compile, metrics) as JSON keyed by "
                        "run — the machine-readable form CI and obs.regress "
                        "consume")
    args = p.parse_args(argv)
    try:
        events = registry.read_events(args.path)
    except OSError as e:
        print(f"summarize: cannot read '{args.path}': {e}", file=sys.stderr)
        return 1
    if args.run and args.run not in _runs(events):
        print(f"summarize: run '{args.run}' not found; runs: "
              f"{', '.join(_runs(events)) or '(none)'}", file=sys.stderr)
        return 1
    if args.json:
        run_ids = [args.run] if args.run else _runs(events)
        payload = {rid: run_summary(events, rid) for rid in run_ids}
        print(json.dumps(payload, indent=1, sort_keys=True))
        return 0
    print(summarize_events(events, args.run))
    return 0


if __name__ == "__main__":
    sys.exit(main())

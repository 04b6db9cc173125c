"""Automatic post-mortem bundles: freeze the crash scene into one file
(the port of ``gauss_tpu/obs/postmortem.py``; a bundle of either package
passes the other's ``debug --check``).

The flight ring (:mod:`gauss_tpu_torch.obs.flight`) survives the process;
this module is the harvest step. On crash *detection* — a supervisor
seeing a dead/stalled child (``durable.supervise``, the replica router), a
restarted server finding unterminated admits at resume, or an
``SDCDetectedError`` escalating in-process — :func:`capture_bundle`
gathers everything a human (or ``python -m gauss_tpu_torch.obs.debug``)
needs to reconstruct the final seconds into ONE json document and writes
it atomically (tmp + fsync + rename + dir fsync) into a bundles
directory:

- every flight ring in the flight dir (events, scan stats, sidecars);
- the request journal's tail — the unterminated admits (operands
  STRIPPED: a bundle is a debugging artifact, not a replay source), the
  recent terminals, torn-drop counts, clean-shutdown flag;
- heartbeat file ages;
- a ``/metrics`` snapshot when the live endpoint is still scrapable;
- the open (unterminated) trace set reconstructed from the ring.

Exactly-one-cause discipline: a bundle names ONE ``cause`` string (the
detector that fired), so attribution stays falsifiable — ``debug
--check`` asserts it. :data:`KNOWN_CAUSES` is the JAX package's
vocabulary; the port's capture sites name ``supervisor_death``,
``supervisor_stall``, ``unclean_resume``, ``sdc_detected``,
``poison_quarantine`` and ``manual`` (the fleet and SLO causes come with
those planes).

In-process triggers (SDC escalation) go through the throttled
:func:`trigger` hook — a module global configured by
:func:`install_trigger` (the server does this when ``flight_dir`` is set)
and a no-op otherwise, the same zero-cost-when-absent contract as every
other obs hook. A flapping detector produces one bundle
per :data:`TRIGGER_MIN_INTERVAL_S`, not one per transition.

Stdlib and the port's stdlib-only modules; loads no torch.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

BUNDLE_SCHEMA = 1
BUNDLE_PREFIX = "bundle-"
BUNDLE_SUFFIX = ".json"

#: causes a capture site may name — exactly one per bundle.
KNOWN_CAUSES = (
    "supervisor_death",    # durable.supervise: child exited nonzero
    "supervisor_stall",    # durable.supervise: heartbeat went stale
    "fleet_worker_dead",   # fleet supervisor: worker process died
    "fleet_worker_stalled",  # fleet supervisor: worker lease went stale
    "unclean_resume",      # server start() found unterminated admits
    "slo_alert",           # a burn-rate alert transitioned to firing
    "sdc_detected",        # SDCDetectedError escalated past repair
    "poison_quarantine",   # death blamed on a poison request (uncharged)
    "manual",              # gauss-debug capture / tests
)

#: recent keyed terminals carried into a bundle's journal tail
JOURNAL_TAIL_TERMINALS = 32
TRIGGER_MIN_INTERVAL_S = 30.0

#: admit-record fields worth keeping (operands dropped — a/b are base64
#: matrices that would bloat a debugging artifact into a replay source)
_ADMIT_KEEP = ("id", "rid", "trace", "n", "k", "was_vector",
               "deadline_unix", "t_unix", "dtype", "structure")
_TERMINAL_KEEP = ("id", "rid", "trace", "status", "lane", "t_unix",
                  "rel_residual", "error")


def default_bundles_dir(flight_dir) -> str:
    """The convention: bundles live under the flight dir they explain."""
    return os.path.join(os.fspath(flight_dir), "bundles")


def _atomic_write_json(path: str, doc: Dict[str, Any]) -> None:
    from gauss_tpu_torch.resilience.checkpoint import fsync_dir

    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=parent)
    with os.fdopen(fd, "w") as f:
        json.dump(doc, f, sort_keys=True, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(parent)


def _strip(doc: Dict[str, Any], keep) -> Dict[str, Any]:
    return {k: doc.get(k) for k in keep if k in doc}


def _journal_tail(journal_dir) -> Optional[Dict[str, Any]]:
    """The journal's view of the death: unterminated admits (= the requests
    in flight), recent terminals, damage counts. Never raises — a bundle
    about a crash must not crash over a damaged journal."""
    try:
        from gauss_tpu_torch.serve import durable

        st = durable.scan(os.fspath(journal_dir))
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}
    terminals = sorted(st.terminals.values(),
                       key=lambda t: t.get("t_unix") or 0.0)
    return {
        "dir": os.fspath(journal_dir),
        "records": st.records,
        "torn_dropped": st.torn_dropped,
        "clean_shutdown": st.clean_shutdown,
        "live_admits": [_strip(d, _ADMIT_KEEP) for d in st.live_admits()],
        "recent_terminals": [_strip(d, _TERMINAL_KEEP)
                             for d in terminals[-JOURNAL_TAIL_TERMINALS:]],
    }


def _heartbeat_age(path) -> Dict[str, Any]:
    doc: Dict[str, Any] = {"path": os.fspath(path)}
    try:
        mtime = os.path.getmtime(path)
        doc["mtime_unix"] = round(mtime, 3)
        doc["age_s"] = round(time.time() - mtime, 3)
    except OSError:
        doc["age_s"] = None
    return doc


def _scrape_metrics(url: str, timeout_s: float = 0.75) -> Optional[str]:
    """GET the live /metrics exposition, or None — the endpoint usually
    died with the process; a surviving one is a bonus, never a wait."""
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return resp.read().decode("utf-8", "replace")
    except Exception:
        return None


def _open_traces(ring_events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Traces present in the ring with no terminal serve_request event —
    the work that was cut off mid-flight. Compact per-trace shape (the
    full events are in the bundle's rings; ``debug`` folds them)."""
    from gauss_tpu_torch.obs.flight import _TERMINAL_STATUSES

    by_trace: Dict[str, Dict[str, Any]] = {}
    for ev in ring_events:
        tids = [ev.get("trace")] if ev.get("trace") else []
        tids += list(ev.get("traces") or ())
        for tid in tids:
            tid = str(tid)
            d = by_trace.setdefault(tid, {"trace": tid, "events": 0,
                                          "types": [], "terminal": None})
            d["events"] += 1
            t = ev.get("type")
            if t and (not d["types"] or d["types"][-1] != t):
                d["types"].append(t)
            if (t == "serve_request"
                    and ev.get("status") in _TERMINAL_STATUSES):
                d["terminal"] = ev.get("status")
    return [d for d in by_trace.values() if d["terminal"] is None]


def capture_bundle(bundles_dir, cause: str, *,
                   flight_dir=None, journal_dir=None,
                   heartbeat_path=None, metrics_url: Optional[str] = None,
                   extra: Optional[Dict[str, Any]] = None,
                   log=None) -> Optional[str]:
    """Capture one post-mortem bundle; returns its path (None only when
    even the atomic write failed — capture must never take the SURVIVOR
    down, so every gather step degrades to a recorded error instead of
    raising)."""
    now = time.time()
    doc: Dict[str, Any] = {
        "schema": BUNDLE_SCHEMA,
        "cause": str(cause),
        "time_unix": round(now, 3),
        "captured_by": {"pid": os.getpid()},
    }
    try:
        from gauss_tpu_torch.obs.registry import environment_fingerprint

        doc["captured_by"].update(environment_fingerprint())
    except Exception:
        pass
    if extra:
        doc["detail"] = {str(k): v for k, v in extra.items()}
    ring_events: List[Dict[str, Any]] = []
    if flight_dir is not None:
        try:
            from gauss_tpu_torch.obs import flight

            rings = flight.scan_dir(flight_dir)
            doc["flight"] = {"dir": os.fspath(flight_dir), "rings": rings}
            for r in rings:
                ring_events.extend(r["events"])
        except Exception as e:
            doc["flight"] = {"error": f"{type(e).__name__}: {e}"}
    if journal_dir is not None:
        doc["journal"] = _journal_tail(journal_dir)
    if heartbeat_path is not None:
        doc["heartbeats"] = [_heartbeat_age(heartbeat_path)]
    if metrics_url:
        doc["metrics"] = _scrape_metrics(metrics_url)
    if ring_events:
        try:
            doc["open_traces"] = _open_traces(ring_events)
        except Exception as e:  # pragma: no cover — shape drift guard
            doc["open_traces_error"] = f"{type(e).__name__}: {e}"
    name = f"{BUNDLE_PREFIX}{int(now * 1000):013d}-{cause}-{os.getpid()}" \
           f"{BUNDLE_SUFFIX}"
    path = os.path.join(os.fspath(bundles_dir), name)
    try:
        _atomic_write_json(path, doc)
    except OSError as e:
        if log:
            log(f"postmortem: bundle write failed: {e}")
        return None
    try:
        from gauss_tpu_torch import obs

        obs.counter("postmortem.bundles")
        obs.emit("postmortem", cause=cause, bundle=path,
                 open_traces=len(doc.get("open_traces", ())),
                 in_flight=len((doc.get("journal") or {})
                               .get("live_admits", ())))
    except Exception:  # pragma: no cover — telemetry never blocks capture
        pass
    if log:
        log(f"postmortem: captured {path} (cause={cause})")
    return path


# -- reading / checking ----------------------------------------------------

def list_bundles(bundles_dir) -> List[str]:
    """Bundle paths in a dir, oldest first (the name embeds capture ms)."""
    try:
        names = sorted(n for n in os.listdir(os.fspath(bundles_dir))
                       if n.startswith(BUNDLE_PREFIX)
                       and n.endswith(BUNDLE_SUFFIX))
    except OSError:
        return []
    return [os.path.join(os.fspath(bundles_dir), n) for n in names]


def latest_bundle(bundles_dir) -> Optional[str]:
    paths = list_bundles(bundles_dir)
    return paths[-1] if paths else None


def bundle_info(path) -> Dict[str, Any]:
    """The facts a bundle FILENAME carries (capture time, cause, writer
    pid) — the cheap per-scrape form /metrics needs, no body read."""
    name = os.path.basename(os.fspath(path))
    out: Dict[str, Any] = {"path": os.fspath(path), "time_unix": None,
                           "cause": None, "pid": None}
    if name.startswith(BUNDLE_PREFIX) and name.endswith(BUNDLE_SUFFIX):
        parts = name[len(BUNDLE_PREFIX):-len(BUNDLE_SUFFIX)].split("-")
        if len(parts) >= 3:
            try:
                out["time_unix"] = int(parts[0]) / 1000.0
            except ValueError:
                pass
            out["cause"] = "-".join(parts[1:-1]) or None
            try:
                out["pid"] = int(parts[-1])
            except ValueError:
                pass
    return out


def read_bundle(path) -> Dict[str, Any]:
    with open(os.fspath(path)) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"bundle {path} is not a json object")
    return doc


def check_bundle(doc: Dict[str, Any]) -> List[str]:
    """Integrity + exactly-one-cause assertions; returns the violations
    (empty = the bundle is trustworthy). This is ``debug --check``."""
    problems: List[str] = []
    if doc.get("schema") != BUNDLE_SCHEMA:
        problems.append(f"schema {doc.get('schema')!r} != {BUNDLE_SCHEMA}")
    cause = doc.get("cause")
    if not isinstance(cause, str) or not cause:
        problems.append("missing cause attribution")
    elif cause not in KNOWN_CAUSES:
        problems.append(f"unknown cause {cause!r} (exactly-one-cause "
                        f"registry: {KNOWN_CAUSES})")
    if "causes" in doc:
        problems.append("bundle carries a plural 'causes' field — "
                        "attribution must be exactly one cause")
    if not isinstance(doc.get("time_unix"), (int, float)):
        problems.append("missing capture time_unix")
    if not isinstance(doc.get("captured_by"), dict) \
            or "pid" not in doc.get("captured_by", {}):
        problems.append("missing captured_by.pid")
    fl = doc.get("flight")
    if isinstance(fl, dict):
        if "error" in fl:
            problems.append(f"flight harvest failed: {fl['error']}")
        for r in fl.get("rings", ()):
            st = r.get("stats") or {}
            if st.get("records", 0) != len(r.get("events", ())):
                problems.append(
                    f"ring {r.get('path')}: stats.records "
                    f"{st.get('records')} != events {len(r.get('events', ()))}")
    jn = doc.get("journal")
    if isinstance(jn, dict) and "error" in jn:
        problems.append(f"journal scan failed: {jn['error']}")
    if isinstance(jn, dict) and "error" not in jn:
        ids = [a.get("id") for a in jn.get("live_admits", ())]
        if len(ids) != len(set(ids)):
            problems.append("journal live_admits carries duplicate ids")
    return problems


# -- in-process trigger hook -----------------------------------------------

_trigger_lock = threading.Lock()
_trigger_cfg: Optional[Dict[str, Any]] = None
_last_trigger: Dict[str, float] = {}  # cause -> unix time of last capture


def install_trigger(bundles_dir, *, flight_dir=None, journal_dir=None,
                    heartbeat_path=None, metrics_url=None) -> None:
    """Arm the in-process capture hook (the server does this when a
    flight_dir is configured): later :func:`trigger` calls capture bundles
    with this context. Idempotent; ``uninstall_trigger`` disarms."""
    global _trigger_cfg
    with _trigger_lock:
        _trigger_cfg = {"bundles_dir": os.fspath(bundles_dir),
                        "flight_dir": flight_dir,
                        "journal_dir": journal_dir,
                        "heartbeat_path": heartbeat_path,
                        "metrics_url": metrics_url}


def uninstall_trigger() -> None:
    global _trigger_cfg
    with _trigger_lock:
        _trigger_cfg = None
        _last_trigger.clear()


def trigger(cause: str, **extra) -> Optional[str]:
    """Throttled in-process capture: no-op (None) when no trigger is armed
    or the same cause captured within :data:`TRIGGER_MIN_INTERVAL_S` (a
    flapping detector must not write a bundle per transition)."""
    with _trigger_lock:
        cfg = _trigger_cfg
        if cfg is None:
            return None
        now = time.time()
        if now - _last_trigger.get(cause, 0.0) < TRIGGER_MIN_INTERVAL_S:
            return None
        _last_trigger[cause] = now
    return capture_bundle(cfg["bundles_dir"], cause,
                          flight_dir=cfg["flight_dir"],
                          journal_dir=cfg["journal_dir"],
                          heartbeat_path=cfg["heartbeat_path"],
                          metrics_url=cfg["metrics_url"],
                          extra=extra or None)

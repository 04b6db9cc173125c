"""The kill-the-replica chaos campaign: ``python -m
gauss_tpu_torch.serve.replicacheck`` (the port of
``gauss_tpu/serve/replicacheck.py``; runs on ``cuda`` unless ``--device
cpu`` is given).

Asserts the replicated-serving invariant the network tier
(:mod:`gauss_tpu_torch.serve.net`) and the router
(:mod:`gauss_tpu_torch.serve.router`) exist to provide:

    **kill any replica mid-load and lose zero requests — every admitted
    request reaches EXACTLY ONE terminal status (served results
    re-verified at the gate from the journaled operands) across replica
    SIGKILLs, stalls, torn journal tails, graceful drains, router
    restarts, and client resubmission storms; and no request is ever
    solved twice.**

Like the durable campaign this is judged journal-vs-ledger: the runner
keeps its own client-side LEDGER of every admitted request, then audits
the UNION of every replica journal (live incarnations AND the retired
``journal-failed-*`` directories handed to adopters) against it — one
terminal per ledger entry across the whole fleet, no matter which
replica answered.

Phases:

- **failover cases** (``--cases``, in-process, cycled over kinds):
  seeded victim-journal → adopt-on-survivor scenarios driving
  :func:`gauss_tpu_torch.serve.net.adopt_journal` directly — ``sigkill`` (live
  victim crashed mid-batch), ``stall`` (victim admitted but never
  dispatched), ``torn`` (victim's journal tail torn mid-terminal-append),
  ``drain`` (clean shutdown: adoption must import terminals and replay
  NOTHING), ``expired`` (admit whose deadline passed during the failover
  window must resolve as a typed expiry, never a silent drop),
  ``router_restart`` (assign-log pins survive close/reopen; a torn tail
  loses only rehash-recoverable pins). Every case ends with a
  resubmission storm through the survivor that must dedupe to the
  journaled terminals without one new solve.
- **fleet legs** (``--no-subprocess`` to skip): a REAL 3-replica router
  (``serve.cli --replicas 3`` shape) under concurrent network load
  where every replica in turn is SIGKILLed mid-load (the acceptance
  drill: zero lost, exactly-once under the storm, each kill leaving a
  post-mortem bundle that passes ``obs.debug --check``); a SIGTERM
  drain that must respawn WITHOUT spending the restart budget; a
  SIGSTOP-stalled replica the router must detect by heartbeat staleness
  and fail over.
- **scaling** (``--no-tput`` to skip): the same injected-device-time mix
  (a ``serve.worker.dispatch`` delay: a sleep stands in for device time,
  so the gate measures the serving path around the device, not the host's
  cores) through 1 replica then 3; aggregate throughput must reach
  ``--min-speedup`` (default 2x). The 3-replica seconds-per-request and
  the kill legs' failover recovery latency land in history
  (``replica:s_per_request``, ``replica:failover_recovery_s``) and are
  regress-gated.

Every server and replica runs on ``--device``. The legs' replicas reach
the card in seconds each, so the router's ``spawn_timeout_s`` and
``stall_after_s`` (the stall leg's 2.5 s is counted only once a replica
is older than it) are the JAX package's. The summary is
regress-ingestable (``kind: replica_campaign``); ``--history`` and
``--regress-check`` use the port's own history (``obs.regress``, each
record stamped with its device). ``--tmpdir`` defaults to a new temporary
directory, removed at the end. Exit 2 when the invariant is violated, 1
when ``--regress-check`` finds an out-of-band metric, 0 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

CASE_KINDS = ("sigkill", "stall", "torn", "drain", "expired",
              "router_restart")
#: the scaling phase's injected "device time" per dispatched batch, s
TPUT_DELAY_S = 0.12


def _fresh_dir(path: str) -> str:
    """Leg/case roots must start empty: a retired ``journal-failed-*``
    or stale ``endpoint.json`` left by a previous campaign in the same
    tmpdir would be adopted as live state and corrupt the audit."""
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)
    return path


def _system(rng: np.random.Generator, n: int):
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a, rng.standard_normal(n)


def _case_config(journal_dir: Optional[str], gate: float,
                 device: str = "cuda", **over):
    from gauss_tpu_torch.serve.admission import ServeConfig

    kw = dict(ladder=(32,), max_batch=4, panel=16, refine_steps=1,
              verify_gate=gate, journal_dir=journal_dir,
              journal_fsync_batch=4, max_queue=256, device=device)
    kw.update(over)
    return ServeConfig(**kw)


def _wait_batches(srv, k: int, timeout_s: float = 20.0) -> None:
    t0 = time.monotonic()
    while srv.batches < k and time.monotonic() - t0 < timeout_s:
        time.sleep(0.002)


def _tear_tail(journal_dir: str, admit_id: int,
               rng: np.random.Generator) -> None:
    """A crash DURING a terminal append: a CRC-less prefix of a would-be
    terminal for ``admit_id`` at the live segment's tail. Adoption must
    drop it and replay the request."""
    from gauss_tpu_torch.serve import durable

    segs = durable.segment_paths(journal_dir)
    payload = durable.encode_record({
        "rec": "terminal", "schema": durable.JOURNAL_SCHEMA,
        "id": int(admit_id), "rid": None, "trace": "torn", "status": "ok",
        "t_unix": time.time()})
    cut = int(rng.integers(1, len(payload) - 1))
    with open(segs[-1], "ab") as f:
        f.write(payload[:cut])


def audit_union(journal_dirs: List[str], ledger: List[Tuple[str, int]],
                gate: float) -> Dict:
    """Journal-vs-ledger audit over the UNION of replica journals (the
    failover handoff legitimately re-admits a request on the adopter, so
    duplicate ADMITS across directories are expected — duplicate
    TERMINALS are the violation). Scans RAW segment lines: the scanner's
    in-memory state dedupes terminals by id, which would hide exactly
    the double-terminal this audit exists to catch."""
    from gauss_tpu_torch.serve import durable
    from gauss_tpu_torch.verify import checks

    admits_by_rid: Dict[str, Dict[str, Any]] = {}
    term_statuses: Dict[str, List[str]] = {}
    term_docs: Dict[str, Dict[str, Any]] = {}
    torn_dropped = 0
    for jd in journal_dirs:
        if not os.path.isdir(jd):
            continue
        for seg in durable.segment_paths(jd):
            with open(seg, "rb") as f:
                for line in f.read().split(b"\n"):
                    if not line:
                        continue
                    doc = durable.decode_line(line + b"\n")
                    if doc is None:
                        torn_dropped += 1
                        continue
                    rid = doc.get("rid")
                    if not rid:
                        continue
                    if doc.get("rec") == "admit":
                        admits_by_rid.setdefault(rid, doc)
                    elif doc.get("rec") == "terminal":
                        term_statuses.setdefault(rid, []).append(
                            doc.get("status"))
                        term_docs.setdefault(rid, doc)
    missing: List[str] = []
    duplicates: List[str] = []
    incorrect: List[str] = []
    statuses: Dict[str, int] = {}
    for rid, _n in ledger:
        terms = term_statuses.get(rid, [])
        if not terms:
            missing.append(rid)
            continue
        if len(terms) > 1:
            duplicates.append(rid)
        term = term_docs[rid]
        statuses[term["status"]] = statuses.get(term["status"], 0) + 1
        if term["status"] == "ok":
            adm = admits_by_rid.get(rid)
            if adm is None or term.get("x") is None:
                incorrect.append(rid)
                continue
            a = durable.decode_array(adm["a"])
            b = durable.decode_array(adm["b"])
            if adm.get("was_vector"):
                b = b.reshape(-1)
            x = durable.decode_array(term["x"])
            rel = checks.residual_norm(a, x, b, relative=True)
            if not (np.isfinite(rel) and rel <= gate):
                incorrect.append(rid)
    return {"admitted": len(ledger), "terminals": len(term_docs),
            "statuses": statuses, "missing": missing,
            "duplicates": duplicates, "incorrect": incorrect,
            "torn_dropped": torn_dropped}


# -- in-process failover cases ---------------------------------------------

def _assign_log_case(i: int, seed: int, tmpdir: str) -> Dict:
    """``router_restart``: the assign-log pin map must survive a router
    restart byte-for-byte, and a TORN tail must lose only pins that the
    deterministic rehash re-derives identically (the documented recovery
    contract — the live set did not change, so the hash agrees)."""
    from gauss_tpu_torch.serve.router import AssignLog, HashRing

    rng = np.random.default_rng(np.random.SeedSequence((seed, i, 0xA551)))
    names = ["r0", "r1", "r2"]
    ring = HashRing(names)
    path = os.path.join(
        _fresh_dir(os.path.join(tmpdir, f"case-router_restart-{i:03d}")),
        "assign.log")
    out: Dict = {"case": i, "kind": "router_restart"}
    pins: Dict[str, str] = {}
    al = AssignLog(path)
    for j in range(24):
        rid = f"rr{seed}-{i}-{j}"
        node = ring.lookup(rid)
        al.assign(rid, node)
        pins[rid] = node
    victim = names[int(rng.integers(0, 3))]
    survivors = {n for n in names if n != victim}
    adopter = ring.lookup(victim, survivors)
    moved = al.failover(victim, adopter)
    for rid, node in pins.items():
        if node == victim:
            pins[rid] = adopter
    # pins assigned AFTER the failover route over the live set only
    for j in range(24, 36):
        rid = f"rr{seed}-{i}-{j}"
        node = ring.lookup(rid, survivors)
        al.assign(rid, node)
        pins[rid] = node
    al.close()
    al2 = AssignLog(path)
    survived = al2.pins()
    al2.close()
    if survived != pins:
        out["outcome"] = "violation"
        out["error"] = (f"pins did not survive restart: "
                        f"{len(survived)} != {len(pins)}")
        return out
    # torn tail: the last record is half-written; reload drops it and
    # rehash over the unchanged live set must re-derive the lost pin
    with open(path, "rb") as f:
        raw = f.read()
    cut = int(rng.integers(3, 20))
    with open(path, "wb") as f:
        f.write(raw[:-cut])
    al3 = AssignLog(path)
    after_torn = al3.pins()
    al3.close()
    lost = {rid: node for rid, node in pins.items()
            if rid not in after_torn}
    bad = {rid: node for rid, node in lost.items()
           if ring.lookup(rid, survivors) != node}
    out["moved"] = moved
    out["torn_lost"] = len(lost)
    out["outcome"] = "violation" if bad else "ok"
    if bad:
        out["error"] = f"torn-tail pins not rehash-recoverable: {bad}"
    return out


def run_failover_case(i: int, seed: int, gate: float, tmpdir: str,
                      kind: str, cache=None, device: str = "cuda") -> Dict:
    """One victim-journal → adopt-on-survivor case; returns its outcome
    record. The in-process analog of a replica death: the victim's
    journal state is exactly what a SIGKILL leaves (``_crash()`` abandons
    the queue and drops the journal handle cold), and the survivor runs
    the same :func:`net.adopt_journal` the router's failover calls."""
    if kind == "router_restart":
        return _assign_log_case(i, seed, tmpdir)

    from gauss_tpu_torch.serve import durable
    from gauss_tpu_torch.serve.net import adopt_journal
    from gauss_tpu_torch.serve.server import SolverServer

    rng = np.random.default_rng(np.random.SeedSequence((seed, i, 0xF417)))
    case_dir = _fresh_dir(os.path.join(tmpdir, f"case-{kind}-{i:03d}"))
    victim_dir = os.path.join(case_dir, "victim")
    survivor_dir = os.path.join(case_dir, "survivor")
    out: Dict = {"case": i, "kind": kind}
    ledger: List[Tuple[str, int]] = []
    operands: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    n_req = 6 + int(rng.integers(0, 5))

    # -- phase 1: load the victim, then kill (or drain) it -----------------
    victim = SolverServer(_case_config(victim_dir, gate, device),
                          cache=cache)
    if kind not in ("stall", "expired"):
        # A STALLED victim admitted work but never dispatched it; the
        # expired kind needs every admit still live when the deadline
        # passes. Both model that by never starting the worker.
        victim.start()
    for j in range(n_req):
        n = 16 + int(rng.integers(0, 13))
        a, b = _system(rng, n)
        rid = f"r{seed}-{i}-{j}"
        # short-deadline requests: dead by adoption time — the replay
        # must type them expired (or serve them honestly pre-kill),
        # never lose them
        expiring = (kind == "expired" and j % 2 == 0) or \
                   (kind in ("sigkill", "stall") and j == n_req - 1)
        h = victim.submit(a, b, request_id=rid,
                          deadline_s=0.2 if expiring else None)
        if not (h.done and h.result(0).status == "rejected"):
            ledger.append((rid, n))
            operands[rid] = (a, b)
    if kind == "drain":
        victim.stop(drain=True, timeout=120.0)
    else:
        if kind not in ("stall", "expired"):
            _wait_batches(victim, int(rng.integers(0, 3)))
        victim._crash()
        if kind == "torn":
            st = durable.scan(victim_dir)
            live = st.live_admits()
            vid = live[0]["id"] if live else next(iter(st.admits), 0)
            _tear_tail(victim_dir, vid, rng)
    if kind == "expired":
        time.sleep(0.35)  # every 0.2 s deadline is dead before adoption

    # -- phase 2: a surviving peer adopts the victim's journal -------------
    survivor = SolverServer(_case_config(survivor_dir, gate, device),
                            cache=cache)
    survivor.start()
    adopt = adopt_journal(survivor, victim_dir)
    out["adopt"] = {k: adopt.get(k) for k in
                    ("imported", "replayed", "expired", "skipped",
                     "torn_dropped")}
    if kind == "drain" and adopt.get("replayed", 0) != 0:
        out["outcome"] = "violation"
        out["error"] = ("clean shutdown journal replayed "
                        f"{adopt['replayed']} request(s) on the adopter")
        survivor.stop()
        return out
    # Quiescence = every ledger rid holds a terminal on the survivor
    # (imported at adoption or resolved by the replay) — NOT depth==0:
    # the worker decrements depth BEFORE dispatching the final batch, so
    # a depth wait races the last in-flight solve and would misread it
    # as a storm-triggered fresh solve.
    t0 = time.monotonic()
    while (time.monotonic() - t0 < 120
           and any(rid not in survivor._rid_terminals
                   for rid, _n in ledger)):
        time.sleep(0.01)
    served_before_storm = survivor.requests_served
    while time.monotonic() - t0 < 120:
        time.sleep(0.05)
        now_served = survivor.requests_served
        if now_served == served_before_storm:
            break
        served_before_storm = now_served

    # -- phase 3: resubmission storm races the completed replay ------------
    storm_mismatch = 0
    threads: List[threading.Thread] = []
    storm_out: Dict[str, str] = {}
    lock = threading.Lock()

    def _resubmit(rid: str) -> None:
        a, b = operands[rid]
        res = survivor.solve(a, b, request_id=rid, timeout=60.0)
        with lock:
            storm_out[rid] = res.status

    for rid, _n in ledger:
        t = threading.Thread(target=_resubmit, args=(rid,))
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=90)
    for rid, _n in ledger:
        if storm_out.get(rid) is None:
            storm_mismatch += 1
    fresh_solves = survivor.requests_served - served_before_storm
    survivor.stop(drain=True, timeout=120.0)

    # -- audit -------------------------------------------------------------
    out["audit"] = audit_union([victim_dir, survivor_dir], ledger, gate)
    out["storm_unanswered"] = storm_mismatch
    out["storm_fresh_solves"] = fresh_solves
    a_ = out["audit"]
    if kind == "expired":
        want_expired = sum(1 for j in range(n_req) if j % 2 == 0)
        if a_["statuses"].get("expired", 0) < want_expired:
            out["outcome"] = "violation"
            out["error"] = (f"expected >= {want_expired} typed expiries, "
                            f"got {a_['statuses']}")
            return out
    violated = bool(a_["missing"] or a_["duplicates"] or a_["incorrect"]
                    or storm_mismatch or fresh_solves > 0)
    out["outcome"] = "violation" if violated else "ok"
    if violated:
        out["error"] = (f"missing={a_['missing'][:3]} "
                        f"duplicates={a_['duplicates'][:3]} "
                        f"incorrect={a_['incorrect'][:3]} "
                        f"storm_unanswered={storm_mismatch} "
                        f"storm_fresh_solves={fresh_solves}")
    return out


# -- fleet legs (real replica processes behind the router) -----------------

def _router_config(root: str, replicas: int, device: str = "cuda",
                   **over):
    from gauss_tpu_torch.serve.router import RouterConfig

    kw = dict(replicas=replicas, dir=root, ladder=(32,), max_batch=4,
              verify_gate=None, max_restarts=3, poll_s=0.1,
              stall_after_s=30.0, device=device)
    kw.update(over)
    return RouterConfig(**kw)


def _net_load(client, mats, rids: List[str], deadline_s: float = 120.0,
              ) -> Dict[str, Any]:
    """Fire every (rid, system) through the client concurrently; returns
    rid -> ServeResult."""
    results: Dict[str, Any] = {}
    lock = threading.Lock()

    def _one(idx: int) -> None:
        a, b = mats[idx]
        res = client.solve(a, b, deadline_s=deadline_s,
                           request_id=rids[idx])
        with lock:
            results[rids[idx]] = res

    threads = [threading.Thread(target=_one, args=(i,))
               for i in range(len(rids))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    return results


def _journal_dirs(router) -> List[str]:
    import glob

    dirs = []
    for rdir in router.replica_dirs():
        dirs.extend(sorted(glob.glob(os.path.join(rdir, "journal*"))))
    return dirs


def _bundle_ok(replica_dir: str) -> Tuple[Optional[str], bool]:
    """The latest post-mortem bundle under a replica's flight ring, and
    whether ``obs.debug --check`` passes on it — the operator-facing
    artifact every charged kill must leave behind."""
    from gauss_tpu_torch.obs import debug as _gdebug
    from gauss_tpu_torch.obs import postmortem

    bundle = postmortem.latest_bundle(
        postmortem.default_bundles_dir(os.path.join(replica_dir, "flight")))
    if bundle is None:
        return None, False
    return bundle, _gdebug.main([bundle, "--check"]) == 0


def _wait_respawn(router, name: str, old_pid: int,
                  timeout_s: float = 120.0) -> float:
    """Seconds from now until ``name`` is live again with a NEW pid —
    the client-observable failover recovery latency."""
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        rp = router.live_replicas().get(name)
        if rp is not None and rp.proc.pid != old_pid and rp.url:
            return time.perf_counter() - t0
        time.sleep(0.02)
    raise TimeoutError(f"replica {name} did not respawn in {timeout_s} s")


def run_kill_leg(seed: int, gate: float, tmpdir: str, device: str = "cuda",
                 log=print) -> Dict:
    """The acceptance drill: 3 replicas under concurrent network load,
    every replica SIGKILLed in turn mid-load — zero lost requests, ok
    terminals re-verified from journaled operands, the resubmission storm
    dedupes to the same terminals, and each kill leaves a checkable
    post-mortem bundle."""
    from gauss_tpu_torch.serve.net import SolveClient
    from gauss_tpu_torch.serve.router import Router

    rng = np.random.default_rng(np.random.SeedSequence((seed, 0x4B11)))
    root = _fresh_dir(os.path.join(tmpdir, "leg-kill3"))
    leg: Dict = {"leg": "kill3"}
    n_req = 45
    mats = []
    for _ in range(n_req):
        n = 8 + int(rng.integers(0, 33))
        mats.append(_system(rng, n))
    rids = [f"k3-{seed}-{j}" for j in range(n_req)]
    ledger = [(rid, mats[j][0].shape[0]) for j, rid in enumerate(rids)]
    t0 = time.perf_counter()
    recoveries: List[float] = []
    with Router(_router_config(root, 3, device)) as router:
        client = SolveClient(router.url, timeout_s=180.0, wait_s=5.0,
                             seed=seed)
        load = threading.Thread(
            target=lambda: leg.update(results=_net_load(client, mats, rids)))
        load.start()
        for victim in ("r0", "r1", "r2"):
            time.sleep(0.4)
            old_pid = router.kill_replica(victim)
            recoveries.append(_wait_respawn(router, victim, old_pid))
            log(f"  kill3: SIGKILLed {victim} (pid {old_pid}), live again "
                f"in {recoveries[-1]:.2f} s")
        load.join(timeout=300)
        results = leg.pop("results", {})
        # resubmission storm: every rid again — must agree, no new solves
        storm = _net_load(client, mats, rids)
        stats = router.stats()
        leg["restarts_used"] = stats["restarts_used"]
        jdirs = _journal_dirs(router)
        router.stop(drain=True)
    lost = [rid for rid in rids if rid not in results
            or results[rid].status is None]
    not_ok = [rid for rid, res in results.items() if not res.ok]
    storm_mismatch = [rid for rid in rids
                      if storm.get(rid) is None
                      or storm[rid].status != results[rid].status]
    leg["audit"] = audit_union(jdirs, ledger, gate)
    leg["recovery_s"] = [round(r, 3) for r in recoveries]
    leg["client_lost"] = lost
    leg["client_not_ok"] = not_ok
    leg["storm_mismatch"] = storm_mismatch
    leg["client_retries"] = client.retries
    bundles = {}
    for victim in ("r0", "r1", "r2"):
        bundle, ok = _bundle_ok(os.path.join(root, victim))
        bundles[victim] = {"bundle": bundle, "check_ok": ok}
    leg["bundles"] = bundles
    leg["wall_s"] = round(time.perf_counter() - t0, 3)
    a_ = leg["audit"]
    violated = bool(lost or not_ok or storm_mismatch or a_["missing"]
                    or a_["duplicates"] or a_["incorrect"]
                    or leg["restarts_used"] != 3
                    or not all(b["check_ok"] for b in bundles.values()))
    leg["outcome"] = "violation" if violated else "ok"
    if violated:
        leg["error"] = (f"lost={lost[:3]} not_ok={not_ok[:3]} "
                        f"storm={storm_mismatch[:3]} "
                        f"missing={a_['missing'][:3]} "
                        f"duplicates={a_['duplicates'][:3]} "
                        f"incorrect={a_['incorrect'][:3]} "
                        f"restarts_used={leg['restarts_used']} "
                        f"bundles={ {k: v['check_ok'] for k, v in bundles.items()} }")
    return leg


def run_drain_leg(seed: int, gate: float, tmpdir: str, device: str = "cuda",
                  log=print) -> Dict:
    """SIGTERM mid-load: the replica drains, exits ``fleet.DRAIN_EXIT``,
    and the router respawns it WITHOUT spending the crash-restart budget
    (the drain-vs-crash accounting, proven at the fleet level)."""
    from gauss_tpu_torch.serve.net import SolveClient
    from gauss_tpu_torch.serve.router import Router

    rng = np.random.default_rng(np.random.SeedSequence((seed, 0xD7A1)))
    root = _fresh_dir(os.path.join(tmpdir, "leg-drain"))
    leg: Dict = {"leg": "drain_free"}
    n_req = 16
    mats = [_system(rng, 12 + int(rng.integers(0, 21)))
            for _ in range(n_req)]
    rids = [f"dr-{seed}-{j}" for j in range(n_req)]
    ledger = [(rid, mats[j][0].shape[0]) for j, rid in enumerate(rids)]
    with Router(_router_config(root, 2, device)) as router:
        client = SolveClient(router.url, timeout_s=120.0, wait_s=5.0,
                             seed=seed)
        results: Dict[str, Any] = {}
        load = threading.Thread(
            target=lambda: results.update(_net_load(client, mats, rids)))
        load.start()
        time.sleep(0.3)
        old_pid = router.terminate_replica("r1")
        recovery = _wait_respawn(router, "r1", old_pid)
        log(f"  drain_free: SIGTERMed r1 (pid {old_pid}), respawned in "
            f"{recovery:.2f} s")
        load.join(timeout=240)
        stats = router.stats()
        jdirs = _journal_dirs(router)
        router.stop(drain=True)
    leg["restarts_used"] = stats["restarts_used"]
    leg["failovers"] = stats["failovers"]
    leg["recovery_s"] = round(recovery, 3)
    leg["audit"] = audit_union(jdirs, ledger, gate)
    lost = [rid for rid in rids if rid not in results
            or results[rid].status is None]
    a_ = leg["audit"]
    violated = bool(lost or a_["missing"] or a_["duplicates"]
                    or a_["incorrect"]
                    or stats["restarts_used"] != 0
                    or stats["failovers"] < 1)
    leg["outcome"] = "violation" if violated else "ok"
    if violated:
        leg["error"] = (f"lost={lost[:3]} missing={a_['missing'][:3]} "
                        f"duplicates={a_['duplicates'][:3]} "
                        f"restarts_used={stats['restarts_used']} "
                        f"(drain must be budget-free) "
                        f"failovers={stats['failovers']}")
    return leg


def run_stall_leg(seed: int, gate: float, tmpdir: str, device: str = "cuda",
                  log=print) -> Dict:
    """A SIGSTOPped replica stops touching its heartbeat; the router must
    call the stall, kill it, fail its journal over, and leave a
    ``supervisor_stall`` bundle — without the clients noticing more than
    latency."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.serve.net import SolveClient
    from gauss_tpu_torch.serve.router import Router

    rng = np.random.default_rng(np.random.SeedSequence((seed, 0x57A7)))
    root = _fresh_dir(os.path.join(tmpdir, "leg-stall"))
    leg: Dict = {"leg": "stall"}
    n_req = 12
    mats = [_system(rng, 12 + int(rng.integers(0, 21)))
            for _ in range(n_req)]
    rids = [f"st-{seed}-{j}" for j in range(n_req)]
    ledger = [(rid, mats[j][0].shape[0]) for j, rid in enumerate(rids)]
    with obs.run() as rec, Router(_router_config(
            root, 2, device, stall_after_s=2.5, poll_s=0.2)) as router:
        first = len(rec.events)
        client = SolveClient(router.url, timeout_s=180.0, wait_s=3.0,
                             seed=seed)
        results: Dict[str, Any] = {}
        load = threading.Thread(
            target=lambda: results.update(
                _net_load(client, mats, rids, deadline_s=150.0)))
        load.start()
        time.sleep(0.3)
        victim = router.live_replicas()["r0"]
        os.kill(victim.proc.pid, signal.SIGSTOP)
        recovery = _wait_respawn(router, "r0", victim.proc.pid,
                                 timeout_s=180.0)
        log(f"  stall: SIGSTOPped r0 (pid {victim.proc.pid}), failed over "
            f"and respawned in {recovery:.2f} s")
        load.join(timeout=300)
        stats = router.stats()
        jdirs = _journal_dirs(router)
        router.stop(drain=True)
        leg["deaths"] = _death_events(rec.events[first:])
    bundle, bundle_ok = _bundle_ok(os.path.join(root, "r0"))
    leg["bundle"] = bundle
    leg["bundle_check_ok"] = bundle_ok
    leg["recovery_s"] = round(recovery, 3)
    leg["restarts_used"] = stats["restarts_used"]
    leg["audit"] = audit_union(jdirs, ledger, gate)
    lost = [rid for rid in rids if rid not in results
            or results[rid].status is None]
    a_ = leg["audit"]
    violated = bool(lost or a_["missing"] or a_["duplicates"]
                    or a_["incorrect"] or not bundle_ok
                    or stats["restarts_used"] != 1)
    leg["outcome"] = "violation" if violated else "ok"
    if violated:
        leg["error"] = (f"lost={lost[:3]} missing={a_['missing'][:3]} "
                        f"duplicates={a_['duplicates'][:3]} "
                        f"bundle_ok={bundle_ok} "
                        f"restarts_used={stats['restarts_used']}")
        # What a violation leaves to read: each replica incarnation's log
        # tail beside the router's death events (leg["deaths"]).
        leg["child_logs"] = {
            name: _tail(os.path.join(root, name, "child.log"))
            for name in sorted(os.listdir(root))
            if os.path.isfile(os.path.join(root, name, "child.log"))}
    return leg


#: the router's events that tell one death from another
DEATH_EVENTS = ("stall", "restart", "degraded", "respawn_failed",
                "death_handling_failed", "replica_spawn")


def _death_events(events) -> List[Dict]:
    """The router's stall, failover, spawn and restart events of a leg, in
    order, each with its time (seconds into the run): which replica died,
    how (``cause``, the stale heartbeat's age), who adopted its journal
    and how long the failover took (``recovery_s``)."""
    keep = ("t", "event", "replica", "cause", "rc", "heartbeat_age_s",
            "adopter", "recovery_s", "replayed", "charged", "pid", "error")
    out = []
    for ev in events:
        if ev.get("type") == "replica_failover" or (
                ev.get("type") == "router"
                and ev.get("event") in DEATH_EVENTS):
            doc = {k: ev[k] for k in keep if ev.get(k) is not None}
            doc.setdefault("event", ev["type"])
            out.append(doc)
    return out


def _tail(path: str, lines: int = 40) -> List[str]:
    try:
        with open(path, "rb") as f:
            return f.read().decode(errors="replace").splitlines()[-lines:]
    except OSError:
        return []


def run_tput_phase(seed: int, tmpdir: str, min_speedup: float,
                   device: str = "cuda", log=print) -> Dict:
    """Aggregate throughput: the same mix through 1 replica then 3, with
    an injected per-dispatch delay of :data:`TPUT_DELAY_S` standing in for
    device time (the host's cores cannot scale real compute with process
    count, but the serving path around a sleeping device must): 3
    replicas must reach ``min_speedup`` x the single-replica
    throughput."""
    from gauss_tpu_torch.resilience import inject as _inject
    from gauss_tpu_torch.serve.net import SolveClient
    from gauss_tpu_torch.serve.router import Router

    rng = np.random.default_rng(np.random.SeedSequence((seed, 0x7707)))
    n_req = 30
    mats = [_system(rng, 24) for _ in range(n_req)]
    out: Dict = {"min_speedup": min_speedup, "delay_s": TPUT_DELAY_S}
    # the same fault plan reaches EVERY replica in BOTH legs: dispatch
    # costs a fixed TPUT_DELAY_S of injected "device time" per batch
    prior = os.environ.get(_inject.ENV_VAR)
    os.environ[_inject.ENV_VAR] = \
        f"serve.worker.dispatch=delay:param={TPUT_DELAY_S}:max=1000000"
    try:
        for replicas in (1, 3):
            root = _fresh_dir(os.path.join(tmpdir, f"leg-tput{replicas}"))
            with Router(_router_config(root, replicas, device,
                                       max_batch=1)) as router:
                client = SolveClient(router.url, timeout_s=240.0,
                                     wait_s=20.0, seed=seed)
                # warm every replica's executable cache off the clock
                warm = [_system(rng, 24) for _ in range(4 * replicas)]
                _net_load(client, warm,
                          [f"w{replicas}-{seed}-{j}"
                           for j in range(len(warm))], deadline_s=240.0)
                rids = [f"tp{replicas}-{seed}-{j}" for j in range(n_req)]
                t0 = time.perf_counter()
                results = _net_load(client, mats, rids, deadline_s=240.0)
                wall = time.perf_counter() - t0
                router.stop(drain=True)
            not_ok = sum(1 for r in results.values() if not r.ok)
            out[f"replicas_{replicas}"] = {
                "wall_s": round(wall, 3),
                "s_per_request": round(wall / n_req, 6),
                "throughput_rps": round(n_req / wall, 3),
                "not_ok": not_ok,
            }
            log(f"  tput: {replicas} replica(s) -> "
                f"{out[f'replicas_{replicas}']['throughput_rps']} req/s")
    finally:
        if prior is None:
            os.environ.pop(_inject.ENV_VAR, None)
        else:
            os.environ[_inject.ENV_VAR] = prior
    r1 = out["replicas_1"]["throughput_rps"]
    r3 = out["replicas_3"]["throughput_rps"]
    out["speedup"] = round(r3 / r1, 3) if r1 else None
    served = (out["replicas_1"]["not_ok"] == 0
              and out["replicas_3"]["not_ok"] == 0)
    out["ok"] = bool(served and out["speedup"]
                     and out["speedup"] >= min_speedup)
    return out


def history_records(summary: Dict) -> List[Tuple[str, float, str]]:
    """(metric, value, unit) records for history. Slow-side gated:
    per-request serving cost through 3 replicas, and how long a SIGKILL
    failover takes end-to-end (kill -> replica live again)."""
    out: List[Tuple[str, float, str]] = []
    tput = summary.get("tput") or {}
    spr = (tput.get("replicas_3") or {}).get("s_per_request")
    if isinstance(spr, (int, float)) and spr > 0:
        out.append(("replica:s_per_request", spr, "s"))
    recs: List[float] = []
    for leg in (summary.get("legs") or ()):
        r = leg.get("recovery_s")
        if leg.get("leg") == "kill3" and isinstance(r, list):
            recs.extend(float(v) for v in r)
    if recs:
        out.append(("replica:failover_recovery_s",
                    round(sum(recs) / len(recs), 4), "s"))
    return out


# -- campaign main ---------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.serve.replicacheck",
        description="Kill-the-replica chaos campaign: SIGKILL/stall/torn-"
                    "tail/drain/router-restart cases against the "
                    "replicated network tier; every admitted request must "
                    "reach exactly one terminal across failover, with "
                    "zero duplicate solves under resubmission storms and "
                    "aggregate throughput scaling across replicas.")
    p.add_argument("--cases", type=int, default=30,
                   help="in-process failover cases, cycled over kinds "
                        f"{CASE_KINDS} (default 30)")
    p.add_argument("--seed", type=int, default=190733)
    p.add_argument("--gate", type=float, default=1e-4)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the servers and replicas run (default cuda; "
                        "cpu runs the kernels' plain versions)")
    p.add_argument("--tmpdir", default=None,
                   help="replica/journal scratch directory (default: a new "
                        "temporary directory, removed at the end)")
    p.add_argument("--min-speedup", type=float, default=2.0,
                   help="required 3-replica/1-replica throughput ratio "
                        "(default 2.0)")
    p.add_argument("--no-subprocess", action="store_true",
                   help="skip the real-replica fleet legs (in-process "
                        "failover cases only)")
    p.add_argument("--no-tput", action="store_true",
                   help="skip the 1-vs-3 replica throughput phase")
    p.add_argument("--metrics-out", default=None, metavar="PATH")
    p.add_argument("--summary-json", default=None, metavar="PATH")
    p.add_argument("--history", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="append campaign records to the regression history "
                        "(default reports/history_torch.jsonl)")
    p.add_argument("--regress-check", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from gauss_tpu_torch.obs import regress
    from gauss_tpu_torch.serve.cache import ExecutableCache
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)  # no card: RuntimeError, no fallback
    with tempfile.TemporaryDirectory(prefix="gauss_replica_") as scratch:
        tmpdir = args.tmpdir or scratch
        os.makedirs(tmpdir, exist_ok=True)
        # One executable cache across the in-process incarnations: the
        # campaign measures failover, not the caches' first batches.
        cache = ExecutableCache(64, device=dev)
        summary = _campaign(args, tmpdir, cache)
    legs, tput = summary["legs"], summary["tput"]
    violations = summary["violations"]
    print(f"replica campaign: {args.cases} failover case(s) + "
          f"{len(legs)} fleet leg(s), {summary['admitted']} admitted "
          f"request(s) on {args.device}")
    print(f"  terminals: {summary['statuses']} — "
          f"{summary['replayed_on_peer']} replayed on a peer, "
          f"{summary['expired_in_failover']} typed-expired in failover, "
          f"{summary['terminals_imported']} imported for dedupe")
    for leg in legs:
        a_ = leg["audit"]
        print(f"  leg[{leg['leg']}]: {leg['outcome']} "
              f"admitted={a_['admitted']} missing={len(a_['missing'])} "
              f"duplicates={len(a_['duplicates'])} "
              f"recovery_s={leg.get('recovery_s')}")
    if tput:
        print(f"  throughput: 1 replica "
              f"{tput['replicas_1']['throughput_rps']} req/s -> 3 replicas "
              f"{tput['replicas_3']['throughput_rps']} req/s "
              f"(speedup {tput['speedup']}x, gate {args.min_speedup}x: "
              f"{'ok' if tput['ok'] else 'FAIL'})")
    print(f"  invariant {'HOLDS' if violations == 0 else 'VIOLATED'} "
          f"({summary['wall_s']} s)")

    if args.summary_json:
        parent = os.path.dirname(args.summary_json)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"summary: {args.summary_json}")

    # A gate-failing run must not ratchet its numbers into the baseline:
    # only campaigns whose invariant held get an epoch.
    rc = regress.gate(
        regress.campaign_records(history_records(summary), "replicacheck",
                                 "replica", regress.device_tag(args.device)),
        args.history, args.regress_check, healthy=not violations)
    if violations:
        print(f"replicacheck: INVARIANT VIOLATED ({violations} case(s))",
              file=sys.stderr)
        for o in summary["case_violations"][:5]:
            print(f"  case {o['case']} [{o['kind']}]: {o.get('error')}",
                  file=sys.stderr)
        for leg in legs:
            if leg["outcome"] == "violation":
                print(f"  leg [{leg['leg']}]: {leg.get('error')}",
                      file=sys.stderr)
        if tput and not tput.get("ok"):
            print(f"  tput: speedup {tput.get('speedup')} < "
                  f"{args.min_speedup}", file=sys.stderr)
        return 2
    return rc


def _campaign(args, tmpdir: str, cache) -> Dict:
    """The failover cases, the fleet legs and the scaling phase; the
    summary (``kind: replica_campaign``)."""
    from gauss_tpu_torch import obs

    t0 = time.perf_counter()
    outcomes: List[Dict] = []
    with obs.run(metrics_out=args.metrics_out, tool="replica_campaign",
                 cases=args.cases, seed=args.seed):
        with obs.span("replica_failover_phase", cases=args.cases):
            for i in range(args.cases):
                kind = CASE_KINDS[i % len(CASE_KINDS)]
                outcomes.append(run_failover_case(
                    i, args.seed, args.gate, tmpdir, kind, cache=cache,
                    device=args.device))
                if (i + 1) % 6 == 0:
                    print(f"  failover cases: {i + 1}/{args.cases}")
        legs: List[Dict] = []
        if not args.no_subprocess:
            with obs.span("replica_fleet_phase"):
                for leg in (run_kill_leg, run_drain_leg, run_stall_leg):
                    legs.append(leg(args.seed, args.gate, tmpdir,
                                    device=args.device))
        tput = ({} if args.no_tput
                else run_tput_phase(args.seed, tmpdir, args.min_speedup,
                                    device=args.device))
        wall = round(time.perf_counter() - t0, 3)

        audited = [o for o in outcomes if "audit" in o]
        statuses: Dict[str, int] = {}
        for o in audited:
            for k, v in o["audit"]["statuses"].items():
                statuses[k] = statuses.get(k, 0) + v
        case_violations = [o for o in outcomes if o["outcome"] != "ok"]
        leg_violations = [leg for leg in legs
                          if leg["outcome"] == "violation"]
        violations = (len(case_violations) + len(leg_violations)
                      + (0 if (not tput or tput.get("ok")) else 1))
        audits = [o["audit"] for o in audited] + [leg["audit"]
                                                  for leg in legs]
        summary = {
            "kind": "replica_campaign", "seed": args.seed,
            "gate": args.gate, "device": args.device,
            "cases": args.cases + len(legs),
            "in_process_cases": args.cases,
            "admitted": sum(o["audit"]["admitted"] for o in audited),
            "statuses": statuses,
            "replayed_on_peer": sum((o.get("adopt") or {}).get("replayed", 0)
                                    for o in outcomes),
            "expired_in_failover": sum(
                (o.get("adopt") or {}).get("expired", 0) for o in outcomes),
            "terminals_imported": sum(
                (o.get("adopt") or {}).get("imported", 0) for o in outcomes),
            "lost": sum(len(a["missing"]) for a in audits),
            "duplicate_terminals": sum(len(a["duplicates"]) for a in audits),
            "duplicate_solves": sum(o.get("storm_fresh_solves", 0)
                                    for o in outcomes),
            "unverified": sum(len(a["incorrect"]) for a in audits),
            "case_violations": [
                {k: o.get(k) for k in ("case", "kind", "error")}
                for o in case_violations],
            "violations": violations,
            "legs": legs, "tput": tput, "wall_s": wall,
            "invariant_ok": violations == 0,
        }
        obs.emit("replica_campaign",
                 **{k: v for k, v in summary.items() if k != "kind"})
    return summary


if __name__ == "__main__":
    sys.exit(main())

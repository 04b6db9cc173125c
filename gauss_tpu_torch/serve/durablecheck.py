"""The kill-the-server chaos campaign: ``python -m
gauss_tpu_torch.serve.durablecheck`` (the port of
``gauss_tpu/serve/durablecheck.py``; runs on ``cuda`` unless ``--device
cpu`` is given).

Asserts the durability invariant the write-ahead request journal
(:mod:`gauss_tpu_torch.serve.durable`) exists to provide:

    **every admitted request reaches EXACTLY ONE terminal status —
    served-and-verified at the 1e-4 gate, a typed failure, or a typed
    expiry — across server crashes, torn journal writes, and restarts;
    and an idempotent resubmission never causes a duplicate solve.**

"Admitted" is client truth: the campaign keeps its own LEDGER of every
``submit()`` that returned an admitted handle, crashes the server, and
audits the journal against the ledger, re-verifying every ``ok`` answer
from the journaled operands.

Phases:

- **recovery cases** (``--cases``, in-process): seeded ``crash``,
  ``torn``, ``clean`` and ``underload`` scenarios against a live journaled
  :class:`~gauss_tpu_torch.serve.server.SolverServer` (crashes through its
  ``_crash()`` chaos hook), each ending in a journal-vs-ledger audit and an
  idempotent-resubmission pass that must answer every key from the
  journal without one solve.
- **subprocess legs** (``--no-subprocess`` skips them): a self-driving
  server child (``--drive``) killed by the seeded ``server_kill`` fault at
  a batch boundary, a ``journal_torn_write`` child that dies mid-append,
  and a child under :func:`~gauss_tpu_torch.serve.durable.supervise`
  whose restart must finish the plan exactly once. Each child is a new
  ``python -m`` process on ``--device``, recording into a flight ring;
  each death (or the unclean resume after it) must leave a post-mortem
  bundle that ``python -m gauss_tpu_torch.obs.debug --check`` passes. The
  legs run at once on the card, in turn on the CPU.
- **overhead** (``--no-overhead`` skips it): one loadgen plan journal-off
  and journal-on, seconds per request and their ratio.

``--history`` appends the campaign's records to the port's regression
history (``obs.regress``: its own file, each record stamped with the
device it ran on) and ``--regress-check`` gates them against that
device's baselines. Deliberate deviations from the JAX package:
``--tmpdir`` defaults to a new temporary directory, removed at the end;
the summary counts the invariant's four failure kinds (``lost``,
``duplicate_terminals``, ``duplicate_solves``, ``unverified``). Exit 2
when the invariant is violated, 1 when ``--regress-check`` finds an
out-of-band metric, 0 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

CASE_KINDS = ("crash", "torn", "clean", "underload")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _system(rng: np.random.Generator, n: int):
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a, rng.standard_normal(n)


def _case_config(journal_dir: str, gate: float, device: str = "cuda",
                 **over):
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


def _tear_terminal_append(journal_dir: str, admit_id: int,
                          rng: np.random.Generator) -> None:
    """Simulate a crash DURING a terminal append: a seeded prefix of a
    would-be terminal record for ``admit_id`` lands at the live segment's
    tail, newline never written. Recovery must drop it (CRC fails) and
    re-solve the request — at-least-once execution, exactly-once
    terminal."""
    from gauss_tpu_torch.serve import durable

    segs = durable.segment_paths(journal_dir)
    payload = durable.encode_record({
        "rec": "terminal", "schema": durable.JOURNAL_SCHEMA,
        "id": int(admit_id), "rid": None, "trace": "torn", "status": "ok",
        "t_unix": time.time()})
    cut = int(rng.integers(1, len(payload) - 1))
    with open(segs[-1], "ab") as f:
        f.write(payload[:cut])


def audit(journal_dir: str, ledger: List[Tuple[str, int]],
          gate: float, state=None) -> Dict:
    """Journal-vs-ledger audit: every admitted request_id must hold exactly
    one journaled terminal; every ``ok`` terminal must verify at ``gate``
    against the JOURNALED operands (the runner's own check — the invariant
    must not trust the server's gate to judge the server). ``state``: a
    scan of ``journal_dir`` already made (a journal of large operands
    takes seconds to scan)."""
    from gauss_tpu_torch.serve import durable
    from gauss_tpu_torch.verify import checks

    st = durable.scan(journal_dir) if state is None else state
    per_rid: Dict[str, int] = {}
    for term in st.terminals.values():
        rid = term.get("rid")
        if rid:
            per_rid[rid] = per_rid.get(rid, 0) + 1
    admits_by_rid = {doc.get("rid"): doc for doc in st.admits.values()
                     if doc.get("rid")}
    missing: List[str] = []
    duplicates: List[str] = []
    incorrect: List[str] = []
    statuses: Dict[str, int] = {}
    for rid, _n in ledger:
        cnt = per_rid.get(rid, 0)
        if cnt == 0:
            missing.append(rid)
            continue
        if cnt > 1:
            duplicates.append(rid)
        term = st.by_rid[rid]
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
    return {"admitted": len(ledger), "terminals": len(st.terminals),
            "statuses": statuses, "missing": missing,
            "duplicates": duplicates, "incorrect": incorrect,
            "torn_dropped": st.torn_dropped,
            "clean_shutdown": st.clean_shutdown}


def run_recovery_case(i: int, seed: int, gate: float, tmpdir: str,
                      kind: str, cache=None, device: str = "cuda") -> Dict:
    """One in-process kill/resume case; returns its outcome record."""
    from gauss_tpu_torch.serve.server import SolverServer

    rng = np.random.default_rng(np.random.SeedSequence((seed, i, 0xD0B1)))
    jd = os.path.join(tmpdir, f"case-{kind}-{i:03d}")
    out: Dict = {"case": i, "kind": kind}
    ledger: List[Tuple[str, int]] = []
    operands: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    n_req = 8 + int(rng.integers(0, 5))

    # -- phase 1: load, then die (or drain) --------------------------------
    srv = SolverServer(_case_config(jd, gate, device), cache=cache)
    srv.start()
    for j in range(n_req):
        n = 16 + int(rng.integers(0, 13))
        a, b = _system(rng, n)
        rid = f"d{seed}-{i}-{j}"
        # One request per crash case carries a deadline that will be dead
        # by recovery time: its replay must end as a typed expiry (or an
        # honest pre-crash serve), never a silent loss — the audit's
        # missing-list judges either way.
        deadline = 0.001 if (kind in ("crash", "underload")
                             and j == n_req - 1) else None
        h = srv.submit(a, b, request_id=rid, deadline_s=deadline)
        if not (h.done and h.result(0).status == "rejected"):
            ledger.append((rid, n))
            operands[rid] = (a, b)
    if kind == "clean":
        srv.stop(drain=True, timeout=120.0)
    else:
        _wait_batches(srv, int(rng.integers(0, 3)))
        srv._crash()
        if kind == "torn":
            from gauss_tpu_torch.serve import durable

            st = durable.scan(jd)
            live = st.live_admits()
            victim = live[0]["id"] if live else next(iter(st.admits), 0)
            _tear_terminal_append(jd, victim, rng)

    # -- phase 2: restart, recover, drain ----------------------------------
    srv2 = SolverServer(_case_config(jd, gate, device), cache=cache)
    srv2.start()
    out["resume"] = dict(srv2.last_resume or {})
    if kind == "clean" and out["resume"].get("replayed", 0) != 0:
        out["outcome"] = "violation"
        out["error"] = "clean shutdown marker did not suppress replay"
        srv2.stop()
        return out
    if kind == "underload":
        for j in range(4):
            n = 16 + int(rng.integers(0, 13))
            a, b = _system(rng, n)
            rid = f"d{seed}-{i}-new{j}"
            h = srv2.submit(a, b, request_id=rid)
            if not (h.done and h.result(0).status == "rejected"):
                ledger.append((rid, n))
                operands[rid] = (a, b)
    srv2.stop(drain=True, timeout=120.0)

    # -- phase 3: idempotent resubmission must not re-solve ----------------
    from gauss_tpu_torch.serve import durable as _d

    st_before = _d.scan(jd)
    srv3 = SolverServer(_case_config(jd, gate, device), cache=cache)
    srv3.start()
    deduped = mismatched = 0
    for rid, _n in ledger:
        a, b = operands[rid]
        res = srv3.solve(a, b, request_id=rid, timeout=60.0)
        want = st_before.by_rid.get(rid, {}).get("status")
        if want is not None and res.status == want:
            deduped += 1
        else:
            mismatched += 1
    resolves = srv3.requests_served
    srv3.stop(drain=True, timeout=120.0)

    # -- audit -------------------------------------------------------------
    out["audit"] = audit(jd, ledger, gate)
    out["deduped"] = deduped
    out["dedupe_mismatched"] = mismatched
    out["dedupe_resolves"] = resolves
    a_ = out["audit"]
    violated = bool(a_["missing"] or a_["duplicates"] or a_["incorrect"]
                    or mismatched or resolves > 0)
    out["outcome"] = "violation" if violated else "ok"
    if violated:
        out["error"] = (f"missing={a_['missing'][:3]} "
                        f"duplicates={a_['duplicates'][:3]} "
                        f"incorrect={a_['incorrect'][:3]} "
                        f"dedupe_mismatched={mismatched} "
                        f"dedupe_resolves={resolves}")
    return out


# -- subprocess legs -------------------------------------------------------

def _drive_argv(journal: str, ledger: str, requests: int, seed: int,
                device: str = "cuda",
                metrics_out: Optional[str] = None) -> List[str]:
    argv = [sys.executable, "-m", "gauss_tpu_torch.serve.durablecheck",
            "--drive", "--journal", journal, "--ledger", ledger,
            "--requests", str(requests), "--seed", str(seed),
            "--device", device]
    if metrics_out:
        argv += ["--metrics-out", metrics_out]
    return argv


def _read_ledger(path: str) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    seen = set()
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue  # torn ledger line: the submit never returned
                rid = doc.get("rid")
                if rid and rid not in seen:  # reruns re-log the same plan
                    seen.add(rid)
                    out.append((rid, int(doc.get("n", 0))))
    except FileNotFoundError:
        pass
    return out


def run_subprocess_legs(seed: int, gate: float, tmpdir: str,
                        device: str = "cuda", log=print) -> Dict:
    """The legs only a real dead process can prove: genuine ``os._exit``
    kills (``server_kill`` at a batch boundary), a torn live segment
    (``journal_torn_write`` mid-append), and a supervised restart. Each
    child is a fresh ``python -m`` process (never a fork of this one) on
    ``device``; on the card it loads the kernels this checkout built. The
    legs share nothing (a journal and a ledger each). On the CPU they run
    in turn, as the JAX package runs them, on a host that tests share; on
    the card at once, each on a thread of its own, to keep the campaign's
    wall time."""
    from concurrent.futures import ThreadPoolExecutor

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.resilience.inject import KILL_EXIT_CODE
    from gauss_tpu_torch.serve import durable

    env_base = {k: v for k, v in os.environ.items() if k != "GAUSS_FAULTS"}

    def _leg(name: str, faults: Optional[str], requests: int,
             supervised: bool) -> Dict:
        jd = os.path.join(tmpdir, f"leg-{name}")
        ledger = os.path.join(tmpdir, f"leg-{name}.ledger")
        # Every leg records into a flight ring; the death (or the unclean
        # resume after it) must leave a post-mortem bundle.
        fdir = os.path.join(tmpdir, f"leg-{name}.flight")
        leg: Dict = {"leg": name}
        t0 = time.perf_counter()
        with obs.span(f"durable_leg_{name}"):
            if supervised:
                env = dict(env_base)
                if faults:
                    env["GAUSS_FAULTS"] = faults
                logs: List[str] = []

                def _log(line: str) -> None:
                    logs.append(line)
                    log(line)

                rc = durable.supervise(
                    _drive_argv(jd, ledger, requests, seed, device),
                    heartbeat_path=os.path.join(jd, "heartbeat.json"),
                    max_restarts=2, stall_after_s=60.0, env=env, log=_log,
                    flight_dir=fdir, journal_dir=jd)
                leg["supervise_rc"] = rc
                leg["restarts"] = sum("restarting" in ln for ln in logs)
                # The leg proves something only if the child really died
                # AND supervision brought the plan home.
                killed = rc == 0 and leg["restarts"] >= 1
            else:
                env = dict(env_base, GAUSS_FLIGHT_DIR=fdir)
                if faults:
                    env["GAUSS_FAULTS"] = faults
                p1 = subprocess.run(
                    _drive_argv(jd, ledger, requests, seed, device),
                    env=env, cwd=_REPO, timeout=300, capture_output=True,
                    text=True)
                killed = p1.returncode == KILL_EXIT_CODE
                leg["first_rc"] = p1.returncode
                if p1.returncode not in (0, KILL_EXIT_CODE):
                    leg["stderr"] = p1.stderr[-1500:]
                # The recovery run: no faults, no new requests — replay
                # and drain. Its start() finds the dead child's
                # unterminated admits and captures the 'unclean_resume'
                # bundle this leg asserts on.
                p2 = subprocess.run(
                    _drive_argv(jd, ledger, 0, seed, device),
                    env=dict(env_base, GAUSS_FLIGHT_DIR=fdir), cwd=_REPO,
                    timeout=300, capture_output=True, text=True)
                leg["resume_rc"] = p2.returncode
                if p2.returncode != 0:
                    leg["stderr2"] = p2.stderr[-1500:]
                # An idempotent rerun of the SAME plan: everything already
                # terminal must dedupe, not re-solve.
                p3 = subprocess.run(
                    _drive_argv(jd, ledger, requests, seed, device),
                    env=env_base, cwd=_REPO, timeout=300,
                    capture_output=True, text=True)
                leg["rerun_rc"] = p3.returncode
                for line in p3.stdout.splitlines():
                    if line.startswith("DRIVE:"):
                        leg["rerun"] = json.loads(line[6:])
        leg["killed"] = killed
        leg["audit"] = audit(jd, _read_ledger(ledger), gate)
        # The post-mortem: a bundle captured for this leg's death that
        # ``obs.debug --check`` passes (integrity + exactly one cause).
        from gauss_tpu_torch.obs import debug as _debug
        from gauss_tpu_torch.obs import postmortem as _postmortem

        bundle = _postmortem.latest_bundle(
            _postmortem.default_bundles_dir(fdir))
        leg["bundle"] = bundle
        leg["bundle_check_rc"] = (_debug.main([bundle, "--check"])
                                  if bundle else None)
        leg["postmortem_ok"] = bundle is not None \
            and leg["bundle_check_rc"] == 0
        leg["wall_s"] = round(time.perf_counter() - t0, 3)
        a_ = leg["audit"]
        rerun = leg.get("rerun") or {}
        leg["outcome"] = (
            "violation" if (a_["missing"] or a_["duplicates"]
                            or a_["incorrect"] or not killed
                            or not leg["postmortem_ok"]
                            or rerun.get("solved_fresh", 0) > 0)
            else "ok")
        return leg

    plans = (("kill", "serve.server.batch=server_kill:skip=1", 10, False),
             ("torn",
              "serve.journal.append=journal_torn_write:skip=9:param=0.6", 8,
              False),
             ("supervised", "serve.server.batch=server_kill:skip=1", 10,
              True))
    with ThreadPoolExecutor(len(plans) if device == "cuda" else 1) as pool:
        legs = list(pool.map(lambda plan: _leg(*plan), plans))
    return {"ran": True, "legs": legs,
            "violations": sum(1 for leg in legs
                              if leg["outcome"] == "violation")}


def run_overhead_phase(seed: int, gate: float, tmpdir: str,
                       cache=None, device: str = "cuda") -> Dict:
    """The journal's cost, measured: one loadgen plan run journal-off then
    journal-on (same seed, same mix, shared executable cache so neither
    run pays a cache miss): seconds per request of each and their
    ratio."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.serve.loadgen import LoadgenConfig, run_load
    from gauss_tpu_torch.serve.server import SolverServer

    results = {}
    # Warm pass (unmeasured, journal off): both measured runs must see the
    # same fully-compiled executable cache, or run ORDER — not the journal
    # — dominates the ratio (observed 30x in the first draft of this
    # campaign: the off run paid every batch-shape compile).
    warm_cfg = LoadgenConfig(mix="random:24*2,random:30", requests=24,
                             warmup=4, mode="closed", concurrency=4,
                             seed=seed, verify_gate=gate,
                             serve=_case_config(None, gate, device))
    with obs.span("durable_overhead_warm"):
        with SolverServer(warm_cfg.serve, cache=cache) as srv:
            run_load(srv, warm_cfg)
    for label, jd in (("off", None),
                      ("on", os.path.join(tmpdir, "overhead-journal"))):
        cfg = LoadgenConfig(mix="random:24*2,random:30", requests=24,
                            warmup=4, mode="closed", concurrency=4,
                            seed=seed, verify_gate=gate,
                            request_ids=jd is not None,
                            serve=_case_config(jd, gate, device))
        with obs.span(f"durable_overhead_{label}"):
            with SolverServer(cfg.serve, cache=cache) as srv:
                summary = run_load(srv, cfg)
        results[label] = {
            "throughput_rps": summary["throughput_rps"],
            "s_per_request": (round(1.0 / summary["throughput_rps"], 6)
                              if summary["throughput_rps"] else None),
            "p50_s": summary["latency_s"]["p50"],
            "incorrect": summary["incorrect"],
        }
        if label == "on":
            results["journal"] = summary.get("journal")
    off, on = results["off"]["s_per_request"], results["on"]["s_per_request"]
    results["overhead_ratio"] = (round(on / off, 4)
                                 if off and on else None)
    return results


def history_records(summary: Dict) -> List[Tuple[str, float, str]]:
    """(metric, value, unit) records a campaign contributes to history
    (the JAX package's names), slow-side gated: recovery getting slower
    shows as s_per_case, the journal getting more expensive as
    journal_s_per_request (the on/off ratio stays in the summary: its
    sub-ms denominator jitters between epochs)."""
    out: List[Tuple[str, float, str]] = []
    wall, cases = summary.get("wall_s"), summary.get("cases")
    if isinstance(wall, (int, float)) and wall > 0 and cases:
        out.append(("durable:s_per_case", round(wall / cases, 6), "s"))
    on = ((summary.get("overhead") or {}).get("on") or {}).get(
        "s_per_request")
    if isinstance(on, (int, float)) and on > 0:
        out.append(("durable:journal_s_per_request", on, "s"))
    return out


# -- the self-driving server child (--drive) -------------------------------

def drive_main(args) -> int:
    """Subprocess worker mode: run a journaled server against a seeded
    request plan, appending to the client LEDGER as each submit returns —
    the client-side truth the campaign audits the journal against. With
    GAUSS_FAULTS armed, this process dies mid-load; rerun with the same
    seed it resubmits the same request_ids and reports how many deduped
    vs solved fresh."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.serve.server import SolverServer

    rng = np.random.default_rng(np.random.SeedSequence(
        (args.seed, 0xD21FE)))
    cfg = _case_config(args.journal, args.gate, args.device,
                       heartbeat_path=os.environ.get(
                           "GAUSS_SERVE_HEARTBEAT") or None,
                       flight_dir=os.environ.get("GAUSS_FLIGHT_DIR") or None)
    with obs.run(metrics_out=args.metrics_out, tool="durable_drive",
                 requests=args.requests, seed=args.seed):
        srv = SolverServer(cfg)
        srv.start()
        served_before = srv.requests_served
        handles = []
        with open(args.ledger, "a", buffering=1) as ledger:
            for j in range(args.requests):
                n = 16 + int(rng.integers(0, 13))
                a, b = _system(rng, n)
                rid = f"p{args.seed}-{j}"
                h = srv.submit(a, b, request_id=rid)
                # Ledger = freshly-ADMITTED requests only: a handle that is
                # already done at submit-return was rejected or answered
                # from the journal/pending dedupe (reruns), not admitted.
                if not h.done:
                    ledger.write(json.dumps({"rid": rid, "n": n}) + "\n")
                    ledger.flush()
                handles.append(h)
        deduped = 0
        for h in handles:
            res = h.result(timeout=180.0)
            if res.status is None:  # pragma: no cover
                return 3
        st = srv.journal.recovered
        for h in handles:
            if h.request_id in st.by_rid:
                deduped += 1
        srv.stop(drain=True, timeout=180.0)
        print("DRIVE:" + json.dumps({
            "requests": args.requests,
            "resume": srv.last_resume,
            "deduped": deduped,
            # fresh solves THIS incarnation (includes replays of a dead
            # predecessor's backlog; must be 0 on an idempotent rerun of a
            # fully-terminal plan)
            "solved_fresh": srv.requests_served - served_before,
        }))
    return 0


# -- campaign main ---------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.serve.durablecheck",
        description="Kill-the-server chaos campaign: crash/torn-write/"
                    "resume cases against the write-ahead request journal; "
                    "every admitted request must reach exactly one "
                    "terminal status (served results verified) with zero "
                    "duplicate solves under idempotent resubmission.")
    p.add_argument("--cases", type=int, default=28,
                   help="in-process recovery cases, cycled over kinds "
                        f"{CASE_KINDS} (default 28)")
    p.add_argument("--seed", type=int, default=258458)
    p.add_argument("--gate", type=float, default=1e-4)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the servers' device lanes run (default "
                        "cuda; cpu runs the kernels' plain versions)")
    p.add_argument("--tmpdir", default=None,
                   help="journal/ledger scratch directory (default: a new "
                        "temporary directory, removed at the end)")
    p.add_argument("--no-subprocess", action="store_true",
                   help="skip the real-kill subprocess legs (in-process "
                        "cases only)")
    p.add_argument("--no-overhead", action="store_true",
                   help="skip the journal-off vs journal-on overhead "
                        "measurement")
    p.add_argument("--metrics-out", default=None, metavar="PATH")
    p.add_argument("--summary-json", default=None, metavar="PATH")
    p.add_argument("--history", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="append campaign records to the regression history "
                        "(default reports/history_torch.jsonl)")
    p.add_argument("--regress-check", action="store_true",
                   help="gate against the history baselines (exit 1 when "
                        "out of band)")
    # -- the subprocess worker mode ---------------------------------------
    p.add_argument("--drive", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--journal", default=None, help=argparse.SUPPRESS)
    p.add_argument("--ledger", default=None, help=argparse.SUPPRESS)
    p.add_argument("--requests", type=int, default=10,
                   help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.drive:
        if not args.journal or not args.ledger:
            print("durablecheck --drive needs --journal and --ledger",
                  file=sys.stderr)
            return 2
        return drive_main(args)

    from gauss_tpu_torch.serve.cache import ExecutableCache
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)  # no card: RuntimeError, no fallback
    with tempfile.TemporaryDirectory(prefix="gauss_durable_") as scratch:
        tmpdir = args.tmpdir or scratch
        os.makedirs(tmpdir, exist_ok=True)
        # One executable cache across incarnations: the campaign measures
        # recovery, not the caches' first batches.
        cache = ExecutableCache(64, device=dev)
        summary = _campaign(args, tmpdir, cache)
    print(f"durable campaign: {summary['cases']} case(s) "
          f"({args.cases} in-process + "
          f"{len(summary['subprocess'].get('legs', ()))} subprocess), "
          f"{summary['admitted']} admitted request(s)")
    print(f"  terminals: {summary['statuses']} — {summary['replayed']} "
          f"replayed, {summary['expired_in_recovery']} expired-in-recovery, "
          f"{summary['deduped']} deduped resubmission(s), "
          f"{summary['torn_dropped']} torn record(s) dropped")
    for leg in summary["subprocess"].get("legs", ()):
        a_ = leg["audit"]
        print(f"  leg[{leg['leg']}]: {leg['outcome']} "
              f"killed={leg['killed']} admitted={a_['admitted']} "
              f"missing={len(a_['missing'])} "
              f"duplicates={len(a_['duplicates'])} "
              f"bundle={'ok' if leg.get('postmortem_ok') else 'MISSING'} "
              f"rerun={leg.get('rerun')}")
    overhead = summary["overhead"]
    if overhead:
        print(f"  overhead: journal-off {overhead['off']['s_per_request']}"
              f" s/req -> journal-on {overhead['on']['s_per_request']} "
              f"s/req (ratio {overhead['overhead_ratio']})")
    print(f"  invariant {'HOLDS' if summary['invariant_ok'] else 'VIOLATED'}"
          f" ({summary['wall_s']} s)")
    if args.summary_json:
        parent = os.path.dirname(args.summary_json)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"summary: {args.summary_json}")
    from gauss_tpu_torch.obs import regress

    rc = regress.gate(
        regress.campaign_records(history_records(summary), "durablecheck",
                                 "durable", regress.device_tag(args.device)),
        args.history, args.regress_check, healthy=summary["invariant_ok"])
    if not summary["invariant_ok"]:
        bad = summary["case_violations"]
        print(f"durablecheck: INVARIANT VIOLATED ({summary['violations']} "
              f"case(s))", file=sys.stderr)
        for o in bad[:5]:
            print(f"  case {o['case']} [{o['kind']}]: {o.get('error')}",
                  file=sys.stderr)
        return 2
    return rc


def _campaign(args, tmpdir: str, cache) -> Dict:
    """The recovery cases, the subprocess legs and the overhead leg; the
    summary (``kind: durable_campaign``)."""
    from gauss_tpu_torch import obs

    t0 = time.perf_counter()
    outcomes: List[Dict] = []
    with obs.run(metrics_out=args.metrics_out, tool="durable_campaign",
                 cases=args.cases, seed=args.seed):
        with obs.span("durable_recovery_phase", cases=args.cases):
            for i in range(args.cases):
                kind = CASE_KINDS[i % len(CASE_KINDS)]
                outcomes.append(run_recovery_case(
                    i, args.seed, args.gate, tmpdir, kind, cache=cache,
                    device=args.device))
                if (i + 1) % 8 == 0:
                    print(f"  recovery cases: {i + 1}/{args.cases}")
        sub = ({} if args.no_subprocess
               else run_subprocess_legs(args.seed, args.gate, tmpdir,
                                        device=args.device))
        overhead = ({} if args.no_overhead
                    else run_overhead_phase(args.seed, args.gate, tmpdir,
                                            cache=cache, device=args.device))
        wall = round(time.perf_counter() - t0, 3)
        admitted = sum(o["audit"]["admitted"] for o in outcomes)
        terminals = sum(o["audit"]["admitted"] - len(o["audit"]["missing"])
                        for o in outcomes)
        case_violations = [o for o in outcomes if o["outcome"] != "ok"]
        statuses: Dict[str, int] = {}
        for o in outcomes:
            for k, v in o["audit"]["statuses"].items():
                statuses[k] = statuses.get(k, 0) + v
        violations = (len(case_violations)
                      + (sub.get("violations", 0) if sub else 0))
        summary = {
            "kind": "durable_campaign", "seed": args.seed,
            "gate": args.gate, "device": args.device,
            "cases": args.cases + len(sub.get("legs", ())),
            "in_process_cases": args.cases,
            "admitted": admitted, "terminal_covered": terminals,
            "statuses": statuses,
            "replayed": sum(o.get("resume", {}).get("replayed", 0)
                            for o in outcomes),
            "expired_in_recovery": sum(
                o.get("resume", {}).get("expired", 0) for o in outcomes),
            "deduped": sum(o.get("deduped", 0) for o in outcomes),
            "torn_dropped": sum(o["audit"]["torn_dropped"]
                                for o in outcomes),
            "lost": sum(len(o["audit"]["missing"]) for o in outcomes)
            + sum(len(leg["audit"]["missing"])
                  for leg in sub.get("legs", ())),
            "duplicate_terminals": sum(
                len(o["audit"]["duplicates"]) for o in outcomes)
            + sum(len(leg["audit"]["duplicates"])
                  for leg in sub.get("legs", ())),
            "duplicate_solves": sum(o.get("dedupe_resolves", 0)
                                    for o in outcomes)
            + sum((leg.get("rerun") or {}).get("solved_fresh", 0)
                  for leg in sub.get("legs", ())),
            "unverified": sum(len(o["audit"]["incorrect"])
                              for o in outcomes)
            + sum(len(leg["audit"]["incorrect"])
                  for leg in sub.get("legs", ())),
            "case_violations": [
                {k: o.get(k) for k in ("case", "kind", "error")}
                for o in case_violations],
            "violations": violations,
            "subprocess": sub, "overhead": overhead, "wall_s": wall,
            "invariant_ok": violations == 0,
        }
        obs.emit("durable_campaign",
                 **{k: v for k, v in summary.items() if k != "kind"})
    return summary


if __name__ == "__main__":
    sys.exit(main())

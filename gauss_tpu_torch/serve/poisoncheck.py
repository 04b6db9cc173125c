"""The poison-the-server chaos campaign: ``python -m
gauss_tpu_torch.serve.poisoncheck`` (the port of
``gauss_tpu/serve/poisoncheck.py``; runs on ``cuda`` unless ``--device
cpu`` is given).

Asserts the poison-isolation invariant the admission scan
(:func:`gauss_tpu_torch.serve.admission.poison_scan`), batch bisection
(``SolverServer._serve_batched``), and the blame-journal quarantine
(:mod:`gauss_tpu_torch.serve.durable` blame records +
``ServeConfig.quarantine_deaths``) exist to provide:

    **a hostile request can cost the service AT MOST its own answer —
    every poison operand (non-finite entries, exactly-singular systems,
    torn wire payloads, kill-on-dispatch pills) draws EXACTLY ONE typed
    ``poison`` terminal, every innocent co-batched next to it is served
    and verified at the gate, no worker dies for it twice, and a
    journaled poison admit can never turn a restart into a crash loop.**

Phases:

- **isolation cases** (``--cases``, in-process, cycled over kinds):
  seeded poison-next-to-innocents scenarios against a live journaled
  :class:`SolverServer` — ``nan``/``inf`` (non-finite operands must be
  typed-rejected at admission, BEFORE the journal admit: a poison the
  journal never saw cannot crash-loop a replay), ``singular`` (an
  exactly-singular system admits finitely, fails the batched verify, and
  must surface the host ladder's :class:`SingularSystemError` verdict as
  a typed poison terminal — never a generic failure, never a worker
  death), ``bisect`` (a batch member that makes the whole batched
  dispatch raise: bisection must isolate it in O(log B) re-dispatches,
  re-serve every innocent under its ORIGINAL journal id and deadline,
  and type only the hunted singleton). Every case ends with a raw-line
  journal audit: one terminal per admitted rid, poison rids typed,
  nan/inf rids absent (rejected pre-admit).
- **mesh leg** (``--mesh``): the same nan/singular mix through
  ``lanes=2`` dispatch lanes. It needs ``serve/lanes``, which follows the
  distributed plane (ROADMAP queue-1 items 10 and 11): the port runs it
  only if asked, and then exits 2 naming that item. ``--no-mesh`` is the
  default, the configuration the port's tests and ``chip_smoke.py`` run.
- **replica leg**: a real 3-replica router under concurrent network
  load with nan/singular poison in the mix (typed ``poison`` results
  ride the 400 lane back through the router proxy), plus torn WIRE
  payloads (truncated JSON, truncated base64 operand) that must be 400s
  — and after all of it, zero replica restarts: poison never kills a
  worker.
- **crash-loop leg** (subprocess): a kill-on-dispatch pill — a healthy
  admit whose dispatch tears the journal mid-append and dies
  (``journal_torn_write``) — re-armed for FOUR incarnations. Blame
  records (one distinct boot per death) must quarantine the rid at
  ``quarantine_deaths`` deaths: incarnations 1-2 die, incarnation 3
  replays the rid SOLO on the host ladder and survives with the fault
  still armed, incarnation 4 replays nothing. Three restarts, one ``ok``
  terminal, loop broken.
- **supervised leg**: the same pill under
  :func:`gauss_tpu_torch.serve.durable.supervise` with ``max_restarts=0`` —
  the quarantined death must respawn WITHOUT charging the restart
  budget (a budget of zero only survives if the charge never lands).

Every server, child and replica runs on ``--device``. The summary is
regress-ingestable (``kind: poison_campaign``); ``--history`` and
``--regress-check`` use the port's own history (``obs.regress``, each
record stamped with its device). ``--tmpdir`` defaults to a new temporary
directory, removed at the end. Exit 2 when the invariant is violated
(innocent casualty, unverified serve, untyped culprit, duplicate
terminal, crash loop, charged quarantine) or the mesh leg is asked for, 1
when ``--regress-check`` finds an out-of-band metric, 0 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

POISON_KINDS = ("nan", "inf", "singular", "bisect")
#: what the mesh leg waits for
MESH_PENDING = ("the mesh leg needs serve/lanes, which follows the "
                "distributed plane (ROADMAP queue-1 items 10 and 11)")

#: finite sentinel the ``bisect`` kind plants at a[0,0]: invisible to the
#: admission scan (finite), fatal to the tripwired executable below — the
#: stand-in for "this member makes the batched dispatch raise".
SENTINEL = 777.0

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _fresh_dir(path: str) -> str:
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)
    return path


def _system(rng: np.random.Generator, n: int):
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a, rng.standard_normal(n)


def poison_system(rng: np.random.Generator, n: int, kind: str):
    """A seeded system carrying one poison of ``kind``. ``singular`` zeroes
    a full row (b kept nonzero — inconsistent, rank-deficient): LAPACK
    reports it exactly and the batched LU cannot produce a finite
    accidental answer for it."""
    a, b = _system(rng, n)
    if kind == "nan":
        a[0, 0] = np.nan
    elif kind == "inf":
        a[0, 0] = np.inf
    elif kind == "singular":
        a[n // 2, :] = 0.0
        b[n // 2] = 1.0
    elif kind == "bisect":
        a[0, 0] = SENTINEL
    else:  # pragma: no cover — campaign-internal
        raise ValueError(f"unknown poison kind {kind!r}")
    return a, b


def _case_config(journal_dir: Optional[str], gate: float,
                 device: str = "cuda", **over):
    from gauss_tpu_torch.serve.admission import ServeConfig

    kw = dict(ladder=(32,), max_batch=4, panel=16, refine_steps=1,
              verify_gate=gate, journal_dir=journal_dir,
              journal_fsync_batch=4, max_queue=256, device=device)
    kw.update(over)
    return ServeConfig(**kw)


class _TrippingExecutable:
    """Delegates to the real batched executable unless the padded operand
    stack contains the SENTINEL pill — then raises the deterministic
    (non-transient) error batch bisection exists to localize."""

    def __init__(self, exe):
        self._exe = exe

    def solve(self, a_pad, b_pad):
        if np.any(a_pad[:, 0, 0] == SENTINEL):
            raise ValueError("sentinel poison member in batch")
        return self._exe.solve(a_pad, b_pad)

    def __getattr__(self, name):
        return getattr(self._exe, name)


class _TrippingCache:
    """ExecutableCache wrapper returning tripwired executables (shared
    inner cache: the campaign measures isolation, not the caches' first
    batches)."""

    def __init__(self, inner):
        self._inner = inner

    def get(self, key, panel=None):
        return _TrippingExecutable(self._inner.get(key, panel=panel))

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _residual_ok(a, x, b, gate: float) -> bool:
    from gauss_tpu_torch.verify import checks

    rel = checks.residual_norm(a, x, b, relative=True)
    return bool(np.isfinite(rel) and rel <= gate)


def journal_records(journal_dirs: List[str]
                    ) -> Tuple[Dict[str, Dict], Dict[str, List[Dict]]]:
    """(admits_by_rid, terminals_by_rid) from RAW segment lines across a
    set of journal dirs — raw so duplicate terminals (the violation the
    scanner's keyed state would hide) stay visible."""
    from gauss_tpu_torch.serve import durable

    admits: Dict[str, Dict] = {}
    terms: Dict[str, List[Dict]] = {}
    for jd in journal_dirs:
        if not jd or not os.path.isdir(jd):
            continue
        for seg in durable.segment_paths(jd):
            with open(seg, "rb") as f:
                for line in f.read().split(b"\n"):
                    if not line:
                        continue
                    doc = durable.decode_line(line + b"\n")
                    if doc is None:
                        continue
                    rid = doc.get("rid")
                    if not rid:
                        continue
                    if doc.get("rec") == "admit":
                        admits.setdefault(rid, doc)
                    elif doc.get("rec") == "terminal":
                        terms.setdefault(rid, []).append(doc)
    return admits, terms


def check_verdicts(journal_dirs: List[str], innocents, culprits,
                   results: Dict[str, Any], gate: float) -> List[str]:
    """The per-case invariant, judged from the client results AND the raw
    journal: every innocent ok + verified + exactly one ok terminal;
    every culprit exactly one typed poison terminal (nan/inf culprits are
    rejected BEFORE the admit — they must be absent from the journal
    entirely)."""
    admits, terms = journal_records(journal_dirs)
    bad: List[str] = []
    for rid, (a, b) in innocents.items():
        res = results.get(rid)
        if res is None or res.status != "ok":
            bad.append(f"innocent {rid}: status="
                       f"{getattr(res, 'status', None)} "
                       f"error={getattr(res, 'error', None)}")
            continue
        if res.x is None or not _residual_ok(a, res.x, b, gate):
            bad.append(f"innocent {rid}: unverified at {gate}")
        n_terms = len(terms.get(rid, ()))
        if rid in admits and n_terms != 1:
            bad.append(f"innocent {rid}: {n_terms} journal terminals")
    for rid, kind in culprits.items():
        res = results.get(rid)
        if res is None or res.status != "poison" or not res.error:
            bad.append(f"culprit {rid} [{kind}]: status="
                       f"{getattr(res, 'status', None)} "
                       f"error={getattr(res, 'error', None)}")
            continue
        if kind in ("nan", "inf"):
            # Scan precedes the journal admit: a non-finite poison must
            # leave NO journal record — nothing for a replay to chew on.
            if rid in admits or rid in terms:
                bad.append(f"culprit {rid} [{kind}]: journaled pre-scan")
        else:
            tl = terms.get(rid, ())
            if len(tl) != 1 or tl[0].get("status") != "poison":
                bad.append(f"culprit {rid} [{kind}]: terminals="
                           f"{[t.get('status') for t in tl]}")
    return bad


# -- in-process isolation cases --------------------------------------------

def run_case(i: int, seed: int, gate: float, tmpdir: str, kind: str,
             cache=None, device: str = "cuda") -> Dict:
    """One poison-next-to-innocents case; returns its outcome record."""
    from gauss_tpu_torch.serve.server import SolverServer

    rng = np.random.default_rng(np.random.SeedSequence((seed, i, 0xB15)))
    jd = os.path.join(_fresh_dir(os.path.join(
        tmpdir, f"case-{kind}-{i:03d}")), "journal")
    out: Dict = {"case": i, "kind": kind}
    over: Dict[str, Any] = {}
    if kind == "bisect":
        # The pill only meets its batch-mates if they form ONE batch: hold
        # the dispatch long enough for all four submits to co-batch.
        over["batch_linger_s"] = 0.25
    innocents: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    culprits: Dict[str, str] = {}
    results: Dict[str, Any] = {}
    srv = SolverServer(_case_config(jd, gate, device, **over), cache=cache)
    srv.start()
    try:
        n_inno = 3 if kind == "bisect" else 4 + int(rng.integers(0, 3))
        handles = []
        plan: List[Tuple[str, str]] = [("innocent", f"i{j}")
                                       for j in range(n_inno)]
        plan.insert(int(rng.integers(0, n_inno + 1)), (kind, "pill"))
        for tag, label in plan:
            n = int(rng.integers(8, 29))
            rid = f"p{seed}-{i}-{label}"
            if tag == "innocent":
                a, b = _system(rng, n)
                innocents[rid] = (a, b)
            else:
                a, b = poison_system(rng, n, kind)
                culprits[rid] = kind
            handles.append((rid, srv.submit(a, b, request_id=rid)))
        for rid, h in handles:
            results[rid] = h.result(timeout=120.0)
    finally:
        srv.stop(drain=True, timeout=120.0)
    bad = check_verdicts([jd], innocents, culprits, results, gate)
    out["requests"] = len(results)
    out["innocents"] = len(innocents)
    out["outcome"] = "violation" if bad else "ok"
    if bad:
        out["error"] = "; ".join(bad[:4])
    return out


# -- replica leg -----------------------------------------------------------

def _router_config(root: str, replicas: int, gate: float,
                   device: str = "cuda", **over):
    from gauss_tpu_torch.serve.router import RouterConfig

    kw = dict(replicas=replicas, dir=root, ladder=(32,), max_batch=4,
              verify_gate=gate, max_restarts=3, poll_s=0.1,
              stall_after_s=30.0, device=device)
    kw.update(over)
    return RouterConfig(**kw)


def _net_load(client, mats, rids: List[str]) -> Dict[str, Any]:
    results: Dict[str, Any] = {}
    lock = threading.Lock()

    def _one(idx: int) -> None:
        a, b = mats[idx]
        res = client.solve(a, b, deadline_s=120.0, request_id=rids[idx])
        with lock:
            results[rids[idx]] = res

    threads = [threading.Thread(target=_one, args=(i,))
               for i in range(len(rids))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    return results


def _raw_post(url: str, body: bytes) -> int:
    """POST raw bytes, returning the HTTP status (4xx/5xx included)."""
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def run_replica_leg(seed: int, gate: float, tmpdir: str,
                    device: str = "cuda", log=print) -> Dict:
    """3 replicas behind the router under concurrent load with poison in
    the mix: typed ``poison`` results ride the 400 lane back through the
    proxy, torn WIRE payloads are 400s, and — the point — zero replica
    deaths and zero restart-budget spend for any of it."""
    import glob

    from gauss_tpu_torch.serve import durable
    from gauss_tpu_torch.serve.net import SolveClient
    from gauss_tpu_torch.serve.router import Router

    rng = np.random.default_rng(np.random.SeedSequence((seed, 0x4E7)))
    root = _fresh_dir(os.path.join(tmpdir, "leg-replica"))
    leg: Dict = {"leg": "replica"}
    innocents: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    culprits: Dict[str, str] = {}
    mats, rids = [], []
    for j in range(9):
        a, b = _system(rng, int(rng.integers(8, 29)))
        rid = f"r{seed}-i{j}"
        innocents[rid] = (a, b)
        mats.append((a, b))
        rids.append(rid)
    for kind in ("nan", "singular"):
        a, b = poison_system(rng, int(rng.integers(8, 29)), kind)
        rid = f"r{seed}-{kind}"
        culprits[rid] = kind
        mats.append((a, b))
        rids.append(rid)
    t0 = time.perf_counter()
    with Router(_router_config(root, 3, gate, device)) as router:
        client = SolveClient(router.url, timeout_s=180.0, wait_s=5.0,
                             seed=seed)
        results = _net_load(client, mats, rids)
        # Torn wire payloads against the proxied solve path: a truncated
        # JSON body and a truncated base64 operand — both must be typed
        # 400s, neither may cost a worker.
        a, b = _system(rng, 12)
        doc = {"schema": 1, "a": durable.encode_array(a),
               "b": durable.encode_array(b), "request_id": f"r{seed}-torn"}
        whole = json.dumps(doc).encode()
        leg["torn_json_http"] = _raw_post(router.url + "/v1/solve",
                                          whole[:len(whole) // 2])
        doc["a"]["b64"] = doc["a"]["b64"][:-3]
        leg["torn_b64_http"] = _raw_post(router.url + "/v1/solve",
                                         json.dumps(doc).encode())
        stats = router.stats()
        live = router.live_replicas()
        leg["replicas_live"] = sum(1 for rp in live.values()
                                   if rp.proc.poll() is None)
        leg["restarts_used"] = stats["restarts_used"]
        jdirs = []
        for rdir in router.replica_dirs():
            jdirs.extend(sorted(glob.glob(os.path.join(rdir, "journal*"))))
        router.stop(drain=True)
    bad = check_verdicts(jdirs, innocents, culprits, results, gate)
    if leg["torn_json_http"] != 400:
        bad.append(f"torn JSON body -> {leg['torn_json_http']}, want 400")
    if leg["torn_b64_http"] != 400:
        bad.append(f"torn base64 operand -> {leg['torn_b64_http']}, "
                   f"want 400")
    if leg["restarts_used"] != 0:
        bad.append(f"poison load spent {leg['restarts_used']} restart(s)")
    if leg["replicas_live"] != 3:
        bad.append(f"only {leg['replicas_live']}/3 replicas alive")
    leg["requests"] = len(results)
    leg["wall_s"] = round(time.perf_counter() - t0, 3)
    leg["outcome"] = "violation" if bad else "ok"
    if bad:
        leg["error"] = "; ".join(bad[:4])
    return leg


# -- crash-loop + supervised legs (subprocess) -----------------------------

def _drive_argv(journal: str, requests: int, seed: int, gate: float,
                k_deaths: int, device: str = "cuda") -> List[str]:
    return [sys.executable, "-m", "gauss_tpu_torch.serve.poisoncheck",
            "--drive", "--journal", journal, "--requests", str(requests),
            "--seed", str(seed), "--gate", str(gate),
            "--k-deaths", str(k_deaths), "--device", device]


def _torn_fault(skip: int) -> str:
    return (f"serve.journal.append=journal_torn_write:skip={skip}"
            f":param=0.6")


def _env_base() -> Dict[str, str]:
    return {k: v for k, v in os.environ.items() if k != "GAUSS_FAULTS"}


def _audit_pill(jd: str, rid: str, gate: float) -> List[str]:
    """The pill is a HEALTHY request implicated only by crashes: across
    every incarnation it must hold exactly one ``ok`` terminal, verified
    from the journaled operands."""
    from gauss_tpu_torch.serve import durable

    admits, terms = journal_records([jd])
    tl = terms.get(rid, ())
    if len(tl) != 1 or tl[0].get("status") != "ok":
        return [f"pill {rid}: terminals="
                f"{[t.get('status') for t in tl]}, want one ok"]
    adm = admits.get(rid)
    if adm is None or tl[0].get("x") is None:
        return [f"pill {rid}: missing admit or solution"]
    a = durable.decode_array(adm["a"])
    b = durable.decode_array(adm["b"])
    if adm.get("was_vector"):
        b = b.reshape(-1)
    x = durable.decode_array(tl[0]["x"])
    if not _residual_ok(a, x, b, gate):
        return [f"pill {rid}: unverified at {gate}"]
    return []


def run_crashloop_leg(seed: int, gate: float, tmpdir: str,
                      device: str = "cuda", log=print) -> Dict:
    """The kill-on-dispatch pill, fault RE-ARMED every incarnation (the
    adversarial case supervise's fault-stripping cannot reach): with
    ``quarantine_deaths=2``, incarnations 1-2 tear the terminal append
    and die (one blame boot each), incarnation 3 must quarantine the rid
    — solo host-ladder execution clears it WITH THE FAULT STILL ARMED —
    and incarnation 4 must replay nothing. The loop is broken by
    evidence, not by luck."""
    from gauss_tpu_torch.resilience.inject import KILL_EXIT_CODE

    jd = os.path.join(_fresh_dir(os.path.join(tmpdir, "leg-crashloop")),
                      "journal")
    leg: Dict = {"leg": "crashloop"}
    rid = f"q{seed}-0"
    env_base = _env_base()
    t0 = time.perf_counter()
    incs: List[Dict] = []
    # skip counts journal appends before the tear fires. Incarnation 1
    # appends admit, blame, terminal -> skip=2 tears the terminal;
    # incarnation 2 replays (no new admit): blame, terminal -> skip=1
    # tears the terminal again; incarnations 3-4 run under skip=3 with
    # fewer than four appends — armed, never reached.
    for idx, skip in enumerate((2, 1, 3, 3)):
        env = dict(env_base)
        env["GAUSS_FAULTS"] = _torn_fault(skip)
        p = subprocess.run(_drive_argv(jd, 1, seed, gate, k_deaths=2,
                                       device=device),
                           env=env, cwd=_REPO, timeout=300,
                           capture_output=True, text=True)
        inc: Dict = {"rc": p.returncode, "skip": skip}
        for line in p.stdout.splitlines():
            if line.startswith("DRIVE:"):
                inc["drive"] = json.loads(line[6:])
        if p.returncode not in (0, KILL_EXIT_CODE):
            inc["stderr"] = p.stderr[-1500:]
        incs.append(inc)
        log(f"  crashloop: incarnation {idx + 1} (skip={skip}) "
            f"rc={p.returncode}")
    leg["incarnations"] = incs
    bad: List[str] = []
    want_rcs = [KILL_EXIT_CODE, KILL_EXIT_CODE, 0, 0]
    got_rcs = [inc["rc"] for inc in incs]
    if got_rcs != want_rcs:
        bad.append(f"incarnation rcs {got_rcs}, want {want_rcs}")
    else:
        d3 = incs[2].get("drive") or {}
        if (d3.get("resume") or {}).get("quarantined") != 1:
            bad.append(f"incarnation 3 did not quarantine the pill: "
                       f"resume={d3.get('resume')}")
        if (d3.get("statuses") or {}).get(rid) != "ok":
            bad.append(f"quarantined solo replay: statuses="
                       f"{d3.get('statuses')}, want {rid} ok")
        d4 = incs[3].get("drive") or {}
        if (d4.get("resume") or {}).get("replayed", 0) != 0 \
                or d4.get("solved_fresh", 0) != 0:
            bad.append(f"incarnation 4 not idempotent: {d4}")
    bad += _audit_pill(jd, rid, gate)
    leg["wall_s"] = round(time.perf_counter() - t0, 3)
    leg["outcome"] = "violation" if bad else "ok"
    if bad:
        leg["error"] = "; ".join(bad[:4])
    return leg


def run_supervised_leg(seed: int, gate: float, tmpdir: str,
                       device: str = "cuda", log=print) -> Dict:
    """The pill under the durable supervisor with a restart budget of
    ZERO: the torn-dispatch death leaves fresh blame evidence, so the
    respawn must be quarantined (uncharged) — a charged death would make
    supervise give up, so ``rc == 0`` IS the budget assertion."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.serve import durable

    root = _fresh_dir(os.path.join(tmpdir, "leg-supervised"))
    jd = os.path.join(root, "journal")
    leg: Dict = {"leg": "supervised"}
    rid = f"q{seed + 1}-0"
    env = _env_base()
    env["GAUSS_FAULTS"] = _torn_fault(2)
    rec = obs.active()
    before_q = (rec.counters.get("serve.quarantined_respawns", 0)
                if rec else 0)
    before_r = (rec.counters.get("serve.supervisor_restarts", 0)
                if rec else 0)
    t0 = time.perf_counter()
    rc = durable.supervise(
        _drive_argv(jd, 1, seed + 1, gate, k_deaths=1, device=device),
        heartbeat_path=os.path.join(root, "heartbeat.json"),
        max_restarts=0, stall_after_s=60.0, env=env, log=log,
        flight_dir=os.path.join(root, "flight"), journal_dir=jd,
        quarantine_deaths=1)
    leg["supervise_rc"] = rc
    leg["quarantined_respawns"] = (
        (rec.counters.get("serve.quarantined_respawns", 0) if rec else 0)
        - before_q)
    leg["charged_restarts"] = (
        (rec.counters.get("serve.supervisor_restarts", 0) if rec else 0)
        - before_r)
    bad: List[str] = []
    if rc != 0:
        bad.append(f"supervise rc={rc} with max_restarts=0 — the "
                   f"quarantined death charged the budget")
    if leg["quarantined_respawns"] != 1:
        bad.append(f"quarantined respawns = "
                   f"{leg['quarantined_respawns']}, want 1")
    if leg["charged_restarts"] != 0:
        bad.append(f"charged restarts = {leg['charged_restarts']}, want 0")
    bad += _audit_pill(jd, rid, gate)
    leg["wall_s"] = round(time.perf_counter() - t0, 3)
    leg["outcome"] = "violation" if bad else "ok"
    if bad:
        leg["error"] = "; ".join(bad[:4])
    return leg


def history_records(summary: Dict) -> List[Tuple[str, float, str]]:
    """(metric, value, unit) records the campaign contributes to history.
    Slow-side gated: poison isolation getting slower (bisection waves,
    quarantine replays) shows up as s_per_case."""
    out: List[Tuple[str, float, str]] = []
    wall, cases = summary.get("wall_s"), summary.get("cases")
    if isinstance(wall, (int, float)) and wall > 0 and cases:
        out.append(("poison:s_per_case", round(wall / cases, 6), "s"))
    return out


# -- the self-driving server child (--drive) -------------------------------

def drive_main(args) -> int:
    """Subprocess worker mode: a journaled quarantine-enabled server fed
    a seeded HEALTHY plan under rid dedupe. With a torn-write fault
    armed, this process dies mid-dispatch; rerun against the same journal
    it replays — and once the blame evidence reaches ``--k-deaths``, the
    replay runs the implicated rid solo on the host ladder."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.serve.server import SolverServer

    rng = np.random.default_rng(np.random.SeedSequence((args.seed, 0xD21)))
    cfg = _case_config(args.journal, args.gate, args.device, max_batch=1,
                       quarantine_deaths=args.k_deaths,
                       heartbeat_path=os.environ.get(
                           "GAUSS_SERVE_HEARTBEAT") or None,
                       flight_dir=os.environ.get("GAUSS_FLIGHT_DIR") or None)
    with obs.run(metrics_out=args.metrics_out, tool="poison_drive",
                 requests=args.requests, seed=args.seed):
        srv = SolverServer(cfg)
        srv.start()  # replay FIRST: submits below dedupe against it
        served_before = srv.requests_served
        handles = []
        for j in range(args.requests):
            a, b = _system(rng, 24)
            handles.append((f"q{args.seed}-{j}",
                            srv.submit(a, b, request_id=f"q{args.seed}-{j}")))
        statuses = {}
        for rid, h in handles:
            res = h.result(timeout=180.0)
            statuses[rid] = res.status if res is not None else None
        srv.stop(drain=True, timeout=180.0)
        print("DRIVE:" + json.dumps({
            "requests": args.requests,
            "resume": srv.last_resume,
            "statuses": statuses,
            "solved_fresh": srv.requests_served - served_before,
        }))
    return 0


# -- campaign main ---------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.serve.poisoncheck",
        description="Poison-the-server chaos campaign: non-finite/"
                    "singular/batch-pill/torn-wire poison next to "
                    "innocent traffic; every culprit must draw exactly "
                    "one typed poison terminal, every innocent must be "
                    "served and verified, and a journaled poison admit "
                    "must never crash-loop a restart.")
    p.add_argument("--cases", type=int, default=28,
                   help="in-process isolation cases, cycled over kinds "
                        f"{POISON_KINDS} (default 28)")
    p.add_argument("--seed", type=int, default=777201)
    p.add_argument("--gate", type=float, default=1e-4)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the servers, children and replicas run "
                        "(default cuda; cpu runs the kernels' plain "
                        "versions)")
    p.add_argument("--tmpdir", default=None,
                   help="journal/replica scratch directory (default: a new "
                        "temporary directory, removed at the end)")
    p.add_argument("--mesh", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="the lanes=2 mesh leg (refused with exit 2: "
                        + MESH_PENDING + "; default --no-mesh)")
    p.add_argument("--no-subprocess", action="store_true",
                   help="skip the crash-loop/supervised subprocess legs "
                        "and the 3-replica leg (in-process cases only)")
    p.add_argument("--metrics-out", default=None, metavar="PATH")
    p.add_argument("--summary-json", default=None, metavar="PATH")
    p.add_argument("--history", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="append campaign records to the regression history "
                        "(default reports/history_torch.jsonl)")
    p.add_argument("--regress-check", action="store_true")
    # -- the subprocess worker mode ---------------------------------------
    p.add_argument("--drive", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--journal", default=None, help=argparse.SUPPRESS)
    p.add_argument("--requests", type=int, default=1,
                   help=argparse.SUPPRESS)
    p.add_argument("--k-deaths", type=int, default=2, dest="k_deaths",
                   help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.drive:
        if not args.journal:
            print("poisoncheck --drive needs --journal", file=sys.stderr)
            return 2
        return drive_main(args)
    if args.mesh:
        print(f"poisoncheck: --mesh: {MESH_PENDING}", file=sys.stderr)
        return 2

    from gauss_tpu_torch.obs import regress
    from gauss_tpu_torch.serve.cache import ExecutableCache
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)  # no card: RuntimeError, no fallback
    with tempfile.TemporaryDirectory(prefix="gauss_poison_") as scratch:
        tmpdir = args.tmpdir or scratch
        os.makedirs(tmpdir, exist_ok=True)
        # One executable cache across the cases: the campaign measures
        # isolation, not the caches' first batches.
        summary = _campaign(args, tmpdir,
                            _TrippingCache(ExecutableCache(64, device=dev)))
    legs = summary["legs"]
    violations = summary["violations"]
    print(f"poison campaign: {args.cases} isolation case(s) + "
          f"{len(legs)} leg(s), {summary['requests']} request(s) "
          f"({summary['innocents']} innocents) on {args.device}")
    print(f"  poisoned: {summary['poisoned']} typed terminal(s), "
          f"{summary['bisections']} bisection(s), "
          f"{summary['nonfinite_rescues']} non-finite rescue(s)")
    for leg in legs:
        print(f"  leg[{leg['leg']}]: {leg['outcome']}"
              + (f" — {leg['error']}" if leg.get("error") else ""))
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

    rc = regress.gate(
        regress.campaign_records(history_records(summary), "poisoncheck",
                                 "poison", regress.device_tag(args.device)),
        args.history, args.regress_check, healthy=not violations)
    if violations:
        print(f"poisoncheck: INVARIANT VIOLATED ({violations} case(s))",
              file=sys.stderr)
        for o in summary["case_violations"][:5]:
            print(f"  case {o['case']} [{o['kind']}]: {o.get('error')}",
                  file=sys.stderr)
        for leg in legs:
            if leg["outcome"] == "violation":
                print(f"  leg [{leg['leg']}]: {leg.get('error')}",
                      file=sys.stderr)
        return 2
    return rc


def _campaign(args, tmpdir: str, cache) -> Dict:
    """The isolation cases and the legs; the summary (``kind:
    poison_campaign``)."""
    from gauss_tpu_torch import obs

    t0 = time.perf_counter()
    outcomes: List[Dict] = []
    with obs.run(metrics_out=args.metrics_out, tool="poison_campaign",
                 cases=args.cases, seed=args.seed):
        with obs.span("poison_isolation_phase", cases=args.cases):
            for i in range(args.cases):
                kind = POISON_KINDS[i % len(POISON_KINDS)]
                outcomes.append(run_case(i, args.seed, args.gate, tmpdir,
                                         kind, cache=cache,
                                         device=args.device))
                if (i + 1) % 8 == 0:
                    print(f"  isolation cases: {i + 1}/{args.cases}")
        legs: List[Dict] = []
        if not args.no_subprocess:
            with obs.span("poison_leg_phase"):
                for leg in (run_replica_leg, run_crashloop_leg,
                            run_supervised_leg):
                    legs.append(leg(args.seed, args.gate, tmpdir,
                                    device=args.device))
        wall = round(time.perf_counter() - t0, 3)

        rec = obs.active()
        counters = dict(rec.counters) if rec else {}
        requests = sum(o.get("requests", 0) for o in outcomes) + \
            sum(leg.get("requests", 0) for leg in legs)
        innocents = sum(o.get("innocents", 0) for o in outcomes)
        case_violations = [o for o in outcomes if o["outcome"] != "ok"]
        leg_violations = [leg for leg in legs
                          if leg["outcome"] == "violation"]
        violations = len(case_violations) + len(leg_violations)
        # A crash loop = the crashloop/supervised legs failing to converge
        crash_loops = sum(1 for leg in leg_violations
                          if leg["leg"] in ("crashloop", "supervised"))
        summary = {
            "kind": "poison_campaign", "seed": args.seed,
            "gate": args.gate, "device": args.device,
            "cases": args.cases + len(legs),
            "in_process_cases": args.cases, "requests": requests,
            "innocents": innocents,
            "innocents_verified": innocents - sum(
                1 for o in case_violations if "innocent" in
                (o.get("error") or "")),
            "culprits": args.cases + 2 * len(
                [leg for leg in legs if leg["leg"] == "replica"]),
            "culprits_typed": args.cases - len(case_violations),
            "bisections": counters.get("serve.bisections", 0),
            "nonfinite_rescues": counters.get("serve.nonfinite_rescues", 0),
            "poisoned": counters.get("serve.poisoned", 0),
            "case_violations": [
                {k: o.get(k) for k in ("case", "kind", "error")}
                for o in case_violations],
            "legs": legs, "wall_s": wall,
            "violations": violations, "crash_loops": crash_loops,
            "invariant_ok": violations == 0,
        }
        obs.emit("poison_campaign",
                 **{k: v for k, v in summary.items() if k != "kind"})
    return summary


if __name__ == "__main__":
    sys.exit(main())

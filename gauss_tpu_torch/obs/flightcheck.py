"""The flight recorder's end-to-end gate (the port of
``gauss_tpu/obs/flightcheck.py``).

``python -m gauss_tpu_torch.obs.flightcheck [--device cpu] [--summary-json PATH]``

Three legs, exit 2 on any invariant failure; the servers run on
``--device`` (default ``cuda``):

1. **Kill mid-load** (skipped by ``--no-subprocess``): a journaled,
   flight-recording server child (``--drive``) is killed with a REAL
   ``SIGKILL`` (kill -9, not ``os._exit``) once its ring shows enough
   dispatched batches; the resume run's ``unclean_resume`` capture must
   leave a bundle from which ``obs.debug``/:func:`reconstruct` recovers
   the final >= :data:`MIN_BATCHES` batches whose trace ids all
   cross-check against the journal's own records, and whose in-flight
   request set equals the journal's unterminated admits EXACTLY (judged
   against an independent scan taken before the resume run could replay
   them).
2. **Torn tail at every offset**: a ring is written, then for EVERY byte
   offset of its data region the file is truncated-at-offset (zeros
   after — the state a kill mid-write leaves) and re-scanned; the scan
   must never raise and must recover exactly the records fully written
   before the offset — the reader-owns-integrity contract, exhaustively.
3. **Overhead** (``--no-overhead`` to skip): one loadgen plan run
   flight-off then flight-on (same seed, shared executable cache, warm
   pass first); the flight-on seconds-per-request enters history
   (``flight:ring_s_per_request``) and is regress-gated like any perf
   metric.

The summary is regress-ingestable (``kind: flight_check``); ``--history``
and ``--regress-check`` use the port's own history (``obs.regress``, each
record stamped with its device). ``--tmpdir`` defaults to a new temporary
directory, removed at the end. Exit 2 on an invariant failure, 1 when
``--regress-check`` finds an out-of-band metric, 0 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the acceptance bar: the bundle must reconstruct at least this many of
#: the dead process's final batches, with trace ids intact
MIN_BATCHES = 5
#: batches that must be visible in the ring before the SIGKILL lands —
#: comfortably past MIN_BATCHES so the reconstruction bar has margin
KILL_AFTER_BATCHES = MIN_BATCHES + 2


def _system(rng: np.random.Generator, n: int):
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a, rng.standard_normal(n)


# -- leg 1: SIGKILL mid-load -> bundle -> timeline -------------------------

def _drive_argv(journal: str, flight: str, requests: int, seed: int,
                device: str = "cuda") -> List[str]:
    return [sys.executable, "-m", "gauss_tpu_torch.obs.flightcheck",
            "--drive", "--journal", journal, "--flight", flight,
            "--requests", str(requests), "--seed", str(seed),
            "--device", device]


def _ring_batches(flight_dir: str) -> int:
    """serve_batch events currently recoverable from the dir's rings."""
    from gauss_tpu_torch.obs import flight

    return sum(1 for r in flight.scan_dir(flight_dir)
               for ev in r["events"] if ev.get("type") == "serve_batch")


def run_kill_leg(seed: int, gate: float, tmpdir: str,
                 requests: int = 80, attempts: int = 3,
                 device: str = "cuda", delay_s: Optional[float] = None,
                 log=print) -> Dict:
    """SIGKILL a flight-recording server mid-load; the resume run's
    ``unclean_resume`` bundle must reconstruct the death. Retries when the
    kill raced the drain (the child finished first) — the leg proves a
    MID-LOAD kill, not a lucky clean exit. ``delay_s`` injects that many
    seconds before each of the killed child's batches
    (``serve.worker.dispatch``), so that a device that serves the whole
    plan faster than the ring is polled still dies mid-load."""
    from gauss_tpu_torch.obs import debug as _gdebug
    from gauss_tpu_torch.obs import postmortem as _postmortem
    from gauss_tpu_torch.serve import durable

    env = {k: v for k, v in os.environ.items() if k != "GAUSS_FAULTS"}
    leg: Dict = {"leg": "kill", "attempts": 0}
    t0 = time.perf_counter()
    for attempt in range(attempts):
        leg["attempts"] = attempt + 1
        jd = os.path.join(tmpdir, f"kill-{attempt}.journal")
        fdir = os.path.join(tmpdir, f"kill-{attempt}.flight")
        # A previous run's ring/journal here would satisfy the kill
        # condition instantly and hand the leg a stale bundle — every
        # attempt starts from a clean scene.
        shutil.rmtree(jd, ignore_errors=True)
        shutil.rmtree(fdir, ignore_errors=True)
        proc = subprocess.Popen(
            _drive_argv(jd, fdir, requests, seed + attempt, device),
            env=dict(env, GAUSS_FAULTS=(
                f"serve.worker.dispatch=delay:param={delay_s}:max=1000000"))
            if delay_s else env, cwd=_REPO, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        # Kill -9 the moment the ring shows the batch budget: the child
        # queued its whole plan up front, so a healthy run still has most
        # of the backlog in flight here.
        deadline = time.monotonic() + 240.0
        killed = False
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                break
            if _ring_batches(fdir) >= KILL_AFTER_BATCHES:
                proc.send_signal(signal.SIGKILL)
                killed = True
                break
            time.sleep(0.003)
        try:
            _, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:  # pragma: no cover
            proc.kill()
            _, err = proc.communicate()
        leg["child_rc"] = proc.returncode
        if not killed or proc.returncode != -signal.SIGKILL:
            leg["note"] = (f"attempt {attempt}: child exited rc="
                           f"{proc.returncode} before the kill landed")
            if proc.returncode not in (0, -signal.SIGKILL):
                leg["stderr"] = (err or "")[-1500:]
            continue
        # The journal's view of the death, taken BEFORE the resume run can
        # replay the backlog — the independent record the bundle's
        # in-flight set must match exactly.
        st = durable.scan(jd)
        want_in_flight = sorted(a["id"] for a in st.live_admits())
        known_traces = {str(d.get("trace"))
                        for d in list(st.admits.values())
                        + list(st.terminals.values()) if d.get("trace")}
        leg["in_flight_at_death"] = len(want_in_flight)
        # Resume run (no new requests): its start() finds the unterminated
        # admits and captures the 'unclean_resume' bundle under fdir.
        p2 = subprocess.run(_drive_argv(jd, fdir, 0, seed + attempt, device),
                            env=env, cwd=_REPO, timeout=300,
                            capture_output=True, text=True)
        leg["resume_rc"] = p2.returncode
        if p2.returncode != 0:
            leg["stderr2"] = p2.stderr[-1500:]
        bundle = _postmortem.latest_bundle(
            _postmortem.default_bundles_dir(fdir))
        leg["bundle"] = bundle
        leg["bundle_check_rc"] = (_gdebug.main([bundle, "--check"])
                                  if bundle else None)
        if bundle is None:
            leg["outcome"] = "violation"
            leg["error"] = "no post-mortem bundle captured at resume"
            break
        doc = _postmortem.read_bundle(bundle)
        rec = _gdebug.reconstruct(doc, batches=MIN_BATCHES)
        leg["cause"] = rec.get("cause")
        leg["batches_reconstructed"] = len(rec["last_batches"])
        batch_traces = [str(t) for ev in rec["last_batches"]
                        for t in (ev.get("traces") or ())]
        leg["trace_ids_ok"] = (bool(batch_traces)
                               and all(t in known_traces
                                       for t in batch_traces))
        got_in_flight = sorted(a.get("id") for a in rec["in_flight"])
        leg["in_flight_match"] = got_in_flight == want_in_flight
        problems = []
        if rec.get("cause") != "unclean_resume":
            problems.append(f"cause {rec.get('cause')!r}")
        if leg["bundle_check_rc"] != 0:
            problems.append("obs.debug --check failed")
        if leg["batches_reconstructed"] < MIN_BATCHES:
            problems.append(f"only {leg['batches_reconstructed']} "
                            f"batch(es) reconstructed (need {MIN_BATCHES})")
        if not leg["trace_ids_ok"]:
            problems.append("batch trace ids do not cross-check against "
                            "the journal")
        if not leg["in_flight_match"]:
            problems.append(f"in-flight set {got_in_flight} != journal "
                            f"unterminated admits {want_in_flight}")
        if p2.returncode != 0:
            problems.append(f"resume run rc={p2.returncode}")
        leg["outcome"] = "violation" if problems else "ok"
        if problems:
            leg["error"] = "; ".join(problems)
        break
    else:
        leg["outcome"] = "violation"
        leg["error"] = (f"kill never landed mid-load in "
                        f"{attempts} attempt(s)")
    leg["wall_s"] = round(time.perf_counter() - t0, 3)
    log(f"  kill leg: {leg['outcome']} "
        f"(attempt {leg['attempts']}, "
        f"{leg.get('batches_reconstructed', 0)} batch(es) reconstructed, "
        f"{leg.get('in_flight_at_death', 0)} in flight at death)")
    return leg


# -- leg 2: torn tail at every offset --------------------------------------

def run_torn_tail_leg(seed: int, tmpdir: str, log=print) -> Dict:
    """The exhaustive torn-tail property: for EVERY offset of the data
    region, a ring cut at that offset (zeros after — what a kill mid-write
    leaves on a fresh ring) must scan without raising to exactly the
    records fully written before the cut. Plus a wrapped-ring damage
    sweep: corruption windows anywhere must never raise and never fake a
    record that was not written."""
    from gauss_tpu_torch.obs import flight

    rng = np.random.default_rng(np.random.SeedSequence((seed, 0xF117)))
    path = os.path.join(tmpdir, "torn.ring")
    if os.path.exists(path):
        os.remove(path)
    ring = flight.FlightRing(path, capacity=flight.MIN_RING_BYTES)
    docs = [{"type": "event", "i": i, "payload": "x" * int(rng.integers(8, 40))}
            for i in range(40)]
    ends: List[Tuple[int, int]] = []  # (end offset in data region, doc idx)
    for i, doc in enumerate(docs):
        assert ring.append(json.dumps(doc, separators=(",", ":")).encode())
        ends.append((ring.wpos, i))
    assert ring.wpos <= ring.capacity, "leg must not wrap — prefix oracle"
    ring.flush()
    blob = open(path, "rb").read()
    hs, wpos = flight.HEADER_SIZE, ring.wpos
    ring.close()
    mismatches: List[str] = []
    checked = 0
    for cut in range(wpos + 1):
        torn = bytearray(blob)
        torn[hs + cut:] = b"\0" * (len(torn) - hs - cut)
        tpath = os.path.join(tmpdir, "torn.cut.ring")
        with open(tpath, "wb") as f:
            f.write(torn)
        events, stats = flight.scan(tpath)  # must never raise
        want = [docs[i] for end, i in ends if end <= cut]
        checked += 1
        if events != want:
            mismatches.append(
                f"cut@{cut}: recovered {len(events)} != expected "
                f"{len(want)} record(s)")
            if len(mismatches) >= 5:
                break
    # Wrapped ring + arbitrary damage windows: recovered events must be a
    # subset of what was written (no fabrication), scan never raises.
    wpath = os.path.join(tmpdir, "torn.wrap.ring")
    if os.path.exists(wpath):
        os.remove(wpath)
    wring = flight.FlightRing(wpath, capacity=flight.MIN_RING_BYTES)
    wdocs = [{"type": "event", "i": i, "p": "y" * int(rng.integers(8, 120))}
             for i in range(200)]
    for doc in wdocs:
        wring.append(json.dumps(doc, separators=(",", ":")).encode())
    assert wring.wpos > wring.capacity, "wrap sweep must actually wrap"
    wring.flush()
    wblob = bytearray(open(wpath, "rb").read())
    wring.close()
    written = {json.dumps(d, sort_keys=True) for d in wdocs}
    for _ in range(64):
        dmg = bytearray(wblob)
        start = hs + int(rng.integers(0, flight.MIN_RING_BYTES - 64))
        width = int(rng.integers(1, 64))
        dmg[start:start + width] = rng.integers(
            0, 256, width, dtype=np.uint8).tobytes()
        with open(wpath + ".dmg", "wb") as f:
            f.write(dmg)
        devents, dstats = flight.scan(wpath + ".dmg")
        checked += 1
        fabricated = [e for e in devents
                      if json.dumps(e, sort_keys=True) not in written]
        if fabricated:
            mismatches.append(f"damage@{start}+{width}: scan fabricated "
                              f"{len(fabricated)} record(s)")
    out = {"leg": "torn_tail", "offsets_checked": checked,
           "records": len(docs), "wrap_records": len(wdocs),
           "mismatches": mismatches,
           "outcome": "violation" if mismatches else "ok"}
    if mismatches:
        out["error"] = "; ".join(mismatches[:3])
    log(f"  torn-tail leg: {out['outcome']} ({checked} cut/damage "
        f"case(s), {len(mismatches)} mismatch(es))")
    return out


# -- leg 3: the ring's measured overhead -----------------------------------

def run_overhead_leg(seed: int, gate: float, tmpdir: str,
                     cache=None, device: str = "cuda", log=print) -> Dict:
    """The recorder's cost, measured: one loadgen plan run flight-off then
    flight-on (same seed, shared executable cache, unmeasured warm pass so
    neither run pays compiles). The flight-on seconds-per-request enters
    history and is regress-gated."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.serve.admission import ServeConfig
    from gauss_tpu_torch.serve.loadgen import LoadgenConfig, run_load
    from gauss_tpu_torch.serve.server import SolverServer

    def _cfg(flight_dir):
        return ServeConfig(ladder=(32,), max_batch=4, panel=16,
                           refine_steps=1, verify_gate=gate,
                           max_queue=256, flight_dir=flight_dir,
                           device=device)

    results: Dict = {"leg": "overhead"}
    warm = LoadgenConfig(mix="random:24*2,random:30", requests=24,
                         warmup=4, mode="closed", concurrency=4,
                         seed=seed, verify_gate=gate, serve=_cfg(None))
    with obs.span("flight_overhead_warm"):
        with SolverServer(warm.serve, cache=cache) as srv:
            run_load(srv, warm)
    for label, fdir in (("off", None),
                        ("on", os.path.join(tmpdir, "overhead.flight"))):
        cfg = LoadgenConfig(mix="random:24*2,random:30", requests=24,
                            warmup=4, mode="closed", concurrency=4,
                            seed=seed, verify_gate=gate, serve=_cfg(fdir))
        # Best-of-2 per arm: a straggler batch-size executable the warm
        # pass happened not to form is built in ONE pass; the best pass is
        # the fully-warm cost the gate reads, not the build spike.
        summary = None
        incorrect = 0
        for _ in range(2):
            with obs.span(f"flight_overhead_{label}"):
                with SolverServer(cfg.serve, cache=cache) as srv:
                    s = run_load(srv, cfg)
            incorrect += s["incorrect"]
            if summary is None or (s["throughput_rps"] or 0) > (
                    summary["throughput_rps"] or 0):
                summary = s
        results[label] = {
            "throughput_rps": summary["throughput_rps"],
            "s_per_request": (round(1.0 / summary["throughput_rps"], 6)
                              if summary["throughput_rps"] else None),
            "p50_s": summary["latency_s"]["p50"],
            "incorrect": incorrect,
        }
    off = results["off"]["s_per_request"]
    on = results["on"]["s_per_request"]
    results["overhead_ratio"] = round(on / off, 4) if off and on else None
    results["outcome"] = ("violation"
                          if results["off"]["incorrect"]
                          or results["on"]["incorrect"] else "ok")
    log(f"  overhead leg: flight-off {off} s/req -> flight-on {on} s/req "
        f"(ratio {results['overhead_ratio']})")
    return results


def history_records(summary: Dict) -> List[Tuple[str, float, str]]:
    """(metric, value, unit) records a flight-check run contributes to
    history. The flight-on absolute cost gates (the on/off RATIO rides in
    the summary only — its sub-ms denominator jitters between epochs,
    which would flake the band, while the numerator is stable); the kill
    campaign's wall-clock gates recovery-tooling cost."""
    out: List[Tuple[str, float, str]] = []
    on = ((summary.get("overhead") or {}).get("on") or {}).get(
        "s_per_request")
    if isinstance(on, (int, float)) and on > 0:
        out.append(("flight:ring_s_per_request", on, "s"))
    wall = (summary.get("kill") or {}).get("wall_s")
    if isinstance(wall, (int, float)) and wall > 0:
        out.append(("flight:kill_to_timeline_s", round(wall, 3), "s"))
    return out


# -- the self-driving server child (--drive) -------------------------------

def drive_main(args) -> int:
    """Subprocess worker: a journaled, flight-recording server fed its
    whole seeded plan up front (a deep backlog, so a SIGKILL anywhere
    mid-run leaves requests in flight). ``--requests 0`` is the resume
    form: replay the dead predecessor's backlog and drain — its start()
    captures the ``unclean_resume`` bundle."""
    from gauss_tpu_torch.serve.admission import ServeConfig
    from gauss_tpu_torch.serve.server import SolverServer

    rng = np.random.default_rng(np.random.SeedSequence(
        (args.seed, 0xF117D)))
    cfg = ServeConfig(ladder=(32,), max_batch=4, panel=16, refine_steps=1,
                      verify_gate=args.gate, journal_dir=args.journal,
                      journal_fsync_batch=1, max_queue=256,
                      flight_dir=args.flight, device=args.device)
    srv = SolverServer(cfg)
    srv.start()
    handles = []
    for j in range(args.requests):
        n = 16 + int(rng.integers(0, 13))
        a, b = _system(rng, n)
        handles.append(srv.submit(a, b, request_id=f"f{args.seed}-{j}"))
    for h in handles:
        if h.result(timeout=240.0).status is None:  # pragma: no cover
            return 3
    srv.stop(drain=True, timeout=240.0)
    return 0


# -- gate main --------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.obs.flightcheck",
        description="Flight-recorder gate: SIGKILL a recording server "
                    "mid-load and reconstruct its death from the "
                    "post-mortem bundle; torn-tail-at-every-offset ring "
                    "property; measured ring overhead (regress-gated).")
    p.add_argument("--seed", type=int, default=258458)
    p.add_argument("--gate", type=float, default=1e-4)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the servers run (default cuda; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--tmpdir", default=None,
                   help="ring/journal scratch directory (default: a new "
                        "temporary directory, removed at the end)")
    p.add_argument("--no-subprocess", action="store_true",
                   help="skip the SIGKILL-mid-load leg")
    p.add_argument("--kill-delay", type=float, default=None, metavar="S",
                   help="seconds injected before each batch of the child "
                        "the kill leg kills (default none)")
    p.add_argument("--no-overhead", action="store_true",
                   help="skip the flight-off vs flight-on measurement")
    p.add_argument("--metrics-out", default=None, metavar="PATH")
    p.add_argument("--summary-json", default=None, metavar="PATH")
    p.add_argument("--history", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="append gate records to the regression history "
                        "(default reports/history_torch.jsonl)")
    p.add_argument("--regress-check", action="store_true")
    # -- the subprocess worker mode ---------------------------------------
    p.add_argument("--drive", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--journal", default=None, help=argparse.SUPPRESS)
    p.add_argument("--flight", default=None, help=argparse.SUPPRESS)
    p.add_argument("--requests", type=int, default=80,
                   help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.drive:
        if not args.journal or not args.flight:
            print("flightcheck --drive needs --journal and --flight",
                  file=sys.stderr)
            return 2
        return drive_main(args)

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.obs import regress
    from gauss_tpu_torch.serve.cache import ExecutableCache
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)  # no card: RuntimeError, no fallback
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gauss_flight_") as scratch, \
            obs.run(metrics_out=args.metrics_out, tool="flight_check",
                    seed=args.seed):
        tmpdir = args.tmpdir or scratch
        os.makedirs(tmpdir, exist_ok=True)
        with obs.span("flight_check"):
            kill = ({} if args.no_subprocess
                    else run_kill_leg(args.seed, args.gate, tmpdir,
                                      requests=args.requests,
                                      device=args.device,
                                      delay_s=args.kill_delay))
            torn = run_torn_tail_leg(args.seed, tmpdir)
            overhead = ({} if args.no_overhead
                        else run_overhead_leg(
                            args.seed, args.gate, tmpdir,
                            cache=ExecutableCache(64, device=dev),
                            device=args.device))
    wall = round(time.perf_counter() - t0, 3)
    legs = [leg for leg in (kill, torn, overhead) if leg]
    violations = sum(1 for leg in legs if leg.get("outcome") == "violation")
    summary = {"kind": "flight_check", "seed": args.seed,
               "gate": args.gate, "device": args.device, "kill": kill,
               "torn_tail": torn, "overhead": overhead, "wall_s": wall,
               "invariant_ok": violations == 0}
    print(f"flight-check: {len(legs)} leg(s), "
          f"{'invariant HOLDS' if violations == 0 else 'VIOLATED'} "
          f"({wall} s)")

    if args.summary_json:
        parent = os.path.dirname(args.summary_json)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"summary: {args.summary_json}")

    rc = regress.gate(
        regress.campaign_records(history_records(summary), "flightcheck",
                                 "flight", regress.device_tag(args.device)),
        args.history, args.regress_check, healthy=violations == 0)
    if violations:
        for leg in legs:
            if leg.get("outcome") == "violation":
                print(f"flightcheck: leg[{leg.get('leg')}] VIOLATION: "
                      f"{leg.get('error')}", file=sys.stderr)
        return 2
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""The live telemetry plane's end-to-end gate (the port of
``gauss_tpu/obs/livecheck.py``).

``python -m gauss_tpu_torch.obs.livecheck [--device {cuda,cpu}]
[--requests N] [--summary-json PATH]``

Four legs against ONE running ``SolverServer`` with the live plane on
(ephemeral port), on ``--device`` (default ``cuda``, the card; ``cpu``
runs the kernels' plain versions), exit 2 on any assertion failure:

1. **Scrape/report totals match.** Drive a closed-loop loadgen mix with
   zero warmup, scrape ``/metrics``, and assert the Prometheus counter
   totals agree EXACTLY with the loadgen's final report — requests
   submitted/served (verified), rejected (shed), expired, failed, retried.
   Two independent folds of the same stream (live ring counters vs
   client-side results) must not drift.
2. **Per-request traces.** Every terminal status in the recorded stream
   folds into exactly one request trace (obs.requesttrace invariant), and
   the tree count equals the terminal count.
3. **On-demand /trace.** Arm a capture over HTTP while traffic flows;
   the returned Chrome-trace JSON must contain a ``serve_batch_solve``
   span carrying request traces.
4. **SLO fire/clear.** Force a deadline-violation burst (requests whose
   deadline is already unmeetable) and assert the burn-rate alert FIRES;
   then let the short window drain and drive good traffic until it
   CLEARS — both transitions must appear as obs ``alert`` events.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np


def _fail(msg: str) -> None:
    print(f"live-check: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(2)


def _ok(msg: str) -> None:
    print(f"live-check: ok: {msg}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.obs.livecheck",
        description="End-to-end gate for the live telemetry plane "
                    "(/metrics totals, request traces, on-demand /trace, "
                    "SLO alert fire/clear).")
    p.add_argument("--requests", type=int, default=40)
    p.add_argument("--seed", type=int, default=258458)
    p.add_argument("--burst", type=int, default=10,
                   help="deadline-violation burst size for the SLO leg")
    p.add_argument("--clear-timeout", type=float, default=30.0)
    p.add_argument("--metrics-out", default=None, metavar="PATH")
    p.add_argument("--summary-json", default=None, metavar="PATH")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the server's device lanes run (default cuda)")
    args = p.parse_args(argv)

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.obs import requesttrace
    from gauss_tpu_torch.obs import top as _top
    from gauss_tpu_torch.obs.slo import SLO
    from gauss_tpu_torch.serve.admission import ServeConfig
    from gauss_tpu_torch.serve.loadgen import LoadgenConfig, run_load
    from gauss_tpu_torch.serve.server import SolverServer

    # Small windows so the fire->clear cycle fits in CI seconds; the burn
    # math is window-size independent.
    slo = SLO(name="serve_ok", objective=0.95, short_window_s=1.5,
              long_window_s=8.0, fire_burn=2.0, clear_burn=1.0, min_count=4)
    serve_cfg = ServeConfig(ladder=(16, 32), max_batch=4, panel=16,
                            refine_steps=1, verify_gate=1e-4,
                            live_port=0, slos=(slo,), device=args.device)
    lg = LoadgenConfig(mix="random:12*2,random:24,internal:20",
                       requests=args.requests, warmup=0, mode="closed",
                       concurrency=4, seed=args.seed, serve=serve_cfg)

    summary = {"kind": "live_check", "device": args.device}
    with obs.run(metrics_out=args.metrics_out, tool="live_check") as rec:
        with SolverServer(serve_cfg) as server:
            url = server.live_url
            _ok(f"live endpoint up at {url}")

            # -- leg 1: loadgen vs /metrics totals -------------------------
            report = run_load(server, lg)
            counts = report["counts"]
            pairs = [
                ("gauss_serve_served_total", counts.get("ok", 0),
                 "served (verified)"),
                ("gauss_serve_rejected_total", counts.get("rejected", 0),
                 "rejected (shed)"),
                ("gauss_serve_expired_total", counts.get("expired", 0),
                 "expired (shed)"),
                ("gauss_serve_failed_total", counts.get("failed", 0),
                 "failed"),
                ("gauss_serve_retries_total", report.get("retries", 0),
                 "retries"),
            ]
            # A client unblocks at resolve(), a hair before the worker's
            # counter increment lands — scrape with a short bounded retry
            # so the comparison reads the settled totals, not the race.
            mismatch = None
            for _ in range(25):
                samples = _top.parse_metrics(urllib.request.urlopen(
                    f"{url}/metrics", timeout=10).read().decode())
                flat = {name: v for name, labels, v in samples
                        if not labels}
                mismatch = next(
                    ((m, flat.get(m, 0), want, label)
                     for m, want, label in pairs
                     if flat.get(m, 0) != want), None)
                if mismatch is None:
                    break
                time.sleep(0.1)
            if mismatch is not None:
                metric, got, want, label = mismatch
                _fail(f"/metrics {metric}={got} but the loadgen "
                      f"report says {label}={want}")
            if report["incorrect"]:
                _fail(f"{report['incorrect']} INCORRECT solution(s)")
            _ok(f"scrape totals match the loadgen report exactly "
                f"({counts.get('ok', 0)} served, "
                f"{counts.get('rejected', 0)} rejected, "
                f"{counts.get('expired', 0)} expired, "
                f"{counts.get('failed', 0)} failed, "
                f"{report.get('retries', 0)} retries)")
            summary["loadgen"] = {k: report[k] for k in
                                  ("counts", "retries", "incorrect")}

            # -- leg 3 (concurrent with traffic): on-demand /trace ---------
            rng = np.random.default_rng(args.seed + 1)
            captured = {}

            def _grab():
                with urllib.request.urlopen(
                        f"{url}/trace?batches=1&timeout=20",
                        timeout=30) as resp:
                    captured["doc"] = json.loads(resp.read().decode())

            t = threading.Thread(target=_grab)
            t.start()
            time.sleep(0.2)  # let the capture arm before traffic flows
            for _ in range(4):
                n = 12
                a = rng.standard_normal((n, n))
                a[np.arange(n), np.arange(n)] += float(n)
                server.solve(a, rng.standard_normal(n))
            t.join(timeout=30)
            doc = captured.get("doc")
            if not doc:
                _fail("/trace capture returned nothing")
            names = {ev.get("name") for ev in doc.get("traceEvents", [])
                     if ev.get("ph") == "X"}
            if "serve_batch_solve" not in names:
                _fail(f"/trace capture has no serve_batch_solve span "
                      f"(spans: {sorted(names)})")
            _ok(f"on-demand /trace captured "
                f"{sum(1 for ev in doc['traceEvents'] if ev.get('ph') == 'X')}"
                f" span(s) from the running server")

            # -- leg 4: SLO alert fires, then clears -----------------------
            mon = server.live.slos[0]
            for _ in range(args.burst):
                n = 12
                a = rng.standard_normal((n, n))
                a[np.arange(n), np.arange(n)] += float(n)
                h = server.submit(a, rng.standard_normal(n),
                                  deadline_s=1e-6)
                try:
                    h.result(timeout=30)
                except TimeoutError:
                    _fail("deadline-burst request hung")
            if not mon.firing:
                _fail(f"SLO alert did not fire after {args.burst} "
                      f"deadline violations (burn "
                      f"short/long = {mon.burn_rates()})")
            _ok(f"SLO alert FIRED after the violation burst "
                f"(worst burn {mon.worst_burn:.1f}x)")
            time.sleep(slo.short_window_s + 0.2)  # let the bad obs age out
            deadline = time.monotonic() + args.clear_timeout
            while mon.firing and time.monotonic() < deadline:
                n = 12
                a = rng.standard_normal((n, n))
                a[np.arange(n), np.arange(n)] += float(n)
                server.solve(a, rng.standard_normal(n))
                time.sleep(0.05)
            if mon.firing:
                _fail(f"SLO alert did not clear within "
                      f"{args.clear_timeout}s of good traffic")
            _ok(f"SLO alert CLEARED under good traffic "
                f"({mon.alerts} fire(s), {mon.clears} clear(s))")
            summary["slo"] = mon.status()

        # -- leg 2: per-request trace invariant (whole recorded stream) ----
        terminal = [ev for ev in rec.events
                    if ev.get("type") == "serve_request"
                    and ev.get("status") in requesttrace.TERMINAL_STATUSES]
        trees = requesttrace.request_traces(rec.events)
        problems = requesttrace.check_traces(trees)
        if problems:
            _fail("; ".join(problems[:5]))
        if len(trees) != len(terminal):
            _fail(f"{len(terminal)} terminal statuses but {len(trees)} "
                  f"request traces — identities dropped somewhere")
        alerts = [ev for ev in rec.events if ev.get("type") == "alert"]
        if not any(ev.get("state") == "firing" for ev in alerts) \
                or not any(ev.get("state") == "clear" for ev in alerts):
            _fail(f"alert events missing a transition: {alerts}")
        _ok(f"every terminal status has exactly one request trace "
            f"({len(trees)} traces); alert fire+clear in the stream")
        summary["traces"] = len(trees)

    if args.summary_json:
        parent = os.path.dirname(args.summary_json)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"summary: {args.summary_json}")
    print("live-check: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())

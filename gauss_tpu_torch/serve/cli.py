"""``python -m gauss_tpu_torch.serve.cli`` — drive the batched solver
service under load (the port of the JAX package's ``gauss-serve``).

Runs the open/closed-loop load generator
(:mod:`gauss_tpu_torch.serve.loadgen`) against an in-process
:class:`~gauss_tpu_torch.serve.server.SolverServer` and prints the serving
report (the JAX package's report lines); ``--metrics-out`` appends the
run's obs stream (render it with ``python -m
gauss_tpu_torch.obs.summarize``, fold it per request with ``python -m
gauss_tpu_torch.obs.requesttrace PATH --check``), ``--summary-json``
writes the report. The flags are the JAX package's plus ``--device
{cuda,cpu}`` (default ``cuda``: without a card the server raises).
``--journal DIR`` makes admission durable (:mod:`.durable`; SIGTERM then
drains and journals the clean-shutdown marker), ``--supervised`` re-runs
this command as a child under :func:`.durable.supervise`, ``--net URL``
drives the load over HTTP against a running replica or router front
(:mod:`.net`), and ``--replicas N`` spawns N journaled replica processes
behind a consistent-hash router front (:mod:`.router`; ``--port``,
``--fleet-dir``) and drives the load through it. ``--flight-dir DIR``
records the run into the crash-surviving flight ring
(:mod:`gauss_tpu_torch.obs.flight`; also read from ``GAUSS_FLIGHT_DIR``,
which is how ``--supervised`` hands it to the child), ``--live-port
PORT`` embeds the live telemetry endpoint (:mod:`gauss_tpu_torch.obs
.export`; watch it with ``python -m gauss_tpu_torch.obs.top``),
``--slo-shed`` shrinks admission while an SLO alert fires, ``--slo-json``
writes the run's ``kind: slo_report``, and ``--history`` /
``--regress-check`` feed and gate the port's regression history
(:mod:`gauss_tpu_torch.obs.regress`). A flag of a plane not ported yet
exits 2 naming its ROADMAP queue-1 item (:data:`UNPORTED_FLAGS`); the JAX
package's sub-options of those planes (``--cb-window``, ...) are not flags
here, so argparse refuses them (exit 2). Exit 2 also when a solution is
INCORRECT, 1 when ``--regress-check`` finds an out-of-band metric.

Example (CPU)::

    python -m gauss_tpu_torch.serve.cli --device cpu --requests 30 \
        --mix random:24*2,random:60,internal:48,spd:40,dtype:bfloat16/32 \
        --ladder 32,64 --refine-steps 3 --metrics-out s.jsonl
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

#: Flags of planes not ported yet: (attribute, value that leaves the plane
#: off, the ROADMAP queue-1 item that brings it).
UNPORTED_FLAGS = (
    ("lanes", 0, "--lanes", "item 11 (serve/lanes)"),
    ("lane_width", 1, "--lane-width", "item 11 (serve/lanes)"),
    ("attr", False, "--attr", "item 11 (obs/attr)"),
    ("compile_cache", None, "--compile-cache",
     "item 11 (the JAX package's tune/compilecache)"),
)


def _install_drain_handler(server) -> None:
    """SIGTERM = graceful drain (journal runs only): stop admitting, serve
    what was accepted, journal the clean-shutdown marker, exit 0."""
    def _drain(signum, frame):
        print("serve.cli: SIGTERM — draining (clean-shutdown marker "
              "journaled on completion)", file=sys.stderr)
        server.stop(drain=True)
        raise SystemExit(0)

    try:
        signal.signal(signal.SIGTERM, _drain)
    except ValueError:  # not the main thread
        pass


def _run_supervised(args, argv) -> int:
    """``--supervised``: run this same serve command as a child under
    :func:`gauss_tpu_torch.serve.durable.supervise`; a child that died or
    stalled restarts against the same journal, whose resume makes the
    restart correct."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.serve import durable

    if not args.journal:
        print("serve.cli: --supervised requires --journal (the restart is "
              "only correct against a journal)", file=sys.stderr)
        return 2
    child = [a for a in (argv if argv is not None else sys.argv[1:])
             if a != "--supervised"]
    child_argv = [sys.executable, "-m", "gauss_tpu_torch.serve.cli"] + child
    hb = os.path.join(args.journal, "heartbeat.json")
    with obs.run(tool="gauss_serve_supervisor", journal=args.journal):
        return durable.supervise(
            child_argv, heartbeat_path=hb, max_restarts=args.max_restarts,
            stall_after_s=args.stall_after, journal_dir=args.journal,
            flight_dir=args.flight_dir)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.serve.cli",
        description="Batched solver serving load test: request queue, "
                    "shape-bucketed executable cache, admission control. "
                    "The flags of planes not ported yet (--lanes, "
                    "--attr, ...) exit 2.")
    p.add_argument("--mix", default="random:100*2,random:200,internal:160",
                   help="weighted workload tokens kind:arg[*weight] "
                        "(kinds: random:<n>, internal:<n>, dat:<path>, "
                        "dataset:<name>, spd:<n>, banded:<n>/<b>, "
                        "blockdiag:<n>/<k>, dtype:<dt>/<n> — drives the "
                        "lowered bf16/bf16x3 batched lanes — and "
                        "poison:<nan|inf|singular>/<n> — deliberately bad "
                        "operands at a controlled rate; typed poison "
                        "rejects are reported separately from failures)")
    p.add_argument("--requests", type=int, default=50,
                   help="measured request count (default 50)")
    p.add_argument("--warmup", type=int, default=8,
                   help="warmup requests excluded from the report "
                        "(default 8)")
    p.add_argument("--mode", choices=("closed", "open"), default="closed",
                   help="closed: N clients submit+wait; open: Poisson "
                        "arrivals at --rate regardless of completions")
    p.add_argument("--concurrency", type=int, default=4,
                   help="closed-loop client threads (default 4)")
    p.add_argument("--rate", type=float, default=50.0,
                   help="open-loop arrival rate, requests/s (default 50)")
    p.add_argument("--nrhs", type=int, default=1,
                   help="right-hand-side columns per request (default 1)")
    p.add_argument("--deadline", type=float, default=None, metavar="S",
                   help="per-request deadline in seconds (expired requests "
                        "are shed before compute)")
    p.add_argument("--seed", type=int, default=258458)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the device lanes run (default cuda; cpu runs "
                        "the kernels' plain versions)")
    # -- server knobs -----------------------------------------------------
    p.add_argument("--ladder", default=None,
                   help="comma-separated bucket sizes (default: 128,256,"
                        "...,4096 — panel-aligned powers of two)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--cache-capacity", type=int, default=32)
    p.add_argument("--refine-steps", type=int, default=1,
                   help="host-f64 refinement rounds per batch (default 1)")
    p.add_argument("--dtype", choices=("float32", "bfloat16", "bf16x3"),
                   default="float32",
                   help="batched-lane storage dtype default (per-request "
                        "dtype: mix tokens override it); lowered dtypes "
                        "key their own cache entries and rely on "
                        "--refine-steps + the verify gate for the 1e-4 "
                        "contract (default float32)")
    p.add_argument("--linger", type=float, default=0.0, metavar="S",
                   help="batching linger: wait this long for same-bucket "
                        "company before dispatching (default 0)")
    p.add_argument("--panel", type=int, default=None,
                   help="blocked-solver panel width (default: auto, "
                        "consulting the tuned store when one exists)")
    # -- durable admission (gauss_tpu_torch.serve.durable) ----------------
    p.add_argument("--journal", default=None, metavar="DIR",
                   help="write-ahead request journal at DIR: every admit "
                        "and terminal is journaled and a restarted server "
                        "replays unterminated admits (exactly-once "
                        "terminal statuses across kill -9)")
    p.add_argument("--resume", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="with --journal: replay unterminated admits at "
                        "start; --no-resume journals new traffic only "
                        "(default: resume)")
    p.add_argument("--request-ids", action="store_true",
                   help="mint a deterministic idempotency key per loadgen "
                        "request; with --journal a rerun dedupes against "
                        "journaled terminals instead of re-solving")
    p.add_argument("--supervised", action="store_true",
                   help="run this serve command as a child that a "
                        "supervisor restarts, against the same journal, "
                        "when it dies or stalls (requires --journal)")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="supervised mode: restart budget (default 3)")
    p.add_argument("--stall-after", type=float, default=30.0, metavar="S",
                   help="supervised mode: heartbeat staleness that calls "
                        "a stall (default 30)")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="crash-surviving flight recorder at DIR: every obs "
                        "event also lands in an mmap ring that outlives "
                        "kill -9, and dead/stalled/unclean-resume detection "
                        "freezes it into a post-mortem bundle under "
                        "DIR/bundles (inspect with python -m "
                        "gauss_tpu_torch.obs.debug; also read from the "
                        "GAUSS_FLIGHT_DIR env, which is how --supervised "
                        "hands it to the child)")
    # -- the network tier (gauss_tpu_torch.serve.net) ---------------------
    p.add_argument("--net", default=None, metavar="URL",
                   help="drive the load over HTTP against a running "
                        "request endpoint (python -m gauss_tpu_torch.serve"
                        ".net --replica) instead of an in-process server; "
                        "history metrics tagged serve:net:<mode>")
    p.add_argument("--replicas", type=int, default=0, metavar="N",
                   help="spawn N journaled replica processes (on --device) "
                        "behind a consistent-hash router front and drive "
                        "the load through it; a replica killed mid-load "
                        "fails its journal over to a surviving peer")
    p.add_argument("--port", type=int, default=0, metavar="P",
                   help="with --replicas: the router front's listen port "
                        "(default 0 = ephemeral)")
    p.add_argument("--fleet-dir", default=None, metavar="DIR",
                   help="with --replicas: fleet state root (per-replica "
                        "journal/flight/heartbeat dirs and the router's "
                        "assign log; default: a new temporary directory)")
    # -- the JAX package's planes that are not ported (each exits 2; their
    #    sub-options are not flags here) -----------------------------------
    p.add_argument("--lanes", type=int, default=0)
    p.add_argument("--lane-width", type=int, default=1)
    p.add_argument("--compile-cache", default=None, metavar="DIR")
    p.add_argument("--attr", action="store_true")
    # -- the live telemetry plane -----------------------------------------
    p.add_argument("--live-port", type=int, default=None, metavar="PORT",
                   help="embed the live telemetry endpoint on PORT "
                        "(0 = ephemeral): /metrics Prometheus exposition, "
                        "/slo burn-rate alert states, /trace on-demand "
                        "Chrome-trace capture; read it live with `python -m "
                        "gauss_tpu_torch.obs.top --url "
                        "http://127.0.0.1:PORT`")
    p.add_argument("--slo-shed", action="store_true",
                   help="while an SLO burn-rate alert fires, shrink the "
                        "admission bound (degradation before the deadline "
                        "cliff); requires --live-port")
    # -- outputs ----------------------------------------------------------
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="append the run's obs JSONL event stream here "
                        "(summarize/requesttrace-compatible)")
    p.add_argument("--summary-json", default=None, metavar="PATH",
                   help="write the serving report as JSON "
                        "(kind=serve_loadgen)")
    p.add_argument("--slo-json", default=None, metavar="PATH",
                   help="write the run's SLO report as JSON (regress-"
                        "ingestable: kind=slo_report; requires "
                        "--live-port)")
    p.add_argument("--history", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="append the run's serving metrics to the regression "
                        "history (default reports/history_torch.jsonl)")
    p.add_argument("--regress-check", action="store_true",
                   help="gate the run's serving metrics against the "
                        "history baselines (exit 1 when out of band)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for attr, off, flag, item in UNPORTED_FLAGS:
        if getattr(args, attr) != off:
            print(f"serve.cli: {flag} is not ported to gauss_tpu_torch yet "
                  f"(ROADMAP queue-1 {item})", file=sys.stderr)
            return 2
    if args.supervised:
        return _run_supervised(args, argv)

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.serve import buckets
    from gauss_tpu_torch.serve.admission import ServeConfig
    from gauss_tpu_torch.serve.loadgen import (
        LoadgenConfig,
        format_summary,
        run_load,
        write_summary,
    )
    from gauss_tpu_torch.serve.server import SolverServer

    ladder = ()
    if args.ladder:
        ladder = buckets.validate_ladder(
            int(r) for r in args.ladder.split(","))
    serve_cfg = ServeConfig(
        ladder=ladder, max_batch=args.max_batch, max_queue=args.max_queue,
        batch_linger_s=args.linger, cache_capacity=args.cache_capacity,
        refine_steps=args.refine_steps, panel=args.panel, dtype=args.dtype,
        device=args.device, journal_dir=args.journal, resume=args.resume,
        live_port=args.live_port, slo_shed=args.slo_shed,
        heartbeat_path=os.environ.get("GAUSS_SERVE_HEARTBEAT") or None,
        flight_dir=(args.flight_dir
                    or os.environ.get("GAUSS_FLIGHT_DIR") or None))
    cfg = LoadgenConfig(
        mix=args.mix, requests=args.requests, warmup=args.warmup,
        mode=args.mode, concurrency=args.concurrency, rate=args.rate,
        nrhs=args.nrhs, seed=args.seed, deadline_s=args.deadline,
        request_ids=args.request_ids, serve=serve_cfg)
    if args.net and args.replicas:
        print("serve.cli: --net and --replicas are exclusive (--net "
              "targets an endpoint that already exists)", file=sys.stderr)
        return 2
    with obs.run(metrics_out=args.metrics_out, tool="gauss_serve",
                 mode=args.mode, mix=args.mix, requests=args.requests):
        if args.net or args.replicas:
            # The same loadgen plan over HTTP through the network client:
            # against an existing endpoint (--net) or a freshly spawned
            # replica fleet behind the router (--replicas).
            import tempfile

            from gauss_tpu_torch.serve.net import SolveClient
            from gauss_tpu_torch.serve.router import Router, RouterConfig

            router = None
            try:
                url = args.net
                if args.replicas:
                    fleet_dir = (args.fleet_dir
                                 or tempfile.mkdtemp(prefix="gauss_fleet-"))
                    router = Router(RouterConfig(
                        replicas=args.replicas, port=args.port,
                        dir=fleet_dir, ladder=tuple(ladder),
                        max_batch=args.max_batch, max_queue=args.max_queue,
                        linger_s=args.linger, dtype=args.dtype,
                        device=args.device)).start()
                    url = router.url
                    print(f"replica fleet: {args.replicas} replica(s) "
                          f"behind {url} (state: {fleet_dir})")
                summary = run_load(SolveClient(url), cfg)
            finally:
                if router is not None:
                    out = router.stop(drain=True)
                    print(f"fleet drained: {out['causes']}")
        else:
            with SolverServer(serve_cfg) as server:
                if args.journal:
                    _install_drain_handler(server)
                if server.live_url:
                    print(f"live telemetry: {server.live_url}/metrics "
                          f"(watch with: python -m gauss_tpu_torch.obs.top "
                          f"--url {server.live_url})")
                if args.journal:
                    if server.last_resume:
                        print(f"journal: {args.journal} "
                              f"resume={server.last_resume}")
                summary = run_load(server, cfg)
    print(format_summary(summary))
    if args.metrics_out:
        print(f"metrics: {args.metrics_out}")
    if args.summary_json:
        write_summary(summary, args.summary_json)
        print(f"summary: {args.summary_json}")
    if args.slo_json:
        if summary.get("slo"):
            write_summary(summary["slo"], args.slo_json)
            print(f"slo report: {args.slo_json}")
        else:
            print("gauss-serve: --slo-json needs --live-port (no SLO "
                  "monitors ran)", file=sys.stderr)
    from gauss_tpu_torch.obs import regress
    from gauss_tpu_torch.serve.loadgen import history_records

    rc = regress.gate(
        regress.campaign_records(history_records(summary), "gauss-serve",
                                 "serve", regress.device_tag(args.device)),
        args.history, args.regress_check)
    if summary["incorrect"]:
        print(f"gauss-serve: {summary['incorrect']} INCORRECT solution(s) "
              f"(relative residual above {cfg.verify_gate:g})",
              file=sys.stderr)
        return 2
    return rc


if __name__ == "__main__":
    sys.exit(main())

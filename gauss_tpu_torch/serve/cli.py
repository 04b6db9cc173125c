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
{cuda,cpu}`` (default ``cuda``: without a card the server raises). A flag
of a plane not ported yet exits 2 naming its ROADMAP queue-1 item
(:data:`UNPORTED_FLAGS`); the JAX package's sub-options of those planes
(``--cb-window``, ``--resume``, ``--request-ids``, ...) are not flags
here, so argparse refuses them (exit 2). Exit 2 also when a solution is
INCORRECT.

Example (CPU)::

    python -m gauss_tpu_torch.serve.cli --device cpu --requests 30 \
        --mix random:24*2,random:60,internal:48,spd:40,dtype:bfloat16/32 \
        --ladder 32,64 --refine-steps 3 --metrics-out s.jsonl
"""

from __future__ import annotations

import argparse
import sys

#: Flags of planes not ported yet: (attribute, value that leaves the plane
#: off, the ROADMAP queue-1 item that brings it).
UNPORTED_FLAGS = (
    ("lanes", 0, "--lanes", "item 11 (serve/lanes)"),
    ("lane_width", 1, "--lane-width", "item 11 (serve/lanes)"),
    ("journal", None, "--journal", "item 11 (serve/durable)"),
    ("supervised", False, "--supervised", "item 11 (serve/durable)"),
    ("flight_dir", None, "--flight-dir", "item 11 (obs/flight)"),
    ("attr", False, "--attr", "item 11 (obs/attr)"),
    ("net", None, "--net", "item 11 (serve/net)"),
    ("replicas", 0, "--replicas", "item 11 (serve/router)"),
    ("live_port", None, "--live-port", "item 11 (obs/live, obs/export)"),
    ("slo_shed", False, "--slo-shed", "item 11 (obs/slo)"),
    ("slo_json", None, "--slo-json", "item 11 (obs/slo)"),
    ("history", None, "--history", "item 11 (obs/regress)"),
    ("regress_check", False, "--regress-check", "item 11 (obs/regress)"),
    ("compile_cache", None, "--compile-cache",
     "item 11 (the JAX package's tune/compilecache)"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.serve.cli",
        description="Batched solver serving load test: request queue, "
                    "shape-bucketed executable cache, admission control. "
                    "The flags of planes not ported yet (--lanes, "
                    "--journal, --net, --live-port, ...) exit 2.")
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
    # -- the JAX package's planes that are not ported (each exits 2; their
    #    sub-options are not flags here) -----------------------------------
    p.add_argument("--lanes", type=int, default=0)
    p.add_argument("--lane-width", type=int, default=1)
    p.add_argument("--compile-cache", default=None, metavar="DIR")
    p.add_argument("--journal", default=None, metavar="DIR")
    p.add_argument("--supervised", action="store_true")
    p.add_argument("--flight-dir", default=None, metavar="DIR")
    p.add_argument("--attr", action="store_true")
    p.add_argument("--net", default=None, metavar="URL")
    p.add_argument("--replicas", type=int, default=0, metavar="N")
    p.add_argument("--live-port", type=int, default=None, metavar="PORT")
    p.add_argument("--slo-shed", action="store_true")
    # -- outputs ----------------------------------------------------------
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="append the run's obs JSONL event stream here "
                        "(summarize/requesttrace-compatible)")
    p.add_argument("--summary-json", default=None, metavar="PATH",
                   help="write the serving report as JSON "
                        "(kind=serve_loadgen)")
    p.add_argument("--slo-json", default=None, metavar="PATH")
    p.add_argument("--history", nargs="?", const="", default=None,
                   metavar="PATH")
    p.add_argument("--regress-check", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for attr, off, flag, item in UNPORTED_FLAGS:
        if getattr(args, attr) != off:
            print(f"serve.cli: {flag} is not ported to gauss_tpu_torch yet "
                  f"(ROADMAP queue-1 {item})", file=sys.stderr)
            return 2

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
        device=args.device)
    cfg = LoadgenConfig(
        mix=args.mix, requests=args.requests, warmup=args.warmup,
        mode=args.mode, concurrency=args.concurrency, rate=args.rate,
        nrhs=args.nrhs, seed=args.seed, deadline_s=args.deadline,
        serve=serve_cfg)
    with obs.run(metrics_out=args.metrics_out, tool="gauss_serve",
                 mode=args.mode, mix=args.mix, requests=args.requests):
        with SolverServer(serve_cfg) as server:
            summary = run_load(server, cfg)
    print(format_summary(summary))
    if args.metrics_out:
        print(f"metrics: {args.metrics_out}")
    if args.summary_json:
        write_summary(summary, args.summary_json)
        print(f"summary: {args.summary_json}")
    if summary["incorrect"]:
        print(f"gauss-serve: {summary['incorrect']} INCORRECT solution(s) "
              f"(relative residual above {cfg.verify_gate:g})",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())

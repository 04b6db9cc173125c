"""Internal-input gauss driver: the synthetic benchmark system, self-timed.

The JAX package's ``gauss_internal`` surface on the port:
``python -m gauss_tpu_torch.cli.gauss_internal -s <n> -t <threads>
[--backend cuda|cuda-unblocked|cuda-rowelim|cuda-rowelim-step] [--verify]
[--device cuda|cpu] [--metrics-out PATH] [--trace DIR] [--profile]
[--phase-profile]``, defaults n=2048 / 32 threads, printing
``Application time: %f Secs`` over init + solve. Invalid -s/-t values
fall back to the defaults with a notice. Exit code 1 when ``--verify``
fails or the matrix is singular.

Telemetry, as in the JAX package: ``--metrics-out`` appends the run's
spans (``setup_env``, ``initMatrix``, staging, warm-up, ``computeGauss``,
``health_monitors``, ``phase_profile`` and its phases, ``verify``) and
its ``config``, ``compile``, ``health`` and ``reported_time`` events as
JSONL (render with ``python -m gauss_tpu_torch.obs.summarize PATH``);
``--trace DIR`` writes a ``torch.profiler`` Chrome trace of the solve
(warm-up included) into DIR; ``--profile`` prints a per-phase wall-clock
table; ``--phase-profile`` (``--backend cuda`` only) re-factors the
system with :func:`gauss_tpu_torch.core.blocked.lu_factor_blocked_phased`
and prints its phase table.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.cli import _common
from gauss_tpu_torch.io import synthetic
from gauss_tpu_torch.utils import profiling
from gauss_tpu_torch.utils.device import resolve_device
from gauss_tpu_torch.verify import checks

DEFAULT_N = 2048
DEFAULT_THREADS = 32


def positive_int_or_default(value: str, default: int, what: str) -> int:
    try:
        v = int(value)
        if v > 0:
            return v
    except ValueError:
        pass
    print(f"Invalid {what} '{value}'; using default {default}.")
    return default


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gauss_internal",
        description="Gaussian elimination on the synthetic benchmark system "
                    "(PyTorch/CUDA port).")
    p.add_argument("-s", metavar="N", default=str(DEFAULT_N),
                   help=f"matrix dimension (default {DEFAULT_N})")
    p.add_argument("-t", metavar="T", default=str(DEFAULT_THREADS),
                   help="threads / shards (accepted for parity; default "
                        f"{DEFAULT_THREADS})")
    p.add_argument("--backend", choices=_common.GAUSS_BACKENDS,
                   default="cuda")
    p.add_argument("--device", choices=_common.DEVICES, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    p.add_argument("--pivoting", choices=("partial", "first_nonzero"),
                   default=None,
                   help="pivot policy; default: first_nonzero on the "
                        "unblocked oracle, partial elsewhere")
    p.add_argument("--verify", action="store_true",
                   help="check the closed-form solution pattern and "
                        "residual")
    p.add_argument("--refine", type=int, default=2, metavar="K",
                   help="iterative-refinement budget; K <= 2 (or n < "
                        f"{_common.DS_ROUTE_MIN_N}) refines host-side with "
                        "early exit at --refine-tol, larger budgets run on "
                        "the device with double-single residuals")
    p.add_argument("--refine-tol", type=float, default=1e-5, metavar="TOL",
                   help="host-side refinement only: stop once "
                        "||Ax-b|| <= TOL*min(1, ||b||) (default 1e-5)")
    p.add_argument("--panel", type=int, default=None,
                   help="panel width for the blocked backend (default: "
                        "auto)")
    p.add_argument("--trace", "--trace-dir", dest="trace", metavar="DIR",
                   default=None,
                   help="write a torch.profiler Chrome trace of the solve "
                        "into DIR (CPU and CUDA activity on the card; view "
                        "in Perfetto)")
    p.add_argument("--metrics-out", metavar="PATH", default=None,
                   help="append this run's telemetry (spans, numerical "
                        "health, warm-up accounting) as JSONL to PATH; "
                        "render with `python -m "
                        "gauss_tpu_torch.obs.summarize PATH`")
    p.add_argument("--profile", action="store_true",
                   help="print a gprof-style per-phase wall-clock table")
    p.add_argument("--phase-profile", action="store_true",
                   help="cuda backend only: additionally run the "
                        "phase-instrumented blocked factorization (panel "
                        "factor / pivot apply / trailing update spans, a "
                        "synchronize after each) and print its table")
    return p


def _run(args) -> int:
    with obs.span("setup_env"):
        dev = resolve_device(args.device)
    n = positive_int_or_default(args.s, DEFAULT_N, "matrix size")
    t = positive_int_or_default(args.t, DEFAULT_THREADS, "thread count")
    obs.emit("config", tool="gauss_internal", n=n, threads=t,
             backend=args.backend, device=dev.type)
    print(f"Computing Gaussian elimination: size {n} x {n}, "
          f"backend {args.backend}, threads/shards {t}")

    # Timed region = init + solve (the internal flavor); the device
    # backends stage the system before their span opens.
    pt = profiling.PhaseTimer()
    with pt.phase("initMatrix"):
        a = synthetic.internal_matrix(n)
        b = synthetic.internal_rhs(n)
    init_elapsed = pt.seconds["initMatrix"]

    t0 = time.perf_counter()
    with profiling.trace(args.trace, args.device):
        x, solve_elapsed = _common.solve_with_backend(
            a, b, args.backend, nthreads=t, pivoting=args.pivoting,
            refine_iters=args.refine, panel=args.panel,
            refine_tol=args.refine_tol, device=args.device)
        wrapper_s = time.perf_counter() - t0
    # The table's rest: the warm-up, the staging and the health monitors
    # (each already an obs span inside solve_with_backend, so neither this
    # nor computeGauss is re-emitted here).
    pt.seconds["computeGauss"] = solve_elapsed
    pt.seconds["warm-up+staging"] = max(0.0, wrapper_s - solve_elapsed)

    print(f"Application time: {init_elapsed + solve_elapsed:f} Secs")
    obs.emit("reported_time", name="Application time",
             seconds=init_elapsed + solve_elapsed)
    if args.profile:
        print(pt.report())
    if args.phase_profile and args.backend == "cuda":
        # The solver-phase profile: re-factor with a synchronize after
        # each phase (the diagnostic path), spans recorded on the run and
        # the table printed like --profile.
        from gauss_tpu_torch.core import blocked

        with obs.span("phase_profile"):
            ppt = profiling.PhaseTimer()
            blocked.lu_factor_blocked_phased(a, panel=args.panel, timer=ppt,
                                             device=args.device)
        print("Solver phase profile (instrumented re-factorization):")
        print(ppt.report())
    elif args.phase_profile:
        print(f"Note: --phase-profile applies to the cuda backend only "
              f"(got '{args.backend}')", file=sys.stderr)
    if args.trace:
        print(f"Device trace written to {args.trace}")

    if args.verify:
        with obs.span("verify"):
            ok = checks.internal_pattern_ok(x, atol=1e-4)
            res = checks.residual_norm(a, x, b)
        print(f"Verification: solution pattern (-0.5, 0...0, 0.5) "
              f"{'OK' if ok else 'FAILED'}")
        print(f"Residual ||Ax-b||: {res:e}")
        if not ok or not np.isfinite(res):
            return 1
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    with _common.metrics_run(args, "gauss_internal") as (rec, stream):
        rc = _run(args)
    if stream:
        print(f"Metrics: run {rec.run_id} appended to {stream}")
    return rc


if __name__ == "__main__":
    sys.exit(main())

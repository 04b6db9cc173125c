"""External-input gauss driver: ``.dat`` file, manufactured-solution oracle.

The JAX package's ``gauss_external`` surface on the port:
``python -m gauss_tpu_torch.cli.gauss_external <matrixfile> [threads]
[--backend B] [--device cuda|cpu] [--metrics-out PATH] [--trace DIR]
[--debug] [--coordinator HOST:PORT --num-processes N --process-id I]`` —
parse and densify the coordinate file, build the RHS from the preset
solution X[i] = i + 1, time the solve, print::

    Time: %f seconds
    Error: %e

where Error is the max relative error against X. Exit code 1 on an
unreadable file or a non-finite solution. ``--metrics-out`` and
``--trace`` are ``gauss_internal``'s (spans ``parse_dat``,
``manufacture_rhs`` and ``verify`` here, and a ``health`` event with the
``max_rel_error``); ``--debug`` prints the parse statistics and, on the
cuda backend, the rows partial pivoting moved and the smallest pivot of
one extra factorization.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.cli import _common
from gauss_tpu_torch.io import datfile, synthetic
from gauss_tpu_torch.utils import profiling
from gauss_tpu_torch.utils.device import resolve_device
from gauss_tpu_torch.verify import checks


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gauss_external",
        description="Gaussian elimination on a .dat coordinate-format matrix "
                    "(PyTorch/CUDA port).")
    p.add_argument("matrixfile", help="path to the .dat matrix file")
    p.add_argument("threads", nargs="?", type=int, default=0,
                   help="threads of the native engines, ranks of the "
                        "distributed ones (default: all)")
    p.add_argument("--backend", choices=_common.GAUSS_BACKENDS,
                   default="cuda")
    p.add_argument("--device", choices=_common.DEVICES, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    p.add_argument("--refine", type=int, default=2, metavar="K",
                   help="iterative-refinement budget; K <= 2 (or n < "
                        f"{_common.DS_ROUTE_MIN_N}) refines host-side with "
                        "early exit at --refine-tol, larger budgets run on "
                        "the device with double-single residuals")
    p.add_argument("--refine-tol", type=float, default=1e-5, metavar="TOL",
                   help="host-side refinement only: stop once "
                        "||Ax-b|| <= TOL*min(1, ||b||)")
    p.add_argument("--panel", type=int, default=None,
                   help="panel width for the blocked backend (default: "
                        "auto)")
    p.add_argument("--trace", "--trace-dir", dest="trace", metavar="DIR",
                   default=None,
                   help="write a torch.profiler Chrome trace of the solve "
                        "into DIR")
    p.add_argument("--metrics-out", metavar="PATH", default=None,
                   help="append this run's telemetry (spans, numerical "
                        "health, warm-up accounting) as JSONL to PATH; "
                        "render with `python -m "
                        "gauss_tpu_torch.obs.summarize PATH`")
    p.add_argument("--debug", action="store_true",
                   help="print parse and pivot diagnostics")
    from gauss_tpu_torch.dist.multihost import add_multihost_args

    add_multihost_args(p)
    return p


def _run(args) -> int:
    with obs.span("setup_env"):
        dev = resolve_device(args.device)
    try:
        with obs.span("parse_dat"):
            if args.debug:
                n_hdr, rows, cols, vals = datfile.read_dat(args.matrixfile)
                if len(vals):
                    stats = (f"coord range rows [{rows.min()},{rows.max()}] "
                             f"cols [{cols.min()},{cols.max()}], |value| in "
                             f"[{abs(vals).min():.3e},{abs(vals).max():.3e}]")
                else:
                    stats = "no nonzeros (zero matrix)"
                print(f"DEBUG: parsed header n={n_hdr}, nnz={len(vals)}, "
                      f"{stats}")
                a = datfile.densify(n_hdr, rows, cols, vals)
            else:
                a = datfile.read_dat_dense(args.matrixfile)
    except (OSError, ValueError) as e:
        print(f"gauss_external: cannot read '{args.matrixfile}': {e}",
              file=sys.stderr)
        return 1
    n = a.shape[0]
    with obs.span("manufacture_rhs"):
        x_true = synthetic.manufactured_solution(n)
        b = synthetic.manufactured_rhs(a, x_true)
    obs.emit("config", tool="gauss_external", n=n, backend=args.backend,
             device=dev.type, matrixfile=str(args.matrixfile))
    print(f"Matrix {args.matrixfile}: {n} x {n}, backend {args.backend}")

    try:
        with profiling.trace(args.trace, args.device):
            x, elapsed = _common.solve_with_backend(
                a, b, args.backend, nthreads=args.threads,
                pivoting="partial", refine_iters=args.refine,
                panel=args.panel, refine_tol=args.refine_tol,
                device=args.device)
    except np.linalg.LinAlgError:
        # The native engines raise on a zero pivot; the reference's abort
        # message (gauss_external_input.c:137 prints to stderr).
        print("The matrix is singular", file=sys.stderr)
        return 1

    if args.debug and args.backend == "cuda":
        # Pivot diagnostics: one extra factorization of the exact backend
        # whose solver it is. min |pivot| reads the real U diagonal (first
        # n entries), not min_abs_pivot, which the identity padding clamps
        # to <= 1 when n is not a panel multiple.
        from gauss_tpu_torch.core.blocked import resolve_factor

        fac = resolve_factor(n, "auto", device=args.device)(
            a, panel=args.panel, device=args.device)
        perm = fac.perm[:n].cpu().numpy()
        moved = int((perm != np.arange(n)).sum())
        pivots = fac.m.diagonal()[:n].abs().cpu().numpy()
        print(f"DEBUG: partial pivoting moved {moved}/{n} rows; "
              f"min |pivot| = {pivots.min():.6e}")

    print(f"Time: {elapsed:f} seconds")
    obs.emit("reported_time", name="Time", seconds=elapsed)
    with obs.span("verify"):
        err = checks.max_rel_error(x, x_true)
    obs.emit("health", backend=args.backend, max_rel_error=err)
    print(f"Error: {err:e}")
    if not np.isfinite(err):
        if np.isnan(np.asarray(x, np.float64)).any():
            print("The matrix is singular", file=sys.stderr)
        else:
            print("Solve overflowed float32 range (matrix scaling problem, "
                  "not singularity)", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    with _common.joined(args), \
            _common.metrics_run(args, "gauss_external") as (rec, stream):
        rc = _run(args)
    if stream:
        print(f"Metrics: run {rec.run_id} appended to {stream}")
    return rc


if __name__ == "__main__":
    sys.exit(main())

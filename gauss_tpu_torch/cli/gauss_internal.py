"""Internal-input gauss driver: the synthetic benchmark system, self-timed.

The JAX package's ``gauss_internal`` surface on the port:
``python -m gauss_tpu_torch.cli.gauss_internal -s <n> -t <threads>
[--backend cuda|cuda-unblocked|cuda-rowelim|cuda-rowelim-step] [--verify]
[--device cuda|cpu]``, defaults
n=2048 / 32 threads, printing ``Application time: %f Secs`` over init +
solve. Invalid -s/-t values fall back to the defaults with a notice. Exit
code 1 when ``--verify`` fails or the matrix is singular.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from gauss_tpu_torch.cli import _common
from gauss_tpu_torch.io import synthetic
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    n = positive_int_or_default(args.s, DEFAULT_N, "matrix size")
    t = positive_int_or_default(args.t, DEFAULT_THREADS, "thread count")
    print(f"Computing Gaussian elimination: size {n} x {n}, "
          f"backend {args.backend}, threads/shards {t}")

    # Timed region = init + solve (the internal flavor); the device
    # backends stage the system before their span opens.
    t0 = time.perf_counter()
    a = synthetic.internal_matrix(n)
    b = synthetic.internal_rhs(n)
    init_elapsed = time.perf_counter() - t0

    x, solve_elapsed = _common.solve_with_backend(
        a, b, args.backend, nthreads=t, pivoting=args.pivoting,
        refine_iters=args.refine, panel=args.panel,
        refine_tol=args.refine_tol, device=args.device)
    print(f"Application time: {init_elapsed + solve_elapsed:f} Secs")

    if args.verify:
        ok = checks.internal_pattern_ok(x, atol=1e-4)
        res = checks.residual_norm(a, x, b)
        print(f"Verification: solution pattern (-0.5, 0...0, 0.5) "
              f"{'OK' if ok else 'FAILED'}")
        print(f"Residual ||Ax-b||: {res:e}")
        if not ok or not np.isfinite(res):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

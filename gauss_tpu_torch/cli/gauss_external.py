"""External-input gauss driver: ``.dat`` file, manufactured-solution oracle.

The JAX package's ``gauss_external`` surface on the port:
``python -m gauss_tpu_torch.cli.gauss_external <matrixfile> [threads]
[--device cuda|cpu]`` — parse and densify the coordinate file, build the
RHS from the preset solution X[i] = i + 1, time the solve, print::

    Time: %f seconds
    Error: %e

where Error is the max relative error against X. Exit code 1 on an
unreadable file or a non-finite solution.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from gauss_tpu_torch.cli import _common
from gauss_tpu_torch.io import datfile, synthetic
from gauss_tpu_torch.verify import checks


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gauss_external",
        description="Gaussian elimination on a .dat coordinate-format matrix "
                    "(PyTorch/CUDA port).")
    p.add_argument("matrixfile", help="path to the .dat matrix file")
    p.add_argument("threads", nargs="?", type=int, default=0,
                   help="threads / shards (accepted for parity)")
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        a = datfile.read_dat_dense(args.matrixfile)
    except (OSError, ValueError) as e:
        print(f"gauss_external: cannot read '{args.matrixfile}': {e}",
              file=sys.stderr)
        return 1
    n = a.shape[0]
    x_true = synthetic.manufactured_solution(n)
    b = synthetic.manufactured_rhs(a, x_true)
    print(f"Matrix {args.matrixfile}: {n} x {n}, backend {args.backend}")

    x, elapsed = _common.solve_with_backend(
        a, b, args.backend, nthreads=args.threads, pivoting="partial",
        refine_iters=args.refine, panel=args.panel,
        refine_tol=args.refine_tol, device=args.device)
    print(f"Time: {elapsed:f} seconds")
    err = checks.max_rel_error(x, x_true)
    print(f"Error: {err:e}")
    if not np.isfinite(err):
        if np.isnan(np.asarray(x, np.float64)).any():
            print("The matrix is singular", file=sys.stderr)
        else:
            print("Solve overflowed float32 range (matrix scaling problem, "
                  "not singularity)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

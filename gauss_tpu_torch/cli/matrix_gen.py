"""Matrix generator CLI: emits a synthetic matrix in .dat format to stdout.

Reference surface (matrices_dense/matrix_gen.cc + Makefile): ``./matrix_gen <n>``.
Without ``--python`` (or ``--structure``) it runs the native C++ tool
(:mod:`gauss_tpu_torch.native`, built at first use); with it, the Python
writer, whose bytes are the same. A native build that fails exits 1 with
make's error instead of taking the Python writer.

``--structure`` extends the reference surface with the structure classes the
router (:mod:`gauss_tpu_torch.structure`) recognizes — ``spd``, ``banded:<b>``,
``blockdiag:<k>``, ``dense``, ``sparse:<nnz_per_row>`` — in the SAME
reference-compatible ``.dat`` coordinate format (sparse classes drop exact
zeros, which is exactly what a coordinate format is for), so datasets,
serving loadgen mixes, and the chaos campaign can exercise the structured
engines end to end. The ``sparse`` mode emits its coordinates DIRECTLY
(io.synthetic.sparse_coords -> write_dat): no n x n buffer exists at any
point, so ``gauss-matrix-gen 1000000 --structure sparse:8`` is an O(nnz)
operation end to end.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from gauss_tpu_torch.io import datfile, synthetic


def structured_matrix(n: int, structure: str):
    """Build the operand for a ``--structure`` spec; returns
    ``(matrix, drop_zeros)`` where ``matrix`` is a dense ndarray for the
    dense-backed classes and a ``(rows, cols, vals)`` coordinate triple for
    ``sparse`` (which is never densified). Specs: ``spd``, ``banded:<b>``
    (default b=1), ``blockdiag:<k>`` (block size, default max(1, n // 8)),
    ``dense``, ``sparse:<nnz_per_row>`` (default 8)."""
    kind, _, arg = structure.partition(":")
    if kind == "spd":
        return synthetic.spd_matrix(n), False
    if kind == "banded":
        return synthetic.banded_matrix(n, int(arg) if arg else 1), True
    if kind == "blockdiag":
        block = int(arg) if arg else max(1, n // 8)
        return synthetic.blockdiag_matrix(n, block), True
    if kind == "dense":
        return synthetic.dense_matrix(n), False
    if kind == "sparse":
        nnz_per_row = int(arg) if arg else 8
        if nnz_per_row < 1:
            raise ValueError(
                f"sparse:<nnz_per_row> must be >= 1, got {nnz_per_row}")
        return synthetic.sparse_coords(n, nnz_per_row=nnz_per_row), True
    raise ValueError(
        f"unknown --structure {structure!r}; options: spd, banded:<b>, "
        f"blockdiag:<k>, dense, sparse:<nnz_per_row>")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="matrix_gen",
        description="Emit a synthetic benchmark matrix in .dat coordinate format.")
    p.add_argument("n", type=int, help="matrix dimension")
    p.add_argument("--structure", default=None, metavar="SPEC",
                   help="structured generation mode: spd | banded:<b> | "
                        "blockdiag:<k> | dense (default: the reference "
                        "matrix_gen.cc min-matrix)")
    p.add_argument("--python", action="store_true",
                   help="force the Python writer (skip the native tool)")
    p.add_argument("--metrics-out", metavar="PATH", default=None,
                   help="append generation telemetry as JSONL to PATH")
    args = p.parse_args(argv)
    if args.n <= 0:
        print("matrix_gen: n must be positive", file=sys.stderr)
        return 1
    if args.structure is not None:
        try:
            matrix, drop_zeros = structured_matrix(args.n, args.structure)
        except ValueError as e:
            print(f"matrix_gen: {e}", file=sys.stderr)
            return 1
    else:
        matrix, drop_zeros = None, False

    from gauss_tpu_torch import obs

    with obs.run(metrics_out=args.metrics_out, tool="matrix_gen") as rec:
        obs.emit("config", tool="matrix_gen", n=args.n,
                 structure=args.structure)
        if not args.python and matrix is None:
            # The native C++ tool only knows the reference min-matrix;
            # structured modes always take the Python writer.
            from gauss_tpu_torch import native

            try:
                gen = native.matrix_gen_path()
            except (native.NativeBuildError, native.NativeRefusedError) as e:
                print(f"matrix_gen: {e}", file=sys.stderr)
                return 1
            sys.stdout.flush()
            with obs.span("generate_native"):
                rc = subprocess.run([gen, str(args.n)],
                                    stdout=sys.stdout).returncode
        else:
            # Values are small integers, exact powers of rho, or float64
            # draws; .17g prints them with an exact round trip either way.
            with obs.span("generate_python"):
                if isinstance(matrix, tuple):
                    # The sparse class: coordinates straight to the
                    # writer — no n x n buffer at any n.
                    rows, cols, vals = matrix
                    datfile.write_dat(sys.stdout, n=args.n, rows=rows,
                                      cols=cols, vals=vals)
                else:
                    datfile.write_dat(
                        sys.stdout,
                        matrix if matrix is not None
                        else synthetic.generator_matrix(args.n),
                        drop_zeros=drop_zeros)
            rc = 0
    if args.metrics_out:
        print(f"Metrics: run {rec.run_id} appended to {args.metrics_out}",
              file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())

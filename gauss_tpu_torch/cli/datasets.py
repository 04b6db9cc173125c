"""Dataset CLI: regenerate the reference's test-matrix library as .dat files.

Usage: ``python -m gauss_tpu_torch.cli.datasets [names...] [--out DIR] [--list]``.
With no names, writes every registry matrix except the two largest (memplus,
matrix_2000), which are opt-in by name.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from gauss_tpu_torch.io import datasets

_LARGE = ("memplus", "matrix_2000")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="datasets",
        description="Regenerate the reference dataset matrices in .dat format.")
    p.add_argument("names", nargs="*", help="registry names (default: all small)")
    p.add_argument("--out", default="matrices_dense", help="output directory")
    p.add_argument("--list", action="store_true", help="list the registry and exit")
    p.add_argument("--metrics-out", metavar="PATH", default=None,
                   help="append per-dataset write telemetry as JSONL to PATH")
    args = p.parse_args(argv)

    if args.list:
        for name in datasets.dataset_names():
            n, nnz = datasets.REGISTRY[name]
            print(f"{name}: n={n} nnz={nnz}")
        return 0

    names = args.names or [n for n in datasets.dataset_names() if n not in _LARGE]
    bad = [n for n in names if n not in datasets.REGISTRY]
    if bad:
        print(f"datasets: unknown names {bad}; use --list", file=sys.stderr)
        return 1

    from gauss_tpu_torch import obs

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with obs.run(metrics_out=args.metrics_out, tool="datasets") as rec:
        obs.emit("config", tool="datasets", names=",".join(names),
                 out=str(out))
        for name in names:
            path = out / f"{name}.dat"
            with obs.span("write_dataset", dataset=name):
                datasets.write_dataset(name, path)
            n, nnz = datasets.REGISTRY[name]
            obs.counter("datasets_written")
            print(f"wrote {path} (n={n}, nnz={nnz})")
    if args.metrics_out:
        print(f"Metrics: run {rec.run_id} appended to {args.metrics_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

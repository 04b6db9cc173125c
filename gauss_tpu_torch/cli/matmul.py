"""Matmul driver: the device engines back to back, each timed and verified.

The JAX package's ``gauss-matmul`` surface on the port, after the
reference's ``./cuda_matmul <nsize>`` (CUDA_and_OpenMP/Version-2/
cuda_matmul.cu:104-187)::

    python -m gauss_tpu_torch.cli.matmul [nsize] [--engines E1,E2,...]
        [--precision highest|high|default] [--device cuda|cpu]

It fills ``A[idx] = idx+1`` and ``B[idx] = 1/(idx+1)`` (default nsize
1024), and per engine prints::

    <label> time: %f seconds (%.1f GFLOP/s) verify: OK|MISMATCH

where verify is the reference's epsilon comparator (eps = 1e-4, scaled by
max|C|) against the float64 product. Exit code 1 when any engine
mismatches. Engines: ``cuda`` (cuBLAS through ``core/matmul.matmul``, the
counterpart of the JAX package's XLA engine; the default),
``cuda-kernel`` (the tiled kernel, :func:`.kernels.matmul.matmul_tiled`)
and ``cuda-kernel-v1`` (the row-stripe kernel,
:func:`.kernels.matmul.matmul_stripe`). ``--precision`` unset keeps each
engine's default, ``"high"`` (the bf16x3 split) everywhere. A warm-up at
shape runs first (it builds the kernel and initialises cuBLAS); the timed
span includes the host-to-device copy of A and B and the fetch of C, as
the reference's does (cuda_matmul.cu:135-167).

Not ported yet: the ``seq``/``omp`` engines wait for the native CPU
engines, ``tpu-dist`` for the distributed plane, and ``--threads``,
``--trace`` and ``--metrics-out`` for the telemetry core.
"""

from __future__ import annotations

import argparse
import sys
from functools import partial

import numpy as np

from gauss_tpu_torch.cli import _common
from gauss_tpu_torch.utils.device import as_tensor, resolve_device
from gauss_tpu_torch.utils.timing import timed_fetch
from gauss_tpu_torch.verify import checks

DEFAULT_N = 1024  # reference default nsize (cuda_matmul.cu:16,105-111)
LABELS = {"cuda": "CUDA", "cuda-kernel": "CUDA-Kernel",
          "cuda-kernel-v1": "CUDA-Kernel-V1"}


def _inputs(n: int):
    idx = np.arange(n * n, dtype=np.float64)
    a = (idx + 1.0).reshape(n, n)
    b = (1.0 / (idx + 1.0)).reshape(n, n)
    return a, b


def _engine_fn(engine: str, precision: str | None = None):
    """The device matmul callable behind an engine name; ``precision``
    None keeps the engine's default ("high")."""
    from gauss_tpu_torch.core.matmul import matmul
    from gauss_tpu_torch.kernels.matmul import matmul_stripe, matmul_tiled

    mm = {"cuda": matmul, "cuda-kernel": matmul_tiled,
          "cuda-kernel-v1": matmul_stripe}[engine]
    return mm if precision is None else partial(mm, precision=precision)


def _run_device(a, b, engine: str, precision, dev):
    mm = _engine_fn(engine, precision)
    mm(as_tensor(a, dev), as_tensor(b, dev)).cpu()  # warm-up at shape
    elapsed, c = timed_fetch(
        lambda: mm(as_tensor(a, dev), as_tensor(b, dev)))
    return np.asarray(c, np.float64), elapsed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="matmul",
        description="Dense matmul benchmark (PyTorch/CUDA port of "
                    "cuda_matmul).")
    p.add_argument("nsize", nargs="?", type=int, default=DEFAULT_N)
    p.add_argument("--engines", default="cuda",
                   help="comma-separated subset of: "
                        f"{', '.join(_common.MATMUL_BACKENDS)}")
    p.add_argument("--precision", choices=("highest", "high", "default"),
                   default=None,
                   help="GEMM precision for every engine (default 'high', "
                        "the bf16x3 split; 'highest' is true float32)")
    p.add_argument("--device", choices=_common.DEVICES, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    args = p.parse_args(argv)
    n = args.nsize
    if n <= 0:
        print("matmul: nsize must be positive", file=sys.stderr)
        return 1
    engines = [e.strip() for e in args.engines.split(",") if e.strip()]
    bad = set(engines) - set(_common.MATMUL_BACKENDS)
    if bad or not engines:
        print(f"matmul: unknown engines {sorted(bad)}; "
              f"options: {_common.MATMUL_BACKENDS}", file=sys.stderr)
        return 1
    dev = resolve_device(args.device)

    a, b = _inputs(n)
    truth = a @ b  # float64 host truth for the epsilon comparator
    scale = float(np.abs(truth).max())
    failed = False
    for engine in engines:
        c, elapsed = _run_device(a, b, engine, args.precision, dev)
        ok = checks.elementwise_match(c, truth,
                                      epsilon=checks.EPSILON * scale)
        gflops = 2.0 * n ** 3 / elapsed / 1e9
        print(f"{LABELS[engine]} time: {elapsed:f} seconds "
              f"({gflops:.1f} GFLOP/s) "
              f"verify: {'OK' if ok else 'MISMATCH'}")
        failed |= not ok
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

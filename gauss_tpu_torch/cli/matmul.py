"""Matmul driver: the device engines back to back, each timed and verified.

The JAX package's ``gauss-matmul`` surface on the port, after the
reference's ``./cuda_matmul <nsize>`` (CUDA_and_OpenMP/Version-2/
cuda_matmul.cu:104-187)::

    python -m gauss_tpu_torch.cli.matmul [nsize] [--engines E1,E2,...]
        [-t THREADS] [--precision highest|high|default]
        [--device cuda|cpu] [--metrics-out PATH] [--trace DIR]
        [--coordinator HOST:PORT --num-processes N --process-id I]

It fills ``A[idx] = idx+1`` and ``B[idx] = 1/(idx+1)`` (default nsize
1024), and per engine prints::

    <label> time: %f seconds (%.1f GFLOP/s) verify: OK|MISMATCH

where verify is the reference's epsilon comparator (eps = 1e-4, scaled by
max|C|) against the float64 product. Exit code 1 when any engine
mismatches. Engines: ``cuda`` (cuBLAS through ``core/matmul.matmul``, the
counterpart of the JAX package's XLA engine), ``cuda-kernel`` (the tiled
kernel, :func:`.kernels.matmul.matmul_tiled`), ``cuda-kernel-v1`` (the
row-stripe kernel, :func:`.kernels.matmul.matmul_stripe`), ``cuda-dist``
(the sharded product, :func:`.dist.matmul_dist.matmul_dist`, on ``-t``
ranks — all the cards by default), and the native host engines ``seq``
and ``omp`` (``-t`` threads; all cores by default). The default run is
the JAX package's three-way comparison, ``cuda,seq,omp`` (the sequential
baseline is slow at large n: name the engines to leave it out).
``--precision`` unset keeps each device engine's default, ``"high"`` (the
bf16x3 split) everywhere. A warm-up at
shape runs first (it builds the kernel and initialises cuBLAS); the timed
span includes the host-to-device copy of A and B and the fetch of C, as
the reference's does (cuda_matmul.cu:135-167).

``--metrics-out`` records, as the JAX package does, the
``prepare_inputs`` span, per engine a ``matmul_warmup:<engine>`` compile
span, a ``verify`` span, the timed ``matmul:<engine>`` span (recorded
after the run), a ``reported_time`` and a ``health`` event;
``--trace DIR`` writes a ``torch.profiler`` Chrome trace of the engines'
runs into DIR.
"""

from __future__ import annotations

import argparse
import sys
from functools import partial

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.cli import _common
from gauss_tpu_torch.utils import profiling
from gauss_tpu_torch.utils.device import as_tensor, resolve_device
from gauss_tpu_torch.utils.timing import timed_fetch
from gauss_tpu_torch.verify import checks

DEFAULT_N = 1024  # reference default nsize (cuda_matmul.cu:16,105-111)
LABELS = {"cuda": "CUDA", "cuda-kernel": "CUDA-Kernel",
          "cuda-kernel-v1": "CUDA-Kernel-V1",
          "cuda-dist": "CUDA-Dist (sharded)", "seq": "Sequential",
          "omp": "OpenMP"}


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
    with obs.compile_span(f"matmul_warmup:{engine}", n=a.shape[0]):
        mm(as_tensor(a, dev), as_tensor(b, dev)).cpu()  # warm-up at shape
    elapsed, c = timed_fetch(
        lambda: mm(as_tensor(a, dev), as_tensor(b, dev)))
    return np.asarray(c, np.float64), elapsed


def dist_matmul_job(a, b, precision, mesh=None):
    """One rank's part of the ``cuda-dist`` engine (run on every rank by
    :func:`gauss_tpu_torch.dist.launch.run`): a warm-up at shape, then
    the sharded product timed with its fetch."""
    from gauss_tpu_torch.dist.matmul_dist import matmul_dist

    kw = {} if precision is None else {"precision": precision}
    with obs.compile_span("matmul_warmup:cuda-dist", n=a.shape[0]):
        matmul_dist(a, b, mesh, **kw).cpu()
    elapsed, c = timed_fetch(lambda: matmul_dist(a, b, mesh, **kw))
    return np.asarray(c, np.float64), elapsed


def _run_dist(a, b, precision, nthreads, dev):
    from gauss_tpu_torch.dist import launch

    return launch.run(nthreads, dist_matmul_job, a, b, precision,
                      mesh="1d", device=dev.type)


def _run_native(a, b, engine, nthreads):
    from gauss_tpu_torch import native

    elapsed, c = timed_fetch(native.matmul, a, b, engine=engine,
                             nthreads=nthreads)
    return c, elapsed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="matmul",
        description="Dense matmul benchmark (PyTorch/CUDA port of "
                    "cuda_matmul).")
    p.add_argument("nsize", nargs="?", type=int, default=DEFAULT_N)
    p.add_argument("--engines", default="cuda,seq,omp",
                   help="comma-separated subset of: "
                        f"{', '.join(_common.MATMUL_BACKENDS)}")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="threads of the omp engine, ranks of cuda-dist "
                        "(default: all)")
    p.add_argument("--precision", choices=("highest", "high", "default"),
                   default=None,
                   help="GEMM precision for every engine (default 'high', "
                        "the bf16x3 split; 'highest' is true float32)")
    p.add_argument("--device", choices=_common.DEVICES, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    p.add_argument("--trace", "--trace-dir", dest="trace", metavar="DIR",
                   default=None,
                   help="write a torch.profiler Chrome trace into DIR")
    p.add_argument("--metrics-out", metavar="PATH", default=None,
                   help="append this run's telemetry as JSONL to PATH; "
                        "render with `python -m "
                        "gauss_tpu_torch.obs.summarize`")
    from gauss_tpu_torch.dist import multihost

    multihost.add_multihost_args(p)
    args = p.parse_args(argv)
    with _common.joined(args):
        return _main(args)


def _main(args) -> int:
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
    with _common.metrics_run(args, "matmul") as (rec, stream):
        obs.emit("config", tool="matmul", n=n, engines=",".join(engines),
                 device=dev.type)
        with obs.span("prepare_inputs"):
            a, b = _inputs(n)
            truth = a @ b  # float64 host truth for the epsilon comparator
            scale = float(np.abs(truth).max())
        failed = False
        with profiling.trace(args.trace, dev):
            for engine in engines:
                if engine in ("seq", "omp"):
                    c, elapsed = _run_native(a, b, engine, args.threads)
                elif engine == "cuda-dist":
                    c, elapsed = _run_dist(a, b, args.precision,
                                           args.threads, dev)
                else:
                    c, elapsed = _run_device(a, b, engine, args.precision,
                                             dev)
                with obs.span("verify"):
                    ok = checks.elementwise_match(
                        c, truth, epsilon=checks.EPSILON * scale)
                label = LABELS[engine]
                obs.record_span(f"matmul:{engine}", elapsed, backend=engine)
                obs.emit("reported_time", name=f"{label} time",
                         seconds=elapsed)
                if obs.active() is not None:
                    obs.emit("health", backend=engine, verified=ok,
                             max_rel_diff=float(
                                 np.max(np.abs(c - truth))) / scale)
                gflops = 2.0 * n ** 3 / elapsed / 1e9
                print(f"{label} time: {elapsed:f} seconds "
                      f"({gflops:.1f} GFLOP/s) "
                      f"verify: {'OK' if ok else 'MISMATCH'}")
                failed |= not ok
    if stream:
        print(f"Metrics: run {rec.run_id} appended to {stream}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

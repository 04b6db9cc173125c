"""Shared CLI machinery: backend dispatch and reference-parity timing spans.

Backends (the port's names for the JAX package's ``tpu``,
``tpu-unblocked``, ``tpu-rowelim``, ``tpu-rowelim-step`` and ``tpu-dist*``;
the native names are the JAX package's):

    cuda               blocked LU (hand-written panel and fused
                       panel+trailing kernels), f32 + iterative refinement
    cuda-unblocked     the unblocked rank-1 elimination oracle
    cuda-rowelim       row elimination, k steps per group (panel kernel +
                       rank-k update kernel), f32, no refinement
    cuda-rowelim-step  row elimination, one step kernel per pivot, f32, no
                       refinement
    cuda-dist          row-cyclic elimination over a mesh of ranks (the
                       reference MPI engine's per-pivot-step protocol,
                       dist.gauss_dist); -t selects the rank count
    cuda-dist2d        2-D cyclic elimination (dist.gauss_dist2d); -t
                       ranks factored into the squarest R x C grid
    cuda-dist-blocked  panel-blocked distributed LU, kernel 1 on each
                       replicated panel strip (dist.gauss_dist_blocked)
    cuda-dist-blocked2d  2-D panel-blocked LU with tournament pivoting
                       (dist.gauss_dist_blocked2d)
    seq|omp|threads|forkjoin|tiled  the native C++ host engines (native/)

The distributed backends run on ``-t`` ranks started by
:mod:`gauss_tpu_torch.dist.launch` (on ``cuda`` clamped to the cards
present, one card each; a world of one runs in this process), or, under
the multihost flags, on the world this process joined.

Matmul engines (``MATMUL_BACKENDS``, the port's names for ``tpu``,
``tpu-pallas``, ``tpu-pallas-v1`` and ``tpu-dist``): ``cuda`` (cuBLAS
through ``core/matmul``), ``cuda-kernel`` (the tiled kernel),
``cuda-kernel-v1`` (the row-stripe kernel), ``cuda-dist`` (the sharded
product, dist.matmul_dist), and the native ``seq`` and ``omp``.

Timing follows the JAX package: the system is staged to the device (f32
cast + host-to-device copy) BEFORE the span opens, a warm-up solve at the
same shape runs first (it builds the kernels at first use and initialises
cuBLAS, so neither bills to the span), and the span ends with a device
synchronize and a host fetch of the solution vector.

The distributed backends follow the JAX package's protocol: a warm-up at
the same shape on a staged identity, the real system staged outside the
span, then solve and fetch timed alone (on every rank; rank 0's time is
reported).

Telemetry follows the JAX package too: under ``--metrics-out`` the
staging (``host_staging``, ``host_staging_ds``), each warm-up (a
``compile:<label>`` span and a ``compile`` event) and the health monitors
(``health_monitors``) are spans, and the timed solve is recorded
afterwards as ``computeGauss`` — no span opens inside it. Backend names in
the stream are the port's (``cuda`` for ``tpu``, ``cuda[ds]`` for
``tpu[ds]``). Without ``--metrics-out`` no recorder is active: the
health reductions do not run, and a run launches, synchronizes and
prints what it did before the telemetry existed.

On a multi-process launch each process writes its own stream
(``<base>.p<id><ext>``) under one shared run id
(:func:`gauss_tpu_torch.dist.multihost.resolve_metrics_stream`); the
``collective`` events of a solve on ranks this process started are
re-emitted into its stream.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from gauss_tpu_torch import obs
from gauss_tpu_torch.utils.device import as_tensor, resolve_device
from gauss_tpu_torch.utils.timing import timed_fetch

NATIVE_BACKENDS = ("seq", "omp", "threads", "forkjoin", "tiled")
DIST_BACKENDS = ("cuda-dist", "cuda-dist2d", "cuda-dist-blocked",
                 "cuda-dist-blocked2d")
GAUSS_BACKENDS = ("cuda", "cuda-unblocked", "cuda-rowelim",
                  "cuda-rowelim-step") + DIST_BACKENDS + NATIVE_BACKENDS
MATMUL_BACKENDS = ("cuda", "cuda-kernel", "cuda-kernel-v1", "cuda-dist",
                   "seq", "omp")
DEVICES = ("cuda", "cpu")

# The internal flavor's swap-on-zero pivot policy lives on the oracle
# backend only; the blocked backend always pivots partially.
FIRST_NONZERO_BACKENDS = ("cuda-unblocked",)

# Minimum size for the on-device double-single refinement route: below it
# host-refined-with-early-exit stays the route (the JAX package's gate).
DS_ROUTE_MIN_N = 512


def resolve_pivoting(pivoting: str | None, backend: str) -> str:
    """``None`` -> the policy the backend implements (first_nonzero on the
    oracle, partial elsewhere); an explicit first_nonzero on a
    partial-only backend prints a notice and runs partial."""
    if pivoting is None:
        return ("first_nonzero" if backend in FIRST_NONZERO_BACKENDS
                else "partial")
    if pivoting == "first_nonzero" and backend not in FIRST_NONZERO_BACKENDS:
        import sys

        print(f"Note: backend '{backend}' always uses partial pivoting "
              f"(max-|column|); --pivoting first_nonzero is honored by: "
              f"{', '.join(FIRST_NONZERO_BACKENDS)}.", file=sys.stderr)
        return "partial"
    return pivoting


@contextlib.contextmanager
def metrics_run(args, tool: str, **meta):
    """The CLIs' ``obs.run`` wrapper, multi-process aware. Yields
    ``(recorder, stream_path)``: with ``args.metrics_out`` a recorder is
    active for the block and flushed to the path
    :func:`~gauss_tpu_torch.dist.multihost.resolve_metrics_stream` names
    (``<base>.p<id><ext>`` and one shared run id on a multi-process
    launch, the path as given otherwise); without it, ``(None, None)`` and
    no recorder, so every telemetry hook is a no-op (the JAX package
    activates an in-memory recorder here; the port does not). Print the
    yielded path: it names the file that exists."""
    from gauss_tpu_torch.dist import multihost

    path, run_id = multihost.resolve_metrics_stream(
        getattr(args, "metrics_out", None),
        coordinator=getattr(args, "coordinator", None),
        process_id=getattr(args, "process_id", None))
    if not path:
        yield None, None
        return
    with obs.run(metrics_out=path, run_id=run_id, tool=tool, **meta) as rec:
        yield rec, path


@contextlib.contextmanager
def joined(args):
    """Join the multi-process launch the multihost flags (or their
    environment) name for the block, printing the rank banner, and leave
    it at the end. Without them, nothing: the distributed backends then
    run on the world a caller started, or on one of their own."""
    from gauss_tpu_torch.dist import multihost

    if not multihost.maybe_initialize_from_args(args):
        yield
        return
    print(multihost.process_banner())
    try:
        yield
    finally:
        multihost.shutdown()


def _stage(dev: torch.device, *arrays):
    """float32 copies on ``dev``, complete before any span opens."""
    with obs.span("host_staging"):
        staged = [as_tensor(a, dev) for a in arrays]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return staged


def _solve_cuda_blocked(a64, b64, refine_iters, panel, refine_tol, dev):
    from gauss_tpu_torch.core import blocked

    n = len(b64)
    holder = {}
    if refine_iters > 2 and n >= DS_ROUTE_MIN_N:
        # The whole refinement budget on the device with double-single
        # residuals; refine_tol does not apply (no host residual to test).
        from gauss_tpu_torch.core import dsfloat

        eye = np.eye(n)
        with obs.compile_span("cuda_ds_warmup", n=n):
            x_w, _ = dsfloat.solve_once_ds(
                _stage(dev, eye)[0], dsfloat.to_ds(eye.T, dev),
                dsfloat.to_ds(np.zeros(n), dev), panel, iters=refine_iters)
            dsfloat.ds_to_f64(x_w)
        with obs.span("host_staging_ds"):
            a_dev = _stage(dev, a64)[0]
            at_ds = dsfloat.to_ds(np.asarray(a64, np.float64).T, dev)
            b_ds = dsfloat.to_ds(np.asarray(b64, np.float64), dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def _solve_ds():
            x_ds, holder["fac"] = dsfloat.solve_once_ds(
                a_dev, at_ds, b_ds, panel, iters=refine_iters)
            return torch.stack([x_ds.hi, x_ds.lo])

        elapsed, hl = timed_fetch(_solve_ds)
        x = hl[0].astype(np.float64) + hl[1].astype(np.float64)
        with obs.span("health_monitors"):
            obs.record_solve_health(a=a64, x=x, b=b64,
                                    factors=holder.get("fac"), n=n,
                                    backend="cuda[ds]")
        return x, elapsed

    with obs.compile_span("cuda_blocked_warmup", n=n):
        w_a, w_b = np.eye(n), np.zeros(n)
        blocked.solve_refined(w_a, w_b, panel=panel, iters=refine_iters,
                              a_dev=_stage(dev, w_a)[0],
                              b_dev=_stage(dev, w_b)[0])
    a_dev, b_dev = _stage(dev, a64, b64)

    # Only x leaves the span; the factors stay on the device in the holder
    # for the health monitors below.
    def _solve():
        x, holder["fac"] = blocked.solve_refined(
            a64, b64, panel=panel, iters=refine_iters, a_dev=a_dev,
            b_dev=b_dev, tol=refine_tol)
        return x

    elapsed, x = timed_fetch(_solve)
    with obs.span("health_monitors"):
        obs.record_solve_health(a=a64, x=x, b=b64, factors=holder.get("fac"),
                                n=n, backend="cuda")
    return x, elapsed


def _solve_cuda_unblocked(a64, b64, pivoting, dev):
    from gauss_tpu_torch.core.gauss import gauss_solve

    n = len(b64)
    with obs.compile_span("cuda_unblocked_warmup", n=n):
        gauss_solve(np.eye(n), np.zeros(n), pivoting=pivoting,
                    device=dev).cpu()  # warm-up at shape
    a_dev, b_dev = _stage(dev, a64, b64)
    elapsed, x = timed_fetch(
        lambda: gauss_solve(a_dev, b_dev, pivoting=pivoting, device=dev))
    return np.asarray(x, np.float64), elapsed


def _solve_cuda_rowelim(a64, b64, batched: bool, dev):
    from gauss_tpu_torch.kernels import rowelim

    solve = (rowelim.gauss_solve_rowelim_batched if batched
             else rowelim.gauss_solve_rowelim)
    n = len(b64)
    label = "cuda_rowelim_warmup" if batched else "cuda_rowelim_step_warmup"
    with obs.compile_span(label, n=n):
        solve(np.eye(n), np.zeros(n), device=dev).cpu()  # warm-up at shape
    a_dev, b_dev = _stage(dev, a64, b64)
    elapsed, x = timed_fetch(lambda: solve(a_dev, b_dev, device=dev))
    return np.asarray(x, np.float64), elapsed


def _solve_dist_generic(a64, b64, prepare_fn, solve_fn):
    """The JAX package's distributed timing protocol: warm up on a staged
    identity at the same shape, free it, stage the real system OUTSIDE
    the span, then time solve + fetch alone."""
    n = len(b64)
    with obs.compile_span("dist_warmup", n=n):
        warm = prepare_fn(np.eye(n, dtype=np.float32),
                          np.zeros(n, dtype=np.float32))
        np.asarray(solve_fn(warm).cpu())
    del warm
    with obs.span("host_staging_dist"):
        staged = prepare_fn(a64.astype(np.float32), b64.astype(np.float32))
    elapsed, x = timed_fetch(lambda: solve_fn(staged))
    return np.asarray(x, np.float64), elapsed


def dist_engine(backend: str):
    """``(prepare(a, b, mesh), solve(staged, mesh), mesh kind)`` of a
    distributed backend."""
    from gauss_tpu_torch.dist import (gauss_dist, gauss_dist2d,
                                      gauss_dist_blocked as gdb,
                                      gauss_dist_blocked2d as g2d)

    return {"cuda-dist": (gauss_dist.prepare_dist,
                          gauss_dist.solve_dist_staged, "1d"),
            "cuda-dist2d": (gauss_dist2d.prepare_dist2d,
                            gauss_dist2d.solve_dist2d_staged, "2d"),
            "cuda-dist-blocked": (gdb.prepare_dist_blocked,
                                  gdb.solve_dist_blocked_staged, "1d"),
            "cuda-dist-blocked2d": (g2d.prepare_dist_blocked2d,
                                    g2d.solve_dist_blocked2d_staged,
                                    "2d")}[backend]


def dist_solve_job(a64, b64, backend: str, record: bool = False,
                   mesh=None):
    """One rank's part of a distributed CLI solve (run on every rank by
    :func:`gauss_tpu_torch.dist.launch.run`): returns ``(x, seconds,
    collective events)``; with ``record`` the rank records its solve in a
    recorder of its own and returns the ``collective`` events for the
    launching process's stream."""
    prepare, solve, _ = dist_engine(backend)

    def go():
        return _solve_dist_generic(a64, b64,
                                   lambda a, b: prepare(a, b, mesh),
                                   lambda staged: solve(staged, mesh))

    if not record:
        return go() + ([],)
    with obs.run() as rec:
        x, elapsed = go()
    return x, elapsed, [ev for ev in rec.events
                        if ev.get("type") == "collective"]


def _solve_dist(a64, b64, backend, nthreads, device):
    import torch.distributed as dist

    from gauss_tpu_torch.dist import launch

    spawned = (not dist.is_initialized()
               and launch.clamp_ranks(nthreads, device) > 1)
    record = spawned and obs.active() is not None
    x, elapsed, events = launch.run(
        nthreads, dist_solve_job, a64, b64, backend, record,
        mesh=dist_engine(backend)[2], device=device)
    for ev in events:
        fields = {k: v for k, v in ev.items()
                  if k not in ("type", "run", "seq", "t", "trace")}
        obs.emit("collective", **fields)
        obs.counter(f"collective.{ev['op']}.count", ev["count"])
        obs.counter(f"collective.{ev['op']}.bytes", ev["bytes"])
    return x, elapsed


def _solve_native(a64, b64, backend, nthreads):
    from gauss_tpu_torch import native

    elapsed, x = timed_fetch(native.gauss_solve, a64, b64, engine=backend,
                             nthreads=nthreads)
    return x, elapsed


def solve_with_backend(a64: np.ndarray, b64: np.ndarray, backend: str,
                       nthreads: int = 0, pivoting: str | None = None,
                       refine_iters: int = 8, panel: int | None = None,
                       refine_tol: float = 1e-5, device=None):
    """Dispatch a solve; returns ``(x_float64, elapsed_seconds)``.

    ``device``: ``cuda`` (None) or ``cpu``. ``nthreads``: the rank count
    of the distributed backends (clamped to the cards on ``cuda``) and the
    thread count of the native ones (0: all cores).
    ``refine_iters``/``refine_tol``/``panel`` apply to the blocked backend
    only (the row-elimination backends do not refine): with
    ``refine_iters <= 2`` or ``n < DS_ROUTE_MIN_N`` it refines host-side
    (float64 residuals) and stops early at
    ``||Ax-b|| <= refine_tol * min(1, ||b||)``; with a larger budget at or
    above the gate the whole budget runs on the device with double-single
    residuals."""
    pivoting = resolve_pivoting(pivoting, backend)
    if backend in NATIVE_BACKENDS:
        x, elapsed = _solve_native(a64, b64, backend, nthreads)
    elif backend in DIST_BACKENDS:
        resolve_device(device)
        x, elapsed = _solve_dist(a64, b64, backend, nthreads, device)
    else:
        x, elapsed = _solve_device(a64, b64, backend, pivoting,
                                   refine_iters, panel, refine_tol, device)
    # Telemetry: the solve span (measured by each backend's protocol
    # above) and, for the backends whose path did not record factor-level
    # monitors, the generic solution-health event.
    obs.record_span("computeGauss", elapsed, backend=backend)
    if backend != "cuda" and obs.active() is not None:
        with obs.span("health_monitors"):
            obs.record_solve_health(a=a64, x=x, b=b64, backend=backend)
    return x, elapsed


def _solve_device(a64, b64, backend, pivoting, refine_iters, panel,
                  refine_tol, device):
    dev = resolve_device(device)
    if backend == "cuda":
        x, elapsed = _solve_cuda_blocked(a64, b64, refine_iters, panel,
                                         refine_tol, dev)
    elif backend == "cuda-unblocked":
        x, elapsed = _solve_cuda_unblocked(a64, b64, pivoting, dev)
    elif backend in ("cuda-rowelim", "cuda-rowelim-step"):
        x, elapsed = _solve_cuda_rowelim(a64, b64,
                                         backend == "cuda-rowelim", dev)
    else:
        raise ValueError(
            f"unknown backend {backend!r}; options: {GAUSS_BACKENDS}")
    return x, elapsed

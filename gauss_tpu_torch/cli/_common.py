"""Shared CLI machinery: backend dispatch and reference-parity timing spans.

Backends (the port's names for the JAX package's ``tpu``,
``tpu-unblocked``, ``tpu-rowelim`` and ``tpu-rowelim-step``):

    cuda               blocked LU (hand-written panel and fused
                       panel+trailing kernels), f32 + iterative refinement
    cuda-unblocked     the unblocked rank-1 elimination oracle
    cuda-rowelim       row elimination, k steps per group (panel kernel +
                       rank-k update kernel), f32, no refinement
    cuda-rowelim-step  row elimination, one step kernel per pivot, f32, no
                       refinement

Matmul engines (``MATMUL_BACKENDS``, the port's names for ``tpu``,
``tpu-pallas`` and ``tpu-pallas-v1``): ``cuda`` (cuBLAS through
``core/matmul``), ``cuda-kernel`` (the tiled kernel) and ``cuda-kernel-v1``
(the row-stripe kernel).

Timing follows the JAX package: the system is staged to the device (f32
cast + host-to-device copy) BEFORE the span opens, a warm-up solve at the
same shape runs first (it builds the kernels at first use and initialises
cuBLAS, so neither bills to the span), and the span ends with a device
synchronize and a host fetch of the solution vector.

Telemetry follows the JAX package too: under ``--metrics-out`` the
staging (``host_staging``, ``host_staging_ds``), each warm-up (a
``compile:<label>`` span and a ``compile`` event) and the health monitors
(``health_monitors``) are spans, and the timed solve is recorded
afterwards as ``computeGauss`` — no span opens inside it. Backend names in
the stream are the port's (``cuda`` for ``tpu``, ``cuda[ds]`` for
``tpu[ds]``). Without ``--metrics-out`` no recorder is active: the
health reductions do not run, and a run launches, synchronizes and
prints what it did before the telemetry existed.

Not ported yet: multihost flags (and the per-process stream naming of
``--metrics-out``), and the native and distributed backends.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from gauss_tpu_torch import obs
from gauss_tpu_torch.utils.device import as_tensor, resolve_device
from gauss_tpu_torch.utils.timing import timed_fetch

GAUSS_BACKENDS = ("cuda", "cuda-unblocked", "cuda-rowelim",
                  "cuda-rowelim-step")
MATMUL_BACKENDS = ("cuda", "cuda-kernel", "cuda-kernel-v1")
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
    """The CLIs' ``obs.run`` wrapper. Yields ``(recorder,
    stream_path)``: with ``args.metrics_out`` a recorder is active for the
    block and flushed to that path at its end; without it, ``(None,
    None)`` and no recorder, so every telemetry hook is a no-op (the JAX
    package activates an in-memory recorder here; the port does not, so an
    unobserved run reduces and synchronizes nothing for it). Single-process
    only: the multihost stream naming comes with the distributed plane."""
    path = getattr(args, "metrics_out", None)
    if not path:
        yield None, None
        return
    with obs.run(metrics_out=path, tool=tool, **meta) as rec:
        yield rec, path


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


def solve_with_backend(a64: np.ndarray, b64: np.ndarray, backend: str,
                       nthreads: int = 0, pivoting: str | None = None,
                       refine_iters: int = 8, panel: int | None = None,
                       refine_tol: float = 1e-5, device=None):
    """Dispatch a solve; returns ``(x_float64, elapsed_seconds)``.

    ``device``: ``cuda`` (None) or ``cpu``. ``nthreads`` is accepted for
    parity with the JAX package's drivers (no backend here uses it).
    ``refine_iters``/``refine_tol``/``panel`` apply to the blocked backend
    only (the row-elimination backends do not refine): with
    ``refine_iters <= 2`` or ``n < DS_ROUTE_MIN_N`` it refines host-side
    (float64 residuals) and stops early at
    ``||Ax-b|| <= refine_tol * min(1, ||b||)``; with a larger budget at or
    above the gate the whole budget runs on the device with double-single
    residuals."""
    del nthreads
    pivoting = resolve_pivoting(pivoting, backend)
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
    # Telemetry: the solve span (measured by each backend's protocol
    # above) and, for the backends whose path did not record factor-level
    # monitors, the generic solution-health event.
    obs.record_span("computeGauss", elapsed, backend=backend)
    if backend != "cuda" and obs.active() is not None:
        with obs.span("health_monitors"):
            obs.record_solve_health(a=a64, x=x, b=b64, backend=backend)
    return x, elapsed

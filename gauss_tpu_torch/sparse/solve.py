"""``solve_sparse`` — the sparse plane's host driver: method selection and
the 1e-4 verify. Port of ``gauss_tpu/sparse/solve.py``.

Method routing mirrors the dense router's certify-then-demote shape:

- ``method="auto"`` tries CG first iff the operand carries the
  Gershgorin SPD certificate (the proof, not a heuristic), then falls
  through to GMRES(restart) and BiCGStab on stagnation; the LAST typed
  :class:`~gauss_tpu_torch.sparse.krylov.IterativeStagnationError`
  propagates when every method stalls — a caller's signal to densify.
- an explicit method runs exactly that solver (CG still demands the
  certificate — typed ``NotSPDError`` otherwise).

Every attempt emits a ``sparse_solve`` event on the active ``obs``
recorder, with the JAX package's fields (the iteration count and a
downsampled residual curve among them), and counts ``sparse.solves`` or
``sparse.stagnations``. With no recorder active the SPD certificate of an
explicit method is not computed: the event is its only reader.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.sparse.csr import CsrMatrix
from gauss_tpu_torch.sparse.krylov import (
    DEFAULT_MAXITER,
    DEFAULT_TOL,
    IterativeStagnationError,
    SparseSolveResult,
    solve_bicgstab,
    solve_cg,
    solve_gmres,
)

__all__ = ["solve_sparse"]

#: residual-curve points kept on the event (downsampled; full curves ride
#: the SparseSolveResult, not the telemetry stream).
_CURVE_POINTS = 33

_SOLVERS = {"cg": solve_cg, "gmres": solve_gmres, "bicgstab": solve_bicgstab}


def _downsample(curve: np.ndarray, points: int = _CURVE_POINTS) -> list:
    curve = np.asarray(curve, dtype=np.float64)
    if curve.size > points:
        idx = np.linspace(0, curve.size - 1, points).round().astype(int)
        curve = curve[np.unique(idx)]
    return [float(f"{v:.6g}") for v in curve]


def solve_sparse(
    a,
    b,
    *,
    method: str = "auto",
    precond: str = "auto",
    gate: float = DEFAULT_TOL,
    restart: Optional[int] = None,
    maxiter: int = DEFAULT_MAXITER,
    block: Optional[int] = None,
    x0=None,
    device=None,
) -> SparseSolveResult:
    """Solve ``a @ x = b`` iteratively on ``device`` (default ``cuda``);
    ``a`` is a :class:`CsrMatrix` (a small dense ndarray is converted).
    Never allocates an n x n buffer for CSR input."""
    if not isinstance(a, CsrMatrix):
        a = CsrMatrix.from_dense(np.asarray(a))
    observed = obs.active() is not None
    certified = (a.gershgorin_spd() if method == "auto" or observed
                 else None)
    if precond == "auto":
        precond = "jacobi"
    if method == "auto":
        methods: Sequence[str] = (
            ("cg", "gmres", "bicgstab") if certified else ("gmres", "bicgstab")
        )
    else:
        if method not in _SOLVERS:
            raise ValueError(
                f"unknown sparse method {method!r}; one of "
                f"{sorted(_SOLVERS)} or 'auto'"
            )
        methods = (method,)

    last_err: Optional[IterativeStagnationError] = None
    for m in methods:
        kwargs = dict(precond=precond, block=block, tol=gate,
                      maxiter=maxiter, x0=x0, device=device)
        if m == "gmres" and restart is not None:
            kwargs["restart"] = restart
        t0 = time.perf_counter()
        try:
            res = _SOLVERS[m](a, b, **kwargs)
        except IterativeStagnationError as e:
            last_err = e
            obs.counter("sparse.stagnations")
            _emit(a, m, precond, e.result, time.perf_counter() - t0,
                  certified)
            continue
        obs.counter("sparse.solves")
        _emit(a, m, precond, res, time.perf_counter() - t0, certified)
        return res
    raise last_err


def _emit(a, method, precond, res, wall_s, certified):
    if res is None or obs.active() is None:
        return
    obs.emit(
        "sparse_solve",
        n=a.n,
        nnz=a.nnz,
        density=round(a.density, 8),
        certified_spd=certified,
        method=method,
        precond=res.precond if res.precond else precond,
        iterations=res.iterations,
        converged=res.converged,
        rel_residual=float(res.rel_residual),
        residuals=_downsample(res.residuals),
        wall_s=round(wall_s, 6),
    )

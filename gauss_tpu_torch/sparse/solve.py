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

Not ported yet: the JAX package counts ``sparse.solves`` /
``sparse.stagnations`` and emits a ``sparse_solve`` event per attempt
through its ``obs`` core; the port has no ``obs`` yet, so an attempt
leaves its record in the returned (or raised) ``SparseSolveResult`` only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

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

_SOLVERS = {"cg": solve_cg, "gmres": solve_gmres, "bicgstab": solve_bicgstab}


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
    if precond == "auto":
        precond = "jacobi"
    if method == "auto":
        methods: Sequence[str] = (
            ("cg", "gmres", "bicgstab") if a.gershgorin_spd()
            else ("gmres", "bicgstab")
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
        try:
            return _SOLVERS[m](a, b, **kwargs)
        except IterativeStagnationError as e:
            last_err = e
    raise last_err

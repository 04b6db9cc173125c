"""Matrix-free Krylov solvers in float64 on the card.

Port of ``gauss_tpu/sparse/krylov.py``. Three cores, each the eager form of
the JAX package's ``lax.while_loop`` program, with its update order kept
line for line so iteration counts agree:

- :func:`cg_run` — preconditioned conjugate gradients. The host wrapper
  :func:`solve_cg` demands the Gershgorin SPD certificate
  (``CsrMatrix.gershgorin_spd``) before running it: an uncertified operand
  raises typed ``NotSPDError`` so a caller demotes to the general-system
  solvers instead of iterating blindly.
- :func:`gmres_run` — left-preconditioned GMRES(restart) with a CGS2
  (classical Gram-Schmidt, one reorthogonalization pass) Arnoldi inner
  loop. Peak memory is O(nnz + n * restart) for the resident basis.
- :func:`bicgstab_run` — BiCGStab with breakdown-guarded denominators; a
  breakdown stalls the residual and surfaces as stagnation.

Every matrix-vector product is :func:`~gauss_tpu_torch.sparse.spmv.
spmv_ell`: on CUDA tensors the hand-written kernel, one launch per
product (CG launches ``iterations + 1`` per solve, BiCGStab ``2 *
iterations + 1``, GMRES ``1 + cycles * (restart + 2)``).

Where the eager form costs: the loop condition ``(k < maxiter) & (rel >
tol)`` needs ``rel`` on the host, one device synchronisation per iteration
(per cycle in GMRES, whose small Hessenberg least-squares problem is also
solved on the host: the CUDA ``lstsq`` driver assumes full rank, which a
converged Arnoldi basis does not have). Every other scalar stays on the
device.

Every wrapper verifies the TRUE residual ``||b - A x|| / ||b||`` on the
host via the CSR matvec — the same 1e-4 gate as every dense engine — and
raises the typed :class:`IterativeStagnationError` when the budget runs
out above it. Each result carries the iteration count and the residual
curve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gauss_tpu_torch.sparse.csr import CsrMatrix
from gauss_tpu_torch.sparse.precond import (Preconditioner, apply_precond,
                                            build_preconditioner)
from gauss_tpu_torch.sparse.spmv import spmv_ell
from gauss_tpu_torch.structure.cholesky import NotSPDError
from gauss_tpu_torch.tune.space import SPARSE_RESTART_SEED
from gauss_tpu_torch.utils.device import resolve_device

__all__ = [
    "IterativeStagnationError",
    "SparseSolveResult",
    "bicgstab_run",
    "cg_run",
    "gmres_run",
    "solve_bicgstab",
    "solve_cg",
    "solve_gmres",
]

#: Same residual gate as the dense engines; a keyword default only.
DEFAULT_TOL = 1e-4

#: Default total matvec budget for the host wrappers.
DEFAULT_MAXITER = 400

_TINY = 1e-300


class IterativeStagnationError(RuntimeError):
    """A Krylov solver exhausted its iteration budget (or broke down)
    above the residual gate. Typed so a caller can demote to another
    method or to the dense chain instead of shipping an unverified answer.
    ``result`` carries the partial :class:`SparseSolveResult` for
    diagnostics."""

    def __init__(self, message, *, method=None, iterations=None,
                 rel_residual=None, result=None):
        super().__init__(message)
        self.method = method
        self.iterations = iterations
        self.rel_residual = rel_residual
        self.result = result


@dataclasses.dataclass(frozen=True)
class SparseSolveResult:
    """Solver outcome: ``x`` (float64 numpy, shape of ``b``), the method and
    preconditioner that produced it, the matvec/iteration count, the
    residual curve (relative, one entry per recorded step), and the TRUE
    host-verified relative residual."""

    x: np.ndarray
    method: str
    precond: str
    iterations: int
    residuals: np.ndarray
    converged: bool
    rel_residual: float


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    tiny = torch.full_like(den, _TINY)
    return num / torch.where(den.abs() > _TINY, den,
                             torch.where(den < 0, -tiny, tiny))


def _curve(values, length: int, like: torch.Tensor) -> torch.Tensor:
    """The recorded residuals, zero-filled to ``length``, on ``like``'s
    device."""
    out = np.zeros(length, dtype=np.float64)
    out[:len(values)] = values
    return torch.as_tensor(out, dtype=like.dtype, device=like.device)


def _bnorm(b: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.linalg.vector_norm(b), _TINY)


def cg_run(cols, vals, b, x0, prec, tol, *, maxiter):
    """Preconditioned CG core on tensors of one device (``cols`` (n, k)
    int32, ``vals`` (n, k), ``b`` and ``x0`` (n,), ``prec`` a
    :class:`Preconditioner` or None). Returns ``(x, iterations, curve,
    rel)``: ``x`` and ``curve`` tensors (``curve`` (maxiter+1,) with
    unreached entries zero), ``iterations`` an int and ``rel`` a float."""
    tol = float(tol)
    mv = lambda u: spmv_ell(cols, vals, u)  # noqa: E731
    bnorm = _bnorm(b)
    x = x0
    r = b - mv(x0)
    z = apply_precond(prec, r)
    p = z
    rz = r @ z
    rel = float(torch.linalg.vector_norm(r) / bnorm)
    curve = [rel]
    k = 0
    while k < maxiter and rel > tol:
        q = mv(p)
        alpha = _safe_div(rz, p @ q)
        x = x + alpha * p
        r = r - alpha * q
        z = apply_precond(prec, r)
        rz_new = r @ z
        p = z + _safe_div(rz_new, rz) * p
        rz = rz_new
        rel = float(torch.linalg.vector_norm(r) / bnorm)  # the host sync
        curve.append(rel)
        k += 1
    return x, k, _curve(curve, maxiter + 1, b), rel


def gmres_run(cols, vals, b, x0, prec, tol, *, restart, maxcycles):
    """Left-preconditioned GMRES(restart) core. Returns ``(x, cycles,
    curve, rel)``; ``curve`` holds the TRUE relative residual once per
    restart cycle, shaped (maxcycles+1,). Peak state is the (restart+1, n)
    basis."""
    tol = float(tol)
    n = b.shape[0]
    mv = lambda u: spmv_ell(cols, vals, u)  # noqa: E731
    bnorm = _bnorm(b)
    x = x0
    rel = float(torch.linalg.vector_norm(b - mv(x0)) / bnorm)
    curve = [rel]
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    c = 0
    while c < maxcycles and rel > tol:
        r = b - mv(x)
        z = apply_precond(prec, r)
        beta = torch.linalg.vector_norm(z)
        V = torch.zeros((restart + 1, n), dtype=b.dtype, device=b.device)
        V[0] = z / torch.clamp_min(beta, _TINY)
        H = torch.zeros((restart + 1, restart), dtype=b.dtype,
                        device=b.device)
        for j in range(restart):
            w = apply_precond(prec, mv(V[j]))
            # CGS2: project against the whole basis twice; unfilled rows of
            # V are zero so they contribute nothing to either pass.
            h1 = V @ w
            w = w - V.T @ h1
            h2 = V @ w
            w = w - V.T @ h2
            hnorm = torch.linalg.vector_norm(w)
            V[j + 1] = torch.where(hnorm > _TINY, w / hnorm, zero)
            H[:, j] = h1 + h2
            H[j + 1, j] = hnorm
        g = torch.zeros(restart + 1, dtype=b.dtype)
        g[0] = float(beta)
        # Minimum-norm least squares (SVD) on the host: H loses rank once
        # the basis has converged.
        y = torch.linalg.lstsq(H.cpu(), g[:, None], driver="gelsd").solution
        x = x + V[:restart].T @ y[:, 0].to(b.device)
        rel = float(torch.linalg.vector_norm(b - mv(x)) / bnorm)
        curve.append(rel)
        c += 1
    return x, c, _curve(curve, maxcycles + 1, b), rel


def bicgstab_run(cols, vals, b, x0, prec, tol, *, maxiter):
    """Preconditioned BiCGStab core with breakdown-guarded denominators.
    Returns ``(x, iterations, curve, rel)``; ``curve`` (maxiter+1,)."""
    tol = float(tol)
    mv = lambda u: spmv_ell(cols, vals, u)  # noqa: E731
    bnorm = _bnorm(b)
    x = x0
    r0 = b - mv(x0)
    r = r0
    rel = float(torch.linalg.vector_norm(r0) / bnorm)
    curve = [rel]
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    k = 0
    while k < maxiter and rel > tol:
        rho_new = r0 @ r
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        phat = apply_precond(prec, p)
        v = mv(phat)
        alpha = _safe_div(rho_new, r0 @ v)
        s = r - alpha * v
        shat = apply_precond(prec, s)
        t = mv(shat)
        omega = _safe_div(t @ s, t @ t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        rel = float(torch.linalg.vector_norm(r) / bnorm)  # the host sync
        curve.append(rel)
        k += 1
    return x, k, _curve(curve, maxiter + 1, b), rel


# ---------------------------------------------------------------------------
# Host wrappers: stage ELL arrays in f64 on the device, run the core, verify
# the TRUE residual on the host, raise typed on stagnation.
# ---------------------------------------------------------------------------

def _resolve_precond(a: CsrMatrix, precond, block, dev):
    if precond is None:
        precond = "none"
    if isinstance(precond, str):
        return build_preconditioner(a, precond, block=block,
                                    device=dev), precond
    arrays = tuple(t.to(dev) for t in precond.arrays)
    return Preconditioner(precond.kind, precond.meta, arrays), precond.kind


def _run_columns(a, b, run_one):
    """Apply a single-RHS solver columnwise for (n, k) b; returns the
    stacked x plus the worst column's (iterations, curve, rel)."""
    b = np.asarray(b, dtype=np.float64)
    if b.ndim == 1:
        return run_one(b)
    xs, worst = [], None
    for j in range(b.shape[1]):
        x, iters, curve, rel = run_one(b[:, j])
        xs.append(x)
        if worst is None or rel > worst[2]:
            worst = (iters, curve, rel)
    return np.stack(xs, axis=1), worst[0], worst[1], worst[2]


def _finish(a, b, x, iters, curve, method, pname, tol, raise_on_stagnation):
    b = np.asarray(b, dtype=np.float64)
    true_res = np.linalg.norm(b - a.matvec(x))
    rel = float(true_res / max(np.linalg.norm(b), _TINY))
    res = SparseSolveResult(
        x=np.asarray(x, dtype=np.float64),
        method=method,
        precond=pname,
        iterations=int(iters),
        residuals=np.asarray(curve, dtype=np.float64),
        converged=rel <= tol,
        rel_residual=rel,
    )
    if not res.converged and raise_on_stagnation:
        raise IterativeStagnationError(
            f"{method} stagnated: rel_residual={rel:.3e} > gate={tol:g} "
            f"after {res.iterations} iterations",
            method=method,
            iterations=res.iterations,
            rel_residual=rel,
            result=res,
        )
    return res


def _stage(a: CsrMatrix, dev):
    """The ELL arrays on ``dev``: int32 columns, float64 values."""
    cols, vals = a.ell()
    return (torch.as_tensor(cols, device=dev),
            torch.as_tensor(vals, dtype=torch.float64, device=dev))


def _solve(a, b, core, method, scale, *, precond, block, tol, x0,
           raise_on_stagnation, device, **static):
    """The shared body of the three wrappers: stage, run ``core`` per
    column, verify. ``scale`` turns the core's count into reported
    iterations (GMRES counts cycles, and records its curve per cycle)."""
    dev = resolve_device(device)
    prec, pname = _resolve_precond(a, precond, block, dev)
    cols, vals = _stage(a, dev)

    def run_one(b1):
        x0t = (torch.zeros(a.n, dtype=torch.float64, device=dev)
               if x0 is None else
               torch.as_tensor(np.asarray(x0, dtype=np.float64), device=dev))
        x, it, curve, rel = core(cols, vals, torch.as_tensor(b1, device=dev),
                                 x0t, prec, tol, **static)
        return x.cpu().numpy(), int(it) * scale, curve.cpu().numpy(), rel

    x, iters, curve, _ = _run_columns(a, b, run_one)
    # Trim the unreached entries (zeros past the count the core ran).
    curve = np.asarray(curve)[: iters // scale + 1]
    return _finish(a, b, x, iters, curve, method, pname, tol,
                   raise_on_stagnation)


def solve_cg(
    a: CsrMatrix,
    b,
    *,
    precond="jacobi",
    block: Optional[int] = None,
    tol: float = DEFAULT_TOL,
    maxiter: int = DEFAULT_MAXITER,
    x0=None,
    raise_on_stagnation: bool = True,
    device=None,
) -> SparseSolveResult:
    """Conjugate gradients on a Gershgorin-CERTIFIED SPD CsrMatrix, on
    ``device`` (default ``cuda``). Raises typed ``NotSPDError`` when the
    certificate fails and ``IterativeStagnationError`` on budget
    exhaustion above ``tol``."""
    if not a.gershgorin_spd():
        raise NotSPDError(
            "solve_cg requires the Gershgorin SPD certificate (symmetric, "
            "positive strictly dominant diagonal); route general systems "
            "to GMRES/BiCGStab"
        )
    return _solve(a, b, cg_run, "cg", 1, precond=precond, block=block,
                  tol=tol, x0=x0, raise_on_stagnation=raise_on_stagnation,
                  device=device, maxiter=maxiter)


def solve_gmres(
    a: CsrMatrix,
    b,
    *,
    precond="jacobi",
    block: Optional[int] = None,
    tol: float = DEFAULT_TOL,
    restart: int = SPARSE_RESTART_SEED,
    maxiter: int = DEFAULT_MAXITER,
    x0=None,
    raise_on_stagnation: bool = True,
    device=None,
) -> SparseSolveResult:
    """GMRES(restart) for general systems; ``maxiter`` bounds total inner
    iterations (cycles = ceil(maxiter / restart)). Reported iterations
    count inner steps (cycles * restart); the curve is per cycle."""
    restart = max(1, min(int(restart), a.n))
    maxcycles = max(1, -(-int(maxiter) // restart))
    return _solve(a, b, gmres_run, "gmres", restart, precond=precond,
                  block=block, tol=tol, x0=x0,
                  raise_on_stagnation=raise_on_stagnation, device=device,
                  restart=restart, maxcycles=maxcycles)


def solve_bicgstab(
    a: CsrMatrix,
    b,
    *,
    precond="jacobi",
    block: Optional[int] = None,
    tol: float = DEFAULT_TOL,
    maxiter: int = DEFAULT_MAXITER,
    x0=None,
    raise_on_stagnation: bool = True,
    device=None,
) -> SparseSolveResult:
    """BiCGStab for general systems (two matvecs per iteration)."""
    return _solve(a, b, bicgstab_run, "bicgstab", 1, precond=precond,
                  block=block, tol=tol, x0=x0,
                  raise_on_stagnation=raise_on_stagnation, device=device,
                  maxiter=maxiter)

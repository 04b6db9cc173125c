"""Gaussian elimination oracle: pivot, eliminate, back-substitute.

The unblocked elimination the JAX package runs as its ``tpu-unblocked``
backend and tests every blocked path against. One step per pivot: select
the pivot row, swap, scale the pivot row to a unit diagonal, and a masked
rank-1 update of the whole matrix (the finished region multiplies by zero).

Pivoting policies:

- ``"partial"``       — max-|column| partial pivoting (the external-input
                        programs' policy);
- ``"first_nonzero"`` — swap only when the diagonal is exactly zero, taking
                        the first nonzero row below (the internal-input
                        programs' policy), with the RHS swapped consistently;
- ``"none"``          — no pivoting.

The JAX package's fault-injection hook is not part of this port yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gauss_tpu_torch.utils.device import as_tensor, resolve_device

PIVOT_POLICIES = ("partial", "first_nonzero", "none")


class EliminationResult(NamedTuple):
    """Forward elimination of [A | b]: ``u`` upper with unit diagonal,
    ``y`` the transformed RHS, ``perm`` the applied row permutation
    (``perm[k]`` = original index of the row now at k), and
    ``min_abs_pivot`` (0 means singular)."""

    u: torch.Tensor
    y: torch.Tensor
    perm: torch.Tensor
    min_abs_pivot: torch.Tensor


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True (0 when none) — argmax of an integer mask
    returns the first maximal index."""
    return torch.argmax(mask.to(torch.int32))


def _select_pivot(col, i: int, idx, policy: str) -> torch.Tensor:
    if policy == "partial":
        cand = torch.where(idx >= i, col.abs(),
                           torch.full_like(col, float("-inf")))
        nan = torch.isnan(cand)
        best = torch.argmax(torch.where(nan, torch.full_like(cand,
                                                             float("-inf")),
                                        cand))
        # A NaN beats every number (the first NaN wins), as jnp.argmax.
        return torch.where(nan.any(), _first_true(nan), best)
    if policy == "first_nonzero":
        eligible = (col != 0) & (idx >= i)
        first = _first_true(eligible)
        i_t = torch.as_tensor(i, device=col.device)
        return torch.where(col[i] != 0, i_t,
                           torch.where(eligible.any(), first, i_t))
    if policy == "none":
        return torch.as_tensor(i, device=col.device)
    raise ValueError(f"unknown pivoting policy {policy!r}; "
                     f"expected one of {PIVOT_POLICIES}")


def eliminate(a, b, pivoting: str = "partial",
              device=None) -> EliminationResult:
    """Forward elimination of the dense system ``a @ x = b`` (float32)."""
    if pivoting not in PIVOT_POLICIES:
        raise ValueError(f"unknown pivoting policy {pivoting!r}; "
                         f"expected one of {PIVOT_POLICIES}")
    dev = resolve_device(device)
    A = as_tensor(a, dev).clone()
    rhs = as_tensor(b, dev).clone()
    n = A.shape[0]
    if A.shape != (n, n) or rhs.shape != (n,):
        raise ValueError(f"expected square a and matching b; got "
                         f"{tuple(A.shape)} and {tuple(rhs.shape)}")
    idx = torch.arange(n, device=dev)
    perm = idx.clone()
    min_piv = torch.full((), float("inf"), device=dev)
    zero = torch.zeros((), device=dev)
    for i in range(n):
        p = _select_pivot(A[:, i], i, idx, pivoting)
        swap = torch.stack([torch.as_tensor(i, device=dev), p])
        A[swap] = A[swap.flip(0)]
        rhs[swap] = rhs[swap.flip(0)]
        perm[swap] = perm[swap.flip(0)]
        piv = A[i, i].clone()
        apiv = piv.abs()
        # A NaN pivot means an earlier zero pivot already poisoned the
        # trailing rows; report it as singular (0), not NaN.
        min_piv = torch.minimum(min_piv,
                                torch.where(torch.isnan(apiv), zero, apiv))
        prow = A[i] / piv
        prow[i] = 1.0  # pinned: the eliminated subdiagonal is exactly 0
        yi = rhs[i] / piv
        A[i] = prow
        rhs[i] = yi
        factors = torch.where(idx > i, A[:, i], zero)
        A = A - factors[:, None] * prow[None, :]
        rhs = rhs - factors * yi
    return EliminationResult(u=A, y=rhs, perm=perm, min_abs_pivot=min_piv)


def back_substitute(u: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve ``u @ x = y`` for upper-triangular ``u`` bottom-up; each step
    is a full-row dot against the solved suffix (unsolved entries are 0)."""
    n = u.shape[0]
    x = torch.zeros_like(y)
    for i in range(n - 1, -1, -1):
        acc = u[i] @ x
        x[i] = (y[i] - acc) / u[i, i]
    return x


def gauss_solve(a, b, pivoting: str = "partial",
                device=None) -> torch.Tensor:
    """Dense solve via forward elimination + back-substitution (the
    oracle path); returns a float32 tensor on the resolved device."""
    res = eliminate(a, b, pivoting=pivoting, device=device)
    return back_substitute(res.u, res.y)

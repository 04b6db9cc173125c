"""Synthetic matrix / RHS initializers reproducing the reference's generators.

Two generator families exist in the reference and both are reproduced here:

- ``internal_matrix``: the in-memory benchmark init used by every
  internal-input program — ``matrix[i][j] = j < i ? 2*(j+1) : 2*(i+1)`` with
  ``B[i] = i`` (reference Pthreads/Version-1/gauss_internal_input.c:59-69).
  That formula is ``2 * (min(i, j) + 1)`` — a symmetric positive-definite
  "min matrix" whose solution against B is the closed form
  (-0.5, 0, ..., 0, 0.5) (gauss_internal_input.c:54-57).

- ``generator_matrix``: the standalone tool's emission,
  ``value = row < col ? 2*row : 2*col`` over 1-indexed coordinates
  (matrix_gen.cc:15-19) — i.e. ``2 * min(row, col)`` 1-indexed, which is the
  same matrix as ``internal_matrix`` (min is symmetric; the survey's
  "transposed convention" collapses for a symmetric formula).

- ``manufactured_rhs``: the external-input programs' oracle: preset solution
  ``X__[i] = i + 1`` and ``R = A @ X__`` so the max relative error of a
  computed solution is checkable (gauss_external_input.c:88-108).
"""

from __future__ import annotations

import numpy as np


def internal_matrix(n: int, dtype=np.float64) -> np.ndarray:
    """A[i, j] = 2 * (min(i, j) + 1), the internal-input benchmark matrix."""
    i = np.arange(n)
    return (2.0 * (np.minimum.outer(i, i) + 1)).astype(dtype)


def internal_rhs(n: int, dtype=np.float64) -> np.ndarray:
    """B[i] = i (gauss_internal_input.c:68)."""
    return np.arange(n, dtype=dtype)


def internal_expected_solution(n: int, dtype=np.float64) -> np.ndarray:
    """Closed-form solution of the internal system: (-0.5, 0, ..., 0, 0.5)."""
    x = np.zeros(n, dtype=dtype)
    x[0] = -0.5
    x[-1] = 0.5
    return x


def generator_matrix(n: int, dtype=np.float64) -> np.ndarray:
    """The matrix matrix_gen.cc emits: value = 2 * min(row, col), 1-indexed."""
    i = np.arange(1, n + 1)
    return (2.0 * np.minimum.outer(i, i)).astype(dtype)


def manufactured_solution(n: int, dtype=np.float64) -> np.ndarray:
    """X__[i] = i + 1, the external-input preset solution."""
    return np.arange(1, n + 1, dtype=dtype)


def manufactured_rhs(a: np.ndarray, x_true: np.ndarray = None) -> np.ndarray:
    """R = A @ X__ computed in float64 (the external-input initRHS)."""
    a = np.asarray(a, dtype=np.float64)
    if x_true is None:
        x_true = manufactured_solution(a.shape[0])
    return a @ np.asarray(x_true, dtype=np.float64)


# -- structured generators (the structure engines' inputs) -----------------
#
# Deterministic matrices for each structure class the router recognizes, so
# datasets, serving mixes, and the chaos campaign can exercise the
# structured engines end to end. All values round-trip exactly through the
# .dat writer's %.17g (matrix_gen CLI --structure).

def spd_matrix(n: int, rho: float = 0.25, dtype=np.float64) -> np.ndarray:
    """Symmetric positive-definite Kac-Murdock-Szego matrix
    ``a_ij = rho^|i-j|``: SPD for |rho| < 1, and for rho <= 1/3 every
    Gershgorin disc sits strictly in the positive half-line
    (off-diagonal row sums < 2*rho/(1-rho) <= 1 = diagonal), so the
    structure detector can CERTIFY it rather than guess."""
    i = np.arange(n)
    return (rho ** np.abs(np.subtract.outer(i, i))).astype(dtype)


def banded_matrix(n: int, bandwidth: int = 1, dtype=np.float64) -> np.ndarray:
    """Strictly diagonally dominant symmetric band: ``2*(b+1)`` on the
    diagonal, ``-1`` within the band — the structured analog of the
    internal benchmark matrix (tridiagonal at b=1)."""
    a = np.zeros((n, n), dtype=dtype)
    np.fill_diagonal(a, 2.0 * (bandwidth + 1))
    for k in range(1, min(bandwidth, n - 1) + 1):
        idx = np.arange(n - k)
        a[idx, idx + k] = -1.0
        a[idx + k, idx] = -1.0
    return a


def blockdiag_matrix(n: int, block: int = 32, dtype=np.float64) -> np.ndarray:
    """Block-diagonal matrix of SPD "min matrix" blocks (the internal
    benchmark formula per block, plus a per-block diagonal shift so blocks
    differ); the last block is ragged when ``block`` does not divide n."""
    a = np.zeros((n, n), dtype=dtype)
    for c, s in enumerate(range(0, n, block)):
        w = min(block, n - s)
        i = np.arange(w)
        blk = 2.0 * (np.minimum.outer(i, i) + 1) + np.eye(w) * (c % 7)
        a[s:s + w, s:s + w] = blk
    return a


def dense_matrix(n: int, rho: float = 0.25, dtype=np.float64) -> np.ndarray:
    """Deterministic NON-symmetric dense matrix (the general-LU class):
    the KMS matrix with its upper triangle scaled 1.5x. Still strictly
    diagonally dominant (off-diagonal row sums < 2.5*rho/(1-rho) < 1 for
    rho = 0.25), hence invertible — but symmetric it is not, so the
    detector must refuse the Cholesky route."""
    a = spd_matrix(n, rho=rho, dtype=np.float64)
    a += np.triu(0.5 * a, 1)
    return a.astype(dtype)


def sparse_coords(n: int, nnz_per_row: int = 8, seed: int = 0,
                  symmetric: bool = True):
    """Deterministic sparse coordinate system for the Krylov plane:
    0-indexed ``(rows, cols, vals)`` with on average at most
    ``nnz_per_row`` stored entries per row, STRICTLY diagonally dominant
    (``a_ii = 1 + sum_j |a_ij|``), never densified — O(nnz) memory at any
    n. Symmetric (the default) also carries the Gershgorin SPD
    certificate, so CG is licensed; ``symmetric=False`` keeps dominance
    (invertible) but routes the general-system solvers. All values are
    float64 and round-trip exactly through the ``.dat`` writer's %.17g.
    """
    if n <= 0:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z
    rng = np.random.default_rng(
        np.random.SeedSequence((seed, n, nnz_per_row, int(symmetric))))
    # k off-diagonal draws per row; the symmetric mirror doubles them, so
    # halve the budget there (diagonal always present).
    k = max(0, (nnz_per_row - 1) // (2 if symmetric else 1))
    if k and n > 1:
        rows = np.repeat(np.arange(n, dtype=np.int64), k)
        cols = rng.integers(0, n - 1, n * k)
        cols += cols >= rows  # skew past the diagonal
        vals = rng.uniform(-1.0, 1.0, n * k)
        if symmetric:
            # Canonicalize to the upper triangle, drop duplicate slots,
            # then mirror — exact value symmetry by construction.
            r = np.minimum(rows, cols)
            c = np.maximum(rows, cols)
            codes = r * n + c
            _, first = np.unique(codes, return_index=True)
            r, c, vals = r[first], c[first], vals[first]
            rows = np.concatenate([r, c])
            cols = np.concatenate([c, r])
            vals = np.concatenate([vals, vals])
        else:
            codes = rows * n + cols
            _, first = np.unique(codes, return_index=True)
            rows, cols, vals = rows[first], cols[first], vals[first]
    else:
        rows = np.zeros(0, dtype=np.int64)
        cols = np.zeros(0, dtype=np.int64)
        vals = np.zeros(0)
    offsum = np.zeros(n)
    np.add.at(offsum, rows, np.abs(vals))
    diag_rows = np.arange(n, dtype=np.int64)
    return (np.concatenate([rows, diag_rows]),
            np.concatenate([cols, diag_rows]),
            np.concatenate([vals, 1.0 + offsum]))


def sparse_matrix(n: int, nnz_per_row: int = 8, seed: int = 0,
                  symmetric: bool = True, dtype=np.float64) -> np.ndarray:
    """Dense materialization of :func:`sparse_coords` for the SMALL-n
    consumers that need an ndarray operand (loadgen mixes, tests); the
    coordinate form is the scalable interface."""
    if n > 4096:
        raise ValueError(
            f"sparse_matrix densifies (n={n} > 4096); use sparse_coords")
    rows, cols, vals = sparse_coords(n, nnz_per_row, seed=seed,
                                     symmetric=symmetric)
    a = np.zeros((n, n), dtype=np.float64)
    a[rows, cols] = vals
    return a.astype(dtype)

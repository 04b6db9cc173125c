"""Preconditioners for the sparse Krylov plane, built from machinery the
dense engines already own. Port of ``gauss_tpu/sparse/precond.py``.

Build (host, numpy) produces a :class:`Preconditioner` whose arrays are
float64 tensors on the solve's device; apply is plain tensor code:

- ``jacobi``       — inverse diagonal; the safe default at any order.
- ``block_jacobi`` — the ``bs x bs`` diagonal blocks, factorability probed
  by the ``core/blocked.py`` stock panel step over the whole stack at once
  (:func:`~gauss_tpu_torch.core.blocked.panel_factor_swap_batched`; a
  vanishing ``min_abs_pivot`` raises typed before the apply ever ships),
  then inverted explicitly so apply is one batched GEMV.
- ``tridiag``      — the ``structure/banded.py`` Thomas solve
  (``solve_tridiag``) over the |i-j| <= 1 crop.
- ``ilu0`` / ``ic0`` — zero-fill incomplete LU / Cholesky with fill
  confined to the BLOCK-tridiagonal pattern: crop to blocks |I - J| <= 1,
  compensate each dropped entry's magnitude onto the diagonal (keeps
  dominance, so the incomplete factor stays nonsingular on the certified
  inputs this plane routes), then run the block-tridiagonal Schur
  recurrence ``S_I = D_I - E_I S_{I-1}^{-1} F_{I-1}`` — each ``S_I``
  probed like ``block_jacobi``. Apply is the block forward/back
  substitution, two sequential sweeps over the ``nb`` blocks (the JAX
  package's two ``lax.scan`` sweeps as Python loops: a handful of small
  launches per block on the card, so slow at large n). ``ic0``
  additionally demands the Gershgorin SPD certificate (typed
  ``StructureMismatchError`` otherwise).

Block size defaults to ``tune.space.SPARSE_BLOCK_SEED``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gauss_tpu_torch.sparse.csr import CsrMatrix
from gauss_tpu_torch.structure.detect import StructureMismatchError
from gauss_tpu_torch.tune.space import SPARSE_BLOCK_SEED
from gauss_tpu_torch.utils.device import resolve_device

__all__ = ["Preconditioner", "build_preconditioner", "apply_precond",
           "PRECOND_KINDS"]

PRECOND_KINDS = ("none", "jacobi", "block_jacobi", "tridiag", "ilu0", "ic0")

_TINY = 1e-300


class Preconditioner:
    """``M^{-1}``-apply state: ``kind``, static ``meta`` ints (``(n,)`` or
    ``(n, bs, nb)``) and ``arrays``, a tuple of float64 tensors on one
    device."""

    def __init__(self, kind: str, meta: Tuple[int, ...], arrays: tuple):
        self.kind = kind
        self.meta = tuple(meta)
        self.arrays = tuple(arrays)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Preconditioner(kind={self.kind!r}, meta={self.meta})"


def _block_stacks(a: CsrMatrix, bs: int):
    """Crop the CSR stream to the block-tridiagonal pattern: returns
    (diag, sub, sup) stacks of shape (nb, bs, bs) plus the per-row
    absolute mass of the DROPPED entries (|I - J| >= 2) for diagonal
    compensation. Padding rows of the last partial block carry an
    identity diagonal."""
    nb = -(-a.n // bs)
    rows, cols, vals = a.coo()
    rb, cb = rows // bs, cols.astype(np.int64) // bs
    lr, lc = (rows - rb * bs).astype(np.int64), (cols.astype(np.int64) - cb * bs)

    diag = np.zeros((nb, bs, bs), dtype=np.float64)
    sub = np.zeros((nb, bs, bs), dtype=np.float64)   # sub[i] = block (i, i-1)
    sup = np.zeros((nb, bs, bs), dtype=np.float64)   # sup[i] = block (i, i+1)
    dropped = np.zeros(a.n, dtype=np.float64)

    on = rb == cb
    diag[rb[on], lr[on], lc[on]] = vals[on]
    lo = rb == cb + 1
    sub[rb[lo], lr[lo], lc[lo]] = vals[lo]
    hi = cb == rb + 1
    sup[rb[hi], lr[hi], lc[hi]] = vals[hi]
    far = np.abs(rb - cb) >= 2
    np.add.at(dropped, rows[far], np.abs(vals[far]))

    pad = nb * bs - a.n
    if pad:
        tail = np.arange(bs - pad, bs)
        diag[nb - 1, tail, tail] = 1.0
    return diag, sub, sup, dropped


def _panel_probe(blocks: np.ndarray, kind: str) -> None:
    """Certify every block factors: run the ``core/blocked.py`` stock panel
    step over the stack (host tensors: the build is host staging) and
    raise typed on a vanishing pivot."""
    from gauss_tpu_torch.core.blocked import panel_factor_swap_batched

    _, _, minpiv = panel_factor_swap_batched(
        torch.from_numpy(np.ascontiguousarray(blocks)))
    worst = float(minpiv.min())
    if not worst > 0.0:
        raise StructureMismatchError(
            f"{kind} preconditioner: a diagonal block is singular "
            f"(panel-step min |pivot| = {worst}); the operand does not "
            "support this partition"
        )


def build_preconditioner(
    a: CsrMatrix, kind: str = "jacobi", *, block: int | None = None,
    device=None,
) -> Preconditioner:
    """Stage ``M^{-1}`` for ``a`` on ``device`` (default ``cuda``).
    ``block`` sizes the block_jacobi / ilu0 / ic0 partitions (default
    ``SPARSE_BLOCK_SEED``)."""
    if kind not in PRECOND_KINDS:
        raise ValueError(f"unknown preconditioner {kind!r}; one of {PRECOND_KINDS}")
    dev = resolve_device(device)

    def staged(*arrays):
        return tuple(torch.as_tensor(np.asarray(x, dtype=np.float64),
                                     device=dev) for x in arrays)

    if kind == "none":
        return Preconditioner("none", (a.n,), ())

    if kind == "jacobi":
        d = a.diagonal()
        inv = np.where(np.abs(d) > _TINY, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
        return Preconditioner("jacobi", (a.n,), staged(inv))

    if kind == "tridiag":
        rows, cols, vals = a.coo()
        dl = np.zeros(a.n)
        d = np.zeros(a.n)
        du = np.zeros(a.n)
        delta = cols.astype(np.int64) - rows
        d[rows[delta == 0]] = vals[delta == 0]
        dl[rows[delta == -1]] = vals[delta == -1]
        du[rows[delta == 1]] = vals[delta == 1]
        d = np.where(np.abs(d) > _TINY, d, 1.0)
        return Preconditioner("tridiag", (a.n,), staged(dl, d, du))

    bs = int(block or SPARSE_BLOCK_SEED)
    bs = max(1, min(bs, a.n))
    nb = -(-a.n // bs)
    diag, sub, sup, dropped = _block_stacks(a, bs)

    if kind == "block_jacobi":
        _panel_probe(diag, kind)
        sinv = np.linalg.inv(diag)
        return Preconditioner("block_jacobi", (a.n, bs, nb), staged(sinv))

    # ilu0 / ic0: block-tridiagonal incomplete factorization.
    if kind == "ic0" and not a.gershgorin_spd():
        raise StructureMismatchError(
            "ic0 preconditioner requires the Gershgorin SPD certificate "
            "(symmetric + strictly dominant positive diagonal); use ilu0 "
            "for general systems"
        )
    # Dropped-entry compensation: fold each row's discarded off-pattern
    # magnitude onto its diagonal — dominance is preserved, so every
    # Schur block below stays invertible on certified inputs.
    comp = np.zeros(nb * bs, dtype=np.float64)
    comp[: a.n] = dropped
    idx = np.arange(bs)
    diag = diag.copy()
    dd = diag[:, idx, idx]
    # Push the diagonal AWAY from zero (sign-aware) so negative-diagonal
    # dominant rows keep their dominance too.
    diag[:, idx, idx] = dd + np.where(dd < 0.0, -1.0, 1.0) * comp.reshape(nb, bs)

    s = np.empty_like(diag)
    sinv = np.empty_like(diag)
    s[0] = diag[0]
    _panel_probe(s[0:1], kind)
    sinv[0] = np.linalg.inv(s[0])
    for i in range(1, nb):
        s[i] = diag[i] - sub[i] @ sinv[i - 1] @ sup[i - 1]
        sinv[i] = np.linalg.inv(s[i])
    _panel_probe(s, kind)
    if not np.isfinite(sinv).all():
        raise StructureMismatchError(
            f"{kind} preconditioner: non-finite incomplete factor"
        )
    return Preconditioner(kind, (a.n, bs, nb), staged(sinv, sub, sup))


def apply_precond(prec, r: torch.Tensor) -> torch.Tensor:
    """``z = M^{-1} r`` for an (n,) tensor ``r`` on the preconditioner's
    device (``prec`` None applies the identity)."""
    if prec is None or prec.kind == "none":
        return r
    if prec.kind == "jacobi":
        (inv_d,) = prec.arrays
        return inv_d * r
    if prec.kind == "tridiag":
        from gauss_tpu_torch.structure.banded import solve_tridiag

        dl, d, du = prec.arrays
        return solve_tridiag(dl, d, du, r)

    n, bs, nb = prec.meta
    pad = nb * bs - n
    rb = (torch.nn.functional.pad(r, (0, pad)) if pad else r).reshape(nb, bs)

    if prec.kind == "block_jacobi":
        (sinv,) = prec.arrays
        z = torch.einsum("nij,nj->ni", sinv, rb).reshape(-1)
        return z[:n] if pad else z

    # ilu0 / ic0: block forward sweep y_I = S_I^{-1}(r_I - E_I y_{I-1}),
    # then back sweep z_I = y_I - S_I^{-1} F_I z_{I+1}.
    sinv, sub, sup = prec.arrays
    ys = torch.empty_like(rb)
    y = torch.zeros(bs, dtype=rb.dtype, device=rb.device)
    for i in range(nb):
        y = sinv[i] @ (rb[i] - sub[i] @ y)
        ys[i] = y
    zs = torch.empty_like(rb)
    z = torch.zeros(bs, dtype=rb.dtype, device=rb.device)
    for i in range(nb - 1, -1, -1):
        z = ys[i] - sinv[i] @ (sup[i] @ z)
        zs[i] = z
    z = zs.reshape(-1)
    return z[:n] if pad else z

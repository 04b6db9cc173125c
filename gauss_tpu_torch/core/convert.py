"""Solver state carried across frameworks as numpy arrays.

The tests hand a factor made by one package to the other's ``lu_solve``:
:func:`blocked_lu_to_numpy` gives the :class:`BlockedLU` fields in their
declared order (so ``BlockedLU(*arrays)`` rebuilds either package's
tuple), :func:`blocked_lu_from_numpy` builds the port's.

The sparse plane's state crosses the same way: :func:`ell_from_numpy`
stages padded-row arrays as the Krylov cores take them, and a
preconditioner is ``(kind, meta, arrays)`` in both packages
(:func:`preconditioner_to_numpy`, :func:`preconditioner_from_numpy`), so
one built by either applies in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from gauss_tpu_torch.core.blocked import BlockedLU
from gauss_tpu_torch.sparse.precond import PRECOND_KINDS, Preconditioner
from gauss_tpu_torch.utils.device import resolve_device


def blocked_lu_from_numpy(m, perm, min_abs_pivot, linv=None, uinv=None,
                          abft_err=None, device=None) -> BlockedLU:
    """A port :class:`BlockedLU` on ``device`` (default ``cuda``) from
    numpy arrays: float32 factor fields (``abft_err`` too), int64
    permutation."""
    dev = resolve_device(device)

    def f32(x):
        return (None if x is None else
                torch.as_tensor(np.array(x, np.float32), device=dev))

    return BlockedLU(
        m=f32(m),
        perm=torch.as_tensor(np.array(perm, np.int64), device=dev),
        min_abs_pivot=f32(np.asarray(min_abs_pivot).reshape(())),
        linv=f32(linv), uinv=f32(uinv), abft_err=f32(abft_err))


def blocked_lu_to_numpy(fac) -> tuple:
    """``(m, perm, min_abs_pivot, linv, uinv, abft_err)`` as numpy arrays
    (None where the factor has no inverses or no checksum record)."""
    def host(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    return (host(fac.m), host(fac.perm), host(fac.min_abs_pivot),
            host(fac.linv), host(fac.uinv),
            host(getattr(fac, "abft_err", None)))


def ell_from_numpy(cols, vals, device=None, dtype=torch.float64):
    """``(cols, vals)`` padded-row arrays (``CsrMatrix.ell()`` of either
    package) as the tensors the sparse kernels and Krylov cores take:
    int32 columns and ``dtype`` values, contiguous, on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    return (torch.as_tensor(np.ascontiguousarray(cols, dtype=np.int32),
                            device=dev),
            torch.as_tensor(np.ascontiguousarray(vals), dtype=dtype,
                            device=dev))


def preconditioner_from_numpy(kind, meta, arrays,
                              device=None) -> Preconditioner:
    """A port :class:`Preconditioner` on ``device`` (default ``cuda``) from
    the ``kind``, ``meta`` ints and numpy ``arrays`` of either package's
    preconditioner (float64 tensors)."""
    if kind not in PRECOND_KINDS:
        raise ValueError(f"unknown preconditioner {kind!r}; one of "
                         f"{PRECOND_KINDS}")
    dev = resolve_device(device)
    return Preconditioner(
        kind, tuple(int(v) for v in meta),
        tuple(torch.as_tensor(np.array(x, np.float64), device=dev)
              for x in arrays))


def preconditioner_to_numpy(prec) -> tuple:
    """``(kind, meta, arrays)`` with ``arrays`` a tuple of numpy arrays:
    what the other package's ``Preconditioner(kind, meta, arrays)``
    takes."""
    return (prec.kind, tuple(prec.meta),
            tuple(np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                             else x) for x in prec.arrays))

"""Factorization state carried across frameworks as numpy arrays.

The tests hand a factor made by one package to the other's ``lu_solve``:
:func:`blocked_lu_to_numpy` gives the :class:`BlockedLU` fields in their
declared order (so ``BlockedLU(*arrays)`` rebuilds either package's
tuple), :func:`blocked_lu_from_numpy` builds the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from gauss_tpu_torch.core.blocked import BlockedLU
from gauss_tpu_torch.utils.device import resolve_device


def blocked_lu_from_numpy(m, perm, min_abs_pivot, linv=None, uinv=None,
                          device=None) -> BlockedLU:
    """A port :class:`BlockedLU` on ``device`` (default ``cuda``) from
    numpy arrays: float32 factor fields, int64 permutation."""
    dev = resolve_device(device)

    def f32(x):
        return (None if x is None else
                torch.as_tensor(np.array(x, np.float32), device=dev))

    return BlockedLU(
        m=f32(m),
        perm=torch.as_tensor(np.array(perm, np.int64), device=dev),
        min_abs_pivot=f32(np.asarray(min_abs_pivot).reshape(())),
        linv=f32(linv), uinv=f32(uinv))


def blocked_lu_to_numpy(fac) -> tuple:
    """``(m, perm, min_abs_pivot, linv, uinv)`` as numpy arrays (None
    where the factor has no inverses)."""
    def host(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    return (host(fac.m), host(fac.perm), host(fac.min_abs_pivot),
            host(fac.linv), host(fac.uinv))

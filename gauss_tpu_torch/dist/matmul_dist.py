"""Sharded dense matmul over a mesh.

The port of ``gauss_tpu/dist/matmul_dist.py``. The CUDA matmul engines of
the reference are single-GPU; the JAX package gets a distributed one from
sharding annotations, with the local product and the collectives left to
XLA. The port issues both itself: the local product is one GEMM
(:func:`gauss_tpu_torch.core.matmul.matmul` at the requested precision),
and the output gathers go through :mod:`gauss_tpu_torch.dist.comm`. Two
layouts:

- 1-D: A row-sharded, B replicated -> C row-sharded; one all_gather over
  ``rows`` replicates C.
- 2-D: A sharded (rows, None), B sharded (None, cols) -> C sharded
  (rows, cols) — the SUMMA-style layout; one all_gather over ``cols`` and
  one over ``rows`` replicate C.

Integer operands keep their dtype (integer products stay exact). SPMD:
every rank calls with the same host operands.
"""

from __future__ import annotations

import numpy as np
import torch

from gauss_tpu_torch.dist import comm
from gauss_tpu_torch.dist.gauss_dist import _host
from gauss_tpu_torch.dist.mesh import (axis_index, axis_names, axis_size,
                                       make_mesh, mesh_device)


def _pad(x: np.ndarray, mult0: int, mult1: int) -> np.ndarray:
    """Zero-pad each dim up to the next multiple (sharding divisibility)."""
    p0 = -(-x.shape[0] // mult0) * mult0
    p1 = -(-x.shape[1] // mult1) * mult1
    if (p0, p1) == x.shape:
        return x
    xp = np.zeros((p0, p1), x.dtype)
    xp[:x.shape[0], :x.shape[1]] = x
    return xp


def _stage(a, b, mesh):
    """This rank's operand shards on its device: A's row block (and B's
    column block on a 2-D mesh). Returns (a_loc, b_loc, m, n, vec_rhs)."""
    a = _host(a)
    b = _host(b, a.dtype)
    vec_rhs = b.ndim == 1
    if vec_rhs:
        b = b[:, None]
    m, n = a.shape[0], b.shape[1]
    names = axis_names(mesh)
    R = axis_size(mesh, names[0])
    a = _pad(a, R, 1)
    a = a.reshape(R, -1, a.shape[1])[axis_index(mesh, names[0])]
    if len(names) == 2:
        C = axis_size(mesh, names[1])
        b = _pad(b, 1, C)
        b = b.reshape(b.shape[0], C, -1)[:, axis_index(mesh, names[1])]
    dev = mesh_device(mesh)
    return (torch.as_tensor(np.ascontiguousarray(a), device=dev),
            torch.as_tensor(np.ascontiguousarray(b), device=dev), m, n,
            vec_rhs)


def _product(a_loc, b_loc, mesh, precision: str, replicate_out: bool):
    from gauss_tpu_torch.core.matmul import matmul

    if a_loc.is_floating_point():
        c = matmul(a_loc, b_loc, precision)
    else:
        c = a_loc @ b_loc
    if not replicate_out:
        return c
    names = axis_names(mesh)
    if len(names) == 2:
        cols = comm.all_gather(c, mesh, names[1])        # (C, mr, nc)
        c = torch.cat(list(cols), dim=1)
    rows = comm.all_gather(c, mesh, names[0])            # (R, mr, n)
    return rows.reshape(-1, c.shape[1])


def matmul_dist(a, b, mesh=None, *, precision: str = "high",
                replicate_out: bool = True, device=None):
    """C = A @ B with operands sharded over the mesh; C replicated on every
    rank (``replicate_out=False``: this rank's block of C)."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.obs import collectives

    if mesh is None:
        mesh = make_mesh(device=device)
    a_loc, b_loc, m, n, vec_rhs = _stage(a, b, mesh)
    with collectives.counting() as budget:
        out = _product(a_loc, b_loc, mesh, precision, replicate_out)
    obs.record_collective_budget("matmul_dist", budget, a_loc, b_loc,
                                 m=m, n=n, mesh_shape=list(mesh.shape))
    if not replicate_out:
        return out
    out = out[:m, :n]
    return out[:, 0] if vec_rhs else out


def matmul_dist_staged(a, b, mesh=None, *, precision: str = "high",
                       device=None):
    """Stage matrix operands once for a chain of sharded products: returns
    ``(a_loc, b_loc, c0, mm)`` where ``mm(a_, b_)`` is the distributed
    product (C replicated) and ``c0`` a zero of its shape."""
    if np.ndim(b) == 1:
        raise ValueError("matmul_dist_staged stages matrix operands only")
    if mesh is None:
        mesh = make_mesh(device=device)
    a_loc, b_loc, m, n, _ = _stage(a, b, mesh)

    def mm(a_, b_):
        return _product(a_, b_, mesh, precision, True)

    c0 = torch.zeros_like(mm(a_loc, b_loc))
    return a_loc, b_loc, c0, mm

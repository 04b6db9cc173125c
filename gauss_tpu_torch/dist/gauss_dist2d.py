"""2-D cyclic-sharded distributed Gaussian elimination on torch.distributed.

The port of ``gauss_tpu/dist/gauss_dist2d.py``: the 2-D generalization of
the row-cyclic engine, the ScaLAPACK block-cyclic layout at block size 1:

- **Layout**: global element (g, j) lives on mesh tile (g % R, j % C).
- **Pivot search** runs in the mesh column that owns matrix column i: a
  local masked argmax, an ``all_gather`` of the candidates' values and one
  of their rows along ``rows``, then a scalar psum along ``cols`` tells
  everyone the winner.
- **Row swap + pivot-row broadcast** fuse into one (2, mc+1) psum along
  ``rows``; the pivot value is one scalar psum along ``cols``; the
  multiplier column one (mr,) psum along ``cols``.
- Elimination and back-substitution are local FMAs; back-substitution
  pays one psum along ``cols`` (the row dot) and one along ``rows`` (the
  solved entry) per row.

Per solve: 2n all_gathers and 6n psums, the JAX budget. SPMD like
:mod:`.gauss_dist`: every rank calls with the same host operands.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gauss_tpu_torch.dist import comm
from gauss_tpu_torch.dist.gauss_dist import (_hooks, _host, _host_dtype,
                                             _masked_row, _put_row)
from gauss_tpu_torch.dist.mesh import (axis_index, axis_names, axis_size,
                                       make_mesh_2d_auto, mesh_device)
from gauss_tpu_torch.resilience import fleet as _fleet
from gauss_tpu_torch.resilience import watchdog as _watchdog


def _solve_2d(mesh, a_loc: torch.Tensor, b_loc: torch.Tensor, npad: int):
    """The elimination and back-substitution on this rank; the right-hand
    side rides as column ``mc`` of the tile, and the pivot's row and owner
    stay on the device, as in :mod:`.gauss_dist`."""
    rax, cax = axis_names(mesh)
    R, C = axis_size(mesh, rax), axis_size(mesh, cax)
    dr, dc = axis_index(mesh, rax), axis_index(mesh, cax)
    mr, mc = npad // R, npad // C
    dev, dt = a_loc.device, a_loc.dtype
    A = torch.cat([a_loc, b_loc[:, None]], 1)
    g_rows = torch.arange(mr, device=dev) * R + dr
    # Global column of each local column; -1 for the right-hand side's.
    g_cols = torch.cat([torch.arange(mc, device=dev) * C + dc,
                        torch.full((1,), -1, device=dev)])
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    ninf = torch.full((), float("-inf"), dtype=dt, device=dev)
    no_cand = torch.full((mr,), float("-inf"), dtype=dt, device=dev)
    zeros_mr = torch.zeros(mr, dtype=dt, device=dev)
    zrow = torch.zeros(mc + 1, dtype=dt, device=dev)
    for i in range(npad):
        l_i, m_i = i // R, i // C
        own_ri, own_ci = dr == i % R, dc == i % C
        # --- distributed partial pivot, owner mesh-column only ---
        cand = (torch.where(g_rows >= i, A[:, m_i].abs(), ninf) if own_ci
                else no_cand)
        lbest = torch.argmax(cand)
        vals = comm.all_gather(cand[lbest], mesh, rax)
        gidxs = comm.all_gather(g_rows[lbest], mesh, rax)
        gpiv_local = gidxs[torch.argmax(vals)]
        gpiv = comm.psum(gpiv_local if own_ci
                         else torch.zeros_like(gpiv_local), mesh, cax)
        l_p, own_rp = gpiv // R, (gpiv % R) == dr
        # --- swap rows i <-> gpiv and broadcast both: one psum over rows ---
        both = comm.psum(torch.stack(
            (A[l_i] if own_ri else zrow, _masked_row(A, l_p, own_rp, zero))),
            mesh, rax)
        row_i, row_p = both[0], both[1]
        # The pivot value lives at local column m_i of the owner column.
        piv = comm.psum(row_p[m_i] if own_ci else zero, mesh, cax)
        prow = torch.where(g_cols == i, one, row_p / piv)
        _put_row(A, l_p, own_rp, row_i)
        if own_ri:
            A[l_i] = prow
        # --- multiplier column: one (mr,) psum over cols ---
        f = comm.psum(A[:, m_i] if own_ci else zeros_mr, mesh, cax)
        A -= torch.where(g_rows > i, f, zero)[:, None] * prow[None, :]
    # --- back-substitution: x column-sharded (mc,), row-replicated ---
    x_loc = torch.zeros(mc, dtype=dt, device=dev)
    for i in range(npad - 1, -1, -1):
        l_i, own_ri = i // R, dr == i % R
        part = A[l_i, :mc] @ x_loc if own_ri else zero
        acc = comm.psum(part.reshape(()), mesh, cax)
        xi = comm.psum((A[l_i, mc] - acc) if own_ri else zero, mesh, rax)
        x_loc = torch.where(g_cols[:mc] == i, xi, x_loc)
    return x_loc


def _prepare_2d(a, b, mesh):
    """Identity-pad to a multiple of lcm(R, C) and take this rank's cyclic
    tile (rows g % R == dr, columns j % C == dc) and right-hand side.
    Returns (a_loc, b_loc, npad)."""
    rax, cax = axis_names(mesh)
    R, C = axis_size(mesh, rax), axis_size(mesh, cax)
    dr, dc = axis_index(mesh, rax), axis_index(mesh, cax)
    dtype = _host_dtype(a)
    a = _host(a, dtype)
    b = _host(b, dtype)
    n = a.shape[0]
    npad = -(-n // math.lcm(R, C)) * math.lcm(R, C)
    if npad != n:
        ap = np.zeros((npad, npad), dtype)
        ap[:n, :n] = a
        ap[np.arange(n, npad), np.arange(n, npad)] = 1.0
        bp = np.zeros((npad,), dtype)
        bp[:n] = b
    else:
        ap, bp = a, b
    rows = np.arange(npad // R) * R + dr
    cols = np.arange(npad // C) * C + dc
    dev = mesh_device(mesh)
    a_loc = torch.as_tensor(np.ascontiguousarray(ap[np.ix_(rows, cols)]),
                            device=dev)
    b_loc = torch.as_tensor(np.ascontiguousarray(bp[rows]), device=dev)
    return a_loc, b_loc, npad


def prepare_dist2d(a, b, mesh):
    """Stage a system onto a 2-D mesh; handle for :func:`solve_dist2d_staged`
    (the same staging/solve split as gauss_dist.prepare_dist)."""
    if mesh.ndim != 2:
        raise ValueError(f"gauss_solve_dist2d needs a 2-D mesh; got shape "
                         f"{tuple(mesh.shape)} (use gauss_solve_dist for "
                         f"1-D)")
    n = np.shape(a)[0]
    a_c, b_c, npad = _prepare_2d(a, b, mesh)
    return (a_c, b_c, n, npad)


def solve_dist2d_staged(staged, mesh) -> torch.Tensor:
    """Solve a system previously staged by :func:`prepare_dist2d`; x comes
    back in natural order on every rank (one all_gather of the column
    slices along ``cols``, outside the counted solve: the JAX package's
    solver returns x column-sharded and its gather is a resharding)."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.obs import collectives

    a_c, b_c, n, npad = staged
    if _hooks():
        _fleet.beat(phase="dist_factor_solve", engine="gauss_dist2d", n=n)
    with collectives.counting() as budget:
        x_loc = _watchdog.guarded_device(
            lambda: _solve_2d(mesh, a_c, b_c, npad),
            site="dist.gauss_dist2d.solve")
    obs.record_collective_budget("gauss_dist2d", budget, a_c, b_c, n=n,
                                 npad=npad, mesh_shape=list(mesh.shape))
    _, cax = axis_names(mesh)
    parts = comm.all_gather(x_loc, mesh, cax)   # (C, mc)
    # parts[dc, l] = x[l * C + dc]: the transpose is natural order.
    return parts.T.reshape(-1)[:n]


def gauss_solve_dist2d(a, b, mesh=None, device=None) -> torch.Tensor:
    """Distributed dense solve over a 2-D mesh; returns x in natural
    order on every rank."""
    if mesh is None:
        mesh = make_mesh_2d_auto(device=device)
    return solve_dist2d_staged(prepare_dist2d(a, b, mesh), mesh)

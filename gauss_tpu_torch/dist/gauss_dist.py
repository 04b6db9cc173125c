"""Row-cyclic distributed Gaussian elimination on torch.distributed.

The port of ``gauss_tpu/dist/gauss_dist.py``, the re-expression of the
reference's MPI master–worker engine
(reference OpenMP_and_MPI/gauss_mpi/gauss_internal_input.c:124-255):

- **Row-cyclic ownership**: global row g lives on rank ``g % P`` for the
  whole solve (the reference's cyclic striping applied across cards).
- **Cross-shard partial pivoting**: a local masked argmax, then one
  ``all_gather`` of the candidates' values and one of their global rows;
  the winner is the first maximum in rank order (``jnp.argmax``'s rule),
  a NaN candidate winning first.
- **Pivot-row broadcast**: both swap rows and their right-hand sides ride
  ONE psum of masked contributions (zeros added: exact), replacing
  MPI_Bcast of the pivot row plus the row-block Isend/Irecv.
- **Back-substitution**: the owner of row i solves it and one psum
  broadcasts x_i.

The JAX package compiles the loop into one ``shard_map`` program; here the
same loop runs eagerly on every rank (SPMD), each ``psum`` an all_reduce on
the mesh's axis group. Per solve: 2n all_gathers and 2n psums, the JAX
budget.

Every entry point is SPMD: every rank of the mesh calls it with the same
host operands and gets x back replicated, a tensor on its own device.
"""

from __future__ import annotations

import numpy as np
import torch

from gauss_tpu_torch.dist import comm
from gauss_tpu_torch.dist.mesh import (ROWS_AXIS, axis_index, axis_names,
                                       axis_size, make_mesh, mesh_device)
from gauss_tpu_torch.resilience import fleet as _fleet
from gauss_tpu_torch.resilience import watchdog as _watchdog


def _host_dtype(a) -> np.dtype:
    """The float dtype a linear system stages in: a floating input keeps
    its own, anything else stages as float32 (gauss divides by pivots)."""
    dt = getattr(a, "dtype", None)
    if isinstance(dt, torch.dtype):
        dt = np.dtype(str(dt).replace("torch.", ""))
    dt = np.dtype(dt) if dt is not None else np.asarray(a).dtype
    if not np.issubdtype(dt, np.floating):
        dt = np.dtype(np.float32)
    return dt


def _host(a, dtype=None) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _hooks() -> bool:
    return _fleet.active() or _watchdog.enabled()


def _masked_row(A: torch.Tensor, idx: torch.Tensor, own: torch.Tensor,
                zero: torch.Tensor) -> torch.Tensor:
    """Row ``idx`` (a 0-d device index) of ``A`` where ``own``, else
    zeros: no host sync."""
    return torch.where(own, A.index_select(0, idx.view(1))[0], zero)


def _put_row(A: torch.Tensor, idx: torch.Tensor, own: torch.Tensor,
             row: torch.Tensor) -> None:
    """``A[idx] = row`` where ``own`` (0-d device tensors): no host sync."""
    old = A.index_select(0, idx.view(1))
    A.index_copy_(0, idx.view(1), torch.where(own, row, old[0])[None])


def _solve(mesh, a_loc: torch.Tensor, b_loc: torch.Tensor, npad: int):
    """The elimination and back-substitution on this rank. The right-hand
    side rides as column ``npad`` of the rows (each entry computed as the
    JAX program computes it), and the pivot's row and owner stay on the
    device (masked reads and writes, as the JAX program's), so a step
    waits on the host for nothing but its collectives. ``torch.argmax``
    takes the first NaN, else the first maximum: ``jnp.argmax``'s rule."""
    axis = axis_names(mesh)[0]
    P = axis_size(mesh, axis)
    d = axis_index(mesh, axis)
    m = npad // P
    dev, dt = a_loc.device, a_loc.dtype
    A = torch.cat([a_loc, b_loc[:, None]], 1)
    local_g = torch.arange(m, device=dev) * P + d
    ninf = torch.full((), float("-inf"), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    zrow = torch.zeros(npad + 1, dtype=dt, device=dev)
    for i in range(npad):
        l_i, own_i = i // P, d == i % P
        # --- distributed partial pivot ---
        cand = torch.where(local_g >= i, A[:, i].abs(), ninf)
        lbest = torch.argmax(cand)
        vals = comm.all_gather(cand[lbest], mesh, axis)
        gidxs = comm.all_gather(local_g[lbest], mesh, axis)
        gpiv = gidxs[torch.argmax(vals)]
        l_p, own_p = gpiv // P, (gpiv % P) == d
        # --- both swap rows (+ rhs) in ONE psum ---
        both = comm.psum(torch.stack(
            (A[l_i] if own_i else zrow, _masked_row(A, l_p, own_p, zero))),
            mesh, axis)
        row_i, row_p = both[0], both[1]
        # The scaled pivot row (its rhs entry is y_i), diagonal pinned.
        prow = row_p / row_p[i]
        prow[i] = 1.0
        # Slot of gpiv receives old row i; slot of i the scaled pivot row
        # (the write order makes gpiv == i come out right).
        _put_row(A, l_p, own_p, row_i)
        if own_i:
            A[l_i] = prow
        # --- local elimination of owned rows below the pivot ---
        A -= torch.where(local_g > i, A[:, i], zero)[:, None] * prow[None, :]
    # --- back-substitution: owner solves, psum broadcasts ---
    x = torch.zeros(npad, dtype=dt, device=dev)
    for i in range(npad - 1, -1, -1):
        own = d == i % P
        # Unsolved entries of x are 0 and U has unit diagonal.
        part = A[i // P, npad] - A[i // P, :npad] @ x if own else zero
        x[i] = comm.psum(part.reshape(()), mesh, axis)
    return x


def _prepare(a, b, mesh):
    """Identity-pad to a shard multiple, take this rank's cyclic rows and
    stage them on its device."""
    axis = axis_names(mesh)[0]
    P = axis_size(mesh, axis)
    d = axis_index(mesh, axis)
    dtype = _host_dtype(a)
    a = _host(a, dtype)
    b = _host(b, dtype)
    n = a.shape[0]
    npad = -(-n // P) * P
    m = npad // P
    rows = np.arange(m) * P + d
    ap = np.zeros((m, npad), dtype)
    bp = np.zeros(m, dtype)
    real = rows < n
    ap[real, :n] = a[rows[real]]
    bp[real] = b[rows[real]]
    pad = rows[~real]
    ap[np.nonzero(~real)[0], pad] = 1.0
    dev = mesh_device(mesh)
    return (torch.as_tensor(ap, device=dev), torch.as_tensor(bp, device=dev),
            npad)


def prepare_dist(a, b, mesh):
    """Stage a system onto the mesh (pad + cyclic rows of this rank) and
    return an opaque handle for :func:`solve_dist_staged`, so callers can
    time the solve alone."""
    n = np.shape(a)[0]
    a_c, b_c, npad = _prepare(a, b, mesh)
    return (a_c, b_c, n, npad)


def solve_dist_staged(staged, mesh) -> torch.Tensor:
    """Solve a system previously staged by :func:`prepare_dist`; records
    the collectives it issued under ``gauss_dist`` when a recorder is
    active."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.obs import collectives

    a_c, b_c, n, npad = staged
    if _hooks():
        _fleet.beat(phase="dist_factor_solve", engine="gauss_dist", n=n)
    with collectives.counting() as budget:
        x = _watchdog.guarded_device(lambda: _solve(mesh, a_c, b_c, npad),
                                     site="dist.gauss_dist.solve")
    obs.record_collective_budget("gauss_dist", budget, a_c, b_c, n=n,
                                 npad=npad, shards=int(mesh.size()))
    return x[:n]


def gauss_solve_dist(a, b, mesh=None, device=None) -> torch.Tensor:
    """Distributed dense solve; returns x replicated on every rank, in
    natural order. ``mesh`` None: all ranks of the world (a world of one
    on ``device`` when no process group exists)."""
    if mesh is None:
        mesh = make_mesh(device=device)
    return solve_dist_staged(prepare_dist(a, b, mesh), mesh)


def eliminate_dist(a, b, mesh=None, device=None):
    """Forward elimination + back-substitution, exposed for tests (same
    signature family as core.gauss.gauss_solve)."""
    return gauss_solve_dist(a, b, mesh=mesh, device=device)


__all__ = ["ROWS_AXIS", "eliminate_dist", "gauss_solve_dist", "make_mesh",
           "prepare_dist", "solve_dist_staged"]

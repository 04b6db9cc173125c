"""2-D panel-blocked distributed LU with CALU tournament pivoting.

The port of ``gauss_tpu/dist/gauss_dist_blocked2d.py``, the
ScaLAPACK-pdgetrf-shaped engine: the strip is never replicated — each
mesh row elects ``panel`` local candidate pivot rows by local partial
pivoting, one ``all_gather`` of the (panel, panel) candidate blocks along
the row axis stages a replicated playoff, and partial pivoting on that
(R*panel, panel) stack both picks the panel's global pivot rows and
factors their (panel, panel) block. Per panel:

- ONE psum along **cols** routes the owning mesh column's (mr, panel)
  strip slice to every rank of its mesh row;
- ONE all_gather along **rows** of the candidate blocks (their global row
  indices ride as one extra float column, exact below 2^24);
- ONE psum along **rows** routes the swapped rows (their local column
  slices and strip slices).

Both factor calls of the election are the stock swap panel with
``zero_pivot_safe=True`` (:func:`gauss_tpu_torch.core.blocked
.panel_factor_swap`, the port of the JAX package's non-Pallas
``_panel_factor_jax``): a rank's eligible rows are routinely
rank-deficient, and the guard keeps the election sound. The trailing
update is one local (mr, panel) x (panel, mc) GEMM on every rank, with U12
computed redundantly per mesh column from the replicated tournament
factor and L21 = A21 @ U11^-1 computed locally from the routed strip.

The blockwise substitution pays one psum along cols (the row dot) and one
along rows (the solved block) per block each way. Budget: the JAX
package's, pmins included (4 outputs x 2 axes at the factor's end, 2 at
the solve's).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gauss_tpu_torch.core.blocked import (_fold_transpositions,
                                          panel_factor_swap, unit_lower_inv,
                                          upper_inv)
from gauss_tpu_torch.dist import comm
from gauss_tpu_torch.dist.gauss_dist import _hooks, _host, _host_dtype
from gauss_tpu_torch.dist.gauss_dist_blocked import (DEFAULT_PANEL_DIST,
                                                     _local_rows,
                                                     auto_panel_dist,
                                                     fold_pivot_rows)
from gauss_tpu_torch.dist.mesh import (axis_index, axis_names, axis_size,
                                       make_mesh_2d_auto, mesh_device)
from gauss_tpu_torch.resilience import fleet as _fleet
from gauss_tpu_torch.resilience import watchdog as _watchdog


def auto_panel_dist2d(n: int, R: int, C: int,
                      panel_max: int = DEFAULT_PANEL_DIST) -> int:
    """The 1-D anti-padding rule with lcm(R, C) standing in for the shard
    count."""
    return auto_panel_dist(n, math.lcm(R, C), panel_max)


class DistBlocked2DLU:
    """A 2-D-factored distributed system: this rank's getrf-layout tile,
    the composed row permutation, the replicated per-panel diagonal-block
    inverses, and the geometry to solve against it."""

    def __init__(self, a_fac, perm, linvs, uinvs, min_piv, n, npad, panel,
                 mesh):
        self.a_fac, self.perm = a_fac, perm
        self.linvs, self.uinvs, self.min_piv = linvs, uinvs, min_piv
        self.n, self.npad, self.panel, self.mesh = n, npad, panel, mesh


def _factor_2d(mesh, a_loc: torch.Tensor, npad: int, panel: int):
    rax, cax = axis_names(mesh)
    R, C = axis_size(mesh, rax), axis_size(mesh, cax)
    dr, dc = axis_index(mesh, rax), axis_index(mesh, cax)
    mr, mc = npad // R, npad // C
    nblocks = npad // panel
    dev, dt = a_loc.device, a_loc.dtype
    A = a_loc.clone()
    g_rows = torch.as_tensor(_local_rows(npad, R, panel, dr), device=dev)
    g_cols = torch.as_tensor(_local_rows(npad, C, panel, dc), device=dev)
    eye = torch.eye(panel, dtype=dt, device=dev)
    min_piv = torch.full((), float("inf"), dtype=dt, device=dev)
    gperm = torch.arange(npad, device=dev)
    linvs = torch.zeros((nblocks, panel, panel), dtype=dt, device=dev)
    uinvs = torch.zeros_like(linvs)
    for k in range(nblocks):
        kb = k * panel
        own_col, own_row = (k % C) == dc, (k % R) == dr
        lc, lr = (k // C) * panel, (k // R) * panel
        # --- [psum over cols] the owning column's strip slice ---
        strip_loc = (A[:, lc:lc + panel] if own_col
                     else torch.zeros((mr, panel), dtype=dt, device=dev))
        strip = comm.psum(strip_loc, mesh, cax)
        # --- local candidate election over the eligible rows ---
        elig = g_rows >= kb
        sel = torch.where(elig[:, None], strip, 0)
        _, ipiv_loc, _ = panel_factor_swap(sel, 0, zero_pivot_safe=True)
        chosen = _fold_transpositions(ipiv_loc, mr)[:panel]
        cand = torch.cat([sel[chosen], g_rows[chosen].to(dt)[:, None]], 1)
        # --- [all_gather over rows] the tournament ---
        stack = comm.all_gather(cand, mesh, rax).reshape(R * panel,
                                                         panel + 1)
        stack_gidx = stack[:, panel].to(torch.int64)
        tfac, tipiv, tmin = panel_factor_swap(stack[:, :panel].contiguous(),
                                              0, zero_pivot_safe=True)
        min_piv = torch.minimum(min_piv, tmin)
        tperm = _fold_transpositions(tipiv, R * panel)
        winners = stack_gidx[tperm[:panel]]
        top = tfac[:panel]
        linv = unit_lower_inv(torch.tril(top, -1) + eye)
        uinv = upper_inv(torch.triu(top))
        linvs[k], uinvs[k] = linv, uinv
        # --- the panel's swap permutation, composed into P ---
        perm_g = torch.as_tensor(
            fold_pivot_rows(winners.tolist(), npad, kb), device=dev)
        gperm = gperm[perm_g]
        # --- [psum over rows] route the swapped rows ---
        src = perm_g[kb:kb + panel]
        src_blk = src // panel
        src_own = (src_blk % R) == dr
        src_lr = (src_blk // R) * panel + src % panel
        buf = torch.zeros((panel, 2 * (mc + panel)), dtype=dt, device=dev)
        buf[:, :mc] = torch.where(src_own[:, None], A[src_lr], 0)
        buf[:, mc:mc + panel] = torch.where(src_own[:, None], strip[src_lr],
                                            0)
        if own_row:
            buf[:, mc + panel:2 * mc + panel] = A[lr:lr + panel]
            buf[:, 2 * mc + panel:] = strip[lr:lr + panel]
        buf = comm.psum(buf, mesh, rax)
        new_diag_A = buf[:, :mc]
        new_diag_S = buf[:, mc:mc + panel]
        old_diag_A = buf[:, mc + panel:2 * mc + panel]
        old_diag_S = buf[:, 2 * mc + panel:]
        # --- each rank rewrites only the rows it owns ---
        tau = perm_g[g_rows]
        is_diag = (g_rows >= kb) & (g_rows < kb + panel)
        moved = torch.nonzero((tau != g_rows) & ~is_diag)[:, 0]
        strip = strip.clone()
        if own_row:
            A[lr:lr + panel] = new_diag_A
            strip[lr:lr + panel] = new_diag_S
        A[moved] = old_diag_A[tau[moved] - kb]
        strip[moved] = old_diag_S[tau[moved] - kb]
        # --- L21 = A21 @ U11^-1, local from the routed strip ---
        below = g_rows >= kb + panel
        l21 = torch.where(below[:, None], strip, 0) @ uinv
        # --- U12 = L11^-1 @ (post-swap block rows), per mesh column ---
        u12 = linv @ new_diag_A
        right = g_cols >= kb + panel
        u12 = torch.where(right[None, :], u12, 0)
        if own_row:
            A[lr:lr + panel] = torch.where(right[None, :], u12,
                                           A[lr:lr + panel])
        # --- trailing update: ONE local GEMM, sharded both ways ---
        A -= torch.where(below[:, None], l21, 0) @ u12
        # The owning column installs the panel columns.
        if own_col:
            pan = torch.where(below[:, None], l21, strip)
            if own_row:
                pan[lr:lr + panel] = top
            A[:, lc:lc + panel] = pan
    pm = (lambda t: comm.pmin(comm.pmin(t, mesh, rax), mesh, cax))
    return A, pm(gperm), pm(linvs), pm(uinvs), pm(min_piv)


def _solve_2d(mesh, a_loc, perm, linvs, uinvs, b, npad: int, panel: int):
    rax, cax = axis_names(mesh)
    R, C = axis_size(mesh, rax), axis_size(mesh, cax)
    dr, dc = axis_index(mesh, rax), axis_index(mesh, cax)
    nblocks = npad // panel
    dev, dt = a_loc.device, a_loc.dtype
    g_cols = torch.as_tensor(_local_rows(npad, C, panel, dc), device=dev)
    rp = b[perm]

    def substep(x, k, inv_stack, rhs):
        kb = k * panel
        own_row = (k % R) == dr
        lr = (k // R) * panel
        rows = a_loc[lr:lr + panel]
        part = comm.psum(rows @ x[g_cols], mesh, cax)
        xk = inv_stack[k] @ (rhs[kb:kb + panel] - part)
        xk = comm.psum(xk if own_row else torch.zeros_like(xk), mesh, rax)
        x = x.clone()
        x[kb:kb + panel] = xk
        return x

    y = torch.zeros(npad, dtype=dt, device=dev)
    for k in range(nblocks):
        y = substep(y, k, linvs, rp)
    x = torch.zeros(npad, dtype=dt, device=dev)
    for k in range(nblocks - 1, -1, -1):
        x = substep(x, k, uinvs, y)
    return comm.pmin(comm.pmin(x, mesh, rax), mesh, cax)


def _resolve_mesh_panel(a, mesh, panel, device=None):
    if mesh is None:
        mesh = make_mesh_2d_auto(device=device)
    if mesh.ndim != 2:
        raise ValueError(f"gauss_dist_blocked2d needs a 2-D mesh; got shape "
                         f"{tuple(mesh.shape)} (use gauss_dist_blocked "
                         f"for 1-D)")
    if panel is None:
        panel = auto_panel_dist2d(np.shape(a)[0], *mesh.shape)
    return mesh, panel


def prepare_dist_blocked2d(a, b, mesh, panel: int | None = None):
    """Identity-pad to a multiple of panel * lcm(R, C) and stage this
    rank's panel-block-cyclic tile (rows over R, columns over C) and the
    whole right-hand side."""
    mesh, panel = _resolve_mesh_panel(a, mesh, panel)
    rax, cax = axis_names(mesh)
    R, C = axis_size(mesh, rax), axis_size(mesh, cax)
    dr, dc = axis_index(mesh, rax), axis_index(mesh, cax)
    dtype = _host_dtype(a)
    a = _host(a, dtype)
    b = _host(b, dtype)
    n = a.shape[0]
    blk = panel * math.lcm(R, C)
    npad = -(-n // blk) * blk
    if npad >= 2 ** 24:
        raise ValueError(
            f"npad={npad} >= 2^24: global row indices would no longer be "
            f"exact in the tournament's float index column")
    ap = np.zeros((npad, npad), dtype)
    ap[:n, :n] = a
    ap[np.arange(n, npad), np.arange(n, npad)] = 1.0
    bp = np.zeros((npad,), dtype)
    bp[:n] = b
    rows = _local_rows(npad, R, panel, dr)
    cols = _local_rows(npad, C, panel, dc)
    dev = mesh_device(mesh)
    a_c = torch.as_tensor(np.ascontiguousarray(ap[np.ix_(rows, cols)]),
                          device=dev)
    return (a_c, torch.as_tensor(bp, device=dev), n, npad, panel)


def factor_dist_blocked2d(staged, mesh) -> DistBlocked2DLU:
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.obs import collectives

    a_c, _, n, npad, panel = staged
    if _hooks():
        _fleet.beat(phase="dist_factor_solve", engine="gauss_dist_blocked2d",
                    n=n)
    with collectives.counting() as budget:
        a_fac, perm, linvs, uinvs, min_piv = _watchdog.guarded_device(
            lambda: _factor_2d(mesh, a_c, npad, panel),
            site="dist.gauss_dist_blocked2d.factor")
    obs.record_collective_budget("gauss_dist_blocked2d", budget, a_c,
                                 n=n, npad=npad, panel=panel,
                                 nblocks=npad // panel,
                                 mesh_shape=list(mesh.shape))
    return DistBlocked2DLU(a_fac, perm, linvs, uinvs, min_piv, n, npad,
                           panel, mesh)


def lu_solve_dist_blocked2d(fac: DistBlocked2DLU, r) -> torch.Tensor:
    """Solve A d = r against an existing 2-D distributed factorization."""
    rpad = torch.zeros(fac.npad, dtype=fac.a_fac.dtype,
                       device=fac.a_fac.device)
    rpad[:fac.n] = torch.as_tensor(_host(r), dtype=fac.a_fac.dtype,
                                   device=fac.a_fac.device)
    return _solve_2d(fac.mesh, fac.a_fac, fac.perm, fac.linvs, fac.uinvs,
                     rpad, fac.npad, fac.panel)[:fac.n]


def factor_solve_dist_blocked2d_staged(staged, mesh):
    """Factor + solve a staged system; returns (x, DistBlocked2DLU)."""
    a_c, b_c, n, npad, panel = staged
    fac = factor_dist_blocked2d(staged, mesh)
    x = _solve_2d(mesh, fac.a_fac, fac.perm, fac.linvs, fac.uinvs, b_c,
                  npad, panel)
    return x[:n], fac


def solve_dist_blocked2d_staged(staged, mesh) -> torch.Tensor:
    return factor_solve_dist_blocked2d_staged(staged, mesh)[0]


def _check_not_singular(fac: DistBlocked2DLU) -> None:
    """Raise on a zero tournament pivot (min_piv == 0 is the witness; the
    reference aborts on a singular matrix, gauss_internal_input.c:95-98)."""
    if float(fac.min_piv) == 0.0:
        raise np.linalg.LinAlgError(
            "matrix is singular (zero tournament pivot in the 2-D blocked "
            "factorization)")


def gauss_solve_dist_blocked2d(a, b, mesh=None, panel: int | None = None,
                               device=None) -> torch.Tensor:
    """2-D panel-blocked distributed dense solve; x replicated, natural
    order. Raises LinAlgError on a singular input."""
    mesh, panel = _resolve_mesh_panel(a, mesh, panel, device)
    staged = prepare_dist_blocked2d(a, b, mesh, panel=panel)
    x, fac = factor_solve_dist_blocked2d_staged(staged, mesh)
    _check_not_singular(fac)
    return x


def gauss_solve_dist_blocked2d_refined(a, b, mesh=None,
                                       panel: int | None = None,
                                       iters: int = 2, tol: float = 0.0,
                                       device=None) -> np.ndarray:
    """2-D distributed solve + host-f64 iterative refinement through the
    SAME factors; returns x float64."""
    from gauss_tpu_torch.dist.gauss_dist_blocked import host_refine

    mesh, panel = _resolve_mesh_panel(a, mesh, panel, device)
    a64 = np.asarray(_host(a), np.float64)
    b64 = np.asarray(_host(b), np.float64)
    staged = prepare_dist_blocked2d(a64.astype(np.float32),
                                    b64.astype(np.float32), mesh, panel=panel)
    x0, fac = factor_solve_dist_blocked2d_staged(staged, mesh)
    _check_not_singular(fac)
    return host_refine(a64, b64, x0,
                       lambda r: lu_solve_dist_blocked2d(fac, r), iters, tol)

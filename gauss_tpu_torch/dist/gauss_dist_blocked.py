"""Blocked distributed factorization: collectives per PANEL, not per row.

The port of ``gauss_tpu/dist/gauss_dist_blocked.py``: right-looking
blocked LU where the O(n^3) work is local GEMMs and the interconnect
carries O(panel)-amortized messages:

- **Layout**: panel-block-cyclic rows — global row block k lives on rank
  k % P, so late panels still touch every rank.
- **Panel factorization is replicated, not negotiated**: each rank
  all-gathers the (npad, panel) column strip (ONE collective) and factors
  the rows from the diagonal down itself, on kernel 1
  (:func:`gauss_tpu_torch.kernels.panel.panel_factor`: the hand-written
  panel kernel on the card, its plain version on the CPU), as the port's
  single-card blocked LU does. Every rank derives the same pivots, so
  pivot agreement costs no collective. The kernel returns its pivots as
  the rows it chose; they are folded here into the swap form the JAX
  package's stock panel produces (:func:`fold_pivot_rows`), so the panel
  moves at most 2 * panel rows, as the routing below assumes.
- **Row swaps route in ONE psum per panel**: the incoming pivot rows and
  the displaced diagonal block ride one (2*panel, npad+1) all_reduce; every
  rank rewrites only the rows it owns.
- **Trailing update is a local GEMM** per rank over the rows below the
  block and the columns right of it: A_own -= L21_own @ U12, with
  U12 = L11^-1 (post-swap block row) computed redundantly from the
  replicated panel factor. The RHS rides as an augmented column.
- **Back-substitution is blockwise**: the owner of block k solves its
  (panel, panel) upper-triangular system and one psum broadcasts x_k.

Collective budget per solve: one all_gather and two psums per panel, and
two pmins at the end (the JAX package's replication proofs of the
permutation and min |pivot|, kept so the budgets match); ``abft=True``
adds one psum per panel and one at the start, and a third pmin.

SPMD like :mod:`.gauss_dist`: every rank calls with the same host
operands and gets x replicated.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from gauss_tpu_torch.core.blocked import unit_lower_inv
from gauss_tpu_torch.dist import comm
from gauss_tpu_torch.dist.gauss_dist import _hooks, _host, _host_dtype
from gauss_tpu_torch.dist.mesh import (axis_index, axis_names, axis_size,
                                       make_mesh, mesh_device)
from gauss_tpu_torch.resilience import fleet as _fleet
from gauss_tpu_torch.resilience import watchdog as _watchdog

DEFAULT_PANEL_DIST = 128


def auto_panel_dist(n: int, nshards: int,
                    panel_max: int = DEFAULT_PANEL_DIST) -> int:
    """Widest power-of-two panel (<= panel_max, >= 8) with panel * P <= n,
    so small systems are not identity-padded to panel * P."""
    p = panel_max
    while p > 8 and p * nshards > n:
        p //= 2
    return p


@lru_cache(maxsize=32)
def _gather_order(npad: int, nshards: int, panel: int) -> np.ndarray:
    """Index array reordering an all-gathered (P*m, panel) strip into
    global row order: ORDER[g] = d(g) * m + l(g)."""
    m = npad // nshards
    g = np.arange(npad)
    blk = g // panel
    return (blk % nshards) * m + (blk // nshards) * panel + g % panel


def fold_pivot_rows(rows, h: int, kb: int = 0) -> list:
    """The swap form of a panel's pivots over ``h`` rows: ``rows[j]`` is
    the (original) row chosen as pivot j, which is swapped into position
    ``kb + j`` from wherever the earlier swaps left it. Returns the gather
    indices ``new[i] = old[perm[i]]`` of that swap sequence, which moves at
    most 2 * len(rows) rows — the permutation the JAX package folds from
    its stock panel's transpositions (and from the 2-D tournament's
    winners)."""
    perm = list(range(h))
    pos = list(range(h))
    for j, r in enumerate(rows):
        t, q = kb + j, pos[r]
        a, b = perm[t], perm[q]
        perm[t], perm[q] = b, a
        pos[b], pos[a] = t, q
    return perm


def factor_strip(strip: torch.Tensor, kb: int):
    """Factor the rows of an (npad, panel) strip from ``kb`` down on kernel
    1 and return ``(pfac, perm_g, min_abs_pivot)`` in the JAX stock
    panel's form: the strip with rows at and below ``kb`` factored and
    swapped, and the global gather indices of the swap sequence."""
    from gauss_tpu_torch.kernels.panel import panel_factor

    npad, panel = strip.shape
    p_perm, ipiv, perm_local, mp = panel_factor(strip[kb:].contiguous(), 0)
    h = npad - kb
    swap = torch.as_tensor(fold_pivot_rows(ipiv.tolist(), h),
                           dtype=torch.int64, device=strip.device)
    inv_local = torch.empty_like(perm_local)
    inv_local[perm_local] = torch.arange(h, device=strip.device)
    pfac = strip.clone()
    pfac[kb:] = p_perm[inv_local[swap]]
    perm_g = torch.arange(npad, device=strip.device)
    perm_g[kb:] = kb + swap
    return pfac, perm_g, mp


def _local_rows(npad: int, nshards: int, panel: int, d: int) -> np.ndarray:
    l = np.arange(npad // nshards)
    return ((l // panel) * nshards + d) * panel + l % panel


def _first_below(npad: int, nshards: int, panel: int, d: int,
                 k: int) -> int:
    """The first local row of rank ``d`` whose global block is past k (the
    rows below the diagonal block form a contiguous local suffix)."""
    m = npad // nshards
    j = max(0, (k - d) // nshards + 1)
    return min(m, j * panel)


def _factor(mesh, a_loc: torch.Tensor, npad: int, panel: int,
            abft: bool = False):
    """The panel loop on this rank; returns (x, A, gperm, min_piv[, errs])
    as the JAX solver's outputs."""
    axis = axis_names(mesh)[0]
    P = axis_size(mesh, axis)
    d = axis_index(mesh, axis)
    m = npad // P
    nblocks = npad // panel
    w = npad + 1
    dev, dt = a_loc.device, a_loc.dtype
    A = a_loc.clone()
    g_loc = torch.as_tensor(_local_rows(npad, P, panel, d), device=dev)
    order = torch.as_tensor(_gather_order(npad, P, panel), device=dev)
    eye = torch.eye(panel, dtype=dt, device=dev)
    min_piv = torch.full((), float("inf"), dtype=dt, device=dev)
    gperm = torch.arange(npad, device=dev)
    errs = []
    if abft:
        crow = comm.psum(A.sum(0), mesh, axis)
    for k in range(nblocks):
        kb = k * panel
        own_k = k % P == d
        lb = (k // P) * panel
        # --- ONE all_gather: the global (npad, panel) column strip ---
        strip = comm.all_gather(A[:, kb:kb + panel], mesh, axis)
        strip = strip.reshape(P * m, panel)[order]
        # --- the replicated panel factorization (kernel 1) ---
        pfac, perm_g, mp = factor_strip(strip, kb)
        min_piv = torch.minimum(min_piv, mp)
        gperm = gperm[perm_g]
        src = perm_g[kb:kb + panel]
        # --- ONE routing psum: incoming pivot rows + displaced block ---
        src_blk = src // panel
        src_mine = (src_blk % P) == d
        src_li = (src_blk // P) * panel + src % panel
        buf = torch.zeros((2 * panel, w), dtype=dt, device=dev)
        buf[:panel] = torch.where(src_mine[:, None], A[src_li], 0)
        if own_k:
            buf[panel:] = A[lb:lb + panel]
        buf = comm.psum(buf, mesh, axis)
        new_diag, old_diag = buf[:panel], buf[panel:]
        # --- each rank rewrites only the rows it owns ---
        tau = perm_g[g_loc]
        is_diag = (g_loc >= kb) & (g_loc < kb + panel)
        moved = torch.nonzero((tau != g_loc) & ~is_diag)[:, 0]
        if own_k:
            A[lb:lb + panel] = new_diag
        A[moved] = old_diag[tau[moved] - kb]
        # Panel columns from the replicated factor.
        strip_mine = pfac[g_loc]
        A[:, kb:kb + panel] = strip_mine
        # --- U12 (replicated small GEMM) + the local trailing GEMM ---
        linv = unit_lower_inv(torch.tril(pfac[kb:kb + panel], -1) + eye)
        c0 = kb + panel
        u12 = linv @ new_diag[:, c0:]
        if own_k:
            A[lb:lb + panel, c0:] = u12
        s = _first_below(npad, P, panel, d, k)
        if s < m:
            A[s:, c0:] -= strip_mine[s:] @ u12
        if abft:
            # The checksum row's multipliers over the panel columns are
            # c1 @ U11^-1, its trailing update the same GEMM the rows got;
            # one psum of each rank's trailing column sums verifies it.
            u11 = torch.triu(pfac[kb:kb + panel])
            lc = torch.linalg.solve_triangular(
                u11, crow[kb:kb + panel][None, :], upper=True, left=False)
            crow = crow.clone()
            crow[c0:] -= (lc @ u12)[0]
            colsum = comm.psum(A[s:].sum(0), mesh, axis)
            diff = torch.zeros(w, dtype=dt, device=dev)
            diff[c0:] = colsum[c0:] - crow[c0:]
            diff = torch.where(torch.isnan(diff),
                               torch.full_like(diff, float("inf")),
                               diff.abs())
            errs.append(diff.max())
    x = _block_substitution(A, lambda rows, kb: rows[:, npad], mesh, axis, d,
                            npad, panel, P, lower=False)
    out = (x, A, comm.pmin(gperm, mesh, axis), comm.pmin(min_piv, mesh, axis))
    if abft:
        out = out + (comm.pmin(torch.stack(errs), mesh, axis),)
    return out


def _block_substitution(A_loc, rhs_block, mesh, axis, d, npad: int,
                        panel: int, nshards: int, lower: bool):
    """Blockwise triangular substitution over the distributed getrf factor:
    per block the owner folds in the solved blocks with one full-width dot
    (the unsolved part of x is zero), solves its (panel, panel) diagonal
    system, and one psum broadcasts the block. ``rhs_block(rows, kb)``
    supplies the block's right-hand side; ``lower`` selects L
    (unit-diagonal, ascending) vs U (descending)."""
    dev, dt = A_loc.device, A_loc.dtype
    nblocks = npad // panel
    x = torch.zeros(npad, dtype=dt, device=dev)
    order = range(nblocks) if lower else range(nblocks - 1, -1, -1)
    for k in order:
        kb = k * panel
        if (k % nshards) == d:
            lb = (k // nshards) * panel
            rows = A_loc[lb:lb + panel]
            r_k = rhs_block(rows, kb) - rows[:, :npad] @ x
            dkk = rows[:, kb:kb + panel]
            if lower:
                xk = torch.linalg.solve_triangular(
                    torch.tril(dkk, -1), r_k[:, None], upper=False,
                    unitriangular=True)[:, 0]
            else:
                xk = torch.linalg.solve_triangular(
                    torch.triu(dkk), r_k[:, None], upper=True)[:, 0]
        else:
            xk = torch.zeros(panel, dtype=dt, device=dev)
        x[kb:kb + panel] = comm.psum(xk, mesh, axis)
    return x


def _prepare_blocked(a, b, mesh, panel: int):
    """Identity-pad to a multiple of panel*P, augment with the RHS column,
    and stage this rank's block-cyclic rows on its device."""
    axis = axis_names(mesh)[0]
    P = axis_size(mesh, axis)
    d = axis_index(mesh, axis)
    dtype = _host_dtype(a)
    a = _host(a, dtype)
    b = _host(b, dtype)
    n = a.shape[0]
    blk = panel * P
    npad = -(-n // blk) * blk
    rows = _local_rows(npad, P, panel, d)
    aug = np.zeros((len(rows), npad + 1), dtype)
    real = rows < n
    aug[real, :n] = a[rows[real]]
    aug[real, npad] = b[rows[real]]
    aug[np.nonzero(~real)[0], rows[~real]] = 1.0
    return torch.as_tensor(aug, device=mesh_device(mesh)), npad


def prepare_dist_blocked(a, b, mesh, panel: int | None = None):
    """Stage a system; returns an opaque handle for
    :func:`solve_dist_blocked_staged`. panel=None resolves through
    :func:`auto_panel_dist`."""
    from gauss_tpu_torch import obs

    n = np.shape(a)[0]
    if panel is None:
        panel = auto_panel_dist(n, int(mesh.size()))
    with obs.span("dist_host_staging", n=n, panel=panel,
                  shards=int(mesh.size())):
        a_c, npad = _prepare_blocked(a, b, mesh, panel)
        if a_c.device.type == "cuda":
            torch.cuda.synchronize(a_c.device)
    return (a_c, n, npad, panel)


def _run_factor(staged, mesh, abft: bool, site: str):
    a_c, n, npad, panel = staged
    if _hooks():
        _fleet.beat(phase="dist_factor_solve", engine="gauss_dist_blocked",
                    n=n)
    return _watchdog.guarded_device(
        lambda: _factor(mesh, a_c, npad, panel, abft), site=site)


def solve_dist_blocked_staged(staged, mesh) -> torch.Tensor:
    """Factor + solve a staged system; x replicated. Records the
    collectives it issued under ``gauss_dist_blocked``."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.obs import collectives

    a_c, n, npad, panel = staged
    with obs.span("dist_factor_solve", n=n, panel=panel):
        with collectives.counting() as budget:
            x = _run_factor(staged, mesh, False,
                            "dist.gauss_dist_blocked.solve")[0]
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
    obs.record_collective_budget("gauss_dist_blocked", budget, a_c, n=n,
                                 npad=npad, panel=panel,
                                 nblocks=npad // panel,
                                 shards=int(mesh.size()))
    return x[:n]


class DistBlockedLU:
    """A factored distributed system: this rank's getrf-layout rows, the
    composed row permutation, and the geometry needed to solve against
    it. Produced by :func:`factor_solve_dist_blocked_staged`; consumed by
    :func:`lu_solve_dist_blocked` — one distributed factorization, many
    O(n^2) solves."""

    def __init__(self, a_fac, perm, min_piv, n, npad, panel, mesh,
                 abft_err=None):
        self.a_fac, self.perm, self.min_piv = a_fac, perm, min_piv
        self.n, self.npad, self.panel, self.mesh = n, npad, panel, mesh
        #: (nblocks,) per-panel ABFT checksum mismatch magnitudes when the
        #: factorization carried the checksum row; None otherwise.
        self.abft_err = abft_err


def factor_solve_dist_blocked_staged(staged, mesh, abft: bool = False):
    """Factor + solve a staged system; returns (x, DistBlockedLU).
    ``abft=True`` carries the replicated checksum row; the per-panel
    mismatch magnitudes land on ``DistBlockedLU.abft_err``."""
    a_c, n, npad, panel = staged
    out = _run_factor(staged, mesh, abft, "dist.gauss_dist_blocked.factor")
    x, a_fac, perm, min_piv = out[:4]
    errs = out[4] if abft else None
    return x[:n], DistBlockedLU(a_fac, perm, min_piv, n, npad, panel, mesh,
                                abft_err=errs)


def lu_solve_dist_blocked(fac: DistBlockedLU, r) -> torch.Tensor:
    """Solve A d = r against an existing distributed factorization:
    blockwise forward + back substitution, 2 psums per block."""
    mesh = fac.mesh
    axis = axis_names(mesh)[0]
    P = axis_size(mesh, axis)
    d = axis_index(mesh, axis)
    rpad = torch.zeros(fac.npad, dtype=fac.a_fac.dtype,
                       device=fac.a_fac.device)
    rpad[:fac.n] = torch.as_tensor(_host(r), dtype=fac.a_fac.dtype,
                                   device=fac.a_fac.device)
    rp = rpad[fac.perm]
    panel = fac.panel
    y = _block_substitution(fac.a_fac, lambda rows, kb: rp[kb:kb + panel],
                            mesh, axis, d, fac.npad, panel, P, lower=True)
    x = _block_substitution(fac.a_fac, lambda rows, kb: y[kb:kb + panel],
                            mesh, axis, d, fac.npad, panel, P, lower=False)
    return x[:fac.n]


def host_refine(a64, b64, x0, lu_solve_fn, iters: int,
                tol: float) -> np.ndarray:
    """The shared host-f64 refinement loop for every distributed engine:
    per iteration an O(n^2) f64 residual on the host and an O(n^2)
    correction through ``lu_solve_fn`` (a solve against EXISTING factors).
    Stops once ||Ax - b||_2 <= tol * min(1, ||b||_2); tol=0 runs exactly
    ``iters``."""
    from gauss_tpu_torch import obs

    x = np.asarray(_host(x0), np.float64)
    tol_eff = tol * min(1.0, float(np.linalg.norm(b64))) if tol > 0.0 else 0.0
    for _ in range(iters):
        with obs.span("refine_residual"):
            r = b64 - a64 @ x
        if tol > 0.0 and float(np.linalg.norm(r)) <= tol_eff:
            break
        with obs.span("refine_correction"):
            x = x + np.asarray(_host(lu_solve_fn(r)), np.float64)
    return x


def gauss_solve_dist_blocked_refined(a, b, mesh=None,
                                     panel: int | None = None,
                                     iters: int = 2, tol: float = 0.0,
                                     abft: bool = False,
                                     device=None) -> np.ndarray:
    """Distributed blocked solve + host-f64 iterative refinement through
    the SAME factors; returns x float64 (on every rank).

    ``abft=True``: the factorization carries the replicated checksum row
    and every panel's trailing block is verified; a mismatch past the
    tolerance emits an obs ``sdc`` event and raises the typed
    :class:`~gauss_tpu_torch.resilience.abft.SDCDetectedError` (the
    distributed engine escalates instead of replaying)."""
    from gauss_tpu_torch import obs

    if mesh is None:
        mesh = make_mesh(device=device)
    a64 = np.asarray(_host(a), np.float64)
    b64 = np.asarray(_host(b), np.float64)
    staged = prepare_dist_blocked(a64.astype(np.float32),
                                  b64.astype(np.float32), mesh, panel=panel)
    x0, fac = factor_solve_dist_blocked_staged(staged, mesh, abft=abft)
    if abft:
        from gauss_tpu_torch.resilience import abft as _abft

        errs = np.asarray(_host(fac.abft_err), np.float64)
        scale = float(max(1.0, np.max(np.abs(a64).sum(axis=0))))
        sdc_tol = _abft.default_tol(fac.npad, np.float32, scale)
        worst = int(np.argmax(np.where(np.isnan(errs), np.inf, errs)))
        worst_err = (float(errs[worst]) if np.isfinite(errs[worst])
                     else float("inf"))
        if not worst_err <= sdc_tol:
            obs.counter("abft.sdc_detected")
            obs.emit("sdc", engine="dist_blocked", group=worst,
                     col=worst * fac.panel, magnitude=worst_err,
                     action="escalate")
            raise _abft.SDCDetectedError(
                f"dist_blocked ABFT: panel {worst} failed its checksum "
                f"(|mismatch| {worst_err:.3e} > tol {sdc_tol:.3e}); the "
                f"distributed engine escalates instead of replaying",
                engine="dist_blocked", group=worst, col=worst * fac.panel,
                magnitude=worst_err)
    return host_refine(a64, b64, x0,
                       lambda r: lu_solve_dist_blocked(fac, r), iters, tol)


def gauss_solve_dist_blocked(a, b, mesh=None, panel: int | None = None,
                             device=None) -> torch.Tensor:
    """Distributed blocked dense solve; x replicated on every rank, in
    natural order."""
    if mesh is None:
        mesh = make_mesh(device=device)
    return solve_dist_blocked_staged(
        prepare_dist_blocked(a, b, mesh, panel=panel), mesh)

"""Blocked (panel) Gaussian elimination with partial pivoting.

The right-looking blocked LU of the JAX package's ``core/blocked.py``: per
column panel, factor the (live rows, panel) column block, permute the live
rows, install the factored panel, and update the trailing submatrix; the
O(n^3) work lands in the trailing update, only the panel factor is rank-1
work. The factor stores L's multipliers strictly below the diagonal and U
on and above it (LAPACK getrf layout), plus the explicit inverses of the
diagonal blocks of L and U, so :func:`lu_solve` is blockwise GEMMs.

Routes per panel (``panel_impl``):

- ``"auto"`` — the fused panel+trailing kernel
  (:func:`gauss_tpu_torch.kernels.panel_fused.panel_trailing_fused`) where
  ``panel >= 64`` and columns remain right of the panel, else the panel
  kernel (:func:`gauss_tpu_torch.kernels.panel.panel_factor`) — the route
  the JAX package takes on a TPU. At n=2048 (panel 256) that is 7 fused
  launches and 1 panel launch per factorization. CPU tensors run the same
  route through the kernels' plain versions.
- ``"fused"`` — the fused kernel wherever columns remain right of the
  panel, whatever the width.
- ``"pallas"`` — the panel kernel, then the trailing update as torch GEMMs
  (U12 = L11^-1 A12, A22 -= L21 U12). The name is the JAX package's.
- ``"jax"`` — the stock swap-based panel (:func:`panel_factor_swap`) and
  torch GEMMs. The name is the JAX package's.

Deliberate deviations from the JAX package:

- :func:`resolve_factor` returns the unrolled form for every n. The JAX
  package picks flat, chunked or unrolled forms to bound XLA trace and
  compile size; eager PyTorch has no such cost. The flat and chunked forms
  (and the checkpoint/ABFT/out-of-core paths built on them) come later.
- The VMEM gate does not apply to the kernels: their scratch lives in
  device memory. :func:`auto_panel` still resolves the JAX package's
  widths (its VMEM model is copied verbatim for that purpose only).
- float32 storage only; the lowered (bfloat16) factor comes later.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gauss_tpu_torch.core.matmul import gdot, resolve_precision
from gauss_tpu_torch.kernels.panel import argmax_nan_first, panel_factor
from gauss_tpu_torch.kernels.panel_fused import panel_trailing_fused
from gauss_tpu_torch.utils.device import as_tensor, resolve_device

DEFAULT_PANEL = 128
#: The JAX package's panel-kernel scoped-VMEM budget and per-row overhead
#: model — used ONLY so that auto_panel resolves the same widths.
PANEL_VMEM_BUDGET = 15_500_000
PANEL_VMEM_ROW_OVERHEAD = {64: 190, 128: 220, 256: 220}
NARROW_PANEL_OVERHEAD_FLOOR = 220
NARROW_PANEL_OVERHEAD_SCALE = 55_000
TRI_INV_BASE = 64  # base-case size of the recursive triangular inversions


def panel_fits_vmem(n: int, panel: int, itemsize: int = 4) -> bool:
    """The JAX package's VMEM model of its panel kernel:
    npad * (panel * itemsize + per-row overhead) <= budget."""
    npad = -(-n // panel) * panel
    overhead = PANEL_VMEM_ROW_OVERHEAD.get(
        panel, 220 if panel >= 64 else max(
            NARROW_PANEL_OVERHEAD_FLOOR,
            NARROW_PANEL_OVERHEAD_SCALE // max(1, panel)))
    return npad * (panel * itemsize + overhead) <= PANEL_VMEM_BUDGET


def auto_panel(n: int, itemsize: int = 4) -> int:
    """The JAX package's panel width: 128 below n=1024, 256 while the
    (n, 256) panel fits its VMEM model (~12.4k), 128 beyond."""
    if n < 1024:
        return DEFAULT_PANEL
    return 256 if panel_fits_vmem(n, 256, itemsize) else 128


def _resolve_panel(n: int, panel, itemsize: int = 4) -> int:
    return auto_panel(n, itemsize) if panel is None else int(panel)


class BlockedLU(NamedTuple):
    """P @ A = L @ U, padded to a panel multiple.

    m:    (npad, npad); strictly lower = L multipliers, upper = U.
    perm: (npad,) int64 gather indices; row k of ``m`` is original row
          ``perm[k]``.
    min_abs_pivot: 0-d; min |pivot| over all steps, 0 means singular.
    linv/uinv: (nb, panel, panel) inverses of the diagonal blocks of L
          (unit lower) and U; None only for hand-built instances, and
          :func:`lu_solve` then substitutes.
    """

    m: torch.Tensor
    perm: torch.Tensor
    min_abs_pivot: torch.Tensor
    linv: torch.Tensor | None = None
    uinv: torch.Tensor | None = None


def unit_lower_inv(l: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit-lower-triangular block by recursive 2x2 partition:
    inv([[A,0],[C,B]]) = [[Ai,0],[-Bi C Ai, Bi]]; triangular solves at the
    base size."""
    p = l.shape[0]
    if p <= TRI_INV_BASE:
        eye = torch.eye(p, dtype=l.dtype, device=l.device)
        return torch.linalg.solve_triangular(l, eye, upper=False,
                                             unitriangular=True)
    h = p // 2
    ai = unit_lower_inv(l[:h, :h])
    bi = unit_lower_inv(l[h:, h:])
    c = (bi @ l[h:, :h]) @ ai
    out = torch.zeros_like(l)
    out[:h, :h] = ai
    out[h:, :h] = -c
    out[h:, h:] = bi
    return out


def upper_inv(u: torch.Tensor) -> torch.Tensor:
    """Inverse of an upper-triangular block, same recursive scheme:
    inv([[A,C],[0,B]]) = [[Ai, -Ai C Bi],[0, Bi]]."""
    p = u.shape[0]
    if p <= TRI_INV_BASE:
        eye = torch.eye(p, dtype=u.dtype, device=u.device)
        return torch.linalg.solve_triangular(u, eye, upper=True)
    h = p // 2
    ai = upper_inv(u[:h, :h])
    bi = upper_inv(u[h:, h:])
    c = (ai @ u[:h, h:]) @ bi
    out = torch.zeros_like(u)
    out[:h, :h] = ai
    out[:h, h:] = -c
    out[h:, h:] = bi
    return out


def _diag_block_linv(d: torch.Tensor) -> torch.Tensor:
    """Inverse of the unit-lower part of one factored diagonal block."""
    return unit_lower_inv(torch.tril(d, -1) + torch.eye(
        d.shape[0], dtype=d.dtype, device=d.device))


def _diag_block_uinv(d: torch.Tensor) -> torch.Tensor:
    """Inverse of the upper part of one factored diagonal block."""
    return upper_inv(torch.triu(d))


def _pad_to_panel(a: torch.Tensor, panel: int) -> torch.Tensor:
    """``a`` in the top-left of an identity-padded panel-multiple array:
    padded rows never win a pivot contest in a real column, and the padded
    block stays exactly the identity through every update."""
    n = a.shape[0]
    npad = -(-n // panel) * panel
    if npad == n:
        return a.clone()
    out = torch.zeros((npad, npad), dtype=a.dtype, device=a.device)
    out[:n, :n] = a
    idx = torch.arange(n, npad, device=a.device)
    out[idx, idx] = 1.0
    return out


def panel_factor_swap(p: torch.Tensor, kb: int = 0):
    """Unblocked partial-pivot elimination of one (h, panel) column block
    with physical row swaps (the JAX package's ``_panel_factor_jax``, the
    stock panel of ``panel_impl="jax"``). Returns ``(factored, ipiv,
    min_abs_pivot)``; ``ipiv[j]`` is the row swapped with row ``kb + j``."""
    h, panel = p.shape
    p = p.clone()
    dev, dt = p.device, p.dtype
    rows = torch.arange(h, device=dev)
    pcols = torch.arange(panel, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    ninf = torch.full((), float("-inf"), dtype=dt, device=dev)
    ipiv = torch.zeros(panel, dtype=torch.int64, device=dev)
    min_piv = torch.full((), float("inf"), dtype=dt, device=dev)
    for j in range(panel):
        c = kb + j
        cand = torch.where(rows >= c, p[:, j].abs(), ninf)
        prow = argmax_nan_first(cand)
        ipiv[j:j + 1] = prow.view(1)
        swap = torch.stack([torch.as_tensor(c, device=dev), prow])
        p[swap] = p[swap.flip(0)]
        piv = p[c, j]
        apiv = piv.abs()
        min_piv = torch.minimum(min_piv,
                                torch.where(torch.isnan(apiv), zero, apiv))
        mult = torch.where(rows > c, p[:, j] / piv, zero)
        p[:, j] = torch.where(rows > c, mult, p[:, j])
        urow = torch.where(pcols > j, p[c], zero)
        p = p - mult[:, None] * urow[None, :]
    return p, ipiv, min_piv


def _fold_transpositions(ipiv: torch.Tensor, h: int) -> torch.Tensor:
    """Fold a swap panel's transposition sequence into gather indices."""
    perm = list(range(h))
    for j, r in enumerate(ipiv.tolist()):
        perm[j], perm[r] = perm[r], perm[j]
    return torch.as_tensor(perm, dtype=torch.int64, device=ipiv.device)


def _use_fused(panel_impl: str, panel: int, wtot: int) -> bool:
    if wtot <= panel:
        return False
    if panel_impl == "fused":
        return True
    return panel_impl == "auto" and panel >= 64


PANEL_IMPLS = ("auto", "fused", "pallas", "jax")


def lu_factor_blocked_unrolled(a, panel: int | None = DEFAULT_PANEL,
                               panel_impl: str = "auto",
                               gemm_precision: str = "highest",
                               device=None) -> BlockedLU:
    """Blocked LU with partial pivoting, one Python step per column panel
    (the trailing submatrix genuinely shrinks: triangular work).

    ``a``: (n, n) array or tensor, factored in float32 on ``device``
    (default ``cuda``; ``"cpu"`` runs the kernels' plain versions).
    ``panel``: width, None = :func:`auto_panel`. ``panel_impl``: see the
    module docstring. ``gemm_precision``: the torch-GEMM trailing updates
    of the ``pallas``/``jax`` routes ("highest" = true f32, "high" and
    "bf16x3" = the explicit bf16 split); the fused kernel runs its own
    f32 arithmetic."""
    if panel_impl not in PANEL_IMPLS:
        raise ValueError(f"unknown panel_impl {panel_impl!r}; "
                         f"options: {PANEL_IMPLS}")
    mode = resolve_precision(gemm_precision, allow_split=True)
    dev = resolve_device(device)
    a = as_tensor(a, dev)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"expected square matrix, got {tuple(a.shape)}")
    panel = _resolve_panel(n, panel)
    m = _pad_to_panel(a, panel)
    npad = m.shape[0]
    perm = torch.arange(npad, device=dev)
    min_piv = torch.full((), float("inf"), device=dev)
    linvs = []
    for kb in range(0, npad, panel):
        live = m[kb:]
        if _use_fused(panel_impl, panel, npad - kb):
            # One launch: factor + U12 + trailing update; the trailing
            # columns of `live` (a view of m) are updated in place.
            p, _, perm_local, mp, _ = panel_trailing_fused(
                live, kb, 0, panel=panel)
        elif panel_impl == "jax":
            p, ipiv, mp = panel_factor_swap(live[:, kb:kb + panel], 0)
            perm_local = _fold_transpositions(ipiv, npad - kb)
        else:
            p, _, perm_local, mp = panel_factor(live[:, kb:kb + panel], 0)
        min_piv = torch.minimum(min_piv, mp)
        # Permute the live rows (the L multipliers left of the panel move
        # with their rows), install the factored panel.
        live = live[perm_local]
        perm[kb:] = perm[kb:][perm_local]
        live[:, kb:kb + panel] = p
        linv = _diag_block_linv(live[:panel, kb:kb + panel])
        linvs.append(linv)
        if (not _use_fused(panel_impl, panel, npad - kb)
                and kb + panel < npad):
            u12 = gdot(linv, live[:panel, kb + panel:], mode)
            live[:panel, kb + panel:] = u12
            live[panel:, kb + panel:] -= gdot(live[panel:, kb:kb + panel],
                                              u12, mode)
        m[kb:] = live
    # The U diagonal-block inverses are only needed by lu_solve: one pass
    # over the finished diagonal blocks after the loop.
    uinvs = [_diag_block_uinv(m[kb:kb + panel, kb:kb + panel])
             for kb in range(0, npad, panel)]
    return BlockedLU(m=m, perm=perm, min_abs_pivot=min_piv,
                     linv=torch.stack(linvs), uinv=torch.stack(uinvs))


def lu_solve(factors: BlockedLU, b, method: str = "auto") -> torch.Tensor:
    """Solve A x = b from a :class:`BlockedLU`: permute, L-solve, U-solve,
    on the factor's device. ``b`` is (n,) or (n, k).

    ``method="auto"`` runs both substitutions blockwise through the stored
    diagonal-block inverses — per block one GEMM against the solved strip
    and one inverse multiply (the JAX package's unrolled and scan forms are
    one loop here). ``"substitution"`` forces triangular solves, which keep
    substitution's backward stability on adversarial inputs (explicit
    unit-lower inverses can grow like 2^(panel-1))."""
    if method not in ("auto", "substitution"):
        raise ValueError(f"unknown method {method!r}; options: "
                         "('auto', 'substitution')")
    m, perm = factors.m, factors.perm
    npad = m.shape[0]
    b = as_tensor(b, m.device, m.dtype)
    was_vector = b.dim() == 1
    b2 = b[:, None] if was_vector else b
    if b2.dim() != 2:
        raise ValueError(f"b must be (n,) or (n, k), got {tuple(b.shape)}")
    n, k = b2.shape
    bp = torch.zeros((npad, k), dtype=m.dtype, device=m.device)
    bp[:n] = b2
    bp = bp[perm]
    if factors.linv is None or method == "substitution":
        y = torch.linalg.solve_triangular(m, bp, upper=False,
                                          unitriangular=True)
        x = torch.linalg.solve_triangular(m, y, upper=True)
    else:
        nb, panel, _ = factors.linv.shape
        y = torch.zeros_like(bp)
        for i in range(nb):
            s = slice(i * panel, (i + 1) * panel)
            r = bp[s] - m[s, :i * panel] @ y[:i * panel]
            y[s] = factors.linv[i] @ r
        x = torch.zeros_like(bp)
        for i in range(nb - 1, -1, -1):
            s = slice(i * panel, (i + 1) * panel)
            r = y[s] - m[s, (i + 1) * panel:] @ x[(i + 1) * panel:]
            x[s] = factors.uinv[i] @ r
    x = x[:n]
    return x[:, 0] if was_vector else x


def resolve_factor(n: int, unroll="auto"):
    """The factorization for (size, unroll policy). The port returns
    :func:`lu_factor_blocked_unrolled` for every n under ``"auto"`` and
    ``True`` (eager PyTorch has no trace or compile payload to bound);
    the flat (``False``) and ``"chunked"`` forms are not ported yet and
    raise."""
    del n
    if unroll == "auto" or unroll is True:
        return lu_factor_blocked_unrolled
    if unroll is False or unroll == "chunked":
        raise ValueError(f"unroll={unroll!r}: the flat and chunked factor "
                         f"forms are not part of gauss_tpu_torch yet; use "
                         f"'auto'")
    raise ValueError(f"unknown unroll {unroll!r}; options: "
                     "(True, False, 'auto', 'chunked')")


def gauss_solve_blocked(a, b, panel: int | None = None,
                        panel_impl: str = "auto", unroll="auto",
                        gemm_precision: str = "highest",
                        device=None) -> torch.Tensor:
    """Factor + solve (float32) on ``device`` (default ``cuda``)."""
    factor = resolve_factor(np.shape(a)[0], unroll)
    fac = factor(a, panel=panel, panel_impl=panel_impl,
                 gemm_precision=gemm_precision, device=device)
    return lu_solve(fac, b)


def solve_refined(a, b, panel: int | None = None, iters: int = 2,
                  panel_impl: str = "auto", a_dev=None, b_dev=None,
                  tol: float = 0.0, unroll="auto", device=None):
    """Mixed-precision solve: float32 blocked factorization on the device,
    float64 residual refinement on the host (one O(n^2) matvec per
    iteration against the O(n^3) factor). Returns ``(x_float64, factors)``.

    ``a_dev``/``b_dev``: the already-staged float32 tensors of a/b (timed
    callers stage outside their span); their device is then the device.
    ``tol``: stop once ``||Ax - b||_2 <= tol * min(1, ||b||_2)``; 0 runs
    exactly ``iters`` iterations."""
    a64 = np.asarray(a, dtype=np.float64)
    b64 = np.asarray(b, dtype=np.float64)
    n = len(b64)
    dev = a_dev.device if a_dev is not None else resolve_device(device)
    if a_dev is None:
        a_dev = as_tensor(a64, dev)
    if b_dev is None:
        b_dev = as_tensor(b64, dev)
    fac = resolve_factor(n, unroll)(a_dev, panel=panel,
                                    panel_impl=panel_impl, device=dev)
    x = lu_solve(fac, b_dev).cpu().numpy().astype(np.float64)
    tol_eff = tol * min(1.0, float(np.linalg.norm(b64))) if tol > 0 else 0.0
    for _ in range(iters):
        r = b64 - a64 @ x
        if tol > 0.0 and float(np.linalg.norm(r)) <= tol_eff:
            break
        d = lu_solve(fac, as_tensor(r, dev)).cpu().numpy()
        x = x + d.astype(np.float64)
    return x, fac

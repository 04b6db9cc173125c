"""Blocked right-looking Cholesky — the SPD half-price factorization.

Port of ``gauss_tpu/structure/cholesky.py``. Per panel: one small dense
Cholesky of the diagonal block (the panel factor), its explicit inverse
(``linv``), one GEMM ``L21 = A21 @ L11^-T`` and one SYRK-shaped trailing
update ``A22 -= L21 @ L21^T``; no pivot contest, no permutation gathers,
no U12 solve. The operand is identity-padded to a panel multiple (an
identity extension of an SPD matrix is SPD).

The JAX engine has no Pallas kernel: the diagonal-block Cholesky and the
triangular inverse are XLA's (here ``torch.linalg.cholesky_ex`` and
``torch.linalg.solve_triangular``), and the two products run through
:func:`gauss_tpu_torch.core.matmul.gdot` under ``gemm_precision`` (true
float32 for ``"highest"``; TF32 stays off).

:func:`cholesky_factor_blocked_batched` and :func:`cholesky_solve_batched`
are the JAX package's ``jax.vmap`` of the factor and the solve over a
(B, n, n) stack (the serving spd lane).

Two forms, as in the JAX package, picked by :func:`resolve_chol_factor`:
the flat form :func:`cholesky_factor_blocked` (masked full-size updates,
the JAX form's arithmetic) and the unrolled form
:func:`cholesky_factor_blocked_unrolled`, whose trailing block genuinely
shrinks (n^3/3 flops): unrolled on the card up to
``core.blocked.UNROLL_MAX_N``, flat elsewhere (the JAX policy, with CUDA
where it asks for a TPU).

Failure is TYPED: a non-SPD operand surfaces as a non-positive (or NaN)
diagonal of some ``L11``. Each diagonal block's NaNs fold to 0 (a failed
block factor is all NaN, as XLA returns it), so ``min_diag`` is the one
witness; the host entries check it once and raise :class:`NotSPDError`,
the router's signal to demote to general LU.

As ``lax.linalg.cholesky`` does by default, the diagonal block is
symmetrized (``(d + d^T) / 2``) before its factor; ``L21`` reads the lower
triangle only. So a non-symmetric operand fails the same way in both
packages.

``abft=True`` on the flat form carries the JAX package's symmetric
column-checksum rider (:func:`_chol_panel_step`'s ``crow``) and returns
``BlockedCholesky.abft_err`` of shape ``(nb + 1,)``: the per-panel
mismatch, then the whole-factor identity ``e^T A = (e^T L) L^T``. The
rider reads the factor and never writes it, so the factor is bit for bit
the ``abft=False`` one. The unrolled form refuses it with the JAX
package's ValueError; the host-stepped runner with replay is
:func:`gauss_tpu_torch.resilience.abft.cholesky_factor_abft`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class NotSPDError(RuntimeError):
    """The matrix is not positive definite (or not symmetric enough to
    pretend). ``min_diag`` carries the witness value where a factorization
    found one (0.0 stands in for NaN)."""

    def __init__(self, message: str, min_diag: float = 0.0):
        super().__init__(message)
        self.min_diag = min_diag


class BlockedCholesky(NamedTuple):
    """A = L @ L^T factorization state (identity-padded to a panel multiple).

    m:    (npad, npad); L on and below the diagonal. The strict upper
          triangle outside the diagonal blocks holds stale input (never
          read by the solve).
    linv: (nb, panel, panel) explicit inverses of the diagonal L blocks.
    min_diag: 0-d; min over the diagonal of L, <= 0 means not SPD (NaN
          folds to 0).
    abft_err: set only by ``abft=True`` and the ABFT runner: the
          checksum mismatch per panel, then the whole-factor identity.
    """

    m: object
    linv: object
    min_diag: object
    abft_err: object = None


def _chol_panel(d, panel: int):
    """Factor one (panel, panel) diagonal block, or a (B, panel, panel)
    stack of them: ``(l11, linv, min_diag)``, NaN folded to 0. Single
    source for every form."""
    import torch

    eye = torch.eye(panel, dtype=d.dtype, device=d.device)
    l11, info = torch.linalg.cholesky_ex((d + d.mT) / 2)
    # A failed factor is all NaN (XLA's contract), then folded to 0, so the
    # witness does not depend on where the factorization stopped.
    l11 = torch.where(info[..., None, None] > 0,
                      torch.full_like(l11, float("nan")), l11)
    dg = torch.diagonal(l11, dim1=-2, dim2=-1)
    dg = torch.where(torch.isnan(dg), torch.zeros_like(dg), dg)
    mind = torch.amin(dg, dim=-1)
    l11 = torch.where(torch.isnan(l11), torch.zeros_like(l11), l11)
    linv = torch.linalg.solve_triangular(
        l11 + eye * (mind <= 0).to(d.dtype)[..., None, None], eye,
        upper=False)
    return l11, linv, mind


def _prepare(a, panel, device):
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.utils.device import as_tensor, resolve_device

    dev = resolve_device(device)
    a = as_tensor(a, dev)
    n = a.shape[0]
    if a.dim() != 2 or a.shape != (n, n):
        raise ValueError(f"expected square matrix, got {tuple(a.shape)}")
    panel = blocked._resolve_panel(n, panel, a.element_size())
    return blocked._pad_to_panel(a, panel), panel


def _chol_panel_step(m, min_diag, kb: int, panel: int, mode: str,
                     crow=None):
    """One panel of the flat (masked) blocked Cholesky on ``m``, in place:
    factor the diagonal block at ``kb``, install L11/L21 and apply the
    self-masking SYRK update over the whole matrix; with an ABFT checksum
    row ``crow``, its symmetric rider update and the checks of the
    trailing block and the panel's columns. Returns ``(m, min_diag, linv,
    crow, err)`` (``crow``/``err`` None without a rider). The JAX
    package's ``_chol_panel_step``: the single source of the flat form and
    of the ABFT runner."""
    import torch

    from gauss_tpu_torch.core.blocked import _nan_inf_abs
    from gauss_tpu_torch.core.matmul import gdot

    npad = m.shape[0]
    rows = torch.arange(npad, device=m.device)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    l11, linv, mind = _chol_panel(m[kb:kb + panel, kb:kb + panel], panel)
    min_diag = torch.minimum(min_diag, mind)
    colblk = m[:, kb:kb + panel]
    below = (rows >= kb + panel)[:, None]
    l21 = gdot(torch.where(below, colblk, zero), linv.T, mode)
    in_panel = ((rows >= kb) & (rows < kb + panel))[:, None]
    l11_full = torch.zeros((npad, panel), dtype=m.dtype, device=m.device)
    l11_full[kb:kb + panel] = l11
    colblk = torch.where(in_panel, l11_full, torch.where(below, l21, colblk))
    m[:, kb:kb + panel] = colblk
    m -= gdot(l21, l21.T, mode)
    err = None
    if crow is not None:
        # s = c1 @ L11^-T is e^T [L11; L21], and the trailing checksum
        # update s @ L21^T is the rider of the SYRK above; then the
        # panel-column identity c1 == (e^T [L11; L21]) @ L11^T.
        c1 = crow[:, kb:kb + panel]
        s = gdot(c1, linv.T, mode)
        crow = crow - gdot(s, l21.T, mode)
        err, _ = _csum_sym_trailing_err(m, crow, kb + panel)
        el = torch.where((rows >= kb)[:, None], colblk, zero).sum(0)
        pred = gdot(el[None, :], l11.T, mode)
        err = torch.maximum(err, _nan_inf_abs(pred[0] - c1[0]).max())
    return m, min_diag, linv, crow, err


def _csum_sym_init(m):
    """The initial checksum row: the column sums of the view symmetrized
    from the lower triangle, ``tril(m) + tril(m, -1)^T`` (the matrix the
    factorization reads), so an asymmetric operand fails as not SPD, not
    as corruption."""
    import torch

    return (torch.tril(m).sum(0) + torch.tril(m, -1).sum(1))[None, :]


def _csum_sym_trailing_err(m, crow, split: int):
    """``(max mismatch, argmax column)`` of the trailing block's column
    sums (the symmetrized-from-lower view of ``m[split:, split:]``)
    against ``crow``; columns left of ``split`` count 0. The strict upper
    triangle, which the factorization never reads, is not checked."""
    import torch

    from gauss_tpu_torch.core.blocked import _nan_inf_abs

    sub = m[split:, split:]
    diff = torch.zeros(m.shape[1], dtype=m.dtype, device=m.device)
    diff[split:] = (torch.tril(sub).sum(0) + torch.tril(sub, -1).sum(1)
                    - crow[0, split:])
    diff = _nan_inf_abs(diff)
    return diff.max(), diff.argmax()


def _csum_final_err_chol(m, crow0):
    """The post-factor identity ``e^T A = (e^T L) @ L^T``: ``(max
    mismatch, argmax column)``."""
    import torch

    from gauss_tpu_torch.core.blocked import _nan_inf_abs

    lt = torch.tril(m)
    pred = lt.sum(0)[None, :] @ lt.T
    diff = _nan_inf_abs(pred[0] - crow0[0])
    return diff.max(), diff.argmax()


def cholesky_factor_blocked(a, panel: int | None = None,
                            gemm_precision: str = "highest",
                            abft: bool = False,
                            device=None) -> BlockedCholesky:
    """Flat blocked Cholesky, the JAX form's arithmetic: each panel's
    ``L21`` and SYRK update are full-size products against the column
    block masked to the rows below the panel (:func:`_chol_panel_step`).
    Never raises on non-SPD input — check ``min_diag`` (the host entries
    do). ``abft``: carry the checksum row and return ``abft_err`` (module
    docstring); the factor is bit for bit the ``abft=False`` one.
    ``device``: default ``cuda``."""
    import torch

    from gauss_tpu_torch.core.matmul import resolve_precision

    mode = resolve_precision(gemm_precision)
    m, panel = _prepare(a, panel, device)
    min_diag = torch.full((), float("inf"), dtype=m.dtype, device=m.device)
    crow0 = crow = _csum_sym_init(m) if abft else None
    linvs, errs = [], []
    for kb in range(0, m.shape[0], panel):
        m, min_diag, linv, crow, err = _chol_panel_step(
            m, min_diag, kb, panel, mode, crow=crow)
        linvs.append(linv)
        errs.append(err)
    abft_err = None
    if abft:
        abft_err = torch.stack(errs + [_csum_final_err_chol(m, crow0)[0]])
    return BlockedCholesky(m=m, linv=torch.stack(linvs), min_diag=min_diag,
                           abft_err=abft_err)


def cholesky_factor_blocked_unrolled(a, panel: int | None = None,
                                     gemm_precision: str = "highest",
                                     abft: bool = False,
                                     device=None) -> BlockedCholesky:
    """Blocked Cholesky whose trailing block genuinely shrinks (n^3/3
    flops, no masks). ``abft=True`` raises the JAX package's ValueError:
    the rider rides the flat form and the ABFT runner only."""
    import torch

    from gauss_tpu_torch.core.matmul import gdot, resolve_precision

    if abft:
        raise ValueError("abft=True is supported on the flat fori form "
                         "(cholesky_factor_blocked) and the host-stepped "
                         "ABFT runner, not the unrolled trace form")
    mode = resolve_precision(gemm_precision)
    m, panel = _prepare(a, panel, device)
    npad = m.shape[0]
    min_diag = torch.full((), float("inf"), dtype=m.dtype, device=m.device)
    linvs = []
    for kb in range(0, npad, panel):
        e = kb + panel
        l11, linv, mind = _chol_panel(m[kb:e, kb:e], panel)
        min_diag = torch.minimum(min_diag, mind)
        linvs.append(linv)
        m[kb:e, kb:e] = l11
        if e < npad:
            l21 = gdot(m[e:, kb:e], linv.T, mode)
            m[e:, kb:e] = l21
            m[e:, e:] -= gdot(l21, l21.T, mode)
    return BlockedCholesky(m=m, linv=torch.stack(linvs), min_diag=min_diag)


def resolve_chol_factor(n: int, unroll="auto", device=None):
    """Factor-form policy, mirroring
    :func:`gauss_tpu_torch.core.blocked.resolve_factor`: unrolled on the
    card (``device`` None or ``cuda``) up to ``UNROLL_MAX_N``, flat
    everywhere else; ``True``/``False`` force a form."""
    import torch

    from gauss_tpu_torch.core import blocked

    if unroll == "auto":
        on_card = torch.device("cuda" if device is None
                               else device).type == "cuda"
        if on_card and n <= blocked.UNROLL_MAX_N:
            return cholesky_factor_blocked_unrolled
        return cholesky_factor_blocked
    if isinstance(unroll, str):
        raise ValueError(f"unknown unroll {unroll!r}; options: "
                         "(True, False, 'auto')")
    return (cholesky_factor_blocked_unrolled if unroll
            else cholesky_factor_blocked)


def cholesky_factor(a, panel: int | None = None, unroll="auto",
                    gemm_precision: str = "highest",
                    device=None) -> BlockedCholesky:
    """Host entry: factor and CHECK — raises :class:`NotSPDError` when the
    factorization's min diagonal is not strictly positive."""
    fac = resolve_chol_factor(np.shape(a)[0], unroll, device)(
        a, panel=panel, gemm_precision=gemm_precision, device=device)
    mind = float(fac.min_diag)
    if not mind > 0.0:
        raise NotSPDError(
            f"matrix is not positive definite (Cholesky min diagonal "
            f"{mind:g}); route to general LU", min_diag=mind)
    return fac


def cholesky_solve(fac: BlockedCholesky, b):
    """Solve A x = b given A = L L^T: forward then transposed substitution,
    blockwise through the stored diagonal-block inverses, on the factor's
    device (float32). ``b`` is (n,) or (n, k)."""
    import torch

    from gauss_tpu_torch.utils.device import as_tensor

    m = fac.m
    npad = m.shape[0]
    nb, panel, _ = fac.linv.shape
    b = as_tensor(b, m.device, m.dtype)
    was_vector = b.dim() == 1
    b2 = b[:, None] if was_vector else b
    if b2.dim() != 2:
        raise ValueError(f"b must be (n,) or (n, k), got {tuple(b.shape)}")
    n, k = b2.shape
    y = torch.zeros((npad, k), dtype=m.dtype, device=m.device)
    y[:n] = b2
    for i in range(nb):
        s = slice(i * panel, (i + 1) * panel)
        y[s] = fac.linv[i] @ (y[s] - m[s, :i * panel] @ y[:i * panel])
    x = torch.zeros_like(y)
    for i in range(nb - 1, -1, -1):
        s = slice(i * panel, (i + 1) * panel)
        e = (i + 1) * panel
        x[s] = fac.linv[i].T @ (y[s] - m[e:, s].T @ x[e:])
    x = x[:n]
    return x[:, 0] if was_vector else x


def cholesky_factor_blocked_batched(a, panel: int | None = None,
                                    gemm_precision: str = "highest",
                                    device=None) -> BlockedCholesky:
    """Blocked Cholesky of every member of a (B, n, n) stack at once — the
    JAX package's ``jax.vmap(cholesky_factor_blocked)``, the serving spd
    lane's factor — in batched torch ops (the JAX Cholesky runs no Pallas
    kernel): per panel one batched diagonal-block factor and inverse, one
    batched ``L21`` product and one batched SYRK-shaped update over the
    rows below the panel (the unrolled form's shrinking trailing block).
    Fields carry a leading batch axis: ``m`` (B, npad, npad), ``linv``
    (B, nb, panel, panel), ``min_diag`` (B,). Never raises on non-SPD
    members — check ``min_diag``. ``device``: default ``cuda``."""
    import torch

    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.core.matmul import gdot, resolve_precision
    from gauss_tpu_torch.utils.device import as_tensor, resolve_device

    mode = resolve_precision(gemm_precision)
    dev = resolve_device(device)
    a = as_tensor(a, dev)
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"expected a (B, n, n) stack, got {tuple(a.shape)}")
    panel = blocked._resolve_panel(a.shape[1], panel, a.element_size())
    m = blocked._pad_to_panel_batched(a, panel)
    bsz, npad, _ = m.shape
    min_diag = torch.full((bsz,), float("inf"), dtype=m.dtype, device=dev)
    linvs = []
    for kb in range(0, npad, panel):
        e = kb + panel
        l11, linv, mind = _chol_panel(m[:, kb:e, kb:e], panel)
        min_diag = torch.minimum(min_diag, mind)
        linvs.append(linv)
        m[:, kb:e, kb:e] = l11
        if e < npad:
            l21 = gdot(m[:, e:, kb:e], linv.mT, mode)
            m[:, e:, kb:e] = l21
            m[:, e:, e:] -= gdot(l21, l21.mT, mode)
    return BlockedCholesky(m=m, linv=torch.stack(linvs, dim=1),
                           min_diag=min_diag)


def cholesky_solve_batched(fac: BlockedCholesky, b):
    """:func:`cholesky_solve` on every member of a batched factor
    (:func:`cholesky_factor_blocked_batched`): ``b`` is (B, n) or (B, n,
    k); one batched product per block and direction."""
    import torch

    from gauss_tpu_torch.utils.device import as_tensor

    m = fac.m
    bsz, npad, _ = m.shape
    nb, panel = fac.linv.shape[1:3]
    b = as_tensor(b, m.device, m.dtype)
    was_vector = b.dim() == 2
    b3 = b[:, :, None] if was_vector else b
    if b3.dim() != 3 or b3.shape[0] != bsz:
        raise ValueError(f"b must be (B, n) or (B, n, k) with B={bsz}, got "
                         f"{tuple(b.shape)}")
    n, k = b3.shape[1:]
    y = torch.zeros((bsz, npad, k), dtype=m.dtype, device=m.device)
    y[:, :n] = b3
    for i in range(nb):
        s = slice(i * panel, (i + 1) * panel)
        y[:, s] = fac.linv[:, i] @ (y[:, s] - m[:, s, :i * panel]
                                    @ y[:, :i * panel])
    x = torch.zeros_like(y)
    for i in range(nb - 1, -1, -1):
        s = slice(i * panel, (i + 1) * panel)
        e = (i + 1) * panel
        x[:, s] = fac.linv[:, i].mT @ (y[:, s] - m[:, e:, s].mT @ x[:, e:])
    x = x[:, :n]
    return x[:, :, 0] if was_vector else x


def solve_spd(a, b, panel: int | None = None, unroll="auto", device=None):
    """One f32 factor + solve (no refinement); raises :class:`NotSPDError`
    on non-SPD input."""
    fac = cholesky_factor(a, panel=panel, unroll=unroll, device=device)
    return cholesky_solve(fac, b)


def solve_spd_refined(a, b, panel: int | None = None, iters: int = 2,
                      unroll="auto", tol: float = 0.0, device=None):
    """Mixed-precision SPD solve: f32 blocked Cholesky on the device +
    host-f64 iterative refinement, contract for contract as
    ``core.blocked.solve_refined`` (x float64, ``(x, factors)``, ``tol``
    early exit). Raises :class:`NotSPDError` before any refinement. The
    JAX package's ``dtype`` option (the storage dtype) is not taken: the
    port's Cholesky factors in float32."""
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    a64 = np.asarray(a, dtype=np.float64)
    b64 = np.asarray(b, dtype=np.float64)
    fac = cholesky_factor(a64, panel=panel, unroll=unroll, device=dev)

    def solve(r):
        return cholesky_solve(fac, r).cpu().numpy().astype(np.float64)

    x = solve(b64)
    tol_eff = tol * min(1.0, float(np.linalg.norm(b64))) if tol > 0.0 else 0.0
    for _ in range(iters):
        r = b64 - a64 @ x
        if tol > 0.0 and float(np.linalg.norm(r)) <= tol_eff:
            break
        x = x + solve(r)
    return x, fac


def solve_spd_ds(a, b, iters: int | None = None, panel: int | None = None,
                 unroll="auto", device=None):
    """On-device SPD solve: f32 Cholesky + double-single refinement
    (``core.dsfloat.refine_ds`` with :func:`cholesky_solve` threaded in).
    Returns ``(x float64, factors)``; raises :class:`NotSPDError`."""
    from gauss_tpu_torch.core import dsfloat
    from gauss_tpu_torch.utils.device import resolve_device

    if iters is None:
        iters = dsfloat.DS_REFINE_STEPS
    dev = resolve_device(device)
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    fac = cholesky_factor(a64, panel=panel, unroll=unroll, device=dev)
    b_ds = dsfloat.to_ds(b64, dev)
    x0 = cholesky_solve(fac, b_ds.hi)
    x = dsfloat.refine_ds(fac, dsfloat.to_ds(a64.T, dev), b_ds, x0,
                          iters=iters, solve_fn=cholesky_solve)
    return dsfloat.ds_to_f64(x), fac

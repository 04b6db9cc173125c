"""Blocked (panel) Gaussian elimination with partial pivoting.

The right-looking blocked LU of the JAX package's ``core/blocked.py``: per
column panel, factor the (live rows, panel) column block, permute the live
rows, install the factored panel, and update the trailing submatrix; the
O(n^3) work lands in the trailing update, only the panel factor is rank-1
work. The factor stores L's multipliers strictly below the diagonal and U
on and above it (LAPACK getrf layout), plus the explicit inverses of the
diagonal blocks of L and U, so :func:`lu_solve` is blockwise GEMMs.

Three factor forms, as in the JAX package:

- :func:`lu_factor_blocked_unrolled` — one Python step per panel.
- :func:`lu_factor_blocked`, the flat form — the same panel loop with the
  JAX form's options: ``swap_impl``, ``zero_pivot_safe`` and the ``abft``
  checksum rider (``BlockedLU.abft_err``). The JAX form masks full-size
  GEMMs so that one ``fori_loop`` body traces once; eager PyTorch has no
  trace to bound, so the port runs the unrolled form's helpers on the live
  rows.
- :func:`lu_factor_blocked_chunked` — groups of ``chunk`` panels
  (:func:`_factor_group`): the panels of a group factor and update only
  the group's own column block, then the columns right of the group take
  one deferred update, a blockwise U12 solve and one
  ``(gh - w, w) x (w, rt)`` GEMM.

:func:`resolve_factor` picks the form by size with the JAX package's
policy, a CUDA device standing where the JAX package asks for a TPU:

    device  n                  form
    cuda    <= 4096            unrolled
    cuda    > 4096             chunked: chunk 4, doubled while the group
                               count exceeds 24 (to at most 32; panel 128
                               skips chunk 16); flat past chunk 32's reach
    cpu     < 1024             flat
    cpu     >= 1024            as on cuda

(n=8192 runs chunk 4 at panel 256, 8 groups; n=12,800 chunk 8 at panel
128, 13 groups.) A tuned store (:mod:`gauss_tpu_torch.tune.apply`) that
carries a ``"lu_factor"`` ``chunk`` or ``panel`` for the size bucket
overrides the seed, as in the JAX package; without one the seeds above
decide.

Routes per panel (``panel_impl``), in every form:

- ``"auto"`` — the fused panel+trailing kernel
  (:func:`gauss_tpu_torch.kernels.panel_fused.panel_trailing_fused`) where
  ``panel >= 64`` and columns remain right of the panel in the block being
  factored (the matrix, or the group's column block), else the panel
  kernel (:func:`gauss_tpu_torch.kernels.panel.panel_factor`) — the route
  the JAX package takes on a TPU. At n=2048 (panel 256) that is 7 fused
  launches and 1 panel launch per factorization; in the chunked form each
  group's last panel, which has no columns right of it inside the group,
  takes the panel kernel. CPU tensors run the same route through the
  kernels' plain versions.
- ``"fused"`` — the fused kernel wherever columns remain right of the
  panel, whatever the width.
- ``"pallas"`` — the panel kernel, then the trailing update as torch GEMMs
  (U12 = L11^-1 A12, A22 -= L21 U12). The name is the JAX package's.
- ``"jax"`` — the stock swap-based panel (:func:`panel_factor_swap`) and
  torch GEMMs. The name is the JAX package's.

An ABFT checksum rider (``abft=True``, or ``_factor_group``'s ``crow``)
pins the unfused pair (``"auto"``/``"fused"`` run ``"pallas"``), so the
factor is bit for bit the ``panel_impl="pallas"`` one;
``zero_pivot_safe=True`` pins the stock panel, which alone guards the
division.

The three factor entries (:func:`lu_factor_blocked_unrolled`,
:func:`lu_factor_blocked`, :func:`lu_factor_blocked_chunked`) are the
``core.blocked.factor`` fault-injection hook point
(:mod:`gauss_tpu_torch.resilience.inject`) on their operand: one ``is
None`` check when no plan is installed.

:func:`lu_factor_blocked_batched` and :func:`lu_solve_batched` are the
JAX package's ``jax.vmap`` of the flat form and of :func:`lu_solve` over
a (B, n, n) stack, one batched kernel launch per panel step (the serving
lane's factor and solve).

:func:`lu_factor_blocked_phased` runs the ``"pallas"`` route with a
synchronized telemetry span around each phase (the solver-phase profile of
the CLIs' ``--phase-profile``). :func:`solve_handoff` routes a solve by its
working set (:func:`fits_single_chip`): the single-card lane, or the
host-streamed out-of-core engine (:mod:`gauss_tpu_torch.outofcore`) past
the card's budget; the sharded ``dist`` lane is not ported.

Deliberate deviations from the JAX package:

- The VMEM guards do not apply to the kernels, whose scratch lives in
  device memory: ``fused_fits_vmem`` (the fused kernel runs wherever the
  route above says), the chunked form's per-group ``_resolve_panel_impl``
  (no group drops to the stock panel for its height), and the
  ``narrow64``/``wide128`` group-width guards (which answer a Mosaic
  aliasing decision). :func:`auto_panel` still resolves the JAX package's
  widths (its VMEM model is copied verbatim for that purpose only).
- The in-group fused launches take the group's live rows with ``kbrow =
  0``, where the JAX package passes the whole group with ``kbrow = kb``:
  the rows above are finished and no pivot comes from them either way.
- ``swap_impl="loop"`` runs the folded gather: it gives the bits of the
  JAX form's two-row exchange loop, which exists for its cost on a TPU.

Storage is float32, or bfloat16 when the operand is a bfloat16 tensor
(the lowered factor of :mod:`gauss_tpu_torch.core.lowered`), under the
JAX package's precision contract: every trailing-update GEMM on bfloat16
operands multiplies in float32 and rounds once to bfloat16
(:func:`_gdot`), the diagonal-block inverses ``linv``/``uinv`` are
computed and stored in float32 (:func:`accum_dtype`), and
:func:`lu_solve` computes in float32 and returns float32 against a
bfloat16 factor. The kernels take bfloat16 storage with the reference's
rounding (``kernels/panel.py``, ``kernels/panel_fused.py``). The float32
path is unchanged: every cast there is an identity.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from gauss_tpu_torch.core.matmul import (BF16X3, dot_bf16x3, gdot,
                                         resolve_precision)
from gauss_tpu_torch.kernels import panel as _kp
from gauss_tpu_torch.kernels import panel_fused as _kpf
from gauss_tpu_torch.kernels.panel import accum_dtype, panel_factor
from gauss_tpu_torch.kernels.panel_fused import panel_trailing_fused
from gauss_tpu_torch.resilience import inject as _inject
from gauss_tpu_torch.tune import apply as _tune
from gauss_tpu_torch.tune.space import CHUNK_SEED
from gauss_tpu_torch.utils.device import as_tensor, resolve_device

DEFAULT_PANEL = 128
#: The JAX package's panel-kernel scoped-VMEM budget and per-row overhead
#: model — used ONLY so that auto_panel resolves the same widths.
PANEL_VMEM_BUDGET = 15_500_000
PANEL_VMEM_ROW_OVERHEAD = {64: 190, 128: 220, 256: 220}
NARROW_PANEL_OVERHEAD_FLOOR = 220
NARROW_PANEL_OVERHEAD_SCALE = 55_000
TRI_INV_BASE = 64  # base-case size of the recursive triangular inversions
#: Panels per group of the chunked form (the tune seed).
CHUNK_DEFAULT = CHUNK_SEED
#: Rows per strip of the chunked form's deferred update in its strip form.
GROUP_UPDATE_STRIP = 2048
#: Up to this many bytes (4 * npad * ncols * itemsize, the unstripped
#: form's transients plus the matrix) the deferred update runs as one
#: gather and one GEMM; past it, in place in row strips.
GROUP_UPDATE_UNSTRIPPED_MAX_BYTES = 16 * 20480 * 20480
#: resolve_factor's size policy: the unrolled form up to UNROLL_MAX_N on
#: the card, the chunked form above with at most MAX_CHUNK_GROUPS groups,
#: the chunk escalated up to MAX_CHUNK.
UNROLL_MAX_N = 4096
MAX_CHUNK_GROUPS = 24
MAX_CHUNK = 32


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
    (n, 256) panel fits its VMEM model at ``itemsize`` (~12.4k at 4
    bytes), 128 beyond. A tuned store's ``"lu_factor"`` ``panel`` for the
    size bucket wins over the rule (:func:`gauss_tpu_torch.tune.apply
    .override`)."""
    tuned = _tune.override("lu_factor", n, "panel")
    if tuned:
        return int(tuned)
    if n < 1024:
        return DEFAULT_PANEL
    return 256 if panel_fits_vmem(n, 256, itemsize) else 128


def _resolve_panel(n: int, panel, itemsize: int = 4) -> int:
    return auto_panel(n, itemsize) if panel is None else int(panel)


class BlockedLU(NamedTuple):
    """P @ A = L @ U, padded to a panel multiple.

    m:    (npad, npad) in the storage dtype (float32 or bfloat16);
          strictly lower = L multipliers, upper = U.
    perm: (npad,) int64 gather indices; row k of ``m`` is original row
          ``perm[k]``.
    min_abs_pivot: 0-d, storage dtype; min |pivot| over all steps, 0
          means singular.
    linv/uinv: (nb, panel, panel) inverses of the diagonal blocks of L
          (unit lower) and U, in the accumulate dtype (float32 for both
          storage dtypes); None only for hand-built instances, and
          :func:`lu_solve` then substitutes.
    abft_err: set only by the ``abft=True`` forms: the column-checksum
          mismatch per panel (flat form) or per group (chunked form), then
          the whole-factor ``e^T P A = (e^T L) U`` check. Near zero on a
          healthy run; a large entry localizes corruption to the panel or
          group that produced it.
    """

    m: torch.Tensor
    perm: torch.Tensor
    min_abs_pivot: torch.Tensor
    linv: torch.Tensor | None = None
    uinv: torch.Tensor | None = None
    abft_err: torch.Tensor | None = None


def unit_lower_inv(l: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit-lower-triangular block (or a stack of them, on
    the last two axes) by recursive 2x2 partition:
    inv([[A,0],[C,B]]) = [[Ai,0],[-Bi C Ai, Bi]]; triangular solves at the
    base size."""
    p = l.shape[-1]
    if p <= TRI_INV_BASE:
        eye = torch.eye(p, dtype=l.dtype, device=l.device)
        return torch.linalg.solve_triangular(l, eye, upper=False,
                                             unitriangular=True)
    h = p // 2
    ai = unit_lower_inv(l[..., :h, :h])
    bi = unit_lower_inv(l[..., h:, h:])
    c = (bi @ l[..., h:, :h]) @ ai
    out = torch.zeros_like(l)
    out[..., :h, :h] = ai
    out[..., h:, :h] = -c
    out[..., h:, h:] = bi
    return out


def upper_inv(u: torch.Tensor) -> torch.Tensor:
    """Inverse of an upper-triangular block (or a stack of them), same
    recursive scheme: inv([[A,C],[0,B]]) = [[Ai, -Ai C Bi],[0, Bi]]."""
    p = u.shape[-1]
    if p <= TRI_INV_BASE:
        eye = torch.eye(p, dtype=u.dtype, device=u.device)
        return torch.linalg.solve_triangular(u, eye, upper=True)
    h = p // 2
    ai = upper_inv(u[..., :h, :h])
    bi = upper_inv(u[..., h:, h:])
    c = (ai @ u[..., :h, h:]) @ bi
    out = torch.zeros_like(u)
    out[..., :h, :h] = ai
    out[..., :h, h:] = -c
    out[..., h:, h:] = bi
    return out


# --- The precision contract (the JAX package's core/blocked.py) ----------
#
# A factorization may run with bfloat16 storage (core.lowered's
# "bfloat16" rung) or with float32 storage and the explicit bf16x3 split
# GEMM ("bf16x3"). What keeps a lowered factor refinable to the 1e-4 gate:
#
# - float32 accumulation: every trailing-update GEMM on bfloat16 operands
#   multiplies in float32 and rounds ONCE to bfloat16 (_gdot);
# - float32 diagonal-block inverses: linv/uinv are computed from the
#   upcast block and stored in float32 (accum_dtype);
# - float32 solves: lu_solve computes in float32 against a bfloat16
#   factor and returns float32.
#
# At float32 storage the accumulate dtype is float32, every cast is an
# identity and _gdot is the pre-contract gdot, so that path is unchanged.


def _gdot(x: torch.Tensor, y: torch.Tensor, mode: str,
          dtype: torch.dtype) -> torch.Tensor:
    """One trailing-update GEMM under the precision contract: ``mode`` is a
    resolved precision; ``dtype`` the storage dtype. bfloat16 storage
    multiplies the upcast operands (exactly representable in float32) and
    rounds once to bfloat16; the split GEMM returns float32, which the
    caller's store rounds; float32 storage is :func:`gdot` itself."""
    if mode == BF16X3:
        return dot_bf16x3(x.float(), y.float())
    if dtype == torch.bfloat16:
        return gdot(x.float(), y.float(), mode).to(dtype)
    return gdot(x, y, mode)


def _diag_block_linv(d: torch.Tensor) -> torch.Tensor:
    """Inverse of the unit-lower part of one factored diagonal block (or a
    stack of them), in the accumulate dtype."""
    d = d.to(accum_dtype(d.dtype))
    return unit_lower_inv(torch.tril(d, -1) + torch.eye(
        d.shape[-1], dtype=d.dtype, device=d.device))


def _diag_block_uinv(d: torch.Tensor) -> torch.Tensor:
    """Inverse of the upper part of one factored diagonal block (or a stack
    of them), in the accumulate dtype."""
    return upper_inv(torch.triu(d.to(accum_dtype(d.dtype))))


def _pad_to_panel(a: torch.Tensor, panel: int,
                  donate: bool = False) -> torch.Tensor:
    """``a`` in the top-left of an identity-padded panel-multiple array:
    padded rows never win a pivot contest in a real column, and the padded
    block stays exactly the identity through every update. ``donate``: an
    ``a`` that needs no padding is factored in place (the caller gives it
    up, as the JAX package's donating twins take their operand)."""
    n = a.shape[0]
    npad = -(-n // panel) * panel
    if npad == n:
        return a if donate else a.clone()
    out = torch.zeros((npad, npad), dtype=a.dtype, device=a.device)
    out[:n, :n] = a
    idx = torch.arange(n, npad, device=a.device)
    out[idx, idx] = 1.0
    return out


def _swap_steps(p: torch.Tensor, kb: int, zero_pivot_safe: bool):
    """The step loop of the stock swap-based panel over a stack of blocks
    ``(nb, h, panel)`` whose diagonals sit at row ``kb``: per column, the
    pivot by ``jnp.argmax``'s order (the first NaN wins), a physical
    two-row swap, the multipliers stored in place and the rank-1 update of
    the columns right of it. ``zero_pivot_safe`` multiplies by a guarded
    reciprocal (a zero pivot eliminates nothing) where the plain step
    divides, as the JAX package's ``_panel_factor_jax`` does. A NaN pivot
    counts as 0 in ``min_abs_pivot``."""
    nb, h, panel = p.shape
    p = p.clone()
    dev, dt = p.device, p.dtype
    blk = torch.arange(nb, device=dev)
    rows = torch.arange(h, device=dev)
    pcols = torch.arange(panel, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    ninf = torch.full((), float("-inf"), dtype=dt, device=dev)
    ipiv = torch.zeros((nb, panel), dtype=torch.int64, device=dev)
    min_piv = torch.full((nb,), float("inf"), dtype=dt, device=dev)
    for j in range(panel):
        c = kb + j
        cand = torch.where(rows >= c, p[:, :, j].abs(), ninf)
        nan = torch.isnan(cand)
        prow = torch.where(nan.any(1), torch.argmax(nan.to(torch.int32), 1),
                           torch.argmax(torch.where(nan, ninf, cand), 1))
        ipiv[:, j] = prow
        rc, rp = p[:, c].clone(), p[blk, prow]
        p[:, c] = rp
        p[blk, prow] = rc
        piv = p[:, c, j]
        apiv = piv.abs()
        min_piv = torch.minimum(min_piv,
                                torch.where(torch.isnan(apiv), zero, apiv))
        if zero_pivot_safe:
            inv_piv = torch.where(apiv > 0, 1.0 / piv, zero)
            q = p[:, :, j] * inv_piv[:, None]
        else:
            q = p[:, :, j] / piv[:, None]
        mult = torch.where(rows > c, q, zero)
        p[:, :, j] = torch.where(rows > c, mult, p[:, :, j])
        urow = torch.where(pcols > j, p[:, c], zero)
        p = p - mult[:, :, None] * urow[:, None, :]
    return p, ipiv, min_piv


def panel_factor_swap(p: torch.Tensor, kb: int = 0,
                      zero_pivot_safe: bool = False):
    """Unblocked partial-pivot elimination of one (h, panel) column block
    with physical row swaps (the JAX package's ``_panel_factor_jax``, the
    stock panel of ``panel_impl="jax"``). Returns ``(factored, ipiv,
    min_abs_pivot)``; ``ipiv[j]`` is the row swapped with row ``kb + j``.
    ``zero_pivot_safe``: a zero pivot eliminates nothing (multiplier 0)
    instead of NaN-poisoning the rows below it; ``min_abs_pivot`` still
    records 0."""
    f, ipiv, min_piv = _swap_steps(p[None], kb, zero_pivot_safe)
    return f[0], ipiv[0], min_piv[0]


def panel_factor_swap_batched(p: torch.Tensor):
    """:func:`panel_factor_swap` at ``kb = 0`` with ``zero_pivot_safe`` over
    a stack of blocks ``(nb, h, panel)`` at once (the JAX package runs
    ``jax.vmap`` of its stock panel here). Returns ``(factored, ipiv,
    min_abs_pivot)`` of shapes ``(nb, h, panel)``, ``(nb, panel)`` and
    ``(nb,)``."""
    return _swap_steps(p, 0, True)


def _fold_transpositions(ipiv: torch.Tensor, h: int) -> torch.Tensor:
    """Fold a swap panel's transposition sequence into gather indices."""
    perm = list(range(h))
    for j, r in enumerate(ipiv.tolist()):
        perm[j], perm[r] = perm[r], perm[j]
    return torch.as_tensor(perm, dtype=torch.int64, device=ipiv.device)


def _use_fused(panel_impl: str, panel: int, wtot: int,
               carried: bool = False) -> bool:
    """Whether a panel step runs the fused kernel: ``wtot`` is the width
    from the panel's first column to the block's last. ``carried`` (an
    ABFT checksum rider) falls back to the unfused pair, on which the
    checksum was validated."""
    if carried or wtot <= panel:
        return False
    if panel_impl == "fused":
        return True
    return panel_impl == "auto" and panel >= 64


PANEL_IMPLS = ("auto", "fused", "pallas", "jax")


def storage_dtype(x) -> torch.dtype:
    """The dtype a factorization stores ``x`` in: bfloat16 for a bfloat16
    tensor or array (``ml_dtypes``), float32 for everything else (float64
    and other inputs stage as float32)."""
    dt = getattr(x, "dtype", None)
    if dt == torch.bfloat16 or str(dt) == "bfloat16":
        return torch.bfloat16
    return torch.float32


def _stage(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``dev``; a numpy bfloat16 array
    (which torch cannot read) goes through float32, exactly."""
    if not isinstance(x, torch.Tensor) and str(getattr(x, "dtype", "")) \
            == "bfloat16":
        x = np.asarray(x, np.float32)
    return as_tensor(x, dev, dtype)


def _check_square(a, panel_impl: str, device):
    if panel_impl not in PANEL_IMPLS:
        raise ValueError(f"unknown panel_impl {panel_impl!r}; "
                         f"options: {PANEL_IMPLS}")
    dev = resolve_device(device)
    a = _stage(a, dev, storage_dtype(a))
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"expected square matrix, got {tuple(a.shape)}")
    return a, dev


def _factor_panel(m: torch.Tensor, kb: int, panel: int, panel_impl: str,
                  zero_pivot_safe: bool = False, carried: bool = False):
    """Factor the (live rows, panel) column block of ``m`` at column
    ``kb``. ``m`` may be rectangular (a group's column block, which may be
    a strided view); on the fused route the kernel also updates the
    trailing columns of the live rows of ``m`` in place. Returns ``(p,
    perm_local, min_abs_pivot, fused)``: the factored panel in pivot
    order, the gather indices of the live rows, and whether the trailing
    update is done. Single source for every factor form.
    ``zero_pivot_safe`` applies to the stock panel (``"jax"``) only;
    ``carried`` pins the unfused pair."""
    live = m[kb:]
    if _use_fused(panel_impl, panel, m.shape[1] - kb, carried):
        # One launch: factor + U12 + trailing update; the trailing
        # columns of `live` (a view of m) are updated in place.
        p, _, perm_local, mp, _ = panel_trailing_fused(live, kb, 0,
                                                       panel=panel)
        return p, perm_local, mp, True
    if panel_impl == "jax":
        p, ipiv, mp = panel_factor_swap(live[:, kb:kb + panel], 0,
                                        zero_pivot_safe)
        return p, _fold_transpositions(ipiv, live.shape[0]), mp, False
    p, _, perm_local, mp = panel_factor(live[:, kb:kb + panel], 0)
    return p, perm_local, mp, False


def _apply_pivots(m: torch.Tensor, perm: torch.Tensor, kb: int,
                  perm_local: torch.Tensor) -> torch.Tensor:
    """Permute the live rows of ``m`` (the L multipliers left of the panel
    move with their rows) into a new tensor, and ``perm`` with them, in
    place. Returns the permuted live rows."""
    perm[kb:] = perm[kb:][perm_local]
    return m[kb:][perm_local]


def _install_and_update(m: torch.Tensor, live: torch.Tensor, kb: int,
                        panel: int, p: torch.Tensor, fused: bool,
                        mode: str) -> torch.Tensor:
    """Install the factored panel into the permuted live rows, compute the
    L diagonal-block inverse, apply U12 = L11^-1 A12 and A22 -= L21 U12
    unless the fused kernel did, and write the live rows back into ``m``.
    Returns the L diagonal-block inverse. ``m`` may be rectangular: the
    update covers its columns right of the panel. The GEMMs follow the
    precision contract (:func:`_gdot`)."""
    live[:, kb:kb + panel] = p
    linv = _diag_block_linv(live[:panel, kb:kb + panel])
    if not fused and kb + panel < m.shape[1]:
        dt = m.dtype
        u12 = _gdot(linv, live[:panel, kb + panel:], mode, dt)
        live[:panel, kb + panel:] = u12
        live[panel:, kb + panel:] -= _gdot(live[panel:, kb:kb + panel], u12,
                                           mode, dt)
    m[kb:] = live
    return linv


def _uinvs(m: torch.Tensor, panel: int) -> torch.Tensor:
    """The U diagonal-block inverses, only needed by lu_solve: one pass
    over the finished diagonal blocks after the panel loop."""
    return torch.stack([_diag_block_uinv(m[kb:kb + panel, kb:kb + panel])
                        for kb in range(0, m.shape[0], panel)])


# --- ABFT: the column-checksum rider (Huang & Abraham 1984) --------------
#
# The JAX package's checksum helpers as plain tensor functions. A row
# c = e^T A, carried beside the factor, is an invariant of blocked LU with
# partial pivoting: row swaps permute rows within the live set (column
# sums unchanged) and the update A22 -= L21 U12 maps it to c2 -= (c1
# U11^-1) U12 = e^T A22'. Checking it after each panel (flat form) or group
# (chunked form), and e^T P A = (e^T L) U at the end, localizes silent
# corruption. The rider reads the factor and never writes it.


def _nan_inf_abs(diff: torch.Tensor) -> torch.Tensor:
    """|diff| with NaN folded to +inf, so a NaN mismatch is detected."""
    return torch.where(torch.isnan(diff),
                       torch.full_like(diff, float("inf")), diff.abs())


def _csum_init(m: torch.Tensor) -> torch.Tensor:
    """The initial column-checksum row ``e^T m`` of the padded operand."""
    return m.sum(0, keepdim=True)


def _csum_group_solve(c1, grp, uinvs, gpanels: int, panel: int, mode: str):
    """``c1 @ Ugroup^-1``: blockwise right-substitution against the
    factored group's (w, w) upper triangle through its per-panel U
    diagonal-block inverses (the checksum row's multipliers)."""
    xs = []
    for j in range(gpanels):
        r = c1[:, j * panel:(j + 1) * panel]
        for i in range(j):
            r = r - gdot(xs[i], grp[i * panel:(i + 1) * panel,
                                    j * panel:(j + 1) * panel], mode)
        xs.append(gdot(r, uinvs[j], mode))
    return torch.cat(xs, dim=1)


def _csum_group_col_err(block, u, c1):
    """The group-column identity ``c1 == (e^T L_group) @ Ugroup`` over the
    group's columns: ``block`` is the (h, w) factored column trapezoid
    (multipliers strictly below the diagonal), ``u`` its (w, w) top.
    Returns (max mismatch, argmax column within the group)."""
    el = torch.tril(block, -1).sum(0) + 1.0  # unit diagonal of L
    pred = el[None, :] @ torch.triu(u)
    diff = _nan_inf_abs(pred[0] - c1[0])
    return diff.max(), diff.argmax()


def _csum_trailing_err(m, crow, split: int):
    """``(max |colsums(m[split:, :]) - crow|, argmax column)`` over the
    columns at or right of ``split`` (columns left of it count 0)."""
    diff = torch.zeros(m.shape[1], dtype=m.dtype, device=m.device)
    diff[split:] = m[split:, split:].sum(0) - crow[0, split:]
    diff = _nan_inf_abs(diff)
    return diff.max(), diff.argmax()


def _csum_final_err_lu(m, crow0):
    """The post-factor identity ``e^T P A = (e^T L) @ U``: the initial
    checksum row against the L-column-sum-weighted rows of U."""
    el = torch.tril(m, -1).sum(0) + 1.0
    pred = el[None, :] @ torch.triu(m)
    diff = _nan_inf_abs(pred[0] - crow0[0])
    return diff.max(), diff.argmax()


def _csum_panel(m, crow, kb: int, panel: int, mode: str):
    """The flat form's rider after the panel at ``kb``: the checksum row's
    multipliers ``c1 @ U11^-1`` take the same ``@ U12`` subtraction the
    live rows took, then the trailing block's column sums and the panel's
    own column identity are checked. Returns ``(crow', err)``."""
    ncols = m.shape[1]
    c1 = crow[:, kb:kb + panel]
    d = m[kb:kb + panel, kb:kb + panel]
    if kb + panel < ncols:
        lc = gdot(c1, _diag_block_uinv(d), mode)
        crow = torch.cat([crow[:, :kb + panel],
                          crow[:, kb + panel:] - gdot(
                              lc, m[kb:kb + panel, kb + panel:], mode)],
                         dim=1)
    err, _ = _csum_trailing_err(m, crow, kb + panel)
    el = torch.tril(m[kb:, kb:kb + panel], -1).sum(0) + 1.0
    gdiff = _nan_inf_abs((el[None, :] @ torch.triu(d))[0] - c1[0])
    return crow, torch.maximum(err, gdiff.max())


def abft_default_tol(npad: int, dtype, scale: float) -> float:
    """The detection threshold of an (npad, npad) checksum-carrying
    factorization at checksum magnitude ``scale`` (the max |initial column
    sum|): above the checksum's accumulated rounding, far below a high-bit
    flip. Copied from the JAX package's ``resilience/abft.py:155``
    (``default_tol``), which the port does not import."""
    eps = float(torch.finfo(dtype).eps if isinstance(dtype, torch.dtype)
                else np.finfo(np.dtype(dtype)).eps)
    return max(float(scale), 1.0) * max(64.0 * npad * eps, 1e-6)


def _check_lowered_support(dtype: torch.dtype, gemm_precision: str,
                           abft: bool) -> None:
    """The rider's tolerances and dots are defined against float32 math:
    bfloat16 storage and the explicit split GEMM are refused with it (a
    bfloat16 rider would alarm on storage rounding)."""
    if abft and (dtype == torch.bfloat16 or gemm_precision == BF16X3):
        raise ValueError(
            "abft=True requires float32 storage with a lax.Precision gemm "
            "(the checksum invariant's tolerances are calibrated against "
            "f32 HIGHEST math); run the lowered dtype without the rider, "
            "or the rider at float32")


def _factor_panels(m: torch.Tensor, panel: int, panel_impl: str, mode: str,
                   zero_pivot_safe: bool = False,
                   abft: bool = False) -> BlockedLU:
    """The panel loop of the unrolled and flat forms on the padded ``m``
    (factored in place)."""
    npad = m.shape[0]
    dev = m.device
    perm = torch.arange(npad, device=dev)
    min_piv = torch.full((), float("inf"), dtype=m.dtype, device=dev)
    linvs, errs = [], []
    crow0 = crow = _csum_init(m) if abft else None
    for kb in range(0, npad, panel):
        p, perm_local, mp, fused = _factor_panel(
            m, kb, panel, panel_impl, zero_pivot_safe, carried=abft)
        live = _apply_pivots(m, perm, kb, perm_local)
        min_piv = torch.minimum(min_piv, mp)
        linvs.append(_install_and_update(m, live, kb, panel, p, fused, mode))
        if abft:
            crow, err = _csum_panel(m, crow, kb, panel, mode)
            errs.append(err)
    abft_err = None
    if abft:
        errs.append(_csum_final_err_lu(m, crow0)[0])
        abft_err = torch.stack(errs)
    return BlockedLU(m=m, perm=perm, min_abs_pivot=min_piv,
                     linv=torch.stack(linvs), uinv=_uinvs(m, panel),
                     abft_err=abft_err)


def lu_factor_blocked_unrolled(a, panel: int | None = DEFAULT_PANEL,
                               panel_impl: str = "auto",
                               gemm_precision: str = "highest",
                               device=None, donate: bool = False) -> BlockedLU:
    """Blocked LU with partial pivoting, one Python step per column panel
    (the trailing submatrix genuinely shrinks: triangular work).

    ``a``: (n, n) array or tensor, factored on ``device`` (default
    ``cuda``; ``"cpu"`` runs the kernels' plain versions) in bfloat16
    when it is a bfloat16 tensor or array, else in float32 (the precision
    contract above).
    ``panel``: width, None = :func:`auto_panel`. ``panel_impl``: see the
    module docstring. ``gemm_precision``: the torch-GEMM trailing updates
    of the ``pallas``/``jax`` routes ("highest" = true f32, "high" and
    "bf16x3" = the explicit bf16 split); the fused kernel runs its own
    arithmetic (float32, or the bfloat16 rounding of the reference at
    bfloat16 storage). ``donate``: factor ``a`` in place when it already
    lies on ``device`` in its storage dtype and needs no padding."""
    if _inject.enabled():
        a = _inject.corrupt_operand("core.blocked.factor", a)
    mode = resolve_precision(gemm_precision, allow_split=True)
    a, dev = _check_square(a, panel_impl, device)
    panel = _resolve_panel(a.shape[0], panel, a.element_size())
    return _factor_panels(_pad_to_panel(a, panel, donate), panel,
                          panel_impl, mode)


def lu_factor_blocked(a, panel: int | None = DEFAULT_PANEL,
                      panel_impl: str = "auto",
                      gemm_precision: str = "highest",
                      swap_impl: str = "gather",
                      zero_pivot_safe: bool = False, abft: bool = False,
                      device=None, donate: bool = False) -> BlockedLU:
    """The flat form (the JAX package's ``lu_factor_blocked``): the panel
    loop of :func:`lu_factor_blocked_unrolled` with the JAX form's options.

    ``swap_impl``: ``"gather"`` or ``"loop"``, validated as in the JAX
    package; both apply each panel's pivots as one folded gather, which
    gives the bits of the JAX form's two-row exchange loop (a choice of
    TPU cost that eager PyTorch does not have).
    ``zero_pivot_safe``: an exactly-zero pivot eliminates nothing instead
    of NaN-poisoning the rows below it (``min_abs_pivot`` still records
    0): the stock panel (``"jax"``), which alone guards the division,
    runs every panel, and no fused step.
    ``abft``: carry the column-checksum row through every panel and return
    ``abft_err`` of shape ``(nb + 1,)``; the unfused pair runs (``"auto"``
    and ``"fused"`` resolve to ``"pallas"``), so ``m``/``perm``/``linv``/
    ``uinv`` equal the ``abft=False, panel_impl="pallas"`` factor bit for
    bit. Other arguments as for :func:`lu_factor_blocked_unrolled`."""
    if _inject.enabled():
        a = _inject.corrupt_operand("core.blocked.factor", a)
    mode = resolve_precision(gemm_precision, allow_split=True)
    if swap_impl not in ("gather", "loop"):
        raise ValueError(f"unknown swap_impl {swap_impl!r}; options: "
                         f"('gather', 'loop')")
    a, dev = _check_square(a, panel_impl, device)
    _check_lowered_support(a.dtype, gemm_precision, abft)
    panel = _resolve_panel(a.shape[0], panel, a.element_size())
    if zero_pivot_safe:
        panel_impl = "jax"
    return _factor_panels(_pad_to_panel(a, panel, donate), panel,
                          panel_impl, mode, zero_pivot_safe=zero_pivot_safe,
                          abft=abft)


def lu_factor_blocked_phased(a, panel: int | None = None,
                             panel_impl: str = "auto",
                             gemm_precision: str = "highest",
                             timer=None, device=None) -> BlockedLU:
    """Blocked LU with per-phase telemetry spans — the solver-phase profile
    (the JAX package's ``lu_factor_blocked_phased``).

    The panel loop of :func:`lu_factor_blocked_unrolled`, through the same
    helpers, with a span around each phase (``pad_stage``, then per panel
    ``panel_factor`` / ``pivot_apply`` / ``trailing_update``), each closed
    after a synchronize of the card, reported through the PhaseTimer ->
    obs bridge. ``"auto"`` and ``"fused"`` resolve to the panel kernel
    (``"pallas"``), as in the JAX package, whose phased form never runs
    the fused kernel: so the result equals
    ``lu_factor_blocked_unrolled(..., panel_impl="pallas")`` bit for bit.
    The synchronizes make this the diagnostic path; the phase RATIOS are
    the payload.

    ``timer``: an optional :class:`gauss_tpu_torch.utils.profiling.PhaseTimer`
    to accumulate into (a private one is used otherwise)."""
    from gauss_tpu_torch.utils.profiling import PhaseTimer

    mode = resolve_precision(gemm_precision, allow_split=True)
    a, dev = _check_square(a, panel_impl, device)
    if panel_impl in ("auto", "fused"):
        panel_impl = "pallas"
    pt = PhaseTimer() if timer is None else timer
    panel = _resolve_panel(a.shape[0], panel, a.element_size())
    with pt.phase("pad_stage", block_on=a):
        m = _pad_to_panel(a, panel)
    npad = m.shape[0]
    perm = torch.arange(npad, device=dev)
    min_piv = torch.full((), float("inf"), dtype=m.dtype, device=dev)
    linvs = []
    for kb in range(0, npad, panel):
        with pt.phase("panel_factor", block_on=m):
            p, perm_local, mp, fused = _factor_panel(m, kb, panel,
                                                     panel_impl)
        min_piv = torch.minimum(min_piv, mp)
        with pt.phase("pivot_apply", block_on=m):
            live = _apply_pivots(m, perm, kb, perm_local)
        with pt.phase("trailing_update", block_on=m):
            linvs.append(_install_and_update(m, live, kb, panel, p, fused,
                                             mode))
    with pt.phase("trailing_update", block_on=m):
        uinv = _uinvs(m, panel)
    return BlockedLU(m=m, perm=perm, min_abs_pivot=min_piv,
                     linv=torch.stack(linvs), uinv=uinv)


def lu_solve(factors: BlockedLU, b, method: str = "auto") -> torch.Tensor:
    """Solve A x = b from a :class:`BlockedLU`: permute, L-solve, U-solve,
    on the factor's device. ``b`` is (n,) or (n, k).

    ``method="auto"`` runs both substitutions blockwise through the stored
    diagonal-block inverses — per block one GEMM against the solved strip
    and one inverse multiply (the JAX package's unrolled and scan forms are
    one loop here). ``"substitution"`` forces triangular solves, which keep
    substitution's backward stability on adversarial inputs (explicit
    unit-lower inverses can grow like 2^(panel-1)).

    The solve runs in the accumulate dtype and returns it: float32 against
    a bfloat16 factor (the precision contract), whose blocks are upcast
    exactly where they meet the solution."""
    if method not in ("auto", "substitution"):
        raise ValueError(f"unknown method {method!r}; options: "
                         "('auto', 'substitution')")
    m, perm = factors.m, factors.perm
    npad = m.shape[0]
    cdt = accum_dtype(m.dtype)
    b = _stage(b, m.device, cdt)
    was_vector = b.dim() == 1
    b2 = b[:, None] if was_vector else b
    if b2.dim() != 2:
        raise ValueError(f"b must be (n,) or (n, k), got {tuple(b.shape)}")
    n, k = b2.shape
    bp = torch.zeros((npad, k), dtype=cdt, device=m.device)
    bp[:n] = b2
    bp = bp[perm]
    if factors.linv is None or method == "substitution":
        ms = m.to(cdt)
        y = torch.linalg.solve_triangular(ms, bp, upper=False,
                                          unitriangular=True)
        x = torch.linalg.solve_triangular(ms, y, upper=True)
    else:
        nb, panel, _ = factors.linv.shape
        y = torch.zeros_like(bp)
        for i in range(nb):
            s = slice(i * panel, (i + 1) * panel)
            r = bp[s] - m[s, :i * panel].to(cdt) @ y[:i * panel]
            y[s] = factors.linv[i] @ r
        x = torch.zeros_like(bp)
        for i in range(nb - 1, -1, -1):
            s = slice(i * panel, (i + 1) * panel)
            r = y[s] - m[s, (i + 1) * panel:].to(cdt) @ x[(i + 1) * panel:]
            x[s] = factors.uinv[i] @ r
    x = x[:n]
    return x[:, 0] if was_vector else x


# --- The batched form: jax.vmap(lu_factor_blocked) ----------------------


def _pad_to_panel_batched(a: torch.Tensor, panel: int) -> torch.Tensor:
    """:func:`_pad_to_panel` on every member of a (B, n, n) stack, into a
    new tensor (the stack is factored in place)."""
    bsz, n, _ = a.shape
    npad = -(-n // panel) * panel
    if npad == n:
        return a.clone()
    out = torch.zeros((bsz, npad, npad), dtype=a.dtype, device=a.device)
    out[:, :n, :n] = a
    idx = torch.arange(n, npad, device=a.device)
    out[:, idx, idx] = 1.0
    return out


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b][idx[b]]`` for every member of a (B, h, w) stack."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def lu_factor_blocked_batched(a, panel: int | None = None,
                              panel_impl: str = "auto",
                              gemm_precision: str = "highest",
                              device=None) -> BlockedLU:
    """Blocked LU of every member of a (B, n, n) stack at once — the JAX
    package's ``jax.vmap(lu_factor_blocked)``, the serving lane's factor.

    Returns a :class:`BlockedLU` whose fields carry a leading batch axis:
    ``m`` (B, npad, npad), ``perm`` (B, npad), ``min_abs_pivot`` (B,),
    ``linv``/``uinv`` (B, nb, panel, panel). Each panel step is ONE
    launch for the whole stack: the batched fused kernel
    (:func:`gauss_tpu_torch.kernels.panel_fused.panel_trailing_fused_batched`)
    while columns remain right of the panel and the route is fused (as in
    :func:`_factor_panel`), else the batched panel kernel
    (:func:`gauss_tpu_torch.kernels.panel.panel_factor_batched`) — at
    n=2048, panel 256, seven fused launches and one panel launch per
    stack. The pivot gathers, the panel install, the unfused route's
    GEMMs and the diagonal-block inverses are batched torch ops. So each
    member's ``m``, ``perm`` and ``min_abs_pivot`` are bit for bit
    :func:`lu_factor_blocked` on that member (the kernels compute each
    member as the single-block kernels do; gathers are exact) wherever the
    route is fused, and ``linv``/``uinv`` agree to float32 rounding
    (batched and single products may round apart).

    ``a``: a (B, n, n) array or tensor, staged on ``device`` (default
    ``cuda``; ``"cpu"`` runs the kernels' plain versions) in bfloat16 when
    it is bfloat16, else float32, under the precision contract. ``panel``
    None resolves :func:`auto_panel` at the storage itemsize;
    ``panel_impl`` and ``gemm_precision`` as for
    :func:`lu_factor_blocked_unrolled` (``"jax"`` runs the stock swap
    panel on the stack)."""
    if panel_impl not in PANEL_IMPLS:
        raise ValueError(f"unknown panel_impl {panel_impl!r}; "
                         f"options: {PANEL_IMPLS}")
    mode = resolve_precision(gemm_precision, allow_split=True)
    dev = resolve_device(device)
    a = _stage(a, dev, storage_dtype(a))
    if a.dim() != 3 or a.shape[1] != a.shape[2] or a.shape[0] < 1:
        raise ValueError(f"expected a (B, n, n) stack, got "
                         f"{tuple(a.shape)}")
    panel = _resolve_panel(a.shape[1], panel, a.element_size())
    m = _pad_to_panel_batched(a, panel)
    bsz, npad, _ = m.shape
    dt = m.dtype
    perm = torch.arange(npad, device=dev).repeat(bsz, 1)
    min_piv = torch.full((bsz,), float("inf"), dtype=dt, device=dev)
    linvs = []
    for kb in range(0, npad, panel):
        live = m[:, kb:]
        fused = _use_fused(panel_impl, panel, npad - kb)
        if fused:
            # One launch: every member's factor + U12 + trailing update;
            # the trailing columns of `live` (a view of m) in place.
            p, _, perm_local, mp, _ = _kpf.panel_trailing_fused_batched(
                live, kb, 0, panel=panel)
        elif panel_impl == "jax":
            p, ipiv, mp = _swap_steps(live[:, :, kb:kb + panel], 0, False)
            perm_local = torch.stack([_fold_transpositions(ipiv[i],
                                                           npad - kb)
                                      for i in range(bsz)])
        else:
            p, _, perm_local, mp = _kp.panel_factor_batched(
                live[:, :, kb:kb + panel], 0)
        min_piv = torch.minimum(min_piv, mp)
        perm[:, kb:] = torch.gather(perm[:, kb:], 1, perm_local)
        live = _gather_rows(live, perm_local)
        live[:, :, kb:kb + panel] = p
        linv = _diag_block_linv(live[:, :panel, kb:kb + panel])
        if not fused and kb + panel < npad:
            u12 = _gdot(linv, live[:, :panel, kb + panel:], mode, dt)
            live[:, :panel, kb + panel:] = u12
            live[:, panel:, kb + panel:] -= _gdot(
                live[:, panel:, kb:kb + panel], u12, mode, dt)
        m[:, kb:] = live
        linvs.append(linv)
    uinv = torch.stack([_diag_block_uinv(m[:, kb:kb + panel, kb:kb + panel])
                        for kb in range(0, npad, panel)], dim=1)
    return BlockedLU(m=m, perm=perm, min_abs_pivot=min_piv,
                     linv=torch.stack(linvs, dim=1), uinv=uinv)


def lu_solve_batched(factors: BlockedLU, b) -> torch.Tensor:
    """:func:`lu_solve` on every member of a batched :class:`BlockedLU`
    (:func:`lu_factor_blocked_batched`) — ``jax.vmap(lu_solve)``: ``b`` is
    (B, n) or (B, n, k); both substitutions run blockwise through the
    stored diagonal-block inverses, one batched product per block, in the
    accumulate dtype (float32 against a bfloat16 factor)."""
    m, perm = factors.m, factors.perm
    bsz, npad, _ = m.shape
    cdt = accum_dtype(m.dtype)
    b = _stage(b, m.device, cdt)
    was_vector = b.dim() == 2
    b3 = b[:, :, None] if was_vector else b
    if b3.dim() != 3 or b3.shape[0] != bsz:
        raise ValueError(f"b must be (B, n) or (B, n, k) with B={bsz}, got "
                         f"{tuple(b.shape)}")
    n, k = b3.shape[1:]
    bp = torch.zeros((bsz, npad, k), dtype=cdt, device=m.device)
    bp[:, :n] = b3
    bp = _gather_rows(bp, perm)
    nb, panel = factors.linv.shape[1:3]
    y = torch.zeros_like(bp)
    for i in range(nb):
        s = slice(i * panel, (i + 1) * panel)
        r = bp[:, s] - m[:, s, :i * panel].to(cdt) @ y[:, :i * panel]
        y[:, s] = factors.linv[:, i] @ r
    x = torch.zeros_like(bp)
    for i in range(nb - 1, -1, -1):
        s = slice(i * panel, (i + 1) * panel)
        r = y[:, s] - m[:, s, (i + 1) * panel:].to(cdt) @ x[:, (i + 1) * panel:]
        x[:, s] = factors.uinv[:, i] @ r
    x = x[:, :n]
    return x[:, :, 0] if was_vector else x


def lu_factor_blocked_chunked(a, panel: int | None = DEFAULT_PANEL,
                              chunk: int = CHUNK_DEFAULT,
                              panel_impl: str = "auto",
                              gemm_precision: str = "highest",
                              abft: bool = False, device=None,
                              donate: bool = False) -> BlockedLU:
    """Blocked LU in groups of ``chunk`` panels (the JAX package's
    ``lu_factor_blocked_chunked``): per group, :func:`_factor_group`
    factors the group's panels over its own column block and then gives
    the columns right of the group one deferred update. ``abft``: the
    checksum rider per group (``abft_err`` of shape ``(groups + 1,)``),
    on the unfused pair. Other arguments as for
    :func:`lu_factor_blocked_unrolled`."""
    if _inject.enabled():
        a = _inject.corrupt_operand("core.blocked.factor", a)
    mode = resolve_precision(gemm_precision, allow_split=True)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    a, dev = _check_square(a, panel_impl, device)
    _check_lowered_support(a.dtype, gemm_precision, abft)
    panel = _resolve_panel(a.shape[0], panel, a.element_size())
    m = _pad_to_panel(a, panel, donate)
    nb = m.shape[0] // panel
    perm = torch.arange(m.shape[0], device=dev)
    min_piv = torch.full((), float("inf"), dtype=m.dtype, device=dev)
    linvs_all, uinvs_all, errs = [], [], []
    crow0 = crow = _csum_init(m) if abft else None
    for g0 in range(0, nb, chunk):
        if abft:
            m, perm, min_piv, linvs, uinvs, crow, err, _ = _factor_group(
                m, perm, min_piv, g0, panel, chunk, panel_impl, mode,
                crow=crow)
            errs.append(err)
        else:
            m, perm, min_piv, linvs, uinvs = _factor_group(
                m, perm, min_piv, g0, panel, chunk, panel_impl, mode)
        linvs_all.append(linvs)
        uinvs_all.append(uinvs)
    abft_err = None
    if abft:
        errs.append(_csum_final_err_lu(m, crow0)[0])
        abft_err = torch.stack(errs)
    return BlockedLU(m=m, perm=perm, min_abs_pivot=min_piv,
                     linv=torch.cat(linvs_all), uinv=torch.cat(uinvs_all),
                     abft_err=abft_err)


def _factor_group(m, perm, min_piv, g0: int, panel: int, chunk: int,
                  panel_impl: str, mode: str, crow=None):
    """One group of the chunked factorization (the JAX package's
    ``_factor_group``, the single source of the chunked, checkpointed,
    ABFT and out-of-core factorizations): factor up to ``chunk`` panels
    from panel ``g0`` over the group's own column block, apply the group's
    composed permutation to the rest of its rows, and run the deferred
    right-of-group update. ``m`` and ``perm`` are updated in place.
    Returns ``(m, perm, min_piv, linvs, uinvs)`` with the group's
    (gpanels, panel, panel) diagonal-block inverses.

    ``m`` may be RECTANGULAR: the right-of-group width is ``m.shape[1] -
    gs - w``, so a group's own (gh, w) column block alone (``g0 = 0``)
    has none. ``mode`` is a resolved GEMM precision
    (:func:`gauss_tpu_torch.core.matmul.resolve_precision`).

    ``crow``: an optional (1, ncols) ABFT checksum row. It pins the
    unfused pair, takes the group's ``Lc @ U12`` update, and the group's
    columns and the trailing block are checked against it; the return
    grows to ``(..., crow', err, err_col)``, the mismatch and the global
    column it localizes to.

    The panels run on a view of the group's columns (``m[gs:, gs:gs +
    w]``, leading dimension ``m.shape[1]``): each panel's live rows are
    permuted within the group's columns only; the rows' other columns are
    realigned once at the group's end. Then U12 = L_group^-1 A12 by a
    blockwise solve through the group's ``linvs`` and A22 -= L21 U12 as
    one GEMM: gathered, multiplied and written last while
    ``4 * npad * ncols * itemsize <= GROUP_UPDATE_UNSTRIPPED_MAX_BYTES``,
    else in place in strips of ``GROUP_UPDATE_STRIP`` rows after a
    gather of the right columns."""
    npad = m.shape[0]
    nb = npad // panel
    gs = g0 * panel
    gh = npad - gs
    gpanels = min(chunk, nb - g0)
    w = gpanels * panel
    rt = m.shape[1] - gs - w
    grp = m[gs:, gs:gs + w]
    gperm = torch.arange(gh, device=m.device)
    carried = crow is not None
    linvs = []
    for j in range(gpanels):
        kb = j * panel
        p, perm_local, mp, fused = _factor_panel(grp, kb, panel, panel_impl,
                                                 carried=carried)
        min_piv = torch.minimum(min_piv, mp)
        live = _apply_pivots(grp, gperm, kb, perm_local)
        linvs.append(_install_and_update(grp, live, kb, panel, p, fused,
                                         mode))
    linvs = torch.stack(linvs)
    uinvs = _uinvs(grp[:w], panel)

    unstripped = (4 * npad * m.shape[1] * m.element_size()
                  <= GROUP_UPDATE_UNSTRIPPED_MAX_BYTES)
    rows = gs + gperm
    if gs:
        m[gs:, :gs] = m[rows, :gs]
    if rt and not unstripped:
        m[gs:, gs + w:] = m[rows, gs + w:]
    perm[gs:] = perm[rows]

    if rt:
        dt = m.dtype
        top = m[rows[:w], gs + w:] if unstripped else m[gs:gs + w, gs + w:]
        u12 = torch.empty((w, rt), dtype=dt, device=m.device)
        for i in range(gpanels):
            s = slice(i * panel, (i + 1) * panel)
            r = top[s]
            if i:
                r = r - _gdot(grp[s, :i * panel], u12[:i * panel], mode, dt)
            u12[s] = _gdot(linvs[i], r, mode, dt)
        if carried:
            lc = _csum_group_solve(crow[:, gs:gs + w], grp, uinvs, gpanels,
                                   panel, mode)
            crow = torch.cat([crow[:, :gs + w],
                              crow[:, gs + w:] - gdot(lc, u12, mode)], dim=1)
        if unstripped:
            # Gather, multiply, then write: rows[w:] can name rows of the
            # group's top block, whose right columns the u12 write below
            # replaces.
            fresh = m[rows[w:], gs + w:] - _gdot(grp[w:], u12, mode, dt)
            m[gs:gs + w, gs + w:] = u12
            m[gs + w:, gs + w:] = fresh
        else:
            m[gs:gs + w, gs + w:] = u12
            sw = max(1, min(GROUP_UPDATE_STRIP, gh - w))
            for r0 in range(w, gh, sw):
                r1 = min(r0 + sw, gh)
                m[gs + r0:gs + r1, gs + w:] -= _gdot(grp[r0:r1], u12, mode,
                                                     dt)

    if not carried:
        return m, perm, min_piv, linvs, uinvs
    g_err, g_col = _csum_group_col_err(grp, grp[:w], crow[:, gs:gs + w])
    err, err_col = g_err, gs + g_col
    if rt:
        diff = _nan_inf_abs(m[gs + w:, gs + w:].sum(0) - crow[0, gs + w:])
        t_err, t_col = diff.max(), gs + w + diff.argmax()
        err_col = torch.where(g_err >= t_err, err_col, t_col)
        err = torch.maximum(g_err, t_err)
    return m, perm, min_piv, linvs, uinvs, crow, err, err_col


def resolve_factor(n: int, unroll="auto", *, donate: bool = False,
                   checkpoint_path=None, abft: bool = False, device=None):
    """The factorization for (size, unroll policy), by the JAX package's
    policy with a CUDA ``device`` (None means CUDA) where it asks for a
    TPU: see the module docstring's table. ``True``, ``False`` and
    ``"chunked"`` force the unrolled, flat and chunked forms. Returns the
    factor function, or a ``functools.partial`` of it carrying ``chunk``,
    ``abft`` or ``donate``; the caller passes ``device`` (and panel,
    panel_impl, ...) to it. Nothing runs and no device is touched here.

    ``abft=True`` selects the checksum-carrying form, the flat one where
    the policy says unrolled. ``donate=True`` lets the factorization take
    the caller's tensor in place when it needs no padding (the JAX
    package's donating twins). A tuned store's ``"lu_factor"`` ``chunk``
    for the size bucket replaces the seed before the escalation.
    ``checkpoint_path`` routes to the host-stepped checkpointed chunked
    factorization (:func:`gauss_tpu_torch.resilience.checkpoint
    .lu_factor_blocked_chunked_checkpointed`, a partial carrying
    ``path``); it and ``abft`` are mutually exclusive."""
    if checkpoint_path is not None:
        if abft:
            raise ValueError("checkpoint_path and abft are mutually "
                             "exclusive; the ABFT runner keeps its own "
                             "in-memory carry (resilience.abft)")
        from gauss_tpu_torch.resilience.checkpoint import \
            lu_factor_blocked_chunked_checkpointed

        return partial(lu_factor_blocked_chunked_checkpointed,
                       path=checkpoint_path)

    def pick(fn, **kw):
        if abft:
            if fn is lu_factor_blocked_unrolled:
                fn = lu_factor_blocked
            kw["abft"] = True
        elif donate:
            kw["donate"] = True
        return partial(fn, **kw) if kw else fn

    if unroll == "auto":
        on_card = torch.device("cuda" if device is None
                               else device).type == "cuda"
        if not on_card and n < 1024:
            return pick(lu_factor_blocked)
        if n > UNROLL_MAX_N:
            # As in the JAX package, the chunk is chosen from the panel at
            # itemsize 4 whatever the operand's dtype, while the factor
            # resolves its own panel at the operand's itemsize.
            panel = auto_panel(n)
            nb = -(-n // panel)
            chunk = int(_tune.override("lu_factor", n, "chunk")
                        or CHUNK_DEFAULT)
            while -(-nb // chunk) > MAX_CHUNK_GROUPS and chunk < MAX_CHUNK:
                chunk *= 2
            if -(-nb // chunk) > MAX_CHUNK_GROUPS:
                return pick(lu_factor_blocked)
            if panel == 128 and chunk == 16:
                chunk = 32
            if chunk == CHUNK_DEFAULT:
                return pick(lu_factor_blocked_chunked)
            return pick(lu_factor_blocked_chunked, chunk=chunk)
        return pick(lu_factor_blocked_unrolled)
    if unroll == "chunked":
        return pick(lu_factor_blocked_chunked)
    if isinstance(unroll, str):
        raise ValueError(f"unknown unroll {unroll!r}; options: "
                         "(True, False, 'auto', 'chunked')")
    return pick(lu_factor_blocked_unrolled if unroll else lu_factor_blocked)


def gauss_solve_blocked(a, b, panel: int | None = None,
                        panel_impl: str = "auto", unroll="auto",
                        gemm_precision: str = "highest",
                        device=None) -> torch.Tensor:
    """Factor + solve (float32) on ``device`` (default ``cuda``)."""
    factor = resolve_factor(np.shape(a)[0], unroll, device=device)
    fac = factor(a, panel=panel, panel_impl=panel_impl,
                 gemm_precision=gemm_precision, device=device)
    return lu_solve(fac, b)


def _torch_dtype(dtype) -> torch.dtype:
    """A storage dtype named by a torch dtype, a string or a numpy dtype:
    float32 or bfloat16, the two the kernels take."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = str(dtype)
    if name in ("float32", "bfloat16"):
        return getattr(torch, name)
    raise ValueError(f"dtype={dtype!r}: the port factors in float32 or "
                     f"bfloat16 only")


def solve_refined(a, b, panel: int | None = None, iters: int = 2,
                  dtype=torch.float32, panel_impl: str = "auto", a_dev=None,
                  b_dev=None, tol: float = 0.0, unroll="auto", device=None):
    """Mixed-precision solve: blocked factorization on the device in
    ``dtype`` (float32, or bfloat16 under the precision contract), float64
    residual refinement on the host (one O(n^2) matvec per iteration
    against the O(n^3) factor). Returns ``(x_float64, factors)``.

    ``a_dev``/``b_dev``: the already-staged ``dtype`` tensors of a/b (timed
    callers stage outside their span); their device is then the device.
    Without ``a_dev`` the staged copy is made here and, when it needs no
    padding, factored in place (``donate``, as in the JAX package). Each
    correction's right-hand side is staged in ``dtype``, as in the JAX
    package. ``tol``: stop once ``||Ax - b||_2 <= tol * min(1, ||b||_2)``;
    0 runs exactly ``iters`` iterations."""
    a64 = np.asarray(a, dtype=np.float64)
    b64 = np.asarray(b, dtype=np.float64)
    n = len(b64)
    dt = _torch_dtype(dtype)
    dev = a_dev.device if a_dev is not None else resolve_device(device)
    donate = a_dev is None
    if a_dev is None:
        a_dev = as_tensor(a64, dev, dt)
    if b_dev is None:
        b_dev = as_tensor(b64, dev, dt)
    factor = resolve_factor(n, unroll, donate=donate, device=dev)
    fac = factor(a_dev, panel=panel, panel_impl=panel_impl, device=dev)
    x = lu_solve(fac, b_dev).cpu().numpy().astype(np.float64)
    tol_eff = tol * min(1.0, float(np.linalg.norm(b64))) if tol > 0 else 0.0
    for _ in range(iters):
        r = b64 - a64 @ x
        if tol > 0.0 and float(np.linalg.norm(r)) <= tol_eff:
            break
        d = lu_solve(fac, as_tensor(r, dev, dt)).cpu().numpy()
        x = x + d.astype(np.float64)
    return x, fac


# --- Size routing: the single-card budget and solve_handoff ---------------

#: Usable bytes of one device when the runtime cannot report them (the
#: JAX package's value).
DEFAULT_CHIP_BYTES = 13 * 2**30

#: Engines solve_handoff understands; None = size-routed.
HANDOFF_ENGINES = (None, "single_chip", "dist", "outofcore")


class LaneNotPortedError(NotImplementedError):
    """A :func:`solve_handoff` lane the JAX package has and the port does
    not yet: the sharded (``dist``) engine, ROADMAP queue-1 item 10.
    Raised instead of any fallback."""


def device_memory_budget(device=None) -> int:
    """Usable bytes on ``device`` (None means the card): 0.85 of the total
    ``torch.cuda.mem_get_info`` reports on a CUDA device, else
    :data:`DEFAULT_CHIP_BYTES`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return int(0.85 * torch.cuda.mem_get_info(dev)[1])
    return DEFAULT_CHIP_BYTES


def fits_single_chip(n: int, itemsize: int = 4, budget: int | None = None,
                     device=None) -> bool:
    """Whether a blocked factorization's working set fits one device: ~3
    matrix copies (operand, factor in progress, slice/update transients)
    against ``budget`` (default :func:`device_memory_budget`)."""
    budget = device_memory_budget(device) if budget is None else budget
    return 3 * n * n * itemsize <= budget


def _dtype_itemsize(dt) -> int:
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    if isinstance(dt, str) and isinstance(getattr(torch, dt, None),
                                          torch.dtype):
        return getattr(torch, dt).itemsize
    return np.dtype(dt).itemsize


def _handoff_itemsize(a, single_chip_kwargs: dict) -> int:
    """The device-storage itemsize a handoff solve would occupy: a
    requested ``dtype`` wins; an operand already in a float type narrower
    than 8 bytes keeps its own; float64 host operands count 4 bytes (the
    refined path stages them at float32)."""
    req = single_chip_kwargs.get("dtype")
    if req is not None:
        return _dtype_itemsize(req)
    dt = getattr(a, "dtype", None)
    if isinstance(dt, torch.dtype):
        if dt.is_floating_point and dt.itemsize < 8:
            return dt.itemsize
    elif dt is not None:
        dt = np.dtype(dt)
        if dt.kind in ("f", "V") and dt.itemsize < 8:
            return dt.itemsize
    return 4


def solve_handoff(a, b, budget: int | None = None, mesh=None,
                  panel: int | None = None, iters: int = 2, tol: float = 0.0,
                  engine: str | None = None, **single_chip_kwargs):
    """Size-routed solve (the JAX package's ``solve_handoff``): the
    single-card refined path (:func:`solve_refined`) while the working set
    fits the budget (:func:`fits_single_chip`), the host-streamed
    out-of-core engine (:func:`gauss_tpu_torch.outofcore.solve_outofcore`)
    beyond it while the host can admit the system
    (:func:`gauss_tpu_torch.outofcore.outofcore_fits`), a ValueError past
    that. Each route emits a ``route`` event with the JAX package's
    fields. Returns x float64, refined on every route.

    ``engine`` forces a lane: ``"single_chip"``, ``"outofcore"`` or
    ``"dist"`` (None = size-routed); ``"dist"`` raises
    :class:`LaneNotPortedError`. Options a chosen lane cannot honour raise
    ValueError, as in the JAX package: ``single_chip_kwargs`` are
    :func:`solve_refined`'s (dtype, panel_impl, unroll, a_dev, b_dev,
    device), and the out-of-core lane honours ``dtype`` and ``device``
    only. ``dtype`` counts in the estimate and must be float32 or
    bfloat16 (the dtypes the kernels take).

    Deviation: the port has no device mesh, so ``mesh`` is accepted for
    the JAX signature and read by no lane; where the JAX package, given a
    multi-device mesh, shards an oversized request (``dist``), the port
    streams it out of core."""
    from gauss_tpu_torch import obs

    del mesh
    if engine not in HANDOFF_ENGINES:
        raise ValueError(f"unknown handoff engine {engine!r}; options: "
                         f"{HANDOFF_ENGINES}")
    n = np.shape(a)[0]
    device = single_chip_kwargs.get("device")
    eff_budget = (budget if budget is not None
                  else device_memory_budget(device))
    itemsize = _handoff_itemsize(a, single_chip_kwargs)
    est_bytes = 3 * n * n * itemsize
    if single_chip_kwargs.get("dtype") is not None:
        _torch_dtype(single_chip_kwargs["dtype"])

    def outofcore_route():
        from gauss_tpu_torch import outofcore

        bad = sorted(set(single_chip_kwargs) - {"dtype", "device"})
        if bad:
            raise ValueError(
                f"n={n} routes to the out-of-core engine and these options "
                f"do not apply to it: {bad}")
        obs.emit("route", tool="solve_handoff", n=n, lane="outofcore",
                 est_bytes=est_bytes, budget=eff_budget, itemsize=itemsize)
        return outofcore.solve_outofcore(a, b, panel=panel, iters=iters,
                                         tol=tol, **single_chip_kwargs)

    if engine == "outofcore":
        return outofcore_route()
    if engine == "single_chip" or (
            engine is None
            and fits_single_chip(n, itemsize=itemsize, budget=eff_budget)):
        obs.emit("route", tool="solve_handoff", n=n, lane="single_chip",
                 est_bytes=est_bytes, budget=eff_budget, itemsize=itemsize)
        return solve_refined(a, b, panel=panel, iters=iters, tol=tol,
                             **single_chip_kwargs)[0]
    if engine is None:
        from gauss_tpu_torch import outofcore

        if outofcore.outofcore_fits(n, itemsize=itemsize, device=device):
            return outofcore_route()
        raise ValueError(
            f"n={n} exceeds the single-card budget (needs ~{est_bytes} "
            f"bytes at itemsize {itemsize}, budget {eff_budget}) and the "
            f"host-streamed out-of-core engine cannot admit it either "
            f"(gauss_tpu_torch.outofcore.outofcore_fits)")
    options = sorted(set(single_chip_kwargs) - {"device"})
    if options:
        raise ValueError(f"n={n} routes to the dist engine and these "
                         f"options do not apply to it: {options}")
    raise LaneNotPortedError(
        f"n={n}: the dist lane (working set ~{est_bytes} bytes at itemsize "
        f"{itemsize}, single-card budget {eff_budget}) is not ported yet: "
        f"the sharded engine is ROADMAP queue-1 item 10")

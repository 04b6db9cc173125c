"""Fused panel-factor + trailing-update, and the unfused pair's trailing leg.

Port of ``gauss_tpu/kernels/panel_fused_pallas.py``:

- :func:`panel_trailing_fused` (``panel_trailing_fused_pallas``): ONE
  launch factors the (h, panel) column block of ``block`` at ``col0`` —
  the panel kernel's step loop, recording each step's multiplier row —
  and applies its eliminations to every column right of the panel. Pivot
  rows come out holding U12 and live rows A22 - L21 @ U12, in the block's
  ORIGINAL row order; columns at or left of ``col0 + panel`` are not
  written. CUDA kernel: ``csrc/panel_fused.cu`` (a cooperative launch:
  block 0 factors, grid-wide barrier, every block updates trailing
  chunks).
- :func:`trailing_update` (``trailing_update_pallas``): the same trailing
  math as its own launch, from multipliers and pivots that
  :func:`reconstruct_mult_pt` rebuilds exactly (gathers and selects only)
  from a factored panel.

The contract, as in the JAX package: fused == panel + reconstruct +
trailing, bit for bit, at matching ``fseg`` — on the card the kernels
share one step routine and one tile routine, on the CPU the plain versions
share their Python functions.

Trailing math per ``fseg``-wide segment of steps [s0, s1): U0 = the
segment's pivot rows; U = the forward substitution of U0 through the unit
lower coupling L[j, i] = mult[s0+i, p_j] (i < j) — the JAX package
inverts the same coupling by a factored Neumann series, equal up to
rounding; every row takes T - mult[s0:s1].T @ U (zero multipliers leave
done rows as they are); the pivot rows take U.

``ct`` (the trailing tile width) is accepted for API parity and changes
no value: every output column depends on its own column alone, so the
card's 32-column chunks give the same bits at any ``ct``. ``seg`` is
ignored (see :mod:`.panel`).
"""

from __future__ import annotations

import torch

from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.kernels.panel import (DEFAULT_SEG, check_cuda_f32,
                                           factor_steps_plain,
                                           perm_from_inv)

#: The JAX package's tuner seeds for the fused kernel's trailing tile width
#: and trailing-apply segment width.
FUSED_CT_SEED = 256
FUSED_FSEG_SEED = 32
#: Widest fseg the CUDA tile routine stages (csrc GTT_FSEG_MAX).
FSEG_MAX_CUDA = 64


def resolve_tiles(h: int, wtot: int, panel: int, ct=None, seg=None,
                  fseg=None):
    """``(ct, seg, fseg)`` as the JAX package resolves them without a tuned
    store: seeds for None, ``ct`` clamped to a panel multiple dividing the
    block width, ``seg``/``fseg`` clamped to [1, panel]."""
    del h
    ct = FUSED_CT_SEED if ct is None else int(ct)
    seg = DEFAULT_SEG if seg is None else int(seg)
    fseg = FUSED_FSEG_SEED if fseg is None else int(fseg)
    ct = max(panel, (min(ct, wtot) // panel) * panel)
    if wtot % ct:
        ct = panel
    return ct, min(max(1, seg), panel), min(max(1, fseg), panel)


def trailing_update_plain(block: torch.Tensor, mult: torch.Tensor,
                          ipiv: torch.Tensor, col0: int,
                          fseg: int) -> torch.Tensor:
    """The plain PyTorch trailing leg; updates ``block`` IN PLACE right of
    ``col0 + panel`` (panel = ``mult.shape[0]``) and returns it."""
    panel = mult.shape[0]
    c1 = col0 + panel
    if c1 >= block.shape[1]:
        return block
    trail = block[:, c1:]
    piv_all = ipiv.to(torch.int64)
    for s0 in range(0, panel, fseg):
        s1 = min(s0 + fseg, panel)
        piv = piv_all[s0:s1]
        m = mult[s0:s1]                      # (w, h)
        u = trail.index_select(0, piv)       # U0 (w, nc)
        lc = m.index_select(1, piv)          # lc[i, j] = mult[s0+i, p_j]
        for j in range(1, s1 - s0):
            u[j] -= lc[:j, j] @ u[:j]
        trail -= m.T @ u
        trail.index_copy_(0, piv, u)
    return block


def panel_trailing_fused_plain(block: torch.Tensor, col0: int, kbrow: int,
                               *, panel: int, fseg: int = FUSED_FSEG_SEED):
    """The plain PyTorch version of :func:`panel_trailing_fused` (same
    return value; ``block`` updated in place)."""
    t = block[:, col0:col0 + panel].T
    t, ipiv, inv, chosen, minpiv, mult = factor_steps_plain(t, kbrow,
                                                            record=True)
    perm_local = perm_from_inv(inv, chosen, kbrow, panel)
    trailing_update_plain(block, mult, ipiv, col0, fseg)
    return t.T[perm_local], ipiv, perm_local, minpiv, block


def _fused_cuda(block, col0: int, kbrow: int, panel: int, fseg: int):
    check_cuda_f32(block, "panel_trailing_fused")
    if fseg > FSEG_MAX_CUDA:
        raise ValueError(f"panel_trailing_fused: fseg {fseg} exceeds the "
                         f"CUDA tile routine's {FSEG_MAX_CUDA}")
    h, wtot = block.shape
    dev = block.device
    pt = torch.empty((panel, h), dtype=block.dtype, device=dev)
    mult = torch.empty((panel, h), dtype=block.dtype, device=dev)
    ipiv = torch.empty(panel, dtype=torch.int32, device=dev)
    inv = torch.empty(h, dtype=torch.int32, device=dev)
    chosen = torch.empty(h, dtype=torch.int32, device=dev)
    minpiv = torch.empty(1, dtype=block.dtype, device=dev)
    lib = _build.library("panel_fused")
    with torch.cuda.device(dev):
        grid = lib.gtt_panel_fused_grid(wtot, col0, panel)
        if grid < 1:
            raise RuntimeError(
                "panel_trailing_fused: no co-resident grid for the "
                "cooperative launch on this device")
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gtt_panel_fused(block.data_ptr(), block.stride(0), h, wtot,
                                 col0, kbrow, panel, fseg, pt.data_ptr(),
                                 mult.data_ptr(), ipiv.data_ptr(),
                                 inv.data_ptr(), chosen.data_ptr(),
                                 minpiv.data_ptr(), grid, stream)
    _build.check(lib, rc, "panel_trailing_fused")
    _build.LAUNCHES["panel_trailing_fused"] += 1
    perm_local = perm_from_inv(inv, chosen, kbrow, panel)
    return pt.T[perm_local], ipiv, perm_local, minpiv[0], block


def panel_trailing_fused(block: torch.Tensor, col0: int, kbrow: int, *,
                         panel: int, ct: int | None = None,
                         seg: int | None = None, fseg: int | None = None):
    """Factor the (h, panel) column block of ``block`` at column ``col0``
    (diagonal at row ``kbrow``) AND apply its eliminations to every column
    right of it, in one launch.

    Returns ``(p, ipiv, perm_local, min_abs_pivot, block_upd)``: the
    factored panel row-permuted (getrf layout), the pivot rows per step
    (int32), the permutation as int64 gather indices, min |pivot|, and the
    updated block in ORIGINAL row order (apply ``perm_local`` as one
    gather, then install ``p``). ``block`` is updated IN PLACE (as the JAX
    kernel aliases its operand) and ``block_upd`` is that same tensor;
    columns at or left of ``col0 + panel`` are not written.

    A CUDA tensor launches the kernel or raises; a CPU tensor runs the
    plain version."""
    if block.dim() != 2:
        raise ValueError(f"expected a 2-D block, got {tuple(block.shape)}")
    h, wtot = block.shape
    if panel > wtot or col0 < 0 or col0 + panel > wtot:
        raise ValueError(f"panel ({panel}) at column {col0} exceeds the "
                         f"block width ({wtot})")
    if kbrow < 0 or h - kbrow < panel:
        raise ValueError(f"need at least panel ({panel}) rows at or below "
                         f"kbrow={kbrow}, block has {h}")
    _, _, fseg = resolve_tiles(h, wtot, panel, ct, seg, fseg)
    col0, kbrow = int(col0), int(kbrow)
    if block.device.type == "cpu":
        return panel_trailing_fused_plain(block, col0, kbrow, panel=panel,
                                          fseg=fseg)
    if block.device.type != "cuda":
        raise ValueError(f"unsupported device {block.device}")
    return _fused_cuda(block, col0, kbrow, panel, fseg)


def reconstruct_mult_pt(p_perm: torch.Tensor, ipiv: torch.Tensor,
                        perm_local: torch.Tensor, kbrow: int, panel: int):
    """The (panel, h) multiplier rows and pivot one-hots of a factored
    panel, rebuilt EXACTLY (gathers, comparisons and selects only) from
    :func:`gauss_tpu_torch.kernels.panel.panel_factor` outputs: row r's
    stored value in column j is the step-j multiplier exactly when r was
    still live there (``inv[r] > kbrow + j``), and 0 otherwise."""
    h = p_perm.shape[0]
    dev = p_perm.device
    rows = torch.arange(h, device=dev)
    perm = perm_local.to(torch.int64)
    inv = torch.empty_like(rows).scatter_(0, perm, rows)
    p_raw = p_perm[inv]
    steps = int(kbrow) + torch.arange(panel, device=dev)
    live = inv[None, :] > steps[:, None]
    mult = torch.where(live, p_raw.T, torch.zeros((), dtype=p_perm.dtype,
                                                  device=dev))
    pt = (ipiv.to(torch.int64)[:, None] == rows[None, :]).to(p_perm.dtype)
    return mult.contiguous(), pt


def trailing_update(block: torch.Tensor, mult: torch.Tensor,
                    ipiv_or_pt: torch.Tensor, col0: int, *,
                    ct: int | None = None,
                    fseg: int | None = None) -> torch.Tensor:
    """Apply recorded eliminations — ``mult`` (panel, h) and the pivots as
    int ``ipiv`` (panel,) or the (panel, h) one-hots of
    :func:`reconstruct_mult_pt` — to every column of ``block`` right of
    ``col0 + panel``, IN PLACE; returns ``block``. The same tile math as
    the fused kernel's trailing phase.

    A CUDA tensor launches ``csrc/panel_fused.cu``'s trailing kernel (no
    launch when nothing lies right of the panel) or raises; a CPU tensor
    runs :func:`trailing_update_plain`."""
    panel = mult.shape[0]
    h, wtot = block.shape
    if col0 < 0 or col0 + panel > wtot:
        raise ValueError(f"panel ({panel}) at column {col0} exceeds the "
                         f"block width ({wtot})")
    ipiv = (ipiv_or_pt.argmax(dim=1) if ipiv_or_pt.dim() == 2
            else ipiv_or_pt)
    if mult.shape != (panel, h) or ipiv.shape != (panel,):
        raise ValueError(f"expected mult ({panel}, {h}) and {panel} pivots "
                         f"for a block of {h} rows, got mult "
                         f"{tuple(mult.shape)} and pivots "
                         f"{tuple(ipiv.shape)}")
    if mult.device != block.device or ipiv.device != block.device:
        raise ValueError(f"mult ({mult.device}) and pivots ({ipiv.device}) "
                         f"must lie on the block's device ({block.device})")
    _, _, fseg = resolve_tiles(h, wtot, panel, ct, 1, fseg)
    col0 = int(col0)
    if block.device.type == "cpu":
        return trailing_update_plain(block, mult, ipiv, col0, fseg)
    if block.device.type != "cuda":
        raise ValueError(f"unsupported device {block.device}")
    check_cuda_f32(block, "trailing_update")
    if fseg > FSEG_MAX_CUDA:
        raise ValueError(f"trailing_update: fseg {fseg} exceeds the CUDA "
                         f"tile routine's {FSEG_MAX_CUDA}")
    if col0 + panel >= wtot:
        return block
    mult = mult.to(torch.float32).contiguous()
    ipiv = ipiv.to(torch.int32).contiguous()
    lib = _build.library("panel_fused")
    with torch.cuda.device(block.device):
        stream = torch.cuda.current_stream(block.device).cuda_stream
        rc = lib.gtt_trailing_update(block.data_ptr(), block.stride(0), h,
                                     wtot, col0, panel, fseg,
                                     mult.data_ptr(), ipiv.data_ptr(),
                                     stream)
    _build.check(lib, rc, "trailing_update")
    _build.LAUNCHES["trailing_update"] += 1
    return block

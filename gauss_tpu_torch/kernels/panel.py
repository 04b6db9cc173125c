"""Panel factorization: partial-pivot LU of one (h, panel) column block.

Port of ``gauss_tpu/kernels/panel_pallas.py::panel_factor_pallas`` (the
classic per-step rank-1 form). The CUDA kernel is ``csrc/panel_factor.cu``;
:func:`panel_factor_plain` is the same step loop in plain PyTorch, in the
same order, and is what a CPU tensor runs.

The scheme (kept from the JAX package): the panel is held TRANSPOSED,
(panel, h), so column j is one contiguous row; rows are never swapped — a
``done`` mask retires rows above the diagonal block (``r < kb``) and chosen
pivots, and the permutation is emitted as an inverse-position vector
(``inv``: row -> new position, pivots at ``kb + j`` in choice order,
unchosen rows after them in original order) that the wrapper turns into
gather indices. Pivot choice is ``argmax |column|`` over live rows with
``jnp.argmax``'s order: a NaN beats every number (the first NaN wins),
ties go to the lowest ORIGINAL row index. A NaN pivot counts as 0 in
``min_abs_pivot``.

Deviation from the JAX package: the two-level deferred form (``defer``)
and the ``seg`` segmentation exist there for VMEM and MXU limits; the port
runs the classic single-segment form only (``seg`` is accepted for API
parity and ignored). On finite inputs segmentation never changes a value.
"""

from __future__ import annotations

import torch

from gauss_tpu_torch.kernels import _build

#: Sub-panel segment width seed of the JAX package's classic form (its
#: tuner seed); the port keeps the name for the fused tile resolution.
PANEL_SEG_SEED = 64
DEFAULT_SEG = PANEL_SEG_SEED


def argmax_nan_first(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` order on a 1-D tensor without a host sync: the first
    NaN if any, else the first maximal value."""
    nan = torch.isnan(x)
    best = torch.argmax(torch.where(nan, torch.full_like(x, float("-inf")),
                                    x))
    return torch.where(nan.any(), torch.argmax(nan.to(torch.int32)), best)


def factor_steps_plain(t: torch.Tensor, kb: int, record: bool = False):
    """The pivot-step loop on a transposed (panel, h) panel ``t`` (not
    modified). Returns ``(t_factored, ipiv, inv, chosen, min_abs_pivot,
    mult)``; ``mult`` is the (panel, h) record of each step's multiplier
    row (0 on done rows) when ``record`` else None."""
    panel, h = t.shape
    dev, dt = t.device, t.dtype
    rows = torch.arange(h, device=dev)
    cols = torch.arange(panel, device=dev)
    inv = rows.to(torch.int32)
    chosen = torch.zeros(h, dtype=torch.int32, device=dev)
    ipiv = torch.zeros(panel, dtype=torch.int32, device=dev)
    done = rows < kb
    zero = torch.zeros((), dtype=dt, device=dev)
    ninf = torch.full((), float("-inf"), dtype=dt, device=dev)
    minpiv = torch.full((), float("inf"), dtype=dt, device=dev)
    mult_rec = (torch.zeros((panel, h), dtype=dt, device=dev) if record
                else None)
    for j in range(panel):
        col = t[j].clone()
        p = argmax_nan_first(torch.where(done, ninf, col.abs())).view(1)
        ipiv[j:j + 1] = p.to(torch.int32)
        inv.index_fill_(0, p, kb + j)
        chosen.index_fill_(0, p, 1)
        u = t.index_select(1, p)[:, 0]  # the pivot row, (panel,)
        piv = u[j]
        apiv = piv.abs()
        minpiv = torch.minimum(minpiv,
                               torch.where(torch.isnan(apiv), zero, apiv))
        done = done.index_fill(0, p, True)
        q = col / piv
        mult = torch.where(done, zero, q)
        if record:
            mult_rec[j] = mult
        row_j_new = torch.where(done, col, q)
        upd = torch.where(cols > j, u, zero)
        t = torch.where((cols == j)[:, None], row_j_new[None, :],
                        t - upd[:, None] * mult[None, :])
    return t, ipiv, inv, chosen, minpiv, mult_rec


def perm_from_inv(inv: torch.Tensor, chosen: torch.Tensor, kb: int,
                  panel: int) -> torch.Tensor:
    """Gather indices (int64) from the inverse-position vector: unchosen
    rows at or below ``kb`` keep their original relative order after the
    ``panel`` chosen pivots."""
    h = inv.shape[0]
    rows = torch.arange(h, device=inv.device)
    unch = (rows >= kb) & (chosen == 0)
    rank = torch.cumsum(unch.to(torch.int64), 0)
    full = torch.where(unch, kb + panel - 1 + rank, inv.to(torch.int64))
    return torch.empty_like(rows).scatter_(0, full, rows)


def panel_factor_plain(p: torch.Tensor, kb: int = 0):
    """The plain PyTorch version of :func:`panel_factor`."""
    h, panel = p.shape
    t, ipiv, inv, chosen, minpiv, _ = factor_steps_plain(p.T, kb)
    perm_local = perm_from_inv(inv, chosen, kb, panel)
    return t.T[perm_local], ipiv, perm_local, minpiv


def check_cuda_f32(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes float32, got "
                        f"{x.dtype}")
    if x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"{what}: expected a 2-D row-major tensor "
                         f"(unit column stride), got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")


def _panel_factor_cuda(p: torch.Tensor, kb: int):
    if p.stride(1) != 1:
        p = p.contiguous()
    check_cuda_f32(p, "panel_factor")
    h, panel = p.shape
    dev = p.device
    pt = torch.empty((panel, h), dtype=p.dtype, device=dev)
    ipiv = torch.empty(panel, dtype=torch.int32, device=dev)
    inv = torch.empty(h, dtype=torch.int32, device=dev)
    chosen = torch.empty(h, dtype=torch.int32, device=dev)
    minpiv = torch.empty(1, dtype=p.dtype, device=dev)
    lib = _build.library("panel_factor")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gtt_panel_factor(p.data_ptr(), p.stride(0), h, panel,
                                  int(kb), pt.data_ptr(), ipiv.data_ptr(),
                                  inv.data_ptr(), chosen.data_ptr(),
                                  minpiv.data_ptr(), stream)
    _build.check(lib, rc, "panel_factor")
    _build.LAUNCHES["panel_factor"] += 1
    perm_local = perm_from_inv(inv, chosen, kb, panel)
    return pt.T[perm_local], ipiv, perm_local, minpiv[0]


def panel_factor(p: torch.Tensor, kb: int = 0, seg: int | None = None):
    """Factor one (h, panel) column block whose diagonal sits at row ``kb``.

    Returns ``(p_perm, ipiv, perm_local, min_abs_pivot)``: the factored
    panel already row-permuted (getrf layout: multipliers below the
    diagonal, U on and above it), the pivot rows per step (int32, indices
    into ``p``), the permutation as int64 gather indices, and min |pivot|
    (0 for singular input). ``p`` is not modified.

    A CUDA tensor launches the kernel (``csrc/panel_factor.cu``) or
    raises; a CPU tensor runs :func:`panel_factor_plain`. ``seg`` is
    accepted for parity with the JAX package and ignored."""
    del seg
    if p.dim() != 2 or p.shape[0] - kb < p.shape[1] or kb < 0:
        raise ValueError(f"panel_factor expects (h, panel) with at least "
                         f"panel rows at or below kb={kb}, got "
                         f"{tuple(p.shape)}")
    if p.device.type == "cpu":
        return panel_factor_plain(p, kb)
    if p.device.type != "cuda":
        raise ValueError(f"panel_factor: unsupported device {p.device}")
    return _panel_factor_cuda(p, kb)

"""Row elimination: one pivot step per launch, or k steps per group.

Port of ``gauss_tpu/kernels/rowelim_pallas.py``, the reference's
row-reduction inner loop (pivot-row broadcast + per-row SAXPY
elimination). Two kernels, both in ``csrc/rowelim.cu``, each beside its
plain PyTorch version (what a CPU tensor runs):

- :func:`eliminate_step` — one pivot step on the swapped augmented
  matrix: the pivot row scaled by ``1/piv`` (a reciprocal, then a
  multiply) with its diagonal pinned to exactly 1, every row minus
  ``f·prow`` where ``f`` is the pivot column below the pivot and 0
  elsewhere, and the pivot row replaced by the scaled row. Bit for bit
  equal to :func:`eliminate_step_plain`.
- :func:`rankk_update` — ``m − f @ u`` in true float32, the product
  accumulated in full and subtracted once (on the f32 routine of
  ``csrc/sgemm_common.cuh``, which the tiled matmul's "highest" shares).

And the two solve drivers:

- :func:`gauss_solve_rowelim` — n kernel steps; the pivot search (an
  argmax with ``jnp.argmax``'s order) and the two-row swap stay on the
  device between launches, so a solve makes no host round trip until
  the back-substitution's result is fetched.
- :func:`gauss_solve_rowelim_batched` — k steps per group: the live
  rows of the group's k columns, ``m[kb:, kb:kb + k]``, are factored by
  the panel kernel (:func:`.panel.panel_factor`), the live rows are
  permuted once, and the k eliminations land as one rank-k update; the block rows are rewritten in row-elimination form
  (unit diagonal, scaled U) and the solution comes from a blockwise
  back-substitution through the inverted diagonal blocks.

Padding follows the JAX package: ``npad`` is a multiple of ``bm`` (and of
``k``), the pad rows carry an identity diagonal, the right-hand side sits
in column ``npad``, and the width is a multiple of ``bn``. The CUDA
kernels bounds-check and need no tile multiples; ``bm``/``bn`` set the
padding only. The JAX back-substitution's two trace forms (unrolled below
``ROWELIM_UNROLL_MAX_NB`` blocks, ``lax.scan`` above) are one loop here.
On the CPU the batched driver's panel runs the panel kernel's plain
version, where the JAX package runs its stock swap panel: pivots agree
wherever the maximum is unique, and values to float32 rounding. The JAX
driver factors the whole (npad, k) strip with the rows above ``kb``
marked done, because ``fori_loop`` needs static shapes; the port factors
only the live rows, which gives every value the driver reads bit for bit
(a done row's entries, NaN included, never reach them).
"""

from __future__ import annotations

import operator

import torch

from gauss_tpu_torch.core.blocked import panel_fits_vmem, unit_lower_inv, upper_inv
from gauss_tpu_torch.core.gauss import back_substitute
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.kernels.panel import (argmax_nan_first, check_cuda_f32,
                                           panel_factor)
from gauss_tpu_torch.utils.device import as_tensor, resolve_device

#: The JAX package's elimination tile seed (``tune/space``), which sets the
#: drivers' padding: rows to a multiple of DEFAULT_BM, width of DEFAULT_BN.
ROWELIM_TILE_SEED = (256, 256)
DEFAULT_BM, DEFAULT_BN = ROWELIM_TILE_SEED
#: Rows and threads (columns) per block of the step kernel, as compiled
#: into ``csrc/rowelim.cu``. The rank-k kernel's grid is
#: :func:`.matmul.gemm_geometry`'s in "highest".
CUDA_ELIM_TILE = (8, 256)


def eliminate_step_plain(m: torch.Tensor, i: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`eliminate_step`, in the kernel's
    order of rounded operations."""
    rows = torch.arange(m.shape[0], device=m.device)
    cols = torch.arange(m.shape[1], device=m.device)
    prow = m[i]
    inv = torch.reciprocal(prow[i])
    ps = torch.where(cols == i, torch.ones((), dtype=m.dtype,
                                           device=m.device), prow * inv)
    f = torch.where(rows > i, m[:, i], torch.zeros((), dtype=m.dtype,
                                                   device=m.device))
    new = m - f[:, None] * ps[None, :]
    return torch.where((rows == i)[:, None], ps[None, :], new)


def _on_card(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x`` with a unit column stride, checked for the CUDA kernels."""
    if x.stride(1) != 1:
        x = x.contiguous()
    check_cuda_f32(x, what)
    return x


def eliminate_step(m: torch.Tensor, i: int) -> torch.Tensor:
    """One elimination step at pivot ``i`` on the already pivot-swapped
    augmented matrix ``m`` (R, W); returns a new matrix (``m`` is not
    modified). ``i`` is a Python int (the drivers' loop counter), so a
    launch needs no host sync.

    A CUDA tensor launches ``gtt_eliminate_step`` or raises; a CPU tensor
    runs :func:`eliminate_step_plain`."""
    i = operator.index(i)
    if m.dim() != 2 or not 0 <= i < min(m.shape):
        raise ValueError(f"eliminate_step: pivot {i} outside the matrix "
                         f"{tuple(m.shape)}")
    if m.device.type == "cpu":
        return eliminate_step_plain(m, i)
    if m.device.type != "cuda":
        raise ValueError(f"eliminate_step: unsupported device {m.device}")
    m = _on_card(m, "eliminate_step")
    rows, cols = m.shape
    out = torch.empty((rows, cols), dtype=m.dtype, device=m.device)
    lib = _build.library("rowelim")
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = lib.gtt_eliminate_step(m.data_ptr(), m.stride(0),
                                    out.data_ptr(), out.stride(0), rows,
                                    cols, i, stream)
    _build.check(lib, rc, "eliminate_step")
    _build.LAUNCHES["eliminate_step"] += 1
    return out


def rankk_update_plain(m: torch.Tensor, f: torch.Tensor,
                       u: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`rankk_update`."""
    return m - torch.matmul(f, u)


def rankk_update(m: torch.Tensor, f: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """``m - f @ u`` in true float32: m (R, C), f (R, k), u (k, C); returns
    a new matrix. A CUDA tensor launches ``gtt_rankk_update`` or raises;
    CPU tensors run :func:`rankk_update_plain`."""
    if (m.dim() != 2 or f.dim() != 2 or u.dim() != 2
            or f.shape[0] != m.shape[0] or u.shape[1] != m.shape[1]
            or f.shape[1] != u.shape[0]):
        raise ValueError(f"rankk_update: shapes m {tuple(m.shape)}, f "
                         f"{tuple(f.shape)}, u {tuple(u.shape)} do not "
                         f"form m - f @ u")
    devs = {m.device, f.device, u.device}
    if devs == {torch.device("cpu")}:
        return rankk_update_plain(m, f, u)
    if len(devs) != 1 or m.device.type != "cuda":
        raise ValueError(f"rankk_update: operands on {sorted(map(str, devs))}"
                         f"; the kernel takes tensors on one CUDA device")
    m, f, u = (_on_card(x, "rankk_update") for x in (m, f, u))
    R, C = m.shape
    k = f.shape[1]
    if R == 0 or C == 0 or k == 0:
        return m.clone()
    out = torch.empty((R, C), dtype=m.dtype, device=m.device)
    lib = _build.library("rowelim")
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = lib.gtt_rankk_update(m.data_ptr(), m.stride(0), f.data_ptr(),
                                  f.stride(0), u.data_ptr(), u.stride(0),
                                  out.data_ptr(), out.stride(0), R, C, k,
                                  stream)
    _build.check(lib, rc, "rankk_update")
    _build.LAUNCHES["rankk_update"] += 1
    return out


def _augmented(a: torch.Tensor, b: torch.Tensor, npad: int,
               wpad: int) -> torch.Tensor:
    """[A | b] in an (npad, wpad) zero matrix: identity on the pad
    diagonal, the right-hand side in column ``npad``."""
    n = a.shape[0]
    m = torch.zeros((npad, wpad), dtype=a.dtype, device=a.device)
    m[:n, :n] = a
    pad = torch.arange(n, npad, device=a.device)
    m[pad, pad] = 1.0
    m[:n, npad] = b
    return m


def _staged(a, b, device):
    dev = resolve_device(device)
    a = as_tensor(a, dev)
    b = as_tensor(b, dev)
    n = a.shape[0]
    if a.shape != (n, n) or b.shape != (n,):
        raise ValueError(f"expected a square matrix and a vector, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return a, b, n


def gauss_solve_rowelim(a, b, bm: int = DEFAULT_BM, bn: int = DEFAULT_BN,
                        device=None) -> torch.Tensor:
    """Full solve with the per-step elimination kernel (partial pivoting):
    per step an on-device argmax of |column| over rows ``>= i`` and a
    two-row swap, then :func:`eliminate_step`; back-substitution from
    :func:`gauss_tpu_torch.core.gauss.back_substitute`. Returns the float32
    solution on ``device`` (default ``cuda``)."""
    a, b, n = _staged(a, b, device)
    dev = a.device
    npad = -(-n // bm) * bm
    wpad = -(-(npad + 1) // bn) * bn
    m = _augmented(a, b, npad, wpad)
    ridx = torch.arange(npad, device=dev)
    ninf = torch.full((), float("-inf"), dtype=m.dtype, device=dev)
    for i in range(npad):
        p = argmax_nan_first(torch.where(ridx >= i, m[:, i].abs(), ninf))
        swap = torch.stack([ridx[i], p])  # device indices: no host sync
        m[swap] = m[swap.flip(0)]
        m = eliminate_step(m, i)
    return back_substitute(m[:, :npad], m[:, npad])[:n]


def auto_rowelim_k(n: int) -> int:
    """Pivot steps per group from n: 256 while the JAX package's panel
    kernel would hold the (n, 256) strip in VMEM, then 128, then 64, and
    256 when none fits (the JAX package's rule, kept so that both packages
    factor the same groups)."""
    for k in (256, 128, 64):
        if panel_fits_vmem(n, k):
            return k
    return 256


def gauss_solve_rowelim_batched(a, b, k: int | None = None,
                                bm: int = DEFAULT_BM, bn: int = DEFAULT_BN,
                                device=None) -> torch.Tensor:
    """Full solve, k pivot steps per group (``k=None``:
    :func:`auto_rowelim_k`); the same row semantics as
    :func:`gauss_solve_rowelim` with n/k passes over the matrix instead of
    n. ``k`` and ``bm`` must nest (one a multiple of the other). Returns
    the float32 solution on ``device`` (default ``cuda``)."""
    a, b, n = _staged(a, b, device)
    dev, dt = a.device, a.dtype
    if k is None:
        k = auto_rowelim_k(n)
    blk = max(bm, k)
    if blk % k or blk % bm:
        raise ValueError(
            f"k={k} and bm={bm} must nest (one a multiple of the other) so "
            f"the padded size is a multiple of both")
    npad = -(-n // blk) * blk
    wpad = -(-(npad + 1) // bn) * bn
    m = _augmented(a, b, npad, wpad)
    cols = torch.arange(wpad, device=dev)
    jcol = torch.arange(k, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    eye_k = torch.eye(k, dtype=dt, device=dev)
    upper = jcol[:, None] < jcol[None, :]
    uinvs = []
    for kb in range(0, npad, k):
        # Only the live rows m[kb:]: the rows above kb are done, and
        # nothing below reads what a panel factor would leave in them.
        p, _, perm_local, _ = panel_factor(m[kb:, kb:kb + k])
        m[kb:] = m[kb:][perm_local]
        dblk = p[:k]
        linv = unit_lower_inv(torch.tril(dblk, -1) + eye_k)
        d = torch.diagonal(dblk)  # the U11 diagonal: the pivots
        # u12 = L11^-1 @ (the post-swap block rows): its panel columns are
        # U11, its trailing columns the updated block-row tail. The block
        # rows are rewritten from u12 below, so the rank-k update needs
        # multipliers only for the rows BELOW the block.
        u12 = torch.matmul(linv, m[kb:kb + k])
        f = torch.zeros((npad, k), dtype=dt, device=dev)
        f[kb + k:] = p[k:]
        right = (cols >= kb + k)[None, :]
        m = rankk_update(m, f, torch.where(right, u12, zero))
        # The block rows in row-elimination form: unit diagonal, scaled U11
        # above it, scaled U12 tail; the panel columns below them zero.
        inv_d = torch.reciprocal(d)[:, None]
        new_block = torch.where(right, u12 * inv_d, zero)
        pan = torch.where(upper, u12[:, kb:kb + k] * inv_d, zero) + eye_k
        new_block[:, kb:kb + k] = pan
        m[kb:kb + k] = new_block
        m[kb + k:, kb:kb + k] = 0.0
        uinvs.append(upper_inv(pan))
    # Blockwise back-substitution, x_i = Uinv_ii (y_i - U_{i,>i} x_{>i}):
    # the full-width row product meets zeros at every unsolved block, so no
    # masking is needed.
    x = torch.zeros(npad, dtype=dt, device=dev)
    for g in range(len(uinvs) - 1, -1, -1):
        blk_rows = m[g * k:(g + 1) * k]
        r = blk_rows[:, npad] - torch.matmul(blk_rows[:, :npad], x)
        x[g * k:(g + 1) * k] = torch.matmul(uinvs[g], r)
    return x[:n]

"""Sparse matrix-vector products over the CSR staging forms.

Port of ``gauss_tpu/sparse/spmv.py``. The padded-row (ELL) product is a
hand-written CUDA kernel (``kernels/csrc/spmv.cu``, replacing the TPU
kernel ``spmv_ell_pallas``) beside its plain PyTorch version:

- :func:`spmv_ell_kernel` — the wrapper: CUDA tensors only, launches
  ``gtt_spmv_ell_f32`` / ``gtt_spmv_ell_f64``, counts its launch, raises on
  anything it does not take. 1-D ``x`` only, like the TPU kernel.
- :func:`spmv_ell_plain` — the same sum in the kernel's order: one
  running sum per row, slot 0 to slot k-1, each product and each sum
  rounded on its own. The kernel equals it bit for bit.
- :func:`spmv_ell` — what the solvers call: for a 1-D ``x`` the kernel on
  CUDA tensors and the plain version on CPU tensors; for an ``(n, m)``
  multivector the stock gather + einsum on either device (the kernel is
  1-D only, as in the JAX package).
- :func:`spmv_coo` — ``index_add_`` over row-sorted COO triplets (the JAX
  package's ``segment_sum`` form): the fallback when a few rows are far
  denser than the rest and padding every row would waste memory.
- :func:`spmv` — host convenience over a ``CsrMatrix``.

Routing, against the JAX package's ``spmv`` (which takes its TPU kernel
only on a real TPU at ``n >= PALLAS_MIN_N = 4096``, and whose traced Krylov
loops call the XLA form): a deliberate difference. That gate answered the
TPU kernel's padding and launch costs and a ``lax.while_loop`` body's
limits; the eager port has neither, so on the card a 1-D product is the
kernel at every n, in :func:`spmv` and in the Krylov solvers alike.
``impl="kernel"`` is the port's name for the JAX package's
``impl="pallas"``: the kernel or an error, never another form.
"""

from __future__ import annotations

import numpy as np
import torch

from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.utils.device import resolve_device

__all__ = ["spmv", "spmv_coo", "spmv_ell", "spmv_ell_kernel",
           "spmv_ell_plain"]

_ENTRY = {torch.float32: "gtt_spmv_ell_f32", torch.float64: "gtt_spmv_ell_f64"}


def _check_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
               what: str) -> None:
    if cols.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(f"{what}: cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} must be one (n, k) shape")
    if x.dim() != 1:
        raise ValueError(f"{what}: x must be 1-D, got {tuple(x.shape)}")
    if vals.dtype not in _ENTRY or x.dtype != vals.dtype:
        raise ValueError(f"{what}: vals {vals.dtype} and x {x.dtype} must "
                         f"both be float32 or both float64")


def spmv_ell_plain(cols: torch.Tensor, vals: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`spmv_ell_kernel`: ``y[r] =
    sum_j vals[r, j] * x[cols[r, j]]``, slot by slot in the kernel's
    order (see the module docstring)."""
    _check_ell(cols, vals, x, "spmv_ell_plain")
    acc = torch.zeros(vals.shape[0], dtype=vals.dtype, device=vals.device)
    for j in range(vals.shape[1]):
        acc = acc + vals[:, j] * x[cols[:, j]]
    return acc


def spmv_ell_kernel(cols: torch.Tensor, vals: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` by the CUDA kernel: ``cols`` (n, k) int32 and ``vals``
    (n, k) float32 or float64, contiguous, ``x`` 1-D of ``vals``' type,
    all on one CUDA device; every column index must lie in ``[0, len(x))``
    (``CsrMatrix`` guarantees it; the kernel does not check). Launches on
    the current stream and raises on anything else: no other form stands
    in."""
    _check_ell(cols, vals, x, "spmv_ell_kernel")
    devs = {cols.device, vals.device, x.device}
    if len(devs) != 1 or vals.device.type != "cuda":
        raise ValueError(f"spmv_ell_kernel: operands on "
                         f"{sorted(map(str, devs))}; the kernel takes "
                         f"tensors on one CUDA device")
    if cols.dtype != torch.int32:
        raise ValueError(f"spmv_ell_kernel: cols must be int32, got "
                         f"{cols.dtype}")
    if not (cols.is_contiguous() and vals.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("spmv_ell_kernel: cols, vals and x must be "
                         "contiguous (row-major (n, k))")
    n, k = vals.shape
    if n == 0 or k == 0:
        return torch.zeros(n, dtype=vals.dtype, device=vals.device)
    y = torch.empty(n, dtype=vals.dtype, device=vals.device)
    lib = _build.library("spmv")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = getattr(lib, _ENTRY[vals.dtype])(
            cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(), n,
            k, stream)
    _build.check(lib, rc, "spmv_ell_kernel")
    _build.LAUNCHES["spmv_ell"] += 1
    return y


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` from padded-row staging ``cols``/``vals`` of shape
    ``(n, k)`` (padding: column 0, value 0). ``x`` may be ``(n,)`` — the
    kernel on CUDA tensors, its plain version on CPU tensors — or an
    ``(n, m)`` multivector (gather + einsum)."""
    if x.dim() == 1:
        if vals.device.type == "cpu":
            return spmv_ell_plain(cols, vals, x)
        return spmv_ell_kernel(cols, vals, x)
    return torch.einsum("rk,rkm->rm", vals, x[cols])


def spmv_coo(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, *, n: int) -> torch.Tensor:
    """``y = A @ x`` from row-sorted COO triplets via ``index_add_``; ``n``
    is the number of rows of ``y``. ``x`` may be ``(n,)`` or ``(n, m)``."""
    contrib = vals * x[cols] if x.dim() == 1 else vals[:, None] * x[cols]
    y = torch.zeros((n,) + tuple(x.shape[1:]), dtype=contrib.dtype,
                    device=contrib.device)
    return y.index_add_(0, rows.to(torch.int64), contrib)


def spmv(a, x, *, impl: str = "auto", device=None) -> np.ndarray:
    """Host convenience: ``A @ x`` for a ``CsrMatrix`` and a numpy ``x``
    ((n,) or (n, m)), staged in float64 on ``device`` (default ``cuda``)
    and returned as numpy. ``impl``: ``"auto"`` (the ELL form:
    :func:`spmv_ell`), ``"kernel"`` (the CUDA kernel or an error: needs a
    CUDA device and a 1-D ``x``) or ``"coo"`` (:func:`spmv_coo`)."""
    if impl not in ("auto", "kernel", "coo"):
        raise ValueError(f"unknown spmv impl {impl!r}; options: auto, "
                         f"kernel, coo")
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)
    if impl == "coo":
        rows, cols, vals = (torch.as_tensor(v, device=dev) for v in a.coo())
        return spmv_coo(rows, cols.to(torch.int64), vals, xt,
                        n=a.n).cpu().numpy()
    cols, vals = (torch.as_tensor(v, device=dev) for v in a.ell())
    fn = spmv_ell_kernel if impl == "kernel" else spmv_ell
    return fn(cols, vals, xt).cpu().numpy()

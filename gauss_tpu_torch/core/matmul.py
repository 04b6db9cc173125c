"""Dense matrix multiplication core and the precision names.

The JAX package names three GEMM precisions for float32 operands. The port
keeps the names and their meaning, not torch's words for them:

- ``"highest"`` — true float32 (TF32 pinned off by
  :func:`gauss_tpu_torch.utils.device.pin_true_f32`); the default.
- ``"high"`` — the explicit three-pass bf16 split (:func:`dot_bf16x3`),
  the meaning it has on a TPU. It is NOT torch's
  ``set_float32_matmul_precision("high")``, which is TF32.
- ``"default"`` — one bf16 pass with float32 accumulation.
- ``"bf16x3"`` — the split by its explicit name (only where
  ``allow_split=True``, as in the JAX package).

Large products go to ``torch.matmul`` (cuBLAS on the card), as the JAX
package left them to XLA.
"""

from __future__ import annotations

import torch

PRECISIONS = {
    "highest": "f32",
    "high": "bf16x3",
    "default": "bf16",
}

#: The explicit split-GEMM precision name (f32 operands split into bf16
#: hi/lo pairs, three bf16 products with f32 accumulation).
BF16X3 = "bf16x3"


def resolve_precision(name: str, allow_split: bool = False) -> str:
    """The precision mode for a name: ``"f32"``, ``"bf16x3"`` or
    ``"bf16"``. ``allow_split=True`` additionally admits :data:`BF16X3`
    by its explicit name."""
    if name == BF16X3:
        if allow_split:
            return BF16X3
        raise ValueError(
            f"precision {BF16X3!r} (the explicit split-GEMM) is only "
            f"supported by the blocked-LU trailing updates and matmul; "
            f"options here: {tuple(PRECISIONS)}")
    try:
        return PRECISIONS[name]
    except KeyError:
        raise ValueError(f"unknown precision {name!r}; "
                         f"options: {tuple(PRECISIONS) + (BF16X3,)}") from None


def split_bf16(x: torch.Tensor):
    """Two-way split ``x ≈ hi + lo`` with both parts bfloat16: ``hi`` keeps
    the leading 8 mantissa bits, ``lo`` the next 8 (the rounding residual
    re-rounded to bf16)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(x.dtype)).to(torch.bfloat16)
    return hi, lo


def _bf16_pass(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One bf16 x bf16 product accumulated in float32. Products of two
    8-bit-mantissa operands are exact in f32, so upcasting the operands and
    multiplying in true f32 is exactly the bf16-in/f32-accumulate pass."""
    return torch.matmul(u.to(torch.float32), v.to(torch.float32))


def dot_bf16x3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` in float32 as THREE bf16 products: with ``x = xh + xl``
    and ``y = yh + yl``, ``xh·yh + (xh·yl + xl·yh)`` (the dropped ``xl·yl``
    term is ~2^-32 relative)."""
    xh, xl = split_bf16(x)
    yh, yl = split_bf16(y)
    return _bf16_pass(xh, yh) + (_bf16_pass(xh, yl) + _bf16_pass(xl, yh))


def gdot(x: torch.Tensor, y: torch.Tensor, mode: str) -> torch.Tensor:
    """One GEMM under a resolved precision mode."""
    if mode == BF16X3:
        return dot_bf16x3(x, y)
    if mode == "bf16":
        return _bf16_pass(x.to(torch.bfloat16), y.to(torch.bfloat16))
    return torch.matmul(x, y)


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: str = "high") -> torch.Tensor:
    """C = A @ B for (m, k) x (k, n) tensors under a precision name."""
    return gdot(a, b, resolve_precision(precision, allow_split=True))

"""Tiled and row-stripe matmul: ``C = A @ B`` under the JAX package's
precision names.

Port of ``gauss_tpu/kernels/matmul_pallas.py``: :func:`matmul_tiled` is
``matmul_pallas`` (a 2-D grid of output tiles, each walking K) and
:func:`matmul_stripe` is ``matmul_pallas_stripe`` (a 1-D grid of
full-width row stripes, the reference's CUDA Version-1 layout). Both
kernels live in ``csrc/matmul.cu`` and share the tile routine of
``csrc/gemm_common.cuh``; :func:`matmul_plain` is their plain PyTorch
version, which a CPU tensor runs.

Precision (the TPU kernel's ``_kernel_precision`` rules): ``"high"`` on
float32 is the in-kernel bf16x3 split (hi·lo + lo·hi + hi·hi, f32 sums),
``"highest"`` true float32, ``"default"`` one bf16 pass; on other types
every name is a full-precision product. The CUDA kernels take float32
only.

Not ported as behaviour, because it answers the TPU's VMEM: the tile
clamp (``_mm_blocks``), the stripe's VMEM guard (``_stripe_blocks``; the
CUDA stripe keeps one column tile's sums in registers at a time, so it
has no width limit), the tuned-store lookup and the VMEM telemetry. The
CUDA tiles are compile-time constants; ``bm``/``bn``/``bk`` are accepted
for parity and ignored. Any ``m, n, k`` works: the kernels bounds-check
the ragged edges instead of padding.
"""

from __future__ import annotations

import torch

from gauss_tpu_torch.core.matmul import _bf16_pass, resolve_precision, split_bf16
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.kernels.panel import check_cuda_f32

#: The JAX package's default matmul tiles (its tuner seed, ``tune/space``),
#: kept for reference; the CUDA kernels' own tiles are below.
MM_TILE_SEED = (512, 512, 1024)
#: Output tile of the tiled kernel and (rows, column tile) of the stripe
#: kernel, as compiled into ``csrc/matmul.cu``.
CUDA_TILE = (128, 128)
CUDA_STRIPE_TILE = (32, 128)

#: Operand modes of ``csrc/gemm_common.cuh`` (GTT_MODE_*).
_MODES = {"f32": 0, "bf16x3": 1, "bf16": 2}


def kernel_mode(precision: str, dtype: torch.dtype) -> str:
    """``"f32"``, ``"bf16x3"`` or ``"bf16"`` for a precision name and an
    operand type. On float32 the names map as
    :func:`gauss_tpu_torch.core.matmul.resolve_precision` maps them
    (``"high"`` is the bf16x3 split); on any other type every name is a
    full-precision product in that type, as the JAX kernel's dots are on
    the CPU."""
    mode = resolve_precision(precision)
    return mode if dtype == torch.float32 else "f32"


def _check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 precision: str = "high") -> torch.Tensor:
    """The plain PyTorch version of :func:`matmul_tiled` and
    :func:`matmul_stripe`: the same operand splits, the three bf16
    products summed in the TPU kernel's order, each accumulated in
    float32."""
    _check_shapes(a, b)
    b = b.to(a.dtype)
    mode = kernel_mode(precision, a.dtype)
    if mode == "bf16x3":
        ah, al = split_bf16(a)
        bh, bl = split_bf16(b)
        return (_bf16_pass(ah, bl) + _bf16_pass(al, bh)) + _bf16_pass(ah, bh)
    if mode == "bf16":
        return _bf16_pass(a.to(torch.bfloat16), b.to(torch.bfloat16))
    return torch.matmul(a, b)


def _launch(fn: str, a: torch.Tensor, b: torch.Tensor,
            precision: str) -> torch.Tensor:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{fn}: operands on {a.device} and {b.device}; "
                         f"the kernel takes two tensors on one CUDA device")
    check_cuda_f32(a, fn)
    check_cuda_f32(b, fn)
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    if k == 0:
        return c.zero_()
    a = a if a.stride(1) == 1 else a.contiguous()
    b = b if b.stride(1) == 1 else b.contiguous()
    lib = _build.library("matmul")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = getattr(lib, f"gtt_{fn}")(
            a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
            c.data_ptr(), c.stride(0), m, n, k,
            _MODES[kernel_mode(precision, a.dtype)], stream)
    _build.check(lib, rc, fn)
    _build.LAUNCHES[fn] += 1
    return c


def _dispatch(fn: str, a, b, precision: str) -> torch.Tensor:
    _check_shapes(a, b)
    kernel_mode(precision, a.dtype)  # an unknown name raises on any device
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, precision)
    return _launch(fn, a, b, precision)


def matmul_tiled(a: torch.Tensor, b: torch.Tensor, precision: str = "high",
                 *, bm: int | None = None, bn: int | None = None,
                 bk: int | None = None) -> torch.Tensor:
    """``a @ b`` on a 2-D grid of (128, 128) output tiles, each walking K
    (kernel ``gtt_matmul_tiled``). A CUDA tensor launches the kernel or
    raises (TypeError for a type other than float32); CPU tensors run
    :func:`matmul_plain`. ``bm``/``bn``/``bk`` are accepted for parity
    with the JAX package and ignored."""
    del bm, bn, bk
    return _dispatch("matmul_tiled", a, b, precision)


def matmul_stripe(a: torch.Tensor, b: torch.Tensor, precision: str = "high",
                  *, bm: int | None = None,
                  bk: int | None = None) -> torch.Tensor:
    """``a @ b`` on a 1-D grid of full-width (32, N) row stripes, each
    block walking its 128-wide column tiles and K (kernel
    ``gtt_matmul_stripe``). Same device contract as :func:`matmul_tiled`;
    ``bm``/``bk`` are accepted for parity and ignored."""
    del bm, bk
    return _dispatch("matmul_stripe", a, b, precision)

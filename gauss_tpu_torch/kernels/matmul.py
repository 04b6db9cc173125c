"""Tiled and row-stripe matmul: ``C = A @ B`` under the JAX package's
precision names.

Port of ``gauss_tpu/kernels/matmul_pallas.py``: :func:`matmul_tiled` is
``matmul_pallas`` (a 2-D grid of output tiles, each walking K, on the
tile routine of ``csrc/gemm_common.cuh``) and :func:`matmul_stripe` is
``matmul_pallas_stripe`` (full-width row stripes, the reference's CUDA
Version-1 layout: on the H100 each stripe belongs to one thread-block
cluster whose blocks split its column tiles, on the routine of
``csrc/stripe_common.cuh``; :func:`stripe_geometry` is its launch
arithmetic). Both kernels live in ``csrc/matmul.cu``;
:func:`matmul_plain` is their plain PyTorch version, which a CPU tensor
runs.

Precision (the TPU kernel's ``_kernel_precision`` rules): ``"high"`` on
float32 is the in-kernel bf16x3 split (hi·lo + lo·hi + hi·hi, f32 sums),
``"highest"`` true float32, ``"default"`` one bf16 pass; on other types
every name is a full-precision product. The CUDA kernels take float32
only.

Not ported as behaviour, because it answers the TPU's VMEM: the tile
clamp (``_mm_blocks``), the stripe's VMEM guard (``_stripe_blocks``; a
CUDA block keeps one column tile's sums in registers at a time, so the
stripe has no width limit), the tuned-store lookup and the VMEM
telemetry. The CUDA tiles are compile-time constants; ``bm``/``bn``/``bk``
are accepted for parity and ignored. Any ``m, n, k`` works: the kernels bounds-check
the ragged edges instead of padding.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gauss_tpu_torch.core.matmul import _bf16_pass, resolve_precision, split_bf16
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.kernels.panel import check_cuda_f32

#: The JAX package's default matmul tiles (its tuner seed, ``tune/space``),
#: kept for reference; the CUDA kernels' own tiles are below.
MM_TILE_SEED = (512, 512, 1024)
#: Output tile of the tiled kernel, as compiled into ``csrc/matmul.cu``.
CUDA_TILE = (128, 128)
#: The stripe kernel's constants, as compiled into
#: ``csrc/stripe_common.cuh``: (rows of a stripe, columns of one tile),
#: blocks per cluster, K depth of a ring stage, stages, threads per block
#: and the row padding of the staged A and B tiles (in floats).
CUDA_STRIPE_TILE = (64, 128)
STRIPE_CLUSTER = 8
STRIPE_BK, STRIPE_STAGES, STRIPE_THREADS = 16, 4, 128
STRIPE_PAD = (8, 4)
#: Streaming multiprocessors of an H100 SXM: the stripe grid at m = 2048
#: holds at least this many blocks.
H100_SMS = 132

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


class StripeGeometry(NamedTuple):
    """Launch arithmetic of ``gtt_matmul_stripe`` for one call."""

    bm: int          # rows of a stripe
    bn: int          # columns of one tile
    cl: int          # blocks per cluster; one cluster per stripe
    stripes: int
    blocks: int      # stripes * cl
    threads: int     # per block
    vec: int         # floats per cp.async: 4 (16 bytes) or 1 (4 bytes)
    smem_bytes: int  # dynamic shared memory per block (the cp.async ring)
    k_tiles: int     # ring stages filled per column tile


def stripe_geometry(m: int, n: int, k: int, lda: int, ldb: int,
                    a_ptr: int = 0, b_ptr: int = 0) -> StripeGeometry:
    """The grid ``gtt_matmul_stripe`` launches for an (m, k) x (k, n)
    product with row strides ``lda``/``ldb`` (in floats) and operand
    addresses ``a_ptr``/``b_ptr`` (``data_ptr()``): the same rule as the
    C launcher. The 16-byte copy needs every row of A and B to start on
    a 16-byte boundary; otherwise the kernel's 4-byte copy runs."""
    bm, bn = CUDA_STRIPE_TILE
    stripes = -(-m // bm)
    vec = 4 if (lda % 4 == 0 and ldb % 4 == 0 and a_ptr % 16 == 0
                and b_ptr % 16 == 0) else 1
    stage = 4 * (bm * (STRIPE_BK + STRIPE_PAD[0])
                 + STRIPE_BK * (bn + STRIPE_PAD[1]))
    return StripeGeometry(bm, bn, STRIPE_CLUSTER, stripes,
                          stripes * STRIPE_CLUSTER, STRIPE_THREADS, vec,
                          STRIPE_STAGES * stage, -(-k // STRIPE_BK))


def stripe_block_tiles(geom: StripeGeometry, n: int, block: int):
    """The (row0, col0) output tiles block ``block`` of the stripe grid
    computes: stripe ``block // cl`` (its cluster), column tiles
    ``rank, rank + cl, ...`` for its cluster rank ``block % cl``. Tiles
    reach past ``m`` and ``n`` at the ragged edges; the kernel masks
    them."""
    stripe, rank = divmod(block, geom.cl)
    return [(stripe * geom.bm, col0)
            for col0 in range(rank * geom.bn, n, geom.cl * geom.bn)]


def stripe_launch_info(precision: str = "high", vec: int = 4) -> dict:
    """What the card reports for the stripe kernel in a precision's mode
    and a copy width (4 or 1): its dynamic shared memory, how many of its
    clusters the card holds at once (``cudaOccupancyMaxActiveClusters``),
    blocks per cluster, threads per block, and whether the mode runs on
    the tensor cores. Builds ``csrc/matmul.cu``; needs a CUDA device."""
    lib = _build.library("matmul")
    out = (ctypes.c_int * 5)()
    mode = _MODES[kernel_mode(precision, torch.float32)]
    _build.check(lib, lib.gtt_matmul_stripe_info(mode, vec, out),
                 "matmul_stripe_info")
    return {"smem_bytes": out[0], "max_active_clusters": out[1],
            "cluster": out[2], "threads": out[3],
            "tensor_cores": bool(out[4])}


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
    """``a @ b`` on full-width (64, N) row stripes, each owned by one
    thread-block cluster of 8 blocks that split its 128-wide column tiles,
    each block walking K through a ``cp.async`` ring (kernel
    ``gtt_matmul_stripe``; :func:`stripe_geometry` gives the grid). Same
    device contract as :func:`matmul_tiled`; a launch the card cannot
    schedule raises. ``bm``/``bk`` are accepted for parity and
    ignored."""
    del bm, bk
    return _dispatch("matmul_stripe", a, b, precision)

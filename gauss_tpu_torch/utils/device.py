"""Device resolution and the float32 precision pin.

Every entry point of the port resolves its device here: ``None`` means the
CUDA card, and a machine without one raises instead of carrying on on the
CPU. ``device="cpu"`` is the explicit request the tests make; on CPU
tensors each kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch


def pin_true_f32() -> None:
    """Float32 matmuls in true float32: the JAX package's default GEMM
    precision ("highest") is full f32, while TF32 keeps ~3 decimal digits.
    Set both switches (cuBLAS and cuDNN) off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` -> ``cuda``. Raises
    RuntimeError when CUDA is requested (explicitly or by default) and no
    CUDA device is present. Pins true f32 matmuls either way."""
    pin_true_f32()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gauss_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; options: cuda, cpu")
    return dev


def as_tensor(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """``x`` (numpy array, sequence or tensor) as a ``dtype`` tensor on
    ``device`` — a copy only where the type or device differs."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def ready_cuda(dev: torch.device) -> None:
    """Make the card ready for a process's first solve: the CUDA context,
    the caching allocator, and the cuBLAS and cuSOLVER handles that the
    solvers' products, triangular solves and factorizations take at
    their first call. Launches none of the port's kernels. A supervised
    process (a replica, a fleet worker) calls it before its first
    heartbeat: on a card that other processes share, these take seconds,
    and inside a first dispatch they would hold the heartbeat past a
    short stall threshold."""
    w = 2 * torch.eye(64, device=dev).expand(2, 64, 64)
    torch.linalg.solve_triangular(w, w @ w, upper=True)
    torch.linalg.cholesky_ex(w)
    torch.cuda.synchronize(dev)

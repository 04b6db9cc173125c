"""gauss_tpu_torch — the PyTorch/CUDA port of gauss_tpu for one NVIDIA H100.

The blocked, verified dense solve: the ``.dat`` reader and synthetic
systems (:mod:`.io`), the blocked right-looking LU with partial pivoting
whose panel factor and fused panel+trailing update are hand-written CUDA
kernels for ``sm_90a`` (:mod:`.kernels`, sources in ``kernels/csrc/``),
the block-inverse triangular solves, host-f64 and on-device
double-single refinement (:mod:`.core`), the float64 checks
(:mod:`.verify`) and the reference-parity CLIs (:mod:`.cli`). Beside it,
the row-elimination solves (one step kernel per pivot, or k steps per
group through the panel kernel and a rank-k update kernel) and the
matmul driver with a tiled and a row-stripe GEMM kernel. And the sparse
Krylov plane (:mod:`.sparse`): CSR assembly from the coordinate stream, an
ELL sparse matrix-vector kernel, CG / GMRES / BiCGStab in float64 with
factor-based preconditioners, with the tuning seeds (:mod:`.tune`) it
reads. The structure router (:mod:`.structure`: ``solve_auto`` over the
blocked Cholesky, the band solvers and a block-diagonal lane whose stacks
factor in one batched panel-kernel launch) runs on the recovery ladder
of :mod:`.resilience`, with seeded fault injection. The
telemetry core (:mod:`.obs`) records spans, counters and health monitors
as JSONL under the CLIs' ``--metrics-out``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit CPU request they raise RuntimeError.
On CPU tensors every kernel wrapper runs its plain PyTorch version.
The package imports torch and numpy only; importing it compiles nothing.

The JAX package's top-level names ``eliminate``, ``back_substitute``,
``gauss_solve`` and ``matmul`` are re-exported here, loaded at first use
so that ``import gauss_tpu_torch`` imports no torch; ``obs`` is the
telemetry core, which imports no torch either.
"""

import importlib

from gauss_tpu_torch import obs

__version__ = "0.1.0"

_LAZY = {"eliminate": "gauss_tpu_torch.core.gauss",
         "back_substitute": "gauss_tpu_torch.core.gauss",
         "gauss_solve": "gauss_tpu_torch.core.gauss",
         "matmul": "gauss_tpu_torch.core.matmul"}
__all__ = sorted([*_LAZY, "obs"])


def __getattr__(name):
    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))

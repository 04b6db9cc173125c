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
factor-based preconditioners, with the structure detector
(:mod:`.structure`) and the tuning seeds (:mod:`.tune`) it reads.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit CPU request they raise RuntimeError.
On CPU tensors every kernel wrapper runs its plain PyTorch version.
The package imports torch and numpy only; importing it compiles nothing.
"""

__version__ = "0.1.0"

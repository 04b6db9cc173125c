"""Sparse engines: CSR assembly straight from the coordinate stream,
matrix-free Krylov solvers, and factor-based preconditioning. Port of
``gauss_tpu/sparse``.

The reference's native input format is already sparse — ``row col value``
coordinate ``.dat`` files — and ``detect_structure_coords`` classifies
structure on that stream without densifying. Here the operand itself
stays in CSR form (O(nnz + n) bytes), SpMV runs as a padded-row (ELL)
CUDA kernel (``kernels/csrc/spmv.cu``), and the solvers are matrix-free
Krylov loops in float64 (CG for Gershgorin-certified SPD systems,
GMRES(restart) and BiCGStab for general systems) gated by the same 1e-4
verify as every dense engine. Preconditioners reuse existing machinery:
block-Jacobi from block-diagonal partitions (factorability probed by the
``core/blocked.py`` panel step), tridiagonal solves from
``structure/banded.py``, and a zero-fill incomplete Cholesky/ILU whose
fill is confined to the block-tridiagonal pattern.

``python -m gauss_tpu_torch.sparse.check`` is the plane's smoke gate.
"""

from gauss_tpu_torch.sparse.csr import CsrMatrix
from gauss_tpu_torch.sparse.krylov import (
    IterativeStagnationError,
    SparseSolveResult,
    solve_bicgstab,
    solve_cg,
    solve_gmres,
)
from gauss_tpu_torch.sparse.precond import Preconditioner, build_preconditioner
from gauss_tpu_torch.sparse.solve import solve_sparse
from gauss_tpu_torch.sparse.spmv import (spmv_coo, spmv_ell, spmv_ell_kernel,
                                         spmv_ell_plain)

__all__ = [
    "CsrMatrix",
    "IterativeStagnationError",
    "Preconditioner",
    "SparseSolveResult",
    "build_preconditioner",
    "solve_bicgstab",
    "solve_cg",
    "solve_gmres",
    "solve_sparse",
    "spmv_coo",
    "spmv_ell",
    "spmv_ell_kernel",
    "spmv_ell_plain",
]

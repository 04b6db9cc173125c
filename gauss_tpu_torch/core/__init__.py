"""Solvers: the unblocked oracle (:mod:`.gauss`), the blocked LU with its
solves and refinement (:mod:`.blocked`), double-single residuals
(:mod:`.dsfloat`), GEMM precision names (:mod:`.matmul`) and the numpy
bridge for factor, ELL and preconditioner state (:mod:`.convert`).

As in the JAX package, the name ``matmul`` here is the function
:func:`gauss_tpu_torch.core.matmul.matmul`, not its module: reach the
module through ``importlib.import_module("gauss_tpu_torch.core.matmul")``
or ``from gauss_tpu_torch.core.matmul import ...``."""

from gauss_tpu_torch.core.gauss import (  # noqa: F401
    EliminationResult,
    back_substitute,
    eliminate,
    gauss_solve,
)
from gauss_tpu_torch.core.matmul import matmul  # noqa: F401

__all__ = ["EliminationResult", "back_substitute", "eliminate",
           "gauss_solve", "matmul"]

"""Solvers: the unblocked oracle (:mod:`.gauss`), the blocked LU with its
solves and refinement (:mod:`.blocked`), double-single residuals
(:mod:`.dsfloat`), GEMM precision names (:mod:`.matmul`) and the numpy
bridge for factor state (:mod:`.convert`)."""

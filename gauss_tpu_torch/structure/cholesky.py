"""The typed not-positive-definite error of the JAX package's
``structure/cholesky.py``. The blocked Cholesky factorization itself is
not ported yet; ``sparse.krylov.solve_cg`` raises this error when the
Gershgorin certificate fails."""


class NotSPDError(RuntimeError):
    """The matrix is not positive definite (or not symmetric enough to
    pretend). ``min_diag`` carries the witness value where a factorization
    found one (0.0 stands in for NaN)."""

    def __init__(self, message: str, min_diag: float = 0.0):
        super().__init__(message)
        self.min_diag = min_diag

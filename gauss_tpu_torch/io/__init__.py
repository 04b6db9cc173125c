"""Matrix I/O: the ``.dat`` coordinate format and the synthetic generators
(numpy only; the port's own copies)."""

from gauss_tpu_torch.io.datfile import (  # noqa: F401
    DatFormatError,
    read_dat,
    read_dat_dense,
    write_dat,
)
from gauss_tpu_torch.io.synthetic import (  # noqa: F401
    generator_matrix,
    internal_matrix,
    internal_rhs,
    manufactured_rhs,
    manufactured_solution,
)

__all__ = ["DatFormatError", "generator_matrix", "internal_matrix",
           "internal_rhs", "manufactured_rhs", "manufactured_solution",
           "read_dat", "read_dat_dense", "write_dat"]

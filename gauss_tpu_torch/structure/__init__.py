"""Structure detection (:mod:`.detect`) and the pieces of the structured
solvers that the sparse plane uses: the typed ``NotSPDError``
(:mod:`.cholesky`) and the tridiagonal solve (:mod:`.banded`). The
structured factorizations and the router (``solve_auto``) are not ported
yet."""

from gauss_tpu_torch.structure.detect import (  # noqa: F401
    STRUCTURE_KINDS,
    StructureInfo,
    StructureMismatchError,
    detect_structure,
    detect_structure_coords,
    detect_structure_dat,
    structure_tag,
)

__all__ = ["STRUCTURE_KINDS", "StructureInfo", "StructureMismatchError",
           "detect_structure", "detect_structure_coords",
           "detect_structure_dat", "structure_tag"]

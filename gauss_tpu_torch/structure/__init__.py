"""Structure-aware solves: detection, specialized engines and one router.
Port of ``gauss_tpu/structure``.

- :mod:`.detect`    — the cheap structure classifier (:class:`StructureInfo`).
- :mod:`.cholesky`  — blocked right-looking Cholesky, typed
                      :class:`~.cholesky.NotSPDError` on failure.
- :mod:`.banded`    — the tridiagonal scan and the blocked band LU.
- :mod:`.blockdiag` — batched small-block solves through the serving
                      layer's executable cache (one batched panel-kernel
                      launch per factor of a uniform partition).
- :mod:`.router`    — :func:`solve_auto`: detect -> route -> engine -> the
                      1e-4 gate, misclassification demoting down the
                      recovery ladder to general LU.
- :mod:`.check`     — ``python -m gauss_tpu_torch.structure.check``.

Importing this package loads no torch; the engines load it at first use.
"""

from gauss_tpu_torch.structure.detect import (  # noqa: F401
    STRUCTURE_KINDS,
    StructureInfo,
    StructureMismatchError,
    detect_structure,
    detect_structure_coords,
    detect_structure_dat,
    structure_tag,
)
from gauss_tpu_torch.structure.router import solve_auto  # noqa: F401

__all__ = ["STRUCTURE_KINDS", "StructureInfo", "StructureMismatchError",
           "detect_structure", "detect_structure_coords",
           "detect_structure_dat", "structure_tag", "solve_auto"]

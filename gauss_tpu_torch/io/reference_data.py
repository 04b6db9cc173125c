"""Locate and load the reference's REAL dataset matrices, read in place.

The reference evaluates its external-input programs on seven Harwell-Boeing
matrices shipped as ``.dat`` files in five ``matrices_dense/`` directories
(SURVEY.md §2 C8; e.g. reference Pthreads/Version-1/matrices_dense/jpwh_991.dat).
Those files are third-party data we do not copy into this repo; instead this
module finds them in a read-only reference checkout named by
``GAUSS_TPU_REFERENCE_ROOT`` and parses them AT USE TIME with the
same :mod:`gauss_tpu_torch.io.datfile` reader the external CLI uses — so golden tests,
cross-engine comparisons, and the external benchmark grid run against the exact
matrices behind the reference reports' external tables (BASELINE.md), not the
same-shape synthetic stand-ins from :mod:`gauss_tpu_torch.io.datasets`.

When no reference checkout is present, everything here degrades
gracefully: :func:`find_dat` returns None and callers fall back to the
stand-ins, which remain the deterministic, redistributable default.

Deviation from the JAX package: it also looks in a fixed default checkout
location when the variable is unset; the port reads only the variable.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Optional

import numpy as np

ROOT_ENV = "GAUSS_TPU_REFERENCE_ROOT"

# The five replicated dataset directories, in lookup order (files are
# md5-identical across them per SURVEY.md §2 C7/C8; first hit wins).
_SEARCH_DIRS = (
    "Pthreads/Version-1/matrices_dense",
    "Pthreads/Version-2/matrices_dense",
    "Pthreads/Version-3/matrices_dense",
    "OpenMP_and_MPI/gauss_openmp/matrices_dense",
    "OpenMP_and_MPI/gauss_mpi/matrices_dense",
)

# The real files shipped by the reference (matrix_2000 is referenced by its
# README but stripped from the mirror — regenerated, never "real").
REAL_NAMES = ("matrix_10", "jpwh_991", "orsreg_1", "sherman5", "saylr4",
              "sherman3", "memplus")


def reference_root() -> Optional[Path]:
    """The reference checkout ``$GAUSS_TPU_REFERENCE_ROOT`` names, or None."""
    root = os.environ.get(ROOT_ENV)
    return Path(root) if root else None


def available() -> bool:
    """True when a reference checkout with at least one dataset dir exists."""
    root = reference_root()
    return root is not None and any((root / d).is_dir()
                                    for d in _SEARCH_DIRS)


@functools.lru_cache(maxsize=None)
def _find_dat_under(root: str, name: str) -> Optional[str]:
    for d in _SEARCH_DIRS:
        p = Path(root) / d / f"{name}.dat"
        if p.is_file():
            return str(p)
    return None


def find_dat(name: str) -> Optional[str]:
    """Absolute path of the real ``<name>.dat``, or None if absent.

    Cached per (root, name): a checkout is read-only and immutable for a run,
    but the ``$GAUSS_TPU_REFERENCE_ROOT`` override is re-read on every call
    (a later env change must not be poisoned by an earlier miss).
    """
    root = reference_root()
    return None if root is None else _find_dat_under(str(root), name)


def load_dense(name: str, dtype=np.float64) -> np.ndarray:
    """Densified REAL reference matrix (raises KeyError when not available).

    Parse semantics are exactly the external programs' initMatrix
    (gauss_external_input.c:34-86): 1-indexed coordinates, last duplicate
    wins, ``0 0 0`` terminator, densified to row-major n x n.
    """
    from gauss_tpu_torch.io import datfile

    path = find_dat(name)
    if path is None:
        raise KeyError(
            f"real reference matrix {name!r} not found under "
            f"{reference_root()} (set ${ROOT_ENV} to a reference checkout)")
    return datfile.read_dat_dense(path, dtype=dtype)

"""Cheap structure classification for square systems (a numpy copy of the
JAX package's ``structure/detect.py``; the router that consumes ``kind``
comes with the structured solvers).

One O(n^2) numpy scan of an in-memory matrix — or one O(nnz log nnz) pass
over a ``.dat`` coordinate stream, where the structure is visible *for free*
before anything is densified — produces a :class:`StructureInfo`:

- **symmetric**: exact elementwise ``A == A.T``. Exact on purpose: routing
  to Cholesky is only *correct* for symmetric matrices, and a near-SPD
  non-symmetric perturbation must classify dense (the router's demotion
  ladder exists for the cases detection refuses to bless).
- **spd_likely**: symmetric, positive diagonal, and every Gershgorin disc
  strictly inside the positive half-line (``a_ii > sum_{j != i} |a_ij|``).
  For a symmetric matrix that is a *proof* of positive definiteness, not a
  heuristic — the detector never certifies SPD on a hunch. Symmetric
  systems that fail Gershgorin can still be SPD; the router covers them
  with a *verified Cholesky attempt*: the factorization itself is the test
  (typed :class:`gauss_tpu_torch.structure.cholesky.NotSPDError` demotes to LU).
- **bandwidth**: max |i - j| over nonzeros (0 = diagonal, n-1 = full).
- **blocks**: the contiguous block-diagonal partition — maximal prefix
  points k where no nonzero couples rows/cols <= k with rows/cols > k.
  A *permuted* block-diagonal matrix is deliberately NOT detected (the
  partition is only cheap for the contiguous layout; general symmetric
  permutation detection is a graph problem this classifier does not
  pretend to solve) — it classifies dense and takes general LU.
- **density**: nnz / n^2.

``kind`` is the routing class with precedence blockdiag > banded > sparse
> spd > dense: a block-diagonal matrix is also banded and possibly SPD,
but the batched small-block solve beats both; a banded SPD matrix takes
the O(n b^2) band engine over the O(n^3/3) Cholesky; and a matrix at or
below :data:`SPARSE_MAX_DENSITY` (with ``n >= SPARSE_MIN_N``) routes to
the matrix-free Krylov plane (``gauss_tpu_torch.sparse``) whether or not it is
SPD — the certificate only picks WHICH Krylov head (CG vs GMRES).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

#: routing classes, in router/inject tag order (inject kind="mistag" indexes
#: this tuple via its float ``param``; "sparse" appended LAST so historical
#: mistag indices stay stable)
STRUCTURE_KINDS = ("spd", "banded", "blockdiag", "dense", "sparse")

#: a matrix is routed banded only when its bandwidth is at most n // this —
#: past that the n*b^2 band solve loses its margin over blocked LU (and the
#: unpivoted band factorization its numerical headroom)
BANDED_MAX_DIVISOR = 8

#: minimum number of contiguous diagonal blocks for the batched route
BLOCKDIAG_MIN_BLOCKS = 2

# Density at or below which a system routes to the sparse Krylov plane
# (gauss_tpu_torch.sparse). Sourced from the declared tune axis so the routing
# boundary and the tuner's "sparse" op can never drift apart.
from gauss_tpu_torch.tune.space import SPARSE_DENSITY_SEED as SPARSE_MAX_DENSITY  # noqa: E402

#: below this order the dense engines win outright (one small dispatch vs
#: staging + iteration), so low density alone never routes sparse — which
#: also keeps every historical small-n classification byte-stable.
SPARSE_MIN_N = 256


class StructureMismatchError(RuntimeError):
    """An engine was handed a matrix without the structure it requires
    (e.g. the banded rung on a full-bandwidth matrix, the block-diagonal
    rung on an unpartitionable one). Typed so the recovery ladder can
    demote to general LU instead of wasting a doomed factorization."""


@dataclasses.dataclass(frozen=True)
class StructureInfo:
    """What one scan learned about a square matrix."""

    n: int
    symmetric: bool
    spd_likely: bool          # Gershgorin-certified positive definite
    bandwidth: int            # max |i - j| over nonzeros
    blocks: Tuple[int, ...]   # contiguous diagonal-block partition sizes
    density: float            # nnz / n^2

    @property
    def kind(self) -> str:
        """Routing class: blockdiag > banded > sparse > spd > dense.
        Sparse sits below the exact-structure classes (a sparse banded
        matrix still wants the O(n b^2) direct factor over iteration)
        and above spd (a certified-SPD matrix at sparse density wants CG,
        not an n^3/3 Cholesky it cannot even allocate at scale)."""
        n = self.n
        if n <= 1:
            return "dense"  # trivial systems route straight through
        if len(self.blocks) >= BLOCKDIAG_MIN_BLOCKS:
            return "blockdiag"
        if self.bandwidth <= max(1, n // BANDED_MAX_DIVISOR):
            return "banded"
        if n >= SPARSE_MIN_N and 0.0 < self.density <= SPARSE_MAX_DENSITY:
            return "sparse"
        if self.spd_likely:
            return "spd"
        return "dense"


def _partition_from_reach(reach: np.ndarray) -> Tuple[int, ...]:
    """Block sizes from the per-index coupling reach: a block ends at k when
    no index <= k couples past k (running max of reach equals k)."""
    n = reach.shape[0]
    if n == 0:
        return ()
    running = np.maximum.accumulate(reach)
    ends = np.nonzero(running == np.arange(n))[0]
    starts = np.concatenate([[0], ends[:-1] + 1])
    return tuple(int(e - s + 1) for s, e in zip(starts, ends))


def detect_structure(a) -> StructureInfo:
    """Classify an in-memory square matrix (one O(n^2) numpy pass)."""
    a = np.asarray(a)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"expected square matrix, got {a.shape}")
    if n == 0:
        return StructureInfo(n=0, symmetric=True, spd_likely=False,
                             bandwidth=0, blocks=(), density=0.0)
    nz = a != 0
    nnz = int(nz.sum())
    density = nnz / float(n * n)
    symmetric = bool(np.array_equal(a, a.T))
    diag = np.diagonal(a).astype(np.float64, copy=False)
    off = np.abs(a).sum(axis=1, dtype=np.float64) - np.abs(diag)
    spd_likely = bool(symmetric and (diag > off).all() and (diag > 0).all())
    idx = np.arange(n)
    if nnz:
        # Furthest column each row touches / furthest row each column
        # touches; -1 where empty so the arange floor wins.
        col_of = np.where(nz, idx[None, :], -1)
        row_of = np.where(nz, idx[:, None], -1)
        row_reach = col_of.max(axis=1)
        col_reach = row_of.max(axis=0)
        reach = np.maximum(np.maximum(row_reach, col_reach), idx)
        rows, cols = np.nonzero(a)
        bandwidth = int(np.abs(rows - cols).max())
    else:
        reach = idx
        bandwidth = 0
    return StructureInfo(n=n, symmetric=symmetric, spd_likely=spd_likely,
                         bandwidth=bandwidth,
                         blocks=_partition_from_reach(reach),
                         density=density)


def detect_structure_coords(n: int, rows, cols, vals) -> StructureInfo:
    """Classify from 0-indexed coordinate entries without densifying —
    byte-for-byte the same :class:`StructureInfo` :func:`detect_structure`
    computes from the densified matrix (asserted in tests). Duplicate
    coordinates are the caller's problem (the strict ``.dat`` reader
    already rejects them); explicit zeros are ignored, matching the dense
    scan's ``a != 0`` mask."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    if n == 0:
        return StructureInfo(n=0, symmetric=True, spd_likely=False,
                             bandwidth=0, blocks=(), density=0.0)
    keep = vals != 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    nnz = int(rows.size)
    density = nnz / float(n * n)
    # Symmetry: the (r, c)-sorted stream must equal the (c, r)-sorted one.
    o1 = np.lexsort((cols, rows))
    o2 = np.lexsort((rows, cols))
    symmetric = bool(np.array_equal(rows[o1], cols[o2])
                     and np.array_equal(cols[o1], rows[o2])
                     and np.array_equal(vals[o1], vals[o2]))
    diag = np.zeros(n, dtype=np.float64)
    dmask = rows == cols
    diag[rows[dmask]] = vals[dmask]
    off = np.zeros(n, dtype=np.float64)
    np.add.at(off, rows[~dmask], np.abs(vals[~dmask]))
    spd_likely = bool(symmetric and (diag > off).all() and (diag > 0).all())
    bandwidth = int(np.abs(rows - cols).max()) if nnz else 0
    reach = np.arange(n)
    if nnz:
        far = np.maximum(rows, cols)
        np.maximum.at(reach, rows, far)
        np.maximum.at(reach, cols, far)
    return StructureInfo(n=n, symmetric=symmetric, spd_likely=spd_likely,
                         bandwidth=bandwidth,
                         blocks=_partition_from_reach(reach),
                         density=density)


def detect_structure_dat(path_or_file, strict: bool = True) -> StructureInfo:
    """Classify a ``.dat`` file straight from its coordinate stream — the
    structure is decided before anything is densified, so a serving/dataset
    path can route by it at parse time for free."""
    from gauss_tpu_torch.io.datfile import read_dat

    n, rows, cols, vals = read_dat(path_or_file, strict=strict)
    return detect_structure_coords(n, rows, cols, vals)


def structure_tag(a) -> str:
    """Shorthand: the routing class of ``a`` (one detection pass)."""
    return detect_structure(a).kind

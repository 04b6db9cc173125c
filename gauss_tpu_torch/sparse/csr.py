"""CSR container assembled directly from the ``.dat`` coordinate stream.

``CsrMatrix`` is the sparse-plane operand: three flat arrays (row
pointers, column indices, values) holding O(nnz + n) bytes, assembled
from coordinates without ever materializing an n x n buffer.  Assembly
SUMS duplicate coordinates — the additive convention for sparse
assembly (finite-element style), documented against the dense path's
fscanf last-wins parity in ``io/datfile.py``.

Two staging forms feed the kernels in ``sparse/spmv.py``:

- ``coo()`` — sorted COO triplets for the ``index_add_`` fallback;
- ``ell()`` — padded-row (ELLPACK) arrays ``(n, k)`` where
  ``k = max_row_nnz``; padding points at column 0 with value 0 so it
  contributes nothing to a matvec.  For the ≤ tens-of-nnz-per-row
  systems this plane targets, the ELL form is a small constant factor
  over CSR, and its rows are what the CUDA kernel's threads walk.

Everything here is host-side numpy (a copy of the JAX package's
``sparse/csr.py``: the two assemble byte-equal arrays); torch enters only
in ``sparse/spmv.py``, ``sparse/precond.py`` and ``sparse/krylov.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np

__all__ = ["CsrMatrix"]

#: ``to_dense`` refuses above this order: the sparse plane exists so that
#: n x n buffers are never allocated by accident; densifying is only for
#: tests and small diagnostics.
DENSIFY_LIMIT = 8192


def _sum_duplicates(
    n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lexsort coordinates by (row, col) and sum duplicate entries."""
    codes = rows.astype(np.int64) * np.int64(n) + cols.astype(np.int64)
    order = np.argsort(codes, kind="stable")
    codes = codes[order]
    vals = vals[order]
    uniq, start = np.unique(codes, return_index=True)
    summed = np.add.reduceat(vals, start) if vals.size else vals
    return (uniq // n).astype(np.int64), (uniq % n).astype(np.int32), summed


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """Compressed-sparse-row matrix: ``indptr`` (n+1,), ``indices``/
    ``data`` (nnz,) with columns sorted within each row."""

    n: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    # -- assembly ----------------------------------------------------------

    @classmethod
    def from_coords(
        cls,
        n: int,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        *,
        drop_zeros: bool = True,
    ) -> "CsrMatrix":
        """Assemble from 0-indexed coordinates, SUMMING duplicates.

        Explicit zeros (and entries that cancel to zero when duplicates
        sum) are dropped by default so density reflects structural
        nonzeros, matching ``detect_structure_coords``.
        """
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, dtype=np.float64)
        if not (rows.shape == cols.shape == vals.shape):
            raise ValueError("rows/cols/vals must have identical shapes")
        if rows.size and (
            rows.min() < 0 or rows.max() >= n or cols.min() < 0 or cols.max() >= n
        ):
            raise ValueError(f"coordinate out of range for n={n}")
        r, c, v = _sum_duplicates(n, rows, cols, vals)
        if drop_zeros:
            keep = v != 0.0
            r, c, v = r[keep], c[keep], v[keep]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, r + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(n=n, indptr=indptr, indices=c, data=v)

    @classmethod
    def from_coord_chunks(
        cls,
        n: int,
        chunks: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        *,
        drop_zeros: bool = True,
    ) -> "CsrMatrix":
        """Assemble from an iterable of ``(rows, cols, vals)`` chunks —
        the shape ``io.datfile.iter_coords`` yields — accumulating
        O(nnz) coordinate arrays, never the file text."""
        rs, cs, vs = [], [], []
        for rows, cols, vals in chunks:
            rs.append(np.asarray(rows))
            cs.append(np.asarray(cols))
            vs.append(np.asarray(vals, dtype=np.float64))
        if not rs:
            rs, cs, vs = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)], [
                np.zeros(0, np.float64)
            ]
        return cls.from_coords(
            n,
            np.concatenate(rs),
            np.concatenate(cs),
            np.concatenate(vs),
            drop_zeros=drop_zeros,
        )

    @classmethod
    def from_dat(cls, path_or_file, *, strict: bool = False) -> "CsrMatrix":
        """Stream a ``.dat`` coordinate file into CSR form.

        Non-strict (the default here, mirroring the reference's
        tolerant fscanf loop) SUMS duplicate coordinates; ``strict=True``
        rejects them with a typed ``DatFormatError`` before assembly —
        see the duplicate-semantics note in ``io/datfile.py``.
        """
        from gauss_tpu_torch.io import datfile

        stream = datfile.iter_coords(path_or_file, strict=strict)
        return cls.from_coord_chunks(stream.n, stream)

    @classmethod
    def from_dense(cls, a: np.ndarray) -> "CsrMatrix":
        """Convert a small dense matrix (tests, recovery-ladder rungs
        whose operands are already dense)."""
        a = np.asarray(a, dtype=np.float64)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected square matrix, got {a.shape}")
        rows, cols = np.nonzero(a)
        return cls.from_coords(a.shape[0], rows, cols, a[rows, cols])

    # -- shape / structure -------------------------------------------------

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    @property
    def density(self) -> float:
        return self.nnz / float(max(self.n, 1) ** 2)

    @property
    def max_row_nnz(self) -> int:
        return int(np.diff(self.indptr).max()) if self.n else 0

    def row_ids(self) -> np.ndarray:
        """COO row index per stored entry (sorted ascending)."""
        return np.repeat(
            np.arange(self.n, dtype=np.int64), np.diff(self.indptr)
        )

    def diagonal(self) -> np.ndarray:
        d = np.zeros(self.n, dtype=np.float64)
        rows = self.row_ids()
        on_diag = rows == self.indices
        d[rows[on_diag]] = self.data[on_diag]
        return d

    def is_symmetric(self) -> bool:
        """Exact pattern + value symmetry (same convention as
        ``structure.detect``: compares the (row, col) stream against its
        transpose after lexsort)."""
        rows = self.row_ids()
        tcodes = self.indices.astype(np.int64) * np.int64(self.n) + rows
        torder = np.argsort(tcodes, kind="stable")
        codes = rows * np.int64(self.n) + self.indices
        return bool(
            np.array_equal(codes, tcodes[torder])
            and np.array_equal(self.data, self.data[torder])
        )

    def gershgorin_spd(self) -> bool:
        """The same SPD certificate the structure tagger issues: symmetric,
        positive diagonal, and every Gershgorin disc strictly right of
        zero (``a_ii > sum_{j != i} |a_ij|``) — a proof of SPD, which is
        what licenses the CG head of the sparse ladder."""
        d = self.diagonal()
        if not (d > 0.0).all():
            return False
        off = np.zeros(self.n, dtype=np.float64)
        rows = self.row_ids()
        mask = rows != self.indices
        np.add.at(off, rows[mask], np.abs(self.data[mask]))
        if not (d > off).all():
            return False
        return self.is_symmetric()

    # -- staging forms -----------------------------------------------------

    def coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Row-sorted COO triplets for the ``index_add_`` SpMV."""
        return self.row_ids(), self.indices, self.data

    def ell(self) -> Tuple[np.ndarray, np.ndarray]:
        """Padded-row (ELLPACK) staging: ``(cols, vals)`` of shape
        ``(n, max_row_nnz)``; padding is column 0 / value 0."""
        k = max(self.max_row_nnz, 1)
        counts = np.diff(self.indptr)
        cols = np.zeros((self.n, k), dtype=np.int32)
        vals = np.zeros((self.n, k), dtype=np.float64)
        slot = np.arange(self.data.size, dtype=np.int64) - np.repeat(
            self.indptr[:-1], counts
        )
        cols[self.row_ids(), slot] = self.indices
        vals[self.row_ids(), slot] = self.data
        return cols, vals

    # -- host reference ops ------------------------------------------------

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host numpy reference ``A @ x`` (1-D or (n, k) x) — the
        independent check the verify gate runs against solver output."""
        x = np.asarray(x, dtype=np.float64)
        rows = self.row_ids()
        contrib = (
            self.data * x[self.indices]
            if x.ndim == 1
            else self.data[:, None] * x[self.indices]
        )
        y = np.zeros(x.shape, dtype=np.float64)
        np.add.at(y, rows, contrib)
        return y

    def to_dense(self, *, limit: int = DENSIFY_LIMIT) -> np.ndarray:
        """Materialize n x n — tests/diagnostics only; refuses above
        ``limit`` so the no-densify contract cannot be broken silently."""
        if self.n > limit:
            raise ValueError(
                f"refusing to densify n={self.n} (> {limit}): the sparse "
                "plane exists to avoid n^2 buffers"
            )
        a = np.zeros((self.n, self.n), dtype=np.float64)
        a[self.row_ids(), self.indices] = self.data
        return a

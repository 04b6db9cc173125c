"""Reader/writer for the reference's ``.dat`` sparse-coordinate matrix format.

Format (reference Pthreads/Version-1/matrices_dense/matrix_gen.cc:13-22 and the
parser in gauss_external_input.c:34-86):

    line 1: ``n n nnz``            (rows, cols, number of entries)
    body:   ``row col value``     one entry per line, **1-indexed**
    end:    ``0 0 0``             terminator row (optional in some files)

Entries may appear in any order. By default (``strict=True``) the parser
REJECTS, with a typed :class:`DatFormatError` carrying the offending line
number, three classes of file the reference's fscanf loop silently accepts
into a bad matrix: non-finite values (a NaN/Inf entry poisons every solve
downstream), duplicate ``(row, col)`` coordinates (the reference's
densifying loop overwrites — two generators disagreeing about one entry is
a corrupt file, not a preference), and a missing ``0 0 0`` terminator (the
classic truncated-upload signature). ``strict=False`` restores the exact
reference semantics — last duplicate wins, EOF terminates — for bug-parity
experiments.

This is the port's own copy of the JAX package's numpy-only parser; the
port imports nothing from the JAX package. The C++ fast parser
(``engine="native"``) is the port's :mod:`gauss_tpu_torch.native`, built
from the same source; ``engine="auto"`` takes it only for ``strict=False``
on a file path, as in the JAX package.

**Duplicate-coordinate semantics.** A ``.dat`` file may name the same
``(row, col)`` twice; the consumers resolve that differently, on purpose:

- ``strict=True`` (every reader's default): duplicates are a CORRUPT
  file — two generators disagreeing about one entry — and parsing fails
  with a typed :class:`DatFormatError` naming both lines. No consumer
  downstream ever sees an ambiguous matrix.
- ``strict=False``, dense path (:func:`read_dat` + :func:`densify`): the
  reference's fscanf loop scatters entries in file order, so the LAST
  occurrence wins — bug-parity with gauss_external_input.c's initMatrix.
- ``strict=False``, sparse assembly (the CSR builder,
  :meth:`gauss_tpu_torch.sparse.csr.CsrMatrix.from_dat`): coordinates are
  SUMMED — the additive convention of finite-element/graph assembly.

That divergence is inherent to the two traditions, which is exactly why
``strict=True`` refuses to guess.

:func:`iter_coords` is the streaming face of the same parser: the header
is read eagerly (``.n`` / ``.declared_nnz``), the body is yielded as
0-indexed ``(rows, cols, vals)`` numpy chunks, and every per-line strict
check of :func:`read_dat` runs as the stream advances — O(chunk) resident
text for an O(nnz) file, never an n x n buffer.
"""

from __future__ import annotations

import io as _io
import os
from typing import Optional, TextIO, Tuple, Union

import numpy as np

PathOrFile = Union[str, os.PathLike, TextIO]


class DatFormatError(ValueError):
    """A malformed .dat file, with the 1-indexed line of the offense when
    known (``.line``; the header is line 1). Subclasses ValueError so
    pre-existing ``except ValueError`` call sites keep working."""

    def __init__(self, message: str, line: Optional[int] = None):
        super().__init__(f"line {line}: {message}" if line is not None
                         else message)
        self.line = line


def _open_maybe(path_or_file: PathOrFile, mode: str):
    if hasattr(path_or_file, "read") or hasattr(path_or_file, "write"):
        return path_or_file, False
    return open(path_or_file, mode), True


def read_dat(path_or_file: PathOrFile, strict: bool = True,
             ) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Parse a .dat file -> (n, rows, cols, vals) with 0-indexed coordinates.

    ``strict`` additionally rejects non-finite values, duplicate (row, col)
    coordinates, and a missing ``0 0 0`` terminator — each as a
    :class:`DatFormatError` with the offending line number — instead of
    silently building a bad matrix (reference fscanf behavior, available
    via ``strict=False``)."""
    f, close = _open_maybe(path_or_file, "r")
    try:
        header = f.readline().split()
        if len(header) < 3:
            raise DatFormatError("malformed .dat header; expected 'n n nnz'",
                                 line=1)
        try:
            n = int(header[0])
            n2 = int(header[1])
            nnz = int(header[2])
        except ValueError as e:
            raise DatFormatError(
                f"malformed .dat header: {' '.join(header[:3])!r}",
                line=1) from e
        if n != n2:
            raise DatFormatError(
                f"non-square matrix in .dat header: {n} x {n2}", line=1)
        if n < 0 or nnz < 0:
            raise DatFormatError(
                f"negative dimension in .dat header: n={n} nnz={nnz}", line=1)
        rows = np.empty(nnz, dtype=np.int64)
        cols = np.empty(nnz, dtype=np.int64)
        vals = np.empty(nnz, dtype=np.float64)
        lines = np.empty(nnz, dtype=np.int64)  # per-entry source line
        count = 0
        terminated = False
        lineno = 1
        for line in f:
            lineno += 1
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 2 or (len(parts) < 3 and not (parts[0] == "0" and parts[1] == "0")):
                raise DatFormatError(
                    f"malformed .dat body line: {line.rstrip()!r}",
                    line=lineno)
            try:
                r, c = int(parts[0]), int(parts[1])
            except ValueError as e:
                raise DatFormatError(
                    f"malformed .dat body line: {line.rstrip()!r}",
                    line=lineno) from e
            if r == 0 and c == 0:  # `0 0 0` terminator
                terminated = True
                break
            if count >= nnz:
                raise DatFormatError(
                    ".dat body has more entries than header nnz",
                    line=lineno)
            if not (1 <= r <= n and 1 <= c <= n):
                raise DatFormatError(
                    f".dat entry ({r}, {c}) out of bounds for 1-indexed "
                    f"{n} x {n} matrix", line=lineno)
            try:
                v = float(parts[2])
            except ValueError as e:
                raise DatFormatError(
                    f"malformed .dat body line: {line.rstrip()!r}",
                    line=lineno) from e
            if strict and not np.isfinite(v):
                raise DatFormatError(
                    f"non-finite value {parts[2]!r} at entry ({r}, {c}); a "
                    f"NaN/Inf entry poisons every downstream solve",
                    line=lineno)
            rows[count] = r - 1
            cols[count] = c - 1
            vals[count] = v
            lines[count] = lineno
            count += 1
        if count != nnz:
            raise DatFormatError(
                f".dat body has {count} entries, header promised {nnz}",
                line=lineno)
        if strict and not terminated:
            raise DatFormatError(
                "missing '0 0 0' terminator (truncated file?); pass "
                "strict=False to accept EOF-terminated files", line=lineno)
        if strict and nnz:
            # Vectorized duplicate scan (a per-line set would cost O(nnz)
            # python-object memory on generator-format files).
            codes = rows * np.int64(n) + cols
            order = np.argsort(codes, kind="stable")
            dup = np.nonzero(np.diff(codes[order]) == 0)[0]
            if dup.size:
                i1, i2 = order[dup[0]], order[dup[0] + 1]
                raise DatFormatError(
                    f"duplicate .dat entry ({rows[i2] + 1}, {cols[i2] + 1}) "
                    f"(first at line {lines[i1]}); the reference's "
                    f"last-wins overwrite is available via strict=False",
                    line=int(lines[i2]))
        return n, rows, cols, vals
    finally:
        if close:
            f.close()


class CoordStream:
    """Streaming ``.dat`` reader: the header eagerly (``.n``,
    ``.declared_nnz``), the body lazily as 0-indexed ``(rows, cols,
    vals)`` numpy chunks of at most ``chunk`` entries. Iterate it once;
    :meth:`gauss_tpu_torch.sparse.csr.CsrMatrix.from_coord_chunks`
    accepts it directly. All of :func:`read_dat`'s per-line validation (bounds,
    malformed lines, header/body count mismatch) runs as the stream
    advances; ``strict`` additionally rejects non-finite values,
    duplicate coordinates (detected by the same vectorized scan, at end
    of stream), and a missing ``0 0 0`` terminator."""

    def __init__(self, path_or_file: PathOrFile, strict: bool = True,
                 chunk: int = 65536):
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self._f, self._close = _open_maybe(path_or_file, "r")
        self.strict = bool(strict)
        self.chunk = int(chunk)
        self._consumed = False
        header = self._f.readline().split()
        try:
            if len(header) < 3:
                raise DatFormatError(
                    "malformed .dat header; expected 'n n nnz'", line=1)
            try:
                n, n2, nnz = (int(header[0]), int(header[1]),
                              int(header[2]))
            except ValueError as e:
                raise DatFormatError(
                    f"malformed .dat header: {' '.join(header[:3])!r}",
                    line=1) from e
            if n != n2:
                raise DatFormatError(
                    f"non-square matrix in .dat header: {n} x {n2}", line=1)
            if n < 0 or nnz < 0:
                raise DatFormatError(
                    f"negative dimension in .dat header: n={n} nnz={nnz}",
                    line=1)
        except Exception:
            self._finish()
            raise
        #: matrix order from the header (available before any body I/O)
        self.n = n
        #: entry count the header promises (validated against the body)
        self.declared_nnz = nnz

    def _finish(self):
        if self._close and self._f is not None:
            self._f.close()
        self._f = None

    def __iter__(self):
        if self._consumed:
            raise RuntimeError(
                "CoordStream is single-pass; construct a new one to re-read")
        self._consumed = True
        return self._iterate()

    def _iterate(self):
        n, nnz, strict = self.n, self.declared_nnz, self.strict
        rs, cs, vs, ls = [], [], [], []
        codes_seen, lines_seen = [], []  # strict duplicate scan, per chunk
        count = 0
        terminated = False
        lineno = 1
        try:
            for line in self._f:
                lineno += 1
                parts = line.split()
                if not parts:
                    continue
                if len(parts) < 2 or (len(parts) < 3 and not (
                        parts[0] == "0" and parts[1] == "0")):
                    raise DatFormatError(
                        f"malformed .dat body line: {line.rstrip()!r}",
                        line=lineno)
                try:
                    r, c = int(parts[0]), int(parts[1])
                except ValueError as e:
                    raise DatFormatError(
                        f"malformed .dat body line: {line.rstrip()!r}",
                        line=lineno) from e
                if r == 0 and c == 0:
                    terminated = True
                    break
                if count >= nnz:
                    raise DatFormatError(
                        ".dat body has more entries than header nnz",
                        line=lineno)
                if not (1 <= r <= n and 1 <= c <= n):
                    raise DatFormatError(
                        f".dat entry ({r}, {c}) out of bounds for 1-indexed "
                        f"{n} x {n} matrix", line=lineno)
                try:
                    v = float(parts[2])
                except ValueError as e:
                    raise DatFormatError(
                        f"malformed .dat body line: {line.rstrip()!r}",
                        line=lineno) from e
                if strict and not np.isfinite(v):
                    raise DatFormatError(
                        f"non-finite value {parts[2]!r} at entry ({r}, {c});"
                        f" a NaN/Inf entry poisons every downstream solve",
                        line=lineno)
                rs.append(r - 1)
                cs.append(c - 1)
                vs.append(v)
                ls.append(lineno)
                count += 1
                if len(rs) >= self.chunk:
                    rows = np.asarray(rs, dtype=np.int64)
                    cols = np.asarray(cs, dtype=np.int64)
                    if strict:
                        codes_seen.append(rows * np.int64(n) + cols)
                        lines_seen.append(np.asarray(ls, dtype=np.int64))
                    yield rows, cols, np.asarray(vs, dtype=np.float64)
                    rs, cs, vs, ls = [], [], [], []
            if count != nnz:
                raise DatFormatError(
                    f".dat body has {count} entries, header promised {nnz}",
                    line=lineno)
            if strict and not terminated:
                raise DatFormatError(
                    "missing '0 0 0' terminator (truncated file?); pass "
                    "strict=False to accept EOF-terminated files",
                    line=lineno)
            if rs:
                rows = np.asarray(rs, dtype=np.int64)
                cols = np.asarray(cs, dtype=np.int64)
                if strict:
                    codes_seen.append(rows * np.int64(n) + cols)
                    lines_seen.append(np.asarray(ls, dtype=np.int64))
                yield rows, cols, np.asarray(vs, dtype=np.float64)
            if strict and codes_seen:
                # Same vectorized duplicate scan as read_dat, over the
                # accumulated codes (O(nnz) ints — the coordinates a
                # consumer holds anyway; never the file text or an n^2
                # buffer).
                codes = np.concatenate(codes_seen)
                srclines = np.concatenate(lines_seen)
                order = np.argsort(codes, kind="stable")
                dup = np.nonzero(np.diff(codes[order]) == 0)[0]
                if dup.size:
                    i1, i2 = order[dup[0]], order[dup[0] + 1]
                    code = int(codes[i2])
                    raise DatFormatError(
                        f"duplicate .dat entry ({code // n + 1}, "
                        f"{code % n + 1}) (first at line {srclines[i1]}); "
                        f"the reference's last-wins overwrite is available "
                        f"via strict=False", line=int(srclines[i2]))
        finally:
            self._finish()


def iter_coords(path_or_file: PathOrFile, strict: bool = True,
                chunk: int = 65536) -> CoordStream:
    """Open a ``.dat`` file for streaming: returns a :class:`CoordStream`
    whose ``.n`` / ``.declared_nnz`` come from the header immediately and
    whose iteration yields 0-indexed ``(rows, cols, vals)`` chunks with
    :func:`read_dat`'s validation applied line by line."""
    return CoordStream(path_or_file, strict=strict, chunk=chunk)


def densify(n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
            dtype=np.float64) -> np.ndarray:
    """Scatter coordinate entries into a dense row-major n x n array."""
    dense = np.zeros((n, n), dtype=dtype)
    dense[rows, cols] = vals
    return dense


def read_dat_dense(path_or_file: PathOrFile, dtype=np.float64,
                   engine: str = "auto", strict: bool = True) -> np.ndarray:
    """Parse + densify in one step (the external-input programs' initMatrix).

    engine: "python", "native" (the C++ parser of
    :mod:`gauss_tpu_torch.native`), or "auto" — native when the input is a
    real file path AND ``strict`` is off; python otherwise. The native
    parser has no per-line validation (its output gets only a whole-matrix
    finite check — no line numbers, no duplicate/terminator detection), so
    the strict default routes "auto" through the fully-checked python
    parser. Unlike the JAX package, a native build that fails raises
    (``native.NativeBuildError``) instead of quietly taking the python
    parser; only ``GAUSS_TPU_NO_NATIVE`` sends "auto" to the python parser.
    """
    is_path = not (hasattr(path_or_file, "read"))
    if engine not in ("auto", "python", "native"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "native" and not is_path:
        raise ValueError("engine='native' requires a file path, not a file "
                         "object")
    if (engine == "native" or (engine == "auto" and not strict)) and is_path:
        from gauss_tpu_torch import native

        if engine == "native" or native.available():
            try:
                dense = native.read_dat_dense(
                    os.fspath(path_or_file)).astype(dtype, copy=False)
                if strict and not np.isfinite(dense).all():
                    raise DatFormatError(
                        f"non-finite value(s) in "
                        f"{os.fspath(path_or_file)!r} (native parser; "
                        f"re-read with engine='python' for the offending "
                        f"line)")
                return dense
            except ValueError:
                # A file the native parser rejects: "auto" re-reads it
                # with the python parser, which names the bad line.
                if engine == "native":
                    raise
    n, rows, cols, vals = read_dat(path_or_file, strict=strict)
    return densify(n, rows, cols, vals, dtype=dtype)


def write_dat(path_or_file: PathOrFile, matrix: np.ndarray = None, *,
              n: int = None, rows=None, cols=None, vals=None,
              column_major: bool = True, terminator: bool = True,
              drop_zeros: bool = False) -> None:
    """Write a matrix in .dat coordinate format (1-indexed, `0 0 0` terminator).

    With a dense ``matrix``, every entry is emitted (optionally skipping exact
    zeros) in column-major order by default — matching matrix_gen.cc's emission
    order (matrix_gen.cc:15-19). Alternatively pass explicit coordinate arrays.
    """
    if matrix is not None:
        matrix = np.asarray(matrix)
        n = matrix.shape[0]
        if matrix.shape != (n, n):
            raise ValueError("write_dat expects a square matrix")
        if column_major:
            cc, rr = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
            rows, cols = rr.ravel(), cc.ravel()
        else:
            rr, cc = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
            rows, cols = rr.ravel(), cc.ravel()
        vals = matrix[rows, cols]
        if drop_zeros:
            keep = vals != 0
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
    else:
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if n is None:
            raise ValueError("n is required when writing coordinate arrays")

    f, close = _open_maybe(path_or_file, "w")
    try:
        buf = _io.StringIO()
        buf.write(f"{n} {n} {len(vals)}\n")
        for r, c, v in zip(rows, cols, vals):
            # 17 significant digits: exact float64 round trip.
            buf.write(f"{int(r) + 1} {int(c) + 1} {v:.17g}\n")
        if terminator:
            buf.write("0 0 0\n")
        f.write(buf.getvalue())
    finally:
        if close:
            f.close()

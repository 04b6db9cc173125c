"""The port's numpy-side sparse modules against the JAX package's: the
``CsrMatrix`` container (arrays byte-equal on the same coordinates), the
structure detector, the ``.dat`` coordinate stream, and the seeds and
typed errors that landed with the sparse plane."""

import io

import numpy as np
import pytest

from gauss_tpu.io import synthetic as jsyn
from gauss_tpu.sparse.csr import CsrMatrix as JCsr
from gauss_tpu.structure import detect as jdet
from gauss_tpu.tune import space as jspace
from gauss_tpu_torch.io import datfile, synthetic
from gauss_tpu_torch.sparse.csr import CsrMatrix
from gauss_tpu_torch.structure import detect
from gauss_tpu_torch.structure.cholesky import NotSPDError
from gauss_tpu_torch.tune import space


def _coords(n, nnz_per_row, seed, symmetric=True):
    return synthetic.sparse_coords(n, nnz_per_row, seed=seed,
                                   symmetric=symmetric)


def _messy_coords(n=90, seed=5):
    """Coordinates with duplicates (summed), explicit zeros (dropped) and
    a pair that cancels to zero (dropped)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, 600)
    cols = rng.integers(0, n, 600)
    vals = rng.standard_normal(600)
    vals[::7] = 0.0
    rows = np.concatenate([rows, [3, 3]])
    cols = np.concatenate([cols, [4, 4]])
    vals = np.concatenate([vals, [2.5, -2.5]])
    return n, rows, cols, vals


def _same_csr(a, j):
    assert a.n == j.n
    for name in ("indptr", "indices", "data"):
        x, y = getattr(a, name), getattr(j, name)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("n,k,seed,sym", [(200, 6, 1, True),
                                          (150, 5, 2, False),
                                          (640, 6, 258458, True),
                                          (1, 3, 0, True)])
def test_csr_byte_equal_on_generator_coords(n, k, seed, sym):
    rows, cols, vals = _coords(n, k, seed, sym)
    jr, jc, jv = jsyn.sparse_coords(n, k, seed=seed, symmetric=sym)
    assert np.array_equal(rows, jr) and np.array_equal(vals, jv)
    a = CsrMatrix.from_coords(n, rows, cols, vals)
    j = JCsr.from_coords(n, jr, jc, jv)
    _same_csr(a, j)
    assert a.nnz == j.nnz and a.max_row_nnz == j.max_row_nnz
    assert a.density == j.density
    assert a.gershgorin_spd() == j.gershgorin_spd() == sym
    assert a.is_symmetric() == j.is_symmetric()
    assert a.diagonal().tobytes() == j.diagonal().tobytes()


@pytest.mark.parametrize("drop_zeros", [True, False])
def test_csr_duplicates_zeros_and_staging_forms(drop_zeros):
    n, rows, cols, vals = _messy_coords()
    a = CsrMatrix.from_coords(n, rows, cols, vals, drop_zeros=drop_zeros)
    j = JCsr.from_coords(n, rows, cols, vals, drop_zeros=drop_zeros)
    _same_csr(a, j)
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    np.testing.assert_allclose(a.to_dense(), dense, rtol=0, atol=1e-15)
    if drop_zeros:
        assert (a.data != 0).all() and a.to_dense()[3, 4] == dense[3, 4]
    for got, want in zip(a.ell(), j.ell()):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for got, want in zip(a.coo(), j.coo()):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    x = np.random.default_rng(0).standard_normal((n, 3))
    # Host matvec, 1-D and (n, m): float64 sums in a fixed order.
    assert a.matvec(x).tobytes() == j.matvec(x).tobytes()
    np.testing.assert_allclose(a.matvec(x[:, 0]), dense @ x[:, 0],
                               rtol=1e-12, atol=1e-13)


def test_csr_from_dense_chunks_and_limits():
    rng = np.random.default_rng(3)
    d = rng.standard_normal((12, 12)) * (rng.random((12, 12)) < 0.3)
    a = CsrMatrix.from_dense(d)
    _same_csr(a, JCsr.from_dense(d))
    assert np.array_equal(a.to_dense(), d)
    rows, cols, vals = a.coo()
    b = CsrMatrix.from_coord_chunks(
        12, [(rows[:5], cols[:5], vals[:5]), (rows[5:], cols[5:], vals[5:])])
    _same_csr(a, b)
    assert CsrMatrix.from_coord_chunks(4, []).nnz == 0
    with pytest.raises(ValueError, match="out of range"):
        CsrMatrix.from_coords(4, [0, 4], [0, 1], [1.0, 2.0])
    with pytest.raises(ValueError, match="identical shapes"):
        CsrMatrix.from_coords(4, [0], [0, 1], [1.0, 2.0])
    with pytest.raises(ValueError, match="square"):
        CsrMatrix.from_dense(np.zeros((3, 4)))
    big = CsrMatrix.from_coords(9000, [0], [0], [1.0])
    with pytest.raises(ValueError, match="refusing to densify"):
        big.to_dense()
    empty_row = CsrMatrix.from_coords(3, [0, 2], [0, 2], [1.0, 2.0])
    cols_e, vals_e = empty_row.ell()
    assert cols_e.shape == (3, 1) and vals_e[1, 0] == 0.0


@pytest.mark.parametrize("strict", [True, False])
def test_csr_from_dat_round_trip(strict, tmp_path):
    n = 120
    rows, cols, vals = _coords(n, 5, 4)
    path = tmp_path / "sparse.dat"
    datfile.write_dat(str(path), n=n, rows=rows, cols=cols, vals=vals)
    a = CsrMatrix.from_dat(str(path), strict=strict)
    _same_csr(a, CsrMatrix.from_coords(n, rows, cols, vals))
    _same_csr(a, JCsr.from_dat(str(path), strict=strict))
    info = detect.detect_structure_dat(str(path))
    assert info == detect.detect_structure_coords(n, rows, cols, vals)


def test_csr_from_dat_duplicates_sum_or_raise():
    text = "3 3 4\n1 1 2.0\n1 1 3.0\n2 2 1.0\n3 3 1.0\n0 0 0\n"
    a = CsrMatrix.from_dat(io.StringIO(text))
    assert a.to_dense()[0, 0] == 5.0
    with pytest.raises(datfile.DatFormatError, match="duplicate"):
        CsrMatrix.from_dat(io.StringIO(text), strict=True)


@pytest.mark.parametrize("make", [
    lambda: synthetic.sparse_matrix(300, 6, seed=2),
    lambda: synthetic.sparse_matrix(300, 6, seed=2, symmetric=False),
    lambda: synthetic.spd_matrix(40),
    lambda: synthetic.banded_matrix(64, 2),
    lambda: synthetic.blockdiag_matrix(64, 16),
    lambda: synthetic.dense_matrix(40),
    lambda: np.zeros((5, 5)),
    lambda: np.zeros((0, 0)),
])
def test_detect_structure_matches_jax_package(make):
    a = make()
    got, want = detect.detect_structure(a), jdet.detect_structure(a)
    assert got.kind == want.kind == detect.structure_tag(a)
    for f in ("n", "symmetric", "spd_likely", "bandwidth", "blocks",
              "density"):
        assert getattr(got, f) == getattr(want, f), f
    rows, cols = np.nonzero(a)
    coords = detect.detect_structure_coords(a.shape[0], rows, cols,
                                            a[rows, cols])
    assert coords == got


def test_seeds_and_typed_errors_match_jax_package():
    for name in ("SPARSE_RESTART_SEED", "SPARSE_BLOCK_SEED",
                 "SPARSE_DENSITY_SEED"):
        assert getattr(space, name) == getattr(jspace, name)
    assert detect.SPARSE_MAX_DENSITY == jdet.SPARSE_MAX_DENSITY
    assert detect.STRUCTURE_KINDS == jdet.STRUCTURE_KINDS
    assert detect.SPARSE_MIN_N == jdet.SPARSE_MIN_N
    assert issubclass(detect.StructureMismatchError, RuntimeError)
    err = NotSPDError("no", min_diag=-1.5)
    assert isinstance(err, RuntimeError) and err.min_diag == -1.5
    with pytest.raises(ValueError, match="square"):
        detect.detect_structure(np.zeros((2, 3)))

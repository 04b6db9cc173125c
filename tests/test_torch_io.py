"""The port's .dat I/O, synthetic generators and checks against the JAX
package's: byte-equal arrays and text, the same typed strict-mode rejects."""

import io

import numpy as np
import pytest

from gauss_tpu.io import datfile as jdat
from gauss_tpu.io import synthetic as jsyn
from gauss_tpu.verify import checks as jchecks
from gauss_tpu_torch.io import datfile as tdat
from gauss_tpu_torch.io import synthetic as tsyn
from gauss_tpu_torch.verify import checks as tchecks


def _same_bytes(x, y):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape
    assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("n", [1, 17, 64])
@pytest.mark.parametrize("name", [
    "internal_matrix", "internal_rhs", "internal_expected_solution",
    "generator_matrix", "manufactured_solution", "spd_matrix",
    "banded_matrix", "blockdiag_matrix", "dense_matrix", "sparse_matrix"])
def test_generators_byte_equal(name, n):
    _same_bytes(getattr(tsyn, name)(n), getattr(jsyn, name)(n))


def test_sparse_coords_and_manufactured_rhs_byte_equal():
    for got, want in zip(tsyn.sparse_coords(50, seed=3),
                         jsyn.sparse_coords(50, seed=3)):
        _same_bytes(got, want)
    a = jsyn.dense_matrix(33)
    _same_bytes(tsyn.manufactured_rhs(a), jsyn.manufactured_rhs(a))


@pytest.mark.parametrize("kwargs", [{}, {"column_major": False},
                                    {"drop_zeros": True},
                                    {"terminator": False}])
def test_write_dat_text_identical(rng, kwargs):
    a = rng.standard_normal((9, 9))
    a[a < -0.5] = 0.0
    fa, fb = io.StringIO(), io.StringIO()
    tdat.write_dat(fa, a, **kwargs)
    jdat.write_dat(fb, a, **kwargs)
    assert fa.getvalue() == fb.getvalue()


@pytest.mark.parametrize("gen", ["generator_matrix", "random"])
def test_read_dat_dense_round_trip_byte_equal(tmp_path, rng, gen):
    a = (tsyn.generator_matrix(40) if gen == "generator_matrix"
         else rng.standard_normal((40, 40)))
    path = tmp_path / "m.dat"
    tdat.write_dat(path, a)
    got = tdat.read_dat_dense(path)
    _same_bytes(got, jdat.read_dat_dense(path, engine="python"))
    _same_bytes(got, a.astype(np.float64))


@pytest.mark.parametrize("text,line", [
    ("2 2 2\n1 1 1.0\n2 2 nan\n0 0 0\n", 3),        # non-finite value
    ("2 2 2\n1 1 1.0\n1 1 2.0\n0 0 0\n", 3),        # duplicate coordinate
    ("2 2 2\n1 1 1.0\n2 2 2.0\n", 3),               # missing terminator
    ("2 3 1\n1 1 1.0\n0 0 0\n", 1),                 # non-square header
    ("x 2 1\n1 1 1.0\n0 0 0\n", 1),                 # malformed header
    ("2 2 1\n3 1 1.0\n0 0 0\n", 2),                 # out of bounds
    ("2 2 2\n1 1 1.0\n0 0 0\n", 3),                 # count mismatch
])
def test_strict_rejects_same_typed_error(text, line):
    with pytest.raises(tdat.DatFormatError) as got:
        tdat.read_dat_dense(io.StringIO(text))
    with pytest.raises(jdat.DatFormatError) as want:
        jdat.read_dat_dense(io.StringIO(text))
    assert got.value.line == want.value.line == line
    assert str(got.value) == str(want.value)


def test_tolerant_mode_matches_reference_semantics():
    text = "2 2 2\n1 1 1.0\n1 1 2.0\n"  # duplicate, no terminator
    _same_bytes(tdat.read_dat_dense(io.StringIO(text), strict=False),
                jdat.read_dat_dense(io.StringIO(text), strict=False))


def test_iter_coords_chunks_byte_equal(tmp_path, rng):
    path = tmp_path / "m.dat"
    tdat.write_dat(path, rng.standard_normal((12, 12)), drop_zeros=True)
    got = list(tdat.iter_coords(path, chunk=17))
    want = list(jdat.iter_coords(path, chunk=17))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            _same_bytes(x, y)


def test_native_engine_refused(tmp_path):
    """The C++ parser (once refused) reads a file path to the JAX native
    parser's bits; a file object is still refused for it, as in the JAX
    package."""
    from gauss_tpu import native as jnative

    with pytest.raises(ValueError, match="native"):
        tdat.read_dat_dense(io.StringIO("1 1 1\n1 1 1.0\n0 0 0\n"),
                            engine="native")
    path = tmp_path / "m.dat"
    path.write_text("2 2 3\n1 1 1.5\n2 1 -2.25\n2 2 1e-3\n0 0 0\n")
    got = tdat.read_dat_dense(str(path), engine="native")
    assert got.tobytes() == jnative.read_dat_dense(str(path)).tobytes()
    assert got.tobytes() == tdat.read_dat_dense(str(path)).tobytes()


def test_checks_identical(rng):
    x = rng.standard_normal(20)
    y = x + 1e-5 * rng.standard_normal(20)
    a = rng.standard_normal((20, 20))
    b = rng.standard_normal(20)
    assert tchecks.max_rel_error(x, y) == jchecks.max_rel_error(x, y)
    assert tchecks.residual_norm(a, x, b) == jchecks.residual_norm(a, x, b)
    assert (tchecks.residual_norm(a, x, b, relative=True)
            == jchecks.residual_norm(a, x, b, relative=True))
    assert tchecks.elementwise_match(x, y) == jchecks.elementwise_match(x, y)
    pattern = tsyn.internal_expected_solution(8)
    assert tchecks.internal_pattern_ok(pattern)
    assert not tchecks.internal_pattern_ok(pattern + 1e-3)

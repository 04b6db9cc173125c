"""The port's native C++ runtime (``gauss_tpu_torch.native``: its own copy
of the JAX package's sources, built with the same flags into a build
directory of its own) against the JAX package's library on the same
seeded inputs: every gauss and matmul engine, the .dat parser and the
``matrix_gen`` tool return EQUAL bits (same source, same flags). A failed
build raises with make's stderr, and ``GAUSS_TPU_NO_NATIVE`` refuses. The
CLIs' native backends print the JAX CLIs' stdout lines."""

import io
import re
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from gauss_tpu_torch import native as tnative
from gauss_tpu_torch.io import datfile as tdat

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jnative():
    from gauss_tpu import native

    assert native.available()
    return native


def _system(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)), rng.standard_normal(n)


@pytest.mark.parametrize("engine", tnative.GAUSS_ENGINES)
@pytest.mark.parametrize("n,threads", [(1, 0), (37, 3), (128, 0)])
def test_gauss_engines_equal_the_jax_library(jnative, engine, n, threads):
    a, b = _system(n, seed=n)
    a0, b0 = a.copy(), b.copy()
    got = tnative.gauss_solve(a, b, engine=engine, nthreads=threads)
    want = jnative.gauss_solve(a, b, engine=engine, nthreads=threads)
    assert got.tobytes() == want.tobytes()
    assert np.array_equal(a, a0) and np.array_equal(b, b0)  # not modified
    np.testing.assert_allclose(a @ got, b, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("engine", tnative.GAUSS_ENGINES)
def test_singular_raises_like_jax(jnative, engine):
    a = np.ones((6, 6))
    b = np.ones(6)
    for lib in (tnative, jnative):
        with pytest.raises(np.linalg.LinAlgError):
            lib.gauss_solve(a, b, engine=engine)


@pytest.mark.parametrize("engine", tnative.MATMUL_ENGINES)
@pytest.mark.parametrize("n", [1, 33, 96])
def test_matmul_engines_equal_the_jax_library(jnative, engine, n):
    rng = np.random.default_rng(n)
    a, b = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    got = tnative.matmul(a, b, engine=engine, nthreads=2)
    assert got.tobytes() == jnative.matmul(a, b, engine=engine,
                                           nthreads=2).tobytes()
    np.testing.assert_allclose(got, a @ b, rtol=1e-12, atol=1e-12)


def test_bad_arguments_refused():
    with pytest.raises(ValueError, match="unknown native gauss engine"):
        tnative.gauss_solve(np.eye(2), np.ones(2), engine="mpi")
    with pytest.raises(ValueError, match="unknown native matmul engine"):
        tnative.matmul(np.eye(2), np.eye(2), engine="threads")
    with pytest.raises(ValueError, match="square"):
        tnative.gauss_solve(np.ones((2, 3)), np.ones(2))


def test_dat_parser_equals_the_jax_library(jnative, tmp_path):
    from gauss_tpu.io import datfile as jdat

    path = tmp_path / "m.dat"
    rng = np.random.default_rng(3)
    m = rng.standard_normal((9, 9))
    m[m < 0.3] = 0
    tdat.write_dat(str(path), m, drop_zeros=True)
    assert tnative.read_dat_header(str(path)) == \
        jnative.read_dat_header(str(path))
    got = tnative.read_dat_dense(str(path))
    assert got.tobytes() == jnative.read_dat_dense(str(path)).tobytes()
    # "auto" takes the native parser for strict=False on a path, as in
    # the JAX package, with the same bits; the strict default parses in
    # python.
    for strict in (False, True):
        t = tdat.read_dat_dense(str(path), strict=strict)
        j = jdat.read_dat_dense(str(path), strict=strict)
        assert t.tobytes() == j.tobytes() == got.tobytes()
    bad = tmp_path / "bad.dat"
    bad.write_text("not a header\n")
    with pytest.raises(ValueError):
        tnative.read_dat_header(str(bad))


def test_matrix_gen_tool_bytes(jnative, tmp_path):
    """The port's tool, the JAX package's tool and the Python writer emit
    the same bytes."""
    gen = tnative.matrix_gen_path()
    assert Path(gen).parent == tnative.build_dir()
    assert tnative.SRC_DIR not in Path(gen).parents
    got = subprocess.run([gen, "7"], capture_output=True).stdout
    want = subprocess.run([jnative.matrix_gen_path(), "7"],
                          capture_output=True).stdout
    buf = io.StringIO()
    from gauss_tpu_torch.io import synthetic

    tdat.write_dat(buf, synthetic.generator_matrix(7))
    assert got == want == buf.getvalue().encode()
    assert subprocess.run([gen], capture_output=True).returncode == 1


def test_failed_build_raises_with_make_stderr(tmp_path, monkeypatch):
    src = tmp_path / "src"
    shutil.copytree(tnative.SRC_DIR, src)
    (src / "gauss_native.cc").write_text("this is not C++ ;\n")
    monkeypatch.setattr(tnative, "SRC_DIR", src)
    with pytest.raises(tnative.NativeBuildError, match="make rc") as ei:
        tnative.build(tmp_path / "out")
    assert "gauss_native.cc" in str(ei.value)   # make's stderr rides along


def test_no_native_is_an_explicit_refusal(monkeypatch, tmp_path):
    monkeypatch.setenv("GAUSS_TPU_NO_NATIVE", "1")
    assert tnative.available() is False
    with pytest.raises(tnative.NativeRefusedError):
        tnative.gauss_solve(np.eye(2), np.ones(2))
    path = tmp_path / "m.dat"
    path.write_text("1 1 1\n1 1 2.0\n0 0 0\n")
    with pytest.raises(tnative.NativeRefusedError):
        tdat.read_dat_dense(str(path), engine="native")
    # "auto" under the refusal reads with the python parser.
    assert tdat.read_dat_dense(str(path), strict=False).tolist() == [[2.0]]


def test_build_dir_is_outside_the_sources(tmp_path):
    secs = tnative.build(tmp_path / "fresh")
    assert secs > 0
    assert (tmp_path / "fresh" / "libgauss_native.so").is_file()
    assert (tmp_path / "fresh" / "matrix_gen").is_file()
    assert not list(tnative.SRC_DIR.glob("*.so"))


# --- the CLIs' native backends ------------------------------------------

def _cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _masked(out: str) -> list:
    return [re.sub(r"[-+]?\d+\.\d+(e[-+]\d+)?", "#", line)
            for line in out.strip().splitlines()]


@pytest.mark.parametrize("engine", tnative.GAUSS_ENGINES)
def test_internal_cli_native_backends_print_the_jax_lines(engine):
    from gauss_tpu.cli import gauss_internal as jcli
    from gauss_tpu_torch.cli import gauss_internal as tcli

    argv = ["-s", "64", "-t", "2", "--verify", "--backend", engine]
    rc_j, out_j = _cli(jcli.main, argv)
    rc_t, out_t = _cli(tcli.main, argv + ["--device", "cpu"])
    assert rc_j == rc_t == 0
    assert _masked(out_t) == _masked(out_j)
    # The residual line: the same engine, the same bits.
    assert out_t.strip().splitlines()[-1] == out_j.strip().splitlines()[-1]


@pytest.mark.parametrize("engine", ["seq", "tiled"])
def test_external_cli_native_backends(engine, tmp_path):
    from gauss_tpu.cli import gauss_external as jcli
    from gauss_tpu_torch.cli import gauss_external as tcli
    from gauss_tpu_torch.io import synthetic

    path = tmp_path / "g.dat"
    tdat.write_dat(str(path), synthetic.generator_matrix(40))
    argv = [str(path), "2", "--backend", engine]
    rc_j, out_j = _cli(jcli.main, argv)
    rc_t, out_t = _cli(tcli.main, argv + ["--device", "cpu"])
    assert rc_j == rc_t == 0
    assert _masked(out_t) == _masked(out_j)
    assert out_t.strip().splitlines()[-1] == out_j.strip().splitlines()[-1]
    sing = tmp_path / "s.dat"
    tdat.write_dat(str(sing), np.ones((4, 4)))
    assert _cli(tcli.main, [str(sing), "--backend", engine,
                            "--device", "cpu"])[0] == 1


def test_matmul_cli_native_engines_match_jax_lines():
    from gauss_tpu.cli import matmul as jcli
    from gauss_tpu_torch.cli import matmul as tcli

    rc_j, out_j = _cli(jcli.main, ["48", "--engines", "seq,omp"])
    rc_t, out_t = _cli(tcli.main, ["48", "--engines", "seq,omp",
                                   "--device", "cpu"])
    assert rc_j == rc_t == 0
    assert _masked(out_t) == _masked(out_j)


def test_matrix_gen_cli_uses_the_native_tool(tmp_path):
    r = subprocess.run([sys.executable, "-m", "gauss_tpu_torch.cli.matrix_gen",
                        "5"], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0
    assert r.stdout.splitlines()[0] == "5 5 25"
    assert r.stdout.splitlines()[-1] == "0 0 0"

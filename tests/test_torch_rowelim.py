"""The port's row-elimination kernels (6: one pivot step, 7: the rank-k
update) and solve drivers against the JAX package's ``rowelim_pallas``
(interpret mode on the CPU), the ``cuda-rowelim`` / ``cuda-rowelim-step``
CLI backends, and the CUDA kernels against their plain versions on the
card."""

import importlib
import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu_torch.io import datfile, synthetic
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.kernels import rowelim as tre
from gauss_tpu_torch.verify import checks

jre = importlib.import_module("gauss_tpu.kernels.rowelim_pallas")

BM, BN = 32, 64  # small tiles: several tiles per axis at n <= 128
# Step kernel vs JAX, relative to max |m| + max |f| max |prow|: XLA:CPU
# contracts m - f*prow into one FMA where the port rounds the product
# first, one rounding of the product apart (measured <= 6.6e-8 here).
STEP_TOL = 1e-6
# Whole solves, max |x_port - x_jax| / max |x_jax|, in units of
# cond(A) * eps32: the same pivots, and rounding that differs per step as
# above, which the system's condition amplifies (measured <= 0.62 on these
# random systems, condition 46 to 2.1e3).
SOLVE_TOL_PER_COND = 4.0
EPS32 = float(np.finfo(np.float32).eps)


def _close(got, want, a):
    tol = SOLVE_TOL_PER_COND * np.linalg.cond(a.astype(np.float64)) * EPS32
    return np.abs(got - want).max() <= tol * np.abs(want).max()


def _system(n, seed=258458):
    rng = np.random.default_rng(seed + n)
    return (rng.standard_normal((n, n)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _augmented(n, width_tile):
    """A padded augmented matrix as the drivers build it: rows to BM,
    width past the RHS column to ``width_tile``."""
    a, b = _system(n)
    npad = -(-n // BM) * BM
    wpad = -(-(npad + 1) // width_tile) * width_tile
    return tre._augmented(torch.from_numpy(a), torch.from_numpy(b), npad,
                          wpad).numpy()


@pytest.mark.parametrize("n,i", [(90, 0), (90, 17), (90, 63), (90, 95),
                                 (64, 40)])
def test_step_plain_matches_jax(n, i):
    m = _augmented(n, BN)  # (96, 128) at n=90: pad rows and pad columns
    want = np.asarray(jre.eliminate_step_pallas(jnp.asarray(m), i, bm=BM,
                                                bn=BN))
    got = tre.eliminate_step(torch.from_numpy(m), i).numpy()
    scale = np.abs(m).max() + np.abs(m[:, i]).max() * np.abs(
        m[i] / m[i, i]).max()
    assert np.abs(got - want).max() <= STEP_TOL * scale
    assert np.all(got[i, :i] == want[i, :i]) and got[i, i] == 1.0
    assert np.all(got[i + 1:, i] == 0.0)


def test_step_zero_pivot_poisons_like_jax():
    """A zero pivot: the scaled pivot row is inf/NaN, and every row,
    including those above the pivot (0 * inf), follows JAX's NaN/inf
    pattern."""
    m = _augmented(40, BN)
    i = 5
    m[i, i] = 0.0
    want = np.asarray(jre.eliminate_step_pallas(jnp.asarray(m), i, bm=BM,
                                                bn=BN))
    got = tre.eliminate_step(torch.from_numpy(m), i).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isnan(got[:i]).any()


@pytest.mark.parametrize("rows,cols,k", [(96, 128, 32), (64, 64, 17),
                                         (32, 192, 1)])
def test_rankk_plain_matches_jax(rows, cols, k):
    rng = np.random.default_rng(7)
    m = rng.standard_normal((rows, cols)).astype(np.float32)
    f = rng.standard_normal((rows, k)).astype(np.float32)
    u = rng.standard_normal((k, cols)).astype(np.float32)
    want = np.asarray(jre.rankk_update_pallas(
        jnp.asarray(m), jnp.asarray(f), jnp.asarray(u), bm=BM, bn=BN))
    got = tre.rankk_update(torch.from_numpy(m), torch.from_numpy(f),
                           torch.from_numpy(u)).numpy()
    # f32 summation order over k <= 32 terms: measured 0 at k = 32 and 17,
    # 1.1e-7 (one rounding) at k = 1.
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("n", [32, 100, 128])
def test_step_solve_matches_jax(n):
    a, b = _system(n)
    want = np.asarray(jre.gauss_solve_rowelim(jnp.asarray(a), jnp.asarray(b),
                                              bm=BM, bn=BN))
    got = tre.gauss_solve_rowelim(a, b, bm=BM, bn=BN, device="cpu").numpy()
    assert got.shape == (n,) and _close(got, want, a)
    assert checks.residual_norm(a.astype(np.float64), got,
                                b.astype(np.float64)) < 1e-3


@pytest.mark.parametrize("k", [16, 32])
@pytest.mark.parametrize("n", [32, 100, 128])
def test_batched_solve_matches_jax(n, k):
    a, b = _system(n)
    want = np.asarray(jre.gauss_solve_rowelim_batched(
        jnp.asarray(a), jnp.asarray(b), k=k, bm=BM, bn=BN))
    got = tre.gauss_solve_rowelim_batched(a, b, k=k, bm=BM, bn=BN,
                                          device="cpu").numpy()
    assert got.shape == (n,) and _close(got, want, a)


@pytest.mark.parametrize("batched", [False, True])
def test_internal_all_ties_pattern(batched):
    """The min matrix ties in every column: pivots follow jnp.argmax's
    first-max rule on both sides, and both give the closed-form answer."""
    n = 100
    a = synthetic.internal_matrix(n).astype(np.float32)
    b = synthetic.internal_rhs(n).astype(np.float32)
    if batched:
        want = jre.gauss_solve_rowelim_batched(jnp.asarray(a), jnp.asarray(b),
                                               k=16, bm=BM, bn=BN)
        got = tre.gauss_solve_rowelim_batched(a, b, k=16, bm=BM, bn=BN,
                                              device="cpu")
    else:
        want = jre.gauss_solve_rowelim(jnp.asarray(a), jnp.asarray(b), bm=BM,
                                       bn=BN)
        got = tre.gauss_solve_rowelim(a, b, bm=BM, bn=BN, device="cpu")
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert checks.internal_pattern_ok(got, atol=1e-4)
    assert checks.internal_pattern_ok(want, atol=1e-4)
    assert np.abs(got - want).max() <= 1e-5


def test_batched_matches_step_form():
    a, b = _system(64)
    xs = tre.gauss_solve_rowelim(a, b, bm=BM, bn=BN, device="cpu").numpy()
    xb = tre.gauss_solve_rowelim_batched(a, b, k=16, bm=BM, bn=BN,
                                         device="cpu").numpy()
    assert _close(xb, xs, a)


def _batched_whole_strip(a, b, k, bm=BM, bn=BN):
    """The batched driver as the JAX package walks it: each group factors
    the whole (npad, k) strip with the rows above kb marked done and
    permutes every row. The port's driver factors only the live rows."""
    from gauss_tpu_torch.core.blocked import unit_lower_inv, upper_inv
    from gauss_tpu_torch.kernels.panel import panel_factor

    a, b, n = tre._staged(a, b, "cpu")
    dt = a.dtype
    npad = -(-n // max(bm, k)) * max(bm, k)
    wpad = -(-(npad + 1) // bn) * bn
    m = tre._augmented(a, b, npad, wpad)
    rows, cols, jcol = (torch.arange(x) for x in (npad, wpad, k))
    zero = torch.zeros((), dtype=dt)
    eye_k = torch.eye(k, dtype=dt)
    upper = jcol[:, None] < jcol[None, :]
    uinvs = []
    for kb in range(0, npad, k):
        p, _, perm_local, _ = panel_factor(m[:, kb:kb + k], kb)
        m = m[perm_local]
        dblk = p[kb:kb + k]
        linv = unit_lower_inv(torch.tril(dblk, -1) + eye_k)
        d = torch.diagonal(dblk)
        u12 = torch.matmul(linv, m[kb:kb + k])
        f = torch.where((rows >= kb + k)[:, None], p, zero)
        right = (cols >= kb + k)[None, :]
        m = tre.rankk_update(m, f, torch.where(right, u12, zero))
        inv_d = torch.reciprocal(d)[:, None]
        new_block = torch.where(right, u12 * inv_d, zero)
        pan = torch.where(upper, u12[:, kb:kb + k] * inv_d, zero) + eye_k
        new_block[:, kb:kb + k] = pan
        m[kb:kb + k] = new_block
        m[kb + k:, kb:kb + k] = 0.0
        uinvs.append(upper_inv(pan))
    x = torch.zeros(npad, dtype=dt)
    for g in range(len(uinvs) - 1, -1, -1):
        blk_rows = m[g * k:(g + 1) * k]
        r = blk_rows[:, npad] - torch.matmul(blk_rows[:, :npad], x)
        x[g * k:(g + 1) * k] = torch.matmul(uinvs[g], r)
    return x[:n]


@pytest.mark.parametrize("system", ["random", "internal_ties", "nan_entry"])
def test_batched_live_rows_match_whole_strip(system):
    """Factoring only the live rows gives the whole-strip form's solution
    bit for bit, ties and NaN included."""
    n, k = 100, 16
    if system == "internal_ties":
        a = synthetic.internal_matrix(n).astype(np.float32)
        b = synthetic.internal_rhs(n).astype(np.float32)
    else:
        a, b = _system(n)
        if system == "nan_entry":
            a[37, 52] = np.nan
    got = tre.gauss_solve_rowelim_batched(a, b, k=k, bm=BM, bn=BN,
                                          device="cpu").numpy()
    want = _batched_whole_strip(a, b, k).numpy()
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()
    assert np.isnan(got).any() == (system == "nan_entry")


@pytest.mark.parametrize("n", [512, 2048, 4096, 16384, 30000, 40000])
def test_auto_rowelim_k_matches_jax(n):
    assert tre.auto_rowelim_k(n) == jre.auto_rowelim_k(n)


def test_padding_constants_match_jax():
    from gauss_tpu.tune.space import ROWELIM_TILE_SEED

    assert tre.ROWELIM_TILE_SEED == ROWELIM_TILE_SEED
    assert (tre.DEFAULT_BM, tre.DEFAULT_BN) == (jre.DEFAULT_BM,
                                                jre.DEFAULT_BN)


def test_bad_arguments_raise():
    a, b = _system(40)
    with pytest.raises(ValueError, match="nest"):
        tre.gauss_solve_rowelim_batched(a, b, k=48, bm=32, device="cpu")
    with pytest.raises(ValueError, match="pivot"):
        tre.eliminate_step(torch.zeros(8, 16), 8)
    with pytest.raises(ValueError, match="pivot"):
        tre.eliminate_step(torch.zeros(8), 0)
    with pytest.raises(ValueError, match="m - f @ u"):
        tre.rankk_update(torch.zeros(8, 16), torch.zeros(8, 4),
                         torch.zeros(5, 16))
    with pytest.raises(ValueError, match="square"):
        tre.gauss_solve_rowelim(np.zeros((4, 5)), np.zeros(4), device="cpu")


def test_cpu_tensors_run_plain_without_launch():
    _build.reset_launches()
    a, b = _system(40)
    tre.gauss_solve_rowelim(a, b, bm=BM, bn=BN, device="cpu")
    tre.gauss_solve_rowelim_batched(a, b, k=16, bm=BM, bn=BN, device="cpu")
    assert all(v == 0 for v in _build.LAUNCHES.values())


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("backend", ["cuda-rowelim", "cuda-rowelim-step"])
def test_internal_cli_backends_verify(backend):
    from gauss_tpu_torch.cli import gauss_internal

    rc, out = _run(gauss_internal.main, ["-s", "128", "--backend", backend,
                                         "--verify", "--device", "cpu"])
    assert rc == 0
    assert "Verification: solution pattern (-0.5, 0...0, 0.5) OK" in out
    assert f"backend {backend}" in out


def test_external_cli_rowelim(tmp_path):
    from gauss_tpu_torch.cli import gauss_external

    path = tmp_path / "gen.dat"
    datfile.write_dat(path, synthetic.generator_matrix(72))
    rc, out = _run(gauss_external.main, [str(path), "--backend",
                                         "cuda-rowelim", "--device", "cpu"])
    assert rc == 0 and "Time:" in out
    err = float(out.split("Error:")[1].split()[0])
    assert err <= 1e-4


def test_cli_help_names_the_backends():
    from gauss_tpu_torch.cli import gauss_external, gauss_internal

    for mod in (gauss_internal, gauss_external):
        text = mod.build_parser().format_help()
        assert "cuda-rowelim" in text and "cuda-rowelim-step" in text


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode "
                    "(run `python -m pytest -m cuda tests/` or "
                    "`python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    rng = np.random.default_rng(11)
    m = torch.as_tensor(rng.standard_normal((512, 768)), dtype=torch.float32,
                        device=cuda_device)
    for i in (0, 1, 255, 511):
        got = tre.eliminate_step(m, i)
        torch.cuda.synchronize()
        assert torch.equal(got, tre.eliminate_step_plain(m, i)), i
    view = m[:, 100:612]  # a strided view: row stride 768
    assert torch.equal(tre.eliminate_step(view, 7),
                       tre.eliminate_step_plain(view, 7))
    f = torch.as_tensor(rng.standard_normal((512, 64)), dtype=torch.float32,
                        device=cuda_device)
    u = torch.as_tensor(rng.standard_normal((64, 768)), dtype=torch.float32,
                        device=cuda_device)
    want = tre.rankk_update_plain(m, f, u)
    got = tre.rankk_update(m, f, u)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # Ragged rows, K and columns (a K under one ring stage), contiguous and
    # as column slices whose rows start off 16-byte boundaries: the 4-byte
    # copies of u and the per-element epilogue. One launch each.
    for rows, k, cols in ((513, 17, 1000), (1, 256, 2304), (130, 300, 129)):
        ops = [torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32, device=cuda_device)
               for shape in ((rows, cols), (rows, k), (k, cols))]
        for sliced in (False, True):
            if sliced:
                ops = [torch.zeros((x.shape[0], x.shape[1] + off + 2),
                                   device=cuda_device)[:, off:off + x.shape[1]]
                       .copy_(x) for x, off in zip(ops, (1, 2, 3))]
                assert all(x.data_ptr() % 16 for x in ops)
            _build.reset_launches()
            got = tre.rankk_update(*ops)
            want = tre.rankk_update_plain(*ops)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["rankk_update"] == 1
            assert got.shape == (rows, cols) and got.is_contiguous()
            err = float((got - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), (rows, k, cols,
                                                          sliced)
    # Both drivers on the card against the same drivers' plain route on
    # the CPU (n=300: identity padding to 512 rows).
    a, b = _system(300)
    for solve in (tre.gauss_solve_rowelim_batched, tre.gauss_solve_rowelim):
        got = solve(a, b, device=cuda_device).cpu().numpy()
        want = solve(a, b, device="cpu").numpy()
        assert _close(got, want, a), solve.__name__

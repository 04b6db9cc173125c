"""The port's double-single arithmetic against float64 numpy, at the
tolerances of tests/test_dsfloat.py, and its ds-refined solve against the
JAX package's ``solve_once_ds``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.core import dsfloat as jds
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.core import dsfloat as tds
from gauss_tpu_torch.verify import checks


def _rep(ds):
    return ds.hi.numpy().astype(np.float64) + ds.lo.numpy().astype(
        np.float64)


def test_to_ds_round_trip():
    a = np.random.default_rng(0).standard_normal(1000) * 1e3
    d = tds.to_ds(a, "cpu")
    assert np.max(np.abs(tds.ds_to_f64(d) - a) / np.abs(a)) < 1e-13
    assert d.hi.dtype == d.lo.dtype == torch.float32


def test_to_ds_range_guard():
    with pytest.raises(ValueError, match="range"):
        tds.to_ds(np.array([2e38]), "cpu")


def test_two_sum_two_prod_exact():
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.standard_normal(4096), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal(4096)
                        * rng.uniform(1e-6, 1e6, 4096), dtype=torch.float32)
    s, e = tds._two_sum(a, b)
    a64, b64 = a.double().numpy(), b.double().numpy()
    assert np.array_equal(s.double().numpy() + e.double().numpy(), a64 + b64)
    p, e = tds._two_prod(a, b)
    exact = a64 * b64
    err = np.abs(p.double().numpy() + e.double().numpy() - exact)
    assert np.max(err / np.maximum(np.abs(exact), 1e-30)) < 2**-50


def test_split_is_exact_and_short():
    a = torch.as_tensor(np.random.default_rng(2).standard_normal(1000),
                        dtype=torch.float32)
    hi, lo = tds._split(a)
    assert torch.equal(hi + lo, a)
    # hi keeps at most 12 significant bits: its low 12 fraction bits are 0
    assert int((hi.view(torch.int32) & 0xFFF).abs().max()) == 0


def test_two_prod_broadcast_operands():
    rng = np.random.default_rng(123)
    a = torch.as_tensor(rng.standard_normal((8, 8)), dtype=torch.float32)
    x = torch.as_tensor(rng.standard_normal(8), dtype=torch.float32)
    p, e = tds._two_prod(a, x[:, None].expand(8, 8))
    exact = a.double().numpy() * x.double().numpy()[:, None]
    err = np.abs(p.double().numpy() + e.double().numpy() - exact)
    assert np.max(err / np.maximum(np.abs(exact), 1e-30)) < 2**-50


@pytest.mark.parametrize("n,m", [(8, 8), (33, 17), (256, 300), (1030, 64)])
def test_ds_matvec_accuracy(n, m):
    rng = np.random.default_rng(n * 1000 + m)
    A = rng.standard_normal((m, n))
    x = rng.standard_normal(n)
    at = tds.to_ds(A.T, "cpu")
    xd = tds.to_ds(x, "cpu")
    truth = _rep(at).T @ _rep(xd)
    got = tds.ds_to_f64(tds.ds_matvec(at, xd))
    scale = np.max(np.abs(A) @ np.abs(x))
    assert np.max(np.abs(got - truth)) / scale < n * 1e-13


def test_ds_matvec_matches_jax():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((40, 70))
    x = rng.standard_normal(70)
    got = tds.ds_to_f64(tds.ds_matvec(tds.to_ds(A.T, "cpu"),
                                      tds.to_ds(x, "cpu")))
    want = jds.ds_to_f64(jds.ds_matvec(jds.to_ds(A.T), jds.to_ds(x)))
    assert np.max(np.abs(got - want)) / np.max(np.abs(A) @ np.abs(x)) < 1e-12


def test_ds_residual_captures_cancellation():
    rng = np.random.default_rng(7)
    n = 200
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    x_true = rng.standard_normal(n)
    b = A @ x_true
    x = x_true * (1 + 1e-7)
    r_true = b - A @ x
    r = tds.ds_to_f64(tds.ds_residual(tds.to_ds(A.T, "cpu"),
                                      tds.to_ds(x, "cpu"),
                                      tds.to_ds(b, "cpu")))
    assert np.max(np.abs(r - r_true)) / np.max(np.abs(r_true)) < 1e-4


def test_solve_ds_well_conditioned():
    rng = np.random.default_rng(3)
    n = 192
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    x_true = rng.standard_normal(n)
    x, fac = tds.solve_ds(A, A @ x_true, iters=3, device="cpu")
    assert checks.max_rel_error(x, x_true) < 1e-9
    assert float(fac.min_abs_pivot) > 0


def test_solve_ds_ill_conditioned_beats_f32_refinement():
    """cond ~1e6: plain-f32 refinement stalls above the 1e-4 bar,
    double-single goes under it."""
    rng = np.random.default_rng(4)
    n = 256
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (u * np.logspace(0, -6, n)) @ v.T
    x_true = rng.standard_normal(n)
    b = A @ x_true
    a32 = torch.as_tensor(A, dtype=torch.float32)
    b32 = torch.as_tensor(b, dtype=torch.float32)
    fac = tb.lu_factor_blocked_unrolled(a32, panel=64, device="cpu")
    x32 = tb.lu_solve(fac, b32)
    for _ in range(6):
        x32 = x32 + tb.lu_solve(fac, b32 - a32 @ x32)
    err32 = checks.max_rel_error(x32.double().numpy(), x_true)
    x, _ = tds.solve_ds(A, b, iters=6, panel=64, device="cpu")
    errds = checks.max_rel_error(x, x_true)
    assert errds < 1e-4, errds
    assert errds < err32 / 10, (errds, err32)


@pytest.mark.parametrize("n", [96, 160])
def test_solve_once_ds_matches_jax(n):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    x_t, fac = tds.solve_once_ds(
        torch.as_tensor(A, dtype=torch.float32), tds.to_ds(A.T, "cpu"),
        tds.to_ds(b, "cpu"), 32)
    x_j, _ = jds.solve_once_ds(jnp.asarray(A, jnp.float32), jds.to_ds(A.T),
                               jds.to_ds(b), 32)
    xt, xj = tds.ds_to_f64(x_t), jds.ds_to_f64(x_j)
    assert checks.residual_norm(A, xt, b) < 1e-4
    assert checks.residual_norm(A, xj, b) < 1e-4
    assert checks.max_rel_error(xt, xj) < 1e-6


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_refine_ds_matches_jax_on_one_factor(iters):
    """The port's refinement loop against the JAX package's on the same
    factor (carried across as numpy). 0 iterations return x0 exactly, which
    agrees with JAX's to the cross-framework ``lu_solve`` tolerance 1e-5;
    a budget of 1 or more reaches the gate and agrees to 1e-6."""
    from gauss_tpu.core import blocked as jb
    from gauss_tpu_torch.core import convert

    rng = np.random.default_rng(8)
    n = 64
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    fj = jb.lu_factor_blocked_unrolled(jnp.asarray(A, jnp.float32), panel=32)
    ft = convert.blocked_lu_from_numpy(*convert.blocked_lu_to_numpy(fj),
                                       device="cpu")
    at, bd = tds.to_ds(A.T, "cpu"), tds.to_ds(b, "cpu")
    x0 = tb.lu_solve(ft, bd.hi)
    x = tds.ds_to_f64(tds.refine_ds(ft, at, bd, x0, iters=iters))
    jat, jbd = jds.to_ds(A.T), jds.to_ds(b)
    xj = jds.ds_to_f64(jds.refine_ds(fj, jat, jbd, jb.lu_solve(fj, jbd.hi),
                                     iters=iters))
    if iters == 0:
        assert np.array_equal(x, x0.double().numpy())
        assert checks.max_rel_error(x, xj) < 1e-5
    else:
        assert checks.residual_norm(A, x, b) < 1e-4
        assert checks.max_rel_error(x, xj) < 1e-6

"""The port's Krylov solvers: the cores ``cg_run`` / ``gmres_run`` /
``bicgstab_run`` against the JAX package's cores called directly with
float64 arrays (equal iteration counts on seeded systems), and the host
wrappers and ``solve_sparse`` against ``np.linalg.solve`` at the 1e-4 gate
(the JAX package's host wrappers call ``jax.experimental.enable_x64``,
which current JAX no longer has, so they cannot serve as the reference)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.sparse import krylov as jkry
from gauss_tpu.sparse import precond as jprec
from gauss_tpu.sparse.csr import CsrMatrix as JCsr
from gauss_tpu_torch.core import convert
from gauss_tpu_torch.io import synthetic
from gauss_tpu_torch.sparse import (CsrMatrix, IterativeStagnationError,
                                    SparseSolveResult, krylov, solve_bicgstab,
                                    solve_cg, solve_gmres, solve_sparse)
from gauss_tpu_torch.sparse import precond as tprec
from gauss_tpu_torch.structure.cholesky import NotSPDError

GATE = 1e-4
# Cores, port vs JAX, float64: the same recurrences, with sums in another
# association (and XLA's FMA contraction), amplified over <= 40 iterations
# of well-conditioned (diagonally dominant) systems.
X_RTOL = 1e-8
CURVE_ATOL = 1e-8


def _system(n=200, nnz_per_row=6, seed=1, symmetric=True):
    rows, cols, vals = synthetic.sparse_coords(n, nnz_per_row, seed=seed,
                                               symmetric=symmetric)
    a = CsrMatrix.from_coords(n, rows, cols, vals)
    ja = JCsr.from_coords(n, rows, cols, vals)
    b = np.random.default_rng(seed + 1000).standard_normal(n)
    return a, ja, b


def _staged(a, ja, kind):
    cols, vals = a.ell()
    tc, tv = convert.ell_from_numpy(cols, vals, "cpu")
    tp = tprec.build_preconditioner(a, kind, device="cpu")
    jp = jprec.build_preconditioner(ja, kind)
    return (tc, tv, tp), (jnp.asarray(cols), jnp.asarray(vals), jp)


def _same_run(got, want, n_curve):
    gx, gk, gcurve, grel = got
    wx, wk, wcurve, wrel = want
    assert isinstance(gk, int) and isinstance(grel, float)
    assert gk == int(wk)
    assert gx.dtype == torch.float64 and gcurve.dtype == torch.float64
    assert tuple(gcurve.shape) == (n_curve,) == np.asarray(wcurve).shape
    wx = np.asarray(wx)
    assert np.abs(gx.numpy() - wx).max() <= X_RTOL * np.abs(wx).max()
    assert np.abs(gcurve.numpy() - np.asarray(wcurve)).max() <= CURVE_ATOL
    assert (gcurve.numpy()[gk + 1:] == 0).all()  # zero past the count
    assert abs(grel - float(wrel)) <= CURVE_ATOL


CASES = [(200, 1, True, "jacobi"), (200, 1, True, "none"),
         (640, 258458, True, "jacobi"), (300, 7, True, "block_jacobi"),
         (150, 3, True, "ic0"), (150, 4, True, "tridiag")]
GENERAL = [(200, 2, False, "jacobi"), (300, 5, False, "ilu0"),
           (150, 6, False, "none")]


@pytest.mark.parametrize("n,seed,sym,kind", CASES)
def test_cg_core_matches_jax_core(n, seed, sym, kind):
    a, ja, b = _system(n, seed=seed, symmetric=sym)
    (tc, tv, tp), (jc, jv, jp) = _staged(a, ja, kind)
    for tol, maxiter in ((1e-4, 60), (1e-10, 60), (1e-30, 5)):
        got = krylov.cg_run(tc, tv, torch.from_numpy(b),
                            torch.zeros(n, dtype=torch.float64), tp, tol,
                            maxiter=maxiter)
        want = jkry.cg_run(jc, jv, jnp.asarray(b), jnp.zeros(n), jp,
                           jnp.asarray(tol), maxiter=maxiter)
        _same_run(got, want, maxiter + 1)
    assert got[1] == 5  # the budget ran out: count == maxiter


@pytest.mark.parametrize("n,seed,sym,kind", CASES[:3] + GENERAL)
def test_bicgstab_core_matches_jax_core(n, seed, sym, kind):
    a, ja, b = _system(n, seed=seed, symmetric=sym)
    (tc, tv, tp), (jc, jv, jp) = _staged(a, ja, kind)
    for tol, maxiter in ((1e-4, 60), (1e-9, 60)):
        got = krylov.bicgstab_run(tc, tv, torch.from_numpy(b),
                                  torch.zeros(n, dtype=torch.float64), tp,
                                  tol, maxiter=maxiter)
        want = jkry.bicgstab_run(jc, jv, jnp.asarray(b), jnp.zeros(n), jp,
                                 jnp.asarray(tol), maxiter=maxiter)
        _same_run(got, want, maxiter + 1)


@pytest.mark.parametrize("n,seed,sym,kind", CASES[:2] + GENERAL)
@pytest.mark.parametrize("restart,maxcycles", [(8, 6), (32, 2)])
def test_gmres_core_matches_jax_core(n, seed, sym, kind, restart, maxcycles):
    a, ja, b = _system(n, seed=seed, symmetric=sym)
    (tc, tv, tp), (jc, jv, jp) = _staged(a, ja, kind)
    x0 = np.random.default_rng(5).standard_normal(n) * 0.1
    got = krylov.gmres_run(tc, tv, torch.from_numpy(b), torch.from_numpy(x0),
                           tp, 1e-6, restart=restart, maxcycles=maxcycles)
    want = jkry.gmres_run(jc, jv, jnp.asarray(b), jnp.asarray(x0), jp,
                          jnp.asarray(1e-6), restart=restart,
                          maxcycles=maxcycles)
    _same_run(got, want, maxcycles + 1)


def test_safe_div_guards_like_jax():
    num = np.array([1.0, -2.0, 3.0, 4.0])
    den = np.array([2.0, 0.0, -0.0, -1e-305])
    got = krylov._safe_div(torch.from_numpy(num), torch.from_numpy(den))
    want = np.asarray(jkry._safe_div(jnp.asarray(num), jnp.asarray(den)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("solver,kwargs", [
    (solve_cg, {}), (solve_cg, {"precond": "ic0"}),
    (solve_cg, {"precond": None}), (solve_gmres, {}),
    (solve_gmres, {"restart": 10, "precond": "block_jacobi"}),
    (solve_bicgstab, {}), (solve_bicgstab, {"precond": "tridiag"}),
])
def test_host_wrappers_meet_the_gate(solver, kwargs):
    a, _, b = _system(200)
    res = solver(a, b, device="cpu", **kwargs)
    assert isinstance(res, SparseSolveResult) and res.converged
    assert res.x.dtype == np.float64 and res.x.shape == (200,)
    x_ref = np.linalg.solve(a.to_dense(), b)
    true_rel = np.linalg.norm(a.to_dense() @ res.x - b) / np.linalg.norm(b)
    assert true_rel <= GATE and abs(true_rel - res.rel_residual) <= 1e-12
    # ||x - x_ref|| <= cond * rel * ||x_ref||; cond < 10 here.
    assert np.linalg.norm(res.x - x_ref) <= 10 * GATE * np.linalg.norm(x_ref)
    assert res.precond == (kwargs.get("precond", "jacobi") or "none")
    if solver is solve_gmres:
        restart = kwargs.get("restart", 32)
        assert res.iterations % restart == 0
        assert len(res.residuals) == res.iterations // restart + 1
    else:
        assert len(res.residuals) == res.iterations + 1
    assert res.residuals[0] == pytest.approx(1.0) and (
        res.residuals[-1] <= GATE)


@pytest.mark.parametrize("solver", [solve_gmres, solve_bicgstab])
def test_general_solvers_handle_nonsymmetric(solver):
    a, _, b = _system(200, seed=2, symmetric=False)
    res = solver(a, b, device="cpu")
    assert res.converged and res.rel_residual <= GATE
    x_ref = np.linalg.solve(a.to_dense(), b)
    assert np.linalg.norm(res.x - x_ref) <= 10 * GATE * np.linalg.norm(x_ref)


def test_cg_refuses_uncertified():
    a, _, b = _system(100, symmetric=False)
    with pytest.raises(NotSPDError, match="Gershgorin"):
        solve_cg(a, b, device="cpu")
    with pytest.raises(NotSPDError):
        solve_sparse(a, b, method="cg", device="cpu")


@pytest.mark.parametrize("solver,extra", [(solve_cg, {}),
                                          (solve_gmres, {"restart": 2}),
                                          (solve_bicgstab, {})])
def test_stagnation_is_typed_and_carries_result(solver, extra):
    a, _, b = _system(200)
    solver = functools.partial(solver, **extra)
    with pytest.raises(IterativeStagnationError) as ei:
        solver(a, b, tol=1e-14, maxiter=2, device="cpu")
    e = ei.value
    assert e.method == e.result.method and not e.result.converged
    assert e.iterations == e.result.iterations
    assert e.rel_residual == e.result.rel_residual > 1e-14
    assert np.isfinite(e.result.x).all()
    res = solver(a, b, tol=1e-14, maxiter=2, raise_on_stagnation=False,
                 device="cpu")
    assert not res.converged and res.iterations == e.iterations


def test_multiple_rhs_and_x0():
    a, _, _ = _system(150)
    bs = np.random.default_rng(3).standard_normal((150, 3))
    res = solve_cg(a, bs, device="cpu")
    assert res.x.shape == (150, 3) and res.converged
    x_ref = np.linalg.solve(a.to_dense(), bs)
    assert np.linalg.norm(res.x - x_ref) <= 10 * GATE * np.linalg.norm(x_ref)
    # The worst column's count is the one reported.
    singles = [solve_cg(a, bs[:, j], device="cpu") for j in range(3)]
    assert res.iterations in {s.iterations for s in singles}
    for j, s in enumerate(singles):
        assert np.array_equal(res.x[:, j], s.x)
    warm = solve_cg(a, bs[:, 0], x0=x_ref[:, 0], device="cpu")
    assert warm.iterations == 0 and warm.residuals.shape == (1,)


def test_prebuilt_preconditioner_is_accepted():
    a, _, b = _system(120)
    p = tprec.build_preconditioner(a, "block_jacobi", block=8, device="cpu")
    res = solve_bicgstab(a, b, precond=p, device="cpu")
    assert res.converged and res.precond == "block_jacobi"


class TestSolveSparse:
    def test_auto_certified_uses_cg(self):
        a, _, b = _system(300)
        res = solve_sparse(a, b, device="cpu")
        assert (res.method, res.precond) == ("cg", "jacobi")
        assert res.converged and res.rel_residual <= GATE

    def test_auto_uncertified_skips_cg(self):
        a, _, b = _system(300, symmetric=False)
        res = solve_sparse(a, b, device="cpu")
        assert res.method == "gmres" and res.converged

    def test_ladder_falls_through_on_stagnation(self, monkeypatch):
        from gauss_tpu_torch.sparse import solve as tsolve

        a, _, b = _system(100)
        calls = []

        def stalls(name):
            def run(a_, b_, **kw):
                calls.append(name)
                raise IterativeStagnationError(name, method=name)
            return run

        real = tsolve._SOLVERS["bicgstab"]
        monkeypatch.setitem(tsolve._SOLVERS, "cg", stalls("cg"))
        monkeypatch.setitem(tsolve._SOLVERS, "gmres", stalls("gmres"))
        res = solve_sparse(a, b, device="cpu")
        assert calls == ["cg", "gmres"] and res.method == "bicgstab"
        monkeypatch.setitem(tsolve._SOLVERS, "bicgstab", stalls("bicgstab"))
        with pytest.raises(IterativeStagnationError) as ei:
            solve_sparse(a, b, device="cpu")
        assert ei.value.method == "bicgstab"  # the LAST typed error
        monkeypatch.setitem(tsolve._SOLVERS, "bicgstab", real)

    def test_every_method_stalls_on_a_tiny_budget(self):
        a, _, b = _system(100)
        with pytest.raises(IterativeStagnationError) as ei:
            solve_sparse(a, b, gate=1e-15, maxiter=1, device="cpu")
        assert ei.value.method == "bicgstab"
        assert ei.value.result is not None

    def test_dense_input_accepted(self):
        d = synthetic.sparse_matrix(64, 5, seed=3)
        b = np.arange(64, dtype=np.float64)
        res = solve_sparse(d, b, device="cpu")
        assert res.method == "cg"
        x_ref = np.linalg.solve(d, b)
        assert np.linalg.norm(res.x - x_ref) <= 10 * GATE * np.linalg.norm(
            x_ref)

    def test_restart_and_explicit_method(self):
        a, _, b = _system(100)
        res = solve_sparse(a, b, method="gmres", restart=5, device="cpu")
        assert res.method == "gmres" and res.iterations % 5 == 0
        with pytest.raises(ValueError, match="unknown sparse method"):
            solve_sparse(a, b, method="sor", device="cpu")

    def test_no_device_and_no_card_raises(self, monkeypatch):
        a, _, b = _system(50)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            solve_sparse(a, b)

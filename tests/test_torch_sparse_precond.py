"""The port's preconditioners and tridiagonal solve against the JAX
package's: ``build_preconditioner`` arrays and ``apply_precond`` for all six
kinds, state carried across in both directions, the batched panel probe,
and the typed errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.core import blocked as jblocked
from gauss_tpu.sparse import precond as jprec
from gauss_tpu.sparse.csr import CsrMatrix as JCsr
from gauss_tpu.structure import banded as jbanded
from gauss_tpu_torch.core import blocked, convert
from gauss_tpu_torch.io import synthetic
from gauss_tpu_torch.sparse import precond as tprec
from gauss_tpu_torch.sparse.csr import CsrMatrix
from gauss_tpu_torch.structure.banded import solve_tridiag
from gauss_tpu_torch.structure.detect import StructureMismatchError

# Port vs JAX in float64: the builds are the same numpy code (arrays equal
# to rounding of the block inverses), the applies the same sums in another
# association.
RTOL = 1e-10


def _pair(n=200, nnz_per_row=6, seed=1, symmetric=True):
    rows, cols, vals = synthetic.sparse_coords(n, nnz_per_row, seed=seed,
                                               symmetric=symmetric)
    return (CsrMatrix.from_coords(n, rows, cols, vals),
            JCsr.from_coords(n, rows, cols, vals))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("kind", tprec.PRECOND_KINDS)
@pytest.mark.parametrize("n,block", [(200, None), (203, 16), (97, 8)])
def test_build_and_apply_match_jax(kind, n, block):
    a, ja = _pair(n)
    p = tprec.build_preconditioner(a, kind, block=block, device="cpu")
    jp = jprec.build_preconditioner(ja, kind, block=block)
    assert p.kind == jp.kind == kind and p.meta == tuple(jp.meta)
    assert len(p.arrays) == len(jp.arrays)
    for got, want in zip(p.arrays, jp.arrays):
        assert got.dtype == torch.float64
        _close(got.numpy(), want)
    r = np.random.default_rng(n).standard_normal(n)
    want = np.asarray(jprec.apply_precond(jp, jnp.asarray(r)))
    got = tprec.apply_precond(p, torch.from_numpy(r)).numpy()
    _close(got, want)
    # State carried across, both ways: a JAX-built preconditioner applied
    # by the port, and a port-built one applied by the JAX package.
    kind_j, meta_j, arrays_j = (jp.kind, jp.meta,
                                tuple(np.asarray(x) for x in jp.arrays))
    from_jax = convert.preconditioner_from_numpy(kind_j, meta_j, arrays_j,
                                                 device="cpu")
    _close(tprec.apply_precond(from_jax, torch.from_numpy(r)).numpy(), want)
    k2, m2, arr2 = convert.preconditioner_to_numpy(p)
    to_jax = jprec.Preconditioner(k2, m2, tuple(jnp.asarray(x) for x in arr2))
    _close(np.asarray(jprec.apply_precond(to_jax, jnp.asarray(r))), want)


@pytest.mark.parametrize("kind", ["jacobi", "block_jacobi", "tridiag",
                                  "ilu0"])
def test_nonsymmetric_operand_matches_jax(kind):
    a, ja = _pair(150, symmetric=False, seed=3)
    p = tprec.build_preconditioner(a, kind, device="cpu")
    jp = jprec.build_preconditioner(ja, kind)
    r = np.random.default_rng(1).standard_normal(150)
    _close(tprec.apply_precond(p, torch.from_numpy(r)).numpy(),
           np.asarray(jprec.apply_precond(jp, jnp.asarray(r))))


def test_apply_identity_and_none():
    r = torch.arange(5, dtype=torch.float64)
    assert tprec.apply_precond(None, r) is r
    a, _ = _pair(20)
    assert tprec.apply_precond(
        tprec.build_preconditioner(a, "none", device="cpu"), r) is r


def test_typed_errors():
    a, _ = _pair(64)
    with pytest.raises(ValueError, match="unknown preconditioner"):
        tprec.build_preconditioner(a, "ssor", device="cpu")
    with pytest.raises(ValueError, match="unknown preconditioner"):
        convert.preconditioner_from_numpy("ssor", (4,), (), device="cpu")
    g, _ = _pair(64, symmetric=False)
    with pytest.raises(StructureMismatchError, match="Gershgorin"):
        tprec.build_preconditioner(g, "ic0", device="cpu")
    # A singular diagonal block: typed, never a NaN-filled apply.
    d = np.eye(32)
    d[4:6, 4:6] = [[1.0, 2.0], [2.0, 4.0]]
    d[0, 31] = 0.5  # keep the operand from being block-trivial
    sing = CsrMatrix.from_dense(d)
    for kind in ("block_jacobi", "ilu0"):
        with pytest.raises(StructureMismatchError, match="singular"):
            tprec.build_preconditioner(sing, kind, block=16, device="cpu")
        with pytest.raises(jprec.StructureMismatchError, match="singular"):
            jprec.build_preconditioner(JCsr.from_dense(d), kind, block=16)


def test_entry_point_without_device_raises_without_card(monkeypatch):
    a, _ = _pair(20)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tprec.build_preconditioner(a, "jacobi")


def test_batched_panel_probe_matches_jax_vmap_and_single_blocks():
    rng = np.random.default_rng(6)
    blocks = rng.standard_normal((9, 16, 16))
    blocks[3, :, 5] = 0.0        # a zero column: singular, no NaN
    blocks[7, 2] = blocks[7, 9]  # duplicate rows: singular
    got_p, got_ipiv, got_min = blocked.panel_factor_swap_batched(
        torch.from_numpy(blocks))
    want_p, want_ipiv, want_min = jax.vmap(
        lambda b: jblocked._panel_factor_jax(b, 0, zero_pivot_safe=True))(
            jnp.asarray(blocks))
    assert torch.isfinite(got_p).all()
    assert np.array_equal(got_ipiv.numpy(), np.asarray(want_ipiv))
    ok = [i for i in range(9) if i not in (3, 7)]
    # Rounding of p * (1 / piv): same arithmetic, FMA contraction aside.
    np.testing.assert_allclose(got_p.numpy()[ok], np.asarray(want_p)[ok],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got_min.numpy()[ok], np.asarray(want_min)[ok],
                               rtol=1e-12)
    assert got_min[3] == 0.0 and got_min[7] < 1e-14
    # Against the one-block stock panel of the port (division in place of
    # the guarded reciprocal: values to rounding, pivots exactly).
    for i in ok:
        p1, ipiv1, min1 = blocked.panel_factor_swap(
            torch.from_numpy(blocks[i]), 0)
        assert torch.equal(ipiv1, got_ipiv[i])
        torch.testing.assert_close(p1, got_p[i], rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(min1, got_min[i])
    nan_block = np.eye(4)[None].copy()
    nan_block[0, 2, 2] = np.nan
    assert blocked.panel_factor_swap_batched(
        torch.from_numpy(nan_block))[2][0] == 0.0  # NaN counts as 0


def _tridiag_system(n, seed, k=None):
    rng = np.random.default_rng(seed)
    dl, du = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    d = 2.5 + np.abs(dl) + np.abs(du)
    d[::3] *= -1.0
    b = rng.standard_normal(n if k is None else (n, k))
    return dl, d, du, b


@pytest.mark.parametrize("n,k", [(1, None), (2, None), (7, None), (64, None),
                                 (200, None), (640, None), (129, 3)])
def test_solve_tridiag_matches_jax_and_numpy(n, k):
    dl, d, du, b = _tridiag_system(n, n)
    got = solve_tridiag(*(torch.from_numpy(v) for v in (dl, d, du, b)))
    assert got.dtype == torch.float64 and tuple(got.shape) == b.shape
    want_jax = np.asarray(jbanded.solve_tridiag(dl, d, du, b))
    t = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    want_np = np.linalg.solve(t, b)
    # Diagonally dominant, condition < 10: float64 rounding through
    # log2(n) scan levels.
    _close(got.numpy(), want_np, 1e-11)
    _close(got.numpy(), want_jax, 1e-11)


def test_solve_tridiag_survives_long_products():
    """n = 5000 with |d| ~ 50: the continuants reach 50^5000; the
    normalised products must not overflow."""
    n = 5000
    rng = np.random.default_rng(8)
    dl, du = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    d = np.full(n, 50.0)
    b = rng.standard_normal(n)
    x = solve_tridiag(*(torch.from_numpy(v) for v in (dl, d, du, b))).numpy()
    res = d * x
    res[1:] += dl[1:] * x[:-1]
    res[:-1] += du[:-1] * x[1:]
    assert np.isfinite(x).all()
    assert np.abs(res - b).max() <= 1e-12 * np.abs(b).max()

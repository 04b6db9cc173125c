"""The port's unblocked elimination oracle against gauss_tpu.core.gauss,
for all three pivot policies (float32 on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.core import gauss as jg
from gauss_tpu_torch.core import gauss as tg
from gauss_tpu_torch.io import synthetic

# f32 elimination in two frameworks: XLA:CPU may contract the rank-1
# update into an FMA, the port rounds product and difference separately.
TOL = 1e-5


def _system(rng, n, dominant):
    a = rng.standard_normal((n, n)).astype(np.float32)
    if dominant:  # nonsingular leading minors: "none" and
        a[np.arange(n), np.arange(n)] += n  # "first_nonzero" are stable
    return a, rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("pivoting", ["partial", "first_nonzero", "none"])
@pytest.mark.parametrize("n", [16, 33])
def test_eliminate_matches_jax(rng, pivoting, n):
    a, b = _system(rng, n, dominant=pivoting != "partial")
    want = jg.eliminate(jnp.asarray(a), jnp.asarray(b), pivoting=pivoting)
    got = tg.eliminate(a, b, pivoting=pivoting, device="cpu")
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    scale = np.abs(np.asarray(want.u)).max()
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u),
                               atol=TOL * scale, rtol=0)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                               atol=TOL * np.abs(np.asarray(want.y)).max(),
                               rtol=0)
    assert float(got.min_abs_pivot) == pytest.approx(
        float(want.min_abs_pivot), rel=TOL)


@pytest.mark.parametrize("pivoting", ["partial", "first_nonzero", "none"])
def test_gauss_solve_matches_jax(rng, pivoting):
    n = 40
    a, b = _system(rng, n, dominant=True)
    want = np.asarray(jg.gauss_solve(jnp.asarray(a), jnp.asarray(b),
                                     pivoting=pivoting), np.float64)
    got = tg.gauss_solve(a, b, pivoting=pivoting, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_internal_system_exact_pattern():
    """The min matrix has exact-integer elimination: the swap-on-zero
    oracle reproduces (-0.5, 0, ..., 0, 0.5)."""
    n = 48
    x = tg.gauss_solve(synthetic.internal_matrix(n), synthetic.internal_rhs(n),
                       pivoting="first_nonzero", device="cpu")
    np.testing.assert_allclose(
        x.numpy(), synthetic.internal_expected_solution(n), atol=1e-5)


def test_singular_reports_zero_pivot():
    a = np.ones((6, 6), np.float32)
    got = tg.eliminate(a, np.ones(6, np.float32), device="cpu")
    want = jg.eliminate(jnp.asarray(a), jnp.ones(6, jnp.float32))
    assert float(got.min_abs_pivot) == float(want.min_abs_pivot) == 0.0


def test_nan_pivot_choice_matches_jax():
    """A NaN beats every number in the pivot contest (the first NaN wins)."""
    a = np.eye(5, dtype=np.float32)
    a[3, 0] = np.nan
    a[4, 0] = np.nan
    got = tg.eliminate(a, np.ones(5, np.float32), device="cpu")
    want = jg.eliminate(jnp.asarray(a), jnp.ones(5, jnp.float32))
    assert int(got.perm[0]) == int(want.perm[0]) == 3
    assert float(got.min_abs_pivot) == float(want.min_abs_pivot) == 0.0


def test_back_substitute_matches_jax(rng):
    u = np.triu(rng.standard_normal((20, 20))).astype(np.float32)
    u[np.arange(20), np.arange(20)] += 4.0
    y = rng.standard_normal(20).astype(np.float32)
    want = np.asarray(jg.back_substitute(jnp.asarray(u), jnp.asarray(y)))
    got = tg.back_substitute(torch.from_numpy(u), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_unknown_policy_rejected():
    with pytest.raises(ValueError, match="pivoting"):
        tg.eliminate(np.eye(3), np.ones(3), pivoting="rook", device="cpu")

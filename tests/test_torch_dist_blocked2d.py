"""The port's 2-D panel-blocked LU with tournament pivoting
(``gauss_tpu_torch.dist.gauss_dist_blocked2d``) against the JAX package's
on the same seeded inputs: the JAX engine on R x C meshes of the
conftest's 8 virtual CPU devices, the port on the same R x C of one gloo
world of 8 started once for the module.

Tolerances: the tournament's winners (the composed permutation) are
equal; x, the factor tiles and the diagonal-block inverses agree to 2e-4
relative to their largest entry (float32; both packages elect with the
stock swap panel at ``zero_pivot_safe=True``); the refined entries pass
the JAX tests' gate; singular input raises LinAlgError in both.
"""

import numpy as np
import pytest
import torch

from gauss_tpu_torch.dist import gauss_dist_blocked2d as tg2
from gauss_tpu_torch.dist import launch

REL = 2e-4


@pytest.fixture(scope="module")
def world():
    with launch.World(8, device="cpu") as w:
        yield w


def _system(n, seed, dominant=1.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + dominant * np.sqrt(n) * np.eye(n)
    rng.shuffle(a)
    return a.astype(np.float32), rng.standard_normal(n).astype(np.float32)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("shape,n,panel", [((2, 2), 32, 8), ((2, 4), 64, 8),
                                           ((4, 2), 64, 16),
                                           ((2, 2), 130, 16),
                                           ((4, 2), 192, 8),
                                           ((1, 1), 40, 8)])
def test_factor_matches_jax(world, shape, n, panel):
    from gauss_tpu.dist import gauss_dist_blocked2d as jg2
    from gauss_tpu.dist.mesh import make_mesh_2d

    a, b = _system(n, seed=n * shape[0] + panel)
    mesh = make_mesh_2d(*shape)
    xj, fj = jg2.factor_solve_dist_blocked2d_staged(
        jg2.prepare_dist_blocked2d(a, b, mesh, panel=panel), mesh)
    size = shape[0] * shape[1]
    calls = [(tg2.prepare_dist_blocked2d, (a, b), {"panel": panel}),
             (tg2.factor_solve_dist_blocked2d_staged, (), {})]
    ranks = world.run(launch.chained, calls, mesh=shape)[:size]
    x0, f0 = ranks[0]
    for x, f in ranks:
        assert torch.equal(x, x0) and torch.equal(f["perm"], f0["perm"])
    perm_j = np.asarray(fj.perm)
    assert np.array_equal(f0["perm"].numpy(), perm_j)
    assert (perm_j[:n] != np.arange(n)).any()   # it pivots
    _close(x0, np.asarray(xj))
    _close(f0["linvs"], np.asarray(fj.linvs))
    _close(f0["uinvs"], np.asarray(fj.uinvs))
    _close(float(f0["min_piv"]), float(fj.min_piv))
    # The tiles, rank (r, c) at row block r, column block c of the JAX
    # package's global sharded layout.
    R, C = shape
    mr, mc = fj.npad // R, fj.npad // C
    glob = np.asarray(fj.a_fac)
    for rank, (_, f) in enumerate(ranks):
        r, c = divmod(rank, C)
        _close(f["a_fac"], glob[r * mr:(r + 1) * mr, c * mc:(c + 1) * mc])


@pytest.mark.parametrize("shape,n", [((2, 2), 64), ((2, 4), 100),
                                     ((4, 2), 192)])
def test_refined_passes_the_jax_gate(world, shape, n):
    from gauss_tpu.dist import gauss_dist_blocked2d as jg2
    from gauss_tpu.dist.mesh import make_mesh_2d

    a, b = _system(n, seed=3 * n)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    xj = jg2.gauss_solve_dist_blocked2d_refined(
        a64, b64, mesh=make_mesh_2d(*shape), panel=8)
    xt = world.run(tg2.gauss_solve_dist_blocked2d_refined, a64, b64,
                   panel=8, mesh=shape)[0]
    for x in (xt, xj):
        res = np.linalg.norm(a64 @ x - b64) / np.linalg.norm(b64)
        assert res <= 1e-10, res
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-12)


def test_singular_raises_like_jax(world):
    from gauss_tpu.dist import gauss_dist_blocked2d as jg2
    from gauss_tpu.dist.mesh import make_mesh_2d

    a = np.ones((32, 32), np.float32)
    b = np.ones(32, np.float32)
    with pytest.raises(np.linalg.LinAlgError):
        jg2.gauss_solve_dist_blocked2d(a, b, mesh=make_mesh_2d(2, 2),
                                       panel=8)
    with pytest.raises(launch.RankError, match="LinAlgError"):
        world.run(tg2.gauss_solve_dist_blocked2d, a, b, panel=8,
                  mesh=(2, 2))


def test_duplicate_rows_across_shards(world):
    """The synthetic internal matrix is full of duplicate rows: the
    guarded election keeps the tournament sound and the solve finite (the
    JAX package's regression of the same name)."""
    from gauss_tpu_torch.io import synthetic

    n = 64
    a = synthetic.internal_matrix(n).astype(np.float32)
    b = synthetic.internal_rhs(n).astype(np.float32)
    x = world.run(tg2.gauss_solve_dist_blocked2d_refined, a, b, panel=8,
                  mesh=(2, 2))[0]
    res = np.linalg.norm(a.astype(np.float64) @ x - b) / np.linalg.norm(b)
    assert np.isfinite(x).all() and res <= 1e-6

"""The port's 2-D cyclic distributed elimination (``gauss_tpu_torch.dist
.gauss_dist2d``) against the JAX package's on the same seeded inputs: the
JAX engine on R x C meshes of the conftest's 8 virtual CPU devices, the
port on the same R x C of one gloo world of 8 started once for the module.

Tolerance: x agrees with the JAX engine's to 2e-4 relative to max |x|
(float32; the same pivots: the owner column's first-maximum election, as
``jnp.argmax`` has it).
"""

import numpy as np
import pytest
import torch

from gauss_tpu_torch.dist import gauss_dist2d as tg2
from gauss_tpu_torch.dist import launch


@pytest.fixture(scope="module")
def world():
    with launch.World(8, device="cpu") as w:
        yield w


def _system(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + np.sqrt(n) * np.eye(n)
    rng.shuffle(a)
    return a.astype(np.float32), rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("shape,n", [((1, 1), 16), ((2, 2), 30),
                                     ((2, 4), 64), ((4, 2), 96),
                                     ((2, 4), 21), ((4, 2), 128)])
def test_gauss_dist2d_matches_jax(world, shape, n):
    from gauss_tpu.dist import gauss_dist2d as jg2
    from gauss_tpu.dist.mesh import make_mesh_2d

    a, b = _system(n, seed=n + shape[0])
    xj = np.asarray(jg2.gauss_solve_dist2d(a, b, mesh=make_mesh_2d(*shape)))
    size = shape[0] * shape[1]
    ranks = world.run(tg2.gauss_solve_dist2d, a, b, mesh=shape)[:size]
    for x in ranks:
        assert torch.equal(x, ranks[0])
    x = ranks[0].numpy()
    assert x.shape == (n,)
    assert np.abs(x - xj).max() <= 2e-4 * float(np.abs(xj).max())


def test_gauss_dist2d_needs_a_2d_mesh(world):
    a, b = _system(8, seed=1)
    with pytest.raises(launch.RankError, match="needs a 2-D mesh"):
        world.run(tg2.gauss_solve_dist2d, a, b, mesh=(4,))


def test_gauss_dist2d_singular_like_jax(world):
    from gauss_tpu.dist import gauss_dist2d as jg2
    from gauss_tpu.dist.mesh import make_mesh_2d

    a = np.ones((12, 12), np.float32)
    b = np.ones(12, np.float32)
    xj = np.asarray(jg2.gauss_solve_dist2d(a, b, mesh=make_mesh_2d(2, 2)))
    xt = world.run(tg2.gauss_solve_dist2d, a, b, mesh=(2, 2))[0].numpy()
    assert not np.isfinite(xj).all() and not np.isfinite(xt).all()

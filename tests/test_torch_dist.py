"""The port's row-cyclic distributed elimination and sharded matmul
(``gauss_tpu_torch.dist.gauss_dist``, ``.matmul_dist``), meshes and
meshfiles against the JAX package's on the same seeded inputs: the JAX
engines on meshes of the conftest's 8 virtual CPU devices, the port on
ranks of one gloo world of 8 started once for the module.

Tolerances: x agrees with the JAX engine's to 2e-4 relative to max |x|
(float32, the same pivots by construction: the cross-rank argmax keeps
``jnp.argmax``'s first-maximum rule); the matmul products are equal to
1e-5 relative (float32 GEMM at "highest") and exact on integers.
"""

import importlib

import numpy as np
import pytest
import torch

from gauss_tpu_torch.dist import gauss_dist as tgd
from gauss_tpu_torch.dist import launch
from gauss_tpu_torch.dist import mesh as tmesh
from gauss_tpu_torch.dist import topology as ttopo

tmd = importlib.import_module("gauss_tpu_torch.dist.matmul_dist")


@pytest.fixture(scope="module")
def world():
    with launch.World(8, device="cpu") as w:
        yield w


def _system(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + np.sqrt(n) * np.eye(n)
    rng.shuffle(a)
    return a.astype(np.float32), rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("P,n", [(1, 16), (2, 33), (4, 64), (8, 96),
                                 (8, 21)])
def test_gauss_dist_matches_jax(world, P, n):
    from gauss_tpu.dist import gauss_dist as jgd
    from gauss_tpu.dist.mesh import make_mesh

    a, b = _system(n, seed=P * 100 + n)
    xj = np.asarray(jgd.gauss_solve_dist(a, b, mesh=make_mesh(P)))
    ranks = world.run(tgd.gauss_solve_dist, a, b, mesh=(P,))[:P]
    for x in ranks:
        assert torch.equal(x, ranks[0])
    x = ranks[0].numpy()
    assert x.shape == (n,) and x.dtype == np.float32
    scale = float(np.abs(xj).max())
    assert np.abs(x - xj).max() <= 2e-4 * scale
    assert world.run(tgd.eliminate_dist, a, b, mesh=(P,))[0].tolist() \
        == x.tolist()


def test_gauss_dist_singular_and_nan_like_jax(world):
    """No raise on a singular system (x non-finite in both packages); a
    NaN entry wins the pivot contest first, as jnp.argmax has it."""
    from gauss_tpu.dist import gauss_dist as jgd
    from gauss_tpu.dist.mesh import make_mesh

    a = np.ones((16, 16), np.float32)
    b = np.ones(16, np.float32)
    xj = np.asarray(jgd.gauss_solve_dist(a, b, mesh=make_mesh(4)))
    xt = world.run(tgd.gauss_solve_dist, a, b, mesh=(4,))[0].numpy()
    assert not np.isfinite(xj).all() and not np.isfinite(xt).all()
    from gauss_tpu_torch.kernels.panel import argmax_nan_first

    assert int(argmax_nan_first(torch.tensor([1.0, float("nan"), 3.0,
                                              float("nan")]))) == 1
    assert int(argmax_nan_first(torch.tensor([1.0, 3.0, 3.0]))) == 1


@pytest.mark.parametrize("mesh", [(1,), (4,), (8,), (2, 2), (2, 4), (4, 2)])
def test_matmul_dist_matches_jax(world, mesh):
    from gauss_tpu.dist.matmul_dist import matmul_dist as jmd
    from gauss_tpu.dist.mesh import make_mesh, make_mesh_2d

    rng = np.random.default_rng(len(mesh) * 10 + mesh[0])
    a = rng.standard_normal((37, 29)).astype(np.float32)
    b = rng.standard_normal((29, 23)).astype(np.float32)
    jm = make_mesh(mesh[0]) if len(mesh) == 1 else make_mesh_2d(*mesh)
    cj = np.asarray(jmd(a, b, jm, precision="highest"))
    ct = world.run(tmd.matmul_dist, a, b, precision="highest",
                   mesh=mesh)[0].numpy()
    assert ct.shape == cj.shape == (37, 23)
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-5)
    v = rng.standard_normal(29).astype(np.float32)
    vt = world.run(tmd.matmul_dist, a, v, precision="highest",
                   mesh=mesh)[0].numpy()
    np.testing.assert_allclose(vt, a @ v, rtol=1e-5, atol=1e-5)
    ai = rng.integers(-9, 9, (12, 12)).astype(np.int64)
    it = world.run(tmd.matmul_dist, ai, ai, mesh=mesh)[0].numpy()
    assert it.dtype == np.int64 and np.array_equal(it, ai @ ai)


def test_matmul_dist_staged_chain():
    """The staged form on a world of one in this process: the product of
    the staged shards is A @ B, and the carry is a zero of its shape."""
    from gauss_tpu_torch.dist import multihost

    a = np.arange(64, dtype=np.float32).reshape(8, 8) / 64
    try:
        a_loc, b_loc, c0, mm = tmd.matmul_dist_staged(a, a, device="cpu",
                                                      precision="highest")
        assert torch.distributed.get_world_size() == 1
        np.testing.assert_allclose(mm(a_loc, b_loc).numpy(), a @ a,
                                   rtol=1e-6)
    finally:
        multihost.shutdown()
    assert c0.shape == (8, 8) and not c0.any()
    with pytest.raises(ValueError, match="matrix operands"):
        tmd.matmul_dist_staged(a, a[0], device="cpu")


def test_mesh_shapes_match_jax():
    from gauss_tpu.dist import mesh as jmesh

    for n in range(1, 17):
        assert tmesh.squarest_factors(n) == jmesh.squarest_factors(n)


def _facts(world, make, *args):
    return world.run(launch.chained, [(make, args, {}),
                                      (tmesh.describe, (), {})])


def test_meshes_and_meshfile_on_ranks(world, tmp_path):
    """The constructors give the JAX shapes and axis names over the ranks;
    a meshfile keeps the hostfile format; ranks outside a mesh have no
    coordinate."""
    from gauss_tpu.dist import mesh as jmesh
    from gauss_tpu.dist import topology as jtopo

    text = "# two axes\naxis rows 2\naxis cols 3  # six ranks\n"
    path = tmp_path / "mesh.txt"
    path.write_text(text)
    assert ttopo.parse_meshfile(text) == jtopo.parse_meshfile(text)
    for bad in ("axis rows", "axis rows x", "axis rows 0", "",
                "axis a 1\naxis a 2"):
        with pytest.raises(ValueError):
            ttopo.parse_meshfile(bad)
        with pytest.raises(ValueError):
            jtopo.parse_meshfile(bad)
    jm = jtopo.load_meshfile(path)
    m1 = _facts(world, tmesh.make_mesh, 4)
    m2 = _facts(world, tmesh.make_mesh_2d_auto, 8)
    mf = _facts(world, ttopo.load_meshfile, str(path))
    lanes = world.run(tmesh.lane_slices, None, 3)
    lm = _facts(world, tmesh.lane_mesh, lanes[0][0])
    for rank in range(8):
        assert m1[rank]["shape"] == (4,) and m1[rank]["axes"] == ("rows",)
        assert m2[rank]["shape"] == tuple(
            jmesh.make_mesh_2d_auto(8).devices.shape) == (4, 2)
        assert mf[rank]["shape"] == tuple(jm.devices.shape) == (2, 3)
        assert mf[rank]["axes"] == tuple(jm.axis_names) == ("rows", "cols")
        assert mf[rank]["ranks"] == list(range(6))
        assert lm[rank]["axes"] == ("batch",) and lm[rank]["shape"] == (3,)
        assert lanes[rank] == [(0, 1, 2), (3, 4, 5)]
        assert m1[rank]["coord"] == ((rank,) if rank < 4 else None)
        assert mf[rank]["coord"] == ((rank // 3, rank % 3) if rank < 6
                                     else None)
    with pytest.raises(launch.RankError, match="only 8"):
        world.run(tmesh.make_mesh, 9)
    bigger = tmp_path / "big.txt"
    bigger.write_text("axis rows 3\naxis cols 3\n")
    with pytest.raises(launch.RankError, match="9 devices"):
        world.run(ttopo.load_meshfile, str(bigger))
    assert world.run(tmesh.squarest_factors, 6) == [(3, 2)] * 8  # still up


# --- the distributed CLI backends, against the JAX CLIs' stdout ------------

def _cli(main, argv):
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _shape(out: str, port_name: str, jax_name: str) -> list:
    """Stdout with every number masked and the backend's name unified."""
    import re

    out = out.replace(port_name, jax_name)
    return [re.sub(r"[-+]?\d+\.\d+(e[-+]\d+)?", "#", line)
            for line in out.strip().splitlines()]


@pytest.mark.parametrize("backend", ["dist", "dist2d", "dist-blocked",
                                     "dist-blocked2d"])
def test_internal_cli_dist_backends_print_the_jax_lines(backend):
    from gauss_tpu.cli import gauss_internal as jcli
    from gauss_tpu_torch.cli import gauss_internal as tcli

    rc_j, out_j = _cli(jcli.main, ["-s", "40", "-t", "4", "--verify",
                                   "--backend", f"tpu-{backend}"])
    rc_t, out_t = _cli(tcli.main, ["-s", "40", "-t", "4", "--verify",
                                   "--backend", f"cuda-{backend}",
                                   "--device", "cpu"])
    assert rc_j == rc_t == 0, out_t
    assert _shape(out_t, f"cuda-{backend}", f"tpu-{backend}") == \
        _shape(out_j, "", "")
    assert "solution pattern (-0.5, 0...0, 0.5) OK" in out_t


def test_external_and_matmul_cli_dist(tmp_path):
    from gauss_tpu.cli import gauss_external as jext
    from gauss_tpu_torch.cli import gauss_external as text
    from gauss_tpu_torch.cli import matmul as tmm
    from gauss_tpu_torch.io import datfile, synthetic

    path = tmp_path / "g.dat"
    datfile.write_dat(str(path), synthetic.generator_matrix(48))
    rc_j, out_j = _cli(jext.main, [str(path), "2", "--backend",
                                   "tpu-dist-blocked"])
    rc_t, out_t = _cli(text.main, [str(path), "2", "--backend",
                                   "cuda-dist-blocked", "--device", "cpu"])
    assert rc_j == rc_t == 0
    assert _shape(out_t, "cuda-", "tpu-") == _shape(out_j, "", "")
    err = float(out_t.strip().splitlines()[-1].split()[-1])
    assert err <= 1e-4
    rc, out = _cli(tmm.main, ["32", "--engines", "cuda-dist", "-t", "2",
                              "--device", "cpu"])
    assert rc == 0 and out.startswith("CUDA-Dist (sharded) time: ")
    assert out.strip().endswith("verify: OK")
    # No card: a cuda-dist backend fails instead of running on the CPU.
    from gauss_tpu_torch.cli import gauss_internal

    with pytest.raises(RuntimeError, match="none is available"):
        _cli(gauss_internal.main, ["-s", "16", "--backend", "cuda-dist"])

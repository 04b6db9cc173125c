"""The port's panel-blocked distributed LU (``gauss_tpu_torch.dist
.gauss_dist_blocked``) against the JAX package's on the same seeded
inputs: the JAX engine on a mesh of P of the conftest's 8 virtual CPU
devices, the port on P ranks of one gloo world of 8 started once for the
module (:class:`gauss_tpu_torch.dist.launch.World`).

Tolerances: the composed permutation is equal (random systems, every
column's maximum unique); x and the factor agree to 2e-4 relative to their
largest entry (float32 throughout; the port's panel is kernel 1's plain
version, the JAX package's its stock swap panel); the refined entries pass
the JAX tests' gates. On the card (``cuda`` marker): kernel 1 on the
engine's strip against its plain version, and the engine on an NCCL
world of one.
"""

import numpy as np
import pytest
import torch

from gauss_tpu_torch.dist import gauss_dist_blocked as tgdb
from gauss_tpu_torch.dist import launch

REL = 2e-4


@pytest.fixture(scope="module")
def world():
    with launch.World(8, device="cpu") as w:
        yield w


def _system(n, seed=0, dominant=2.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + dominant * np.sqrt(n) * np.eye(n)
    a[:, ::3] *= 0.5  # keep pivoting alive off the diagonal
    rng.shuffle(a)
    return a.astype(np.float32), rng.standard_normal(n).astype(np.float32)


def _jax_factor(a, b, P, panel, abft=False):
    from gauss_tpu.dist import gauss_dist_blocked as jgdb
    from gauss_tpu.dist.mesh import make_mesh

    mesh = make_mesh(P)
    x, fac = jgdb.factor_solve_dist_blocked_staged(
        jgdb.prepare_dist_blocked(a, b, mesh, panel=panel), mesh, abft=abft)
    return np.asarray(x), fac


def _port_factor(world, a, b, P, panel, abft=False):
    calls = [(tgdb.prepare_dist_blocked, (a, b), {"panel": panel}),
             (tgdb.factor_solve_dist_blocked_staged, (), {"abft": abft})]
    out = world.run(launch.chained, calls, mesh=(P,))[:P]
    return out


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("P,n,panel", [(1, 16, 8), (2, 40, 8), (4, 64, 16),
                                       (8, 192, 16), (8, 77, 8), (4, 130, 8),
                                       (2, 192, 16)])
def test_factor_matches_jax(world, P, n, panel):
    a, b = _system(n, seed=n + P)
    xj, fj = _jax_factor(a, b, P, panel)
    ranks = _port_factor(world, a, b, P, panel)
    x0, fac0 = ranks[0]
    for x, fac in ranks:     # replicated: every rank the same x and perm
        assert torch.equal(x, x0) and torch.equal(fac["perm"], fac0["perm"])
    assert fac0["npad"] == fj.npad and fac0["panel"] == fj.panel == panel
    assert np.array_equal(fac0["perm"].numpy(), np.asarray(fj.perm))
    assert (np.asarray(fj.perm)[:n] != np.arange(n)).any()  # it pivots
    _close(x0, xj)
    # The factor: the ranks' local rows in rank order are the JAX
    # package's global (sharded) layout.
    a_fac = torch.cat([fac["a_fac"] for _, fac in ranks]).numpy()
    _close(a_fac, np.asarray(fj.a_fac))
    _close(float(fac0["min_piv"]), float(fj.min_piv))


@pytest.mark.parametrize("P,n", [(1, 48), (4, 100), (8, 192)])
def test_refined_passes_the_jax_gate(world, P, n):
    """The refined entry: float64 x to the JAX tests' gate (relative
    residual <= 1e-10 after 2 host-f64 iterations), like the JAX one."""
    from gauss_tpu.dist import gauss_dist_blocked as jgdb
    from gauss_tpu.dist.mesh import make_mesh

    a, b = _system(n, seed=7 * n, dominant=1.0)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    xj = jgdb.gauss_solve_dist_blocked_refined(a64, b64, mesh=make_mesh(P),
                                               panel=8)
    xt = world.run(tgdb.gauss_solve_dist_blocked_refined, a64, b64,
                   panel=8, mesh=(P,))[0]
    assert xt.dtype == np.float64
    for x in (xt, xj):
        res = np.linalg.norm(a64 @ x - b64) / np.linalg.norm(b64)
        assert res <= 1e-10, res
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_abft_bit_identical_to_plain(world, P):
    """The checksum rider changes no bit of the solve (the contract of the
    JAX package's test_dist_blocked_abft_bit_identical, whose JAX
    abft=True path is red under JAX 0.9.0); both agree with the JAX
    abft=False solve, and a clean run's per-panel mismatches sit under the
    detection threshold."""
    from gauss_tpu.dist import gauss_dist_blocked as jgdb
    from gauss_tpu.dist.mesh import make_mesh

    n = 96
    a, b = _system(n, seed=11)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    plain = world.run(tgdb.gauss_solve_dist_blocked_refined, a64, b64,
                      panel=8, mesh=(P,))[:P]
    abft = world.run(tgdb.gauss_solve_dist_blocked_refined, a64, b64,
                     panel=8, abft=True, mesh=(P,))[:P]
    for x, y in zip(plain, abft):
        assert x.tobytes() == y.tobytes()
    xj = jgdb.gauss_solve_dist_blocked_refined(a64, b64, mesh=make_mesh(P),
                                               panel=8)
    np.testing.assert_allclose(abft[0], xj, rtol=1e-9, atol=1e-12)
    _, fac = _port_factor(world, a, b, P, 8, abft=True)[0]
    errs = fac["abft_err"].numpy()
    assert errs.shape == (n // 8,) and np.all(errs < 1e-3), errs


def test_singular_input_matches_jax(world):
    """A singular system: the JAX engine does not raise, min |pivot| is 0
    and x is not finite; the port's the same."""
    n = 32
    a = np.ones((n, n), np.float32)
    b = np.ones(n, np.float32)
    xj, fj = _jax_factor(a, b, 2, 8)
    x, fac = _port_factor(world, a, b, 2, 8)[0]
    assert float(fj.min_piv) == float(fac["min_piv"]) == 0.0
    assert not np.all(np.isfinite(xj)) and not torch.isfinite(x).all()


def test_handoff_dist_lane_on_two_ranks(world):
    """A request past the single-card budget with a 2-rank mesh lands on
    the dist lane (route event) and passes the gate."""
    from gauss_tpu_torch.core import blocked as tb

    n = 80
    a, b = _system(n, seed=3)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    out = world.run(launch.recorded, tb.solve_handoff, a64, b64, budget=16,
                    mesh=(2,))[:2]
    for x, events in out:
        res = np.linalg.norm(a64 @ x - b64) / np.linalg.norm(b64)
        assert res <= 1e-4, res
        (route,) = [ev for ev in events if ev["type"] == "route"]
        assert route["lane"] == "dist" and route["devices"] == 2
        assert route["est_bytes"] == 3 * n * n * 4 and route["budget"] == 16
    assert out[0][0].tobytes() == out[1][0].tobytes()


def test_fold_pivot_rows_matches_transposition_fold():
    """Folding the chosen rows into swaps gives the JAX package's
    transposition fold of the same panel."""
    from gauss_tpu_torch.core.blocked import (_fold_transpositions,
                                              panel_factor_swap)
    from gauss_tpu_torch.kernels.panel import panel_factor_plain

    rng = np.random.default_rng(5)
    p = torch.as_tensor(rng.standard_normal((37, 8)), dtype=torch.float32)
    _, ipiv_swap, _ = panel_factor_swap(p, 0)
    _, ipiv_rows, _, _ = panel_factor_plain(p, 0)
    want = _fold_transpositions(ipiv_swap, 37).tolist()
    assert tgdb.fold_pivot_rows(ipiv_rows.tolist(), 37) == want
    moved = sum(i != r for i, r in enumerate(want))
    assert moved <= 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel 1 and NCCL have no CPU mode "
                    "(run `python -m pytest -m cuda tests/` or "
                    "`python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("npad,panel,kb", [(1024, 128, 0), (1024, 128, 896),
                                           (8192, 128, 256)])
def test_kernel1_on_the_strip_matches_plain_on_card(cuda_device, npad, panel,
                                                    kb):
    from gauss_tpu_torch.kernels import panel as kpanel

    rng = np.random.default_rng(npad + kb)
    strip = torch.as_tensor(rng.standard_normal((npad, panel)),
                            dtype=torch.float32, device=cuda_device)
    got = tgdb.factor_strip(strip, kb)
    p, ipiv, perm, mp = kpanel.panel_factor_plain(strip[kb:].contiguous(), 0)
    want_swap = tgdb.fold_pivot_rows(ipiv.tolist(), npad - kb)
    assert got[1][kb:].tolist() == [kb + i for i in want_swap]
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(npad - kb, device=cuda_device)
    want = strip.clone()
    want[kb:] = p[inv[torch.as_tensor(want_swap, device=cuda_device)]]
    assert torch.equal(got[0], want) and float(got[2]) == float(mp)


@pytest.mark.cuda
def test_argmax_takes_the_first_nan_on_card(cuda_device):
    """The per-row engines elect pivots with ``torch.argmax``: on the card
    too it takes the first NaN, else the first maximum (``jnp.argmax``'s
    rule), against the explicit rule of the plain panel."""
    from gauss_tpu_torch.kernels.panel import argmax_nan_first

    rng = np.random.default_rng(2)
    for _ in range(100):
        v = rng.integers(0, 3, size=int(rng.integers(1, 5000))).astype(
            np.float32)
        if rng.random() < 0.5:
            v[rng.integers(0, len(v), size=2)] = np.nan
        t = torch.as_tensor(v, device=cuda_device)
        assert int(torch.argmax(t)) == int(argmax_nan_first(t))


@pytest.mark.cuda
def test_nccl_world_of_one_on_card(cuda_device):
    from gauss_tpu_torch.dist import multihost

    n = 512
    a, b = _system(n, seed=9)
    try:
        x = tgdb.gauss_solve_dist_blocked_refined(
            a.astype(np.float64), b.astype(np.float64), device="cuda")
        assert torch.distributed.get_backend() == "nccl"
    finally:
        multihost.shutdown()
    res = np.linalg.norm(a.astype(np.float64) @ x - b) / np.linalg.norm(b)
    assert res <= 1e-6


def test_chip_smoke_dist_phase_rehearsal(monkeypatch):
    """Phase 14 end to end at small sizes on the CPU (gloo in place of
    NCCL, the kernels' plain versions, so kernel 1's launches are 0 and
    the held calls one a panel): the engines' legs with their refinement
    gate and collectives, the four CLI backends, the external and matmul
    runs, the multihost stream and its aggregate, and the native engines
    from a clean build."""
    import io
    import sys
    from contextlib import redirect_stdout
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(repo)
    for name, value in (("DEVICE", "cpu"), ("DIST_N", 256),
                        ("DIST_WARM_N", 64), ("DIST_CLI_N", 96),
                        ("NATIVE_N", 48)):
        monkeypatch.setattr(cs, name, value)
    buf = io.StringIO()
    with redirect_stdout(buf):
        la, lbc, figs = cs.phase_dist()
    assert not any(la.values()) and not any(lbc.values())
    legs = figs["a"]["legs"]
    nb = 256 // legs["cuda-dist-blocked"]["panel"]
    # The factor: a gather and two psums a panel, two pmins; one solve
    # against it: two psums a panel.
    assert legs["cuda-dist-blocked"]["collectives"] == {
        "all_gather": nb, "pmin": 2, "psum": 2 * nb + 2 * nb}
    assert legs["cuda-dist-blocked2d"]["rel_residual"] <= 1e-4
    assert sum(figs["a"]["held"].values()) == nb
    assert set(figs["b"]["lines"]) == {*cs.DIST_BACKENDS,
                                       "external cuda-dist-blocked",
                                       "external backward error",
                                       "matmul cuda-dist"}
    assert figs["c"]["collectives"]["all_gather"] > 0
    assert len(figs["d"]["lines"]) == 6
    assert '{"dist": ' in buf.getvalue()

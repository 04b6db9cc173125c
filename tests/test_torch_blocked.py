"""The port's blocked LU, solves and refinement against the JAX package's
``core/blocked.py`` (the same float32 inputs on both sides), plus the
port-internal properties (padding invariance, routes, device contract)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.core import blocked as jb
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.core import convert
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.verify import checks

# Factor fields: f32 factorizations in two frameworks (different rounding
# in the panel updates and the trailing association) on random matrices
# with real pivoting; m, linv and uinv compared relative to max |m|.
TOL_FACTOR = 5e-5
# min |pivot| relative to max |m|: the smallest pivot of a random matrix
# is its most cancellation-prone entry (relative to itself it differs by
# up to ~1e-4 between the frameworks at n=130).
TOL_MINPIV = 1e-5


def _matrix(n, seed):
    return np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)


def _compare(fj, ft):
    np.testing.assert_array_equal(ft.perm.numpy(), np.asarray(fj.perm))
    scale = np.abs(np.asarray(fj.m)).max()
    for field in ("m", "linv", "uinv"):
        np.testing.assert_allclose(getattr(ft, field).numpy(),
                                   np.asarray(getattr(fj, field)), rtol=0,
                                   atol=TOL_FACTOR * scale)
    assert abs(float(ft.min_abs_pivot) - float(fj.min_abs_pivot)) <= (
        TOL_MINPIV * scale)


@pytest.mark.parametrize("n", [64, 100, 130, 256])
@pytest.mark.parametrize("panel", [16, 32])
def test_fused_route_matches_jax(n, panel):
    """Plain fused kernel on every panel but the last, plain panel kernel
    on the last — against the JAX unrolled factor with panel_impl='fused'."""
    a = _matrix(n, n + panel)
    fj = jb.lu_factor_blocked_unrolled(jnp.asarray(a), panel=panel,
                                       panel_impl="fused")
    ft = tb.lu_factor_blocked_unrolled(a, panel=panel, panel_impl="fused",
                                       device="cpu")
    _compare(fj, ft)


@pytest.mark.parametrize("impl", ["pallas", "jax"])
@pytest.mark.parametrize("n,panel", [(100, 16), (256, 32)])
def test_unfused_routes_match_jax(impl, n, panel):
    a = _matrix(n, 3 * n + panel)
    fj = jb.lu_factor_blocked_unrolled(jnp.asarray(a), panel=panel,
                                       panel_impl=impl)
    ft = tb.lu_factor_blocked_unrolled(a, panel=panel, panel_impl=impl,
                                       device="cpu")
    _compare(fj, ft)


def test_auto_route_at_panel_64_matches_jax_fused():
    """'auto' fuses at panel >= 64 (the TPU route) on every device."""
    a = _matrix(256, 9)
    fj = jb.lu_factor_blocked_unrolled(jnp.asarray(a), panel=64,
                                       panel_impl="fused")
    ft = tb.lu_factor_blocked_unrolled(a, panel=64, device="cpu")
    _compare(fj, ft)


@pytest.mark.parametrize("n,panel", [(100, 16), (256, 32)])
def test_lu_solve_across_frameworks(n, panel):
    """A JAX factor solved by the port and a port factor solved by JAX."""
    a = _matrix(n, 5 * n)
    b = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    fj = jb.lu_factor_blocked_unrolled(jnp.asarray(a), panel=panel,
                                       panel_impl="fused")
    ft = tb.lu_factor_blocked_unrolled(a, panel=panel, panel_impl="fused",
                                       device="cpu")
    want = np.asarray(jb.lu_solve(fj, jnp.asarray(b)))
    scale = np.abs(want).max()
    x1 = tb.lu_solve(convert.blocked_lu_from_numpy(
        *convert.blocked_lu_to_numpy(fj), device="cpu"), b).numpy()
    np.testing.assert_allclose(x1, want, rtol=0, atol=1e-5 * scale)
    arrays = [None if v is None else jnp.asarray(v)
              for v in convert.blocked_lu_to_numpy(ft)]
    x2 = np.asarray(jb.lu_solve(jb.BlockedLU(*arrays), jnp.asarray(b)))
    np.testing.assert_allclose(x2, tb.lu_solve(ft, b).numpy(), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("n", [64, 130])
def test_solve_refined_gate_and_parity(n):
    rng = np.random.default_rng(77 + n)
    a = rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    x, fac = tb.solve_refined(a, b, panel=32, device="cpu")
    xj, _ = jb.solve_refined(a, b, panel=32)
    assert checks.residual_norm(a, x, b) < 1e-4
    assert checks.max_rel_error(x, np.asarray(xj, np.float64)) < 1e-6
    assert fac.m.dtype == torch.float32


def test_solve_refined_internal_system_exact():
    from gauss_tpu_torch.io import synthetic

    n = 200
    x, _ = tb.solve_refined(synthetic.internal_matrix(n),
                            synthetic.internal_rhs(n), device="cpu")
    assert checks.internal_pattern_ok(x, atol=1e-4)


@pytest.mark.parametrize("n,panel", [(100, 16), (130, 32)])
def test_padding_invariance(n, panel):
    """n % panel != 0: the factor of A equals the factor of the explicitly
    identity-padded matrix, and the solve is bit-identical."""
    a = _matrix(n, 11 + n)
    b = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    npad = -(-n // panel) * panel
    ap = np.eye(npad, dtype=np.float32)
    ap[:n, :n] = a
    bp = np.zeros(npad, np.float32)
    bp[:n] = b
    f1 = tb.lu_factor_blocked_unrolled(a, panel=panel, device="cpu")
    f2 = tb.lu_factor_blocked_unrolled(ap, panel=panel, device="cpu")
    assert torch.equal(f1.m, f2.m) and torch.equal(f1.perm, f2.perm)
    assert torch.equal(tb.lu_solve(f1, b), tb.lu_solve(f2, bp)[:n])
    assert torch.equal(f1.m[n:, n:], torch.eye(npad - n))


def test_substitution_method_and_multi_rhs(rng):
    n = 96
    a = _matrix(n, 4)
    fac = tb.lu_factor_blocked_unrolled(a, panel=32, device="cpu")
    bmat = rng.standard_normal((n, 3)).astype(np.float32)
    xa = tb.lu_solve(fac, bmat)
    xs = tb.lu_solve(fac, bmat, method="substitution")
    assert xa.shape == (n, 3)
    np.testing.assert_allclose(xa.numpy(), xs.numpy(), atol=1e-4)
    np.testing.assert_allclose(a.astype(np.float64) @ xa.numpy(), bmat,
                               atol=1e-3)


def test_bf16x3_trailing_refines_to_gate(rng):
    n = 128
    a = rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    fac = tb.lu_factor_blocked_unrolled(a, panel=32, panel_impl="pallas",
                                        gemm_precision="high", device="cpu")
    x = tb.lu_solve(fac, b).double().numpy()
    for _ in range(3):
        x = x + tb.lu_solve(fac, b - a @ x).double().numpy()
    assert checks.residual_norm(a, x, b) < 1e-4


def test_triangular_inverses(rng):
    for p in (16, 100, 256):
        low = np.tril(rng.standard_normal((p, p)) * 0.1, -1) + np.eye(p)
        up = np.triu(rng.standard_normal((p, p))) + 4 * np.eye(p)
        li = tb.unit_lower_inv(torch.from_numpy(low)).numpy()
        ui = tb.upper_inv(torch.from_numpy(up)).numpy()
        np.testing.assert_allclose(li @ low, np.eye(p), atol=1e-10)
        np.testing.assert_allclose(ui @ up, np.eye(p), atol=1e-10)


def test_auto_panel_and_resolve_factor():
    for n in (8, 1000, 1024, 2048, 4096, 12288, 12800, 20000):
        assert tb.auto_panel(n) == jb.auto_panel(n)
    assert tb.resolve_factor(2048, "auto") is tb.lu_factor_blocked_unrolled
    assert tb.resolve_factor(64, True) is tb.lu_factor_blocked_unrolled
    # The flat and chunked forms are routes now: forced, and by size.
    assert tb.resolve_factor(64, False) is tb.lu_factor_blocked
    assert tb.resolve_factor(64, "chunked") is tb.lu_factor_blocked_chunked
    assert tb.resolve_factor(64, "auto", device="cpu") is tb.lu_factor_blocked
    assert tb.resolve_factor(64, "auto") is tb.lu_factor_blocked_unrolled
    assert tb.resolve_factor(8192, "auto") is tb.lu_factor_blocked_chunked
    f = tb.resolve_factor(12800, "auto", device="cpu")
    assert f.func is tb.lu_factor_blocked_chunked and f.keywords == {
        "chunk": 8}
    with pytest.raises(ValueError, match="unknown unroll"):
        tb.resolve_factor(64, "bogus")
    with pytest.raises(ValueError):
        tb.lu_factor_blocked_unrolled(np.eye(4), panel_impl="mosaic",
                                      device="cpu")


def test_cpu_route_launches_nothing():
    _build.reset_launches()
    tb.lu_factor_blocked_unrolled(_matrix(128, 1), panel=64, device="cpu")
    assert sum(_build.LAUNCHES.values()) == 0


def test_no_device_means_cuda(monkeypatch):
    """Without device= the entry points run on CUDA or raise: never a
    quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.lu_factor_blocked_unrolled(np.eye(8))
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.solve_refined(np.eye(8), np.ones(8))
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.gauss_solve_blocked(np.eye(8), np.ones(8))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the blocked route launches the "
                    "CUDA kernels (run `python -m pytest -m cuda tests/` or "
                    "`python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_factor_matches_cpu_plain(cuda_device):
    """The n=512 auto route on the card (3 fused launches + 1 launch of
    the cluster panel kernel) against the plain versions on the CPU."""
    a = _matrix(512, 21)
    _build.reset_launches()
    fg = tb.lu_factor_blocked_unrolled(a, panel=128, device=cuda_device)
    assert _build.LAUNCHES["panel_trailing_fused"] == 3
    assert _build.LAUNCHES["panel_factor_cluster"] == 1
    assert _build.LAUNCHES["panel_factor"] == 0
    fc = tb.lu_factor_blocked_unrolled(a, panel=128, device="cpu")
    assert torch.equal(fg.perm.cpu(), fc.perm)
    scale = float(fc.m.abs().max())
    assert float((fg.m.cpu() - fc.m).abs().max()) <= TOL_FACTOR * scale

"""The serving lane's batched factorizations against the JAX package's
``jax.vmap`` forms on the CPU: the batched fused kernel's plain version
against ``jax.vmap(panel_trailing_fused_pallas)`` and the bfloat16
batched panel kernel's against ``jax.vmap(panel_factor_pallas)`` (both in
interpret mode), ``lu_factor_blocked_batched`` against
``jax.vmap(lu_factor_blocked)`` through the batched converter and against
the port's own ``lu_factor_blocked`` per member, ``lu_solve_batched``,
and the batched Cholesky against ``jax.vmap(cholesky_factor_blocked)``.
``cuda``-marked tests hold the three batched kernels to their plain
versions and to the single-stack kernels on the card."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gauss_tpu.core import blocked as jblocked
from gauss_tpu.kernels.panel_fused_pallas import panel_trailing_fused_pallas
from gauss_tpu.kernels.panel_pallas import panel_factor_pallas
from gauss_tpu.structure import cholesky as jchol
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.core import convert
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.kernels import panel as kp
from gauss_tpu_torch.kernels import panel_fused as kf
from gauss_tpu_torch.structure import cholesky as tchol

CPU = "cpu"
BF16 = torch.bfloat16
#: The fused kernel's float32 block against the JAX kernel (rtol = atol):
#: tests/test_torch_fused.py's bound (forward substitution there, a
#: Neumann series in the JAX kernel).
TOL = 5e-5
#: A bfloat16 trailing block against the JAX kernel, relative to its max:
#: tests/test_torch_lowered.py's two bfloat16 ulps.
TRAIL_TOL_BF16 = 2 * 2.0 ** -7
#: Factor fields against the JAX package, relative to max |m|:
#: tests/test_torch_blocked.py's bound.
TOL_FACTOR = 5e-5
#: linv/uinv of the batched factor against the single one: float32
#: rounding (batched and single products may round apart), relative to
#: the field's max.
TOL_INV = 4 * 2.0 ** -24


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _dominant_stack(rng, bsz, n):
    a = rng.standard_normal((bsz, n, n))
    a[:, np.arange(n), np.arange(n)] += float(n)
    return a


# --- the batched fused kernel's plain version --------------------------------


@pytest.mark.parametrize("bsz,h,w,panel,col0", [(3, 64, 96, 16, 0),
                                                (2, 96, 96, 32, 32),
                                                (4, 48, 48, 16, 32)])
def test_fused_batched_plain_matches_vmapped_jax_f32(rng, bsz, h, w, panel,
                                                     col0):
    x = rng.standard_normal((bsz, h, w)).astype(np.float32)
    jf = jax.vmap(lambda m: panel_trailing_fused_pallas(
        m, col0, 0, panel=panel, interpret=True))
    want = [np.asarray(o) for o in jf(jnp.asarray(x))]
    stack = torch.from_numpy(x.copy())
    got = kf.panel_trailing_fused_batched(stack, col0, 0, panel=panel)
    assert got[4] is stack
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(stack.numpy(), want[4], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=1e-6)
    np.testing.assert_array_equal(stack.numpy()[:, :, :col0 + panel],
                                  x[:, :, :col0 + panel])


@pytest.mark.parametrize("bsz,h,w,panel,fseg", [(2, 64, 64, 16, 8),
                                                (3, 96, 128, 32, 16)])
def test_fused_batched_plain_matches_vmapped_jax_bf16(rng, bsz, h, w, panel,
                                                      fseg):
    x = rng.standard_normal((bsz, h, w)).astype(ml_dtypes.bfloat16)
    jf = jax.vmap(lambda m: panel_trailing_fused_pallas(
        m, 0, 0, panel=panel, seg=panel, fseg=fseg, ct=panel,
        interpret=True))
    want = [np.asarray(o, np.float32) if o.dtype != jnp.int32
            else np.asarray(o) for o in jf(jnp.asarray(x))]
    stack = torch.from_numpy(np.asarray(x, np.float32)).to(BF16)
    got = kf.panel_trailing_fused_batched(stack, 0, 0, panel=panel,
                                          fseg=fseg)
    np.testing.assert_array_equal(_np32(got[0]), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(_np32(got[3]), want[3])
    out = _np32(stack)
    for i in range(bsz):
        scale = np.abs(want[4][i]).max()
        assert np.abs(out[i] - want[4][i]).max() <= TRAIL_TOL_BF16 * scale


def test_fused_batched_plain_is_kernel_2_per_member(rng):
    """Each member bit for bit the single-block plain version, on a
    strided view (the live rows of a stack, as the batched LU passes
    them)."""
    full = torch.as_tensor(rng.standard_normal((3, 80, 80)),
                           dtype=torch.float32)
    ref = full.clone()
    got = kf.panel_trailing_fused_batched(full[:, 16:], 16, 0, panel=16)
    for i in range(3):
        one = kf.panel_trailing_fused(ref[i, 16:], 16, 0, panel=16)
        for g, w in zip(got[:4], one[:4]):
            assert torch.equal(g[i], w)
    assert torch.equal(full, ref)


def test_fused_batched_argument_checks():
    with pytest.raises(ValueError, match="panel_trailing_fused_batched"):
        kf.panel_trailing_fused_batched(torch.zeros(8, 8), 0, 0, panel=4)
    with pytest.raises(ValueError, match="exceeds"):
        kf.panel_trailing_fused_batched(torch.zeros(2, 8, 8), 6, 0, panel=4)
    with pytest.raises(ValueError, match="rows at or below"):
        kf.panel_trailing_fused_batched(torch.zeros(2, 8, 8), 0, 6, panel=4)


# --- the bfloat16 batched panel kernel's plain version -------------------------


@pytest.mark.parametrize("bsz,h,panel,kb", [(3, 64, 16, 0), (2, 96, 32, 32)])
def test_batched_panel_plain_bf16_matches_vmapped_jax(rng, bsz, h, panel, kb):
    x = rng.standard_normal((bsz, h, panel)).astype(ml_dtypes.bfloat16)
    jp = jax.vmap(lambda m: panel_factor_pallas(m, kb, interpret=True,
                                                seg=panel))
    want = jp(jnp.asarray(x))
    got = kp.panel_factor_batched(
        torch.from_numpy(np.asarray(x, np.float32)).to(BF16), kb)
    assert got[0].dtype == BF16 and got[3].dtype == BF16
    np.testing.assert_array_equal(_np32(got[0]), np.asarray(want[0],
                                                            np.float32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(_np32(got[3]), np.asarray(want[3],
                                                            np.float32))


# --- lu_factor_blocked_batched -------------------------------------------------


@pytest.mark.parametrize("n,panel", [(40, 16), (64, 16), (100, 32)])
def test_batched_lu_matches_vmapped_jax(rng, n, panel):
    a = _dominant_stack(rng, 3, n)
    want = jax.vmap(lambda m: jblocked.lu_factor_blocked(m, panel=panel))(
        jnp.asarray(a, jnp.float32))
    want = convert.blocked_lu_batched_to_numpy(want)
    fac = tb.lu_factor_blocked_batched(a, panel=panel, device=CPU)
    got = convert.blocked_lu_batched_to_numpy(fac)
    np.testing.assert_array_equal(got[1], want[1])
    scale = np.abs(want[0]).max()
    for g, w in zip((got[0], got[3], got[4]), (want[0], want[3], want[4])):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= TOL_FACTOR * scale
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    # The converter's other direction: the JAX factor solved by the port.
    back = convert.blocked_lu_batched_from_numpy(*want, device=CPU)
    b = rng.standard_normal((3, n))
    x = tb.lu_solve_batched(back, b).numpy()
    for i in range(3):
        assert np.linalg.norm(a[i] @ x[i] - b[i]) <= 1e-5 * np.linalg.norm(
            b[i])


@pytest.mark.parametrize("n,panel,dtype", [(64, 16, torch.float32),
                                           (130, 64, torch.float32),
                                           (96, 32, BF16), (200, None,
                                                            torch.float32)])
def test_batched_lu_is_the_single_factor_per_member(rng, n, panel, dtype):
    """m, perm and min |pivot| bit for bit lu_factor_blocked on each
    member (both routes: unfused at panel < 64, fused from 64); linv and
    uinv within float32 rounding."""
    a = torch.as_tensor(_dominant_stack(rng, 3, n),
                        dtype=torch.float32).to(dtype)
    fac = tb.lu_factor_blocked_batched(a, panel=panel, device=CPU)
    assert fac.m.dtype == dtype and fac.linv.dtype == torch.float32
    for i in range(3):
        one = tb.lu_factor_blocked(a[i], panel=panel, device=CPU)
        assert torch.equal(fac.m[i], one.m)
        assert torch.equal(fac.perm[i], one.perm)
        assert torch.equal(fac.min_abs_pivot[i], one.min_abs_pivot)
        for f in ("linv", "uinv"):
            g, w = getattr(fac, f)[i], getattr(one, f)
            assert float((g - w).abs().max()) <= TOL_INV * float(
                w.abs().max())


def test_batched_lu_solve_and_padding_invariance(rng):
    """lu_solve_batched through the batched factor solves each member; a
    member identity-padded to a bucket solves to the same bits at its
    own rows and exactly 0 in the pad."""
    from gauss_tpu_torch.serve import buckets

    n, bucket = 20, 64
    a = _dominant_stack(rng, 2, n)
    b = rng.standard_normal((2, n))
    x = tb.lu_solve_batched(tb.lu_factor_blocked_batched(
        a, panel=16, device=CPU), b).numpy()
    for i in range(2):
        assert np.linalg.norm(a[i] @ x[i] - b[i]) <= 1e-5 * np.linalg.norm(
            b[i])
    pad = [buckets.pad_system(a[i], b[i], bucket) for i in range(2)]
    ap = np.stack([p[0] for p in pad])
    bp = np.stack([p[1] for p in pad])
    xp = tb.lu_solve_batched(tb.lu_factor_blocked_batched(
        ap, panel=16, device=CPU), bp).numpy()
    np.testing.assert_array_equal(xp[:, :n, 0], x.astype(np.float32))
    np.testing.assert_array_equal(xp[:, n:], 0.0)


def test_batched_lu_routes_one_launch_per_step(monkeypatch, rng):
    """One batched call per panel step: fused while columns remain right
    of the panel (panel >= 64), the batched panel kernel on the last."""
    calls = []
    real_f, real_p = kf.panel_trailing_fused_batched, kp.panel_factor_batched
    monkeypatch.setattr(kf, "panel_trailing_fused_batched",
                        lambda s, c, k, **kw: calls.append(("fused", c))
                        or real_f(s, c, k, **kw))
    monkeypatch.setattr(kp, "panel_factor_batched",
                        lambda p, kb=0: calls.append(("panel", p.shape[1]))
                        or real_p(p, kb))
    tb.lu_factor_blocked_batched(_dominant_stack(rng, 2, 256), panel=64,
                                 device=CPU)
    assert calls == [("fused", 0), ("fused", 64), ("fused", 128),
                     ("panel", 64)]
    del calls[:]
    tb.lu_factor_blocked_batched(_dominant_stack(rng, 2, 64), panel=32,
                                 device=CPU)
    assert calls == [("panel", 64), ("panel", 32)]


def test_batched_lu_argument_checks():
    with pytest.raises(ValueError, match="stack"):
        tb.lu_factor_blocked_batched(np.zeros((4, 4)), device=CPU)
    with pytest.raises(ValueError, match="panel_impl"):
        tb.lu_factor_blocked_batched(np.zeros((1, 4, 4)), panel_impl="x",
                                     device=CPU)
    fac = tb.lu_factor_blocked_batched(np.eye(4)[None], panel=4, device=CPU)
    with pytest.raises(ValueError, match="B=1"):
        tb.lu_solve_batched(fac, np.zeros((2, 4)))


def test_batched_lu_swap_panel_and_split_gemm(rng):
    """panel_impl="jax" (the stock swap panel) and gemm_precision="bf16x3"
    are the single factor's per member, as in the flat form."""
    a = torch.as_tensor(_dominant_stack(rng, 2, 48), dtype=torch.float32)
    for kw in ({"panel_impl": "jax"}, {"gemm_precision": "bf16x3"}):
        fac = tb.lu_factor_blocked_batched(a, panel=16, device=CPU, **kw)
        for i in range(2):
            one = tb.lu_factor_blocked(a[i], panel=16, device=CPU, **kw)
            assert torch.equal(fac.perm[i], one.perm)
            scale = float(one.m.abs().max())
            assert float((fac.m[i] - one.m).abs().max()) <= 1e-6 * scale


# --- the batched Cholesky ---------------------------------------------------


@pytest.mark.parametrize("n,panel", [(40, 16), (64, 32)])
def test_batched_cholesky_matches_vmapped_jax(rng, n, panel):
    from gauss_tpu_torch.io import synthetic

    a = np.stack([synthetic.spd_matrix(n) + 0.1 * i * np.eye(n)
                  for i in range(3)])
    want = jax.vmap(lambda m: jchol.cholesky_factor_blocked(m, panel=panel))(
        jnp.asarray(a, jnp.float32))
    fac = tchol.cholesky_factor_blocked_batched(a, panel=panel, device=CPU)
    scale = float(np.abs(np.asarray(want.m)).max())
    np.testing.assert_allclose(np.tril(fac.m.numpy()),
                               np.tril(np.asarray(want.m)),
                               atol=TOL_FACTOR * scale)
    np.testing.assert_allclose(fac.linv.numpy(), np.asarray(want.linv),
                               atol=TOL_FACTOR * scale)
    np.testing.assert_allclose(fac.min_diag.numpy(),
                               np.asarray(want.min_diag), rtol=1e-6)
    b = rng.standard_normal((3, n, 2))
    x = tchol.cholesky_solve_batched(fac, b).numpy()
    jx = np.asarray(jax.vmap(jchol.cholesky_solve)(want, jnp.asarray(
        b, jnp.float32)))
    np.testing.assert_allclose(x, jx, rtol=1e-4, atol=1e-5)
    for i in range(3):
        one = tchol.cholesky_factor_blocked_unrolled(a[i], panel=panel,
                                                     device=CPU)
        assert torch.equal(torch.tril(fac.m[i]), torch.tril(one.m))


def test_batched_cholesky_flags_a_non_spd_member(rng):
    a = np.stack([np.eye(8), -np.eye(8)])
    fac = tchol.cholesky_factor_blocked_batched(a, panel=4, device=CPU)
    assert float(fac.min_diag[0]) == 1.0 and float(fac.min_diag[1]) <= 0.0


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode "
                    "(run `python -m pytest -m cuda tests/` or "
                    "`python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,h,w,panel,dtype", [
    (3, 512, 512, 128, torch.float32), (2, 300, 700, 64, torch.float32),
    (2, 4096, 768, 256, torch.float32), (3, 512, 512, 128, BF16)])
def test_fused_batched_kernel_on_card(cuda_device, bsz, h, w, panel, dtype):
    """One launch per stack; every member bit for bit kernel 2 on it alone
    (both phase-A routes), pivots equal to the plain version's."""
    x = torch.as_tensor(np.random.default_rng(h + w).standard_normal(
        (bsz, h, w)), dtype=torch.float32, device=cuda_device).to(dtype)
    key = "panel_trailing_fused_batched" + ("_bf16" if dtype == BF16
                                            else "")
    before = _build.LAUNCHES[key]
    work = x.clone()
    got = kf.panel_trailing_fused_batched(work, 0, 0, panel=panel)
    assert _build.LAUNCHES[key] == before + 1
    for i in range(bsz):
        single = x[i].clone()
        one = kf.panel_trailing_fused(single, 0, 0, panel=panel)
        for g, o in zip(got[:4], one[:4]):
            assert torch.equal(g[i], o)
        assert torch.equal(work[i], single)
        plain = kf.panel_trailing_fused_plain(x[i].clone(), 0, 0,
                                              panel=panel)
        assert torch.equal(got[1][i], plain[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128, 128), (64, 128, 128),
                                   (3, 700, 128)])
def test_batched_panel_kernel_bf16_on_card(cuda_device, shape):
    x = torch.as_tensor(np.random.default_rng(shape[0]).standard_normal(
        shape), dtype=BF16, device=cuda_device)
    before = _build.LAUNCHES["panel_factor_batched_bf16"]
    got = kp.panel_factor_batched(x.clone())
    assert _build.LAUNCHES["panel_factor_batched_bf16"] == before + 1
    for g, w in zip(got, kp.panel_factor_batched_plain(x.clone())):
        assert torch.equal(g, w)
    for i in range(shape[0]):
        for g, w in zip(got, kp.panel_factor(x[i].clone())):
            assert torch.equal(g[i], w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", [(256, torch.float32),
                                     (1024, torch.float32), (512, BF16)])
def test_batched_lu_on_card_is_the_single_factor(cuda_device, n, dtype):
    rng = np.random.default_rng(n)
    a = torch.as_tensor(_dominant_stack(rng, 4, n), dtype=torch.float32,
                        device=cuda_device).to(dtype)
    fac = tb.lu_factor_blocked_batched(a, device=cuda_device)
    for i in range(4):
        one = tb.lu_factor_blocked(a[i], panel=None, device=cuda_device)
        assert torch.equal(fac.m[i], one.m)
        assert torch.equal(fac.perm[i], one.perm)

"""The port's panel factor (kernel 1) against the JAX package's
``panel_factor_pallas`` (interpret mode on the CPU), and the CUDA kernel
against its plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.kernels.panel_pallas import panel_factor_pallas
from gauss_tpu_torch.io import synthetic
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.kernels.panel import panel_factor, panel_factor_plain

# Factored-panel tolerance, relative to the panel's max |value|: XLA:CPU
# contracts the rank-1 update into an FMA where the port rounds product and
# difference separately, and the difference compounds over up to 64
# dependent steps (measured up to 2.5e-6 at panel 64).
TOL_PANEL = 5e-6
TOL_MINPIV = 1e-6  # relative, min |pivot|
TOL_DEFER = 5e-5   # vs the JAX two-level form (different association)

SHAPES = [(h, panel, kb) for h in (64, 128, 256) for panel in (16, 32, 64)
          for kb in (0, 16) if h - kb >= panel]


def _jax(p, kb, **kw):
    out = panel_factor_pallas(jnp.asarray(p), kb, **kw)
    return [np.asarray(o) for o in out]


def _port(p, kb):
    return [o.numpy() for o in panel_factor(torch.from_numpy(p.copy()), kb)]


def _assert_close(got, want, tol):
    np.testing.assert_array_equal(got[1], want[1])        # ipiv
    np.testing.assert_array_equal(got[2], want[2])        # perm_local
    scale = np.abs(want[0]).max()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol * scale)
    assert float(got[3]) == pytest.approx(float(want[3]), rel=TOL_MINPIV)


@pytest.mark.parametrize("h,panel,kb", SHAPES)
def test_plain_matches_classic_pallas(h, panel, kb):
    p = np.random.default_rng(h * 1000 + panel * 10 + kb).standard_normal(
        (h, panel)).astype(np.float32)
    _assert_close(_port(p, kb), _jax(p, kb, seg=panel), TOL_PANEL)


@pytest.mark.parametrize("h,panel,kb", [(64, 16, 0), (128, 32, 16),
                                        (256, 64, 0), (256, 64, 16)])
def test_internal_matrix_all_ties(h, panel, kb):
    """The min matrix ties in EVERY column; pivots must follow argmax's
    lowest-original-row rule, and its integer arithmetic stays exact."""
    p = synthetic.internal_matrix(h)[:, kb:kb + panel].astype(np.float32)
    got, want = _port(p, kb), _jax(p, kb, seg=panel)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    assert float(got[3]) == float(want[3])


@pytest.mark.parametrize("h,panel,kb", [(128, 64, 0), (256, 64, 16),
                                        (256, 32, 0)])
def test_plain_matches_two_level_pallas(h, panel, kb):
    """The default (deferred two-level) JAX form: same pivots on random
    input, values equal up to its different association."""
    p = np.random.default_rng(7 + h + panel + kb).standard_normal(
        (h, panel)).astype(np.float32)
    _assert_close(_port(p, kb), _jax(p, kb), TOL_DEFER)


@pytest.mark.parametrize("poison", ["zero_column", "nan"])
def test_singular_and_nan_report_zero_pivot(poison):
    p = np.random.default_rng(3).standard_normal((64, 16)).astype(np.float32)
    if poison == "zero_column":
        p[:, 5] = 0.0  # stays exactly 0: a zero pivot at step 5
    else:
        p[10, 0] = np.nan
    got, want = _port(p, 0), _jax(p, 0, seg=16)
    assert float(got[3]) == float(want[3]) == 0.0
    np.testing.assert_array_equal(got[1], want[1])


def test_getrf_layout_reconstructs_pa():
    """P A = L U from the returned panel and permutation."""
    h, panel = 96, 32
    p = np.random.default_rng(11).standard_normal((h, panel)).astype(
        np.float64)
    f, ipiv, perm, _ = panel_factor(torch.from_numpy(p), 0)
    f = f.numpy()
    lo = np.tril(f, -1)
    lo[np.arange(panel), np.arange(panel)] = 1.0
    u = np.triu(f[:panel])
    np.testing.assert_allclose(lo @ u, p[perm.numpy()], atol=1e-10)
    assert sorted(perm.tolist()) == list(range(h))
    assert ipiv.tolist() == perm[:panel].tolist()


def test_cpu_tensor_runs_plain_without_launch():
    _build.reset_launches()
    p = torch.randn(32, 8, generator=torch.Generator().manual_seed(0))
    got = panel_factor(p, 0)
    want = panel_factor_plain(p, 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert _build.LAUNCHES["panel_factor"] == 0


def test_too_few_rows_rejected():
    with pytest.raises(ValueError, match="rows"):
        panel_factor(torch.zeros(20, 16), 8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode "
                    "(run `python -m pytest -m cuda tests/` or "
                    "`python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,panel", [(256, 256), (2048, 256), (100, 16)])
def test_kernel_matches_plain_on_card(cuda_device, h, panel):
    """Same step arithmetic (explicitly rounded mul/sub/div): identical
    pivots and values."""
    x = torch.as_tensor(np.random.default_rng(h).standard_normal(
        (h, panel)), dtype=torch.float32, device=cuda_device)
    before = _build.LAUNCHES["panel_factor"]
    got = panel_factor(x, 0)
    want = panel_factor_plain(x, 0)
    assert _build.LAUNCHES["panel_factor"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)

"""The port's fused panel+trailing kernel (kernel 2) and trailing kernel
(kernel 3) against the JAX package's ``panel_fused_pallas`` (interpret
mode on the CPU), the port's own fused == pair contract, and the CUDA
kernels against their plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.kernels import panel_fused_pallas as jpf
from gauss_tpu.kernels.panel_pallas import panel_factor_pallas
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.kernels import panel_fused as tpf
from gauss_tpu_torch.kernels.panel import panel_factor

# Fused-vs-JAX tolerance (rtol = atol): the float-association difference
# tests/test_fused.py allows between the fused kernel and XLA — here the
# trailing coupling is a forward substitution, there a Neumann series.
TOL = 5e-5

CASES = [
    (96, 16, 32, 16, 8, 8),      # mid-block panel, small tiles
    (96, 16, 0, 32, 16, 4),      # first panel, wider tiles
    (64, 32, 0, 64, 32, 32),     # single-segment apply (fseg == panel)
    (80, 16, 64, 16, 4, 16),     # last panel: trailing empty
]


def _block(h, seed=258458):
    return np.random.default_rng(seed + h).standard_normal(
        (h, h)).astype(np.float32)


def _port_pair(block, kb, panel, fseg):
    work = torch.from_numpy(block.copy())
    p, ipiv, perm, mp = panel_factor(work[:, kb:kb + panel], kb)
    mult, onehot = tpf.reconstruct_mult_pt(p, ipiv, perm, kb, panel)
    upd = tpf.trailing_update(work, mult, onehot, kb, fseg=fseg)
    return p, ipiv, perm, mp, upd


@pytest.mark.parametrize("h,panel,kb,ct,seg,fseg", CASES)
def test_plain_fused_matches_jax(h, panel, kb, ct, seg, fseg):
    block = _block(h)
    want = [np.asarray(o) for o in jpf.panel_trailing_fused_pallas(
        jnp.asarray(block), kb, kb, panel=panel, ct=ct, seg=seg, fseg=fseg)]
    got = [o.numpy() for o in tpf.panel_trailing_fused(
        torch.from_numpy(block.copy()), kb, kb, panel=panel, ct=ct, seg=seg,
        fseg=fseg)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[4], want[4], rtol=TOL, atol=TOL)
    assert float(got[3]) == pytest.approx(float(want[3]), rel=1e-6)


@pytest.mark.parametrize("h,panel,kb,ct,seg,fseg", CASES)
def test_fused_bit_identical_to_pair(h, panel, kb, ct, seg, fseg):
    """fused == panel + reconstruct_mult_pt + trailing_update, bit for bit,
    and columns at or left of the panel come back untouched."""
    block = _block(h)
    work = torch.from_numpy(block.copy())
    p, ipiv, perm, mp, upd = tpf.panel_trailing_fused(
        work, kb, kb, panel=panel, ct=ct, seg=seg, fseg=fseg)
    assert upd is work  # in place, as the JAX kernel aliases its operand
    p2, ipiv2, perm2, mp2, upd2 = _port_pair(block, kb, panel, fseg)
    assert torch.equal(p, p2) and torch.equal(ipiv, ipiv2)
    assert torch.equal(perm, perm2) and float(mp) == float(mp2)
    assert torch.equal(upd, upd2)
    np.testing.assert_array_equal(upd.numpy()[:, :kb + panel],
                                  block[:, :kb + panel])


@pytest.mark.parametrize("h,panel,kb", [(96, 16, 32), (64, 32, 0)])
def test_reconstruct_mult_pt_matches_jax(h, panel, kb):
    block = _block(h)
    p, ipiv, perm, _ = panel_factor_pallas(
        jnp.asarray(block[:, kb:kb + panel]), kb, seg=panel)
    want = jpf.reconstruct_mult_pt(p, ipiv, perm, kb, panel)
    got = tpf.reconstruct_mult_pt(torch.tensor(np.asarray(p)),
                                  torch.tensor(np.asarray(ipiv)),
                                  torch.tensor(np.asarray(perm)), kb,
                                  panel)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_trailing_update_matches_jax_on_same_eliminations():
    """Kernel 3 alone, fed the JAX pair's reconstructed eliminations."""
    h, panel, kb, fseg = 96, 16, 32, 8
    block = _block(h)
    p, ipiv, perm, _ = panel_factor_pallas(
        jnp.asarray(block[:, kb:kb + panel]), kb, seg=panel)
    mult, pt = jpf.reconstruct_mult_pt(p, ipiv, perm, kb, panel)
    want = np.asarray(jpf.trailing_update_pallas(
        jnp.asarray(block), mult, pt, kb, ct=16, fseg=fseg))
    got = tpf.trailing_update(torch.from_numpy(block.copy()),
                              torch.tensor(np.asarray(mult)),
                              torch.tensor(np.asarray(ipiv)), kb,
                              fseg=fseg)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_trailing_takes_ipiv_or_one_hots():
    block = _block(64)
    work = torch.from_numpy(block.copy())
    p, ipiv, perm, _ = panel_factor(work[:, 16:32], 16)
    mult, onehot = tpf.reconstruct_mult_pt(p, ipiv, perm, 16, 16)
    a = tpf.trailing_update(work.clone(), mult, onehot, 16, fseg=4)
    b = tpf.trailing_update(work.clone(), mult, ipiv, 16, fseg=4)
    assert torch.equal(a, b)


def test_fused_trailing_matches_gemm_reference():
    """The fused update reproduces U12 = L11^-1 A12, A22 -= L21 U12 (the
    torch-GEMM route of the blocked LU) to f32 rounding."""
    h, panel, kb = 96, 16, 32
    block = _block(h, seed=5)
    work = torch.from_numpy(block.copy()).double()
    p, _, perm, _, upd = tpf.panel_trailing_fused(work.clone(), kb, kb,
                                                  panel=panel, fseg=8)
    ref = work[perm].clone()
    ref[:, kb:kb + panel] = p
    l11 = torch.tril(p[kb:kb + panel], -1) + torch.eye(panel,
                                                       dtype=ref.dtype)
    u12 = torch.linalg.solve_triangular(l11, ref[kb:kb + panel,
                                                 kb + panel:],
                                        upper=False, unitriangular=True)
    ref[kb:kb + panel, kb + panel:] = u12
    ref[kb + panel:, kb + panel:] -= p[kb + panel:] @ u12
    fused_m = upd[perm]
    fused_m[:, kb:kb + panel] = p
    np.testing.assert_allclose(fused_m.numpy(), ref.numpy(), atol=1e-10,
                               rtol=1e-10)


def test_resolve_tiles_matches_jax():
    for h, wtot, panel, ct, fseg in [(96, 96, 16, None, None),
                                     (2048, 2048, 256, None, None),
                                     (96, 96, 16, 40, 100),
                                     (80, 80, 16, 64, 0)]:
        want = jpf._resolve_tiles(h, wtot, panel, jnp.float32, ct, None,
                                  fseg)
        assert tpf.resolve_tiles(h, wtot, panel, ct, None, fseg) == want


def test_cpu_runs_plain_without_launch():
    _build.reset_launches()
    tpf.panel_trailing_fused(torch.from_numpy(_block(64)), 0, 0, panel=16)
    assert _build.LAUNCHES == {k: 0 for k in _build.LAUNCHES}


def test_bad_geometry_rejected():
    with pytest.raises(ValueError):
        tpf.panel_trailing_fused(torch.zeros(32, 32), 24, 0, panel=16)
    with pytest.raises(ValueError):
        tpf.panel_trailing_fused(torch.zeros(32, 64), 0, 24, panel=16)


def test_trailing_update_rejects_mismatched_eliminations():
    """The kernel reads mult as (panel, h) and panel pivot rows: other
    shapes are refused before any pointer is passed."""
    block = torch.zeros(32, 64)
    with pytest.raises(ValueError, match="mult"):
        tpf.trailing_update(block, torch.zeros(16, 24),
                            torch.zeros(16, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="pivots"):
        tpf.trailing_update(block, torch.zeros(16, 32),
                            torch.zeros(8, dtype=torch.int32), 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode "
                    "(run `python -m pytest -m cuda tests/` or "
                    "`python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,wtot,kb,panel", [(2048, 2048, 0, 256),
                                             (1024, 2048, 1024, 256),
                                             (96, 96, 32, 16)])
def test_kernels_match_plain_on_card(cuda_device, h, wtot, kb, panel):
    rng = np.random.default_rng(h + kb)
    orig = torch.as_tensor(rng.standard_normal((h, wtot)),
                           dtype=torch.float32, device=cuda_device)
    p, ipiv, perm, mp, upd = tpf.panel_trailing_fused(orig.clone(), kb, 0,
                                                      panel=panel)
    rp, ripiv, rperm, rmp, rupd = tpf.panel_trailing_fused_plain(
        orig.clone(), kb, 0, panel=panel)
    assert torch.equal(ipiv, ripiv) and torch.equal(perm, rperm)
    scale = float(rupd.abs().max())
    assert float((upd - rupd).abs().max()) <= TOL * scale
    assert torch.equal(p, rp) and float(mp) == float(rmp)
    assert torch.equal(upd[:, :kb + panel], orig[:, :kb + panel])
    pair = orig.clone()
    p2, ipiv2, perm2, _ = panel_factor(pair[:, kb:kb + panel], 0)
    mult, onehot = tpf.reconstruct_mult_pt(p2, ipiv2, perm2, 0, panel)
    tpf.trailing_update(pair, mult, onehot, kb)
    assert torch.equal(pair, upd) and torch.equal(p2, p)

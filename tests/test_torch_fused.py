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
from gauss_tpu_torch.kernels.panel import cluster_smem_bytes, panel_factor

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


@pytest.mark.parametrize("kb,grid", zip(range(0, 2048 - 256, 256),
                                         (112, 112, 112, 112, 80, 48, 32)))
def test_fused_geometry_main_path(kb, grid):
    """The 7 fused launches of an n=2048 factorization: phase A on a
    cluster of 16, and a grid of phase A's cluster plus a block per job,
    at most the 7 clusters of 16 an H100 holds at once."""
    h = 2048 - kb
    g = tpf.fused_geometry(h, 2048, 256, kb)
    assert g.grid == grid
    assert (g.route, g.cluster, g.rows_per_block) == ("cluster", 16, h // 16)
    assert g.chunks == (2048 - kb - 256) // 64 and g.row_tiles == h // 256
    jobs = g.chunks * (1 + g.row_tiles)
    assert g.grid == 16 * min(1 + -(-jobs // 16), 7)
    assert tpf.fused_geometry(h, 2048, 256, kb, clusters=3).grid == 16 * min(
        1 + -(-jobs // 16), 3)
    assert g.smem_bytes == max(cluster_smem_bytes(h // 16, 256),
                               tpf.trailing_smem_bytes(256, 32))
    assert g.smem_bytes <= 232448


def test_fused_geometry_one_block_route():
    """A strip taller than a 16-block cluster holds: phase A on a group of
    G = ceil(h / 64) blocks (the grid route), the grid G blocks plus one a
    job up to one per SM; one block only past the grid's reach (panel
    1024 above 6,864 rows), the grid one block per job up to one per SM."""
    g = tpf.fused_geometry(4096, 4096, 256)
    assert (g.route, g.cluster, g.rows_per_block, g.group) == (
        "grid", 1, 64, 64)
    assert (g.chunks, g.row_tiles, g.grid) == (60, 16, 132)
    assert g.smem_bytes == max(cluster_smem_bytes(64, 256),
                               tpf.trailing_smem_bytes(256, 32))
    assert tpf.fused_geometry(3392, 3392, 256).route == "cluster"
    assert tpf.fused_geometry(3393, 3393, 256).route == "grid"
    g = tpf.fused_geometry(6865, 6865, 1024)
    assert (g.route, g.cluster, g.rows_per_block, g.group) == (
        "block", 1, 6865, 1)
    assert (g.chunks, g.row_tiles, g.grid) == (92, 27, 132)
    assert g.smem_bytes == tpf.trailing_smem_bytes(1024, 32)
    assert tpf.fused_geometry(6864, 6864, 1024).route == "grid"


def test_fused_geometry_ragged_and_empty_trailing():
    g = tpf.fused_geometry(96, 96, 16, 32, fseg=16)
    assert (g.chunks, g.row_tiles) == (1, 1)
    g = tpf.fused_geometry(80, 80, 16, 64)
    assert g.chunks == 0 and g.grid == g.cluster


@pytest.mark.parametrize("h,wtot,panel,col0,fseg", [
    (0, 64, 16, 0, 16), (64, 64, 16, 56, 16), (64, 64, 0, 0, 16),
    (2048, 2048, 1025, 0, 16), (64, 64, 16, -1, 16), (64, 64, 16, 0, 0),
    (64, 64, 16, 0, 65)])
def test_fused_geometry_rejects_bad_shapes(h, wtot, panel, col0, fseg):
    with pytest.raises(ValueError):
        tpf.fused_geometry(h, wtot, panel, col0, fseg)


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


def _card_pair(orig, kb, panel, fseg=None):
    """The unfused pair on the card: panel kernel + reconstruction +
    trailing kernel."""
    pair = orig.clone()
    p, ipiv, perm, mp = panel_factor(pair[:, kb:kb + panel], 0)
    mult, onehot = tpf.reconstruct_mult_pt(p, ipiv, perm, 0, panel)
    tpf.trailing_update(pair, mult, onehot, kb, fseg=fseg)
    return p, ipiv, perm, mp, pair, mult


@pytest.mark.cuda
@pytest.mark.parametrize("h,wtot,kb,panel,route", [
    (2048, 2048, 0, 256, "cluster"), (1024, 2048, 1024, 256, "cluster"),
    (96, 96, 32, 16, "cluster"), (4096, 4096, 0, 256, "grid"),
    (8192, 1024, 0, 256, "grid"), (6865, 1088, 0, 1024, "block")])
def test_kernels_match_plain_on_card(cuda_device, h, wtot, kb, panel, route):
    """The three phase-A routes against the plain version (pivots equal,
    values within TOL, columns left of the panel's end untouched), and
    fused == pair bit for bit; one launch each."""
    assert tpf.fused_geometry(h, wtot, panel, kb).route == route
    rng = np.random.default_rng(h + kb)
    orig = torch.as_tensor(rng.standard_normal((h, wtot)),
                           dtype=torch.float32, device=cuda_device)
    _build.reset_launches()
    p, ipiv, perm, mp, upd = tpf.panel_trailing_fused(orig.clone(), kb, 0,
                                                      panel=panel)
    assert _build.LAUNCHES["panel_trailing_fused"] == 1
    rp, ripiv, rperm, rmp, rupd = tpf.panel_trailing_fused_plain(
        orig.clone(), kb, 0, panel=panel)
    assert torch.equal(ipiv, ripiv) and torch.equal(perm, rperm)
    scale = float(rupd.abs().max())
    assert float((upd - rupd).abs().max()) <= TOL * scale
    assert torch.equal(p, rp) and float(mp) == float(rmp)
    assert torch.equal(upd[:, :kb + panel], orig[:, :kb + panel])
    p2, ipiv2, _, mp2, pair, _ = _card_pair(orig, kb, panel)
    assert torch.equal(pair, upd) and torch.equal(p2, p)
    assert torch.equal(ipiv2, ipiv) and float(mp2) == float(mp)


@pytest.mark.cuda
@pytest.mark.parametrize("h,wtot,kb,panel,fseg", [
    (300, 333, 5, 64, 8),     # ragged rows, a 13-column last chunk
    (300, 333, 5, 64, 64),    # one segment of 64 (two lanes a warp row)
    (200, 250, 0, 48, 32),    # a 16-wide last segment
    (600, 900, 0, 320, 32)])  # more pivot rows than one 256-row B1 pass
def test_ragged_shapes_and_segments_on_card(cuda_device, h, wtot, kb, panel,
                                            fseg):
    """Ragged tiles and chunks, odd segment widths and a panel wider than
    a tile through B1/B2: the fused kernel within TOL of the plain version,
    fused == pair bit for bit, and the trailing kernel within TOL of its
    plain version on the same eliminations."""
    rng = np.random.default_rng(h + wtot + fseg)
    orig = torch.as_tensor(rng.standard_normal((h, wtot)),
                           dtype=torch.float32, device=cuda_device)
    p, ipiv, perm, mp, upd = tpf.panel_trailing_fused(orig.clone(), kb, 0,
                                                      panel=panel, fseg=fseg)
    _, ripiv, _, _, rupd = tpf.panel_trailing_fused_plain(
        orig.clone(), kb, 0, panel=panel, fseg=fseg)
    assert torch.equal(ipiv, ripiv)
    scale = float(rupd.abs().max())
    assert float((upd - rupd).abs().max()) <= TOL * scale
    assert torch.equal(upd[:, :kb + panel], orig[:, :kb + panel])
    p2, _, _, _, pair, mult = _card_pair(orig, kb, panel, fseg)
    assert torch.equal(pair, upd) and torch.equal(p2, p)
    plain = tpf.trailing_update_plain(orig.clone(), mult, ipiv, kb, fseg)
    assert float((pair - plain).abs().max()) <= TOL * scale


def _same_with_nan(a, b):
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(torch.where(nan, 0, a), torch.where(nan, 0, b)))


@pytest.mark.cuda
@pytest.mark.parametrize("poison", ["nan", "singular"])
@pytest.mark.parametrize("h", [512, 4096])
def test_poisoned_block_matches_pair_on_card(cuda_device, poison, h):
    """A NaN in the panel, or a panel column of zeros (a zero pivot): the
    fused kernel gives the pair's min |pivot| and the pair's NaN pattern,
    its other values bit for bit, on the cluster and grid routes."""
    kb, panel = 0, 256
    rng = np.random.default_rng(7 + h)
    a = rng.standard_normal((h, h)).astype(np.float32)
    if poison == "nan":
        a[h // 3, 5] = np.nan
    else:
        a[:, 17] = 0.0
    orig = torch.as_tensor(a, device=cuda_device)
    p, _, _, mp, upd = tpf.panel_trailing_fused(orig.clone(), kb, 0,
                                                panel=panel)
    p2, _, _, mp2, pair, _ = _card_pair(orig, kb, panel)
    assert float(mp) == float(mp2) == 0.0
    assert bool(torch.isnan(upd).any())
    assert _same_with_nan(upd, pair) and _same_with_nan(p, p2)


@pytest.mark.cuda
def test_launch_info_matches_geometry_on_card(cuda_device):
    """The C launcher's geometry is fused_geometry's, at the main path's
    first and last shapes, the grid route's tall strips and the one-block
    route's, and the card holds at least one such cluster or block."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for h, wtot, kb, panel in ((2048, 2048, 0, 256), (512, 2048, 1536, 256),
                               (4096, 4096, 0, 256), (8192, 1024, 0, 256),
                               (12800, 1024, 0, 128),
                               (6865, 6865, 0, 1024)):
        info = tpf.fused_launch_info(h, wtot, panel, kb)
        g = tpf.fused_geometry(h, wtot, panel, kb, sms=sms,
                               clusters=info["fit"])
        assert info["fit"] >= 1
        assert {k: info[k] for k in g._fields} == g._asdict()


@pytest.mark.cuda
@pytest.mark.parametrize("h,wtot,dtype,route", [
    (4096, 4096, torch.float32, "grid"), (8192, 1024, torch.float32, "grid"),
    (4096, 4096, torch.bfloat16, "cluster"),   # a bfloat16 cluster holds it
    (8192, 1024, torch.bfloat16, "grid")])
def test_grid_route_matches_pair_on_card(cuda_device, h, wtot, dtype, route):
    """The tall strips at both storage types: panel, pivots and min
    |pivot| bit for bit the plain version's, the block bit for bit the
    unfused pair's (kernel 1 on the same route + reconstruction + kernel
    3); one launch."""
    assert tpf.fused_geometry(h, wtot, 256, itemsize=2 if dtype ==
                              torch.bfloat16 else 4).route == route
    orig = torch.as_tensor(np.random.default_rng(h + wtot).standard_normal(
        (h, wtot)), dtype=torch.float32, device=cuda_device).to(dtype)
    key = "panel_trailing_fused" + ("_bf16" if dtype == torch.bfloat16
                                    else "")
    before = _build.LAUNCHES[key]
    work = orig.clone()
    got = tpf.panel_trailing_fused(work, 0, 0, panel=256)
    assert _build.LAUNCHES[key] == before + 1
    want = tpf.panel_trailing_fused_plain(orig.clone(), 0, 0, panel=256)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    p2, ipiv2, _, mp2, pair, _ = _card_pair(orig, 0, 256)
    assert torch.equal(pair, work) and torch.equal(p2, got[0])
    assert torch.equal(ipiv2, got[1]) and float(mp2) == float(got[3])

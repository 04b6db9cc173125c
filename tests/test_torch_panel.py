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
from gauss_tpu_torch.kernels import panel_fused
from gauss_tpu_torch.kernels.panel import (PANEL_GRID_MAX,
                                           PANEL_GRID_START_MAX,
                                           PANEL_SMEM_MAX, PanelGeometry,
                                           cluster_smem_bytes,
                                           panel_factor,
                                           panel_factor_cluster,
                                           panel_factor_grid,
                                           panel_factor_one_block,
                                           panel_factor_plain,
                                           panel_geometry)

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


# Shared memory of a cluster or grid block, by hand: 4 B x (panel x
# (column stride + 4) + 2 x rows rounded up to 4 + rows + 128), the column
# stride being the rounded rows with bit 2 set.
@pytest.mark.parametrize("h,panel,want", [
    (256, 256, PanelGeometry("cluster", 16, 16, 4 * (256 * 24 + 176), 16)),
    (2048, 256, PanelGeometry("cluster", 16, 128, 4 * (256 * 136 + 512),
                              16)),
    (1001, 256, PanelGeometry("cluster", 16, 63, 4 * (256 * 72 + 319), 16)),
    (3392, 256, PanelGeometry("cluster", 16, 212, 4 * (256 * 216 + 764),
                              16)),
    (3393, 256, PanelGeometry("grid", 1, 63, 4 * (256 * 72 + 319), 54)),
    (4096, 256, PanelGeometry("grid", 1, 64, 4 * (256 * 72 + 320), 64)),
    (100, 16, PanelGeometry("cluster", 7, 15, 4 * (16 * 24 + 175), 7)),
    (16, 16, PanelGeometry("cluster", 1, 16, 4 * (16 * 24 + 176), 1)),
    (1024, 1024, PanelGeometry("grid", 1, 52, 4 * (1024 * 56 + 284), 20)),
    (6865, 1024, PanelGeometry("block", 1, 6865, 0, 1)),
    (2048, 2048, PanelGeometry("block", 1, 2048, 0, 1)),
])
def test_panel_geometry(h, panel, want):
    """The routing rule: the cluster kernel wherever a cluster of at most
    16 blocks holds the strip in shared memory (227 KB a block), the grid
    kernel on G <= 132 blocks above that (from min(ceil(h / 64), 100)
    up), the one-block kernel beyond."""
    got = panel_geometry(h, panel)
    assert got == want
    if got.route != "block":
        assert got.smem_bytes <= 232448
        assert (got.blocks - 1) * got.rows_per_block < h
        assert got.blocks * got.rows_per_block >= h


# Heights past a cluster's reach, up to and past the grid's, at every
# panel width the factor forms use and both storage widths.
GRID_HEIGHTS = (3393, 4096, 6849, 7424, 8192, 10000, 12800, 20000, 27984,
                27985, 56496, 56497, 100000, 200000)


@pytest.mark.parametrize("panel", [128, 256, 1024])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_grid_rule_bounds(panel, itemsize):
    """Every grid-route strip: G <= 132 blocks whose rows cover the strip
    and fit a block's shared memory, G the smallest such from
    min(ceil(h / 64), 100); the one-block route only where no G <= 132
    holds the strip; and the fused kernel's phase A on the same route at
    the same G."""
    routes = set()
    for h in GRID_HEIGHTS:
        g = panel_geometry(h, panel, itemsize)
        routes.add(g.route)
        if g.route == "grid":
            assert 1 <= g.blocks <= PANEL_GRID_MAX
            assert g.blocks * g.rows_per_block >= h
            assert g.rows_per_block == -(-h // g.blocks)
            assert g.smem_bytes == cluster_smem_bytes(g.rows_per_block,
                                                      panel, itemsize)
            assert g.smem_bytes <= PANEL_SMEM_MAX
            start = min(PANEL_GRID_START_MAX, -(-h // 64))
            assert g.blocks >= start
            if g.blocks > start:         # grown: one block fewer overflows
                assert cluster_smem_bytes(-(-h // (g.blocks - 1)), panel,
                                          itemsize) > PANEL_SMEM_MAX
        elif g.route == "block":
            assert cluster_smem_bytes(-(-h // PANEL_GRID_MAX), panel,
                                      itemsize) > PANEL_SMEM_MAX
        f = panel_fused.fused_geometry(h, h, panel, itemsize=itemsize)
        assert (f.route, f.group, f.rows_per_block) == (
            g.route, g.blocks, g.rows_per_block if g.route != "block"
            else h)
        if f.route == "grid":
            assert f.grid == min(g.blocks + f.chunks * (1 + f.row_tiles),
                                 132)
    assert "grid" in routes and "block" in routes


def test_main_path_strips_take_the_cluster_route():
    """Every strip that the n=2048 main paths factor: the blocked path's
    last panel and the batched solve's live-row strips."""
    for h in range(256, 2049, 256):
        assert panel_geometry(h, 256).route == "cluster", h


def test_cluster_wrapper_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        panel_factor_cluster(torch.zeros(32, 8))
    with pytest.raises(ValueError, match="rows"):
        panel_factor_cluster(torch.zeros(20, 16), 8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode "
                    "(run `python -m pytest -m cuda tests/` or "
                    "`python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


def _identical(got, want):
    """torch.equal on every output, NaN positions compared as positions."""
    return all(torch.equal(torch.isnan(g), torch.isnan(w))
               and torch.equal(torch.nan_to_num(g, nan=0.0),
                               torch.nan_to_num(w, nan=0.0))
               if g.is_floating_point() else torch.equal(g, w)
               for g, w in zip(got, want))


def _launched(h, panel):
    return {"cluster": "panel_factor_cluster", "grid": "panel_factor_grid",
            "block": "panel_factor"}[panel_geometry(h, panel).route]


@pytest.mark.cuda
@pytest.mark.parametrize("h,panel", [(256, 256), (2048, 256), (100, 16)])
def test_kernel_matches_plain_on_card(cuda_device, h, panel):
    """Same step arithmetic (explicitly rounded mul/sub/div): identical
    pivots and values."""
    x = torch.as_tensor(np.random.default_rng(h).standard_normal(
        (h, panel)), dtype=torch.float32, device=cuda_device)
    name = _launched(h, panel)
    before = _build.LAUNCHES[name]
    got = panel_factor(x, 0)
    want = panel_factor_plain(x, 0)
    assert _build.LAUNCHES[name] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _poisoned(kind, h, panel, seed):
    p = np.random.default_rng(seed).standard_normal((h, panel))
    if kind == "zero_column":
        p[:, 5] = 0.0
    elif kind == "nan_column":
        p[h // 3, 7] = np.nan
    elif kind == "ties":
        p = synthetic.internal_matrix(h)[:, :panel]
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("h,panel,kb,kind", [
    (1001, 256, 0, "random"),      # h not a multiple of C = 16
    (790, 128, 40, "random"),      # kb > 0
    (2048, 256, 300, "random"),    # kb > 0 across the first two blocks
    (512, 64, 0, "zero_column"),
    (512, 64, 16, "nan_column"),
    (700, 96, 0, "ties"),
    (700, 96, 33, "ties"),
    (4096, 256, 16, "random"),     # routed to the grid kernel
])
def test_routes_match_plain_on_card(cuda_device, h, panel, kb, kind):
    x = torch.as_tensor(_poisoned(kind, h, panel, h + kb),
                        dtype=torch.float32, device=cuda_device)
    name = _launched(h, panel)
    assert (name == "panel_factor_grid") == (h == 4096)
    before = dict(_build.LAUNCHES)
    got = panel_factor(x, kb)
    torch.cuda.synchronize()
    want = panel_factor_plain(x, kb)
    assert _build.LAUNCHES[name] == before[name] + 1
    assert sum(_build.LAUNCHES.values()) == sum(before.values()) + 1
    assert _identical(got, want)
    if kind != "random":
        assert float(got[3]) == float(want[3])


@pytest.mark.cuda
@pytest.mark.parametrize("h,panel,cluster", [
    (40, 8, 16),     # rows 3 a block: the last two blocks hold none
    (200, 32, 16),   # the last block holds 5 of 13 rows
    (200, 32, 3), (200, 32, 1), (1024, 256, 5), (1024, 256, 12),
])
def test_cluster_sizes_match_plain_on_card(cuda_device, h, panel, cluster):
    x = torch.as_tensor(np.random.default_rng(cluster).standard_normal(
        (h, panel)), dtype=torch.float32, device=cuda_device)
    got = panel_factor_cluster(x, 0, cluster)
    torch.cuda.synchronize()
    assert _identical(got, panel_factor_plain(x, 0))


@pytest.mark.cuda
def test_cluster_that_does_not_fit_raises(cuda_device):
    x = torch.zeros((4096, 256), device=cuda_device)
    with pytest.raises(RuntimeError, match="panel_factor_cluster"):
        panel_factor_cluster(x)      # the rule sends it to the grid
    with pytest.raises(RuntimeError, match="panel_factor_cluster"):
        panel_factor_cluster(x, 0, 17)


def test_grid_and_one_block_wrappers_need_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        panel_factor_grid(torch.zeros(32, 8))
    with pytest.raises(ValueError, match="CUDA"):
        panel_factor_one_block(torch.zeros(32, 8))
    with pytest.raises(ValueError, match="rows"):
        panel_factor_grid(torch.zeros(20, 16), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("h,panel,kb,kind,dtype", [
    (4096, 256, 0, "random", torch.float32),
    (7424, 256, 0, "random", torch.float32),
    (12800, 128, 0, "random", torch.float32),
    (4096, 256, 0, "ties", torch.float32),        # min matrix
    (4096, 256, 0, "nan_column", torch.float32),
    (4096, 256, 0, "zero_column", torch.float32),
    (4096, 256, 300, "random", torch.float32),    # kb > 0 across blocks
    (6912, 256, 0, "random", torch.bfloat16),
    (7424, 256, 0, "random", torch.bfloat16),
])
def test_grid_route_matches_plain_on_card(cuda_device, h, panel, kb, kind,
                                          dtype):
    """The grid kernel, by the rule, bit for bit its plain version, NaN
    and ties included; one launch under its own key."""
    x = torch.as_tensor(_poisoned(kind, h, panel, h + kb),
                        dtype=torch.float32, device=cuda_device).to(dtype)
    geom = panel_geometry(h, panel, x.element_size())
    assert geom.route == "grid"
    key = "panel_factor_grid" + ("_bf16" if dtype == torch.bfloat16 else "")
    before = dict(_build.LAUNCHES)
    got = panel_factor(x, kb)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before[key] + 1
    assert sum(_build.LAUNCHES.values()) == sum(before.values()) + 1
    want = panel_factor_plain(x, kb)
    assert _identical(got, want)
    if kind != "random":
        assert float(got[3]) == float(want[3])


@pytest.mark.cuda
@pytest.mark.parametrize("h,panel,grid", [
    (2048, 256, 16), (2048, 256, 33),   # strips a cluster also holds
    (4096, 256, 32), (4096, 256, 128),
    (200, 32, 132),                     # most blocks hold no row
])
def test_grid_sizes_match_plain_on_card(cuda_device, h, panel, grid):
    x = torch.as_tensor(np.random.default_rng(grid).standard_normal(
        (h, panel)), dtype=torch.float32, device=cuda_device)
    got = panel_factor_grid(x, 0, grid)
    torch.cuda.synchronize()
    assert _identical(got, panel_factor_plain(x, 0))


@pytest.mark.cuda
def test_grid_that_does_not_fit_raises(cuda_device):
    with pytest.raises(RuntimeError, match="panel_factor_grid"):
        panel_factor_grid(torch.zeros((4096, 256), device=cuda_device), 0,
                          133)               # more blocks than the route
    with pytest.raises(RuntimeError, match="panel_factor_grid"):
        panel_factor_grid(torch.zeros((4096, 256), device=cuda_device), 0,
                          4)                 # 1024 rows a block
    with pytest.raises(RuntimeError, match="panel_factor_grid"):
        panel_factor_grid(torch.zeros((2048, 256), device=cuda_device))


@pytest.mark.cuda
def test_one_block_entry_matches_plain_on_card(cuda_device):
    """The one-block kernel, kept for timing, on a strip the rule sends to
    the grid."""
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (4096, 256)), dtype=torch.float32, device=cuda_device)
    before = _build.LAUNCHES["panel_factor"]
    got = panel_factor_one_block(x, 16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["panel_factor"] == before + 1
    assert _identical(got, panel_factor_plain(x, 16))

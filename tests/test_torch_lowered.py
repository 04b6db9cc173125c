"""The lowered-precision slice: the bfloat16 plain versions of the panel and
fused kernels against the JAX package's kernels at bfloat16 (interpret
mode on the CPU), the precision contract of ``core.blocked``,
``refine_ds``'s masked early exit, ``core.lowered``'s ladder against the
JAX package's, and the bfloat16 CUDA kernels against their plain versions
on the card. The residual grid of every factor form is in
``tests/test_torch_lowered_grid.py``."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gauss_tpu.core import blocked as jb
from gauss_tpu.core import dsfloat as jd
from gauss_tpu.core import lowered as jl
from gauss_tpu.kernels.panel_fused_pallas import panel_trailing_fused_pallas
from gauss_tpu.kernels.panel_pallas import panel_factor_pallas
from gauss_tpu.verify import checks
from gauss_tpu_torch import obs
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.core import dsfloat as td
from gauss_tpu_torch.core import lowered as tl
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.kernels import panel as kp
from gauss_tpu_torch.kernels import panel_fused as kf
from gauss_tpu_torch.tune import apply as tapply

BF16 = torch.bfloat16
#: One bfloat16 ulp at 1.0 (8 significant bits).
BF16_ULP = 2.0 ** -7
#: The trailing block of the fused plain version against the JAX kernel at
#: bfloat16, relative to the block's max |value|: two ulps at that scale.
#: Both take U0 and the coupling in float32 and round once per segment;
#: the JAX kernel inverts the coupling by a Neumann series, the port by
#: forward substitution, so a float32 sum may round to the other bfloat16
#: neighbour, and a pivot row's flip enters later rows through |m| <= 1.
TRAIL_TOL_BF16 = 2 * BF16_ULP


def _bf16_array(rng, shape):
    return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)


def _torch_bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF16)


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _system(rng, n):
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a, rng.standard_normal(n)


def _ill_system(rng, n, cond_exp=6):
    """tests/test_lowered.py's cond ~10^cond_exp symmetric system."""
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.logspace(0, cond_exp, n)
    return (q * d) @ q.T, rng.standard_normal(n)


# --- kernels 1-3 at bfloat16, plain versions against the JAX kernels ------


@pytest.mark.parametrize("h,panel,kb", [(64, 16, 0), (256, 32, 0),
                                        (96, 16, 32)])
def test_panel_plain_bf16_bit_identical_to_jax(rng, h, panel, kb):
    """Per-operation bfloat16 rounding: the same pivots and the same bits
    as the JAX kernel's classic form (``seg=panel``) in interpret mode."""
    a = _bf16_array(rng, (h, panel))
    want = panel_factor_pallas(jnp.asarray(a), kb, interpret=True, seg=panel)
    got = kp.panel_factor_plain(_torch_bf16(a), kb)
    assert got[0].dtype == BF16 and got[3].dtype == BF16
    np.testing.assert_array_equal(_np32(got[0]), np.asarray(want[0],
                                                            np.float32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert float(got[3]) == float(want[3])
    assert kp.panel_factor(_torch_bf16(a), kb)[0].equal(got[0])


FUSED_CASES = [(64, 64, 16, 0, 8), (128, 128, 32, 32, 16),
               (96, 160, 32, 0, 32), (80, 80, 16, 64, 8)]


@pytest.mark.parametrize("h,w,panel,col0,fseg", FUSED_CASES)
def test_fused_plain_bf16_matches_jax(rng, h, w, panel, col0, fseg):
    """The panel bit for bit; the trailing block within TRAIL_TOL_BF16 of
    the JAX kernel's precision contract; columns left of the panel's end
    untouched."""
    a = _bf16_array(rng, (h, w))
    want = [np.asarray(o, np.float32) if o.dtype != jnp.int32
            else np.asarray(o) for o in panel_trailing_fused_pallas(
                jnp.asarray(a), col0, 0, panel=panel, seg=panel, fseg=fseg,
                ct=panel, interpret=True)]
    block = _torch_bf16(a)
    got = kf.panel_trailing_fused(block, col0, 0, panel=panel, fseg=fseg)
    assert got[4] is block and block.dtype == BF16
    np.testing.assert_array_equal(_np32(got[0]), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert float(got[3]) == float(want[3])
    out = _np32(got[4])
    np.testing.assert_array_equal(out[:, :col0 + panel],
                                  np.asarray(a, np.float32)[:, :col0 + panel])
    scale = np.abs(want[4]).max()
    assert np.abs(out - want[4]).max() <= TRAIL_TOL_BF16 * scale


@pytest.mark.parametrize("h,w,panel,col0,fseg", FUSED_CASES)
def test_fused_bf16_bit_identical_to_pair(rng, h, w, panel, col0, fseg):
    """fused == panel + reconstruct_mult_pt + trailing_update at bfloat16,
    bit for bit, as at float32."""
    a = _torch_bf16(_bf16_array(rng, (h, w)))
    fused = kf.panel_trailing_fused(a.clone(), col0, 0, panel=panel,
                                    fseg=fseg)
    pair = a.clone()
    p, ipiv, perm, mp = kp.panel_factor(pair[:, col0:col0 + panel], 0)
    mult, onehot = kf.reconstruct_mult_pt(p, ipiv, perm, 0, panel)
    kf.trailing_update(pair, mult, onehot, col0, fseg=fseg)
    for g, w_ in zip(fused, (p, ipiv, perm, mp, pair)):
        assert torch.equal(g, w_)


def test_trailing_plain_f32_path_unchanged(rng):
    """The float32 trailing leg is the pre-contract loop, bit for bit."""
    h, w, panel, col0, fseg = 96, 160, 32, 16, 8
    block = torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32))
    p, ipiv, perm, _ = kp.panel_factor(block[:, col0:col0 + panel], 0)
    mult, _ = kf.reconstruct_mult_pt(p, ipiv, perm, 0, panel)
    want = block.clone()
    trail = want[:, col0 + panel:]
    piv_all = ipiv.to(torch.int64)
    for s0 in range(0, panel, fseg):
        s1 = min(s0 + fseg, panel)
        piv = piv_all[s0:s1]
        m = mult[s0:s1]
        u = trail.index_select(0, piv)
        lc = m.index_select(1, piv)
        for j in range(1, s1 - s0):
            u[j] -= lc[:j, j] @ u[:j]
        trail -= m.T @ u
        trail.index_copy_(0, piv, u)
    got = kf.trailing_update_plain(block.clone(), mult, ipiv, col0, fseg)
    assert torch.equal(got, want)


def _trailing_with_fault(block, mult, ipiv, col0, fseg, fault):
    """The bfloat16 trailing leg with one break of the precision contract
    (``no-ulow``: U applied unrounded; ``per-panel``: one rounding at the
    panel's end; ``bf16-acc``: the products summed in bfloat16), or none
    but another summation order (``reordered``: products in float64)."""
    panel = mult.shape[0]
    trail = block[:, col0 + panel:]
    piv_all = ipiv.to(torch.int64)
    t = trail.float()
    for s0 in range(0, panel, fseg):
        s1 = min(s0 + fseg, panel)
        piv = piv_all[s0:s1]
        m = mult[s0:s1].float()
        u = t.index_select(0, piv)
        lc = m.index_select(1, piv)
        for j in range(1, s1 - s0):
            u[j] -= lc[:j, j] @ u[:j]
        ulow = u.to(BF16).float()
        applied = u if fault == "no-ulow" else ulow
        if fault == "reordered":
            prod = (m.double().T @ applied.double()).float()
        elif fault == "bf16-acc":
            prod = torch.zeros_like(t)
            for i in range(s1 - s0):
                prod = (prod + torch.outer(m[i], applied[i])).to(BF16).float()
        else:
            prod = m.T @ applied
        t = t - prod
        t.index_copy_(0, piv, ulow if fault == "per-panel" else applied)
        if fault != "per-panel":
            t = t.to(BF16).float()
    trail.copy_(t.to(BF16))
    return block


@pytest.mark.parametrize("fault", ["no-ulow", "per-panel", "bf16-acc",
                                   "reordered"])
def test_share_limit_catches_contract_faults(fault):
    """chip_smoke's bfloat16 limits against a plain trailing leg that breaks
    the contract: each break moves most trailing elements, so the share
    limit trips though the max limit (4 ulps of the block's largest) may
    not; another summation order alone passes both. The card's kernels
    with these faults planted: scripts/probe_bf16_faults.py."""
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    h = w = 512
    panel, fseg = 64, 32
    block = torch.from_numpy(np.random.default_rng(258458).standard_normal(
        (h, w)).astype(np.float32)).to(BF16)
    p, ipiv, perm, _ = kp.panel_factor(block[:, :panel], 0)
    mult, _ = kf.reconstruct_mult_pt(p, ipiv, perm, 0, panel)
    want = kf.trailing_update_plain(block.clone(), mult, ipiv, 0, fseg)
    got = _trailing_with_fault(block.clone(), mult, ipiv, 0, fseg, fault)
    err, scale, share = chip_smoke.bf16_block_stats(got, want, panel)
    if fault == "reordered":
        assert err <= chip_smoke.TOL_BF16 * scale
        assert share <= chip_smoke.TOL_BF16_SHARE / 100
    else:
        assert share > 10 * chip_smoke.TOL_BF16_SHARE


def test_bf16_geometry_reaches_twice_the_rows():
    """A bfloat16 strip takes half the shared memory a row: the cluster
    route reaches about twice the rows of float32, the grid route takes
    over above it at both widths, and the fused kernel's phase A follows
    them."""
    def reach(panel, itemsize):
        h = 1
        while kp.panel_geometry(h + 1, panel, itemsize).route == "cluster":
            h += 1
        return h

    for panel in (128, 256):
        r4, r2 = reach(panel, 4), reach(panel, 2)
        assert 1.9 <= r2 / r4 <= 2.1, (panel, r4, r2)
    assert (reach(256, 4), reach(256, 2)) == (3392, 6848)
    assert kp.cluster_smem_bytes(212, 256) == kp.cluster_smem_bytes(
        212, 256, 4) == 224240
    assert kp.cluster_smem_bytes(428, 256, 2) <= kp.PANEL_SMEM_MAX
    assert kf.fused_geometry(6848, 6848, 256, itemsize=2).route == "cluster"
    assert kf.fused_geometry(6849, 6849, 256, itemsize=2).route == "grid"
    assert kf.fused_geometry(6848, 6848, 256).route == "grid"
    assert kp.panel_geometry(6849, 256, 2).blocks == kf.fused_geometry(
        6849, 6849, 256, itemsize=2).group == 100


def test_kernel_dtype_checks():
    """The panel kernels take float32 and bfloat16; the others float32."""
    for dt in (torch.float32, BF16):
        kp.check_cuda_storage(torch.zeros(4, 4, dtype=dt), "x")
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            kp.check_cuda_storage(torch.zeros(4, 4, dtype=dt), "x")
    with pytest.raises(TypeError, match="takes float32"):
        kp.check_cuda_f32(torch.zeros(4, 4, dtype=BF16), "x")
    assert kp.launch_suffix(BF16) == "_bf16"
    assert kp.launch_suffix(torch.float32) == ""


# --- the precision contract ------------------------------------------------


def test_accumulate_contract_inverses_and_solves(rng):
    """tests/test_lowered.py's shapes: a bfloat16 factor keeps bfloat16
    ``m``, float32 ``linv``/``uinv``, and ``lu_solve`` returns float32; the
    float32 path stays float32 throughout."""
    a, b = _system(rng, 64)
    fac16 = tb.lu_factor_blocked(torch.as_tensor(a, dtype=BF16), panel=16,
                                 device="cpu")
    assert fac16.m.dtype == BF16 and fac16.min_abs_pivot.dtype == BF16
    assert fac16.linv.dtype == fac16.uinv.dtype == torch.float32
    x = tb.lu_solve(fac16, torch.as_tensor(b, dtype=torch.float32))
    assert x.dtype == torch.float32
    assert checks.residual_norm(a, x.numpy(), b, relative=True) < 5e-3
    jfac = jb.lu_factor_blocked(jnp.asarray(a, jnp.bfloat16), panel=16)
    np.testing.assert_array_equal(_np32(fac16.m), np.asarray(jfac.m,
                                                             np.float32))
    np.testing.assert_array_equal(fac16.linv.numpy(), np.asarray(jfac.linv))
    fac32 = tb.lu_factor_blocked(a, panel=16, device="cpu")
    assert fac32.m.dtype == fac32.linv.dtype == torch.float32
    assert tb.lu_solve(fac32, b).dtype == torch.float32
    # A float64 or float16 operand stages as float32; bfloat16 arrays
    # (ml_dtypes) stay bfloat16.
    assert tb.storage_dtype(a) == tb.storage_dtype(
        torch.zeros(1, dtype=torch.float16)) == torch.float32
    assert tb.storage_dtype(a.astype(ml_dtypes.bfloat16)) == BF16


def test_gdot_rounds_once_at_bf16(rng):
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    x16, y16 = x.to(BF16), y.to(BF16)
    got = tb._gdot(x16, y16, "f32", BF16)
    assert got.dtype == BF16
    assert torch.equal(got, (x16.float() @ y16.float()).to(BF16))
    assert torch.equal(tb._gdot(x, y, "f32", torch.float32), x @ y)
    assert tb.accum_dtype(BF16) == torch.float32
    assert tb.accum_dtype(torch.float32) == torch.float32


def test_abft_rejects_lowered_typed(rng):
    a, _ = _system(rng, 64)
    with pytest.raises(ValueError, match="abft=True requires float32"):
        tb.lu_factor_blocked(torch.as_tensor(a, dtype=BF16), panel=16,
                             abft=True, device="cpu")
    with pytest.raises(ValueError, match="abft=True requires float32"):
        tb.lu_factor_blocked_chunked(a, panel=16, chunk=2,
                                     gemm_precision="bf16x3", abft=True,
                                     device="cpu")
    with pytest.raises(ValueError, match="abft=True requires float32"):
        tb.lu_factor_blocked_chunked(torch.as_tensor(a, dtype=BF16),
                                     panel=16, chunk=2, abft=True,
                                     device="cpu")


def test_bf16_panel_resolution_and_handoff(rng):
    """auto_panel takes the operand's itemsize (the VMEM model admits
    bfloat16 at 256 further out); resolve_factor chooses the chunk at
    itemsize 4, as the JAX package does."""
    for n in (2048, 13000, 20000):
        for itemsize in (2, 4):
            assert tb.auto_panel(n, itemsize) == jb.auto_panel(n, itemsize)
    assert (tb.auto_panel(13000, 4), tb.auto_panel(13000, 2)) == (128, 256)
    a, b = _system(rng, 200)
    x = tb.solve_handoff(a, b, dtype="bfloat16", device="cpu")
    assert checks.residual_norm(a, x, b, relative=True) < 1e-4


# --- refine_ds's masked early exit -----------------------------------------


@pytest.fixture
def bf16_factor(rng):
    a, b = _system(rng, 96)
    a16 = a.astype(ml_dtypes.bfloat16)
    jfac = jb.lu_factor_blocked(jnp.asarray(a16), panel=16)
    tfac = tb.lu_factor_blocked(a16, panel=16, device="cpu")
    return a, b, jfac, tfac


@pytest.mark.parametrize("tol", [1e-3, 1e-7, 1e-9])
def test_refine_ds_used_matches_jax(bf16_factor, tol):
    a, b, jfac, tfac = bf16_factor
    atj, bj = jd.to_ds(a.T), jd.to_ds(b)
    att, bt = td.to_ds(a.T, "cpu"), td.to_ds(b, "cpu")
    xj, uj = jd.refine_ds(jfac, atj, bj, jb.lu_solve(jfac, bj.hi), iters=8,
                          tol=tol, return_iters=True)
    xt, ut = td.refine_ds(tfac, att, bt, tb.lu_solve(tfac, bt.hi), iters=8,
                          tol=tol, return_iters=True)
    assert ut.dtype == torch.int32 and int(ut) == int(uj)
    assert checks.residual_norm(a, td.ds_to_f64(xt), b, relative=True) < (
        max(10 * tol, 1e-6))


def test_refine_ds_default_is_the_plain_loop(bf16_factor):
    """Without tol and return_iters the loop is today's, bit for bit; with
    tol=0 and return_iters the masked loop updates every step and gives the
    same bits."""
    a, b, _, tfac = bf16_factor
    at, bd = td.to_ds(a.T, "cpu"), td.to_ds(b, "cpu")
    x0 = tb.lu_solve(tfac, bd.hi)
    want = td.ds_from_f32(x0)
    for _ in range(3):
        r = td.ds_residual(at, want, bd)
        want = td.ds_add(want, td.ds_from_f32(tb.lu_solve(tfac, r.hi + r.lo)))
    got = td.refine_ds(tfac, at, bd, x0.clone(), iters=3)
    assert isinstance(got, td.DS)
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
    masked, used = td.refine_ds(tfac, at, bd, x0.clone(), iters=3,
                                return_iters=True)
    assert int(used) == 3
    assert torch.equal(masked.hi, want.hi) and torch.equal(masked.lo,
                                                           want.lo)


# --- core.lowered ----------------------------------------------------------


def test_constants_match_jax():
    assert tl.LOWERED_DTYPES == jl.LOWERED_DTYPES
    assert tl.DEFAULT_GATE == jl.DEFAULT_GATE
    assert tl.REFINE_TOL_MARGIN == jl.REFINE_TOL_MARGIN
    assert tl.DEFAULT_REFINE_STEPS == jl.DEFAULT_REFINE_STEPS
    for dt in tl.LOWERED_DTYPES:
        assert tl.default_refine_steps(dt) == jl.default_refine_steps(dt)
    with pytest.raises(ValueError, match="unknown lowered dtype"):
        tl.default_refine_steps("float8")
    with pytest.raises(ValueError, match="unknown lowered dtype"):
        tl.solve_lowered(np.eye(4), np.ones(4), dtype="float8",
                         device="cpu")


def test_solve_lowered_rungs_match_jax(rng):
    """Each rung converges on a dominant system with the JAX package's
    refine count; the bfloat16 rung's factor is the JAX package's, bit for
    bit."""
    a, b = _system(rng, 96)
    for dt, max_steps in (("bfloat16", 4), ("bf16x3", 2), ("float32", 2)):
        x, fac, info = tl.solve_lowered(a, b, dtype=dt, device="cpu")
        _, jfac, jinfo = jl.solve_lowered(a, b, dtype=dt)
        assert info["dtype"] == dt and info["rel_residual"] <= 1e-4
        assert 0 <= info["refine_steps"] <= max_steps
        assert info["refine_steps"] == jinfo["refine_steps"]
        assert checks.residual_norm(a, x, b, relative=True) <= 1e-4
        assert fac.m.dtype == (BF16 if dt == "bfloat16" else torch.float32)
        if dt == "bfloat16":
            np.testing.assert_array_equal(_np32(fac.m),
                                          np.asarray(jfac.m, np.float32))


def test_demotion_is_typed_like_jax(rng, tmp_path):
    """cond ~1e6: the bfloat16 rung raises the JAX package's error (same
    dtype, steps and message), and the walk demotes with the precision
    events and counters."""
    a, b = _ill_system(rng, 64)
    with pytest.raises(tl.PrecisionNotConvergedError) as ei:
        tl.solve_lowered(a, b, dtype="bfloat16", device="cpu")
    with pytest.raises(jl.PrecisionNotConvergedError) as ej:
        jl.solve_lowered(a, b, dtype="bfloat16")
    e, j = ei.value, ej.value
    assert (e.dtype, e.refine_steps, e.gate) == (j.dtype, j.refine_steps,
                                                j.gate)
    assert e.rel_residual > 1e-4
    assert e.rel_residual == pytest.approx(j.rel_residual, rel=1e-3)
    assert str(e) == str(j)
    stream = tmp_path / "m.jsonl"
    with obs.run(metrics_out=str(stream), tool="test"):
        x, _, info = tl.solve_lowered_auto(a, b, device="cpu")
    assert info["dtype"] == "float32" and info["demoted"] is False
    assert checks.residual_norm(a, x, b, relative=True) <= 1e-4
    events = [ev for ev in obs.read_events(str(stream))
              if ev["type"] == "precision"]
    assert [ev.get("dtype") for ev in events] == ["float32"]


def test_auto_consults_tuned_store(rng, monkeypatch, tmp_path):
    """tests/test_lowered.py:231-250: a store pair (bfloat16, 6) moves the
    start down the ladder; a dominant system serves bfloat16 undemoted, the
    ill-conditioned one demotes, typed, to a verified answer."""
    def fake_params(op, n, dtype="float32", engine="blocked"):
        assert op == "lowered"
        return {"dtype": "bfloat16", "refine_steps": 6}

    monkeypatch.setattr(tapply, "params_for", fake_params)
    assert tl.lowered_params(80) == ("bfloat16", 6) and tl.lowered_enabled(80)
    a, b = _system(rng, 80)
    x, _, info = tl.solve_lowered_auto(a, b, device="cpu")
    assert info["dtype"] == "bfloat16" and info["demoted"] is False
    assert checks.residual_norm(a, x, b, relative=True) <= 1e-4
    ia, ib = _ill_system(rng, 64)
    stream = tmp_path / "m.jsonl"
    with obs.run(metrics_out=str(stream), tool="test"):
        x, _, info = tl.solve_lowered_auto(ia, ib, device="cpu")
    assert info["demoted"] is True and info["dtype"] != "bfloat16"
    assert checks.residual_norm(ia, x, ib, relative=True) <= 1e-4
    events = list(obs.read_events(str(stream)))
    demotes = [ev for ev in events if ev["type"] == "precision"
               and ev.get("event") == "demote"]
    assert demotes and demotes[0]["from_dtype"] == "bfloat16"
    counters = {ev["name"]: ev["value"] for ev in events
                if ev["type"] == "metric" and ev["kind"] == "counter"}
    assert counters.get("precision.demotions", 0) >= 1
    assert counters.get("precision.served_demoted") == 1


def test_no_store_start_is_float32(monkeypatch, tmp_path):
    from gauss_tpu_torch.tune import store as tstore

    monkeypatch.setenv(tstore.ENV_STORE, str(tmp_path / "none.json"))
    tapply.reset_cache()
    try:
        assert tl.lowered_params(2048) == ("float32", 6)
        assert not tl.lowered_enabled(2048)
    finally:
        tapply.reset_cache()


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.solve_lowered(np.eye(8), np.ones(8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.solve_lowered_auto(np.eye(8), np.ones(8))


def test_cpu_route_launches_nothing(rng):
    _build.reset_launches()
    a, b = _system(rng, 64)
    tl.solve_lowered(a, b, dtype="bfloat16", device="cpu")
    assert sum(_build.LAUNCHES.values()) == 0


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bfloat16 CUDA kernels have no "
                    "CPU mode (run `python -m pytest -m cuda "
                    "tests/test_torch_lowered.py` or `python3 chip_smoke.py` "
                    "on the card)")
    return torch.device("cuda")


#: The trailing block on the card against the plain version at bfloat16,
#: relative to max |plain|: four ulps at that scale. The kernel's float32
#: sums run in another order than torch's, so a sum may round to the other
#: bfloat16 neighbour, and such a flip in a pivot row's U enters every
#: later row through |m| <= 1, once per segment.
CARD_TOL_BF16 = 4 * BF16_ULP
#: At most this share of the trailing elements may differ at all
#: (chip_smoke.TOL_BF16_SHARE): an order flip is rare, a broken contract
#: moves most elements (test_share_limit_catches_contract_faults).
CARD_SHARE_BF16 = 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("h,panel", [(256, 256), (2048, 256), (6848, 256),
                                     (6849, 256), (100, 16)])
def test_bf16_panel_kernel_bit_identical_on_card(cuda_device, h, panel):
    x = torch.as_tensor(np.random.default_rng(h).standard_normal(
        (h, panel)), dtype=BF16, device=cuda_device)
    geom = kp.panel_geometry(h, panel, 2)
    name = {"cluster": "panel_factor_cluster", "grid": "panel_factor_grid",
            "block": "panel_factor"}[geom.route] + "_bf16"
    before = _build.LAUNCHES[name]
    got = kp.panel_factor(x, 0)
    want = kp.panel_factor_plain(x, 0)
    assert _build.LAUNCHES[name] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if geom.route == "cluster":
        info = kp.panel_cluster_info(h, panel, itemsize=2)
        assert (info["cluster"], info["rows_per_block"],
                info["smem_bytes"]) == (geom.cluster, geom.rows_per_block,
                                        geom.smem_bytes)
    if geom.route == "grid":
        info = kp.panel_grid_info(h, panel, itemsize=2)
        assert (info["grid"], info["rows_per_block"],
                info["smem_bytes"]) == (geom.blocks, geom.rows_per_block,
                                        geom.smem_bytes)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,col0", [(2048, 2048, 0), (2048, 2048, 512),
                                      (7000, 768, 0), (300, 200, 16)])
def test_bf16_fused_and_trailing_on_card(cuda_device, h, w, col0):
    panel = 256 if w >= 512 else 64
    a = torch.as_tensor(np.random.default_rng(h + w).standard_normal(
        (h, w)), dtype=BF16, device=cuda_device)
    before = dict(_build.LAUNCHES)
    got = kf.panel_trailing_fused(a.clone(), col0, 0, panel=panel)
    want = kf.panel_trailing_fused_plain(a.clone(), col0, 0, panel=panel)
    assert _build.LAUNCHES["panel_trailing_fused_bf16"] == before[
        "panel_trailing_fused_bf16"] + 1
    for g, w_ in zip(got[:4], want[:4]):
        assert torch.equal(g, w_)
    scale = float(want[4].float().abs().max())
    diff = (got[4].float() - want[4].float()).abs()
    assert float(diff.max()) <= CARD_TOL_BF16 * scale
    assert float((diff[:, col0 + panel:] > 0).float().mean()) <= (
        CARD_SHARE_BF16)
    pair = a.clone()
    p, ipiv, perm, _ = kp.panel_factor(pair[:, col0:col0 + panel], 0)
    mult, onehot = kf.reconstruct_mult_pt(p, ipiv, perm, 0, panel)
    kf.trailing_update(pair, mult, onehot, col0)
    assert torch.equal(pair, got[4])
    info = kf.fused_launch_info(h, w, panel, col0, itemsize=2)
    geom = kf.fused_geometry(h, w, panel, col0, itemsize=2)
    assert {k: info[k] for k in ("route", "rows_per_block", "smem_bytes",
                                 "chunks", "row_tiles")} == {
        k: getattr(geom, k) for k in ("route", "rows_per_block",
                                      "smem_bytes", "chunks", "row_tiles")}


@pytest.mark.cuda
def test_solve_lowered_on_card(cuda_device):
    rng = np.random.default_rng(258458)
    a, b = _system(rng, 512)
    _build.reset_launches()
    x, fac, info = tl.solve_lowered(a, b, dtype="bfloat16")
    assert fac.m.device.type == "cuda" and fac.m.dtype == BF16
    assert info["rel_residual"] <= 1e-4
    assert _build.LAUNCHES["panel_factor_bf16"] + _build.LAUNCHES[
        "panel_factor_cluster_bf16"] >= 1


def test_chip_smoke_lowered_phase_rehearsal(monkeypatch, tmp_path):
    """chip_smoke.py's phase 7 on the CPU at small sizes: the bfloat16
    kernel shapes against their plain versions, the rungs, the ladder with
    a tune store (demotions on both systems), the chunked form's launches
    and its float64 check, end to end (no kernel launches here, so every
    count is 0)."""
    import io
    import sys
    from contextlib import redirect_stdout
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "REPO", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "N", 128)
    monkeypatch.setattr(chip_smoke, "PANEL", 32)
    monkeypatch.setattr(chip_smoke, "LOWERED_CHECK", (128, 32, 2))
    monkeypatch.setattr(chip_smoke, "LOWERED_LARGE", (256, 128, 4))
    # F64_CAP_BF16 is the card's cap at n=1024; a dominant system of order
    # 128 is less dominant, so its bfloat16 factor lies further from the
    # float64 one: the cap asserted below.
    monkeypatch.setattr(chip_smoke, "F64_CAP_BF16", 2 ** -6)
    monkeypatch.setattr(tb, "UNROLL_MAX_N", 100)
    buf = io.StringIO()
    with redirect_stdout(buf):
        launches, out = chip_smoke.phase_lowered(3)
    assert not any(launches.values())
    assert out["bf16_reach"] == chip_smoke.bf16_reach(32)
    assert kp.panel_geometry(out["bf16_reach"] + 1, 32, 2).route == "grid"
    assert all(r["err"] == 0.0 for r in out["panel"].values())
    assert all(r["err"] == r["err3"] == r["err_rel"] == 0.0
               for r in out["fused"].values())
    assert all(r["rel_residual"] <= 1e-4 for r in out["rungs"].values())
    assert out["walks"]["cond1e6"]["bfloat16"]["converged"] is False
    assert out["tuned"]["cond1e6"]["demotions"] >= 1
    assert all(t["rel_residual"] <= 1e-4 for t in out["tuned"].values())
    check = out["check"]["whole_factor"]
    assert check["card_vs_f64"] == check["cpu_vs_f64"]
    assert all(0 < v < 2 ** -6 for v in check["cpu_vs_f64"].values())
    assert out["check"]["launches"] == {"panel": 4, "panel strided": 4}
    large = out["large"]
    assert large["launches"] == {"panel_trailing_fused_bf16/cluster": 1,
                                 "panel_factor_cluster_bf16/cluster": 1}
    assert large["checked_launches"] == {"fused": 1, "panel": 1,
                                         "panel strided": 1}
    assert large["solve"]["rel_residual"] <= 1e-4
    text = buf.getvalue()
    assert '{"lowered": ' in text and "served bf16x3" in text
    # The plans at the card's size: n=8192 at bfloat16 sends 6 launches to
    # the grid route (float32: 19), the rest to the cluster.
    plan16 = chip_smoke.factor_plan(8192, 256, 4, 2)
    counts = chip_smoke.route_counts(plan16)
    assert counts == {"panel_trailing_fused_bf16/grid": 5,
                      "panel_trailing_fused_bf16/cluster": 19,
                      "panel_factor_grid_bf16/grid": 1,
                      "panel_factor_cluster_bf16/cluster": 7}
    assert sum(v for k, v in chip_smoke.route_counts(chip_smoke.factor_plan(
        8192, 256, 4)).items() if k.endswith("/grid")) == 19

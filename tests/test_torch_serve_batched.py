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


# --- the batched fused launch's rule -------------------------------------------

#: (B, h, wtot, panel, itemsize) at the serving lane's shapes (the first
#: panel step of each bucket's factor, and the tall steps of the 4096
#: bucket, the panel at column wtot - h) -> the rule's (route, K, G, rows
#: a phase-A block holds, grid) on the H100.
SERVICE_ROUTES = {
    (8, 4096, 4096, 256, 4): ("grid", 6, 22, 187, 132),
    (8, 3840, 4096, 256, 4): ("grid", 6, 22, 175, 132),
    (8, 3584, 4096, 256, 4): ("grid", 7, 18, 200, 132),
    (8, 2048, 2048, 256, 4): ("grid", 8, 16, 128, 132),
    (8, 1024, 1024, 256, 4): ("grid", 8, 16, 64, 132),
    (8, 512, 512, 128, 4): ("grid", 8, 8, 64, 132),
    (8, 2048, 2048, 256, 2): ("grid", 8, 16, 128, 132),
}


@pytest.mark.parametrize("shape", sorted(SERVICE_ROUTES))
def test_fused_batched_geometry_at_the_service_shapes(shape):
    bsz, h, w, panel, isz = shape
    g = kf.fused_batched_geometry(bsz, h, w, panel, w - h, itemsize=isz)
    assert (g.route, g.groups, g.group, g.rows_per_block,
            g.grid) == SERVICE_ROUTES[shape]
    assert g.groups * g.group <= kf.H100_SMS
    assert g.smem_bytes == max(kp.cluster_smem_bytes(g.rows_per_block, panel,
                                                     isz),
                               kf.trailing_smem_bytes(panel, 32))


@pytest.mark.parametrize("itemsize", [4, 2])
def test_fused_batched_rule_keeps_one_wave_of_clusters(itemsize):
    """At h = 2048 a cluster holds the strip: up to the 7 clusters the H100
    holds at once the stack takes the cluster route in one wave; an eighth
    member takes the grid route, 8 groups of 16, in one round."""
    for bsz in range(1, 8):
        g = kf.fused_batched_geometry(bsz, 2048, 2048, 256,
                                      itemsize=itemsize)
        assert (g.route, g.cluster, g.groups) == ("cluster", 16, 0)
        assert g.grid == 16 * min(bsz + -(-bsz * g.chunks * (
            1 + g.row_tiles) // 16), kf.H100_CLUSTERS_OF_16)
    g = kf.fused_batched_geometry(8, 2048, 2048, 256, itemsize=itemsize)
    assert (g.route, g.groups, g.group) == ("grid", 8, 16)
    assert kf.fused_batched_geometry(8, 2048, 2048, 256, clusters=8,
                                     itemsize=itemsize).route == "cluster"


@pytest.mark.parametrize("itemsize", [4, 2])
def test_tall_members_never_take_the_one_block_route(itemsize):
    """(B, 4096) and the 4096 bucket's steps, at every batch the lane
    pads to, and the n=8192 form's tallest strips: the grid route (or a
    bfloat16 cluster), never one block; the groups fit the card."""
    for bsz in (1, 2, 4, 8, 16):
        for h in (4096, 3840, 3584, 8192):
            g = kf.fused_batched_geometry(bsz, h, 4096 if h < 4096 else h,
                                          256, 4096 - h if h < 4096 else 0,
                                          itemsize=itemsize)
            assert g.route != "block"
            if g.route == "grid":
                assert 1 <= g.groups <= bsz
                assert g.groups * g.group <= kf.H100_SMS
                assert kp.cluster_smem_bytes(g.rows_per_block, 256,
                                             itemsize) <= kp.PANEL_SMEM_MAX


@pytest.mark.parametrize("bsz,h,panel,sms", [
    (8, 4096, 256, 132), (8, 2048, 256, 132), (5, 3000, 128, 132),
    (16, 1024, 256, 132), (8, 4096, 256, 60), (3, 12800, 128, 132),
    (8, 27000, 256, 132), (1, 100, 16, 132), (40, 1024, 256, 132)])
def test_group_size_takes_the_most_groups_then_the_widest(bsz, h, panel,
                                                          sms):
    k, g = kf.group_size(bsz, h, panel, 4, sms)
    fits = [gg for gg in range(1, kp.PANEL_GRID_MAX + 1)
            if kp.cluster_smem_bytes(-(-h // gg), panel) <= kp.PANEL_SMEM_MAX]
    if not fits or fits[0] > sms or not kp.grid_size(h, panel):
        assert (k, g) == (0, 0)
        return
    # As many groups of the smallest fitting G as the card holds, at most
    # one a member; then the widest G that K groups leave, capped at the
    # single strip's G.
    assert k == min(bsz, sms // fits[0])
    assert g == min(sms // k, kp.grid_size(h, panel)) and g in fits
    assert k * g <= sms and -(-bsz // k) == -(-bsz // (sms // fits[0]))


@pytest.mark.parametrize("h,wtot,panel,col0,itemsize", [
    (2048, 2048, 256, 0, 4), (512, 2048, 256, 1536, 4),
    (4096, 4096, 256, 0, 4), (8192, 1024, 256, 0, 4),
    (12800, 1024, 128, 0, 4), (6865, 6865, 1024, 0, 4),
    (6849, 1024, 256, 0, 2), (96, 96, 16, 32, 4)])
def test_one_member_is_kernel_2s_launch(h, wtot, panel, col0, itemsize):
    """At B = 1 the batched rule is kernel 2's: the strip's route and blocks
    (panel_geometry), one group."""
    g = kf.fused_batched_geometry(1, h, wtot, panel, col0,
                                  itemsize=itemsize)
    strip = kp.panel_geometry(h, panel, itemsize)
    assert g == kf.fused_geometry(h, wtot, panel, col0, itemsize=itemsize)
    assert (g.route, g.group) == (strip.route, strip.blocks)
    assert g.groups == (1 if strip.route == "grid" else 0)


@pytest.mark.parametrize("chunks", [5, 4])
def test_batched_exchange_scratch(chunks):
    """Each member's counters, the stack's two tickets, then room for each
    member's grid-route exchange at any G the C launcher may take (up to
    PANEL_GRID_MAX): 2 x G zeroed 64-bit records a member (8-byte aligned
    after the tickets) and 2 x G pivot-row slots."""
    gmax = kp.PANEL_GRID_MAX
    u, ctr, gctr, rec, slot = kf._batched_scratch(3, 16, chunks, CPU)
    assert u.shape == (3, 16, chunks * kf.TRAIL_CHUNK_COLS)
    gctr0 = 3 * (3 + chunks)
    head = gctr0 + 2 + gctr0 % 2
    assert ctr.dtype == torch.int32 and ctr.numel() == head + 4 * gmax * 3
    assert gctr.data_ptr() == ctr.data_ptr() + 4 * gctr0
    assert rec.numel() == 2 * gmax * 3 * 2 and rec.data_ptr() % 8 == 0
    assert rec.data_ptr() == ctr.data_ptr() + 4 * head
    assert not bool(ctr.any())
    assert slot.shape == (3, 2 * gmax, 16) and slot.dtype == torch.float32


def test_route_launches_reset_and_cpu_counts_none(rng):
    """``_build.ROUTE_LAUNCHES`` (the batched fused launches by the route
    the launcher took) is cleared by ``reset_launches``; the CPU path, the
    plain version, counts nothing there."""
    _build.ROUTE_LAUNCHES["panel_trailing_fused_batched/grid"] = 3
    _build.reset_launches()
    assert _build.ROUTE_LAUNCHES == {}
    x = torch.as_tensor(rng.standard_normal((2, 64, 96)),
                        dtype=torch.float32)
    kf.panel_trailing_fused_batched(x, 16, 0, panel=16)
    assert _build.ROUTE_LAUNCHES == {}


def test_one_block_entry_runs_the_plain_version_on_the_cpu(rng):
    """``panel_trailing_fused_one_block`` takes a block or a stack; on the
    CPU it is the plain version and counts no launch; the route-forcing
    entry needs the card."""
    x = torch.as_tensor(rng.standard_normal((2, 64, 96)),
                        dtype=torch.float32)
    before = dict(_build.LAUNCHES)
    got = kf.panel_trailing_fused_one_block(x.clone(), 16, 0, panel=16)
    want = kf.panel_trailing_fused_batched_plain(x.clone(), 16, 0, panel=16)
    one = kf.panel_trailing_fused_one_block(x[1].clone(), 16, 0, panel=16)
    for g, w, o in zip(got, want, one):
        assert torch.equal(g, w) and torch.equal(g[1], o)
    assert dict(_build.LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        kf.panel_trailing_fused_batched_at(x, 16, 0, panel=16, route="grid")


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
@pytest.mark.parametrize("bsz,h,w,panel,dtype,route", [
    (3, 512, 512, 128, torch.float32, "cluster"),
    (2, 300, 700, 64, torch.float32, "cluster"),
    (2, 4096, 768, 256, torch.float32, "grid"),
    (3, 512, 512, 128, BF16, "cluster"),
    (2, 7424, 512, 256, BF16, "grid"),           # taller than a cluster
    (8, 1024, 1024, 256, torch.float32, "grid"),  # more than 7 clusters
    (8, 1024, 1024, 256, BF16, "grid"),
    (9, 700, 800, 128, torch.float32, "grid")])
def test_fused_batched_kernel_on_card(cuda_device, bsz, h, w, panel, dtype,
                                      route):
    """One launch per stack on the rule's route, the C launcher's geometry
    equal to the Python rule's; every member bit for bit kernel 2 on it
    alone (every phase-A route), pivots equal to the plain version's."""
    x = torch.as_tensor(np.random.default_rng(h + w).standard_normal(
        (bsz, h, w)), dtype=torch.float32, device=cuda_device).to(dtype)
    isz = x.element_size()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    info = kf.fused_batched_launch_info(bsz, h, w, panel, itemsize=isz)
    geom = kf.fused_batched_geometry(bsz, h, w, panel, sms=sms, itemsize=isz,
                                     clusters=info["fit"] if info["route"]
                                     == "cluster" else None)
    assert geom.route == route
    assert {k: info[k] for k in geom._fields} == geom._asdict()
    key = "panel_trailing_fused_batched" + ("_bf16" if dtype == BF16
                                            else "")
    before = _build.LAUNCHES[key]
    by_route = dict(_build.ROUTE_LAUNCHES)
    work = x.clone()
    got = kf.panel_trailing_fused_batched(work, 0, 0, panel=panel)
    assert _build.LAUNCHES[key] == before + 1
    by_route[f"{key}/{route}"] = by_route.get(f"{key}/{route}", 0) + 1
    assert _build.ROUTE_LAUNCHES == by_route
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
def test_fused_batched_routes_agree_and_fail_typed_on_card(cuda_device):
    """Every route that holds the strip gives the rule's bits (the cluster
    waves, the one-block route, the grid route at other K and G); a grid
    route the card cannot hold at once, or a route that does not hold the
    strip, raises KernelLaunchError and launches nothing."""
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (8, 512, 640)), dtype=torch.float32, device=cuda_device)
    want = x.clone()
    ref = kf.panel_trailing_fused_batched(want, 0, 0, panel=128)
    for route, k, g in (("cluster", 0, 0), ("block", 0, 0), ("grid", 4, 8),
                        ("grid", 8, 3), ("grid", 0, 0)):
        work = x.clone()
        n = _build.ROUTE_LAUNCHES.get(f"panel_trailing_fused_batched/{route}",
                                      0)
        got = kf.panel_trailing_fused_batched_at(work, 0, 0, panel=128,
                                                 route=route, groups=k,
                                                 group=g)
        assert _build.ROUTE_LAUNCHES[
            f"panel_trailing_fused_batched/{route}"] == n + 1
        for a, b in zip(got[:4], ref[:4]):
            assert torch.equal(a, b)
        assert torch.equal(work, want)
    before = dict(_build.LAUNCHES)
    by_route = dict(_build.ROUTE_LAUNCHES)
    with pytest.raises(_build.KernelLaunchError, match="CUDA error"):
        kf.panel_trailing_fused_batched_at(x.clone(), 0, 0, panel=128,
                                           route="grid", groups=8, group=40)
    tall = torch.zeros((2, 4096, 512), device=cuda_device)
    with pytest.raises(_build.KernelLaunchError, match="CUDA error"):
        kf.panel_trailing_fused_batched_at(tall, 0, 0, panel=256,
                                           route="cluster")
    assert dict(_build.LAUNCHES) == before
    assert _build.ROUTE_LAUNCHES == by_route


def _same(g, w):
    """Equal values, NaN equal to NaN."""
    if g.is_floating_point():
        gn, wn = g.isnan(), w.isnan()
        return torch.equal(gn, wn) and torch.equal(g.masked_fill(gn, 0),
                                                   w.masked_fill(wn, 0))
    return torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "zero_pivot", "nan"])
@pytest.mark.parametrize("shape", [
    (8, 128, 128), (64, 128, 128), (3, 700, 128), (1, 128, 128),
    (2, 128, 128), (4, 128, 128), (1, 256, 256), (2, 256, 256),
    (4, 256, 256), (8, 256, 256), (3, 129, 128), (2, 257, 256)])
def test_batched_panel_kernel_bf16_on_card(cuda_device, shape, case):
    """The bfloat16 batched panel kernel: one launch on the rule's route,
    each member bit for bit the plain version and the bfloat16 kernel 1
    on it alone, on a random stack, one with a zero pivot (a zero first
    column in member 0) and one with a NaN entry."""
    x = torch.as_tensor(np.random.default_rng(shape[0]).standard_normal(
        shape), dtype=BF16)
    if case == "zero_pivot":
        x[0, :, 0] = 0
    elif case == "nan":
        x[-1, shape[1] // 2, 1] = float("nan")
    x = x.to(cuda_device)
    route = kp.panel_batched_geometry(*shape[1:], 2).route
    before = _build.LAUNCHES["panel_factor_batched_bf16"]
    by_route = _build.ROUTE_LAUNCHES.get(
        f"panel_factor_batched_bf16/{route}", 0)
    got = kp.panel_factor_batched(x.clone())
    assert _build.LAUNCHES["panel_factor_batched_bf16"] == before + 1
    assert _build.ROUTE_LAUNCHES[f"panel_factor_batched_bf16/{route}"] \
        == by_route + 1
    for g, w in zip(got, kp.panel_factor_batched_plain(x.clone())):
        assert _same(g, w)
    for i in range(shape[0]):
        for g, w in zip(got, kp.panel_factor(x[i].clone())):
            assert _same(g[i], w)


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

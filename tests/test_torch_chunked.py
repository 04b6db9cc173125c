"""The port's flat and chunked factor forms, its size routing and its
single-card handoff lane against the JAX package's ``core/blocked.py``
(the same float32 inputs on both sides; the JAX side on the CPU, its
Pallas kernels in interpret mode), plus the port-internal contracts: the
ABFT rider changes no bit of the factor, ``swap_impl="loop"`` equals
``"gather"``, and the card runs the chunked form as the CPU does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu import obs as jobs
from gauss_tpu.core import blocked as jb
from gauss_tpu.core.matmul import resolve_precision as jresolve_precision
from gauss_tpu.resilience.abft import default_tol
from gauss_tpu_torch import obs as tobs
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.core import convert
from gauss_tpu_torch.kernels import _build

# tests/test_torch_blocked.py's tolerances: m, linv and uinv relative to
# max |m| (f32 factorizations in two frameworks), min |pivot| likewise.
TOL_FACTOR = 5e-5
TOL_MINPIV = 1e-5
FIELDS = ("m", "perm", "linv", "uinv")


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


def _abft_tol(a, panel):
    """The JAX package's detection threshold (``resilience.abft.
    default_tol``) for the identity-padded operand of ``a``."""
    n = a.shape[0]
    npad = -(-n // panel) * panel
    am = np.eye(npad, dtype=np.float32)
    am[:n, :n] = a
    return default_tol(npad, np.float32, float(np.abs(am.sum(0)).max()))


def _bitwise_equal(f1, f2):
    return all(torch.equal(getattr(f1, k), getattr(f2, k)) for k in FIELDS)


def _chip_smoke():
    """The repo root's chip_smoke module (its float64 reference factor and
    its large-n phase)."""
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


# --- the flat form --------------------------------------------------------


@pytest.mark.parametrize("impl", ["fused", "pallas", "jax"])
@pytest.mark.parametrize("n,panel", [(100, 16), (100, 32), (256, 16),
                                     (256, 32)])
def test_flat_matches_jax(impl, n, panel):
    a = _matrix(n, 7 * n + panel)
    fj = jb.lu_factor_blocked(jnp.asarray(a), panel=panel, panel_impl=impl)
    ft = tb.lu_factor_blocked(a, panel=panel, panel_impl=impl, device="cpu")
    _compare(fj, ft)
    assert ft.abft_err is None and fj.abft_err is None


def test_flat_swap_loop_equals_gather():
    """``swap_impl="loop"`` gives the folded gather's bits on the stock
    panel and on the panel kernel's route, matches the JAX package's
    two-row exchange loop, and a bad name raises."""
    a = _matrix(100, 3)
    gather = tb.lu_factor_blocked(a, panel=16, panel_impl="jax",
                                  device="cpu")
    loop = tb.lu_factor_blocked(a, panel=16, panel_impl="jax",
                                swap_impl="loop", device="cpu")
    assert _bitwise_equal(loop, gather)
    assert _bitwise_equal(
        tb.lu_factor_blocked(a, panel=16, panel_impl="pallas",
                             swap_impl="loop", device="cpu"),
        tb.lu_factor_blocked(a, panel=16, panel_impl="pallas", device="cpu"))
    _compare(jb.lu_factor_blocked(jnp.asarray(a), panel=16, panel_impl="jax",
                                  swap_impl="loop"), loop)
    with pytest.raises(ValueError, match="swap_impl"):
        tb.lu_factor_blocked(a, swap_impl="scatter", device="cpu")


def test_flat_zero_pivot_safe_on_singular_matrix():
    """A singular system (a zero column and duplicate rows) factors to a
    finite factor with min |pivot| 0 in both packages; unguarded, the
    stock panel NaN-poisons it."""
    a = _matrix(96, 5)
    a[:, 7] = 0.0
    a[40] = a[3]
    fj = jb.lu_factor_blocked(jnp.asarray(a), panel=32, zero_pivot_safe=True)
    ft = tb.lu_factor_blocked(a, panel=32, zero_pivot_safe=True,
                              device="cpu")
    assert np.isfinite(np.asarray(fj.m)).all()
    assert torch.isfinite(ft.m).all() and torch.isfinite(ft.linv).all()
    assert float(ft.min_abs_pivot) == 0.0 == float(fj.min_abs_pivot)
    raw = tb.lu_factor_blocked(a, panel=32, panel_impl="jax", device="cpu")
    assert not torch.isfinite(raw.m).all()
    assert float(raw.min_abs_pivot) == 0.0


@pytest.mark.parametrize("impl", ["auto", "fused", "pallas"])
def test_flat_abft_rider_is_bit_identical(impl):
    """abft=True runs the unfused pair: the factor equals the
    ``abft=False, panel_impl="pallas"`` one bit for bit, and every
    checksum entry of both packages sits below the JAX package's
    detection threshold."""
    n, panel = 200, 32
    a = _matrix(n, 11)
    ft = tb.lu_factor_blocked(a, panel=panel, panel_impl=impl, abft=True,
                              device="cpu")
    ref = tb.lu_factor_blocked(a, panel=panel, panel_impl="pallas",
                               device="cpu")
    assert _bitwise_equal(ft, ref)
    fj = jb.lu_factor_blocked(jnp.asarray(a), panel=panel, panel_impl=impl,
                              abft=True)
    assert ft.abft_err.shape == np.asarray(fj.abft_err).shape == (
        ft.m.shape[0] // panel + 1,)
    tol = _abft_tol(a, panel)
    assert (ft.abft_err.numpy() < tol).all()
    assert (np.asarray(fj.abft_err) < tol).all()
    _compare(fj, ft)


def test_abft_default_tol_is_the_jax_packages():
    for npad, dtype, scale in ((224, np.float32, 31.5), (8192, np.float32,
                                                         0.2),
                               (64, np.float64, 1e3)):
        assert tb.abft_default_tol(npad, dtype, scale) == default_tol(
            npad, dtype, scale)
    assert tb.abft_default_tol(224, torch.float32, 3.0) == default_tol(
        224, np.float32, 3.0)


def test_flat_abft_detects_a_corrupted_factor():
    """A flipped entry of the finished factor shows in the final identity
    check at about its own magnitude."""
    a = _matrix(128, 2)
    f = tb.lu_factor_blocked(a, panel=32, abft=True, device="cpu")
    m = f.m.clone()
    m[60, 100] += 4.0  # an entry of U: only column 100's identity moves
    crow0 = tb._csum_init(torch.as_tensor(a))
    err, col = tb._csum_final_err_lu(m, crow0)
    el60 = float(torch.tril(f.m, -1)[:, 60].sum()) + 1.0
    assert int(col) == 100 and abs(float(err) - 4.0 * abs(el60)) < 1e-2
    assert float(tb._csum_final_err_lu(f.m, crow0)[0]) < 1e-2
    with pytest.raises(ValueError, match="abft=True requires"):
        tb.lu_factor_blocked(a, gemm_precision="bf16x3", abft=True,
                             device="cpu")


# --- the chunked form -----------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "fused", "pallas", "jax"])
@pytest.mark.parametrize("chunk", [2, 3])
def test_chunked_matches_jax(impl, chunk):
    """n=200 pads to 7 panels of 32: chunk 2 and 3 give ragged last
    groups."""
    a = _matrix(200, 200 + chunk)
    fj = jb.lu_factor_blocked_chunked(jnp.asarray(a), panel=32, chunk=chunk,
                                      panel_impl=impl)
    ft = tb.lu_factor_blocked_chunked(a, panel=32, chunk=chunk,
                                      panel_impl=impl, device="cpu")
    assert ft.linv.shape == (7, 32, 32)
    _compare(fj, ft)


@pytest.mark.parametrize("impl", ["auto", "fused", "pallas", "jax"])
@pytest.mark.parametrize("chunk", [2, 3])
@pytest.mark.parametrize("seed", range(30, 38))
def test_chunked_seeds_against_float64(seed, chunk, impl):
    """Seeds 30-37 taken as they come (33 among them, where one uinv
    entry of the fused route differs from the JAX package's by 1.3x
    TOL_FACTOR): the same pivots as the JAX package, and every field
    within TOL_FACTOR * max |m| of the float64 factor with those pivots
    (chip_smoke.lu_f64, numpy)."""
    a = _matrix(200, seed)
    fj = jb.lu_factor_blocked_chunked(jnp.asarray(a), panel=32, chunk=chunk,
                                      panel_impl=impl)
    ft = tb.lu_factor_blocked_chunked(a, panel=32, chunk=chunk,
                                      panel_impl=impl, device="cpu")
    np.testing.assert_array_equal(ft.perm.numpy(), np.asarray(fj.perm))
    ref = _chip_smoke().lu_f64(a, ft.perm, 32)
    scale = float(ref.m.abs().max())
    for field in ("m", "linv", "uinv"):
        np.testing.assert_allclose(getattr(ft, field).double().numpy(),
                                   getattr(ref, field).numpy(), rtol=0,
                                   atol=TOL_FACTOR * scale, err_msg=field)


def test_chunked_fused_rounding_against_float64():
    """Where the two packages' fused chunked factors differ most (an
    entry of uinv at this input differs by 1.3x TOL_FACTOR * max |m|):
    the JAX package's in-kernel trailing update inverts each segment's
    coupling by a Neumann series, the port's by forward substitution, and
    a U block of condition ~125 amplifies the difference. Held to the
    float64 factor with the same pivots: the port is no further from it
    than the JAX package in any field."""
    import scipy.linalg

    a = _matrix(200, 33)
    fj = jb.lu_factor_blocked_chunked(jnp.asarray(a), panel=32, chunk=2,
                                      panel_impl="fused")
    ft = tb.lu_factor_blocked_chunked(a, panel=32, chunk=2,
                                      panel_impl="fused", device="cpu")
    np.testing.assert_array_equal(ft.perm.numpy(), np.asarray(fj.perm))
    ap = np.eye(224)
    ap[:200, :200] = a
    p, low, up = scipy.linalg.lu(ap[np.asarray(fj.perm)])
    assert np.array_equal(p, np.eye(224))  # the same pivots in float64
    want = {"m": np.tril(low, -1) + up,
            "linv": np.stack([np.linalg.inv(low[k:k + 32, k:k + 32])
                              for k in range(0, 224, 32)]),
            "uinv": np.stack([np.linalg.inv(up[k:k + 32, k:k + 32])
                              for k in range(0, 224, 32)])}
    for field, ref in want.items():
        err_t = np.abs(getattr(ft, field).numpy() - ref).max()
        err_j = np.abs(np.asarray(getattr(fj, field)) - ref).max()
        assert err_t <= err_j, (field, err_t, err_j)


@pytest.mark.parametrize("impl", ["auto", "jax"])
def test_chunked_strip_form_matches_jax(monkeypatch, impl):
    """The deferred update's in-place strip form, forced in both packages
    (strips of 48 rows plus a tail; the unstripped byte gate off, and the
    JAX caches cleared so the patched trace constants are read), against
    each other and against the unstripped form."""
    a = _matrix(200, 17)
    unstripped = tb.lu_factor_blocked_chunked(a, panel=32, chunk=2,
                                              panel_impl=impl, device="cpu")
    for mod in (jb, tb):
        monkeypatch.setattr(mod, "GROUP_UPDATE_STRIP", 48)
        monkeypatch.setattr(mod, "GROUP_UPDATE_UNSTRIPPED_MAX_BYTES", 0)
    jax.clear_caches()
    fj = jb.lu_factor_blocked_chunked(jnp.asarray(a), panel=32, chunk=2,
                                      panel_impl=impl)
    ft = tb.lu_factor_blocked_chunked(a, panel=32, chunk=2, panel_impl=impl,
                                      device="cpu")
    jax.clear_caches()
    _compare(fj, ft)
    assert torch.equal(ft.perm, unstripped.perm)
    scale = float(unstripped.m.abs().max())
    assert float((ft.m - unstripped.m).abs().max()) <= TOL_FACTOR * scale


def _group_inputs(gh, w, seed):
    return np.random.default_rng(seed).standard_normal((gh, w)).astype(
        np.float32)


@pytest.mark.parametrize("impl", ["fused", "pallas", "jax"])
def test_factor_group_rectangular_block(impl):
    """A group's own (gh, w) column block alone (gs = 0, no columns right
    of the group), as the out-of-core engine calls it. Rows that no panel
    of the block chose keep an order that depends on the panel route, so
    each route is held to the JAX package's same route ("auto" there is
    the stock panel off a TPU, and at panel 16 on one too)."""
    panel, chunk = 16, 3
    m = _group_inputs(112, chunk * panel, 41)
    prec = jresolve_precision("highest", allow_split=True)
    jm, jperm, jmin, jlinv, juinv = jb._factor_group(
        jnp.asarray(m), jnp.arange(112), jnp.asarray(jnp.inf, jnp.float32),
        0, panel, chunk, impl, prec)
    tm = torch.as_tensor(m).clone()
    out = tb._factor_group(tm, torch.arange(112),
                           torch.full((), float("inf")), 0, panel, chunk,
                           impl, "f32")
    fj = jb.BlockedLU(jm, jperm, jmin, jlinv, juinv)
    ft = tb.BlockedLU(*out)
    assert ft.m is tm and ft.m.shape == (112, chunk * panel)
    _compare(fj, ft)


@pytest.mark.parametrize("col", [5, 150])
def test_factor_group_checksum_rider(col):
    """``crow``: the group's checksum update and its two checks. One entry
    of the operand is corrupted after its checksum row was taken, in the
    group's columns (col 5) or right of them (col 150): both packages
    return the same crow' within tolerance and localize the corruption to
    the same column."""
    n, panel, chunk = 192, 32, 2
    a = _matrix(n, 61)
    crow = a.sum(0, keepdims=True)
    a[120, col] += 8.0
    prec = jresolve_precision("highest", allow_split=True)
    jout = jb._factor_group(jnp.asarray(a), jnp.arange(n),
                            jnp.asarray(jnp.inf, jnp.float32), 0, panel,
                            chunk, "pallas", prec, crow=jnp.asarray(crow))
    tout = tb._factor_group(torch.as_tensor(a).clone(), torch.arange(n),
                            torch.full((), float("inf")), 0, panel, chunk,
                            "pallas", "f32", crow=torch.as_tensor(crow))
    assert len(tout) == len(jout) == 8
    _compare(jb.BlockedLU(*jout[:5]), tb.BlockedLU(*tout[:5]))
    jcrow, jerr, jcol = (np.asarray(x) for x in jout[5:])
    tcrow, terr, tcol = tout[5:]
    scale = np.abs(jcrow).max()
    np.testing.assert_allclose(tcrow.numpy(), jcrow, rtol=0,
                               atol=TOL_FACTOR * scale)
    assert int(tcol) == int(jcol) == col
    assert float(terr) > 1.0 and abs(float(terr) - float(jerr)) < 1e-2 * (
        float(jerr))


def test_chunked_abft_rider_is_bit_identical():
    a = _matrix(200, 23)
    ft = tb.lu_factor_blocked_chunked(a, panel=32, chunk=3, abft=True,
                                      device="cpu")
    ref = tb.lu_factor_blocked_chunked(a, panel=32, chunk=3,
                                       panel_impl="pallas", device="cpu")
    assert _bitwise_equal(ft, ref)
    fj = jb.lu_factor_blocked_chunked(jnp.asarray(a), panel=32, chunk=3,
                                      abft=True)
    assert ft.abft_err.shape == np.asarray(fj.abft_err).shape == (4,)
    tol = _abft_tol(a, 32)
    assert (ft.abft_err.numpy() < tol).all()
    assert (np.asarray(fj.abft_err) < tol).all()


def test_chunked_solve_and_bad_chunk():
    n = 150
    a = _matrix(n, 29)
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    fac = tb.lu_factor_blocked_chunked(a, panel=32, chunk=2, device="cpu")
    x = tb.lu_solve(fac, b).double().numpy()
    ref = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(x, ref, rtol=5e-3, atol=5e-3)
    for chunk in (0, -1):
        with pytest.raises(ValueError, match="chunk must be >= 1"):
            tb.lu_factor_blocked_chunked(a, chunk=chunk, device="cpu")


def test_abft_err_converts_both_ways():
    """A JAX factor with ``abft_err`` crosses to the port and back."""
    a = _matrix(64, 9)
    fj = jb.lu_factor_blocked(jnp.asarray(a), panel=16, abft=True)
    arrays = convert.blocked_lu_to_numpy(fj)
    assert len(arrays) == 6 and arrays[5].shape == (5,)
    ft = convert.blocked_lu_from_numpy(*arrays, device="cpu")
    assert ft.abft_err.dtype == torch.float32
    np.testing.assert_array_equal(ft.abft_err.numpy(), arrays[5])
    back = jb.BlockedLU(*[None if v is None else jnp.asarray(v)
                          for v in convert.blocked_lu_to_numpy(ft)])
    np.testing.assert_array_equal(np.asarray(back.abft_err), arrays[5])
    plain = convert.blocked_lu_to_numpy(
        tb.lu_factor_blocked(a, panel=16, device="cpu"))
    assert plain[5] is None


# --- routing --------------------------------------------------------------

ROUTE_NS = (64, 1000, 1024, 2048, 4096, 4097, 8192, 12288, 12800, 16384,
            34048, 100000)


def _jax_route(f):
    """(form, chunk, abft) of a JAX resolve_factor result."""
    fn = getattr(f, "func", f)
    kw = getattr(f, "keywords", {})
    form = {jb.lu_factor_blocked: "flat",
            jb.lu_factor_blocked_donating: "flat",
            jb.lu_factor_blocked_chunked: "chunked",
            jb.lu_factor_blocked_chunked_donating: "chunked",
            jb.lu_factor_blocked_unrolled: "unrolled",
            jb.lu_factor_blocked_unrolled_donating: "unrolled"}[fn]
    return form, kw.get("chunk", jb.CHUNK_DEFAULT), kw.get("abft", False)


def _port_route(f):
    fn = getattr(f, "func", f)
    kw = getattr(f, "keywords", {})
    form = {tb.lu_factor_blocked: "flat",
            tb.lu_factor_blocked_chunked: "chunked",
            tb.lu_factor_blocked_unrolled: "unrolled"}[fn]
    return form, kw.get("chunk", tb.CHUNK_DEFAULT), kw.get("abft", False)


@pytest.mark.parametrize("unroll", ["auto", True, False, "chunked"])
@pytest.mark.parametrize("abft", [False, True])
def test_resolve_factor_matches_jax(monkeypatch, unroll, abft):
    """The form and chunk the port picks for each n, on the CPU against the
    JAX package on the CPU, and for a CUDA device (route choice only,
    nothing launched) against the JAX package on a TPU."""
    for backend, device in (("cpu", "cpu"), ("tpu", "cuda")):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        for n in ROUTE_NS:
            want = _jax_route(jb.resolve_factor(n, unroll, abft=abft))
            got = _port_route(tb.resolve_factor(n, unroll, abft=abft,
                                                device=device))
            assert got == want, (backend, n, unroll, abft)
    assert tb.UNROLL_MAX_N == jb.UNROLL_MAX_N
    assert tb.MAX_CHUNK_GROUPS == jb.MAX_CHUNK_GROUPS
    assert tb.MAX_CHUNK == jb.MAX_CHUNK
    assert tb.CHUNK_DEFAULT == jb.CHUNK_DEFAULT


def test_resolve_factor_options():
    f = tb.resolve_factor(8192, "auto", device="cuda")
    assert f is tb.lu_factor_blocked_chunked
    f = tb.resolve_factor(12800, "auto", device="cuda")
    assert f.func is tb.lu_factor_blocked_chunked and f.keywords == {
        "chunk": 8}
    assert tb.resolve_factor(4096, "auto") is tb.lu_factor_blocked_unrolled
    f = tb.resolve_factor(2048, "auto", donate=True, device="cpu")
    assert f.func is tb.lu_factor_blocked_unrolled and f.keywords == {
        "donate": True}
    with pytest.raises(ValueError, match="unknown unroll"):
        tb.resolve_factor(64, "bogus")
    from gauss_tpu_torch.resilience import checkpoint as tckpt

    f = tb.resolve_factor(64, "auto", checkpoint_path="ckpt")
    assert f.func is tckpt.lu_factor_blocked_chunked_checkpointed
    assert f.keywords == {"path": "ckpt"}
    with pytest.raises(ValueError, match="mutually exclusive"):
        tb.resolve_factor(64, "auto", checkpoint_path="ckpt", abft=True)


def test_donate_factors_in_place_only_unpadded():
    a = torch.as_tensor(_matrix(64, 4))
    keep = a.clone()
    f = tb.lu_factor_blocked_unrolled(a, panel=32, device="cpu", donate=True)
    assert f.m is a and not torch.equal(a, keep)
    b = torch.as_tensor(_matrix(60, 4))
    keep = b.clone()
    f = tb.lu_factor_blocked_chunked(b, panel=32, chunk=1, device="cpu",
                                     donate=True)
    assert f.m is not b and torch.equal(b, keep)
    assert torch.equal(f.m[:60, :60], tb.lu_factor_blocked_chunked(
        keep, panel=32, chunk=1, device="cpu").m[:60, :60])


# --- the handoff ----------------------------------------------------------


def _route_events(obs, path, fn):
    with obs.run(metrics_out=str(path), tool="handoff"):
        x = fn()
    return x, [{k: v for k, v in ev.items() if k not in ("t", "seq", "run")}
               for ev in obs.read_events(path) if ev["type"] == "route"]


def test_handoff_single_chip_lane_matches_jax(tmp_path):
    n = 48
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    budget = 3 * n * n * 4
    assert tb.fits_single_chip(n, budget=budget) == jb.fits_single_chip(
        n, budget=budget)
    assert tb.fits_single_chip(n, budget=budget - 1) is False
    xj, ej = _route_events(jobs, tmp_path / "j.jsonl", lambda: jb.solve_handoff(
        a, b, budget=budget, panel=16))
    xt, et = _route_events(tobs, tmp_path / "t.jsonl", lambda: tb.solve_handoff(
        a, b, budget=budget, panel=16, device="cpu"))
    assert et == ej and et[0]["lane"] == "single_chip"
    assert et[0]["est_bytes"] == budget and et[0]["itemsize"] == 4
    np.testing.assert_allclose(xt, np.linalg.solve(a, b), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(xt, xj, rtol=1e-6, atol=1e-8)


def test_handoff_itemsize_matches_jax():
    import ml_dtypes

    f64 = np.ones((4, 4))
    cases = [(f64, {}), (f64.astype(np.float32), {}),
             (f64.astype(np.float16), {}),
             (f64.astype(ml_dtypes.bfloat16), {}),
             (f64, {"dtype": np.float32}), (f64, {"dtype": "bfloat16"}),
             (f64.astype(np.float32), {"dtype": "float16"})]
    for a, kw in cases:
        assert tb._handoff_itemsize(a, kw) == jb._handoff_itemsize(a, kw), (
            a.dtype, kw)
    assert tb._handoff_itemsize(torch.ones(2, dtype=torch.float16), {}) == 2
    assert tb._handoff_itemsize(torch.ones(2, dtype=torch.float64), {}) == 4


def test_handoff_off_card_lanes_raise_typed_error(tmp_path):
    """The sharded lane still raises typed; the out-of-core lane, forced
    or size-routed past the budget, now solves, with the JAX package's
    route event."""
    n = 32
    a, b = np.eye(n), np.ones(n)
    with pytest.raises(tb.LaneNotPortedError, match="queue-1 item 10"):
        tb.solve_handoff(a, b, engine="dist")
    assert np.array_equal(tb.solve_handoff(a, b, engine="outofcore",
                                           device="cpu"), b)
    x, ev = _route_events(tobs, tmp_path / "t.jsonl", lambda: tb.solve_handoff(
        a, b, budget=16, device="cpu"))
    assert np.array_equal(x, b)
    assert ev[0]["lane"] == "outofcore" and ev[0]["budget"] == 16
    assert ev[0]["est_bytes"] == 3 * n * n * 4
    with pytest.raises(ValueError, match="do not apply"):
        tb.solve_handoff(a, b, engine="dist", panel_impl="jax")
    with pytest.raises(ValueError, match="unknown handoff engine"):
        tb.solve_handoff(a, b, engine="grid")
    # The single-card lane factors in float32 or bfloat16 (the dtypes the
    # kernels take) and refuses any other storage dtype.
    with pytest.raises(ValueError, match="float32 or bfloat16 only"):
        tb.solve_handoff(a, b, engine="single_chip", dtype="float16",
                         device="cpu")
    x = tb.solve_handoff(a, b, engine="single_chip", dtype="bfloat16",
                         device="cpu")
    assert np.array_equal(x, b)
    assert tb.device_memory_budget("cpu") == jb.DEFAULT_CHIP_BYTES


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chunked form launches the "
                    "CUDA kernels (run `python -m pytest -m cuda "
                    "tests/test_torch_chunked.py` or `python3 chip_smoke.py` "
                    "on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [2, 3])
def test_card_chunked_matches_cpu(cuda_device, chunk):
    """n=1000 at panel 128: the fused kernel on strided group views, the
    panel kernel on each group's last panel, against the same call on the
    CPU: the same pivots, and no further from the float64 factor with
    those pivots (chip_smoke.lu_f64, numpy) than chip_smoke.F64_RATIO
    times the CPU's float32 factor, and than chip_smoke.F64_CAP (in max
    |m|). TOL_FACTOR lies below the float32 rounding of the factorization
    at this size."""
    chip_smoke = _chip_smoke()
    a = _matrix(1000, 5 + chunk)
    _build.reset_launches()
    fg = tb.lu_factor_blocked_chunked(a, panel=128, chunk=chunk,
                                      device=cuda_device)
    groups = -(-8 // chunk)
    assert _build.LAUNCHES["panel_trailing_fused"] == 8 - groups
    assert (_build.LAUNCHES["panel_factor_cluster"]
            + _build.LAUNCHES["panel_factor"]) == groups
    fc = tb.lu_factor_blocked_chunked(a, panel=128, chunk=chunk,
                                      device="cpu")
    assert torch.equal(fg.perm.cpu(), fc.perm)
    f64 = chip_smoke.lu_f64(a, fc.perm, 128)
    err = chip_smoke.factor_err(fg, f64)
    assert err <= chip_smoke.F64_RATIO * chip_smoke.factor_err(fc, f64)
    assert err <= chip_smoke.F64_CAP


@pytest.mark.cuda
@pytest.mark.parametrize("col0,w", [(0, 384), (128, 384), (256, 384)])
def test_card_fused_on_strided_group_view(cuda_device, col0, w):
    """The fused kernel on a group's live rows, a view whose leading
    dimension (1024) exceeds its width, including the last panel of the
    group (no trailing columns): the panel bit for bit against the plain
    version, the block within tolerance, and nothing outside the view's
    trailing columns written."""
    from gauss_tpu_torch.kernels import panel_fused as kf

    full = torch.as_tensor(_matrix(1024, col0 + w), device=cuda_device)
    orig = full.clone()
    view = full[col0:, 128:128 + w]
    assert view.stride(0) == 1024
    p, ipiv, perm, mp, _ = kf.panel_trailing_fused(view, col0, 0, panel=128)
    rp, ripiv, rperm, rmp, rblock = kf.panel_trailing_fused_plain(
        orig[col0:, 128:128 + w].cpu().clone(), col0, 0, panel=128)
    assert torch.equal(p.cpu(), rp) and torch.equal(ipiv.cpu(), ripiv)
    assert torch.equal(perm.cpu(), rperm) and float(mp) == float(rmp)
    scale = float(rblock.abs().max())
    assert float((view.cpu() - rblock).abs().max()) <= TOL_FACTOR * scale
    outside = torch.ones_like(full, dtype=torch.bool)
    outside[col0:, 128 + col0 + 128:128 + w] = False
    assert torch.equal(full[outside], orig[outside])


def test_chip_smoke_large_n_phase_rehearsal(monkeypatch, tmp_path):
    """chip_smoke.py's large-n phase on the CPU at small sizes: its
    routing checks at the card's sizes, the launch-by-launch checks
    against the plain versions (panel 64, so the fused route runs), both
    update forms against the CPU, the cells, the counted path's CLI and
    solves, the flat form's three checks and the handoff lane, end to
    end (no kernel launches here, so every count is 0)."""
    import io
    from contextlib import redirect_stdout

    chip_smoke = _chip_smoke()
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "REPO", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "CHUNK_CHECK", (256, 64, (2, 3)))
    monkeypatch.setattr(chip_smoke, "CHUNK_CHECK_STRIP", 48)
    monkeypatch.setattr(chip_smoke, "LARGE_CELLS", ((320, 64, 2),
                                                    (192, 64, 3)))
    monkeypatch.setattr(chip_smoke, "FLAT_N", 192)
    buf = io.StringIO()
    with redirect_stdout(buf):
        launches, out = chip_smoke.phase_large_n()
    assert not any(launches.values())
    # Per update form, chunk 2 gives groups [fused, panel] x 2 and chunk 3
    # [fused, fused, panel] and [panel]; then the launch with no trailing
    # columns. Every launch runs on a strided view of the matrix.
    assert out["chunk_check"]["launches"] == {
        "fused": 9, "fused strided": 9, "fused no trailing": 1, "panel": 8,
        "panel strided": 8}
    assert all(e["card_vs_cpu"] == 0.0 and e["card_vs_f64"] == e[
        "cpu_vs_f64"] < 1e-4 for e in out["chunk_check"]["whole_factor"]
        .values())
    assert [c["groups"] for c in out["cells"]] == [3, 1]
    assert out["cells"][0]["launches"] == {
        "panel_trailing_fused/cluster": 2, "panel_factor_cluster/cluster": 3}
    # Each cell's launches checked one by one: on strided group views
    # where the cell has more than one group.
    assert [c["checked_launches"] for c in out["cells"]] == [
        {"fused": 2, "fused strided": 2, "panel": 3, "panel strided": 3},
        {"fused": 2, "panel": 1, "panel strided": 1}]
    assert all(0 < c["backward_err"] <= chip_smoke.BACKWARD_RATIO
               * c["lu_factor_backward_err"] for c in out["cells"])
    assert out["handoff"]["largest_n"] == int(
        (tb.DEFAULT_CHIP_BYTES // 12) ** 0.5)
    text = buf.getvalue()
    assert '{"large_n": ' in text and "queue-1 item 10" in text
    # The plans at the card's sizes: n=8192 runs 24 fused launches (15 on
    # the grid route) and 8 panel-kernel launches (4 on the grid route);
    # n=12,800 87 fused (41 grid) and 13 panel (5 grid); neither sends a
    # strip to the one-block route.
    plan = chip_smoke.factor_plan(8192, 256, 4)
    assert chip_smoke.route_counts(plan) == {
        "panel_trailing_fused/grid": 15, "panel_trailing_fused/cluster": 9,
        "panel_factor_grid/grid": 4, "panel_factor_cluster/cluster": 4}
    assert chip_smoke.route_counts(chip_smoke.factor_plan(12800, 128, 8)) == {
        "panel_trailing_fused/grid": 41, "panel_trailing_fused/cluster": 46,
        "panel_factor_grid/grid": 5, "panel_factor_cluster/cluster": 8}

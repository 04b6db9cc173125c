"""The port's checksum-carrying solves (``gauss_tpu_torch.resilience.abft``)
against the JAX package's ``resilience/abft.py`` on the CPU: the rider
changes no bit of any factor, an on-device ``sdc_bitflip`` plan flips the
same element and is detected in the same group and column in both
packages, replays give the uninterrupted bits, persistent corruption is
typed and escalates to a verified answer, and the GEMM form corrects or
recomputes. The same seeded float32 inputs go to both packages."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.core import blocked as jb
from gauss_tpu.io import synthetic
from gauss_tpu.resilience import abft as ja
from gauss_tpu.resilience import abftcheck as jcheck
from gauss_tpu.resilience import inject as ji
from gauss_tpu.resilience import recover as jr
from gauss_tpu.structure import cholesky as jchol
from gauss_tpu_torch import obs as tobs
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.resilience import abft as ta
from gauss_tpu_torch.resilience import abftcheck as tcheck
from gauss_tpu_torch.resilience import inject as ti
from gauss_tpu_torch.resilience import recover as tr
from gauss_tpu_torch.structure import cholesky as tchol

CPU = "cpu"
# tests/test_torch_blocked.py's tolerances: factor fields relative to
# max |m| (float32 factorizations in two frameworks).
TOL_FACTOR = 5e-5
GATE = 1e-4
LU_FIELDS = ("m", "perm", "min_abs_pivot", "linv", "uinv")
CHOL_FIELDS = ("m", "linv", "min_diag")


def _dd_system(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    a[np.arange(n), np.arange(n)] += np.float32(n)
    return a, rng.standard_normal(n).astype(np.float32)


def _spd(n):
    return synthetic.spd_matrix(n).astype(np.float32)


def _bits_equal(f0, f1, fields):
    for f in fields:
        assert torch.equal(getattr(f0, f), getattr(f1, f)), f


def _close_to_jax(ft, fj, fields):
    """Port factor against the JAX one: integer fields equal, the others
    within TOL_FACTOR of max |m|."""
    scale = float(np.abs(np.asarray(fj.m)).max())
    for f in fields:
        got, want = getattr(ft, f).numpy(), np.asarray(getattr(fj, f))
        if f == "perm":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=TOL_FACTOR * scale, err_msg=f)


def _run_plan(inj, site, fn, seed, **spec):
    plan = inj.FaultPlan([inj.FaultSpec(site=site, kind="sdc_bitflip",
                                        **spec)], seed=seed)
    with inj.plan(plan) as ap:
        res = fn()
    return res, ap.stats()


# -- the checksum rider changes no bit -------------------------------------

def test_flat_lu_abft_invariant_and_bit_identity():
    a, _ = _dd_system(0, 96)
    f0 = tb.lu_factor_blocked(a, panel=16, device=CPU)
    f1 = tb.lu_factor_blocked(a, panel=16, abft=True, device=CPU)
    assert f0.abft_err is None and f1.abft_err.shape == (7,)
    _bits_equal(f0, f1, LU_FIELDS)
    fj = jb.lu_factor_blocked(jnp.asarray(a), panel=16, abft=True)
    _close_to_jax(f1, fj, ("m", "perm", "linv", "uinv"))
    tol = ta.default_tol(96, np.float32, 96.0)
    assert tol == ja.default_tol(96, np.float32, 96.0)
    assert float(f1.abft_err.max()) < tol
    assert float(np.asarray(fj.abft_err).max()) < tol


def test_chunked_lu_abft_invariant_and_bit_identity():
    a, b = _dd_system(1, 96)
    f0 = tb.lu_factor_blocked_chunked(a, panel=16, chunk=2, device=CPU)
    f1 = tb.lu_factor_blocked_chunked(a, panel=16, chunk=2, abft=True,
                                      device=CPU)
    assert f0.abft_err is None and f1.abft_err.shape == (4,)
    _bits_equal(f0, f1, LU_FIELDS)
    x = tb.lu_solve(f1, b).numpy()
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < GATE


def test_chol_flat_abft_invariant_and_bit_identity():
    a = _spd(96)
    f0 = tchol.cholesky_factor_blocked(a, panel=16, device=CPU)
    f1 = tchol.cholesky_factor_blocked(a, panel=16, abft=True, device=CPU)
    assert f0.abft_err is None
    _bits_equal(f0, f1, CHOL_FIELDS)
    fj = jchol.cholesky_factor_blocked(jnp.asarray(a), panel=16, abft=True)
    assert f1.abft_err.shape == np.asarray(fj.abft_err).shape == (7,)
    assert float(f1.abft_err.max()) < 1e-3
    assert float(np.asarray(fj.abft_err).max()) < 1e-3
    scale = float(np.abs(np.asarray(fj.m)).max())
    lower = np.tril(np.ones((96, 96), bool))
    np.testing.assert_allclose(f1.m.numpy()[lower], np.asarray(fj.m)[lower],
                               rtol=0, atol=TOL_FACTOR * scale)


def test_chol_unrolled_rejects_abft():
    a = _spd(32)
    with pytest.raises(ValueError, match="flat fori form") as ej:
        jchol._factor_impl(a, 16, "highest", unrolled=True, abft=True)
    with pytest.raises(ValueError, match="flat fori form") as et:
        tchol.cholesky_factor_blocked_unrolled(a, panel=16, abft=True,
                                               device=CPU)
    assert str(et.value) == str(ej.value)


def test_host_stepped_runners_match_jitted_forms():
    a, _ = _dd_system(2, 64)
    fac, rep = ta.lu_factor_abft(a, panel=16, chunk=2, device=CPU)
    _bits_equal(fac, tb.lu_factor_blocked_chunked(a, panel=16, chunk=2,
                                                  device=CPU), LU_FIELDS)
    _bits_equal(fac, tb.lu_factor_blocked_chunked(
        a, panel=16, chunk=2, abft=True, device=CPU), LU_FIELDS)
    # panel 64: "auto" would run the fused kernel; the rider pins the pair.
    big, _ = _dd_system(3, 256)
    fb, _ = ta.lu_factor_abft(big, panel=64, chunk=2, device=CPU)
    _bits_equal(fb, tb.lu_factor_blocked_chunked(
        big, panel=64, chunk=2, panel_impl="pallas", device=CPU), LU_FIELDS)
    assert rep.detections == 0 and rep.replays == 0
    fj, rj = ja.lu_factor_abft(a, panel=16, chunk=2)
    _close_to_jax(fac, fj, ("m", "perm", "linv", "uinv"))
    assert rep.groups == rj.groups == 2 and rep.tol == pytest.approx(
        rj.tol, rel=1e-6)
    assert fac.abft_err.shape == np.asarray(fj.abft_err).shape == (3,)
    aspd = _spd(64)
    cfac, crep = ta.cholesky_factor_abft(aspd, panel=16, device=CPU)
    _bits_equal(cfac, tchol.cholesky_factor_blocked(aspd, panel=16,
                                                    device=CPU),
                CHOL_FIELDS)
    assert crep.detections == 0 and crep.groups == 4


# -- the corruption primitive ----------------------------------------------

@pytest.mark.parametrize("bit", [0, 22, 30, 31])
def test_flip_bit_roundtrip(bit):
    a, _ = _dd_system(3, 16)
    m = torch.as_tensor(a.copy())
    assert ta.flip_bit(m, 3, 5, bit) is m  # in place
    assert torch.argwhere(m != torch.as_tensor(a)).tolist() == [[3, 5]]
    np.testing.assert_array_equal(
        m.numpy().view(np.uint32),
        np.asarray(ja.flip_bit(jnp.asarray(a), 3, 5, bit)).view(np.uint32))
    ta.flip_bit(m, 3, 5, bit)
    assert np.array_equal(m.numpy(), a)  # XOR is its own inverse


def test_sdc_bitflip_kind_parses():
    text = "abft.lu.group=sdc_bitflip:skip=1:max=1"
    pt, pj = ti.FaultPlan.parse(text), ji.FaultPlan.parse(text)
    assert pt.specs[0].kind == pj.specs[0].kind == "sdc_bitflip"
    assert pt.specs[0].site == ta.SITE_LU == ja.SITE_LU
    assert (ta.SITE_CHOL, ta.SITE_MATMUL) == (ja.SITE_CHOL, ja.SITE_MATMUL)
    with pytest.raises(ValueError, match="unknown fault kind"):
        ti.FaultSpec(site="x", kind="sdc_flip")


# -- detect -> localize -> replay, in both packages -------------------------

@pytest.mark.parametrize("seed,skip,chunk", [(7, 2, 1), (3, 1, 2)])
def test_lu_detects_localizes_and_replays(seed, skip, chunk):
    a, _ = _dd_system(4, 64)
    clean, _ = ta.lu_factor_abft(a, panel=16, chunk=chunk, device=CPU)
    (fj, rj), sj = _run_plan(ji, ja.SITE_LU, lambda: ja.lu_factor_abft(
        a, panel=16, chunk=chunk), seed, max_triggers=1, skip=skip)
    with tobs.run() as rec:
        (ft, rt), st = _run_plan(ti, ta.SITE_LU, lambda: ta.lu_factor_abft(
            a, panel=16, chunk=chunk, device=CPU), seed, max_triggers=1,
            skip=skip)
    assert st["triggered"] == sj["triggered"] == 1
    assert rt.detections >= 1 and rt.replays >= 1 and not rt.escalated
    assert skip in rt.detect_groups
    # The same element flipped and caught at the same group and column.
    assert (rt.detect_groups, rt.detect_cols, rt.replays) == (
        rj.detect_groups, rj.detect_cols, rj.replays)
    (inj,) = [e for e in rec.events if e["type"] == "sdc_inject"]
    assert inj["group"] == skip and inj["engine"] == "lu"
    _bits_equal(ft, clean, LU_FIELDS)  # bit-identical repair
    _close_to_jax(ft, fj, ("m", "perm", "linv", "uinv"))


def test_lu_last_group_fault_caught_by_final_identity():
    a, _ = _dd_system(5, 64)
    clean, _ = ta.lu_factor_abft(a, panel=16, chunk=1, device=CPU)
    (_, rj), _ = _run_plan(ji, ja.SITE_LU, lambda: ja.lu_factor_abft(
        a, panel=16, chunk=1), 5, max_triggers=1, skip=3)
    (ft, rt), _ = _run_plan(ti, ta.SITE_LU, lambda: ta.lu_factor_abft(
        a, panel=16, chunk=1, device=CPU), 5, max_triggers=1, skip=3)
    assert rt.detections >= 1 and not rt.escalated
    assert 3 in rt.detect_groups
    assert (rt.detect_groups, rt.detect_cols) == (rj.detect_groups,
                                                  rj.detect_cols)
    _bits_equal(ft, clean, LU_FIELDS)


@pytest.mark.parametrize("engine", ["lu", "chol"])
@pytest.mark.parametrize("group", [3, 1])
def test_final_identity_replays_only_the_last_group(monkeypatch, engine,
                                                    group):
    """The runners' final-identity branch: a mismatch that the final
    identity reports once (a stand-in) in a column of the last group is
    replayed once from the held rollback point, to the clean bits; in an
    earlier group, past the carry kept, it escalates."""
    col = group * 16 + 5
    if engine == "lu":
        a, _ = _dd_system(5, 64)
        mod, name, step = tb, "_csum_final_err_lu", "_factor_group"
        run = lambda: ta.lu_factor_abft(a, panel=16, chunk=1, device=CPU)
        fields = LU_FIELDS
    else:
        a = _spd(64)
        mod, name, step = tchol, "_csum_final_err_chol", "_chol_panel_step"
        run = lambda: ta.cholesky_factor_abft(a, panel=16, device=CPU)
        fields = CHOL_FIELDS
    clean, rep = run()
    real_final, real_step = getattr(mod, name), getattr(mod, step)
    calls, steps = [], []

    def mismatch_once(m, crow0):
        err, at = real_final(m, crow0)
        calls.append(col)
        if len(calls) == 1:
            return torch.full_like(err, 1e30), torch.full_like(at, col)
        return err, at

    def counted_step(m, *args, **kw):
        steps.append(args[2] if engine == "lu" else args[1] // 16)
        return real_step(m, *args, **kw)

    monkeypatch.setattr(mod, name, mismatch_once)
    monkeypatch.setattr(mod, step, counted_step)
    if group == 3:
        fac, rep = run()
        assert (rep.detect_groups, rep.detect_cols) == ([3], [col])
        assert rep.replays == 1 and not rep.escalated and len(calls) == 2
        assert steps == [0, 1, 2, 3, 3]
        _bits_equal(fac, clean, fields)
    else:
        with pytest.raises(ta.SDCUnrecoverableError) as ei:
            run()
        assert (ei.value.group, ei.value.col) == (1, col)
        assert ta.last_report().escalated and len(calls) == 1
        assert steps == [0, 1, 2, 3]


def test_lu_persistent_corruption_is_typed():
    a, _ = _dd_system(6, 64)
    errs = []
    for inj, mod, kw in ((ji, ja, {}), (ti, ta, {"device": CPU})):
        with pytest.raises(mod.SDCUnrecoverableError) as ei:
            _run_plan(inj, mod.SITE_LU, lambda: mod.lu_factor_abft(
                a, panel=16, chunk=1, **kw), 3, max_triggers=None, skip=1)
        errs.append(ei.value)
    assert errs[1].group == errs[0].group == 1
    assert errs[1].col == errs[0].col and errs[1].magnitude > 0
    assert ta.last_report().escalated
    assert issubclass(ta.SDCUnrecoverableError, ta.SDCDetectedError)


def test_chol_detects_and_replays():
    a = _spd(64)
    clean, _ = ta.cholesky_factor_abft(a, panel=16, device=CPU)
    (_, rj), _ = _run_plan(ji, ja.SITE_CHOL, lambda: ja.cholesky_factor_abft(
        a, panel=16), 11, max_triggers=1, skip=2)
    (ft, rt), _ = _run_plan(ti, ta.SITE_CHOL, lambda: ta.cholesky_factor_abft(
        a, panel=16, device=CPU), 11, max_triggers=1, skip=2)
    assert rt.detections >= 1 and not rt.escalated
    assert (rt.detect_groups, rt.detect_cols, rt.replays) == (
        rj.detect_groups, rj.detect_cols, rj.replays)
    _bits_equal(ft, clean, CHOL_FIELDS)


def test_chol_not_spd_stays_typed_under_abft():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((32, 32)).astype(np.float32)
    a = (a + a.T) / 2  # indefinite with overwhelming probability
    b = rng.standard_normal(32).astype(np.float32)
    with pytest.raises(jchol.NotSPDError) as ej:
        ja.solve_chol_abft(a, b, panel=16)
    with pytest.raises(tchol.NotSPDError) as et:
        ta.solve_chol_abft(a, b, panel=16, device=CPU)
    assert np.sign(et.value.min_diag) == np.sign(ej.value.min_diag)


# -- the ladder ------------------------------------------------------------

def test_ladders_gain_abft_heads():
    for engine in ("blocked", "rank1"):
        assert tr.default_rungs(engine, abft=True) == jr.default_rungs(
            engine, abft=True) == ("abft",) + tr.default_rungs(engine)
    for tag in ("spd", "banded", "blockdiag", "dense", "sparse"):
        assert tr.structured_rungs(tag, abft=True) == jr.structured_rungs(
            tag, abft=True)
    assert tr.structured_rungs("spd", abft=True)[0] == "abft_chol"
    assert tr.structured_rungs("banded", abft=True) == \
        tr.structured_rungs("banded")


def test_solve_resilient_replay_rung_and_sdc_tag():
    a, b = _dd_system(8, 128)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    res0 = tr.solve_resilient(a64, b64, abft=True, panel=16, device=CPU)
    assert res0.rung == "abft" and not res0.sdc_detected
    assert res0.sdc is not None and res0.sdc["detections"] == 0
    with ti.plan(ti.FaultPlan([ti.FaultSpec(
            site=ta.SITE_LU, kind="sdc_bitflip", max_triggers=1, skip=1)],
            seed=4)):
        res = tr.solve_resilient(a64, b64, abft=True, panel=16, device=CPU)
    with ji.plan(ji.FaultPlan([ji.FaultSpec(
            site=ja.SITE_LU, kind="sdc_bitflip", max_triggers=1, skip=1)],
            seed=4)):
        resj = jr.solve_resilient(a64, b64, abft=True, panel=16)
    assert res.rung == resj.rung == "abft" and res.rung_index == 0
    assert res.sdc_detected and res.sdc["replays"] >= 1
    assert {k: res.sdc[k] for k in ("engine", "groups", "detect_groups",
                                    "detect_cols", "replays")} == {
        k: resj.sdc[k] for k in ("engine", "groups", "detect_groups",
                                 "detect_cols", "replays")}
    # the replay-recovered solve is bit-identical to the uninterrupted one
    assert np.array_equal(res.x, res0.x)
    assert res.rel_residual <= GATE and resj.rel_residual <= GATE


def test_solve_resilient_escalates_past_failed_replay():
    a, b = _dd_system(9, 128)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    out = []
    for inj, rec, site, kw in ((ji, jr, ja.SITE_LU, {}),
                               (ti, tr, ta.SITE_LU, {"device": CPU})):
        with inj.plan(inj.FaultPlan([inj.FaultSpec(
                site=site, kind="sdc_bitflip", max_triggers=None)],
                seed=4)):
            out.append(rec.solve_resilient(a64, b64, abft=True, panel=16,
                                           **kw))
    resj, res = out
    assert res.rung_index > 0 and res.rung == resj.rung
    assert res.escalations[0] == ("abft",
                                  "exception:SDCUnrecoverableError")
    assert [tuple(e) for e in res.escalations] == [
        tuple(e) for e in resj.escalations]
    assert res.sdc_detected and res.sdc["escalated"]  # the failed report
    assert np.linalg.norm(a64 @ res.x - b64) / np.linalg.norm(b64) < GATE


def test_kernel_faults_in_the_abft_rung_are_not_replayed(monkeypatch):
    """A kernel that fails to launch inside the abft rung re-raises out of
    the ladder: it is not taken for SDC, not replayed, not escalated."""
    a, b = _dd_system(10, 64)
    calls = []

    def broken(*args, **kw):
        calls.append(1)
        raise _build.KernelLaunchError("gtt_panel_factor_cluster: "
                                       "injected launch failure")

    monkeypatch.setattr(tb, "_factor_group", broken)
    with pytest.raises(_build.KernelLaunchError):
        tr.solve_resilient(a, b, abft=True, panel=16, device=CPU)
    assert calls == [1]


# -- abft matmul -----------------------------------------------------------

def test_abft_matmul_clean_and_corrected():
    rng = np.random.default_rng(10)
    a = rng.standard_normal((48, 32)).astype(np.float32)
    b = rng.standard_normal((32, 40)).astype(np.float32)
    c0, info0 = ta.abft_matmul(a, b, device=CPU)
    assert info0["detections"] == 0
    np.testing.assert_allclose(c0.numpy(), a.astype(np.float64) @ b,
                               rtol=0, atol=1e-4)
    cj, infoj0 = ja.abft_matmul(a, b)
    assert info0["tol"] == pytest.approx(infoj0["tol"], rel=1e-6)
    (c1, info), st = _run_plan(ti, ta.SITE_MATMUL, lambda: ta.abft_matmul(
        a, b, device=CPU), 9, max_triggers=1)
    (_, infoj), _ = _run_plan(ji, ja.SITE_MATMUL, lambda: ja.abft_matmul(
        a, b), 9, max_triggers=1)
    assert st["triggered"] == 1 and info["detections"] == 1
    assert info["corrected"] or info["recomputed"]
    assert {k: info[k] for k in ("corrected", "recomputed", "row", "col")} \
        == {k: infoj[k] for k in ("corrected", "recomputed", "row", "col")}
    assert float((c1 - c0).abs().max()) <= info["tol"]


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_abft_matmul_recomputes_wide_corruption(monkeypatch, precision):
    """A corrupted row (many bad columns) cannot be corrected in place: it
    is recomputed, under the precision contract ("high" is the bf16x3
    split)."""
    from gauss_tpu_torch.core.matmul import matmul

    rng = np.random.default_rng(11)
    a = rng.standard_normal((40, 24)).astype(np.float32)
    b = rng.standard_normal((24, 36)).astype(np.float32)
    clean, _ = ta.abft_matmul(a, b, precision=precision, device=CPU)
    ref = matmul(torch.as_tensor(a), torch.as_tensor(b), precision)
    assert torch.equal(clean, ref)

    def corrupt_row(site, m, lo, engine, group, **kw):
        for j in range(m.shape[1]):
            ta.flip_bit(m, 5, j, 29)
        return m, True

    monkeypatch.setattr(ta, "_poll_sdc_corrupt", corrupt_row)
    fixed, info = ta.abft_matmul(a, b, precision=precision, device=CPU)
    assert info["detections"] == 1 and info["recomputed"]
    assert not info["corrected"] and torch.equal(fixed, clean)


# -- obs -------------------------------------------------------------------

def test_sdc_summarize_section(tmp_path):
    from gauss_tpu.obs import summarize as jsummarize
    from gauss_tpu_torch.obs import summarize

    a, _ = _dd_system(11, 64)
    stream = tmp_path / "sdc.jsonl"
    with tobs.run(metrics_out=str(stream), tool="test_sdc") as rec:
        _run_plan(ti, ta.SITE_LU, lambda: ta.lu_factor_abft(
            a, panel=16, chunk=1, device=CPU), 2, max_triggers=1, skip=1)
    events = rec.events
    sd = summarize.sdc_summary(events)
    assert sd["detections"]["total"] >= 1
    assert sd["detections"]["by_engine"].get("lu", 0) >= 1
    assert sd["injected"]["total"] >= 1 and sd["max_magnitude"] > 0
    # The JAX package's summarizer reads the port's stream alike.
    assert jsummarize.sdc_summary(tobs.read_events(stream)) == sd
    run_id = events[0]["run"]
    text = summarize.summarize_run(events, run_id)
    assert "sdc (abft checksum detections):" in text
    rs = summarize.resilience_summary(events)
    assert rs["recoveries"]["by_rung"].get("abft_replay", 0) >= 1
    assert any(ev.get("type") == "health" and ev.get("sdc_detected")
               for ev in events)


# -- serve -----------------------------------------------------------------

def test_serve_abft_tags_sdc_detected():
    from gauss_tpu_torch.serve import ServeConfig, SolverServer

    a, b = _dd_system(12, 128)
    cfg = ServeConfig(ladder=(32, 64), panel=16, abft=True,
                      verify_gate=GATE, device=CPU)
    plan = ti.FaultPlan([ti.FaultSpec(
        site=ta.SITE_LU, kind="sdc_bitflip", max_triggers=1, skip=1)],
        seed=2)
    with tobs.run() as rec:
        with ti.plan(plan) as ap:
            with SolverServer(cfg) as srv:
                res = srv.solve(a, b, timeout=180)
    assert ap.stats()["triggered"] == 1
    assert res.ok and res.lane == "handoff" and res.sdc_detected
    (route,) = [e for e in rec.events if e["type"] == "route"]
    assert route["lane"] == "abft" and route["n"] == 128
    (done,) = [e for e in rec.events if e["type"] == "serve_request"
               and e["status"] == "ok"]
    assert done["sdc_detected"] is True
    with SolverServer(ServeConfig(ladder=(32, 64), panel=16,
                                  device=CPU)) as srv:
        res2 = srv.solve(a, b, timeout=180)
    assert res2.ok and not res2.sdc_detected


# -- the campaign runner ---------------------------------------------------

def test_abftcheck_case_runner_invariant():
    cache, jcache = {}, {}
    outcomes = []
    for i in range(8):
        o = tcheck.run_sdc_case(i, 99, GATE, clean_cache=cache, device=CPU)
        outcomes.append(o)
        if i < 4:
            oj = jcheck.run_sdc_case(i, 99, GATE, clean_cache=jcache)
            keys = ("engine", "n", "scenario", "group", "outcome", "rung",
                    "detect_groups", "injected")
            assert {k: o.get(k) for k in keys} == {k: oj.get(k)
                                                   for k in keys}
    summ = tcheck.summarize_sdc_cases(outcomes, 1.0)
    assert summ["missed"] == 0 and summ["violations"] == 0
    assert summ["detect_rate"] == 1.0
    replayed = [o for o in outcomes if o["outcome"] == "replayed"]
    assert replayed and all(o["bit_identical"] for o in replayed)
    assert all(o["localized"] for o in replayed)


def test_abftcheck_cli_smoke(tmp_path, capsys):
    out = tmp_path / "summary.json"
    rc = tcheck.main(["--device", CPU, "--cases", "6", "--seed", "77",
                      "--matmul-cases", "2", "--summary-json", str(out)])
    assert rc == 0
    assert "invariant HOLDS" in capsys.readouterr().out
    summary = json.loads(out.read_text())
    assert summary["kind"] == "abft_campaign" and summary["invariant_ok"]
    assert summary["identity"]["bit_identical"]
    assert set(summary) >= {"seed", "gate", "panel", "sdc", "identity",
                            "matmul", "wall_s"}
    assert tcheck.history_records(summary) and all(
        m.startswith("abft:") for m, _, _ in tcheck.history_records(summary))
    assert tcheck.history_records(summary) == \
        jcheck.history_records(summary)
    from gauss_tpu_torch.obs import regress

    hist = tmp_path / "h.jsonl"
    assert regress.gate(regress.ingest_file(out), str(hist), True) == 0
    assert {r["device"] for r in regress.load_history(hist)} == {CPU}
    assert (tcheck.LU_SIZES, tcheck.CHOL_SIZES, tcheck.SCENARIOS) == (
        jcheck.LU_SIZES, jcheck.CHOL_SIZES, jcheck.SCENARIOS)
    assert tcheck.build_parser().parse_args([]).cases == 110


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ABFT runner launches the "
                    "panel kernel (run `python -m pytest -m cuda "
                    "tests/test_torch_abft.py` or `python3 chip_smoke.py` "
                    "on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_replay_is_bit_identical(cuda_device):
    """On the card: the runner equals the chunked form with the rider and
    the ``"pallas"`` route bit for bit (the panel kernel on every panel),
    and a transient flip in a middle group is replayed to the same bits."""
    a = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (1024, 1024)), dtype=torch.float32, device=cuda_device)
    _build.reset_launches()
    clean, rep = ta.lu_factor_abft(a, panel=128, chunk=2, device=cuda_device)
    assert _build.LAUNCHES["panel_trailing_fused"] == 0
    assert _build.LAUNCHES["panel_factor_cluster"] == 8
    assert rep.detections == 0
    _bits_equal(clean, tb.lu_factor_blocked_chunked(
        a, panel=128, chunk=2, abft=True, device=cuda_device), LU_FIELDS)
    _bits_equal(clean, tb.lu_factor_blocked_chunked(
        a, panel=128, chunk=2, panel_impl="pallas", device=cuda_device),
        LU_FIELDS)
    (fac, rep), _ = _run_plan(ti, ta.SITE_LU, lambda: ta.lu_factor_abft(
        a, panel=128, chunk=2, device=cuda_device), 3, max_triggers=1,
        skip=2)
    assert rep.detect_groups[:1] == [2] and rep.replays == 1
    _bits_equal(fac, clean, LU_FIELDS)

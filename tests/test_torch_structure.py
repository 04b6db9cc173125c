"""The port's structured solvers and router against the JAX package's on
the CPU: the blocked Cholesky's factor fields (flat and unrolled forms),
the band solvers, ``solve_auto``'s routing, serving rung and events, the
mistag demotions, the ``structure.check`` CLI, and chip_smoke.py's
structure phase rehearsed at a small size (its demotion cases giving the
JAX package's rung sequence)."""

import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu import obs as jobs
from gauss_tpu.resilience import inject as jinject
from gauss_tpu.structure import banded as jbanded
from gauss_tpu.structure import check as jcheck
from gauss_tpu.structure import cholesky as jchol
from gauss_tpu.structure import solve_auto as jsolve_auto
from gauss_tpu_torch import obs as tobs
from gauss_tpu_torch.io import synthetic
from gauss_tpu_torch.resilience import inject as tinject
from gauss_tpu_torch.structure import (STRUCTURE_KINDS,
                                       StructureMismatchError, banded,
                                       check, cholesky, solve_auto)

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
GATE = 1e-4
# Cholesky factor fields: within this fraction of each field's largest
# magnitude (float32 sums in another order).
TOL_CHOL = 1e-5
# Band and routed solutions: relative to the solution's norm.
TOL_X = 1e-6


def _rel(x, ref):
    return np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref)


# --- cholesky --------------------------------------------------------------

@pytest.mark.parametrize("unrolled", [False, True])
@pytest.mark.parametrize("n,panel", [(96, 32), (200, 64), (96, 64)])
def test_cholesky_fields_match_the_reference(n, panel, unrolled):
    a = synthetic.spd_matrix(n) + np.diag(np.linspace(0, 1, n))
    if unrolled:
        j = jchol.cholesky_factor_blocked_unrolled(
            jnp.asarray(a, jnp.float32), panel=panel)
        t = cholesky.cholesky_factor_blocked_unrolled(a, panel=panel,
                                                      device=CPU)
    else:
        j = jchol.cholesky_factor_blocked(jnp.asarray(a, jnp.float32),
                                          panel=panel)
        t = cholesky.cholesky_factor_blocked(a, panel=panel, device=CPU)
    jm, tm = np.tril(np.asarray(j.m)), np.tril(t.m.numpy())
    assert tm.shape == jm.shape == (-(-n // panel) * panel,) * 2
    np.testing.assert_allclose(tm, jm, rtol=0,
                               atol=TOL_CHOL * np.abs(jm).max())
    jl, tl = np.asarray(j.linv), t.linv.numpy()
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, rtol=0,
                               atol=TOL_CHOL * np.abs(jl).max())
    assert float(t.min_diag) == pytest.approx(float(j.min_diag),
                                              rel=TOL_CHOL)


def test_resolve_chol_factor_mirrors_the_lu_policy():
    pick = cholesky.resolve_chol_factor
    assert pick(4096, device="cuda") is \
        cholesky.cholesky_factor_blocked_unrolled
    assert pick(8192, device="cuda") is cholesky.cholesky_factor_blocked
    assert pick(64, device=CPU) is cholesky.cholesky_factor_blocked
    assert pick(64, True) is cholesky.cholesky_factor_blocked_unrolled
    with pytest.raises(ValueError):
        pick(64, "sometimes")


@pytest.mark.parametrize("row", [None, 40])
def test_non_spd_is_typed_with_the_same_witness(row):
    """Indefinite in every panel, or only from the second panel on."""
    a = synthetic.spd_matrix(64)
    if row is None:
        a -= 2.0 * np.eye(64)
    else:
        a[row, row] = -50.0
    with pytest.raises(jchol.NotSPDError) as ej:
        jchol.cholesky_factor(jnp.asarray(a, jnp.float32), panel=32)
    with pytest.raises(cholesky.NotSPDError) as et:
        cholesky.cholesky_factor(a, panel=32, device=CPU)
    assert np.sign(et.value.min_diag) == np.sign(ej.value.min_diag)
    assert et.value.min_diag == pytest.approx(ej.value.min_diag, abs=1e-6)
    # The checksum rider leaves the witness as it is.
    f0 = cholesky.cholesky_factor_blocked(a, panel=32, device=CPU)
    f1 = cholesky.cholesky_factor_blocked(a, panel=32, abft=True, device=CPU)
    assert float(f1.min_diag) == float(f0.min_diag) <= 0.0
    assert torch.equal(f1.m, f0.m) and f1.abft_err.shape == (3,)


def test_spd_solves_pass_the_gate():
    a = synthetic.spd_matrix(120)
    rng = np.random.default_rng(3)
    b = rng.standard_normal((120, 3))
    x, fac = cholesky.solve_spd_refined(a, b, device=CPU)
    assert x.shape == (120, 3) and float(fac.min_diag) > 0
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) <= GATE
    assert _rel(x, np.linalg.solve(a, b)) <= TOL_X
    xd, _ = cholesky.solve_spd_ds(a, b[:, 0], iters=3, device=CPU)
    assert np.linalg.norm(a @ xd - b[:, 0]) / np.linalg.norm(b[:, 0]) <= GATE
    xs = cholesky.solve_spd(a, b[:, 0], device=CPU).numpy()
    assert np.linalg.norm(a @ xs - b[:, 0]) / np.linalg.norm(b[:, 0]) <= 1e-5
    xr, _ = jchol.solve_spd_refined(a, b)
    assert _rel(x, xr) <= TOL_X


# --- banded -----------------------------------------------------------------

@pytest.mark.parametrize("bw", [1, 3, 8])
def test_band_solves_match_the_reference(bw):
    n = 240
    a = synthetic.banded_matrix(n, bw).astype(np.float32)
    b = np.random.default_rng(bw).standard_normal((n, 2)).astype(np.float32)
    assert banded.bandwidth_of(a) == jbanded.bandwidth_of(a) == bw
    want = np.asarray(jbanded.solve_banded(a, b))
    assert _rel(banded.solve_banded(a, b, device=CPU).numpy(), want) <= TOL_X
    if bw > 1:
        got = banded.solve_band_blocklu(a, b[:, 0], bw, device=CPU).numpy()
        assert _rel(got, np.asarray(jbanded.solve_band_blocklu(
            a, b[:, 0], bw))) <= TOL_X
    a64 = synthetic.banded_matrix(n, bw)
    got = banded.solve_banded_refined(a64, b[:, 0], device=CPU)
    assert _rel(got, jbanded.solve_banded_refined(a64, b[:, 0])) <= TOL_X


def test_block_diagonals_equal_the_reference():
    a = synthetic.banded_matrix(50, 4)
    got, want = banded._block_diagonals(a, 4), jbanded._block_diagonals(a, 4)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[3] == want[3]


def test_band_mismatches_and_limits_are_typed_alike():
    a = synthetic.banded_matrix(96, 3)
    b = np.ones(96)
    cases = [dict(a=a, bandwidth=1),                     # a lie
             dict(a=synthetic.dense_matrix(32)),         # over the limit
             dict(a=a, max_bandwidth=2),                 # over the cap
             dict(a=np.diag(np.r_[np.ones(10), 0.0]))]   # singular diagonal
    for kw in cases:
        a_, kw = kw.pop("a"), kw
        bb = b[:a_.shape[0]]
        with pytest.raises(type(jbanded.StructureMismatchError("x"))):
            jbanded.solve_banded(a_, bb, **kw)
        with pytest.raises(StructureMismatchError):
            banded.solve_banded(a_, bb, device=CPU, **kw)
    d = np.diag(np.arange(1.0, 9.0))
    np.testing.assert_array_equal(banded.solve_banded(d, np.ones(8)),
                                  jbanded.solve_banded(d, np.ones(8)))
    with pytest.raises(ValueError):
        banded.solve_banded(np.zeros((3, 4)), np.ones(3), device=CPU)


# --- the router -------------------------------------------------------------

def _systems(n):
    return {"spd": synthetic.spd_matrix(n),
            "banded": synthetic.banded_matrix(n, 1),
            "blockdiag": synthetic.blockdiag_matrix(n, 16),
            "dense": synthetic.dense_matrix(n)}


def _events(rec, kind):
    return [{k: v for k, v in e.items() if k not in ("t", "ts", "run",
                                                      "run_id", "trace")}
            for e in rec.events if e["type"] == kind]


@pytest.mark.parametrize("kind", ["spd", "banded", "blockdiag", "dense"])
def test_solve_auto_routes_and_serves_as_the_reference(kind):
    n = 96
    a = _systems(n)[kind]
    b = np.random.default_rng(11).standard_normal(n)
    with jobs.run() as jrec:
        jr = jsolve_auto(a, b)
    with tobs.run() as trec:
        tr = solve_auto(a, b, device=CPU)
    assert (tr.rung, tr.rung_index, tr.escalations) == (
        jr.rung, jr.rung_index, jr.escalations)
    assert tr.rung == {"spd": "cholesky", "banded": "banded",
                       "blockdiag": "blockdiag", "dense": "blocked"}[kind]
    assert _rel(tr.x, jr.x) <= TOL_X
    (js,), (ts,) = _events(jrec, "structure"), _events(trec, "structure")
    assert ts == js
    (jo,), (to,) = (_events(jrec, "structure_solve"),
                    _events(trec, "structure_solve"))
    assert set(to) == set(jo)
    assert to["rel_residual"] <= GATE
    assert {k: v for k, v in to.items() if k != "rel_residual"} == {
        k: v for k, v in jo.items() if k != "rel_residual"}


#: The routed CG's answer against a plain float64 Jacobi-preconditioned CG
#: in numpy run for the same number of iterations (reading 2.1e-16 at
#: n=640; a float32 PCG reads 1.1e-7 and one iteration fewer 1.5e-4).
TOL_PCG = 1e-12


def _jacobi_pcg(a, b, iters):
    """Plain float64 CG with a Jacobi preconditioner, from x = 0."""
    d = np.diag(a)
    x, r = np.zeros_like(b), b.copy()
    z = r / d
    p, rz = z.copy(), r @ z
    for _ in range(iters):
        ap = a @ p
        alpha = rz / (p @ ap)
        x += alpha * p
        r -= alpha * ap
        z = r / d
        rz, rz_old = r @ z, rz
        p = z + (rz / rz_old) * p
    return x


def test_solve_auto_routes_sparse_to_cg():
    """The sparse class: the JAX package routes it alike, and its Krylov
    wrappers fail under JAX 0.9 (``enable_x64`` is gone; ROADMAP queue
    3), so the port's answer is held to a plain float64 PCG of as many
    iterations as the ``cg`` method leg takes on the same system, and to
    float64 LAPACK within the gate the CG stops at."""
    from gauss_tpu_torch.sparse.csr import CsrMatrix
    from gauss_tpu_torch.sparse.solve import solve_sparse
    from gauss_tpu_torch.structure.detect import (detect_structure,
                                                  detect_structure_coords)
    from gauss_tpu.structure.detect import detect_structure as jdetect

    n = 640
    rows, cols, vals = synthetic.sparse_coords(n, 8, seed=258458)
    a = CsrMatrix.from_coords(n, rows, cols, vals).to_dense()
    b = np.random.default_rng(12).standard_normal(n)
    info = detect_structure_coords(n, rows, cols, vals)
    assert info.kind == detect_structure(a).kind == jdetect(a).kind == \
        "sparse"
    with tobs.run() as rec:
        res = solve_auto(a, b, info=info, device=CPU)
    assert res.rung == "cg" and res.rung_index == 0
    (ev,) = _events(rec, "structure_solve")
    assert ev["engine"] == "cg" and not ev["demoted"]
    (sp,) = _events(rec, "sparse_solve")
    leg = solve_sparse(CsrMatrix.from_coords(n, rows, cols, vals), b,
                       method="cg", device=CPU)
    assert sp["method"] == leg.method == "cg"
    assert sp["iterations"] == leg.iterations and sp["converged"]
    assert _rel(res.x, _jacobi_pcg(a, b, leg.iterations)) <= TOL_PCG
    # The CG stops at the 1e-4 gate; LAPACK reads 6.1e-5 from it.
    assert _rel(res.x, np.linalg.solve(a, b)) <= GATE


MISTAGS = [("dense", "spd"), ("spd", "banded"), ("banded", "blockdiag"),
           ("spd", "blockdiag"), ("blockdiag", "banded")]


@pytest.mark.parametrize("true,wrong", MISTAGS)
def test_mistags_demote_to_the_same_rung(true, wrong):
    n = 96
    a = _systems(n)[true]
    b = np.random.default_rng(13).standard_normal(n)
    out = []
    for inj, sa, kw, obs_mod in ((jinject, jsolve_auto, {}, jobs),
                                 (tinject, solve_auto, {"device": CPU},
                                  tobs)):
        plan = inj.FaultPlan([inj.FaultSpec(
            site="structure.detect", kind="mistag",
            param=float(STRUCTURE_KINDS.index(wrong)), max_triggers=1)])
        with obs_mod.run() as rec:
            with inj.plan(plan):
                r = sa(a, b, **kw)
        out.append((r.rung, r.rung_index, r.escalations,
                    [(e["rung"], e["trigger"], e["outcome"])
                     for e in rec.events if e["type"] == "recovery"],
                    [e["demoted"] for e in rec.events
                     if e["type"] == "structure_solve"], r.x))
    (*j, jx), (*t, tx) = out
    assert t == j
    assert _rel(tx, jx) <= TOL_X


def test_trivial_and_malformed_requests_behave_alike():
    for sa, kw in ((jsolve_auto, {}), (solve_auto, {"device": CPU})):
        r0 = sa(np.zeros((0, 0)), np.zeros(0), **kw)
        assert r0.x.shape == (0,) and r0.rung == "empty"
        r1 = sa(np.array([[4.0]]), np.array([2.0]), **kw)
        np.testing.assert_allclose(r1.x, [0.5])
        assert r1.rung == "numpy_f64" and r1.rung_index == 0
        for a, b, extra in ((np.zeros((2, 3)), np.zeros(2), {}),
                            (np.eye(2), np.zeros(3), {}),
                            (np.eye(2), np.zeros(2),
                             {"structure": "wavelet"})):
            with pytest.raises(ValueError):
                sa(a, b, **extra, **kw)


# --- structure.check ----------------------------------------------------------

def _masked(out):
    """The class lines with the timing field masked."""
    lines = [ln for ln in out.splitlines() if ln.startswith(
        "structure-check [")]
    return [" ".join("s_per_solve=*" if f.startswith("s_per_solve=")
                     else f for f in ln.split()) for ln in lines]


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["--spd-n", "48", "--banded-n", "64", "--blockdiag-n", "48", "--block",
     "8", "--dense-n", "48"],
    ["--spd-n", "32", "--banded-n", "128", "--banded-bw", "64",
     "--blockdiag-n", "32", "--block", "8", "--dense-n", "32"]])
def test_check_cli_prints_the_reference_lines(tmp_path, argv):
    argv = argv + ["--repeats", "1"]
    jrc, jout = _run(jcheck.main, argv)
    summary = tmp_path / "s.json"
    trc, tout = _run(check.main, argv + ["--device", "cpu",
                                         "--summary-json", str(summary)])
    assert trc == jrc
    # The residuals are each package's own float64 figures; the rest of
    # every class line is the same text.
    strip = [" ".join(f for f in ln.split() if not f.startswith(
        "rel_residual=")) for ln in _masked(tout)]
    assert strip == [" ".join(f for f in ln.split() if not f.startswith(
        "rel_residual=")) for ln in _masked(jout)]
    data = json.loads(summary.read_text())
    assert data["kind"] == "structured_solve" and data["device"] == "cpu"
    assert data["ok"] == (trc == 0)
    assert set(data["classes"]) == {"spd", "banded", "blockdiag", "dense"}


def test_check_cli_refuses_regress_options(tmp_path):
    """``--history`` / ``--regress-check`` are ported since
    (``obs.regress``): the records enter the history file named, stamped
    with the device, and gate against it. The name is the one the test
    had while both were refused."""
    hist = str(tmp_path / "h.jsonl")
    from gauss_tpu_torch.obs import regress

    for extra in (["--history", hist], ["--regress-check", "--history",
                                        hist]):
        rc, _ = _run(check.main, ["--device", "cpu", "--spd-n", "32",
                                  "--banded-n", "64", "--blockdiag-n", "32",
                                  "--dense-n", "32", "--repeats", "1"]
                     + extra)
        assert rc == 0
    recs = regress.load_history(hist)
    assert recs and {r["device"] for r in recs} == {"cpu"}
    assert {r["metric"] for r in recs} == {
        m for m, _, _ in check.history_records({"classes": {
            k: {"s_per_solve": 1.0, "flops_ratio": 1.0}
            for k in ("spd", "banded", "blockdiag", "dense")}})}


# --- chip_smoke.py phase 8 on the CPU ---------------------------------------

def test_chip_smoke_structure_phase_rehearsal(monkeypatch, tmp_path):
    """Phase 8 at small sizes with the kernels' plain versions: every class
    at rung 0, the demotion cases served as the JAX package serves the
    same cases."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "REPO", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "N", 96)
    monkeypatch.setattr(chip_smoke, "PANEL", 32)
    monkeypatch.setattr(chip_smoke, "STRUCT_SPD", (64, 100))
    monkeypatch.setattr(chip_smoke, "STRUCT_BANDED", ((200, 1), (200, 6)))
    monkeypatch.setattr(chip_smoke, "STRUCT_BLOCKDIAG", ((64, 16),))
    monkeypatch.setattr(chip_smoke, "STRUCT_DEMOTE_N", 96)
    monkeypatch.setattr(chip_smoke, "STRUCT_BATCH_CHECK", ((2, 48, 32),))
    buf = io.StringIO()
    with redirect_stdout(buf):
        path, out = chip_smoke.phase_structure(2)
    assert all(v == 0 for v in path.values())  # no kernel on the CPU
    assert {r["rung_index"] for r in out["classes"].values()} == {0}
    assert all(r["rel_residual"] <= GATE for r in out["classes"].values())
    line = buf.getvalue().splitlines()[-1]
    assert json.loads(line)["structure"]["card"] == "cpu"
    b = np.random.default_rng(0).standard_normal(96)
    systems = {"spd": synthetic.spd_matrix(96, rho=chip_smoke.DEMOTE_RHO),
               "dense": synthetic.dense_matrix(96)}
    for name, system, fault, failed, serving in chip_smoke.DEMOTIONS:
        got = out["demotions"][name]
        assert got["rung"] == serving
        assert [r for r, _ in got["escalations"]] == list(failed)
        if "=" in fault:
            plan = jinject.FaultPlan.parse(fault)
        else:
            plan = jinject.FaultPlan([jinject.FaultSpec(
                site="structure.detect", kind="mistag",
                param=float(STRUCTURE_KINDS.index(fault)), max_triggers=1)])
        with jinject.plan(plan):
            ref = jsolve_auto(systems[system], b)
        assert (got["rung"], got["rung_index"],
                [tuple(e) for e in got["escalations"]]) == (
            ref.rung, ref.rung_index, [tuple(e) for e in ref.escalations])

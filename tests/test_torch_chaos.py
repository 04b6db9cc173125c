"""The port's chaos campaign (``gauss_tpu_torch.resilience.chaos``) against
the JAX package's ``resilience/chaos.py`` on the CPU: the same seeded
cases draw the same engines, sizes, scenarios and corruption kinds and end
the same way (recovered, or typed), every phase keeps the invariant, the
phases not ported are refused typed, and ``chip_smoke.py``'s phase 10 runs
end to end at small sizes."""

import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from gauss_tpu.resilience import chaos as jchaos
from gauss_tpu_torch import obs as tobs
from gauss_tpu_torch.obs import summarize
from gauss_tpu_torch.resilience import chaos as tchaos
from tests.test_torch_fleet import spawning

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
GATE = 1e-4


def test_solver_cases_match_the_reference():
    """The first cases of the solver phase: the same draw and the same
    end (ok / recovered / typed error) in both packages, and the port
    verifies every served answer at the gate."""
    keys = ("engine", "n", "scenario", "kind", "outcome")
    for i in range(8):
        oj = jchaos._solver_case(i, 5, ["blocked", "rank1"], [24, 32], 16,
                                 GATE)
        ot = tchaos._solver_case(i, 5, ["blocked", "rank1"], [24, 32], 16,
                                 GATE, CPU)
        assert {k: ot[k] for k in keys} == {k: oj[k] for k in keys}, i
        assert ot["injected"]["triggered"] == oj["injected"]["triggered"]
        if ot["outcome"] in ("ok", "recovered"):
            assert ot["rel_residual"] <= GATE


def test_chaos_campaign_small_end_to_end(tmp_path, capsys):
    summary_path = tmp_path / "chaos.json"
    metrics_path = tmp_path / "chaos.jsonl"
    rc = tchaos.main(["--device", CPU, "--cases", "12",
                      "--serve-requests", "6", "--sdc-cases", "4",
                      "--seed", "5", "--tmpdir", str(tmp_path),
                      "--no-fleet", "--no-durable",
                      "--summary-json", str(summary_path),
                      "--metrics-out", str(metrics_path)])
    assert rc == 0, capsys.readouterr()
    summary = json.loads(summary_path.read_text())
    assert summary["kind"] == "chaos_campaign" and summary["invariant_ok"]
    assert summary["injected"] >= 12
    assert summary["solver"]["counts"]["silent_wrong"] == 0
    assert summary["solver"]["counts"]["violation"] == 0
    assert summary["checkpoint"]["bit_identical"]
    assert summary["checkpoint"]["killed"]
    assert summary["structure"]["violations"] == 0
    assert summary["sdc"]["detect_rate"] == 1.0
    assert summary["fleet"] == {} and summary["durable"] == {}
    assert set(summary) == {"kind", "seed", "engines", "sizes", "gate",
                            "device", "injected", "injected_by_site",
                            "solver", "serve", "checkpoint", "fleet",
                            "structure", "durable", "sdc", "wall_s",
                            "invariant_ok"}
    # The stream renders a resilience section whose injections reconcile
    # with the campaign's count, and an sdc section.
    events = tobs.read_events(metrics_path)
    rs = summarize.resilience_summary(events)
    assert rs["injections"]["total"] == summary["injected"]
    assert summarize.sdc_summary(events)["detections"]["total"] >= 4
    assert "invariant HOLDS" in capsys.readouterr().out


@pytest.mark.parametrize("argv,needle", [
    ([], "--no-fleet"),
    (["--no-durable"], "--no-fleet"),
    (["--no-durable", "--history"], "--no-fleet"),
    (["--no-fleet", "--no-durable", "--engines", "bogus"], "unknown engine")])
def test_unported_phases_and_options_exit_2(argv, needle, monkeypatch,
                                            tmp_path, capsys):
    """No phase is refused any more: the fleet phase is ported
    (``test_fleet_phase_verdicts_and_bundles``), so a run without
    ``--no-fleet`` runs it (its runner stubbed here, the other phases cut
    to nothing), and ``--no-fleet`` skips it. An unknown engine still
    exits 2."""
    assert not hasattr(tchaos, "UNPORTED_PHASES")
    ran = []
    monkeypatch.setattr(tchaos, "run_fleet_phase", lambda seed, gate, device:
                        ran.append(device) or {"ran": True, "cases": [],
                                               "injected": 0,
                                               "violations": 0})
    monkeypatch.setattr(tchaos, "run_durable_phase",
                        lambda *a, **k: {"ran": True, "cases": [],
                                         "admitted": 0, "crashes": 0,
                                         "violations": 0})
    cut = ["--cases", "0", "--serve-requests", "0", "--no-checkpoint",
           "--no-structure", "--sdc-cases", "0"]
    if "--history" in argv:
        argv = [*argv, str(tmp_path / "h.jsonl")]
    rc = tchaos.main(["--device", CPU, *cut, *argv])
    captured = capsys.readouterr()
    if needle == "unknown engine":
        assert rc == 2 and needle in captured.err
        return
    assert rc == 0 and "invariant HOLDS" in captured.out
    assert [str(d) for d in ran] == ([] if "--no-fleet" in argv else [CPU])


def test_fleet_phase_verdicts_and_bundles(monkeypatch):
    """chaos's fleet phase on the CPU: a worker killed and a worker
    stalled at the same seeded group as the JAX package's phase draws,
    each recovered bit for bit to the clean supervised run, each leaving a
    bundle ``obs.debug --check`` accepts."""
    import numpy as np

    seed = 258458
    rng = np.random.default_rng(np.random.SeedSequence((seed, 0xF1EE7)))
    jchaos._system(rng, 48)
    group = 1 + int(rng.integers(0, 2))
    with spawning():
        out = tchaos.run_fleet_phase(seed, GATE, device=CPU)
    assert out["violations"] == 0 and out["injected"] == 2
    assert [c["kind"] for c in out["cases"]] == ["kill", "stall"]
    for c in out["cases"]:
        assert c["group"] == group
        assert c["outcome"] == "recovered" and c["rung"] == "restart"
        assert c["bit_identical"] and c["postmortem_ok"]
        assert c["rel_residual"] <= GATE
    assert out["cases"][1]["stalls"] == 1


def test_durable_phase_verdicts_equal_the_jax_packages(tmp_path):
    """chaos's durable phase: one in-process kill/resume case per
    ``durablecheck.CASE_KINDS``, the same verdicts and admitted counts as
    the JAX package's phase for the same seed."""
    got = tchaos.run_durable_phase(5, GATE, str(tmp_path / "t"), device=CPU)
    want = jchaos.run_durable_phase(5, GATE, str(tmp_path / "j"))
    keys = ("case", "kind", "outcome")
    assert [{k: c[k] for k in keys} for c in got["cases"]] == [
        {k: c[k] for k in keys} for c in want["cases"]]
    assert got["crashes"] == want["crashes"] == 4
    assert got["violations"] == want["violations"] == 0
    assert got["admitted"] == want["admitted"]


def test_chaos_history_and_regress_gate(tmp_path, capsys):
    hist = tmp_path / "h.jsonl"
    argv = ["--device", CPU, "--cases", "4", "--serve-requests", "0",
            "--sdc-cases", "0", "--no-checkpoint", "--no-structure",
            "--no-fleet", "--no-durable", "--seed", "5", "--history",
            str(hist)]
    assert tchaos.main(argv) == 0
    assert tchaos.main(argv + ["--regress-check"]) == 0
    from gauss_tpu_torch.obs import regress

    recs = regress.load_history(hist)
    assert recs and {r["device"] for r in recs} == {CPU}
    assert "chaos:solver/s_per_case" in {r["metric"] for r in recs}
    capsys.readouterr()


def test_chaos_history_records_shape():
    summ = {"solver": {"mean_rung": 2.1, "typed_error_rate": 0.08,
                       "cases": 100}, "wall_s": 10.0}
    assert tchaos.history_records(summ) == jchaos.history_records(summ)
    assert ("chaos:solver/s_per_case", 0.1, "s") in \
        tchaos.history_records(summ)
    assert tchaos.history_records({"solver": {}, "wall_s": None}) == []
    assert (tchaos.SCENARIOS, tchaos.CORRUPT_KINDS, tchaos.ENGINE_SITES) \
        == (jchaos.SCENARIOS, jchaos.CORRUPT_KINDS, jchaos.ENGINE_SITES)


def test_structure_phase_matches_the_reference():
    """Every class x every wrong tag ends the same way (served at once,
    demoted, or typed) in both packages. A ``sparse`` tag is the
    exception: the JAX package's Krylov wrappers are red under JAX 0.9
    (ROADMAP queue 3), so its ladder demotes past them where the port's
    Krylov rung serves; the port must still verify."""
    jt = jchaos.run_structure_phase(5, GATE)
    tt = tchaos.run_structure_phase(5, GATE, device=CPU)
    assert tt["violations"] == 0 and tt["injected"] == jt["injected"]
    assert [(c["true"], c["forced"]) for c in tt["cases"]] == [
        (c["true"], c["forced"]) for c in jt["cases"]]
    for ct, cj in zip(tt["cases"], jt["cases"]):
        if ct["forced"] == "sparse":
            assert ct["outcome"] in ("ok", "demoted")
            assert ct["rel_residual"] <= GATE
        else:
            assert (ct["outcome"], ct.get("engine")) == (
                cj["outcome"], cj.get("engine")), ct


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def test_chip_smoke_resilience_phase_rehearsal(monkeypatch, tmp_path):
    """Phase 10 end to end at small sizes on the CPU: the ABFT LU (every
    panel launch held against the plain version, the three flips, the
    escalation, the internal system), the checkpointed factor with its
    killed child, the Cholesky and matmul forms, and the campaigns
    (launches 0 == the plan's 0 on the CPU)."""
    cs = _chip_smoke()
    for name, value in (
            ("DEVICE", CPU), ("REPO", str(REPO)), ("RES_LU", (512, 64, 2)),
            ("RES_FLIP_GROUP", 1), ("RES_PERSIST_GROUP", 1),
            ("RES_KILL_SKIP", 1), ("RES_CHOL", (128,)), ("RES_MM", 64),
            ("SERVE_LADDER", (32, 64)), ("RES_SERVE_N", 600),
            ("RES_SERVE_REQUESTS", 1),
            ("RES_ABFTCHECK_ARGS", ("--cases", "4", "--matmul-cases", "2")),
            ("RES_CHAOS_ARGS", ("--cases", "6", "--serve-requests", "4",
                                "--sdc-cases", "2"))):
        monkeypatch.setattr(cs, name, value)
    buf = io.StringIO()
    with redirect_stdout(buf):
        launches, out = cs.phase_resilience(2)
    assert not any(launches.values()) and out["launches"] == {}
    lu = out["lu"]
    # 8 panels of 64 (4 groups of 2): every one on the panel kernel's
    # route (the plain version on the CPU), each checked.
    assert lu["checked_launches"] == {"panel": 8, "panel strided": 8}
    assert lu["max_group_err_over_tol"] < 1.0 and lu["final_err_over_tol"] < 1
    assert lu["transient"]["group"] == 1 and lu["transient"]["col"] >= 256
    assert lu["last_group"]["group"] == 3
    # A U flip only the final identity reads: replayed in the last group,
    # escalated in group 0.
    assert lu["last_group"]["final_identity"]["col"] == 3 * 128 + 1
    assert lu["last_group"]["final_identity"]["replays"] == 1
    assert lu["last_group"]["factored_flip"]["escalated"]
    assert lu["persistent"]["group"] == 1
    assert lu["persistent"]["rel_residual"] <= GATE
    assert out["checkpoint"]["kill"]["next_group"] == 2
    assert len(out["checkpoint"]["saves_s_bytes"]) == 3
    assert [c["n"] for c in out["cholesky"]] == [128]
    assert set(out["matmul"]) == {"highest", "high"}
    assert all(r["flips"][-1]["corrected"] for r in out["matmul"].values())
    camp = out["campaigns"]
    assert camp["abftcheck"]["rc"] == camp["chaos"]["rc"] == 0
    assert camp["serve"]["sdc_detected"] == [False, True]
    # Kernel 1 checked at the campaigns' sizes (panel 16) and the
    # service's; the campaigns' calls kept by shape and held.
    assert list(camp["checked_launches"]) == [
        "n=24, panel 16", "n=32, panel 16", "n=48, panel 16",
        "n=96, panel 16", "n=128, panel 16", "n=600, panel 128"]
    assert camp["checked_launches"]["n=128, panel 16"] == {
        "panel": 8, "panel strided": 8}
    assert camp["held"]["panel"]["calls"] > camp["held"]["panel"]["shapes"]
    text = buf.getvalue()
    assert '{"resilience": ' in text and "phase 10 (e)" in text
    # The plan of the card's cell: 32 panel launches, 19 on the grid route
    # and 13 on the cluster route, each replayed group's four again.
    monkeypatch.setattr(cs, "DEVICE", "cuda")
    assert cs.launch_counts(cs.abft_plan(8192, 256, 4)) == {
        "panel_factor_grid": 19, "panel_factor_cluster": 13}
    assert cs.launch_counts(cs.abft_plan(8192, 256, 4, (3, 7))) == {
        "panel_factor_grid": 23, "panel_factor_cluster": 17}
    # A persistent flip in group 2: groups 0-2, then group 2 twice more.
    assert cs.launch_counts(cs.abft_plan(8192, 256, 4, (2, 2), 3)) == {
        "panel_factor_grid": 20}
    # The checkpointed form: kernel 2 by phase-A route, kernel 1 by key.
    assert cs.launch_counts(cs.factor_plan(8192, 256, 4)) == {
        "panel_trailing_fused/grid": 15, "panel_trailing_fused/cluster": 9,
        "panel_factor_grid": 4, "panel_factor_cluster": 4}

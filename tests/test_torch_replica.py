"""The port's kill-the-replica campaign (``gauss_tpu_torch.serve
.replicacheck``) on the CPU, against the JAX package's: every in-process
failover case kind gives the same verdict for the same seed in both
packages, the journal-union audit reads the same journals alike, the
history records are equal, the scaling leg's gate, and the campaign CLI
with its history and regress gate. Outcomes and counts are compared
equal."""

import json
import os
import time

import pytest

from gauss_tpu.serve import replicacheck as jcheck
from gauss_tpu.serve.cache import ExecutableCache as JExecutableCache
from gauss_tpu_torch.serve import replicacheck
from gauss_tpu_torch.serve.cache import ExecutableCache
from tests.test_torch_fleet import timing

CPU = "cpu"
GATE = 1e-4
SEED = 190733


@pytest.fixture(scope="module")
def caches():
    return ExecutableCache(64, device=CPU), JExecutableCache(64)


@pytest.mark.parametrize("kind", replicacheck.CASE_KINDS)
def test_failover_case_verdicts_equal_the_jax_packages(kind, caches,
                                                       tmp_path):
    i = replicacheck.CASE_KINDS.index(kind)
    got = replicacheck.run_failover_case(i, SEED, GATE, str(tmp_path / "t"),
                                         kind, cache=caches[0], device=CPU)
    want = jcheck.run_failover_case(i, SEED, GATE, str(tmp_path / "j"),
                                    kind, cache=caches[1])
    assert got["outcome"] == want["outcome"] == "ok", (got, want)
    if kind == "router_restart":
        assert (got["moved"], got["torn_lost"]) == (want["moved"],
                                                    want["torn_lost"])
        return
    assert got["audit"]["admitted"] == want["audit"]["admitted"]
    assert got["audit"]["missing"] == got["audit"]["duplicates"] == []
    assert got["storm_fresh_solves"] == want["storm_fresh_solves"] == 0
    if kind == "drain":
        assert got["adopt"]["replayed"] == want["adopt"]["replayed"] == 0
    if kind == "expired":
        assert (got["audit"]["statuses"].get("expired")
                == want["audit"]["statuses"].get("expired"))


def test_audit_union_reads_journals_as_the_jax_package(caches, tmp_path):
    out = replicacheck.run_failover_case(0, 7, GATE, str(tmp_path), "torn",
                                         cache=caches[0], device=CPU)
    case = tmp_path / "case-torn-000"
    dirs = [str(case / "victim"), str(case / "survivor")]
    ledger = [(f"r7-0-{j}", 0) for j in range(out["audit"]["admitted"])]
    ledger.append(("never-admitted", 0))
    got = replicacheck.audit_union(dirs, ledger, GATE)
    assert got == jcheck.audit_union(dirs, ledger, GATE)
    assert got["missing"] == ["never-admitted"] and got["torn_dropped"] >= 1


def test_history_records_equal_the_jax_packages():
    summ = {"tput": {"replicas_3": {"s_per_request": 0.04}},
            "legs": [{"leg": "kill3", "recovery_s": [2.0, 3.0, 4.5]},
                     {"leg": "stall", "recovery_s": 9.0}]}
    assert replicacheck.history_records(summ) == jcheck.history_records(summ)
    assert replicacheck.history_records({}) == []


def test_scaling_gate_holds_the_injected_legs(monkeypatch, tmp_path):
    """The gate holds the injected-delay legs to ``min_speedup``: a fleet
    that does not scale fails it, one that does passes, and every
    replica's dispatch is delayed by ``TPUT_DELAY_S`` while the legs run
    (the variable is restored after)."""
    from gauss_tpu_torch.resilience import inject

    seen = []

    class FakeRouter:
        url = "http://x"

        def __init__(self, cfg):
            assert cfg.device == CPU
            self.replicas = cfg.replicas

        def __enter__(self):
            seen.append(os.environ.get(inject.ENV_VAR))
            FakeRouter.current = self
            return self

        def __exit__(self, *exc):
            pass

        def stop(self, drain=True):
            pass

    def fake_load(client, mats, rids, deadline_s=120.0, scale=1):
        # 1 replica or 3 take the same time (no speedup), or 3 take a
        # third of it (``scale``)
        time.sleep(0.06 / (scale if FakeRouter.current.replicas == 3
                           else 1))
        return {r: type("R", (), {"ok": True})() for r in rids}

    import gauss_tpu_torch.serve.router as rmod
    monkeypatch.setattr(rmod, "Router", FakeRouter)
    monkeypatch.delenv(inject.ENV_VAR, raising=False)
    monkeypatch.setattr(replicacheck, "_net_load", fake_load)
    with timing():  # no supervised worker processes beside the legs
        out = replicacheck.run_tput_phase(1, str(tmp_path), 2.0, device=CPU)
        assert not out["ok"]
        assert out["delay_s"] == replicacheck.TPUT_DELAY_S
        monkeypatch.setattr(replicacheck, "_net_load",
                            lambda *a, **k: fake_load(*a, **k, scale=3))
        out = replicacheck.run_tput_phase(1, str(tmp_path), 2.0, device=CPU)
    assert out["ok"] and out["speedup"] >= 2.0
    assert len(seen) == 4 and all(
        f"param={replicacheck.TPUT_DELAY_S}" in v for v in seen)
    assert inject.ENV_VAR not in os.environ


def test_campaign_cli_in_process_with_history_and_gate(tmp_path, capsys):
    summary, hist = tmp_path / "r.json", tmp_path / "h.jsonl"
    rc = replicacheck.main(["--device", CPU, "--cases", "6",
                            "--no-subprocess", "--no-tput",
                            "--summary-json", str(summary),
                            "--history", str(hist), "--regress-check"])
    assert rc == 0
    doc = json.loads(summary.read_text())
    assert doc["kind"] == "replica_campaign" and doc["invariant_ok"]
    assert doc["device"] == CPU and doc["in_process_cases"] == 6
    assert (doc["lost"], doc["duplicate_terminals"], doc["duplicate_solves"],
            doc["unverified"]) == (0, 0, 0, 0)
    assert "invariant HOLDS" in capsys.readouterr().out

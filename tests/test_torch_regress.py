"""The port's regression sentinel (``gauss_tpu_torch.obs.regress``) on the
CPU, against the JAX package's: the same records from the same campaign
summaries, the same verdicts on a read-only copy of the JAX package's
committed history, the device stamp that keeps a card figure away from a
CPU or TPU baseline, the port's own history file, the planes not ported
refused by name, and the ``--history`` / ``--regress-check`` tails of the
check CLIs. Records and verdicts are compared equal."""

import json
import shutil
from pathlib import Path

import pytest

from gauss_tpu.obs import regress as jregress
from gauss_tpu_torch.obs import regress

REPO = Path(__file__).resolve().parents[1]
JAX_HISTORY = REPO / "reports" / "history.jsonl"

#: One summary per ported plane, shaped as each campaign writes it.
SUMMARIES = {
    "chaos_campaign": {"kind": "chaos_campaign", "solver": {
        "mean_rung": 1.4, "typed_error_rate": 0.05, "cases": 40,
        "wall_s": 8.0}, "wall_s": 9.5},
    "abft_campaign": {"kind": "abft_campaign", "sdc": {
        "wall_s": 11.0, "cases": 110, "mean_detect_latency_s": 0.02,
        "escalated": 3}, "identity": {"plain_s_per_solve": 0.004,
                                      "overhead_ratio": 1.3}},
    "structured_solve": {"kind": "structured_solve", "classes": {
        "spd": {"s_per_solve": 0.01, "flops_ratio": 0.5},
        "banded": {"s_per_solve": 0.002, "flops_ratio": 0.001}}},
    "sparse_solve": {"kind": "sparse_solve", "methods": {
        "cg": {"s_per_solve": 0.03, "iterations": 12},
        "gmres": {"s_per_solve": 0.05, "iterations": 20}},
        "giant": {"s_per_solve": 2.5, "peak_rss_bytes": 2.0e9}},
    "outofcore_bench": {"kind": "outofcore_bench", "smoke": {
        "s_per_solve": 0.8, "stall_fraction": 0.25,
        "peak_device_frac": 0.3}, "giant": {"n": 32768,
                                            "s_per_solve": 9.0}},
    "durable_campaign": {"kind": "durable_campaign", "wall_s": 30.0,
                         "cases": 31, "overhead": {
                             "on": {"s_per_request": 0.02}}},
    "replica_campaign": {"kind": "replica_campaign", "tput": {
        "replicas_3": {"s_per_request": 0.05}}, "legs": [
        {"leg": "kill3", "recovery_s": [3.0, 4.0, 5.0]},
        {"leg": "drain_free", "recovery_s": 2.0}]},
    "poison_campaign": {"kind": "poison_campaign", "wall_s": 40.0,
                        "cases": 31},
    "flight_check": {"kind": "flight_check", "overhead": {
        "on": {"s_per_request": 0.004}}, "kill": {"wall_s": 12.5}},
    "serve_loadgen": {"kind": "serve_loadgen", "mode": "closed",
                      "throughput_rps": 4.0, "latency_s": {
                          "p50": 0.5, "p99": 1.5, "mean": 0.6}},
}


def _strip_device(records):
    return [{k: v for k, v in r.items() if k != "device"} for r in records]


@pytest.mark.parametrize("kind", sorted(SUMMARIES))
def test_ingest_gives_the_jax_packages_records(kind, tmp_path):
    """The same summary ingests to the same records in both packages
    (equal), the port's each stamped with the summary's device."""
    doc = dict(SUMMARIES[kind], device="cpu")
    path = tmp_path / f"{kind}.json"
    path.write_text(json.dumps(doc))
    got = regress.ingest_file(path)
    want = jregress.ingest_file(path)
    assert got and _strip_device(got) == want
    assert {r["device"] for r in got} == {"cpu"}


def _committed_history(tmp_path):
    """A read-only copy of the JAX package's committed history."""
    copy = tmp_path / "history.jsonl"
    shutil.copyfile(JAX_HISTORY, copy)
    copy.chmod(0o444)
    return copy


@pytest.mark.parametrize("factor", [0.5, 1.0, 1.1, 1.3, 1.6, 3.0])
def test_verdicts_equal_the_jax_packages_on_its_history(factor, tmp_path):
    """Each metric of the committed history, scaled by ``factor`` from its
    median, gets the same verdict from both packages (records with no
    device: the JAX package's own)."""
    hist = regress.load_history(_committed_history(tmp_path))
    assert hist == jregress.load_history(JAX_HISTORY)
    metrics = sorted({r["metric"] for r in hist})
    records = []
    for m in metrics:
        vals = [r["value"] for r in hist if r["metric"] == m]
        records.append({"metric": m, "value": factor * sorted(vals)[
            len(vals) // 2], "source": "t", "kind": "t"})
    got = regress.check_records(records, hist)
    want = jregress.check_records(records, hist)
    assert got == want
    assert {v["status"] for v in got} - {"no-baseline"}
    assert regress.format_verdicts(got) == jregress.format_verdicts(want)


def test_a_card_record_never_meets_a_cpu_or_tpu_baseline(tmp_path):
    hist = regress.load_history(_committed_history(tmp_path))
    metric = max({r["metric"] for r in hist},
                 key=lambda m: sum(r["metric"] == m for r in hist))
    card = {"metric": metric, "value": 1.0, "source": "t", "kind": "t",
            "device": "cuda:NVIDIA H100 80GB HBM3"}
    (v,) = regress.check_records([card], hist)
    assert v["status"] == "no-baseline" and v["samples"] == 0
    # Three epochs of the card: the baseline is theirs alone.
    epochs = [dict(card, value=x) for x in (2.0, 2.1, 2.2)]
    (v,) = regress.check_records([dict(card, value=2.15)], hist + epochs)
    assert v["samples"] == 3 and v["baseline"] == 2.1
    assert v["device"] == card["device"] and v["status"] == "ok"
    (v,) = regress.check_records([dict(card, value=9.0)], hist + epochs)
    assert v["status"] == "out-of-band"


def test_device_tag_and_the_ports_own_history_file():
    assert regress.device_tag("cpu") == "cpu"
    assert regress.device_tag(None) is None
    assert regress.device_tag("cuda").startswith("cuda")
    path = Path(regress.default_history_path())
    assert path != Path(jregress.default_history_path())
    assert path.name == "history_torch.jsonl"
    assert path.parent == JAX_HISTORY.parent


#: kinds whose planes were refused here and are ported since: a summary of
#: one is ingested through its plane's history_records
PORTED_SINCE = {"fleet_solve": {"rung_index": 1, "resume_latency_s": 2.5,
                                "restarts": 1, "wall_s": 9.0},
                "slo_report": {"violation_rate": 0.25, "worst_burn_rate": 3.0,
                               "alerts": 2}}


@pytest.mark.parametrize("kind", sorted(set(regress.PENDING_PLANES)
                                        | set(PORTED_SINCE)))
def test_planes_not_ported_are_refused_by_name(kind, tmp_path, capsys):
    """Kinds of planes not ported are refused by name; ``fleet_solve`` and
    ``slo_report``, ported since, are ingested with the JAX package's
    metrics, stamped with the summary's device."""
    path = tmp_path / "s.json"
    if kind in PORTED_SINCE:
        doc = dict(PORTED_SINCE[kind], kind=kind, device="cpu")
        path.write_text(json.dumps(doc))
        recs = regress.ingest_file(path)
        want = jregress.ingest_file(path)
        assert [(r["metric"], r["value"], r["unit"], r["kind"])
                for r in recs] == [(r["metric"], r["value"], r["unit"],
                                    r["kind"]) for r in want]
        assert recs and all(r["device"] == "cpu" for r in recs)
        assert kind not in regress.PENDING_PLANES
        return
    path.write_text(json.dumps({"kind": kind}))
    with pytest.raises(regress.PlaneNotPortedError, match="queue-1 item"):
        regress.ingest_file(path)
    assert regress.main(["check", str(path), "--history",
                         str(tmp_path / "h.jsonl")]) == 2
    assert regress.PENDING_PLANES[kind] in capsys.readouterr().err


def test_cli_ingest_check_report_and_the_gate(tmp_path, capsys):
    hist = tmp_path / "h.jsonl"
    path = tmp_path / "flight.json"
    doc = dict(SUMMARIES["flight_check"], device="cpu")
    path.write_text(json.dumps(doc))
    assert regress.main(["ingest", str(path), "--history", str(hist)]) == 0
    assert regress.main(["ingest", str(path), "--history", str(hist)]) == 0
    assert len(regress.load_history(hist)) == 2  # deduped on re-ingest
    assert regress.main(["check", str(path), "--history", str(hist),
                         "--min-samples", "1"]) == 0
    out = capsys.readouterr().out
    assert "on cpu" in out and "0 out of band" in out
    for v in (0.0041, 0.0043):
        doc["overhead"]["on"]["s_per_request"] = v
        doc["kill"]["wall_s"] = 12.4
        path.write_text(json.dumps(doc))
        assert regress.main(["check", str(path), "--history", str(hist),
                             "--update"]) == 0
    doc["overhead"]["on"]["s_per_request"] = 0.05
    path.write_text(json.dumps(doc))
    assert regress.main(["check", str(path), "--history", str(hist)]) == 1
    assert regress.main(["report", "--history", str(hist)]) == 0
    assert "flight:ring_s_per_request" in capsys.readouterr().out
    # The CLIs' shared tail: a run whose invariant failed never enters
    # the baseline; a green one appends.
    recs = regress.ingest_file(path)
    assert regress.gate(recs, str(tmp_path / "g.jsonl"), False,
                        healthy=False) == 0
    assert not (tmp_path / "g.jsonl").exists()
    assert regress.gate(recs, str(tmp_path / "g.jsonl"), True) == 0
    assert len(regress.load_history(tmp_path / "g.jsonl")) == len(recs)


def test_gate_default_history_is_the_ports_file(tmp_path, monkeypatch):
    """``--history`` with no path appends to the port's default file and
    never to the JAX package's committed history."""
    before = JAX_HISTORY.read_bytes()
    target = tmp_path / "reports" / "history_torch.jsonl"
    monkeypatch.setattr(regress, "default_history_path", lambda: str(target))
    recs = regress.campaign_records([("poison:s_per_case", 1.5, "s")],
                                    "poisoncheck", "poison", "cpu")
    assert regress.gate(recs, "", False) == 0
    assert regress.load_history(target) == recs
    assert JAX_HISTORY.read_bytes() == before

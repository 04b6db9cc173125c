"""The port's replica router (``gauss_tpu_torch.serve.router``) and the
exit-cause helpers it needs (``gauss_tpu_torch.resilience.fleet``) on the
CPU, against the JAX package's: the same ring lookups for the same nodes
and keys with dead replicas skipped, an assign log written by either
package replayed in the other (torn tail included), the cause vocabulary;
and the router end to end on the CPU: two ``--device cpu`` replicas, one
SIGKILLed mid-load, every request answered ``ok`` exactly once, the dead
replica's journal adopted and its bundle passing ``debug --check``; a
replica that finds no card without ``--device cpu`` fails at startup.
Every comparison is equal."""

import glob
import json
import os
import threading

import numpy as np
import pytest
import torch

from gauss_tpu.resilience import fleet as jfleet
from gauss_tpu.serve import router as jrouter
from gauss_tpu_torch import obs as tobs
from gauss_tpu_torch.obs import debug, postmortem
from gauss_tpu_torch.resilience import fleet
from gauss_tpu_torch.resilience.inject import KILL_EXIT_CODE
from gauss_tpu_torch.serve import STATUS_OK, net, replicacheck
from gauss_tpu_torch.serve import cli as serve_cli
from gauss_tpu_torch.serve import router

CPU = "cpu"
NODES = ["r0", "r1", "r2"]
KEYS = [f"key-{i}" for i in range(300)] + ["r0", "r1", "r2", "", "é"]


@pytest.mark.parametrize("live", [None, {"r0", "r1", "r2"}, {"r0", "r2"},
                                  {"r1"}, set()])
def test_hash_ring_lookups_equal_the_jax_packages(live):
    ring, jring = router.HashRing(NODES), jrouter.HashRing(NODES)
    got = [ring.lookup(k, live) for k in KEYS]
    assert got == [jring.lookup(k, live) for k in KEYS]
    if live:
        assert set(got) <= live and len(set(got)) == len(live)
    elif live is not None:
        assert set(got) == {None}


@pytest.mark.parametrize("writer,reader", [(router, jrouter),
                                           (jrouter, router)])
def test_assign_log_replays_across_packages(writer, reader, tmp_path):
    path = str(tmp_path / "assign.log")
    log = writer.AssignLog(path)
    ring = router.HashRing(NODES)
    for j in range(20):
        log.assign(f"rid{j}", ring.lookup(f"rid{j}"))
    moved = log.failover("r1", "r2")
    log.assign("late", "r0")
    pins = log.pins()
    log.close()
    assert moved == sum(ring.lookup(f"rid{j}") == "r1" for j in range(20))
    again = reader.AssignLog(path)
    assert again.pins() == pins
    again.close()
    raw = open(path, "rb").read()
    for cut in range(1, 30):
        with open(path, "wb") as f:
            f.write(raw[:-cut])
        a, b = router.AssignLog(path), jrouter.AssignLog(path)
        assert a.pins() == b.pins()
        a.close()
        b.close()


def test_exit_causes_and_the_restart_budget_equal_the_jax_packages():
    for rc in (0, KILL_EXIT_CODE, 116, 117, 115, 1, -9, None):
        assert fleet.exit_cause(rc) == jfleet.exit_cause(rc)
    for cause in ("clean", "killed", "drained", "peer_lost", "config",
                  "crashed", "stalled", "quarantined"):
        assert (fleet.counts_against_restart_budget(cause)
                == jfleet.counts_against_restart_budget(cause))
    assert (fleet.DRAIN_EXIT, fleet.PEER_LOST_EXIT, fleet.CONFIG_EXIT) == (
        jfleet.DRAIN_EXIT, jfleet.PEER_LOST_EXIT, jfleet.CONFIG_EXIT)
    assert net.DRAIN_EXIT is fleet.DRAIN_EXIT


def test_router_config_is_the_jax_packages_plus_device():
    import dataclasses

    ours = {f.name: f.default for f in dataclasses.fields(router.RouterConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(jrouter.RouterConfig)}
    assert ours.pop("device") == "cuda" and ours.pop("structure_aware") is False
    assert ours == theirs


def _systems(n_req, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_req):
        n = 8 + int(rng.integers(0, 17))
        a = rng.standard_normal((n, n))
        a[np.arange(n), np.arange(n)] += float(n)
        out.append((a, rng.standard_normal(n)))
    return out


@pytest.mark.parametrize("survivor_age_s,adopter", [(0.5, "r1"),
                                                    (60.0, None)])
def test_failover_passes_over_a_survivor_with_a_stale_heartbeat(
        tmp_path, monkeypatch, survivor_age_s, adopter):
    """A dead replica's journal is posted to a survivor whose heartbeat is
    fresh, and never to one whose heartbeat is already past
    ``stall_after_s`` (a wedged or stopped replica would hold the watch
    loop for the whole adopt timeout): the failover then has no adopter
    and the stale survivor is left to its own stall check."""
    import time

    cfg = router.RouterConfig(dir=str(tmp_path), replicas=2, device=CPU,
                              stall_after_s=2.5, max_restarts=0)
    r = router.Router(cfg)
    procs = {}
    for name in ("r0", "r1"):
        rdir = tmp_path / name
        (rdir / "journal").mkdir(parents=True)
        rp = router.ReplicaProc(name, str(rdir), None, open(
            rdir / "child.log", "ab"))
        rp.t_spawn = time.time() - 100.0
        rp.url = f"http://{name}"
        procs[name] = rp
    hb = tmp_path / "r1" / "heartbeat.json"
    hb.write_text("{}")
    t = time.time() - survivor_age_s
    os.utime(hb, (t, t))
    posted = []
    monkeypatch.setattr(r, "_post_adopt", lambda rp, retired: posted.append(
        rp.name) or {"replayed": 0})
    r.alog = router.AssignLog(str(tmp_path / "assign.log"))
    r._live = dict(procs)
    with tobs.run() as rec:
        r._on_death("r0", procs["r0"], "stalled")
    (fail,) = [e for e in rec.events if e["type"] == "replica_failover"]
    assert fail["adopter"] == adopter
    assert posted == ([adopter] if adopter else [])
    assert "r1" in r._live and r.degraded
    r.alog.close()


def test_router_end_to_end_with_a_sigkilled_replica(tmp_path):
    """Two CPU replicas behind the router under concurrent load; r1 is
    SIGKILLed mid-load: every request ``ok`` once, the journal union
    audited, ``journal-failed-1`` adopted, the bundle checks, the respawn
    serves and every key resubmitted returns its journaled terminal."""
    root = str(tmp_path / "fleet")
    cfg = router.RouterConfig(replicas=2, dir=root, ladder=(32,),
                              max_batch=4, verify_gate=1e-4, poll_s=0.1,
                              device=CPU)
    mats = _systems(16)
    rids = [f"e2e-{j}" for j in range(len(mats))]
    with router.Router(cfg) as rt:
        client = net.SolveClient(rt.url, timeout_s=120.0, wait_s=5.0,
                                 seed=3)
        results = {}
        load = threading.Thread(target=lambda: results.update(
            replicacheck._net_load(client, mats, rids)))
        load.start()
        pid = rt.kill_replica("r1")
        replicacheck._wait_respawn(rt, "r1", pid, timeout_s=120)
        load.join(timeout=240)
        storm = replicacheck._net_load(client, mats, rids)
        stats = rt.stats()
        jdirs = replicacheck._journal_dirs(rt)
    assert all(results[r].status == STATUS_OK for r in rids)
    assert all(storm[r].status == STATUS_OK for r in rids)
    ledger = [(rid, m[0].shape[0]) for rid, m in zip(rids, mats)]
    audit = replicacheck.audit_union(jdirs, ledger, 1e-4)
    assert not (audit["missing"] or audit["duplicates"] or audit["incorrect"])
    assert stats["failovers"] == 1 and stats["restarts_used"] == 1
    assert os.path.isdir(os.path.join(root, "r1", "journal-failed-1"))
    bundle = postmortem.latest_bundle(postmortem.default_bundles_dir(
        os.path.join(root, "r1", "flight")))
    assert postmortem.read_bundle(bundle)["cause"] == "supervisor_death"
    assert debug.main([bundle, "--check"]) == 0
    assert glob.glob(os.path.join(root, "r0", "flight", "flight.*.ring"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_a_replica_without_a_card_fails_at_startup(tmp_path):
    """No CPU fallback: a replica asked for the card on a machine with
    none exits during startup, and the router's start raises."""
    cfg = router.RouterConfig(replicas=1, dir=str(tmp_path / "f"),
                              ladder=(32,), spawn_timeout_s=120)
    with pytest.raises(RuntimeError, match="died during startup"):
        router.Router(cfg).start()


def test_serve_cli_replicas_drives_the_load_through_a_fleet(tmp_path,
                                                            capsys):
    fleet_dir = str(tmp_path / "fleet")
    rc = serve_cli.main(["--device", CPU, "--replicas", "2", "--requests",
                         "6", "--warmup", "2", "--mix", "random:24",
                         "--ladder", "32", "--fleet-dir", fleet_dir,
                         "--history", str(tmp_path / "h.jsonl")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "replica fleet: 2 replica(s)" in out
    assert "fleet drained: {'r0': 'drained', 'r1': 'drained'}" in out
    assert "record(s) appended" in out
    assert os.path.isfile(os.path.join(fleet_dir, "assign.log"))


# -- chip_smoke.py's phase 13, rehearsed small on the CPU ------------------

def _chip_smoke():
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


class _Finished:
    """What ``start_own_process`` returns, for a process that has already
    exited 0."""

    def poll(self):
        return 0

    def wait(self, timeout=None):
        return 0


def _campaigns_here(monkeypatch, cs):
    """The campaigns' processes run here, at once (their output to their
    logs, their value as JSON on the last line), so that their legs with
    real replica processes can be stood in for: those legs are tested for
    real in ``test_torch_replica.py`` and ``test_torch_poison.py``."""
    import contextlib

    from gauss_tpu_torch.serve import poisoncheck, replicacheck

    def start(expr, log, names=()):
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            print(json.dumps(eval(expr, {"c": cs}), default=str))
        return _Finished()

    def leg(name, **extra):
        def run(*args, **kw):
            return {"leg": name, "outcome": "ok", "audit": {
                "admitted": 0, "missing": [], "duplicates": [],
                "incorrect": [], "statuses": {}}, **extra}
        return run
    for attr, value in (
            ("run_kill_leg", leg("kill3", recovery_s=[1.0, 2.0, 3.0],
                                 restarts_used=3)),
            ("run_drain_leg", leg("drain_free", recovery_s=1.0,
                                  restarts_used=0)),
            ("run_stall_leg", leg("stall", recovery_s=2.0,
                                  restarts_used=1)),
            ("run_tput_phase", lambda *a, **k: {
                "min_speedup": 2.0, "delay_s": replicacheck.TPUT_DELAY_S,
                "replicas_1": {"throughput_rps": 1.0, "s_per_request": 1.0},
                "replicas_3": {"throughput_rps": 2.5, "s_per_request": 0.4},
                "speedup": 2.5, "ok": True})):
        monkeypatch.setattr(replicacheck, attr, value)
    for attr, value in (
            ("run_replica_leg", leg("replica", restarts_used=0)),
            ("run_crashloop_leg", leg("crashloop", incarnations=[
                {"rc": 113}, {"rc": 0}])),
            ("run_supervised_leg", leg("supervised"))):
        monkeypatch.setattr(poisoncheck, attr, value)
    monkeypatch.setattr(cs, "start_own_process", start)


@pytest.mark.parametrize("early", [False, True])
def test_chip_smoke_router_phase_rehearsal(monkeypatch, early):
    """Phase 13 end to end at small sizes on the CPU: the router over two
    replicas with the busiest SIGKILLed after the warm-up (audited, every
    key resubmitted, the respawn probed, the bundle checked, the systems
    re-solved in process with every batched launch held), then the
    campaigns (their in-process cases, their real-replica legs stood in
    for, and flightcheck whole). ``early``: as in a whole run on the
    card, the timed run and the campaigns' start happen first
    (``start_router_phase``, which phase 12 calls) and the checks later;
    else in turn, as on the CPU."""
    import io
    from contextlib import redirect_stdout

    cs = _chip_smoke()
    for name, value in (
            ("DEVICE", CPU), ("SERVE_LADDER", (32, 64)),
            ("SERVE_BATCH", 4), ("SERVE_CONCURRENCY", 2),
            ("SERVE_MIX", "random:50*3,internal:40,spd:40,"
                          "dtype:bfloat16/40,dtype:bf16x3/50,sparse:60/4"),
            ("NET_WARMUP", 2), ("NET_REQUESTS", 4), ("ROUTER_REPLICAS", 2),
            ("ROUTER_PROBE_N", 20), ("ROUTER_KILL_WAIT_S", 5.0),
            ("REPLICA_CAMPAIGN", ("--cases", "6", "--seed", "5")),
            ("POISON_CAMPAIGN", ("--cases", "4", "--seed", "5")),
            ("FLIGHT_KILL_DELAY_S", 0.0)):
        monkeypatch.setattr(cs, name, value)
    _campaigns_here(monkeypatch, cs)
    buf = io.StringIO()
    bg = {}
    with redirect_stdout(buf):
        if early:
            cs.start_router_phase(bg)
            assert set(bg["procs"]) == set(cs.ROUTER_CAMPAIGNS)
        launches, out = cs.phase_router({"serve_solves_per_s": 1.0,
                                         "net_solves_per_s": 0.5}, bg)
    assert not any(os.path.exists(bg[k]) for k in ("work", "router_work"))
    assert not any(launches.values())  # the plain versions on the CPU
    r = out["router"]
    assert r["counts"]["ok"] == 4 and r["keys"] == 7
    assert (r["lost"], r["duplicate_terminals"], r["duplicate_solves"]) == (
        0, 0, 0)
    assert r["bundle_check_rc"] == 0 and r["kill"]["adopter"]
    assert r["max_rel_diff_in_process"] <= 1e-4
    assert r["held_launches"].get("panel_factor_batched")
    assert r["vs_one_replica"] == round(r["solves_per_s"] / 0.5, 4)
    assert out["replica"]["cases"] == 6 and out["poison"]["cases"] == 4
    assert [v["metric"] for v in out["replica"]["verdicts"]] == [
        "replica:s_per_request", "replica:failover_recovery_s"]
    assert out["poison"]["replica_restarts"] == 0
    assert out["flight"]["kill"]["bundle_check_rc"] == 0
    text = buf.getvalue()
    assert '{"router": ' in text and "phase 13 (e)" in text

"""The port's multi-process plane against the JAX package's:
``dist.multihost`` (stream naming, run ids, the launch flags, joining and
leaving a world), the launcher (``python -m gauss_tpu_torch.dist.launch``:
P local ranks with the multihost coordinates, one stream each),
``obs.aggregate`` (the same merged stream and statistics from the JAX
test's two-process streams), ``resilience.watchdog`` and ``fleet``'s
worker side. Equal outputs throughout (string, path and dict equality)."""

import argparse
import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from gauss_tpu_torch.dist import multihost as tmh
from gauss_tpu_torch.obs import aggregate as tagg

REPO = Path(__file__).resolve().parents[1]
ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
       "GAUSS_OBS_RUN_ID")


@pytest.mark.parametrize("env", [{}, {"JAX_COORDINATOR_ADDRESS": "h0:1234"},
                                 {"JAX_PROCESS_ID": "3"},
                                 {"JAX_COORDINATOR_ADDRESS": "h0:1",
                                  "JAX_PROCESS_ID": "1",
                                  "GAUSS_OBS_RUN_ID": "shared"}])
@pytest.mark.parametrize("args", [(None, None, None), ("m.jsonl", None, None),
                                  ("out/m.jsonl", "c:9", 0),
                                  ("m", "c:9", 2), (None, "c:9", 1),
                                  ("m.jsonl", None, 4)])
def test_resolve_metrics_stream_matches_jax(monkeypatch, env, args):
    from gauss_tpu.dist import multihost as jmh

    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    path, coord, pid = args
    assert tmh.resolve_metrics_stream(path, coordinator=coord,
                                      process_id=pid) == \
        jmh.resolve_metrics_stream(path, coordinator=coord, process_id=pid)


def test_multihost_flags_match_jax():
    from gauss_tpu.dist import multihost as jmh

    argv = ["--coordinator", "h:1", "--num-processes", "4",
            "--process-id", "2"]
    parsed = []
    for mod in (tmh, jmh):
        p = argparse.ArgumentParser()
        mod.add_multihost_args(p)
        parsed.append(vars(p.parse_args(argv)))
        assert vars(p.parse_args([])) == {"coordinator": None,
                                          "num_processes": None,
                                          "process_id": None}
    assert parsed[0] == parsed[1]


def test_initialize_world_of_one_idempotent(monkeypatch):
    import torch.distributed as dist

    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    ns = argparse.Namespace(coordinator=None, num_processes=None,
                            process_id=None, device="cpu")
    assert tmh.maybe_initialize_from_args(ns) is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs a coordinator"):
        tmh.initialize(None, 2, 0, device="cpu")
    try:
        tmh.initialize(None, 1, 0, device="cpu")
        tmh.initialize(None, 1, 0, device="cpu")      # same: a no-op
        with pytest.raises(RuntimeError, match="already called"):
            tmh.initialize("h:1", 1, 0, device="cpu")
        assert dist.get_backend() == "gloo" and not tmh.is_multihost()
        assert tmh.process_banner() == \
            "process 0/1: 1 local / 1 global devices (cpu)"
        e0 = tmh.epoch()
    finally:
        tmh.shutdown()
    assert not dist.is_initialized()
    tmh.ensure_world("cpu")
    assert tmh.epoch() == e0 + 1
    tmh.shutdown()


def test_launcher_writes_one_stream_per_process(tmp_path):
    """``-n 2`` over the multihost flags: every process solves on the
    world of two (cuda-dist-blocked), writes its own ``<base>.p<i>.jsonl``
    under one run id with its collective events, and ``obs.aggregate``
    merges them into one run with two lanes."""
    base = tmp_path / "run.jsonl"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for k in ENV:
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "gauss_tpu_torch.dist.launch", "-n", "2",
         "--device", "cpu", "gauss_tpu_torch.cli.gauss_internal", "-s", "48",
         "--backend", "cuda-dist-blocked", "--verify", "--metrics-out",
         str(base)], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("Verification: solution pattern") == 2
    assert "process 1/2: 1 local / 2 global devices (cpu)" in r.stdout
    streams = [tmp_path / "run.p0.jsonl", tmp_path / "run.p1.jsonl"]
    runs = set()
    for i, s in enumerate(streams):
        events = [json.loads(line) for line in s.read_text().splitlines()]
        start = events[0]
        assert start["type"] == "run_start" and start["process_index"] == i
        assert start["process_count"] == 2
        runs.add(start["run"])
        colls = {ev["op"]: ev["count"] for ev in events
                 if ev["type"] == "collective"}
        assert colls["all_gather"] == 4   # one per panel: 4 of 16 rows
    assert len(runs) == 1
    out = tmp_path / "merged.jsonl"
    r = subprocess.run([sys.executable, "-m", "gauss_tpu_torch.obs.aggregate",
                        *map(str, streams), "-o", str(out)], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "from 2 process(es) [0, 1]" in r.stdout
    merged = [json.loads(line) for line in out.read_text().splitlines()]
    assert {ev["proc"] for ev in merged} == {0, 1}
    assert any(ev["type"] == "collective" for ev in merged)


def _mh_stream(path, proc, t_unix, spans, wall):
    """The JAX package's test stream shape (tests/test_obs_dist.py)."""
    events = [{"type": "run_start", "run": "mhrun0001", "seq": 0, "t": 0.0,
               "time_unix": t_unix, "schema": 1, "tool": "mh",
               "process_index": proc, "process_count": 2,
               "host": f"host{proc}"}]
    seq = 1
    for name, end_t, dur, parent in spans:
        events.append({"type": "span", "run": "mhrun0001", "seq": seq,
                       "t": end_t, "name": name, "dur_s": dur,
                       "parent": parent, "depth": 1 if parent else 0})
        seq += 1
    events.append({"type": "run_end", "run": "mhrun0001", "seq": seq,
                   "t": wall, "wall_s": wall})
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")


@pytest.fixture
def mh_streams(tmp_path):
    p0 = tmp_path / "run.p0.jsonl"
    p1 = tmp_path / "run.p1.jsonl"
    _mh_stream(p0, 0, 1000.0,
               [("solve", 0.5, 0.4, "root"), ("root", 1.0, 0.9, None)], 1.0)
    _mh_stream(p1, 1, 1000.25,
               [("solve", 0.7, 0.6, "root"), ("root", 1.1, 1.0, None)], 1.2)
    return str(p0), str(p1)


def test_aggregate_matches_jax(mh_streams, tmp_path):
    from gauss_tpu.obs import aggregate as jagg

    for order in (list(mh_streams), list(reversed(mh_streams))):
        t = tagg.merge_streams(order)
        j = jagg.merge_streams(order)
        assert t == j
    rid, merged = t
    assert tagg.straggler_stats(merged) == jagg.straggler_stats(merged)
    assert tagg.aggregate_report(rid, merged) == \
        jagg.aggregate_report(rid, merged)
    outs = []
    for mod, name in ((tagg, "t"), (jagg, "j")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert mod.main([*mh_streams, "--json", "-o",
                             str(tmp_path / f"{name}.jsonl")]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    assert tagg.main([mh_streams[0], "--run", "nope"]) == 1


def test_watchdog_matches_the_jax_contract(monkeypatch):
    from gauss_tpu_torch import resilience
    from gauss_tpu_torch.resilience import watchdog as wd

    assert resilience.WorkerLostError is wd.WorkerLostError
    assert not wd.enabled() and wd.guarded(lambda: 7, site="s") == 7
    assert wd.guarded_device(lambda: 8, site="s") == 8
    with wd.deadline(0.2):
        assert wd.enabled() and wd.configured_deadline() == 0.2
        with pytest.raises(wd.WorkerLostError) as ei:
            wd.guarded(lambda: time.sleep(2), site="dist.x")
        assert ei.value.site == "dist.x" and ei.value.deadline_s == 0.2
        assert wd.guarded_device(lambda: 9, site="s") == 9
        with pytest.raises(ValueError):
            wd.guarded(lambda: int("x"), site="s")
        ticks = []
        with pytest.raises(wd.WorkerLostError):
            wd.wait_for(lambda: False, site="barrier", poll_s=0.01,
                        on_tick=lambda: ticks.append(1))
        assert ticks
    assert not wd.enabled()
    assert wd.wait_for(lambda: 5, site="b") == 5
    monkeypatch.setenv(wd.ENV_VAR, "1.5")
    assert wd._env_deadline() == 1.5
    monkeypatch.setenv(wd.ENV_VAR, "x")
    assert wd._env_deadline() is None


def test_fleet_worker_lease_matches_jax(monkeypatch, tmp_path):
    from gauss_tpu.resilience import fleet as jfleet
    from gauss_tpu_torch.resilience import fleet as tfleet

    assert tfleet.ENV_LEASE == jfleet.ENV_LEASE
    assert tfleet.lease_path(tmp_path, 3) == jfleet.lease_path(tmp_path, 3)
    monkeypatch.delenv(tfleet.ENV_LEASE, raising=False)
    assert not tfleet.active()
    tfleet.beat(phase="x")                      # no lease: a no-op
    lease = tfleet.lease_path(tmp_path, 0)
    monkeypatch.setenv(tfleet.ENV_LEASE, lease)
    assert tfleet.active()
    tfleet.beat(phase="dist_factor_solve", n=4)
    got = tfleet.read_lease(lease)
    assert got == jfleet.read_lease(lease)
    assert got["pid"] == os.getpid() and got["phase"] == "dist_factor_solve"
    assert tfleet.read_lease(tmp_path / "none.json") is None

"""The port's fleet supervisor (``gauss_tpu_torch.resilience.fleet``)
against the JAX package's ``resilience/fleet.py`` on the CPU: the
configuration and its one added field, the exit-cause vocabulary, the
history records, and supervised solves with real worker processes (clean,
a killed worker, a stalled one, shrink and local finish, the CLI), each x
verified at 1e-4, bit for bit the port's uninterrupted factor's, and
within rounding of the JAX package's refined answer on the same inputs.

The supervised solves run with ``device="cpu"`` and a 30 s stall
threshold, except the one stall test, so that a loaded host cannot
stall-kill a worker (the JAX package's own supervised tests use 3 s).
They hold ``spawning()``, so that no port test that times itself
(``timing()``) runs beside their worker processes."""

import contextlib
import dataclasses
import fcntl
import json
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.core import blocked as jb
from gauss_tpu.resilience import fleet as jfleet
from gauss_tpu.resilience import inject as ji
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.obs import postmortem, regress
from gauss_tpu_torch.resilience import fleet as tfleet
from gauss_tpu_torch.resilience import inject as ti
from gauss_tpu_torch.serve.admission import FeatureNotPortedError

CPU = "cpu"
GATE = 1e-4
N = 64
KW = dict(workers=2, panel=16, chunk=1, stall_after_s=30.0,
          barrier_deadline_s=60.0, job_timeout_s=240.0, device=CPU)

#: Kept apart across xdist workers: the tests that spawn worker processes
#: hold this lock shared (beside each other), a port test that times
#: itself holds it alone, so no worker process loads the host meanwhile.
SPAWN_LOCK = os.path.join(tempfile.gettempdir(),
                          "gauss_tpu_torch_tests.spawn.lock")


@contextlib.contextmanager
def _flock(mode):
    with open(SPAWN_LOCK, "a") as f:
        fcntl.flock(f, mode)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def spawning():
    """Held by a test while it spawns worker processes (shared)."""
    return _flock(fcntl.LOCK_SH)


def timing():
    """Held by a test that measures wall time (exclusive)."""
    return _flock(fcntl.LOCK_EX)


@pytest.fixture(autouse=True)
def _spawning_workers():
    with spawning():
        yield


def _system(seed=7, n=N):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a, rng.standard_normal(n)


@pytest.fixture(scope="module")
def system():
    """The seeded system, the port's uninterrupted answer (the chunked
    factor + the supervisor's refinement, in this process) and the JAX
    package's on the same inputs."""
    a, b = _system()
    a32 = a.astype(np.float32)
    ft = tb.lu_factor_blocked_chunked(a32, panel=16, chunk=1, device=CPU)
    xt = tfleet._solve_refined(ft, a, b, 2)
    fj = jb.lu_factor_blocked_chunked(jnp.asarray(a32), panel=16, chunk=1)
    xj = jfleet._solve_refined(fj, a, b, 2)
    return a, b, xt, xj


def _check(res, system):
    a, b, xt, xj = system
    assert res.rel_residual <= GATE
    np.testing.assert_array_equal(res.x, xt)
    np.testing.assert_allclose(res.x, xj, rtol=1e-9, atol=1e-12)


def test_fleet_config_is_the_jax_packages_plus_device():
    tf = {f.name: f.default for f in dataclasses.fields(tfleet.FleetConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(jfleet.FleetConfig)}
    assert tf.pop("device") == "cuda"
    assert tf == jf
    tr = [f.name for f in dataclasses.fields(tfleet.FleetResult)]
    jr = [f.name for f in dataclasses.fields(jfleet.FleetResult)]
    assert tr == jr + ["launches", "route_launches", "checkpoint"]
    assert tfleet.RUNGS == jfleet.RUNGS
    assert (tfleet.PEER_LOST_EXIT, tfleet.DRAIN_EXIT, tfleet.CONFIG_EXIT) \
        == (jfleet.PEER_LOST_EXIT, jfleet.DRAIN_EXIT, jfleet.CONFIG_EXIT)


@pytest.mark.parametrize("rc", [0, ti.KILL_EXIT_CODE, 116, 117, 115, 1,
                                -9, None])
def test_exit_cause_and_the_restart_budget(rc):
    assert ti.KILL_EXIT_CODE == ji.KILL_EXIT_CODE
    cause = tfleet.exit_cause(rc)
    assert cause == jfleet.exit_cause(rc)
    assert tfleet.counts_against_restart_budget(cause) == \
        jfleet.counts_against_restart_budget(cause)


@pytest.mark.parametrize("summary", [
    {},
    {"rung_index": 0, "wall_s": 3.5},
    {"rung_index": 1, "resume_latency_s": 2.25, "restarts": 1, "stalls": 1,
     "wall_s": 9.0},
    {"rung_index": 3, "resume_latency_s": 0, "restarts": 0, "wall_s": 0},
])
def test_history_records_equal_the_jax_packages(summary):
    assert tfleet.history_records(summary) == \
        jfleet.history_records(summary)


def test_a_worker_without_a_card_fails_at_startup(tmp_path):
    """No fallback hides the device: a worker asked for the card exits
    during startup with CONFIG_EXIT (the supervisor then raises
    FleetError), and the supervisor itself refuses the card it lacks."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    a, b = _system(n=8)
    np.save(tmp_path / "a.npy", a)
    np.save(tmp_path / "b.npy", b)
    assert tfleet.main(["--worker", "--jobdir", str(tmp_path),
                        "--device", "cuda"]) == tfleet.CONFIG_EXIT
    assert tfleet.exit_cause(tfleet.CONFIG_EXIT) == "config"
    with pytest.raises(RuntimeError, match="CUDA"):
        tfleet.solve_supervised(a, b, device="cuda")


def test_the_compile_cache_is_refused_by_name(capsys):
    a, b = _system(n=8)
    with pytest.raises(FeatureNotPortedError, match="compilecache"):
        tfleet.solve_supervised(a, b, compile_cache_dir="/nonexistent",
                                device=CPU)
    assert tfleet.main(["--device", CPU, "--compile-cache", "c"]) == 2
    assert "tune/compilecache" in capsys.readouterr().err
    with pytest.raises(ValueError, match="workers"):
        tfleet.solve_supervised(a, b, workers=0, device=CPU)


def test_supervised_clean_solve(system):
    a, b = system[:2]
    res = tfleet.solve_supervised(a, b, **KW)
    assert (res.rung, res.rung_index, res.restarts, res.stalls,
            res.world) == ("supervised", 0, 0, 0, 2)
    assert res.resume_latency_s is None and not res.recovered
    _check(res, system)
    # Both workers finished and reported their checkpoint figures: one
    # shard a generation each, worker 0 hashed the manifests.
    assert sorted(r["worker"] for r in res.checkpoint) == [0, 1]
    for r in res.checkpoint:
        assert r["gens_written"] == N // 16
        assert len(r["shard_bytes"]) == N // 16
    assert next(r for r in res.checkpoint
                if r["worker"] == 0)["manifest_hash_s"] > 0
    assert res.launches == {}  # the plain versions launch no kernel


def test_supervised_kill_resumes_bit_identical(system, tmp_path):
    a, b = system[:2]
    res = tfleet.solve_supervised(
        a, b, jobdir=tmp_path, inject="fleet.worker.group=kill:skip=2",
        inject_worker=1, **KW)
    assert (res.rung, res.restarts, res.kills, res.stalls) == \
        ("restart", 1, 1, 0)
    assert res.recovered and res.resume_latency_s > 0
    _check(res, system)
    bundle = postmortem.latest_bundle(postmortem.default_bundles_dir(
        os.path.join(tmp_path, "flight")))
    assert bundle and postmortem.bundle_info(bundle)["cause"] == \
        "fleet_worker_dead"
    # The respawned worker resumed from the last generation the killed
    # world manifested.
    assert any(r["worker"] == 1 and r["resumed_from"] == 2
               for r in res.checkpoint)


def test_supervised_stall_detected_within_deadline(system):
    """The one stall test: a 3 s threshold, as the JAX package's."""
    a, b = system[:2]
    res = tfleet.solve_supervised(
        a, b, inject="fleet.worker.group=stall:skip=2", inject_worker=1,
        **dict(KW, stall_after_s=3.0))
    assert res.stalls == 1 and res.restarts == 1 and res.rung == "restart"
    _check(res, system)


@pytest.mark.parametrize("min_workers,rung,world", [
    (1, "shrink", 1), (2, "local_finish", 0)])
def test_elastic_shrink_and_local_finish(system, min_workers, rung, world):
    a, b = system[:2]
    res = tfleet.solve_supervised(
        a, b, inject="fleet.worker.group=kill:skip=1", inject_worker=1,
        max_restarts=0, min_workers=min_workers, **KW)
    assert (res.rung, res.world, res.restarts) == (rung, world, 0)
    assert res.shrinks == (1 if rung == "shrink" else 0)
    _check(res, system)
    if rung == "local_finish":
        assert res.checkpoint[-1]["worker"] == "local_finish"


def test_cli_summary_and_the_regression_history(tmp_path, capsys):
    summary = tmp_path / "s.json"
    hist = tmp_path / "h.jsonl"
    rc = tfleet.main(["--device", CPU, "-s", "48", "--panel", "16",
                      "--stall-after", "30", "--summary-json", str(summary),
                      "--history", str(hist)])
    out = capsys.readouterr().out
    assert rc == 0 and "rung=supervised" in out
    doc = json.loads(summary.read_text())
    assert doc["kind"] == "fleet_solve" and doc["verified"]
    assert doc["device"] == CPU and doc["compile_cache"] is None
    assert {k for k in doc} >= {"rung", "rung_index", "restarts",
                                "resume_latency_s", "rel_residual", "wall_s"}
    recs = regress.ingest_file(summary)
    assert [r["metric"] for r in recs] == [
        m for m, _, _ in jfleet.history_records(doc)]
    assert all(r["device"] == CPU and r["kind"] == "fleet" for r in recs)
    assert [json.loads(line)["metric"]
            for line in hist.read_text().splitlines()] == \
        [r["metric"] for r in recs]

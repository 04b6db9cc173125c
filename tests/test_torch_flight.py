"""The port's flight recorder, post-mortem bundles and debug CLI
(``gauss_tpu_torch.obs.flight``, ``postmortem``, ``debug``) on the CPU,
against the JAX package's: a ring written by either package scans in the
other (records equal), the torn tail at every byte offset and damaged
wrapped rings read alike by both scanners, a bundle of either package
passes the other's ``debug --check``, and the flight plane wired into the
server (``ServeConfig(flight_dir=)``, the ``unclean_resume`` capture), the
supervisor (``durable.supervise(flight_dir=)``) and the recovery ladder's
``sdc_detected`` trigger. Every comparison is equal."""

import json
import os
import sys

import numpy as np
import pytest

from gauss_tpu.obs import debug as jdebug
from gauss_tpu.obs import flight as jflight
from gauss_tpu.obs import postmortem as jpostmortem
from gauss_tpu_torch import obs
from gauss_tpu_torch.obs import debug, flight, postmortem
from gauss_tpu_torch.serve import ServeConfig, SolverServer, durable

CPU = "cpu"
PACKAGES = {"torch": flight, "jax": jflight}


def _docs(n, seed=3, width=40):
    rng = np.random.default_rng(seed)
    return [{"type": "event", "i": i, "p": "x" * int(rng.integers(8, width))}
            for i in range(n)]


def _write_ring(mod, path, docs, capacity=None):
    ring = mod.FlightRing(path, capacity=capacity or mod.MIN_RING_BYTES)
    ends = []
    for doc in docs:
        ring.append(json.dumps(doc, separators=(",", ":")).encode())
        ends.append(ring.wpos)
    ring.flush()
    ring.close()
    return ends


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_ring_written_by_one_package_scans_in_the_other(writer, reader,
                                                        tmp_path):
    path = str(tmp_path / "flight.1.ring")
    docs = _docs(40)
    _write_ring(PACKAGES[writer], path, docs)
    got, stats = PACKAGES[reader].scan(path)
    assert got == docs
    assert stats == PACKAGES[writer].scan(path)[1]
    assert stats["records"] == 40 and stats["torn_dropped"] == 0
    assert open(path, "rb").read()[:8] == flight.HEADER_MAGIC


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_torn_tail_at_every_offset_reads_alike(writer, tmp_path):
    """A ring cut at each byte offset (zeros after: what a kill mid-write
    leaves) scans, in both packages, to exactly the records written whole
    before the cut."""
    path = str(tmp_path / "w.ring")
    docs = _docs(24)
    ends = _write_ring(PACKAGES[writer], path, docs)
    blob = open(path, "rb").read()
    hs = flight.HEADER_SIZE
    cut_path = str(tmp_path / "cut.ring")
    for cut in range(ends[-1] + 1):
        torn = blob[:hs + cut] + b"\0" * (len(blob) - hs - cut)
        with open(cut_path, "wb") as f:
            f.write(torn)
        got, _ = flight.scan(cut_path)
        want = [docs[i] for i, end in enumerate(ends) if end <= cut]
        assert got == want, cut
        assert jflight.scan(cut_path)[0] == got, cut


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_wrapped_damaged_rings_read_alike(writer, tmp_path):
    """A ring that wrapped many laps, damaged in random windows: both
    scanners return the same records, never one that was not written."""
    path = str(tmp_path / "wrap.ring")
    docs = _docs(200, seed=5, width=120)
    _write_ring(PACKAGES[writer], path, docs)
    blob = bytearray(open(path, "rb").read())
    written = {json.dumps(d, sort_keys=True) for d in docs}
    rng = np.random.default_rng(11)
    dmg_path = str(tmp_path / "dmg.ring")
    for _ in range(40):
        dmg = bytearray(blob)
        start = flight.HEADER_SIZE + int(rng.integers(0, 4000))
        width = int(rng.integers(1, 64))
        dmg[start:start + width] = rng.integers(0, 256, width,
                                                dtype=np.uint8).tobytes()
        with open(dmg_path, "wb") as f:
            f.write(dmg)
        got, stats = flight.scan(dmg_path)
        assert (got, stats) == jflight.scan(dmg_path)
        assert all(json.dumps(e, sort_keys=True) in written for e in got)


def test_sink_records_the_obs_stream_and_its_sidecar(tmp_path):
    fdir = str(tmp_path / "flight")
    sink = flight.install(fdir)
    try:
        assert obs.flight_sink() is sink
        with obs.span("outer", n=4):
            obs.emit("serve_admit", trace="t1", n=4)
            obs.counter("c", 2)
            obs.gauge("serve.queue_depth", 3)
            obs.histogram("h", 0.5)
        obs.emit("serve_request", trace="t1", status="ok")
    finally:
        flight.uninstall()
    assert obs.flight_sink() is None
    (ring,) = flight.scan_dir(fdir)
    assert ring == jflight.scan_dir(fdir)[0]
    types = [e["type"] for e in ring["events"]]
    assert types == ["serve_admit", "counter", "gauge", "hist", "span",
                     "serve_request"]
    side = ring["sidecar"]
    assert side["pid"] == os.getpid() and side["active_traces"] == []
    assert side["gauges"] == {"serve.queue_depth": 3.0}


def _scene(tmp_path, mod_flight, mod_durable):
    """A flight dir with one ring and a journal with one live admit."""
    fdir = str(tmp_path / "flight")
    os.makedirs(fdir)
    _write_ring(mod_flight, mod_flight.ring_path(fdir, 4242), [
        {"type": "serve_admit", "trace": "tA", "n": 4},
        {"type": "serve_batch", "traces": ["tA"], "bucket_n": 16,
         "requests": 1, "seconds": 0.01}])
    jd = str(tmp_path / "journal")
    jr = mod_durable.RequestJournal(jd, fsync_batch=1)
    a = np.eye(4)
    jr.append_admit(id=1, request_id="r1", trace="tA", a=a, b=np.ones(4),
                    was_vector=True, deadline_unix=None, dtype=None,
                    structure=None)
    jr.close()
    return fdir, jd


@pytest.mark.parametrize("capturer,checker", [("torch", "jax"),
                                              ("jax", "torch")])
def test_bundles_pass_the_other_packages_check(capturer, checker, tmp_path,
                                               capsys):
    from gauss_tpu.serve import durable as jdurable

    mods = {"torch": (flight, durable, postmortem, debug),
            "jax": (jflight, jdurable, jpostmortem, jdebug)}
    fl, du, pm, _ = mods[capturer]
    fdir, jd = _scene(tmp_path, fl, du)
    path = pm.capture_bundle(pm.default_bundles_dir(fdir),
                             "supervisor_death", flight_dir=fdir,
                             journal_dir=jd, extra={"rc": -9})
    assert path and pm.latest_bundle(pm.default_bundles_dir(fdir)) == path
    other = mods[checker][3]
    assert other.main([path, "--check"]) == 0
    assert debug.main([path, "--check"]) == 0
    doc = postmortem.read_bundle(path)
    assert postmortem.check_bundle(doc) == jpostmortem.check_bundle(doc) == []
    rec, jrec = debug.reconstruct(doc), jdebug.reconstruct(doc)
    assert rec == jrec
    assert rec["open_traces"] == ["tA"] and len(rec["in_flight"]) == 1
    assert postmortem.bundle_info(path) == jpostmortem.bundle_info(path)
    capsys.readouterr()


def test_check_rejects_a_bundle_without_exactly_one_known_cause(tmp_path):
    fdir, jd = _scene(tmp_path, flight, durable)
    path = postmortem.capture_bundle(postmortem.default_bundles_dir(fdir),
                                     "manual", flight_dir=fdir)
    doc = postmortem.read_bundle(path)
    for bad in ({"cause": "gremlins"}, {"causes": ["a", "b"]},
                {"schema": 9}):
        d = dict(doc, **bad)
        assert postmortem.check_bundle(d) == jpostmortem.check_bundle(d)
        assert postmortem.check_bundle(d)
    assert postmortem.KNOWN_CAUSES == jpostmortem.KNOWN_CAUSES


def test_debug_cli_capture_timeline_json_and_trace(tmp_path, capsys):
    fdir, jd = _scene(tmp_path, flight, durable)
    assert debug.main([fdir, "--capture", "--journal", jd]) == 0
    out = capsys.readouterr().out
    assert "cause: manual" in out and "in flight at death" in out
    assert debug.main([fdir, "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["open_traces"] == ["tA"] and rec["ring_events"] == 2
    assert debug.main([fdir, "--trace", "tA"]) == 0
    assert debug.main([fdir, "--trace", "nope"]) == 2
    assert debug.main([str(tmp_path / "none")]) == 2


def test_trigger_is_armed_by_the_server_and_throttled(tmp_path):
    fdir = str(tmp_path / "flight")
    assert postmortem.trigger("sdc_detected") is None  # not armed
    postmortem.install_trigger(postmortem.default_bundles_dir(fdir),
                               flight_dir=fdir)
    try:
        first = postmortem.trigger("sdc_detected", rung="abft")
        assert first and postmortem.trigger("sdc_detected") is None
        assert debug.main([first, "--check"]) == 0
    finally:
        postmortem.uninstall_trigger()


def _system(rng, n):
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a, rng.standard_normal(n)


def test_server_records_and_captures_an_unclean_resume(tmp_path, rng):
    """``ServeConfig(flight_dir=)`` records the server's events into the
    ring; a crash leaves admits unterminated, and the next journaled start
    captures an ``unclean_resume`` bundle before its replay."""
    fdir, jd = str(tmp_path / "flight"), str(tmp_path / "journal")
    cfg = ServeConfig(ladder=(16, 32), max_batch=4, panel=16,
                      refine_steps=1, verify_gate=1e-4, journal_dir=jd,
                      flight_dir=fdir, device=CPU)
    srv = SolverServer(cfg).start()
    assert srv.flight_sink is not None and obs.flight_sink() is not None
    srv._stop.set()  # the worker takes nothing more: the admits stay live
    srv._queue.put(None)
    srv._worker.join(timeout=30)
    srv._worker = None
    for j in range(3):
        srv.submit(*_system(rng, 12), request_id=f"k{j}")
    srv._crash()
    assert obs.flight_sink() is None and srv.flight_sink is None
    events = [e for r in flight.scan_dir(fdir) for e in r["events"]]
    assert sum(e["type"] == "serve_admit" for e in events) == 3
    with SolverServer(cfg) as again:
        assert again.last_resume["replayed"] == 3
    bundle = postmortem.latest_bundle(postmortem.default_bundles_dir(fdir))
    doc = postmortem.read_bundle(bundle)
    assert doc["cause"] == "unclean_resume"
    assert len(doc["journal"]["live_admits"]) == 3
    assert debug.main([bundle, "--check"]) == 0
    assert jdebug.main([bundle, "--check"]) == 0
    assert obs.flight_sink() is None


def test_sdc_escalation_fires_the_armed_trigger(tmp_path, monkeypatch):
    """The recovery ladder fires ``sdc_detected`` when an SDC error
    escalates past its rung (a no-op unless a server armed it)."""
    from gauss_tpu_torch.resilience import abft, recover

    def sdc_rung(a64, b64, panel, iters, device):
        raise abft.SDCDetectedError("planted")
    monkeypatch.setitem(recover._RUNG_FNS, "blocked", sdc_rung)
    fdir = str(tmp_path / "flight")
    postmortem.install_trigger(postmortem.default_bundles_dir(fdir),
                               flight_dir=fdir)
    try:
        a, b = _system(np.random.default_rng(1), 16)
        res = recover.solve_resilient(a, b, rungs=("blocked", "numpy_f64"),
                                      device=CPU)
        assert res.rung == "numpy_f64"
    finally:
        postmortem.uninstall_trigger()
    bundle = postmortem.latest_bundle(postmortem.default_bundles_dir(fdir))
    doc = postmortem.read_bundle(bundle)
    assert doc["cause"] == "sdc_detected"
    assert doc["detail"]["rung"] == "blocked"


def test_supervisor_captures_a_bundle_of_each_death(tmp_path):
    """``durable.supervise(flight_dir=)`` hands the child the dir and
    captures a ``supervisor_death`` bundle when it dies."""
    marker = str(tmp_path / "ran")
    script = (f"import os, sys\n"
              f"assert os.environ['GAUSS_FLIGHT_DIR'] == "
              f"{str(tmp_path / 'f')!r}\n"
              f"if not os.path.exists({marker!r}):\n"
              f"    open({marker!r}, 'w').close(); sys.exit(3)\n")
    logs = []
    rc = durable.supervise([sys.executable, "-c", script],
                           heartbeat_path=str(tmp_path / "hb"),
                           max_restarts=1, poll_s=0.05,
                           flight_dir=str(tmp_path / "f"), log=logs.append)
    assert rc == 0
    bundle = postmortem.latest_bundle(postmortem.default_bundles_dir(
        str(tmp_path / "f")))
    assert postmortem.read_bundle(bundle)["cause"] == "supervisor_death"
    assert debug.main([bundle, "--check"]) == 0

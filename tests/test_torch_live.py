"""The port's live telemetry plane (``gauss_tpu_torch.obs.live``,
``export``, ``slo``, ``top``, ``livecheck``) against the JAX package's on
the CPU: window quantiles against ``np.quantile`` and the JAX windows, the
``/metrics`` text for the same event stream, SLO fire and clear on the
same status sequence, the dashboard's frame for the same scrape, the
embedded endpoints, the server's live plane (totals, ``/trace``, SLO-shed
admission), the fleet supervisor's heartbeat gauges, and the livecheck
gate end to end."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from gauss_tpu.obs import export as jexport
from gauss_tpu.obs import live as jlive
from gauss_tpu.obs import slo as jslo
from gauss_tpu.obs import top as jtop
from gauss_tpu_torch import obs as tobs
from gauss_tpu_torch.obs import export as texport
from gauss_tpu_torch.obs import live as tlive
from gauss_tpu_torch.obs import livecheck, regress
from gauss_tpu_torch.obs import slo as tslo
from gauss_tpu_torch.obs import top as ttop
from gauss_tpu_torch.serve.admission import STATUS_REJECTED, ServeConfig
from gauss_tpu_torch.serve.server import SolverServer
from tests.test_torch_fleet import spawning

CPU = "cpu"
LADDER = (16, 32)


def _system(rng, n):
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a, rng.standard_normal(n)


def _config(**over):
    kw = dict(ladder=LADDER, max_batch=4, panel=16, refine_steps=1,
              verify_gate=1e-4, live_port=0, device=CPU)
    kw.update(over)
    return ServeConfig(**kw)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read().decode()


def _feed(agg, rng):
    """One seeded event stream through the sink interface."""
    for i in range(40):
        agg.on_counter("serve.served", 1 + i % 3)
        agg.on_gauge("serve.queue_depth", i % 5)
        agg.on_histogram("serve.latency_s", float(rng.exponential(0.2)))
        agg.on_span("serve_batch_solve", float(rng.uniform(0.01, 0.1)),
                    None, 0, {})
    agg.on_gauge("fleet.w0.heartbeat_age_s", 0.25)
    agg.on_gauge("fleet.w1.heartbeat_age_s", 1.5)
    agg.on_gauge("fleet.world", 2)
    agg.on_counter("fleet.restarts", 1)
    agg.on_event("health", {"min_pivot": 0.5, "label": "x"})


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.95, 0.99, 1.0])
def test_quantile_matches_numpy_and_the_jax_package(q):
    vals = sorted(np.random.default_rng(1).standard_normal(257).tolist())
    got = tlive.quantile(vals, q)
    np.testing.assert_allclose(got, np.quantile(vals, q), rtol=1e-12)
    assert got == jlive.quantile(vals, q)
    assert tlive.quantile([], q) is None and tlive.quantile([7.0], q) == 7.0


def test_rolling_window_quantiles_against_np_quantile():
    rng = np.random.default_rng(2)
    vals = rng.standard_normal(300)
    tw, jw = tlive.RollingWindow(128, None), jlive.RollingWindow(128, None)
    for i, v in enumerate(vals):
        tw.add(v, t=float(i))
        jw.add(v, t=float(i))
    qs = (0.5, 0.95, 0.99)
    got = tw.quantiles(qs)
    assert got == jw.quantiles(qs)
    for q in qs:
        np.testing.assert_allclose(got[f"p{int(q * 100)}"],
                                   np.quantile(vals[-128:], q), rtol=1e-12)
    assert (tw.count, tw.total) == (300, pytest.approx(float(vals.sum())))
    # the horizon drops samples older than it
    hw = tlive.RollingWindow(64, horizon_s=10.0)
    for t in range(30):
        hw.add(float(t), t=float(t))
    assert sorted(hw.values(now=29.0)) == [float(t) for t in range(19, 30)]
    with pytest.raises(ValueError):
        tlive.RollingWindow(0)


def test_metrics_text_equals_the_jax_packages_for_the_same_stream():
    slo = dict(name="serve_ok", objective=0.9, short_window_s=10.0,
               long_window_s=60.0)
    tagg = tlive.LiveAggregator(slos=(tslo.SLO(**slo),))
    jagg = jlive.LiveAggregator(slos=(jslo.SLO(**slo),))
    for agg in (tagg, jagg):
        _feed(agg, np.random.default_rng(3))
    for i, status in enumerate(["ok"] * 6 + ["expired", "failed"] * 3):
        tagg.slos[0].observe(status, now=100.0 + i)
        jagg.slos[0].observe(status, now=100.0 + i)
    snaps = []
    for agg in (tagg, jagg):
        snap = agg.snapshot(now=120.0)
        snap["uptime_s"] = 1.5
        snaps.append(snap)
    text = texport.render_prometheus(snaps[0])
    assert text == jexport.render_prometheus(snaps[1])
    assert text == jexport.render_prometheus(snaps[0])
    lines = text.splitlines()
    assert "gauss_serve_served_total 79" in lines
    assert "# TYPE gauss_serve_latency_s summary" in lines
    assert "gauss_health_min_pivot 0.5" in lines
    assert 'gauss_slo_firing{slo="serve_ok"} 1' in lines
    assert texport.metric_name("serve.cache.hits") == \
        "gauss_serve_cache_hits"
    assert texport.attr_status() == {"recording": False}
    # the dashboard's frame for the same scrape
    tv = ttop._View(ttop.parse_metrics(text))
    jv = jtop._View(jtop.parse_metrics(text))
    assert tv.samples == jv.samples
    frame = ttop.render(tv, "http://x")
    assert frame == jtop.render(jv, "http://x")
    assert "fleet: world 2, heartbeat ages: w0=0.2s, w1=1.5s" in frame


def test_slo_fire_and_clear_equal_the_jax_packages():
    kw = dict(name="s", objective=0.95, short_window_s=1.5,
              long_window_s=8.0, fire_burn=2.0, clear_burn=1.0, min_count=4)
    tm, jm = tslo.SLOMonitor(tslo.SLO(**kw)), jslo.SLOMonitor(jslo.SLO(**kw))
    seq = ["ok"] * 5 + ["expired"] * 6 + ["cancelled", "bogus"] + \
        ["ok"] * 30
    trans = []
    for i, status in enumerate(seq):
        now = 0.2 * i
        t, j = tm.observe(status, now=now), jm.observe(status, now=now)
        assert t == j, i
        if t:
            trans.append(t["state"])
    assert trans == ["firing", "clear"]
    assert tm.status(now=10.0) == jm.status(now=10.0)
    for bad in (dict(objective=1.0), dict(short_window_s=9.0),
                dict(clear_burn=3.0)):
        with pytest.raises(ValueError):
            tslo.SLO(**dict(kw, **bad))
    rep = tslo.slo_report([tm], mix="m")
    assert rep == jslo.slo_report([jm], mix="m")
    assert rep["kind"] == "slo_report" and rep["alerts"] == 1
    assert tslo.history_records(rep) == jslo.history_records(rep)
    assert tslo.default_serving_slo() == tslo.SLO()


def test_slo_report_is_ingested_by_regress(tmp_path):
    mon = tslo.SLOMonitor(tslo.SLO(min_count=1))
    for s in ("ok", "failed", "failed", "ok"):
        mon.observe(s)
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(tslo.slo_report([mon])))
    recs = regress.ingest_file(path)
    assert [r["metric"] for r in recs] == \
        [m for m, _, _ in jslo.history_records(json.loads(path.read_text()))]
    assert all(r["kind"] == "slo" for r in recs)


def test_live_server_endpoints_and_the_dashboard(capsys):
    agg = tlive.LiveAggregator(slos=(tslo.SLO(),))
    agg.on_counter("serve.submitted", 3)
    agg.on_counter("serve.served", 2)
    with texport.LiveServer(agg, port=0) as srv:
        code, text = _get(srv.url + "/metrics")
        assert code == 200 and "gauss_serve_served_total 2" in text
        assert json.loads(_get(srv.url + "/healthz")[1])["status"] == "ok"
        assert json.loads(_get(srv.url + "/slo")[1])["slo"][0]["name"] == \
            "serve_ok"
        snap = json.loads(_get(srv.url + "/snapshot")[1])
        assert snap["attr"] == {"recording": False}
        assert snap["flight"] == {"recording": False}
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/nope")
        assert e.value.code == 404
        assert ttop.main(["--url", srv.url, "--once"]) == 0
        assert "requests: submitted 3" in capsys.readouterr().out
        assert ttop.main(["--url", srv.url, "--once", "--json"]) == 0
        assert json.loads(capsys.readouterr().out)
    assert agg.snapshot()["counters"]["live.scrapes"] == 3
    assert ttop.main(["--url", "http://127.0.0.1:9", "--once"]) == 2
    assert "cannot scrape" in capsys.readouterr().err


def test_server_live_plane_totals_trace_and_slo_shed():
    rng = np.random.default_rng(4)
    with SolverServer(_config()) as srv:
        assert srv.live_url and srv.live is not None
        for n in (12, 20, 12):
            assert srv.solve(*_system(rng, n)).ok
        got = {}

        def grab():
            got["doc"] = json.loads(_get(
                srv.live_url + "/trace?batches=1&timeout=20")[1])

        t = threading.Thread(target=grab)
        t.start()
        time.sleep(0.3)
        for _ in range(3):
            srv.solve(*_system(rng, 12))
        t.join(timeout=30)
        names = {ev.get("name") for ev in got["doc"]["traceEvents"]}
        assert "serve_batch_solve" in names
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            flat = {n: v for n, lab, v in ttop.parse_metrics(
                _get(srv.live_url + "/metrics")[1]) if not lab}
            if flat.get("gauss_serve_served_total") == 6:
                break
            time.sleep(0.05)
        assert flat["gauss_serve_served_total"] == 6
        assert flat["gauss_serve_submitted_total"] == 6
    assert srv.live_url is None and tobs.live_sink() is None
    # SLO-shed admission: while the alert fires, the bound halves.
    slo = tslo.SLO(objective=0.9, short_window_s=5.0, long_window_s=30.0,
                   min_count=2)
    srv = SolverServer(_config(slos=(slo,), slo_shed=True, max_queue=4))
    srv.start()
    try:
        for _ in range(4):
            srv.live.observe_slo("expired")
        assert srv.live.slo_firing()
        srv._stop.set()  # park the worker: requests stay queued
        srv._queue.put(None)
        srv._worker.join(timeout=10)
        res = [srv.submit(*_system(rng, 12)) for _ in range(3)]
        assert [r.done for r in res] == [False, False, True]
        assert res[2].result(1).status == STATUS_REJECTED
        assert "slo degraded" in res[2].result(1).error
    finally:
        srv.stop(drain=False)


def test_fleet_heartbeat_ages_are_live_gauges():
    """The supervisor's heartbeat ages and world size reach the live sink
    while a supervised solve runs (what its CLI serves on --live-port)."""
    from gauss_tpu_torch.resilience import fleet

    rng = np.random.default_rng(5)
    a, b = _system(rng, 32)
    agg = tlive.LiveAggregator()
    prev = tlive.install(agg)
    try:
        with spawning():
            res = fleet.solve_supervised(a, b, workers=2, panel=16,
                                         stall_after_s=30.0, device=CPU)
    finally:
        tlive.uninstall(prev)
    assert res.rel_residual <= 1e-4
    snap = agg.snapshot()
    assert snap["gauges"]["fleet.world"] == 2
    assert {"fleet.w0.heartbeat_age_s", "fleet.w1.heartbeat_age_s"} <= \
        set(snap["gauges"])
    frame = ttop.render(ttop._View(ttop.parse_metrics(
        texport.render_prometheus(snap))), "u")
    assert "fleet: world 2, heartbeat ages: w0=" in frame


def test_livecheck_gate_end_to_end(tmp_path, capsys):
    summary = tmp_path / "live.json"
    assert livecheck.main(["--device", CPU, "--requests", "24",
                           "--summary-json", str(summary)]) == 0
    out = capsys.readouterr().out
    assert "live-check: PASS" in out
    doc = json.loads(summary.read_text())
    assert doc["kind"] == "live_check" and doc["device"] == CPU
    assert doc["slo"]["alerts"] >= 1 and doc["slo"]["clears"] >= 1
    assert doc["loadgen"]["incorrect"] == 0

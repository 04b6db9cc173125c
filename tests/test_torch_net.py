"""The port's network request tier (``gauss_tpu_torch.serve.net``) on the
CPU, against the JAX package's: the wire codec (result docs, slab
framing, the matrix digest, the seeded full-jitter backoff) equal to the
JAX package's; the replica endpoint end to end (solve, idempotent
resubmission with no second solve, chunked upload, ``Retry-After`` on
overload, bad schema, unknown keys); journal adoption (typed expiry,
resubmissions racing the replay, from threads, the donor's quarantine
evidence and poisoned operands); each package's
``SolveClient`` answered by the other package's ``RequestApi``; the
replica child process (``--device cpu``) driven by ``serve.cli --net``
and drained by SIGTERM to ``DRAIN_EXIT``; and the loadgen's
``serve:net:`` history tag.

Sizes as the JAX package's tests: ladder (16, 32), panel 16, n <= 32, on
``device="cpu"``."""

import io
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from gauss_tpu.serve import ServeConfig as JServeConfig
from gauss_tpu.serve import SolverServer as JSolverServer
from gauss_tpu.serve import net as jnet
from gauss_tpu_torch.serve import (
    STATUS_EXPIRED,
    STATUS_OK,
    ServeConfig,
    SolverServer,
    durable,
    loadgen,
    net,
)
from gauss_tpu_torch.serve import cli as serve_cli
from gauss_tpu_torch.serve.admission import ServeResult
from gauss_tpu_torch.serve.cache import ExecutableCache
from gauss_tpu_torch.verify import checks

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
GATE = 1e-4


@pytest.fixture(scope="module")
def shared_cache():
    return ExecutableCache(64, device=CPU)


@pytest.fixture()
def rng():
    return np.random.default_rng(190733)


def _system(rng, n):
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a, rng.standard_normal(n)


def _config(journal_dir=None, **over):
    kw = dict(ladder=(16, 32), max_batch=4, panel=16, refine_steps=1,
              verify_gate=GATE, journal_dir=journal_dir,
              journal_fsync_batch=4, device=CPU)
    kw.update(over)
    return ServeConfig(**kw)


def _raw_terminals(jd, rids):
    """Terminal records by key across a journal's raw segment lines."""
    counts = dict.fromkeys(rids, 0)
    for seg in durable.segment_paths(jd):
        with open(seg, "rb") as f:
            for line in f.read().split(b"\n"):
                doc = durable.decode_line(line + b"\n") if line else None
                if (doc and doc.get("rec") == "terminal"
                        and doc.get("rid") in counts):
                    counts[doc["rid"]] += 1
    return counts


# -- wire codec ------------------------------------------------------------

def test_result_doc_roundtrip_and_equal_to_the_jax_package(rng):
    from gauss_tpu.serve.admission import ServeResult as JServeResult

    x = rng.standard_normal(7)
    kw = dict(status=STATUS_OK, x=x, lane="batched", bucket_n=16,
              trace="t-1", latency_s=0.5, queue_s=0.1, rel_residual=1e-9)
    doc = net.result_doc(ServeResult(**kw))
    assert doc == jnet.result_doc(JServeResult(**kw))
    assert doc["schema"] == net.WIRE_SCHEMA == jnet.WIRE_SCHEMA
    back = net.doc_result(json.loads(json.dumps(doc)))
    assert back.status == STATUS_OK and back.lane == "batched"
    assert back.bucket_n == 16 and back.trace == "t-1"
    assert back.rel_residual == pytest.approx(1e-9)
    np.testing.assert_array_equal(back.x, x)
    none_doc = net.result_doc(ServeResult(status="rejected",
                                          retry_after_s=0.4))
    assert "x" not in none_doc
    assert net.doc_result(none_doc).x is None


def test_full_jitter_backoff_bounds_and_seeded_equal():
    r = random.Random(7)
    for attempt in range(12):
        ceiling = min(30.0, 0.05 * 2 ** attempt)
        for _ in range(20):
            assert 0.0 <= net.full_jitter_backoff(0.05, attempt,
                                                  rng=r) <= ceiling
    assert all(net.full_jitter_backoff(1.0, 50, rng=r, cap_s=2.0) <= 2.0
               for _ in range(50))
    mine, theirs = random.Random(3), random.Random(3)
    assert [net.full_jitter_backoff(0.05, k, rng=mine, cap_s=2.0)
            for k in range(16)] == [
        jnet.full_jitter_backoff(0.05, k, rng=theirs, cap_s=2.0)
        for k in range(16)]


def test_slab_framing_covers_counts_and_equals_the_jax_package(rng):
    a = rng.standard_normal((37, 5))
    target = 200
    slabs = list(net.iter_slabs(a, target_bytes=target))
    assert [s[0] for s in slabs] == list(range(len(slabs)))
    assert len(slabs) == net.slab_count(37, 5, a.dtype.itemsize,
                                        target_bytes=target)
    np.testing.assert_array_equal(np.vstack([s[3] for s in slabs]), a)
    edges = [(r0, r1) for _, r0, r1, _ in slabs]
    assert edges[0][0] == 0 and edges[-1][1] == 37
    assert all(p[1] == q[0] for p, q in zip(edges, edges[1:]))
    theirs = list(jnet.iter_slabs(a, target_bytes=target))
    assert [s[:3] for s in slabs] == [s[:3] for s in theirs]
    for n_rows, n_cols, isz in ((4096, 4096, 8), (1000, 1000, 8),
                                (37, 5, 4), (1, 1, 8)):
        assert (net.slab_rows(n_cols, isz) == jnet.slab_rows(n_cols, isz))
        assert (net.slab_count(n_rows, n_cols, isz)
                == jnet.slab_count(n_rows, n_cols, isz))


def test_matrix_digest_is_content_keyed_and_equal(rng):
    a = rng.standard_normal((6, 6))
    assert net.matrix_digest(a) == net.matrix_digest(a.copy())
    assert net.matrix_digest(a) != net.matrix_digest(a + 1e-9)
    assert net.matrix_digest(a) == jnet.matrix_digest(a)


# -- the replica HTTP endpoint --------------------------------------------

def test_http_solve_e2e_idempotent_resubmit(tmp_path, rng, shared_cache):
    srv = SolverServer(_config(str(tmp_path / "journal")),
                       cache=shared_cache).start()
    api = net.RequestApi(net.ReplicaApp(srv)).start()
    try:
        client = net.SolveClient(api.url, seed=3)
        a, b = _system(rng, 12)
        res = client.solve(a, b, request_id="e2e-1", timeout=60)
        assert res.status == STATUS_OK
        assert checks.residual_norm(a, res.x, b, relative=True) <= GATE
        served, batches = srv.requests_served, srv.batches
        res2 = client.solve(a, b, request_id="e2e-1", timeout=60)
        assert res2.status == STATUS_OK
        assert (srv.requests_served, srv.batches) == (served, batches)
        np.testing.assert_array_equal(res2.x, res.x)
        h = client.submit(a, b, request_id="e2e-2")
        assert h.result(60).status == STATUS_OK
        with urllib.request.urlopen(api.url + "/healthz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        api.stop()
        srv.stop(drain=True)


def test_http_chunked_upload_solve(tmp_path, rng, shared_cache):
    srv = SolverServer(_config(str(tmp_path / "journal")),
                       cache=shared_cache).start()
    api = net.RequestApi(net.ReplicaApp(srv)).start()
    try:
        client = net.SolveClient(api.url, upload_threshold=0, seed=5)
        a, b = _system(rng, 24)
        res = client.solve(a, b, timeout=60)
        assert res.status == STATUS_OK
        assert checks.residual_norm(a, res.x, b, relative=True) <= GATE
    finally:
        api.stop()
        srv.stop(drain=True)


def test_queue_full_503_carries_retry_after(rng):
    srv = SolverServer(_config(max_queue=1))  # worker NOT started
    api = net.RequestApi(net.ReplicaApp(srv)).start()
    try:
        a, b = _system(rng, 8)
        body = json.dumps({
            "schema": net.WIRE_SCHEMA, "wait_s": 0,
            "a": durable.encode_array(a),
            "b": durable.encode_array(b)}).encode()

        def _post():
            req = urllib.request.Request(
                api.url + "/v1/solve", data=body, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=10) as resp:
                    return resp.status, dict(resp.headers)
            except urllib.error.HTTPError as e:
                e.read()
                return e.code, dict(e.headers or {})

        codes = [_post() for _ in range(3)]
        assert any(code == 202 for code, _ in codes)
        shed = [(code, hdrs) for code, hdrs in codes if code == 503]
        assert shed
        assert int(shed[-1][1]["Retry-After"]) >= 1
    finally:
        api.stop()
        srv.stop(drain=False)


def test_bad_schema_and_unknown_rid(rng):
    srv = SolverServer(_config(max_queue=4))
    app = net.ReplicaApp(srv)
    code, payload = app.handle_solve({"schema": 99})
    assert code == 400 and "schema" in payload["error"]
    assert app.lookup("no-such-rid") == (None, None)
    srv.stop(drain=False)


# -- journal adoption ------------------------------------------------------

def test_adopt_expired_yields_typed_terminal(tmp_path, rng, shared_cache):
    victim_dir = str(tmp_path / "victim")
    victim = SolverServer(_config(victim_dir))  # worker NOT started
    a, b = _system(rng, 10)
    victim.submit(a, b, deadline_s=0.05, request_id="dead-rid")
    victim.submit(a, b, request_id="live-rid")
    victim._crash()
    time.sleep(0.1)
    survivor = SolverServer(_config(str(tmp_path / "survivor")),
                            cache=shared_cache).start()
    try:
        out = net.adopt_journal(survivor, victim_dir)
        assert out["expired"] == 1 and out["replayed"] == 1
        t0 = time.monotonic()
        while (time.monotonic() - t0 < 60
               and not {"dead-rid", "live-rid"}
               <= set(survivor._rid_terminals)):
            time.sleep(0.01)
        assert survivor._rid_terminals["dead-rid"]["status"] == \
            STATUS_EXPIRED
        live = survivor._rid_terminals["live-rid"]
        assert live["status"] == STATUS_OK
        x = durable.decode_array(live["x"]).reshape(-1)
        assert checks.residual_norm(a, x, b, relative=True) <= GATE
    finally:
        survivor.stop(drain=True)


def test_resubmit_racing_replay_dedupes(tmp_path, rng, shared_cache):
    victim_dir = str(tmp_path / "victim")
    victim = SolverServer(_config(victim_dir))
    a, b = _system(rng, 10)
    victim.submit(a, b, request_id="raced-rid")
    victim._crash()
    survivor_dir = str(tmp_path / "survivor")
    survivor = SolverServer(_config(survivor_dir),
                            cache=shared_cache).start()
    try:
        h = survivor.submit(a, b, request_id="raced-rid")
        out = net.adopt_journal(survivor, victim_dir)
        assert out["skipped"] == 1 and out["replayed"] == 0
        assert h.result(60).status == STATUS_OK
    finally:
        survivor.stop(drain=True)
    assert _raw_terminals(survivor_dir, ["raced-rid"]) == {"raced-rid": 1}


def test_adopt_concurrent_resubmit_storm(tmp_path, rng, shared_cache):
    victim_dir = str(tmp_path / "victim")
    victim = SolverServer(_config(victim_dir))
    systems = [_system(rng, 10) for _ in range(4)]
    for j, (a, b) in enumerate(systems):
        victim.submit(a, b, request_id=f"storm-{j}")
    victim._crash()
    survivor_dir = str(tmp_path / "survivor")
    survivor = SolverServer(_config(survivor_dir),
                            cache=shared_cache).start()
    results = {}

    def _storm(j):
        results[j] = survivor.solve(*systems[j], request_id=f"storm-{j}",
                                    timeout=60)

    try:
        threads = [threading.Thread(target=_storm, args=(j,))
                   for j in range(4)]
        adopter = threading.Thread(target=net.adopt_journal,
                                   args=(survivor, victim_dir))
        for t in threads + [adopter]:
            t.start()
        for t in threads + [adopter]:
            t.join(120)
            assert not t.is_alive()
        assert all(results[j].status == STATUS_OK for j in range(4))
    finally:
        survivor.stop(drain=True)
    counts = _raw_terminals(survivor_dir, [f"storm-{j}" for j in range(4)])
    assert all(v == 1 for v in counts.values()), counts


def _journal_with_admit(jd, a, b, *, rid="r1", blame_boots=()):
    """A dead replica's journal: one live admit, one blame record per boot
    in ``blame_boots``."""
    jr = durable.RequestJournal(jd, fsync_batch=1, rotate_records=10_000)
    jr.append_admit(id=1, request_id=rid, trace="t1", a=a, b=b,
                    was_vector=True, deadline_unix=None, dtype=None,
                    structure=None)
    for boot in blame_boots:
        jr.append_blame(ids=[1], rids=[rid], boot=boot)
    jr.close()


def test_adopt_journal_quarantines_implicated_rid(rng, shared_cache,
                                                  tmp_path):
    """The donor's death counts cross the failover: a key implicated in
    K deaths runs solo on the host ladder on the adopter, and the evidence
    is journaled there under negative synthetic boots."""
    from gauss_tpu_torch import obs

    victim = str(tmp_path / "victim")
    a, b = _system(rng, 12)
    _journal_with_admit(victim, a, b, blame_boots=(1, 2))
    with obs.run() as rec:
        with SolverServer(_config(str(tmp_path / "survivor"),
                                  quarantine_deaths=2),
                          cache=shared_cache) as srv:
            out = net.adopt_journal(srv, victim)
            assert out["quarantined"] == 1 and out["poisoned"] == 0
            res = srv.solve(a, b, request_id="r1", timeout=120.0)
    assert res.status == STATUS_OK and res.lane == "numpy"
    assert checks.residual_norm(a, res.x, b, relative=True) <= GATE
    assert any(ev.get("type") == "quarantine" and ev.get("adopted")
               for ev in rec.events)
    st = durable.scan(str(tmp_path / "survivor"))
    assert any(bl["boot"] < 0 for bl in st.blames)
    assert st.by_rid["r1"]["status"] == STATUS_OK


def test_adopt_journal_rejects_past_k_and_scans_operands(rng, shared_cache,
                                                         tmp_path):
    victim, victim2 = str(tmp_path / "victim"), str(tmp_path / "victim2")
    a, b = _system(rng, 12)
    _journal_with_admit(victim, a, b, blame_boots=(1, 2, 3))
    bad = a.copy()
    bad[0, 0] = np.inf
    _journal_with_admit(victim2, bad, b, rid="r2")
    with SolverServer(_config(str(tmp_path / "survivor"),
                              quarantine_deaths=2),
                      cache=shared_cache) as srv:
        out = net.adopt_journal(srv, victim)
        assert out["poisoned"] == 1 and out["quarantined"] == 0
        assert net.adopt_journal(srv, victim2)["poisoned"] == 1
        r1 = srv.solve(a, b, request_id="r1", timeout=60.0)
        r2 = srv.solve(bad, b, request_id="r2", timeout=60.0)
    assert r1.status == "poison" and "quarantined" in r1.error
    assert r2.status == "poison" and "poisoned operands" in r2.error


# -- across the packages ---------------------------------------------------

def test_jax_client_is_answered_by_the_port_api(tmp_path, rng,
                                                shared_cache):
    srv = SolverServer(_config(str(tmp_path / "journal")),
                       cache=shared_cache).start()
    api = net.RequestApi(net.ReplicaApp(srv)).start()
    try:
        client = jnet.SolveClient(api.url, seed=9)
        for n, threshold in ((12, None), (24, 0)):
            if threshold is not None:
                client.upload_threshold = threshold   # chunked upload
            a, b = _system(rng, n)
            res = client.solve(a, b, request_id=f"j{n}", timeout=60)
            assert res.status == STATUS_OK, res.error
            assert checks.residual_norm(a, res.x, b, relative=True) <= GATE
            again = client.solve(a, b, request_id=f"j{n}", timeout=60)
            np.testing.assert_array_equal(again.x, res.x)
    finally:
        api.stop()
        srv.stop(drain=True)
    assert _raw_terminals(str(tmp_path / "journal"), ["j12", "j24"]) == {
        "j12": 1, "j24": 1}


def test_port_client_is_answered_by_the_jax_api(tmp_path, rng):
    jsrv = JSolverServer(JServeConfig(
        ladder=(16, 32), max_batch=4, panel=16, refine_steps=1,
        verify_gate=GATE, journal_dir=str(tmp_path / "journal"))).start()
    api = jnet.RequestApi(jnet.ReplicaApp(jsrv)).start()
    try:
        client = net.SolveClient(api.url, seed=9)
        for n, threshold in ((12, None), (24, 0)):
            if threshold is not None:
                client.upload_threshold = threshold
            a, b = _system(rng, n)
            res = client.solve(a, b, request_id=f"p{n}", timeout=60)
            assert res.status == STATUS_OK, res.error
            assert checks.residual_norm(a, res.x, b, relative=True) <= GATE
            served = jsrv.requests_served
            again = client.solve(a, b, request_id=f"p{n}", timeout=60)
            assert jsrv.requests_served == served
            np.testing.assert_array_equal(again.x, res.x)
    finally:
        api.stop()
        jsrv.stop(drain=True)


# -- the replica child process and the CLI ---------------------------------

def _wait_endpoint(d, pid_not=None, timeout=60.0):
    path = os.path.join(d, "endpoint.json")
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        try:
            with open(path) as f:
                doc = json.load(f)
            if doc.get("pid") != pid_not:
                return doc
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    raise TimeoutError(f"no endpoint at {path}")


def test_replica_child_serves_cli_net_and_drains_to_drain_exit(tmp_path):
    d = str(tmp_path / "rep")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gauss_tpu_torch.serve.net", "--replica",
         "--dir", d, "--ladder", "32", "--verify-gate", "1e-4",
         "--device", CPU], cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        ep = _wait_endpoint(d)
        assert ep["pid"] == proc.pid and ep["build_s"] == 0.0
        summary = tmp_path / "s.json"
        rc = serve_cli.main(["--net", ep["url"], "--requests", "8",
                             "--warmup", "2", "--mix", "random:24",
                             "--seed", "7", "--device", CPU,
                             "--summary-json", str(summary)])
        assert rc == 0
        doc = json.loads(summary.read_text())
        assert doc["counts"]["ok"] == 8 and doc["net"] == ep["url"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == net.DRAIN_EXIT == 116
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    st = durable.scan(os.path.join(d, "journal"))
    assert st.clean_shutdown and st.live_admits() == []
    assert len(st.terminals) == 10
    assert "--replica" in proc.args


def test_replica_refuses_a_bare_run(tmp_path, capsys):
    assert net.replica_main(["--dir", str(tmp_path)]) == 2
    assert "--replica" in capsys.readouterr().err


def test_loadgen_history_tag_net_qualified():
    base = {"mode": "closed", "throughput_rps": 10.0}
    plain = dict(loadgen.history_records(base))
    assert "serve:closed/s_per_request" in plain
    wired = dict(loadgen.history_records(dict(base, net="http://x")))
    assert "serve:net:closed/s_per_request" in wired
    assert "serve:closed/s_per_request" not in wired


# -- chip_smoke.py's phase 12, rehearsed small on the CPU ------------------

def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def test_chip_smoke_net_phase_rehearsal(monkeypatch):
    """Phase 12 end to end at small sizes on the CPU: the wire run through
    ``run_load`` with its held re-run, in-process comparison and
    zero-launch resubmission; the supervised replica killed at a seeded
    boundary, restarted, audited and drained to DRAIN_EXIT; the campaign
    (its cases, its three subprocess legs in turn) and, alone after it,
    the overhead leg. Every non-sparse request of the mix lies in the
    ladder's top bucket, so the kill always follows a top-bucket
    batch."""
    cs = _chip_smoke()
    for name, value in (
            ("DEVICE", CPU), ("SERVE_LADDER", (32, 64)),
            ("SERVE_BATCH", 4), ("SERVE_CONCURRENCY", 2),
            ("SERVE_MIX", "random:50*3,internal:40,spd:40,"
                          "dtype:bfloat16/40,dtype:bf16x3/50,sparse:60/4"),
            ("SERVE_OVERSIZE", 80),
            ("NET_CAMPAIGN", ("--cases", "4", "--seed", "5")),
            ("NET_WARMUP", 2), ("NET_REQUESTS", 4),
            ("NET_KILL_REQUESTS", 4),
            ("NET_KILL_SKIP", (2, 3))):
        monkeypatch.setattr(cs, name, value)
    buf = io.StringIO()
    with redirect_stdout(buf):
        launches, out = cs.phase_net({"solves_per_s": 1.0, "p50_s": 0.5,
                                      "p99_s": 0.9})
    assert not any(launches.values())
    camp = out["campaign"]
    assert camp["legs_ok"] == camp["legs"] == 3
    assert (camp["lost"], camp["duplicate_terminals"],
            camp["duplicate_solves"], camp["unverified"]) == (0, 0, 0, 0)
    assert camp["overhead"]["on"]["incorrect"] == 0
    assert camp["overhead"]["overhead_ratio"] > 0
    wire = out["wire"]
    # the warm-up, the measured requests, then the oversized request
    assert wire["counts"]["ok"] == 4 and sum(wire["counts"].values()) == 4
    assert wire["keys"] == 7
    assert (wire["warmup"], wire["requests"]) == (2, 4)
    split = wire["split"]
    assert 0 < split["server"]["mean_s"] <= split["client"]["mean_s"]
    assert "batched" in wire["lanes"]
    # Both answers pass the 1e-4 gate; the lowered lanes' one refinement
    # step leaves them apart by up to that order when the two batches
    # differ in size.
    assert wire["max_rel_diff_in_process"] <= 1e-4
    assert wire["journal"]["appends"] > 0
    kill = out["kill"]
    assert kill["restarts"] == 1 and kill["drain_exit"] == net.DRAIN_EXIT
    assert kill["replayed"] >= 1 and kill["keys"] == 6
    assert kill["build_s"] == [0.0, 0.0]
    assert kill["restart_after_drain"]["replayed"] == 0
    text = buf.getvalue()
    assert '{"net": ' in text and "phase 12 (c)" in text


def test_held_batched_launches_hold_only_the_given_thread():
    """Phase 12 (b) holds its re-run's launches on its own thread while the
    server's worker solves the in-process pass: given ``thread``, only the
    launches made on it are held and counted."""
    import torch

    from gauss_tpu_torch.kernels import panel as kp

    cs = _chip_smoke()
    p = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 32, 16)),
                        dtype=torch.float32)
    seen, got = {}, []
    with cs.held_batched_launches(seen, thread=threading.current_thread()):
        other = threading.Thread(
            target=lambda: got.append(kp.panel_factor_batched(p)))
        other.start()
        other.join(timeout=60)
        mine = kp.panel_factor_batched(p)
    assert seen == {"panel_factor_batched": 1}
    assert all(torch.equal(a, b) for a, b in zip(got[0], mine))

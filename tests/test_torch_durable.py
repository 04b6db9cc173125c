"""The port's durable admission (``gauss_tpu_torch.serve.durable``, the
journal half of ``serve/server.py`` and ``serve/durablecheck``) on the CPU,
against the JAX package's: the record codec byte for byte, journals
scanned across the packages in both directions, the torn tail at every
byte offset, rotation, the clean-shutdown marker, crash -> restart replay
with exactly-once terminals and complete trace trees, idempotency keys
(journaled and in flight), typed expiry in recovery, the blame records,
replay-time quarantine and the supervisor's growth guard, the
supervisor, the campaign's case runner and subprocess legs, the loadgen
journal report, the stop race, the refused options; and one seeded crash
plan through both packages' servers (the same audit counts, answers
within X_TOL of |x|).

Sizes as the JAX package's tests: ladder (16, 32), panel 16, n <= 32, on
``device="cpu"`` (the kernels' plain versions)."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from gauss_tpu.serve import ServeConfig as JServeConfig
from gauss_tpu.serve import SolverServer as JSolverServer
from gauss_tpu.serve import durable as jdurable
from gauss_tpu_torch import obs
from gauss_tpu_torch.obs import requesttrace, summarize
from gauss_tpu_torch.resilience import inject
from gauss_tpu_torch.serve import (
    STATUS_EXPIRED,
    STATUS_OK,
    STATUS_POISON,
    STATUS_REJECTED,
    ServeConfig,
    ServeRequest,
    SolverServer,
    durable,
    durablecheck,
)
from gauss_tpu_torch.serve.cache import ExecutableCache
from gauss_tpu_torch.verify import checks

CPU = "cpu"
GATE = 1e-4
#: The port's served answer against the JAX server's, relative to |x| (the
#: port's serve tests' X_TOL): both refine in host float64 past the gate;
#: their float32 factors round apart.
X_TOL = 1e-6


@pytest.fixture(scope="module")
def shared_cache():
    return ExecutableCache(64, device=CPU)


@pytest.fixture()
def rng():
    return np.random.default_rng(258458)


def _system(rng, n):
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a, rng.standard_normal(n)


def _config(journal_dir, **over):
    kw = dict(ladder=(16, 32), max_batch=4, panel=16, refine_steps=1,
              verify_gate=GATE, journal_dir=journal_dir,
              journal_fsync_batch=4, device=CPU)
    kw.update(over)
    return ServeConfig(**kw)


def _fill_journal(mod, jd, records=10, terminals=6):
    jr = mod.RequestJournal(jd, fsync_batch=2, rotate_records=10_000)
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((4, 4)), rng.standard_normal(4)
    for i in range(records):
        jr.append_admit(id=i, request_id=f"r{i}", trace=f"t{i}", a=a, b=b,
                        was_vector=True, deadline_unix=None, dtype=None,
                        structure=None)
    for i in range(terminals):
        jr.append_terminal(id=i, request_id=f"r{i}", trace=f"t{i}",
                           status="ok", x=b, lane="batched",
                           rel_residual=1e-9)
    jr.append_blame(ids=[records - 1], rids=[f"r{records - 1}"])
    jr.close()
    return jr


def _journal_with_admit(jd, a, b, *, rid="r1", blame_boots=()):
    """A dead worker's journal: one live admit, one blame record per boot
    in ``blame_boots``."""
    jr = durable.RequestJournal(jd, fsync_batch=1, rotate_records=10_000)
    jr.append_admit(id=1, request_id=rid, trace="t1", a=a, b=b,
                    was_vector=True, deadline_unix=None, dtype=None,
                    structure=None)
    for boot in blame_boots:
        jr.append_blame(ids=[1], rids=[rid], boot=boot)
    jr.close()


def _state(st):
    """A scan's content, comparable across the packages."""
    return {"admits": {i: json.dumps(d, sort_keys=True)
                       for i, d in st.admits.items()},
            "order": list(st.order),
            "terminals": {i: json.dumps(d, sort_keys=True)
                          for i, d in st.terminals.items()},
            "by_rid": sorted(st.by_rid), "blames": st.blames,
            "clean": st.clean_shutdown, "records": st.records,
            "torn": st.torn_dropped, "max_id": st.max_id,
            "max_boot": st.max_boot, "live": [d["id"] for d in
                                              st.live_admits()],
            "deaths": st.death_counts()}


# -- journal mechanics, and the records against the JAX package's ----------

def test_record_codec_roundtrip_and_bytes_equal_the_jax_package(rng):
    a = rng.standard_normal((5, 5))
    doc = {"rec": "admit", "id": 3, "a": durable.encode_array(a),
           "rid": "k", "t_unix": 1.5, "deadline_unix": None}
    line = durable.encode_record(doc)
    assert line == jdurable.encode_record(doc)
    assert durable.encode_array(a) == jdurable.encode_array(a)
    back = durable.decode_line(line)
    assert back == jdurable.decode_line(line)
    assert back["id"] == 3
    assert np.array_equal(durable.decode_array(back["a"]), a)
    corrupt = bytearray(line)
    corrupt[15] ^= 0x40
    assert durable.decode_line(bytes(corrupt)) is None
    assert jdurable.decode_line(bytes(corrupt)) is None


@pytest.mark.parametrize("writer,reader", [(jdurable, durable),
                                           (durable, jdurable)])
def test_journals_cross_between_the_packages(tmp_path, writer, reader):
    """A journal directory one package's RequestJournal wrote (admits,
    terminals, a blame, a clean-shutdown marker, then a reopened run)
    scans equal in the other."""
    jd = str(tmp_path / "j")
    _fill_journal(writer, jd)
    jr = writer.RequestJournal(jd)
    jr.append_shutdown()
    jr.close()
    jr = writer.RequestJournal(jd)
    assert jr.boot == 2
    jr.append_blame(ids=[8])
    jr.close()
    assert _state(reader.scan(jd)) == _state(writer.scan(jd))
    assert (reader.quarantinable_ids(jd) == writer.quarantinable_ids(jd)
            == {9: 1, 8: 1})
    assert reader.quarantinable_ids(jd, k=2) == {}


def test_torn_write_every_byte_offset_parses_longest_prefix(tmp_path):
    """Truncating the segment at every byte offset of its final record
    parses to the longest valid record prefix, in both packages alike."""
    jd = str(tmp_path / "j")
    _fill_journal(durable, jd)
    path = durable.segment_paths(jd)[-1]
    data = open(path, "rb").read()
    last_start = data.rstrip(b"\n").rfind(b"\n") + 1
    total = durable.scan(jd).records
    for cut in range(last_start, len(data)):
        with open(path, "wb") as f:
            f.write(data[:cut])
        st = durable.scan(jd)
        want = total if cut >= len(data) - 1 else total - 1
        assert st.records == want, (cut, st.records, want)
        assert st.torn_dropped == (0 if cut == last_start or want == total
                                   else 1)
        assert _state(st) == _state(jdurable.scan(jd)), cut


def test_partial_line_merged_with_next_append_drops_both(tmp_path):
    jd = str(tmp_path / "j")
    _fill_journal(durable, jd, records=4, terminals=2)
    path = durable.segment_paths(jd)[-1]
    data = open(path, "rb").read()
    last_start = data.rstrip(b"\n").rfind(b"\n") + 1
    extra = durable.encode_record({"rec": "terminal", "id": 3, "rid": "r3",
                                   "trace": "t3", "status": "failed",
                                   "schema": durable.JOURNAL_SCHEMA})
    with open(path, "wb") as f:
        f.write(data[:last_start + 8] + extra)  # torn tail + merged record
    st = durable.scan(jd)
    assert st.torn_dropped == 1
    assert "r3" not in st.by_rid
    assert st.records == 7 - 1
    assert _state(st) == _state(jdurable.scan(jd))


def test_rotation_compacts_and_carries_dedupe_window(tmp_path):
    jd = str(tmp_path / "j")
    jr = durable.RequestJournal(jd, fsync_batch=4, rotate_records=16)
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((4, 4)), rng.standard_normal(4)
    jr.append_admit(id=0, request_id="live0", trace="t", a=a, b=b,
                    was_vector=True, deadline_unix=None, dtype=None,
                    structure=None)
    for i in range(1, 30):
        jr.append_admit(id=i, request_id=f"k{i}", trace="t", a=a, b=b,
                        was_vector=True, deadline_unix=None, dtype=None,
                        structure=None)
        jr.append_terminal(id=i, request_id=f"k{i}", trace="t",
                           status="ok", x=b)
    assert jr.rotations >= 1
    stats = jr.stats()
    assert stats["rotations"] == jr.rotations and stats["bytes"] > 0
    jr.close()
    assert len(durable.segment_paths(jd)) <= 2
    st = durable.scan(jd)
    assert [d["id"] for d in st.live_admits()] == [0]
    assert "k29" in st.by_rid
    assert jr.rotations < 5
    assert _state(st) == _state(jdurable.scan(jd))


def test_clean_shutdown_marker_only_when_final(tmp_path):
    jd = str(tmp_path / "j")
    jr = durable.RequestJournal(jd)
    jr.append_shutdown()
    jr.close()
    assert durable.scan(jd).clean_shutdown
    jr2 = durable.RequestJournal(jd)
    rng = np.random.default_rng(1)
    jr2.append_admit(id=9, request_id=None, trace="t",
                     a=rng.standard_normal((3, 3)),
                     b=rng.standard_normal(3), was_vector=True,
                     deadline_unix=None, dtype=None, structure=None)
    jr2.close()
    st = durable.scan(jd)
    assert not st.clean_shutdown
    assert len(st.live_admits()) == 1


def test_foreign_schema_is_a_typed_error(tmp_path):
    jd = str(tmp_path / "j")
    os.makedirs(jd)
    with open(os.path.join(jd, "journal-000000.jsonl"), "wb") as f:
        f.write(durable.encode_record({"rec": "admit", "id": 1,
                                       "schema": durable.JOURNAL_SCHEMA + 1}))
    with pytest.raises(durable.JournalError, match="schema"):
        durable.scan(jd)
    assert durable.quarantinable_ids(jd) == {}


# -- server integration ----------------------------------------------------

def test_journal_off_path_unchanged(rng, shared_cache):
    with SolverServer(_config(None), cache=shared_cache) as srv:
        assert srv.journal is None
        a, b = _system(rng, 12)
        h = srv.submit(a, b)
        assert h._on_terminal is None
        res = h.result(30)
        assert res.status == STATUS_OK
        assert res.trace == h.trace_id


def test_crash_recovery_exactly_once_and_traces_complete(rng, shared_cache,
                                                         tmp_path):
    """Kill at a batch boundary -> restart: every admitted key holds
    exactly one journaled terminal, served answers verify from the
    journaled operands, and the replayed terminals complete the original
    trace trees."""
    jd = str(tmp_path / "j")
    stream = str(tmp_path / "events.jsonl")
    with obs.run(metrics_out=stream, tool="test_crash_recovery"):
        srv = SolverServer(_config(jd), cache=shared_cache).start()
        rids = []
        for j in range(4):
            a, b = _system(rng, 20)
            srv.submit(a, b, request_id=f"c{j}", deadline_s=60.0)
            rids.append(f"c{j}")
        t0 = time.monotonic()
        while srv.requests_served < 2 and time.monotonic() - t0 < 30:
            time.sleep(0.005)
        srv._stop.set()                   # park the worker: the rest stay
        srv._worker.join(timeout=30)      # queued at crash time
        srv._worker = None
        for j in range(4, 8):
            a, b = _system(rng, 20)
            srv.submit(a, b, request_id=f"c{j}", deadline_s=60.0)
            rids.append(f"c{j}")
        srv._crash()
        st = durable.scan(jd)
        assert len(st.live_admits()) > 0
        srv2 = SolverServer(_config(jd), cache=shared_cache).start()
        assert srv2.last_resume["replayed"] == len(st.live_admits())
        srv2.stop(drain=True, timeout=120.0)
    st = durable.scan(jd)
    assert st.clean_shutdown
    per_rid = {}
    for term in st.terminals.values():
        per_rid[term["rid"]] = per_rid.get(term["rid"], 0) + 1
    assert sorted(per_rid) == sorted(rids)
    assert all(v == 1 for v in per_rid.values())
    for doc in st.admits.values():
        term = st.terminals[doc["id"]]
        if term["status"] == "ok":
            a = durable.decode_array(doc["a"])
            b = durable.decode_array(doc["b"]).reshape(-1)
            x = durable.decode_array(term["x"])
            assert checks.residual_norm(a, x, b, relative=True) <= GATE
    trees = requesttrace.request_traces(obs.read_events(stream))
    assert len(trees) >= len(rids)
    assert requesttrace.check_traces(trees) == []


def test_clean_shutdown_replays_nothing(rng, shared_cache, tmp_path):
    jd = str(tmp_path / "j")
    srv = SolverServer(_config(jd), cache=shared_cache).start()
    a, b = _system(rng, 14)
    assert srv.solve(a, b, request_id="x0", timeout=60).status == STATUS_OK
    srv.stop(drain=True)
    srv2 = SolverServer(_config(jd), cache=shared_cache).start()
    assert srv2.last_resume == {"replayed": 0, "expired": 0, "clean": True,
                                "resume": True, "torn_dropped": 0}
    srv2.stop()


def test_duplicate_request_id_returns_journaled_status_without_resolving(
        rng, shared_cache, tmp_path):
    jd = str(tmp_path / "j")
    a, b = _system(rng, 18)
    with SolverServer(_config(jd), cache=shared_cache) as srv:
        first = srv.solve(a, b, request_id="dup", timeout=60)
        assert first.status == STATUS_OK
    terms_before = len(durable.scan(jd).terminals)
    with SolverServer(_config(jd), cache=shared_cache) as srv2:
        again = srv2.solve(a, b, request_id="dup", timeout=5)
        assert again.status == STATUS_OK
        assert np.array_equal(again.x, first.x)
        assert srv2.requests_served == 0
    assert len(durable.scan(jd).terminals) == terms_before


def test_pending_dedupe_attaches_to_inflight_request(rng, shared_cache,
                                                     tmp_path):
    jd = str(tmp_path / "j")
    srv = SolverServer(_config(jd), cache=shared_cache)
    srv._closed = False               # not started: submissions queue
    a, b = _system(rng, 16)
    h1 = srv.submit(a, b, request_id="pend")
    h2 = srv.submit(a, b, request_id="pend")
    assert h2 is h1
    srv.start()
    assert h1.result(60).status == STATUS_OK
    srv.stop(drain=True)
    st = durable.scan(jd)
    assert sum(1 for t in st.terminals.values()
               if t.get("rid") == "pend") == 1


def test_expired_in_recovery_is_typed_terminal(rng, shared_cache, tmp_path):
    jd = str(tmp_path / "j")
    srv = SolverServer(_config(jd), cache=shared_cache)
    srv.start()
    a, b = _system(rng, 16)
    srv._stop.set()
    srv._worker.join(timeout=30)
    srv._worker = None
    h = srv.submit(a, b, request_id="late", deadline_s=0.05)
    assert not h.done
    srv._crash()
    time.sleep(0.1)
    srv2 = SolverServer(_config(jd), cache=shared_cache).start()
    assert srv2.last_resume["expired"] == 1
    srv2.stop(drain=True)
    term = durable.scan(jd).by_rid["late"]
    assert term["status"] == STATUS_EXPIRED
    assert "recovery" in term["error"]


def test_restarted_process_never_reuses_a_journaled_id(rng, shared_cache,
                                                       tmp_path):
    """A new process counts request ids from 1: the port's journaled
    server mints its new admits above the journal's largest id, so a new
    admit's records never fold into an older request's (the JAX package's
    server reuses the ids: an old terminal then shadows the new admit)."""
    jd = str(tmp_path / "j")
    a, b = _system(rng, 12)
    jr = durable.RequestJournal(jd, fsync_batch=1)
    for i in (10_000_000, 10_000_001):
        jr.append_admit(id=i, request_id=f"old{i}", trace="t", a=a, b=b,
                        was_vector=True, deadline_unix=None, dtype=None,
                        structure=None)
    jr.append_terminal(id=10_000_001, request_id="old10000001", trace="t",
                       status=STATUS_OK, x=b)
    jr.close()
    with SolverServer(_config(jd), cache=shared_cache) as srv:
        assert srv.last_resume["replayed"] == 1
        h = srv.submit(a, b, request_id="new")
        assert h.id > 10_000_001
        assert h.result(60).status == STATUS_OK
    st = durable.scan(jd)
    assert st.live_admits() == []
    assert {t["rid"] for t in st.terminals.values()} == {
        "old10000000", "old10000001", "new"}
    assert ServeRequest(a, b).id > h.id


def test_reject_terminals_carry_traces_loadgen_visible(rng, shared_cache,
                                                       tmp_path):
    stream = str(tmp_path / "rejects.jsonl")
    with obs.run(metrics_out=stream, tool="test_rejects"):
        srv = SolverServer(_config(None, max_queue=0),
                           cache=shared_cache).start()
        a, b = _system(rng, 12)
        h = srv.submit(a, b)                      # queue_full reject
        res = h.result(5)
        assert res.status == STATUS_REJECTED
        assert res.trace == h.trace_id
        srv.stop()
        h2 = srv.submit(a, b)                     # server-stopped reject
        assert h2.result(5).status == STATUS_REJECTED
        assert h2.result(5).trace == h2.trace_id
    events = obs.read_events(stream)
    terminals = [ev for ev in events if ev.get("type") == "serve_request"]
    assert len(terminals) == 2
    assert all(ev.get("trace") for ev in terminals)
    assert requesttrace.check_traces(requesttrace.request_traces(events)) == []


def test_heartbeat_written_from_worker_loop(shared_cache, tmp_path):
    hb = str(tmp_path / "hb.json")
    with SolverServer(_config(None, heartbeat_path=hb), cache=shared_cache):
        t0 = time.monotonic()
        while not os.path.exists(hb) and time.monotonic() - t0 < 10:
            time.sleep(0.02)
        assert os.path.exists(hb)
        doc = json.loads(open(hb).read())
        assert doc["pid"] == os.getpid()


def test_supervise_restarts_dead_child(tmp_path):
    """A child that dies once (rc 113) then exits 0 is restarted once, and
    GAUSS_FAULTS does not reach the respawn."""
    marker = str(tmp_path / "died_once")
    hb = str(tmp_path / "hb.json")
    script = (
        "import os, sys\n"
        "open(os.environ['HB'], 'w').write('beat')\n"
        f"m = {marker!r}\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').write('x')\n"
        "    assert os.environ.get('GAUSS_FAULTS') == 'armed'\n"
        "    os._exit(113)\n"
        "assert 'GAUSS_FAULTS' not in os.environ\n"
        "sys.exit(0)\n")
    env = dict(os.environ, HB=hb, GAUSS_FAULTS="armed")
    logs = []
    rc = durable.supervise([sys.executable, "-c", script],
                           heartbeat_path=hb, max_restarts=2,
                           stall_after_s=60.0, env=env, log=logs.append)
    assert rc == 0
    assert any("restarting" in ln for ln in logs)


def test_supervise_kills_a_stalled_child_and_waits_for_it(tmp_path):
    """A child whose heartbeat goes stale is killed, and the respawn
    starts only after it exited."""
    marker = str(tmp_path / "stalled_once")
    hb = str(tmp_path / "hb.json")
    script = (
        "import os, sys, time\n"
        "open(os.environ['HB'], 'w').write('beat')\n"
        f"m = {marker!r}\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').write(str(os.getpid()))\n"
        "    time.sleep(60)\n"
        "sys.exit(0)\n")
    logs = []
    rc = durable.supervise([sys.executable, "-c", script],
                           heartbeat_path=hb, max_restarts=1,
                           stall_after_s=1.0, poll_s=0.05,
                           env=dict(os.environ, HB=hb), log=logs.append)
    assert rc == 0
    assert any("stalled" in ln for ln in logs)
    first = int(open(marker).read())
    with pytest.raises(ProcessLookupError):
        os.kill(first, 0)


def test_supervise_flight_dir_is_refused_before_any_spawn(tmp_path):
    """``flight_dir`` is ported since (``obs/postmortem``): the child runs
    with ``GAUSS_FLIGHT_DIR`` set, and a clean exit captures no bundle
    (``tests/test_torch_flight.py`` holds the bundle of a death). The
    name is the one the test had while ``flight_dir`` was refused."""
    marker = str(tmp_path / "spawned")
    fdir = str(tmp_path / "f")
    rc = durable.supervise(
        [sys.executable, "-c", f"import os; open({marker!r}, 'w')"
         f".write(os.environ['GAUSS_FLIGHT_DIR'])"],
        heartbeat_path=str(tmp_path / "hb"), flight_dir=fdir,
        log=lambda _m: None)
    assert rc == 0 and open(marker).read() == fdir
    assert not os.path.exists(os.path.join(fdir, "bundles"))


def test_inject_kinds_and_torn_write_hook():
    plan = inject.FaultPlan.parse(
        "serve.server.batch=server_kill:skip=2;"
        "serve.journal.append=journal_torn_write:param=0.5")
    assert {sp.kind for sp in plan.specs} == {"server_kill",
                                              "journal_torn_write"}
    with inject.plan(plan):
        assert inject.poll_torn_write("serve.server.batch") is None
        sp = inject.poll_torn_write("serve.journal.append")
        assert sp is not None and sp.param == 0.5


@pytest.mark.parametrize("kind", durablecheck.CASE_KINDS)
def test_campaign_case_runner_each_kind(shared_cache, tmp_path, kind):
    i = durablecheck.CASE_KINDS.index(kind)
    out = durablecheck.run_recovery_case(i, 99, GATE, str(tmp_path), kind,
                                         cache=shared_cache, device=CPU)
    assert out["outcome"] == "ok", out
    assert out["audit"]["admitted"] >= 8
    assert out["deduped"] == out["audit"]["admitted"]
    assert out["dedupe_resolves"] == 0


def test_campaign_subprocess_legs(tmp_path):
    """The real kills: a server_kill child, a torn-write child and a
    supervised child, each audited exactly-once."""
    sub = durablecheck.run_subprocess_legs(5, GATE, str(tmp_path),
                                           device=CPU, log=lambda _l: None)
    assert [leg["leg"] for leg in sub["legs"]] == ["kill", "torn",
                                                   "supervised"]
    assert sub["violations"] == 0, sub
    assert all(leg["killed"] for leg in sub["legs"])
    assert sub["legs"][2]["restarts"] == 1


@pytest.mark.parametrize("flag", [["--history"], ["--regress-check"]])
def test_campaign_regress_flags_exit_2(flag, capsys, tmp_path,
                                       monkeypatch):
    """``--history`` and ``--regress-check`` are ported since
    (``obs.regress``): the campaign appends its records to the port's
    history (here a temporary file standing in for the default), stamped
    with the device, or gates them against it (no baseline yet: exit 0).
    The name is the one the test had while both exited 2."""
    from gauss_tpu_torch.obs import regress

    hist = tmp_path / "history_torch.jsonl"
    monkeypatch.setattr(regress, "default_history_path", lambda: str(hist))
    assert durablecheck.main(["--device", CPU, "--cases", "4",
                              "--no-subprocess", "--no-overhead",
                              *flag]) == 0
    out = capsys.readouterr().out
    if flag == ["--history"]:
        recs = regress.load_history(hist)
        assert [r["metric"] for r in recs] == ["durable:s_per_case"]
        assert recs[0]["device"] == CPU and recs[0]["kind"] == "durable"
    else:
        assert "no-baseline" in out and not hist.exists()


def test_campaign_cli_in_process_only(tmp_path):
    summary = tmp_path / "d.json"
    rc = durablecheck.main(["--device", CPU, "--cases", "4",
                            "--no-subprocess", "--no-overhead",
                            "--summary-json", str(summary)])
    assert rc == 0
    doc = json.loads(summary.read_text())
    assert doc["kind"] == "durable_campaign" and doc["invariant_ok"]
    assert (doc["lost"], doc["duplicate_terminals"],
            doc["duplicate_solves"], doc["unverified"]) == (0, 0, 0, 0)


def test_summarize_durability_section(rng, shared_cache, tmp_path):
    jd = str(tmp_path / "j")
    stream = str(tmp_path / "durable_events.jsonl")
    with obs.run(metrics_out=stream, tool="test_durability_summary"):
        srv = SolverServer(_config(jd), cache=shared_cache).start()
        srv._stop.set()
        srv._worker.join(timeout=30)
        srv._worker = None
        a, b = _system(rng, 14)
        srv.submit(a, b, request_id="s0")
        srv._crash()
        srv2 = SolverServer(_config(jd), cache=shared_cache).start()
        srv2.stop(drain=True, timeout=60)
        with SolverServer(_config(jd), cache=shared_cache) as srv3:
            srv3.solve(a, b, request_id="s0", timeout=10)
    events = obs.read_events(stream)
    run_id = events[0]["run"]
    du = summarize.run_summary(events, run_id)["durability"]
    assert du["resumes"]["replayed"] == 1
    assert du["deduped"] == 1
    assert du["journal_events"]["open"] >= 3
    assert "durability (request journal):" in summarize.summarize_run(
        events, run_id)


def test_loadgen_journal_report_and_request_ids(shared_cache, tmp_path):
    from gauss_tpu_torch.serve.loadgen import (LoadgenConfig, format_summary,
                                               run_load)

    cfg = LoadgenConfig(mix="random:14", requests=6, warmup=2,
                        concurrency=2, seed=5, request_ids=True,
                        serve=_config(str(tmp_path / "j")))
    with SolverServer(cfg.serve, cache=shared_cache) as srv:
        summary = run_load(srv, cfg)
    assert summary["counts"]["ok"] == 6
    assert summary["journal"]["appends"] > 0
    assert "journal:" in format_summary(summary)
    st = durable.scan(str(tmp_path / "j"))
    assert any(k.startswith("lg5-") for k in st.by_rid)


def test_stop_shutdown_race_still_exactly_one_terminal_with_journal(
        rng, shared_cache, tmp_path):
    jd = str(tmp_path / "j")
    srv = SolverServer(_config(jd), cache=shared_cache).start()
    a, b = _system(rng, 12)
    stop_now = threading.Event()
    admitted = []
    lock = threading.Lock()

    def submitter(k):
        for j in range(12):
            rid = f"race{k}-{j}"
            h = srv.submit(a, b, request_id=rid, deadline_s=30.0)
            if not (h.done and h.result(0).status == STATUS_REJECTED):
                with lock:
                    admitted.append(rid)
            if stop_now.is_set() and j > 4:
                return

    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.02)
    stop_now.set()
    srv.stop(drain=True, timeout=120.0)
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    per_rid = {}
    for term in durable.scan(jd).terminals.values():
        if term.get("rid"):
            per_rid[term["rid"]] = per_rid.get(term["rid"], 0) + 1
    for rid in admitted:
        assert per_rid.get(rid, 0) == 1, rid


# -- poison, blame records and quarantine ---------------------------------

def test_submit_rejects_nonfinite_before_journal_admit(rng, shared_cache,
                                                       tmp_path):
    jd = str(tmp_path / "j")
    a, b = _system(rng, 12)
    a[0, 0] = np.nan
    with SolverServer(_config(jd), cache=shared_cache) as srv:
        res = srv.solve(a, b, request_id="nanpill", timeout=60.0)
        assert res.status == STATUS_POISON
        assert "poisoned operands" in res.error
    st = durable.scan(jd)
    assert "nanpill" not in st.by_rid
    assert not any(d.get("rid") == "nanpill" for d in st.admits.values())


def test_blame_records_boot_increments_and_death_counts(rng, tmp_path):
    jd = str(tmp_path / "j")
    a, b = _system(rng, 6)
    jr = durable.RequestJournal(jd, fsync_batch=1, rotate_records=10_000)
    assert jr.boot == 1
    for i in (1, 2):
        jr.append_admit(id=i, request_id=f"r{i}", trace="t", a=a, b=b,
                        was_vector=True, deadline_unix=None, dtype=None,
                        structure=None)
    jr.append_blame(ids=[1, 2], rids=["r1", "r2"])
    jr.append_blame(ids=[1])          # a re-dispatch, same boot: one death
    jr.close()
    jr2 = durable.RequestJournal(jd, fsync_batch=1, rotate_records=10_000)
    assert jr2.boot == 2
    jr2.append_blame(ids=[1])
    jr2.append_terminal(id=2, request_id="r2", trace="t", status="ok",
                        x=b, lane="batched", rel_residual=1e-9)
    jr2.close()
    assert durable.scan(jd).death_counts() == {1: 2}
    assert durable.quarantinable_ids(jd) == {1: 2}
    assert durable.quarantinable_ids(jd, k=3) == {}
    assert durable.quarantinable_ids(str(tmp_path / "missing")) == {}
    assert jdurable.quarantinable_ids(jd) == {1: 2}


def test_rotation_carries_blame_for_live_admits(rng, tmp_path):
    jd = str(tmp_path / "j")
    a, b = _system(rng, 6)
    jr = durable.RequestJournal(jd, fsync_batch=1, rotate_records=8)
    jr.append_admit(id=1, request_id="r1", trace="t", a=a, b=b,
                    was_vector=True, deadline_unix=None, dtype=None,
                    structure=None)
    jr.append_blame(ids=[1], rids=["r1"])
    for i in range(2, 12):
        jr.append_admit(id=i, request_id=f"r{i}", trace="t", a=a, b=b,
                        was_vector=True, deadline_unix=None, dtype=None,
                        structure=None)
        jr.append_terminal(id=i, request_id=f"r{i}", trace="t",
                           status="ok", x=b, lane="batched",
                           rel_residual=1e-9)
    jr.close()
    assert durable.scan(jd).death_counts() == {1: 1}


def test_replay_quarantines_at_k_deaths_and_solves_solo(rng, shared_cache,
                                                        tmp_path):
    jd = str(tmp_path / "j")
    a, b = _system(rng, 12)
    _journal_with_admit(jd, a, b, blame_boots=(1, 2))
    with obs.run() as rec:
        with SolverServer(_config(jd, quarantine_deaths=2),
                          cache=shared_cache) as srv:
            assert srv.last_resume["quarantined"] == 1
            res = srv.solve(a, b, request_id="r1", timeout=120.0)
    assert res.status == "ok" and res.lane == "numpy"
    assert checks.residual_norm(a, res.x, b, relative=True) <= GATE
    assert any(ev.get("type") == "quarantine" and ev.get("action") == "solo"
               for ev in rec.events)
    assert durable.scan(jd).by_rid["r1"]["status"] == "ok"


def test_replay_rejects_typed_past_k_deaths(rng, shared_cache, tmp_path):
    jd = str(tmp_path / "j")
    a, b = _system(rng, 12)
    _journal_with_admit(jd, a, b, blame_boots=(1, 2, 3))
    with SolverServer(_config(jd, quarantine_deaths=2),
                      cache=shared_cache) as srv:
        assert srv.last_resume["poisoned"] == 1
        res = srv.solve(a, b, request_id="r1", timeout=60.0)
    assert res.status == STATUS_POISON
    assert "quarantined" in res.error
    assert durable.scan(jd).by_rid["r1"]["status"] == STATUS_POISON


def test_replay_scans_journaled_operands(rng, shared_cache, tmp_path):
    jd = str(tmp_path / "j")
    a, b = _system(rng, 12)
    a[3, 3] = np.nan
    _journal_with_admit(jd, a, b)
    with SolverServer(_config(jd), cache=shared_cache) as srv:
        assert srv.last_resume["poisoned"] == 1
    term = durable.scan(jd).by_rid["r1"]
    assert term["status"] == STATUS_POISON
    assert "poisoned operands" in term["error"]


def test_quarantine_zero_disables_the_policy(rng, shared_cache, tmp_path):
    jd = str(tmp_path / "j")
    a, b = _system(rng, 12)
    _journal_with_admit(jd, a, b, blame_boots=(1, 2, 3, 4))
    with SolverServer(_config(jd, quarantine_deaths=0),
                      cache=shared_cache) as srv:
        res = srv.solve(a, b, request_id="r1", timeout=120.0)
    assert res.status == "ok" and res.lane == "batched"


def _blame_growth_child(jd, marker, exit_code=113):
    """A torch-free supervise child: the first incarnation appends blame
    evidence to the live segment and dies; the respawn exits 0."""
    seg = durable.segment_paths(jd)[-1]
    blame = durable.encode_record({
        "rec": "blame", "schema": durable.JOURNAL_SCHEMA, "boot": 1,
        "ids": [1], "rids": ["r1"], "t_unix": 0.0})
    return (
        "import os, sys\n"
        "open(os.environ['HB'], 'w').write('beat')\n"
        f"m = {marker!r}\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').write('x')\n"
        f"    open({seg!r}, 'ab').write({blame!r})\n"
        f"    os._exit({exit_code})\n"
        "sys.exit(0)\n")


def test_supervise_free_respawn_at_quarantine_threshold(rng, tmp_path):
    jd = str(tmp_path / "j")
    a, b = _system(rng, 6)
    _journal_with_admit(jd, a, b)
    hb = str(tmp_path / "hb.json")
    logs = []
    with obs.run() as rec:
        rc = durable.supervise(
            [sys.executable, "-c",
             _blame_growth_child(jd, str(tmp_path / "died_once"))],
            heartbeat_path=hb, max_restarts=0, stall_after_s=60.0,
            env=dict(os.environ, HB=hb), journal_dir=jd,
            quarantine_deaths=1, log=logs.append)
    assert rc == 0
    assert any("quarantined" in ln for ln in logs)
    assert rec.counters.get("serve.quarantined_respawns") == 1
    assert rec.counters.get("serve.supervisor_restarts", 0) == 0


def test_supervise_charges_death_without_new_evidence(rng, tmp_path):
    jd = str(tmp_path / "j")
    a, b = _system(rng, 6)
    _journal_with_admit(jd, a, b, blame_boots=(1,))
    hb = str(tmp_path / "hb.json")
    script = ("import os\n"
              "open(os.environ['HB'], 'w').write('beat')\n"
              "os._exit(113)\n")
    rc = durable.supervise(
        [sys.executable, "-c", script], heartbeat_path=hb,
        max_restarts=0, stall_after_s=60.0,
        env=dict(os.environ, HB=hb), journal_dir=jd, quarantine_deaths=1,
        log=lambda _ln: None)
    assert rc == 113


def test_supervise_charges_first_death_below_threshold(rng, tmp_path):
    jd = str(tmp_path / "j")
    a, b = _system(rng, 6)
    _journal_with_admit(jd, a, b)
    hb = str(tmp_path / "hb.json")
    rc = durable.supervise(
        [sys.executable, "-c",
         _blame_growth_child(jd, str(tmp_path / "died_once"))],
        heartbeat_path=hb, max_restarts=0, stall_after_s=60.0,
        env=dict(os.environ, HB=hb), journal_dir=jd, quarantine_deaths=2,
        log=lambda _ln: None)
    assert rc == 113


# -- the slice as a whole against the JAX package --------------------------

def _crash_plan(make, jd, seed):
    """One seeded crash plan through a server ``make(cfg_kwargs)`` builds:
    two keys served, the worker parked, four more admitted (the last with
    a deadline dead by the restart), a crash, two prior deaths blamed on
    the first queued key, a restart that replays, a drain. Returns the
    resume report, the audit counts and each key's answer."""
    rng = np.random.default_rng(seed)
    systems = {f"k{j}": _system(rng, 12 + 2 * j) for j in range(6)}
    srv = make(jd).start()
    for rid in ("k0", "k1"):
        assert srv.solve(*systems[rid], request_id=rid,
                         timeout=120).status == STATUS_OK
    srv._stop.set()
    srv._worker.join(timeout=30)
    srv._worker = None
    handles = {rid: srv.submit(*systems[rid], request_id=rid,
                               deadline_s=0.05 if rid == "k5" else 120.0)
               for rid in ("k2", "k3", "k4", "k5")}
    srv._crash()
    blamed = handles["k2"].journal_id
    jmod = durable if isinstance(srv, SolverServer) else jdurable
    jr = jmod.RequestJournal(jd)
    for boot in (1, 2):
        jr.append_blame(ids=[blamed], rids=["k2"], boot=boot)
    jr.close()
    time.sleep(0.1)                   # k5's deadline passes
    srv2 = make(jd).start()
    resume = dict(srv2.last_resume)
    srv2.stop(drain=True, timeout=120)
    st = jmod.scan(jd)
    statuses = {}
    for term in st.terminals.values():
        statuses[term["status"]] = statuses.get(term["status"], 0) + 1
    counts = {"admits": len(st.admits), "terminals": len(st.terminals),
              "statuses": statuses, "live": len(st.live_admits()),
              "clean": st.clean_shutdown}
    answers = {rid: jmod.decode_array(t["x"]) for rid, t in st.by_rid.items()
               if t.get("x") is not None}
    return resume, counts, answers, systems


def test_one_crash_plan_through_both_servers(tmp_path, shared_cache):
    kw = dict(ladder=(16, 32), max_batch=4, panel=16, refine_steps=1,
              verify_gate=GATE, journal_fsync_batch=4, quarantine_deaths=2)
    got = _crash_plan(lambda jd: SolverServer(
        ServeConfig(journal_dir=jd, device=CPU, **kw), cache=shared_cache),
        str(tmp_path / "port"), 11)
    want = _crash_plan(lambda jd: JSolverServer(
        JServeConfig(journal_dir=jd, **kw)), str(tmp_path / "jax"), 11)
    assert got[0] == want[0] == {
        "replayed": 3, "expired": 1, "poisoned": 0, "quarantined": 1,
        "clean": False, "resume": True, "torn_dropped": 0}
    assert got[1] == want[1]
    assert got[1]["statuses"] == {STATUS_OK: 5, STATUS_EXPIRED: 1}
    assert sorted(got[2]) == sorted(want[2]) == ["k0", "k1", "k2", "k3",
                                                 "k4"]
    systems = got[3]
    for rid, x in got[2].items():
        a, b = systems[rid]
        ref = want[2][rid]
        assert checks.residual_norm(a, x, b, relative=True) <= GATE
        assert np.linalg.norm(x - ref) <= X_TOL * np.linalg.norm(ref), rid

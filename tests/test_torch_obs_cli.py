"""The port's CLIs under the telemetry flags against the JAX package's:
the same span names, event types and health keys in their ``--metrics-out``
streams (the port's backend names for the JAX package's: ``cuda`` for
``tpu``; no XLA cost accounting), both summarizers on those streams,
``--trace`` on the CPU, and runs without the flags left as they were."""

import io
import json
import re
from contextlib import redirect_stdout

import pytest

from gauss_tpu.obs import summarize as jsummarize
from gauss_tpu_torch import obs as tobs
from gauss_tpu_torch.io import datfile, synthetic
from gauss_tpu_torch.obs import summarize as tsummarize

# The JAX package's XLA cost accounting, which the port does not have.
COST_SPANS = {"cost_analysis"}
COST_EVENTS = {"cost", "vmem_estimate"}
HEALTH_KEYS = {"nan", "inf", "max_abs_x", "residual", "rel_residual",
               "min_abs_pivot", "max_abs_pivot", "growth_factor",
               "loop_min_abs_pivot", "backend"}


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _port_name(name: str) -> str:
    """A JAX package span or backend name under the port's backend names."""
    return name.replace("tpu", "cuda")


def _stream(path):
    events = tobs.read_events(path)
    assert len({ev["run"] for ev in events}) == 1
    spans = {ev["name"] for ev in events if ev["type"] == "span"}
    types = {ev["type"] for ev in events}
    return events, spans, types


@pytest.fixture(scope="module")
def jax_streams(tmp_path_factory):
    """One run of each JAX CLI with --metrics-out (three runs in all)."""
    from gauss_tpu.cli import gauss_external, gauss_internal, matmul

    d = tmp_path_factory.mktemp("jax")
    dat = d / "gen.dat"
    datfile.write_dat(dat, synthetic.generator_matrix(48))
    runs = {
        "internal": (gauss_internal.main,
                     ["-s", "64", "--verify", "--profile", "--phase-profile"]),
        "external": (gauss_external.main, [str(dat), "--debug"]),
        "matmul": (matmul.main, ["64", "--engines", "tpu"]),
    }
    out = {"dat": dat}
    for key, (main, argv) in runs.items():
        path = d / f"{key}.jsonl"
        rc, text = _run(main, [*argv, "--metrics-out", str(path)])
        assert rc == 0, text
        out[key] = (path, text)
    return out


def _assert_same_stream(port_path, jax_path):
    jev, jspans, jtypes = _stream(jax_path)
    tev, tspans, ttypes = _stream(port_path)
    assert tspans == {_port_name(s) for s in jspans - COST_SPANS}
    assert ttypes == jtypes - COST_EVENTS
    jhealth = [ev for ev in jev if ev["type"] == "health"]
    thealth = [ev for ev in tev if ev["type"] == "health"]
    assert [set(ev) - {"seq", "t", "run"} for ev in thealth] == [
        set(ev) - {"seq", "t", "run"} for ev in jhealth]
    assert [ev["backend"] for ev in thealth] == [
        _port_name(ev["backend"]) for ev in jhealth]
    return tev


def test_internal_stream_matches_jax(jax_streams, tmp_path):
    from gauss_tpu_torch.cli import gauss_internal

    path = tmp_path / "m.jsonl"
    rc, out = _run(gauss_internal.main, [
        "-s", "64", "--verify", "--profile", "--phase-profile", "--device",
        "cpu", "--metrics-out", str(path)])
    assert rc == 0
    jpath, jout = jax_streams["internal"]
    events = _assert_same_stream(path, jpath)
    assert re.search(rf"Metrics: run \w+ appended to {re.escape(str(path))}",
                     out)
    assert "Solver phase profile (instrumented re-factorization):" in out
    assert "Solver phase profile (instrumented re-factorization):" in jout
    spans = {ev["name"] for ev in events if ev["type"] == "span"}
    assert {"setup_env", "initMatrix", "host_staging",
            "compile:cuda_blocked_warmup", "computeGauss", "health_monitors",
            "phase_profile", "pad_stage", "panel_factor", "pivot_apply",
            "trailing_update", "verify"} == spans
    (health,) = [ev for ev in events if ev["type"] == "health"]
    assert set(health) - {"type", "run", "seq", "t"} == HEALTH_KEYS
    assert health["backend"] == "cuda" and health["min_abs_pivot"] > 0
    assert health["residual"] < 1e-4 and health["growth_factor"] > 0
    (config,) = [ev for ev in events if ev["type"] == "config"]
    assert config["n"] == 64 and config["backend"] == "cuda"
    (compile_ev,) = [ev for ev in events if ev["type"] == "compile"]
    assert compile_ev["label"] == "cuda_blocked_warmup"
    (reported,) = [ev for ev in events if ev["type"] == "reported_time"]
    secs = float(re.search(r"Application time: (\S+) Secs", out).group(1))
    assert reported["name"] == "Application time"
    assert reported["seconds"] == pytest.approx(secs, abs=1e-6)


def test_external_stream_matches_jax(jax_streams, tmp_path):
    from gauss_tpu_torch.cli import gauss_external

    path = tmp_path / "e.jsonl"
    rc, out = _run(gauss_external.main, [
        str(jax_streams["dat"]), "--debug", "--device", "cpu",
        "--metrics-out", str(path)])
    assert rc == 0
    assert "DEBUG: parsed header n=48, nnz=2304" in out
    assert "DEBUG: partial pivoting moved" in out
    events = _assert_same_stream(path, jax_streams["external"][0])
    spans = {ev["name"] for ev in events if ev["type"] == "span"}
    assert {"parse_dat", "manufacture_rhs", "verify"} <= spans
    errors = [ev["max_rel_error"] for ev in events
              if ev["type"] == "health" and "max_rel_error" in ev]
    err = float(re.search(r"Error: (\S+)", out).group(1))
    assert errors == [pytest.approx(err, rel=1e-5, abs=1e-12)]


def test_matmul_stream_matches_jax(jax_streams, tmp_path):
    from gauss_tpu_torch.cli import matmul

    path = tmp_path / "mm.jsonl"
    rc, out = _run(matmul.main, ["64", "--engines", "cuda", "--device",
                                 "cpu", "--metrics-out", str(path)])
    assert rc == 0
    events = _assert_same_stream(path, jax_streams["matmul"][0])
    spans = {ev["name"] for ev in events if ev["type"] == "span"}
    assert spans == {"prepare_inputs", "compile:matmul_warmup:cuda",
                     "verify", "matmul:cuda"}
    (health,) = [ev for ev in events if ev["type"] == "health"]
    assert health["verified"] is True and health["max_rel_diff"] < 1e-4


@pytest.mark.parametrize("key", ["internal", "external", "matmul"])
def test_cpu_stream_says_cpu(jax_streams, tmp_path, key):
    """A --device cpu stream records the device in its config event and
    backend "cpu" in its fingerprint, and the run starts no CUDA
    context."""
    import torch

    from gauss_tpu_torch.cli import gauss_external, gauss_internal, matmul

    path = tmp_path / "c.jsonl"
    main, argv = {
        "internal": (gauss_internal.main, ["-s", "32", "--verify"]),
        "external": (gauss_external.main, [str(jax_streams["dat"])]),
        "matmul": (matmul.main, ["32", "--engines", "cuda"]),
    }[key]
    assert _run(main, [*argv, "--device", "cpu", "--metrics-out",
                       str(path)])[0] == 0
    events, _, _ = _stream(path)
    (config,) = [ev for ev in events if ev["type"] == "config"]
    assert config["device"] == "cpu"
    assert events[0]["type"] == "run_start"
    assert events[0]["backend"] == "cpu" and "device_kind" not in events[0]
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("key", ["internal", "external", "matmul"])
def test_both_summarizers_render_both_streams(jax_streams, tmp_path, key):
    """One stream, both summarizers: the same flat profile and health
    sections; each package's stream renders under the other's."""
    from gauss_tpu_torch.cli import gauss_external, gauss_internal, matmul

    path = tmp_path / "p.jsonl"
    main, argv = {
        "internal": (gauss_internal.main, ["-s", "32", "--phase-profile"]),
        "external": (gauss_external.main, [str(jax_streams["dat"])]),
        "matmul": (matmul.main, ["32", "--engines", "cuda"]),
    }[key]
    assert _run(main, [*argv, "--device", "cpu", "--metrics-out",
                       str(path)])[0] == 0
    for stream in (path, jax_streams[key][0]):
        events = tobs.read_events(stream)
        rid = events[0]["run"]
        js = jsummarize.run_summary(events, rid)
        ts = tsummarize.run_summary(events, rid)
        for section in ("profile", "health", "reported", "compile"):
            assert ts[section] == js[section], (stream, section)
        jt = jsummarize.summarize_events(events)
        tt = tsummarize.summarize_events(events)
        for head in ("flat profile (leaf spans):", "numerical health:"):
            assert _section(tt, head) == _section(jt, head) != []
        assert tsummarize.main([str(stream)]) == 0
        assert jsummarize.main([str(stream)]) == 0


def _section(text, head):
    lines = text.splitlines()
    start = lines.index(head)
    end = next((i for i in range(start, len(lines)) if not lines[i]),
               len(lines))
    return lines[start:end]


def test_sparse_check_metrics_out(tmp_path):
    from gauss_tpu_torch.sparse import check

    path = tmp_path / "s.jsonl"
    rc, out = _run(check.main, ["--skip-giant", "--device", "cpu",
                                "--repeats", "2", "--metrics-out",
                                str(path)])
    assert rc == 0, out
    events, spans, _ = _stream(path)
    assert spans == {"sparse_check_smoke"}
    solves = [ev for ev in events if ev["type"] == "sparse_solve"]
    # The routed leg's CG rung first, then each method's repeats.
    assert [ev["method"] for ev in solves] == (
        ["cg"] * 3 + ["gmres"] * 2 + ["bicgstab"] * 2)
    assert all(ev["converged"] and ev["n"] == 640 for ev in solves)
    (routed,) = [ev for ev in events if ev["type"] == "structure_solve"]
    assert routed["engine"] == "cg" and not routed["demoted"]
    counters = {ev["name"]: ev["value"] for ev in events
                if ev["type"] == "metric" and ev["kind"] == "counter"}
    assert counters == {"sparse.solves": 7, "structure.solves": 1}
    assert events[0]["tool"] == "sparse_check" and events[0]["seed"] == 258458


def test_internal_trace_on_cpu_writes_json(tmp_path):
    from gauss_tpu_torch.cli import gauss_internal

    d = tmp_path / "trace"
    rc, out = _run(gauss_internal.main, ["-s", "32", "--device", "cpu",
                                         "--trace", str(d)])
    assert rc == 0 and f"Device trace written to {d}" in out
    (f,) = list(d.iterdir())
    data = json.loads(f.read_text())
    assert any(ev.get("cat") == "cpu_op" for ev in data["traceEvents"])


def test_phase_profile_note_on_other_backends(capsys):
    from gauss_tpu_torch.cli import gauss_internal

    assert gauss_internal.main(["-s", "32", "--backend", "cuda-unblocked",
                                "--phase-profile", "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert ("Note: --phase-profile applies to the cuda backend only "
            "(got 'cuda-unblocked')") in captured.err
    assert "Solver phase profile" not in captured.out


def _shape(text):
    return [re.sub(r"[-+]?\d[\d.]*(e[-+]\d+)?", "<num>", line)
            for line in text.strip().splitlines()]


@pytest.mark.parametrize("cli,argv,lines", [
    ("gauss_internal", ["-s", "64", "--verify"], [
        "Computing Gaussian elimination: size <num> x <num>, backend cuda, "
        "threads/shards <num>",
        "Application time: <num> Secs",
        "Verification: solution pattern (<num>, <num>, <num>) OK",
        "Residual ||Ax-b||: <num>"]),
    ("gauss_external", ["gen.dat"], [
        "Matrix gen.dat: <num> x <num>, backend cuda",
        "Time: <num> seconds",
        "Error: <num>"]),
    ("matmul", ["64", "--engines", "cuda,cuda-kernel"], [
        "CUDA time: <num> seconds (<num> GFLOP/s) verify: OK",
        "CUDA-Kernel time: <num> seconds (<num> GFLOP/s) verify: OK"]),
])
def test_unobserved_run_is_unchanged(cli, argv, lines, tmp_path,
                                     monkeypatch):
    """No telemetry flag: no recorder is active, the health reductions
    never run, nothing is written, and the output lines are the ones the
    CLIs printed before the telemetry flags existed."""
    import importlib

    from gauss_tpu_torch.obs import health, registry

    mod = importlib.import_module(f"gauss_tpu_torch.cli.{cli}")
    monkeypatch.chdir(tmp_path)
    datfile.write_dat("gen.dat", synthetic.generator_matrix(32))
    before = sorted(p.name for p in tmp_path.iterdir())

    def boom(*a, **k):
        raise AssertionError("telemetry ran on an unobserved run")

    # No recorder is created, and no health monitor reduces anything.
    monkeypatch.setattr(registry.Recorder, "__init__", boom)
    for name in ("solution_health", "residual_health", "factor_health"):
        monkeypatch.setattr(health, name, boom)
    rc, out = _run(mod.main, [*argv, "--device", "cpu"])
    assert rc == 0
    assert _shape(out) == lines
    assert sorted(p.name for p in tmp_path.iterdir()) == before


def test_chip_smoke_telemetry_phase_rehearsal(monkeypatch, tmp_path):
    """chip_smoke.py's telemetry phase on the CPU at a small size: every
    CLI run, stream, trace and bit-for-bit check of the phase end to end
    (no kernel launches here, so every launch count is 0)."""
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "N", 128)
    monkeypatch.setattr(chip_smoke, "REPO", str(tmp_path))
    dat = tmp_path / "gen.dat"
    datfile.write_dat(dat, synthetic.generator_matrix(128))
    buf = io.StringIO()
    with redirect_stdout(buf):
        launches, out = chip_smoke.phase_telemetry(str(dat))
    assert not any(launches.values())
    assert set(out["phase_share"]) == set(chip_smoke.PHASES)
    assert abs(sum(out["phase_share"].values()) - 1.0) < 1e-9
    assert len(out["application_time_s"]["no_flags"]) == 3
    assert out["traced_solve"]["busy_ms"] == 0.0
    text = buf.getvalue()
    assert "bit for bit" in text and '{"telemetry": ' in text

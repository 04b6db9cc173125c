"""The port's telemetry core (``gauss_tpu_torch.obs``) and its profiling
utilities against the JAX package's: the same event stream from the same
calls, the same health monitors on the same factors, the same summaries,
and the phase-instrumented blocked factorization."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu import obs as jobs
from gauss_tpu.core import blocked as jb
from gauss_tpu.obs import registry as jregistry
from gauss_tpu.obs import summarize as jsummarize
from gauss_tpu.utils import profiling as jprofiling
from gauss_tpu_torch import obs as tobs
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.core import convert
from gauss_tpu_torch.io import synthetic
from gauss_tpu_torch.obs import registry as tregistry
from gauss_tpu_torch.obs import summarize as tsummarize
from gauss_tpu_torch.obs import trace as ttrace
from gauss_tpu_torch.utils import profiling as tprofiling

# Keys whose values differ between two runs of the same calls: clocks, run
# ids and measured durations; and on run_start, where the run executed.
VOLATILE = {"t", "time_unix", "run", "dur_s", "wall_s", "compile_wall_s"}
ENVIRONMENT = (set(jregistry.ENV_FINGERPRINT_KEYS)
               | set(tregistry.ENV_FINGERPRINT_KEYS))
# Factor fields of the phased factorization across frameworks, relative to
# max |m| (tests/test_torch_blocked.py's tolerances).
TOL_FACTOR = 5e-5
TOL_MINPIV = 1e-5
# record_solve_health on a random seeded matrix, relative.
HEALTH_RTOL = 1e-5


def _script(obs, path):
    """One fixed sequence of obs calls; returns the recorder's run id."""
    with obs.run(metrics_out=str(path), tool="scripted", n=64) as rec:
        obs.emit("config", tool="scripted", n=64, backend="b")
        with obs.span("outer", n=64):
            with obs.span("inner"):
                obs.counter("c")
                obs.counter("c", 2)
            obs.record_span("measured", 0.25, backend="b")
            with obs.trace_context("req-1"):
                obs.emit("note", value=1.5)
                with obs.span("traced"):
                    pass
        with obs.compile_span("warm", n=64):
            obs.gauge("g", 3)
        obs.histogram("h", 1.0)
        obs.histogram("h", 3.0)
        obs.emit("reported_time", name="Application time", seconds=0.5)
        obs.emit("health", backend="b", nan=False, residual=float("nan"),
                 growth=float("inf"))
        assert obs.active() is rec and obs.current_trace() is None
    assert obs.active() is None
    return rec.run_id


def _normalized(events):
    out = []
    for ev in events:
        drop = VOLATILE | (ENVIRONMENT if ev["type"] == "run_start" else set())
        ev = {k: v for k, v in ev.items() if k not in drop}
        if str(ev.get("name", "")).startswith("span.") and (
                ev.get("kind") == "histogram"):
            ev = {k: v for k, v in ev.items()
                  if k not in ("min", "max", "mean", "p50")}
        out.append(ev)
    return out


def test_scripted_calls_give_the_jax_packages_events(tmp_path):
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jrun = _script(jobs, jpath)
    trun = _script(tobs, tpath)
    jev, tev = jobs.read_events(jpath), tobs.read_events(tpath)
    assert {ev["run"] for ev in jev} == {jrun}
    assert {ev["run"] for ev in tev} == {trun}
    assert _normalized(tev) == _normalized(jev)
    for ev in tev:
        if ev["type"] == "span":
            assert ev["dur_s"] >= 0
    # The port's environment keys, read without starting CUDA.
    start = tev[0]
    assert start["type"] == "run_start" and start["torch"] == torch.__version__
    assert "jax" not in start


def test_hooks_are_no_ops_without_a_recorder(tmp_path):
    assert tobs.active() is None
    with tobs.span("x"):
        tobs.counter("c")
        tobs.gauge("g", 1)
        tobs.histogram("h", 1)
        tobs.record_span("y", 1.0)
        assert tobs.emit("e") is None
    with tobs.compile_span("w"):
        pass
    assert tobs.record_solve_health(x=np.ones(3)) is None
    assert jobs.record_solve_health(x=np.ones(3)) is None
    assert list(tmp_path.iterdir()) == []


def test_obs_surface_matches_the_jax_package():
    import gauss_tpu.obs as jpkg

    cost_and_collectives = {"collective_budget", "compiled_collective_budget",
                            "record_collective_budget", "cost_summary",
                            "record_cost", "record_vmem_estimate"}
    want = {n for n in dir(jpkg) if not n.startswith("_")
            and callable(getattr(jpkg, n))} - cost_and_collectives
    assert want <= set(tobs.__all__)


def _solve_case(kind, n):
    if kind == "internal":
        return synthetic.internal_matrix(n), synthetic.internal_rhs(n)
    if kind == "generator":
        a = synthetic.generator_matrix(n)
        return a, synthetic.manufactured_rhs(
            a, synthetic.manufactured_solution(n))
    rng = np.random.default_rng(258458 + n)
    return rng.standard_normal((n, n)), rng.standard_normal(n)


@pytest.mark.parametrize("kind,n", [("internal", 96), ("generator", 64),
                                    ("random", 100)])
def test_record_solve_health_matches_jax(kind, n):
    """Both packages' health event on one (a, x, b, factors): the JAX
    package's factors, carried to the port by core/convert.py."""
    a, b = _solve_case(kind, n)
    fj = jb.lu_factor_blocked_unrolled(jnp.asarray(a, jnp.float32), panel=32,
                                       panel_impl="pallas")
    x = np.asarray(jb.lu_solve(fj, jnp.asarray(b, jnp.float32)), np.float64)
    ft = convert.blocked_lu_from_numpy(*convert.blocked_lu_to_numpy(fj),
                                       device="cpu")
    with jobs.run():
        hj = jobs.record_solve_health(a=a, x=x, b=b, factors=fj, n=n,
                                      backend="tpu")
    with tobs.run():
        ht = tobs.record_solve_health(a=a, x=x, b=b, factors=ft, n=n,
                                      backend="cuda")
    assert set(ht) == set(hj) == {
        "nan", "inf", "max_abs_x", "residual", "rel_residual",
        "min_abs_pivot", "max_abs_pivot", "growth_factor",
        "loop_min_abs_pivot"}
    for key in ("nan", "inf"):
        assert ht[key] == hj[key]
    if kind == "random":
        for key in sorted(set(hj) - {"nan", "inf"}):
            np.testing.assert_allclose(ht[key], hj[key], rtol=HEALTH_RTOL,
                                       err_msg=key)
    else:
        assert ht == hj
        assert ht["min_abs_pivot"] > 0


def test_record_solve_health_without_recorder_reduces_nothing(monkeypatch):
    from gauss_tpu_torch.obs import health

    def boom(*a, **k):
        raise AssertionError("reduced without a recorder")

    monkeypatch.setattr(health, "factor_health", boom)
    a = np.eye(4)
    fac = tb.lu_factor_blocked_unrolled(a, panel=2, device="cpu")
    assert tobs.record_solve_health(a=a, x=np.ones(4), b=np.ones(4),
                                    factors=fac, n=4) is None


def test_phased_factor_matches_jax_and_the_unrolled_form():
    """The JAX package's phased factorization (panel kernel in interpret
    mode) against the port's at n=256, panel 64; the port's phased form
    equals its unrolled "pallas" form bit for bit, under every name that
    resolves to the panel kernel."""
    a = np.random.default_rng(256).standard_normal((256, 256)).astype(
        np.float32)
    pj, pt = jprofiling.PhaseTimer(emit=False), tprofiling.PhaseTimer()
    fj = jb.lu_factor_blocked_phased(jnp.asarray(a), panel=64,
                                     panel_impl="pallas", timer=pj)
    ft = tb.lu_factor_blocked_phased(a, panel=64, timer=pt, device="cpu")
    assert set(pt.seconds) == set(pj.seconds) == {
        "pad_stage", "panel_factor", "pivot_apply", "trailing_update"}
    np.testing.assert_array_equal(ft.perm.numpy(), np.asarray(fj.perm))
    scale = np.abs(np.asarray(fj.m)).max()
    for field in ("m", "linv", "uinv"):
        np.testing.assert_allclose(getattr(ft, field).numpy(),
                                   np.asarray(getattr(fj, field)), rtol=0,
                                   atol=TOL_FACTOR * scale)
    assert abs(float(ft.min_abs_pivot) - float(fj.min_abs_pivot)) <= (
        TOL_MINPIV * scale)
    fu = tb.lu_factor_blocked_unrolled(a, panel=64, panel_impl="pallas",
                                       device="cpu")
    for impl in ("auto", "fused", "pallas"):
        fp = tb.lu_factor_blocked_phased(a, panel=64, panel_impl=impl,
                                         device="cpu")
        assert all(torch.equal(x, y) for x, y in zip(fp, fu)), impl


@pytest.mark.parametrize("n,panel", [(100, 32), (64, 16)])
def test_phased_jax_route_and_padding(n, panel):
    a = np.random.default_rng(n).standard_normal((n, n)).astype(np.float32)
    fp = tb.lu_factor_blocked_phased(a, panel=panel, panel_impl="jax",
                                     device="cpu")
    fu = tb.lu_factor_blocked_unrolled(a, panel=panel, panel_impl="jax",
                                       device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(fp, fu))


def test_phased_spans_land_on_the_recorder(tmp_path):
    path = tmp_path / "p.jsonl"
    with tobs.run(metrics_out=str(path)):
        tb.lu_factor_blocked_phased(np.eye(64) * 2, panel=16, device="cpu")
    spans = [ev["name"] for ev in tobs.read_events(path)
             if ev["type"] == "span"]
    # 4 panels: one pad, 4 x (factor, pivots, update), the U inverses.
    assert spans.count("pad_stage") == 1
    assert spans.count("panel_factor") == spans.count("pivot_apply") == 4
    assert spans.count("trailing_update") == 5


def test_phase_timer_report_and_block_on_cpu():
    pt = tprofiling.PhaseTimer(emit=False)
    x = torch.ones(3)
    with pt.phase("a", block_on={"x": x, "y": [x, (x,)]}):
        pass
    with pt.phase("b", block_on=x):
        pass
    assert set(pt.seconds) == {"a", "b"}
    assert pt.report().splitlines()[0] == "  %time   seconds  phase"


def test_trace_on_cpu_writes_chrome_json(tmp_path):
    with tprofiling.trace(str(tmp_path / "d"), "cpu") as tr:
        torch.ones(64) @ torch.ones(64)
    assert tr.device_events == 0
    data = json.loads(open(tr.path).read())
    assert data["traceEvents"]
    with tprofiling.trace(None) as none:
        assert none is None


def test_summarize_sections_agree_on_one_stream(tmp_path):
    path = tmp_path / "s.jsonl"
    rid = _script(tobs, path)
    events = tobs.read_events(path)
    js, ts = (jsummarize.run_summary(events, rid),
              tsummarize.run_summary(events, rid))
    for key in ("profile", "health", "reported", "compile", "metrics"):
        assert ts[key] == js[key], key
    jt, tt = (jsummarize.summarize_events(events),
              tsummarize.summarize_events(events))
    for head in ("flat profile (leaf spans):", "numerical health:"):
        assert _section(tt, head) == _section(jt, head) != []
    assert tsummarize.main([str(path)]) == 0


def _section(text, head):
    lines = text.splitlines()
    start = lines.index(head)
    end = next((i for i in range(start, len(lines)) if not lines[i]),
               len(lines))
    return lines[start:end]


def test_chrome_trace_export_names_the_port(tmp_path):
    path = tmp_path / "s.jsonl"
    _script(tobs, path)
    tr = ttrace.to_chrome_trace(tobs.read_events(path))
    assert tr["otherData"]["source"] == "gauss_tpu_torch.obs.trace"
    names = {ev["name"] for ev in tr["traceEvents"] if ev["ph"] == "X"}
    assert {"outer", "inner", "measured", "compile:warm"} <= names
    assert ttrace.main([str(path), "-o", str(tmp_path / "t.json")]) == 0


# Fields of the JAX package's sparse_solve event, as
# gauss_tpu/sparse/solve.py:114-125 emits them (its sparse wrappers do not
# run under the JAX version here, so the list is held literally).
SPARSE_SOLVE_FIELDS = ["n", "nnz", "density", "certified_spd", "method",
                       "precond", "iterations", "converged", "rel_residual",
                       "residuals", "wall_s"]


def _spd_csr(n):
    from gauss_tpu_torch.sparse.csr import CsrMatrix

    rows, cols, vals = synthetic.sparse_coords(n, 6, seed=7)
    return CsrMatrix.from_coords(n, rows, cols, vals)


def test_sparse_solve_counters_and_event(tmp_path):
    from gauss_tpu_torch.sparse import solve_sparse
    from gauss_tpu_torch.sparse.krylov import IterativeStagnationError

    a = _spd_csr(200)
    b = np.random.default_rng(3).standard_normal(200)
    path = tmp_path / "sp.jsonl"
    with tobs.run(metrics_out=str(path)):
        res = solve_sparse(a, b, device="cpu")
        with pytest.raises(IterativeStagnationError):
            solve_sparse(a, b, method="gmres", maxiter=1, restart=2,
                         device="cpu")
    events = tobs.read_events(path)
    solves = [ev for ev in events if ev["type"] == "sparse_solve"]
    assert len(solves) == 2
    for ev in solves:
        assert sorted(set(ev) - {"type", "run", "seq", "t"}) == sorted(
            SPARSE_SOLVE_FIELDS)
    ok, stalled = solves
    assert ok["method"] == res.method == "cg" and ok["converged"] is True
    assert ok["iterations"] == res.iterations and ok["certified_spd"] is True
    assert ok["n"] == 200 and ok["nnz"] == a.nnz
    assert stalled["method"] == "gmres" and stalled["converged"] is False
    counters = {ev["name"]: ev["value"] for ev in events
                if ev["type"] == "metric" and ev["kind"] == "counter"}
    assert counters == {"sparse.solves": 1, "sparse.stagnations": 1}


def test_sparse_solve_unobserved_skips_the_certificate(monkeypatch):
    from gauss_tpu_torch.sparse import solve_sparse
    from gauss_tpu_torch.sparse.csr import CsrMatrix

    a = _spd_csr(120)
    b = np.ones(120)

    def boom(self):
        raise AssertionError("certificate computed for no reader")

    monkeypatch.setattr(CsrMatrix, "gershgorin_spd", boom)
    res = solve_sparse(a, b, method="bicgstab", device="cpu")
    assert res.converged


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode "
                    "(run `python -m pytest -m cuda tests/` or "
                    "`python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_phased_equals_unrolled_pallas_on_card(cuda_device):
    from gauss_tpu_torch.kernels import _build

    a = torch.as_tensor(np.random.default_rng(2048).standard_normal(
        (2048, 2048)), dtype=torch.float32, device=cuda_device)
    _build.reset_launches()
    fp = tb.lu_factor_blocked_phased(a, panel=256, device=cuda_device)
    torch.cuda.synchronize()
    # The panel kernel on its cluster route at every strip, nothing else.
    assert _build.LAUNCHES["panel_factor_cluster"] == 8
    assert sum(_build.LAUNCHES.values()) == 8
    fu = tb.lu_factor_blocked_unrolled(a, panel=256, panel_impl="pallas",
                                       device=cuda_device)
    assert all(torch.equal(x, y) for x, y in zip(fp, fu))


@pytest.mark.cuda
def test_trace_holds_each_kernel_launch(cuda_device, tmp_path):
    from gauss_tpu_torch.kernels import _build

    n = 2048
    a = synthetic.internal_matrix(n)
    b = synthetic.internal_rhs(n)
    tb.solve_refined(a, b, device=cuda_device)  # build and load
    _build.reset_launches()
    with tprofiling.trace(str(tmp_path), cuda_device) as tr:
        tb.solve_refined(a, b, device=cuda_device)
    events = json.loads(open(tr.path).read())["traceEvents"]
    kernels = [ev["name"] for ev in events if ev.get("cat") == "kernel"]
    assert tr.device_events >= len(kernels) > 0
    for name, symbol in (("panel_factor_cluster", "gtt_panel_cluster_kernel"),
                         ("panel_trailing_fused", "gtt_fused_kernel")):
        got = sum(1 for k in kernels if symbol in k)
        assert got == _build.LAUNCHES[name] > 0, name


@pytest.mark.cuda
def test_record_solve_health_on_card_equals_cpu(cuda_device):
    n = 512
    a, b = _solve_case("random", n)
    x, fac = tb.solve_refined(a, b, device=cuda_device)
    fac_cpu = convert.blocked_lu_from_numpy(
        *convert.blocked_lu_to_numpy(fac), device="cpu")
    with tobs.run():
        on_card = tobs.record_solve_health(a=a, x=x, b=b, factors=fac, n=n)
        on_cpu = tobs.record_solve_health(a=a, x=x, b=b, factors=fac_cpu,
                                          n=n)
    assert on_card == on_cpu

"""gauss_tpu_torch.outofcore — the host-streamed engine — against the JAX
package's ``gauss_tpu.outofcore`` on the same seeded numpy inputs (the
JAX side on the CPU), and against the port's own in-core chunked factor.

Mirrors ``tests/test_outofcore.py``: the factor against the in-core
chunked form (bit for bit in the port) and the JAX streamed factor (perm
exact, fields within TOL_FACTOR), the 1e-4 solve gate and the stream
accounting, the spans, multi-RHS, window sizing with the tuned consult,
admission, handoff routing (dtype-aware, the engine parameter, ``dist``
still typed), checkpoint resume (bit for bit, and across the packages
both ways), the mismatch typed, the ABFT rider (clean, and a tile
corruption localized to the JAX package's group), the recovery rung, the
serve lane, the tune axes and the CLI, and phase 11 of chip_smoke.py
rehearsed at small sizes. Pending, with ``obs/regress`` (ROADMAP
queue-1 item 11): the JAX cases ``test_bench_summary_ingest`` and
``test_committed_history_epochs``. The pipeline on the card, against the
CPU path, is tests/test_torch_outofcore_card.py."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu import obs as jobs
from gauss_tpu import outofcore as joc
from gauss_tpu.core import blocked as jb
from gauss_tpu.outofcore import stream as jstream
from gauss_tpu.resilience import inject as jinject
from gauss_tpu_torch import obs as tobs
from gauss_tpu_torch import outofcore as toc
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.outofcore import stream as tstream
from gauss_tpu_torch.resilience import inject as tinject

CPU = "cpu"
# tests/test_torch_chunked.py's tolerance: m, linv and uinv relative to
# max |m| (float32 factorizations in two frameworks).
TOL_FACTOR = 5e-5
FIELDS = ("m", "perm", "linv", "uinv")


@pytest.fixture
def rng():
    return np.random.default_rng(1349)


def _system(rng, n, k=None):
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n if k is None else (n, k))
    return a, b


def _bits_equal(f1, f2):
    return all(torch.equal(getattr(f1, k), getattr(f2, k)) for k in FIELDS)


def _close_to_jax(ft, fj):
    np.testing.assert_array_equal(ft.perm.numpy(), np.asarray(fj.perm))
    scale = float(np.abs(np.asarray(fj.m)).max())
    for field in ("m", "linv", "uinv"):
        np.testing.assert_allclose(
            getattr(ft, field).double().numpy(),
            np.asarray(getattr(fj, field), dtype=np.float64), rtol=0,
            atol=TOL_FACTOR * scale, err_msg=field)
    assert ft.min_abs_pivot == pytest.approx(fj.min_abs_pivot,
                                             rel=TOL_FACTOR)


@pytest.mark.parametrize("kind,impl", [("dominant", "auto"),
                                       ("random", "jax")])
def test_factor_matches_chunked_and_jax(rng, kind, impl):
    """The streamed factor IS the port's in-core chunked factor (the
    shared group step, the same right-of-group math per tile): bit for
    bit on the CPU; and the JAX package's streamed factor on the same
    input: the same pivots, every field within TOL_FACTOR."""
    n = 384
    a = (_system(rng, n)[0] if kind == "dominant"
         else rng.standard_normal((n, n)).astype(np.float32))
    ft = toc.lu_factor_outofcore(a, panel=64, chunk=2, ct=128,
                                 panel_impl=impl, device=CPU)
    ref = tb.lu_factor_blocked_chunked(a, panel=64, chunk=2,
                                       panel_impl=impl, device=CPU)
    assert _bits_equal(ft, ref)
    assert ft.min_abs_pivot == float(ref.min_abs_pivot)
    fj = joc.lu_factor_outofcore(a, panel=64, chunk=2, ct=128,
                                 panel_impl=impl)
    _close_to_jax(ft, fj)
    assert ft.m.shape == (n, n) and ft.device == "cpu"


def test_factor_bfloat16_matches_chunked(rng):
    """bfloat16 storage (the handoff's ``dtype``): bit for bit the port's
    chunked factor of the bfloat16 operand, float32 inverses."""
    n = 256
    a, _ = _system(rng, n)
    ft = toc.lu_factor_outofcore(a, panel=64, chunk=2, ct=64,
                                 dtype="bfloat16", device=CPU)
    ref = tb.lu_factor_blocked_chunked(
        torch.as_tensor(a, dtype=torch.bfloat16), panel=64, chunk=2,
        device=CPU)
    assert ft.m.dtype == torch.bfloat16 and ft.linv.dtype == torch.float32
    assert _bits_equal(ft, ref)


def test_solve_gate_and_stream_stats(rng):
    """The refined streamed solve lands far under the 1e-4 gate, and the
    accounting is coherent: the trailing region was tiled, the matrix
    went down and came back at least once, the ledger's peak stays under
    half the in-core working set and ends at 0 live bytes; the same
    counts as the JAX package's run."""
    n = 256
    a, b = _system(rng, n)
    x = toc.solve_outofcore(a, b, panel=64, chunk=1, ct=64, device=CPU)
    rel = np.linalg.norm(a @ x - b) / np.linalg.norm(b)
    assert rel < 1e-8
    s = toc.last_stream_stats()
    assert s.tiles >= 2 and s.groups == 4 and s.solves >= 2
    assert s.bytes_h2d >= n * n * 4
    assert s.bytes_d2h >= n * n * 4
    assert 0 < s.peak_device_bytes < 0.5 * 3 * n * n * 4
    assert s.live_device_bytes == 0
    assert 0.0 <= s.overlap_fraction <= 1.0
    assert s.stall_fraction == pytest.approx(1.0 - s.overlap_fraction)
    xj = joc.solve_outofcore(a, b, panel=64, chunk=1, ct=64)
    sj = joc.last_stream_stats()
    assert (s.groups, s.tiles, s.solves) == (sj.groups, sj.tiles, sj.solves)
    np.testing.assert_allclose(x, xj, rtol=1e-9, atol=1e-12)


def test_transfer_spans_recorded(rng):
    """The obs stream carries the transfer and stall spans and the final
    ``outofcore`` accounting event, under the JAX package's names."""
    n = 192
    a, b = _system(rng, n)
    with tobs.run() as rec:
        toc.solve_outofcore(a, b, panel=64, chunk=1, ct=64, iters=1,
                            device=CPU)
    spans = [e["name"] for e in rec.events if e["type"] == "span"]
    for name in ("outofcore.h2d", "outofcore.d2h", "outofcore.compute_wait",
                 "outofcore.solve"):
        assert name in spans, f"missing span {name}"
    oev = [e for e in rec.events if e["type"] == "outofcore"]
    done = [e for e in oev if e.get("event") == "solve_complete"]
    assert done and done[0]["peak_device_bytes"] > 0
    assert done[0]["tiles"] >= 2
    assert {e.get("event") for e in oev} >= {"factor_complete",
                                            "solve_complete"}


def test_multi_rhs(rng):
    n, k = 192, 3
    a, b = _system(rng, n, k)
    x = toc.solve_outofcore(a, b, panel=64, chunk=1, ct=64, device=CPU)
    assert x.shape == (n, k)
    np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-8,
                               atol=1e-8)


def test_window_sizing_and_tuned_consult(monkeypatch):
    """outofcore_window: the JAX package's ct from the budget fraction
    (a panel multiple, window + group block within the fraction), and a
    tuned store's ct short-circuits it."""
    from gauss_tpu_torch.tune import apply as tapply

    for n, panel, chunk, budget in ((4096, 128, 4, 64 * 2**20),
                                    (1000, 64, 2, 2**20),
                                    (32768, 128, 16, 68 * 2**30)):
        ct = toc.outofcore_window(n, panel, chunk, itemsize=4,
                                  budget=budget)
        assert ct == joc.outofcore_window(n, panel, chunk, itemsize=4,
                                          budget=budget)
        assert ct % panel == 0 and ct >= panel
    n, panel, chunk, budget = 4096, 128, 4, 64 * 2**20
    ct = toc.outofcore_window(n, panel, chunk, itemsize=4, budget=budget)
    workset = n * (chunk * panel + tstream.PIPELINE_TILE_BUFFERS * ct) * 4
    assert workset <= toc.OUTOFCORE_DEVICE_FRAC * budget
    monkeypatch.setattr(tapply, "override",
                        lambda op, n_, name, **kw: 512
                        if (op, name) == ("outofcore", "ct") else None)
    assert toc.outofcore_window(n, panel, chunk, device=CPU) == 512


def test_admission(monkeypatch):
    """outofcore_fits: host admission against the OS's memory, device
    admission against the budget fraction; the JAX package's verdicts."""
    for n, kw in ((512, {}), (4096, {"host_budget": 10**6}),
                  (1 << 20, {"budget": 10**6}),
                  (65536, {"host_budget": 2**40, "budget": 2**34})):
        assert toc.outofcore_fits(n, device=CPU, **kw) == joc.outofcore_fits(
            n, **kw), (n, kw)
    assert toc.outofcore_fits(512, device=CPU)
    monkeypatch.setattr(tstream, "host_memory_budget", lambda: 10**6)
    assert not toc.outofcore_fits(4096, device=CPU)


def _route_events(fn):
    with tobs.run() as rec:
        x = fn()
    return x, [e for e in rec.events if e["type"] == "route"]


def test_handoff_dtype_aware_routing(rng):
    """The estimate's itemsize comes from the requested dtype: a bfloat16
    request near the budget stays on the card where float32 streams; the
    route events equal the JAX package's (given no mesh to shard over)."""
    from gauss_tpu.dist.mesh import make_mesh

    n = 64
    a, b = _system(rng, n)
    budget = 3 * n * n * 3  # between the bf16 (2-byte) and f32 working sets
    cases = ((a, b, {"dtype": jnp.bfloat16, "iters": 6},
              {"dtype": "bfloat16", "iters": 6}, "single_chip", 2),
             (a, b, {}, {}, "outofcore", 4))
    for aa, bb, jkw, tkw, lane, itemsize in cases:
        with jobs.run() as rec:
            xj = jb.solve_handoff(aa, bb, budget=budget, mesh=make_mesh(1),
                                  **jkw)
        jr = [e for e in rec.events if e["type"] == "route"]
        xt, tr = _route_events(lambda: tb.solve_handoff(
            aa, bb, budget=budget, device=CPU, **tkw))
        keys = ("tool", "n", "lane", "est_bytes", "budget", "itemsize")
        assert [{k: e[k] for k in keys} for e in tr] == [
            {k: e[k] for k in keys} for e in jr]
        assert tr[-1]["lane"] == lane and tr[-1]["itemsize"] == itemsize
        np.testing.assert_allclose(xt, xj, rtol=1e-6, atol=1e-8)
    # An already-lowered operand keeps its own itemsize.
    a32 = a.astype(np.float32)
    _, tr = _route_events(lambda: tb.solve_handoff(
        a32, b.astype(np.float32), budget=3 * n * n * 4, device=CPU))
    assert tr[-1]["itemsize"] == 4 and tr[-1]["lane"] == "single_chip"


def test_handoff_engine_param(rng):
    n = 96
    a, b = _system(rng, n)
    x, tr = _route_events(lambda: tb.solve_handoff(a, b, engine="outofcore",
                                                   device=CPU))
    assert tr[-1]["lane"] == "outofcore"
    np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-8,
                               atol=1e-8)
    x16 = tb.solve_handoff(a, b, engine="outofcore", dtype="bfloat16",
                           iters=8, device=CPU)
    assert toc.last_stream_stats().groups >= 1
    np.testing.assert_allclose(x16, np.linalg.solve(a, b), rtol=1e-6,
                               atol=1e-8)
    with pytest.raises(ValueError, match="unknown handoff engine"):
        tb.solve_handoff(a, b, engine="warp")
    with pytest.raises(ValueError, match="do not apply"):
        tb.solve_handoff(a, b, engine="outofcore", unroll=True)
    from gauss_tpu_torch.dist import multihost

    try:
        xd = tb.solve_handoff(a, b, engine="dist", device=CPU)
    finally:
        multihost.shutdown()
    np.testing.assert_allclose(xd, np.linalg.solve(a, b), rtol=1e-8,
                               atol=1e-8)
    with pytest.raises(ValueError, match="do not apply"):
        tb.solve_handoff(a, b, engine="dist", panel_impl="jax")


def test_handoff_oversized_refused_when_the_host_cannot_admit(
        rng, monkeypatch):
    n = 96
    a, b = _system(rng, n)
    monkeypatch.setattr(tstream, "host_memory_budget", lambda: 10**3)
    with pytest.raises(ValueError, match="cannot admit"):
        tb.solve_handoff(a, b, budget=16, device=CPU)


@pytest.mark.parametrize("kind", ["dominant", "random"])
def test_checkpoint_resume_bit_identical(rng, tmp_path, monkeypatch, kind):
    """A streamed factorization killed between groups resumes from the
    checkpoint carry and finishes bit for bit an uninterrupted run; the
    files go on success. The random matrix pivots, so the retired blocks'
    rows realigned at each save keep following the later groups."""
    n = 256
    a = (_system(rng, n)[0] if kind == "dominant"
         else rng.standard_normal((n, n)).astype(np.float32))
    full = toc.lu_factor_outofcore(a, panel=64, chunk=1, ct=64, device=CPU)
    assert _bits_equal(full, tb.lu_factor_blocked_chunked(
        a, panel=64, chunk=1, device=CPU))
    ck = tmp_path / "giant.ckpt"
    orig = tstream._group_step
    calls = {"n": 0}

    def preempt(*args, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("preempted")
        return orig(*args, **kw)

    monkeypatch.setattr(tstream, "_group_step", preempt)
    with pytest.raises(RuntimeError, match="preempted"):
        toc.lu_factor_outofcore(a, panel=64, chunk=1, ct=64,
                                checkpoint_path=ck, device=CPU)
    monkeypatch.setattr(tstream, "_group_step", orig)
    assert ck.exists()
    fac = toc.lu_factor_outofcore(a, panel=64, chunk=1, ct=64,
                                  checkpoint_path=ck, device=CPU)
    assert _bits_equal(fac, full)
    assert not ck.exists()


@pytest.mark.parametrize("kind", ["dominant", "random"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(rng, tmp_path, writer, kind):
    """A checkpoint written by one package at the third group boundary
    (an ``outofcore.group`` raise plan in each package's own injector)
    resumes in the other: the same pivots as the reader's uninterrupted
    factor, every field within TOL_FACTOR of it (a pivoting matrix on the
    stock panel, which both packages name "jax")."""
    n = 256
    a = (_system(rng, n)[0] if kind == "dominant"
         else rng.standard_normal((n, n)).astype(np.float32))
    ck = tmp_path / "cross.ckpt"
    kw = dict(panel=64, chunk=1, ct=64,
              panel_impl="auto" if kind == "dominant" else "jax")
    if writer == "jax":
        with jinject.plan(jinject.FaultPlan.parse(
                "outofcore.group=raise:skip=2")):
            with pytest.raises(jinject.SimulatedFaultError):
                joc.lu_factor_outofcore(a, checkpoint_path=ck, **kw)
        assert ck.exists()
        got = toc.lu_factor_outofcore(a, checkpoint_path=ck, device=CPU,
                                      **kw)
        full = toc.lu_factor_outofcore(a, device=CPU, **kw)
        np.testing.assert_array_equal(got.perm.numpy(), full.perm.numpy())
        scale = float(full.m.abs().max())
        for f in ("m", "linv", "uinv"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       getattr(full, f).numpy(), rtol=0,
                                       atol=TOL_FACTOR * scale)
    else:
        with tinject.plan(tinject.FaultPlan.parse(
                "outofcore.group=raise:skip=2")):
            with pytest.raises(tinject.SimulatedFaultError):
                toc.lu_factor_outofcore(a, checkpoint_path=ck, device=CPU,
                                        **kw)
        assert ck.exists()
        got = joc.lu_factor_outofcore(a, checkpoint_path=ck, **kw)
        full = joc.lu_factor_outofcore(a, **kw)
        np.testing.assert_array_equal(got.perm, full.perm)
        scale = float(np.abs(full.m).max())
        for f in ("m", "linv", "uinv"):
            np.testing.assert_allclose(getattr(got, f), getattr(full, f),
                                       rtol=0, atol=TOL_FACTOR * scale)
    assert not ck.exists()


def test_checkpoint_mismatch_typed(rng, tmp_path):
    """A checkpoint of a DIFFERENT operand is a typed mismatch, never a
    silently wrong factor."""
    from gauss_tpu_torch.resilience.checkpoint import CheckpointMismatchError

    n = 128
    a, _ = _system(rng, n)
    ck = tmp_path / "ooc.ckpt"
    toc.lu_factor_outofcore(a, panel=64, chunk=1, ct=64, checkpoint_path=ck,
                            keep=True, device=CPU)
    assert ck.exists()
    with pytest.raises(CheckpointMismatchError):
        toc.lu_factor_outofcore(a + 1.0, panel=64, chunk=1, ct=64,
                                checkpoint_path=ck, device=CPU)


def test_abft_clean_run(rng):
    """The rider changes no bit (the port's chunked ``abft=True`` factor)
    and finds no mismatch on a clean run: one entry per group, each under
    the JAX package's threshold, as the JAX package's run."""
    from gauss_tpu.resilience.abft import default_tol

    n = 256
    a, _ = _system(rng, n)
    fac = toc.lu_factor_outofcore(a, panel=64, chunk=1, ct=64, abft=True,
                                  device=CPU)
    assert fac.abft_err is not None and fac.abft_err.shape == (4,)
    tol = default_tol(256, np.float32, float(np.abs(a).max()))
    assert fac.abft_err.max() < tol
    ref = tb.lu_factor_blocked_chunked(a, panel=64, chunk=1, abft=True,
                                       device=CPU)
    assert _bits_equal(fac, ref)
    fj = joc.lu_factor_outofcore(a, panel=64, chunk=1, ct=64, abft=True)
    assert fj.abft_err.shape == fac.abft_err.shape and fj.abft_err.max() < tol


def test_abft_detects_tile_corruption(rng):
    """A corrupted trailing tile (site ``outofcore.tile``, the same plan
    in both packages) trips the per-tile identity: typed SDCDetectedError
    at the JAX package's group, and at the first column the plan's draw
    poisoned (the JAX package names no column)."""
    n = 384
    a, _ = _system(rng, n)
    spec = "outofcore.tile=nan:seed=7"
    kw = dict(panel=64, chunk=1, ct=256, abft=True)
    with jinject.plan(jinject.FaultPlan.parse(spec)):
        with pytest.raises(joc.SDCDetectedError) as ej:
            joc.lu_factor_outofcore(a, **kw)
    with tinject.plan(tinject.FaultPlan.parse(spec)):
        with pytest.raises(toc.SDCDetectedError) as et:
            toc.lu_factor_outofcore(a, device=CPU, **kw)
    assert et.value.group == ej.value.group >= 0
    assert et.value.err > 0 and ej.value.err > 0
    # The plan's draw on the first tile: group 0's, at column w = 64.
    with tinject.plan(tinject.FaultPlan.parse(spec)):
        probe = tinject.corrupt_operand("outofcore.tile",
                                        np.zeros((n, 256), np.float32))
    first = int(np.isnan(probe).any(axis=0).argmax())
    assert et.value.group == 0 and et.value.col == 64 + first


def test_recover_rung(rng):
    from gauss_tpu_torch.resilience import recover

    n = 96
    a, b = _system(rng, n)
    rr = recover.solve_resilient(a, b, rungs=("outofcore", "numpy_f64"),
                                 device=CPU)
    assert rr.rung == "outofcore" and rr.rung_index == 0
    np.testing.assert_allclose(rr.x, np.linalg.solve(a, b), rtol=1e-8,
                               atol=1e-8)


def test_recover_rung_escalates_on_sdc(rng):
    """An ABFT detection inside the rung escalates to the host tail, as a
    refused admission does; neither is a kernel fault."""
    from gauss_tpu_torch.resilience import recover

    n = 96
    a, b = _system(rng, n)

    def sdc(*args):
        raise toc.SDCDetectedError("injected", group=0, col=3)

    rungs = dict(recover._RUNG_FNS, outofcore=sdc)
    orig = recover._RUNG_FNS
    recover._RUNG_FNS = rungs
    try:
        rr = recover.solve_resilient(a, b, rungs=("outofcore", "numpy_f64"),
                                     device=CPU)
    finally:
        recover._RUNG_FNS = orig
    assert rr.rung == "numpy_f64"
    assert rr.escalations == [("outofcore", "exception:SDCDetectedError")]


def test_serve_outofcore_lane(rng):
    """ServeConfig(outofcore_handoff=True, device_budget=tiny): an
    oversized handoff request streams (lane ``outofcore``) and
    verifies."""
    from gauss_tpu_torch.serve.admission import ServeConfig
    from gauss_tpu_torch.serve.server import SolverServer

    n = 96
    a, b = _system(rng, n)
    srv = SolverServer(ServeConfig(ladder=(16, 32), outofcore_handoff=True,
                                   device_budget=1024, verify_gate=1e-4,
                                   device=CPU))
    with tobs.run() as rec:
        srv.start()
        try:
            res = srv.submit(a, b).result(timeout=120)
        finally:
            srv.stop()
    assert res.ok and res.lane == "outofcore"
    np.testing.assert_allclose(res.x, np.linalg.solve(a, b), rtol=1e-6,
                               atol=1e-6)
    routes = [e for e in rec.events if e["type"] == "route"
              and e.get("tool") == "serve_handoff"]
    assert routes and routes[0]["lane"] == "outofcore"


def test_tune_space_axes(monkeypatch):
    from gauss_tpu.tune import space as jspace
    from gauss_tpu_torch.tune import apply as tapply
    from gauss_tpu_torch.tune import space as tspace

    assert ([(a.name, a.seed, a.values(), a.sweep_default)
             for a in tspace.space_for("outofcore")]
            == [(a.name, a.seed, a.values(), a.sweep_default)
                for a in jspace.space_for("outofcore")])
    assert (tspace.OUTOFCORE_CT_SEED, tspace.OUTOFCORE_CHUNK_SEED,
            tspace.OUTOFCORE_DEVICE_FRAC_SEED) == (4096, 16, 0.25)
    assert tspace.seed_params("outofcore") == jspace.seed_params("outofcore")
    assert toc.OUTOFCORE_DEVICE_FRAC == joc.OUTOFCORE_DEVICE_FRAC
    seen = []

    def override(op, n, name, **kw):
        seen.append((op, name))
        return 2 if (op, name) == ("outofcore", "chunk") else None

    monkeypatch.setattr(tapply, "override", override)
    assert tstream._group_width(1000, 64, None, 4) == (64, 2)
    assert ("outofcore", "chunk") in seen


def test_check_cli_smoke(tmp_path, capsys):
    """The gate CLI end to end at micro sizes on the CPU: verifies,
    asserts boundedness and routing, writes the summary, whose records
    equal the JAX package's; ``--history`` appends them (stamped with the
    device) to the file named."""
    from gauss_tpu_torch.outofcore import check

    metrics = tmp_path / "ooc.jsonl"
    summary = tmp_path / "summary.json"
    rc = check.main(["--n", "256", "--panel", "64", "--ct", "64",
                     "--chunk", "1", "--routing-n", "96", "--seed", "7",
                     "--device", "cpu", "--metrics-out", str(metrics),
                     "--summary-json", str(summary)])
    assert rc == 0
    doc = json.loads(summary.read_text())
    assert doc["kind"] == "outofcore_bench" and doc["ok"]
    assert doc["smoke"]["verified"] and doc["smoke"]["streamed"]
    assert doc["smoke"]["bounded"] and doc["routing"]["verified"]
    events = tobs.read_events(metrics)
    assert any(e["type"] == "route" and e.get("lane") == "outofcore"
               for e in events)
    a, b = check._seeded_system(64, 7)
    from gauss_tpu.outofcore import check as jcheck

    aj, bj = jcheck._seeded_system(64, 7)
    assert np.array_equal(a, aj) and np.array_equal(b, bj)
    assert check.history_records(doc) == jcheck.history_records(doc)
    from gauss_tpu_torch.obs import regress

    hist = tmp_path / "h.jsonl"
    recs = regress.ingest_file(summary)
    assert regress.gate(recs, str(hist), True) == 0
    assert regress.load_history(hist) == recs
    assert {r["device"] for r in recs} == {"cpu"}
    capsys.readouterr()


def test_entry_points_default_to_the_card():
    """Without ``device=``, the entry points ask for CUDA, and raise where
    there is none (no quiet CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = np.eye(8)
    for fn in (lambda: toc.lu_factor_outofcore(a, panel=4),
               lambda: toc.solve_outofcore(a, np.ones(8), panel=4),
               lambda: tb.solve_handoff(a, np.ones(8), engine="outofcore")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


def test_jax_stream_module_untouched_contract():
    """The port's constants and its JAX twin's agree (window, host
    factor, residual blocks)."""
    for name in ("PIPELINE_TILE_BUFFERS", "OUTOFCORE_HOST_FACTOR",
                 "DEFAULT_HOST_BYTES", "RESIDUAL_ROW_BLOCK"):
        assert getattr(tstream, name) == getattr(jstream, name), name


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


def test_chip_smoke_outofcore_phase_rehearsal(monkeypatch):
    """Phase 11 end to end at small sizes on the CPU (the kernels' plain
    versions; launches 0 == the plan's 0): the check CLI, the streamed
    factor against the in-core one, the size-routed handoff past a budget
    made small, the riders (the tile fault at the planned group and
    column, the killed child resumed bit for bit), the rung and the
    service lane."""
    import io
    from contextlib import redirect_stdout

    from gauss_tpu_torch.tune import space as tspace

    cs = _chip_smoke()
    for name, value in (
            ("DEVICE", CPU), ("OOC_N", 512), ("OOC_CT", 128),
            ("OOC_BIG_N", 1000), ("OOC_RIDERS", (512, 64, 2, 128)),
            ("OOC_TILE_SKIP", 3), ("OOC_KILL_SKIP", 1),
            ("OOC_LADDER_N", 300), ("OOC_SERVE_N", 600),
            ("SERVE_LADDER", (32, 64)),
            ("OOC_CHECK_ARGS", ("--n", "256", "--panel", "64", "--ct", "64",
                                "--chunk", "1", "--routing-n", "96"))):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(tspace, "OUTOFCORE_CHUNK_SEED", 1)
    monkeypatch.setattr(tb, "DEFAULT_CHIP_BYTES", 11_000_000)
    buf = io.StringIO()
    with redirect_stdout(buf):
        launches, out = cs.phase_outofcore()
    assert not any(launches.values()) and out["launches"] == {}
    g = out["giant"]
    assert g["rel_residual"] <= 1e-4 and g["bits_equal_incore"]
    assert g["stream"]["tiles"] >= 2 and g["peak_frac"] < 0.5
    assert g["held"] and g["launches"]
    big = out["past_budget"]
    assert big["route"]["lane"] == "outofcore"
    assert big["held"]["panel"] >= 2 and big["launches"]  # chunk 1: no fused
    assert big["route"]["budget"] == 11_000_000
    rid = out["riders"]
    assert rid["clean_err_over_tol"] < 1.0 and rid["bits_equal_incore_abft"]
    # skip=3 at n=512, panel 64, chunk 2, ct 128: group 0 streams three
    # tiles (from columns 128, 256, 384), so the fourth is group 1's first.
    assert rid["tile_fault"]["group"] == 2
    assert 256 <= rid["tile_fault"]["col"] < 384
    assert rid["kill"]["next_group"] == 2
    assert out["ladder_service"]["service"]["lane"] == "outofcore"
    text = buf.getvalue()
    assert '{"outofcore": ' in text and "phase 11 (e)" in text


@pytest.mark.parametrize("place,fails", [(2, True), (0, False)])
def test_held_launches_are_held_after_the_call(monkeypatch, place, fails):
    """Phase 11's recorder (``checked_launches`` with ``held`` and
    ``deferred``) on a streamed factor on the CPU: it holds the launches
    at ooc_held's places of the plan and times every launch by key; a
    kernel-2 launch that leaves a wrong block fails the run after the
    call has ended when its place is held, and passes unseen when it is
    not."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", CPU)
    n, panel, chunk = 384, 64, 2
    a = np.random.default_rng(3).standard_normal((n, n)).astype(np.float32)
    plan = cs.ooc_plan(n, panel, chunk)
    held = cs.ooc_held(plan, 2)
    assert held == {0, 1, 4, 5}  # the first group; each route's ends
    log = {}
    _, got = cs.held_ooc_launches(plan, held, log, lambda: (
        toc.lu_factor_outofcore(a, panel=panel, chunk=chunk, ct=128,
                                device=CPU)))
    assert got == cs.held_counts(plan, held) == {"fused": 2, "panel": 2}
    assert sum(r["launches"] for r in log.values()) == len(plan) == 6
    real, fused_calls, done = tb.panel_trailing_fused, [], []

    def wrong(block, col0, kbrow, *, panel, **kw):
        out = real(block, col0, kbrow, panel=panel, **kw)
        fused_calls.append(1)
        if len(fused_calls) == 2:  # the launch at place 2
            block[-1, -1] += 1.0
        return out

    def factor():
        toc.lu_factor_outofcore(a, panel=panel, chunk=chunk, ct=128,
                                device=CPU)
        done.append(True)

    monkeypatch.setattr(tb, "panel_trailing_fused", wrong)
    if fails:
        with pytest.raises(SystemExit, match="fused kernel at"):
            cs.held_ooc_launches(plan, {place}, {}, factor)
    else:
        cs.held_ooc_launches(plan, {place}, {}, factor)
    assert done == [True]


def test_strided_copy_needs_unit_column_stride():
    """The pipe's strided copy moves a window with unit column stride as
    it lies and refuses any other, so no contiguous temporary is made on
    the compute stream for a copy stream to race."""
    pipe = object.__new__(tstream._Pipe)
    with pytest.raises(ValueError, match="unit column stride"):
        pipe._copy2d(torch.empty(4, 8), torch.empty(8, 4).T, 2, None)
    with pytest.raises(ValueError, match="unit column stride"):
        pipe._copy2d(torch.empty(8, 4).T, torch.empty(4, 8), 1, None)


@pytest.mark.parametrize("skip", [0, 3])
def test_planned_tile_fault_is_where_both_packages_raise(rng, skip):
    """chip_smoke's ``planned_tile_fault`` (which phase 11 (d) holds the
    card's detection to) names the group the JAX package raises at and
    the column the port raises at, for the same plan."""
    n = 384
    a, _ = _system(rng, n)
    spec = f"outofcore.tile=nan:seed=7:skip={skip}"
    kw = dict(panel=64, chunk=1, ct=128, abft=True)
    with jinject.plan(jinject.FaultPlan.parse(spec)):
        with pytest.raises(joc.SDCDetectedError) as ej:
            joc.lu_factor_outofcore(a, **kw)
    with tinject.plan(tinject.FaultPlan.parse(spec)):
        with pytest.raises(toc.SDCDetectedError) as et:
            toc.lu_factor_outofcore(a, device=CPU, **kw)
    want = _chip_smoke().planned_tile_fault(n, 64, 1, 128, spec)
    assert (ej.value.group, et.value.col) == want
    assert et.value.group == ej.value.group

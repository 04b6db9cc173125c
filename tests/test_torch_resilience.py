"""The port's resilience layer (``gauss_tpu_torch.resilience``) against the
JAX package's on the CPU: fault plans parse and fire alike, operand
corruption writes the same bytes, and the recovery ladder takes the same
rungs with the same ``recovery`` events on the same systems. Kernel build
and launch errors are re-raised, and unported rungs are refused before the
ladder runs."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu import obs as jobs
from gauss_tpu.resilience import inject as jinject
from gauss_tpu.resilience import recover as jrecover
from gauss_tpu_torch import obs as tobs
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.resilience import inject as tinject
from gauss_tpu_torch.resilience import recover as trecover

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _system(rng, n, k=None):
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    b = rng.standard_normal(n) if k is None else rng.standard_normal((n, k))
    return a, b


def _specs(plan):
    return [dataclasses.asdict(s) for s in plan.specs]


# --- inject --------------------------------------------------------------

PLANS = (
    '{"seed": 7, "faults": [{"site": "core.blocked.factor", "kind": "nan", '
    '"p": 0.5, "max_triggers": 2}, {"site": "serve.cache.compile", '
    '"kind": "compile_fail", "skip": 1}]}',
    "a.site=inf:p=0.25:max=3:skip=1;b.site=delay:param=0.5",
    "core.blocked.factor=nan:p=1:max=1",
    "structure.detect=mistag:param=1:seed=4",
)


@pytest.mark.parametrize("text", PLANS)
def test_plan_parses_as_the_reference_does(text):
    j, t = jinject.FaultPlan.parse(text), tinject.FaultPlan.parse(text)
    assert t.seed == j.seed and _specs(t) == _specs(j)
    assert tinject.FaultPlan.from_env({"GAUSS_FAULTS": text}).seed == j.seed


@pytest.mark.parametrize("bad", ["", "siteonly", "a=notakind",
                                 "a=nan:bogus=1", "a=nan:p=2"])
def test_bad_plans_are_refused_alike(bad):
    with pytest.raises(ValueError):
        jinject.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        tinject.FaultPlan.parse(bad)


def _poll_run(mod):
    spec = mod.FaultSpec
    plan = mod.FaultPlan([
        spec(site="s1", kind="nan", p=0.5, max_triggers=None, seed=4),
        spec(site="s1", kind="inf", p=0.3, max_triggers=5, seed=1),
        spec(site="s2", kind="raise", p=0.7, max_triggers=3, skip=2),
        spec(site="s3", kind="bitflip", p=1.0, max_triggers=None, skip=7)],
        seed=9)
    fired = []
    with mod.plan(plan) as ap:
        for _ in range(50):
            for site in ("s1", "s2", "s3", "unplanned"):
                sp = mod.poll(site)
                fired.append((site, None if sp is None else sp.kind))
        return fired, ap.stats()


def test_fifty_polls_per_site_fire_identically():
    f_jax, s_jax = _poll_run(jinject)
    f_port, s_port = _poll_run(tinject)
    assert f_port == f_jax and s_port == s_jax
    assert s_port["polls"] == {"s1": 50, "s2": 50, "s3": 50,
                               "unplanned": 50}


def _corrupt(mod, a, kind, draws=3, **kw):
    plan = mod.FaultPlan([mod.FaultSpec(site="s", kind=kind, seed=3,
                                        max_triggers=None, **kw)], seed=11)
    with mod.plan(plan):
        return [mod.corrupt_operand("s", a, panel=8) for _ in range(draws)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", tinject.CORRUPT_KINDS)
def test_corrupt_operand_writes_the_reference_bytes(kind, dtype):
    a = np.random.default_rng(5).standard_normal((40, 36)).astype(dtype)
    orig = a.copy()
    want = _corrupt(jinject, a, kind)
    got_np = _corrupt(tinject, a, kind)
    t = torch.from_numpy(a.copy())
    got_t = _corrupt(tinject, t, kind)
    for w, g, gt in zip(want, got_np, got_t):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        assert g.tobytes() == w.tobytes()
        assert isinstance(gt, torch.Tensor) and gt.dtype == t.dtype
        assert gt is not t and gt.numpy().tobytes() == w.tobytes()
    np.testing.assert_array_equal(a, orig)  # never written in place
    np.testing.assert_array_equal(t.numpy(), orig)


@pytest.mark.parametrize("kind", tinject.CORRUPT_KINDS)
def test_corrupt_operand_bfloat16_bits_match(kind):
    """A bfloat16 tensor corrupts as the JAX package's bfloat16 array."""
    a = np.random.default_rng(6).standard_normal((24, 20)).astype(np.float32)
    ja = np.asarray(jnp.asarray(a, jnp.bfloat16))
    want = _corrupt(jinject, ja, kind, param=1e-3)
    tt = torch.from_numpy(a).to(torch.bfloat16)
    orig = tt.clone()
    got = _corrupt(tinject, tt, kind, param=1e-3)
    for w, g in zip(want, got):
        assert g.dtype == torch.bfloat16
        assert (g.view(torch.int16).numpy().tobytes()
                == np.asarray(w).view(np.int16).tobytes())
    assert torch.equal(tt.view(torch.int16), orig.view(torch.int16))


def test_no_plan_is_inert_and_plans_do_not_stack():
    assert not tinject.enabled()
    assert tinject.poll("anything") is None
    a, t = np.ones((4, 4)), torch.ones(4, 4)
    assert tinject.corrupt_operand("anything", a) is a
    assert tinject.corrupt_operand("anything", t) is t
    p = tinject.FaultPlan([tinject.FaultSpec(site="s", kind="nan")])
    with tinject.plan(p):
        assert tinject.enabled()
        with pytest.raises(RuntimeError, match="already installed"):
            tinject.install(p)
        # Values without data pass through (the trigger still counts).
        meta = torch.empty((4, 4), device="meta")
        assert tinject.corrupt_operand("s", meta) is meta
    assert not tinject.enabled()


def test_fault_events_go_to_the_port_stream():
    with tobs.run() as rec:
        with tinject.plan(tinject.FaultPlan.parse("s=nan:max=2")):
            for _ in range(3):
                tinject.poll("s")
    faults = [e for e in rec.events if e["type"] == "fault"]
    assert [(e["site"], e["kind"], e["seq"]) for e in faults] == [
        ("s", "nan", 1), ("s", "nan", 2)]


def test_env_var_installs_a_plan_in_a_subprocess():
    code = ("import sys\n"
            "from gauss_tpu_torch.resilience import inject\n"
            "assert inject.enabled()\n"
            "assert inject.active().plan.specs[0].site == 'w'\n"
            "assert not [k for k in sys.modules if k.split('.')[0] in "
            "('torch', 'jax', 'gauss_tpu')]\n"
            "inject.maybe_kill('w')\n"
            "raise SystemExit(99)\n")
    env = {**os.environ, "GAUSS_FAULTS": "w=kill"}
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == tinject.KILL_EXIT_CODE, r.stderr


# --- recover: the ladders --------------------------------------------------

def _ref_or_refused(fn_jax, fn_port, *args):
    want = fn_jax(*args)
    if set(want) & set(trecover.UNPORTED_RUNGS):
        with pytest.raises(trecover.RungNotPortedError) as ei:
            fn_port(*args)
        assert set(ei.value.rungs) == set(want) & set(
            trecover.UNPORTED_RUNGS)
        assert "queue-1 item" in str(ei.value)
        return None
    got = fn_port(*args)
    assert got == want
    return got


@pytest.mark.parametrize("lowered", [False, True])
@pytest.mark.parametrize("abft", [False, True])
@pytest.mark.parametrize("tag", ["spd", "banded", "blockdiag", "dense",
                                 "sparse"])
def test_structured_rungs_equal_the_reference(tag, abft, lowered):
    _ref_or_refused(jrecover.structured_rungs, trecover.structured_rungs,
                    tag, abft, lowered)


@pytest.mark.parametrize("abft", [False, True])
@pytest.mark.parametrize("engine", ["blocked", "rank1"])
def test_default_rungs_equal_the_reference(engine, abft):
    _ref_or_refused(jrecover.default_rungs, trecover.default_rungs,
                    engine, abft)


def test_unknown_tags_and_engines_are_valueerrors():
    with pytest.raises(ValueError):
        trecover.structured_rungs("wavelet")
    with pytest.raises(ValueError):
        trecover.default_rungs("bogus")


def _ladder(mod, obs_mod, a, b, plan_text=None, **kw):
    """(rung, rung_index, escalations, recovery events) of one solve, or
    the typed error's (type name, trigger, attempts, events)."""
    inj = jinject if mod is jrecover else tinject
    if mod is trecover:
        kw["device"] = CPU
    ctx = inj.plan(inj.FaultPlan.parse(plan_text)) if plan_text else None
    with obs_mod.run() as rec:
        try:
            if ctx is not None:
                with ctx:
                    res = mod.solve_resilient(a, b, **kw)
            else:
                res = mod.solve_resilient(a, b, **kw)
            out = (res.rung, res.rung_index,
                   [tuple(e) for e in res.escalations], res.x)
        except mod.UnrecoverableSolveError as e:
            out = (type(e).__name__, e.trigger,
                   [tuple(x) for x in e.attempts], None)
    events = [(e["rung"], e["trigger"], e["outcome"], e.get("rung_index"))
              for e in rec.events if e["type"] == "recovery"]
    return out, events


SCENARIOS = {
    "clean": (32, None, None, {}),
    "injected nan": (32, None, "core.blocked.factor=nan:max=1", {}),
    "near-zero pivot": (32, None, "core.blocked.factor=near_zero_pivot:max=1",
                        {}),
    "persistent, both engines": (
        24, None, "core.blocked.factor=inf:max=1000000;"
                  "core.gauss.solve=inf:max=1000000", {}),
    "rank1 engine": (24, None, "core.gauss.solve=nan:max=1",
                     {"engine": "rank1"}),
    "multi-rhs": (24, 3, "core.blocked.factor=nan:max=1000000", {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ladder_scenarios_match_the_reference(name):
    n, k, plan_text, kw = SCENARIOS[name]
    a, b = _system(np.random.default_rng(sorted(SCENARIOS).index(name)),
                   n, k)
    (jr, ji, je, jx), jev = _ladder(jrecover, jobs, a, b, plan_text, **kw)
    (tr, ti, te, tx), tev = _ladder(trecover, tobs, a, b, plan_text, **kw)
    assert (tr, ti, te) == (jr, ji, je)
    assert tev == jev
    assert tx.shape == b.shape
    assert np.linalg.norm(tx - jx) <= 1e-6 * np.linalg.norm(jx)
    assert np.linalg.norm(a @ tx - b) / np.linalg.norm(b) <= 1e-4


def test_singular_and_nonfinite_inputs_are_typed_alike():
    a = np.zeros((12, 12))
    a[0, :] = 1.0
    b = np.ones(12)
    (jn, jt, ja, _), jev = _ladder(jrecover, jobs, a, b)
    (tn, tt, ta, _), tev = _ladder(trecover, tobs, a, b)
    assert (tn, tt, ta) == (jn, jt, ja)
    assert tn in ("SingularSystemError", "UnrecoverableSolveError")
    assert [r for r, _ in ta] == ["blocked", "pivot_safe", "ds_refine",
                                  "rank1", "numpy_f64"]
    assert tev == jev
    a, b = _system(np.random.default_rng(1), 16)
    a[3, 5] = np.nan
    out_j, ev_j = _ladder(jrecover, jobs, a, b)
    out_t, ev_t = _ladder(trecover, tobs, a, b)
    assert out_t[:3] == out_j[:3] == ("UnrecoverableSolveError",
                                      "nonfinite_input", [])
    assert ev_t == ev_j and ev_t[-1][2] == "unrecoverable"


def test_bad_requests_are_valueerrors():
    a, b = _system(np.random.default_rng(2), 8)
    with pytest.raises(ValueError):
        trecover.solve_resilient(a[:4], b, device=CPU)
    with pytest.raises(ValueError):
        trecover.solve_resilient(a, b, rungs=("bogus",), device=CPU)


def _spy_rungs(monkeypatch, **fns):
    calls = []
    for name, fn in fns.items():
        def rung(*args, name=name, fn=fn):
            calls.append(name)
            return fn(*args)
        monkeypatch.setitem(trecover._RUNG_FNS, name, rung)
    return calls


@pytest.mark.parametrize("rungs", [("outofcore", "numpy_f64"),
                                   ("numpy_f64", "outofcore"),
                                   ("abft_chol", "abft", "outofcore")])
def test_unported_rungs_are_refused_before_any_rung_runs(monkeypatch, rungs):
    """``outofcore`` was the one unported rung; ported now, the ladder runs
    it wherever it stands: first it serves, after rungs that fail it
    serves in their place. ``UNPORTED_RUNGS`` is empty."""
    def fail(*args):
        raise RuntimeError("injected rung failure")

    head = rungs.index("outofcore")
    calls = _spy_rungs(monkeypatch, numpy_f64=fail if head else
                       trecover._rung_numpy, abft=fail, abft_chol=fail,
                       outofcore=trecover._rung_outofcore)
    a, b = _system(np.random.default_rng(3), 8)
    rr = trecover.solve_resilient(a, b, rungs=rungs, device=CPU)
    assert rr.rung == "outofcore" and rr.rung_index == head
    assert calls == list(rungs[:head + 1])
    np.testing.assert_allclose(rr.x, np.linalg.solve(a, b), rtol=1e-8,
                               atol=1e-10)
    assert trecover.UNPORTED_RUNGS == {}


def _cuda_error_without_class(msg):
    """torch's CUDA error as torch releases without ``AcceleratorError``
    raise it: a plain RuntimeError."""
    return RuntimeError(msg)


@pytest.mark.parametrize("err", [_build.KernelBuildError,
                                 _build.KernelLaunchError,
                                 torch.AcceleratorError,
                                 _cuda_error_without_class])
def test_kernel_errors_propagate_and_do_not_escalate(monkeypatch, err):
    """A kernel that fails to build or launch, or faults while it runs
    (torch's sticky CUDA error at the next sync), propagates: no rung after
    it is tried and no ``recovery`` event is emitted."""
    planted = err("CUDA error: an illegal memory access was encountered")
    assert isinstance(planted, RuntimeError)

    def broken(*args):
        raise planted

    calls = _spy_rungs(monkeypatch, blocked=broken,
                       numpy_f64=trecover._rung_numpy)
    a, b = _system(np.random.default_rng(4), 8)
    with tobs.run() as rec:
        with pytest.raises(RuntimeError, match="illegal memory") as got:
            trecover.solve_resilient(a, b, device=CPU)
    assert got.value is planted
    assert calls == ["blocked"]
    assert not [e for e in rec.events if e["type"] == "recovery"]


@pytest.mark.parametrize("err", [
    RuntimeError("a transient fault"),
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")])
def test_other_runtime_errors_still_escalate(monkeypatch, err):
    def flaky(*args):
        raise err

    _spy_rungs(monkeypatch, blocked=flaky)
    a, b = _system(np.random.default_rng(5), 8)
    res = trecover.solve_resilient(a, b, device=CPU)
    assert res.rung == "pivot_safe" and res.escalations == [
        ("blocked", f"exception:{type(err).__name__}")]


def test_the_nvcc_and_launch_paths_raise_the_typed_errors(monkeypatch):
    """The build's missing-nvcc path and the C-error check raise the typed
    subclasses (still RuntimeErrors, so existing catches hold)."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.find_nvcc()

    class Lib:
        @staticmethod
        def gtt_error_string(rc):
            return b"invalid argument"

    with pytest.raises(_build.KernelLaunchError, match="CUDA error 1"):
        _build.check(Lib, 1, "panel_factor")
    _build.check(Lib, 0, "panel_factor")

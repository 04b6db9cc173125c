"""The port's checkpointed chunked factorization
(``gauss_tpu_torch.resilience.checkpoint``) against the JAX package's
``resilience/checkpoint.py`` on the CPU: a run killed between groups (in
this process, and in a subprocess through ``GAUSS_FAULTS``) resumes bit for
bit; a different operand or statics, a torn file and two torn generations
are typed; and one file format crosses between the packages in both
directions. The same seeded float32 inputs go to both packages."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.core import blocked as jb
from gauss_tpu.resilience import checkpoint as jck
from gauss_tpu.resilience import inject as ji
from gauss_tpu_torch import obs as tobs
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.resilience import checkpoint as tck
from gauss_tpu_torch.resilience import inject as ti

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
# tests/test_torch_blocked.py's tolerance: factor fields relative to max |m|.
TOL_FACTOR = 5e-5
FIELDS = ("m", "perm", "min_abs_pivot", "linv", "uinv")


def _system(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a.astype(np.float32), rng.standard_normal(n)


def _bits_equal(f0, f1):
    for f in FIELDS:
        assert torch.equal(getattr(f0, f), getattr(f1, f)), f


def _close(ft, fj):
    """A port factor against a JAX one: pivots equal, values within
    TOL_FACTOR of max |m|."""
    np.testing.assert_array_equal(ft.perm.numpy(), np.asarray(fj.perm))
    scale = float(np.abs(np.asarray(fj.m)).max())
    for f in ("m", "linv", "uinv", "min_abs_pivot"):
        np.testing.assert_allclose(getattr(ft, f).numpy(),
                                   np.asarray(getattr(fj, f)), rtol=0,
                                   atol=TOL_FACTOR * scale, err_msg=f)


def _kill_at(inj, mod, a, path, skip, **kw):
    """Run ``mod``'s checkpointed factorization with a ``raise`` at the
    ``skip``-th group boundary: the in-process kill."""
    plan = inj.FaultPlan([inj.FaultSpec(
        site="checkpoint.group", kind="raise", max_triggers=1, skip=skip)])
    with inj.plan(plan):
        with pytest.raises(inj.SimulatedFaultError):
            mod.lu_factor_blocked_chunked_checkpointed(a, path, **kw)


def test_checkpoint_kill_resume_bit_identical(tmp_path):
    a, _ = _system(0, 96)
    kw = dict(panel=16, chunk=2, device=CPU)
    clean = tck.lu_factor_blocked_chunked_checkpointed(
        a, tmp_path / "clean.npz", **kw)
    assert not (tmp_path / "clean.npz").exists()  # removed on success
    _bits_equal(clean, tb.lu_factor_blocked_chunked(a, panel=16, chunk=2,
                                                    device=CPU))
    path = tmp_path / "killed.npz"
    with tobs.run() as rec:
        _kill_at(ti, tck, a, path, 2, **kw)
        assert path.exists()  # the carry survived the kill
        resumed = tck.lu_factor_blocked_chunked_checkpointed(a, path, **kw)
    assert not path.exists()
    _bits_equal(clean, resumed)
    evs = [e for e in rec.events if e["type"] == "checkpoint"]
    saves = [e for e in evs if e["event"] == "save"]
    assert [e["next_group"] for e in saves] == [2, 4]  # none after the last
    assert all(e["bytes"] > 96 * 96 * 4 for e in saves)
    (res,) = [e for e in evs if e["event"] == "resume"]
    assert res["next_group"] == 4
    # The JAX package's factor of the same operand at the same statics.
    _close(resumed, jck.lu_factor_blocked_chunked_checkpointed(
        a, tmp_path / "jax.npz", panel=16, chunk=2))


def test_checkpoint_mismatch_is_typed(tmp_path):
    a, _ = _system(1, 64)
    other, _ = _system(2, 64)
    path = tmp_path / "ck.npz"
    _kill_at(ti, tck, a, path, 1, panel=16, chunk=1, device=CPU)
    for mod, inj, kw in ((tck, ti, {"device": CPU}), (jck, ji, {})):
        # A different matrix, or different statics, refuses to resume.
        with pytest.raises(mod.CheckpointMismatchError):
            mod.lu_factor_blocked_chunked_checkpointed(
                other, path, panel=16, chunk=1, keep=True, **kw)
        with pytest.raises(mod.CheckpointMismatchError):
            mod.lu_factor_blocked_chunked_checkpointed(
                a, path, panel=16, chunk=2, keep=True, **kw)
    # resume=False ignores the stale file and recomputes from scratch.
    fac = tck.lu_factor_blocked_chunked_checkpointed(
        a, path, panel=16, chunk=1, resume=False, device=CPU)
    _bits_equal(fac, tb.lu_factor_blocked_chunked(a, panel=16, chunk=1,
                                                  device=CPU))


def test_checkpoint_corrupt_file_typed_and_prev_fallback(tmp_path):
    a, _ = _system(3, 96)
    path = tmp_path / "ck.npz"
    kw = dict(panel=16, chunk=1, every_panels=1, device=CPU)
    _kill_at(ti, tck, a, path, 3, **kw)
    prev = tmp_path / "ck.npz.prev"
    assert path.exists() and prev.exists()
    k_cur = tck.load_state(path)["meta"]["next_group"]
    assert tck.load_state(prev)["meta"]["next_group"] == k_cur - 1
    path.write_bytes(path.read_bytes()[:100])  # a torn write
    with pytest.raises(tck.CheckpointMismatchError, match="corrupt"):
        tck.load_state(path)
    with pytest.raises(jck.CheckpointMismatchError, match="corrupt"):
        jck.load_state(path)
    with tobs.run() as rec:
        resumed = tck.lu_factor_blocked_chunked_checkpointed(a, path, **kw)
    evs = [e for e in rec.events if e["type"] == "checkpoint"]
    assert [e for e in evs if e["event"] == "corrupt"]
    assert [e for e in evs if e["event"] == "fallback_prev"]
    (res,) = [e for e in evs if e["event"] == "resume"]
    assert res["next_group"] == k_cur - 1
    _bits_equal(resumed, tck.lu_factor_blocked_chunked_checkpointed(
        a, tmp_path / "clean.npz", **kw))
    assert not path.exists() and not prev.exists()  # success cleans both


def test_checkpoint_both_generations_corrupt_is_typed(tmp_path):
    a, _ = _system(4, 64)
    path = tmp_path / "ck.npz"
    _kill_at(ti, tck, a, path, 2, panel=16, chunk=1, every_panels=1,
             device=CPU)
    for p in (path, tmp_path / "ck.npz.prev"):
        p.write_bytes(b"not a checkpoint")
    with pytest.raises(tck.CheckpointMismatchError, match="corrupt"):
        tck.lu_factor_blocked_chunked_checkpointed(a, path, panel=16,
                                                   chunk=1, device=CPU)
    fac = tck.lu_factor_blocked_chunked_checkpointed(
        a, path, panel=16, chunk=1, resume=False, device=CPU)
    assert torch.isfinite(fac.m).all()


def test_subprocess_kill_resumes_bit_identical(tmp_path):
    """A real ``os._exit`` at the third group boundary
    (``GAUSS_FAULTS=checkpoint.group=kill:skip=2``) in a child process;
    this process resumes its file bit for bit."""
    a, _ = _system(5, 128)
    np.save(tmp_path / "a.npy", a)
    path = tmp_path / "ck.npz"
    code = ("import numpy as np; "
            "from gauss_tpu_torch.resilience import checkpoint as c; "
            f"a = np.load({str(tmp_path / 'a.npy')!r}); "
            f"c.lu_factor_blocked_chunked_checkpointed(a, {str(path)!r}, "
            "panel=16, chunk=2, device='cpu'); print('finished')")
    env = {**os.environ, "GAUSS_FAULTS": "checkpoint.group=kill:skip=2",
           "PYTHONPATH": str(REPO) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == ti.KILL_EXIT_CODE, r.stdout + r.stderr
    assert "finished" not in r.stdout
    assert tck.load_state(path)["meta"]["next_group"] == 4
    resumed = tck.lu_factor_blocked_chunked_checkpointed(
        a, path, panel=16, chunk=2, device=CPU)
    _bits_equal(resumed, tb.lu_factor_blocked_chunked(a, panel=16, chunk=2,
                                                      device=CPU))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    a, _ = _system(6, 96)
    path = tmp_path / "ck.npz"
    _kill_at(ji, jck, a, path, 1, panel=16, chunk=2)
    state = tck.load_state(path)
    assert state["meta"]["digest"] == tck._digest(a) == jck._digest(a)
    assert state["meta"]["next_group"] == 2
    with tobs.run() as rec:
        resumed = tck.lu_factor_blocked_chunked_checkpointed(
            a, path, panel=16, chunk=2, device=CPU)
    (res,) = [e for e in rec.events if e.get("event") == "resume"]
    assert res["next_group"] == 2
    _close(resumed, jb.lu_factor_blocked_chunked(jnp.asarray(a), panel=16,
                                                 chunk=2))
    # The first group's diagonal-block inverses are the JAX package's own.
    np.testing.assert_array_equal(resumed.linv[:2].numpy(),
                                  state["linvs"])


def test_port_checkpoint_resumes_in_the_jax_package(tmp_path):
    a, _ = _system(7, 96)
    path = tmp_path / "ck.npz"
    _kill_at(ti, tck, a, path, 2, panel=16, chunk=2, device=CPU)
    state = jck.load_state(path)
    assert sorted(state["meta"]) == sorted(
        ["schema", "n", "panel", "chunk", "panel_impl", "gemm_precision",
         "dtype", "digest", "next_group", "panels_done"])
    assert state["meta"]["schema"] == tck.SCHEMA == jck.SCHEMA
    assert state["perm"].dtype == np.int64
    resumed = jck.lu_factor_blocked_chunked_checkpointed(a, path, panel=16,
                                                         chunk=2)
    clean = tb.lu_factor_blocked_chunked(a, panel=16, chunk=2, device=CPU)
    _close(clean, resumed)
    np.testing.assert_array_equal(np.asarray(resumed.linv)[:4],
                                  state["linvs"])


def test_resolve_factor_routes_checkpoint_path(tmp_path):
    path = str(tmp_path / "c.npz")
    f = tb.resolve_factor(256, "auto", checkpoint_path=path, device=CPU)
    assert f.func is tck.lu_factor_blocked_chunked_checkpointed
    a, _ = _system(8, 64)
    _bits_equal(f(a, panel=16, device=CPU),
                tb.lu_factor_blocked_chunked(a, panel=16, device=CPU))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tb.resolve_factor(256, "auto", checkpoint_path=path, abft=True)
    # path=None is the plain chunked call: no hook polls, no file.
    plan = ti.FaultPlan.parse("checkpoint.group=raise")
    with ti.plan(plan) as ap:
        fac = tck.lu_factor_blocked_chunked_checkpointed(
            a, None, panel=16, chunk=2, device=CPU)
    assert ap.stats()["triggered"] == 0
    _bits_equal(fac, tb.lu_factor_blocked_chunked(a, panel=16, chunk=2,
                                                  device=CPU))

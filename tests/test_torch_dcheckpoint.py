"""The port's sharded coordinated checkpoint
(``gauss_tpu_torch.resilience.dcheckpoint``) against the JAX package's
``resilience/dcheckpoint.py`` on the CPU: the shard and manifest keys and
meta, the factor against the chunked form, assembly across a world
change, the fallback from a corrupt shard, an in-process kill between
groups, and a generation that crosses between the packages in both
directions. The same seeded float32 inputs go to both packages."""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.core import blocked as jb
from gauss_tpu.resilience import checkpoint as jck
from gauss_tpu.resilience import dcheckpoint as jdc
from gauss_tpu.resilience import inject as ji
from gauss_tpu_torch import obs as tobs
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.resilience import checkpoint as tck
from gauss_tpu_torch.resilience import dcheckpoint as tdc
from gauss_tpu_torch.resilience import inject as ti
from gauss_tpu_torch.verify import checks

CPU = "cpu"
# tests/test_torch_blocked.py's tolerance: factor fields relative to max |m|.
TOL_FACTOR = 5e-5
GATE = 1e-4
FIELDS = ("m", "perm", "min_abs_pivot", "linv", "uinv")
KW = dict(panel=16, chunk=1, barrier_deadline_s=30.0)


def _system(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a.astype(np.float32), rng.standard_normal(n)


def _meta(a32, n, panel=16, chunk=1):
    return {"schema": tck.SCHEMA, "n": n, "panel": panel, "chunk": chunk,
            "panel_impl": "auto", "gemm_precision": "highest",
            "dtype": "float32", "digest": tck._digest(a32)}


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


def _rel(a32, x, b):
    return checks.residual_norm(a32.astype(np.float64), x, b, relative=True)


def _port_solve(fac, b):
    x = tb.lu_solve(fac, torch.as_tensor(b, dtype=torch.float32))
    return x.numpy().astype(np.float64)


def _jax_solve(fac, b):
    x = jb.lu_solve(fac, jnp.asarray(b, jnp.float32))
    return np.asarray(x, np.float64)


def test_shard_and_manifest_keys_and_meta_equal_the_jax_packages(tmp_path):
    a, _ = _system(0, 48)
    ft, st = tdc.factor_sharded(a, tmp_path / "t", 0, 1, device=CPU, **KW)
    fj, sj = jdc.factor_sharded(a, str(tmp_path / "j"), 0, 1, **KW)
    assert st["resumed_from"] is None and st["gens_written"] == 3
    assert {k: st[k] for k in sj} == sj
    assert len(st["shard_write_s"]) == len(st["shard_bytes"]) == 3
    assert st["manifest_hash_s"] > 0 and min(st["shard_bytes"]) > 0
    meta = _meta(a, 48)
    gt, mt = tdc.last_good(str(tmp_path / "t"), meta)
    gj, mj = jdc.last_good(str(tmp_path / "j"), meta)
    assert gt == gj == 3
    assert mt.keys() == mj.keys()
    assert {k: mt[k] for k in mt if k != "shards"} == \
        {k: mj[k] for k in mj if k != "shards"}
    assert mt["shards"].keys() == mj["shards"].keys() == {"shard-00-of-01.npz"}
    shard = lambda root: os.path.join(tdc.gen_dir(str(root), 3),
                                      tdc.shard_name(0, 1))
    with np.load(shard(tmp_path / "t")) as zt, \
            np.load(shard(tmp_path / "j")) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        assert json.loads(bytes(zt["meta"]).decode()) == \
            json.loads(bytes(zj["meta"]).decode())
        assert zt["perm"].dtype == np.int64
        for k in ("blocks", "done_blocks"):
            np.testing.assert_array_equal(zt[k], zj[k])
        for k in zt.files:
            if k != "meta":
                assert zt[k].shape == zj[k].shape, k
    _close(ft, fj)
    assert tdc.owned_blocks(8, 1, 3) == jdc.owned_blocks(8, 1, 3) == [1, 4, 7]
    assert tdc.shard_name(3, 8) == jdc.shard_name(3, 8)
    assert tdc.gen_dir("d", 7) == jdc.gen_dir("d", 7)


@pytest.mark.parametrize("chunk", [1, 2])
def test_factor_bit_for_bit_the_chunked_form(tmp_path, chunk):
    a, b = _system(1, 64)
    fac, _ = tdc.factor_sharded(a, tmp_path, 0, 1, panel=16, chunk=chunk,
                                barrier_deadline_s=30.0, device=CPU)
    _bits_equal(fac, tb.lu_factor_blocked_chunked(a, panel=16, chunk=chunk,
                                                  device=CPU))
    assert _rel(a, _port_solve(fac, b), b) <= GATE


def test_assembly_across_a_world_change(tmp_path):
    """A carry checkpointed by TWO workers (threads in lockstep) restores
    onto ONE: the world-size-independent layout behind the shrink."""
    a, _ = _system(2, 64)
    d = str(tmp_path / "ck")
    facs = {}

    def run(w):
        facs[w], _ = tdc.factor_sharded(a, d, w, 2, panel=16, chunk=1,
                                        barrier_deadline_s=60.0, device=CPU)

    ts = [threading.Thread(target=run, args=(w,)) for w in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert sorted(facs) == [0, 1]
    _bits_equal(facs[0], facs[1])
    g, manifest = tdc.last_good(d, _meta(a, 64))
    assert g == 4 and manifest["world"] == 2
    assert sorted(manifest["shards"]) == ["shard-00-of-02.npz",
                                          "shard-01-of-02.npz"]
    fac1, stats = tdc.factor_sharded(a, d, 0, 1, panel=16, chunk=1,
                                     barrier_deadline_s=30.0, device=CPU)
    assert stats["resumed_from"] == 4 and stats["gens_written"] == 0
    _bits_equal(fac1, facs[0])
    # The JAX package assembles the same generation to the same carry.
    cj = jdc.load_carry(d, manifest, panel=16, npad=64)
    ct = tdc.load_carry(d, manifest, panel=16, npad=64)
    for k in ("m", "perm", "min_piv", "linvs", "uinvs", "next_group"):
        np.testing.assert_array_equal(ct[k], cj[k])


def test_corrupt_shard_falls_back_and_a_foreign_manifest_raises(tmp_path):
    a, _ = _system(3, 48)
    d = str(tmp_path / "ck")
    tdc.factor_sharded(a, d, 0, 1, device=CPU, **KW)
    gens = tdc._generations(d)
    assert len(gens) == tdc.KEEP_GENERATIONS == 2
    shard = os.path.join(tdc.gen_dir(d, gens[-1]), tdc.shard_name(0, 1))
    with open(shard, "r+b") as f:
        f.truncate(64)
    meta = _meta(a, 48)
    with tobs.run() as rec:
        g, _ = tdc.last_good(d, meta)
    assert g == gens[-2] == jdc.last_good(d, meta)[0]
    assert any(e["type"] == "checkpoint" and e.get("event") == "corrupt"
               for e in rec.events)
    with pytest.raises(tck.CheckpointMismatchError):
        tdc.last_good(d, dict(meta, digest="0" * 16))
    with pytest.raises(tck.CheckpointMismatchError, match="corrupt"):
        tdc._load_shard(shard)


def test_kill_between_groups_resumes_bit_for_bit(tmp_path):
    a, _ = _system(4, 64)
    clean, _ = tdc.factor_sharded(a, tmp_path / "clean", 0, 1, device=CPU,
                                  **KW)
    d = tmp_path / "killed"
    plan = ti.FaultPlan([ti.FaultSpec(site="fleet.worker.group",
                                      kind="raise", max_triggers=1, skip=2)])
    with ti.plan(plan):
        with pytest.raises(ti.SimulatedFaultError):
            tdc.factor_sharded(a, d, 0, 1, device=CPU, **KW)
    resumed, stats = tdc.factor_sharded(a, d, 0, 1, device=CPU, **KW)
    assert stats["resumed_from"] == 2 and stats["gens_written"] == 2
    _bits_equal(clean, resumed)


def _killed_jax(a, d):
    plan = ji.FaultPlan([ji.FaultSpec(site="fleet.worker.group",
                                      kind="raise", max_triggers=1, skip=2)])
    with ji.plan(plan):
        with pytest.raises(ji.SimulatedFaultError):
            jdc.factor_sharded(a, d, 0, 1, **KW)


def _killed_port(a, d):
    plan = ti.FaultPlan([ti.FaultSpec(site="fleet.worker.group",
                                      kind="raise", max_triggers=1, skip=2)])
    with ti.plan(plan):
        with pytest.raises(ti.SimulatedFaultError):
            tdc.factor_sharded(a, d, 0, 1, device=CPU, **KW)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_generation_resumes_in_the_other_package(tmp_path, writer):
    """A generation written by one package resumes in the other; both
    finish verified at 1e-4, their factor fields within TOL_FACTOR of the
    other package's uninterrupted factor, pivots equal."""
    a, b = _system(5, 48)
    d = str(tmp_path / "ck")
    fj_clean, _ = jdc.factor_sharded(a, str(tmp_path / "jc"), 0, 1, **KW)
    ft_clean, _ = tdc.factor_sharded(a, tmp_path / "tc", 0, 1, device=CPU,
                                     **KW)
    if writer == "jax":
        _killed_jax(a, d)
        fac, stats = tdc.factor_sharded(a, d, 0, 1, device=CPU, **KW)
        assert stats["resumed_from"] == 2
        _close(fac, fj_clean)
        assert _rel(a, _port_solve(fac, b), b) <= GATE
    else:
        _killed_port(a, d)
        fac, stats = jdc.factor_sharded(a, d, 0, 1, **KW)
        assert stats["resumed_from"] == 2
        _close(ft_clean, fac)
        assert _rel(a, _jax_solve(fac, b), b) <= GATE

"""Collective accounting (``gauss_tpu_torch.obs.collectives`` through the
engines' one wrapper, ``gauss_tpu_torch.dist.comm``) against the JAX
package's budgets: for each engine at a given (n, P, panel), the
``collective`` events a port solve records carry the counts, by kind, that
the JAX package derives from its traced program (``record_collective_budget``
on the conftest's 8 virtual CPU devices) — equal — and the same output
bytes where the two packages' dtypes agree (the conftest enables x64, so
the JAX row indices are int64, as the port's are).

Where the protocols differ: the 2-D per-row engine's solver returns x
column-sharded in the JAX package; the port gathers x along ``cols`` once
after the counted solve (one all_gather the JAX budget does not show,
issued outside the recorded budget), and ``matmul_dist`` on a 2-D mesh
gathers along ``cols`` and ``rows`` where XLA partitions its own way.
"""

import importlib

import numpy as np
import pytest

from gauss_tpu_torch import obs as tobs
from gauss_tpu_torch.dist import comm, launch
from gauss_tpu_torch.dist import gauss_dist as tgd
from gauss_tpu_torch.dist import gauss_dist2d as tg2
from gauss_tpu_torch.dist import gauss_dist_blocked as tgdb
from gauss_tpu_torch.dist import gauss_dist_blocked2d as tgb2
from gauss_tpu_torch.obs import collectives as tcoll

tmd = importlib.import_module("gauss_tpu_torch.dist.matmul_dist")


@pytest.fixture(scope="module")
def world():
    with launch.World(8, device="cpu") as w:
        yield w


def _system(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n)) + np.sqrt(n) * np.eye(n)
    return a.astype(np.float32), rng.standard_normal(n).astype(np.float32)


def _jax_budget(label, fn, *args, **kw):
    from gauss_tpu import obs

    with obs.run() as rec:
        np.asarray(fn(*args, **kw))
    return {ev["op"]: ev for ev in rec.events
            if ev["type"] == "collective" and ev["label"] == label}


def _port_budget(world, label, fn, *args, mesh, **kw):
    out = world.run(launch.recorded, fn, *args, mesh=mesh, **kw)
    size = int(np.prod(mesh))
    budgets = [{ev["op"]: ev for ev in events
                if ev["type"] == "collective" and ev["label"] == label}
               for _, events in out[:size]]
    assert all(b == budgets[0] or _same_counts(b, budgets[0])
               for b in budgets)
    return budgets[0]


def _same_counts(x, y):
    return {k: v["count"] for k, v in x.items()} == \
        {k: v["count"] for k, v in y.items()}


CASES = [("gauss_dist", "1d", (4,), 32, None),
         ("gauss_dist", "1d", (8,), 24, None),
         ("gauss_dist2d", "2d", (2, 2), 32, None),
         ("gauss_dist2d", "2d", (2, 4), 16, None),
         ("gauss_dist_blocked", "1d", (8,), 64, 8),
         ("gauss_dist_blocked", "1d", (2,), 96, 16),
         ("gauss_dist_blocked2d", "2d", (2, 2), 64, 8),
         ("gauss_dist_blocked2d", "2d", (4, 2), 64, 8)]


@pytest.mark.parametrize("label,kind,mesh,n,panel", CASES)
def test_counts_equal_the_jax_budget(world, label, kind, mesh, n, panel):
    from gauss_tpu.dist import gauss_dist as jgd
    from gauss_tpu.dist import gauss_dist2d as jg2
    from gauss_tpu.dist import gauss_dist_blocked as jgdb
    from gauss_tpu.dist import gauss_dist_blocked2d as jgb2
    from gauss_tpu.dist.mesh import make_mesh, make_mesh_2d

    a, b = _system(n)
    jm = make_mesh(*mesh) if kind == "1d" else make_mesh_2d(*mesh)
    kw = {} if panel is None else {"panel": panel}
    jfn, tfn = {"gauss_dist": (jgd.gauss_solve_dist, tgd.gauss_solve_dist),
                "gauss_dist2d": (jg2.gauss_solve_dist2d,
                                 tg2.gauss_solve_dist2d),
                "gauss_dist_blocked": (jgdb.gauss_solve_dist_blocked,
                                       tgdb.gauss_solve_dist_blocked),
                "gauss_dist_blocked2d": (jgb2.gauss_solve_dist_blocked2d,
                                         tgb2.gauss_solve_dist_blocked2d)
                }[label]
    want = _jax_budget(label, jfn, a, b, mesh=jm, **kw)
    got = _port_budget(world, label, tfn, a, b, mesh=mesh, **kw)
    assert want and set(got) == set(want)
    for op in want:
        assert got[op]["count"] == want[op]["count"], op
        assert got[op]["bytes"] == want[op]["bytes"], op
        assert got[op]["via"] == "issued" and want[op]["via"] == "jaxpr"
    if label == "gauss_dist_blocked":
        nblocks = -(-n // (panel * mesh[0])) * mesh[0]
        assert got["all_gather"]["count"] == nblocks       # ONE per panel
        assert got["psum"]["count"] == 2 * nblocks


def test_matmul_dist_budget(world):
    """1-D: the one output all_gather the JAX package finds in its HLO."""
    from gauss_tpu.dist.matmul_dist import matmul_dist as jmd
    from gauss_tpu.dist.mesh import make_mesh

    a = np.ones((32, 32), np.float32)
    want = _jax_budget("matmul_dist", jmd, a, a, mesh=make_mesh(4))
    got = _port_budget(world, "matmul_dist", tmd.matmul_dist, a, a,
                       mesh=(4,))
    assert {k: v["count"] for k, v in got.items()} == \
        {k: v["count"] for k, v in want.items()} == {"all_gather": 1}
    assert got["all_gather"]["bytes"] == want["all_gather"]["bytes"]
    got2 = _port_budget(world, "matmul_dist", tmd.matmul_dist, a, a,
                        mesh=(2, 2))
    assert got2["all_gather"]["count"] == 2


def test_dedup_counters_and_summary(tmp_path):
    """Two identical solves (a world of one in this process) record one
    budget (dedup by label and shapes); the counters carry it; both
    packages' summarizers fold the port's stream into the comms
    section."""
    from gauss_tpu.obs import summarize as jsum
    from gauss_tpu_torch.dist import multihost
    from gauss_tpu_torch.obs import summarize as tsum

    a, b = _system(64)
    path = tmp_path / "c.jsonl"
    try:
        with tobs.run(metrics_out=str(path)) as rec:
            for _ in range(2):
                tgdb.gauss_solve_dist_blocked(a, b, panel=8, device="cpu")
    finally:
        multihost.shutdown()
    evs = tobs.read_events(path)
    colls = [ev for ev in evs if ev["type"] == "collective"]
    assert sorted(ev["op"] for ev in colls) == ["all_gather", "pmin", "psum"]
    assert {ev["op"]: ev["count"] for ev in colls} == {
        "all_gather": 8, "psum": 16, "pmin": 2}
    assert rec.counters["collective.psum.count"] == 16
    for mod in (tsum, jsum):
        comms = mod.comms_summary(evs)
        assert comms["gauss_dist_blocked"]["count"] == 8 + 16 + 2
    assert "collective traffic" in tsum.summarize_run(evs, rec.run_id)


def test_counting_nests_and_tally_is_free_without_a_budget():
    tcoll.tally("psum", 8)        # no budget open: nothing to count into
    with tcoll.counting() as outer:
        tcoll.tally("psum", 8)
        with tcoll.counting() as inner:
            tcoll.tally("all_gather", 32)
    assert inner == {"all_gather": {"count": 1, "bytes": 32}}
    assert outer == {"psum": {"count": 1, "bytes": 8},
                     "all_gather": {"count": 1, "bytes": 32}}
    assert tcoll.record_collective_budget("x", outer) is None  # no run
    with tobs.run() as rec:
        got = tobs.record_collective_budget("x", outer, np.zeros(3))
        assert got == outer
        assert tobs.record_collective_budget("x", outer, np.zeros(3)) is None
    kinds = {ev["op"] for ev in rec.events if ev["type"] == "collective"}
    assert kinds == {"psum", "all_gather"}
    assert set(tcoll.COLLECTIVE_KINDS) >= kinds
    assert callable(comm.psum) and callable(comm.all_gather)

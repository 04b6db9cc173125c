"""The serving pieces the block-diagonal lane needs, against the JAX
package's on the CPU: the shape buckets byte for byte, the executable
cache (LRU, stats, the ``serve.cache.compile`` hook, the lanes not ported
refused typed), the block-diagonal solves through it (a uniform
partition is one entry and one batched-factor call; mixed partitions; the
batched blocked factor above one panel), and the batched panel kernel's plain
version against the per-member plain panel and against ``jax.vmap`` of
the JAX kernel in interpret mode. A ``cuda``-marked test holds the kernel
to its plain version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.kernels.panel_pallas import panel_factor_pallas
from gauss_tpu.serve import buckets as jbuckets
from gauss_tpu.structure import blockdiag as jblockdiag
from gauss_tpu_torch.io import synthetic
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.kernels import panel as kp
from gauss_tpu_torch.resilience import inject
from gauss_tpu_torch.serve import buckets, cache
from gauss_tpu_torch.structure import blockdiag

CPU = "cpu"
# The JAX kernel's rank-1 update is contracted into an FMA by XLA:CPU in
# interpret mode; the port's step loop rounds the product and the
# difference apart (tests/test_torch_panel.py holds the same bound).
TOL_PANEL = 5e-6


# --- buckets ---------------------------------------------------------------

def test_bucket_ladder_and_counts_equal_the_reference():
    assert buckets.DEFAULT_LADDER == jbuckets.DEFAULT_LADDER
    for n in (1, 2, 3, 100, 128, 129, 4096, 5000):
        assert buckets.bucket_for(n) == jbuckets.bucket_for(n)
        assert buckets.pow2_bucket(n) == jbuckets.pow2_bucket(n)
        assert buckets.pow2_bucket(n, cap=64) == jbuckets.pow2_bucket(
            n, cap=64)
    assert buckets.validate_ladder([256, 128, 128]) == \
        jbuckets.validate_ladder([256, 128, 128])
    for mod in (buckets, jbuckets):
        for bad in ([], [0, 4]):
            with pytest.raises(ValueError):
                mod.validate_ladder(bad)
        with pytest.raises(ValueError):
            mod.bucket_for(0)
        with pytest.raises(ValueError):
            mod.pow2_bucket(0)


@pytest.mark.parametrize("n,k,bucket,kb", [(5, None, 8, 1), (7, 3, 16, 4),
                                           (16, 2, 16, 2)])
def test_pad_and_unpad_are_byte_equal(n, k, bucket, kb):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n))
    b = rng.standard_normal(n) if k is None else rng.standard_normal((n, k))
    got, want = buckets.pad_system(a, b, bucket, kb), jbuckets.pad_system(
        a, b, bucket, kb)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    x = rng.standard_normal((bucket, kb))
    kk = 1 if k is None else k
    g = buckets.unpad_solution(x, n, kk, was_vector=k is None)
    w = jbuckets.unpad_solution(x, n, kk, was_vector=k is None)
    assert g.shape == w.shape and g.tobytes() == w.tobytes()
    for mod in (buckets, jbuckets):
        with pytest.raises(ValueError):
            mod.pad_system(a, b, n - 1)


# --- the batched panel kernel's plain version -------------------------------

def _stack(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape), dtype=torch.float32)


@pytest.mark.parametrize("shape,kb", [((3, 64, 64), 0), ((4, 48, 16), 8),
                                      ((1, 32, 32), 0)])
def test_batched_plain_is_the_per_member_plain_panel(shape, kb):
    p = _stack(shape, sum(shape))
    x = p.clone()
    got = kp.panel_factor_batched(p, kb)
    assert torch.equal(p, x)  # not modified
    for i in range(shape[0]):
        want = kp.panel_factor_plain(x[i], kb)
        for g, w in zip(got, want):
            assert torch.equal(g[i], w)
    # The permutation rule over a (B, h) stack equals the per-member one.
    _, _, inv, chosen, _, _ = kp.factor_steps_plain(x[0].T, kb)
    assert torch.equal(
        kp.perm_from_inv(inv[None], chosen[None], kb, shape[2])[0],
        kp.perm_from_inv(inv, chosen, kb, shape[2]))


def test_batched_against_vmapped_jax_kernel_in_interpret_mode():
    p = _stack((3, 64, 64), 7).numpy()
    jp = jax.vmap(lambda m: panel_factor_pallas(m, 0, interpret=True,
                                                seg=64))(jnp.asarray(p))
    jp = [np.asarray(o) for o in jp]
    got = [o.numpy() for o in kp.panel_factor_batched(torch.from_numpy(p))]
    np.testing.assert_array_equal(got[1], jp[1])  # ipiv
    np.testing.assert_array_equal(got[2], jp[2])  # perm
    scale = np.abs(jp[0]).max()
    np.testing.assert_allclose(got[0], jp[0], rtol=0, atol=TOL_PANEL * scale)
    np.testing.assert_allclose(got[3], np.asarray(jp[3]).reshape(-1),
                               rtol=0, atol=TOL_PANEL * scale)


def test_batched_argument_checks():
    with pytest.raises(ValueError, match="panel_factor_batched"):
        kp.panel_factor_batched(torch.zeros(8, 8))
    with pytest.raises(ValueError, match="panel_factor_batched"):
        kp.panel_factor_batched(torch.zeros(2, 8, 16))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode "
                    "(run `python -m pytest -m cuda tests/` or "
                    "`python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128, 128), (3, 512, 128),
                                   (5, 100, 16), (1, 256, 256)])
def test_batched_kernel_matches_plain_on_card(cuda_device, shape):
    """One launch per stack, each member bit for bit the plain panel, a
    one-member stack bit for bit the single-strip kernel."""
    x = _stack(shape, shape[1]).to(cuda_device)
    before = _build.LAUNCHES["panel_factor_batched"]
    got = kp.panel_factor_batched(x.clone())
    assert _build.LAUNCHES["panel_factor_batched"] == before + 1
    for g, w in zip(got, kp.panel_factor_batched_plain(x.clone())):
        assert torch.equal(g, w)
    one = kp.panel_factor_batched(x[:1].clone())
    for g, w in zip(one, kp.panel_factor(x[0].clone())):
        assert torch.equal(g[0], w)


@pytest.mark.cuda
def test_batched_route_is_reported_by_the_launcher(cuda_device):
    """A (128, 128) float32 member (64 KiB) is factored in shared memory,
    a (512, 128) one (256 KiB) in place in global memory."""
    assert kp.panel_batched_info(128, 128) == {"route": "smem",
                                               "smem_bytes": 65536}
    assert kp.panel_batched_info(512, 128) == {"route": "global",
                                               "smem_bytes": 0}


# --- the cache ---------------------------------------------------------------

def _key(bucket_n=16, batch=2, **kw):
    return cache.CacheKey(bucket_n=bucket_n, nrhs=1, batch=batch,
                          dtype=kw.pop("dtype", "float32"),
                          engine="blockdiag", refine_steps=1, **kw)


def test_cache_lru_stats_and_compile_hook():
    c = cache.ExecutableCache(capacity=2, device=CPU)
    e1 = c.get(_key(16))
    assert c.get(_key(16)) is e1
    c.get(_key(8))
    c.get(_key(32))  # evicts the least recently used, 16
    assert c.keys() == [_key(8), _key(32)]
    assert c.stats() == {"hits": 1, "misses": 3, "evictions": 1,
                         "entries": 2, "capacity": 2, "hit_rate": 0.25}
    plan = inject.FaultPlan.parse("serve.cache.compile=compile_fail:max=1")
    with inject.plan(plan):
        with pytest.raises(inject.SimulatedCompileError):
            c.get(_key(4))
        assert c.get(_key(4)).key == _key(4)  # the retry builds
    with pytest.raises(ValueError):
        cache.ExecutableCache(0)


def test_lanes_not_ported_are_refused_typed():
    """Only the sharded (mesh) lane is refused now; the lowered and spd
    lanes build (tests/test_torch_serve.py serves them)."""
    with pytest.raises(cache.LaneNotPortedError, match="item 11"):
        cache.BatchedExecutable(_key(mesh="batch"), device=CPU)
    for key in (_key(dtype="bfloat16"), _key(dtype="bf16x3"),
                _key(structure="spd")):
        assert cache.BatchedExecutable(key, device=CPU).key == key
    assert cache.storage_dtype("bf16x3") == torch.float32
    assert cache.storage_dtype("bfloat16") == torch.bfloat16
    with pytest.raises(ValueError):
        cache.storage_dtype("float16")


@pytest.fixture
def batched_calls(monkeypatch):
    calls = []
    real = kp.panel_factor_batched

    def spy(p, kb=0):
        calls.append(tuple(p.shape))
        return real(p, kb)

    monkeypatch.setattr(kp, "panel_factor_batched", spy)
    monkeypatch.setattr(blockdiag, "_caches", {})
    return calls


def _rel(x, ref):
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def test_uniform_partition_is_one_entry_and_one_batched_factor(batched_calls):
    n, blk = 8 * 16, 16
    a = synthetic.blockdiag_matrix(n, blk)
    b = np.random.default_rng(6).standard_normal(n)
    x = blockdiag.solve_blockdiag(a, b, device=CPU)
    c = blockdiag._exe_cache(CPU)
    assert len(c) == 1 and c.stats()["misses"] == 1
    # The new entry's warm-up factor (identities), then the solve's.
    assert batched_calls == [(8, 128, 128), (8, 128, 128)]
    del batched_calls[:]
    x2 = blockdiag.solve_blockdiag(a, b, device=CPU)
    assert batched_calls == [(8, 128, 128)] and c.stats()["hits"] == 1
    np.testing.assert_array_equal(x, x2)
    assert _rel(x, jblockdiag.solve_blockdiag(a, b)) <= 1e-6
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) <= 1e-4


def test_mixed_partition_and_multi_rhs_match_the_reference(batched_calls):
    rng = np.random.default_rng(7)
    sizes = (16, 9, 32, 16, 5, 16)
    n = sum(sizes)
    a = np.zeros((n, n))
    s = 0
    for w in sizes:
        blk = rng.standard_normal((w, w)) + w * np.eye(w)
        a[s:s + w, s:s + w] = blk
        s += w
    b = rng.standard_normal((n, 3))
    x = blockdiag.solve_blockdiag(a, b, refine_steps=2, device=CPU)
    want = jblockdiag.solve_blockdiag(a, b, refine_steps=2)
    assert x.shape == want.shape == (n, 3)
    assert _rel(x, want) <= 1e-6
    # Buckets 8, 16, 32: one entry each.
    assert sorted(k.bucket_n for k in blockdiag._exe_cache(CPU).keys()) == [
        8, 16, 32]
    assert len(batched_calls) == 6


def test_bucket_wider_than_a_panel_factors_per_member(batched_calls,
                                                      monkeypatch):
    """A bucket above the 128-wide auto panel is no longer factored member
    by member: the whole stack takes one batched fused launch for its
    first panel and one batched panel launch for its last (the
    per-member deviation this test once held is closed)."""
    from gauss_tpu_torch.kernels import panel_fused as kpf

    fused = []
    real = kpf.panel_trailing_fused_batched

    def spy(stack, col0, kbrow, **kw):
        fused.append((tuple(stack.shape), col0))
        return real(stack, col0, kbrow, **kw)

    monkeypatch.setattr(kpf, "panel_trailing_fused_batched", spy)
    n, blk = 2 * 200, 200
    a = synthetic.blockdiag_matrix(n, blk)
    b = np.random.default_rng(8).standard_normal(n)
    x = blockdiag.solve_blockdiag(a, b, device=CPU)
    (key,) = blockdiag._exe_cache(CPU).keys()
    assert key.bucket_n == 256
    exe = blockdiag._exe_cache(CPU).get(key)
    assert exe.panel == 128
    # The warm-up factor (identities), then the solve's.
    assert fused == [((2, 256, 256), 0)] * 2
    assert batched_calls == [(2, 128, 128)] * 2
    assert _rel(x, jblockdiag.solve_blockdiag(a, b)) <= 1e-6


def test_partitions_that_lie_are_typed():
    from gauss_tpu_torch.structure import StructureMismatchError

    a = synthetic.blockdiag_matrix(64, 16)
    b = np.ones(64)
    for blocks in ((8,) + (16,) * 3 + (8,), (64,), (16, 16, 16)):
        with pytest.raises(StructureMismatchError):
            blockdiag.solve_blockdiag(a, b, blocks=blocks, device=CPU)
        with pytest.raises(type(jblockdiag.StructureMismatchError("x"))):
            jblockdiag.solve_blockdiag(a, b, blocks=blocks)
    with pytest.raises(StructureMismatchError):
        blockdiag.solve_blockdiag(a, b, require_blocks=5, device=CPU)
    # Coarsening the detected partition is allowed.
    x = blockdiag.solve_blockdiag(a, b, blocks=(32, 32), device=CPU)
    assert np.linalg.norm(a @ x - b) <= 1e-4 * np.linalg.norm(b)

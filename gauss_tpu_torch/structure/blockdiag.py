"""Block-diagonal solves: one batched factor launch per bucket size.

Port of ``gauss_tpu/structure/blockdiag.py``. A block-diagonal system is
n/s independent (s, s) solves wearing one (n, n) coat: the contiguous
diagonal blocks are stacked into a (batch, s, s) operand and solved
through the serving layer's executable cache
(:class:`gauss_tpu_torch.serve.cache.ExecutableCache`, one module cache
per device). Blocks are identity-padded to power-of-two buckets
(``serve.buckets.pad_system``) and grouped by bucket; a uniform partition
(e.g. 64 blocks of 32) is one cache entry and, on the card, one launch of
the batched panel kernel per factor. Refinement is the cache's batched
host-f64 kind.

Mis-tagged operands raise the typed
:class:`gauss_tpu_torch.structure.detect.StructureMismatchError`: entries
off the promised partition would be silently dropped otherwise.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from gauss_tpu_torch.structure.detect import (StructureMismatchError,
                                              detect_structure)

#: executable-cache capacity for the block lane (shapes are tiny and
#: bucketed, so a handful of entries covers a whole workload)
CACHE_CAPACITY = 16

_caches: dict = {}
_cache_lock = threading.Lock()


def _exe_cache(device=None):
    """The lazily built module cache for ``device`` (default ``cuda``)."""
    from gauss_tpu_torch.serve.cache import ExecutableCache
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    with _cache_lock:
        cache = _caches.get(str(dev))
        if cache is None:
            cache = _caches[str(dev)] = ExecutableCache(CACHE_CAPACITY,
                                                        device=dev)
        return cache


def block_partition(a) -> Tuple[int, ...]:
    """The contiguous diagonal-block partition of ``a`` (one detect scan)."""
    return detect_structure(a).blocks


def solve_blockdiag(a, b, blocks: Optional[Sequence[int]] = None,
                    refine_steps: int = 1, require_blocks: int = 2,
                    device=None) -> np.ndarray:
    """Solve a block-diagonal system by batched small-block solves.

    ``blocks``: the partition sizes (detected when None). A partition that
    does not cover the matrix — off-partition nonzeros, wrong total — or
    one with fewer than ``require_blocks`` blocks raises the typed
    :class:`StructureMismatchError`. Returns x float64 with ``b``'s shape.
    ``device``: default ``cuda``."""
    from gauss_tpu_torch.serve import buckets
    from gauss_tpu_torch.serve.cache import CacheKey

    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"expected square matrix, got {a.shape}")
    b = np.asarray(b, dtype=np.float64)
    was_vector = b.ndim == 1
    b2 = b[:, None] if was_vector else b
    k = b2.shape[1]

    detected = block_partition(a)
    if blocks is None:
        blocks = detected
    blocks = tuple(int(s) for s in blocks)
    if sum(blocks) != n:
        raise StructureMismatchError(
            f"block partition {blocks} does not cover n={n}")
    # The promised partition must COARSEN the detected (finest) one: every
    # promised boundary must be a real decoupling point.
    starts = np.cumsum((0,) + blocks[:-1])
    det_bounds = set(np.cumsum(detected))
    bad = [int(s + w) for s, w in zip(starts, blocks)
           if int(s + w) not in det_bounds]
    if bad:
        raise StructureMismatchError(
            f"matrix couples across the promised block boundaries at "
            f"{bad[:4]}; not block-diagonal under this partition")
    if len(blocks) < require_blocks:
        raise StructureMismatchError(
            f"only {len(blocks)} diagonal block(s); the batched route "
            f"needs >= {require_blocks} — use the dense path")

    nrhs_b = buckets.pow2_bucket(k)
    x = np.empty((n, k), dtype=np.float64)
    # Group blocks by bucketed size: a uniform partition is ONE entry.
    by_bucket = {}
    for s, w in zip(starts, blocks):
        by_bucket.setdefault(buckets.pow2_bucket(w), []).append((int(s), w))
    cache = _exe_cache(device)
    for bucket_n, members in sorted(by_bucket.items()):
        batch_b = buckets.pow2_bucket(len(members))
        key = CacheKey(bucket_n=bucket_n, nrhs=nrhs_b, batch=batch_b,
                       dtype="float32", engine="blockdiag",
                       refine_steps=refine_steps, mesh=None)
        a_pad = np.broadcast_to(
            np.eye(bucket_n), (batch_b, bucket_n, bucket_n)).copy()
        b_pad = np.zeros((batch_b, bucket_n, nrhs_b))
        for i, (s, w) in enumerate(members):
            a_pad[i], b_pad[i] = buckets.pad_system(
                a[s:s + w, s:s + w], b2[s:s + w], bucket_n, nrhs_b)
        exe = cache.get(key)
        xb = exe.solve(a_pad, b_pad)
        for i, (s, w) in enumerate(members):
            x[s:s + w] = buckets.unpad_solution(xb[i], w, k,
                                                was_vector=False)
    return x[:, 0] if was_vector else x

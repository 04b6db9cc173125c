"""Shape-bucketed LRU cache of batched-solve executables (the port of
``gauss_tpu/serve/cache.py``).

A cache entry is one :class:`BatchedExecutable` — a batched factor +
solve pair at one ``(batch, bucket_n, nrhs)`` shape, warmed on identity
systems when it is built — and the cache holds at most ``capacity`` of
them in LRU order, keyed by :class:`CacheKey`. Every hit/miss/evict is an
obs ``serve_cache`` event plus a ``serve.cache.*`` counter; a build runs
the ``serve.cache.compile`` fault-injection hook.

The lanes, as in the JAX package (``jax.vmap`` of the blocked factor and
solve):

- LU (every key but ``structure="spd"``):
  :func:`gauss_tpu_torch.core.blocked.lu_factor_blocked_batched` and
  :func:`~gauss_tpu_torch.core.blocked.lu_solve_batched` — one batched
  kernel launch per panel step for the whole stack: a bucket at most one
  panel wide (the auto panel is 128 below n=1024; each member is
  identity-padded to it) is ONE launch of the batched panel kernel, a
  wider one a batched fused launch per panel step and a batched panel
  launch for the last panel. ``dtype`` picks the storage: ``"float32"``,
  ``"bfloat16"`` (bfloat16 storage, the bfloat16 kernels) or ``"bf16x3"``
  (float32 storage, the split-GEMM trailing updates of the unfused
  route).
- spd: :func:`gauss_tpu_torch.structure.cholesky
  .cholesky_factor_blocked_batched` and ``cholesky_solve_batched`` (torch
  ops; the JAX Cholesky runs no Pallas kernel).

:meth:`BatchedExecutable.solve` refines in host float64 through the same
factors, as the JAX package does.

Not ported yet (ROADMAP queue-1 item 11, with the mesh and attribution
planes they serve): ``placement``, ``cost_budget``, ``shared_cache``,
``CacheView`` and the miss coalescing of concurrent lanes; a key with
``mesh`` set raises :class:`LaneNotPortedError` when it is built.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.resilience import inject as _inject

#: The ``CacheKey.dtype`` names of the JAX package's lanes.
KEY_DTYPES = ("float32", "bfloat16", "bf16x3")


class LaneNotPortedError(NotImplementedError):
    """A cache key asks for a lane the port does not have yet (the sharded
    ``mesh`` lane)."""


def storage_dtype(key_dtype: str):
    """The torch staging dtype for a ``CacheKey.dtype`` name: "bf16x3" is a
    GEMM mode on float32 storage; "bfloat16" stages bfloat16."""
    import torch

    if key_dtype not in KEY_DTYPES:
        raise ValueError(f"unknown cache dtype {key_dtype!r}; options: "
                         f"{KEY_DTYPES}")
    return torch.bfloat16 if key_dtype == "bfloat16" else torch.float32


class CacheKey(NamedTuple):
    bucket_n: int
    nrhs: int
    batch: int
    #: batched-lane precision: "float32", "bfloat16" (bfloat16 storage) or
    #: "bf16x3" (float32 storage, split-GEMM updates)
    dtype: str
    engine: str
    refine_steps: int
    #: the sharded lane's mesh; not ported (set: LaneNotPortedError)
    mesh: Optional[str] = None
    #: structure routing tag; "spd" is the batched Cholesky lane, other
    #: tags share the LU lane under their own entries
    structure: Optional[str] = None


class BatchedExecutable:
    """One lane: batched factor + solve at a fixed shape.

    ``factor`` factors all B systems of a stack (one batched kernel launch
    per panel step on the card, in the key's storage dtype); ``solve``
    back-solves all B right-hand sides. Refinement reuses the batched
    factors: each step is one host-f64 batched residual plus one batched
    solve. ``device``: default ``cuda``."""

    def __init__(self, key: CacheKey, panel: Optional[int] = None,
                 device=None):
        from gauss_tpu_torch.core import blocked
        from gauss_tpu_torch.tune import apply as _tune
        from gauss_tpu_torch.utils.device import resolve_device

        if key.mesh is not None:
            raise LaneNotPortedError(
                f"the sharded batched lane (mesh={key.mesh!r}) is not "
                f"ported to gauss_tpu_torch yet (ROADMAP queue-1 item 11: "
                f"serve/lanes)")
        self.key = key
        self.device = resolve_device(device)
        self.dtype = storage_dtype(key.dtype)
        if panel is None:
            # The tuned store's panel for this bucket, else the auto rule.
            panel = _tune.override("lu_factor", key.bucket_n, "panel",
                                   dtype=key.dtype, engine=key.engine)
            panel = int(panel) if panel else None
        self.panel = blocked._resolve_panel(key.bucket_n, panel,
                                            self.dtype.itemsize)
        with obs.compile_span("serve_executable", bucket_n=key.bucket_n,
                              nrhs=key.nrhs, batch=key.batch,
                              dtype=key.dtype, engine=key.engine):
            eye = np.broadcast_to(np.eye(key.bucket_n), (
                key.batch, key.bucket_n, key.bucket_n)).copy()
            self.solve_factored(self.factor(eye),
                                np.zeros((key.batch, key.bucket_n,
                                          key.nrhs)))

    def _stage(self, x: np.ndarray):
        from gauss_tpu_torch.utils.device import as_tensor

        return as_tensor(np.asarray(x), self.device, self.dtype)

    def factor(self, a_pad: np.ndarray):
        """Factor the (B, bucket_n, bucket_n) host stack in the key's
        storage dtype."""
        if self.key.structure == "spd":
            from gauss_tpu_torch.structure import cholesky

            return cholesky.cholesky_factor_blocked_batched(
                self._stage(a_pad), panel=self.panel, device=self.device)
        from gauss_tpu_torch.core import blocked

        return blocked.lu_factor_blocked_batched(
            self._stage(a_pad), panel=self.panel,
            gemm_precision=("bf16x3" if self.key.dtype == "bf16x3"
                            else "highest"), device=self.device)

    def solve_factored(self, fac, b_pad: np.ndarray) -> np.ndarray:
        """Solve a (B, bucket_n, nrhs) host stack, staged in the storage
        dtype, through ``fac``; returns float64."""
        if self.key.structure == "spd":
            from gauss_tpu_torch.structure import cholesky

            x = cholesky.cholesky_solve_batched(fac, self._stage(b_pad))
        else:
            from gauss_tpu_torch.core import blocked

            x = blocked.lu_solve_batched(fac, self._stage(b_pad))
        return x.cpu().numpy().astype(np.float64)

    def solve(self, a_pad: np.ndarray, b_pad: np.ndarray) -> np.ndarray:
        """Solve the padded batch; returns float64 (B, bucket_n, nrhs).

        ``a_pad``/``b_pad`` are host float64 stacks at the cached shape;
        the device factors and solves in the key's dtype, and
        ``refine_steps`` rounds of host-f64 refinement through the same
        factors follow (the lowered keys lean on them for the 1e-4 gate)."""
        fac = self.factor(a_pad)
        x = self.solve_factored(fac, b_pad)
        for _ in range(self.key.refine_steps):
            r = b_pad - np.einsum("bij,bjk->bik", a_pad, x)
            x = x + self.solve_factored(fac, r)
        return x


class ExecutableCache:
    """Bounded LRU over :class:`BatchedExecutable` entries (thread-safe).
    The JAX cache's miss coalescing (concurrent lanes warming one key)
    serves the multi-lane server, which is not ported: two racing misses
    here each build, and the later insert wins."""

    def __init__(self, capacity: int = 32, device=None):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.device = device
        # guarded by: self._lock
        self._entries: "OrderedDict[CacheKey, BatchedExecutable]" = \
            OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0                   # guarded by: self._lock
        self.misses = 0                 # guarded by: self._lock
        self.evictions = 0              # guarded by: self._lock

    def get(self, key: CacheKey,
            panel: Optional[int] = None) -> BatchedExecutable:
        """The cached executable for ``key``, building (and possibly
        evicting the least-recently-used entry) on a miss."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        if entry is not None:
            obs.counter("serve.cache.hits")
            obs.emit("serve_cache", event="hit", **key._asdict())
            return entry
        obs.counter("serve.cache.misses")
        obs.emit("serve_cache", event="miss", **key._asdict())
        if _inject.enabled():
            # Hook point "serve.cache.compile": a simulated build failure
            # (RuntimeError-shaped).
            _inject.maybe_raise("serve.cache.compile")
        entry = BatchedExecutable(key, panel=panel, device=self.device)
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            evicted = []
            while len(self._entries) > self.capacity:
                evicted.append(self._entries.popitem(last=False)[0])
                self.evictions += 1
        for old in evicted:
            obs.counter("serve.cache.evictions")
            obs.emit("serve_cache", event="evict", **old._asdict())
        return entry

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self):
        with self._lock:
            return list(self._entries.keys())

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": len(self),
                "capacity": self.capacity,
                "hit_rate": round(self.hit_rate, 4)}

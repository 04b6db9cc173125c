"""Shape-bucketed LRU cache of batched-solve executables: the part of
``gauss_tpu/serve/cache.py`` the block-diagonal lane needs.

A cache entry is one :class:`BatchedExecutable` — a batched blocked-LU
factor + solve pair at one ``(batch, bucket_n, nrhs)`` shape, warmed on
identity systems when it is built — and the cache holds at most
``capacity`` of them in LRU order, keyed by :class:`CacheKey`. Every
hit/miss/evict is an obs ``serve_cache`` event plus a ``serve.cache.*``
counter; a build runs the ``serve.cache.compile`` fault-injection hook.

The float32 LU lane: where the bucket is at most one panel wide (the
auto panel is 128 below n=1024, and each member is identity-padded to
it), the whole stack is factored by ONE launch of the batched panel
kernel (:func:`gauss_tpu_torch.kernels.panel.panel_factor_batched`) — the
JAX package's ``jax.vmap(lu_factor_blocked)``, whose members are each one
``panel_factor_pallas`` call — followed by the batched diagonal-block
inverses; the solve is two batched products per right-hand-side stack.
:meth:`BatchedExecutable.solve` refines in host float64 through the same
factors, as the JAX package does.

Deliberate deviation: a bucket wider than one panel is factored member by
member (``core.blocked.lu_factor_blocked`` on each), where the JAX package
vmaps the whole blocked factorization; it closes with the serve slice.

Not ported yet (ROADMAP queue-1 item 11): the lowered dtype lanes
(``bfloat16``, ``bf16x3``), the ``spd`` structure lane, ``placement``,
``cost_budget``, ``shared_cache``, ``CacheView`` and the miss coalescing
of concurrent lanes; a key that asks for a lane not ported raises
:class:`LaneNotPortedError` when it is built.
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
    """A cache key asks for a lane the port does not have yet."""


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
    #: batched-lane precision: "float32" (the lane the port has),
    #: "bfloat16" or "bf16x3" (queue-1 item 11)
    dtype: str
    engine: str
    refine_steps: int
    mesh: Optional[str] = None
    #: structure routing tag; "spd" names the batched Cholesky lane (queue-1
    #: item 11), other tags share the LU lane under their own entries
    structure: Optional[str] = None


class BatchedLU(NamedTuple):
    """The factors of a one-panel bucket stack: ``m`` (B, p, p), ``perm``
    (B, p) gather indices, ``min_abs_pivot`` (B,), ``linv``/``uinv``
    (B, p, p)."""

    m: object
    perm: object
    min_abs_pivot: object
    linv: object
    uinv: object


class BatchedExecutable:
    """One lane: batched blocked factor + solve at a fixed shape.

    ``factor`` factors all B systems of a stack (one batched kernel launch
    on the card when the bucket is one panel wide); ``solve`` back-solves
    all B right-hand sides. Refinement reuses the batched factors: each
    step is one host-f64 batched residual plus one batched solve.
    ``device``: default ``cuda``."""

    def __init__(self, key: CacheKey, panel: Optional[int] = None,
                 device=None):
        from gauss_tpu_torch.core import blocked
        from gauss_tpu_torch.tune import apply as _tune
        from gauss_tpu_torch.utils.device import resolve_device

        if key.dtype != "float32" or key.structure == "spd":
            raise LaneNotPortedError(
                f"the {key.dtype} / structure={key.structure!r} batched lane "
                f"is not ported to gauss_tpu_torch yet (ROADMAP queue-1 item "
                f"11); the port has the float32 LU lane")
        self.key = key
        self.device = resolve_device(device)
        if panel is None:
            # The tuned store's panel for this bucket, else the auto rule.
            panel = _tune.override("lu_factor", key.bucket_n, "panel",
                                   dtype=key.dtype, engine=key.engine)
            panel = int(panel) if panel else None
        self.panel = blocked._resolve_panel(key.bucket_n, panel)
        #: the batched kernel's route: the bucket is one panel wide
        self.one_panel = key.bucket_n <= self.panel
        with obs.compile_span("serve_executable", bucket_n=key.bucket_n,
                              nrhs=key.nrhs, batch=key.batch,
                              dtype=key.dtype, engine=key.engine):
            eye = np.ascontiguousarray(np.broadcast_to(
                np.eye(key.bucket_n), (key.batch, key.bucket_n,
                                       key.bucket_n)))
            self.solve_factored(self.factor(eye),
                                np.zeros((key.batch, key.bucket_n,
                                          key.nrhs)))

    def factor(self, a_pad: np.ndarray):
        """Factor the (B, bucket_n, bucket_n) host stack in float32."""
        import torch

        from gauss_tpu_torch.core import blocked
        from gauss_tpu_torch.kernels.panel import panel_factor_batched
        from gauss_tpu_torch.utils.device import as_tensor

        a = as_tensor(np.asarray(a_pad), self.device)
        if not self.one_panel:
            return [blocked.lu_factor_blocked(a[i], panel=self.panel,
                                              device=self.device)
                    for i in range(a.shape[0])]
        bsz, n, _ = a.shape
        p = self.panel
        m = a
        if n < p:
            m = torch.eye(p, dtype=a.dtype, device=a.device).repeat(
                bsz, 1, 1)
            m[:, :n, :n] = a
        lu, _, perm, minpiv = panel_factor_batched(m, 0)
        return BatchedLU(m=lu, perm=perm, min_abs_pivot=minpiv,
                         linv=blocked._diag_block_linv(lu),
                         uinv=blocked._diag_block_uinv(lu))

    def solve_factored(self, fac, b_pad: np.ndarray) -> np.ndarray:
        """Solve a (B, bucket_n, nrhs) host stack through ``fac``; returns
        float64."""
        import torch

        from gauss_tpu_torch.core import blocked
        from gauss_tpu_torch.utils.device import as_tensor

        b = as_tensor(np.asarray(b_pad), self.device)
        if not self.one_panel:
            x = torch.stack([blocked.lu_solve(f, b[i])
                             for i, f in enumerate(fac)])
            return x.cpu().numpy().astype(np.float64)
        bsz, n, k = b.shape
        p = self.panel
        bp = torch.zeros((bsz, p, k), dtype=b.dtype, device=b.device)
        bp[:, :n] = b
        bp = torch.gather(bp, 1, fac.perm[:, :, None].expand(bsz, p, k))
        x = fac.uinv @ (fac.linv @ bp)
        return x[:, :n].cpu().numpy().astype(np.float64)

    def solve(self, a_pad: np.ndarray, b_pad: np.ndarray) -> np.ndarray:
        """Solve the padded batch; returns float64 (B, bucket_n, nrhs).

        ``a_pad``/``b_pad`` are host float64 stacks at the cached shape;
        the device factors and solves in float32, and ``refine_steps``
        rounds of host-f64 refinement through the same factors follow."""
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

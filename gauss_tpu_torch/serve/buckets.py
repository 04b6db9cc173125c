"""Shape bucketing for the serving layer: the executable-cache key space.

Port of ``gauss_tpu/serve/buckets.py`` (numpy only, copied; the panel
width comes from the port's ``core.blocked``).

A long-lived solver service cannot afford one XLA compile per distinct
``(n, nrhs, batch)`` it ever sees — arbitrary request shapes must collapse
onto a SMALL ladder of compiled shapes, the same move MAGMA-style batched
dense libraries make (PAPERS.md: many small systems per launch, one kernel
per size class). Three axes are bucketed:

- **System size** ``n`` rounds up to a ladder of bucket sizes. The default
  ladder is the powers-of-two multiples of :data:`core.blocked.DEFAULT_PANEL`
  (128, 256, ..., 4096) — every rung is a panel multiple, so the blocked
  factorization's own padding (:func:`core.blocked._pad_to_panel`) never
  adds a second layer of padding on top of the bucket's.
- **RHS count** ``k`` rounds up to a power of two (serving stacks RHS
  columns; ``lu_solve`` carries the k axis through its GEMMs for free).
- **Batch size** rounds up to a power of two capped by the server's
  ``max_batch``, so draining 3 queued requests reuses the batch-4
  executable instead of compiling a batch-3 one.

Padding is identity-extension, exactly the policy of
``core.blocked._pad_to_panel``: the padded diagonal is 1, padded RHS rows
are 0, so padded rows can never win a partial-pivot contest in a real
column, the padded block stays the identity through every update, and the
solution tail is exactly zero — ``unpad`` just slices ``x[:n]``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

#: ``core.blocked.DEFAULT_PANEL`` (tests/test_torch_serve.py holds them
#: equal); not imported, so that importing the serving package loads no
#: torch.
DEFAULT_PANEL = 128

# Powers-of-two multiples of the panel width: 128 .. 4096. Past the top
# rung a request is OVERSIZED for the batched lane and routes through
# core.blocked.solve_handoff (the single-card lane in the port).
DEFAULT_LADDER: Tuple[int, ...] = tuple(DEFAULT_PANEL * 2 ** i
                                        for i in range(6))


def validate_ladder(ladder: Sequence[int]) -> Tuple[int, ...]:
    """Sorted, deduplicated, all-positive ladder (ValueError otherwise)."""
    rungs = sorted(set(int(r) for r in ladder))
    if not rungs or rungs[0] < 1:
        raise ValueError(f"bucket ladder must be positive ints, got {ladder}")
    return tuple(rungs)


def bucket_for(n: int, ladder: Sequence[int] = DEFAULT_LADDER) -> int | None:
    """Smallest ladder rung >= n, or None when ``n`` overflows the ladder
    (the caller routes those through solve_handoff instead of batching)."""
    if n < 1:
        raise ValueError(f"system size must be >= 1, got {n}")
    for rung in ladder:
        if n <= rung:
            return rung
    return None


def pow2_bucket(k: int, cap: int | None = None) -> int:
    """Smallest power of two >= k (optionally capped)."""
    if k < 1:
        raise ValueError(f"count must be >= 1, got {k}")
    b = 1
    while b < k:
        b *= 2
    if cap is not None:
        b = min(b, cap)
    return b


def pad_system(a: np.ndarray, b: np.ndarray, bucket_n: int,
               nrhs_bucket: int | None = None,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Embed ``(a, b)`` in an identity-extended ``bucket_n`` system.

    ``a`` -> top-left of an identity-padded (bucket_n, bucket_n) matrix;
    ``b`` (n,) or (n, k) -> zero-extended (bucket_n, nrhs_bucket), the k
    axis zero-padded up to the RHS bucket. Returns host arrays in ``a``'s
    dtype; the caller stacks them into the batched device operand.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"expected square matrix, got {a.shape}")
    if b.shape[0] != n:
        raise ValueError(f"rhs rows {b.shape[0]} != system size {n}")
    if n > bucket_n:
        raise ValueError(f"system size {n} exceeds bucket {bucket_n}")
    b2 = b[:, None] if b.ndim == 1 else b
    if b2.ndim != 2:
        raise ValueError(f"b must be (n,) or (n, k), got {b.shape}")
    k = b2.shape[1]
    kb = k if nrhs_bucket is None else nrhs_bucket
    if k > kb:
        raise ValueError(f"nrhs {k} exceeds rhs bucket {kb}")
    ap = np.eye(bucket_n, dtype=a.dtype)
    ap[:n, :n] = a
    bp = np.zeros((bucket_n, kb), dtype=b2.dtype)
    bp[:n, :k] = b2
    return ap, bp


def unpad_solution(x: np.ndarray, n: int, k: int,
                   was_vector: bool) -> np.ndarray:
    """Slice the original system's solution back out of a padded one."""
    x = np.asarray(x)
    out = x[:n, :k]
    return out[:, 0] if was_vector else out

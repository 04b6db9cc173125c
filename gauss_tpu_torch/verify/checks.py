"""Correctness checks, unified from the reference's three verification ideas.

1. Manufactured-solution max relative error — the external programs' always-on
   oracle (reference gauss_external_input.c:304-315): ``max |x - x_true| / |x_true|``.
2. VERIFY pattern check — the internal programs' compile-time-gated check that
   the solution is (-0.5, 0, ..., 0, 0.5) (gauss_internal_input.c:17,54-57).
   Here it is a runtime function, not a recompile.
3. Elementwise epsilon comparison — the CUDA ``verify()`` with EPSILON=1e-4
   (cuda_matmul.cu:13,61-72), which the reference defines but never calls;
   we actually wire it into tests and the CLI.

Plus the residual norm ``||Ax - b||`` used as the BASELINE.json acceptance bar.
All checks compute in float64 on host so they are meaningful for f32 device
results.
"""

from __future__ import annotations

import numpy as np

EPSILON = 1e-4  # reference cuda_matmul.cu:13


def max_rel_error(x, x_true) -> float:
    """max_i |x_i - x_true_i| / |x_true_i| (external-input 'Error:' line)."""
    x = np.asarray(x, dtype=np.float64)
    x_true = np.asarray(x_true, dtype=np.float64)
    denom = np.abs(x_true)
    denom = np.where(denom == 0.0, 1.0, denom)
    return float(np.max(np.abs(x - x_true) / denom))


def residual_norm(a, x, b, relative: bool = False) -> float:
    """||A x - b||_2, optionally scaled by ||b||_2."""
    a = np.asarray(a, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    r = float(np.linalg.norm(a @ x - b))
    if relative:
        nb = float(np.linalg.norm(b))
        return r / nb if nb else r
    return r


def elementwise_match(x, y, epsilon: float = EPSILON) -> bool:
    """CUDA verify() semantics: no element differs by more than epsilon."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    return bool(np.all(np.abs(x - y) <= epsilon))


def internal_pattern_ok(x, atol: float = 1e-6) -> bool:
    """The internal-input VERIFY oracle: x == (-0.5, 0, ..., 0, 0.5)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    expected = np.zeros(n)
    expected[0], expected[-1] = -0.5, 0.5
    return bool(np.all(np.abs(x - expected) <= atol))

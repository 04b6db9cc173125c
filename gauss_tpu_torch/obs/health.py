"""Numerical-health monitors: per-solve conditioning and stability signals.

The port's copy of the JAX package's ``obs/health.py``, with the same
``health`` event and keys:

- ``min_abs_pivot`` — smallest |U diagonal| actually used; 0 means singular,
  tiny means the solve is leaning on refinement.
- ``growth_factor`` — max |entry of the factor| / max |entry of A|: the
  element-growth bound behind partial pivoting's stability argument
  (Wilkinson); large growth explains a bad residual with healthy pivots.
- ``nan`` / ``inf`` flags on the solution (the device engines signal
  singularity through NaN rather than exceptions).
- ``residual`` / ``rel_residual`` — ||Ax - b||_2 in f64 on host, absolute
  and b-relative.

The factor's numbers come from O(n^2) reductions on the factor's own
device, fetched as one small vector; the residual is the one O(n^2) host
matvec the refinement loop already pays.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from gauss_tpu_torch.obs import spans as _spans


def _host(v) -> np.ndarray:
    """A float64 host copy of an array or tensor."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


def solution_health(x) -> Dict[str, Any]:
    """NaN/Inf flags + magnitude of a solution vector (host or device)."""
    x = _host(x)
    return {
        "nan": bool(np.isnan(x).any()),
        "inf": bool(np.isinf(x).any()),
        "max_abs_x": float(np.max(np.abs(x))) if x.size else 0.0,
    }


def residual_health(a, x, b) -> Dict[str, Any]:
    """Absolute + relative residual norms in f64 on host."""
    from gauss_tpu_torch.verify import checks

    res = checks.residual_norm(_host(a), _host(x), _host(b))
    nb = float(np.linalg.norm(_host(b)))
    return {"residual": res,
            "rel_residual": res / nb if nb > 0 else res}


def factor_health(factors, a=None, n: Optional[int] = None) -> Dict[str, Any]:
    """Pivot/growth monitors from a :class:`BlockedLU`-shaped factorization.

    ``n``: the true system size — the identity padding's 1.0 diagonal
    entries would otherwise clamp the reported min |pivot| at <= 1. The
    reductions run on the factor's device; one vector of scalars crosses
    to the host.
    """
    import torch

    m = factors.m
    n = int(m.shape[0]) if n is None else int(n)
    diag = m.diagonal()[:n].abs()
    scalars = [diag.min(), diag.max(), m[:n, :n].abs().max()]
    loop_min = getattr(factors, "min_abs_pivot", None)
    if loop_min is not None:
        scalars.append(loop_min.reshape(()).to(m.dtype))
    host = torch.stack(scalars).cpu().tolist()
    out: Dict[str, Any] = {"min_abs_pivot": host[0],
                           "max_abs_pivot": host[1]}
    max_factor = host[2]
    if a is not None:
        max_a = float(np.max(np.abs(_host(a))))
        if max_a > 0 and np.isfinite(max_factor):
            out["growth_factor"] = max_factor / max_a
    if loop_min is not None:
        # The loop-recorded minimum (includes padded steps; kept for
        # cross-checking the diagonal read).
        out["loop_min_abs_pivot"] = host[3]
    return out


def record_solve_health(a=None, x=None, b=None, factors=None,
                        n: Optional[int] = None, backend: Optional[str] = None,
                        **extra) -> Optional[Dict[str, Any]]:
    """Assemble whichever monitors the inputs allow and emit ONE ``health``
    event on the active recorder. Returns the metrics dict (None when no
    recorder is active — the reductions are skipped entirely, so permanent
    call sites stay free on unobserved runs)."""
    if _spans.active() is None:
        return None
    metrics: Dict[str, Any] = {}
    if x is not None:
        metrics.update(solution_health(x))
    if a is not None and x is not None and b is not None:
        metrics.update(residual_health(a, x, b))
    if factors is not None:
        metrics.update(factor_health(factors, a=a, n=n))
    metrics.update(extra)
    _spans.emit("health", backend=backend, **metrics)
    return metrics

"""solve_auto: detect -> route -> structured engine -> the same 1e-4 gate.

Port of ``gauss_tpu/structure/router.py``. Classify the operand
(:mod:`.detect`), pick the engine for its class, and run it through
:func:`gauss_tpu_torch.resilience.recover.solve_resilient` with the
structured ladder (:func:`~gauss_tpu_torch.resilience.recover
.structured_rungs`): the structured engine is rung 0, and below it is the
same general-LU demotion chain as every dense solve. So every structured
result passes the 1e-4 relative-residual gate, a misclassified matrix
fails its rung typed or by the residual and demotes to general LU, every
escalation is an obs ``recovery`` event, and the routing decision is an
obs ``structure`` event and its outcome a ``structure_solve`` event, with
the JAX package's fields (``obs.summarize.structure_summary`` reads them).

Hook point ``structure.detect`` (:mod:`gauss_tpu_torch.resilience.inject`,
kind ``mistag``): forces the routing tag to ``STRUCTURE_KINDS[int(param)]``.

Importing this module loads no torch; the engines load at first use.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.resilience import inject as _inject
from gauss_tpu_torch.resilience import recover
from gauss_tpu_torch.structure.detect import (STRUCTURE_KINDS,
                                              StructureInfo,
                                              detect_structure)

#: which ladder rung counts as "the structured engine" per tag (anything
#: else that serves the solution means the route DEMOTED)
ENGINE_FOR_TAG = {"spd": "cholesky", "banded": "banded",
                  "blockdiag": "blockdiag", "dense": "blocked",
                  "sparse": "cg"}


def routed_tag(info: StructureInfo,
               structure: Optional[str] = None) -> str:
    """The tag :func:`solve_auto` will route on: the caller's override,
    else the detected class — then through the ``structure.detect``
    mis-tag hook when a plan is installed."""
    tag = structure if structure is not None else info.kind
    if tag not in STRUCTURE_KINDS:
        raise ValueError(f"unknown structure tag {tag!r}; options: "
                         f"{STRUCTURE_KINDS}")
    if _inject.enabled():
        sp = _inject.poll("structure.detect")
        if sp is not None and sp.kind == "mistag":
            tag = STRUCTURE_KINDS[int(sp.param) % len(STRUCTURE_KINDS)]
    return tag


def solve_auto(a, b, *, structure: Optional[str] = None,
               info: Optional[StructureInfo] = None,
               gate: float = recover.DEFAULT_GATE,
               panel: Optional[int] = None,
               refine_iters: int = 2,
               device=None) -> recover.ResilientResult:
    """Structure-routed solve of ``a @ x = b``.

    Returns the ladder's :class:`~gauss_tpu_torch.resilience.recover
    .ResilientResult` — ``.x`` float64 at the original shape, ``.rung``
    the engine that served (``cholesky`` / ``banded`` / ``blockdiag`` /
    ``blocked`` / a Krylov rung / deeper), ``.rung_index > 0`` meaning the
    route demoted. Raises :class:`~gauss_tpu_torch.resilience.recover
    .UnrecoverableSolveError` only when every rung failed; ``ValueError``
    for malformed requests. ``structure`` overrides detection; ``info``
    supplies a precomputed :class:`StructureInfo`. The ``lowered`` head of
    the dense lane comes from ``core.lowered.lowered_enabled(n)`` (a tuned
    store). ``device``: where the engines run (default ``cuda``)."""
    a64 = np.asarray(a, dtype=np.float64)
    b64 = np.asarray(b, dtype=np.float64)
    n = a64.shape[0]
    if a64.ndim != 2 or a64.shape != (n, n):
        raise ValueError(f"expected square matrix, got {a64.shape}")
    if b64.shape[:1] != (n,) or b64.ndim > 2:
        raise ValueError(f"b must be (n,) or (n, k) with n={n}, "
                         f"got {b64.shape}")
    if n == 0:
        # The empty system: one valid solution, nothing to verify.
        return recover.ResilientResult(
            x=np.zeros_like(b64), rung="empty", rung_index=0, attempts=0,
            rel_residual=0.0, escalations=[])
    if info is None:
        info = detect_structure(a64)
    tag = routed_tag(info, structure)
    obs.emit("structure", n=n, detected=info.kind, tag=tag,
             symmetric=info.symmetric, spd_likely=info.spd_likely,
             bandwidth=info.bandwidth, blocks=len(info.blocks),
             density=round(info.density, 6))
    if n == 1:
        # Trivial 1x1: the host rung alone.
        res = recover.solve_resilient(a64, b64, gate=gate,
                                      rungs=("numpy_f64",), device=device)
    else:
        low = False
        if tag == "dense":
            from gauss_tpu_torch.core import lowered as _lowered

            low = _lowered.lowered_enabled(n)
        res = recover.solve_resilient(
            a64, b64, gate=gate, panel=panel, refine_iters=refine_iters,
            rungs=recover.structured_rungs(tag, lowered=low), device=device)
    honest = {ENGINE_FOR_TAG.get(tag, res.rung)}
    if tag == "dense":
        # The mixed-precision head serving IS the dense route as tuned.
        honest.add("lowered")
    elif tag == "sparse":
        # Any Krylov rung serving IS the sparse route: method selection,
        # not a densified demotion.
        honest.update(("gmres", "bicgstab"))
    demoted = res.rung not in honest and n > 1
    obs.counter("structure.solves")
    if demoted:
        obs.counter("structure.demotions")
    obs.emit("structure_solve", n=n, tag=tag, engine=res.rung,
             demoted=demoted, rung_index=res.rung_index,
             rel_residual=res.rel_residual)
    return res

"""Collective-traffic accounting: count and size the interconnect ops.

The port of ``gauss_tpu/obs/collectives.py``. The JAX package derives a
distributed solve's collective budget statically, by walking the traced
program (scan bodies weighted by their trip counts) or the compiled HLO.
The port's engines are eager ``torch.distributed`` programs, so the port
counts the collectives one call ISSUES: every engine sends its
collectives through the one thin wrapper in :mod:`gauss_tpu_torch.dist.comm`,
which calls :func:`tally` once per collective, and :func:`counting` scopes
a budget around a call. The JAX kind names are kept (``psum`` for an
all_reduce sum, ``pmin``, ``all_gather``, ...), so the two packages'
``collective`` events and ``collective.<op>.count|bytes`` counters read
alike.

Bytes are the payload of each op's OUTPUT (elements x itemsize of the
tensor the collective materializes on each participant), as in the JAX
package: not a wire-protocol byte count.

``compiled_collective_budget`` has no compiled module to read here (no
XLA partitioner inserts collectives behind the engines' backs); it is
bound to the same issued count as :func:`collective_budget`.

Everything no-ops without an active recorder and never raises —
accounting must not take down a solve. Stdlib only at import.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

from gauss_tpu_torch.obs import spans as _spans

COLLECTIVE_KINDS = ("all_gather", "all_to_all", "ppermute", "psum", "pmin",
                    "pmax", "pbroadcast", "pcast")

_lock = threading.Lock()
_budgets: list = []


def tally(kind: str, nbytes: int) -> None:
    """Count one issued collective of ``kind`` with an output of
    ``nbytes`` into every open :func:`counting` budget (one list check
    when none is open)."""
    if not _budgets:
        return
    with _lock:
        for budget in _budgets:
            b = budget.setdefault(kind, {"count": 0, "bytes": 0})
            b["count"] += 1
            b["bytes"] += int(nbytes)


@contextlib.contextmanager
def counting():
    """Yield a budget dict ``{op_kind: {"count": N, "bytes": B}}`` that
    fills with every collective issued in this process while the block
    runs (budgets nest: an outer one counts the inner block's too)."""
    budget: Dict[str, Dict[str, int]] = {}
    with _lock:
        _budgets.append(budget)
    try:
        yield budget
    finally:
        with _lock:
            for i in range(len(_budgets) - 1, -1, -1):
                if _budgets[i] is budget:
                    del _budgets[i]
                    break


def collective_budget(fn, *args, **kwargs) -> Dict[str, Dict[str, int]]:
    """The collectives one call ``fn(*args, **kwargs)`` issues, by kind:
    ``{op_kind: {"count": N, "bytes": B}}``. The call runs (on every rank
    of its mesh, as any distributed call must)."""
    with counting() as budget:
        fn(*args, **kwargs)
    return budget


def compiled_collective_budget(fn, *args) -> Dict[str, Dict[str, int]]:
    """The JAX package reads this from the compiled HLO; an eager torch
    program has no compiled module, so this is the issued count of
    :func:`collective_budget`."""
    return collective_budget(fn, *args)


def _shape_key(a):
    shape = getattr(a, "shape", None)
    return (tuple(shape) if shape is not None else None,
            str(getattr(a, "dtype", None)))


def record_collective_budget(label: str, fn, *args, via: str = "issued",
                             **meta) -> Optional[Dict[str, Dict[str, int]]]:
    """Emit one ``collective`` event per op kind (fields ``label``, ``op``,
    ``count``, ``bytes``, ``via`` and the meta kwargs) and bump the
    ``collective.<op>.count|bytes`` counters; returns the budget, or None
    when no recorder is active or the (label, arg shapes) pair was
    recorded already in this run.

    ``fn`` is either a budget dict the caller counted with
    :func:`counting` around the call it just made (the engines' form: the
    solve runs once), or a callable that is run here under
    :func:`counting` with ``args``. ``args`` key the deduplication, as in
    the JAX package: a loop that solves the same staged system repeatedly
    records its budget once."""
    rec = _spans.active()
    if rec is None:
        return None
    try:
        key = (label, tuple(_shape_key(a) for a in args))
        seen = getattr(rec, "_collective_seen", None)
        if seen is None:
            seen = rec._collective_seen = set()
        if key in seen:
            return None
        seen.add(key)
        if isinstance(fn, dict):
            budget = fn
        else:
            with _spans.span(f"collective_budget:{label}"):
                budget = collective_budget(fn, *args)
        for op in sorted(budget):
            b = budget[op]
            rec.emit("collective", label=label, op=op, count=b["count"],
                     bytes=b["bytes"], via=via, **meta)
            rec.counter(f"collective.{op}.count", b["count"])
            rec.counter(f"collective.{op}.bytes", b["bytes"])
        return budget
    except Exception:  # accounting must never take down a solve
        return None

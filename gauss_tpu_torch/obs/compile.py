"""Compile accounting: the warm-up region of each entry point.

The port's copy of :func:`compile_span` from the JAX package's
``obs/compile.py``. In the port it bounds the warm-up solve at shape,
which builds the kernels with ``nvcc`` at first use and loads them, and
initialises cuBLAS — so that cost is attributed instead of leaking into
whatever phase runs next. The JAX module's cost half (``cost_summary``,
``record_cost``, ``record_vmem_estimate``) reads XLA's cost analysis and
Mosaic's VMEM model, which have no counterpart here.
"""

from __future__ import annotations

import contextlib
import time

from gauss_tpu_torch.obs import spans as _spans


@contextlib.contextmanager
def compile_span(label: str, **attrs):
    """Record a compile/warmup region: emits both a span (so the flat
    profile accounts the time) and a ``compile`` event keyed by label."""
    rec = _spans.active()
    if rec is None:
        yield
        return
    t0 = time.perf_counter()
    with _spans.span(f"compile:{label}", **attrs):
        yield
    _spans.emit("compile", label=label,
                compile_wall_s=round(time.perf_counter() - t0, 6), **attrs)

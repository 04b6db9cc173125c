"""gauss_tpu_torch.obs — the port's telemetry core: metrics, spans, health.

One per-run event stream that every layer reports into, flushed as JSONL
via ``--metrics-out`` and rendered offline by
``python -m gauss_tpu_torch.obs.summarize`` (or the JAX package's
summarizer: event types, span names and field names are the JAX
package's, so one ``summarize`` reads either package's stream).

Quick tour::

    from gauss_tpu_torch import obs

    with obs.run(metrics_out="run.jsonl", tool="my_sweep") as rec:
        with obs.span("factor"):
            fac = lu_factor_blocked_unrolled(a)
        obs.record_solve_health(a=a, x=x, b=b, factors=fac, n=n)
        obs.gauge("panel_width", 128)

Every hook is a no-op without an active recorder, so instrumentation lives
permanently in the host-side paths at zero cost on unobserved runs.
Importing this package loads no torch; the factor health reductions import
it when they run.

Where span and event values name a backend, the port's names stand for the
JAX package's: ``cuda`` for ``tpu``, ``cuda[ds]`` for ``tpu[ds]``, and so
on (``cli/_common.py``). Compile spans are ``compile:cuda_blocked_warmup``
for ``compile:tpu_blocked_warmup`` and the like.

The crash-surviving flight recorder (:mod:`.flight`, a flight sink on
the same hooks), its post-mortem bundles (:mod:`.postmortem`), their
reader (``python -m gauss_tpu_torch.obs.debug``), its gate (``python -m
gauss_tpu_torch.obs.flightcheck``) and the regression sentinel
(``python -m gauss_tpu_torch.obs.regress``, with a history of its own)
load only where they are used.

The collective budgets (:mod:`.collectives`: ``collective_budget``,
``compiled_collective_budget``, ``record_collective_budget``) count the
collectives a distributed call issues through
:mod:`gauss_tpu_torch.dist.comm`; ``python -m gauss_tpu_torch.obs.aggregate``
merges the per-process streams of a multi-process launch.

Not ported yet: the cost half of ``obs.compile`` (``cost_summary``,
``record_cost``, ``record_vmem_estimate``: XLA's cost analysis and
Mosaic's VMEM have no counterpart), and the modules ``attr``, ``doctor``,
``export``, ``live``, ``livecheck``, ``prof``, ``profcheck``, ``slo`` and
``top``.
"""

from gauss_tpu_torch.obs.collectives import (
    collective_budget,
    compiled_collective_budget,
    record_collective_budget,
)
from gauss_tpu_torch.obs.compile import compile_span
from gauss_tpu_torch.obs.health import record_solve_health
from gauss_tpu_torch.obs.registry import Recorder, new_run_id, read_events
from gauss_tpu_torch.obs.spans import (
    active,
    counter,
    current_trace,
    emit,
    flight_sink,
    gauge,
    histogram,
    live_sink,
    record_span,
    run,
    set_flight_sink,
    set_live_sink,
    span,
    trace_context,
)

__all__ = ["Recorder", "active", "collective_budget",
           "compiled_collective_budget", "compile_span", "counter",
           "current_trace", "emit", "flight_sink", "gauge", "histogram",
           "live_sink", "new_run_id", "read_events",
           "record_collective_budget", "record_solve_health", "record_span",
           "run", "set_flight_sink", "set_live_sink", "span", "trace_context"]

# gauss_tpu_torch.obs.summarize, .trace, .debug, .flightcheck, .regress
# and .aggregate
# are `python -m` entry points and are deliberately NOT imported here
# (runpy's double-import warning).

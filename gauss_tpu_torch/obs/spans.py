"""Span-based tracing over the active recorder: nested wall-clock regions.

A copy of the JAX package's ``obs/spans.py`` with the same hooks, events
and fields. Generalizes :class:`gauss_tpu_torch.utils.profiling.PhaseTimer`
(which keeps its print-a-table surface and also reports here): a span is
one named wall-clock region with a parent, so the summarizer can render
both a gprof-style flat profile (aggregate by name) and a nesting-aware
coverage check (leaf spans vs the root's duration). Spans measure HOST
wall-clock; callers bounding device work must synchronize before the span
closes, same rule as ``PhaseTimer.phase(block_on=...)``.

Three sinks hang off these hooks:

- the **recorder** (per-run JSONL, post-hoc analysis) — one process-global
  handed over by :func:`run`;
- the **live sink** — rolling-window in-memory views, installed by
  :func:`set_live_sink`; every hook forwards to it with the same
  zero-cost-when-absent contract the recorder has (one module-global read);
- the **flight sink** — a crash-surviving ring of the most recent events,
  installed by :func:`set_flight_sink`; same contract again.

The flight sink is :class:`gauss_tpu_torch.obs.flight.FlightSink`
(installed by ``obs.flight.install``, which a server with a
``flight_dir`` calls); the live sink is
:class:`gauss_tpu_torch.obs.live.LiveAggregator` (installed by
``obs.live.install``, which a server with a ``live_port`` and the fleet
supervisor's ``--live-port`` call).

Additionally, a thread-local **trace context** (:func:`trace_context`)
stamps every event emitted inside it with a ``trace`` id, so request-scoped
work that flows through library code with no trace parameter still lands
in the right per-request span tree.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional

from gauss_tpu_torch.obs import registry as _registry

# One active recorder per process (a CLI run is one run); a lock guards
# hand-over, and the span stack is thread-local so bench worker threads
# cannot corrupt each other's nesting.
_state_lock = threading.Lock()
_active: Optional[_registry.Recorder] = None
_live = None  # live sink (duck-typed: on_counter/on_gauge/... — see live.py)
_flight = None  # flight sink (same duck type — see flight.py)
_tls = threading.local()


def active() -> Optional[_registry.Recorder]:
    """The recorder events currently report into (None -> hooks no-op)."""
    return _active


def live_sink():
    """The installed live aggregator (None -> live forwarding no-ops)."""
    return _live


def set_live_sink(sink):
    """Install ``sink`` as the process's live telemetry sink; returns the
    previous sink so callers can restore it (the server install/uninstall
    pair). ``None`` uninstalls. The sink receives ``on_counter``,
    ``on_gauge``, ``on_histogram``, ``on_span``, and ``on_event`` calls
    from the same hooks the recorder gets — in-band, no second
    instrumentation path."""
    global _live
    with _state_lock:
        prev = _live
        _live = sink
    return prev


def flight_sink():
    """The installed flight recorder sink (None -> no crash ring)."""
    return _flight


def set_flight_sink(sink):
    """Install ``sink`` as the process's crash-surviving flight sink;
    returns the previous sink so callers can restore (and close) it.
    ``None`` uninstalls. Receives the same ``on_counter``/``on_gauge``/
    ``on_histogram``/``on_span``/``on_event`` calls as the live sink —
    the ring sees exactly the stream everything else sees."""
    global _flight
    with _state_lock:
        prev = _flight
        _flight = sink
    return prev


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


# -- trace context ---------------------------------------------------------

def current_trace() -> Optional[str]:
    """The trace id events on THIS thread are being stamped with."""
    return getattr(_tls, "trace", None)


@contextlib.contextmanager
def trace_context(trace_id: Optional[str]):
    """Stamp every event emitted on this thread inside the block with
    ``trace=trace_id`` (unless the emit already carries one). Nests: the
    innermost context wins, the outer one is restored on exit."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace_id
    try:
        yield
    finally:
        _tls.trace = prev


@contextlib.contextmanager
def run(metrics_out=None, run_id: Optional[str] = None, **meta):
    """Activate a recorder for the duration of the block; flush to
    ``metrics_out`` (JSONL, append) on exit when given. Re-entrant use nests
    harmlessly: an inner ``run`` with no ``metrics_out`` reuses the outer
    recorder instead of shadowing it, so library code can declare a run
    without stealing the caller's.

    ``run_id`` defaults to the GAUSS_OBS_RUN_ID environment variable when
    set — the multihost hook: a launcher exports one id to every process so
    their per-process streams merge as ONE run in ``obs.aggregate``."""
    global _active
    with _state_lock:
        outer = _active
        if outer is not None and metrics_out is None:
            rec = outer
        else:
            rec = _registry.Recorder(
                run_id=run_id or os.environ.get("GAUSS_OBS_RUN_ID"),
                meta=meta)
            _active = rec
    try:
        yield rec
    finally:
        if rec is not outer:
            rec.close()
            with _state_lock:
                _active = outer
            if metrics_out:
                rec.flush(metrics_out)


def emit(type_: str, **fields):
    """Record one event on the active recorder and forward it to the live
    sink (no-op when neither is present). Events emitted inside a
    :func:`trace_context` are stamped with the context's trace id."""
    rec = _active
    ls = _live
    fs = _flight
    if rec is None and ls is None and fs is None:
        return None
    tid = getattr(_tls, "trace", None)
    if tid is not None and "trace" not in fields and "traces" not in fields:
        fields["trace"] = tid
    ev = rec.emit(type_, **fields) if rec is not None else None
    if ls is not None:
        ls.on_event(type_, fields)
    if fs is not None:
        fs.on_event(type_, fields)
    return ev


def counter(name: str, inc: float = 1) -> None:
    rec = _active
    if rec is not None:
        rec.counter(name, inc)
    ls = _live
    if ls is not None:
        ls.on_counter(name, inc)
    fs = _flight
    if fs is not None:
        fs.on_counter(name, inc)


def gauge(name: str, value: float) -> None:
    rec = _active
    if rec is not None:
        rec.gauge(name, value)
    ls = _live
    if ls is not None:
        ls.on_gauge(name, value)
    fs = _flight
    if fs is not None:
        fs.on_gauge(name, value)


def histogram(name: str, value: float) -> None:
    rec = _active
    if rec is not None:
        rec.histogram(name, value)
    ls = _live
    if ls is not None:
        ls.on_histogram(name, value)
    fs = _flight
    if fs is not None:
        fs.on_histogram(name, value)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a named region; records a ``span`` event with parent/depth on
    exit. Zero-cost (two global reads) when no sink is active."""
    rec = _active
    ls = _live
    fs = _flight
    if rec is None and ls is None and fs is None:
        yield
        return
    stack = _stack()
    parent = stack[-1] if stack else None
    stack.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        stack.pop()
        tid = getattr(_tls, "trace", None)
        if tid is not None and "trace" not in attrs and "traces" not in attrs:
            attrs = dict(attrs, trace=tid)
        if rec is not None:
            rec.emit("span", name=name, dur_s=round(dur, 6), parent=parent,
                     depth=len(stack), **attrs)
            rec.histogram(f"span.{name}.s", dur)
        if ls is not None:
            ls.on_span(name, dur, parent, len(stack), attrs)
        if fs is not None:
            fs.on_span(name, dur, parent, len(stack), attrs)


def record_span(name: str, seconds: float, parent: Optional[str] = None,
                **attrs) -> None:
    """Record an externally measured duration as a span (for spans whose
    wall-clock was produced elsewhere — ``timed_fetch`` results, PhaseTimer
    phases, the reference-parity CLI timing numbers). Parent defaults to the
    currently open span of THIS thread, so these interleave correctly with
    ``with span(...)`` nesting."""
    rec = _active
    ls = _live
    fs = _flight
    if rec is None and ls is None and fs is None:
        return
    stack = _stack()
    if parent is None and stack:
        parent = stack[-1]
    if rec is not None:
        rec.emit("span", name=name, dur_s=round(float(seconds), 6),
                 parent=parent, depth=len(stack), **attrs)
        rec.histogram(f"span.{name}.s", float(seconds))
    if ls is not None:
        ls.on_span(name, float(seconds), parent, len(stack), attrs)
    if fs is not None:
        fs.on_span(name, float(seconds), parent, len(stack), attrs)

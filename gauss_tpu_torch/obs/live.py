"""Live telemetry aggregator: rolling-window views the process can serve
(the port of ``gauss_tpu/obs/live.py``, stdlib only).

The per-run JSONL stream is *post-hoc*: summarized after the process
exits. Long-lived processes (``SolverServer``, the fleet supervisor
``python -m gauss_tpu_torch.resilience.fleet``) need the complementary
half — numbers you can read WHILE the system runs. This module is that
half:

- :class:`RollingWindow` — a fixed-capacity ring buffer of ``(t, value)``
  samples with an optional time horizon, plus numpy-compatible quantiles
  over the surviving window (the "latency sketch": p50/p95/p99 over the
  last N observations, exact within the window — asserted against
  ``np.quantile`` in tests).
- :class:`LiveAggregator` — the live sink the obs hooks forward into
  (:func:`gauss_tpu_torch.obs.spans.set_live_sink`): monotonic counter totals,
  last-write gauges, one rolling window per histogram/span series, plus
  per-counter increment windows so windowed RATES (requests/s over the
  last minute) come from the same stream. It also hosts the SLO monitors
  (:mod:`gauss_tpu_torch.obs.slo`) — terminal ``serve_request`` events feed the
  burn-rate windows in-band — and the on-demand trace capture the
  ``/trace`` endpoint uses.

Everything is lock-cheap: one mutex around plain dict/ring updates —
no allocation beyond ring slots, no sorting until a reader asks. With no
sink installed the obs hooks stay the zero-cost no-ops they were (two
module-global reads).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from gauss_tpu_torch.obs import registry as _registry
from gauss_tpu_torch.obs import spans as _spans

DEFAULT_WINDOW = 1024          # ring capacity per series
DEFAULT_HORIZON_S = 600.0      # samples older than this leave the window


def quantile(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    """Linear-interpolation quantile over an ascending sequence — the same
    definition ``np.quantile`` defaults to, so window quantiles are exact
    (within the window), not an approximation."""
    n = len(sorted_vals)
    if n == 0:
        return None
    if n == 1:
        return float(sorted_vals[0])
    pos = min(max(q, 0.0), 1.0) * (n - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac)


class RollingWindow:
    """Fixed-capacity ring of ``(t, value)`` samples with a time horizon.

    ``add`` is O(1); readers pay the sort. NOT internally locked — the
    owning aggregator serializes access (one lock for the whole sink is
    cheaper than one per series).
    """

    __slots__ = ("capacity", "horizon_s", "_buf", "_next", "count", "total")

    def __init__(self, capacity: int = DEFAULT_WINDOW,
                 horizon_s: Optional[float] = DEFAULT_HORIZON_S):
        if capacity < 1:
            raise ValueError(f"window capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.horizon_s = horizon_s
        self._buf: List[Tuple[float, float]] = []
        self._next = 0          # ring write index once the buffer is full
        self.count = 0          # all-time observation count
        self.total = 0.0        # all-time sum

    def add(self, value: float, t: Optional[float] = None) -> None:
        t = time.monotonic() if t is None else t
        item = (t, float(value))
        if len(self._buf) < self.capacity:
            self._buf.append(item)
        else:
            self._buf[self._next] = item
            self._next = (self._next + 1) % self.capacity
        self.count += 1
        self.total += float(value)

    def items(self, now: Optional[float] = None,
              horizon_s: Optional[float] = None) -> List[Tuple[float, float]]:
        """Samples still inside the horizon (unordered by time is fine for
        quantiles; rate readers filter by t anyway)."""
        horizon = self.horizon_s if horizon_s is None else horizon_s
        if horizon is None:
            return list(self._buf)
        now = time.monotonic() if now is None else now
        cutoff = now - horizon
        return [it for it in self._buf if it[0] >= cutoff]

    def values(self, now: Optional[float] = None,
               horizon_s: Optional[float] = None) -> List[float]:
        return [v for _, v in self.items(now, horizon_s)]

    def quantiles(self, qs: Sequence[float], now: Optional[float] = None,
                  ) -> Dict[str, Optional[float]]:
        vals = sorted(self.values(now))
        return {f"p{int(q * 100)}": quantile(vals, q) for q in qs}


class LiveAggregator:
    """The process's live metrics plane (install via :func:`install`).

    Counters accumulate monotonically (Prometheus counter semantics) and
    additionally record each increment into a rolling window, so
    :meth:`window_rate` answers "requests/s over the last minute" from the
    same stream. Histogram observations (including every ``span.<name>.s``)
    land in per-series rolling windows read back as p50/p95/p99.
    """

    def __init__(self, window: int = DEFAULT_WINDOW,
                 horizon_s: float = DEFAULT_HORIZON_S,
                 slos: Sequence = ()):
        self._lock = threading.Lock()
        self.t0 = time.monotonic()
        self.t0_unix = time.time()
        self.window = window
        self.horizon_s = horizon_s
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.windows: Dict[str, RollingWindow] = {}
        self._increments: Dict[str, RollingWindow] = {}
        from gauss_tpu_torch.obs import slo as _slo

        self.slos = [s if isinstance(s, _slo.SLOMonitor) else _slo.SLOMonitor(s)
                     for s in slos]
        # on-demand trace capture (the /trace endpoint): a real Recorder the
        # hooks tee into while armed, completed after N serve_batch events.
        self._capture: Optional[_registry.Recorder] = None
        self._capture_left = 0
        self._capture_done = threading.Event()

    # -- sink interface (called by gauss_tpu_torch.obs.spans hooks) --------------

    def on_counter(self, name: str, inc: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + inc
            win = self._increments.get(name)
            if win is None:
                win = self._increments[name] = RollingWindow(
                    self.window, self.horizon_s)
            win.add(inc)

    def on_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def on_histogram(self, name: str, value: float) -> None:
        with self._lock:
            win = self.windows.get(name)
            if win is None:
                win = self.windows[name] = RollingWindow(
                    self.window, self.horizon_s)
            win.add(float(value))

    def on_span(self, name: str, dur_s: float, parent: Optional[str],
                depth: int, attrs: Dict[str, Any]) -> None:
        self.on_histogram(f"span.{name}.s", dur_s)
        cap = self._capture
        if cap is not None:
            cap.emit("span", name=name, dur_s=round(dur_s, 6), parent=parent,
                     depth=depth, **attrs)

    def on_event(self, type_: str, fields: Dict[str, Any]) -> None:
        cap = self._capture
        if cap is not None and type_ != "alert":
            cap.emit(type_, **fields)
            if type_ == "serve_batch":
                with self._lock:
                    if self._capture_left > 0:
                        self._capture_left -= 1
                        if self._capture_left == 0:
                            self._capture_done.set()
        if type_ == "health":
            # numerical-health monitors become live gauges (last value
            # wins): min pivot, growth, residuals — scraped next to the
            # serving counters so a numerically sick lane is visible
            # BEFORE the post-hoc summary.
            with self._lock:
                for k, v in fields.items():
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        self.gauges[f"health.{k}"] = float(v)
            return
        if type_ == "serve_request" and self.slos:
            status = fields.get("status")
            if status is not None:
                self.observe_slo(str(status))

    # -- SLO plumbing ------------------------------------------------------

    def observe_slo(self, status: str, now: Optional[float] = None) -> None:
        """Feed one terminal request status to every SLO monitor; emit
        ``alert`` obs events for state transitions (outside the lock —
        the emit re-enters this sink through on_event)."""
        transitions = []
        with self._lock:
            for mon in self.slos:
                tr = mon.observe(status, now=now)
                if tr is not None:
                    transitions.append(tr)
        for tr in transitions:
            _spans.counter("slo.alerts" if tr["state"] == "firing"
                           else "slo.clears")
            _spans.emit("alert", **tr)
            if tr["state"] == "firing":
                # In-process crash detection: a firing burn-rate alert
                # freezes the flight ring into a post-mortem bundle while
                # the degradation is still observable. The trigger is a
                # no-op unless the server armed it (flight_dir set) and is
                # throttled there — a flapping alert cannot bundle-storm.
                try:
                    from gauss_tpu_torch.obs import postmortem as _postmortem

                    _postmortem.trigger("slo_alert", slo=tr.get("slo"),
                                        burn_short=tr.get("burn_short"),
                                        burn_long=tr.get("burn_long"))
                except Exception:  # pragma: no cover — capture is best-effort
                    pass

    def slo_firing(self) -> bool:
        """Is any SLO alert currently firing? (The shed-wiring consult:
        one lock + list scan, cheap enough for the admission path.)"""
        with self._lock:
            return any(mon.firing for mon in self.slos)

    def slo_status(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        with self._lock:
            return [mon.status(now=now) for mon in self.slos]

    # -- readers -----------------------------------------------------------

    def window_rate(self, counter: str, horizon_s: float = 60.0,
                    now: Optional[float] = None) -> float:
        """Increments/s of ``counter`` over the trailing ``horizon_s``."""
        now = time.monotonic() if now is None else now
        with self._lock:
            win = self._increments.get(counter)
            if win is None:
                return 0.0
            total = sum(v for t, v in win.items(now, horizon_s))
        return total / horizon_s if horizon_s > 0 else 0.0

    def snapshot(self, quantiles=(0.5, 0.95, 0.99),
                 now: Optional[float] = None) -> Dict[str, Any]:
        """One coherent read of the whole plane (the /metrics payload)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            windows = {
                name: {"count": win.count, "sum": win.total,
                       **win.quantiles(quantiles, now=now)}
                for name, win in self.windows.items()}
            slos = [mon.status(now=now) for mon in self.slos]
        return {"uptime_s": now - self.t0, "time_unix": time.time(),
                "counters": counters, "gauges": gauges, "windows": windows,
                "slo": slos}

    # -- on-demand trace capture (the /trace endpoint) ---------------------

    def start_capture(self, batches: int = 1, **meta) -> str:
        """Arm a capture of the next ``batches`` served batches; returns
        the capture run id. One capture at a time (409 at the endpoint)."""
        if batches < 1:
            raise ValueError(f"batches must be >= 1, got {batches}")
        with self._lock:
            if self._capture is not None:
                raise RuntimeError("a trace capture is already running")
            self._capture_done.clear()
            self._capture_left = batches
            self._capture = _registry.Recorder(
                meta={"tool": "live_trace_capture", "batches": batches,
                      **meta})
        return self._capture.run_id

    def wait_capture(self, timeout: Optional[float] = None) -> bool:
        """Block until the armed capture saw its N batches (False on
        timeout — the partial capture is still collectable)."""
        return self._capture_done.wait(timeout)

    def finish_capture(self) -> List[Dict[str, Any]]:
        """Disarm the capture and return its events (run_end stamped)."""
        with self._lock:
            cap, self._capture = self._capture, None
            self._capture_left = 0
        if cap is None:
            raise RuntimeError("no trace capture is running")
        cap.close()
        return cap.events + cap._registry_events()


def install(aggregator: LiveAggregator):
    """Install ``aggregator`` as the process live sink; returns the
    previous sink (restore it with :func:`uninstall`)."""
    return _spans.set_live_sink(aggregator)


def uninstall(previous=None) -> None:
    """Remove the live sink (restoring ``previous`` when given)."""
    _spans.set_live_sink(previous)

"""/metrics exposition + the embedded live-telemetry HTTP plane (the port
of ``gauss_tpu/obs/export.py``, stdlib only).

Pull-based exposition, the production-serving shape: the process embeds one
stdlib ``http.server`` thread (no new dependencies) and anything — a
Prometheus scraper, ``curl``, ``gauss-torch-top`` — reads the live aggregator's
rolling windows while the system runs. Endpoints:

====================  =====================================================
``/metrics``          Prometheus text exposition (v0.0.4): every counter as
                      ``gauss_*_total``, gauges plain, rolling windows as
                      summary quantiles + ``_count``/``_sum``, SLO burn
                      rates/alert states with ``{slo=...}`` labels.
``/healthz``          liveness JSON: uptime, counts, firing-alert count.
``/slo``              full SLO monitor states as JSON.
``/snapshot``         the raw aggregator snapshot as JSON (gauss-torch-top's
                      fallback; /metrics is the stable surface).
``/trace?batches=N``  arm an on-demand capture, block until the running
                      server has served N more batches (or ``timeout=S``),
                      return the Chrome-trace JSON — the Chrome-trace
                      exporter (obs.trace) pointed at a LIVE process instead of a
                      flushed file. 409 when a capture is already armed.
====================  =====================================================

Metric name mangling is mechanical and stable: ``serve.cache.hits`` ->
``gauss_serve_cache_hits_total``; the window ``span.serve_batch_solve.s``
-> ``gauss_span_serve_batch_solve_s{quantile="0.5"}``. A scrape totals-
match with the loadgen's final report is asserted by ``python -m
gauss_tpu_torch.obs.livecheck``.

Deliberate deviation: the attribution plane (``obs/attr``) is not ported,
so :func:`attr_status` (the ``attr`` section of ``/snapshot``) is always
``{"recording": False}``.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

from gauss_tpu_torch.obs.live import LiveAggregator

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_QUANTILES = {"p50": "0.5", "p95": "0.95", "p99": "0.99"}


def flight_status() -> Dict[str, Any]:
    """The flight-recorder section of ``/snapshot``: whether this process
    is recording, its ring position, and the LAST post-mortem bundle
    pointer (cause/time parsed from the filename — no body read per
    scrape). ``{"recording": False}`` when no sink is installed."""
    from gauss_tpu_torch.obs import spans

    sink = spans.flight_sink()
    out: Dict[str, Any] = {"recording": sink is not None}
    if sink is None:
        return out
    try:
        out["flight_dir"] = sink.flight_dir
        out["ring"] = sink.position()
    except Exception:  # pragma: no cover — a scrape never takes serving down
        return out
    try:
        from gauss_tpu_torch.obs import postmortem

        last = postmortem.latest_bundle(
            postmortem.default_bundles_dir(sink.flight_dir))
        if last:
            out["last_bundle"] = postmortem.bundle_info(last)
    except Exception:  # pragma: no cover
        pass
    return out


def attr_status() -> Dict[str, Any]:
    """The attribution-plane section of ``/snapshot``. The plane
    (``obs/attr``) is not ported, so it is always ``{"recording": False}``
    — the JAX package's value when its plane is off."""
    return {"recording": False}


def metric_name(name: str, prefix: str = "gauss") -> str:
    """Flatten a dotted obs name into a legal Prometheus metric name."""
    flat = _NAME_RE.sub("_", name.strip("."))
    if flat and flat[0].isdigit():
        flat = "_" + flat
    return f"{prefix}_{flat}" if prefix else flat


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus(snapshot: Dict[str, Any], prefix: str = "gauss",
                      flight: Optional[Dict[str, Any]] = None) -> str:
    """Render an aggregator snapshot as the Prometheus text format.

    Deterministic (sorted by metric name) so the format has a golden test;
    one ``# TYPE`` line per family, counters suffixed ``_total``, windows
    rendered as summaries (quantile labels + _count/_sum). ``flight`` (the
    :func:`flight_status` dict) adds the flight-ring position gauges and —
    because Prometheus values are numeric-only — the last post-mortem's
    CAUSE as a label on its age gauge:
    ``gauss_postmortem_last_age_s{cause="..."}``."""
    lines = []

    def family(name: str, typ: str, help_: Optional[str] = None):
        if help_:
            lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {typ}")

    up = metric_name("live.uptime_s", prefix)
    family(up, "gauge", "seconds since the live aggregator started")
    lines.append(f"{up} {_fmt_value(snapshot.get('uptime_s', 0.0))}")

    for name in sorted(snapshot.get("counters", {})):
        m = metric_name(name, prefix) + "_total"
        family(m, "counter")
        lines.append(f"{m} {_fmt_value(snapshot['counters'][name])}")

    for name in sorted(snapshot.get("gauges", {})):
        m = metric_name(name, prefix)
        family(m, "gauge")
        lines.append(f"{m} {_fmt_value(snapshot['gauges'][name])}")

    for name in sorted(snapshot.get("windows", {})):
        win = snapshot["windows"][name]
        m = metric_name(name, prefix)
        family(m, "summary")
        for key, q in _QUANTILES.items():
            if win.get(key) is not None:
                lines.append(f'{m}{{quantile="{q}"}} '
                             f"{_fmt_value(win[key])}")
        lines.append(f"{m}_count {_fmt_value(win.get('count', 0))}")
        lines.append(f"{m}_sum {_fmt_value(win.get('sum', 0.0))}")

    slos = snapshot.get("slo") or []
    if slos:
        burn = metric_name("slo.burn_rate", prefix)
        family(burn, "gauge", "error-budget burn rate per SLO window")
        firing = metric_name("slo.firing", prefix)
        alerts = metric_name("slo.alerts", prefix) + "_total"
        objective = metric_name("slo.objective", prefix)
        viol = metric_name("slo.violation_rate", prefix)
        for s in sorted(slos, key=lambda s: s.get("name", "")):
            lines.append(f'{burn}{{slo="{s["name"]}",window="short"}} '
                         f"{_fmt_value(s['burn_short'])}")
            lines.append(f'{burn}{{slo="{s["name"]}",window="long"}} '
                         f"{_fmt_value(s['burn_long'])}")
        family(firing, "gauge", "1 while the SLO alert is firing")
        for s in sorted(slos, key=lambda s: s.get("name", "")):
            lines.append(f'{firing}{{slo="{s["name"]}"}} '
                         f"{1 if s.get('firing') else 0}")
        family(alerts, "counter")
        for s in sorted(slos, key=lambda s: s.get("name", "")):
            lines.append(f'{alerts}{{slo="{s["name"]}"}} '
                         f"{_fmt_value(s.get('alerts', 0))}")
        family(objective, "gauge")
        for s in sorted(slos, key=lambda s: s.get("name", "")):
            lines.append(f'{objective}{{slo="{s["name"]}"}} '
                         f"{_fmt_value(s.get('objective', 0.0))}")
        family(viol, "gauge")
        for s in sorted(slos, key=lambda s: s.get("name", "")):
            lines.append(f'{viol}{{slo="{s["name"]}"}} '
                         f"{_fmt_value(s.get('violation_rate', 0.0))}")

    if flight and flight.get("recording"):
        rec = metric_name("flight.recording", prefix)
        family(rec, "gauge", "1 while the flight recorder ring is on")
        lines.append(f"{rec} 1")
        ring = flight.get("ring") or {}
        for key in ("wpos", "seq", "capacity", "dropped_oversize"):
            if key in ring:
                m = metric_name(f"flight.ring_{key}", prefix)
                family(m, "gauge")
                lines.append(f"{m} {_fmt_value(ring[key])}")
        last = flight.get("last_bundle")
        if last and isinstance(last.get("time_unix"), (int, float)):
            m = metric_name("postmortem.last_age_s", prefix)
            family(m, "gauge",
                   "seconds since the last post-mortem bundle was captured")
            cause = str(last.get("cause") or "unknown").replace('"', "'")
            age = max(0.0, time.time() - float(last["time_unix"]))
            lines.append(f'{m}{{cause="{cause}"}} {_fmt_value(age)}')
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "gauss-live/1"
    agg: LiveAggregator = None  # type: ignore[assignment] # set per server

    def log_message(self, fmt, *args):  # quiet: obs, not stdout noise
        pass

    def _reply(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):  # client went away
            pass

    def _json(self, code: int, payload) -> None:
        self._reply(code, json.dumps(payload, sort_keys=True) + "\n",
                    "application/json")

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        url = urlparse(self.path)
        agg = self.agg
        if url.path == "/metrics":
            agg.on_counter("live.scrapes")
            self._reply(200,
                        render_prometheus(agg.snapshot(),
                                          flight=flight_status()),
                        "text/plain; version=0.0.4; charset=utf-8")
        elif url.path == "/healthz":
            snap = agg.snapshot()
            self._json(200, {
                "status": "ok", "uptime_s": round(snap["uptime_s"], 3),
                "counters": len(snap["counters"]),
                "windows": len(snap["windows"]),
                "slo_firing": sum(1 for s in snap["slo"]
                                  if s.get("firing"))})
        elif url.path == "/slo":
            self._json(200, {"slo": agg.slo_status()})
        elif url.path == "/snapshot":
            snap = agg.snapshot()
            snap["flight"] = flight_status()
            snap["attr"] = attr_status()
            self._json(200, snap)
        elif url.path == "/trace":
            self._trace(parse_qs(url.query))
        else:
            self._json(404, {"error": f"unknown endpoint {url.path!r}",
                             "endpoints": ["/metrics", "/healthz", "/slo",
                                           "/snapshot", "/trace"]})

    def _trace(self, q) -> None:
        from gauss_tpu_torch.obs import trace as _trace

        try:
            batches = int(q.get("batches", ["1"])[0])
            timeout = float(q.get("timeout", ["30"])[0])
        except ValueError as e:
            self._json(400, {"error": f"bad query: {e}"})
            return
        try:
            self.agg.start_capture(batches=batches)
        except RuntimeError as e:
            self._json(409, {"error": str(e)})
            return
        except ValueError as e:
            self._json(400, {"error": str(e)})
            return
        complete = self.agg.wait_capture(timeout)
        events = self.agg.finish_capture()
        try:
            doc = _trace.to_chrome_trace(events)
        except ValueError as e:  # no spans arrived at all
            self._json(408, {"error": f"capture timed out empty: {e}"})
            return
        doc["otherData"]["complete"] = complete
        self._json(200 if complete else 206, doc)


class LiveServer:
    """The embedded telemetry endpoint: one daemon thread serving the
    aggregator. ``port=0`` binds an ephemeral port (tests); read the bound
    address back from :attr:`port` / :attr:`url`."""

    def __init__(self, aggregator: LiveAggregator, port: int = 0,
                 host: str = "127.0.0.1"):
        self.agg = aggregator
        handler = type("BoundHandler", (_Handler,), {"agg": aggregator})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "LiveServer":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="gauss-live",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "LiveServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

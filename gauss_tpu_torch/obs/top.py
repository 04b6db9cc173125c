"""``gauss-torch-top`` — a live terminal dashboard over a /metrics endpoint
(the port of ``gauss_tpu/obs/top.py``; ``python -m gauss_tpu_torch.obs.top``).

Polls the Prometheus text exposition a ``SolverServer`` (``python -m
gauss_tpu_torch.serve.cli --live-port``) or the fleet supervisor
(``python -m gauss_tpu_torch.resilience.fleet --live-port``) embeds, and renders the
numbers an operator watches during an incident: request totals and rates,
latency quantiles, queue depth and batch occupancy, cache hit-rate,
breaker state, SLO burn rates with firing alerts, and fleet heartbeat
ages. Stdlib only (urllib + ANSI clears); ``--once`` prints a single frame
and exits (the scriptable/CI form), ``--json`` dumps the parsed samples.

The parser speaks enough of the exposition format for our own exporter
(and any standard one): ``name{label="v",...} value`` lines, comments
skipped. It is intentionally NOT a full openmetrics parser.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)\s*$")
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')

Sample = Tuple[str, Dict[str, str], float]


def parse_metrics(text: str) -> List[Sample]:
    """Parse exposition text into (name, labels, value) samples."""
    out: List[Sample] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        labels = dict(_LABEL_RE.findall(m.group("labels") or ""))
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        out.append((m.group("name"), labels, value))
    return out


def scrape(url: str, timeout: float = 5.0) -> List[Sample]:
    with urllib.request.urlopen(f"{url.rstrip('/')}/metrics",
                                timeout=timeout) as resp:
        return parse_metrics(resp.read().decode())


class _View:
    """Indexed access over one scrape."""

    def __init__(self, samples: List[Sample]):
        self.samples = samples
        self._plain = {name: v for name, labels, v in samples if not labels}

    def get(self, name: str, default: Optional[float] = None):
        return self._plain.get(name, default)

    def labeled(self, name: str) -> List[Tuple[Dict[str, str], float]]:
        return [(labels, v) for n, labels, v in self.samples
                if n == name and labels]

    def prefixed(self, prefix: str) -> Dict[str, float]:
        return {n: v for n, v in self._plain.items()
                if n.startswith(prefix)}


def _fmt(v: Optional[float], unit: str = "", digits: int = 3) -> str:
    if v is None:
        return "-"
    if unit == "ms":
        return f"{v * 1e3:.{digits}f}ms"
    if float(v).is_integer() and abs(v) < 1e12:
        return f"{int(v)}{unit}"
    return f"{v:.{digits}f}{unit}"


def render(view: _View, url: str,
           prev: Optional[_View] = None, dt: float = 0.0) -> str:
    g = view.get
    lines = [f"gauss-top — {url}  (uptime "
             f"{_fmt(g('gauss_live_uptime_s'), 's', 1)})"]

    def rate(name: str) -> str:
        if prev is None or dt <= 0:
            return ""
        now, before = view.get(name), prev.get(name)
        if now is None or before is None:
            return ""
        return f" ({(now - before) / dt:.1f}/s)"

    served = g("gauss_serve_served_total")
    if served is not None or g("gauss_serve_submitted_total") is not None:
        lines.append(
            "  requests: "
            f"submitted {_fmt(g('gauss_serve_submitted_total', 0))}"
            f"{rate('gauss_serve_submitted_total')}, "
            f"served {_fmt(g('gauss_serve_served_total', 0))}"
            f"{rate('gauss_serve_served_total')}, "
            f"rejected {_fmt(g('gauss_serve_rejected_total', 0))}, "
            f"expired {_fmt(g('gauss_serve_expired_total', 0))}, "
            f"failed {_fmt(g('gauss_serve_failed_total', 0))}, "
            f"cancelled {_fmt(g('gauss_serve_cancelled_total', 0))}")
        q = {labels.get("quantile"): v for labels, v
             in view.labeled("gauss_serve_latency_s")}
        if q:
            lines.append(
                f"  latency: p50 {_fmt(q.get('0.5'), 'ms')}  "
                f"p95 {_fmt(q.get('0.95'), 'ms')}  "
                f"p99 {_fmt(q.get('0.99'), 'ms')}  "
                f"(window n={_fmt(g('gauss_serve_latency_s_count'))})")
        occ = {labels.get("quantile"): v for labels, v
               in view.labeled("gauss_serve_batch_occupancy")}
        breaker = g("gauss_serve_breaker_open")
        lines.append(
            f"  lane: queue depth {_fmt(g('gauss_serve_queue_depth', 0))}, "
            f"batches {_fmt(g('gauss_serve_batches_total', 0))}"
            f"{rate('gauss_serve_batches_total')}, occupancy p50 "
            f"{_fmt(occ.get('0.5'))}, retries "
            f"{_fmt(g('gauss_serve_retries_total', 0))}, breaker "
            + ("OPEN" if breaker else "closed"))
        hits = g("gauss_serve_cache_hits_total", 0)
        misses = g("gauss_serve_cache_misses_total", 0)
        total = (hits or 0) + (misses or 0)
        lines.append(
            f"  cache: {_fmt(hits)} hits / {_fmt(misses)} misses"
            + (f" (hit-rate {hits / total:.3f})" if total else "")
            + f", evictions {_fmt(g('gauss_serve_cache_evictions_total', 0))}"
            + (f"; tune store {_fmt(g('gauss_tune_store_hits_total', 0))}h/"
               f"{_fmt(g('gauss_tune_store_misses_total', 0))}m"
               if g("gauss_tune_store_hits_total") is not None
               or g("gauss_tune_store_misses_total") is not None else ""))

    # Mesh serving plane (serve.lanes): per-lane occupancy/steal panel.
    # Lane gauges are plain-named gauss_serve_lane<i>_<stat>; one row per
    # lane index found, plus the set-wide steal/cb/active counters.
    lane_samples = view.prefixed("gauss_serve_lane")
    if lane_samples:
        per: Dict[int, Dict[str, float]] = {}
        for name, v in lane_samples.items():
            m = re.match(r"gauss_serve_lane(\d+)_(\w+)", name)
            if m:
                per.setdefault(int(m.group(1)), {})[m.group(2)] = v
        lines.append(
            f"  mesh: {_fmt(g('gauss_serve_lanes_active'))} active "
            f"lane(s), steals {_fmt(g('gauss_serve_steals_total', 0))}"
            f"{rate('gauss_serve_steals_total')}, cb admits "
            f"{_fmt(g('gauss_serve_cb_admits_total', 0))}"
            f"{rate('gauss_serve_cb_admits_total')}, scale events "
            f"{_fmt(g('gauss_serve_lane_scales_total', 0))}")
        for idx in sorted(per):
            s = per[idx]
            lines.append(
                f"    lane {idx}: depth {_fmt(s.get('queue_depth', 0))}, "
                f"served {_fmt(s.get('served', 0))}, stolen "
                f"{_fmt(s.get('stolen', 0))}, occupancy "
                f"{_fmt(s.get('occupancy'))}")

    # Utilization panel (obs.attr): per-lane achieved-vs-peak, stall
    # fraction and device-seconds per wall-second, plus the per-engine
    # roofline fractions. Gauges are plain-named gauss_util_lane<i>_<stat>
    # / gauss_util_<engine>_<stat>; absent entirely when the attribution
    # plane is off (ServeConfig(attr=None)).
    util_samples = view.prefixed("gauss_util_")
    if util_samples:
        ulanes: Dict[int, Dict[str, float]] = {}
        engines: Dict[str, Dict[str, float]] = {}
        for name, v in util_samples.items():
            m = re.match(r"gauss_util_lane(\d+)_(\w+)", name)
            if m:
                ulanes.setdefault(int(m.group(1)), {})[m.group(2)] = v
                continue
            m = re.match(r"gauss_util_(\w+?)_"
                         r"(achieved_flops_per_s|flops_frac)$", name)
            if m:
                engines.setdefault(m.group(1), {})[m.group(2)] = v
        lines.append("  utilization (attribution plane):")
        for idx in sorted(ulanes):
            s = ulanes[idx]
            frac = s.get("flops_frac")
            lines.append(
                f"    lane {idx}: "
                f"{_fmt(s.get('achieved_flops_per_s'), digits=3)} flop/s "
                f"achieved ({_fmt(frac, digits=4)} of peak), stall "
                f"{_fmt(s.get('stall_frac'), digits=4)}, device-s/s "
                f"{_fmt(s.get('device_s_per_s'), digits=4)}")
        for eng in sorted(engines):
            s = engines[eng]
            lines.append(
                f"    engine {eng}: "
                f"{_fmt(s.get('achieved_flops_per_s'), digits=3)} flop/s "
                f"achieved ({_fmt(s.get('flops_frac'), digits=4)} of peak)")

    firing = view.labeled("gauss_slo_firing")
    if firing:
        burns = {(labels.get("slo"), labels.get("window")): v
                 for labels, v in view.labeled("gauss_slo_burn_rate")}
        alerts = {labels.get("slo"): v for labels, v
                  in view.labeled("gauss_slo_alerts_total")}
        for labels, state in sorted(firing,
                                    key=lambda lv: lv[0].get("slo", "")):
            name = labels.get("slo", "?")
            flag = "FIRING" if state else "ok"
            lines.append(
                f"  slo {name}: {flag}  burn short "
                f"{_fmt(burns.get((name, 'short')), 'x', 2)} / long "
                f"{_fmt(burns.get((name, 'long')), 'x', 2)}, "
                f"{_fmt(alerts.get(name, 0))} alert(s)")

    # Flight recorder / post-mortem panel: the cause rides as a label on
    # the age gauge (Prometheus values are numeric-only).
    pm = view.labeled("gauss_postmortem_last_age_s")
    if pm:
        for labels, age in sorted(pm, key=lambda lv: lv[0].get("cause", "")):
            lines.append(
                f"  last post-mortem: {labels.get('cause', '?')} "
                f"{_fmt(age, 's', 1)} ago "
                f"({_fmt(g('gauss_postmortem_bundles_total', 0))} bundle(s) "
                f"this process; inspect with gauss-debug)")
    elif g("gauss_flight_recording"):
        lines.append(
            f"  flight recorder: on, ring at "
            f"{_fmt(g('gauss_flight_ring_wpos'))}/"
            f"{_fmt(g('gauss_flight_ring_capacity'))} bytes "
            f"({_fmt(g('gauss_flight_ring_seq'))} records), no post-mortems")

    hearts = view.prefixed("gauss_fleet_w")
    if hearts:
        ages = ", ".join(
            f"{n.removeprefix('gauss_fleet_').removesuffix('_heartbeat_age_s')}"
            f"={v:.1f}s" for n, v in sorted(hearts.items()))
        lines.append(
            f"  fleet: world {_fmt(view.get('gauss_fleet_world'))}, "
            f"heartbeat ages: {ages}; restarts "
            f"{_fmt(view.get('gauss_fleet_restarts_total', 0))}, stalls "
            f"{_fmt(view.get('gauss_fleet_stalls_total', 0))}")

    if len(lines) == 1:
        lines.append("  (no serving/fleet series yet — is traffic "
                     "flowing?)")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gauss-torch-top",
        description="Live terminal dashboard over a gauss live-telemetry "
                    "/metrics endpoint (gauss_tpu_torch.serve.cli "
                    "--live-port / gauss_tpu_torch.resilience.fleet "
                    "--live-port).")
    p.add_argument("--url", default="http://127.0.0.1:9100",
                   help="endpoint base URL (default http://127.0.0.1:9100)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="poll interval in seconds (default 2)")
    p.add_argument("--once", action="store_true",
                   help="print one frame and exit (scriptable form)")
    p.add_argument("--json", action="store_true",
                   help="dump the parsed samples as JSON instead of the "
                        "dashboard")
    args = p.parse_args(argv)

    prev: Optional[_View] = None
    prev_t = 0.0
    while True:
        try:
            view = _View(scrape(args.url))
        except (urllib.error.URLError, OSError) as e:
            print(f"gauss-torch-top: cannot scrape {args.url}/metrics: {e}",
                  file=sys.stderr)
            return 2
        now = time.monotonic()
        if args.json:
            print(json.dumps(
                [{"name": n, "labels": lab, "value": v}
                 for n, lab, v in view.samples], indent=1, sort_keys=True))
        else:
            frame = render(view, args.url, prev,
                           now - prev_t if prev is not None else 0.0)
            if not args.once:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print(frame)
        if args.once:
            return 0
        prev, prev_t = view, now
        try:
            time.sleep(max(0.1, args.interval))
        except KeyboardInterrupt:  # pragma: no cover — interactive exit
            return 0


if __name__ == "__main__":
    sys.exit(main())

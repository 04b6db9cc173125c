"""SLO definitions + multi-window burn-rate alerts over the live windows
(the port of ``gauss_tpu/obs/slo.py``, stdlib only).

A service promising "99% of requests verified-correct under deadline"
needs more than a violation counter: it needs to know how FAST it is
spending its error budget. The standard answer (the SRE-workbook
multi-window multi-burn-rate pattern) is encoded here:

- an :class:`SLO` declares the objective (fraction of requests that must be
  *good*) and which terminal statuses count *bad* (default: ``expired`` —
  the deadline was missed — and ``failed``; a shed/rejected request is
  load-control, not a broken promise, unless the SLO says otherwise);
- **burn rate** over a window = (bad fraction in the window) / (allowed bad
  fraction). Burn 1.0 means spending the budget exactly as fast as the SLO
  allows; burn 10 means the budget dies in a tenth of the period.
- an alert **fires** only when BOTH a short and a long window burn above
  ``fire_burn`` — the short window makes detection fast, the long window
  keeps one unlucky batch from paging — and **clears** only when the short
  window burns below ``clear_burn`` (< fire_burn: hysteresis, so the alert
  cannot flap at the threshold).

:class:`SLOMonitor` evaluates this incrementally per observation (O(window)
worst case, on small rings), emits nothing itself — the aggregator turns
transitions into obs ``alert`` events — and renders its state for
``/metrics`` (`gauss_slo_burn_rate{window=...}`) and ``/slo``.

The ``slo_report`` summary (:func:`slo_report`) is the post-run fold the
loadgen exports and ``obs.regress`` ingests (``kind: slo_report``): the
violation rate, the worst burn rate seen, and the alert count gate in CI
exactly like latency percentiles do.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

#: Statuses every monitor treats as a terminal observation; anything else
#: (e.g. a queued progress event) is ignored.
TERMINAL_STATUSES = ("ok", "rejected", "expired", "failed", "cancelled")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One service-level objective over terminal request statuses."""

    name: str = "serve_ok"
    #: fraction of counted requests that must be good (0.99 -> 1% budget)
    objective: float = 0.99
    #: detection window (seconds): fast to rise, fast to clear
    short_window_s: float = 60.0
    #: confirmation window (seconds): one bad batch cannot page alone
    long_window_s: float = 300.0
    #: both windows must burn at/above this to fire
    fire_burn: float = 2.0
    #: the short window must burn at/below this to clear (hysteresis)
    clear_burn: float = 1.0
    #: statuses that spend the error budget
    bad_statuses: Tuple[str, ...] = ("expired", "failed")
    #: statuses excluded from the denominator entirely (cancelled requests
    #: say nothing about the service; rejected ones are load control)
    ignored_statuses: Tuple[str, ...] = ("cancelled",)
    #: observations the short window needs before it may fire (keeps the
    #: very first bad request of a quiet service from burning "infinity")
    min_count: int = 4

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got "
                             f"{self.objective}")
        if self.short_window_s >= self.long_window_s:
            raise ValueError("short_window_s must be < long_window_s")
        if self.clear_burn >= self.fire_burn:
            raise ValueError("clear_burn must be < fire_burn (hysteresis)")


def default_serving_slo() -> SLO:
    """The serving default: 99% of requests terminate ok (verified under
    deadline — the server's verify gate and deadline shedding define ok)."""
    return SLO()


class SLOMonitor:
    """Incremental burn-rate evaluation + alert state for one :class:`SLO`.

    Not internally locked — the owning aggregator serializes ``observe``.
    """

    def __init__(self, slo: SLO, capacity: int = 4096):
        from gauss_tpu_torch.obs.live import RollingWindow

        self.slo = slo
        # one ring, horizon = the long window; the short window filters by t
        self._obs = RollingWindow(capacity=capacity,
                                  horizon_s=slo.long_window_s)
        self.firing = False
        self.alerts = 0              # fire transitions (all-time)
        self.clears = 0              # clear transitions (all-time)
        self.good = 0                # all-time counted good
        self.bad = 0                 # all-time counted bad
        self.worst_burn = 0.0        # worst short-window burn seen
        self._last = (0.0, 0.0)      # last (short, long) burn rates

    def _burn(self, horizon_s: float, now: float) -> float:
        items = self._obs.items(now=now, horizon_s=horizon_s)
        if not items:
            return 0.0
        bad = sum(v for _, v in items)
        frac = bad / len(items)
        return frac / (1.0 - self.slo.objective)

    def burn_rates(self, now: Optional[float] = None) -> Tuple[float, float]:
        now = time.monotonic() if now is None else now
        return (self._burn(self.slo.short_window_s, now),
                self._burn(self.slo.long_window_s, now))

    def observe(self, status: str, now: Optional[float] = None,
                ) -> Optional[Dict[str, Any]]:
        """Count one terminal status; returns the alert-transition payload
        (``state="firing"`` / ``"clear"``) when this observation crossed a
        threshold, else None."""
        s = self.slo
        if status in s.ignored_statuses or status not in TERMINAL_STATUSES:
            return None
        now = time.monotonic() if now is None else now
        bad = status in s.bad_statuses
        self._obs.add(1.0 if bad else 0.0, t=now)
        if bad:
            self.bad += 1
        else:
            self.good += 1
        short, long_ = self.burn_rates(now)
        self._last = (short, long_)
        self.worst_burn = max(self.worst_burn, short)
        in_window = len(self._obs.items(now=now, horizon_s=s.short_window_s))
        if (not self.firing and in_window >= s.min_count
                and short >= s.fire_burn and long_ >= s.fire_burn):
            self.firing = True
            self.alerts += 1
            return self._transition("firing", short, long_)
        if self.firing and short <= s.clear_burn:
            self.firing = False
            self.clears += 1
            return self._transition("clear", short, long_)
        return None

    def _transition(self, state: str, short: float, long_: float,
                    ) -> Dict[str, Any]:
        return {"slo": self.slo.name, "state": state,
                "objective": self.slo.objective,
                "burn_short": round(short, 4), "burn_long": round(long_, 4),
                "fire_burn": self.slo.fire_burn,
                "clear_burn": self.slo.clear_burn,
                "windows_s": [self.slo.short_window_s,
                              self.slo.long_window_s]}

    def status(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The monitor's full render (the ``/slo`` payload and the
        per-SLO ``/metrics`` lines)."""
        short, long_ = self.burn_rates(now)
        counted = self.good + self.bad
        return {"name": self.slo.name, "objective": self.slo.objective,
                "firing": self.firing, "alerts": self.alerts,
                "clears": self.clears,
                "burn_short": round(short, 4), "burn_long": round(long_, 4),
                "worst_burn": round(self.worst_burn, 4),
                "good": self.good, "bad": self.bad,
                "violation_rate": (round(self.bad / counted, 6)
                                   if counted else 0.0),
                "windows_s": [self.slo.short_window_s,
                              self.slo.long_window_s],
                "fire_burn": self.slo.fire_burn,
                "clear_burn": self.slo.clear_burn}


def slo_report(monitors: List[SLOMonitor], **meta) -> Dict[str, Any]:
    """Fold monitor states into the regress-ingestable summary
    (``kind: slo_report``): per-SLO status plus the headline numbers —
    overall violation rate, worst burn rate, alert count."""
    statuses = [m.status() for m in monitors]
    good = sum(s["good"] for s in statuses)
    bad = sum(s["bad"] for s in statuses)
    counted = good + bad
    return {
        "kind": "slo_report",
        "slos": statuses,
        "requests_counted": counted,
        "violations": bad,
        "violation_rate": round(bad / counted, 6) if counted else 0.0,
        "worst_burn_rate": max((s["worst_burn"] for s in statuses),
                               default=0.0),
        "alerts": sum(s["alerts"] for s in statuses),
        "clears": sum(s["clears"] for s in statuses),
        **meta,
    }


def history_records(summary: Dict[str, Any]) -> List[Tuple[str, float, str]]:
    """The (metric, value, unit) pairs an slo_report contributes to the
    regression history. Regress gates the slow/bad side, so all three rise
    with degradation: violation rate, worst burn, alert count."""
    out: List[Tuple[str, float, str]] = []
    vr = summary.get("violation_rate")
    if isinstance(vr, (int, float)) and vr > 0:
        out.append(("slo/violation_rate", float(vr), "ratio"))
    wb = summary.get("worst_burn_rate")
    if isinstance(wb, (int, float)) and wb > 0:
        out.append(("slo/worst_burn", float(wb), "x"))
    al = summary.get("alerts")
    if isinstance(al, (int, float)) and al > 0:
        out.append(("slo/alerts", float(al), "count"))
    return out

"""Metrics registry + structured run events, flushed as JSONL.

The port's copy of the JAX package's ``obs/registry.py``, with the same
JSONL schema: every layer reports counters, gauges, histograms, spans,
health monitors and compile accounting into ONE per-run event stream,
written as JSON Lines so any run can be re-analysed later
(``gauss_tpu_torch.obs.summarize``).

Design rules:

- **No torch import at module load** — ``import gauss_tpu_torch.obs``
  loads no torch, as the JAX package's loads no jax.
- **Zero-cost when inactive**: every module-level hook is a no-op unless a
  recorder is active, so instrumentation can live permanently in host-side
  setup paths at no cost on unobserved runs.
- **Append-only events**: an event is one flat JSON object with ``type``,
  ``run``, ``seq`` and ``t`` (seconds since run start); consumers aggregate,
  producers never mutate.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1


def new_run_id() -> str:
    """Short unique run ID (hex; collision-safe across hosts via uuid4)."""
    return uuid.uuid4().hex[:12]


# run_start fields written by environment_fingerprint(); the summarizer
# renders these on their own "environment:" line instead of the meta header.
ENV_FINGERPRINT_KEYS = ("host", "os_pid", "python", "torch", "cuda",
                        "backend", "device_kind", "device_count")


def environment_fingerprint() -> Dict[str, Any]:
    """Where this run executed: hostname, interpreter, the torch and CUDA
    versions and — when CUDA is ALREADY initialized in this process — the
    card's name and the device count. Stamped into run_start at close so a
    regression is attributable to an environment, not just a commit.

    Never initializes anything: torch is read only if already imported,
    and the device only if CUDA is initialized (probing would create a
    CUDA context on runs that never touched the card)."""
    import platform
    import socket
    import sys

    fp: Dict[str, Any] = {"host": socket.gethostname(), "os_pid": os.getpid(),
                          "python": platform.python_version()}
    torch = sys.modules.get("torch")
    if torch is None:
        return fp
    fp["torch"] = getattr(torch, "__version__", None)
    fp["cuda"] = getattr(getattr(torch, "version", None), "cuda", None)
    if not torch.cuda.is_initialized():
        return fp
    fp.update(backend="cuda",
              device_kind=torch.cuda.get_device_name(0),
              device_count=torch.cuda.device_count())
    return fp


def _jsonable(v):
    """Coerce numpy/torch scalars and other oddballs to JSON-safe values."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        # NaN/Inf are not valid JSON; encode as strings so the flags survive.
        if v != v:
            return "nan"
        if v in (float("inf"), float("-inf")):
            return "inf" if v > 0 else "-inf"
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:  # numpy / torch scalars and 0-d arrays
        return _jsonable(float(v))
    except (TypeError, ValueError):
        return str(v)


class Recorder:
    """One run's event stream plus its counter/gauge/histogram registry.

    Thread-safe appends (bench sweeps may record from worker threads); the
    registry state is also folded into ``metric`` summary events at flush so
    the JSONL alone reconstructs everything.
    """

    def __init__(self, run_id: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None) -> None:
        self.run_id = run_id or new_run_id()
        self.t0 = time.perf_counter()
        self.events: List[Dict[str, Any]] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, List[float]] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self.emit("run_start", time_unix=time.time(),
                  schema=SCHEMA_VERSION, **(meta or {}))

    # -- event stream -----------------------------------------------------
    def emit(self, type_: str, **fields) -> Dict[str, Any]:
        """Append one structured event; returns it (already stamped)."""
        with self._lock:
            ev = {"type": type_, "run": self.run_id, "seq": self._seq,
                  "t": round(time.perf_counter() - self.t0, 6)}
            self._seq += 1
        for k, v in fields.items():
            ev[k] = _jsonable(v)
        with self._lock:
            self.events.append(ev)
        return ev

    # -- registry ---------------------------------------------------------
    def counter(self, name: str, inc: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def histogram(self, name: str, value: float) -> None:
        with self._lock:
            self.histograms.setdefault(name, []).append(float(value))

    # -- output -----------------------------------------------------------
    def _registry_events(self) -> List[Dict[str, Any]]:
        evs = []
        for name, v in sorted(self.counters.items()):
            evs.append({"type": "metric", "kind": "counter", "name": name,
                        "value": _jsonable(v)})
        for name, v in sorted(self.gauges.items()):
            evs.append({"type": "metric", "kind": "gauge", "name": name,
                        "value": _jsonable(v)})
        for name, vals in sorted(self.histograms.items()):
            svals = sorted(vals)
            evs.append({
                "type": "metric", "kind": "histogram", "name": name,
                "count": len(vals), "min": _jsonable(svals[0]),
                "max": _jsonable(svals[-1]),
                "mean": _jsonable(sum(vals) / len(vals)),
                "p50": _jsonable(svals[len(svals) // 2])})
        for ev in evs:
            ev["run"] = self.run_id
        return evs

    def close(self) -> None:
        """Stamp the run_end event (wall-clock of the whole run) and merge
        the environment fingerprint into run_start's meta. Fingerprinting at
        close — not construction — sees the device the run actually used
        (the CLIs open the run before any CUDA call; by close, CUDA is
        initialized if the run touched the card)."""
        self.emit("run_end", wall_s=time.perf_counter() - self.t0)
        start = self.events[0]
        for k, v in environment_fingerprint().items():
            if k not in start and v is not None:
                start[k] = _jsonable(v)

    def flush(self, path) -> int:
        """Append every event (+ registry summaries) to ``path`` as JSONL;
        returns the number of lines written. Appending, not truncating:
        several runs (a bench sweep) can share one file and the summarizer
        splits them by run ID."""
        lines = [json.dumps(ev, sort_keys=True)
                 for ev in self.events + self._registry_events()]
        path = os.fspath(path)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "a") as f:
            f.write("\n".join(lines) + "\n")
        return len(lines)


def read_events(path) -> List[Dict[str, Any]]:
    """Parse a JSONL events file; skips blank/corrupt lines (a crashed run
    may truncate its last line — the surviving prefix is still data)."""
    events = []
    with open(os.fspath(path)) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                continue
    return events

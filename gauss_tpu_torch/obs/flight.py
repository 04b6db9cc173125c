"""Crash-surviving flight recorder: an mmap-backed ring of recent events
(the port of ``gauss_tpu/obs/flight.py``; the ring's bytes are that
package's, so a ring written by either package scans in the other, torn
tails included).

The recorder (:mod:`gauss_tpu_torch.obs.registry`) holds its state in
process memory, so a ``kill -9`` — the exact fault the durable and replica
chaos campaigns inject on purpose — destroys every byte of telemetry
describing the final seconds. This module is the flight sink (installed
via :func:`gauss_tpu_torch.obs.spans.set_flight_sink`): every
span/event/counter-delta the hooks already emit is ALSO appended to a
fixed-size ring buffer in an mmap'd file, where it survives the process. A
surviving process (``durable.supervise``, the replica router, the
post-restart server, ``python -m gauss_tpu_torch.obs.debug``) harvests the
ring with :func:`scan` and folds the dead process's last seconds into a
post-mortem bundle (:mod:`gauss_tpu_torch.obs.postmortem`).

Ring file layout (all integers little-endian)::

    header (64 bytes)
      [0:8)    magic  b"GAUSFLT1"
      [8:12)   u32    format version (1)
      [16:24)  u64    capacity — data-region bytes
      [24:32)  u64    wpos — logical bytes written (data offset = wpos % cap)
      [32:40)  u64    seq  — records written (monotonic)
      [40:48)  u64    writer pid
      [48:56)  f64    writer start time (unix)
    data (capacity bytes)
      record := marker(4) | u32 len | u64 seq | u32 crc | payload[len]
      marker  = b"\\xf1\\x9a\\x7e\\x01" (non-ASCII, cannot occur in the
                JSON payload — the resync anchor)
      crc     = crc32(seq_le_bytes + payload)

Same torn-tail discipline as the request journal: the writer never
trusts its own death to be clean, so the READER carries the integrity
invariant — :func:`scan` walks the data region, accepts only records whose
marker, length, and CRC all check out, resynchronizes on the marker after
any damage, and orders the survivors by embedded ``seq``. A record torn at
the kill offset (or half-overwritten by a later lap of the ring) fails its
CRC and is dropped, counted in ``stats["torn_dropped"]``. Records never
straddle the ring end (the tail is zero-padded instead), so a record's
bytes are always contiguous.

Alongside the ring, a **sidecar** JSON file carries the per-process state a
post-mortem needs but events don't repeat: the environment fingerprint,
the set of trace ids admitted but not yet terminal, the latest gauges
(queue depth, lane occupancy), and a last-alive timestamp. It is rewritten
atomically and throttled (default 0.5 s), so its mtime doubles as a
heartbeat.

Cost contract: with no sink installed (``flight_dir=None`` everywhere) the
hot path is one module-global ``is None`` read. With the sink on, the only
hot-path cost is one compact-JSON encode plus a locked memcpy into the
mmap; ``python -m gauss_tpu_torch.obs.flightcheck`` measures it.

Stdlib + the port's obs machinery only; loads no torch.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

HEADER_MAGIC = b"GAUSFLT1"
HEADER_SIZE = 64
FORMAT_VERSION = 1
RECORD_MARKER = b"\xf1\x9a\x7e\x01"
RECORD_HEADER = struct.Struct("<4sIQI")  # marker, len, seq, crc
DEFAULT_RING_BYTES = 1 << 20
MIN_RING_BYTES = 1 << 12
#: records larger than capacity // 4 are dropped (a single runaway event
#: must not evict the whole recent history it exists to explain)
OVERSIZE_DIVISOR = 4

#: terminal serve_request statuses — a trace leaves the sidecar's
#: "active" set when its request reaches one (mirrors requesttrace).
_TERMINAL_STATUSES = ("ok", "rejected", "expired", "failed", "cancelled")
_MAX_ACTIVE_TRACES = 1024
SIDECAR_WRITE_EVERY_S = 0.5


def ring_path(flight_dir: str, pid: Optional[int] = None) -> str:
    return os.path.join(os.fspath(flight_dir),
                        f"flight.{pid or os.getpid()}.ring")


def sidecar_path(flight_dir: str, pid: Optional[int] = None) -> str:
    return os.path.join(os.fspath(flight_dir),
                        f"flight.{pid or os.getpid()}.state.json")


class FlightRing:
    """The mmap-backed ring. Thread-safe appends; one writer process."""

    def __init__(self, path, capacity: int = DEFAULT_RING_BYTES):
        if capacity < MIN_RING_BYTES:
            raise ValueError(
                f"flight ring capacity must be >= {MIN_RING_BYTES}, "
                f"got {capacity}")
        self.path = os.fspath(path)
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        size = HEADER_SIZE + self.capacity
        # O_CREAT without truncation: attaching to an existing ring (a
        # restarted pid reusing its path) keeps the old lap's records.
        fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            if os.fstat(fd).st_size != size:
                os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        if self._mm[:8] != HEADER_MAGIC:
            self._mm[:HEADER_SIZE] = b"\0" * HEADER_SIZE
            self._mm[:8] = HEADER_MAGIC
            struct.pack_into("<I", self._mm, 8, FORMAT_VERSION)
            struct.pack_into("<Q", self._mm, 16, self.capacity)
            struct.pack_into("<Qd", self._mm, 40, os.getpid(), time.time())
        else:
            cap = struct.unpack_from("<Q", self._mm, 16)[0]
            if cap != self.capacity:
                raise ValueError(
                    f"flight ring {self.path} has capacity {cap}, "
                    f"asked for {self.capacity}")
        self.wpos = struct.unpack_from("<Q", self._mm, 24)[0]
        self.seq = struct.unpack_from("<Q", self._mm, 32)[0]
        self.dropped_oversize = 0

    # -- writing ----------------------------------------------------------
    def append(self, payload: bytes) -> bool:
        """Append one record; returns False when dropped as oversize."""
        total = RECORD_HEADER.size + len(payload)
        if total > self.capacity // OVERSIZE_DIVISOR:
            with self._lock:
                self.dropped_oversize += 1
            return False
        with self._lock:
            seq = self.seq
            self.seq += 1
            pos = self.wpos % self.capacity
            if pos + total > self.capacity:
                # Records never straddle the ring end: zero the tail (so a
                # scan resyncs straight past it) and wrap to offset 0.
                pad = self.capacity - pos
                self._mm[HEADER_SIZE + pos:HEADER_SIZE + self.capacity] = (
                    b"\0" * pad)
                self.wpos += pad
                pos = 0
            crc = zlib.crc32(struct.pack("<Q", seq) + payload) & 0xFFFFFFFF
            rec = RECORD_HEADER.pack(RECORD_MARKER, len(payload), seq, crc)
            self._mm[HEADER_SIZE + pos:HEADER_SIZE + pos + total] = (
                rec + payload)
            self.wpos += total
            # Header update LAST: a kill between the data write and here
            # leaves wpos short of the new record, whose CRC still admits
            # it at scan — the reader, not this pointer, owns integrity.
            struct.pack_into("<QQ", self._mm, 24, self.wpos, self.seq)
        return True

    def position(self) -> Dict[str, int]:
        """Where the ring is: logical write offset, records written, size."""
        with self._lock:
            return {"wpos": self.wpos, "seq": self.seq,
                    "capacity": self.capacity,
                    "dropped_oversize": self.dropped_oversize}

    def flush(self) -> None:
        self._mm.flush()

    def close(self) -> None:
        with self._lock:
            try:
                self._mm.close()
            except ValueError:  # pragma: no cover — already closed
                pass


def scan(path) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Read every intact record out of a ring file, oldest first.

    Never raises on damage: a torn/overwritten/garbage region is skipped by
    resynchronizing on the record marker, and every marker whose record
    fails its length or CRC check counts as ``torn_dropped``. Returns
    ``(events, stats)`` where events are the decoded JSON payloads sorted
    by their embedded write sequence (the ring's physical order is a lap,
    not a timeline).
    """
    stats: Dict[str, Any] = {"records": 0, "torn_dropped": 0,
                             "wpos": 0, "seq": 0, "capacity": 0, "pid": None}
    try:
        with open(os.fspath(path), "rb") as f:
            blob = f.read()
    except OSError:
        return [], stats
    if len(blob) < HEADER_SIZE or blob[:8] != HEADER_MAGIC:
        return [], stats
    cap = struct.unpack_from("<Q", blob, 16)[0]
    stats["capacity"] = cap
    stats["wpos"] = struct.unpack_from("<Q", blob, 24)[0]
    stats["seq"] = struct.unpack_from("<Q", blob, 32)[0]
    stats["pid"] = struct.unpack_from("<Q", blob, 40)[0]
    data = blob[HEADER_SIZE:HEADER_SIZE + cap]
    found: List[Tuple[int, Dict[str, Any]]] = []
    pos = 0
    end = len(data)
    hsz = RECORD_HEADER.size
    while pos + hsz <= end:
        if data[pos:pos + 4] != RECORD_MARKER:
            nxt = data.find(RECORD_MARKER, pos + 1)
            if nxt < 0:
                break
            pos = nxt
            continue
        _, length, seq, crc = RECORD_HEADER.unpack_from(data, pos)
        body = data[pos + hsz:pos + hsz + length]
        ok = (length <= cap // OVERSIZE_DIVISOR
              and len(body) == length
              and zlib.crc32(struct.pack("<Q", seq) + body) & 0xFFFFFFFF
              == crc)
        doc = None
        if ok:
            try:
                doc = json.loads(body)
            except ValueError:
                doc = None
        if doc is None:
            stats["torn_dropped"] += 1
            pos += 1  # resync: the marker may have been payload of damage
            continue
        found.append((seq, doc))
        pos += hsz + length
    found.sort(key=lambda sd: sd[0])
    stats["records"] = len(found)
    return [doc for _, doc in found], stats


def read_sidecar(path) -> Optional[Dict[str, Any]]:
    """Parse a sidecar state file; None when absent/corrupt (a kill can
    land mid-rename only on exotic filesystems, but never crash a reader
    over it)."""
    try:
        with open(os.fspath(path)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def scan_dir(flight_dir) -> List[Dict[str, Any]]:
    """Harvest every ring in a flight dir: one entry per ring file with its
    events, scan stats, and sidecar (when present), newest writer last."""
    flight_dir = os.fspath(flight_dir)
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(flight_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("flight.") and name.endswith(".ring")):
            continue
        path = os.path.join(flight_dir, name)
        events, stats = scan(path)
        pid = stats.get("pid")
        entry = {"path": path, "pid": pid, "events": events, "stats": stats,
                 "sidecar": read_sidecar(sidecar_path(flight_dir, pid))
                 if pid else None}
        out.append(entry)
    out.sort(key=lambda e: ((e.get("sidecar") or {}).get("time_unix", 0.0),
                            e["path"]))
    return out


class FlightSink:
    """The third telemetry sink: forwards every hook into the ring.

    Duck-typed (``on_counter``/``on_gauge``/``on_histogram``/``on_span``/
    ``on_event``) so :func:`gauss_tpu_torch.obs.spans.set_flight_sink`
    can install it with the
    identical zero-cost-when-absent contract. Counter deltas are recorded
    as written (``inc``), not as totals — the scanner sums them.
    """

    def __init__(self, flight_dir, ring_bytes: int = DEFAULT_RING_BYTES,
                 sidecar_every_s: float = SIDECAR_WRITE_EVERY_S):
        self.flight_dir = os.fspath(flight_dir)
        os.makedirs(self.flight_dir, exist_ok=True)
        self.ring = FlightRing(ring_path(self.flight_dir),
                               capacity=ring_bytes)
        self._sidecar_path = sidecar_path(self.flight_dir)
        self._sidecar_every_s = float(sidecar_every_s)
        self._lock = threading.Lock()
        self._active_traces: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._last_heartbeat: Optional[float] = None
        self._started_unix = time.time()
        self._last_sidecar_write = 0.0
        from gauss_tpu_torch.obs import registry as _registry

        self._env = _registry.environment_fingerprint()
        self._write_sidecar(force=True)

    # -- ring records -----------------------------------------------------
    def _put(self, doc: Dict[str, Any]) -> None:
        try:
            payload = json.dumps(doc, separators=(",", ":"),
                                 default=str).encode()
        except (TypeError, ValueError):  # pragma: no cover — _jsonable'd
            return
        self.ring.append(payload)

    def on_event(self, type_: str, fields: Dict[str, Any]) -> None:
        doc = {"type": type_, "tu": round(time.time(), 3)}
        doc.update(fields)
        self._put(doc)
        self._track(type_, fields)

    def on_counter(self, name: str, inc: float) -> None:
        self._put({"type": "counter", "name": name, "inc": inc,
                   "tu": round(time.time(), 3)})

    def on_gauge(self, name: str, value: float) -> None:
        self._put({"type": "gauge", "name": name, "value": value,
                   "tu": round(time.time(), 3)})
        with self._lock:
            self._gauges[name] = float(value)
        self._maybe_write_sidecar()

    def on_histogram(self, name: str, value: float) -> None:
        self._put({"type": "hist", "name": name, "value": value,
                   "tu": round(time.time(), 3)})

    def on_span(self, name: str, dur_s: float, parent: Optional[str],
                depth: int, attrs: Dict[str, Any]) -> None:
        doc = {"type": "span", "name": name, "dur_s": round(dur_s, 6),
               "parent": parent, "depth": depth, "tu": round(time.time(), 3)}
        doc.update(attrs)
        self._put(doc)

    # -- sidecar ----------------------------------------------------------
    def _track(self, type_: str, fields: Dict[str, Any]) -> None:
        """Maintain the active-trace set and heartbeat from the event flow
        (admit opens a trace; its request's terminal status closes it)."""
        now = time.time()
        if type_ == "serve_admit":
            tid = fields.get("trace")
            if tid and len(self._active_traces) < _MAX_ACTIVE_TRACES:
                with self._lock:
                    self._active_traces[str(tid)] = now
        elif type_ == "serve_request":
            if fields.get("status") in _TERMINAL_STATUSES:
                tid = fields.get("trace")
                if tid:
                    with self._lock:
                        self._active_traces.pop(str(tid), None)
        elif type_ == "serve_batch":
            self._last_heartbeat = now
        self._maybe_write_sidecar()

    def _maybe_write_sidecar(self) -> None:
        now = time.time()
        if now - self._last_sidecar_write < self._sidecar_every_s:
            return
        self._write_sidecar()

    def _write_sidecar(self, force: bool = False) -> None:
        now = time.time()
        with self._lock:
            if not force and (now - self._last_sidecar_write
                              < self._sidecar_every_s):
                return
            self._last_sidecar_write = now
            doc = {"pid": os.getpid(), "time_unix": round(now, 3),
                   "started_unix": round(self._started_unix, 3),
                   "env": dict(self._env),
                   "active_traces": sorted(self._active_traces),
                   "gauges": dict(self._gauges),
                   "last_heartbeat_unix":
                       round(self._last_heartbeat, 3)
                       if self._last_heartbeat else None,
                   "ring": self.ring.position()}
        tmp = self._sidecar_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, sort_keys=True)
            os.replace(tmp, self._sidecar_path)
        except OSError:  # pragma: no cover — telemetry never takes a run down
            pass

    # -- lifecycle --------------------------------------------------------
    def position(self) -> Dict[str, Any]:
        """Ring position + sidecar path (the /snapshot payload)."""
        pos = self.ring.position()
        pos["path"] = self.ring.path
        return pos

    def close(self) -> None:
        self._write_sidecar(force=True)
        self.ring.close()


def install(flight_dir, ring_bytes: int = DEFAULT_RING_BYTES) -> FlightSink:
    """Create a :class:`FlightSink` over ``flight_dir`` and install it as
    the process's flight sink; returns it. One per process — installing
    over an existing sink closes the old one."""
    from gauss_tpu_torch.obs import spans

    sink = FlightSink(flight_dir, ring_bytes=ring_bytes)
    prev = spans.set_flight_sink(sink)
    if prev is not None:
        try:
            prev.close()
        except Exception:  # pragma: no cover
            pass
    return sink


def uninstall() -> None:
    """Remove and close the installed flight sink (no-op when absent)."""
    from gauss_tpu_torch.obs import spans

    prev = spans.set_flight_sink(None)
    if prev is not None:
        prev.close()


#: env channel a supervisor uses to hand its children a flight dir
#: (durable.supervise). Consumed explicitly by
#: :func:`install_from_env` at worker startup — NOT at import, unlike
#: GAUSS_FAULTS: recording is a process decision, not ambient state.
ENV_VAR = "GAUSS_FLIGHT_DIR"


def install_from_env(environ=None) -> Optional[FlightSink]:
    """Install a flight sink when the ``GAUSS_FLIGHT_DIR`` env channel
    names a directory; returns it (None when the channel is unset or the
    install fails — a worker never dies over its telemetry)."""
    environ = os.environ if environ is None else environ
    flight_dir = environ.get(ENV_VAR)
    if not flight_dir:
        return None
    try:
        return install(flight_dir)
    except Exception:  # pragma: no cover — best-effort by design
        return None

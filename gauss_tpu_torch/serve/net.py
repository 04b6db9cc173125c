"""The network request tier: HTTP serving on top of ``SolverServer`` (the
port of ``gauss_tpu/serve/net.py``).

**Wire format** (``WIRE_SCHEMA = 1``, JSON over stdlib HTTP; the JAX
package's byte for byte, so either package's client talks to either
package's replica):

=============================  ===========================================
``POST /v1/solve``             body: ``schema``, ``request_id`` (the
                               idempotency key, journaled, so resubmitting
                               it after any crash dedupes to the journaled
                               terminal), ``matrix_id`` (routing
                               affinity), ``deadline_s``, ``dtype``,
                               ``structure``, ``b`` (inline array doc) and
                               ``a``: inline for small systems or
                               ``{"upload": id}`` naming a chunked upload.
                               200 = terminal result doc (``x`` base64),
                               202 = still pending after ``wait_s`` (poll
                               ``GET /v1/requests/<rid>``), 503 = admission
                               rejected with a ``Retry-After`` header, 400
                               = poisoned or malformed, 409 = the ``a``
                               upload is missing (re-send the slabs).
``POST /v1/upload``            one row slab of a big operand: ``upload``,
                               ``seq``/``total``, ``rows`` ``[r0, r1)``,
                               ``shape``/``dtype``, ``data`` (array doc);
                               idempotent per ``(upload, seq)``. Slab
                               height is :func:`slab_rows`: one HTTP
                               body's bytes over the bytes of a row.
``GET /v1/requests/<rid>``     streamed NDJSON status: ``pending`` lines
                               while the request runs, then the terminal
                               result doc; close-delimited.
``POST /v1/adopt``             failover: adopt the journal dir in the body
                               (:func:`adopt_journal`).
``GET /healthz``               liveness, queue depth, the retry hint (and
                               the port's own served and batch counts and
                               kernel launches).
=============================  ===========================================

**Client contract** (:class:`SolveClient`): retries capped by the
deadline (the budget never exceeds ``deadline_s`` plus a small slack),
full-jitter exponential backoff on transport errors
(:func:`full_jitter_backoff`), ``Retry-After`` honoured on 503, chunked
upload above 4 MiB, and an idempotency key on every request (minted by the
client when the caller gave none), so a resubmission can never solve
twice: the journal answers.

HTTP handler threads only parse, admit and wait; every solve runs on the
server's worker thread. :func:`adopt_journal` admits under
``server._depth_lock``, the section ``SolverServer.submit`` admits under,
so a resubmission racing an adoption never admits one logical request
twice.

The replica (``python -m gauss_tpu_torch.serve.net --replica``) records
into ``<dir>/flight`` (or ``GAUSS_FLIGHT_DIR``) as the JAX package's does,
and exits with :data:`DRAIN_EXIT` (116,
:mod:`gauss_tpu_torch.resilience.fleet`'s) after a drain. Deliberate
deviations from the JAX package (ROADMAP queue 3): the replica takes
``--device {cuda,cpu}`` (default ``cuda``) and ``--structure-aware``, has
no compile cache (``tune/compilecache``: not ported), and publishes
``build_s`` and ``resume`` in ``endpoint.json``; :func:`adopt_journal` has
no mesh-lanes branch (``serve/lanes`` is not ported). Importing this
module loads no torch.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import os
import random
import signal
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterator, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.resilience import fleet as _fleet
from gauss_tpu_torch.serve import durable
from gauss_tpu_torch.serve.admission import (
    STATUS_EXPIRED,
    STATUS_FAILED,
    STATUS_POISON,
    STATUS_REJECTED,
    ServeRequest,
    ServeResult,
    poison_scan,
)

#: wire schema version; bumped on incompatible body changes.
WIRE_SCHEMA = 1
#: how long a POST /v1/solve parks server-side before answering 202.
DEFAULT_WAIT_S = 30.0
#: target bytes per upload slab (~1 MiB keeps any single request body
#: bounded regardless of n — the same bound the out-of-core tile window
#: puts on device-resident bytes).
UPLOAD_SLAB_BYTES = 1 << 20
#: in-progress uploads kept per replica (oldest evicted past this).
UPLOAD_KEEP = 64
#: operands above this many bytes go through chunked upload by default.
UPLOAD_THRESHOLD_BYTES = 4 << 20
#: a replica's exit code after a SIGTERM/SIGINT drain: an operator drain,
#: not a crash (one constant, :mod:`gauss_tpu_torch.resilience.fleet`'s).
DRAIN_EXIT = _fleet.DRAIN_EXIT


# -- framing / codecs ------------------------------------------------------

def slab_rows(n_cols: int, itemsize: int,
              target_bytes: int = UPLOAD_SLAB_BYTES) -> int:
    """Rows per upload slab: how many fit ``target_bytes`` — the
    out-of-core window formula (bytes budget // bytes per row) with the
    budget meaning "one HTTP body" instead of "the device fraction"."""
    row_bytes = max(1, int(n_cols) * int(itemsize))
    return max(1, int(target_bytes) // row_bytes)


def iter_slabs(a: np.ndarray, target_bytes: int = UPLOAD_SLAB_BYTES,
               ) -> Iterator[Tuple[int, int, int, np.ndarray]]:
    """Yield ``(seq, r0, r1, rows)`` row-slabs covering ``a`` in order."""
    a = np.asarray(a)
    rows = slab_rows(a.shape[1] if a.ndim > 1 else 1, a.dtype.itemsize,
                     target_bytes)
    seq = 0
    for r0 in range(0, a.shape[0], rows):
        r1 = min(a.shape[0], r0 + rows)
        yield seq, r0, r1, a[r0:r1]
        seq += 1


def slab_count(n_rows: int, n_cols: int, itemsize: int,
               target_bytes: int = UPLOAD_SLAB_BYTES) -> int:
    """Total slabs :func:`iter_slabs` will produce for an (n_rows, n_cols)
    operand (what ``total`` must be on every upload body)."""
    rows = slab_rows(n_cols, itemsize, target_bytes)
    return -(-int(n_rows) // rows)


def full_jitter_backoff(base_s: float, attempt: int,
                        rng: Optional[random.Random] = None,
                        cap_s: float = 30.0) -> float:
    """Full-jitter exponential backoff: ``uniform(0, min(cap,
    base·2^attempt))``. The fully-jittered form decorrelates a resubmit
    storm — after a replica death every client retries, and the plain
    exponential (admission.retry_backoff) would march them into the
    survivor in lockstep waves."""
    ceiling = min(float(cap_s), float(base_s) * (2 ** int(attempt)))
    return (rng or random).uniform(0.0, max(0.0, ceiling))


def matrix_digest(a: np.ndarray) -> str:
    """Content digest of an operand — the default ``matrix_id`` routing
    affinity key: repeat-A traffic hashes to the same replica, so its
    bucket executables and (future) factor caches stay warm there."""
    a = np.ascontiguousarray(a)
    h = hashlib.md5(a.tobytes())
    h.update(str(a.shape).encode())
    return h.hexdigest()[:16]


def result_doc(res: ServeResult) -> Dict[str, Any]:
    """ServeResult -> wire terminal doc (x base64 via the journal codec)."""
    doc: Dict[str, Any] = {
        "schema": WIRE_SCHEMA, "status": res.status, "lane": res.lane,
        "bucket_n": res.bucket_n, "trace": res.trace,
        "latency_s": res.latency_s, "queue_s": res.queue_s,
        "retry_after_s": res.retry_after_s, "error": res.error,
        "rel_residual": res.rel_residual,
        "sdc_detected": bool(res.sdc_detected),
        # the attribution plane's cost fields (not ported): always null
        "device_s": None, "compile_s": None,
    }
    if res.x is not None:
        doc["x"] = durable.encode_array(np.asarray(res.x))
    return doc


def doc_result(doc: Dict[str, Any]) -> ServeResult:
    """Wire terminal doc -> ServeResult (the client-side inverse)."""
    x = None
    if doc.get("x") is not None:
        x = durable.decode_array(doc["x"])
    return ServeResult(
        status=str(doc.get("status")), x=x, lane=doc.get("lane"),
        bucket_n=doc.get("bucket_n"), trace=doc.get("trace"),
        latency_s=doc.get("latency_s"), queue_s=doc.get("queue_s"),
        retry_after_s=doc.get("retry_after_s"), error=doc.get("error"),
        rel_residual=doc.get("rel_residual"),
        sdc_detected=bool(doc.get("sdc_detected")))


# -- journal adoption (failover replay on a surviving peer) ----------------

def adopt_journal(server, dirpath: str) -> Dict[str, Any]:
    """Adopt a DEAD replica's journal onto ``server`` (the failover half
    of exactly-once): import its rid-keyed terminals into the adopter's
    dedupe map — in MEMORY only, so the adopter's journal never grows a
    second terminal record for a request the dead replica finished — and
    replay its unterminated admits through the adopter's own admission
    (fresh journal ids, ORIGINAL trace ids and request ids), so every
    admitted request still reaches exactly one terminal:

    - in-deadline live admits re-enter the adopter's queue (re-journaled
      here as the adopter's own admits — the retired journal is never
      written again);
    - admits whose deadline expired during the failover window resolve as
      typed ``STATUS_EXPIRED`` terminals, never a silent drop;
    - an admit whose rid is already pending or terminal on the adopter
      (a client resubmit raced the failover) is SKIPPED — the existing
      request owns the terminal.

    The pending-map check, journal append, and depth bump run as ONE
    critical section under ``server._depth_lock`` — the same section
    ``submit()`` admits under — so a resubmit racing this replay can
    never double-admit one logical request from either side.
    """
    st = durable.scan(dirpath)
    imported = 0
    for rid, doc in st.by_rid.items():
        if rid and rid not in server._rid_terminals:
            server._rid_terminals[rid] = doc
            imported += 1
    replayed = expired = skipped = poisoned = quarantined = 0
    cfg = server.config
    k_deaths = int(cfg.quarantine_deaths or 0)
    deaths = st.death_counts() if k_deaths else {}
    now = time.time()
    for doc in st.live_admits():
        try:
            a = durable.decode_array(doc["a"])
            b = durable.decode_array(doc["b"])
        except Exception:  # pragma: no cover — admit body damaged
            obs.counter("journal.replay_undecodable")
            continue
        if doc.get("was_vector"):
            b = b.reshape(-1)
        rid = doc.get("rid")
        remaining = None
        if doc.get("deadline_unix") is not None:
            remaining = float(doc["deadline_unix"]) - now
        req = ServeRequest(
            a, b,
            deadline_s=(remaining if remaining is None or remaining > 0
                        else None),
            structure=(doc.get("structure")
                       if server.config.structure_aware else None),
            dtype=doc.get("dtype") or server.config.dtype,
            request_id=rid)
        if doc.get("trace"):
            req.trace_id = str(doc["trace"])
        is_expired = remaining is not None and remaining <= 0
        # The dead replica's quarantine evidence crosses the failover: a
        # rid implicated in K prior deaths stays quarantined (solo) on the
        # adopter, past K it is typed-rejected — a naive re-replay here
        # would re-trigger the very crash that killed the donor.
        reason = (poison_scan(a, b) if cfg.poison_scan else None)
        implicated = deaths.get(doc.get("id"), 0)
        poison_reject = (not is_expired
                         and (reason is not None
                              or (k_deaths and implicated > k_deaths)))
        if (not is_expired and not poison_reject
                and k_deaths and implicated >= k_deaths):
            req.quarantine = True
        admitted = False
        duplicate = False
        with server._depth_lock:
            if server._closed:
                pass
            elif rid and (rid in server._rid_pending
                          or rid in server._rid_terminals):
                duplicate = True
            else:
                if server.journal is not None:
                    server.journal.append_admit(
                        id=req.id, request_id=rid, trace=req.trace_id,
                        a=req.a, b=req.b, was_vector=req.was_vector,
                        deadline_unix=doc.get("deadline_unix"),
                        dtype=req.dtype, structure=req.structure)
                    if implicated and not poison_reject:
                        # Re-journal the donor's death count against the
                        # ADOPTER's fresh journal id (synthetic negative
                        # boots: distinct from each other and from real
                        # boots), so a further crash or failover still
                        # sees the full history.
                        for d in range(implicated):
                            server.journal.append_blame(
                                ids=[req.id],
                                rids=[rid] if rid else None,
                                boot=-(d + 1))
                    req._on_terminal = server._journal_terminal
                    if rid:
                        server._rid_pending[rid] = req
                admitted = True
                if not is_expired and not poison_reject:
                    server._depth += 1
                    server._queue.put(req)
        if duplicate:
            skipped += 1
            continue
        if not admitted:
            # The adopter itself is stopping — refuse with a terminal
            # rather than dropping (a router re-adopts elsewhere).
            if req.resolve(ServeResult(status=STATUS_REJECTED,
                                       error="adopter stopped during "
                                             "failover")):
                obs.counter("serve.rejected")
                obs.emit("serve_request", id=req.id, n=req.n,
                         trace=req.trace_id, status=STATUS_REJECTED,
                         reason="adopter_stopped")
            continue
        if is_expired:
            expired += 1
            if req.resolve(ServeResult(
                    status=STATUS_EXPIRED,
                    error="deadline expired during replica failover "
                          "(journal replay on peer)")):
                obs.counter("serve.adopt_expired")
                obs.emit("serve_request", id=req.id, n=req.n,
                         trace=req.trace_id, status=STATUS_EXPIRED,
                         replayed=True, adopted=True)
            continue
        if poison_reject:
            poisoned += 1
            err = (f"poisoned operands: {reason}" if reason is not None
                   else f"quarantined: implicated in {implicated} worker "
                        f"deaths (threshold {k_deaths})")
            if req.resolve(ServeResult(status=STATUS_POISON, error=err)):
                obs.counter("serve.poisoned")
                obs.emit("serve_request", id=req.id, n=req.n,
                         trace=req.trace_id, status=STATUS_POISON,
                         reason="adopt_replay", deaths=implicated,
                         replayed=True, adopted=True)
            continue
        if req.quarantine:
            quarantined += 1
            obs.counter("serve.quarantined")
            obs.emit("quarantine", id=req.id, rid=rid, trace=req.trace_id,
                     deaths=implicated, action="solo", adopted=True)
        replayed += 1
        obs.counter("serve.adopted")
        obs.emit("serve_admit", id=req.id, trace=req.trace_id, n=req.n,
                 k=req.k, replayed=True, adopted=True)
    out = {"dir": dirpath, "imported": imported, "replayed": replayed,
           "expired": expired, "skipped": skipped, "poisoned": poisoned,
           "quarantined": quarantined, "torn_dropped": st.torn_dropped}
    obs.emit("replica_adopt", **out)
    return out


# -- the replica-side application ------------------------------------------

class ReplicaApp:
    """The HTTP-facing application around one :class:`SolverServer`:
    body parsing, chunked-upload assembly, and the status lookup the
    streamed GET reads. Transport lives in :class:`RequestApi`."""

    def __init__(self, server):
        self.server = server
        self._upload_lock = threading.Lock()
        #: upload id -> {"total", "shape", "dtype", "slabs": {seq: rows}}
        self._uploads: Dict[str, Dict[str, Any]] = {}  # guarded by: self._upload_lock

    # -- uploads -----------------------------------------------------------

    def handle_upload(self, doc: Dict[str, Any]) -> Tuple[int, Dict]:
        try:
            upload = str(doc["upload"])
            seq = int(doc["seq"])
            total = int(doc["total"])
            rows = durable.decode_array(doc["data"])
            shape = [int(v) for v in doc["shape"]]
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": f"bad upload body: {e}"}
        if seq < 0 or seq >= total:
            return 400, {"error": f"seq {seq} outside total {total}"}
        with self._upload_lock:
            entry = self._uploads.get(upload)
            if entry is None:
                entry = {"total": total, "shape": shape,
                         "dtype": str(doc.get("dtype", rows.dtype)),
                         "slabs": {}}
                self._uploads[upload] = entry
                while len(self._uploads) > UPLOAD_KEEP:
                    self._uploads.pop(next(iter(self._uploads)))
            # Idempotent per (upload, seq): a client re-sending after a
            # torn connection overwrites with identical bytes.
            entry["slabs"][seq] = rows
            have = len(entry["slabs"])
        return 200, {"upload": upload, "have": have, "total": total,
                     "complete": have >= total}

    def _take_upload(self, ref: Dict[str, Any]) -> Optional[np.ndarray]:
        """Assemble and CONSUME a completed upload; None when incomplete
        or unknown (the 409 path — the client re-sends its slabs)."""
        upload = str(ref.get("upload"))
        with self._upload_lock:
            entry = self._uploads.get(upload)
            if entry is None or len(entry["slabs"]) < entry["total"]:
                return None
            entry = self._uploads.pop(upload)
        parts = [entry["slabs"][i] for i in range(entry["total"])]
        a = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        return np.asarray(a, dtype=np.dtype(entry["dtype"])).reshape(
            entry["shape"])

    # -- solve / status ----------------------------------------------------

    def _operand(self, doc_or_ref) -> Tuple[Optional[np.ndarray], bool]:
        """(array, upload_missing): decode an inline array doc or consume
        an upload reference."""
        if isinstance(doc_or_ref, dict) and "upload" in doc_or_ref:
            a = self._take_upload(doc_or_ref)
            return a, a is None
        return durable.decode_array(doc_or_ref), False

    def handle_solve(self, doc: Dict[str, Any]) -> Tuple[int, Dict]:
        schema = doc.get("schema", WIRE_SCHEMA)
        if schema != WIRE_SCHEMA:
            return 400, {"error": f"wire schema {schema} unsupported "
                                  f"(this replica speaks {WIRE_SCHEMA})"}
        try:
            a, a_missing = self._operand(doc["a"])
            if a_missing:
                return 409, {"error": "operand upload incomplete — "
                                      "re-send the slabs",
                             "upload": doc["a"].get("upload"),
                             "missing": True}
            b, _ = self._operand(doc["b"])
            deadline_s = doc.get("deadline_s")
            deadline_s = None if deadline_s is None else float(deadline_s)
            wait_s = float(doc.get("wait_s", DEFAULT_WAIT_S))
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": f"bad solve body: {e}"}
        try:
            req = self.server.submit(
                a, b, deadline_s=deadline_s,
                structure=doc.get("structure"), dtype=doc.get("dtype"),
                request_id=doc.get("request_id"))
        except ValueError as e:
            return 400, {"error": str(e)}
        req.wait(max(0.0, wait_s))
        res = req.peek()
        if res is None:
            return 202, {"schema": WIRE_SCHEMA, "pending": True,
                         "request_id": doc.get("request_id"),
                         "trace": req.trace_id}
        if res.status == STATUS_REJECTED:
            out = result_doc(res)
            if out.get("retry_after_s") is None:
                out["retry_after_s"] = self.server.retry_after_hint()
            return 503, out
        if res.status == STATUS_POISON:
            # A typed verdict about the REQUEST, not the replica: 400, not
            # 500/503 — the client must not retry a poisoned operand.
            return 400, result_doc(res)
        return 200, result_doc(res)

    def lookup(self, rid: str) -> Tuple[Optional[ServeRequest],
                                        Optional[ServeResult]]:
        """Status by idempotency key: ``(pending request, None)``,
        ``(None, terminal result)``, or ``(None, None)`` for unknown."""
        req = self.server._rid_pending.get(rid)
        if req is not None:
            res = req.peek()
            return (None, res) if res is not None else (req, None)
        term = self.server._rid_terminals.get(rid)
        if term is not None:
            return None, durable.terminal_to_result(term)
        return None, None

    def handle_adopt(self, doc: Dict[str, Any]) -> Tuple[int, Dict]:
        dirpath = doc.get("dir")
        if not dirpath or not os.path.isdir(dirpath):
            return 400, {"error": f"adopt: no journal dir at {dirpath!r}"}
        return 200, adopt_journal(self.server, dirpath)

    def health(self) -> Dict[str, Any]:
        """The ``/healthz`` doc: the JAX package's fields, and the port's
        own ``served``, ``batches`` and, once this process has loaded the
        kernels, their ``launches`` by key and by route
        (``kernels._build.LAUNCHES`` / ``ROUTE_LAUNCHES``): a router's
        replicas are processes of their own, and this is where their
        launches are read."""
        doc = {"status": "ok", "pid": os.getpid(),
               "depth": self.server._depth_snapshot(),
               "retry_after_s": self.server.retry_after_hint(),
               "served": self.server.requests_served,  # lockset: ok — racy counter read
               "batches": self.server.batches}  # lockset: ok — racy counter read
        build = sys.modules.get("gauss_tpu_torch.kernels._build")
        if build is not None:
            doc["launches"] = {k: v for k, v in build.LAUNCHES.items() if v}
            doc["route_launches"] = dict(build.ROUTE_LAUNCHES)
        return doc


class _NetHandler(BaseHTTPRequestHandler):
    """One request-API connection (the obs.export bound-handler idiom:
    ``RequestApi`` subclasses this with ``app`` bound per server)."""

    server_version = "gauss-net/1"
    app: ReplicaApp = None  # type: ignore[assignment] # set per server

    def log_message(self, fmt, *args):  # quiet: obs, not stderr noise
        pass

    def _json(self, code: int, payload: Dict[str, Any],
              headers: Optional[Dict[str, str]] = None) -> None:
        data = (json.dumps(payload, sort_keys=True) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):  # client went away
            pass

    def _body(self) -> Optional[Dict[str, Any]]:
        try:
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length)
            return json.loads(raw)
        except (ValueError, OSError):
            return None

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        path = urlparse(self.path).path
        doc = self._body()
        if doc is None:
            self._json(400, {"error": "unparseable JSON body"})
            return
        if path == "/v1/solve":
            code, payload = self.app.handle_solve(doc)
            headers = None
            if code == 503 and payload.get("retry_after_s") is not None:
                # ceil: Retry-After is integer seconds and rounding a
                # 0.3 s hint down to 0 would tell clients to hammer.
                secs = max(1, int(float(payload["retry_after_s"]) + 0.999))
                headers = {"Retry-After": str(secs)}
            self._json(code, payload, headers)
        elif path == "/v1/upload":
            code, payload = self.app.handle_upload(doc)
            self._json(code, payload)
        elif path == "/v1/adopt":
            code, payload = self.app.handle_adopt(doc)
            self._json(code, payload)
        else:
            self._json(404, {"error": f"unknown endpoint {path!r}"})

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        url = urlparse(self.path)
        if url.path == "/healthz":
            self._json(200, self.app.health())
            return
        if url.path.startswith("/v1/requests/"):
            rid = url.path[len("/v1/requests/"):]
            try:
                wait_s = float(parse_qs(url.query).get(
                    "wait", [str(DEFAULT_WAIT_S)])[0])
            except ValueError:
                self._json(400, {"error": "bad wait= value"})
                return
            self._stream_status(rid, wait_s)
            return
        self._json(404, {"error": f"unknown endpoint {url.path!r}",
                         "endpoints": ["/healthz", "/v1/requests/<rid>"]})

    def _stream_status(self, rid: str, wait_s: float) -> None:
        """NDJSON status stream: pending heartbeat lines while the request
        runs, then the terminal doc; the close delimits the stream."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Connection", "close")
        self.end_headers()
        t_end = time.monotonic() + max(0.0, wait_s)

        def _line(payload: Dict[str, Any]) -> None:
            self.wfile.write(
                (json.dumps(payload, sort_keys=True) + "\n").encode())
            self.wfile.flush()

        try:
            while True:
                req, res = self.app.lookup(rid)
                if res is not None:
                    _line(result_doc(res))
                    return
                if req is None:
                    _line({"unknown": True, "request_id": rid})
                    return
                now = time.monotonic()
                if now >= t_end:
                    _line({"pending": True, "timeout": True})
                    return
                _line({"pending": True})
                req.wait(min(0.5, t_end - now))
        except (BrokenPipeError, ConnectionResetError):
            pass


class RequestApi:
    """The embedded request endpoint: a daemon-threaded stdlib HTTP
    server bound to one :class:`ReplicaApp` (``port=0`` = ephemeral;
    read the bound address back from :attr:`url`)."""

    def __init__(self, app: ReplicaApp, port: int = 0,
                 host: str = "127.0.0.1"):
        self.app = app
        handler = type("BoundNetHandler", (_NetHandler,), {"app": app})
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

    def start(self) -> "RequestApi":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="gauss-net",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "RequestApi":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- the client ------------------------------------------------------------

class _NullCacheStats:
    """Client-side stand-in for the server's executable-cache stats: the
    loadgen report reads ``cache.hits``/``.misses``/``.stats()`` — over
    the wire those live in the replicas, so the client reports zeros."""

    hits = 0
    misses = 0

    @staticmethod
    def stats() -> Dict[str, int]:
        return {"entries": 0, "capacity": 0, "evictions": 0}


class _NetHandle:
    """The async handle :meth:`SolveClient.submit` returns — the network
    analog of :class:`ServeRequest` as far as ``result()`` goes."""

    def __init__(self):
        self._ev = threading.Event()
        self._box: Dict[str, ServeResult] = {}

    def _finish(self, res: ServeResult) -> None:
        self._box["res"] = res
        self._ev.set()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if not self._ev.wait(timeout):
            raise TimeoutError(f"network solve timed out after {timeout} s")
        return self._box["res"]

    @property
    def done(self) -> bool:
        return self._ev.is_set()


class SolveClient:
    """HTTP client for the replica/router tier with the retry contract
    baked in: deadline-capped budget, full-jitter exponential backoff,
    ``Retry-After`` honored, chunked upload for big operands, and an
    auto-minted idempotency key on every request so resubmission is
    always safe (the journal dedupes). API-compatible with the loadgen's
    server interface (``solve``/``submit``/``cache``/``batches``/
    ``retries``), so ``python -m gauss_tpu_torch.serve.cli --net URL``
    drives it unchanged."""

    def __init__(self, url: str, *, timeout_s: float = 600.0,
                 wait_s: float = DEFAULT_WAIT_S,
                 retry_base_s: float = 0.05, retry_cap_s: float = 2.0,
                 deadline_slack_s: float = 2.0,
                 upload_threshold: int = UPLOAD_THRESHOLD_BYTES,
                 seed: Optional[int] = None):
        self.url = url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.wait_s = float(wait_s)
        self.retry_base_s = float(retry_base_s)
        self.retry_cap_s = float(retry_cap_s)
        self.deadline_slack_s = float(deadline_slack_s)
        self.upload_threshold = int(upload_threshold)
        self.cache = _NullCacheStats()
        self.batches = 0
        self._lock = threading.Lock()
        self.retries = 0        # guarded by: self._lock
        self._rng = random.Random(seed)  # guarded by: self._lock
        self._minted = 0        # guarded by: self._lock
        with self._lock:
            self._rid_prefix = f"net{self._rng.getrandbits(32):08x}"

    # -- bookkeeping -------------------------------------------------------

    def _count_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def _mint_rid(self) -> str:
        with self._lock:
            self._minted += 1
            return f"{self._rid_prefix}-{self._minted}"

    def _jitter(self, attempt: int) -> float:
        with self._lock:
            return full_jitter_backoff(self.retry_base_s, attempt,
                                       rng=self._rng,
                                       cap_s=self.retry_cap_s)

    # -- transport ---------------------------------------------------------

    def _http(self, method: str, path: str, doc: Optional[Dict],
              timeout: float) -> Tuple[int, Dict[str, str], Dict]:
        data = None if doc is None else json.dumps(doc).encode()
        req = urllib.request.Request(
            self.url + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return (resp.status, dict(resp.headers),
                        json.loads(resp.read()))
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                payload = json.loads(raw)
            except (ValueError, TypeError):
                payload = {"error": raw[:200].decode("utf-8", "replace")}
            return e.code, dict(e.headers or {}), payload

    def _upload(self, upload_id: str, a: np.ndarray, budget_s: float,
                rid: Optional[str] = None,
                matrix_id: Optional[str] = None) -> None:
        total = slab_count(a.shape[0], a.shape[1] if a.ndim > 1 else 1,
                           a.dtype.itemsize)
        for seq, r0, r1, rows in iter_slabs(a):
            # request_id/matrix_id ride along on every slab so a routing
            # front tier can land the upload on the same replica the
            # subsequent solve will hash to.
            code, _, payload = self._http(
                "POST", "/v1/upload",
                {"upload": upload_id, "seq": seq, "total": total,
                 "request_id": rid, "matrix_id": matrix_id,
                 "rows": [r0, r1], "shape": list(a.shape),
                 "dtype": str(a.dtype),
                 "data": durable.encode_array(rows)},
                timeout=max(1.0, min(30.0, budget_s)))
            if code != 200:
                raise urllib.error.URLError(
                    f"upload slab {seq}/{total} refused: HTTP {code} "
                    f"{payload.get('error')}")

    def _poll_status(self, rid: str, t_end: float) -> Optional[ServeResult]:
        """Follow the streamed status endpoint until a terminal doc, the
        budget runs out (None -> the caller re-POSTs; idempotent), or the
        replica reports the rid unknown (failover remapped it — re-POST
        lands on the adopter and dedupes against its imported journal)."""
        remaining = t_end - time.monotonic()
        if remaining <= 0:
            return None
        req = urllib.request.Request(
            f"{self.url}/v1/requests/{rid}?wait={max(0.1, remaining):.3f}")
        try:
            with urllib.request.urlopen(req, timeout=remaining + 10.0) \
                    as resp:
                for raw in resp:
                    doc = json.loads(raw)
                    if doc.get("pending"):
                        continue
                    if doc.get("unknown"):
                        return None
                    return doc_result(doc)
        except (urllib.error.URLError, OSError, ValueError,
                http.client.HTTPException):
            return None
        return None

    # -- the request path --------------------------------------------------

    def solve(self, a, b, deadline_s: Optional[float] = None,
              timeout: Optional[float] = None,
              dtype: Optional[str] = None,
              structure: Optional[str] = None,
              request_id: Optional[str] = None) -> ServeResult:
        """One solve over the wire, retried to completion or budget
        exhaustion. The budget is DEADLINE-CAPPED: ``min(timeout,
        deadline_s + slack)`` — past the request's deadline every retry
        can only buy a typed expiry, so the client stops paying for it."""
        a = np.asarray(a)
        b = np.asarray(b)
        rid = request_id or self._mint_rid()
        budget = self.timeout_s if timeout is None else float(timeout)
        if deadline_s is not None:
            budget = min(budget, float(deadline_s) + self.deadline_slack_s)
        t_end = time.monotonic() + budget
        inline = a.nbytes <= self.upload_threshold
        body: Dict[str, Any] = {
            "schema": WIRE_SCHEMA, "request_id": rid,
            "matrix_id": matrix_digest(a), "deadline_s": deadline_s,
            "dtype": dtype, "structure": structure,
            "b": durable.encode_array(b)}
        if inline:
            body["a"] = durable.encode_array(a)
        else:
            body["a"] = {"upload": f"{rid}-a", "shape": list(a.shape),
                         "dtype": str(a.dtype)}
        uploaded = False
        attempt = 0
        last_error = "no attempt completed"
        while True:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                break
            try:
                if not inline and not uploaded:
                    self._upload(f"{rid}-a", a, remaining, rid=rid,
                                 matrix_id=body["matrix_id"])
                    uploaded = True
                wait = max(0.1, min(self.wait_s, remaining))
                body["wait_s"] = round(wait, 3)
                code, headers, payload = self._http(
                    "POST", "/v1/solve", body, timeout=wait + 10.0)
            except (urllib.error.URLError, OSError,
                    http.client.HTTPException) as e:
                # Transport failure: the replica may be dead mid-failover.
                # The POST is resubmit-safe (idempotency key), so back off
                # with full jitter and try again — a router remaps rids
                # to the adopter.
                last_error = f"transport: {type(e).__name__}: {e}"
                self._count_retry()
                time.sleep(max(0.0, min(self._jitter(attempt),
                                        t_end - time.monotonic())))
                attempt += 1
                continue
            if code == 200:
                return doc_result(payload)
            if code == 202:
                res = self._poll_status(rid, t_end)
                if res is not None:
                    return res
                last_error = "pending past the poll window"
                self._count_retry()
                continue
            if code == 409 and not inline:
                # The replica lost the upload (restart / failover moved
                # the rid): re-send the slabs, then re-POST.
                uploaded = False
                last_error = "operand upload missing on the replica"
                self._count_retry()
                continue
            if code == 503:
                hint = payload.get("retry_after_s")
                if hint is None and headers.get("Retry-After"):
                    try:
                        hint = float(headers["Retry-After"])
                    except ValueError:
                        hint = None
                delay = max(float(hint or 0.0), self._jitter(attempt))
                last_error = (f"rejected (retry after "
                              f"{float(hint or 0.0):.3g} s)")
                self._count_retry()
                time.sleep(max(0.0, min(delay, t_end - time.monotonic())))
                attempt += 1
                continue
            # 4xx and anything else: deterministic — retrying replays it.
            if payload.get("status") == STATUS_POISON:
                # The replica's typed poison verdict survives the wire:
                # the client sees STATUS_POISON, not a generic HTTP failure.
                return doc_result(payload)
            return ServeResult(
                status=STATUS_FAILED,
                error=f"HTTP {code}: {payload.get('error')}")
        return ServeResult(
            status=STATUS_FAILED,
            error=f"retry budget exhausted after {budget:.1f} s "
                  f"({last_error})")

    def submit(self, a, b, deadline_s: Optional[float] = None,
               dtype: Optional[str] = None,
               structure: Optional[str] = None,
               request_id: Optional[str] = None) -> _NetHandle:
        """Async form: run :meth:`solve` on a daemon thread and return a
        handle whose ``result(timeout)`` blocks (the loadgen warmup-burst
        surface)."""
        handle = _NetHandle()

        def _run():
            try:
                res = self.solve(a, b, deadline_s=deadline_s, dtype=dtype,
                                 structure=structure,
                                 request_id=request_id)
            except Exception as e:  # noqa: BLE001 — the handle must resolve
                res = ServeResult(status=STATUS_FAILED,
                                  error=f"{type(e).__name__}: {e}")
            handle._finish(res)

        threading.Thread(target=_run, name="gauss-net-client",
                         daemon=True).start()
        return handle


# -- the replica child process ---------------------------------------------

def build_replica_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.serve.net",
        description="One network serving replica: a journaled "
                    "SolverServer behind the request API, runnable solo "
                    "or under gauss_tpu_torch.serve.durable.supervise.")
    p.add_argument("--replica", action="store_true",
                   help="required marker: this invocation is a replica "
                        "child (guards against accidental bare runs)")
    p.add_argument("--dir", required=True,
                   help="replica state dir: journal/, heartbeat.json, "
                        "endpoint.json, obs.jsonl, flight/")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="bind port (0 = ephemeral; the bound address is "
                        "published to <dir>/endpoint.json)")
    p.add_argument("--ladder", default=None,
                   help="comma-separated bucket ladder")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--linger", type=float, default=0.0)
    p.add_argument("--verify-gate", type=float, default=None)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--fsync-batch", type=int, default=4)
    p.add_argument("--structure-aware", action="store_true",
                   help="classify requests and serve them on the "
                        "structure lanes (spd, sparse)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the device lanes run (default cuda; cpu runs "
                        "the kernels' plain versions)")
    return p


def replica_main(argv: Optional[List[str]] = None) -> int:
    """Entry point for one replica child. SIGTERM/SIGINT triggers a
    graceful drain (the journal's clean-shutdown marker) and exits with
    :data:`DRAIN_EXIT`, so a supervisor knows this was an operator drain,
    not a crash. On the card the kernels are built (or loaded, when this
    checkout built them already) before the endpoint is published; the
    seconds spent building are ``build_s`` in ``endpoint.json``."""
    args = build_replica_parser().parse_args(argv)
    if not args.replica:
        print("serve.net: pass --replica to run a replica child",
              file=sys.stderr)
        return 2
    from gauss_tpu_torch.serve import buckets
    from gauss_tpu_torch.serve.admission import ServeConfig
    from gauss_tpu_torch.serve.server import SolverServer

    d = args.dir
    os.makedirs(d, exist_ok=True)
    ladder = ()
    if args.ladder:
        ladder = buckets.validate_ladder(
            int(r) for r in args.ladder.split(","))
    cfg = ServeConfig(
        ladder=ladder, max_batch=args.max_batch, max_queue=args.max_queue,
        batch_linger_s=args.linger, dtype=args.dtype,
        verify_gate=args.verify_gate, device=args.device,
        structure_aware=args.structure_aware,
        journal_dir=os.path.join(d, "journal"), resume=True,
        journal_fsync_batch=args.fsync_batch,
        heartbeat_path=os.path.join(d, "heartbeat.json"),
        flight_dir=(os.environ.get("GAUSS_FLIGHT_DIR")
                    or os.path.join(d, "flight")))
    # The handler touches ONLY this dict, never a threading primitive: it
    # runs on the main thread, and Event.set() there could wait on a lock
    # that thread already holds inside wait().
    drained = {"requested": False}

    def _term(signum, frame):
        drained["requested"] = True

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    with obs.run(metrics_out=os.path.join(d, "obs.jsonl"),
                 tool="gauss_serve_replica", replica_dir=d):
        build_s = 0.0
        if cfg.device == "cuda":
            from gauss_tpu_torch.kernels import _build

            build_s = sum(_build.build_all().values())
        with SolverServer(cfg) as server:
            app = ReplicaApp(server)
            api = RequestApi(app, port=args.port, host=args.host).start()
            tmp = os.path.join(d, "endpoint.json.tmp")
            with open(tmp, "w") as f:
                json.dump({"url": api.url, "pid": os.getpid(),
                           "build_s": build_s,
                           "resume": server.last_resume}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(d, "endpoint.json"))
            obs.emit("replica", event="listening", url=api.url,
                     pid=os.getpid(), dir=d, build_s=build_s,
                     resume=server.last_resume)
            while not drained["requested"]:
                time.sleep(0.2)
            api.stop()
            server.stop(drain=True)
            obs.emit("replica", event="drained", pid=os.getpid(), dir=d)
    return DRAIN_EXIT if drained["requested"] else 0


if __name__ == "__main__":
    sys.exit(replica_main())

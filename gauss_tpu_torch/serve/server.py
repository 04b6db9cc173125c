"""SolverServer: the long-lived batched solving service (the port of
``gauss_tpu/serve/server.py``, its single-lane server).

Clients ``submit`` systems and block on per-request results; one worker
thread drains the bounded queue in SAME-BUCKET batches and dispatches each
batch as one batched blocked solve through the shape-bucketed executable
cache (:mod:`gauss_tpu_torch.serve.cache`: one batched kernel launch per
panel step for the whole stack on the card). Lanes:

- **batched** — requests whose padded size fits the bucket ladder: the
  float32, ``bfloat16`` and ``bf16x3`` LU lanes, and the Cholesky lane for
  certified-SPD batches with ``structure_aware``.
- **handoff** — oversized systems (past the ladder top), one at a time
  through :func:`gauss_tpu_torch.core.blocked.solve_handoff` (the
  single-card lane; its ``route`` event says why), or, with
  ``ServeConfig.abft`` and a system that fits the card, through the
  checksum-carrying recovery ladder (``solve_resilient(abft=True)``, a
  ``route`` event with ``lane="abft"``; the result carries
  ``sdc_detected``), or, with ``supervised_handoff`` and one right-hand
  side, through the fleet supervisor
  (:func:`gauss_tpu_torch.resilience.fleet.solve_supervised`, lane
  ``fleet``: ``fleet_workers`` worker processes on ``device`` over a
  sharded checkpoint, so the solve survives a worker's death).
- **sparse** — ``structure="sparse"`` batches: every member runs the
  Krylov recovery ladder.
- **numpy** — the degraded lane: the host recovery ladder, when the
  device lane is persistently unhealthy (the :class:`LaneHealth` circuit
  breaker after transient failures).

Everything observable lands on the active obs recorder, with the JAX
package's event and span names: ``serve_admit`` / ``serve_request`` per
request (one terminal each, carrying its ``trace`` id), ``serve_batch``
per batch, ``serve_cache`` / ``serve_retry`` / ``serve_fallback`` /
``serve_bisect``, the ``serve_batch_pad`` / ``serve_batch_solve`` spans
and the latency histogram; ``python -m gauss_tpu_torch.obs.summarize``
renders the serving section and ``python -m
gauss_tpu_torch.obs.requesttrace`` folds the stream into one span tree
per request.

Deliberate deviations from the JAX package:

- ``ServeConfig.device`` (default ``cuda``) is where the device lanes run;
  the server resolves it when it is built (no card: RuntimeError) and
  passes it to every lane explicitly, so no lane depends on the worker
  thread's current device.
- A kernel fault (:func:`gauss_tpu_torch.kernels._build.is_kernel_fault`)
  fails its batch typed (``STATUS_FAILED``, the error naming the kernel):
  it is not retried, not bisected and never served by the ``numpy`` lane
  (:func:`~gauss_tpu_torch.serve.admission.is_transient_device_error`).
  Out-of-memory and injected faults stay transient, as in the JAX
  package.
- A batched member that comes back non-finite is judged by the host
  ladder but never served by it (the JAX package serves the host answer):
  a singular or non-finite system gets the typed poison verdict, and a
  system the host solves fails ``STATUS_FAILED`` with ``kernel_fault``,
  since the batched lane's kernels wrote the non-finite values.
- The executable cache is private to the server (the JAX package's
  process-shared ``shared_cache`` serves its mesh lanes and is pending).
- :meth:`start` builds the kernels before the worker admits anything on
  the card, so a first batch's deadline never runs while ``nvcc`` does,
  and makes the card ready (:func:`gauss_tpu_torch.utils.device
  .ready_cuda`) before the worker's first heartbeat, so a supervisor's
  stall threshold times dispatches, not a process still starting.
- Options of planes not ported (:data:`~gauss_tpu_torch.serve.admission
  .UNPORTED_OPTIONS`: the mesh lanes and the attribution plane) raise
  :class:`~gauss_tpu_torch.serve.admission.FeatureNotPortedError` when
  the server is built.
- A journaled server mints its request ids above the journal's largest
  (:meth:`~gauss_tpu_torch.serve.admission.ServeRequest.reserve_ids`): the
  JAX package's restarted server counts from 1 again, and a new admit
  that takes a journaled id is folded into the older request at the next
  scan.

With ``ServeConfig(journal_dir=...)`` admission is durable
(:mod:`gauss_tpu_torch.serve.durable`): every admit and every terminal is
journaled, a restarted server replays the unterminated admits through
this same dispatch (in-deadline requests re-solve and re-verify, expired
ones get a typed terminal, journaled operands are poison-scanned, an
admit implicated in ``quarantine_deaths`` process deaths runs solo on the
host ladder and is refused typed past that; original journal and trace
ids kept), and client idempotency keys (``submit(request_id=...)``)
dedupe resubmissions against journaled terminals and in-flight requests.
A kernel fault on a replayed batch fails it typed like any other: one
journaled ``failed`` terminal, never a replay loop.

With ``ServeConfig(live_port=...)`` the same stream also feeds the live
telemetry plane (:mod:`gauss_tpu_torch.obs.live`): a rolling-window
aggregator installed as the obs live sink and an embedded HTTP endpoint
(:mod:`gauss_tpu_torch.obs.export`) serving ``/metrics`` (Prometheus
text), ``/healthz``, ``/slo`` (burn-rate alert states), ``/snapshot`` and
``/trace`` (an on-demand Chrome-trace capture of the next N batches).
With ``slo_shed`` the admission bound shrinks to ``max_queue *
degraded_queue_factor`` while an SLO alert fires (reason
``slo_degraded``).

With ``ServeConfig(flight_dir=...)`` the server records into the
crash-surviving flight ring (:mod:`gauss_tpu_torch.obs.flight`) from
:meth:`start` to :meth:`stop`, arms the in-process post-mortem trigger
(:mod:`gauss_tpu_torch.obs.postmortem`), and a journaled start that finds
unterminated admits captures an ``unclean_resume`` bundle before its
replay, as the JAX package's server does.
"""

from __future__ import annotations

import json
import os
import queue as _queue
import threading
import time
from typing import Optional

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.resilience import inject as _inject
from gauss_tpu_torch.serve import buckets
from gauss_tpu_torch.serve.admission import (
    STATUS_EXPIRED,
    STATUS_FAILED,
    STATUS_OK,
    STATUS_POISON,
    STATUS_REJECTED,
    LaneHealth,
    ServeConfig,
    ServeRequest,
    ServeResult,
    is_transient_device_error,
    poison_scan,
    refuse_unported,
    retry_backoff,
)
from gauss_tpu_torch.serve.cache import CacheKey, ExecutableCache


def _err(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


class SolverServer:
    """In-process batched solver service (start() ... submit() ... stop()).

    The service boundary is a thread-safe Python API: batching, executable
    caching, admission and degradation are transport-independent."""

    def __init__(self, config: Optional[ServeConfig] = None, *,
                 cache: Optional[ExecutableCache] = None):
        from gauss_tpu_torch.utils.device import resolve_device

        self.config = config if config is not None else ServeConfig()
        refuse_unported(self.config)
        self.device = resolve_device(self.config.device)
        self.ladder = buckets.validate_ladder(
            self.config.ladder or buckets.DEFAULT_LADDER)
        self.cache = (cache if cache is not None
                      else ExecutableCache(self.config.cache_capacity,
                                           device=self.device))
        self.health = LaneHealth(self.config.unhealthy_after,
                                 self.config.device_probe_cooldown_s)
        self._queue: "_queue.Queue[ServeRequest]" = _queue.Queue()
        self._depth = 0                   # guarded by: self._depth_lock
        self._depth_lock = threading.Lock()
        self._closed = False              # guarded by: self._depth_lock
        self._drain_rate = 0.0            # owned by: worker — EWMA req/s
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self.batches = 0                  # guarded by: self._stats_lock
        self.requests_served = 0          # guarded by: self._stats_lock
        self.retries = 0                  # guarded by: self._stats_lock
        #: durable admission (None = journal off)
        self.journal = None               # serve.durable.RequestJournal
        self._rid_terminals: dict = {}    # idempotency key -> terminal doc
        self._rid_pending: dict = {}      # idempotency key -> in-flight req
        self._resumed = False             # replay runs once per journal open
        #: what the last start() recovery did ({"replayed", "expired",
        #: "clean", ...}); None before any journaled start
        self.last_resume = None
        self._hb_last = 0.0               # owned by: worker — hb throttle
        #: the crash-surviving flight recorder (None until start() with a
        #: flight_dir) — obs.flight.FlightSink
        self._flight = None
        #: the live telemetry plane (None until start() with a live_port)
        self.live = None                  # obs.live.LiveAggregator
        self._live_server = None          # obs.export.LiveServer
        self._live_prev = None            # sink displaced by install()
        if self.config.journal_dir:
            from gauss_tpu_torch.serve import durable as _durable

            self._durable = _durable
            self.journal = _durable.RequestJournal(
                self.config.journal_dir,
                fsync_batch=self.config.journal_fsync_batch,
                rotate_records=self.config.journal_rotate_records)
            self._rid_terminals = dict(self.journal.recovered.by_rid)
            # A restarted process counts request ids from 1 again: new
            # admits must not reuse a journaled id, or their records fold
            # into an older request's at the next scan (the JAX package's
            # server reuses them).
            ServeRequest.reserve_ids(self.journal.recovered.max_id)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "SolverServer":
        if self._worker is not None and self._worker.is_alive():
            return self
        if self.device.type == "cuda":
            # The kernels build at their first CUDA use, under the build
            # lock; built here, before the worker takes a request, no
            # batch's deadline runs while nvcc does (an unchanged checkout
            # loads its libraries as built).
            from gauss_tpu_torch.kernels import _build
            from gauss_tpu_torch.utils.device import ready_cuda

            _build.build_all()
            ready_cuda(self.device)
        if self.config.live_port is not None and self._live_server is None:
            self._start_live()
        if self.config.flight_dir and self._flight is None:
            self._start_flight()
        self._stop.clear()
        with self._depth_lock:
            self._closed = False
        self._worker = threading.Thread(target=self._run,
                                        name="gauss-serve", daemon=True)
        self._worker.start()
        if self.journal is not None and not self._resumed:
            self._resumed = True
            self._replay()
        return self

    def _start_live(self) -> None:
        """Bring up the live telemetry plane: the aggregator installed as
        the process obs live sink, and the embedded HTTP endpoint. Lazy
        imports: a server without a live_port never loads any of this."""
        from gauss_tpu_torch.obs import export as _export
        from gauss_tpu_torch.obs import live as _live
        from gauss_tpu_torch.obs import slo as _slo

        cfg = self.config
        slos = cfg.slos or (_slo.default_serving_slo(),)
        self.live = _live.LiveAggregator(window=cfg.live_window, slos=slos)
        self._live_prev = _live.install(self.live)
        self._live_server = _export.LiveServer(
            self.live, port=cfg.live_port, host=cfg.live_host).start()
        obs.emit("live", event="listening", url=self._live_server.url,
                 slos=[m.slo.name for m in self.live.slos])

    def _stop_live(self) -> None:
        if self._live_server is not None:
            self._live_server.stop()
            self._live_server = None
        if self.live is not None:
            from gauss_tpu_torch.obs import live as _live

            _live.uninstall(self._live_prev)
            self.live = None
            self._live_prev = None

    @property
    def live_url(self) -> Optional[str]:
        """The live endpoint base URL (None when the plane is off)."""
        return self._live_server.url if self._live_server else None

    def _start_flight(self) -> None:
        """Bring up the flight recorder: the obs flight sink writing every
        event into ``flight_dir``'s mmap ring, plus the in-process
        post-mortem trigger (SLO firing, SDC escalation). Lazy imports: a
        ``flight_dir=None`` server never loads any of this."""
        from gauss_tpu_torch.obs import flight as _flight_mod
        from gauss_tpu_torch.obs import postmortem as _postmortem

        cfg = self.config
        self._flight = _flight_mod.install(
            cfg.flight_dir, ring_bytes=cfg.flight_ring_bytes)
        _postmortem.install_trigger(
            _postmortem.default_bundles_dir(cfg.flight_dir),
            flight_dir=cfg.flight_dir, journal_dir=cfg.journal_dir,
            heartbeat_path=cfg.heartbeat_path,
            metrics_url=(self._live_server.url + "/metrics"
                         if self._live_server else None))
        obs.emit("flight", event="recording", dir=cfg.flight_dir,
                 ring_bytes=cfg.flight_ring_bytes)

    def _stop_flight(self, close: bool = True) -> None:
        """Uninstall the flight sink and disarm the trigger. ``close=False``
        (a crash) drops the sink without its final sidecar write: the ring
        stays exactly as a kill would leave it."""
        if self._flight is None:
            return
        from gauss_tpu_torch.obs import flight as _flight_mod
        from gauss_tpu_torch.obs import postmortem as _postmortem
        from gauss_tpu_torch.obs import spans as _spans

        _postmortem.uninstall_trigger()
        if close:
            _flight_mod.uninstall()
        else:
            _spans.set_flight_sink(None)
        self._flight = None

    @property
    def flight_sink(self):
        """The installed flight recorder sink (None when the plane is
        off)."""
        return self._flight

    # -- durability (gauss_tpu_torch.serve.durable) ------------------------

    def _journal_terminal(self, req: ServeRequest, result) -> None:
        """The resolve() terminal hook of a journaled request: append the
        terminal record from the winning CAS, so the journal carries
        exactly one terminal per admit. Never raises into the resolver: a
        journaling failure is counted and emitted."""
        try:
            doc = self.journal.append_terminal(
                id=req.journal_id, request_id=req.request_id,
                trace=req.trace_id, status=result.status, x=result.x,
                lane=result.lane, rel_residual=result.rel_residual,
                error=result.error)
            if req.request_id:
                self._rid_terminals[req.request_id] = doc
                self._rid_pending.pop(req.request_id, None)
        except Exception as e:  # noqa: BLE001 — durability must not break serving
            obs.counter("journal.errors")
            obs.emit("journal", event="append_error", error=_err(e)[:200])

    def _replay(self) -> None:
        """Crash -> restart recovery: the journal's unterminated admits
        back through the normal dispatch, under their original journal
        and trace ids. Past-deadline ones resolve STATUS_EXPIRED; poisoned
        operands, and admits implicated in more than
        ``quarantine_deaths`` process deaths, resolve STATUS_POISON; those
        at the threshold are quarantined (solo on the host ladder). The
        admission bound is bypassed: these were admitted once."""
        st = self.journal.recovered
        if st.clean_shutdown or not self.config.resume:
            self.last_resume = {"replayed": 0, "expired": 0,
                                "clean": st.clean_shutdown,
                                "resume": self.config.resume,
                                "torn_dropped": st.torn_dropped}
            obs.emit("serve_resume", **self.last_resume)
            return
        if self.config.flight_dir and st.live_admits():
            # Crash detection at resume time: an unclean journal with
            # unterminated admits means the previous incarnation died
            # mid-flight — harvest its flight ring into a post-mortem
            # bundle BEFORE replay traffic overwrites the scene.
            try:
                from gauss_tpu_torch.obs import postmortem as _postmortem

                _postmortem.capture_bundle(
                    _postmortem.default_bundles_dir(self.config.flight_dir),
                    "unclean_resume", flight_dir=self.config.flight_dir,
                    journal_dir=self.config.journal_dir,
                    heartbeat_path=self.config.heartbeat_path,
                    extra={"live_admits": len(st.live_admits()),
                           "torn_dropped": st.torn_dropped})
            except Exception:  # noqa: BLE001 — capture never blocks recovery
                obs.counter("postmortem.capture_errors")
        dec = self._durable.decode_array
        replayed = expired = poisoned = quarantined = 0
        k_deaths = self.config.quarantine_deaths
        deaths = st.death_counts() if k_deaths else {}
        now = time.time()
        for doc in st.live_admits():
            try:
                a = dec(doc["a"])
                b = dec(doc["b"])
            except Exception:  # noqa: BLE001 — a damaged admit body
                obs.counter("journal.replay_undecodable")
                continue
            if doc.get("was_vector"):
                b = b.reshape(-1)
            remaining = None
            if doc.get("deadline_unix") is not None:
                remaining = float(doc["deadline_unix"]) - now
            structure = (doc.get("structure")
                         if self.config.structure_aware else None)
            req = ServeRequest(
                a, b, deadline_s=(remaining if remaining is None
                                  or remaining > 0 else None),
                structure=structure,
                dtype=doc.get("dtype") or self.config.dtype,
                request_id=doc.get("rid"))
            req.journal_id = int(doc["id"])
            if doc.get("trace"):
                req.trace_id = str(doc["trace"])
            req._on_terminal = self._journal_terminal
            if req.request_id:
                # A client resubmitting its key during recovery attaches
                # to the replay instead of solving twice.
                self._rid_pending[req.request_id] = req
            if remaining is not None and remaining <= 0:
                expired += 1
                if req.resolve(ServeResult(
                        status=STATUS_EXPIRED,
                        error="deadline expired before recovery "
                              "(crash -> restart replay)")):
                    obs.counter("serve.resume_expired")
                    obs.emit("serve_request", id=req.journal_id, n=req.n,
                             trace=req.trace_id, status=STATUS_EXPIRED,
                             replayed=True)
                continue
            reason = (poison_scan(a, b) if self.config.poison_scan
                      else None)
            implicated = deaths.get(int(doc["id"]), 0)
            if reason is not None or (k_deaths and implicated > k_deaths):
                # Re-dispatching it is the crash loop: a typed terminal,
                # journaled, so the next restart replays nothing.
                poisoned += 1
                err = (f"poisoned operands: {reason}" if reason is not None
                       else f"quarantined: implicated in {implicated} "
                            f"worker deaths (threshold {k_deaths})")
                if req.resolve(ServeResult(status=STATUS_POISON,
                                           error=err)):
                    obs.counter("serve.poisoned")
                    obs.emit("serve_request", id=req.journal_id, n=req.n,
                             trace=req.trace_id, status=STATUS_POISON,
                             replayed=True, deaths=implicated,
                             error=err[:200])
                continue
            if k_deaths and implicated >= k_deaths:
                # Quarantine: solo on the host recovery ladder, never
                # batched and never on the device lane its deaths
                # implicate; one more death takes it past the threshold.
                req.quarantine = True
                quarantined += 1
                obs.counter("serve.quarantined")
                obs.emit("quarantine", id=req.journal_id,
                         rid=req.request_id, trace=req.trace_id,
                         deaths=implicated, action="solo")
            replayed += 1
            self._depth_add(1)
            self._queue.put(req)
            obs.counter("serve.replayed")
            obs.emit("serve_admit", id=req.journal_id, trace=req.trace_id,
                     n=req.n, k=req.k, replayed=True,
                     deadline_s=remaining)
        self.last_resume = {"replayed": replayed, "expired": expired,
                            "poisoned": poisoned,
                            "quarantined": quarantined,
                            "clean": False, "resume": True,
                            "torn_dropped": st.torn_dropped}
        obs.emit("serve_resume", **self.last_resume)

    def _crash(self) -> None:
        """Chaos hook (not part of the serving API): die as a kill at a
        batch boundary does. The in-flight batch finishes (its terminals
        are journaled), everything still queued is abandoned unresolved,
        and the journal's file handle is dropped with no fsync and no
        shutdown marker. The in-process campaign uses this where a
        subprocess would use ``os._exit``."""
        self._stop.set()
        self._queue.put(None)  # type: ignore[arg-type]
        if self._worker is not None:
            self._worker.join(timeout=60.0)
            self._worker = None
        if self.journal is not None:
            self.journal.abandon()
        self._stop_live()
        # Dropped, not closed: a real kill writes no final sidecar.
        self._stop_flight(close=False)

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the worker; with ``drain`` (default) requests accepted
        before the stop began are served first, otherwise they resolve as
        rejected. Admission closes first, under the lock submits enqueue
        under, so every accepted request gets exactly one terminal. A
        journal gets its clean-shutdown marker only when the worker
        joined (a wedged worker may still be computing a journaled
        admit), and is closed."""
        with self._depth_lock:
            self._closed = True
        joined = True
        if self._worker is not None:
            if drain:
                deadline = time.monotonic() + timeout
                while self._depth_snapshot() and time.monotonic() < deadline:
                    time.sleep(0.005)
            self._stop.set()
            self._queue.put(None)  # type: ignore[arg-type] # wake the worker
            self._worker.join(timeout=timeout)
            joined = not self._worker.is_alive()
            self._worker = None
        else:
            self._stop.set()
        while True:
            try:
                req = self._queue.get_nowait()
            except _queue.Empty:
                break
            if req is None:
                continue
            self._depth_add(-1)
            self._reject_stopped(req)
        if self.journal is not None and not self.journal.closed:  # lockset: ok — stop() is the only closer; close() re-checks under its lock
            if joined:
                self.journal.append_shutdown()
            self.journal.close()
        self._stop_live()
        self._stop_flight()

    def __enter__(self) -> "SolverServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- admission --------------------------------------------------------

    def _depth_add(self, d: int) -> int:
        with self._depth_lock:
            self._depth += d
            depth = self._depth
        obs.gauge("serve.queue_depth", depth)
        return depth

    def _depth_snapshot(self) -> int:
        with self._depth_lock:
            return self._depth

    def retry_after_hint(self) -> float:
        """Seconds until a full queue has likely drained one batch's worth
        (from the EWMA drain rate, with a floor)."""
        rate = max(self._drain_rate, 1e-3)  # lockset: ok — racy EWMA read
        return round(min(60.0, max(0.01, self.config.max_batch / rate)), 4)

    def _reject_stopped(self, req: ServeRequest) -> None:
        if req.resolve(ServeResult(status=STATUS_REJECTED,
                                   error="server stopped")):
            obs.counter("serve.rejected")
            obs.emit("serve_request", id=req.id, n=req.n,
                     trace=req.trace_id, status=STATUS_REJECTED,
                     reason="server_stopped")

    def submit(self, a, b, deadline_s: Optional[float] = None,
               structure: Optional[str] = None,
               dtype: Optional[str] = None,
               request_id: Optional[str] = None) -> ServeRequest:
        """Enqueue one system. Returns the request handle at once; a
        queue-full rejection or a poisoned operand resolves it
        synchronously.

        ``structure``: a routing tag; with ``config.structure_aware`` an
        untagged request is classified here, and the tag keys batching and
        the cache (certified-SPD batches take the Cholesky lane). Ignored
        otherwise. ``dtype``: the batched lane's storage dtype for this
        request (``float32`` / ``bfloat16`` / ``bf16x3``), None takes
        ``config.dtype``. ``request_id``: a client idempotency key, read
        only with ``config.journal_dir``: a key already in flight returns
        that request's handle; a key with a journaled terminal resolves
        from the journal at once, with no solve. The poison scan runs
        before the journal admit, so a non-finite request never reaches
        the journal; the admit is journaled before this returns."""
        jr = self.journal
        if jr is not None and request_id:
            pending = self._rid_pending.get(request_id)
            if pending is not None:
                obs.counter("serve.deduped_pending")
                obs.emit("serve_dedup", request_id=request_id,
                         trace=pending.trace_id, pending=True)
                return pending
            term = self._rid_terminals.get(request_id)
            if term is not None:
                # A new client interaction (a fresh trace) answered by the
                # journaled terminal: one terminal event, no solve.
                req = ServeRequest(a, b, deadline_s=deadline_s,
                                   request_id=request_id)
                if req.resolve(self._durable.terminal_to_result(term)):
                    obs.counter("serve.deduped")
                    obs.emit("serve_request", id=req.id, n=req.n,
                             trace=req.trace_id,
                             status=term.get("status"), deduped=True,
                             request_id=request_id)
                return req
        if deadline_s is None:
            deadline_s = self.config.deadline_default_s
        if self.config.poison_scan:
            reason = poison_scan(a, b)
            if reason is not None:
                req = ServeRequest(a, b, deadline_s=deadline_s,
                                   request_id=request_id)
                if req.resolve(ServeResult(
                        status=STATUS_POISON,
                        error=f"poisoned operands: {reason}")):
                    obs.counter("serve.poisoned")
                    obs.emit("serve_request", id=req.id, n=req.n,
                             trace=req.trace_id, status=STATUS_POISON,
                             reason="admission_scan", error=reason,
                             request_id=request_id)
                return req
        if self.config.structure_aware and structure is None:
            from gauss_tpu_torch.structure import structure_tag

            structure = structure_tag(a)
        if not self.config.structure_aware:
            structure = None
        req = ServeRequest(a, b, deadline_s=deadline_s, structure=structure,
                           dtype=dtype or self.config.dtype,
                           request_id=request_id)
        # SLO-degraded admission (slo_shed): while a burn-rate alert fires,
        # the effective queue bound shrinks, so load is turned away while
        # the error budget bleeds. One boolean read when the plane is off.
        bound = self.config.max_queue
        degraded = (self.config.slo_shed and self.live is not None
                    and self.live.slo_firing())
        if degraded:
            bound = int(bound * self.config.degraded_queue_factor)
        # One critical section: the closed/full check, the journal admit
        # and the enqueue, so a request is either enqueued before stop()
        # closes admission (its drain or flush owns it) or refused here,
        # and a terminal can never precede its admit in the journal.
        dup = None
        with self._depth_lock:
            closed = self._closed
            if not closed and jr is not None and request_id:
                # Again inside the lock: a concurrent submit or an
                # adoption (net.adopt_journal) may have taken the key.
                dup = self._rid_pending.get(request_id)
            full = (not closed and dup is None and self._depth >= bound)
            if not closed and dup is None and not full:
                if jr is not None:
                    jr.append_admit(
                        id=req.id, request_id=request_id,
                        trace=req.trace_id, a=req.a, b=req.b,
                        was_vector=req.was_vector,
                        deadline_unix=req.deadline_unix,
                        dtype=req.dtype, structure=req.structure)
                    req._on_terminal = self._journal_terminal
                    if request_id:
                        self._rid_pending[request_id] = req
                self._depth += 1
                self._queue.put(req)
        if dup is not None:
            obs.counter("serve.deduped_pending")
            obs.emit("serve_dedup", request_id=request_id,
                     trace=dup.trace_id, pending=True, raced=True)
            return dup
        if closed:
            self._reject_stopped(req)
            return req
        if full:
            hint = self.retry_after_hint()
            reason = "slo_degraded" if degraded else "queue_full"
            if req.resolve(ServeResult(status=STATUS_REJECTED,
                                       retry_after_s=hint,
                                       error="queue full"
                                             + (" (slo degraded)"
                                                if degraded else ""))):
                obs.counter("serve.rejected")
                if degraded:
                    obs.counter("serve.slo_shed")
                obs.emit("serve_request", id=req.id, n=req.n,
                         trace=req.trace_id, status=STATUS_REJECTED,
                         reason=reason, retry_after_s=hint,
                         queue_depth=self._depth_snapshot())
            return req
        obs.counter("serve.submitted")
        obs.emit("serve_admit", id=req.id, trace=req.trace_id, n=req.n,
                 k=req.k, queue_depth=self._depth_snapshot(),
                 deadline_s=deadline_s,
                 **({"structure": structure} if structure else {}))
        return req

    def solve(self, a, b, deadline_s: Optional[float] = None,
              timeout: Optional[float] = 300.0,
              dtype: Optional[str] = None,
              request_id: Optional[str] = None) -> ServeResult:
        """Synchronous convenience: submit + wait."""
        return self.submit(a, b, deadline_s=deadline_s, dtype=dtype,
                           request_id=request_id).result(timeout)

    # -- worker loop ------------------------------------------------------

    def _run(self) -> None:
        hb_path = self.config.heartbeat_path
        while not self._stop.is_set():
            if hb_path is not None:
                self._heartbeat(hb_path)
            try:
                req = self._queue.get(timeout=0.1)
            except _queue.Empty:
                continue
            if req is None:
                continue
            batch = [req]
            if req.n <= self.ladder[-1]:
                batch.extend(self._drain_same_bucket(req))
            self._depth_add(-len(batch))
            if _inject.enabled():
                # Hook point "serve.worker.dispatch": an injected worker
                # stall (expired requests must shed, not hang).
                _inject.maybe_delay("serve.worker.dispatch")
            t0 = time.perf_counter()
            served = self._dispatch(batch)
            dt = time.perf_counter() - t0
            if dt > 0 and served:
                inst = served / dt
                self._drain_rate = (0.7 * self._drain_rate + 0.3 * inst
                                    if self._drain_rate else inst)
            if _inject.enabled():
                # Hook point "serve.server.batch": the batch boundary (the
                # batch's terminals are journaled, the queue is not yet
                # served); kind "server_kill" os._exits here.
                _inject.maybe_kill("serve.server.batch")

    def _heartbeat(self, path: str) -> None:
        """Supervisor liveness (durable.supervise): touch the heartbeat
        file from the worker loop, at most every 0.5 s; a wedged worker
        stops touching it. The file is replaced whole (tmp + rename), so a
        reader never sees a half-written beat."""
        now = time.monotonic()
        if now - self._hb_last < 0.5:
            return
        self._hb_last = now
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps({"pid": os.getpid(),
                                    "time_unix": time.time(),
                                    "batches": self.batches}))  # lockset: ok — a stats snapshot for liveness
            os.replace(tmp, path)
        except OSError:  # liveness must not kill serving
            pass

    def _drain_same_bucket(self, first: ServeRequest):
        """Collect queued requests that share ``first``'s size bucket,
        structure tag and dtype, up to max_batch, optionally lingering for
        late arrivals; the others go back on the queue in order."""
        want = buckets.bucket_for(first.n, self.ladder)
        got, requeue = [], []
        deadline = time.monotonic() + self.config.batch_linger_s
        while len(got) + 1 < self.config.max_batch:
            try:
                nxt = self._queue.get_nowait()
            except _queue.Empty:
                if time.monotonic() >= deadline:
                    break
                time.sleep(0.001)
                continue
            if nxt is None:
                continue
            if (nxt.n <= self.ladder[-1]
                    and buckets.bucket_for(nxt.n, self.ladder) == want
                    and nxt.structure == first.structure
                    and nxt.dtype == first.dtype):
                got.append(nxt)
            else:
                requeue.append(nxt)
        for r in requeue:
            self._queue.put(r)
        return got

    # -- dispatch ---------------------------------------------------------

    def _dispatch(self, batch) -> int:
        """Serve one same-bucket batch (or oversized requests); returns the
        number of requests taken."""
        now = time.perf_counter()
        live, solo = [], []
        for req in batch:
            if req.done:
                # Cancelled while queued: the client holds its terminal.
                obs.counter("serve.cancelled_skipped")
                continue
            if req.expired(now):
                if req.resolve(ServeResult(status=STATUS_EXPIRED,
                                           error="deadline expired before "
                                                 "compute")):
                    obs.counter("serve.expired")
                    obs.emit("serve_request", id=req.id, n=req.n,
                             trace=req.trace_id, status=STATUS_EXPIRED)
            elif req.quarantine:
                solo.append(req)
            else:
                live.append(req)
        if (live or solo) and self.journal is not None:
            # The blame record, before the dispatch: a death while this
            # batch is in flight implicates exactly these ids (one death
            # per journal boot, the quarantine's evidence). A torn blame
            # drops at scan, costing evidence, never correctness.
            try:
                self.journal.append_blame(
                    ids=[r.journal_id for r in live + solo],
                    rids=[r.request_id for r in live + solo
                          if r.request_id])
            except Exception as e:  # noqa: BLE001 — durability must not break serving
                obs.counter("journal.errors")
                obs.emit("journal", event="append_error",
                         error=_err(e)[:200])
        for req in solo:
            # Quarantined: solo on the host ladder, never batched.
            self._serve_numpy(req)
        if not live:
            return len(batch)
        if live[0].n > self.ladder[-1]:
            for req in live:
                self._serve_handoff(req)
            return len(batch)
        self._serve_batched(live)
        return len(batch)

    def _fail(self, reqs, status: str, lane: str, bucket_n, err: str,
              **fields) -> None:
        for req in reqs:
            if req.resolve(ServeResult(status=status, lane=lane,
                                       bucket_n=bucket_n, error=err)):
                obs.counter("serve.poisoned" if status == STATUS_POISON
                            else "serve.failed")
                obs.emit("serve_request", id=req.id, n=req.n,
                         trace=req.trace_id, status=status, lane=lane,
                         error=err[:200], **fields)

    def _serve_batched(self, reqs, hunt: bool = False) -> None:
        from gauss_tpu_torch.kernels._build import is_kernel_fault

        cfg = self.config
        if reqs[0].structure == "sparse":
            self._serve_sparse(reqs)
            return
        bucket_n = buckets.bucket_for(reqs[0].n, self.ladder)
        nrhs = buckets.pow2_bucket(max(r.k for r in reqs))
        bb = buckets.pow2_bucket(len(reqs), cap=cfg.max_batch)
        traces = [r.trace_id for r in reqs]
        key = CacheKey(bucket_n=bucket_n, nrhs=nrhs, batch=bb,
                       dtype=reqs[0].dtype or "float32", engine=cfg.engine,
                       refine_steps=cfg.refine_steps, mesh=None,
                       structure=reqs[0].structure)

        allowed = self.health.device_allowed()
        obs.gauge("serve.breaker_open", 0.0 if allowed else 1.0)
        if not allowed:
            obs.counter("serve.fallback_batches")
            for req in reqs:
                self._serve_numpy(req)
            return

        with obs.span("serve_batch_pad", bucket_n=bucket_n, batch=len(reqs),
                      requests=len(reqs), traces=traces):
            a_pad = np.empty((bb, bucket_n, bucket_n), dtype=np.float64)
            b_pad = np.zeros((bb, bucket_n, nrhs), dtype=np.float64)
            for i, req in enumerate(reqs):
                a_pad[i], b_pad[i] = buckets.pad_system(
                    req.a.astype(np.float64), req.b.astype(np.float64),
                    bucket_n, nrhs)
            for i in range(len(reqs), bb):  # batch padding: identities
                a_pad[i] = np.eye(bucket_n)

        t0 = time.perf_counter()
        x = None
        err: Optional[BaseException] = None
        for attempt in range(cfg.max_retries + 1):
            try:
                exe = self.cache.get(key, panel=cfg.panel)
                with obs.span("serve_batch_solve", bucket_n=bucket_n,
                              batch=len(reqs), requests=len(reqs),
                              traces=traces):
                    x = exe.solve(a_pad, b_pad)
                err = None
                break
            except Exception as e:  # noqa: BLE001 — lane boundary
                err = e
                if not is_transient_device_error(e):
                    break
                with self._stats_lock:
                    self.retries += 1
                obs.counter("serve.retries")
                obs.emit("serve_retry", attempt=attempt, bucket_n=bucket_n,
                         requests=len(reqs), traces=traces,
                         error=_err(e)[:200])
                if attempt < cfg.max_retries:
                    time.sleep(retry_backoff(cfg.retry_backoff_s, attempt))
        batch_s = time.perf_counter() - t0

        if x is None:
            if is_kernel_fault(err):
                # A kernel that does not build, launch or run is a fault
                # of the program: the batch fails typed, naming it, and no
                # other lane hides it.
                obs.counter("serve.kernel_faults")
                self._fail(reqs, STATUS_FAILED, "batched", bucket_n,
                           "kernel fault: " + _err(err), kernel_fault=True)
                return
            transient = is_transient_device_error(err)
            if transient and self.health.record_failure():
                obs.emit("serve_fallback", lane="numpy",
                         reason="device lane unhealthy",
                         cooldown_s=cfg.device_probe_cooldown_s)
            if transient:
                # Degrade THIS batch to the host lane rather than failing
                # user requests over a device-side hiccup.
                for req in reqs:
                    self._serve_numpy(req)
                return
            if cfg.bisect_batches and len(reqs) > 1:
                # A non-transient failure of a multi-member batch names no
                # culprit: split and re-dispatch each half; a member that
                # still fails alone is the culprit (typed poison below).
                obs.counter("serve.bisections")
                obs.emit("serve_bisect", bucket_n=bucket_n,
                         requests=len(reqs), traces=traces,
                         error=_err(err)[:200])
                mid = len(reqs) // 2
                self._serve_batched(reqs[:mid], hunt=True)
                self._serve_batched(reqs[mid:], hunt=True)
                return
            culprit = hunt and cfg.bisect_batches
            self._fail(reqs, STATUS_POISON if culprit else STATUS_FAILED,
                       "batched", bucket_n,
                       ("poison batch member: " if culprit else "")
                       + _err(err), bisected=hunt)
            return

        self.health.record_success()
        obs.gauge("serve.breaker_open", 0.0)
        with self._stats_lock:
            self.batches += 1
        occupancy = len(reqs) / bb
        obs.counter("serve.batches")
        obs.histogram("serve.batch_occupancy", occupancy)
        obs.emit("serve_batch", bucket_n=bucket_n, nrhs=nrhs,
                 batch=len(reqs), batch_bucket=bb, occupancy=occupancy,
                 seconds=round(batch_s, 6), requests=len(reqs),
                 traces=traces,
                 **({"structure": reqs[0].structure}
                    if reqs[0].structure else {}))
        for i, req in enumerate(reqs):
            xi = buckets.unpad_solution(x[i], req.n, req.k, req.was_vector)
            self._finish(req, xi, lane="batched", bucket_n=bucket_n)

    def _serve_handoff(self, req: ServeRequest) -> None:
        """Oversized lane: with ``supervised_handoff`` and one right-hand
        side, the fleet supervisor (lane ``fleet``: the solve survives a
        worker's death by restart and resume from the sharded checkpoint,
        or elastic degrade); with ``outofcore_handoff`` and a working set
        past ``device_budget``, the request streams from host memory under
        the ladder ``("outofcore", "numpy_f64")`` (lane ``outofcore``);
        with ``abft`` and a system that fits the card, the
        checksum-carrying ladder; else one solve_handoff call (its routing
        decision is its own ``route`` event)."""
        from gauss_tpu_torch.core import blocked

        cfg = self.config
        sdc_detected = False
        lane = "handoff"
        try:
            with obs.trace_context(req.trace_id), \
                    obs.span("serve_handoff", n=req.n):
                if cfg.supervised_handoff and req.was_vector:
                    from gauss_tpu_torch.resilience import fleet

                    lane = "fleet"
                    obs.emit("route", tool="serve_handoff", lane="fleet",
                             n=req.n, workers=cfg.fleet_workers)
                    x = fleet.solve_supervised(
                        req.a.astype(np.float64), req.b.astype(np.float64),
                        workers=cfg.fleet_workers, panel=cfg.panel,
                        refine_iters=max(2, cfg.refine_steps),
                        device=self.device.type).x
                elif (cfg.outofcore_handoff
                        and not blocked.fits_single_chip(
                            req.n, budget=cfg.device_budget,
                            device=self.device)):
                    from gauss_tpu_torch.resilience import recover

                    lane = "outofcore"
                    obs.emit("route", tool="serve_handoff",
                             lane="outofcore", n=req.n,
                             budget=cfg.device_budget)
                    x = recover.solve_resilient(
                        req.a.astype(np.float64), req.b.astype(np.float64),
                        rungs=("outofcore", "numpy_f64"), panel=cfg.panel,
                        refine_iters=max(2, cfg.refine_steps),
                        device=self.device).x
                elif cfg.abft and blocked.fits_single_chip(
                        req.n, device=self.device):
                    from gauss_tpu_torch.resilience import recover

                    obs.emit("route", tool="serve_handoff", lane="abft",
                             n=req.n)
                    rr = recover.solve_resilient(
                        req.a.astype(np.float64), req.b.astype(np.float64),
                        abft=True, panel=cfg.panel,
                        refine_iters=max(2, cfg.refine_steps),
                        device=self.device)
                    x = rr.x
                    sdc_detected = rr.sdc_detected
                else:
                    x = blocked.solve_handoff(
                        req.a.astype(np.float64), req.b.astype(np.float64),
                        budget=cfg.device_budget, panel=cfg.panel,
                        iters=max(2, cfg.refine_steps), device=self.device)
        except Exception as e:  # noqa: BLE001 — lane boundary
            self._fail([req], STATUS_FAILED, lane, None, _err(e))
            return
        self._finish(req, np.asarray(x), lane=lane, bucket_n=None,
                     sdc_detected=sdc_detected)

    def _serve_sparse(self, reqs) -> None:
        """The sparse lane: every member runs the Krylov recovery ladder
        under its own trace context, then the same verify gate."""
        from gauss_tpu_torch.resilience import recover

        gate = self.config.verify_gate or recover.DEFAULT_GATE
        obs.emit("route", tool="serve", lane="sparse", requests=len(reqs))
        for req in reqs:
            try:
                with obs.trace_context(req.trace_id), \
                        obs.span("serve_sparse", n=req.n):
                    rr = recover.solve_resilient(
                        req.a.astype(np.float64), req.b.astype(np.float64),
                        gate=gate, rungs=recover.structured_rungs("sparse"),
                        device=self.device)
            except Exception as e:  # noqa: BLE001 — lane boundary
                self._fail([req], STATUS_FAILED, "sparse", None, _err(e))
                continue
            self._finish(req, rr.x, lane="sparse", bucket_n=None)

    def _host_ladder(self, req: ServeRequest):
        """The host recovery ladder on one request (host LAPACK first, then
        the rank-1 engine): its ``ResilientResult``, or None once it has
        failed the request typed on the ``numpy`` lane (poison for an
        exactly singular or non-finite system)."""
        from gauss_tpu_torch.resilience import recover

        gate = self.config.verify_gate or recover.DEFAULT_GATE
        try:
            with obs.trace_context(req.trace_id), \
                    obs.span("serve_numpy", n=req.n):
                return recover.solve_resilient(
                    req.a.astype(np.float64), req.b.astype(np.float64),
                    gate=gate, rungs=("numpy_f64", "rank1"),
                    device=self.device)
        except Exception as e:  # noqa: BLE001 — lane boundary
            poison = (isinstance(e, recover.SingularSystemError)
                      or getattr(e, "trigger", None) == "nonfinite_input")
            self._fail([req], STATUS_POISON if poison else STATUS_FAILED,
                       "numpy", None, _err(e))
            return None

    def _serve_numpy(self, req: ServeRequest) -> None:
        """Degraded host lane: the host ladder serves the request."""
        rr = self._host_ladder(req)
        if rr is not None:
            self._finish(req, rr.x, lane="numpy", bucket_n=None)

    def _finish(self, req: ServeRequest, x: np.ndarray, lane: str,
                bucket_n: Optional[int], sdc_detected: bool = False) -> None:
        rel = None
        if (lane == "batched" and self.config.poison_scan
                and not bool(np.isfinite(x).all())):
            # A non-finite solution out of the batched lane: the host
            # ladder judges the member but never serves it. A singular or
            # non-finite system is the member's own numerics (it passes
            # the finite operand scan): the typed poison verdict. A system
            # the host solves means the batched lane's kernels wrote the
            # non-finite values: a kernel fault, failed typed.
            obs.counter("serve.nonfinite_rescues")
            if self._host_ladder(req) is not None:
                obs.counter("serve.kernel_faults")
                self._fail([req], STATUS_FAILED, "batched", bucket_n,
                           "kernel fault: the batched lane returned a "
                           "non-finite solution for a system the host "
                           f"ladder solves (bucket {bucket_n}, dtype "
                           f"{req.dtype or 'float32'})", kernel_fault=True)
            return
        if self.config.verify_gate is not None:
            from gauss_tpu_torch.verify import checks

            rel = checks.residual_norm(req.a, x, req.b, relative=True)
            if not rel <= self.config.verify_gate:
                if req.resolve(ServeResult(
                        status=STATUS_FAILED, lane=lane, bucket_n=bucket_n,
                        rel_residual=rel,
                        error=f"relative residual {rel:.3e} exceeds the "
                              f"{self.config.verify_gate:.0e} verify gate")):
                    obs.counter("serve.failed")
                    obs.emit("serve_request", id=req.id, n=req.n,
                             trace=req.trace_id, status=STATUS_FAILED,
                             lane=lane, rel_residual=rel,
                             error="verify gate")
                return
        queue_s = time.perf_counter() - req.t_submit
        if not req.resolve(ServeResult(status=STATUS_OK, x=x, lane=lane,
                                       bucket_n=bucket_n, queue_s=queue_s,
                                       rel_residual=rel,
                                       sdc_detected=sdc_detected)):
            return  # cancelled mid-compute: the client owns the terminal
        with self._stats_lock:
            self.requests_served += 1
        obs.counter("serve.served")
        if sdc_detected:
            obs.counter("serve.sdc_detected")
        obs.histogram("serve.latency_s", queue_s)
        obs.emit("serve_request", id=req.id, n=req.n, k=req.k,
                 trace=req.trace_id, status=STATUS_OK, lane=lane,
                 bucket_n=bucket_n, latency_s=round(queue_s, 6),
                 rel_residual=rel,
                 **({"sdc_detected": True} if sdc_detected else {}))

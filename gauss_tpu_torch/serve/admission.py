"""Admission control: request/response types, deadlines, retry, lane health
(the port of ``gauss_tpu/serve/admission.py``).

The serving layer degrades gracefully instead of falling over (ROADMAP north
star: heavy traffic). Three mechanisms, in the order a request meets them:

- **Queue-full rejection with retry-after.** The request queue is bounded;
  a submit against a full queue is rejected immediately with a retry-after
  hint derived from the recent drain rate, so clients back off instead of
  building an unbounded memory balloon inside the server.
- **Deadlines.** A request may carry a relative deadline; the worker drops
  expired requests at drain time — BEFORE padding, H2D, or compute — so a
  latency spike sheds exactly the work whose answer nobody is waiting for.
- **Retry + fallback lane.** A batch that fails with a transient device
  error is retried with exponential backoff; requests that exhaust retries
  fail individually. When the device lane fails persistently
  (``unhealthy_after`` consecutive batch failures) the server trips into a
  NumPy fallback lane (host LAPACK ``solve`` — slow but always available)
  and probes the device lane again after a cooldown, the classic
  circuit-breaker shape.

Deliberate deviations from the JAX package:

- ``ServeConfig.device`` (default ``"cuda"``): where the batched,
  handoff and sparse lanes run; ``"cpu"`` runs the kernels' plain
  versions (the tests). The card is never left for the CPU quietly.
- A kernel fault is not transient: :func:`is_transient_device_error`
  returns False for every error
  :func:`gauss_tpu_torch.kernels._build.is_kernel_fault` names (a build
  or launch failure, or the sticky CUDA error of a kernel that faulted
  while it ran), so the server fails that batch typed and never serves it
  from the host ``numpy`` lane, where no kernel runs.
- The options of planes not ported yet (:data:`UNPORTED_OPTIONS`) raise
  :class:`FeatureNotPortedError` when a server is built with them, never
  a silent no-op.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

# Request terminal states.
STATUS_OK = "ok"
STATUS_REJECTED = "rejected"      # queue full — never entered the queue
STATUS_EXPIRED = "expired"        # deadline passed before compute
STATUS_FAILED = "failed"          # lane error after retries
STATUS_CANCELLED = "cancelled"    # client gave up waiting; worker skips it
STATUS_POISON = "poison"          # the REQUEST is the fault: non-finite
#                                   operands or a singular system — typed
#                                   blame, never a 500


def poison_scan(a, b) -> Optional[str]:
    """Admission-time operand scan: the reason string when ``(a, b)`` can
    never be served (non-finite values, non-numeric dtype), else None.

    This is the STATUS_POISON front door: submit runs it, so a poisoned
    request is rejected with typed blame before it can reach a batch or a
    device. Shape/conformability
    errors stay plain ValueError (programming errors, not poison); this
    scan owns the *values*. O(n²) reads, no allocation beyond the
    reduction.
    """
    for name, arr in (("a", a), ("b", b)):
        arr = np.asarray(arr)
        if not np.issubdtype(arr.dtype, np.number):
            return f"non-numeric {name} (dtype {arr.dtype})"
        if np.issubdtype(arr.dtype, np.complexfloating):
            return f"complex {name} unsupported"
        if not np.isfinite(arr).all():
            bad = "nan" if np.isnan(arr).any() else "inf"
            return f"non-finite operand {name} ({bad})"
    return None


class FeatureNotPortedError(NotImplementedError):
    """A :class:`ServeConfig` option whose plane is not ported to
    gauss_tpu_torch yet; raised when the server is built."""


#: ServeConfig options whose planes are not ported, with the value that
#: keeps each plane off and the ROADMAP queue-1 item that brings it.
UNPORTED_OPTIONS = (
    ("lanes", 0, "item 11 (serve/lanes, the mesh serving plane)"),
    ("journal_dir", None, "item 11 (serve/durable, the request journal)"),
    ("live_port", None, "item 11 (obs/live, obs/export, the live plane)"),
    ("slos", (), "item 11 (obs/slo)"),
    ("slo_shed", False, "item 11 (obs/slo, the SLO-degraded admission)"),
    ("flight_dir", None, "item 11 (obs/flight, the flight recorder)"),
    ("attr", None, "item 11 (obs/attr, the attribution plane)"),
    ("supervised_handoff", False, "item 10 (resilience/fleet)"),
)


def _asks(value, off) -> bool:
    """Whether an option's value turns its plane on: anything but its off
    value, None or False (``live_port=0`` asks for an ephemeral port)."""
    return value is not None and value is not False and value != off


def refuse_unported(config: "ServeConfig") -> None:
    """Raise :class:`FeatureNotPortedError` naming every option of
    ``config`` that asks for a plane the port does not have."""
    asked = [f"{name}={getattr(config, name)!r} (ROADMAP queue-1 {item})"
             for name, off, item in UNPORTED_OPTIONS
             if _asks(getattr(config, name), off)]
    if asked:
        raise FeatureNotPortedError(
            "not ported to gauss_tpu_torch yet: " + "; ".join(asked))


@dataclasses.dataclass
class ServeConfig:
    """Tuning knobs for :class:`gauss_tpu_torch.serve.server.SolverServer`:
    the JAX package's that the single-lane server reads, ``device``, and
    the switches of the planes not ported (:data:`UNPORTED_OPTIONS`), which
    must keep their off values. The JAX package's sub-options of those
    planes (journal batching, lane widths, continuous batching, the live
    endpoint's host and window, ...) are not fields here."""

    ladder: tuple = ()              # () -> buckets.DEFAULT_LADDER
    max_batch: int = 8              # dynamic-batching ceiling per dispatch
    max_queue: int = 256            # admission bound (queue-full rejection)
    batch_linger_s: float = 0.0     # wait this long for same-bucket company
    cache_capacity: int = 32        # LRU executable-cache entries
    refine_steps: int = 1           # host-f64 refinement rounds per batch
    panel: Optional[int] = None     # blocked-solver panel (None -> auto)
    engine: str = "blocked"         # batched lane engine label (cache key)
    dtype: str = "float32"          # batched-lane storage dtype: "float32",
    #                                 "bfloat16" (bfloat16 storage, the
    #                                 float32-accumulate contract) or
    #                                 "bf16x3" (float32 storage, split-GEMM
    #                                 updates); keys the executable cache,
    #                                 and a per-request dtype (submit(dtype=)
    #                                 / the loadgen "dtype:" token)
    #                                 overrides it per batch. Lowered lanes
    #                                 lean on refine_steps + verify_gate for
    #                                 the 1e-4 contract (core.lowered)
    device: str = "cuda"            # where the device lanes run: "cuda"
    #                                 (the card, default) or "cpu" (the
    #                                 kernels' plain versions)
    max_retries: int = 2            # transient-failure retries per batch
    retry_backoff_s: float = 0.05   # base backoff (doubles per attempt)
    unhealthy_after: int = 3        # consecutive failures that trip fallback
    device_probe_cooldown_s: float = 5.0  # how long fallback lane holds
    deadline_default_s: Optional[float] = None  # applied when request has none
    verify_gate: Optional[float] = None  # rel-residual bar; None = no check
    device_budget: Optional[int] = None  # device-byte budget of the handoff
    #                                      routing (None = the card's
    #                                      device_memory_budget())
    structure_aware: bool = False   # detect/accept structure tags, batch by
    #                                 (bucket, tag), and give Gershgorin-
    #                                 certified SPD batches the Cholesky
    #                                 lane (gauss_tpu_torch.structure)
    poison_scan: bool = True        # reject non-finite/non-numeric operands
    #                                 at submit with a typed STATUS_POISON
    #                                 terminal. False = the trusting path
    #                                 (tests)
    bisect_batches: bool = True     # bisect a batch that fails non-
    #                                 transiently to isolate the culprit
    #                                 member(s) (typed STATUS_POISON);
    #                                 False = the whole batch fails together
    abft: bool = False              # checksum-carrying (ABFT) solves on the
    #                                 handoff lane for systems that fit the
    #                                 card: silent data corruption detected
    #                                 within one panel group and repaired by
    #                                 replay (resilience.abft); results that
    #                                 saw a detection carry sdc_detected
    # -- the JAX package's planes not ported: each off, or the server
    #    refuses to build (FeatureNotPortedError) --------------------------
    supervised_handoff: bool = False  # the fleet supervisor's handoff lane
    outofcore_handoff: bool = False   # the host-streamed handoff lane
    live_port: Optional[int] = None  # the live telemetry endpoint
    slos: tuple = ()                # its SLO definitions
    slo_shed: bool = False          # SLO-degraded admission
    journal_dir: Optional[str] = None  # the write-ahead request journal
    flight_dir: Optional[str] = None  # the crash-surviving flight recorder
    attr: Optional[bool] = None     # the device-time attribution plane
    lanes: int = 0                  # the mesh serving plane's lanes


@dataclasses.dataclass
class ServeResult:
    """What a completed (or refused) request resolves to."""

    status: str
    x: Optional[np.ndarray] = None
    lane: Optional[str] = None       # "batched" | "handoff" | "sparse" |
    #                                  "numpy"
    bucket_n: Optional[int] = None
    #: the request's end-to-end trace id, stamped at resolve so every
    #: client-visible outcome — synchronous admission rejects included —
    #: joins against the obs stream.
    trace: Optional[str] = None
    latency_s: Optional[float] = None
    queue_s: Optional[float] = None
    retry_after_s: Optional[float] = None
    error: Optional[str] = None
    rel_residual: Optional[float] = None
    #: True when the ABFT-protected lane detected (and repaired) silent
    #: data corruption while serving this request (ServeConfig.abft).
    sdc_detected: bool = False

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK


class ServeRequest:
    """One queued solve: operands, deadline, and a completion latch."""

    _ids = iter(range(1, 1 << 62))
    _ids_lock = threading.Lock()

    def __init__(self, a: np.ndarray, b: np.ndarray,
                 deadline_s: Optional[float] = None,
                 structure: Optional[str] = None,
                 dtype: Optional[str] = None):
        from gauss_tpu_torch.obs import requesttrace

        with ServeRequest._ids_lock:
            self.id = next(ServeRequest._ids)
        #: end-to-end trace identity, minted at admission and carried by
        #: every event this request touches (obs.requesttrace folds the
        #: stream back into one span tree per request).
        self.trace_id = requesttrace.mint()
        self.a = np.asarray(a)
        self.b = np.asarray(b)
        #: structure routing tag ("spd" / "banded" / "blockdiag" / "dense"
        #: / "sparse"), None when the server is not structure-aware; part
        #: of the batch compatibility key and the cache key.
        self.structure = structure
        #: batched-lane storage dtype ("float32" / "bfloat16" / "bf16x3");
        #: part of the batch compatibility key and the cache key.
        self.dtype = dtype
        self.n = self.a.shape[0]
        if self.a.shape != (self.n, self.n):
            raise ValueError(f"expected square matrix, got {self.a.shape}")
        if self.b.shape[:1] != (self.n,) or self.b.ndim > 2:
            raise ValueError(
                f"b must be (n,) or (n, k) with n={self.n}, got {self.b.shape}")
        self.was_vector = self.b.ndim == 1
        self.k = 1 if self.was_vector else self.b.shape[1]
        self.t_submit = time.perf_counter()
        self.deadline = (self.t_submit + deadline_s
                         if deadline_s is not None else None)
        self._done = threading.Event()
        self._resolve_lock = threading.Lock()
        self._result: Optional[ServeResult] = None  # guarded by: self._resolve_lock

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.perf_counter() if now is None else now) > self.deadline

    def resolve(self, result: ServeResult) -> bool:
        """Set the terminal result. FIRST resolve wins (a compare-and-set
        under a lock): the worker finishing and the client cancelling can
        race, and exactly one of them owns the terminal status. Returns
        True when this call won; callers emit their terminal obs event
        only then, so the stream carries one terminal per request too."""
        with self._resolve_lock:
            if self._result is not None:
                return False
            result.latency_s = time.perf_counter() - self.t_submit
            result.trace = self.trace_id
            self._result = result
            self._done.set()
            return True

    def cancel(self, error: str = "cancelled by client") -> bool:
        """Resolve as cancelled (if still pending); the worker then skips
        the request. Returns True when the cancellation won the race."""
        won = self.resolve(ServeResult(status=STATUS_CANCELLED, error=error))
        if won:
            from gauss_tpu_torch import obs

            obs.counter("serve.cancelled")
            obs.emit("serve_request", id=self.id, n=self.n,
                     trace=self.trace_id, status=STATUS_CANCELLED,
                     reason=error)
        return won

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        """Block until the request resolves (the client-side wait). A
        timeout CANCELS the request before raising TimeoutError; if the
        worker resolves in the race window the real result is returned."""
        if not self._done.wait(timeout):
            if self.cancel(error="client stopped waiting "
                                 f"(result timeout {timeout} s)"):
                raise TimeoutError(
                    f"request {self.id} timed out after {timeout} s and "
                    f"was cancelled")
        return self._result  # read after the done event (set under the lock)

    @property
    def done(self) -> bool:
        return self._done.is_set()


class LaneHealth:
    """Circuit breaker for the device lane (thread-safe).

    Healthy until ``unhealthy_after`` CONSECUTIVE batch failures; then the
    device lane is held open (fallback serves) for ``cooldown_s``, after
    which ONE probe batch is allowed through — success closes the circuit,
    failure re-opens it for another cooldown.
    """

    def __init__(self, unhealthy_after: int, cooldown_s: float):
        self.unhealthy_after = max(1, int(unhealthy_after))
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._consecutive = 0           # guarded by: self._lock
        self._open_until: Optional[float] = None  # guarded by: self._lock

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._open_until = None

    def record_failure(self) -> bool:
        """Count one batch failure; returns True when this trips the lane."""
        with self._lock:
            self._consecutive += 1
            tripped = (self._consecutive >= self.unhealthy_after
                       and self._open_until is None)
            if self._consecutive >= self.unhealthy_after:
                self._open_until = time.perf_counter() + self.cooldown_s
            return tripped

    def device_allowed(self) -> bool:
        """May the next batch try the device lane? (True once per cooldown
        expiry — the probe; steady-state True when healthy.)"""
        with self._lock:
            if self._open_until is None:
                return True
            if time.perf_counter() >= self._open_until:
                # Let one probe through; a failure re-opens via record_failure.
                self._open_until = None
                self._consecutive = self.unhealthy_after - 1
                return True
            return False

    @property
    def open(self) -> bool:
        with self._lock:
            return (self._open_until is not None
                    and time.perf_counter() < self._open_until)


def retry_backoff(base_s: float, attempt: int) -> float:
    """Exponential backoff delay for retry ``attempt`` (0-based)."""
    return base_s * (2 ** attempt)


def is_transient_device_error(e: BaseException) -> bool:
    """Heuristic for retryable device failures vs programming errors.

    Shape/value errors are deterministic — retrying replays the bug — while
    runtime/device errors (out of memory, injected faults) are worth a
    bounded retry and count against lane health. A kernel fault
    (:func:`gauss_tpu_torch.kernels._build.is_kernel_fault`: a build or
    launch failure, or the sticky CUDA error after a kernel faulted) is a
    fault of the program, not of the moment: not transient.
    """
    from gauss_tpu_torch.kernels._build import is_kernel_fault

    if isinstance(e, (ValueError, TypeError)):
        return False
    return not is_kernel_fault(e)

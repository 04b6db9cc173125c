"""Durable admission: the write-ahead request journal and crash recovery
(the port of ``gauss_tpu/serve/durable.py``).

- **Write-ahead journal.** With ``ServeConfig(journal_dir=...)`` every
  admitted request appends an ``admit`` record (operands included) to an
  append-only JSONL segment BEFORE ``submit()`` returns, and every terminal
  resolution appends a ``terminal`` record from the same first-resolve-wins
  CAS that guarantees one terminal per request, so the journal carries
  exactly one terminal per admit by construction. Each record line is
  ``<crc32 hex> <json>``: a torn or truncated tail (a kill mid-append, a
  merged partial line) fails its CRC and is dropped at scan time, never a
  crash; the journal parses to the longest valid record prefix wherever
  the crash landed. The records are the JAX package's byte for byte, so a
  journal written by either package scans equal in the other.
- **Batched fsync.** Appends reach the OS on every record (a process kill
  cannot lose them) and are ``fsync``ed every ``fsync_batch`` records and
  at every shutdown marker and rotation (group commit against power loss).
- **Segment rotation.** Past ``rotate_records`` the journal compacts: the
  live (unterminated) admits, the recent idempotency terminals and the
  blame records of live admits are rewritten into a fresh segment (tmp +
  fsync + rename + parent fsync, through
  :func:`gauss_tpu_torch.resilience.checkpoint.fsync_dir`) and older
  segments are deleted.
- **Crash -> restart recovery.** A server started on a journal with
  unterminated admits and no clean-shutdown marker replays them through
  its normal dispatch: in-deadline requests re-solve and re-verify,
  past-deadline ones get a typed ``STATUS_EXPIRED`` terminal, and both
  keep their original journal and trace ids.
- **Exactly-once from the client's view.** ``submit(request_id=...)``
  carries a client idempotency key; a resubmission whose key holds a
  journaled terminal resolves from the journal without a solve.
  Execution is at-least-once across a crash window; the terminal status is
  exactly-once.
- **Graceful drain.** ``stop(drain=True)`` serves what was accepted and
  appends a clean-``shutdown`` marker, so the next start replays nothing.
- **Supervision.** :func:`supervise` restarts a serving child that died
  (exited nonzero) or stalled (its heartbeat file went stale) against the
  same journal, within a restart budget; a death that pushed a suspect to
  the quarantine threshold respawns without charging it.

``journal_dir=None`` (the default) keeps all of this out of the serve
path: one ``is None`` check at admission, and the terminal hook is only
installed on journaled requests.

Fault hooks (:mod:`gauss_tpu_torch.resilience.inject`):
``serve.server.batch`` fires at every worker batch boundary (kind
``server_kill``: ``os._exit``) and ``serve.journal.append`` at every
record append (kind ``journal_torn_write``: a partial record, then
``os._exit``).

With ``flight_dir``, :func:`supervise` hands its children the flight dir
(``GAUSS_FLIGHT_DIR``) and captures a post-mortem bundle of every death it
detects (:mod:`gauss_tpu_torch.obs.postmortem`), as the JAX package's
does. Importing this module loads no torch.
"""

from __future__ import annotations

import base64
import json
import os
import signal
import subprocess
import tempfile
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.resilience import inject as _inject
from gauss_tpu_torch.resilience.checkpoint import fsync_dir

#: journal record schema (bumped on incompatible record changes; a scan of
#: a newer schema is a typed error, never a misparse)
JOURNAL_SCHEMA = 1

SEGMENT_PREFIX = "journal-"
SEGMENT_SUFFIX = ".jsonl"

#: idempotency terminals carried across a rotation compaction (the dedupe
#: window: a keyed resubmission older than this many terminals may re-solve)
IDEMPOTENCY_KEEP = 1024


class JournalError(RuntimeError):
    """The journal directory cannot be trusted (foreign schema, unreadable
    directory). Torn/truncated RECORDS are never this — they are dropped by
    construction; this is for damage recovery must not guess through."""


# -- array codec -----------------------------------------------------------

def encode_array(a: np.ndarray) -> Dict[str, Any]:
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(doc: Dict[str, Any]) -> np.ndarray:
    raw = base64.b64decode(doc["b64"])
    return np.frombuffer(raw, dtype=np.dtype(doc["dtype"])).reshape(
        doc["shape"]).copy()


# -- record line codec -----------------------------------------------------

def encode_record(doc: Dict[str, Any]) -> bytes:
    body = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    crc = zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF
    return f"{crc:08x} {body}\n".encode("utf-8")


def decode_line(line: bytes) -> Optional[Dict[str, Any]]:
    """One journal line -> record dict, or None when the line is torn —
    short, CRC-mismatched (a partial record merged with the next append),
    or not JSON. Never raises: a corrupt line is a dropped line."""
    try:
        text = line.decode("utf-8")
    except UnicodeDecodeError:
        return None
    if len(text) < 10 or text[8] != " ":
        return None
    crc_hex, body = text[:8], text[9:].rstrip("\n")
    try:
        crc = int(crc_hex, 16)
    except ValueError:
        return None
    if zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF != crc:
        return None
    try:
        doc = json.loads(body)
    except ValueError:
        return None
    return doc if isinstance(doc, dict) else None


# -- scan ------------------------------------------------------------------

class JournalState:
    """What a scan of a journal directory recovers: the admits still owed a
    terminal, the idempotency map, and whether the last run shut down
    cleanly."""

    def __init__(self):
        self.admits: Dict[int, Dict[str, Any]] = {}     # id -> admit record
        self.order: List[int] = []                      # admit ids, in order
        self.terminals: Dict[int, Dict[str, Any]] = {}  # id -> terminal
        #: client idempotency key -> terminal record (the dedupe map)
        self.by_rid: Dict[str, Dict[str, Any]] = {}
        #: pre-dispatch blame records (the quarantine evidence)
        self.blames: List[Dict[str, Any]] = []
        self.clean_shutdown = False
        self.records = 0
        self.torn_dropped = 0
        self.max_id = 0
        self.max_boot = 0

    def live_admits(self) -> List[Dict[str, Any]]:
        """Admit records with no terminal, in admission order — the replay
        set."""
        return [self.admits[i] for i in self.order if i not in self.terminals]

    def death_counts(self) -> Dict[int, int]:
        """For each admit still owed a terminal, the number of DISTINCT
        boots whose blame records implicate it — the quarantine evidence a
        replay consults. An id blamed twice in the SAME incarnation (two
        dispatch attempts before one crash) counts once: deaths, not
        dispatches. Terminated admits are excluded — a request that reached
        its terminal can no longer be the crash trigger being hunted."""
        boots: Dict[int, set] = {}
        for doc in self.blames:
            boot = doc.get("boot")
            for rid in doc.get("ids") or ():
                if isinstance(rid, int):
                    boots.setdefault(rid, set()).add(boot)
        return {i: len(boots[i]) for i in self.order
                if i not in self.terminals and i in boots}

    def apply(self, doc: Dict[str, Any]) -> None:
        rec = doc.get("rec")
        # Any record after a shutdown marker belongs to a NEWER run in the
        # same directory: the marker only means "clean" when final.
        if rec != "shutdown":
            self.clean_shutdown = False
        if rec == "admit":
            rid = doc.get("id")
            if isinstance(rid, int):
                self.admits[rid] = doc
                self.order.append(rid)
                self.max_id = max(self.max_id, rid)
        elif rec == "terminal":
            rid = doc.get("id")
            if isinstance(rid, int):
                self.terminals.setdefault(rid, doc)
                self.max_id = max(self.max_id, rid)
            key = doc.get("rid")
            if key:
                self.by_rid.setdefault(str(key), doc)
        elif rec == "blame":
            self.blames.append(doc)
            boot = doc.get("boot")
            if isinstance(boot, int):
                self.max_boot = max(self.max_boot, boot)
        elif rec == "shutdown":
            self.clean_shutdown = True


def segment_paths(dirpath: str) -> List[str]:
    try:
        names = sorted(n for n in os.listdir(dirpath)
                       if n.startswith(SEGMENT_PREFIX)
                       and n.endswith(SEGMENT_SUFFIX))
    except FileNotFoundError:
        return []
    return [os.path.join(dirpath, n) for n in names]


def scan(dirpath: str) -> JournalState:
    """Fold every segment (oldest first) into a :class:`JournalState`.
    Torn/truncated/merged lines are counted and dropped — by construction a
    scan parses to the longest valid prefix of each segment and NEVER
    raises on tail damage."""
    state = JournalState()
    for path in segment_paths(dirpath):
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            continue
        for line in data.split(b"\n"):
            if not line:
                continue
            doc = decode_line(line + b"\n")
            if doc is None:
                state.torn_dropped += 1
                continue
            if doc.get("schema", JOURNAL_SCHEMA) > JOURNAL_SCHEMA:
                raise JournalError(
                    f"journal segment {path} carries schema "
                    f"{doc.get('schema')} > {JOURNAL_SCHEMA}: refusing to "
                    f"replay records this build cannot interpret")
            state.records += 1
            state.apply(doc)
    return state


# -- the journal -----------------------------------------------------------

class RequestJournal:
    """Append-only, CRC-per-record, segment-rotated request journal.

    Thread-safe: client threads (admits, client-side cancels) and the
    worker thread (terminals) append concurrently under one lock. All
    appends go to the LIVE segment; a restart always opens a fresh segment
    so recovery appends never extend a possibly-torn tail.
    """

    def __init__(self, dirpath: str, *, fsync_batch: int = 8,
                 rotate_records: int = 4096):
        self.dir = os.fspath(dirpath)
        os.makedirs(self.dir, exist_ok=True)
        self.fsync_batch = max(1, int(fsync_batch))
        self.rotate_records = max(16, int(rotate_records))
        self._lock = threading.Lock()
        #: the state recovered from segments present at open (what a
        #: restart replays); live appends do NOT update it.
        self.recovered = scan(self.dir)
        #: this incarnation's boot number — monotone per journal open, so
        #: blame records from distinct incarnations are distinguishable and
        #: death_counts() counts deaths, not dispatch attempts.
        self.boot = self.recovered.max_boot + 1
        segs = segment_paths(self.dir)
        if segs:
            last = os.path.basename(segs[-1])
            seq = int(last[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)]) + 1
        else:
            seq = 0
        self._seq = seq                 # guarded by: self._lock
        self._path = self._segment_path(seq)  # guarded by: self._lock
        self._f = open(self._path, "ab", buffering=0)  # guarded by: self._lock
        self._live_records = 0          # guarded by: self._lock
        #: rotate once the live segment holds this many records; reset
        #: past each compaction to carried + rotate_records, so a large
        #: carried set cannot re-trigger rotation on every append.
        self._rotate_at = self.rotate_records  # guarded by: self._lock
        self._since_fsync = 0           # guarded by: self._lock
        self.appends = 0
        self.fsyncs = 0
        self.rotations = 0
        self.closed = False             # guarded by: self._lock
        if self.recovered.torn_dropped:
            obs.emit("journal", event="torn_tail",
                     dropped=self.recovered.torn_dropped, dir=self.dir)
        obs.emit("journal", event="open", dir=self.dir, segment=self._seq,
                 recovered_records=self.recovered.records,
                 live=len(self.recovered.live_admits()),
                 clean_shutdown=self.recovered.clean_shutdown)

    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{SEGMENT_PREFIX}{seq:06d}"
                                      f"{SEGMENT_SUFFIX}")

    # -- append paths ------------------------------------------------------

    def _append(self, doc: Dict[str, Any], force_fsync: bool = False) -> None:
        payload = encode_record(doc)
        with self._lock:
            if self.closed:
                return
            if _inject.enabled():
                sp = _inject.poll_torn_write("serve.journal.append")
                if sp is not None:
                    # A crash MID-APPEND: a prefix of the record reaches the
                    # file, the process dies before the rest. `param` (0,1)
                    # picks the tear fraction; the torn line fails its CRC
                    # at the next scan and is dropped by construction.
                    frac = sp.param if 0 < sp.param < 1 else 0.5
                    cut = max(1, int(len(payload) * frac))
                    self._f.write(payload[:cut])
                    os._exit(_inject.KILL_EXIT_CODE)
            self._f.write(payload)  # unbuffered: flushed to the OS per record
            self.appends += 1
            self._live_records += 1
            self._since_fsync += 1
            if force_fsync or self._since_fsync >= self.fsync_batch:
                os.fsync(self._f.fileno())
                self.fsyncs += 1
                self._since_fsync = 0
            obs.counter("journal.appends")
            rotate = self._live_records >= self._rotate_at
        if rotate:
            self.rotate()

    def append_admit(self, *, id: int, request_id: Optional[str],
                     trace: str, a: np.ndarray, b: np.ndarray,
                     was_vector: bool, deadline_unix: Optional[float],
                     dtype: Optional[str], structure: Optional[str]) -> None:
        self._append({
            "rec": "admit", "schema": JOURNAL_SCHEMA, "id": int(id),
            "rid": request_id, "trace": trace,
            "n": int(a.shape[0]), "k": 1 if was_vector else int(b.shape[1]),
            "was_vector": bool(was_vector),
            "deadline_unix": deadline_unix, "t_unix": time.time(),
            "dtype": dtype, "structure": structure,
            "a": encode_array(np.asarray(a, np.float64)),
            "b": encode_array(np.asarray(b, np.float64)),
        })

    def append_terminal(self, *, id: int, request_id: Optional[str],
                        trace: str, status: str,
                        x: Optional[np.ndarray] = None,
                        lane: Optional[str] = None,
                        rel_residual: Optional[float] = None,
                        error: Optional[str] = None) -> Dict[str, Any]:
        doc = {"rec": "terminal", "schema": JOURNAL_SCHEMA, "id": int(id),
               "rid": request_id, "trace": trace, "status": status,
               "lane": lane, "t_unix": time.time(),
               "rel_residual": (float(rel_residual)
                               if rel_residual is not None else None),
               "error": (str(error)[:500] if error else None)}
        if x is not None:
            doc["x"] = encode_array(np.asarray(x, np.float64))
        self._append(doc)
        return doc

    def append_blame(self, *, ids: List[int],
                     rids: Optional[List[str]] = None,
                     boot: Optional[int] = None) -> None:
        """The pre-dispatch blame record: names every journal id (and
        client rid) the next dispatch puts at risk. A crash between this
        append and the batch's terminals leaves the ids implicated in this
        boot — the evidence ``JournalState.death_counts`` folds into the
        replay-time quarantine decision.

        ``boot`` overrides this incarnation's boot number; journal ADOPTION
        uses negative synthetic boots (never colliding with real boots,
        which start at 1) to carry a dead replica's death counts onto the
        adopter's journal id."""
        self._append({"rec": "blame", "schema": JOURNAL_SCHEMA,
                      "boot": int(self.boot if boot is None else boot),
                      "ids": [int(i) for i in ids],
                      "rids": [str(r) for r in (rids or [])],
                      "t_unix": time.time()})

    def append_shutdown(self) -> None:
        """The clean-shutdown marker: the next start replays nothing. Always
        fsynced — this is the record whose absence means 'crashed'."""
        self._append({"rec": "shutdown", "schema": JOURNAL_SCHEMA,
                      "t_unix": time.time()}, force_fsync=True)
        obs.emit("journal", event="shutdown_marker", dir=self.dir)

    # -- rotation ----------------------------------------------------------

    def rotate(self) -> None:
        """Compact into a fresh segment: re-journal the still-live admits
        plus the most recent :data:`IDEMPOTENCY_KEEP` keyed terminals (the
        dedupe window), atomically (tmp + fsync + rename + dir fsync), then
        delete the older segments. A kill at any instant leaves either the
        old segments or the complete new one."""
        with self._lock:
            if self.closed:
                return
            os.fsync(self._f.fileno())
            self.fsyncs += 1
            self._since_fsync = 0
            self._f.close()
            state = scan(self.dir)
            keep: List[Dict[str, Any]] = state.live_admits()
            keyed = [t for t in state.terminals.values() if t.get("rid")]
            keyed.sort(key=lambda t: t.get("t_unix") or 0.0)
            keep += keyed[-IDEMPOTENCY_KEEP:]
            # Blame evidence follows the admits it implicates: a rotation
            # must not amnesty a poison request's death history.
            live_ids = {d["id"] for d in state.live_admits()}
            keep += [bl for bl in state.blames
                     if live_ids.intersection(bl.get("ids") or ())]
            old = segment_paths(self.dir)
            self._seq += 1
            self._path = self._segment_path(self._seq)
            fd, tmp = tempfile.mkstemp(
                prefix=os.path.basename(self._path) + ".", suffix=".tmp",
                dir=self.dir)
            with os.fdopen(fd, "wb") as f:
                for doc in keep:
                    f.write(encode_record(doc))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path)
            fsync_dir(self.dir)
            for path in old:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self._f = open(self._path, "ab", buffering=0)
            self._live_records = len(keep)
            self._rotate_at = len(keep) + self.rotate_records
            self.rotations += 1
            obs.counter("journal.rotations")
            obs.emit("journal", event="rotate", segment=self._seq,
                     carried=len(keep), deleted=len(old))

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            try:
                os.fsync(self._f.fileno())
                self.fsyncs += 1
            except OSError:
                pass
            self._f.close()
            self.closed = True

    def abandon(self) -> None:
        """Crash stand-in for in-process chaos: drop the file handle with
        no fsync, no marker, no close bookkeeping — the journal directory
        is left exactly as a kill would leave it."""
        with self._lock:
            try:
                self._f.close()
            finally:
                self.closed = True

    def stats(self) -> Dict[str, Any]:
        segs = segment_paths(self.dir)
        return {"dir": self.dir, "segments": len(segs),
                "appends": self.appends, "fsyncs": self.fsyncs,
                "rotations": self.rotations,
                "bytes": sum(os.path.getsize(p) for p in segs
                             if os.path.exists(p)),
                "recovered_records": self.recovered.records,
                "torn_dropped": self.recovered.torn_dropped}


def terminal_to_result(doc: Dict[str, Any]):
    """A journaled terminal record -> the client-visible ServeResult a
    deduped resubmission resolves with (solution included when journaled)."""
    from gauss_tpu_torch.serve.admission import ServeResult

    x = decode_array(doc["x"]) if doc.get("x") is not None else None
    return ServeResult(status=doc.get("status"), x=x, lane=doc.get("lane"),
                       rel_residual=doc.get("rel_residual"),
                       error=doc.get("error"))


def quarantinable_ids(dirpath: str, k: int = 1) -> Dict[int, int]:
    """Scan a (possibly dead) journal directory for live admit ids
    implicated in at least ``k`` prior worker deaths: ``{id: deaths}``.
    The supervisor and journal adoption use this
    to recognize a poison-driven death without owning a journal handle.
    Never raises on a damaged directory — no evidence means no quarantine."""
    try:
        counts = scan(dirpath).death_counts()
    except (JournalError, OSError):
        return {}
    return {i: c for i, c in counts.items() if c >= k}


# -- the supervisor --------------------------------------------------------

def supervise(child_argv: List[str], *, heartbeat_path: str,
              max_restarts: int = 3, stall_after_s: float = 30.0,
              poll_s: float = 0.25, term_grace_s: float = 15.0,
              env: Optional[Dict[str, str]] = None,
              flight_dir: Optional[str] = None,
              journal_dir: Optional[str] = None,
              quarantine_deaths: int = 2,
              log=print) -> int:
    """Run ``child_argv`` and restart it, against the same journal, when it
    dies or stalls.

    - *died*: the child exited nonzero (crash, kill, preemption).
    - *stalled*: the child is alive but its heartbeat file (written from
      the serve worker loop) has not been touched for ``stall_after_s``:
      it is killed and waited for, then restarted.
    - restarts are bounded by ``max_restarts``; a child that exits 0 ends
      supervision with 0. Respawns strip ``GAUSS_FAULTS`` from the
      environment: an injected kill models a one-off crash.
    - a death that pushed some live journal id's death count to
      ``quarantine_deaths`` or past it (``journal_dir`` given) respawns
      without charging the budget: the next replay quarantines the
      suspect. ``quarantine_deaths`` must match the child server's
      ``ServeConfig.quarantine_deaths``; 0 disables the free respawns.

    A respawn starts only after the previous child has exited, so two
    incarnations never hold the card at once. SIGTERM to the supervisor
    (in the main thread) is forwarded to the child for a graceful drain,
    and the child's exit code is returned.

    With ``flight_dir``, the children inherit it through
    ``GAUSS_FLIGHT_DIR`` (a child server records into its ring), and every
    died/stalled detection harvests the dead incarnation's ring into a
    post-mortem bundle (cause ``supervisor_death``, ``supervisor_stall``
    or ``poison_quarantine``) BEFORE the restart overwrites the scene."""
    base_env = dict(env if env is not None else os.environ)
    base_env["GAUSS_SERVE_HEARTBEAT"] = heartbeat_path
    if flight_dir:
        base_env["GAUSS_FLIGHT_DIR"] = os.fspath(flight_dir)

    def _capture(cause: str, **detail) -> None:
        """The supervisor's post-mortem capture; never raises (a capture
        failure must not cost the restart)."""
        if not flight_dir:
            return
        try:
            from gauss_tpu_torch.obs import postmortem

            postmortem.capture_bundle(
                postmortem.default_bundles_dir(flight_dir), cause,
                flight_dir=flight_dir, journal_dir=journal_dir,
                heartbeat_path=heartbeat_path, extra=detail, log=log)
        except Exception as e:  # pragma: no cover — capture is best-effort
            log(f"supervise: post-mortem capture failed: {e}")
    restarts = 0
    draining = {"flag": False}
    child: Dict[str, Optional[subprocess.Popen]] = {"proc": None}
    prev_deaths: Dict[int, int] = (
        quarantinable_ids(journal_dir) if journal_dir else {})

    def _forward_term(signum, frame):  # pragma: no cover — signal timing
        draining["flag"] = True
        proc = child["proc"]
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGTERM)

    prev = None
    try:
        prev = signal.signal(signal.SIGTERM, _forward_term)
    except ValueError:  # not the main thread (tests drive this in-thread)
        prev = None

    def _hb_age() -> Optional[float]:
        try:
            return time.time() - os.path.getmtime(heartbeat_path)
        except OSError:
            return None

    try:
        spawn_env = base_env
        while True:
            t_spawn = time.time()
            proc = subprocess.Popen(child_argv, env=spawn_env)
            child["proc"] = proc
            obs.counter("serve.supervisor_spawns")
            obs.emit("serve_supervisor", event="spawn", pid=proc.pid,
                     restarts=restarts)
            log(f"supervise: spawned pid {proc.pid} (restart {restarts})")
            stalled = False
            while proc.poll() is None:
                time.sleep(poll_s)
                if draining["flag"]:
                    continue  # drain in progress; wait for its exit
                age = _hb_age()
                # A stall is called only once the child has had time to
                # write its first beat (spawn + torch import + CUDA start).
                if (age is not None and age > stall_after_s
                        and time.time() - t_spawn > stall_after_s):
                    stalled = True
                    obs.emit("serve_supervisor", event="stall",
                             pid=proc.pid, heartbeat_age_s=round(age, 3))
                    log(f"supervise: pid {proc.pid} stalled "
                        f"(heartbeat {age:.1f}s stale); killing")
                    proc.kill()
                    proc.wait(timeout=term_grace_s)
                    break
            rc = proc.returncode
            if rc == 0 and not stalled:
                obs.emit("serve_supervisor", event="done", restarts=restarts)
                return 0
            if draining["flag"]:
                obs.emit("serve_supervisor", event="drained", rc=rc)
                return rc if rc is not None else 0
            cause = "stalled" if stalled else f"died rc={rc}"
            quarantined = False
            if journal_dir and quarantine_deaths > 0:
                cur = quarantinable_ids(journal_dir)
                quarantined = any(c >= quarantine_deaths
                                  and c > prev_deaths.get(i, 0)
                                  for i, c in cur.items())
                prev_deaths = cur
            _capture("poison_quarantine" if quarantined
                     else "supervisor_stall" if stalled
                     else "supervisor_death",
                     rc=rc, restarts=restarts, pid=proc.pid)
            if quarantined:
                obs.counter("serve.quarantined_respawns")
                obs.emit("serve_supervisor", event="restart",
                         cause="quarantined", underlying=cause,
                         restarts=restarts)
                log(f"supervise: child {cause} with a suspect at the "
                    f"quarantine threshold — quarantined death; restarting "
                    f"without charging the budget "
                    f"({restarts}/{max_restarts} spent)")
            elif restarts >= max_restarts:
                obs.emit("serve_supervisor", event="gave_up", cause=cause,
                         restarts=restarts)
                log(f"supervise: {cause}; restart budget "
                    f"({max_restarts}) spent — giving up")
                return rc if rc else 1
            else:
                restarts += 1
                obs.counter("serve.supervisor_restarts")
                obs.emit("serve_supervisor", event="restart", cause=cause,
                         restarts=restarts)
                log(f"supervise: child {cause}; restarting against the same "
                    f"journal ({restarts}/{max_restarts})")
            # One-off-crash contract: injected fault plans die with the
            # incarnation they killed.
            spawn_env = {k: v for k, v in base_env.items()
                         if k != _inject.ENV_VAR}
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        proc = child["proc"]
        if proc is not None and proc.poll() is None:  # pragma: no cover
            proc.kill()
            proc.wait(timeout=term_grace_s)

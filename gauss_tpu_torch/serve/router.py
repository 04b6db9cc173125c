"""The replica front tier: consistent-hash routing + journal failover (the
port of ``gauss_tpu/serve/router.py``).

One :class:`Router` owns N ``SolverServer`` replica PROCESSES (each is
``python -m gauss_tpu_torch.serve.net --replica`` — a journaled server
behind the request API, recording into its ``flight/`` ring), watches
them (liveness polling, heartbeat staleness, bounded restarts), and
fronts them with one HTTP endpoint speaking the same wire schema, so a
client cannot tell one replica from many:

- **Routing.** A request's ``matrix_id`` (falling back to its idempotency
  key) is consistent-hashed over the replica ring (:class:`HashRing` —
  md5 positions, ``vnodes`` virtual nodes per replica, lookups walk
  clockwise skipping dead replicas), so repeat-A traffic keeps hitting
  the replica whose executable cache is warm for it. The FIRST sight of
  an idempotency key pins it in the :class:`AssignLog`; every later
  resubmit of that key follows the pin, because exactly-once depends on
  the resubmit reaching the journal that knows the key.
- **Failover.** When a replica dies (exit, injected kill, stall-kill),
  the router retires its journal directory, asks a surviving peer to
  ADOPT it (``POST /v1/adopt`` → :func:`gauss_tpu_torch.serve.net
  .adopt_journal`: terminals imported for dedupe, live admits replayed,
  expired admits typed), appends a fsync-forced failover record
  remapping the dead replica's pinned keys to the adopter, and respawns
  the replica against a fresh journal. A resubmit that raced the window
  either hits the pinned-but-dead replica (503 → the client's jittered
  retry lands after the remap) or the adopter (the imported journal
  dedupes) — never a second solve.
- **Restart accounting.** Deaths are classified through
  :func:`gauss_tpu_torch.resilience.fleet.exit_cause`: a graceful drain
  (``fleet.DRAIN_EXIT``) respawns WITHOUT charging ``max_restarts`` (a
  rolling drain must not look like a crash loop), while crashes, kills
  and stalls consume the bounded budget and each capture a post-mortem
  bundle from the dead replica's flight ring (cause ``supervisor_death``
  / ``supervisor_stall`` — the same vocabulary ``durable.supervise``
  uses) before the respawn overwrites the scene.

The assign log, the ring's positions and the wire are the JAX package's:
a log written by either package replays in the other, and the same nodes
and keys map to the same replica. Deliberate deviations (ROADMAP queue
3): :class:`RouterConfig` has the port's own ``device`` (default
``"cuda"``; a replica that finds no card exits at startup, never falling
back to the CPU) and ``structure_aware`` fields, passed to every replica;
``spawn_timeout_s`` counts a replica's start on the card (its torch
import, its CUDA start and, on a new checkout, the kernels' build, which
``kernels._build`` runs once under a file lock for all replicas); and a
failover passes over a survivor whose heartbeat is already stale instead
of posting the adopt to it (the JAX router posts it and waits out the
adopt timeout, its watch loop held all the while).
Importing this module loads no torch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from bisect import bisect_right
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Set, Tuple
from urllib.parse import urlparse

from gauss_tpu_torch import obs
from gauss_tpu_torch.resilience import fleet as _fleet
from gauss_tpu_torch.resilience import inject as _inject
from gauss_tpu_torch.serve import durable

#: virtual nodes per replica on the hash ring: enough that removing one
#: replica of three moves ~1/3 of the keyspace, not a contiguous half.
RING_VNODES = 64
#: assign-log group-commit batch (failover records always force fsync —
#: a lost plain assign is recoverable by deterministic rehash; a lost
#: failover record is not).
ASSIGN_FSYNC_BATCH = 8


def _ring_hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    """Consistent hashing over replica names. Immutable after build —
    liveness is a per-lookup filter, not a ring mutation, so the mapping
    of keys to their PREFERRED replica never churns when a replica
    bounces."""

    def __init__(self, nodes: List[str], vnodes: int = RING_VNODES):
        self.nodes = tuple(nodes)
        points: List[Tuple[int, str]] = []
        for node in nodes:
            for v in range(vnodes):
                points.append((_ring_hash(f"{node}#{v}"), node))
        points.sort()
        self._points = points
        self._hashes = [h for h, _ in points]

    def lookup(self, key: str, live: Optional[Set[str]] = None,
               ) -> Optional[str]:
        """The first clockwise replica from ``key``'s ring position that
        is in ``live`` (all nodes when None). Also how failover picks the
        adopter: ``lookup(dead_name, survivors)`` is the dead replica's
        ring successor."""
        if not self._points:
            return None
        start = bisect_right(self._hashes, _ring_hash(key))
        for i in range(len(self._points)):
            node = self._points[(start + i) % len(self._points)][1]
            if live is None or node in live:
                return node
        return None


class AssignLog:
    """Durable ``rid -> replica`` pin map (CRC'd records via the journal
    line codec, so a torn tail drops records instead of poisoning the
    scan). ``assign`` records are group-committed; ``failover`` records
    fsync immediately. A router restart reloads the surviving prefix —
    an assign lost from the torn tail re-derives by rehash, which is
    only wrong if the live set changed in the same crash window, in
    which case the journal dedupe still holds the exactly-once line."""

    def __init__(self, path: str):
        self.path = path
        self._alock = threading.Lock()
        self._pins: Dict[str, str] = {}   # guarded by: self._alock
        self._unsynced = 0                # guarded by: self._alock
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        for doc in self._scan():
            self._apply(doc)
        self._fh = open(path, "ab")       # guarded by: self._alock

    def _scan(self) -> List[Dict[str, Any]]:
        docs = []
        try:
            with open(self.path, "rb") as f:
                for line in f.read().split(b"\n"):
                    if not line:
                        continue
                    doc = durable.decode_line(line + b"\n")
                    if doc is not None:
                        docs.append(doc)
        except OSError:
            pass
        return docs

    def _apply(self, doc: Dict[str, Any]) -> None:
        # Construction-time replay only: runs before the instance is
        # published to any other thread, so _pins needs no lock yet.
        if doc.get("rec") == "assign":
            self._pins[str(doc["rid"])] = str(doc["node"])  # lockset: ok — pre-publication replay in __init__
        elif doc.get("rec") == "failover":
            src, dst = str(doc["from"]), str(doc["to"])
            for rid, node in list(self._pins.items()):  # lockset: ok — pre-publication replay in __init__
                if node == src:
                    self._pins[rid] = dst  # lockset: ok — pre-publication replay in __init__

    def _append(self, doc: Dict[str, Any], force_fsync: bool) -> None:
        # Private write path: every caller (assign/failover) already holds
        # _alock; taking it again here would deadlock a non-reentrant lock.
        self._fh.write(durable.encode_record(doc))  # lockset: ok — caller holds _alock
        self._fh.flush()  # lockset: ok — caller holds _alock
        self._unsynced += 1  # lockset: ok — caller holds _alock
        if force_fsync or self._unsynced >= ASSIGN_FSYNC_BATCH:  # lockset: ok — caller holds _alock
            os.fsync(self._fh.fileno())  # lockset: ok — caller holds _alock
            self._unsynced = 0  # lockset: ok — caller holds _alock

    def resolve(self, rid: str) -> Optional[str]:
        with self._alock:
            return self._pins.get(rid)

    def assign(self, rid: str, node: str) -> None:
        with self._alock:
            if self._pins.get(rid) == node:
                return
            self._pins[rid] = node
            self._append({"rec": "assign", "rid": rid, "node": node},
                         force_fsync=False)

    def failover(self, src: str, dst: str) -> int:
        """Remap every pin on ``src`` to ``dst``; fsync-forced. Returns
        how many pins moved."""
        with self._alock:
            moved = 0
            for rid, node in list(self._pins.items()):
                if node == src:
                    self._pins[rid] = dst
                    moved += 1
            self._append({"rec": "failover", "from": src, "to": dst},
                         force_fsync=True)
            return moved

    def pins(self) -> Dict[str, str]:
        with self._alock:
            return dict(self._pins)

    def close(self) -> None:
        with self._alock:
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except (OSError, ValueError):
                pass
            self._fh.close()


@dataclasses.dataclass
class RouterConfig:
    """Knobs for the replica front tier."""

    replicas: int = 3               # replica process count
    dir: str = "gauss_router"      # state root: r<i>/ per replica + assign log
    port: int = 0                   # front endpoint port (0 = ephemeral)
    host: str = "127.0.0.1"
    # -- per-replica ServeConfig passthrough -------------------------------
    ladder: tuple = ()
    max_batch: int = 8
    max_queue: int = 256
    linger_s: float = 0.0
    verify_gate: Optional[float] = None
    dtype: str = "float32"
    fsync_batch: int = 4
    device: str = "cuda"            # the replicas' --device (the port's)
    structure_aware: bool = False   # the replicas' --structure-aware
    # -- supervision -------------------------------------------------------
    max_restarts: int = 3           # crash-restart budget (drains are free)
    #: blame-journal quarantine threshold for the free-respawn guard; must
    #: match the replicas' ``ServeConfig.quarantine_deaths`` (both default
    #: 2). A death is uncharged only when it pushed a suspect's death
    #: count TO this threshold or past it — the point where the adoption-
    #: side replay solos or typed-rejects the suspect. 0 disables.
    quarantine_deaths: int = 2
    stall_after_s: float = 30.0     # heartbeat staleness that calls a stall
    poll_s: float = 0.25            # watch-loop cadence
    spawn_timeout_s: float = 180.0  # endpoint.json publish deadline
    forward_timeout_s: float = 120.0  # per proxied request


class ReplicaProc:
    """One spawned replica process + its on-disk state dir."""

    def __init__(self, name: str, dirpath: str, proc: subprocess.Popen,
                 log_fh):
        self.name = name
        self.dirpath = dirpath
        self.proc = proc
        self.url: Optional[str] = None
        self.t_spawn = time.time()
        self._log_fh = log_fh

    def wait_ready(self, timeout_s: float) -> str:
        """Block until this incarnation published ``endpoint.json`` (pid
        must match — a stale file from the previous incarnation does not
        count)."""
        deadline = time.monotonic() + timeout_s
        path = os.path.join(self.dirpath, "endpoint.json")
        while time.monotonic() < deadline:
            rc = self.proc.poll()
            if rc is not None:
                raise RuntimeError(
                    f"replica {self.name} died during startup (rc={rc}, "
                    f"cause={_fleet.exit_cause(rc)}); see "
                    f"{self.dirpath}/child.log")
            try:
                with open(path) as f:
                    doc = json.load(f)
                if doc.get("pid") == self.proc.pid:
                    self.url = str(doc["url"])
                    return self.url
            except (OSError, ValueError, KeyError):
                pass
            time.sleep(0.05)
        raise TimeoutError(f"replica {self.name} did not publish its "
                           f"endpoint within {timeout_s} s")

    def heartbeat_age(self) -> Optional[float]:
        try:
            return time.time() - os.path.getmtime(
                os.path.join(self.dirpath, "heartbeat.json"))
        except OSError:
            return None

    def stale(self, after_s: float) -> Optional[float]:
        """The heartbeat's age when it, and this incarnation, are older
        than ``after_s`` (a stall), else None."""
        age = self.heartbeat_age()
        if (age is not None and age > after_s
                and time.time() - self.t_spawn > after_s):
            return age
        return None

    def retire_journal(self, seq: int) -> Optional[str]:
        """Move this incarnation's journal aside for adoption; the
        respawn starts a FRESH journal (the retired one now belongs to
        the adopter, and two writers against one journal dir would tear
        it)."""
        src = os.path.join(self.dirpath, "journal")
        if not os.path.isdir(src):
            return None
        # The seq counter is per-Router; a retired dir from a PREVIOUS
        # incarnation against the same state dir would collide the rename
        # (and an OSError here would take the watch thread down with it) —
        # probe forward to a free name instead.
        dst = os.path.join(self.dirpath, f"journal-failed-{seq}")
        k = seq
        while os.path.exists(dst):
            k += 1
            dst = os.path.join(self.dirpath, f"journal-failed-{k}")
        os.rename(src, dst)
        return dst

    def close_log(self) -> None:
        try:
            self._log_fh.close()
        except OSError:  # pragma: no cover
            pass


class Router:
    """Spawn/watch N replicas, route requests, fail over journals.

    ``start()`` brings up the replicas (spawned at once, each waited for)
    and the front endpoint; ``kill_replica``/``terminate_replica`` are the
    chaos surface the replica campaign drives; ``stop(drain=True)``
    SIGTERMs every replica and expects ``fleet.DRAIN_EXIT`` back (the
    graceful path)."""

    def __init__(self, config: Optional[RouterConfig] = None):
        self.config = config if config is not None else RouterConfig()
        names = [f"r{i}" for i in range(self.config.replicas)]
        self.ring = HashRing(names)
        self.alog: Optional[AssignLog] = None
        self._rlock = threading.Lock()
        self._live: Dict[str, ReplicaProc] = {}   # guarded by: self._rlock
        self.restarts_used = 0                    # guarded by: self._rlock
        self.degraded = False                     # guarded by: self._rlock
        self.failovers = 0                        # guarded by: self._rlock
        self._retired_dirs: List[str] = []        # guarded by: self._rlock
        self._failover_seq = 0                    # guarded by: self._rlock
        #: stable request key (rid / trace) -> max deaths seen across
        #: failovers — the quarantine growth guard. guarded by: self._rlock
        self._blame_seen: Dict[str, int] = {}
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._api: Optional["RouterFront"] = None
        self._stopping = False                    # guarded by: self._rlock

    # -- lifecycle ---------------------------------------------------------

    def _spawn(self, name: str, strip_faults: bool = False) -> ReplicaProc:
        cfg = self.config
        rdir = os.path.join(cfg.dir, name)
        os.makedirs(rdir, exist_ok=True)
        cmd = [sys.executable, "-m", "gauss_tpu_torch.serve.net",
               "--replica", "--dir", rdir, "--port", "0",
               "--max-batch", str(cfg.max_batch),
               "--max-queue", str(cfg.max_queue),
               "--linger", str(cfg.linger_s),
               "--dtype", cfg.dtype,
               "--fsync-batch", str(cfg.fsync_batch),
               "--device", cfg.device]
        if cfg.structure_aware:
            cmd.append("--structure-aware")
        if cfg.ladder:
            cmd += ["--ladder", ",".join(str(r) for r in cfg.ladder)]
        if cfg.verify_gate is not None:
            cmd += ["--verify-gate", str(cfg.verify_gate)]
        env = dict(os.environ)
        if strip_faults:
            # One-off-crash contract (same as durable.supervise): an
            # injected kill dies with the incarnation it killed.
            env.pop(_inject.ENV_VAR, None)
        log_fh = open(os.path.join(rdir, "child.log"), "ab")
        proc = subprocess.Popen(cmd, env=env, stdout=log_fh,
                                stderr=subprocess.STDOUT)
        rp = ReplicaProc(name, rdir, proc, log_fh)
        obs.emit("router", event="replica_spawn", replica=name,
                 pid=proc.pid, dir=rdir)
        return rp

    def start(self) -> "Router":
        cfg = self.config
        os.makedirs(cfg.dir, exist_ok=True)
        self.alog = AssignLog(os.path.join(cfg.dir, "assign.log"))
        spawned = [self._spawn(f"r{i}") for i in range(cfg.replicas)]
        for rp in spawned:
            rp.wait_ready(cfg.spawn_timeout_s)
        with self._rlock:
            for rp in spawned:
                self._live[rp.name] = rp
        self._watch_thread = threading.Thread(
            target=self._watch, name="gauss-router-watch", daemon=True)
        self._watch_thread.start()
        self._api = RouterFront(self, port=cfg.port, host=cfg.host).start()
        obs.emit("router", event="listening", url=self._api.url,
                 replicas=cfg.replicas, dir=cfg.dir)
        return self

    @property
    def url(self) -> Optional[str]:
        return self._api.url if self._api is not None else None

    def live_replicas(self) -> Dict[str, ReplicaProc]:
        with self._rlock:
            return dict(self._live)

    def stats(self) -> Dict[str, Any]:
        with self._rlock:
            live = {name: {"pid": rp.proc.pid, "url": rp.url,
                           "heartbeat_age_s": rp.heartbeat_age()}
                    for name, rp in self._live.items()}
            return {"live": live, "restarts_used": self.restarts_used,
                    "failovers": self.failovers,
                    "degraded": self.degraded,
                    "pins": len(self.alog.pins()) if self.alog else 0}

    # -- the watch loop (liveness + heartbeat staleness) -------------------

    def _watch(self) -> None:
        cfg = self.config
        while not self._watch_stop.wait(cfg.poll_s):
            with self._rlock:
                if self._stopping:
                    return
                procs = dict(self._live)
            for name, rp in procs.items():
                # A death-handling failure (retire/adopt/respawn raising)
                # must not take the watch thread with it — a dead watcher
                # means no replica death is ever noticed again, which is
                # strictly worse than one degraded failover.
                try:
                    rc = rp.proc.poll()
                    if rc is not None:
                        self._on_death(name, rp, _fleet.exit_cause(rc),
                                       rc=rc)
                        continue
                    age = rp.stale(cfg.stall_after_s)
                    if age is not None:
                        # Alive but wedged: the heartbeat (written every
                        # worker-loop iteration) went stale — kill it and
                        # treat the death as a stall.
                        obs.emit("router", event="stall", replica=name,
                                 heartbeat_age_s=round(age, 3))
                        rp.proc.kill()
                        try:
                            rp.proc.wait(timeout=15)
                        except subprocess.TimeoutExpired:  # pragma: no cover
                            continue
                        self._on_death(name, rp, "stalled",
                                       rc=rp.proc.returncode,
                                       heartbeat_age_s=round(age, 3))
                except Exception as exc:  # pragma: no cover - defensive
                    obs.emit("router", event="death_handling_failed",
                             replica=name, error=repr(exc))
                    with self._rlock:
                        self._live.pop(name, None)
                        self.degraded = True
            with self._rlock:
                n_live = len(self._live)
            obs.gauge("router.replicas_live", n_live)

    def _capture(self, rp: ReplicaProc, cause: str, retired: Optional[str],
                 **detail) -> None:
        """Post-mortem bundle from the dead replica's flight ring —
        BEFORE the respawn overwrites the scene. Best-effort: a capture
        failure must not cost the failover."""
        try:
            from gauss_tpu_torch.obs import postmortem

            flight_dir = os.path.join(rp.dirpath, "flight")
            postmortem.capture_bundle(
                postmortem.default_bundles_dir(flight_dir), cause,
                flight_dir=flight_dir, journal_dir=retired,
                heartbeat_path=os.path.join(rp.dirpath, "heartbeat.json"),
                extra={"replica": rp.name, **detail},
                log=lambda *a: None)
        except Exception as e:  # pragma: no cover — capture is best-effort
            obs.emit("router", event="capture_failed", replica=rp.name,
                     error=f"{type(e).__name__}: {e}"[:200])

    def _blame_grew(self, retired: Optional[str]) -> bool:
        """Did the retired journal push a suspect's death count TO the
        quarantine threshold (or past it) — higher than anything seen for
        its stable key (rid, else trace) across prior failovers AND at
        least ``config.quarantine_deaths``? That is the point where the
        adoption-side replay changes behavior (solo at K deaths, typed
        reject past K), so the death is the ladder CONVERGING, not a crash
        loop. Growth below the threshold does NOT qualify: every mid-
        dispatch kill blames its in-flight batch once, and charging
        nothing for first deaths would let an environmental crasher under
        load respawn for free forever. Counts are bounded per request
        (past K deaths the replay rejects it terminally), so free
        respawns are finite."""
        k = self.config.quarantine_deaths
        if not retired or k <= 0:
            return False
        try:
            st = durable.scan(retired)
            counts = st.death_counts()
        except (durable.JournalError, OSError):
            return False
        grew = False
        with self._rlock:
            for jid, c in counts.items():
                adm = st.admits.get(jid) or {}
                key = str(adm.get("rid") or adm.get("trace") or jid)
                if c > self._blame_seen.get(key, 0):
                    self._blame_seen[key] = c
                    if c >= k:
                        grew = True
        return grew

    def _on_death(self, name: str, rp: ReplicaProc, cause: str,
                  rc: Optional[int] = None, **detail) -> None:
        t0 = time.perf_counter()
        with self._rlock:
            if self._live.get(name) is not rp or self._stopping:
                return
            del self._live[name]
            self._failover_seq += 1
            seq = self._failover_seq
        charged = _fleet.counts_against_restart_budget(cause)
        retired = rp.retire_journal(seq)
        if charged and self._blame_grew(retired):
            # Poison-implicated death: reclassify through the shared
            # fleet cause vocabulary so the respawn stops charging the
            # restart budget — the journal adoption below quarantines or
            # rejects the suspects, which is what actually ends the loop.
            obs.counter("router.quarantined_deaths")
            detail = {**detail, "underlying_cause": cause}
            cause = "quarantined"
            charged = _fleet.counts_against_restart_budget(cause)
            self._capture(rp, "poison_quarantine", retired, rc=rc, **detail)
        elif charged:
            self._capture(rp, "supervisor_stall" if cause == "stalled"
                          else "supervisor_death", retired, rc=rc, **detail)
        rp.close_log()
        adopter_name = None
        adopt_out: Dict[str, Any] = {}
        moved = 0
        with self._rlock:
            live = dict(self._live)
            if retired:
                self._retired_dirs.append(retired)
        if retired and live:
            # The dead replica's ring successor adopts its journal —
            # terminals imported for dedupe, live admits replayed,
            # expired ones typed. Walk the survivors until one answers,
            # passing over one whose heartbeat is already stale: the
            # watch loop calls its stall next, and an adopt posted to a
            # wedged (or stopped) replica would hold this loop, and with
            # it every other replica's stall check, for the whole adopt
            # timeout.
            order = [self.ring.lookup(name, set(live))]
            order += [n for n in sorted(live) if n not in order]
            for cand in order:
                if live[cand].stale(self.config.stall_after_s) is not None:
                    continue
                try:
                    adopt_out = self._post_adopt(live[cand], retired)
                    adopter_name = cand
                    break
                except (urllib.error.URLError, OSError, ValueError,
                        TimeoutError):
                    continue
            if adopter_name is not None:
                moved = self.alog.failover(name, adopter_name)
        recovery_s = time.perf_counter() - t0
        with self._rlock:
            self.failovers += 1
        obs.counter("router.failovers")
        obs.emit("replica_failover", replica=name, cause=cause, rc=rc,
                 adopter=adopter_name, pins_moved=moved,
                 replayed=adopt_out.get("replayed"),
                 imported=adopt_out.get("imported"),
                 expired=adopt_out.get("expired"),
                 skipped=adopt_out.get("skipped"),
                 poisoned=adopt_out.get("poisoned"),
                 quarantined=adopt_out.get("quarantined"),
                 recovery_s=round(recovery_s, 4), **detail)
        # -- respawn accounting (fleet.exit_cause vocabulary): drains and
        # -- peer-lost respawn free; crashes/kills/stalls spend the budget.
        respawn = False
        with self._rlock:
            if not charged:
                respawn = True
            elif self.restarts_used < self.config.max_restarts:
                self.restarts_used += 1
                respawn = True
            else:
                self.degraded = True
        if not respawn:
            obs.emit("router", event="degraded", replica=name, cause=cause,
                     max_restarts=self.config.max_restarts)
            return
        new_rp = self._spawn(name, strip_faults=True)
        try:
            new_rp.wait_ready(self.config.spawn_timeout_s)
        except (RuntimeError, TimeoutError) as e:  # pragma: no cover
            obs.emit("router", event="respawn_failed", replica=name,
                     error=str(e)[:200])
            return
        with self._rlock:
            if not self._stopping:
                self._live[name] = new_rp
        obs.emit("router", event="restart", replica=name, cause=cause,
                 charged=charged, pid=new_rp.proc.pid)

    def _post_adopt(self, rp: ReplicaProc, retired: str) -> Dict[str, Any]:
        req = urllib.request.Request(
            rp.url + "/v1/adopt",
            data=json.dumps({"dir": retired}).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120.0) as resp:
            return json.loads(resp.read())

    # -- routing -----------------------------------------------------------

    def route(self, rid: Optional[str], affinity: Optional[str],
              ) -> Optional[ReplicaProc]:
        """Pick the replica for a request. A PINNED rid follows its pin
        even while that replica is down (returning None → the front
        answers 503 and the client's jittered retry lands after the
        failover record moves the pin) — remapping early would race the
        adoption and could double-solve. Unpinned keys hash over the
        LIVE ring; first sight of a rid pins it."""
        with self._rlock:
            live = dict(self._live)
        if rid:
            pinned = self.alog.resolve(rid)
            if pinned is not None:
                return live.get(pinned)
        if not live:
            return None
        node = self.ring.lookup(affinity or rid or "?", set(live))
        if node is None:  # pragma: no cover — live is non-empty
            return None
        if rid:
            self.alog.assign(rid, node)
        return live.get(node)

    # -- chaos surface -----------------------------------------------------

    def kill_replica(self, name: str) -> int:
        """SIGKILL a live replica (the campaign's mid-load kill). Returns
        the killed pid. The watch loop notices the death and fails over."""
        with self._rlock:
            rp = self._live[name]
        rp.proc.kill()
        return rp.proc.pid

    def terminate_replica(self, name: str) -> int:
        """SIGTERM a live replica: graceful drain → ``fleet.DRAIN_EXIT``
        → a budget-free respawn."""
        with self._rlock:
            rp = self._live[name]
        rp.proc.send_signal(signal.SIGTERM)
        return rp.proc.pid

    # -- shutdown ----------------------------------------------------------

    def stop(self, drain: bool = True, timeout: float = 60.0,
             ) -> Dict[str, Any]:
        with self._rlock:
            self._stopping = True
            procs = dict(self._live)
            self._live.clear()
        self._watch_stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=10)
            self._watch_thread = None
        rcs = {}
        for name, rp in procs.items():
            if rp.proc.poll() is None:
                rp.proc.send_signal(
                    signal.SIGTERM if drain else signal.SIGKILL)
        for name, rp in procs.items():
            try:
                rcs[name] = rp.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:  # pragma: no cover
                rp.proc.kill()
                rcs[name] = rp.proc.wait(timeout=10)
            rp.close_log()
        if self._api is not None:
            self._api.stop()
            self._api = None
        if self.alog is not None:
            self.alog.close()
        out = {"rcs": rcs,
               "causes": {n: _fleet.exit_cause(rc)
                          for n, rc in rcs.items()}}
        obs.emit("router", event="drained" if drain else "killed", **out)
        return out

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def retired_dirs(self) -> List[str]:
        with self._rlock:
            return list(self._retired_dirs)

    def replica_dirs(self) -> List[str]:
        return [os.path.join(self.config.dir, f"r{i}")
                for i in range(self.config.replicas)]


class _FrontHandler(BaseHTTPRequestHandler):
    """Front-tier connection handler: parse just enough of the body to
    route, then proxy the raw bytes to the chosen replica."""

    server_version = "gauss-router/1"
    router: Router = None  # type: ignore[assignment] # set per server

    def log_message(self, fmt, *args):
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
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _unavailable(self, why: str) -> None:
        self._json(503, {"error": why, "retry_after_s": 0.5},
                   headers={"Retry-After": "1"})

    def _proxy(self, rp: ReplicaProc, method: str, path: str,
               raw: Optional[bytes]) -> None:
        req = urllib.request.Request(
            rp.url + path, data=raw, method=method,
            headers={"Content-Type": "application/json"})
        timeout = self.router.config.forward_timeout_s
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                body = resp.read()
                self.send_response(resp.status)
                for key in ("Content-Type", "Retry-After"):
                    if resp.headers.get(key):
                        self.send_header(key, resp.headers[key])
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
        except urllib.error.HTTPError as e:
            body = e.read()
            self.send_response(e.code)
            for key in ("Content-Type", "Retry-After"):
                if e.headers and e.headers.get(key):
                    self.send_header(key, e.headers[key])
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass
        except (urllib.error.URLError, OSError):
            # The replica died under us (mid-failover window): tell the
            # client to retry — its key stays pinned until the failover
            # record moves it to the adopter.
            self._unavailable("replica unavailable (failover in progress)")
        except (BrokenPipeError, ConnectionResetError):  # pragma: no cover
            pass

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        path = urlparse(self.path).path
        try:
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length)
            doc = json.loads(raw)
        except (ValueError, OSError):
            self._json(400, {"error": "unparseable JSON body"})
            return
        if path not in ("/v1/solve", "/v1/upload"):
            self._json(404, {"error": f"unknown endpoint {path!r}"})
            return
        rid = doc.get("request_id")
        affinity = doc.get("matrix_id")
        if path == "/v1/upload" and rid is None:
            # Uploads carry request_id/matrix_id too, so the slabs land
            # on the replica the solve will route to.
            rid = doc.get("upload")
        rp = self.router.route(rid, affinity)
        if rp is None:
            self._unavailable("no live replica for this key yet")
            return
        self._proxy(rp, "POST", path, raw)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        url = urlparse(self.path)
        if url.path == "/healthz":
            self._json(200, {"status": "ok", **self.router.stats()})
            return
        if url.path.startswith("/v1/requests/"):
            rid = url.path[len("/v1/requests/"):]
            rp = self.router.route(rid, None)
            if rp is None:
                self._unavailable("no live replica holds this request yet")
                return
            self._stream_proxy(rp, self.path)
            return
        self._json(404, {"error": f"unknown endpoint {url.path!r}"})

    def _stream_proxy(self, rp: ReplicaProc, path: str) -> None:
        timeout = self.router.config.forward_timeout_s
        try:
            with urllib.request.urlopen(rp.url + path,
                                        timeout=timeout) as resp:
                self.send_response(resp.status)
                self.send_header("Content-Type",
                                 resp.headers.get("Content-Type",
                                                  "application/x-ndjson"))
                self.send_header("Connection", "close")
                self.end_headers()
                for line in resp:
                    self.wfile.write(line)
                    self.wfile.flush()
        except (urllib.error.URLError, OSError):
            self._unavailable("replica unavailable (failover in progress)")
        except (BrokenPipeError, ConnectionResetError):  # pragma: no cover
            pass


class RouterFront:
    """The router's single client-facing endpoint (same bound-handler
    idiom as the replica API)."""

    def __init__(self, router: Router, port: int = 0,
                 host: str = "127.0.0.1"):
        self.router = router
        handler = type("BoundFrontHandler", (_FrontHandler,),
                       {"router": router})
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

    def start(self) -> "RouterFront":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="gauss-router",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

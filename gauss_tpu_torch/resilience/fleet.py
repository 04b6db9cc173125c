"""gauss_tpu_torch.resilience.fleet — supervised multi-worker solves (the
port of ``gauss_tpu/resilience/fleet.py``).

When a WORKER PROCESS dies mid-factorization nothing in a plain solve
detects it, preserves the work, or brings the job back. This module is
the supervisor, three mechanisms deep:

- **Lease-file heartbeats.** Every worker writes a small lease JSON
  (atomic replace) from its group loop and from every coordination-barrier
  poll (:func:`beat`, also called by the distributed engines). The
  supervisor watches process liveness AND lease freshness, so it can tell
  *dead* (process exited), *stalled* (process alive, lease stale) and
  *blocked on a peer* (the worker's own watchdog fired:
  :data:`PEER_LOST_EXIT`) apart.
- **Restart-and-resume.** A replacement worker resumes from the newest
  verified generation of the sharded coordinated checkpoint
  (:mod:`gauss_tpu_torch.resilience.dcheckpoint`), and because every group
  step is deterministic over bit-identical carry, the supervised job
  finishes bit for bit equal to an uninterrupted supervised run.
- **Elastic degrade.** When the restart budget is spent the job is
  re-sharded onto the surviving mesh (world W -> W-1), and at the last
  rung the supervisor itself finishes the factorization in-process from
  the last good generation. The ladder is ``supervised -> restart ->
  shrink -> local_finish``; every rung ends in a solution verified at the
  1e-4 gate or a typed :class:`FleetError`, never a hang and never a
  silent wrong answer.

Entry points: :func:`solve_supervised` and ``python -m
gauss_tpu_torch.resilience.fleet`` (``gauss-torch-fleet``), which also
hosts the internal ``--worker`` mode the supervisor spawns and serves its
heartbeat ages live over ``--live-port`` (:mod:`gauss_tpu_torch.obs.live`,
:mod:`gauss_tpu_torch.obs.export`; read with ``python -m
gauss_tpu_torch.obs.top``). The CLI's summary (``kind: fleet_solve``)
feeds ``obs.regress``.

The exit-cause vocabulary (:func:`exit_cause`,
:func:`counts_against_restart_budget`, :data:`DRAIN_EXIT`) is shared with
the replica router (:mod:`gauss_tpu_torch.serve.router`) and
``durable.supervise``.

Deliberate deviations from the JAX package:

- ``FleetConfig.device`` (default ``"cuda"``) is passed to every worker
  (``--device``) and to the local finish; ``"cpu"`` runs the kernels'
  plain versions. On the card the supervisor builds the kernels
  (``kernels._build.build_all``) before it spawns a worker, so every
  worker and respawn loads the built libraries (under the build dir's
  lock) and restarts warm without a compile cache.
- A worker makes its device ready before its first beat: the operands are
  staged on the card, the kernel libraries loaded and the CUDA context and
  the cuBLAS and cuSOLVER handles created
  (:func:`gauss_tpu_torch.utils.device.ready_cuda`) under the startup
  grace, so the stall threshold times only the factorization. A worker that finds no card without
  ``--device cpu`` exits during startup with :data:`CONFIG_EXIT`, and the
  supervisor raises :class:`FleetError`.
- ``compile_cache_dir`` / ``--compile-cache`` (the JAX package's
  persistent XLA cache) refuse by name
  (:class:`~gauss_tpu_torch.serve.admission.FeatureNotPortedError`, exit
  2) until ``tune/compilecache`` is ported.
- Each worker's lease beats carry its kernel launches (``launches``, the
  process's :data:`gauss_tpu_torch.kernels._build.LAUNCHES` and
  ``route_launches``) and, with its last beat, the checkpoint's shard
  seconds and bytes; :class:`FleetResult` sums the launches over every
  incarnation (``launches``, ``route_launches``, also in the ``fleet``
  ``done`` event, for a caller that holds no result: the server's fleet
  lane) and keeps the workers'
  checkpoint figures (``checkpoint``). Once the result is written, the
  supervisor gives live workers :data:`FINISH_GRACE_S` to exit on their
  own (their last beat written) before it kills them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.resilience import inject as _inject
from gauss_tpu_torch.resilience.inject import KILL_EXIT_CODE

ENV_LEASE = "GAUSS_FLEET_LEASE"

#: a worker's own watchdog fired (peer dead/stalled): the worker is healthy
#: but cannot make progress; its respawn is free (bounded separately).
PEER_LOST_EXIT = 117
#: a child exited from a GRACEFUL drain (SIGTERM -> drain -> this code):
#: an operator-initiated shutdown, not a failure. Supervisors respawn it
#: without charging the bounded restart budget, so a rolling drain cannot
#: look like a crash loop.
DRAIN_EXIT = 116
#: unrecoverable configuration/checkpoint mismatch inside a worker (and a
#: worker that finds no card without ``--device cpu``).
CONFIG_EXIT = 115

RUNGS = ("supervised", "restart", "shrink", "local_finish")

#: seconds the supervisor waits, once the result is written, for live
#: workers to exit on their own (their last beat carries their launches)
#: before it kills them
FINISH_GRACE_S = 10.0

#: death causes whose respawn does not consume the restart budget:
#: peer_lost is a secondary casualty, drained an operator's graceful exit,
#: quarantined a poison-request death whose blame evidence grew (the
#: journal-replay quarantine converges: solo at K deaths, a typed reject
#: past K, so these respawns are finite).
FREE_RESPAWN_CAUSES = ("peer_lost", "drained", "quarantined")


def exit_cause(rc: Optional[int]) -> str:
    """Classify a supervised child's exit code: ``"clean"`` (0),
    ``"killed"`` (the fault injector's ``os._exit``), ``"drained"``
    (:data:`DRAIN_EXIT`), ``"peer_lost"``, ``"config"``, or ``"crashed"``
    (anything else, signal deaths included, where ``rc`` is negative)."""
    if rc == 0:
        return "clean"
    return {KILL_EXIT_CODE: "killed",
            DRAIN_EXIT: "drained",
            PEER_LOST_EXIT: "peer_lost",
            CONFIG_EXIT: "config"}.get(rc, "crashed")


def counts_against_restart_budget(cause: str) -> bool:
    """Does a death with this :func:`exit_cause` consume the bounded
    restart budget? Crashes, injected kills, stall-kills and config
    errors do; drains, peer-lost exits and quarantined deaths do not."""
    return cause not in FREE_RESPAWN_CAUSES and cause != "clean"


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class FleetError(RuntimeError):
    """The supervised job could not produce a verified solution — every
    rung of the elastic ladder failed or the result missed the residual
    gate. The typed terminal error of the fleet path (the chaos invariant:
    verified solution or THIS, never a hang)."""


# -- lease heartbeats ------------------------------------------------------

_BEAT_SEQ = 0


def active() -> bool:
    """Is this process a supervised fleet worker (lease env configured)?
    One environ lookup, consulted (with ``watchdog.enabled()``) once per
    staged distributed solve, so the unsupervised path carries no hook
    plumbing."""
    return bool(os.environ.get(ENV_LEASE))


def lease_path(jobdir, worker: int) -> str:
    return os.path.join(os.fspath(jobdir), "leases", f"w{worker}.json")


def beat(**fields) -> None:
    """Write this process's fleet lease (no-op outside a fleet worker —
    one environ lookup): a JSON document replaced atomically, with the pid,
    a sequence number, the wall time and ``fields``."""
    path = os.environ.get(ENV_LEASE)
    if not path:
        return
    global _BEAT_SEQ
    _BEAT_SEQ += 1
    doc = {"pid": os.getpid(), "beat": _BEAT_SEQ,
           "time_unix": time.time(), **fields}
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def read_lease(path) -> Optional[dict]:
    try:
        with open(os.fspath(path)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# -- configuration / results ----------------------------------------------

@dataclasses.dataclass
class FleetConfig:
    """Tuning knobs for :func:`solve_supervised` (the JAX package's, plus
    ``device``)."""

    workers: int = 2                 # initial world size
    panel: Optional[int] = None      # blocked-factor panel (None -> auto)
    chunk: int = 1                   # panels per group (= per checkpoint)
    refine_iters: int = 2            # host-f64 refinement rounds
    gate: float = 1e-4               # rel-residual verification bar
    stall_after_s: float = 10.0      # stale-lease threshold (alive process)
    startup_grace_s: float = 60.0    # stall allowance before the 1st beat
    poll_s: float = 0.05             # supervisor monitor cadence
    max_restarts: int = 2            # dead-worker respawn budget (global)
    max_peer_respawns: int = 8       # free respawns of PEER_LOST exits
    min_workers: int = 1             # elastic floor before local_finish
    barrier_deadline_s: float = 60.0  # worker-side watchdog (GAUSS_WATCHDOG_S)
    job_timeout_s: float = 600.0     # whole-job bound -> local_finish
    inject: Optional[str] = None     # GAUSS_FAULTS plan for first spawns
    inject_worker: Optional[int] = None  # target worker (None = all)
    keep: bool = False               # keep the job directory
    #: the JAX package's persistent XLA compile cache; not ported (a value
    #: raises FeatureNotPortedError): the kernels are built once before
    #: any worker spawns, and every respawn loads them
    compile_cache_dir: Optional[str] = None
    device: str = "cuda"             # where the workers (and the local
    #                                  finish) factor: "cuda" or "cpu"


@dataclasses.dataclass
class FleetResult:
    """What a supervised solve produced and how hard the fleet worked."""

    x: np.ndarray
    rung: str                  # deepest elastic rung exercised
    rung_index: int            # 0 = clean supervised run
    restarts: int              # budgeted dead-worker respawns
    peer_respawns: int         # free respawns after PEER_LOST exits
    stalls: int                # stale-lease detections (worker killed)
    kills: int                 # dead-worker detections (incl. stalls)
    shrinks: int               # world-size reductions
    world: int                 # final world size (0 = local_finish)
    resume_latency_s: Optional[float]  # worst death->replacement-beat gap
    rel_residual: float
    wall_s: float
    #: kernel launches by key (kernels._build.LAUNCHES), summed over every
    #: worker incarnation's last beat and the local finish
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: the same by route (kernels._build.ROUTE_LAUNCHES keys)
    route_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: per worker incarnation that finished: its checkpoint figures
    #: (shard_write_s, shard_bytes, manifest_hash_s, resumed_from)
    checkpoint: List[dict] = dataclasses.field(default_factory=list)

    @property
    def recovered(self) -> bool:
        return self.rung_index > 0


def _refuse_compile_cache(cache_dir) -> None:
    if cache_dir:
        from gauss_tpu_torch.serve.admission import FeatureNotPortedError

        raise FeatureNotPortedError(
            "compile_cache_dir: the persistent compile cache is not ported "
            "to gauss_tpu_torch yet (ROADMAP queue-1 item 11, "
            "tune/compilecache); workers load the kernels built before "
            "they spawn")


def _launch_counts() -> dict:
    """This process's kernel launches, for a lease beat."""
    from gauss_tpu_torch.kernels import _build

    return {"launches": {k: v for k, v in _build.LAUNCHES.items() if v},
            "route_launches": dict(_build.ROUTE_LAUNCHES)}


# -- worker subprocess management ------------------------------------------

class _Worker:
    def __init__(self, wid: int, proc, log, spawn_t: float):
        self.id = wid
        self.proc = proc
        self.log = log
        self.spawn_t = spawn_t          # monotonic clock
        self.spawn_unix = time.time()   # for lease-mtime freshness checks
        self.reaped = False
        self.harvested = False          # its last beat's launches summed


def _spawn_worker(jobdir: str, cfg: FleetConfig, wid: int, world: int,
                  run_id: str, attempt: int,
                  faults: Optional[str]) -> _Worker:
    env = {k: v for k, v in os.environ.items() if k != _inject.ENV_VAR}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env[ENV_LEASE] = lease_path(jobdir, wid)
    env["GAUSS_OBS_RUN_ID"] = run_id
    env["GAUSS_WATCHDOG_S"] = str(cfg.barrier_deadline_s)
    # Crash-surviving telemetry: every worker appends its obs events to an
    # mmap flight ring under the jobdir, so when the supervisor detects it
    # dead or stalled the final seconds are still on disk to bundle.
    from gauss_tpu_torch.obs import flight as _flight

    env[_flight.ENV_VAR] = os.path.join(jobdir, "flight")
    if faults:
        env[_inject.ENV_VAR] = faults
    cmd = [sys.executable, "-m", "gauss_tpu_torch.resilience.fleet",
           "--worker", "--jobdir", jobdir, "--worker-id", str(wid),
           "--num-workers", str(world), "--chunk", str(cfg.chunk),
           "--refine-iters", str(cfg.refine_iters), "--device", cfg.device]
    if cfg.panel:
        cmd += ["--panel", str(cfg.panel)]
    logdir = os.path.join(jobdir, "logs")
    os.makedirs(logdir, exist_ok=True)
    log = open(os.path.join(logdir, f"w{wid}.{attempt}.log"), "ab")
    proc = subprocess.Popen(cmd, cwd=_REPO, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    return _Worker(wid, proc, log, time.monotonic())


def _reap(w: _Worker) -> None:
    if not w.reaped:
        try:
            w.log.close()
        except OSError:
            pass
        w.reaped = True


def _kill_worker(w: _Worker) -> None:
    if w.proc.poll() is None:
        w.proc.kill()
        try:
            w.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:  # pragma: no cover
            pass
    _reap(w)


def _last_activity(jobdir: str, w: _Worker) -> float:
    """Monotonic-clock timestamp of the worker's most recent sign of life
    (its spawn, or its latest lease write)."""
    try:
        mtime_age = time.time() - os.path.getmtime(lease_path(jobdir, w.id))
    except OSError:
        return w.spawn_t
    return max(w.spawn_t, time.monotonic() - max(0.0, mtime_age))


def _lease_fresh(jobdir: str, w: _Worker) -> bool:
    """Has THIS incarnation beaten yet? (A dead predecessor's lease file
    still exists; only a write after this worker's spawn counts.)"""
    try:
        return os.path.getmtime(lease_path(jobdir, w.id)) >= w.spawn_unix
    except OSError:
        return False


# -- results on disk -------------------------------------------------------

def _result_path(jobdir: str) -> str:
    return os.path.join(jobdir, "result.npz")


def _write_result(jobdir: str, x: np.ndarray) -> None:
    from gauss_tpu_torch.resilience import dcheckpoint

    x = np.asarray(x, np.float64)
    dcheckpoint._atomic_write(
        _result_path(jobdir),
        lambda f: np.savez(f, x=x, digest=np.frombuffer(
            _x_digest(x).encode(), np.uint8)))


def _x_digest(x: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()[:16]


def _read_result(jobdir: str) -> Optional[np.ndarray]:
    path = _result_path(jobdir)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            x = np.array(z["x"])
            digest = bytes(np.array(z["digest"])).decode()
    except Exception:  # noqa: BLE001 — torn write: not ready yet
        return None
    return x if _x_digest(x) == digest else None


def _solve_refined(fac, a64: np.ndarray, b64: np.ndarray,
                   iters: int) -> np.ndarray:
    """Deterministic solve through an existing blocked factor: one f32
    device solve + fixed host-f64 refinement — identical on every rung, so
    the elastic ladder cannot change the bits of a recovered answer."""
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.resilience.checkpoint import _host
    from gauss_tpu_torch.resilience.recover import _refine_host
    from gauss_tpu_torch.utils.device import as_tensor

    x = _host(blocked.lu_solve(fac, as_tensor(b64.astype(np.float32),
                                               fac.m.device)))
    return _refine_host(fac, a64, b64, np.asarray(x, np.float64), iters)


# -- the supervisor --------------------------------------------------------

def solve_supervised(a, b, *, config: Optional[FleetConfig] = None,
                     jobdir=None, **overrides) -> FleetResult:
    """Solve ``a @ x = b`` under fleet supervision; returns a
    :class:`FleetResult` with a 1e-4-verified float64 solution, or raises
    the typed :class:`FleetError`. ``overrides`` patch
    :class:`FleetConfig` fields (``workers=4``, ``inject="..."``,
    ``device="cpu"``, ...).

    The factorization runs in ``config.workers`` spawned worker processes
    over a sharded coordinated checkpoint in ``jobdir`` (a temp directory
    by default, removed on success unless ``keep``); the calling process
    only supervises — and, at the last elastic rung, finishes the job
    itself from the last good checkpoint generation on ``device``.
    """
    cfg = dataclasses.replace(
        config if config is not None else FleetConfig(), **overrides)
    if cfg.workers < 1:
        raise ValueError(f"workers must be >= 1, got {cfg.workers}")
    _refuse_compile_cache(cfg.compile_cache_dir)
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(cfg.device)
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    n = a64.shape[0]
    if a64.shape != (n, n) or b64.shape != (n,):
        raise ValueError(f"expected (n, n) and (n,) operands, got "
                         f"{a64.shape} and {b64.shape}")
    if dev.type == "cuda":
        # Built (or loaded) once here, under the build dir's lock, before
        # any worker spawns: workers and respawns load the libraries.
        from gauss_tpu_torch.kernels import _build

        _build.build_all()
    own_jobdir = jobdir is None
    jobdir = os.fspath(jobdir) if jobdir else tempfile.mkdtemp(
        prefix="gauss_fleet_")
    os.makedirs(jobdir, exist_ok=True)
    np.save(os.path.join(jobdir, "a.npy"), a64)
    np.save(os.path.join(jobdir, "b.npy"), b64)
    t0 = time.monotonic()
    try:
        x, stats = _supervise(cfg, jobdir, a64, b64)
        from gauss_tpu_torch.verify import checks

        rel = checks.residual_norm(a64, x, b64, relative=True)
        wall = time.monotonic() - t0
        if not (np.isfinite(rel) and rel <= cfg.gate):
            obs.emit("fleet", event="verify_failed", rel_residual=float(rel))
            raise FleetError(
                f"supervised solve finished but missed the verification "
                f"gate: relative residual {rel:.3e} > {cfg.gate:.0e} "
                f"(rung {stats['rung']})")
        result = FleetResult(x=x, rel_residual=float(rel),
                             wall_s=round(wall, 4), **stats)
        obs.emit("fleet", event="done", rung=result.rung,
                 restarts=result.restarts, stalls=result.stalls,
                 shrinks=result.shrinks, world=result.world,
                 resume_latency_s=result.resume_latency_s,
                 rel_residual=result.rel_residual, wall_s=result.wall_s,
                 launches=result.launches,
                 route_launches=result.route_launches)
        return result
    finally:
        if own_jobdir and not cfg.keep:
            shutil.rmtree(jobdir, ignore_errors=True)


def _supervise(cfg: FleetConfig, jobdir: str, a64, b64):
    run_id = os.environ.get("GAUSS_OBS_RUN_ID") or obs.new_run_id()
    world = cfg.workers
    restarts = peer_respawns = stalls = kills = shrinks = 0
    rung_index = 0
    resume_latencies: List[float] = []
    pending_detect: Dict[int, float] = {}   # worker id -> detection time
    attempts: Dict[int, int] = {}
    deadline = time.monotonic() + cfg.job_timeout_s
    launches: Dict[str, int] = {}
    route_launches: Dict[str, int] = {}
    ckpt_reports: List[dict] = []

    def faults_for(wid: int) -> Optional[str]:
        # Fault plans model the ENVIRONMENT's one-shot misbehavior: only
        # first spawns inherit them — a replacement re-running the same
        # GAUSS_FAULTS would deterministically re-die forever.
        if cfg.inject and attempts.get(wid, 0) == 0 and (
                cfg.inject_worker is None or cfg.inject_worker == wid):
            return cfg.inject
        return None

    def spawn(wid: int) -> _Worker:
        w = _spawn_worker(jobdir, cfg, wid, world, run_id,
                          attempts.get(wid, 0), faults_for(wid))
        attempts[wid] = attempts.get(wid, 0) + 1
        return w

    def harvest(w: _Worker) -> None:
        # Once per incarnation, when it is gone: its last beat's launches
        # (and, from a worker that finished, its checkpoint figures).
        if w.harvested:
            return
        w.harvested = True
        doc = read_lease(lease_path(jobdir, w.id))
        if not doc or doc.get("pid") != w.proc.pid:
            return
        for src, dst in ((doc.get("launches") or {}, launches),
                         (doc.get("route_launches") or {}, route_launches)):
            for k, v in src.items():
                dst[k] = dst.get(k, 0) + int(v)
        if doc.get("checkpoint"):
            ckpt_reports.append({"worker": w.id, **doc["checkpoint"]})

    def finish(w: _Worker) -> None:
        _kill_worker(w)
        harvest(w)

    flight_dir = os.path.join(jobdir, "flight")

    def capture(cause: str, w: _Worker, **detail) -> None:
        # Freeze the failed worker's flight ring into a post-mortem bundle
        # the moment the failure is detected — before a replacement spawns
        # and telemetry moves on. Best-effort: diagnostics never take the
        # supervised job down.
        try:
            from gauss_tpu_torch.obs import postmortem as _postmortem

            _postmortem.capture_bundle(
                _postmortem.default_bundles_dir(flight_dir), cause,
                flight_dir=flight_dir,
                heartbeat_path=lease_path(jobdir, w.id),
                extra={"worker": w.id, **detail}, log=lambda *a: None)
        except Exception:  # pragma: no cover
            pass

    obs.emit("fleet", event="launch", workers=world, n=int(a64.shape[0]),
             chunk=cfg.chunk, jobdir=os.path.basename(jobdir))
    workers = [spawn(w) for w in range(world)]
    beaten: Dict[int, bool] = {}

    def finish_stats(final_world: int):
        return {"rung": RUNGS[rung_index], "rung_index": rung_index,
                "restarts": restarts, "peer_respawns": peer_respawns,
                "stalls": stalls, "kills": kills, "shrinks": shrinks,
                "world": final_world,
                "resume_latency_s": (round(max(resume_latencies), 4)
                                     if resume_latencies else None),
                "launches": launches, "route_launches": route_launches,
                "checkpoint": ckpt_reports}

    def note_resume(w: _Worker):
        # resume latency: death detection -> the replacement's first beat
        if w.id in pending_detect and _lease_fresh(jobdir, w):
            resume_latencies.append(
                time.monotonic() - pending_detect.pop(w.id))

    try:
        while True:
            x = _read_result(jobdir)
            if x is not None:
                grace = time.monotonic() + FINISH_GRACE_S
                while (time.monotonic() < grace
                       and any(w.proc.poll() is None for w in workers)):
                    time.sleep(cfg.poll_s)
                for w in workers:
                    finish(w)
                return x, finish_stats(world)
            if time.monotonic() > deadline:
                obs.emit("fleet", event="job_timeout",
                         timeout_s=cfg.job_timeout_s)
                break  # -> local_finish

            replace: List[_Worker] = []
            degrade = False
            obs.gauge("fleet.world", world)
            for w in workers:
                rc = w.proc.poll()
                if rc is None:
                    if not beaten.get(w.id) and _lease_fresh(jobdir, w):
                        beaten[w.id] = True
                        note_resume(w)
                    # Heartbeat age as a live gauge per worker: scraped on
                    # /metrics when the live plane is on (--live-port), so
                    # a stalling worker is visible before the threshold
                    # kills it.
                    obs.gauge(f"fleet.w{w.id}.heartbeat_age_s",
                              round(time.monotonic()
                                    - _last_activity(jobdir, w), 3))
                    # Freshness, not existence: a respawned worker still
                    # starting must get the startup grace even though its
                    # dead predecessor's lease file is present.
                    grace = (cfg.stall_after_s if _lease_fresh(jobdir, w)
                             else cfg.startup_grace_s)
                    if time.monotonic() - _last_activity(jobdir, w) > grace:
                        stalls += 1
                        kills += 1
                        stale = round(time.monotonic()
                                      - _last_activity(jobdir, w), 3)
                        obs.counter("fleet.stalls")
                        obs.emit("fleet", event="worker_stalled",
                                 worker=w.id, stale_s=stale)
                        capture("fleet_worker_stalled", w, stale_s=stale)
                        finish(w)
                        pending_detect.setdefault(w.id, time.monotonic())
                        replace.append(w)
                    continue
                _reap(w)
                harvest(w)
                if rc == 0:
                    continue
                cause = exit_cause(rc)
                if counts_against_restart_budget(cause):
                    # A peer_lost exit is a secondary casualty of a death
                    # already bundled, and a drained exit is no failure:
                    # neither gets a bundle.
                    capture("fleet_worker_dead", w, rc=rc, exit_cause=cause)
                if cause == "config":
                    raise FleetError(
                        f"worker {w.id} exited with a configuration/"
                        f"checkpoint mismatch or found no device (exit "
                        f"{rc}); see {jobdir}/logs/")
                kills += counts_against_restart_budget(cause)
                obs.counter("fleet.worker_deaths")
                obs.emit("fleet", event="worker_dead", worker=w.id, rc=rc,
                         cause=cause)
                pending_detect.setdefault(w.id, time.monotonic())
                replace.append(w)

            for w in replace:
                dead_cause = exit_cause(w.proc.returncode)
                if dead_cause == "peer_lost" \
                        and peer_respawns < cfg.max_peer_respawns:
                    peer_respawns += 1
                elif dead_cause == "drained":
                    # Graceful drain: the replacement is free (the stall
                    # path kills with SIGKILL, so a stalled worker still
                    # lands in the bounded branch).
                    pass
                elif restarts < cfg.max_restarts:
                    restarts += 1
                    rung_index = max(rung_index, 1)
                else:
                    degrade = True
                    continue
                beaten[w.id] = False
                nw = spawn(w.id)
                workers[workers.index(w)] = nw
                obs.counter("fleet.restarts")
                obs.emit("fleet", event="restart", worker=w.id,
                         attempt=attempts[w.id], world=world)

            if degrade:
                if world - 1 >= cfg.min_workers:
                    world -= 1
                    shrinks += 1
                    rung_index = max(rung_index, 2)
                    obs.counter("fleet.shrinks")
                    obs.emit("fleet", event="shrink", world=world)
                    for w in workers:
                        finish(w)
                    beaten.clear()
                    workers = [spawn(w) for w in range(world)]
                else:
                    break  # -> local_finish
            time.sleep(cfg.poll_s)
    finally:
        for w in workers:
            finish(w)

    # Last rung: the supervisor finishes the job itself, in-process, from
    # the newest good generation (world-size-independent assembly).
    rung_index = 3
    obs.counter("fleet.local_finish")
    obs.emit("fleet", event="local_finish")
    from gauss_tpu_torch.resilience import dcheckpoint

    before = _launch_counts()
    try:
        fac, st = dcheckpoint.factor_sharded(
            a64.astype(np.float32), os.path.join(jobdir, "ckpt"), 0, 1,
            panel=cfg.panel, chunk=cfg.chunk,
            barrier_deadline_s=cfg.barrier_deadline_s, device=cfg.device)
        x = _solve_refined(fac, a64, b64, cfg.refine_iters)
    except Exception as e:  # noqa: BLE001 — the ladder's true bottom
        raise FleetError(
            f"local_finish rung failed after fleet supervision was "
            f"exhausted: {type(e).__name__}: {e}") from e
    after = _launch_counts()
    for key, dst in (("launches", launches),
                     ("route_launches", route_launches)):
        for k, v in (after.get(key) or {}).items():
            d = v - (before.get(key) or {}).get(k, 0)
            if d:
                dst[k] = dst.get(k, 0) + d
    ckpt_reports.append({"worker": "local_finish",
                         **_checkpoint_figures(st)})
    return x, finish_stats(0)


def _checkpoint_figures(stats: dict) -> dict:
    return {k: stats[k] for k in ("resumed_from", "gens_written",
                                  "shard_write_s", "shard_bytes",
                                  "manifest_hash_s")}


# -- the worker subprocess entry -------------------------------------------

def _ready_device(device: str, a32: np.ndarray):
    """Stage the operand and make the device ready (the kernel libraries,
    ``utils.device.ready_cuda``) before the worker's first beat, so the
    supervisor's startup grace covers them and its stall threshold times
    only the factorization. Raises RuntimeError without a card."""
    import torch

    from gauss_tpu_torch.utils.device import ready_cuda, resolve_device

    dev = resolve_device(device)
    a_dev = torch.as_tensor(a32, device=dev)
    if dev.type == "cuda":
        from gauss_tpu_torch.kernels import _build

        _build.build_all()
        ready_cuda(dev)
    return a_dev


def _worker_main(args) -> int:
    # Flight recorder: when the supervisor handed us a flight dir, every
    # obs event also lands in an mmap ring that survives kill -9 — the
    # crash telemetry the supervisor bundles on worker death or stall.
    from gauss_tpu_torch.obs import flight as _flight

    _flight.install_from_env()
    jobdir = os.fspath(args.jobdir)
    wid, world = args.worker_id, args.num_workers
    a64 = np.load(os.path.join(jobdir, "a.npy"))
    b64 = np.load(os.path.join(jobdir, "b.npy"))
    a32 = a64.astype(np.float32)
    stream = os.path.join(jobdir, "obs", f"fleet.p{wid}.jsonl")
    run_id = os.environ.get("GAUSS_OBS_RUN_ID")

    from gauss_tpu_torch.resilience import dcheckpoint
    from gauss_tpu_torch.resilience.checkpoint import CheckpointMismatchError
    from gauss_tpu_torch.resilience.watchdog import WorkerLostError

    def wbeat(**fields):
        beat(**fields, **_launch_counts())

    with obs.run(metrics_out=stream, run_id=run_id, tool="fleet_worker",
                 worker=wid, world=world):
        try:
            a_dev = _ready_device(args.device, a32)
        except RuntimeError as e:
            print(f"fleet worker {wid}: {e}", file=sys.stderr)
            return CONFIG_EXIT
        wbeat(phase="start")
        try:
            fac, stats = dcheckpoint.factor_sharded(
                a_dev, os.path.join(jobdir, "ckpt"), wid, world,
                panel=args.panel, chunk=args.chunk, beat=wbeat,
                device=args.device)
            ckpt = _checkpoint_figures(stats)
            if wid == 0:
                wbeat(phase="solve", checkpoint=ckpt)
                x = _solve_refined(fac, a64, b64, args.refine_iters)
                _write_result(jobdir, x)
            wbeat(phase="done", resumed_from=stats["resumed_from"],
                  checkpoint=ckpt)
        except WorkerLostError as e:
            obs.emit("fleet", event="peer_lost", worker=wid, site=e.site)
            wbeat(phase="peer_lost")
            return PEER_LOST_EXIT
        except CheckpointMismatchError as e:
            print(f"fleet worker {wid}: {e}", file=sys.stderr)
            return CONFIG_EXIT
    return 0


# -- CLI -------------------------------------------------------------------

def history_records(summary: dict):
    """(metric, value, unit) records a fleet solve contributes to the
    regression history — all slow-side gated: recovery getting WORSE shows
    as a deeper rung, more restarts, or a longer resume."""
    out = []
    ri = summary.get("rung_index")
    if isinstance(ri, int):
        out.append(("fleet:rung_depth", ri + 1, "rung"))
    lat = summary.get("resume_latency_s")
    if isinstance(lat, (int, float)) and lat > 0:
        out.append(("fleet:resume_latency_s", lat, "s"))
    restarts = (summary.get("restarts") or 0) + (summary.get("stalls") or 0)
    if restarts > 0:
        out.append(("fleet:restarts", restarts, "count"))
    wall = summary.get("wall_s")
    if isinstance(wall, (int, float)) and wall > 0:
        out.append(("fleet:s_per_solve", round(wall, 4), "s"))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.resilience.fleet",
        description="Supervised multi-worker solve: lease heartbeats, "
                    "sharded coordinated checkpoints, restart-and-resume, "
                    "elastic degrade. Finishes with a verified solution or "
                    "a typed error — never a hang.")
    p.add_argument("-s", "--size", type=int, default=96,
                   help="generate a seeded diagonally-dominant system of "
                        "this size (default 96)")
    p.add_argument("--seed", type=int, default=258458)
    p.add_argument("--a", dest="a_path", default=None, metavar="A.npy")
    p.add_argument("--b", dest="b_path", default=None, metavar="B.npy")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--panel", type=int, default=None)
    p.add_argument("--chunk", type=int, default=1)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the workers factor (default cuda; cpu runs "
                        "the kernels' plain versions)")
    p.add_argument("--stall-after", type=float, default=10.0,
                   help="seconds of stale lease before a live worker is "
                        "declared stalled and killed (default 10)")
    p.add_argument("--barrier-deadline", type=float, default=60.0,
                   help="worker-side watchdog deadline on coordination "
                        "barriers (default 60)")
    p.add_argument("--max-restarts", type=int, default=2)
    p.add_argument("--min-workers", type=int, default=1)
    p.add_argument("--job-timeout", type=float, default=600.0)
    p.add_argument("--inject", default=None, metavar="PLAN",
                   help="GAUSS_FAULTS plan for first-spawn workers (e.g. "
                        "'fleet.worker.group=kill:skip=1')")
    p.add_argument("--inject-worker", type=int, default=None,
                   help="restrict --inject to this worker id (default all)")
    p.add_argument("--jobdir", default=None)
    p.add_argument("--live-port", type=int, default=None, metavar="PORT",
                   help="embed the live telemetry endpoint on PORT "
                        "(0 = ephemeral): /metrics exposes per-worker "
                        "heartbeat ages, world size, restart/stall/shrink "
                        "counters while the supervised solve runs (read "
                        "with python -m gauss_tpu_torch.obs.top)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="not ported (exit 2): the JAX package's persistent "
                        "compile cache")
    p.add_argument("--keep", action="store_true",
                   help="keep the job directory (checkpoints, logs, leases)")
    p.add_argument("--metrics-out", default=None, metavar="PATH")
    p.add_argument("--summary-json", default=None, metavar="PATH",
                   help="write the regress-ingestable summary "
                        "(kind=fleet_solve)")
    p.add_argument("--history", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="append fleet recovery metrics to the regression "
                        "history (default reports/history_torch.jsonl)")
    p.add_argument("--regress-check", action="store_true")
    # internal worker mode (spawned by the supervisor)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--worker-id", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--num-workers", type=int, default=1,
                   help=argparse.SUPPRESS)
    p.add_argument("--refine-iters", type=int, default=2,
                   help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.worker:
        return _worker_main(args)
    if args.compile_cache:
        print("gauss-fleet: --compile-cache is not ported to "
              "gauss_tpu_torch yet (ROADMAP queue-1 item 11, "
              "tune/compilecache)", file=sys.stderr)
        return 2

    if args.a_path:
        a = np.load(args.a_path)
        b = (np.load(args.b_path) if args.b_path
             else np.ones(a.shape[0]))
    else:
        rng = np.random.default_rng(args.seed)
        n = args.size
        a = rng.standard_normal((n, n))
        a[np.arange(n), np.arange(n)] += float(n)
        b = rng.standard_normal(n)

    cfg = FleetConfig(workers=args.workers, panel=args.panel,
                      chunk=args.chunk, stall_after_s=args.stall_after,
                      barrier_deadline_s=args.barrier_deadline,
                      max_restarts=args.max_restarts,
                      min_workers=args.min_workers,
                      job_timeout_s=args.job_timeout, inject=args.inject,
                      inject_worker=args.inject_worker, keep=args.keep,
                      device=args.device)
    live_server = live_prev = None
    if args.live_port is not None:
        from gauss_tpu_torch.obs import export as _export
        from gauss_tpu_torch.obs import live as _live

        agg = _live.LiveAggregator()
        live_prev = _live.install(agg)
        live_server = _export.LiveServer(agg, port=args.live_port).start()
        print(f"live telemetry: {live_server.url}/metrics "
              f"(watch with: python -m gauss_tpu_torch.obs.top --url "
              f"{live_server.url})", flush=True)

    t0 = time.monotonic()
    error = None
    try:
        with obs.run(metrics_out=args.metrics_out, tool="gauss_fleet",
                     n=int(a.shape[0]), workers=args.workers) as rec:
            run_id = rec.run_id
            try:
                res = solve_supervised(a, b, config=cfg, jobdir=args.jobdir)
            except (FleetError, ValueError, RuntimeError) as e:
                error = e
    finally:
        if live_server is not None:
            live_server.stop()
            from gauss_tpu_torch.obs import live as _live

            _live.uninstall(live_prev)

    if error is not None:
        print(f"gauss-fleet: FAILED (typed): {type(error).__name__}: "
              f"{error}", file=sys.stderr)
        return 2
    print(f"gauss-fleet: n={a.shape[0]} workers={args.workers} -> "
          f"rung={res.rung} restarts={res.restarts} stalls={res.stalls} "
          f"shrinks={res.shrinks} rel_residual={res.rel_residual:.3e} "
          f"({res.wall_s:.2f} s)")
    if res.resume_latency_s is not None:
        print(f"  worst resume latency: {res.resume_latency_s:.3f} s "
              f"(no compile cache: the kernels are built once)")

    summary = {"kind": "fleet_solve", "n": int(a.shape[0]),
               "workers": args.workers, "seed": args.seed,
               "device": args.device,
               "rung": res.rung, "rung_index": res.rung_index,
               "restarts": res.restarts, "peer_respawns": res.peer_respawns,
               "stalls": res.stalls, "kills": res.kills,
               "shrinks": res.shrinks, "world": res.world,
               "resume_latency_s": res.resume_latency_s,
               "rel_residual": res.rel_residual, "verified": True,
               "wall_s": round(time.monotonic() - t0, 3),
               "inject": args.inject, "compile_cache": None,
               "launches": res.launches}
    if args.summary_json:
        parent = os.path.dirname(args.summary_json)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"summary: {args.summary_json}")

    from gauss_tpu_torch.obs import regress

    # Source carries the run id: epochs of a DISCRETE metric (rung_depth=2
    # every green run) must still accumulate as separate history samples.
    return regress.gate(
        regress.campaign_records(history_records(summary),
                                 f"fleet:{run_id}", "fleet",
                                 regress.device_tag(args.device)),
        args.history, args.regress_check)


if __name__ == "__main__":
    sys.exit(main())

"""The exit-cause vocabulary of supervised children (the part of
``gauss_tpu/resilience/fleet.py`` the replica router needs).

A supervisor classifies how a child died through :func:`exit_cause` and
charges its bounded restart budget through
:func:`counts_against_restart_budget`; the replica router
(:mod:`gauss_tpu_torch.serve.router`) and ``durable.supervise`` share the
one vocabulary, so the drain-vs-crash accounting cannot diverge between
them. The codes and causes are the JAX package's.

The worker side of the fleet is here too: the lease heartbeat a
supervised worker writes (:func:`active`, :func:`lease_path`,
:func:`beat`, :func:`read_lease`, :data:`ENV_LEASE`), which every
distributed engine calls before its device step.

Not ported yet: the supervisor itself (``solve_supervised``,
``FleetError`` and the elastic ladder) and ``dcheckpoint`` (ROADMAP
queue-1 item 10). Stdlib only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

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
#: unrecoverable configuration/checkpoint mismatch inside a worker.
CONFIG_EXIT = 115

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

"""The exit-cause vocabulary of supervised children (the part of
``gauss_tpu/resilience/fleet.py`` the replica router needs).

A supervisor classifies how a child died through :func:`exit_cause` and
charges its bounded restart budget through
:func:`counts_against_restart_budget`; the replica router
(:mod:`gauss_tpu_torch.serve.router`) and ``durable.supervise`` share the
one vocabulary, so the drain-vs-crash accounting cannot diverge between
them. The codes and causes are the JAX package's.

Not ported yet: the supervised multi-worker solve itself
(``solve_supervised``, ``FleetError``, the lease heartbeats and the
elastic ladder) waits for the distributed plane (ROADMAP queue-1 item
10). Stdlib only.
"""

from __future__ import annotations

from typing import Optional

from gauss_tpu_torch.resilience.inject import KILL_EXIT_CODE

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

"""Collective watchdog: deadlines around blocking distributed steps (the
port of ``gauss_tpu/resilience/watchdog.py``).

A distributed solve blocks in two places: inside a collective
(a ``torch.distributed`` all_reduce or all_gather, or the stream sync
after one, waiting for a peer) and at the fleet's host-level coordination barriers
(waiting for a peer's checkpoint shard or the coordinator's manifest). When
a peer process is dead or stalled, both waits are INFINITE by default — the
reference MPI engine has exactly this failure mode, and "the job hangs until
an operator notices" is the one outcome a supervised fleet must never allow.

This module turns those infinite waits into a typed
:class:`WorkerLostError` after a configurable deadline:

- :func:`guarded` runs a blocking callable (a distributed solve)
  on a helper thread and bounds the wait. On timeout the caller gets the
  typed error immediately; the stuck collective cannot be cancelled from
  host Python, so the helper thread is left to die with the
  process — the supervisor's restart, not this process, is the actual
  recovery. With no deadline configured the callable runs inline: zero
  threads, zero cost.
- :func:`wait_for` polls a host-side predicate (a shard file appearing, a
  manifest landing) with the same deadline semantics, invoking an optional
  ``on_tick`` each poll so a worker blocked on a PEER keeps writing its own
  heartbeat — being blocked is not being dead, and the supervisor must be
  able to tell the two apart.

The deadline comes from the ``GAUSS_WATCHDOG_S`` environment variable (how
fleet worker subprocesses inherit it), from the :func:`deadline` context
manager, or per call. Every timeout emits an obs ``watchdog`` event before
raising, so the summarizer's fleet section counts detections from the same
stream everything else uses.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Optional

ENV_VAR = "GAUSS_WATCHDOG_S"

#: default poll interval for host-side predicate waits
POLL_S = 0.05


class WorkerLostError(RuntimeError):
    """A peer did not show up within the deadline: the collective (or the
    coordination barrier standing in for one) can never complete from this
    process's point of view. ``site`` names the blocked operation;
    ``deadline_s`` is the bound that expired."""

    def __init__(self, message: str, site: str = "?",
                 deadline_s: Optional[float] = None):
        super().__init__(message)
        self.site = site
        self.deadline_s = deadline_s


# Process-wide configured deadline (None = watchdog off). Set once from the
# environment at import — fleet workers inherit it that way — and scoped by
# the deadline() context manager for in-process use.
_DEADLINE: Optional[float] = None
_lock = threading.Lock()


def _env_deadline() -> Optional[float]:
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


def configured_deadline() -> Optional[float]:
    """The active deadline in seconds, or None when the watchdog is off."""
    return _DEADLINE


def enabled() -> bool:
    return _DEADLINE is not None


@contextlib.contextmanager
def deadline(seconds: Optional[float]):
    """Scope a watchdog deadline (None disables) for the block."""
    global _DEADLINE
    with _lock:
        prev = _DEADLINE
        _DEADLINE = float(seconds) if seconds else None
    try:
        yield
    finally:
        with _lock:
            _DEADLINE = prev


def _emit_timeout(site: str, dl: float, kind: str) -> None:
    try:
        from gauss_tpu_torch import obs

        obs.counter("resilience.watchdog_timeouts")
        obs.emit("watchdog", site=site, deadline_s=dl, kind=kind)
    except Exception:  # pragma: no cover — telemetry must never mask the error
        pass


def guarded(fn: Callable, *, site: str, deadline_s: Optional[float] = None):
    """Run a blocking callable under the watchdog deadline.

    No deadline configured -> ``fn()`` inline (the zero-cost default every
    unsupervised solve takes). With a deadline, ``fn`` runs on a daemon
    thread; if it does not finish in time a :class:`WorkerLostError` is
    raised — the hung collective itself cannot be interrupted from host
    Python, so the thread is abandoned and the caller (a fleet worker)
    exits for the supervisor to restart.
    """
    dl = deadline_s if deadline_s is not None else _DEADLINE
    if dl is None:
        return fn()
    box: dict = {}
    done = threading.Event()

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, name=f"watchdog:{site}", daemon=True)
    t.start()
    if not done.wait(dl):
        _emit_timeout(site, dl, "collective")
        raise WorkerLostError(
            f"collective at {site!r} did not complete within {dl:.3g} s — "
            f"a peer process is dead or stalled", site=site, deadline_s=dl)
    if "error" in box:
        raise box["error"]
    return box.get("value")


def wait_for(predicate: Callable[[], object], *, site: str,
             deadline_s: Optional[float] = None,
             poll_s: float = POLL_S,
             on_tick: Optional[Callable[[], None]] = None):
    """Poll ``predicate`` until it returns a truthy value; that value is
    returned. ``on_tick`` runs every poll (a fleet worker's heartbeat — a
    worker BLOCKED on a peer is alive and must keep saying so). Past the
    deadline a :class:`WorkerLostError` is raised; with no deadline
    configured anywhere the wait is unbounded (plain coordination)."""
    dl = deadline_s if deadline_s is not None else _DEADLINE
    t0 = time.monotonic()
    while True:
        value = predicate()
        if value:
            return value
        if on_tick is not None:
            on_tick()
        if dl is not None and time.monotonic() - t0 > dl:
            _emit_timeout(site, dl, "barrier")
            raise WorkerLostError(
                f"barrier at {site!r} not satisfied within {dl:.3g} s — "
                f"a peer process is dead or stalled", site=site,
                deadline_s=dl)
        time.sleep(poll_s)


def guarded_device(fn: Callable, *, site: str):
    """The distributed engines' hook shape: with the watchdog OFF the
    callable runs inline and stays lazy (no forced device sync — timed
    spans keep their semantics); with a deadline configured the callable
    runs on the helper thread and the current CUDA stream is synchronized
    there before it returns (where the JAX package blocks until its
    program is ready), so a peer hung inside a collective trips the
    deadline."""
    if _DEADLINE is None:
        return fn()

    def run_synced():
        out = fn()
        import sys

        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return out

    return guarded(run_synced, site=site)


# Environment activation: fleet worker subprocesses inherit their collective
# deadline through GAUSS_WATCHDOG_S, installed here at import so every
# guarded call in the process sees it without API plumbing.
_DEADLINE = _env_deadline()

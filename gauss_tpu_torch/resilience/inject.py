"""Seeded, deterministic fault injection behind named hook points.

Port of ``gauss_tpu/resilience/inject.py``, which is stdlib + numpy, so
the plan machinery is a copy: :class:`FaultSpec`, :class:`FaultPlan` with
its JSON and compact ``GAUSS_FAULTS`` forms, the per-site seeded
generators (:func:`_site_key`), the ``fault`` obs event and the
``resilience.faults_injected`` counter. Given the same plan, the same
call sequence and the same values, the same polls fire and the same bytes
corrupt as in the JAX package.

The hook sites the port polls today:

    core.blocked.factor     corrupt the factor operand (the first positional
                            argument of ``lu_factor_blocked``,
                            ``lu_factor_blocked_unrolled`` and
                            ``lu_factor_blocked_chunked``)
    core.gauss.solve        the same corruption kinds — ``gauss_solve``
    serve.cache.compile     raise a simulated build failure —
                            ``gauss_tpu_torch.serve.cache``
    structure.detect        force the router's tag (kind ``mistag``) —
                            ``gauss_tpu_torch.structure.router``

The other sites of the JAX package's catalog (the serve worker, the
journal, dist, checkpoint, out-of-core, fleet and ABFT sites) belong to
modules not ported yet; a plan may name them, and nothing polls them.

The operand of the port is a numpy array or a torch tensor, on the CPU
or on the card. :func:`corrupt_operand` corrupts a copy on the host with
the JAX module's draws and returns it as the caller's type, dtype and
device; it never writes into the caller's array or tensor.

Design rules:

- **Off by default, zero hot-path cost.** No plan installed -> every hook is
  one module-global ``is None`` check. Instrumented modules import this
  module at load (stdlib + numpy only — importing it pulls no torch).
- **Deterministic.** Each spec draws from its own ``np.random.Generator``
  seeded from ``(plan.seed, spec.seed, site)``; given the same plan and the
  same call sequence, the same calls trigger and the same bytes corrupt.
- **Observable.** Every trigger emits an obs ``fault`` event (site, kind,
  per-site trigger index) so the summarizer's resilience section and the
  chaos campaign count injections from the same stream everything else uses.
- **Trace-safe.** Corruption helpers act only on concrete values; a
  tensor without storage (meta or fake tensors under a graph trace) passes
  through untouched.

Activation: ``inject.plan(...)`` as a context manager (tests, the chaos
runner), ``install()``/``uninstall()`` for long-lived processes, or the
``GAUSS_FAULTS`` environment variable — parsed and installed at import time,
which is how a *worker subprocess* (multihost, checkpoint kill tests)
inherits a fault plan it cannot be handed through an API. Accepted forms::

    GAUSS_FAULTS='{"seed": 7, "faults": [{"site": "core.blocked.factor",
                                          "kind": "nan", "p": 1.0,
                                          "max_triggers": 1}]}'
    GAUSS_FAULTS='core.blocked.factor=nan:p=0.5:max=2;serve.worker.dispatch=delay:param=0.05'
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ENV_VAR = "GAUSS_FAULTS"

#: kinds that corrupt an operand array
CORRUPT_KINDS = ("nan", "inf", "bitflip", "near_zero_pivot")
#: kinds with dedicated action helpers; ``mistag`` forces the structure
#: router's routing tag to ``STRUCTURE_KINDS[int(param)]`` (see
#: structure.router.routed_tag) — the lying-classifier fault;
#: ``sdc_bitflip`` flips one bit of one ON-DEVICE array element at an ABFT
#: panel-group site (applied by the owning runner via :func:`poll_sdc`).
#: ``server_kill`` is the serving-process analog of ``kill`` (os._exit at
#: the serve worker's batch-boundary hook — a distinct name so a campaign
#: can aim at the SERVER without also arming worker/fleet kill sites);
#: ``journal_torn_write`` tears the live journal segment mid-record and
#: dies (applied by the journal via :func:`poll_torn_write` — only the
#: journal knows its own record boundaries). The kinds of sites the port
#: does not poll yet stay valid plan entries.
ACTION_KINDS = ("raise", "compile_fail", "delay", "kill", "stall", "mistag",
                "sdc_bitflip", "server_kill", "journal_torn_write")
KINDS = CORRUPT_KINDS + ACTION_KINDS

#: exit status used by kind="kill" — distinctive, so a harness can tell an
#: injected kill from a real crash.
KILL_EXIT_CODE = 113


class SimulatedFaultError(RuntimeError):
    """An injected failure (kind="raise"). RuntimeError on purpose: the
    serve layer's transient-error heuristic must treat it as retryable,
    exactly like the device hiccups it stands in for."""


class SimulatedCompileError(SimulatedFaultError):
    """An injected executable-build failure (kind="compile_fail"), worded
    like the real Mosaic scoped-VMEM exhaustion it simulates."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault: where (site), what (kind), how often, how many times.

    ``p``: per-poll trigger probability (1.0 = every eligible poll).
    ``max_triggers``: stop firing after this many triggers (None = forever);
    the default 1 models a transient fault a retry heals.
    ``skip``: let this many eligible polls pass before the first trigger —
    "fail on the Nth visit" (e.g. kill at the second checkpoint group).
    ``param``: kind-specific knob — delay seconds for ``delay``, corruption
    scale for ``near_zero_pivot`` (default 1e-30).
    ``seed``: per-spec RNG stream offset (so two specs at one site differ).
    """

    site: str
    kind: str
    p: float = 1.0
    max_triggers: Optional[int] = 1
    skip: int = 0
    param: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; options: {KINDS}")
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"fault p must be in [0, 1], got {self.p}")


class FaultPlan:
    """An immutable set of :class:`FaultSpec` plus the campaign seed."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = int(seed)

    def __repr__(self):
        return f"FaultPlan(seed={self.seed}, specs={list(self.specs)!r})"

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse the JSON or compact ``site=kind:k=v:...;...`` forms."""
        text = text.strip()
        if not text:
            raise ValueError("empty fault plan")
        if text.startswith("{"):
            doc = json.loads(text)
            specs = [FaultSpec(**f) for f in doc.get("faults", ())]
            return cls(specs, seed=int(doc.get("seed", 0)))
        specs = []
        for i, token in enumerate(t for t in text.split(";") if t.strip()):
            head, *opts = token.strip().split(":")
            if "=" not in head:
                raise ValueError(f"fault token {token!r} needs site=kind")
            site, kind = head.split("=", 1)
            kw = dict(site=site.strip(), kind=kind.strip(), seed=i)
            names = {"p": "p", "max": "max_triggers", "skip": "skip",
                     "param": "param", "seed": "seed"}
            for opt in opts:
                if "=" not in opt:
                    raise ValueError(f"bad fault option {opt!r} in {token!r}")
                k, v = opt.split("=", 1)
                if k not in names:
                    raise ValueError(f"unknown fault option {k!r} in {token!r}")
                key = names[k]
                kw[key] = (int(v) if key in ("max_triggers", "skip", "seed")
                           else float(v))
            specs.append(FaultSpec(**kw))
        return cls(specs)

    @classmethod
    def from_env(cls, environ=os.environ) -> Optional["FaultPlan"]:
        text = environ.get(ENV_VAR)
        return cls.parse(text) if text else None


class ActivePlan:
    """Runtime state of an installed plan: per-spec trigger accounting and
    RNG streams. Thread-safe — the serve worker and client threads poll
    concurrently."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._by_site: Dict[str, List[int]] = {}
        for i, sp in enumerate(plan.specs):
            self._by_site.setdefault(sp.site, []).append(i)
        self._rngs = [np.random.default_rng(
            np.random.SeedSequence((plan.seed, sp.seed, _site_key(sp.site))))
            for sp in plan.specs]
        self.polls: Dict[str, int] = {}           # guarded by: self._lock
        self.triggers: List[int] = [0] * len(plan.specs)  # guarded by: self._lock
        self._skips_left: List[int] = [sp.skip for sp in plan.specs]  # guarded by: self._lock

    def poll(self, site: str) -> Optional[FaultSpec]:
        """One hook-point visit: returns the spec that fires, or None. At
        most one spec fires per poll (first eligible in plan order)."""
        idxs = self._by_site.get(site)
        with self._lock:
            self.polls[site] = self.polls.get(site, 0) + 1
            if not idxs:
                return None
            for i in idxs:
                sp = self.plan.specs[i]
                if (sp.max_triggers is not None
                        and self.triggers[i] >= sp.max_triggers):
                    continue
                if sp.p < 1.0 and self._rngs[i].random() >= sp.p:
                    continue
                if self._skips_left[i] > 0:
                    self._skips_left[i] -= 1
                    continue
                self.triggers[i] += 1
                seq = self.triggers[i]
                break
            else:
                return None
        _emit_fault_event(site, sp.kind, seq)
        return sp

    def rng_for(self, spec: FaultSpec) -> np.random.Generator:
        return self._rngs[self.plan.specs.index(spec)]

    def stats(self) -> Dict[str, object]:
        with self._lock:
            by_site: Dict[str, int] = {}
            by_kind: Dict[str, int] = {}
            for sp, n in zip(self.plan.specs, self.triggers):
                if n:
                    by_site[sp.site] = by_site.get(sp.site, 0) + n
                    by_kind[sp.kind] = by_kind.get(sp.kind, 0) + n
            return {"triggered": sum(self.triggers),
                    "by_site": by_site, "by_kind": by_kind,
                    "polls": dict(self.polls)}


def _site_key(site: str) -> int:
    # Stable across processes (hash() is salted; this must not be).
    return int.from_bytes(site.encode()[:8].ljust(8, b"\0"), "big")


def _emit_fault_event(site: str, kind: str, seq: int) -> None:
    try:
        from gauss_tpu_torch import obs

        obs.counter("resilience.faults_injected")
        obs.emit("fault", site=site, kind=kind, seq=seq)
    except Exception:  # pragma: no cover — telemetry must never mask a test
        pass


# The one module global every hook point checks. Installed plans nest via
# the context manager; GAUSS_FAULTS installs one at import (see bottom).
_ACTIVE: Optional[ActivePlan] = None
_install_lock = threading.Lock()


def enabled() -> bool:
    """True when a fault plan is installed (the zero-cost hook guard)."""
    return _ACTIVE is not None


def active() -> Optional[ActivePlan]:
    return _ACTIVE


def install(p: FaultPlan) -> ActivePlan:
    global _ACTIVE
    with _install_lock:
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already installed; uninstall "
                               "it first (plans do not stack)")
        _ACTIVE = ActivePlan(p)
        return _ACTIVE


def uninstall() -> None:
    global _ACTIVE
    with _install_lock:
        _ACTIVE = None


@contextlib.contextmanager
def plan(p: FaultPlan):
    """Install ``p`` for the duration of the block; yields the ActivePlan
    (its ``stats()`` are how a campaign counts what actually fired)."""
    ap = install(p)
    try:
        yield ap
    finally:
        uninstall()


def poll(site: str) -> Optional[FaultSpec]:
    """Module-level hook: poll the installed plan (None when off)."""
    ap = _ACTIVE
    return ap.poll(site) if ap is not None else None


def _is_torch(a) -> bool:
    return type(a).__module__.split(".")[0] == "torch"


def _is_concrete(a) -> bool:
    """A value with data: anything but a meta or fake tensor (a graph
    trace's), whose corruption would be meaningless."""
    if not _is_torch(a):
        return True
    from torch._subclasses.fake_tensor import FakeTensor

    return not isinstance(a, FakeTensor) and a.device.type != "meta"


def _host_copy(a, raw: bool):
    """A numpy copy of ``a`` on which the JAX module's corruption code runs
    unchanged, and a function that turns it back into ``a``'s type, dtype
    and device. numpy has no bfloat16: a bfloat16 tensor travels as its
    16-bit words when ``raw`` (a bit flip), else as float32 values rounded
    back to nearest even, which is what the JAX module's bfloat16 arrays
    (``ml_dtypes``) compute for the other kinds."""
    if not _is_torch(a):
        return np.array(a, copy=True), lambda arr: arr
    import torch

    t = a.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy(), lambda x: torch.from_numpy(x).to(a.device)

    def from_words(w):
        return torch.from_numpy(w.view(np.int16)).view(torch.bfloat16).to(
            a.device)

    if raw:
        return t.view(torch.int16).numpy().view(np.uint16).copy(), from_words
    return t.float().numpy(), lambda x: from_words(_bf16_words(x))


def _bf16_words(x: np.ndarray) -> np.ndarray:
    """float32 values as bfloat16 words, rounded to nearest even, NaN as
    0x7FC0 (``ml_dtypes``' rounding and NaN)."""
    u = x.view(np.uint32).astype(np.uint64)
    w = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(np.isnan(x), np.uint16(0x7FC0), w)


def corrupt_operand(site: str, a, panel: int = 128):
    """Poll ``site`` and, on trigger, return a corrupted COPY of ``a``
    (else ``a`` unchanged), as ``a``'s type, dtype and device. The
    corruption kinds model device-memory faults at panel granularity:

    - ``nan`` / ``inf``: poison one panel-sized column block (the shape a
      corrupted factor panel would have).
    - ``bitflip``: flip one random bit of one element's mantissa/exponent.
    - ``near_zero_pivot``: scale one column's on-and-below-diagonal entries
      by ``param`` (default 1e-30), so that step's pivot contest can only
      find a vanishing pivot.

    Values without data and operands that are not matrices are passed
    through untouched even when the spec fires (the trigger still counts —
    the fault "happened", the program just wasn't at a corruptible
    boundary).
    """
    ap = _ACTIVE
    if ap is None:
        return a
    if not _is_concrete(a):
        return a
    sp = ap.poll(site)
    if sp is None or sp.kind not in CORRUPT_KINDS:
        return a
    arr, back = _host_copy(a, raw=sp.kind == "bitflip")
    if arr.ndim < 2 or arr.shape[0] < 1:
        return a
    n = arr.shape[0]
    rng = ap.rng_for(sp)
    if sp.kind in ("nan", "inf"):
        w = min(n, panel)
        c0 = int(rng.integers(0, max(1, arr.shape[1] - w + 1)))
        arr[:, c0:c0 + w] = np.nan if sp.kind == "nan" else np.inf
    elif sp.kind == "bitflip":
        i = int(rng.integers(0, n))
        j = int(rng.integers(0, arr.shape[1]))
        itemsize = arr.dtype.itemsize
        uint = {2: np.uint16, 4: np.uint32, 8: np.uint64}[itemsize]
        bits = np.asarray(arr[i, j]).view(uint)
        bit = int(rng.integers(0, 8 * itemsize))
        arr[i, j] = (bits ^ uint(1 << bit)).view(arr.dtype)
    elif sp.kind == "near_zero_pivot":
        j = int(rng.integers(0, min(n, arr.shape[1])))
        scale = sp.param if sp.param else 1e-30
        arr[j:, j] = arr[j:, j] * scale
    return back(arr)


def maybe_raise(site: str) -> None:
    """Poll ``site``; kinds ``raise``/``compile_fail`` raise their simulated
    error (other kinds at this site are ignored — wrong hook shape)."""
    sp = poll(site)
    if sp is None:
        return
    if sp.kind == "compile_fail":
        raise SimulatedCompileError(
            f"RESOURCE_EXHAUSTED: ran out of memory in memory space vmem "
            f"(simulated scoped-VMEM compile failure injected at {site})")
    if sp.kind == "raise":
        raise SimulatedFaultError(f"injected fault at {site}")


def poll_sdc(site: str):
    """Poll ``site`` for an on-device silent-data-corruption fault (kind
    ``sdc_bitflip``). Returns ``(spec, rng)`` when one fires — the caller
    owns the device array and applies the flip itself — else None. Other
    kinds at the site are ignored (wrong hook shape), matching the other
    ``maybe_*`` helpers; the trigger still counts and emits its ``fault``
    event either way."""
    ap = _ACTIVE
    if ap is None:
        return None
    sp = ap.poll(site)
    if sp is None or sp.kind != "sdc_bitflip":
        return None
    return sp, ap.rng_for(sp)


def poll_torn_write(site: str):
    """Poll ``site`` for a torn journal write (kind ``journal_torn_write``).
    Returns the spec when one fires — the JOURNAL applies the tear itself
    (write a prefix of the record, then die: only it knows its record
    boundaries) — else None. Other kinds at the site are ignored (wrong
    hook shape); the trigger still counts and emits its ``fault`` event."""
    ap = _ACTIVE
    if ap is None:
        return None
    sp = ap.poll(site)
    if sp is None or sp.kind != "journal_torn_write":
        return None
    return sp


def maybe_delay(site: str) -> float:
    """Poll ``site``; kind ``delay`` sleeps ``param`` seconds (straggler /
    deadline-pressure injection). Returns the seconds slept."""
    sp = poll(site)
    if sp is not None and sp.kind == "delay" and sp.param > 0:
        time.sleep(sp.param)
        return sp.param
    return 0.0


def maybe_kill(site: str) -> None:
    """Poll ``site``; kind ``kill`` terminates the process immediately via
    ``os._exit`` (no cleanup, no atexit — the honest SIGKILL stand-in);
    kind ``stall`` sleeps FOREVER (the hung-not-dead worker: the process
    stays alive, its heartbeat goes stale, and only an external kill — the
    fleet supervisor's — ends it), distinct from ``kill`` so watchdog/
    stall-detection paths are testable separately from crash paths; kind
    ``raise`` throws SimulatedFaultError instead (the in-process variant
    tests use where a real exit would take the test runner down)."""
    sp = poll(site)
    if sp is None:
        return
    if sp.kind in ("kill", "server_kill"):
        os._exit(KILL_EXIT_CODE)
    if sp.kind == "stall":
        while True:  # pragma: no cover — only ends by external kill
            time.sleep(3600.0)
    if sp.kind == "raise":
        raise SimulatedFaultError(f"injected worker kill at {site}")


# Environment activation: a worker subprocess (multihost rank, checkpoint
# kill test) inherits its fault plan through GAUSS_FAULTS — installed here
# at import so every hook in the process sees it without any API call.
_env_plan = FaultPlan.from_env()
if _env_plan is not None and _env_plan.specs:
    install(_env_plan)
del _env_plan

"""solve_resilient: health-gated solves with an explicit escalation ladder.

Port of ``gauss_tpu/resilience/recover.py``. Every candidate solution is
gated on the health monitors (finite solution, non-zero min pivot, the
1e-4 relative residual of :func:`gauss_tpu_torch.verify.checks
.residual_norm`), and a failed gate escalates along an explicit ladder
instead of returning a wrong answer:

    rung 0  primary engine        blocked f32 factor + host-f64 refinement
                                  (``core.blocked.solve_refined``), or the
                                  rank-1 oracle (``core.gauss``); with
                                  ``abft=True`` the checksum-carrying form
                                  (``resilience.abft``) is prepended: a
                                  transient mid-solve corruption is
                                  detected and replayed inside the rung
                                  (``abft_replay`` recovery events), and
                                  only persistent corruption (typed
                                  ``SDCUnrecoverableError``) escalates
    rung 1  pivot_safe            re-factor with ``zero_pivot_safe`` + the
                                  same refinement
    rung 2  ds_refine             double-single on-device refinement
                                  (``core.dsfloat.solve_ds``)
    rung 3  alternate engine      the other engine (blocked <-> rank1)
    rung 4  numpy_f64             host LAPACK in float64

The ``outofcore`` rung streams a system past the card's memory from the
host (:mod:`gauss_tpu_torch.outofcore`); the service's out-of-core
handoff lane runs the ladder ``("outofcore", "numpy_f64")``.

:func:`structured_rungs` puts a structure tag's engine ahead of the
general-LU chain (``cholesky``, ``banded``, ``blockdiag``, the Krylov
rungs ``cg``/``gmres``/``bicgstab``, or the ``lowered`` head on the dense
lane). Each escalation emits an obs ``recovery`` event and counts
``resilience.escalations``; a recovery counts ``resilience.recovered``,
an exhausted ladder ``resilience.unrecoverable`` and a typed
:class:`UnrecoverableSolveError` (:class:`SingularSystemError` at once
when host LAPACK finds the system singular).

``device`` (default ``cuda``) is where every rung but ``numpy_f64`` runs.

Deliberate deviations from the JAX package:

- **Unported rungs are refused before the ladder runs.** A ladder that
  names a rung with no engine in the port (:data:`UNPORTED_RUNGS`, empty
  since the ``outofcore`` rung came) raises :class:`RungNotPortedError`
  when it is built; such a rung is never tried and escalated past.
- **Kernel failures are not hidden.** The JAX ladder escalates past any
  exception of a rung. The port re-raises
  :class:`~gauss_tpu_torch.kernels._build.KernelBuildError` and
  :class:`~gauss_tpu_torch.kernels._build.KernelLaunchError`, and torch's
  CUDA error that a kernel faulting while it runs raises at the next sync
  (:func:`~gauss_tpu_torch.kernels._build.is_kernel_fault`): a kernel that
  does not build, launch or run is a fault of the program, and escalating
  would quietly serve the answer from a rung that runs no kernel (the CUDA
  error is sticky, so every card rung after it fails the same way). This
  holds inside the ``abft``/``abft_chol`` rungs too: a kernel fault is not
  a checksum mismatch and is not replayed. Every other exception
  escalates as in the JAX package; an ``SDCUnrecoverableError`` escalates
  to the next rung, and the failed rung's ABFT report stays on the result
  (``ResilientResult.sdc``).

An SDC error escalating past its rung means repair failed: the ladder
then fires the ``sdc_detected`` post-mortem trigger
(:func:`gauss_tpu_torch.obs.postmortem.trigger`, a no-op unless a serving
process with a ``flight_dir`` armed it), as the JAX ladder does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.verify import checks

#: relative-residual acceptance bar (the reference EPSILON, BASELINE.json)
DEFAULT_GATE = 1e-4

ENGINES = ("blocked", "rank1")

#: Rungs of the JAX package that have no engine in the port yet, and the
#: ROADMAP queue-1 item that brings each: none since ``outofcore``.
UNPORTED_RUNGS: Dict[str, str] = {}


class RungNotPortedError(NotImplementedError):
    """A ladder names a rung whose engine is not ported yet; raised when the
    ladder is built, before any rung runs. ``rungs`` names them."""

    def __init__(self, rungs: Sequence[str]):
        self.rungs = tuple(rungs)
        items = "; ".join(f"{r}: {UNPORTED_RUNGS[r]}" for r in self.rungs)
        super().__init__(
            f"recovery rung(s) {list(self.rungs)} are not ported to "
            f"gauss_tpu_torch yet ({items}); drop them from the ladder")


def _refuse_unported(ladder: Sequence[str]) -> Tuple[str, ...]:
    ladder = tuple(ladder)
    bad = [r for r in ladder if r in UNPORTED_RUNGS]
    if bad:
        raise RungNotPortedError(bad)
    return ladder


def default_rungs(engine: str = "blocked",
                  abft: bool = False) -> Tuple[str, ...]:
    """The ladder's rung names in escalation order for a primary engine.
    ``abft=True`` prepends the checksum-carrying rung (in-rung detect,
    localize, replay; see :mod:`gauss_tpu_torch.resilience.abft`): replay
    failure escalates through exactly the ladder below it."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; options: {ENGINES}")
    alternate = "rank1" if engine == "blocked" else "blocked"
    base = (engine, "pivot_safe", "ds_refine", alternate, "numpy_f64")
    return ("abft",) + base if abft else base


class UnrecoverableSolveError(RuntimeError):
    """The ladder is exhausted: every rung failed its gate or raised.

    ``trigger``: the last rung's failure reason; ``attempts``: the
    (rung, trigger) history — what the obs stream also recorded.
    """

    def __init__(self, message: str, trigger: Optional[str] = None,
                 attempts: Optional[List[Tuple[str, str]]] = None):
        super().__init__(message)
        self.trigger = trigger
        self.attempts = list(attempts or ())


class SingularSystemError(UnrecoverableSolveError):
    """The system is exactly singular: host LAPACK (the ``numpy_f64`` rung)
    reports ``LinAlgError``, a verdict about the operands that no other
    rung can overturn, so the ladder re-raises at once."""

    def __init__(self, message: str,
                 attempts: Optional[List[Tuple[str, str]]] = None):
        super().__init__(message, trigger="singular_matrix",
                         attempts=attempts)


@dataclasses.dataclass
class ResilientResult:
    """A gated solve: the solution plus how hard the ladder worked for it."""

    x: np.ndarray
    rung: str                  # the rung that produced the accepted solution
    rung_index: int            # 0 = healthy first try
    attempts: int              # rungs tried (1 = no escalation)
    rel_residual: float
    escalations: List[Tuple[str, str]]  # (rung, trigger) of each failure
    #: the ABFT rungs' detection/replay accounting (None when the ladder
    #: has no ABFT rung, or none of them ran).
    sdc: Optional[dict] = None

    @property
    def recovered(self) -> bool:
        return self.rung_index > 0

    @property
    def sdc_detected(self) -> bool:
        return bool(self.sdc and self.sdc.get("detections"))


def _gate(a64: np.ndarray, b64: np.ndarray, x, factors=None,
          gate: float = DEFAULT_GATE) -> Tuple[bool, str, float]:
    """The health monitors as an accept/reject decision: returns
    ``(ok, trigger, rel_residual)``. Order matters — a NaN solution must
    report ``nonfinite``, not a meaningless residual."""
    x = np.asarray(x, dtype=np.float64)
    if not np.isfinite(x).all():
        return False, "nonfinite_solution", float("inf")
    if factors is not None:
        mp = getattr(factors, "min_abs_pivot", None)
        if mp is not None:
            mp = float(mp)
            if not mp > 0.0:  # 0 (singular) and NaN both fail
                return False, "zero_pivot", float("inf")
    rel = checks.residual_norm(a64, x, b64, relative=True)
    if not rel <= gate:
        return False, "residual", rel
    return True, "", rel


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _refine_host(fac, a64, b64, x, iters: int):
    """Classical host-f64 iterative refinement through existing factors."""
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.utils.device import as_tensor

    x = np.asarray(x, dtype=np.float64)
    for _ in range(iters):
        r = b64 - a64 @ x
        x = x + _host(blocked.lu_solve(fac, as_tensor(r, fac.m.device)))
    return x


def _rung_blocked(a64, b64, panel, iters, device):
    from gauss_tpu_torch.core import blocked

    return blocked.solve_refined(a64, b64, panel=panel, iters=iters,
                                 device=device)


def _rung_lowered(a64, b64, panel, iters, device):
    """Mixed-precision head (``core.lowered``): the tuned (dtype,
    refine_steps) pair with its own dtype demotion inside the rung; a
    typed failure after even float32 missed escalates to the f32 chain."""
    from gauss_tpu_torch.core import lowered

    x, fac, _info = lowered.solve_lowered_auto(a64, b64, panel=panel,
                                               device=device)
    return x, fac


def _rung_pivot_safe(a64, b64, panel, iters, device):
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.utils.device import as_tensor, resolve_device

    dev = resolve_device(device)
    fac = blocked.lu_factor_blocked(as_tensor(a64, dev), panel=panel,
                                    zero_pivot_safe=True, device=dev)
    x = _host(blocked.lu_solve(fac, as_tensor(b64, dev)))
    return _refine_host(fac, a64, b64, x, iters), fac


def _rung_ds(a64, b64, panel, iters, device):
    from gauss_tpu_torch.core import dsfloat

    x, fac = dsfloat.solve_ds(a64, b64, panel=panel, device=device)
    return np.asarray(x, dtype=np.float64), fac


def _rung_rank1(a64, b64, panel, iters, device):
    from gauss_tpu_torch.core import gauss
    from gauss_tpu_torch.utils.device import as_tensor, resolve_device

    dev = resolve_device(device)
    a32 = as_tensor(a64, dev)
    if b64.ndim == 1:
        return _host(gauss.gauss_solve(a32, as_tensor(b64, dev),
                                       device=dev)), None
    # The rank-1 oracle solves one RHS at a time (a recovery rung, not a
    # hot path).
    cols = [_host(gauss.gauss_solve(a32, as_tensor(b64[:, j], dev),
                                    device=dev))
            for j in range(b64.shape[1])]
    return np.stack(cols, axis=1), None


def _rung_numpy(a64, b64, panel, iters, device):
    try:
        return np.linalg.solve(a64, b64), None
    except np.linalg.LinAlgError as e:
        # Host LAPACK is the ground-truth rung: its LinAlgError means the
        # system is exactly singular, which no other rung can overturn.
        raise SingularSystemError(
            f"exactly singular system: host LAPACK reports {e}") from e


def _rung_outofcore(a64, b64, panel, iters, device):
    """Host-streamed rung (:mod:`gauss_tpu_torch.outofcore`): only the
    active panel group and a bounded tile window live on the card, the
    serving layer's giant-request lane. An ABFT detection
    (``SDCDetectedError``) or a refused admission escalates; a kernel
    fault re-raises, as in the other card rungs."""
    from gauss_tpu_torch import outofcore

    return outofcore.solve_outofcore(a64, b64, panel=panel,
                                     iters=max(2, iters),
                                     device=device), None


def _rung_abft(a64, b64, panel, iters, device):
    """Checksum-carrying blocked LU with in-rung detect/localize/replay
    (:mod:`gauss_tpu_torch.resilience.abft`): a transient corruption is
    repaired inside the rung, bit for bit an uninterrupted run; persistent
    corruption raises the typed SDCUnrecoverableError and the ladder
    escalates past it."""
    from gauss_tpu_torch.resilience import abft

    x, fac, _report = abft.solve_lu_abft(a64, b64, panel=panel, iters=iters,
                                         device=device)
    return x, fac


def _rung_abft_chol(a64, b64, panel, iters, device):
    """The SPD sibling: checksum-carrying blocked Cholesky with replay; a
    non-SPD operand raises the typed NotSPDError the plain cholesky rung
    does."""
    from gauss_tpu_torch.resilience import abft

    x, fac, _report = abft.solve_chol_abft(a64, b64, panel=panel,
                                           iters=iters, device=device)
    return x, fac


def _rung_cholesky(a64, b64, panel, iters, device):
    """SPD rung: blocked Cholesky + host-f64 refinement; a non-SPD operand
    raises the typed NotSPDError and the ladder demotes."""
    from gauss_tpu_torch.structure import cholesky

    return cholesky.solve_spd_refined(a64, b64, panel=panel, iters=iters,
                                      device=device)


def _rung_banded(a64, b64, panel, iters, device):
    """Banded rung: O(n*b^2) band solve + refinement; a bandwidth over the
    band limit raises StructureMismatchError and the ladder demotes."""
    from gauss_tpu_torch.structure import banded

    return banded.solve_banded_refined(a64, b64, iters=iters,
                                       device=device), None


def _rung_blockdiag(a64, b64, panel, iters, device):
    """Block-diagonal rung: one batched factor per bucket; an
    unpartitionable matrix raises StructureMismatchError."""
    from gauss_tpu_torch.structure import blockdiag

    return blockdiag.solve_blockdiag(a64, b64, refine_steps=iters,
                                     device=device), None


def _rung_krylov(method: str):
    def rung(a64, b64, panel, iters, device):
        from gauss_tpu_torch.sparse import solve as _sparse

        return _sparse.solve_sparse(a64, b64, method=method,
                                    device=device).x, None

    rung.__name__ = f"_rung_{method}"
    rung.__doc__ = (f"Sparse Krylov rung ({method}); an uncertified "
                    f"operand (cg) or stagnation raises typed and the "
                    f"ladder demotes.")
    return rung


_RUNG_FNS: Dict[str, Callable] = {
    "blocked": _rung_blocked,
    "lowered": _rung_lowered,
    "pivot_safe": _rung_pivot_safe,
    "ds_refine": _rung_ds,
    "rank1": _rung_rank1,
    "numpy_f64": _rung_numpy,
    "cholesky": _rung_cholesky,
    "banded": _rung_banded,
    "blockdiag": _rung_blockdiag,
    "cg": _rung_krylov("cg"),
    "gmres": _rung_krylov("gmres"),
    "bicgstab": _rung_krylov("bicgstab"),
    "abft": _rung_abft,
    "abft_chol": _rung_abft_chol,
    "outofcore": _rung_outofcore,
}

_ABFT_RUNGS = ("abft", "abft_chol")

#: ladder head per structure tag; every structured ladder then demotes to
#: "blocked" (general LU) -> pivot_safe -> ds_refine -> numpy_f64.
_STRUCTURE_HEADS: Dict[str, Tuple[str, ...]] = {
    "spd": ("cholesky",),
    "banded": ("banded",),
    "blockdiag": ("blockdiag",),
    "dense": (),
    "sparse": ("cg", "gmres", "bicgstab"),
}


def structured_rungs(tag: str, abft: bool = False,
                     lowered: bool = False) -> Tuple[str, ...]:
    """The escalation ladder for a structure tag: the structured engine
    first, then the general-LU demotion rungs. ``lowered=True`` (dense
    only) prepends the mixed-precision rung. ``abft=True`` prepends the
    checksum-carrying engine where one exists (``abft_chol`` on spd,
    ``abft`` on dense) and wins over ``lowered``; the other tags' ladders
    are unchanged by it."""
    if tag not in _STRUCTURE_HEADS:
        raise ValueError(f"unknown structure tag {tag!r}; options: "
                         f"{sorted(_STRUCTURE_HEADS)}")
    base = _STRUCTURE_HEADS[tag] + ("blocked", "pivot_safe", "ds_refine",
                                    "numpy_f64")
    if abft and tag == "spd":
        return ("abft_chol",) + base
    if abft and tag == "dense":
        return ("abft",) + base
    if lowered and tag == "dense":
        return ("lowered",) + base
    return base


def solve_resilient(a, b, *, gate: float = DEFAULT_GATE,
                    engine: str = "blocked",
                    rungs: Optional[Sequence[str]] = None,
                    panel: Optional[int] = None,
                    refine_iters: int = 2,
                    abft: bool = False,
                    device=None) -> ResilientResult:
    """Solve ``a @ x = b`` with health gating and ladder escalation.

    Returns a :class:`ResilientResult` (``.x`` float64, plus which rung
    served it). Raises :class:`UnrecoverableSolveError` when every rung
    fails — and at once for non-finite INPUT operands — plain
    ``ValueError`` for malformed requests (shapes, unknown rung names),
    :class:`RungNotPortedError` for a ladder naming an unported rung, and
    re-raises the kernels' build, launch and run errors. ``rungs``
    overrides the ladder. ``abft=True`` prepends the checksum-carrying
    rung (:func:`default_rungs`); ``.sdc`` on the result then carries the
    detection/replay accounting (``.sdc_detected`` is the serving tag).
    ``device``: where the rungs run (default ``cuda``)."""
    from gauss_tpu_torch.kernels._build import is_kernel_fault

    a64 = np.asarray(a, dtype=np.float64)
    b64 = np.asarray(b, dtype=np.float64)
    n = a64.shape[0]
    if a64.shape != (n, n):
        raise ValueError(f"expected square matrix, got {a64.shape}")
    if b64.shape[:1] != (n,) or b64.ndim > 2:
        raise ValueError(f"b must be (n,) or (n, k) with n={n}, "
                         f"got {b64.shape}")
    if not (np.isfinite(a64).all() and np.isfinite(b64).all()):
        # No rung can restore a system that was never well-posed.
        obs.counter("resilience.unrecoverable")
        obs.emit("recovery", trigger="nonfinite_input", rung="input",
                 attempt=0, outcome="unrecoverable")
        raise UnrecoverableSolveError(
            "non-finite entries in the input operands (NaN/Inf); no "
            "recovery rung can restore a system that was never well-posed",
            trigger="nonfinite_input")
    ladder = (tuple(rungs) if rungs is not None
              else default_rungs(engine, abft=abft))
    unknown = [r for r in ladder
               if r not in _RUNG_FNS and r not in UNPORTED_RUNGS]
    if unknown:
        raise ValueError(f"unknown ladder rung(s) {unknown}; options: "
                         f"{sorted(set(_RUNG_FNS) | set(UNPORTED_RUNGS))}")
    _refuse_unported(ladder)
    has_abft = any(r in _ABFT_RUNGS for r in ladder)
    sdc_reports: List[dict] = []

    def collect_sdc(rung: str) -> None:
        """Keep the just-finished ABFT rung's report: a later ABFT rung
        overwrites the module's thread-local, so a failed rung's
        detections must be taken here."""
        if rung not in _ABFT_RUNGS:
            return
        from gauss_tpu_torch.resilience import abft as _abft

        rep = _abft.last_report()
        if rep is not None:
            sdc_reports.append(rep.to_dict())
        _abft.clear_report()

    def sdc_info() -> Optional[dict]:
        if not has_abft or not sdc_reports:
            return None
        if len(sdc_reports) == 1:
            return sdc_reports[0]
        out = dict(sdc_reports[-1])
        out["engine"] = "+".join(r["engine"] for r in sdc_reports)
        for key in ("detections", "replays"):
            out[key] = sum(r[key] for r in sdc_reports)
        out["escalated"] = any(r["escalated"] for r in sdc_reports)
        out["max_err"] = max(r["max_err"] for r in sdc_reports)
        for key in ("detect_groups", "detect_cols", "detect_latency_s"):
            out[key] = [v for r in sdc_reports for v in r[key]]
        return out

    if has_abft:
        from gauss_tpu_torch.resilience import abft as _abft

        _abft.clear_report()

    escalations: List[Tuple[str, str]] = []
    for i, rung in enumerate(ladder):
        try:
            x, fac = _RUNG_FNS[rung](a64, b64, panel, refine_iters, device)
            ok, trigger, rel = _gate(a64, b64, x, factors=fac, gate=gate)
            collect_sdc(rung)
        except SingularSystemError as e:
            collect_sdc(rung)
            escalations.append((rung, "singular_matrix"))
            obs.counter("resilience.unrecoverable")
            obs.emit("recovery", trigger="singular_matrix", rung=rung,
                     rung_index=i, attempt=i + 1, outcome="unrecoverable")
            e.attempts = list(escalations)
            raise
        except Exception as e:  # noqa: BLE001 — a rung failing IS the signal
            if is_kernel_fault(e):
                raise
            ok, trigger, rel = False, f"exception:{type(e).__name__}", None
            collect_sdc(rung)
        if ok:
            if i > 0:
                obs.counter("resilience.recovered")
                obs.emit("recovery", trigger=escalations[-1][1], rung=rung,
                         rung_index=i, attempt=i + 1, outcome="recovered",
                         rel_residual=rel)
            return ResilientResult(x=np.asarray(x, dtype=np.float64),
                                   rung=rung, rung_index=i, attempts=i + 1,
                                   rel_residual=rel,
                                   escalations=escalations,
                                   sdc=sdc_info())
        escalations.append((rung, trigger))
        if "SDC" in trigger:
            # Repair failed: freeze the flight ring into a post-mortem
            # bundle (no-op unless the serving process armed the trigger).
            try:
                from gauss_tpu_torch.obs import postmortem as _postmortem

                _postmortem.trigger("sdc_detected", rung=rung,
                                    escalation=trigger)
            except Exception:  # pragma: no cover — capture is best-effort
                pass
        obs.counter("resilience.escalations")
        obs.emit("recovery", trigger=trigger, rung=rung, rung_index=i,
                 attempt=i + 1, outcome="escalate",
                 **({"rel_residual": rel} if rel is not None
                    and np.isfinite(rel) else {}))

    obs.counter("resilience.unrecoverable")
    obs.emit("recovery", trigger=escalations[-1][1], rung=ladder[-1],
             attempt=len(ladder), outcome="unrecoverable")
    raise UnrecoverableSolveError(
        f"recovery ladder exhausted after {len(ladder)} rung(s) "
        f"({', '.join(f'{r}: {t}' for r, t in escalations)})",
        trigger=escalations[-1][1], attempts=escalations)

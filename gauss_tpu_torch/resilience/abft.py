"""Algorithm-based fault tolerance: checksum-carrying solves that detect,
localize and repair silent data corruption in the middle of a solve.

Port of ``gauss_tpu/resilience/abft.py``. A column-checksum row (Huang &
Abraham, IEEE ToC 1984; blocked form per Du, Bosilca & Dongarra,
PPoPP'12) rides through the factorization as an invariant of every panel
factor and trailing GEMM (the rider of :mod:`gauss_tpu_torch.core
.blocked` and :mod:`gauss_tpu_torch.structure.cholesky`) and is checked
on the device after each panel group:

- :func:`lu_factor_abft` / :func:`cholesky_factor_abft` step the same
  group math as the checkpointed factorization (``blocked._factor_group``
  / ``cholesky._chol_panel_step``), holding the last verified carry on the
  device. On a checksum mismatch the fault is localized to the group (and
  the argmax column), an obs ``sdc`` event and a health gauge fire, and
  the group is replayed from the held carry: the same kernel launches and
  GEMMs over bit-identical inputs, so a repaired run is bit for bit an
  uninterrupted one. Replay exhaustion (persistent corruption) raises the
  typed :class:`SDCUnrecoverableError`, and the recovery ladder
  (:mod:`gauss_tpu_torch.resilience.recover`, rungs ``abft`` /
  ``abft_chol``) escalates to the rest of the ladder.
- A final whole-factor identity (``e^T P A = (e^T L) U``, resp.
  ``e^T A = (e^T L) L^T``) covers the factored region the per-group checks
  stop watching, the last group included.
- :func:`abft_matmul`: column- and row-checksums of ``C = A @ B``; a single
  wrong element is localized to its (row, column) intersection and
  corrected in place, anything wider is recomputed.

Fault injection (:mod:`gauss_tpu_torch.resilience.inject`, kind
``sdc_bitflip`` at sites ``abft.lu.group`` / ``abft.chol.group`` /
``abft.matmul``) flips one bit of one element of the carry on the device
at a group boundary (:func:`flip_bit`: an XOR on an integer view of the
element). ``(i, j, bit)`` are drawn from the plan's generator in the JAX
package's order, so one plan flips the same element in both packages.

The detection threshold is :func:`default_tol` (``core.blocked
.abft_default_tol``): ``scale * max(64 * npad * eps, 1e-6)`` with ``scale
= max |initial column sums|``. NaN mismatches fold to +inf, so NaN
corruption is always detected.

Every entry point runs on ``device`` (default ``cuda``; ``"cpu"`` runs the
kernels' plain versions). A kernel's build, launch or run fault is not a
checksum mismatch: it raises out of the runner and out of the ``abft``
rungs, and is never replayed.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.core.blocked import abft_default_tol as default_tol
from gauss_tpu_torch.resilience import inject as _inject

#: fault-injection hook sites (inject kind ``sdc_bitflip``)
SITE_LU = "abft.lu.group"
SITE_CHOL = "abft.chol.group"
SITE_MATMUL = "abft.matmul"

#: the final whole-factor identity accumulates rounding across all groups;
#: its acceptance band is this many group-check tolerances wide.
FINAL_TOL_FACTOR = 4.0

#: replays per group before the corruption counts as persistent.
DEFAULT_MAX_REPLAYS = 2

class SDCDetectedError(RuntimeError):
    """A checksum mismatch the runner could not (or was not asked to)
    repair in place. Carries the localization: engine, panel group,
    column, and mismatch magnitude."""

    def __init__(self, message: str, engine: str = "", group: int = -1,
                 col: int = -1, magnitude: float = 0.0):
        super().__init__(message)
        self.engine = engine
        self.group = group
        self.col = col
        self.magnitude = magnitude


class SDCUnrecoverableError(SDCDetectedError):
    """Replay exhausted: the same panel group failed its checksum
    ``max_replays + 1`` times — persistent corruption, not a transient
    flip. Typed so the recovery ladder escalates."""


@dataclasses.dataclass
class AbftReport:
    """What the checksum machinery saw during one factorization."""

    engine: str
    groups: int
    tol: float
    detections: int = 0
    replays: int = 0
    escalated: bool = False
    max_err: float = 0.0
    detect_groups: List[int] = dataclasses.field(default_factory=list)
    detect_cols: List[int] = dataclasses.field(default_factory=list)
    detect_latency_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def repaired(self) -> bool:
        return self.detections > 0 and not self.escalated

    def to_dict(self) -> dict:
        return {"engine": self.engine, "groups": self.groups,
                "detections": self.detections, "replays": self.replays,
                "escalated": self.escalated,
                "max_err": float(self.max_err), "tol": float(self.tol),
                "detect_groups": list(self.detect_groups),
                "detect_cols": list(self.detect_cols),
                "detect_latency_s": [round(v, 6)
                                     for v in self.detect_latency_s]}


# The last factorization's report, per thread: how the recovery ladder
# (which only sees a rung's (x, factors)) attaches SDC accounting to its
# result.
_tls = threading.local()


def last_report() -> Optional[AbftReport]:
    return getattr(_tls, "report", None)


def clear_report() -> None:
    _tls.report = None


# -- the corruption primitive ----------------------------------------------

_UINT = {2: "uint16", 4: "uint32", 8: "uint64"}
_INT = {2: "int16", 4: "int32", 8: "int64"}


def flip_bit(m, i: int, j: int, bit: int):
    """Flip bit ``bit`` of element (i, j) of the tensor ``m`` IN PLACE, on
    its device (an XOR on an integer view of the element; no copy of the
    matrix to the host). Returns ``m``."""
    import torch

    size = m.element_size()
    mask = np.array(1 << int(bit), _UINT[size]).view(_INT[size]).item()
    m.view(getattr(torch, _INT[size]))[i, j] ^= mask
    return m


def _flipped_host(v: float, bit: int, np_dtype) -> float:
    """What flipping ``bit`` of ``v`` yields, computed on the host (used to
    pre-qualify an injection as detectable)."""
    uint = np.dtype(_UINT[np.dtype(np_dtype).itemsize])
    u = np.asarray(v, np_dtype).view(uint)
    return float(np.asarray(u ^ uint.type(1 << bit)).view(np_dtype))


def _poll_sdc_corrupt(site: str, m, lo: int, engine: str, group: int,
                      tol: float = 0.0, lower_only: bool = False):
    """Poll ``site``; on an ``sdc_bitflip`` trigger, flip one seeded bit of
    one seeded element of the active region (rows/cols >= ``lo``) of ``m``
    in place. Returns ``(m, fired)``.

    The draw prefers (element, bit) pairs whose flip moves the value by
    more than the detection tolerance (a flip below the float32 checksum's
    rounding is not a detectable fault); ``spec.param`` > 0 pins the bit.
    ``lower_only`` draws i >= j (the Cholesky fault model: the strict
    upper triangle is never read). The draws are the JAX package's, in its
    order; an index past a rectangular ``m``'s edge is clamped to it, as
    JAX clamps the indices of its reads and updates."""
    if not _inject.enabled():
        return m, False
    hit = _inject.poll_sdc(site)
    if hit is None:
        return m, False
    sp, rng = hit
    npad = m.shape[0]
    np_dtype = np.dtype(str(m.dtype).replace("torch.", ""))
    nbits = np_dtype.itemsize * 8
    mant = {2: 10, 4: 23, 8: 52}[np_dtype.itemsize]

    def draw_ij():
        i = lo + int(rng.integers(0, max(1, npad - lo)))
        j = lo + int(rng.integers(0, max(1, npad - lo)))
        return (max(i, j), min(i, j)) if lower_only else (i, j)

    def at(i, j):
        return min(i, m.shape[0] - 1), min(j, m.shape[1] - 1)

    i = j = bit = None
    if sp.param and sp.param > 0:
        i, j = draw_ij()
        bit = int(sp.param) % nbits
    else:
        floor = max(4.0 * tol, 1e-3)
        for _ in range(16):
            i, j = draw_ij()
            v = float(m[at(i, j)])
            for b in rng.permutation(np.arange(mant - 3, nbits)):
                nv = _flipped_host(v, int(b), np_dtype)
                delta = abs(nv - v)
                if not np.isfinite(delta) or delta > floor:
                    bit = int(b)
                    break
            if bit is not None:
                break
        if bit is None:
            bit = nbits - 2  # top exponent bit: always catastrophic
    obs.emit("sdc_inject", site=site, engine=engine, group=group,
             row=i, col=j, bit=bit)
    return flip_bit(m, *at(i, j), bit), True


def _record_detection(report: AbftReport, engine: str, group: int,
                      col: int, err: float, lat: float,
                      action: str) -> None:
    report.detections += 1
    report.max_err = max(report.max_err, err)
    report.detect_groups.append(group)
    report.detect_cols.append(col)
    report.detect_latency_s.append(lat)
    obs.counter("abft.sdc_detected")
    obs.histogram("abft.detect_latency_s", lat)
    obs.gauge("abft.last_sdc_group", float(group))
    obs.emit("sdc", engine=engine, group=group, col=col,
             magnitude=float(err), latency_s=round(lat, 6), action=action)
    obs.emit("health", sdc_detected=1.0, sdc_magnitude=float(err),
             sdc_group=group)


def _emit_repair(report: AbftReport, replays: int, group: int) -> None:
    report.replays += replays
    obs.counter("abft.replays", replays)
    obs.counter("abft.sdc_repaired")
    obs.emit("recovery", trigger="sdc", rung="abft_replay", rung_index=0,
             attempt=replays, outcome="recovered", group=group)


def _escalate(report: AbftReport, engine: str, group: int, col: int,
              err: float) -> SDCUnrecoverableError:
    report.escalated = True
    _tls.report = report
    obs.counter("abft.sdc_escalated")
    obs.emit("recovery", trigger="sdc", rung="abft_replay", rung_index=0,
             attempt=report.replays + 1, outcome="escalate", group=group)
    return SDCUnrecoverableError(
        f"{engine} ABFT: panel group {group} failed its checksum after "
        f"{report.replays} replay(s) (|mismatch| {err:.3e} > tol "
        f"{report.tol:.3e} at column {col}); corruption is persistent — "
        f"escalate to the full recovery ladder", engine=engine,
        group=group, col=col, magnitude=err)


def _errs_tensor(errs, dtype, device):
    import torch

    return torch.as_tensor(np.asarray(errs, np.float64), device=device).to(
        dtype)


# -- checksum-carrying blocked LU (host-stepped groups + replay) -----------

def lu_factor_abft(a, *, panel: Optional[int] = None,
                   chunk: Optional[int] = None, panel_impl: str = "auto",
                   gemm_precision: str = "highest",
                   max_replays: int = DEFAULT_MAX_REPLAYS,
                   tol: Optional[float] = None, device=None):
    """Checksum-carrying chunked blocked LU with detect -> localize ->
    replay. Returns ``(BlockedLU, AbftReport)``; the factor is bit for bit
    :func:`gauss_tpu_torch.core.blocked.lu_factor_blocked_chunked` at the
    same statics with ``abft=True``, or ``abft=False,
    panel_impl="pallas"`` (the rider pins the unfused pair: the panel
    kernel on every panel, torch GEMMs for the updates). A faulted and
    replayed run is bit for bit an uninterrupted one; persistent
    corruption raises :class:`SDCUnrecoverableError`. Each group runs on a
    copy of the held carry, so a replay starts from the same bits."""
    import torch

    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.core.matmul import resolve_precision

    mode = resolve_precision(gemm_precision, allow_split=True)
    a, dev = blocked._check_square(a, panel_impl, device)
    blocked._check_lowered_support(a.dtype, gemm_precision, True)
    panel = blocked._resolve_panel(a.shape[0], panel, a.element_size())
    chunk = blocked.CHUNK_DEFAULT if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    m = blocked._pad_to_panel(a, panel)
    del a
    npad = m.shape[0]
    nb = npad // panel
    ngroups = -(-nb // chunk)
    crow0 = blocked._csum_init(m)
    scale = float(crow0.abs().max())
    tol = default_tol(npad, m.dtype, scale) if tol is None else float(tol)
    report = AbftReport(engine="lu", groups=ngroups, tol=tol)
    _tls.report = report

    carry = (m, torch.arange(npad, device=dev),
             torch.full((), float("inf"), dtype=m.dtype, device=dev), crow0)
    carry_before = carry   # the last group's rollback point
    linv_parts, uinv_parts, errs = [], [], []

    def run_group(gi: int, g0: int, carry):
        """One verified group: the corrupt-hook poll, the step on a copy of
        the carry, the checksum verdict, bounded replay."""
        replays = 0
        while True:
            t0 = time.perf_counter()
            m_in, perm_in, piv_in, crow_in = carry
            m_try, _ = _poll_sdc_corrupt(SITE_LU, m_in.clone(), g0 * panel,
                                         "lu", gi, tol=tol)
            m2, perm2, piv2, linvs, uinvs, crow2, err, col = \
                blocked._factor_group(m_try, perm_in.clone(), piv_in, g0,
                                      panel, chunk, panel_impl, mode,
                                      crow=crow_in)
            err_f = float(err)
            if not err_f > tol:   # NaN already folded to inf
                if replays:
                    _emit_repair(report, replays, gi)
                return (m2, perm2, piv2, crow2), linvs, uinvs, err_f
            del m2, perm2, m_try
            lat = time.perf_counter() - t0
            col_i = int(col)
            _record_detection(report, "lu", gi, col_i, err_f, lat,
                              "replay" if replays < max_replays
                              else "escalate")
            if replays >= max_replays:
                raise _escalate(report, "lu", gi, col_i, err_f)
            replays += 1

    for gi, g0 in enumerate(range(0, nb, chunk)):
        carry_before = carry
        carry, linv_g, uinv_g, err_f = run_group(gi, g0, carry)
        linv_parts.append(linv_g)
        uinv_parts.append(uinv_g)
        errs.append(err_f)

    # The whole-factor identity covers the factored region and the last
    # group. A mismatch that localizes to the last group replays it from
    # the held rollback point; anything earlier is past the carry kept.
    final_tol = tol * FINAL_TOL_FACTOR
    last_gi, last_g0 = ngroups - 1, (ngroups - 1) * chunk
    for attempt in range(max_replays + 1):
        fe, fcol = blocked._csum_final_err_lu(carry[0], crow0)
        fe_f = float(fe)
        if not fe_f > final_tol:
            break
        col_i = int(fcol)
        group_i = min(col_i // (panel * chunk), last_gi)
        _record_detection(report, "lu", group_i, col_i, fe_f, 0.0,
                          "replay" if (group_i == last_gi
                                       and attempt < max_replays)
                          else "escalate")
        if group_i != last_gi or attempt >= max_replays:
            raise _escalate(report, "lu", group_i, col_i, fe_f)
        carry, linv_parts[-1], uinv_parts[-1], errs[-1] = run_group(
            last_gi, last_g0, carry_before)
        _emit_repair(report, 1, last_gi)
    del carry_before

    m, perm, min_piv, _ = carry
    fac = blocked.BlockedLU(
        m=m, perm=perm, min_abs_pivot=min_piv,
        linv=torch.cat(linv_parts), uinv=torch.cat(uinv_parts),
        abft_err=_errs_tensor(errs + [fe_f], m.dtype, dev))
    _tls.report = report
    return fac, report


def solve_lu_abft(a, b, *, panel: Optional[int] = None,
                  chunk: Optional[int] = None, iters: int = 2,
                  max_replays: int = DEFAULT_MAX_REPLAYS,
                  tol: Optional[float] = None, device=None):
    """ABFT-protected LU solve: the float32 checksum-carrying factorization
    (with replay repair) + host-f64 iterative refinement — the contract of
    ``blocked.solve_refined`` with mid-solve SDC detection added. Returns
    ``(x float64, factors, AbftReport)``."""
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.utils.device import as_tensor, resolve_device

    dev = resolve_device(device)
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    fac, report = lu_factor_abft(as_tensor(a64, dev), panel=panel,
                                 chunk=chunk, max_replays=max_replays,
                                 tol=tol, device=dev)

    def solve(r):
        return blocked.lu_solve(fac, as_tensor(r, dev)).cpu().numpy().astype(
            np.float64)

    x = solve(b64)
    for _ in range(iters):
        x = x + solve(b64 - a64 @ x)
    return x, fac, report


# -- checksum-carrying blocked Cholesky (per-panel groups) -----------------

def cholesky_factor_abft(a, *, panel: Optional[int] = None,
                         gemm_precision: str = "highest",
                         max_replays: int = DEFAULT_MAX_REPLAYS,
                         tol: Optional[float] = None, device=None):
    """Checksum-carrying blocked Cholesky with detect -> localize ->
    replay, one group per panel; the SPD sibling of :func:`lu_factor_abft`.
    Returns ``(BlockedCholesky, AbftReport)``, the factor bit for bit
    ``cholesky_factor_blocked`` (the flat form) with or without ``abft``.
    Never raises on non-SPD input — check ``min_diag`` (the solve wrapper
    does) — except where a persistent mismatch comes with a non-positive
    diagonal: the typed :class:`~gauss_tpu_torch.structure.cholesky
    .NotSPDError`."""
    import torch

    from gauss_tpu_torch.core.matmul import resolve_precision
    from gauss_tpu_torch.structure import cholesky

    mode = resolve_precision(gemm_precision)
    m, panel = cholesky._prepare(a, panel, device)
    npad = m.shape[0]
    nb = npad // panel
    crow0 = cholesky._csum_sym_init(m)
    scale = float(crow0.abs().max())
    tol = default_tol(npad, m.dtype, scale) if tol is None else float(tol)
    report = AbftReport(engine="chol", groups=nb, tol=tol)
    _tls.report = report

    carry = (m, torch.full((), float("inf"), dtype=m.dtype,
                           device=m.device), crow0)
    carry_before = carry
    linv_parts, errs = [], []

    def run_group(k: int, carry):
        replays = 0
        kb = k * panel
        while True:
            t0 = time.perf_counter()
            m_in, mind_in, crow_in = carry
            m_try, _ = _poll_sdc_corrupt(SITE_CHOL, m_in.clone(), kb, "chol",
                                         k, tol=tol, lower_only=True)
            m2, mind2, linv, crow2, err = cholesky._chol_panel_step(
                m_try, mind_in, kb, panel, mode, crow=crow_in)
            err_f = float(err)
            if not err_f > tol:
                if replays:
                    _emit_repair(report, replays, k)
                return (m2, mind2, crow2), linv, err_f
            lat = time.perf_counter() - t0
            # The panel index is the localization of a per-panel group.
            _record_detection(report, "chol", k, kb, err_f, lat,
                              "replay" if replays < max_replays
                              else "escalate")
            if replays >= max_replays:
                # A mismatch that persists beside a non-positive diagonal
                # is the not-SPD signature (the NaN-as-0 fold makes an
                # indefinite operand's factor garbage), not SDC.
                mind_f = float(mind_in)
                if not mind_f > 0.0 or not float(mind2) > 0.0:
                    report.escalated = True
                    _tls.report = report
                    raise cholesky.NotSPDError(
                        f"matrix is not positive definite (Cholesky min "
                        f"diagonal <= 0 with a persistent checksum mismatch "
                        f"at panel {k}); route to general LU",
                        min_diag=min(mind_f, float(mind2)))
                raise _escalate(report, "chol", k, kb, err_f)
            replays += 1

    for k in range(nb):
        carry_before = carry
        carry, linv_k, err_f = run_group(k, carry)
        linv_parts.append(linv_k)
        errs.append(err_f)

    final_tol = tol * FINAL_TOL_FACTOR
    for attempt in range(max_replays + 1):
        fe, fcol = cholesky._csum_final_err_chol(carry[0], crow0)
        fe_f = float(fe)
        if not fe_f > final_tol:
            break
        col_i = int(fcol)
        group_i = min(col_i // panel, nb - 1)
        _record_detection(report, "chol", group_i, col_i, fe_f, 0.0,
                          "replay" if (group_i == nb - 1
                                       and attempt < max_replays)
                          else "escalate")
        if group_i != nb - 1 or attempt >= max_replays:
            raise _escalate(report, "chol", group_i, col_i, fe_f)
        carry, linv_parts[-1], errs[-1] = run_group(nb - 1, carry_before)
        _emit_repair(report, 1, nb - 1)
    del carry_before

    m, min_diag, _ = carry
    fac = cholesky.BlockedCholesky(
        m=m, linv=torch.stack(linv_parts), min_diag=min_diag,
        abft_err=_errs_tensor(errs + [fe_f], m.dtype, m.device))
    _tls.report = report
    return fac, report


def solve_chol_abft(a, b, *, panel: Optional[int] = None, iters: int = 2,
                    max_replays: int = DEFAULT_MAX_REPLAYS,
                    tol: Optional[float] = None, device=None):
    """ABFT-protected SPD solve: the checksum-carrying Cholesky (with
    replay repair) + host-f64 refinement — ``cholesky.solve_spd_refined``'s
    contract with mid-solve SDC detection. Returns ``(x float64, factors,
    AbftReport)``; raises :class:`~gauss_tpu_torch.structure.cholesky
    .NotSPDError` on non-SPD input."""
    from gauss_tpu_torch.structure import cholesky
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    fac, report = cholesky_factor_abft(a64, panel=panel,
                                       max_replays=max_replays, tol=tol,
                                       device=dev)
    mind = float(fac.min_diag)
    if not mind > 0.0:
        raise cholesky.NotSPDError(
            f"matrix is not positive definite (Cholesky min diagonal "
            f"{mind:g}); route to general LU", min_diag=mind)

    def solve(r):
        return cholesky.cholesky_solve(fac, r).cpu().numpy().astype(
            np.float64)

    x = solve(b64)
    for _ in range(iters):
        x = x + solve(b64 - a64 @ x)
    return x, fac, report


# -- ABFT matmul: detect + correct single-element GEMM errors --------------

def abft_matmul(a, b, *, precision: str = "highest", correct: bool = True,
                tol: Optional[float] = None, device=None):
    """``C = A @ B`` with full Huang-Abraham checksums: the column-checksum
    row ``(e^T A) B`` and the row-checksum column ``A (B e)`` predict C's
    column and row sums. A single corrupted element is localized to the
    intersection of the one mismatching row and column and corrected in
    place from the column-sum excess; anything wider (or a correction that
    does not verify) is recomputed. Returns ``(c, info)`` with ``info =
    {detections, corrected, recomputed, row, col, magnitude, tol}``.

    The product and the checksum products run through
    :func:`gauss_tpu_torch.core.matmul.gdot` under ``precision``
    ("highest": true float32; "high": the explicit bf16x3 split; the JAX
    package runs them as ``jnp.dot``, outside any Pallas kernel). Hook site
    ``abft.matmul`` corrupts the product between compute and verification.
    ``a``/``b`` are staged as float32 on ``device`` (default ``cuda``)."""
    import torch

    from gauss_tpu_torch.core.blocked import _nan_inf_abs
    from gauss_tpu_torch.core.matmul import gdot, resolve_precision
    from gauss_tpu_torch.utils.device import as_tensor, resolve_device

    mode = resolve_precision(precision, allow_split=True)
    dev = resolve_device(device)
    a = as_tensor(a, dev)
    b = as_tensor(b, dev)

    def chk(c):
        ccol = gdot(a.sum(0, keepdim=True), b, mode)
        crow = gdot(a, b.sum(1, keepdim=True), mode)
        dcol = c.sum(0) - ccol[0]
        drow = c.sum(1) - crow[:, 0]
        return _nan_inf_abs(dcol), _nan_inf_abs(drow), dcol

    c = gdot(a, b, mode)
    c, _ = _poll_sdc_corrupt(SITE_MATMUL, c, 0, "matmul", 0)
    k = a.shape[1]
    if tol is None:
        eps = float(torch.finfo(c.dtype).eps)
        scale = max(1.0, float(a.abs().max()) * float(b.abs().max()) * k)
        tol = scale * max(64.0 * max(a.shape[0], b.shape[1], k) * eps, 1e-6)
    info = {"detections": 0, "corrected": False, "recomputed": False,
            "row": None, "col": None, "magnitude": 0.0, "tol": float(tol)}
    dcol_a, drow_a, dcol = chk(c)
    dcol_h = dcol_a.cpu().numpy()
    drow_h = drow_a.cpu().numpy()
    bad_cols = np.nonzero(dcol_h > tol)[0]
    bad_rows = np.nonzero(drow_h > tol)[0]
    if not len(bad_cols) and not len(bad_rows):
        return c, info
    info["detections"] = 1
    mag = float(max(np.max(dcol_h[bad_cols], initial=0.0),
                    np.max(drow_h[bad_rows], initial=0.0)))
    info["magnitude"] = mag
    obs.counter("abft.sdc_detected")
    if correct and len(bad_cols) == 1 and len(bad_rows) == 1:
        i, j = int(bad_rows[0]), int(bad_cols[0])
        delta = float(dcol[j])
        if np.isfinite(delta):
            c2 = c.clone()
            c2[i, j] -= torch.tensor(delta, dtype=c.dtype, device=dev)
            # Re-verify: a very large corrupted value inflates the column
            # sum's ulp past the true terms, leaving the correction
            # imprecise — then recompute instead.
            d2c, d2r, _ = chk(c2)
            if (float(d2c.max()) <= tol and float(d2r.max()) <= tol):
                info.update(corrected=True, row=i, col=j)
                obs.counter("abft.sdc_corrected")
                obs.emit("sdc", engine="matmul", group=0, col=j, row=i,
                         magnitude=mag, action="correct")
                return c2, info
    c = gdot(a, b, mode)
    info["recomputed"] = True
    obs.counter("abft.replays")
    obs.emit("sdc", engine="matmul", group=0,
             col=int(bad_cols[0]) if len(bad_cols) else -1,
             magnitude=mag, action="recompute")
    return c, info

"""Panel-granular checkpoint/resume for the chunked blocked factorization.

Port of ``gauss_tpu/resilience/checkpoint.py``. A long factorization on
preemptible hardware dies with all its work: :func:`gauss_tpu_torch.core
.blocked.lu_factor_blocked_chunked` is one call. This module runs the
same math group by group — the per-group step is the port's
:func:`gauss_tpu_torch.core.blocked._factor_group`, the one the chunked
form runs — and serializes the outer-loop carry ``(m, perm, min_piv,
linvs, uinvs, next_group)`` to disk every K panels. A killed run resumes
from the last checkpoint and, because every group step is the same
sequence of kernel launches and GEMMs over bit-identical carry inputs,
finishes bit for bit equal to an uninterrupted run.

The file format is the JAX package's, so a checkpoint written by either
package resumes in the other: an ``npz`` holding ``meta`` (sorted JSON as
uint8: ``schema``, ``n``, ``panel``, ``chunk``, ``panel_impl``,
``gemm_precision``, ``dtype``, ``digest`` of the operand, and
``next_group``/``panels_done``), ``m``, ``perm``, ``min_piv``, ``linvs``
and ``uinvs``. The port stores ``perm`` as int64 and reads either width.

Cost: one host round trip per group plus one O(npad^2 * itemsize) copy to
the host and file write per checkpoint interval. The digest of the
operand (on the host) makes resuming against a different matrix — or
different panel/chunk/precision statics — a typed
:class:`CheckpointMismatchError`, never a silently wrong factor.

Hook point ``checkpoint.group`` (:mod:`gauss_tpu_torch.resilience
.inject`) fires before every group: kind ``kill`` is a real ``os._exit``
(subprocess tests), kind ``raise`` the in-process stand-in.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Optional

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.resilience import inject as _inject

SCHEMA = 1


class CheckpointMismatchError(RuntimeError):
    """The checkpoint on disk does not belong to this (operand, statics)
    factorization — or is truncated/corrupt and cannot be trusted at all.
    Either way, resuming from it would risk a silently wrong factor."""


def _digest(a: np.ndarray) -> str:
    """The operand's digest: its shape, dtype and bytes (the JAX
    package's, so the two packages agree on one operand)."""
    h = hashlib.sha256()
    h.update(str((a.shape, str(a.dtype))).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def prev_path(path) -> str:
    """Where :func:`save_state` keeps the PREVIOUS checkpoint generation."""
    return os.fspath(path) + ".prev"


def fsync_dir(parent: str) -> None:
    """fsync a directory so a just-renamed file's entry survives a crash.
    Best-effort — not every filesystem supports it."""
    try:
        fd = os.open(parent, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_state(path, *, meta: dict, m, perm, min_piv, linvs, uinvs) -> int:
    """Durably write one checkpoint; returns bytes written.

    tmp + fsync + rename + parent-dir fsync, and the checkpoint that was at
    ``path`` is kept as ``path.prev`` (one previous generation): a process
    killed at any instant of writing generation K leaves K or K-1 intact.
    Tensors are copied to the host first."""
    path = os.fspath(path)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=parent)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, meta=np.frombuffer(
                json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8),
                m=_host(m), perm=_host(perm), min_piv=_host(min_piv),
                linvs=_host(linvs), uinvs=_host(uinvs))
            f.flush()
            os.fsync(f.fileno())
        nbytes = os.path.getsize(tmp)
        if os.path.exists(path):
            os.replace(path, prev_path(path))
        os.replace(tmp, path)
        fsync_dir(parent)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return nbytes


def load_state(path) -> dict:
    """Load one checkpoint as host arrays plus its ``meta`` dict. A file
    that cannot be parsed end to end raises a typed
    :class:`CheckpointMismatchError`."""
    path = os.fspath(path)
    try:
        with np.load(path) as z:
            out = {k: np.array(z[k])
                   for k in ("m", "perm", "min_piv", "linvs", "uinvs")}
            out["meta"] = json.loads(bytes(z["meta"]).decode())
    except CheckpointMismatchError:
        raise
    except Exception as e:  # noqa: BLE001 — any parse failure means corrupt
        raise CheckpointMismatchError(
            f"checkpoint at {path} is truncated or corrupt "
            f"({type(e).__name__}: {e})") from e
    return out


def _load_resume_state(path, meta: dict):
    """The resumable state for ``meta``: the checkpoint at ``path``, else
    the kept previous generation when the current file is corrupt; None
    when neither exists. A valid checkpoint whose meta differs raises
    :class:`CheckpointMismatchError`; two corrupt generations raise the
    typed corruption."""
    corrupt = None
    for cand in (path, prev_path(path)):
        if not os.path.exists(cand):
            continue
        try:
            state = load_state(cand)
        except CheckpointMismatchError as e:
            corrupt = e
            obs.counter("resilience.checkpoint.corrupt")
            obs.emit("checkpoint", event="corrupt", path=cand,
                     error=str(e)[:200])
            continue
        disk = dict(state["meta"])
        disk.pop("next_group", None)
        disk.pop("panels_done", None)
        if disk != meta or "next_group" not in state["meta"]:
            raise CheckpointMismatchError(
                f"checkpoint at {cand} does not match this factorization: "
                f"checkpoint {disk}, requested {meta}")
        if cand != path:
            obs.emit("checkpoint", event="fallback_prev", path=cand)
        return state
    if corrupt is not None:
        raise corrupt
    return None


def lu_factor_blocked_chunked_checkpointed(
        a, path, *, panel: Optional[int] = None, chunk: Optional[int] = None,
        panel_impl: str = "auto", gemm_precision: str = "highest",
        every_panels: Optional[int] = None, resume: bool = True,
        keep: bool = False, device=None):
    """Chunked blocked LU with a checkpoint file at ``path``.

    The factor of :func:`gauss_tpu_torch.core.blocked
    .lu_factor_blocked_chunked` at the same statics, bit for bit (the same
    ``_factor_group`` steps), stepped on the host so the carry can be
    saved every ``every_panels`` factored panels (default: every group).
    When ``resume`` and ``path`` holds a checkpoint of this exact
    (operand, statics) pair, the factorization continues from its
    ``next_group``; a mismatched checkpoint raises
    :class:`CheckpointMismatchError`. On success the checkpoint files are
    removed unless ``keep``.

    ``path=None`` delegates to ``lu_factor_blocked_chunked`` (no host
    stepping, no hook polls). ``a``: a float32 array or tensor, staged on
    ``device`` (default ``cuda``; ``"cpu"`` runs the kernels' plain
    versions). Returns a :class:`gauss_tpu_torch.core.blocked.BlockedLU`.
    """
    import torch

    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.core.matmul import resolve_precision

    chunk = blocked.CHUNK_DEFAULT if chunk is None else chunk
    if path is None:
        return blocked.lu_factor_blocked_chunked(
            a, panel=panel, chunk=chunk, panel_impl=panel_impl,
            gemm_precision=gemm_precision, device=device)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    mode = resolve_precision(gemm_precision, allow_split=True)
    host = _host(a)
    n = host.shape[0]
    if host.shape != (n, n):
        raise ValueError(f"expected square matrix, got {host.shape}")
    m0, dev = blocked._check_square(a, panel_impl, device)
    panel = blocked._resolve_panel(n, panel, m0.element_size())
    every = chunk if every_panels is None else max(1, int(every_panels))
    path = os.fspath(path)
    meta = {"schema": SCHEMA, "n": n, "panel": panel, "chunk": chunk,
            "panel_impl": panel_impl, "gemm_precision": gemm_precision,
            "dtype": str(host.dtype), "digest": _digest(host)}

    state = _load_resume_state(path, meta) if resume else None
    if state is None:
        m = blocked._pad_to_panel(m0, panel)
        perm = torch.arange(m.shape[0], device=dev)
        min_piv = torch.full((), float("inf"), dtype=m.dtype, device=dev)
        linv_parts, uinv_parts = [], []
        start_group = 0
    else:
        disk = dict(state["meta"])
        m = torch.as_tensor(state["m"], device=dev)
        perm = torch.as_tensor(state["perm"], dtype=torch.int64, device=dev)
        min_piv = torch.as_tensor(state["min_piv"], device=dev)
        linv_parts = ([torch.as_tensor(state["linvs"], device=dev)]
                      if state["linvs"].size else [])
        uinv_parts = ([torch.as_tensor(state["uinvs"], device=dev)]
                      if state["uinvs"].size else [])
        start_group = int(disk["next_group"])
        obs.counter("resilience.checkpoint.resumes")
        obs.emit("checkpoint", event="resume", path=path,
                 next_group=start_group,
                 panels_done=int(disk.get("panels_done", 0)))
    del m0
    nb = m.shape[0] // panel
    unsaved = 0
    for g0 in range(start_group, nb, chunk):
        # A kill here models preemption between groups: everything since
        # the last save is lost, the saved carry is intact.
        _inject.maybe_kill("checkpoint.group")
        m, perm, min_piv, linvs, uinvs = blocked._factor_group(
            m, perm, min_piv, g0, panel, chunk, panel_impl, mode)
        linv_parts.append(linvs)
        uinv_parts.append(uinvs)
        unsaved += min(chunk, nb - g0)
        next_group = g0 + chunk
        if unsaved >= every and next_group < nb:
            nbytes = save_state(
                path, meta={**meta, "next_group": next_group,
                            "panels_done": next_group},
                m=m, perm=perm, min_piv=min_piv,
                linvs=torch.cat(linv_parts), uinvs=torch.cat(uinv_parts))
            unsaved = 0
            obs.counter("resilience.checkpoint.saves")
            obs.emit("checkpoint", event="save", path=path,
                     next_group=next_group, panels_done=int(next_group),
                     bytes=int(nbytes))

    if not keep:
        for stale in (path, prev_path(path)):
            try:
                os.unlink(stale)
            except OSError:
                pass
    obs.emit("checkpoint", event="complete", path=path, groups=-(-nb // chunk))
    return blocked.BlockedLU(m=m, perm=perm, min_abs_pivot=min_piv,
                             linv=torch.cat(linv_parts),
                             uinv=torch.cat(uinv_parts))

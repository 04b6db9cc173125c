"""Sharded coordinated checkpointing for supervised multi-worker solves
(the port of ``gauss_tpu/resilience/dcheckpoint.py``).

:mod:`gauss_tpu_torch.resilience.checkpoint` makes ONE process's chunked
factorization killable: the outer-loop carry of ``blocked._factor_group``
is serialized between groups and a resume is bit for bit an
uninterrupted run. A supervised FLEET (:mod:`gauss_tpu_torch.resilience
.fleet`) needs the distributed form of the same promise:

- **Sharded persistence.** Each worker atomically writes only its own
  checkpoint shard — the panel-block rows it owns under block-cyclic
  assignment (global panel block ``k`` belongs to worker ``k % W``) plus
  its owned diagonal-block inverses; the tiny replicated carry pieces
  (``perm``, ``min_piv``) ride in every shard.
- **Coordinated generations.** A generation is complete only when worker 0
  has observed every shard of it and published ``MANIFEST.json`` naming
  the per-shard SHA-256 digests. The manifest wait doubles as the
  per-group barrier: every worker advances group-lockstep, which is what
  makes a stale heartbeat unambiguous. The wait runs under the collective
  watchdog, so a dead peer surfaces as a typed
  :class:`~gauss_tpu_torch.resilience.watchdog.WorkerLostError`, never a
  hang.
- **Last-good retention.** The two most recent manifested generations are
  kept; a kill at ANY instant leaves a complete older generation to resume
  from. Corrupt or digest-mismatched shards disqualify their generation
  (observed) and the previous one is used; a manifest from a DIFFERENT
  (operand, statics) factorization raises
  :class:`~gauss_tpu_torch.resilience.checkpoint.CheckpointMismatchError`.
- **World-size-independent layout.** Shards name their world in the
  filename (``shard-03-of-08.npz``) and assembly walks global panel
  blocks, so a carry checkpointed by W workers restores onto W' workers:
  the mechanism behind the fleet's elastic degrade.

The shard and manifest formats are the JAX package's, key for key and
meta for meta, so a generation written by either package resumes in the
other. ``perm`` is stored as int64 and either width is read.

Compute per group is the port's :func:`gauss_tpu_torch.core.blocked
._factor_group` (the step the chunked and checkpointed forms run) on
``device`` (default ``cuda``; ``"cpu"`` runs the kernels' plain
versions): every worker derives the identical carry, so kill -> restart
-> resume (even onto a different world size) finishes bit for bit equal
to an uninterrupted supervised run, and to
:func:`~gauss_tpu_torch.core.blocked.lu_factor_blocked_chunked` at the
same statics.

Hook point ``fleet.worker.group`` fires between groups in every worker:
kind ``kill`` is the preempted-VM stand-in, ``stall`` the hung worker the
supervisor must catch, ``raise`` the in-process variant.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.resilience import inject as _inject
from gauss_tpu_torch.resilience import watchdog
from gauss_tpu_torch.resilience.checkpoint import (
    SCHEMA,
    CheckpointMismatchError,
    _digest,
    _host,
    fsync_dir,
)

MANIFEST = "MANIFEST.json"
#: manifested generations kept on disk (current + last-good fallback)
KEEP_GENERATIONS = 2

_GEN_RE = re.compile(r"^gen-(\d+)$")


def owned_blocks(nb: int, worker: int, world: int) -> List[int]:
    """Global panel-block indices worker ``worker`` owns out of ``nb``
    (block-cyclic: block k -> worker k % world)."""
    return [k for k in range(nb) if k % world == worker]


def gen_dir(ckptdir: str, next_group: int) -> str:
    return os.path.join(ckptdir, f"gen-{next_group:05d}")


def shard_name(worker: int, world: int) -> str:
    """World size rides in the NAME so a partially-written generation from
    a differently-sized world (pre-shrink leftovers) can never satisfy the
    new world's barrier or be hashed into its manifest."""
    return f"shard-{worker:02d}-of-{world:02d}.npz"


def _file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:16]


def _atomic_write(path: str, write_fn) -> int:
    """tmp + fsync + rename + parent fsync; returns bytes written."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=parent)
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        nbytes = os.path.getsize(tmp)
        os.replace(tmp, path)
        fsync_dir(parent)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return nbytes


def write_shard(ckptdir: str, next_group: int, worker: int, world: int, *,
                meta: dict, m, perm, min_piv, linvs, uinvs,
                panel: int) -> Tuple[str, int]:
    """Atomically write worker ``worker``'s shard of the generation whose
    carry is about to process group ``next_group``. The shard holds ONLY
    the rows / diagonal-block inverses of the panel blocks this worker owns
    (plus the tiny replicated ``perm``/``min_piv``); arrays or tensors on
    any device. Returns the shard path and the bytes written (the JAX
    package returns the path alone)."""
    nb = m.shape[0] // panel
    blocks = owned_blocks(nb, worker, world)
    # Only the owned rows leave the device (one copy a block).
    rows = (np.concatenate([_host(m[k * panel:(k + 1) * panel])
                            for k in blocks]) if blocks
            else np.empty((0, m.shape[1]), _host(m[:0]).dtype))
    linvs = _host(linvs)
    uinvs = _host(uinvs)
    done = [k for k in blocks if k < linvs.shape[0]]
    path = os.path.join(gen_dir(ckptdir, next_group),
                        shard_name(worker, world))
    payload = {
        "meta": np.frombuffer(json.dumps(
            {**meta, "worker": worker, "world": world,
             "next_group": next_group}, sort_keys=True).encode(), np.uint8),
        "blocks": np.asarray(blocks, np.int64),
        "m_rows": rows,
        "perm": _host(perm).astype(np.int64),
        "min_piv": _host(min_piv),
        "done_blocks": np.asarray(done, np.int64),
        "linvs": linvs[done] if done else np.empty((0,) + linvs.shape[1:],
                                                   linvs.dtype),
        "uinvs": uinvs[done] if done else np.empty((0,) + uinvs.shape[1:],
                                                   uinvs.dtype),
    }
    nbytes = _atomic_write(path, lambda f: np.savez(f, **payload))
    return path, nbytes


def _load_shard(path: str) -> dict:
    try:
        with np.load(path) as z:
            out = {k: np.array(z[k]) for k in
                   ("blocks", "m_rows", "perm", "min_piv", "done_blocks",
                    "linvs", "uinvs")}
            out["meta"] = json.loads(bytes(z["meta"]).decode())
    except Exception as e:  # noqa: BLE001 — any parse failure means corrupt
        raise CheckpointMismatchError(
            f"checkpoint shard at {path} is truncated or corrupt "
            f"({type(e).__name__}: {e})") from e
    return out


def try_publish_manifest(ckptdir: str, next_group: int, world: int,
                         meta: dict) -> bool:
    """Coordinator step (worker 0): if every shard of this generation is
    present, hash them and atomically publish MANIFEST.json. Returns True
    once the manifest exists (already-published counts). The generation is
    resumable if and only if this file exists and its digests verify."""
    gdir = gen_dir(ckptdir, next_group)
    if os.path.exists(os.path.join(gdir, MANIFEST)):
        return True
    names = [shard_name(w, world) for w in range(world)]
    if not all(os.path.exists(os.path.join(gdir, nm)) for nm in names):
        return False
    doc = {"schema": SCHEMA, "meta": meta, "next_group": next_group,
           "world": world,
           "shards": {nm: _file_digest(os.path.join(gdir, nm))
                      for nm in names}}
    _atomic_write(os.path.join(gdir, MANIFEST),
                  lambda f: f.write(json.dumps(doc, sort_keys=True,
                                               indent=1).encode()))
    return True


def _generations(ckptdir: str) -> List[int]:
    if not os.path.isdir(ckptdir):
        return []
    gens = []
    for name in os.listdir(ckptdir):
        mm = _GEN_RE.match(name)
        if mm:
            gens.append(int(mm.group(1)))
    return sorted(gens)


def gc_generations(ckptdir: str, keep: int = KEEP_GENERATIONS) -> None:
    """Drop everything older than the ``keep`` newest manifested
    generations (unmanifested partials below them included). Best-effort —
    a racing reader that loses its generation falls back via last_good."""
    manifested = [g for g in _generations(ckptdir)
                  if os.path.exists(os.path.join(gen_dir(ckptdir, g),
                                                 MANIFEST))]
    if len(manifested) <= keep:
        return
    floor = manifested[-keep]
    for g in _generations(ckptdir):
        if g < floor:
            shutil.rmtree(gen_dir(ckptdir, g), ignore_errors=True)


def last_good(ckptdir: str, meta: dict) -> Optional[Tuple[int, dict]]:
    """Newest generation whose manifest verifies end to end: manifest
    parses, meta matches, every named shard exists with the recorded
    digest. Digest/corruption failures disqualify the generation (observed,
    typed internally) and the scan continues downward; a VALID manifest for
    a different (operand, statics) factorization raises — that is operator
    error, not a torn write. Returns ``(next_group, manifest)`` or None."""
    for g in reversed(_generations(ckptdir)):
        mpath = os.path.join(gen_dir(ckptdir, g), MANIFEST)
        if not os.path.exists(mpath):
            continue
        try:
            doc = json.loads(open(mpath).read())
            shards = doc["shards"]
        except Exception:  # noqa: BLE001 — torn manifest: not last-good
            obs.emit("checkpoint", event="corrupt", path=mpath)
            continue
        if doc.get("meta") != meta:
            raise CheckpointMismatchError(
                f"sharded checkpoint at {ckptdir} (generation {g}) does not "
                f"match this factorization: checkpoint {doc.get('meta')}, "
                f"requested {meta}")
        ok = True
        for nm, digest in shards.items():
            spath = os.path.join(gen_dir(ckptdir, g), nm)
            if not (os.path.exists(spath)
                    and _file_digest(spath) == digest):
                obs.counter("resilience.checkpoint.corrupt")
                obs.emit("checkpoint", event="corrupt", path=spath)
                ok = False
                break
        if ok:
            return g, doc
    return None


def load_carry(ckptdir: str, manifest: dict, *, panel: int,
               npad: int) -> dict:
    """Assemble the full factorization carry from a manifested generation,
    independent of the world size that wrote it (the elastic-degrade
    enabler). Returns ``{"m", "perm", "min_piv", "linvs", "uinvs",
    "next_group"}`` as host numpy arrays."""
    g = int(manifest["next_group"])
    gdir = gen_dir(ckptdir, g)
    shards = [_load_shard(os.path.join(gdir, nm))
              for nm in sorted(manifest["shards"])]
    nb = npad // panel
    m = np.empty((npad, npad), shards[0]["m_rows"].dtype)
    seen = np.zeros(nb, bool)
    done: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for sh in shards:
        for i, k in enumerate(sh["blocks"]):
            m[k * panel:(k + 1) * panel] = \
                sh["m_rows"][i * panel:(i + 1) * panel]
            seen[k] = True
        for i, k in enumerate(sh["done_blocks"]):
            done[int(k)] = (sh["linvs"][i], sh["uinvs"][i])
    if not seen.all():
        raise CheckpointMismatchError(
            f"sharded checkpoint generation {g} at {ckptdir} does not cover "
            f"all {nb} panel blocks (missing {np.flatnonzero(~seen)[:8]})")
    panels_done = min(g, nb)
    if sorted(done) != list(range(panels_done)):
        raise CheckpointMismatchError(
            f"sharded checkpoint generation {g} at {ckptdir}: diagonal "
            f"inverses incomplete ({sorted(done)[:8]}... vs "
            f"{panels_done} panels done)")
    dt = shards[0]["linvs"].dtype if panels_done else m.dtype
    linvs = (np.stack([done[k][0] for k in range(panels_done)])
             if panels_done else np.empty((0, panel, panel), dt))
    uinvs = (np.stack([done[k][1] for k in range(panels_done)])
             if panels_done else np.empty((0, panel, panel), dt))
    return {"m": m, "perm": shards[0]["perm"],
            "min_piv": shards[0]["min_piv"], "linvs": linvs, "uinvs": uinvs,
            "next_group": g}


def factor_sharded(a, ckptdir, worker: int, world: int, *,
                   panel: Optional[int] = None,
                   chunk: Optional[int] = None,
                   panel_impl: str = "auto",
                   gemm_precision: str = "highest",
                   beat: Optional[Callable[..., None]] = None,
                   barrier_deadline_s: Optional[float] = None,
                   barrier_poll_s: float = 0.02, device=None):
    """One fleet worker's group loop: factor ``a`` with per-group sharded
    checkpoints and a manifest barrier per generation.

    Resumes automatically from the newest verified generation in
    ``ckptdir`` (written by ANY world size, by either package). Worker 0
    is the coordinator (publishes manifests, garbage-collects old
    generations); everyone else blocks on the manifest. Both waits run
    under the collective watchdog (``barrier_deadline_s``, else the
    process-wide deadline), so a dead or stalled peer raises
    :class:`watchdog.WorkerLostError` for the supervisor to act on
    instead of hanging the job. ``beat`` is invoked with progress fields
    every group AND every barrier poll.

    ``a``: a float32 array (or tensor), staged on ``device`` (default
    ``cuda``; ``"cpu"`` runs the kernels' plain versions). Returns
    ``(BlockedLU, stats)``; the final generation (``next_group == nb``) is
    always written and manifested, so a worker killed after factorization
    but before the solve resumes for free. ``stats`` has the JAX
    package's ``resumed_from`` and ``gens_written`` and, the port's own,
    ``shard_write_s`` / ``shard_bytes`` (one entry a generation this
    worker wrote: the device-to-host copy, the write and its fsync) and
    ``manifest_hash_s`` (worker 0: the seconds spent hashing shards and
    publishing manifests).
    """
    import torch

    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.core.matmul import resolve_precision

    if not 0 <= worker < world:
        raise ValueError(f"worker must be in [0, {world}), got {worker}")
    host = _host(a)
    n = host.shape[0]
    if host.shape != (n, n):
        raise ValueError(f"expected square matrix, got {host.shape}")
    mode = resolve_precision(gemm_precision, allow_split=True)
    m0, dev = blocked._check_square(a, panel_impl, device)
    panel = blocked._resolve_panel(n, panel, m0.element_size())
    chunk = blocked.CHUNK_DEFAULT if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    ckptdir = os.fspath(ckptdir)
    beat = beat or (lambda **kw: None)
    meta = {"schema": SCHEMA, "n": n, "panel": panel, "chunk": chunk,
            "panel_impl": panel_impl, "gemm_precision": gemm_precision,
            "dtype": str(host.dtype), "digest": _digest(host)}

    m = blocked._pad_to_panel(m0, panel)
    del m0
    npad = m.shape[0]
    nb = npad // panel
    start_group = 0
    perm = torch.arange(npad, device=dev)
    min_piv = torch.full((), float("inf"), dtype=m.dtype, device=dev)
    linv_parts: List = []
    uinv_parts: List = []

    good = last_good(ckptdir, meta)
    if good is not None:
        g, manifest = good
        carry = load_carry(ckptdir, manifest, panel=panel, npad=npad)
        m = torch.as_tensor(carry["m"], device=dev)
        perm = torch.as_tensor(carry["perm"], dtype=torch.int64, device=dev)
        min_piv = torch.as_tensor(carry["min_piv"], device=dev)
        if carry["linvs"].shape[0]:
            linv_parts = [torch.as_tensor(carry["linvs"], device=dev)]
            uinv_parts = [torch.as_tensor(carry["uinvs"], device=dev)]
        start_group = int(carry["next_group"])
        obs.counter("resilience.checkpoint.resumes")
        obs.emit("checkpoint", event="resume", path=ckptdir,
                 next_group=start_group, worker=worker, world=world)

    stats = {"resumed_from": start_group if good else None,
             "gens_written": 0, "shard_write_s": [], "shard_bytes": [],
             "manifest_hash_s": 0.0}

    def _publish(next_group: int) -> bool:
        t0 = time.perf_counter()
        try:
            return try_publish_manifest(ckptdir, next_group, world, meta)
        finally:
            stats["manifest_hash_s"] += time.perf_counter() - t0

    def _barrier(next_group: int, phase: str):
        beat(phase=phase, group=next_group)
        if worker == 0:
            watchdog.wait_for(
                lambda: _publish(next_group),
                site="fleet.manifest.publish", deadline_s=barrier_deadline_s,
                poll_s=barrier_poll_s,
                on_tick=lambda: beat(phase=phase, group=next_group))
            gc_generations(ckptdir)
        else:
            watchdog.wait_for(
                lambda: os.path.exists(os.path.join(
                    gen_dir(ckptdir, next_group), MANIFEST)),
                site="fleet.manifest.wait", deadline_s=barrier_deadline_s,
                poll_s=barrier_poll_s,
                on_tick=lambda: beat(phase=phase, group=next_group))

    for g0 in range(start_group, nb, chunk):
        # Hook point "fleet.worker.group": preemption (kill), a hang
        # (stall), or the in-process stand-in (raise) BETWEEN groups —
        # the supervisor and watchdog must turn any of them into a
        # restart-and-resume, never a hang or a wrong answer.
        _inject.maybe_kill("fleet.worker.group")
        beat(phase="factor", group=g0)
        m, perm, min_piv, lg, ug = blocked._factor_group(
            m, perm, min_piv, g0, panel, chunk, panel_impl, mode)
        linv_parts.append(lg)
        uinv_parts.append(ug)
        next_group = min(g0 + chunk, nb)
        t0 = time.perf_counter()
        _, nbytes = write_shard(
            ckptdir, next_group, worker, world, meta=meta, m=m, perm=perm,
            min_piv=min_piv, linvs=torch.cat(linv_parts),
            uinvs=torch.cat(uinv_parts), panel=panel)
        stats["shard_write_s"].append(round(time.perf_counter() - t0, 6))
        stats["shard_bytes"].append(int(nbytes))
        stats["gens_written"] += 1
        obs.counter("resilience.checkpoint.saves")
        obs.emit("checkpoint", event="save", path=ckptdir,
                 next_group=next_group, worker=worker, world=world,
                 bytes=int(nbytes))
        _barrier(next_group, phase="barrier")

    if start_group >= nb and nb > 0:
        # Resumed past the last group (killed between factorization and
        # solve): the final generation already exists; nothing to compute.
        _barrier(nb, phase="barrier")

    stats["manifest_hash_s"] = round(stats["manifest_hash_s"], 6)
    empty = torch.empty((0, panel, panel), dtype=torch.float32, device=dev)
    fac = blocked.BlockedLU(
        m=m, perm=perm, min_abs_pivot=min_piv,
        linv=torch.cat(linv_parts) if linv_parts else empty,
        uinv=torch.cat(uinv_parts) if uinv_parts else empty)
    return fac, stats

"""Multi-process bootstrap: the mpirun + hostfile axis, on torch.distributed.

The reference scales past one machine with MPI: an ssh-key bootstrap, a
hostfile naming the nodes, and ``mpirun -np N -hostfile hosts`` starting one
rank per slot (reference OpenMP_and_MPI/README.txt:39-48,
OpenMP_and_MPI/gauss_mpi/hosts:1-6). The port's equivalent is one process
per card: every process runs the same program, calls :func:`initialize`
once (the MPI_Init analog, ``torch.distributed.init_process_group`` over
NCCL on the card or gloo on the CPU), and the distributed engines build
their meshes over the world of processes.

Launch parity table:

    mpirun -np N -hostfile hosts ./gauss -s 8192
        == on each host, one process per card:
    python -m gauss_tpu_torch.cli.gauss_internal -s 8192 \\
        --backend cuda-dist-blocked --coordinator host0:29500 \\
        --num-processes N --process-id <i>

On one host, ``-t P`` (or ``python -m gauss_tpu_torch.dist.launch``)
starts the P local ranks itself (:mod:`gauss_tpu_torch.dist.launch`).

The launch coordinates fall back to the JAX package's environment names
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), so
one launch script serves both packages, and :func:`resolve_metrics_stream`
names the per-process streams exactly as the JAX package does.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Optional

from gauss_tpu_torch.resilience import inject as _inject

# None until initialize() succeeds, then the (coordinator, num_processes,
# process_id) topology it was called with (for the idempotence check).
_INITIALIZED = None
# The process group this module started (destroyed by shutdown()).
_OWNED = False
_DEVICE = None
_EPOCH = 0
_STORE_DIR = None

#: Seconds a collective may wait for a peer before the process group
#: raises (torch.distributed's own bound; the watchdog's is separate).
PG_TIMEOUT_S = 600


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def epoch() -> int:
    """Bumped at every process-group start, so cached meshes of an earlier
    world are never reused."""
    return _EPOCH


def device():
    """This rank's torch.device (the card it owns, or the CPU)."""
    import torch

    if _DEVICE is not None:
        return _DEVICE
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _start(dev, init_method: str, world: int, rank: int) -> None:
    """Start the process group for ``rank`` of ``world`` on ``dev``:
    NCCL on a card (which must exist, and NCCL with it), gloo on the
    CPU."""
    global _OWNED, _DEVICE, _EPOCH
    import torch
    import torch.distributed as dist

    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(dev)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL backend; the "
                               "distributed engines on the card need it")
        local = rank % torch.cuda.device_count()
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    _OWNED, _DEVICE = True, dev
    _EPOCH += 1


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> None:
    """MPI_Init analog: join this process into the world of processes.

    Arguments fall back to ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``. With no coordinator a world
    of one starts on a file store in a temporary directory; a larger world
    needs the coordinator (``host:port`` of process 0, where the TCP store
    listens). ``device``: ``cuda`` (None, NCCL, the card ``process_id``
    modulo the cards present) or ``cpu`` (gloo). Idempotent for an
    identical topology; raises on re-initialization with a different
    one."""
    global _INITIALIZED, _STORE_DIR
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID")
    requested = (coordinator, num_processes, process_id)
    if _INITIALIZED is not None:
        if requested == _INITIALIZED:
            return
        raise RuntimeError(
            f"multihost.initialize() already called with topology "
            f"{_INITIALIZED}; cannot re-initialize as {requested}")
    world = num_processes if num_processes is not None else 1
    rank = process_id if process_id is not None else 0
    if coordinator is None:
        if world != 1:
            raise ValueError(f"a world of {world} processes needs a "
                             f"coordinator address (--coordinator)")
        _STORE_DIR = tempfile.mkdtemp(prefix="gauss_torch_pg_")
        init_method = f"file://{os.path.join(_STORE_DIR, 'store')}"
    else:
        init_method = f"tcp://{coordinator}"
    if _inject.enabled():
        # Hook point "dist.multihost.straggler": a worker that shows up
        # late to the rendezvous (the plan's ``param`` is the delay).
        _inject.maybe_delay("dist.multihost.straggler")
    _start(device, init_method, world, rank)
    _INITIALIZED = requested
    if _inject.enabled():
        # Hook point "dist.multihost.worker": kill THIS worker right after
        # it joined (kind="kill", a real os._exit) or stall it.
        _inject.maybe_kill("dist.multihost.worker")


def ensure_world(device=None) -> None:
    """A process group exists after this call: the one already started,
    else a world of one on ``device``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        initialize(None, 1, 0, device=device)


def shutdown() -> None:
    """Destroy the process group this module started (no-op otherwise)."""
    global _INITIALIZED, _OWNED, _DEVICE, _STORE_DIR
    import torch.distributed as dist

    if _OWNED and dist.is_initialized():
        dist.destroy_process_group()
    if _STORE_DIR is not None:
        import shutil

        shutil.rmtree(_STORE_DIR, ignore_errors=True)
    _INITIALIZED, _OWNED, _DEVICE, _STORE_DIR = None, False, None, None


def is_multihost() -> bool:
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > 1


def process_banner() -> str:
    """One-line rank banner, the analog of the reference's per-rank prints
    (gauss_mpi/gauss_internal_input.c:319-327): one device per process."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    return (f"process {rank}/{world}: 1 local / {world} global devices "
            f"({device()})")


def maybe_initialize_from_args(args) -> bool:
    """CLI hook: initialize when any multihost flag/env coordinate is set.
    Returns True when the process joined a launch this way. ``args.device``
    (when present) picks the card or the CPU."""
    explicit = any(getattr(args, k, None) is not None
                   for k in ("coordinator", "num_processes", "process_id"))
    env = any(k in os.environ for k in
              ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
               "JAX_PROCESS_ID"))
    if not (explicit or env):
        return False
    initialize(getattr(args, "coordinator", None),
               getattr(args, "num_processes", None),
               getattr(args, "process_id", None),
               device=getattr(args, "device", None))
    return True


def resolve_metrics_stream(metrics_out, coordinator=None, process_id=None):
    """Per-process telemetry coordinates for a (possibly) multi-process
    launch: returns ``(stream_path, run_id)`` for ``obs.run``.

    Each process writes ``<base>.p<process_id><ext>`` (two processes
    appending to one file interleave partial lines) and all of them stamp
    ONE run id, so ``python -m gauss_tpu_torch.obs.aggregate
    base.p*.jsonl`` merges the streams back into a single run. The id is
    ``GAUSS_OBS_RUN_ID`` when the launcher exported one, else derived from
    the coordinator address (the same on every process of a launch).
    Single-process runs (no coordinates anywhere) pass through unchanged:
    ``(metrics_out, None)``. The JAX package's function, name for name."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    run_id = os.environ.get("GAUSS_OBS_RUN_ID")
    if coordinator is None and process_id is None:
        return metrics_out, run_id
    if run_id is None and coordinator is not None:
        import hashlib

        run_id = hashlib.sha1(
            f"multihost:{coordinator}".encode()).hexdigest()[:12]
    if metrics_out and process_id is not None:
        root, ext = os.path.splitext(os.fspath(metrics_out))
        metrics_out = f"{root}.p{process_id}{ext}"
    return metrics_out, run_id


def add_multihost_args(parser) -> None:
    """Attach the three launch coordinates to a CLI parser (mpirun parity)."""
    g = parser.add_argument_group(
        "multihost", "multi-process launch coordinates (the mpirun "
        "-np/-hostfile analog; one process per card)")
    g.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="process 0's rendezvous address")
    g.add_argument("--num-processes", type=int, default=None)
    g.add_argument("--process-id", type=int, default=None)

"""Start P local ranks, each on its own device, and feed them calls.

The port's ``mpirun -np P`` on one host. :class:`World` starts P
processes once (``multiprocessing``'s spawn), joins them into one
``torch.distributed`` process group through a file store in a fresh
temporary directory (no fixed TCP port), and then runs as many calls on
them as its owner sends: every rank runs the same function on the same
arguments (SPMD), on the mesh the call names, and each rank's result
comes back with tensors moved to the host. The CLIs' ``-t P``, the tests
and ``chip_smoke.py`` start their ranks here.

On ``cuda`` each rank owns one card (rank i the card i), and P is clamped
to the cards present, as the JAX package clamps its mesh to its devices;
``cuda`` without a card raises. On ``cpu`` the ranks run gloo, P clamped
to the CPU cores. Every rank runs on one torch thread.

:func:`run` is the one-shot form: P == 1 runs the call in the calling
process on a world of one (started and shut down around the call unless a
process group exists already); P > 1 starts a World, runs the call and
closes it.

``python -m gauss_tpu_torch.dist.launch -n P [--device cpu] -- <module>
[args]`` runs ``python -m <module> [args]`` as P processes with the three
multihost coordinates set (``--coordinator 127.0.0.1:<free port>
--num-processes P --process-id i``), the launch a multi-card host makes.
"""

from __future__ import annotations

import argparse
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback

#: Seconds a World waits for all ranks to answer one call.
CALL_TIMEOUT_S = 900


class RankError(RuntimeError):
    """A rank raised, died or timed out; the message carries its
    traceback. A World whose ranks all answered stays open after it; one
    that lost a rank, or waited past its timeout, is closed."""


def clamp_ranks(nprocs: int, device) -> int:
    """The number of ranks a launch of ``nprocs`` on ``device`` runs: at
    least one, and at most the cards present on ``cuda`` (raises without
    a card) or the CPU cores on ``cpu``, one rank each (0: all of them)."""
    import torch

    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    avail = (torch.cuda.device_count() if dev.type == "cuda"
             else os.cpu_count() or 1)
    return max(1, min(int(nprocs or avail), avail))


def _to_host(obj):
    """A rank's result as host data: tensors on the CPU, containers
    walked, and any other object with attributes (a factorization handle)
    as the dict of its attributes, meshes dropped (a mesh does not leave
    its process)."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, (list, tuple)):
        out = [_to_host(o) for o in obj]
        return tuple(out) if isinstance(obj, tuple) else out
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if (hasattr(obj, "__dict__") and not isinstance(obj, (type, np.ndarray))
            and not callable(obj)):
        return {k: _to_host(v) for k, v in vars(obj).items()
                if not isinstance(v, DeviceMesh)}
    return obj


def chained(calls, mesh=None):
    """Run ``(fn, args, kwargs)`` calls in turn on this rank, each after
    the first with the previous result as its first argument, and every
    one with ``mesh=mesh`` when a mesh is named (stage, then solve)."""
    out = None
    for i, (fn, args, kwargs) in enumerate(calls):
        if i:
            args = (out, *args)
        kw = dict(kwargs)
        if mesh is not None:
            kw["mesh"] = mesh
        out = fn(*args, **kw)
    return out


def recorded(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under a recorder of this rank's own; returns
    ``(result, events)``: the events the call recorded (its ``collective``
    budgets, ``route`` decisions, spans)."""
    from gauss_tpu_torch import obs

    with obs.run() as rec:
        out = fn(*args, **kwargs)
    return out, list(rec.events)


def _mesh_for(spec, device):
    """The mesh a call names: None (no mesh), ``(P,)`` (1-D over the
    first P ranks), ``(R, C)`` (2-D)."""
    from gauss_tpu_torch.dist import mesh as _mesh

    if spec is None:
        return None
    if len(spec) == 1:
        return _mesh.make_mesh(spec[0], device=device)
    return _mesh.make_mesh_2d(*spec, device=device)


def call_on_rank(fn, args, kwargs, mesh_spec, count, device):
    """Run one call on this rank: build the named mesh (every rank takes
    part), run ``fn(*args, mesh=mesh, **kwargs)`` where this rank is in it
    (None elsewhere), and with ``count`` return ``(result, budget)`` with
    the collectives the call issued."""
    from gauss_tpu_torch.dist import mesh as _mesh
    from gauss_tpu_torch.obs import collectives

    mesh = _mesh_for(mesh_spec, device)
    if mesh is not None and not _mesh.in_mesh(mesh):
        return (None, {}) if count else None
    kw = dict(kwargs)
    if mesh is not None:
        kw["mesh"] = mesh
    with collectives.counting() as budget:
        out = fn(*args, **kw)
    return (out, budget) if count else out


def _rank_main(rank, world, device, init_file, conn):
    """A World's rank: join the group, then run calls until told to stop.
    One torch thread a rank: P ranks share the host's cores."""
    import torch

    from gauss_tpu_torch.dist import multihost

    torch.set_num_threads(1)
    try:
        multihost._start(device, f"file://{init_file}", world, rank)
        multihost._INITIALIZED = ("launch", world, rank)
        conn.send(("ready", None))
    except BaseException:  # noqa: BLE001 — relayed to the owner
        conn.send(("error", traceback.format_exc()))
        return
    while True:
        job = conn.recv()
        if job is None:
            break
        try:
            conn.send(("ok", _to_host(call_on_rank(*job, device))))
        except BaseException:  # noqa: BLE001 — relayed to the owner
            conn.send(("error", traceback.format_exc()))
    multihost.shutdown()


class World:
    """P ranks started once; :meth:`run` sends them calls. Use as a
    context manager (or call :meth:`close`)."""

    def __init__(self, nprocs: int, device=None):
        import multiprocessing as mp

        self.device = "cuda" if device is None else str(device)
        self.size = clamp_ranks(nprocs, self.device)
        self._dir = tempfile.mkdtemp(prefix="gauss_torch_world_")
        init_file = os.path.join(self._dir, "store")
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        for rank in range(self.size):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(rank, self.size, self.device, init_file,
                                  child))
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self._collect("start")

    def _collect(self, what: str) -> list:
        """Every rank's answer; after the first failure the others get a
        short grace (they may be blocked in a collective with it)."""
        deadline = time.monotonic() + CALL_TIMEOUT_S
        out, errors = [None] * self.size, []
        pending = set(range(self.size))
        while pending:
            for rank in sorted(pending):
                conn = self._conns[rank]
                if conn.poll():
                    status, value = conn.recv()
                    pending.discard(rank)
                    if status == "error":
                        errors.append(f"rank {rank}:\n{value}")
                        deadline = min(deadline, time.monotonic() + 10)
                    else:
                        out[rank] = value
                elif not self._procs[rank].is_alive():
                    pending.discard(rank)
                    errors.append(f"rank {rank} died (exit code "
                                  f"{self._procs[rank].exitcode})")
                    deadline = min(deadline, time.monotonic() + 10)
            if pending and time.monotonic() > deadline:
                errors += [f"rank {r} gave no answer to {what}"
                           for r in sorted(pending)]
                break
            if pending:
                time.sleep(0.002)
        if errors:
            if pending or not all(p.is_alive() for p in self._procs):
                # A rank is lost or stuck in a collective: the world cannot
                # take another call.
                self.close(force=True)
            raise RankError(f"{what} failed on the world of {self.size}:\n"
                            + "\n".join(errors))
        return out

    def run(self, fn, *args, mesh=None, count: bool = False, **kwargs):
        """Run ``fn(*args, mesh=<mesh>, **kwargs)`` on every rank and return
        the list of per-rank results (None for ranks outside the mesh).
        ``mesh``: None, ``(P,)`` or ``(R, C)``. ``fn`` must be importable
        by name (a module-level function)."""
        if not self._conns:
            raise RankError("the world is closed")
        for conn in self._conns:
            conn.send((fn, args, kwargs, mesh, count))
        return self._collect(getattr(fn, "__name__", "call"))

    def close(self, force: bool = False) -> None:
        for conn in self._conns:
            try:
                if not force:
                    conn.send(None)
            except OSError:
                pass
        for p in self._procs:
            p.join(timeout=0 if force else 30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(force=exc[0] is not None)


def run(nprocs: int, fn, *args, mesh=None, device=None, count=False,
        **kwargs):
    """One call on ``nprocs`` ranks (clamped as :func:`clamp_ranks` says);
    returns rank 0's result. A ``mesh`` of ``"1d"`` or ``"2d"`` spans all
    the ranks (the squarest grid for ``"2d"``); a tuple names a shape."""
    from gauss_tpu_torch.dist import multihost
    from gauss_tpu_torch.dist.mesh import squarest_factors

    import torch.distributed as dist

    if dist.is_initialized():
        p = dist.get_world_size()
    else:
        p = clamp_ranks(nprocs, device)
    if mesh == "1d":
        mesh = (p,)
    elif mesh == "2d":
        mesh = squarest_factors(p)
    if p == 1 or dist.is_initialized():
        started = not dist.is_initialized()
        multihost.ensure_world(device)
        try:
            return call_on_rank(fn, args, kwargs, mesh, count, device)
        finally:
            if started:
                multihost.shutdown()
    with World(p, device=device) as world:
        return world.run(fn, *args, mesh=mesh, count=count, **kwargs)[0]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.dist.launch",
        description="Run `python -m MODULE ARGS` as P local processes with "
                    "the multihost coordinates set (one card each).")
    p.add_argument("-n", "--nprocs", type=int, required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("module")
    p.add_argument("args", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    n = clamp_ranks(a.nprocs, a.device)
    coord = f"127.0.0.1:{free_port()}"
    extra = [] if a.device == "cuda" else ["--device", "cpu"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", a.module, *a.args, *extra,
         "--coordinator", coord, "--num-processes", str(n),
         "--process-id", str(i)]) for i in range(n)]
    rcs = [pr.wait() for pr in procs]
    return max(rcs, key=abs)


if __name__ == "__main__":
    sys.exit(main())

"""gauss_tpu_torch.serve — the batched solver service (the port of
``gauss_tpu/serve``).

A long-lived in-process server that pads arbitrary-``n`` requests onto a
small shape-bucket ladder (:mod:`.buckets`), drains a bounded queue into
batched blocked solves through an LRU cache of batched executables
(:mod:`.cache`: one batched kernel launch per panel step on the card),
routes oversized systems through ``solve_handoff``, serves sparse
systems on the Krylov ladder and degrades to the host recovery ladder
when the device lane is persistently unhealthy — with admission control
(:mod:`.admission`: queue bounds, deadlines, the poison scan) in front and
an open/closed-loop load generator (:mod:`.loadgen`, ``python -m
gauss_tpu_torch.serve.cli``) beside it. :mod:`.durable` makes admission
durable (the write-ahead request journal, ``ServeConfig(journal_dir=)``,
crash -> restart replay, idempotency keys, ``supervise``; the campaign
``python -m gauss_tpu_torch.serve.durablecheck``), and :mod:`.net` puts
a server behind HTTP (``ReplicaApp``, ``RequestApi``, ``SolveClient``,
``python -m gauss_tpu_torch.serve.net --replica``). :mod:`.router` fronts
N replica processes (consistent-hash routing, journal failover, bounded
restarts; ``serve.cli --replicas N``), with its campaigns ``python -m
gauss_tpu_torch.serve.replicacheck`` and ``python -m
gauss_tpu_torch.serve.poisoncheck``. Importing this package loads no
torch.

Quick tour::

    from gauss_tpu_torch.serve import ServeConfig, SolverServer

    with SolverServer(ServeConfig(verify_gate=1e-4)) as srv:  # the card
        res = srv.solve(a, b)            # pads, batches, caches, verifies
        assert res.ok

Not ported yet (ROADMAP queue-1 item 11): ``CacheView``,
``shared_cache``, ``Lane``, ``LaneSet``, ``compat_sig`` (the mesh lanes)
and ``meshcheck``.
"""

from gauss_tpu_torch.serve.admission import (  # noqa: F401
    STATUS_CANCELLED,
    STATUS_EXPIRED,
    STATUS_FAILED,
    STATUS_OK,
    STATUS_POISON,
    STATUS_REJECTED,
    FeatureNotPortedError,
    LaneHealth,
    ServeConfig,
    ServeRequest,
    ServeResult,
    poison_scan,
)
from gauss_tpu_torch.serve.buckets import (  # noqa: F401
    DEFAULT_LADDER,
    bucket_for,
    pad_system,
    pow2_bucket,
    unpad_solution,
)
from gauss_tpu_torch.serve.cache import (  # noqa: F401
    BatchedExecutable,
    CacheKey,
    ExecutableCache,
    LaneNotPortedError,
)
from gauss_tpu_torch.serve.durable import (  # noqa: F401
    JournalError,
    RequestJournal,
)
from gauss_tpu_torch.serve.server import SolverServer  # noqa: F401

__all__ = ["BatchedExecutable", "CacheKey", "DEFAULT_LADDER",
           "ExecutableCache", "FeatureNotPortedError", "JournalError",
           "LaneHealth", "LaneNotPortedError", "RequestJournal",
           "STATUS_CANCELLED", "STATUS_EXPIRED", "STATUS_FAILED",
           "STATUS_OK", "STATUS_POISON", "STATUS_REJECTED", "ServeConfig",
           "ServeRequest", "ServeResult", "SolverServer", "bucket_for",
           "pad_system", "poison_scan", "pow2_bucket", "unpad_solution"]

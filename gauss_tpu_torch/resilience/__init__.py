"""gauss_tpu_torch.resilience — fault injection, recovery ladders,
checkpointed and checksum-carrying solves.

Port of ``gauss_tpu/resilience``:

- :mod:`.inject` — seeded, deterministic fault injection behind named hook
  points; off by default, one ``is None`` check per hook.
- :mod:`.recover` — ``solve_resilient(a, b)``: every result gated at the
  1e-4 relative residual, failures escalated along an explicit ladder of
  the port's engines (with ``abft=True``, the checksum-carrying rung
  first), each step an obs ``recovery`` event, a typed
  :class:`UnrecoverableSolveError` only when the ladder is exhausted.
- :mod:`.checkpoint` — panel-granular checkpoint/resume of the chunked
  factorization, in the JAX package's file format: a killed run resumes
  bit for bit.
- :mod:`.abft` — checksum-carrying LU, Cholesky and matmul that detect
  silent data corruption within one panel group, localize it and replay
  the group from the held carry (bit for bit an uninterrupted run), and
  escalate typed (:class:`~gauss_tpu_torch.resilience.abft
  .SDCUnrecoverableError`) when replay fails.
- :mod:`.chaos` — the campaign runner (``python -m
  gauss_tpu_torch.resilience.chaos``): every injected fault recovered or
  typed, never a silent wrong answer.
- :mod:`.abftcheck` — the ABFT campaign (``python -m
  gauss_tpu_torch.resilience.abftcheck``).

``inject`` is imported eagerly (stdlib + numpy only; the hook points in
``core`` reference it at module load); the other submodules import the
solver stack and load lazily. Not ported yet: ``watchdog``,
``dcheckpoint`` and ``fleet`` (ROADMAP queue-1 item 10), so
``WorkerLostError``, ``FleetError`` and ``solve_supervised`` are not
here, and ``chaos`` refuses its ``fleet`` and ``durable`` phases.
"""

from gauss_tpu_torch.resilience.inject import (  # noqa: F401
    FaultPlan,
    FaultSpec,
    SimulatedCompileError,
    SimulatedFaultError,
)

_LAZY = ("recover", "checkpoint", "chaos", "inject", "abft", "abftcheck")

__all__ = ["FaultPlan", "FaultSpec", "SimulatedCompileError",
           "SimulatedFaultError", "UnrecoverableSolveError",
           "solve_resilient"]


def __getattr__(name):
    if name == "UnrecoverableSolveError":
        from gauss_tpu_torch.resilience.recover import UnrecoverableSolveError

        return UnrecoverableSolveError
    if name == "solve_resilient":
        from gauss_tpu_torch.resilience.recover import solve_resilient

        return solve_resilient
    if name in _LAZY:
        import importlib

        return importlib.import_module(f"gauss_tpu_torch.resilience.{name}")
    raise AttributeError(
        f"module 'gauss_tpu_torch.resilience' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))

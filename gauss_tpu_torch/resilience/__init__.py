"""gauss_tpu_torch.resilience — fault injection and the recovery ladder.

Port of ``gauss_tpu/resilience``:

- :mod:`.inject` — seeded, deterministic fault injection behind named hook
  points (``core.blocked.factor``, ``core.gauss.solve``,
  ``serve.cache.compile``, ``structure.detect``); off by default, one
  ``is None`` check per hook.
- :mod:`.recover` — ``solve_resilient(a, b)``: every result gated at the
  1e-4 relative residual, failures escalated along an explicit ladder of
  the port's engines, each step an obs ``recovery`` event, a typed
  :class:`UnrecoverableSolveError` only when the ladder is exhausted.

``inject`` is imported eagerly (stdlib + numpy only; the hook points in
``core`` reference it at module load); ``recover`` imports the solver
stack and loads lazily. Not ported yet: ``checkpoint``, ``abft``,
``chaos`` and ``abftcheck`` (ROADMAP queue-1 item 9) and ``watchdog``,
``dcheckpoint`` and ``fleet`` (item 10), so ``WorkerLostError``,
``FleetError`` and ``solve_supervised`` are not here.
"""

from gauss_tpu_torch.resilience.inject import (  # noqa: F401
    FaultPlan,
    FaultSpec,
    SimulatedCompileError,
    SimulatedFaultError,
)

_LAZY = ("recover", "inject")

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

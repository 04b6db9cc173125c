"""Tracing / profiling: phase tables and device traces.

The port's counterpart of the JAX package's ``utils/profiling.py``:

- :class:`PhaseTimer` — named wall-clock spans with a gprof-style
  percentage report, each phase closed after a synchronize of the CUDA
  devices of the tensors it is given;
- :func:`trace` — a ``torch.profiler`` capture written as a Chrome trace
  into a directory (the JAX package writes a ``jax.profiler`` trace
  there), no-op when given no directory so CLI flags can pass None
  straight through. A trace of a CUDA run records the card's kernels,
  including the hand-written ones launched through ``ctypes``, and fails
  when it holds none.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


def _cuda_devices(value, found: set) -> set:
    """The CUDA devices of every tensor in ``value`` (a tensor or a
    tuple/list/dict of them, NamedTuples included)."""
    if hasattr(value, "device") and hasattr(value, "detach"):
        if value.device.type == "cuda":
            found.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, found)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    return found


def _synchronize(value) -> None:
    """Wait for the CUDA devices that hold ``value``'s tensors; CPU
    tensors need no wait."""
    devices = _cuda_devices(value, set())
    if devices:
        import torch

        for dev in devices:
            torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulates named wall-clock spans; renders a gprof-like table.

    Every closed phase also reports into the telemetry core
    (``gauss_tpu_torch.obs``) as a span event when a recorder is active.
    Pass ``emit=False`` to keep a timer table-only.

    >>> pt = PhaseTimer()
    >>> with pt.phase("init"): ...
    >>> with pt.phase("computeGauss"): ...
    >>> print(pt.report())
    """

    def __init__(self, emit: bool = True) -> None:
        self.seconds: Dict[str, float] = {}
        self.emit = emit

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time a phase. ``block_on``: optional tensor (or tuple/list/dict
        of tensors) whose CUDA devices are synchronized before the span
        closes, so asynchronous launches do not leak one phase's device
        time into the next."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            dur = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dur
            if self.emit:
                from gauss_tpu_torch.obs import spans as _obs_spans

                _obs_spans.record_span(name, dur)

    @property
    def total(self) -> float:
        return sum(self.seconds.values())

    def report(self) -> str:
        """gprof-flavoured flat profile: % time, seconds, phase."""
        total = self.total or 1.0
        lines = ["  %time   seconds  phase"]
        for name, s in sorted(self.seconds.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {100.0 * s / total:5.1f}  {s:9.6f}  {name}")
        return "\n".join(lines)


class Trace:
    """What a :func:`trace` block wrote, filled in when it closes: the
    Chrome trace's ``path`` and the number of ``device_events`` it holds
    (kernels, copies and sets on the card; 0 on a CPU run)."""

    path: Optional[str] = None
    device_events: int = 0


@contextlib.contextmanager
def trace(logdir: Optional[str], device=None):
    """Capture a ``torch.profiler`` trace of the block into ``logdir``
    (None -> no-op, yields None); yields a :class:`Trace`.

    ``device``: the run's device (``None`` = ``cuda``). On a CUDA run the
    profiler records CPU and CUDA activity, the card is synchronized
    before the capture closes, and a trace that holds no device event
    raises RuntimeError; on a CPU run it records CPU activity only. The
    trace is written as ``trace_<pid>_<ms>.json`` (Chrome trace format:
    chrome://tracing, https://ui.perfetto.dev)."""
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gauss_tpu_torch.utils.device import resolve_device

    on_card = resolve_device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    out = Trace()
    with profile(activities=activities) as prof:
        try:
            yield out
        finally:
            if on_card:
                torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(
        os.fspath(logdir),
        f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    out.path = path
    out.device_events = sum(
        1 for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    if on_card and not out.device_events:
        raise RuntimeError(
            f"the CUDA trace {path} recorded no device activity: the "
            "profiler did not trace the card")

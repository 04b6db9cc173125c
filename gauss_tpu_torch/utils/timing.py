"""Wall-clock timing with device-completion semantics.

CUDA launches return before the card finishes, so an honest span ends with
``torch.cuda.synchronize()`` and a host fetch of the (small) result.
:func:`timed_fetch` is what the CLI drivers use; :func:`cuda_event_ms`
times a kernel on the card's own clock.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import numpy as np
import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _fetch(result):
    """Host copy of a result (tensor, or tuple/list/dict of them)."""
    if isinstance(result, torch.Tensor):
        return result.detach().cpu().numpy()
    if isinstance(result, (tuple, list)):
        return type(result)(_fetch(r) for r in result)
    if isinstance(result, dict):
        return {k: _fetch(v) for k, v in result.items()}
    return np.asarray(result) if result is not None else None


def timed_fetch(fn: Callable, *args, **kwargs):
    """Run ``fn`` once in one span; return ``(seconds, host_result)``. The
    span opens after a device synchronize (earlier work cannot bill to it)
    and closes after the result is on the host. Keep the result small (a
    vector, not a matrix), or the span measures the device-to-host copy."""
    _sync()
    t0 = time.perf_counter()
    result = _fetch(fn(*args, **kwargs))
    _sync()
    return time.perf_counter() - t0, result


def cuda_event_ms(fn: Callable, reps: int = 20, warmup: int = 2,
                  setup: Callable | None = None) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events around
    each call. ``setup()`` (optional) runs before each call, outside the
    timed window — e.g. a fresh copy of an operand the call updates in
    place."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_event_ms needs a CUDA device")
    for _ in range(max(warmup, 0)):
        if setup is not None:
            setup()
        fn()
    times = []
    for _ in range(max(reps, 1)):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(statistics.median(times))

"""gauss_tpu_torch.outofcore — host-streamed solves for n beyond the card.

Port of ``gauss_tpu/outofcore``. The full matrix lives in (page-locked)
host memory; only the active panel group and a bounded window of trailing
column tiles are on the card, with the H2D and D2H copies on their own
CUDA streams against the updates. The per-group step is the shared
``core.blocked._factor_group``, so the streamed factor cannot drift from
the in-core forms. See stream.py's module docstring for the design;
``python -m gauss_tpu_torch.outofcore.check`` is the gate.

Quick tour::

    from gauss_tpu_torch import outofcore

    x = outofcore.solve_outofcore(a, b)          # float64, 1e-4-refinable
    stats = outofcore.last_stream_stats()        # copies/stalls/peaks
    outofcore.outofcore_fits(65536)              # admission

``core.blocked.solve_handoff(engine="outofcore")`` forces this route;
size-routed requests past the card's budget stream here.
"""

from gauss_tpu_torch.outofcore.stream import (  # noqa: F401
    OUTOFCORE_DEVICE_FRAC,
    PIPELINE_TILE_BUFFERS,
    OutOfCoreLU,
    SDCDetectedError,
    StreamStats,
    host_memory_budget,
    last_stream_stats,
    lu_factor_outofcore,
    lu_solve_outofcore,
    outofcore_fits,
    outofcore_window,
    solve_outofcore,
)

__all__ = ["OUTOFCORE_DEVICE_FRAC", "PIPELINE_TILE_BUFFERS", "OutOfCoreLU",
           "SDCDetectedError", "StreamStats", "host_memory_budget",
           "last_stream_stats", "lu_factor_outofcore", "lu_solve_outofcore",
           "outofcore_fits", "outofcore_window", "solve_outofcore"]

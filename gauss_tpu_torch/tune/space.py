"""The tunable parameter space, with the hand constants as seed defaults.

A copy of the parts of the JAX package's ``tune/space.py`` that the port
reads: the seeds of the sparse plane, of the blocked factorization and
the fused kernel, of the lowered-precision solve and of the out-of-core
stream, the declared axes of the ops ``core/blocked``,
``kernels/panel_fused``, ``core/lowered`` and ``outofcore/stream``
consult, and the key helpers (:func:`space_for`, :func:`seed_params`,
:func:`n_bucket`, :func:`config_key`). :func:`config_key` gives the JAX
package's key for the same ``(op, n, dtype, engine)``, so one store
schema describes both packages' configs. The sweep (the JAX package's
``tune/runner.py``) is not ported yet.

Standard library only: importing it loads no torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

# -- seed constants ----------------------------------------------------------

#: Panels per chunked group (``core.blocked.CHUNK_DEFAULT``).
CHUNK_SEED = 4

#: The JAX package's panel-kernel scoped-VMEM budget in bytes; the port
#: keeps it only so that ``core.blocked.auto_panel`` resolves the JAX
#: package's widths.
PANEL_VMEM_BUDGET_SEED = 15_500_000

#: Sub-panel segment width of the JAX package's panel kernel; the port's
#: kernels run the classic single-segment form and accept it for parity.
PANEL_SEG_SEED = 64

#: The fused kernel's trailing column-tile width (accepted for parity,
#: changes no value in the port) and trailing-apply segment width.
FUSED_CT_SEED = 256
FUSED_FSEG_SEED = 32

#: The lowered-precision solve (``core.lowered``): the dtype a solve
#: starts at and its double-single refinement budget. The dtype seed is
#: float32, so without a store nothing changes; only a store that carries
#: a measured converging pair moves the start down the ladder.
LOWERED_DTYPE_SEED = "float32"
LOWERED_REFINE_SEED = 6

#: The out-of-core streamed factorization (``outofcore.stream``): the
#: trailing tile width (columns per streamed H2D/D2H tile), the panels per
#: streamed group, and the share of the device budget the streamed
#: working set may claim (declared, not swept: it keeps headroom for the
#: update's transients and cuBLAS's workspace).
OUTOFCORE_CT_SEED = 4096
OUTOFCORE_CHUNK_SEED = 16
OUTOFCORE_DEVICE_FRAC_SEED = 0.25

#: GMRES restart length — the resident Krylov basis, i.e. the
#: O(nnz + n*restart) peak-memory bound of the sparse plane.
SPARSE_RESTART_SEED = 32
#: Block size the block-Jacobi / blocked incomplete (ILU0/IC0)
#: preconditioners partition on.
SPARSE_BLOCK_SEED = 16

#: Density at or below which the structure tagger classifies "sparse"
#: (structure.detect.SPARSE_MAX_DENSITY re-exports it). A routing-policy
#: bound, not a timing knob.
SPARSE_DENSITY_SEED = 1.0 / 32.0


# -- the declared space ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Axis:
    """One tunable parameter: its name, hand-picked seed, and the candidate
    values an offline sweep tries (seed always included, tried first)."""

    name: str
    seed: Any
    candidates: Tuple[Any, ...] = ()
    #: swept by default? Axes that change numerics or encode hardware
    #: limits are declared (a store may carry them) but swept only on
    #: request.
    sweep_default: bool = True

    def values(self) -> Tuple[Any, ...]:
        vals = [self.seed]
        for c in self.candidates:
            if c not in vals:
                vals.append(c)
        return tuple(vals)


#: op name -> axes, as the JAX package declares them for the ops the port
#: consults. ``None`` seeds mean "auto-resolved by the code" (panel=None
#: routes through ``core.blocked.auto_panel``); a stored winner then
#: short-circuits the auto resolution.
SPACES: Dict[str, Tuple[Axis, ...]] = {
    "lu_factor": (
        Axis("panel", None, (128, 256, 64)),
        Axis("chunk", CHUNK_SEED, (2, 8, 16)),
        Axis("refine_steps", 2, (1, 3), sweep_default=False),
    ),
    "panel_fused": (
        Axis("ct", FUSED_CT_SEED, (128, 512)),
        Axis("fseg", FUSED_FSEG_SEED, (16, 64)),
        Axis("seg", PANEL_SEG_SEED, (32, 128)),
        Axis("vmem_budget", PANEL_VMEM_BUDGET_SEED, (), sweep_default=False),
    ),
    "lowered": (
        Axis("dtype", LOWERED_DTYPE_SEED, ("bfloat16", "bf16x3")),
        Axis("refine_steps", LOWERED_REFINE_SEED, (2, 4, 8, 12)),
    ),
    "outofcore": (
        Axis("ct", OUTOFCORE_CT_SEED, (2048, 8192)),
        Axis("chunk", OUTOFCORE_CHUNK_SEED, (8, 32)),
        Axis("device_frac", OUTOFCORE_DEVICE_FRAC_SEED, (),
             sweep_default=False),
    ),
    "sparse": (
        Axis("restart", SPARSE_RESTART_SEED, (16, 64)),
        Axis("block", SPARSE_BLOCK_SEED, (8, 32)),
        Axis("density", SPARSE_DENSITY_SEED, (), sweep_default=False),
    ),
}


def space_for(op: str) -> Tuple[Axis, ...]:
    try:
        return SPACES[op]
    except KeyError:
        raise KeyError(f"unknown tunable op {op!r}; options: "
                       f"{sorted(SPACES)}") from None


def seed_params(op: str) -> Dict[str, Any]:
    """The hand-tuned defaults for ``op`` — what runs when no store
    exists."""
    return {ax.name: ax.seed for ax in space_for(op)}


def n_bucket(n: int) -> int:
    """The size bucket a tuned config is keyed by: the next power of two
    at or above ``n``."""
    b = 1
    while b < max(1, int(n)):
        b <<= 1
    return b


def config_key(op: str, n: int, dtype: str = "float32",
               engine: str = "blocked") -> str:
    """The store key for (op, n-bucket, dtype, engine). The device kind is
    not in the key: it lives in the store's fingerprint, so one store file
    describes one hardware epoch."""
    return f"{op}/n{n_bucket(n)}/{dtype}/{engine}"

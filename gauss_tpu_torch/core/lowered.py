"""Lowered-precision factorization refined back to the 1e-4 gate (the JAX
package's ``core/lowered.py``).

bfloat16 storage halves every byte the factorization moves, and lets a
thread-block cluster of the panel kernels hold about twice the rows of a
float32 strip in shared memory (``kernels/panel.py``). This module
packages that as a solve with the same 1e-4 guarantee as every other
solve in the package:

- **The dtype ladder** (:data:`LOWERED_DTYPES`, cheapest first):
  ``bfloat16`` (bfloat16 storage, float32-accumulate trailing updates:
  the precision contract of ``core.blocked``), ``bf16x3`` (float32
  storage, the three-pass bf16 split GEMM in the torch-GEMM trailing
  updates, ``core.matmul.dot_bf16x3``), ``float32`` (always the last
  rung).
- **Refinement back to the gate.** Every factor is refined by
  ``dsfloat.refine_ds`` (double-single residuals, corrections through
  the lowered factor's float32 solves) with its masked early exit, whose
  count of updating steps is reported. A solve that misses the gate at
  its budget raises :class:`PrecisionNotConvergedError`.
- **Deterministic demotion.** :func:`solve_lowered_auto` walks the
  ladder from the tuned starting dtype (``tune`` op ``"lowered"``, seed
  ``"float32"``: without a store nothing changes) down to float32, one
  rung per typed failure, and never returns an unverified answer.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gauss_tpu_torch import obs
from gauss_tpu_torch.utils.device import resolve_device
from gauss_tpu_torch.verify import checks

#: The demotion ladder, cheapest first; float32 is always the last rung.
LOWERED_DTYPES = ("bfloat16", "bf16x3", "float32")

#: The acceptance bar every rung refines back to (the reference EPSILON).
DEFAULT_GATE = 1e-4

#: refine_ds stops updating once the double-single residual is under
#: ``gate * margin * ||b||``: inside the gate, so the reported count
#: measures convergence to the contract, not to the last bit.
REFINE_TOL_MARGIN = 0.1

#: Refinement budget per dtype (the masked early exit stops updating, and
#: counting, once converged). bf16's ~4e-3 factor error needs more room
#: than bf16x3's ~1e-5; float32 keeps the dsfloat default.
DEFAULT_REFINE_STEPS = {"bfloat16": 8, "bf16x3": 4, "float32": 6}


class PrecisionNotConvergedError(RuntimeError):
    """A lowered solve could not refine back to the gate at its budget:
    the typed demotion signal :func:`solve_lowered_auto` catches to drop
    one rung down the ladder."""

    def __init__(self, dtype: str, refine_steps: int, rel_residual: float,
                 gate: float):
        super().__init__(
            f"lowered dtype {dtype!r} did not reach the {gate:.0e} gate "
            f"after {refine_steps} refinement step(s) (relative residual "
            f"{rel_residual:.3e}); demote down LOWERED_DTYPES")
        self.dtype = dtype
        self.refine_steps = refine_steps
        self.rel_residual = rel_residual
        self.gate = gate


def _storage_and_precision(dtype: str):
    """(torch storage dtype, gemm_precision) for a ladder dtype name."""
    if dtype == "bfloat16":
        return torch.bfloat16, "highest"
    if dtype == "bf16x3":
        return torch.float32, "bf16x3"
    if dtype == "float32":
        return torch.float32, "highest"
    raise ValueError(f"unknown lowered dtype {dtype!r}; options: "
                     f"{LOWERED_DTYPES}")


def default_refine_steps(dtype: str) -> int:
    try:
        return DEFAULT_REFINE_STEPS[dtype]
    except KeyError:
        raise ValueError(f"unknown lowered dtype {dtype!r}; options: "
                         f"{LOWERED_DTYPES}") from None


def solve_lowered(a, b, dtype: str = "bfloat16",
                  refine_steps: Optional[int] = None,
                  panel: Optional[int] = None, unroll="auto",
                  gate: float = DEFAULT_GATE, device=None,
                  ) -> Tuple[np.ndarray, object, dict]:
    """One lowered factor and one double-single refinement pass, gated.

    Returns ``(x_float64, factors, info)``; ``info`` holds the dtype, the
    refinement steps that updated before the masked early exit, and the
    final relative residual. Raises :class:`PrecisionNotConvergedError`
    when the budget was not enough: demotion is the caller's move
    (:func:`solve_lowered_auto`), so a direct call measures one
    configuration. ``device``: the card by default, ``"cpu"`` on
    request."""
    from gauss_tpu_torch.core import blocked, dsfloat

    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    n = len(b64)
    storage, gemm_precision = _storage_and_precision(dtype)
    if refine_steps is None:
        refine_steps = default_refine_steps(dtype)
    dev = resolve_device(device)
    itemsize = storage.itemsize
    # The staged operand is owned here and dead after the factor: donate
    # it (panel-multiple shapes only; a padded one is copied anyway).
    donate = n % blocked._resolve_panel(n, panel, itemsize) == 0
    a_dev = torch.as_tensor(a64, dtype=storage, device=dev)
    factor = blocked.resolve_factor(n, unroll, donate=donate, device=dev)
    fac = factor(a_dev, panel=panel, gemm_precision=gemm_precision,
                 device=dev)
    at_ds = dsfloat.to_ds(a64.T, dev)
    b_ds = dsfloat.to_ds(b64, dev)
    x0 = blocked.lu_solve(fac, b_ds.hi)
    x, used = dsfloat.refine_ds(fac, at_ds, b_ds, x0, iters=refine_steps,
                                tol=gate * REFINE_TOL_MARGIN,
                                return_iters=True)
    x64 = dsfloat.ds_to_f64(x)
    used = int(used)
    rel = checks.residual_norm(a64, x64, b64, relative=True)
    obs.emit("precision", dtype=dtype, n=n, refine_steps=used,
             budget=refine_steps, rel_residual=float(f"{rel:.3e}"),
             converged=bool(rel <= gate))
    if not rel <= gate:
        obs.counter("precision.not_converged")
        raise PrecisionNotConvergedError(dtype, used, rel, gate)
    return x64, fac, {"dtype": dtype, "refine_steps": used,
                      "rel_residual": rel}


def lowered_params(n: int) -> Tuple[str, Optional[int]]:
    """The tuned (dtype, refine_steps) starting point for size ``n`` (the
    ``tune`` op ``"lowered"``). The seed is ("float32", None): without a
    store the start is today's float32 path."""
    from gauss_tpu_torch.tune import apply as _tune

    p = _tune.params_for("lowered", n)
    dtype = str(p.get("dtype") or "float32")
    steps = p.get("refine_steps")
    return dtype, (int(steps) if steps else None)


def lowered_enabled(n: int) -> bool:
    """Whether the tuned store starts this size below float32."""
    return lowered_params(n)[0] != "float32"


def solve_lowered_auto(a, b, panel: Optional[int] = None, unroll="auto",
                       gate: float = DEFAULT_GATE, device=None,
                       ) -> Tuple[np.ndarray, object, dict]:
    """The ladder walk: start at the tuned (dtype, refine_steps) pair and
    demote down :data:`LOWERED_DTYPES` on every typed convergence failure.
    Returns ``(x_float64, factors, info)`` with ``info["demoted"]`` set
    when the serving dtype is below the start; re-raises the last
    :class:`PrecisionNotConvergedError` only when even float32 missed the
    gate."""
    tuned_dtype, tuned_steps = lowered_params(np.shape(a)[0])
    start = (LOWERED_DTYPES.index(tuned_dtype)
             if tuned_dtype in LOWERED_DTYPES else len(LOWERED_DTYPES) - 1)
    last_err: Optional[PrecisionNotConvergedError] = None
    for dt in LOWERED_DTYPES[start:]:
        steps = tuned_steps if dt == tuned_dtype else None
        try:
            x64, fac, info = solve_lowered(a, b, dtype=dt,
                                           refine_steps=steps, panel=panel,
                                           unroll=unroll, gate=gate,
                                           device=device)
        except PrecisionNotConvergedError as e:
            last_err = e
            obs.counter("precision.demotions")
            obs.emit("precision", event="demote", from_dtype=dt,
                     rel_residual=float(f"{e.rel_residual:.3e}"))
            continue
        info["demoted"] = dt != tuned_dtype
        if info["demoted"]:
            obs.counter("precision.served_demoted")
        return x64, fac, info
    if last_err is None:
        raise RuntimeError("solve_lowered_auto: the ladder ran no rung")
    raise last_err

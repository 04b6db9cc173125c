"""Out-of-core streamed-solve gate: ``python -m gauss_tpu_torch.outofcore.check``.

Port of ``gauss_tpu/outofcore/check.py``; runs on ``cuda`` unless
``--device cpu`` is given. Runs the host-streamed blocked LU end to end
and asserts the subsystem's three contracts:

- **correctness**: the streamed solve passes the 1e-4 relative-residual
  gate (verified here, by a chunked float64 residual);
- **boundedness**: the device-byte ledger's peak stays under half of the
  full in-core working set (``3 n^2 itemsize``), and the trailing region
  really was tiled (``tiles >= 2``). The giant leg holds the allocator's
  peak over the call (``torch.cuda.max_memory_allocated`` less what was
  allocated before it) to the same bar; the smoke leg prints it but
  cannot hold it: at n=2048 half the working set (24 MiB) is smaller
  than cuBLAS's workspace and the updates' transients, which the
  allocator counts;
- **routing**: an oversized request (budget one byte below the working
  set) reaches the streamed engine through ``solve_handoff`` without an
  engine request, emitting the ``route`` obs event with
  ``lane=outofcore``.

The summary (``--summary-json``) is the JAX package's
(``kind: outofcore_bench``), with the port's stream fields beside. ``--giant
N`` adds the acceptance-scale leg (n=32768 class; ``--giant-ct`` pins its
tile width, which the card's 80 GB budget would otherwise make one tile).

``--history`` appends the run's records to the port's regression history
(``obs.regress``: its own file, each record stamped with the device it
ran on) and ``--regress-check`` gates them against that device's
baselines.

Exit status: 2 when any assertion fails, 1 when ``--regress-check`` finds
an out-of-band metric, 0 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


def _seeded_system(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX check's deterministic diagonally dominant system (float32
    operand, the streamed engine's storage; residuals in float64)."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, n)))
    a = rng.standard_normal((n, n)).astype(np.float32)
    a[np.arange(n), np.arange(n)] += np.float32(n)
    b = rng.standard_normal(n).astype(np.float32)
    return a, b


def _rel_residual(a: np.ndarray, x: np.ndarray, b: np.ndarray) -> float:
    """Chunked float64 relative residual (no full float64 operand copy)."""
    from gauss_tpu_torch.outofcore.stream import _residual_chunked

    b64 = np.asarray(b, dtype=np.float64)
    r = _residual_chunked(a, np.asarray(x, dtype=np.float64)[:, None],
                          b64[:, None])
    return float(np.linalg.norm(r) / max(np.linalg.norm(b64), 1e-300))


def run_streamed(n: int, seed: int, gate: float, panel: Optional[int],
                 chunk: Optional[int], ct: Optional[int], reps: int = 1,
                 device=None, hold_alloc: bool = False) -> Dict:
    """One streamed solve (best of ``reps``); its summary row with the
    StreamStats accounting folded in. ``hold_alloc``: hold the
    allocator's peak to the boundedness bar too."""
    from gauss_tpu_torch import outofcore

    a, b = _seeded_system(n, seed)
    workset = 3 * n * n * a.dtype.itemsize
    best = None
    stats = x = None
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        x = outofcore.solve_outofcore(a, b, panel=panel, chunk=chunk, ct=ct,
                                      device=device, alloc_peak=True)
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best = dt
            stats = outofcore.last_stream_stats()
    rel = _rel_residual(a, x, b)
    peak_frac = stats.peak_device_bytes / workset
    alloc_frac = stats.alloc_peak_device_bytes / workset
    held = max(peak_frac, alloc_frac) if hold_alloc else peak_frac
    return {
        "n": n, "panel": stats.panel, "chunk": stats.chunk, "ct": stats.ct,
        "s_per_solve": round(best, 6),
        "rel_residual": rel,
        "verified": bool(np.isfinite(rel) and rel <= gate),
        "workset_bytes": int(workset),
        "peak_device_frac": round(peak_frac, 6),
        "alloc_peak_device_frac": round(alloc_frac, 6),
        "bounded": bool(held < 0.5),
        "streamed": bool(stats.tiles >= 2),
        **stats.to_dict(),
    }


def run_routing(n: int, seed: int, gate: float, device=None) -> Dict:
    """The handoff leg: a request whose working set exceeds a forced
    budget, submitted WITHOUT an engine request, must stream (the port has
    no multi-device mesh) and verify."""
    from gauss_tpu_torch.core import blocked

    a, b = _seeded_system(n, seed + 1)
    budget = 3 * n * n * a.dtype.itemsize - 1  # one byte short: oversized
    t0 = time.perf_counter()
    x = blocked.solve_handoff(a, b, budget=budget, device=device)
    dt = time.perf_counter() - t0
    rel = _rel_residual(a, x, b)
    return {"n": n, "budget": budget, "s_per_solve": round(dt, 6),
            "rel_residual": rel,
            "verified": bool(np.isfinite(rel) and rel <= gate)}


def history_records(summary: Dict) -> List[Tuple[str, float, str]]:
    """(metric, value, unit) records an out-of-core run contributes to the
    regression history (the JAX package's names), all slow-side gated:
    the streamed solve's seconds, its stall fraction (1 - transfer/compute
    overlap) and the ledger's peak device fraction; the giant leg's
    seconds."""
    out: List[Tuple[str, float, str]] = []
    smoke = summary.get("smoke") or {}
    if isinstance(smoke.get("s_per_solve"), (int, float)):
        out.append(("outofcore:s_per_solve", smoke["s_per_solve"], "s"))
    if isinstance(smoke.get("stall_fraction"), (int, float)):
        out.append(("outofcore:stall_fraction",
                    round(smoke["stall_fraction"], 4), "ratio"))
    if isinstance(smoke.get("peak_device_frac"), (int, float)):
        out.append(("outofcore:peak_device_frac",
                    smoke["peak_device_frac"], "ratio"))
    giant = summary.get("giant") or {}
    if isinstance(giant.get("s_per_solve"), (int, float)):
        out.append((f"outofcore:n{giant['n']}/s_per_solve",
                    giant["s_per_solve"], "s"))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.outofcore.check",
        description="Out-of-core streamed-solve gate: correctness at the "
                    "1e-4 bar, measured peak device bytes bounded under "
                    "half the in-core working set, copy/compute overlap "
                    "reported from obs spans, and solve_handoff routing "
                    "oversized requests to the streamed engine.")
    p.add_argument("--n", type=int, default=2048,
                   help="smoke-leg system size (default 2048)")
    p.add_argument("--panel", type=int, default=None)
    p.add_argument("--chunk", type=int, default=4,
                   help="panels per streamed group for the smoke leg")
    p.add_argument("--ct", type=int, default=256,
                   help="trailing tile width for the smoke leg (small, so "
                        "the pipeline demonstrably streams)")
    p.add_argument("--routing-n", type=int, default=192,
                   help="size of the forced-oversized routing leg")
    p.add_argument("--reps", type=int, default=1)
    p.add_argument("--seed", type=int, default=258458)
    p.add_argument("--gate", type=float, default=1e-4)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the stream runs (default cuda)")
    p.add_argument("--giant", type=int, default=0, metavar="N",
                   help="also run the acceptance-scale leg at this n "
                        "(e.g. 32768; auto window)")
    p.add_argument("--giant-ct", type=int, default=None,
                   help="explicit tile width for the giant leg "
                        "(default: outofcore_window from the budget)")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="append the run's obs JSONL stream here")
    p.add_argument("--summary-json", default=None, metavar="PATH",
                   help="write the summary (kind=outofcore_bench)")
    p.add_argument("--history", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="append this run's records to the regression "
                        "history (default reports/history_torch.jsonl)")
    p.add_argument("--regress-check", action="store_true",
                   help="gate against the history baselines (exit 1 when "
                        "out of band)")
    p.add_argument("--band", type=float, default=1.5,
                   help="slow-side noise band for --regress-check")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from gauss_tpu_torch import obs

    t0 = time.perf_counter()
    with obs.run(metrics_out=args.metrics_out, tool="outofcore_check",
                 seed=args.seed):
        with obs.span("outofcore_check_smoke", n=args.n):
            smoke = run_streamed(args.n, args.seed, args.gate, args.panel,
                                 args.chunk, args.ct, reps=args.reps,
                                 device=args.device)
        with obs.span("outofcore_check_routing", n=args.routing_n):
            routing = run_routing(args.routing_n, args.seed, args.gate,
                                  device=args.device)
        giant = None
        if args.giant:
            with obs.span("outofcore_check_giant", n=args.giant):
                giant = run_streamed(args.giant, args.seed, args.gate,
                                     None, None, args.giant_ct, reps=1,
                                     device=args.device, hold_alloc=True)
    wall = round(time.perf_counter() - t0, 3)

    failures: List[str] = []
    for name, row, need_stream in (("smoke", smoke, True),
                                   ("routing", routing, False),
                                   ("giant", giant, True)):
        if row is None:
            continue
        if not row["verified"]:
            failures.append(f"{name}: rel_residual {row['rel_residual']:.2e}"
                            f" missed the {args.gate:.0e} gate")
        if need_stream and not row.get("bounded", True):
            failures.append(
                f"{name}: peak device bytes {row['peak_device_frac']:.1%} "
                f"(ledger), {row['alloc_peak_device_frac']:.1%} "
                f"(allocator) of the in-core working set (must be < 50%)")
        if need_stream and not row.get("streamed", True):
            failures.append(f"{name}: trailing region was not tiled "
                            f"(tiles={row.get('tiles')})")
    # The routing decision as data: the handoff leg must have emitted
    # lane=outofcore (checked on the recorded stream when one exists).
    if args.metrics_out and os.path.exists(args.metrics_out):
        events = obs.read_events(args.metrics_out)
        lanes = [e.get("lane") for e in events
                 if e.get("type") == "route"
                 and e.get("tool") == "solve_handoff"]
        if "outofcore" not in lanes:
            failures.append(f"routing: no route event with lane=outofcore "
                            f"on the recorded stream (saw {lanes})")

    summary = {"kind": "outofcore_bench", "seed": args.seed,
               "gate": args.gate, "device": args.device, "smoke": smoke,
               "routing": routing, "giant": giant, "wall_s": wall,
               "ok": not failures}

    for name, row in (("smoke", smoke), ("routing", routing),
                      ("giant", giant)):
        if row is None:
            continue
        extra = (f" peak={row['peak_device_frac']:.1%} "
                 f"alloc={row['alloc_peak_device_frac']:.1%} "
                 f"overlap={row['overlap_fraction']:.2f} "
                 f"tiles={row['tiles']}" if "tiles" in row else "")
        print(f"outofcore-check [{name:7s}] n={row['n']:6d} "
              f"s_per_solve={row['s_per_solve']:.3f} "
              f"rel_residual={row['rel_residual']:.2e}{extra} "
              f"{'OK' if row['verified'] else 'FAIL'}")
    print(f"outofcore-check: done in {wall} s"
          + (f"; FAILED: {failures}" if failures
             else f"; all legs verified at the {args.gate:.0e} gate"))

    if args.summary_json:
        parent = os.path.dirname(args.summary_json)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"summary: {args.summary_json}")
    # Run-id-tagged sources: equal values of distinct epochs stay
    # separate baseline samples.
    from gauss_tpu_torch.obs import regress

    records = regress.campaign_records(
        history_records(summary), f"outofcore-{obs.new_run_id()}",
        "outofcore", regress.device_tag(args.device))
    rc = regress.gate(records, args.history, args.regress_check,
                      band=args.band, healthy=not failures)
    return 2 if failures else rc


if __name__ == "__main__":
    sys.exit(main())

"""Structured-solve smoke gate: ``python -m gauss_tpu_torch.structure.check``.
Port of ``gauss_tpu/structure/check.py``; runs on ``cuda`` unless
``--device cpu`` is given.

Runs detect -> route -> engine -> verify end to end for every structure
class the router knows (SPD, banded, block-diagonal, dense), on the
deterministic generators of ``io.synthetic``, and asserts:

- the detector classifies each generator into its class;
- ``solve_auto`` routes to the class's engine WITHOUT demotion;
- every solution passes the 1e-4 relative-residual gate (verified here,
  independently of the ladder's own gate).

The summary (``--summary-json``) is regress-ingestable
(``kind: structured_solve``): per class, seconds per solve and the
structured engine's FLOP ratio vs dense LU (structured / dense — LOWER is
better, so the slow-side sentinel gates a routing regression exactly like
a perf regression: a class silently demoting to LU shows up as
flops_ratio jumping to 1.0). ``--metrics-out PATH`` appends the run's
obs stream.

``--history`` appends the run's records to the port's regression history
(``obs.regress``: its own file, each record stamped with the device it
ran on) and ``--regress-check`` gates them against that device's
baselines.

Exit status: 2 when any class fails verification or routes to the wrong
engine, 1 when ``--regress-check`` finds an out-of-band metric, 0
otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Tuple

import numpy as np


def dense_lu_flops(n: int) -> float:
    """The general path's factor cost: ~2/3 n^3."""
    return (2.0 / 3.0) * n ** 3


def structured_flops(kind: str, n: int, bandwidth: int = 1,
                     block: int = 32) -> float:
    """The structured engine's factor cost model per class: Cholesky
    ~n^3/3, band LU ~3 n b^2, block-diagonal ~(n/s) * 2/3 s^3."""
    if kind == "spd":
        return n ** 3 / 3.0
    if kind == "banded":
        return 3.0 * n * max(1, bandwidth) ** 2
    if kind == "blockdiag":
        nb = -(-n // block)
        return nb * (2.0 / 3.0) * block ** 3
    return dense_lu_flops(n)


def run_class(kind: str, a: np.ndarray, seed: int, gate: float,
              repeats: int, device=None) -> Dict:
    """Solve one class's system ``repeats`` times through solve_auto on
    ``device``; returns its summary row (best wall-clock, engine,
    residual)."""
    from gauss_tpu_torch.structure import detect_structure, solve_auto
    from gauss_tpu_torch.structure.router import ENGINE_FOR_TAG
    from gauss_tpu_torch.verify import checks

    n = a.shape[0]
    rng = np.random.default_rng(np.random.SeedSequence((seed, n)))
    b = rng.standard_normal(n)
    info = detect_structure(a)
    best = None
    res = None
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        res = solve_auto(a, b, info=info, gate=gate, device=device)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    rel = checks.residual_norm(a, res.x, b, relative=True)
    return {
        "n": n, "detected": info.kind, "expected": kind,
        "engine": res.rung, "demoted": bool(res.rung_index > 0),
        "s_per_solve": round(best, 6),
        "rel_residual": float(rel),
        "verified": bool(np.isfinite(rel) and rel <= gate),
        "routed_ok": (info.kind == kind
                      and res.rung == ENGINE_FOR_TAG[kind]),
        "bandwidth": info.bandwidth, "blocks": len(info.blocks),
        "flops_ratio": round(
            structured_flops(kind, n, info.bandwidth,
                             max(info.blocks) if info.blocks else n)
            / dense_lu_flops(n), 6),
    }


def history_records(summary: Dict) -> List[Tuple[str, float, str]]:
    """(metric, value, unit) records for the regression history (the JAX
    package's names): s_per_solve and the flops ratio per class, both
    slow-side gated (a class demoting to dense LU raises both)."""
    out: List[Tuple[str, float, str]] = []
    for kind, row in (summary.get("classes") or {}).items():
        if isinstance(row.get("s_per_solve"), (int, float)):
            out.append((f"structure:{kind}/s_per_solve",
                        row["s_per_solve"], "s"))
        if isinstance(row.get("flops_ratio"), (int, float)):
            out.append((f"structure:{kind}/flops_ratio",
                        row["flops_ratio"], "ratio"))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.structure.check",
        description="Structured-solve smoke gate: detect -> route -> "
                    "engine -> 1e-4 verify across all four structure "
                    "classes.")
    p.add_argument("--spd-n", type=int, default=96)
    p.add_argument("--banded-n", type=int, default=512)
    p.add_argument("--banded-bw", type=int, default=1)
    p.add_argument("--blockdiag-n", type=int, default=96)
    p.add_argument("--block", type=int, default=16,
                   help="block size for the block-diagonal class")
    p.add_argument("--dense-n", type=int, default=96)
    p.add_argument("--repeats", type=int, default=3,
                   help="timed solves per class (best-of; the first rep "
                        "pays the jit compile, so >= 2 is meaningful)")
    p.add_argument("--seed", type=int, default=258458)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the engines run (default cuda)")
    p.add_argument("--gate", type=float, default=1e-4)
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="append the run's obs JSONL stream here")
    p.add_argument("--summary-json", default=None, metavar="PATH",
                   help="write the regress-ingestable summary "
                        "(kind=structured_solve)")
    p.add_argument("--history", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="append this run's records to the regression "
                        "history (default reports/history_torch.jsonl)")
    p.add_argument("--regress-check", action="store_true",
                   help="gate against the history baselines (exit 1 when "
                        "out of band)")
    p.add_argument("--band", type=float, default=1.5,
                   help="slow-side noise band for --regress-check "
                        "(default 1.5: the smoke's per-class timings are "
                        "millisecond-scale CPU numbers — jittery — while "
                        "the regressions this gate exists for, a class "
                        "demoting to dense LU, move s_per_solve and "
                        "flops_ratio by orders of magnitude)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.cli._common import metrics_run
    from gauss_tpu_torch.io import synthetic

    systems = {
        "spd": synthetic.spd_matrix(args.spd_n),
        "banded": synthetic.banded_matrix(args.banded_n, args.banded_bw),
        "blockdiag": synthetic.blockdiag_matrix(args.blockdiag_n,
                                                args.block),
        "dense": synthetic.dense_matrix(args.dense_n),
    }
    t0 = time.perf_counter()
    classes: Dict[str, Dict] = {}
    with metrics_run(args, "structure_check", seed=args.seed):
        for kind, a in systems.items():
            with obs.span(f"structure_check_{kind}", n=a.shape[0]):
                classes[kind] = run_class(kind, a, args.seed, args.gate,
                                          args.repeats, args.device)
    wall = round(time.perf_counter() - t0, 3)
    bad = [k for k, row in classes.items()
           if not (row["verified"] and row["routed_ok"])]
    summary = {"kind": "structured_solve", "seed": args.seed,
               "gate": args.gate, "device": args.device,
               "classes": classes, "wall_s": wall, "ok": not bad}

    for kind, row in classes.items():
        print(f"structure-check [{kind:9s}] n={row['n']:5d} detected="
              f"{row['detected']:9s} engine={row['engine']:9s} "
              f"s_per_solve={row['s_per_solve']:.4f} "
              f"flops_ratio={row['flops_ratio']:.4f} "
              f"rel_residual={row['rel_residual']:.2e} "
              f"{'OK' if row['verified'] and row['routed_ok'] else 'FAIL'}")
    print(f"structure-check: {len(classes)} class(es) in {wall} s"
          + (f"; FAILED: {bad}" if bad else "; all verified at the "
             f"{args.gate:.0e} gate"))

    if args.summary_json:
        parent = os.path.dirname(args.summary_json)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"summary: {args.summary_json}")
    # Run-id-tagged sources: identical values from distinct epochs (the
    # flops ratios are deterministic) stay separate baseline samples.
    from gauss_tpu_torch.obs import regress

    records = regress.campaign_records(
        history_records(summary), f"structure-{obs.new_run_id()}",
        "structure", regress.device_tag(args.device))
    rc = regress.gate(records, args.history, args.regress_check,
                      band=args.band, healthy=not bad)
    return 2 if bad else rc


if __name__ == "__main__":
    sys.exit(main())

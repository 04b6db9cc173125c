#!/usr/bin/env python3
"""The solver service's end-to-end figures on the card, for one checkout:
``chip_smoke.py`` phase 9 (c)'s load run alone.

    python3 scripts/probe_service.py [--root DIR] [--requests 120]

Imports ``gauss_tpu_torch`` from the checkout at ``--root`` (default: this
one; another checkout, for example a parent commit unpacked beside it,
compares two versions on one card: run parent, change, change, parent,
each in its own process), builds its kernels, and drives a
``SolverServer`` at phase 9 (c)'s configuration (this checkout's
``chip_smoke.py`` constants: the ladder 128-4096, batch 8, one refinement
step, cache 32, the 1e-4 verify gate, structure-aware) with
``loadgen.run_load`` closed-loop on SERVE_MIX (16 warm-up requests, then
``--requests``, 8 clients, seed 258458). Every request must be ``ok``.
Prints one JSON line: solves/s, p50 and p99 in seconds, the batches, the
batched fused launches by phase-A route where the checkout counts them,
and the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _smoke():
    """This checkout's ``chip_smoke.py``, loaded by path so that the
    constants are the same whichever checkout ``--root`` names."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--requests", type=int, default=None,
                    help="measured requests (default: SERVE_REQUESTS)")
    args = ap.parse_args(argv)
    c = _smoke()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.serve import ServeConfig, SolverServer, loadgen

    _build.build_all()
    cfg = ServeConfig(ladder=c.SERVE_LADDER, max_batch=c.SERVE_BATCH,
                      refine_steps=c.SERVE_REFINE, cache_capacity=32,
                      verify_gate=c.GATE, structure_aware=True,
                      device="cuda")
    requests = args.requests or c.SERVE_REQUESTS
    lcfg = loadgen.LoadgenConfig(
        mix=c.SERVE_MIX, requests=requests, warmup=c.SERVE_WARMUP,
        concurrency=c.SERVE_CONCURRENCY, seed=c.SEED, serve=cfg)
    with SolverServer(cfg) as server:
        _build.reset_launches()
        summary = loadgen.run_load(server, lcfg)
        torch.cuda.synchronize()
    counts = summary["counts"]
    if counts["ok"] != requests or summary["incorrect"]:
        print(f"probe: service {counts}, {summary['incorrect']} incorrect",
              file=sys.stderr)
        return 1
    lat = summary["latency_s"]
    print(json.dumps({
        "root": str(root), "requests": requests,
        "solves_per_s": summary["throughput_rps"], "p50_s": lat["p50"],
        "p99_s": lat["p99"], "batches": summary["batches"],
        "batched_fused_routes": {
            k: v for k, v in getattr(_build, "ROUTE_LAUNCHES", {}).items()
            if k.startswith("panel_trailing_fused_batched")} or None,
        "card": c.smi_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

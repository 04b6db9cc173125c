"""Sparse-plane smoke gate: ``python -m gauss_tpu_torch.sparse.check``.
Port of ``gauss_tpu/sparse/check.py``.

Two legs, both on the deterministic generator ``io.synthetic.sparse_coords``:

- **smoke** (n ~ 640): the coordinate stream classifies ``sparse``
  (``detect_structure_coords``), ``solve_auto`` routes it to the CG rung
  (the ``routed`` line prints the engine that served it), and each Krylov
  method — CG, GMRES,
  BiCGStab — solves the same system to the 1e-4 relative-residual gate
  (verified here with a TRUE residual, independently of the solvers' own
  convergence tests).

- **giant** (n = 100,000, ~20 nnz/row): the headline of the sparse plane
  — the system is assembled, preconditioned, and CG-solved to 1e-4
  WITHOUT ever allocating an n x n buffer. Enforced, not asserted by
  inspection: the host memory the leg adds (its peak RSS over the RSS at
  its start) and, on the card, the peak device memory
  (``torch.cuda.max_memory_allocated``) must each stay under a budget that
  the dense matrix alone (8 n^2 bytes = 80 GB) exceeds tenfold. A change
  that quietly densifies anywhere on the path cannot pass this leg. (The
  JAX package budgets the process's lifetime peak RSS. A CUDA build of
  torch can map more than the whole budget at import, before any leg
  runs, so the port measures what the leg itself adds: see
  :class:`_LegRss`.)

Runs on ``cuda`` unless ``--device cpu`` is given. ``--summary-json``
writes the per-method seconds-per-solve and iteration counts plus the
giant leg's wall time and peak bytes (``kind: sparse_solve``).

``--metrics-out PATH`` appends the run's ``obs`` stream: the
``sparse_check_smoke`` and ``sparse_check_giant`` spans, a
``sparse_solve`` event per solve and the ``sparse.solves`` counter.

``--history`` appends the run's records to the port's regression history
(``obs.regress``: its own file, each record stamped with the device it
ran on) and ``--regress-check`` gates them against that device's
baselines, with the slow-side band ``--band``.

Exit status: 2 when any leg fails verification/classification/memory, 1
when ``--regress-check`` finds an out-of-band metric, 0 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Dict, List, Tuple

import numpy as np

#: giant-leg peak budget (bytes), held on the host RSS the leg adds and on
#: the device's peak allocation.
#: The point is the ORDER: the dense operand alone costs 8 n^2 = 80 GB at
#: n = 100,000 — at least 10x this budget (asserted) — so fitting under it
#: proves no densification.
PEAK_BUDGET_BYTES = 4 << 30


def _peak_rss_bytes() -> int:
    """Lifetime peak RSS of this process. ru_maxrss is KiB on Linux,
    bytes on macOS."""
    import resource

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return int(peak) if sys.platform == "darwin" else int(peak) * 1024


def _rss_bytes() -> int:
    """Current RSS of this process (``/proc/self/statm``); where there is
    no procfs, the lifetime peak stands in."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return _peak_rss_bytes()


class _LegRss:
    """Peak RSS over a ``with`` block: ``start`` (RSS on entry) and
    ``peak`` (the highest seen until exit). A thread samples the current
    RSS every ``interval`` seconds (numpy releases the interpreter lock in
    the large operations that move RSS); where the block raised the
    process's lifetime peak, that exact figure is taken instead."""

    def __init__(self, interval: float = 0.005):
        self.interval = interval
        self.start = self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self):
        while not self._stop.wait(self.interval):
            self.peak = max(self.peak, _rss_bytes())

    def __enter__(self):
        self._lifetime = _peak_rss_bytes()
        self.start = self.peak = _rss_bytes()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())
        lifetime = _peak_rss_bytes()
        if lifetime > self._lifetime:
            self.peak = max(self.peak, lifetime)
        return False


def _true_rel(a, x, b) -> float:
    return float(np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b))


def run_smoke(n: int, nnz_per_row: int, seed: int, gate: float,
              repeats: int, device=None) -> Tuple[Dict, Dict[str, Dict]]:
    """The small-n leg: coordinate classification + routing + all three
    Krylov methods at the gate. Returns (routed_row, per_method_rows)."""
    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.sparse import solve_sparse
    from gauss_tpu_torch.sparse.csr import CsrMatrix
    from gauss_tpu_torch.structure import solve_auto
    from gauss_tpu_torch.structure.detect import detect_structure_coords

    rows, cols, vals = synthetic.sparse_coords(n, nnz_per_row, seed=seed)
    a = CsrMatrix.from_coords(n, rows, cols, vals)
    rng = np.random.default_rng(np.random.SeedSequence((seed, n)))
    b = rng.standard_normal(n)

    info = detect_structure_coords(n, rows, cols, vals)
    res = solve_auto(a.to_dense(), b, info=info, gate=gate, device=device)
    rel = _true_rel(a, res.x, b)
    routed = {
        "n": n, "nnz": a.nnz, "detected": info.kind, "engine": res.rung,
        "demoted": bool(res.rung_index > 0),
        "certified_spd": bool(info.spd_likely),
        "rel_residual": rel,
        "verified": bool(np.isfinite(rel) and rel <= gate),
        "routed_ok": info.kind == "sparse" and res.rung == "cg",
    }

    methods: Dict[str, Dict] = {}
    for method in ("cg", "gmres", "bicgstab"):
        best = None
        out = None
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            out = solve_sparse(a, b, method=method, gate=gate, device=device)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        true_rel = _true_rel(a, out.x, b)
        methods[method] = {
            "n": n, "nnz": a.nnz, "precond": out.precond,
            "iterations": int(out.iterations),
            "s_per_solve": round(best, 6),
            "rel_residual": true_rel,
            "verified": bool(np.isfinite(true_rel) and true_rel <= gate),
        }
    return routed, methods


def run_giant(n: int, nnz_per_row: int, seed: int, gate: float,
              device=None) -> Dict:
    """The no-densify leg: assemble + CG-solve an n = 100k system to the
    gate with the host memory the leg adds, and the device's peak
    allocation, each held under PEAK_BUDGET_BYTES."""
    import torch

    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.sparse import solve_sparse
    from gauss_tpu_torch.sparse.csr import CsrMatrix
    from gauss_tpu_torch.utils.device import resolve_device

    on_card = resolve_device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with _LegRss() as rss:
        t0 = time.perf_counter()
        rows, cols, vals = synthetic.sparse_coords(n, nnz_per_row, seed=seed)
        a = CsrMatrix.from_coords(n, rows, cols, vals)
        t_assembled = time.perf_counter()
        rng = np.random.default_rng(np.random.SeedSequence((seed, n)))
        b = rng.standard_normal(n)
        out = solve_sparse(a, b, method="cg", precond="jacobi", gate=gate,
                           device=device)
        wall = time.perf_counter() - t0
        true_rel = _true_rel(a, out.x, b)
    added = rss.peak - rss.start
    device_peak = int(torch.cuda.max_memory_allocated()) if on_card else None
    dense_bytes = 8 * n * n
    return {
        "n": n, "nnz": a.nnz, "density": a.density,
        "ell_shape": [a.n, max(a.max_row_nnz, 1)],
        "method": out.method, "precond": out.precond,
        "iterations": int(out.iterations),
        "s_per_solve": round(wall, 6),
        "assembly_s": round(t_assembled - t0, 6),
        "rel_residual": true_rel,
        "verified": bool(np.isfinite(true_rel) and true_rel <= gate),
        "peak_rss_bytes": rss.peak,
        "rss_at_start_bytes": rss.start,
        "host_added_bytes": added,
        "device_peak_bytes": device_peak,
        "peak_budget_bytes": PEAK_BUDGET_BYTES,
        "dense_bytes": dense_bytes,
        # The leg's whole point, as data: the budget held (host and
        # device) AND the budget is small against the densified operand
        # (>= 10x margin).
        "no_densify_ok": bool(added <= PEAK_BUDGET_BYTES
                              and (device_peak or 0) <= PEAK_BUDGET_BYTES
                              and dense_bytes >= 10 * PEAK_BUDGET_BYTES),
    }


def history_records(summary: Dict) -> List[Tuple[str, float, str]]:
    """(metric, value, unit) records for the regression history (the JAX
    package's names): per-method seconds per solve and iteration counts,
    the giant leg's wall time and peak bytes; all slow-side gated."""
    out: List[Tuple[str, float, str]] = []
    for method, row in (summary.get("methods") or {}).items():
        if isinstance(row.get("s_per_solve"), (int, float)):
            out.append((f"sparse:{method}/s_per_solve",
                        row["s_per_solve"], "s"))
        if isinstance(row.get("iterations"), (int, float)):
            out.append((f"sparse:{method}/iterations",
                        float(row["iterations"]), "count"))
    giant = summary.get("giant") or {}
    if isinstance(giant.get("s_per_solve"), (int, float)):
        out.append(("sparse:giant/s_per_solve",
                    giant["s_per_solve"], "s"))
    if isinstance(giant.get("peak_rss_bytes"), (int, float)):
        out.append(("sparse:giant/peak_rss_bytes",
                    float(giant["peak_rss_bytes"]), "bytes"))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.sparse.check",
        description="Sparse-plane smoke gate: coordinate classification, "
                    "CG/GMRES/BiCGStab at the 1e-4 gate, and the n=100k "
                    "no-densify leg.")
    p.add_argument("--smoke-n", type=int, default=640)
    p.add_argument("--giant-n", type=int, default=100_000)
    p.add_argument("--nnz-per-row", type=int, default=6,
                   help="stored entries per row for the smoke leg")
    p.add_argument("--giant-nnz-per-row", type=int, default=20,
                   help="stored entries per row for the giant leg")
    p.add_argument("--skip-giant", action="store_true",
                   help="smoke legs only (developer loop)")
    p.add_argument("--repeats", type=int, default=3,
                   help="timed solves per method (best-of; on the card the "
                        "first rep builds and loads the kernel, so >= 2 is "
                        "meaningful)")
    p.add_argument("--seed", type=int, default=258458)
    p.add_argument("--gate", type=float, default=1e-4)
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="append the run's obs JSONL stream here")
    p.add_argument("--summary-json", default=None, metavar="PATH",
                   help="write the summary (kind=sparse_solve)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the solves run (default cuda; cpu runs the "
                        "kernel's plain version)")
    p.add_argument("--history", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="append this run's records to the regression "
                        "history (default reports/history_torch.jsonl)")
    p.add_argument("--regress-check", action="store_true",
                   help="gate against the history baselines (exit 1 when "
                        "out of band)")
    p.add_argument("--band", type=float, default=1.5,
                   help="slow-side noise band for --regress-check "
                        "(default 1.5: millisecond-scale timings are "
                        "jittery, while the regressions this gate exists "
                        "for — densification, a preconditioner losing its "
                        "bite — move the metrics by orders of magnitude)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.cli._common import metrics_run

    t0 = time.perf_counter()
    with metrics_run(args, "sparse_check", seed=args.seed):
        with obs.span("sparse_check_smoke", n=args.smoke_n):
            routed, methods = run_smoke(args.smoke_n, args.nnz_per_row,
                                        args.seed, args.gate, args.repeats,
                                        args.device)
        giant = None
        if not args.skip_giant:
            with obs.span("sparse_check_giant", n=args.giant_n):
                giant = run_giant(args.giant_n, args.giant_nnz_per_row,
                                  args.seed, args.gate, args.device)
    wall = round(time.perf_counter() - t0, 3)

    bad: List[str] = []
    if not (routed["verified"] and routed["routed_ok"]):
        bad.append("routed")
    bad.extend(m for m, row in methods.items() if not row["verified"])
    if giant is not None and not (giant["verified"]
                                  and giant["no_densify_ok"]):
        bad.append("giant")
    summary = {"kind": "sparse_solve", "seed": args.seed,
               "gate": args.gate, "device": args.device, "routed": routed,
               "methods": methods, "giant": giant, "wall_s": wall,
               "ok": not bad}

    routed_ok = routed["verified"] and routed["routed_ok"]
    print(f"sparse-check [routed   ] n={routed['n']:6d} detected="
          f"{routed['detected']:7s} engine={routed['engine']:9s} "
          f"rel_residual={routed['rel_residual']:.2e} "
          f"certified_spd={routed['certified_spd']} "
          f"{'OK' if routed_ok else 'FAIL'}")
    for method, row in methods.items():
        print(f"sparse-check [{method:9s}] n={row['n']:6d} "
              f"precond={row['precond']:7s} iters={row['iterations']:4d} "
              f"s_per_solve={row['s_per_solve']:.4f} "
              f"rel_residual={row['rel_residual']:.2e} "
              f"{'OK' if row['verified'] else 'FAIL'}")
    if giant is not None:
        dev_peak = ("" if giant["device_peak_bytes"] is None else
                    f"device_peak={giant['device_peak_bytes'] / 2**30:.2f} "
                    f"GiB ")
        print(f"sparse-check [giant    ] n={giant['n']:6d} "
              f"nnz={giant['nnz']} iters={giant['iterations']:4d} "
              f"s_per_solve={giant['s_per_solve']:.4f} "
              f"rel_residual={giant['rel_residual']:.2e} "
              f"peak_rss={giant['peak_rss_bytes'] / 2**30:.2f} GiB "
              f"(+{giant['host_added_bytes'] / 2**30:.2f} GiB over the "
              f"leg's start) {dev_peak}"
              f"(budget {giant['peak_budget_bytes'] / 2**30:.0f} GiB, "
              f"dense would be {giant['dense_bytes'] / 2**30:.0f} GiB) "
              f"{'OK' if giant['verified'] and giant['no_densify_ok'] else 'FAIL'}")
    print(f"sparse-check: {len(methods) + 1 + (giant is not None)} leg(s) "
          f"in {wall} s on {args.device}"
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
    # iteration counts are deterministic) stay separate baseline samples.
    from gauss_tpu_torch.obs import regress

    records = regress.campaign_records(
        history_records(summary), f"sparse-{obs.new_run_id()}", "sparse",
        regress.device_tag(args.device))
    rc = regress.gate(records, args.history, args.regress_check,
                      band=args.band, healthy=not bad)
    return 2 if bad else rc


if __name__ == "__main__":
    sys.exit(main())

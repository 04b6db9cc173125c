"""ABFT campaign runner: ``python -m gauss_tpu_torch.resilience.abftcheck``.

Port of ``gauss_tpu/resilience/abftcheck.py``; runs on ``cuda`` unless
``--device cpu`` is given. Sweeps seeded on-device ``sdc_bitflip`` faults
(:mod:`gauss_tpu_torch.resilience.inject`) across the checksum-carrying LU
and Cholesky engines (:mod:`gauss_tpu_torch.resilience.abft`) and asserts
the SDC invariant:

    every injected on-device corruption is DETECTED by the checksum
    invariant before the final residual gate, LOCALIZED to the panel group
    that produced it, and repaired — by the localized replay for transient
    faults (bit for bit an uninterrupted ABFT run) or by escalation
    through the recovery ladder for persistent ones — and the runner
    verifies every solution at the 1e-4 gate itself.

Three phases:

- **sdc** (``--cases``): each case draws an engine (LU / Cholesky), a
  size, a panel group and a transient-or-persistent scenario from a
  seeded catalog, installs an ``sdc_bitflip`` plan at the engine's ABFT
  group site, and runs ``recover.solve_resilient`` with ABFT on.
- **identity** (``--no-identity`` to skip): ``abft=False`` paths give the
  bits of the checksum-carrying forms (the checksum is a rider, never an
  operand) across the flat, chunked, host-stepped LU and Cholesky forms;
  the plain and protected seconds per solve are recorded.
- **matmul** (``--no-matmul`` to skip): single-element GEMM corruption is
  localized and corrected in place; wider corruption is recomputed.

The summary (``--summary-json``, ``kind: abft_campaign``) has the JAX
package's keys. ``--history`` appends the campaign's records to the
port's regression history (``obs.regress``: its own file, each record
stamped with the device it ran on) and ``--regress-check`` gates them
against that device's baselines. Exit status: 2 when the invariant is
violated (missed detection, silent wrong answer, bit-identity failure), 1
when ``--regress-check`` finds an out-of-band metric, 0 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

#: scenario catalog: transient dominates ~11:1 (real SDC is overwhelmingly
#: one-shot; the persistent slice proves the escalate-to-ladder path).
SCENARIOS = (("transient", 11), ("persistent", 1))

#: default sweep sizes: the LU rung path (panel 16, the ladder's
#: CHUNK_DEFAULT grouping) has >= 2 panel groups to localize across.
LU_SIZES = (96, 128)
CHOL_SIZES = (64, 96)


def _lu_groups(n: int, panel: int) -> int:
    from gauss_tpu_torch.core import blocked

    nb = -(-n // panel)
    return -(-nb // blocked.CHUNK_DEFAULT)


def _system_lu(rng: np.random.Generator, n: int):
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    return a, rng.standard_normal(n)


def _system_chol(rng: np.random.Generator, n: int):
    from gauss_tpu_torch.io import synthetic

    return np.asarray(synthetic.spd_matrix(n)), rng.standard_normal(n)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_sdc_case(i: int, seed: int, gate: float, panel: int = 16,
                 lu_sizes=LU_SIZES, chol_sizes=CHOL_SIZES,
                 clean_cache: Optional[dict] = None, device=None) -> Dict:
    """One seeded on-device SDC case on ``device``; returns its outcome
    record. Shared with the chaos campaign's sdc phase."""
    from gauss_tpu_torch.resilience import abft, inject, recover
    from gauss_tpu_torch.verify import checks

    rng = np.random.default_rng(np.random.SeedSequence((seed, 0xABF7, i)))
    engine = ("lu", "chol")[i % 2]
    names = [s for s, w in SCENARIOS for _ in range(w)]
    scenario = names[int(rng.integers(0, len(names)))]
    if engine == "lu":
        n = int(lu_sizes[int(rng.integers(0, len(lu_sizes)))])
        a, b = _system_lu(np.random.default_rng(
            np.random.SeedSequence((seed, 0, n))), n)
        groups = _lu_groups(n, panel)
        site = abft.SITE_LU
        rungs = None
    else:
        n = int(chol_sizes[int(rng.integers(0, len(chol_sizes)))])
        a, b = _system_chol(np.random.default_rng(
            np.random.SeedSequence((seed, 1, n))), n)
        groups = -(-n // panel)
        site = abft.SITE_CHOL
        rungs = recover.structured_rungs("spd", abft=True)
    group = int(rng.integers(0, groups))

    def solve():
        if rungs is None:
            return recover.solve_resilient(a, b, gate=gate, panel=panel,
                                           abft=True, device=device)
        return recover.solve_resilient(a, b, gate=gate, panel=panel,
                                       rungs=rungs, device=device)

    # The unfaulted ABFT solve of this system: the bit-identity reference
    # of replay recovery (cached per (engine, n)).
    key = (engine, n)
    if clean_cache is None:
        clean_cache = {}
    if key not in clean_cache:
        clean_cache[key] = solve().x
    clean_x = clean_cache[key]

    spec = inject.FaultSpec(
        site=site, kind="sdc_bitflip", skip=group, seed=i,
        max_triggers=1 if scenario == "transient" else None)
    out = {"case": i, "engine": engine, "n": n, "scenario": scenario,
           "group": group}
    with inject.plan(inject.FaultPlan([spec], seed=seed)) as ap:
        try:
            res = solve()
            rel = checks.residual_norm(a, res.x, b, relative=True)
            sdc = res.sdc or {}
            detected = bool(sdc.get("detections"))
            if not (np.isfinite(rel) and rel <= gate):
                out.update(outcome="silent_wrong", rung=res.rung,
                           rel_residual=float(rel), detected=detected)
            elif res.rung_index == 0 and detected:
                out.update(outcome="replayed", rung=res.rung,
                           detected=True, replays=sdc.get("replays"),
                           detect_groups=sdc.get("detect_groups"),
                           localized=group in (sdc.get("detect_groups")
                                               or []),
                           detect_latency_s=sdc.get("detect_latency_s"),
                           bit_identical=bool(np.array_equal(res.x,
                                                             clean_x)),
                           rel_residual=float(rel))
            elif res.rung_index > 0:
                out.update(outcome="escalated", rung=res.rung,
                           detected=detected, rel_residual=float(rel))
            else:
                out.update(outcome="missed" if ap.stats()["triggered"]
                           else "no_fault", rung=res.rung,
                           detected=detected, rel_residual=float(rel))
        except recover.UnrecoverableSolveError as e:
            out.update(outcome="typed_error", trigger=e.trigger,
                       detected=True)
        except Exception as e:  # noqa: BLE001 — an untyped escape IS the bug
            from gauss_tpu_torch.kernels._build import is_kernel_fault

            if is_kernel_fault(e):
                raise
            out.update(outcome="violation",
                       error=f"{type(e).__name__}: {e}"[:200])
        out["injected"] = ap.stats()["triggered"]
    return out


def summarize_sdc_cases(outcomes: List[Dict], wall_s: float) -> Dict:
    counts: Dict[str, int] = {}
    by_engine: Dict[str, int] = {}
    injected = 0
    missed = 0
    bit_fail = 0
    mislocalized = 0
    lats: List[float] = []
    for o in outcomes:
        counts[o["outcome"]] = counts.get(o["outcome"], 0) + 1
        injected += o.get("injected", 0)
        if o.get("injected") and not o.get("detected"):
            missed += 1
        if o["outcome"] == "replayed":
            by_engine[o["engine"]] = by_engine.get(o["engine"], 0) + 1
            if not o.get("bit_identical"):
                bit_fail += 1
            if not o.get("localized"):
                mislocalized += 1
            lats.extend(o.get("detect_latency_s") or [])
    replayed = counts.get("replayed", 0)
    escalated = counts.get("escalated", 0)
    faulted = sum(1 for o in outcomes if o.get("injected"))
    violations = (counts.get("silent_wrong", 0)
                  + counts.get("violation", 0) + missed + bit_fail)
    return {
        "cases": len(outcomes), "counts": counts, "injected": injected,
        "faulted_cases": faulted, "missed": missed,
        "detect_rate": round((faulted - missed) / faulted, 4)
        if faulted else None,
        "replayed": replayed, "escalated": escalated,
        "replay_rate": round(replayed / (replayed + escalated), 4)
        if replayed + escalated else None,
        "replayed_by_engine": by_engine,
        "bit_identity_failures": bit_fail,
        "mislocalized": mislocalized,
        "mean_detect_latency_s": round(float(np.mean(lats)), 6)
        if lats else None,
        "violations": violations, "wall_s": round(wall_s, 3),
    }


def run_sdc_phase(cases: int, seed: int, gate: float, panel: int = 16,
                  log=print, device=None) -> Dict:
    from gauss_tpu_torch import obs

    outcomes: List[Dict] = []
    clean_cache: dict = {}
    t0 = time.perf_counter()
    with obs.span("abft_sdc_phase", cases=cases):
        for i in range(cases):
            outcomes.append(run_sdc_case(i, seed, gate, panel=panel,
                                         clean_cache=clean_cache,
                                         device=device))
            if (i + 1) % 25 == 0:
                log(f"  sdc cases: {i + 1}/{cases}")
    return summarize_sdc_cases(outcomes, time.perf_counter() - t0)


def run_identity_phase(seed: int, reps: int = 3, device=None) -> Dict:
    """The rider contract: ``abft=False`` output equals the
    checksum-carrying forms' factor bit for bit; the plain and protected
    paths' seconds per factorization are recorded."""
    import torch

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.resilience import abft
    from gauss_tpu_torch.structure import cholesky
    from gauss_tpu_torch.utils.device import as_tensor, resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence((seed, 0x1DE47)))
    n = 96
    a, _ = _system_lu(rng, n)
    a32 = as_tensor(a, dev)
    mismatches: List[str] = []

    def cmp(tag, f0, f1, fields):
        for f in fields:
            if not torch.equal(getattr(f0, f), getattr(f1, f)):
                mismatches.append(f"{tag}.{f}")

    with obs.span("abft_identity_phase"):
        lu_fields = ("m", "perm", "min_abs_pivot", "linv", "uinv")
        cmp("flat", blocked.lu_factor_blocked(a32, panel=16, device=dev),
            blocked.lu_factor_blocked(a32, panel=16, abft=True, device=dev),
            lu_fields)
        ck0 = blocked.lu_factor_blocked_chunked(a32, panel=16, chunk=2,
                                                device=dev)
        cmp("chunked", ck0,
            blocked.lu_factor_blocked_chunked(a32, panel=16, chunk=2,
                                              abft=True, device=dev),
            lu_fields)
        stepped, _ = abft.lu_factor_abft(a32, panel=16, chunk=2, device=dev)
        cmp("stepped", ck0, stepped, lu_fields)
        aspd = as_tensor(synthetic.spd_matrix(n), dev)
        ch0 = cholesky.cholesky_factor_blocked(aspd, panel=16, device=dev)
        cmp("chol_flat", ch0,
            cholesky.cholesky_factor_blocked(aspd, panel=16, abft=True,
                                             device=dev),
            ("m", "linv", "min_diag"))
        ch_stepped, _ = abft.cholesky_factor_abft(aspd, panel=16,
                                                  device=dev)
        cmp("chol_stepped", ch0, ch_stepped, ("m", "linv", "min_diag"))

        def best_of(fn):
            fn()  # warm-up outside the timed reps
            best = float("inf")
            for _ in range(reps):
                _sync(dev)
                t0 = time.perf_counter()
                fn()
                _sync(dev)
                best = min(best, time.perf_counter() - t0)
            return best

        plain_s = best_of(lambda: blocked.lu_factor_blocked_chunked(
            a32, panel=16, chunk=2, device=dev))
        abft_s = best_of(lambda: abft.lu_factor_abft(a32, panel=16, chunk=2,
                                                     device=dev))
    return {
        "ran": True, "n": n, "bit_identical": not mismatches,
        "mismatches": mismatches,
        "plain_s_per_solve": round(plain_s, 6),
        "abft_s_per_solve": round(abft_s, 6),
        "overhead_ratio": round(abft_s / plain_s, 4) if plain_s else None,
    }


def run_matmul_phase(cases: int, seed: int, device=None) -> Dict:
    import torch

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.resilience import abft, inject

    rng = np.random.default_rng(np.random.SeedSequence((seed, 0x3A73)))
    corrected = recomputed = detections = 0
    max_dev = 0.0
    violations = 0
    with obs.span("abft_matmul_phase", cases=cases):
        for i in range(cases):
            mm, kk, nn = (int(rng.integers(24, 64)) for _ in range(3))
            a = rng.standard_normal((mm, kk)).astype(np.float32)
            b = rng.standard_normal((kk, nn)).astype(np.float32)
            clean, info0 = abft.abft_matmul(a, b, device=device)
            if info0["detections"]:
                violations += 1  # a clean product must verify clean
                continue
            plan = inject.FaultPlan([inject.FaultSpec(
                site=abft.SITE_MATMUL, kind="sdc_bitflip",
                max_triggers=1, seed=i)], seed=seed)
            with inject.plan(plan) as ap:
                fixed, info = abft.abft_matmul(a, b, device=device)
            if not ap.stats()["triggered"]:
                continue
            detections += info["detections"]
            corrected += bool(info["corrected"])
            recomputed += bool(info["recomputed"])
            if not (info["corrected"] or info["recomputed"]):
                violations += 1
            dev = float(torch.max(torch.abs(fixed - clean)))
            max_dev = max(max_dev, dev)
            if dev > info["tol"]:
                violations += 1
    return {"ran": True, "cases": cases, "detections": detections,
            "corrected": corrected, "recomputed": recomputed,
            "max_dev": max_dev, "violations": violations}


def history_records(summary: Dict) -> List[Tuple[str, float, str]]:
    """(metric, value, unit) records an ABFT campaign contributes to the
    regression history (the JAX package's names)."""
    out: List[Tuple[str, float, str]] = []
    sdc = summary.get("sdc") or {}
    if sdc.get("wall_s") and sdc.get("cases"):
        out.append(("abft:s_per_case",
                    round(sdc["wall_s"] / sdc["cases"], 6), "s"))
    if sdc.get("mean_detect_latency_s"):
        out.append(("abft:detect_latency_s",
                    sdc["mean_detect_latency_s"], "s"))
    esc = sdc.get("escalated")
    if isinstance(esc, int) and esc > 0 and sdc.get("cases"):
        out.append(("abft:escalation_rate",
                    round(esc / sdc["cases"], 4), "ratio"))
    ident = summary.get("identity") or {}
    if ident.get("plain_s_per_solve"):
        out.append(("abft:plain_s_per_solve", ident["plain_s_per_solve"],
                    "s"))
    if ident.get("overhead_ratio"):
        out.append(("abft:overhead_ratio", ident["overhead_ratio"], "x"))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.resilience.abftcheck",
        description="Seeded ABFT campaign: inject on-device sdc_bitflip "
                    "faults at panel-group boundaries of the checksum-"
                    "carrying LU/Cholesky engines; assert 100%% detection, "
                    "localized replay recovery (bit-identical), ladder "
                    "escalation for persistent faults, and the abft-off "
                    "bit-identity contract.")
    p.add_argument("--cases", type=int, default=110,
                   help="sdc-phase fault cases (default 110: >= 100 "
                        "injected faults across LU + Cholesky)")
    p.add_argument("--seed", type=int, default=258458)
    p.add_argument("--panel", type=int, default=16)
    p.add_argument("--gate", type=float, default=1e-4)
    p.add_argument("--matmul-cases", type=int, default=8)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the engines run (default cuda)")
    p.add_argument("--no-identity", action="store_true",
                   help="skip the bit-identity phase")
    p.add_argument("--no-matmul", action="store_true",
                   help="skip the GEMM single-element-correction phase")
    p.add_argument("--metrics-out", default=None, metavar="PATH")
    p.add_argument("--summary-json", default=None, metavar="PATH",
                   help="write the campaign summary (kind=abft_campaign)")
    p.add_argument("--history", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="append this campaign's records to the regression "
                        "history (default reports/history_torch.jsonl)")
    p.add_argument("--regress-check", action="store_true",
                   help="gate against the history baselines (exit 1 when "
                        "out of band)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.cli._common import metrics_run
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    with metrics_run(args, "abft_campaign", cases=args.cases,
                     seed=args.seed):
        sdc = run_sdc_phase(args.cases, args.seed, args.gate,
                            panel=args.panel, device=dev)
        ident = ({} if args.no_identity
                 else run_identity_phase(args.seed, device=dev))
        mat = ({} if args.no_matmul
               else run_matmul_phase(args.matmul_cases, args.seed,
                                     device=dev))
        wall = round(time.perf_counter() - t0, 3)
        violations = (sdc["violations"]
                      + (0 if not ident or ident["bit_identical"] else 1)
                      + (mat.get("violations", 0) if mat else 0))
        summary = {
            "kind": "abft_campaign", "seed": args.seed,
            "gate": args.gate, "panel": args.panel, "device": args.device,
            "sdc": sdc, "identity": ident, "matmul": mat,
            "wall_s": wall, "invariant_ok": violations == 0,
        }
        obs.emit("abft_campaign",
                 **{k: v for k, v in summary.items() if k != "kind"})

    c = sdc["counts"]
    print(f"abft campaign: {sdc['cases']} sdc case(s), {sdc['injected']} "
          f"on-device fault(s) injected ({sdc['faulted_cases']} faulted "
          f"case(s))")
    print(f"  detection: rate={sdc['detect_rate']}, {sdc['missed']} "
          f"missed; replay-recovered {sdc['replayed']} "
          f"(rate {sdc['replay_rate']}, by engine "
          f"{sdc['replayed_by_engine']}, {sdc['bit_identity_failures']} "
          f"bit-identity failure(s), {sdc['mislocalized']} mislocalized), "
          f"{sdc['escalated']} ladder escalation(s), "
          f"{c.get('silent_wrong', 0)} SILENT WRONG, "
          f"{c.get('violation', 0)} untyped")
    if ident:
        print(f"  identity: bit_identical={ident['bit_identical']}"
              + (f" MISMATCHES={ident['mismatches']}"
                 if ident["mismatches"] else "")
              + f", plain {ident['plain_s_per_solve']} s/solve, abft "
                f"{ident['abft_s_per_solve']} s/solve "
                f"({ident['overhead_ratio']}x)")
    if mat:
        print(f"  matmul: {mat['detections']} detection(s) -> "
              f"{mat['corrected']} corrected in place, "
              f"{mat['recomputed']} recomputed, max deviation "
              f"{mat['max_dev']:.2e}, {mat['violations']} violation(s)")
    print(f"  invariant {'HOLDS' if violations == 0 else 'VIOLATED'} "
          f"({wall} s)")

    if args.summary_json:
        parent = os.path.dirname(args.summary_json)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"summary: {args.summary_json}")

    from gauss_tpu_torch.obs import regress

    rc = regress.gate(
        regress.campaign_records(history_records(summary), "abft", "abft",
                                 regress.device_tag(args.device)),
        args.history, args.regress_check, healthy=not violations)
    if violations:
        print(f"abftcheck: INVARIANT VIOLATED ({violations} case(s))",
              file=sys.stderr)
        return 2
    return rc


if __name__ == "__main__":
    sys.exit(main())

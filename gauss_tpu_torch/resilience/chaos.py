"""Chaos campaign runner: ``python -m gauss_tpu_torch.resilience.chaos``.

Port of ``gauss_tpu/resilience/chaos.py``; runs on ``cuda`` unless
``--device cpu`` is given. Sweeps seeded randomized fault plans across
engines and hook points and asserts the invariant a solver service must
never break:

    every injected fault is either recovered — a solution the runner
    verifies itself at the relative-residual gate — or surfaced as a typed
    error. Never a silent wrong answer.

Phases:

- **solver** (``--cases``): each case draws an engine (blocked / rank-1),
  a size and a fault scenario — transient or persistent operand corruption
  (NaN / Inf / bit-flip / near-zero pivot) at the engine's hook point,
  corruption of both engines, or input corruption (a typed
  ``UnrecoverableSolveError`` expected) — and runs
  :func:`gauss_tpu_torch.resilience.recover.solve_resilient`.
- **serve** (``--serve-requests``): a live :class:`SolverServer` under
  injected build failures and dispatch stalls; every request reaches one
  terminal status, and every ``ok`` solution is verified.
- **checkpoint**: a checkpointed chunked factorization killed mid-run
  (the ``checkpoint.group`` hook) resumes bit for bit to the uninterrupted
  run's factor.
- **structure** (``--no-structure`` to skip): structured solves under a
  lying classifier (every class x every wrong tag, through the
  ``structure.detect`` hook) demote to a verified answer or a typed error.
- **sdc** (``--sdc-cases``, 0 disables): on-device ``sdc_bitflip`` faults
  at the ABFT group sites, through
  :func:`gauss_tpu_torch.resilience.abftcheck.run_sdc_case`.

The JAX package's ``fleet`` and ``durable`` phases need the supervised
fleet (ROADMAP queue-1 item 10) and the request journal (item 11), which
are not ported: a run that does not pass ``--no-fleet --no-durable``
exits 2 naming them, and does not skip them silently. ``--history`` and
``--regress-check`` need ``obs.regress`` (item 11) and exit 2 too.

The summary (``--summary-json``, ``kind: chaos_campaign``) has the JAX
package's keys (``fleet`` and ``durable`` empty). Exit status: 2 when the
invariant is violated (silent wrong answer or untyped error) or a refused
option is given, 0 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np

#: what --history / --regress-check wait for
REGRESS_PENDING = ("obs.regress is not ported to gauss_tpu_torch yet "
                   "(ROADMAP queue-1 item 11)")
#: the JAX package's phases whose planes are not ported
UNPORTED_PHASES = (
    ("no_fleet", "--no-fleet", "the fleet phase needs resilience/fleet "
     "(ROADMAP queue-1 item 10)"),
    ("no_durable", "--no-durable", "the durable phase needs serve/durable "
     "(ROADMAP queue-1 item 11)"),
)

#: solver-phase scenario catalog: (name, weight). Most faults are one-shot.
SCENARIOS = (
    ("transient", 6),      # one-shot corruption at the primary engine
    ("persistent", 2),     # corruption on every primary-engine call
    ("persistent_all", 1),  # both engines corrupted -> numpy rung
    ("input", 1),          # corrupt the input itself -> typed error
)
CORRUPT_KINDS = ("nan", "inf", "bitflip", "near_zero_pivot")
#: the solver phase's default system sizes
SOLVER_SIZES = (24, 32, 48)

ENGINE_SITES = {"blocked": "core.blocked.factor",
                "rank1": "core.gauss.solve"}


def _system(rng: np.random.Generator, n: int):
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)  # diagonally dominant
    return a, rng.standard_normal(n)


def _solver_case(i: int, seed: int, engines, sizes, panel, gate, device):
    """Run one seeded solver case; returns its outcome record."""
    from gauss_tpu_torch.kernels._build import is_kernel_fault
    from gauss_tpu_torch.resilience import inject, recover
    from gauss_tpu_torch.verify import checks

    rng = np.random.default_rng(np.random.SeedSequence((seed, i)))
    engine = engines[i % len(engines)]
    n = int(sizes[int(rng.integers(0, len(sizes)))])
    names = [s for s, w in SCENARIOS for _ in range(w)]
    scenario = names[int(rng.integers(0, len(names)))]
    kind = CORRUPT_KINDS[int(rng.integers(0, len(CORRUPT_KINDS)))]
    a, b = _system(rng, n)

    if scenario == "transient":
        specs = [inject.FaultSpec(site=ENGINE_SITES[engine], kind=kind,
                                  max_triggers=1, seed=i)]
    elif scenario == "persistent":
        specs = [inject.FaultSpec(site=ENGINE_SITES[engine], kind=kind,
                                  max_triggers=None, seed=i)]
    elif scenario == "persistent_all":
        specs = [inject.FaultSpec(site=s, kind=kind, max_triggers=None,
                                  seed=i + j)
                 for j, s in enumerate(ENGINE_SITES.values())]
    else:  # input
        specs = [inject.FaultSpec(site="chaos.input",
                                  kind="nan" if kind == "bitflip" else kind,
                                  max_triggers=1, seed=i)]

    out = {"case": i, "engine": engine, "n": n, "scenario": scenario,
           "kind": kind}
    with inject.plan(inject.FaultPlan(specs, seed=seed)) as ap:
        if scenario == "input":
            a = inject.corrupt_operand("chaos.input", a)
        try:
            res = recover.solve_resilient(a, b, engine=engine, panel=panel,
                                          gate=gate, device=device)
            # The runner's own verification: the ladder's gate does not
            # judge the ladder.
            rel = checks.residual_norm(a, res.x, b, relative=True)
            if np.isfinite(rel) and rel <= gate:
                out.update(outcome="recovered" if res.rung_index else "ok",
                           rung=res.rung, rung_index=res.rung_index,
                           rel_residual=rel)
            else:
                out.update(outcome="silent_wrong", rung=res.rung,
                           rel_residual=float(rel))
        except recover.UnrecoverableSolveError as e:
            out.update(outcome="typed_error", trigger=e.trigger)
        except Exception as e:  # noqa: BLE001 — an untyped escape IS the bug
            if is_kernel_fault(e):
                raise
            out.update(outcome="violation",
                       error=f"{type(e).__name__}: {e}"[:200])
        out["injected"] = ap.stats()
    return out


def run_solver_phase(cases: int, seed: int, engines, sizes, panel, gate,
                     log=print, device=None) -> Dict:
    from gauss_tpu_torch import obs

    outcomes: List[Dict] = []
    t0 = time.perf_counter()
    with obs.span("chaos_solver_phase", cases=cases):
        for i in range(cases):
            outcomes.append(_solver_case(i, seed, engines, sizes, panel,
                                         gate, device))
            if (i + 1) % 50 == 0:
                log(f"  solver cases: {i + 1}/{cases}")
    phase_wall = round(time.perf_counter() - t0, 3)
    by_rung: Dict[str, int] = {}
    counts = {"ok": 0, "recovered": 0, "typed_error": 0, "silent_wrong": 0,
              "violation": 0}
    rung_depths = []
    inj_site: Dict[str, int] = {}
    inj_kind: Dict[str, int] = {}
    injected = 0
    for o in outcomes:
        counts[o["outcome"]] = counts.get(o["outcome"], 0) + 1
        if o["outcome"] in ("ok", "recovered"):
            by_rung[o["rung"]] = by_rung.get(o["rung"], 0) + 1
            rung_depths.append(o["rung_index"] + 1)
        st = o.get("injected", {})
        injected += st.get("triggered", 0)
        for k, v in st.get("by_site", {}).items():
            inj_site[k] = inj_site.get(k, 0) + v
        for k, v in st.get("by_kind", {}).items():
            inj_kind[k] = inj_kind.get(k, 0) + v
    return {
        "cases": cases, "counts": counts, "recovered_by_rung": by_rung,
        "mean_rung": (round(float(np.mean(rung_depths)), 4)
                      if rung_depths else None),
        "typed_error_rate": round(counts["typed_error"] / cases, 4)
        if cases else None,
        "injected": injected, "injected_by_site": inj_site,
        "injected_by_kind": inj_kind, "wall_s": phase_wall,
    }


def run_serve_phase(requests: int, seed: int, gate: float,
                    device=None) -> Dict:
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.resilience import inject
    from gauss_tpu_torch.serve import ServeConfig, SolverServer
    from gauss_tpu_torch.verify import checks

    cfg = ServeConfig(ladder=(32, 64), max_batch=4, panel=16, refine_steps=1,
                      verify_gate=gate, max_retries=2, retry_backoff_s=0.0,
                      unhealthy_after=2, device_probe_cooldown_s=0.05,
                      device="cuda" if device is None else str(device))
    plan = inject.FaultPlan([
        inject.FaultSpec(site="serve.cache.compile", kind="compile_fail",
                         p=0.35, max_triggers=None, seed=1),
        inject.FaultSpec(site="serve.worker.dispatch", kind="delay",
                         p=0.25, max_triggers=None, param=0.02, seed=2),
    ], seed=seed)
    rng = np.random.default_rng(np.random.SeedSequence((seed, 0x5e12e)))
    counts: Dict[str, int] = {}
    incorrect = 0
    unresolved = 0
    injected = {}
    with obs.span("chaos_serve_phase", requests=requests):
        with inject.plan(plan) as ap:
            with SolverServer(cfg) as srv:
                handles = []
                for i in range(requests):
                    n = int(rng.integers(8, 49))
                    a, b = _system(rng, n)
                    # every 5th request runs under deadline pressure
                    dl = 0.01 if i % 5 == 4 else None
                    handles.append((a, b, srv.submit(a, b, deadline_s=dl)))
                for a, b, h in handles:
                    try:
                        res = h.result(timeout=120)
                    except TimeoutError:
                        unresolved += 1
                        continue
                    counts[res.status] = counts.get(res.status, 0) + 1
                    if res.status == "ok":
                        rel = checks.residual_norm(a, res.x, b,
                                                   relative=True)
                        if not rel <= gate:
                            incorrect += 1
            injected = ap.stats()
    return {"requests": requests, "counts": counts, "incorrect": incorrect,
            "unresolved": unresolved, "injected": injected.get("triggered", 0),
            "injected_by_site": injected.get("by_site", {})}


def run_checkpoint_phase(tmpdir: str, device=None) -> Dict:
    import torch

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.resilience import checkpoint as ckpt
    from gauss_tpu_torch.resilience import inject
    from gauss_tpu_torch.verify import checks

    rng = np.random.default_rng(2584580)
    n = 96
    a = (rng.standard_normal((n, n)) + np.diag([float(n)] * n)).astype(
        np.float32)
    kw = dict(panel=16, chunk=2, device=device)
    with obs.span("chaos_checkpoint_phase"):
        clean = ckpt.lu_factor_blocked_chunked_checkpointed(
            a, f"{tmpdir}/chaos_ck_clean.npz", **kw)
        path = f"{tmpdir}/chaos_ck_killed.npz"
        plan = inject.FaultPlan([inject.FaultSpec(
            site="checkpoint.group", kind="raise", max_triggers=1, skip=2)])
        killed = False
        with inject.plan(plan) as ap:
            try:
                ckpt.lu_factor_blocked_chunked_checkpointed(a, path, **kw)
            except inject.SimulatedFaultError:
                killed = True
            injected = ap.stats()["triggered"]
        resumed = ckpt.lu_factor_blocked_chunked_checkpointed(a, path, **kw)
        identical = all(
            torch.equal(getattr(clean, f), getattr(resumed, f))
            for f in ("m", "perm", "min_abs_pivot", "linv", "uinv"))
        # and the factor solves
        b = rng.standard_normal(n)
        x = blocked.lu_solve(resumed, b).cpu().numpy()
        rel = checks.residual_norm(a, x, b, relative=True)
    return {"ran": True, "killed": killed, "bit_identical": bool(identical),
            "injected": injected, "resumed_rel_residual": float(rel)}


def run_structure_phase(seed: int, gate: float, device=None) -> Dict:
    """Structured-solve chaos: a wrong structure tag (every class x every
    wrong tag, through the ``structure.detect`` mis-tag hook) must demote
    to a verified answer or a typed error."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.kernels._build import is_kernel_fault
    from gauss_tpu_torch.resilience import inject, recover
    from gauss_tpu_torch.structure import STRUCTURE_KINDS, solve_auto
    from gauss_tpu_torch.verify import checks

    rng = np.random.default_rng(np.random.SeedSequence((seed, 0x5717)))
    n = 48
    systems = {
        "spd": synthetic.spd_matrix(n),
        "banded": synthetic.banded_matrix(n, 1),
        "blockdiag": synthetic.blockdiag_matrix(n, 8),
        "dense": synthetic.dense_matrix(n),
    }
    cases: List[Dict] = []
    injected = 0
    with obs.span("chaos_structure_phase"):
        for true_kind, a in systems.items():
            b = rng.standard_normal(n)
            for wrong_idx, wrong in enumerate(STRUCTURE_KINDS):
                if wrong == true_kind:
                    continue
                case = {"true": true_kind, "forced": wrong}
                plan = inject.FaultPlan([inject.FaultSpec(
                    site="structure.detect", kind="mistag",
                    param=float(wrong_idx), max_triggers=1)], seed=seed)
                with inject.plan(plan) as ap:
                    try:
                        res = solve_auto(a, b, gate=gate, device=device)
                        rel = checks.residual_norm(a, res.x, b,
                                                   relative=True)
                        if np.isfinite(rel) and rel <= gate:
                            case.update(outcome=("demoted"
                                                 if res.rung_index else "ok"),
                                        engine=res.rung,
                                        rel_residual=float(rel))
                        else:
                            case.update(outcome="silent_wrong",
                                        engine=res.rung,
                                        rel_residual=float(rel))
                    except recover.UnrecoverableSolveError as e:
                        case.update(outcome="typed_error", trigger=e.trigger)
                    except Exception as e:  # noqa: BLE001 — untyped IS the bug
                        if is_kernel_fault(e):
                            raise
                        case.update(outcome="violation",
                                    error=f"{type(e).__name__}: {e}"[:200])
                    injected += ap.stats()["triggered"]
                cases.append(case)
    violations = sum(1 for c in cases
                     if c["outcome"] in ("silent_wrong", "violation"))
    return {"ran": True, "cases": cases, "injected": injected,
            "demotions": sum(1 for c in cases if c["outcome"] == "demoted"),
            "violations": violations}


def run_sdc_phase(cases: int, seed: int, gate: float, log=print,
                  device=None) -> Dict:
    """On-device SDC chaos: the abftcheck case runner under the campaign
    invariant (100% detection, replay-or-ladder recovery, bit-identity)."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.resilience import abftcheck

    outcomes: List[Dict] = []
    clean_cache: Dict = {}
    by_site: Dict[str, int] = {}
    t0 = time.perf_counter()
    with obs.span("chaos_sdc_phase", cases=cases):
        for i in range(cases):
            o = abftcheck.run_sdc_case(i, seed, gate,
                                       clean_cache=clean_cache,
                                       device=device)
            outcomes.append(o)
            site = f"abft.{o['engine']}.group"
            by_site[site] = by_site.get(site, 0) + o.get("injected", 0)
    summ = abftcheck.summarize_sdc_cases(outcomes,
                                         time.perf_counter() - t0)
    summ["ran"] = True
    summ["injected_by_site"] = by_site
    return summ


def history_records(summary: Dict) -> List[Tuple[str, float, str]]:
    """(metric, value, unit) records a campaign would contribute to the
    regression history (the JAX package's names), for ``obs.regress`` once
    it is ported."""
    out: List[Tuple[str, float, str]] = []
    sol = summary.get("solver") or {}
    if isinstance(sol.get("mean_rung"), (int, float)) and sol["mean_rung"] > 0:
        out.append(("chaos:solver/mean_rung", sol["mean_rung"], "rung"))
    ter = sol.get("typed_error_rate")
    if isinstance(ter, (int, float)) and ter > 0:
        out.append(("chaos:solver/typed_error_rate", ter, "ratio"))
    wall = sol.get("wall_s", summary.get("wall_s"))
    cases = sol.get("cases")
    if isinstance(wall, (int, float)) and wall > 0 and cases:
        out.append(("chaos:solver/s_per_case", round(wall / cases, 6), "s"))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.resilience.chaos",
        description="Seeded chaos campaign: inject faults across engines "
                    "and hook points; assert every fault is recovered "
                    "(verified) or a typed error — never a silent wrong "
                    "answer. Pass --no-fleet --no-durable: those phases "
                    "are not ported.")
    p.add_argument("--cases", type=int, default=200,
                   help="solver-phase fault cases (default 200)")
    p.add_argument("--seed", type=int, default=258458)
    p.add_argument("--engines", default="blocked,rank1",
                   help="comma-separated primary engines (default both)")
    p.add_argument("--sizes", default=",".join(map(str, SOLVER_SIZES)),
                   help="comma-separated system sizes")
    p.add_argument("--panel", type=int, default=16)
    p.add_argument("--gate", type=float, default=1e-4,
                   help="relative-residual verification bar (default 1e-4)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the engines and the server run (default "
                        "cuda)")
    p.add_argument("--serve-requests", type=int, default=30,
                   help="serve-phase request count (0 disables the phase)")
    p.add_argument("--no-checkpoint", action="store_true",
                   help="skip the checkpoint kill/resume phase")
    p.add_argument("--no-fleet", action="store_true",
                   help="required: the supervised-fleet phase is not "
                        "ported (ROADMAP queue-1 item 10)")
    p.add_argument("--no-structure", action="store_true",
                   help="skip the structured-solve mis-tag phase")
    p.add_argument("--no-durable", action="store_true",
                   help="required: the journal-recovery phase is not "
                        "ported (ROADMAP queue-1 item 11)")
    p.add_argument("--sdc-cases", type=int, default=12,
                   help="on-device sdc_bitflip cases against the ABFT "
                        "engines (0 disables; the deep campaign is "
                        "abftcheck)")
    p.add_argument("--tmpdir", default=None,
                   help="where the checkpoint phase writes its files "
                        "(default: a new temporary directory)")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="append the campaign's obs JSONL stream here")
    p.add_argument("--summary-json", default=None, metavar="PATH",
                   help="write the campaign summary (kind=chaos_campaign)")
    p.add_argument("--history", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="append this campaign's records to the regression "
                        "history (refused: " + REGRESS_PENDING + ")")
    p.add_argument("--regress-check", action="store_true",
                   help="gate against the history baselines (refused: "
                        + REGRESS_PENDING + ")")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.history is not None or args.regress_check:
        print(f"chaos: --history / --regress-check: {REGRESS_PENDING}",
              file=sys.stderr)
        return 2
    missing = [(flag, why) for attr, flag, why in UNPORTED_PHASES
               if not getattr(args, attr)]
    if missing:
        print("chaos: not ported, pass " + " ".join(f for f, _ in missing)
              + ": " + "; ".join(w for _, w in missing), file=sys.stderr)
        return 2

    engines = [e.strip() for e in args.engines.split(",") if e.strip()]
    sizes = [int(s) for s in args.sizes.split(",")]
    bad = [e for e in engines if e not in ENGINE_SITES]
    if bad:
        print(f"chaos: unknown engine(s) {bad}; options: "
              f"{sorted(ENGINE_SITES)}", file=sys.stderr)
        return 2

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.cli._common import metrics_run
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    with metrics_run(args, "chaos_campaign", cases=args.cases,
                     seed=args.seed), \
            tempfile.TemporaryDirectory(prefix="gauss_chaos_") as scratch:
        solver = run_solver_phase(args.cases, args.seed, engines, sizes,
                                  args.panel, args.gate, device=dev)
        serve = (run_serve_phase(args.serve_requests, args.seed, args.gate,
                                 device=dev)
                 if args.serve_requests > 0 else {})
        ckpt = ({} if args.no_checkpoint
                else run_checkpoint_phase(args.tmpdir or scratch,
                                          device=dev))
        struct = ({} if args.no_structure
                  else run_structure_phase(args.seed, args.gate, device=dev))
        sdc = (run_sdc_phase(args.sdc_cases, args.seed, args.gate,
                             device=dev)
               if args.sdc_cases > 0 else {})
        wall = round(time.perf_counter() - t0, 3)

        violations = (solver["counts"]["silent_wrong"]
                      + solver["counts"]["violation"]
                      + (serve.get("incorrect", 0) if serve else 0)
                      + (serve.get("unresolved", 0) if serve else 0)
                      + (0 if not ckpt or ckpt["bit_identical"] else 1)
                      + (struct.get("violations", 0) if struct else 0)
                      + (sdc.get("violations", 0) if sdc else 0))
        injected = (solver["injected"] + (serve.get("injected", 0))
                    + (ckpt.get("injected", 0) if ckpt else 0)
                    + (struct.get("injected", 0) if struct else 0)
                    + (sdc.get("injected", 0) if sdc else 0))
        sites = dict(solver["injected_by_site"])
        for k, v in (serve.get("injected_by_site") or {}).items():
            sites[k] = sites.get(k, 0) + v
        if ckpt.get("injected"):
            sites["checkpoint.group"] = (sites.get("checkpoint.group", 0)
                                         + ckpt["injected"])
        if struct.get("injected"):
            sites["structure.detect"] = (sites.get("structure.detect", 0)
                                         + struct["injected"])
        for k, v in (sdc.get("injected_by_site") or {}).items():
            sites[k] = sites.get(k, 0) + v
        summary = {
            "kind": "chaos_campaign", "seed": args.seed,
            "engines": engines, "sizes": sizes, "gate": args.gate,
            "device": args.device,
            "injected": injected, "injected_by_site": sites,
            "solver": solver, "serve": serve, "checkpoint": ckpt,
            "fleet": {}, "structure": struct, "durable": {}, "sdc": sdc,
            "wall_s": wall, "invariant_ok": violations == 0,
        }
        obs.emit("chaos_campaign",
                 **{k: v for k, v in summary.items() if k != "kind"})

    c = solver["counts"]
    print(f"chaos campaign: {args.cases} solver case(s) over "
          f"{'+'.join(engines)} @ n={sizes}, {injected} fault(s) injected "
          f"across {len(sites)} site(s)")
    print(f"  solver: {c['ok']} clean, {c['recovered']} recovered "
          f"(by rung: {solver['recovered_by_rung']}), "
          f"{c['typed_error']} typed error(s), "
          f"{c['silent_wrong']} SILENT WRONG, {c['violation']} untyped")
    if serve:
        print(f"  serve: {serve['requests']} request(s) -> "
              f"{serve['counts']}, {serve['incorrect']} incorrect, "
              f"{serve['unresolved']} unresolved, "
              f"{serve['injected']} fault(s)")
    if ckpt:
        print(f"  checkpoint: killed={ckpt['killed']} "
              f"bit_identical={ckpt['bit_identical']} "
              f"rel_residual={ckpt['resumed_rel_residual']:.3e}")
    if struct:
        by_outcome: Dict[str, int] = {}
        for c in struct["cases"]:
            by_outcome[c["outcome"]] = by_outcome.get(c["outcome"], 0) + 1
        print(f"  structure: {len(struct['cases'])} mis-tag case(s) -> "
              f"{by_outcome}, {struct['demotions']} demotion(s), "
              f"{struct['violations']} violation(s)")
    if sdc:
        print(f"  sdc: {sdc['cases']} on-device case(s), "
              f"{sdc['injected']} bitflip(s) -> detect rate "
              f"{sdc['detect_rate']}, {sdc['replayed']} replay-recovered, "
              f"{sdc['escalated']} escalated, "
              f"{sdc['bit_identity_failures']} bit-identity failure(s), "
              f"{sdc['violations']} violation(s)")
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

    if violations:
        print(f"chaos: INVARIANT VIOLATED ({violations} case(s))",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())

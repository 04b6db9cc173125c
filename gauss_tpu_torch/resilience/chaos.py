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
- **fleet** (``--no-fleet`` to skip): supervised multi-worker solves
  (:func:`gauss_tpu_torch.resilience.fleet.solve_supervised` on
  ``--device``) with one worker killed and one stalled at a seeded panel
  group; the supervised job must finish bit for bit equal to the
  unfaulted supervised run, or raise the typed ``FleetError``, and every
  injected kill or stall must leave a post-mortem bundle that ``python -m
  gauss_tpu_torch.obs.debug --check`` accepts.
- **structure** (``--no-structure`` to skip): structured solves under a
  lying classifier (every class x every wrong tag, through the
  ``structure.detect`` hook) demote to a verified answer or a typed error.
- **durable** (``--no-durable`` to skip): the serving plane killed and
  restarted against its write-ahead request journal — one in-process
  case per crash kind of
  :data:`gauss_tpu_torch.serve.durablecheck.CASE_KINDS`, through that
  campaign's :func:`~gauss_tpu_torch.serve.durablecheck.run_recovery_case`
  (every admitted request reaches exactly one journaled terminal, served
  results re-verified, idempotent resubmission never re-solves).
- **sdc** (``--sdc-cases``, 0 disables): on-device ``sdc_bitflip`` faults
  at the ABFT group sites, through
  :func:`gauss_tpu_torch.resilience.abftcheck.run_sdc_case`.

``--history`` appends the
campaign's records to the port's regression history (``obs.regress``:
its own file, each record stamped with the device it ran on) and
``--regress-check`` gates them against that device's baselines.

The summary (``--summary-json``, ``kind: chaos_campaign``) has the JAX
package's keys. Exit status: 2 when the invariant is violated (silent
wrong answer or untyped error) or a refused option is given, 1 when ``--regress-check`` finds an out-of-band metric, 0
otherwise.
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


def run_fleet_phase(seed: int, gate: float, device=None) -> Dict:
    """Supervised-fleet chaos: kill one fleet worker and stall another at
    a seeded panel group (the JAX package's phase: n=48, panel 16, a 3 s
    stall threshold). Invariant: the supervised job completes with a
    verified solution — bit for bit the unfaulted supervised run — or a
    typed FleetError; never a hang (every wait is deadline-bounded); and
    every injected fault leaves a post-mortem bundle ``obs.debug --check``
    accepts."""
    import shutil

    from gauss_tpu_torch import obs
    from gauss_tpu_torch.obs import debug as _debug
    from gauss_tpu_torch.obs import postmortem as _postmortem
    from gauss_tpu_torch.resilience import fleet
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence((seed, 0xF1EE7)))
    n = 48
    a, b = _system(rng, n)
    kw = dict(workers=2, panel=16, chunk=1, gate=gate, stall_after_s=3.0,
              barrier_deadline_s=45.0, job_timeout_s=150.0,
              device=dev.type)
    cases: List[Dict] = []
    with obs.span("chaos_fleet_phase"):
        clean = fleet.solve_supervised(a, b, **kw)
        group = 1 + int(rng.integers(0, 2))  # kill/stall at group 1 or 2
        for kind in ("kill", "stall"):
            case = {"kind": kind, "group": group}
            # Caller-owned jobdir: solve_supervised leaves it in place, so
            # the supervisor's post-mortem bundle can be checked after.
            jobdir = tempfile.mkdtemp(prefix=f"gauss_chaos_fleet_{kind}_")
            try:
                res = fleet.solve_supervised(
                    a, b, jobdir=jobdir,
                    inject=f"fleet.worker.group={kind}:skip={group}",
                    inject_worker=1, **kw)
                case.update(
                    outcome="recovered" if res.recovered else "ok",
                    rung=res.rung, restarts=res.restarts,
                    stalls=res.stalls,
                    rel_residual=float(res.rel_residual),
                    resume_latency_s=res.resume_latency_s,
                    bit_identical=bool(np.array_equal(clean.x, res.x)))
            except fleet.FleetError as e:
                case.update(outcome="typed_error", error=str(e)[:200])
            except Exception as e:  # noqa: BLE001 — an untyped escape IS the bug
                case.update(outcome="violation",
                            error=f"{type(e).__name__}: {e}"[:200])
            # Every injected kill or stall must leave a post-mortem bundle
            # that obs.debug --check accepts.
            bundle = _postmortem.latest_bundle(
                _postmortem.default_bundles_dir(
                    os.path.join(jobdir, "flight")))
            case["bundle_check_rc"] = (
                _debug.main([bundle, "--check"]) if bundle else None)
            case["postmortem_ok"] = (bundle is not None
                                     and case["bundle_check_rc"] == 0)
            shutil.rmtree(jobdir, ignore_errors=True)
            cases.append(case)
    violations = sum(
        1 for c in cases
        if c["outcome"] == "violation"
        or not c.get("postmortem_ok")
        or (c["outcome"] in ("ok", "recovered")
            and not c.get("bit_identical")))
    return {"ran": True, "cases": cases, "injected": len(cases),
            "clean_rel_residual": float(clean.rel_residual),
            "violations": violations}


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


def run_durable_phase(seed: int, gate: float, tmpdir: str,
                      device=None) -> Dict:
    """Kill-the-server chaos: one in-process case per crash kind against
    the write-ahead request journal (the deep campaign with real
    subprocess kills is ``serve.durablecheck``; the runner is shared).
    These crashes go through the server's ``_crash()`` hook, not the
    inject module, so they are not counted as injected faults."""
    from gauss_tpu_torch import obs
    from gauss_tpu_torch.kernels._build import is_kernel_fault
    from gauss_tpu_torch.serve import durablecheck
    from gauss_tpu_torch.serve.cache import ExecutableCache
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cache = ExecutableCache(32, device=dev)
    ddir = os.path.join(tmpdir, "durable")
    os.makedirs(ddir, exist_ok=True)
    cases: List[Dict] = []
    with obs.span("chaos_durable_phase"):
        for i, kind in enumerate(durablecheck.CASE_KINDS):
            try:
                cases.append(durablecheck.run_recovery_case(
                    i, seed, gate, ddir, kind, cache=cache,
                    device=dev.type))
            except Exception as e:  # noqa: BLE001 — untyped escape IS the bug
                if is_kernel_fault(e):
                    raise
                cases.append({"case": i, "kind": kind,
                              "outcome": "violation",
                              "error": f"{type(e).__name__}: {e}"[:200]})
    return {"ran": True, "cases": cases,
            "admitted": sum(c.get("audit", {}).get("admitted", 0)
                            for c in cases),
            "crashes": len(cases),
            "violations": sum(1 for c in cases
                              if c["outcome"] == "violation")}


def history_records(summary: Dict) -> List[Tuple[str, float, str]]:
    """(metric, value, unit) records a campaign contributes to the
    regression history (the JAX package's names)."""
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
                    "answer.")
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
                   help="skip the supervised-fleet kill/stall phase "
                        "(worker subprocesses)")
    p.add_argument("--no-structure", action="store_true",
                   help="skip the structured-solve mis-tag phase")
    p.add_argument("--no-durable", action="store_true",
                   help="skip the journal kill/resume phase")
    p.add_argument("--sdc-cases", type=int, default=12,
                   help="on-device sdc_bitflip cases against the ABFT "
                        "engines (0 disables; the deep campaign is "
                        "abftcheck)")
    p.add_argument("--tmpdir", default=None,
                   help="where the checkpoint and durable phases write "
                        "their files (default: a new temporary directory)")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="append the campaign's obs JSONL stream here")
    p.add_argument("--summary-json", default=None, metavar="PATH",
                   help="write the campaign summary (kind=chaos_campaign)")
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
        flt = ({} if args.no_fleet
               else run_fleet_phase(args.seed, args.gate, device=dev))
        struct = ({} if args.no_structure
                  else run_structure_phase(args.seed, args.gate, device=dev))
        dur = ({} if args.no_durable
               else run_durable_phase(args.seed, args.gate,
                                      args.tmpdir or scratch, device=dev))
        sdc = (run_sdc_phase(args.sdc_cases, args.seed, args.gate,
                             device=dev)
               if args.sdc_cases > 0 else {})
        wall = round(time.perf_counter() - t0, 3)

        violations = (solver["counts"]["silent_wrong"]
                      + solver["counts"]["violation"]
                      + (serve.get("incorrect", 0) if serve else 0)
                      + (serve.get("unresolved", 0) if serve else 0)
                      + (0 if not ckpt or ckpt["bit_identical"] else 1)
                      + (flt.get("violations", 0) if flt else 0)
                      + (struct.get("violations", 0) if struct else 0)
                      + (dur.get("violations", 0) if dur else 0)
                      + (sdc.get("violations", 0) if sdc else 0))
        injected = (solver["injected"] + (serve.get("injected", 0))
                    + (ckpt.get("injected", 0) if ckpt else 0)
                    + (flt.get("injected", 0) if flt else 0)
                    + (struct.get("injected", 0) if struct else 0)
                    + (sdc.get("injected", 0) if sdc else 0))
        sites = dict(solver["injected_by_site"])
        for k, v in (serve.get("injected_by_site") or {}).items():
            sites[k] = sites.get(k, 0) + v
        if ckpt.get("injected"):
            sites["checkpoint.group"] = (sites.get("checkpoint.group", 0)
                                         + ckpt["injected"])
        if flt.get("injected"):
            sites["fleet.worker.group"] = (sites.get("fleet.worker.group", 0)
                                           + flt["injected"])
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
            "fleet": flt, "structure": struct, "durable": dur, "sdc": sdc,
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
    if flt:
        for c in flt["cases"]:
            print(f"  fleet[{c['kind']}@group{c['group']}]: "
                  f"{c['outcome']}"
                  + (f" rung={c.get('rung')} restarts={c.get('restarts')} "
                     f"stalls={c.get('stalls')} "
                     f"bit_identical={c.get('bit_identical')}"
                     if "rung" in c else f" ({c.get('error', '')[:80]})"))
    if struct:
        by_outcome: Dict[str, int] = {}
        for c in struct["cases"]:
            by_outcome[c["outcome"]] = by_outcome.get(c["outcome"], 0) + 1
        print(f"  structure: {len(struct['cases'])} mis-tag case(s) -> "
              f"{by_outcome}, {struct['demotions']} demotion(s), "
              f"{struct['violations']} violation(s)")
    if dur:
        by_outcome = {}
        for c in dur["cases"]:
            by_outcome[c["outcome"]] = by_outcome.get(c["outcome"], 0) + 1
        print(f"  durable: {dur['crashes']} kill/resume case(s) "
              f"({'+'.join(c['kind'] for c in dur['cases'])}) -> "
              f"{by_outcome}, {dur['admitted']} admitted, "
              f"{dur['violations']} violation(s)")
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

    from gauss_tpu_torch.obs import regress

    rc = regress.gate(
        regress.campaign_records(history_records(summary), "chaos", "chaos",
                                 regress.device_tag(args.device)),
        args.history, args.regress_check, healthy=not violations)
    if violations:
        print(f"chaos: INVARIANT VIOLATED ({violations} case(s))",
              file=sys.stderr)
        return 2
    return rc


if __name__ == "__main__":
    sys.exit(main())

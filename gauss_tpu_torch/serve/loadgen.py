"""Open/closed-loop load generator + report for the serving layer (the
port of ``gauss_tpu/serve/loadgen.py``).

The reference's evaluation story is one matrix per process launch; a serving
system is evaluated under TRAFFIC. This module replays a workload mix against
an in-process :class:`SolverServer` and reports what the serving literature
reports: throughput, p50/p95/p99 latency, batch occupancy, and cache
hit-rate — all recomputed from numbers the server already emitted as obs
events, and exportable as a regress-sentinel record so serving performance
is gated the same way solve performance is (``reports/history.jsonl``).

Workload mixes are comma-separated weighted tokens::

    random:100*3,internal:256,dat:/path/to/jpwh_991.dat,dataset:orsirr_1

- ``random:<n>`` — diagonally-dominant dense random system (well-
  conditioned; the serving analog of the bench sweeps' rng systems).
- ``internal:<n>`` — the reference's internal benchmark matrix
  (io.synthetic.internal_matrix, known closed-form solution).
- ``dat:<path>`` — a reference-format ``.dat`` file, RHS manufactured
  as the external programs do (io.synthetic.manufactured_rhs).
- ``dataset:<name>`` — an io.datasets stand-in by name (the committed
  deterministic doubles of the reference Harwell-Boeing set).
- ``spd:<n>`` / ``banded:<n>/<b>`` / ``blockdiag:<n>/<k>`` — the
  structured generators (io.synthetic.spd_matrix / banded_matrix /
  blockdiag_matrix), so a mix can drive the structure-aware serving
  lanes (``ServeConfig(structure_aware=True)``) and the chaos campaign
  end to end; ``<b>``/``<k>`` default to 1 / n // 8.
- ``sparse:<n>/<nnz_per_row>`` — the sparse-plane generator
  (io.synthetic.sparse_matrix, ``<nnz_per_row>`` default 8): a
  Gershgorin-certified low-density system that a structure-aware server
  routes to the Krylov lane (``gauss_tpu_torch.sparse``). Loadgen operands are
  in-memory ndarrays, so ``<n>`` is capped at the generator's 4096
  densify limit — the scalable no-densify path is exercised by
  ``gauss_tpu_torch.sparse.check``, not by serving traffic.
- ``dtype:<dt>/<n>`` — a diagonally-dominant random system (like
  ``random:<n>``) submitted with a per-request storage dtype
  (``bfloat16`` / ``bf16x3`` / ``float32`` — core.lowered's ladder
  names), so a mix can drive the LOWERED batched lanes
  (``submit(dtype=...)`` -> ``CacheKey.dtype``) alongside f32 traffic
  and prove the executables never alias; every solution still passes
  the same 1e-4 verification below.

Two driving modes: **closed** loop (``concurrency`` clients, each submits,
waits, repeats — throughput self-clocks to service capacity) and **open**
loop (Poisson arrivals at ``rate`` rps regardless of completions — the mode
that actually exercises admission control, because arrivals do not slow down
when the server does).

Every request's solution is verified against ``verify.checks`` at the 1e-4
relative-residual gate; the summary counts ``incorrect`` separately from
transport-level failures, because a fast wrong answer is the one failure
mode a solver service must never ship.

The "server" may be a network client
(:class:`gauss_tpu_torch.serve.net.SolveClient`, the ``--net`` mode): the
report then names its endpoint (``net``) and its history metrics are
tagged ``serve:net:<mode>``. A journaled server adds the ``journal``
section, a server with the live plane on the ``slo`` section (its SLO
monitors' :func:`gauss_tpu_torch.obs.slo.slo_report`). The report's
sections for planes the port does not have yet (the mesh lanes, the
attribution plane) are absent, as the
JAX package's are when those planes are off; ``compile_cache`` is None
(the persistent compile cache is the JAX package's).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gauss_tpu_torch import obs
from gauss_tpu_torch.serve.admission import STATUS_OK, ServeConfig
from gauss_tpu_torch.serve.server import SolverServer
from gauss_tpu_torch.verify import checks

VERIFY_GATE = 1e-4  # relative-residual bar, the reference EPSILON


@dataclass(frozen=True)
class WorkloadSpec:
    """One sampled request template."""

    kind: str          # random | internal | dat | dataset | structured...
    arg: str           # n as string, path, or dataset name
    nrhs: int = 1
    #: per-request storage dtype for the batched lane (the ``dtype:``
    #: token); None = the server's default.
    dtype: Optional[str] = None


@dataclass
class LoadgenConfig:
    mix: str = "random:100*2,random:200,internal:160"
    requests: int = 50
    warmup: int = 8               # per-run warmup requests (excluded)
    mode: str = "closed"          # closed | open
    concurrency: int = 4          # closed loop: client count
    rate: float = 50.0            # open loop: arrivals per second
    nrhs: int = 1
    seed: int = 258458
    deadline_s: Optional[float] = None
    #: mint a deterministic idempotency key per measured request
    #: (``submit(request_id="lg<seed>-<i>")``): with a journaled server a
    #: rerun of the same plan dedupes already-terminal requests.
    request_ids: bool = False
    timeout_s: float = 600.0
    verify_gate: float = VERIFY_GATE
    serve: ServeConfig = field(default_factory=ServeConfig)


def parse_mix(mix: str) -> List[Tuple[WorkloadSpec, float]]:
    """Parse ``kind:arg*weight`` comma-separated tokens into specs."""
    out: List[Tuple[WorkloadSpec, float]] = []
    for token in mix.split(","):
        token = token.strip()
        if not token:
            continue
        weight = 1.0
        if "*" in token:
            token, w = token.rsplit("*", 1)
            weight = float(w)
        if ":" not in token:
            raise ValueError(f"workload token {token!r} needs kind:arg")
        kind, arg = token.split(":", 1)
        if kind not in ("random", "internal", "dat", "dataset",
                        "spd", "banded", "blockdiag", "sparse", "dtype",
                        "poison"):
            raise ValueError(f"unknown workload kind {kind!r} in {token!r}")
        if kind == "poison":
            # poison:<kind>/<n> — a deliberately bad operand at a
            # controlled rate: nan/inf (non-finite entries the admission
            # scan rejects) or singular (finite but exactly rank-deficient
            # — the recovery ladder's typed singular verdict). Typed
            # rejects are counted separately from failures in the report.
            p_part, _, n_part = arg.partition("/")
            if p_part not in ("nan", "inf", "singular"):
                raise ValueError(
                    f"bad poison kind in workload token {token!r}; "
                    f"options: ('nan', 'inf', 'singular')")
            if not n_part or int(n_part) < 2:
                raise ValueError(f"bad size in workload token {token!r} "
                                 f"(poison needs n >= 2)")
        dtype = None
        if kind == "dtype":
            # dtype:<dt>/<n> — a random dominant system served at the
            # lowered storage dtype (the mixed-precision batched lane).
            from gauss_tpu_torch.core.lowered import LOWERED_DTYPES

            dt_part, _, n_part = arg.partition("/")
            if dt_part not in LOWERED_DTYPES:
                raise ValueError(
                    f"bad dtype in workload token {token!r}; options: "
                    f"{LOWERED_DTYPES}")
            if not n_part or int(n_part) < 1:
                raise ValueError(f"bad size in workload token {token!r}")
            kind, arg, dtype = "random", n_part, dt_part
        if kind in ("random", "internal", "spd") and int(arg) < 1:
            raise ValueError(f"bad size in workload token {token!r}")
        if kind in ("banded", "blockdiag", "sparse"):
            n_part, _, x_part = arg.partition("/")
            if int(n_part) < 1:
                raise ValueError(f"bad size in workload token {token!r}")
            if kind == "sparse":
                if int(n_part) > 4096:
                    raise ValueError(
                        f"sparse workload n={n_part} exceeds the loadgen "
                        f"densify cap 4096 (token {token!r})")
                if x_part and int(x_part) < 1:
                    raise ValueError(
                        f"bad nnz_per_row in workload token {token!r}")
        out.append((WorkloadSpec(kind=kind, arg=arg, dtype=dtype), weight))
    if not out:
        raise ValueError(f"empty workload mix {mix!r}")
    return out


_dat_cache: Dict[str, np.ndarray] = {}
_dat_lock = threading.Lock()


def materialize(spec: WorkloadSpec, rng: np.random.Generator, nrhs: int = 1,
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Build the (a, b) operands for one request from its spec.

    ``.dat``/dataset matrices are parsed once and cached host-side (the
    serving layer's own cache is about EXECUTABLES; re-parsing a file per
    request would just benchmark the parser). RHS vectors are freshly
    sampled per request — same matrix, different b is exactly the
    one-factorization-many-solves traffic serving is built for.
    """
    if spec.kind == "random":
        n = int(spec.arg)
        a = rng.standard_normal((n, n))
        a[np.arange(n), np.arange(n)] += float(n)  # diagonal dominance
    elif spec.kind == "internal":
        from gauss_tpu_torch.io import synthetic

        a = synthetic.internal_matrix(int(spec.arg))
    elif spec.kind == "dat":
        with _dat_lock:
            a = _dat_cache.get(spec.arg)
        if a is None:
            from gauss_tpu_torch.io.datfile import read_dat_dense

            a = np.asarray(read_dat_dense(spec.arg), dtype=np.float64)
            with _dat_lock:
                _dat_cache[spec.arg] = a
    elif spec.kind in ("spd", "banded", "blockdiag", "sparse"):
        from gauss_tpu_torch.io import synthetic

        if spec.kind == "spd":
            a = synthetic.spd_matrix(int(spec.arg))
        elif spec.kind == "banded":
            n_s, _, b_s = spec.arg.partition("/")
            a = synthetic.banded_matrix(int(n_s),
                                        int(b_s) if b_s else 1)
        elif spec.kind == "sparse":
            n_s, _, z_s = spec.arg.partition("/")
            a = synthetic.sparse_matrix(int(n_s),
                                        int(z_s) if z_s else 8)
        else:
            n_s, _, k_s = spec.arg.partition("/")
            n_i = int(n_s)
            a = synthetic.blockdiag_matrix(
                n_i, int(k_s) if k_s else max(1, n_i // 8))
    elif spec.kind == "poison":
        p_kind, _, n_s = spec.arg.partition("/")
        n = int(n_s)
        a = rng.standard_normal((n, n))
        a[np.arange(n), np.arange(n)] += float(n)
        if p_kind == "nan":
            a[0, 0] = np.nan
        elif p_kind == "inf":
            a[0, 0] = np.inf
        else:  # singular: zero a full row — exactly rank-deficient, but
            # finite, so it sails past the admission scan and must be
            # caught by the ladder's typed singular verdict instead. (A
            # zero row, not a duplicated one: elimination of a duplicate
            # leaves a rounding-level pivot and a finite garbage answer,
            # which is a generic gate failure, not the typed verdict.)
            a[n // 2, :] = 0.0
    elif spec.kind == "dataset":
        with _dat_lock:
            a = _dat_cache.get("dataset:" + spec.arg)
        if a is None:
            from gauss_tpu_torch.io import datasets

            a = np.asarray(datasets.dataset_dense(spec.arg),
                           dtype=np.float64)
            with _dat_lock:
                _dat_cache["dataset:" + spec.arg] = a
    else:  # pragma: no cover — parse_mix already rejects
        raise ValueError(f"unknown workload kind {spec.kind!r}")
    n = a.shape[0]
    k = max(1, nrhs)
    b = rng.standard_normal((n, k)) if k > 1 else rng.standard_normal(n)
    return a, b


def sample_plan(cfg: LoadgenConfig, count: int, rng: np.random.Generator,
                ) -> List[WorkloadSpec]:
    """Deterministically sample ``count`` request specs from the mix."""
    specs_weights = parse_mix(cfg.mix)
    specs = [s for s, _ in specs_weights]
    w = np.asarray([wt for _, wt in specs_weights], dtype=np.float64)
    idx = rng.choice(len(specs), size=count, p=w / w.sum())
    return [specs[i] for i in idx]


def _percentile(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


def run_load(server: SolverServer, cfg: LoadgenConfig) -> Dict:
    """Drive the workload and return the serving report (a plain dict).

    Warmup requests run first through the same path (closed-loop, low
    concurrency) and are excluded from every reported number; cache
    hit-rate is measured from the post-warmup delta of the server's cache
    counters — the steady-state number, which is what the >80% acceptance
    bar is about (the first occupant of each bucket shape is always a miss).
    """
    rng = np.random.default_rng(cfg.seed)
    warm_plan = sample_plan(cfg, cfg.warmup, rng)
    plan = sample_plan(cfg, cfg.requests, rng)

    t_warm = time.perf_counter()
    with obs.span("loadgen_warmup", requests=len(warm_plan)):
        # Submitted as a burst, not serially: warmup must compile the
        # BATCHED executable shapes too (a serial warmup only ever forms
        # batch-1 dispatches, leaving every batch-bucket shape to compile
        # inside the measured window).
        warm_handles = [server.submit(*materialize(spec, rng, cfg.nrhs),
                                      dtype=spec.dtype)
                        for spec in warm_plan]
        for h in warm_handles:
            h.result(cfg.timeout_s)
    # Warmup wall-clock is the cold-start number: every executable-cache
    # entry (and, in a fresh process on the card, the kernels' first use)
    # is paid here.
    warmup_s = time.perf_counter() - t_warm
    hits0, misses0 = server.cache.hits, server.cache.misses
    batches0 = server.batches
    retries0 = server.retries
    rec = obs.active()
    occ_skip = (len(rec.histograms.get("serve.batch_occupancy", []))
                if rec is not None else 0)

    results = [None] * len(plan)
    operands = [None] * len(plan)
    next_i = iter(range(len(plan)))
    next_lock = threading.Lock()

    def _take() -> Optional[int]:
        with next_lock:
            return next(next_i, None)

    def _rid(i: int) -> Optional[str]:
        return f"lg{cfg.seed}-{i}" if cfg.request_ids else None

    def closed_worker(wid: int):
        wrng = np.random.default_rng(cfg.seed + 1000 + wid)
        while True:
            i = _take()
            if i is None:
                return
            a, b = materialize(plan[i], wrng, cfg.nrhs)
            operands[i] = (a, b)
            results[i] = server.solve(a, b, deadline_s=cfg.deadline_s,
                                      timeout=cfg.timeout_s,
                                      dtype=plan[i].dtype,
                                      request_id=_rid(i))

    t_start = time.perf_counter()
    if cfg.mode == "closed":
        threads = [threading.Thread(target=closed_worker, args=(w,))
                   for w in range(max(1, cfg.concurrency))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    elif cfg.mode == "open":
        wrng = np.random.default_rng(cfg.seed + 999)
        handles = []
        t_next = time.perf_counter()
        for i, spec in enumerate(plan):
            a, b = materialize(spec, wrng, cfg.nrhs)
            operands[i] = (a, b)
            # Poisson arrivals: exponential inter-arrival gaps at `rate`.
            t_next += wrng.exponential(1.0 / max(cfg.rate, 1e-9))
            delay = t_next - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            handles.append(server.submit(a, b, deadline_s=cfg.deadline_s,
                                         dtype=spec.dtype,
                                         request_id=_rid(i)))
        for i, h in enumerate(handles):
            results[i] = h.result(cfg.timeout_s)
    else:
        raise ValueError(f"unknown mode {cfg.mode!r}; options: "
                         "('closed', 'open')")
    wall_s = time.perf_counter() - t_start

    # -- fold the per-request outcomes ------------------------------------
    counts = {"ok": 0, "rejected": 0, "expired": 0, "failed": 0,
              "poison": 0}
    incorrect = 0
    lanes: Dict[str, int] = {}
    lat = []
    for i, res in enumerate(results):
        counts[res.status] = counts.get(res.status, 0) + 1
        if res.status == STATUS_OK:
            lat.append(res.latency_s)
            lanes[res.lane] = lanes.get(res.lane, 0) + 1
            a, b = operands[i]
            if not (checks.residual_norm(a, res.x, b, relative=True)
                    <= cfg.verify_gate):
                incorrect += 1
    lat.sort()
    served = counts["ok"]

    hits = server.cache.hits - hits0
    misses = server.cache.misses - misses0
    lookups = hits + misses
    occ = None
    if server.batches > batches0 and rec is not None:
        vals = rec.histograms.get("serve.batch_occupancy", [])[occ_skip:]
        if vals:
            occ = float(np.mean(vals))

    summary = {
        "kind": "serve_loadgen",
        "mix": cfg.mix,
        "mode": cfg.mode,
        "requests": len(plan),
        "warmup": len(warm_plan),
        "warmup_s": round(warmup_s, 6),
        "compile_cache": None,
        "counts": counts,
        "incorrect": incorrect,
        "lanes": lanes,
        "wall_s": round(wall_s, 6),
        "throughput_rps": round(served / wall_s, 4) if wall_s > 0 else None,
        "latency_s": {
            "mean": round(float(np.mean(lat)), 6) if lat else None,
            "p50": _percentile(lat, 0.50),
            "p95": _percentile(lat, 0.95),
            "p99": _percentile(lat, 0.99),
            "max": lat[-1] if lat else None,
        },
        "batch_occupancy_mean": round(occ, 4) if occ is not None else None,
        "batches": server.batches - batches0,
        "retries": server.retries - retries0,
        "cache": {"hits": hits, "misses": misses,
                  "hit_rate": round(hits / lookups, 4) if lookups else None,
                  **{k: v for k, v in server.cache.stats().items()
                     if k in ("entries", "capacity", "evictions")}},
        "verify_gate": cfg.verify_gate,
    }
    if getattr(server, "url", None) is not None:
        # The "server" is a network client (the --net mode): its history
        # metrics band separately (history_records' serve:net: tag).
        summary["net"] = server.url
    if getattr(server, "journal", None) is not None:
        summary["journal"] = {**server.journal.stats(),
                              "resume": server.last_resume}
    if getattr(server, "live", None) is not None:
        # The live plane was on: fold its SLO monitors into the report,
        # also exportable alone (serve.cli --slo-json) as the
        # regress-ingestable ``kind: slo_report``.
        from gauss_tpu_torch.obs import slo as _slo

        summary["slo"] = _slo.slo_report(server.live.slos, mix=cfg.mix,
                                         mode=cfg.mode)
    obs.emit("serve_loadgen", **{k: v for k, v in summary.items()
                                 if k != "kind"})
    for name, value in history_records(summary):
        obs.gauge(f"loadgen.{name}", value)
    return summary


def history_records(summary: Dict) -> List[Tuple[str, float]]:
    """The (metric, value) pairs a loadgen summary contributes to the
    regression history (obs.regress ingests these via the serve_loadgen
    ingest path; metric names are mode-qualified so open- and closed-loop
    epochs never pollute each other's baselines)."""
    tag = f"serve:{summary.get('mode', 'closed')}"
    if summary.get("net"):
        # Wire runs pay HTTP and codec time on top of serving.
        tag = f"serve:net:{summary.get('mode', 'closed')}"
    out = []
    tput = summary.get("throughput_rps")
    if isinstance(tput, (int, float)) and tput > 0:
        # Regress gates SLOWDOWNS (value above median * band fails), so
        # throughput enters history inverted — seconds per request.
        out.append((f"{tag}/s_per_request", round(1.0 / tput, 6)))
    lat = summary.get("latency_s") or {}
    for q in ("p50", "p95"):
        v = lat.get(q)
        if isinstance(v, (int, float)) and v > 0:
            out.append((f"{tag}/{q}_s", round(v, 6)))
    return out


def write_summary(summary: Dict, path) -> None:
    path = os.fspath(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
        f.write("\n")


def format_summary(summary: Dict) -> str:
    c = summary["counts"]
    lat = summary["latency_s"]
    cache = summary["cache"]

    def _s(v):
        return "-" if v is None else (f"{v:.6f}" if isinstance(v, float)
                                      else str(v))

    lines = [
        f"serve loadgen [{summary['mode']}] mix={summary['mix']}",
        f"  warmup: {_s(summary.get('warmup_s'))} s"
        + (f" (compile cache: {summary['compile_cache']})"
           if summary.get("compile_cache") else " (no compile cache)"),
        f"  requests {summary['requests']} (+{summary['warmup']} warmup): "
        f"{c.get('ok', 0)} ok, {c.get('rejected', 0)} rejected, "
        f"{c.get('expired', 0)} expired, {c.get('failed', 0)} failed, "
        f"{c.get('poison', 0)} poison-rejected, "
        f"{summary['incorrect']} INCORRECT",
        f"  lanes: " + (", ".join(f"{k}={v}" for k, v in
                                  sorted(summary['lanes'].items())) or "-"),
        f"  throughput {_s(summary['throughput_rps'])} req/s over "
        f"{_s(summary['wall_s'])} s",
        f"  latency s: mean {_s(lat['mean'])}  p50 {_s(lat['p50'])}  "
        f"p95 {_s(lat['p95'])}  p99 {_s(lat['p99'])}  max {_s(lat['max'])}",
        f"  batches {summary['batches']}, mean occupancy "
        f"{_s(summary['batch_occupancy_mean'])}",
        f"  cache: {cache['hits']} hits / {cache['misses']} misses "
        f"(hit-rate {_s(cache['hit_rate'])}), {cache['entries']} entries, "
        f"{cache['evictions']} evictions"
        + (f"; {summary['retries']} retried batch attempt(s)"
           if summary.get("retries") else ""),
    ]
    jr = summary.get("journal")
    if jr:
        lines.append(
            f"  journal: {jr['appends']} append(s) / {jr['fsyncs']} "
            f"fsync(s) / {jr['rotations']} rotation(s), "
            f"{jr['segments']} segment(s), {jr['bytes']} bytes"
            + (f"; resumed {jr['resume']['replayed']} replayed + "
               f"{jr['resume']['expired']} expired"
               if jr.get("resume") else ""))
    slo = summary.get("slo")
    if slo:
        lines.append(
            f"  slo: {slo['violations']}/{slo['requests_counted']} "
            f"violation(s) (rate {slo['violation_rate']:.4f}), worst burn "
            f"{slo['worst_burn_rate']:.2f}x, {slo['alerts']} alert(s) "
            f"fired / {slo['clears']} cleared")
    return "\n".join(lines)

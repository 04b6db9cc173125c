"""Benchmark-regression sentinel: baselines with a noise band, as a gate.

``python -m gauss_tpu_torch.obs.regress {ingest|check|report} ...``

The port of ``gauss_tpu/obs/regress.py``, with the same record shape,
baseline and verdicts:

- **History** is an append-only JSONL, one line per measurement —
  ``{"metric", "value", "unit", "source", "kind"}``. Ingestable sources:
  the campaign and check summaries of the planes the port has
  (``serve_loadgen``, ``structured_solve``, ``sparse_solve``,
  ``chaos_campaign``, ``abft_campaign``, ``outofcore_bench``,
  ``durable_campaign``, ``poison_campaign``, ``replica_campaign``,
  ``flight_check``), BENCH-shaped records (the ``parsed`` dict),
  bench-grid ``--json`` cell arrays and obs JSONL streams with ``cell``
  events — only VERIFIED cells enter history.
- **Baseline** per metric: the MEDIAN across epochs plus a noise band;
  the slow-side threshold is ``median * max(band, 1 + 3*MAD/median)``.
- **Verdict** per checked value: ``ok`` (within band), ``fast`` (at or
  below the median, never flagged), ``out-of-band`` (exit 1), or
  ``no-baseline`` (fewer than ``--min-samples`` epochs).

How this module differs from the JAX package's:

- **Its own history file.** The default is
  ``reports/history_torch.jsonl`` (:func:`default_history_path`), never
  the JAX package's ``reports/history.jsonl``, which holds that package's
  CPU and TPU epochs under the same metric names. Nothing here appends to
  that file unless a caller names it.
- **Every record carries the device it ran on** (``device``: ``"cpu"``, or
  ``"cuda:<card name>"``, :func:`device_tag`), and a check compares a
  record only with history records of the same device: a card figure is
  never held against a CPU or TPU baseline. Records with no ``device``
  (the JAX package's) compare only with each other, exactly as the JAX
  module compares them.
- **No ratchet.** The JAX package's ``RATCHET_BASELINES`` and ``check
  --ratchet`` hold records to its own committed TPU and CPU bests; the
  port has committed no card record, so it has neither.
- **No phase attribution.** A failed gate does not diff ``phases_s``
  against the best BENCH record (that needs ``obs/doctor``).
- **Planes not ported are refused by name.** A summary of a kind whose
  plane the port lacks (``mesh_serve``, ``throughput_bench``,
  ``tune_sweep``, ``prof_check``, ``lint_report``)
  raises :class:`PlaneNotPortedError` naming the ROADMAP queue-1 item that
  brings it; the CLI exits 2.

Stdlib only at module level; the planes' ``history_records`` load lazily.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_BAND = 1.2        # slow-side relative tolerance vs the median
EPOCH_DRIFT_CEILING = 1.5  # documented epoch envelope
MIN_SAMPLES = 3

#: summary ``kind`` -> (module holding its ``history_records``, record kind)
PLANES = {
    "serve_loadgen": ("gauss_tpu_torch.serve.loadgen", "serve"),
    "structured_solve": ("gauss_tpu_torch.structure.check", "structure"),
    "sparse_solve": ("gauss_tpu_torch.sparse.check", "sparse"),
    "chaos_campaign": ("gauss_tpu_torch.resilience.chaos", "chaos"),
    "abft_campaign": ("gauss_tpu_torch.resilience.abftcheck", "abft"),
    "outofcore_bench": ("gauss_tpu_torch.outofcore.check", "outofcore"),
    "durable_campaign": ("gauss_tpu_torch.serve.durablecheck", "durable"),
    "poison_campaign": ("gauss_tpu_torch.serve.poisoncheck", "poison"),
    "replica_campaign": ("gauss_tpu_torch.serve.replicacheck", "replica"),
    "flight_check": ("gauss_tpu_torch.obs.flightcheck", "flight"),
    "fleet_solve": ("gauss_tpu_torch.resilience.fleet", "fleet"),
    "slo_report": ("gauss_tpu_torch.obs.slo", "slo"),
}
#: summary kinds of the JAX package whose planes are not ported, and the
#: ROADMAP queue-1 item that brings each
PENDING_PLANES = {
    "mesh_serve": "item 11 (serve/meshcheck, after serve/lanes)",
    "throughput_bench": "item 8 (bench/throughput)",
    "tune_sweep": "item 11 (tune/runner)",
    "prof_check": "item 11 (obs/profcheck)",
    "lint_report": "item 11 (analysis/)",
}


class PlaneNotPortedError(NotImplementedError):
    """An artifact of a plane the port does not have yet."""


def default_history_path() -> str:
    """The port's own history file (never the JAX package's)."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, "reports", "history_torch.jsonl")


def device_tag(device: Optional[str]) -> Optional[str]:
    """The ``device`` stamp of a record: ``"cpu"``; ``"cuda:<card name>"``
    where a card is present (``"cuda"`` where it is not, as when a card's
    summary is ingested elsewhere); None passes through (a record of
    unknown device, as the JAX package's are)."""
    if device is None:
        return None
    device = str(device)
    if not device.startswith("cuda"):
        return device
    import torch

    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name(0)}"
    return "cuda"


def _record(metric: str, value, source: str, kind: str,
            unit: str = "s", **meta) -> Optional[Dict[str, Any]]:
    if not isinstance(value, (int, float)) or not value > 0:
        return None
    rec = {"metric": metric, "value": float(value), "unit": unit,
           "source": os.path.basename(os.fspath(source)), "kind": kind}
    rec.update({k: v for k, v in meta.items() if v is not None})
    return rec


def campaign_records(triples, source: str, kind: str,
                     device: Optional[str]) -> List[Dict[str, Any]]:
    """History records from a plane's ``history_records`` output:
    ``(metric, value, unit)`` triples (or ``(metric, value)`` pairs, unit
    ``s``), each stamped with ``device`` (:func:`device_tag`)."""
    out = []
    for t in triples:
        metric, value = t[0], t[1]
        unit = t[2] if len(t) > 2 else "s"
        rec = _record(metric, value, source, kind, unit=unit, device=device)
        if rec:
            out.append(rec)
    return out


def _cell_metric(cell: Dict[str, Any]) -> str:
    name = (f"cell:{cell.get('suite')}/{cell.get('key')}/"
            f"{cell.get('backend')}")
    if cell.get("span") == "device":
        name += "@device"
    dtype = cell.get("dtype")
    if dtype and dtype != "float32":
        name += f"@{dtype}"
    return name


def ingest_file(path) -> List[Dict[str, Any]]:
    """Parse one artifact into history records. Detects, in order: an obs
    JSONL stream (``cell`` events), a summary of a ported plane
    (:data:`PLANES`; one of :data:`PENDING_PLANES` raises
    :class:`PlaneNotPortedError`), a bench-grid ``--json`` cell array, and
    a BENCH-shaped record. Unverified cells are dropped."""
    text = open(os.fspath(path)).read()
    records: List[Dict[str, Any]] = []
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and doc.get("type"):
        doc = None  # a one-line obs stream, not a summary
    if doc is None:  # JSONL: an obs event stream
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if ev.get("type") == "cell" and ev.get("verified"):
                rec = _record(_cell_metric(ev), ev.get("seconds"), path,
                              "cell", run=ev.get("run"),
                              device=device_tag(ev.get("device")))
                if rec:
                    records.append(rec)
        return records
    kind = doc.get("kind") if isinstance(doc, dict) else None
    if kind in PENDING_PLANES:
        raise PlaneNotPortedError(
            f"{os.fspath(path)}: a {kind!r} summary; its plane is not "
            f"ported to gauss_tpu_torch yet (ROADMAP queue-1 "
            f"{PENDING_PLANES[kind]})")
    if kind in PLANES:
        module, rkind = PLANES[kind]
        hist = importlib.import_module(module).history_records
        return campaign_records(hist(doc), path, rkind,
                                device_tag(doc.get("device")))
    if isinstance(doc, list):  # bench-grid --json cells
        for cell in doc:
            if isinstance(cell, dict) and cell.get("verified"):
                rec = _record(_cell_metric(cell), cell.get("seconds"), path,
                              "cell", run=cell.get("run_id"),
                              device=device_tag(cell.get("device")))
                if rec:
                    records.append(rec)
        return records
    if isinstance(doc, dict):  # a BENCH-shaped record
        parsed = doc.get("parsed") if isinstance(doc.get("parsed"), dict) \
            else doc
        metric = parsed.get("metric")
        if metric:
            dev = device_tag(parsed.get("device"))
            for name, key in ((metric, "value"),
                              (f"{metric}:refined", "refined_value")):
                rec = _record(name, parsed.get(key), path, "bench",
                              unit=parsed.get("unit", "s"),
                              run=parsed.get("run_id"), device=dev)
                if rec:
                    records.append(rec)
    return records


def load_history(path) -> List[Dict[str, Any]]:
    if not os.path.exists(os.fspath(path)):
        return []
    out = []
    with open(os.fspath(path)) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("metric"):
                out.append(rec)
    return out


def append_history(records: List[Dict[str, Any]], path) -> int:
    """Append records not already present (same metric, value, source and
    device: the same measurement re-ingested). Returns how many were
    added."""
    def key(r):
        return (r.get("metric"), r.get("value"), r.get("source"),
                r.get("device"))
    existing = {key(r) for r in load_history(path)}
    fresh = [r for r in records if key(r) not in existing]
    if not fresh:
        return 0
    path = os.fspath(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a") as f:
        for r in fresh:
            f.write(json.dumps(r, sort_keys=True) + "\n")
    return len(fresh)


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def baseline(values: List[float], band: float = DEFAULT_BAND,
             ) -> Dict[str, float]:
    """Median + slow-side threshold for one metric's history; the band
    widens to 1 + 3*MAD/median when the recorded scatter exceeds it."""
    med = _median(values)
    mad = _median([abs(v - med) for v in values])
    rel = max(band, 1.0 + (3.0 * mad / med if med > 0 else 0.0))
    return {"median": med, "mad": mad, "n": len(values),
            "rel_band": round(rel, 4), "threshold": med * rel}


def evaluate(metric: str, value: float, history: List[Dict[str, Any]],
             band: float = DEFAULT_BAND, min_samples: int = MIN_SAMPLES,
             device: Optional[str] = None) -> Dict[str, Any]:
    """Classify one fresh measurement against the history of the same
    metric ON THE SAME DEVICE (``device`` None: records with no device)."""
    values = [r["value"] for r in history if r.get("metric") == metric
              and r.get("device") == device
              and isinstance(r.get("value"), (int, float))]
    verdict: Dict[str, Any] = {"metric": metric, "value": value,
                               "samples": len(values)}
    if device is not None:
        verdict["device"] = device
    if len(values) < min_samples:
        verdict.update(status="no-baseline",
                       note=f"only {len(values)} committed epoch(s) "
                            f"(need {min_samples}); informational only")
        return verdict
    base = baseline(values, band)
    ratio = value / base["median"] if base["median"] > 0 else float("inf")
    verdict.update(baseline=round(base["median"], 9),
                   threshold=round(base["threshold"], 9),
                   rel_band=base["rel_band"], ratio=round(ratio, 3))
    if value <= base["median"]:
        verdict.update(status="fast",
                       note="at or below the baseline median — a favorable "
                            "epoch is not a regression")
    elif value <= base["threshold"]:
        verdict.update(status="ok",
                       note=f"{ratio:.2f}x median, inside the "
                            f"{base['rel_band']:.2f}x noise band (epoch "
                            f"noise; docs/BENCH_STABILITY.md)")
    elif ratio <= EPOCH_DRIFT_CEILING:
        verdict.update(status="out-of-band",
                       note=f"{ratio:.2f}x median exceeds the "
                            f"{base['rel_band']:.2f}x band but sits inside "
                            f"the {EPOCH_DRIFT_CEILING}x epoch-drift "
                            f"ceiling — confirm with a same-epoch A/B "
                            f"before blaming code (BENCH_STABILITY.md)")
    else:
        verdict.update(status="out-of-band",
                       note=f"{ratio:.2f}x median, beyond the "
                            f"{EPOCH_DRIFT_CEILING}x epoch-drift ceiling — "
                            f"likely a code regression")
    return verdict


def check_records(records: List[Dict[str, Any]],
                  history: List[Dict[str, Any]],
                  band: float = DEFAULT_BAND,
                  min_samples: int = MIN_SAMPLES) -> List[Dict[str, Any]]:
    return [evaluate(r["metric"], r["value"], history, band, min_samples,
                     device=r.get("device")) for r in records]


def format_verdicts(verdicts: List[Dict[str, Any]]) -> str:
    out = []
    for v in verdicts:
        head = f"[{v['status']:^12}] {v['metric']} = {v['value']:.6g}"
        if v.get("device"):
            head += f" on {v['device']}"
        if "baseline" in v:
            head += (f"  (baseline {v['baseline']:.6g} over "
                     f"{v['samples']} epochs)")
        out.append(head)
        out.append(f"               {v['note']}")
    bad = sum(1 for v in verdicts if v["status"] == "out-of-band")
    out.append(f"{len(verdicts)} metric(s) checked, {bad} out of band")
    return "\n".join(out)


def format_report(history: List[Dict[str, Any]],
                  band: float = DEFAULT_BAND) -> str:
    metrics: Dict[Tuple[str, str], List[float]] = {}
    for r in history:
        if isinstance(r.get("value"), (int, float)):
            metrics.setdefault((r.get("device") or "-", r["metric"]),
                               []).append(r["value"])
    if not metrics:
        return "(empty history)"
    out = ["  epochs     median      threshold   device  metric"]
    for dev, m in sorted(metrics):
        b = baseline(metrics[(dev, m)], band)
        out.append(f"  {b['n']:6d}  {b['median']:10.6g}  "
                   f"{b['threshold']:10.6g}   {dev}  {m}")
    return "\n".join(out)


def gate(records: List[Dict[str, Any]], history: Optional[str],
         regress_check: bool, band: float = DEFAULT_BAND,
         healthy: bool = True) -> int:
    """The ``--history`` / ``--regress-check`` tail every check CLI shares:
    with ``regress_check``, print the verdicts against the history
    (``history`` or :func:`default_history_path`) and return 1 when one is
    out of band; with ``history`` not None (``""`` = the default file),
    append the records when the gate is green and the run ``healthy`` (a
    run whose invariant failed never enters the baseline). Returns 0
    otherwise."""
    rc = 0
    path = history or default_history_path()
    if regress_check and records:
        verdicts = check_records(records, load_history(path), band=band)
        print(format_verdicts(verdicts))
        if any(v["status"] == "out-of-band" for v in verdicts):
            rc = 1
    if history is not None and records and rc == 0 and healthy:
        added = append_history(records, path)
        print(f"history: {added} record(s) appended to {path}")
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gauss_tpu_torch.obs.regress",
        description="Benchmark-regression sentinel over the port's "
                    "append-only history (reports/history_torch.jsonl): "
                    "median baselines per device with an epoch-noise band, "
                    "usable as a CI gate.")
    p.add_argument("command", choices=("ingest", "check", "report"),
                   help="ingest: append artifacts to history; check: "
                        "classify artifacts against history (exit 1 on "
                        "out-of-band); report: print per-metric baselines")
    p.add_argument("files", nargs="*",
                   help="artifacts: check and campaign summaries, BENCH-"
                        "shaped records, bench-grid --json cell arrays, or "
                        "obs JSONL streams with cell events")
    p.add_argument("--history", default=None, metavar="PATH",
                   help=f"history file (default {default_history_path()})")
    p.add_argument("--band", type=float, default=DEFAULT_BAND,
                   help="slow-side relative noise band vs the median "
                        f"(default {DEFAULT_BAND})")
    p.add_argument("--min-samples", type=int, default=MIN_SAMPLES,
                   help="epochs required before a baseline gates "
                        f"(default {MIN_SAMPLES})")
    p.add_argument("--update", action="store_true",
                   help="check only: also append the checked records to "
                        "history when every verdict is in band")
    args = p.parse_args(argv)
    history_path = args.history or default_history_path()

    if args.command == "report":
        print(f"history: {history_path}")
        print(format_report(load_history(history_path), args.band))
        return 0

    if not args.files:
        p.error(f"{args.command} needs at least one artifact file")
    records: List[Dict[str, Any]] = []
    for f in args.files:
        try:
            recs = ingest_file(f)
        except OSError as e:
            print(f"regress: cannot read '{f}': {e}", file=sys.stderr)
            return 2
        except PlaneNotPortedError as e:
            print(f"regress: {e}", file=sys.stderr)
            return 2
        if not recs:
            print(f"regress: no ingestable measurements in '{f}'",
                  file=sys.stderr)
        records.extend(recs)
    if not records:
        print("regress: nothing to do (no measurements found)",
              file=sys.stderr)
        return 2

    if args.command == "ingest":
        added = append_history(records, history_path)
        print(f"regress: {added} new record(s) appended to {history_path} "
              f"({len(records) - added} already present)")
        return 0

    history = load_history(history_path)
    verdicts = check_records(records, history, args.band, args.min_samples)
    print(format_verdicts(verdicts))
    bad = any(v["status"] == "out-of-band" for v in verdicts)
    if args.update and not bad:
        added = append_history(records, history_path)
        print(f"regress: gate green; {added} record(s) appended to history")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

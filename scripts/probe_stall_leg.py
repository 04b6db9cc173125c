#!/usr/bin/env python3
"""``replicacheck``'s stall leg alone, run again and again beside a CPU
load, for one checkout.

    python3 scripts/probe_stall_leg.py [--root DIR] [--runs 10] [--load 3]
        [--gpu-load 0] [--disk-load 0] [--seed 190733] [--device cuda]
        [--out PATH]

Imports ``gauss_tpu_torch`` from the checkout at ``--root`` (default: this
one; another checkout, for example a parent commit unpacked beside it,
compares two versions on one card: run them in turns, each in its own
process) and runs :func:`gauss_tpu_torch.serve.replicacheck.run_stall_leg`
``--runs`` times at ``--seed`` (``chip_smoke.py`` phase 13 (b)'s campaign
seed): a router over 2 replicas on ``--device`` with the leg's
``stall_after_s=2.5``, r0 SIGSTOPped under load, which the router must
call a stall, kill, fail over and respawn with exactly one restart. The
load: ``--load`` processes, each multiplying 1024 x 1024 float64 matrices
on 2 BLAS threads without pause (``chip_smoke.py``'s background processes
run on 2 threads each), from before the first run to after the last;
with ``--gpu-load`` as many processes more, each multiplying 8192 x 8192
float32 matrices on the card without pause (a whole run's other
contexts), and with ``--disk-load`` as many writing and fsyncing 64 MB
files in turn in a directory of their own (a whole run's checkpoint
shards and journals).

Prints one line a run (outcome, recovery seconds, restarts used, and the
router's death events: which replica died how, who adopted its journal
and the failover's seconds) and, last, one JSON line: the runs that
passed, the recovery seconds, and every run's events; ``--out`` also
writes that JSON, with the replicas' log tails of the runs that failed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

BURN = ("import numpy as np\n"
        "a = np.random.default_rng(0).standard_normal((1024, 1024))\n"
        "while True:\n"
        "    a = np.tanh(a @ a)\n")


GPU_BURN = ("import torch\n"
            "a = torch.randn(8192, 8192, device='cuda')\n"
            "while True:\n"
            "    a = torch.tanh(a @ a)\n"
            "    torch.cuda.synchronize()\n")

DISK_BURN = ("import os, sys\n"
             "d = sys.argv[1]\n"
             "buf = os.urandom(64 << 20)\n"
             "i = 0\n"
             "while True:\n"
             "    p = os.path.join(d, f'f{i % 4}')\n"
             "    with open(p, 'wb') as f:\n"
             "        f.write(buf)\n"
             "        f.flush()\n"
             "        os.fsync(f.fileno())\n"
             "    i += 1\n")


def start_load(k: int, gpu: int = 0, disk: int = 0, disk_dir: str = ""):
    env = dict(os.environ, OMP_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2",
               MKL_NUM_THREADS="2")
    cmds = ([[sys.executable, "-c", BURN]] * k
            + [[sys.executable, "-c", GPU_BURN]] * gpu
            + [[sys.executable, "-c", DISK_BURN,
                os.path.join(disk_dir, f"d{i}")] for i in range(disk)])
    for i in range(disk):
        os.makedirs(os.path.join(disk_dir, f"d{i}"), exist_ok=True)
    return [subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL) for cmd in cmds]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--load", type=int, default=3,
                    help="CPU-burning processes of 2 threads each")
    ap.add_argument("--gpu-load", type=int, default=0,
                    help="processes multiplying matrices on the card")
    ap.add_argument("--disk-load", type=int, default=0,
                    help="processes writing and fsyncing 64 MB files")
    ap.add_argument("--seed", type=int, default=190733)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    # The replicas are `python -m` children: they import this checkout.
    os.environ["PYTHONPATH"] = root + os.pathsep + os.environ.get(
        "PYTHONPATH", "")
    os.chdir(root)
    from gauss_tpu_torch.serve import replicacheck

    if args.device == "cuda":
        from gauss_tpu_torch.kernels import _build

        _build.build_all()
    card = ""
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    disk_dir = tempfile.mkdtemp(prefix="gauss_stall_disk_")
    load = start_load(args.load, args.gpu_load, args.disk_load, disk_dir)
    runs = []
    try:
        for i in range(args.runs):
            with tempfile.TemporaryDirectory(prefix="gauss_stall_") as d:
                t0 = time.perf_counter()
                try:
                    leg = replicacheck.run_stall_leg(
                        args.seed, 1e-4, d, device=args.device,
                        log=lambda *a: None)
                except Exception as e:  # noqa: BLE001 — a failed run, kept
                    leg = {"outcome": "error",
                           "error": f"{type(e).__name__}: {e}"[:400]}
                leg["wall_s"] = round(time.perf_counter() - t0, 3)
            leg.pop("audit", None)
            runs.append(leg)
            print(f"run {i}: {leg['outcome']} recovery "
                  f"{leg.get('recovery_s')} s, restarts "
                  f"{leg.get('restarts_used')}, {leg['wall_s']} s; "
                  f"deaths {json.dumps(leg.get('deaths'))}"
                  + (f"; error {leg.get('error')}"
                     if leg["outcome"] != "ok" else ""), flush=True)
    finally:
        for p in load:
            p.kill()
            p.wait(timeout=60)
        shutil.rmtree(disk_dir, ignore_errors=True)
    doc = {"root": root, "device": args.device, "card": card,
           "load_processes": args.load, "gpu_load": args.gpu_load,
           "disk_load": args.disk_load, "runs": len(runs),
           "passed": sum(r["outcome"] == "ok" for r in runs),
           "recovery_s": [r.get("recovery_s") for r in runs],
           "restarts_used": [r.get("restarts_used") for r in runs],
           "events": [r.get("deaths") for r in runs]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**doc, "failed_runs": [r for r in runs
                                              if r["outcome"] != "ok"]},
                      f, indent=1)
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())

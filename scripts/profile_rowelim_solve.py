#!/usr/bin/env python3
"""Where one batched row-elimination solve spends its time on the card.

    python3 scripts/profile_rowelim_solve.py [--root DIR] [--n 2048] [--reps 10]

Imports ``gauss_tpu_torch`` from the checkout at ``--root`` (default: this
one; another checkout, for example a parent commit unpacked beside it,
compares two versions in one run on one card), builds its kernels, and on
a random n x n system seeded 258458:

- times ``gauss_solve_rowelim_batched`` by CUDA events around each of
  ``--reps`` calls (after two warm-up calls) and prints the median and
  the least;
- traces one more call with ``torch.profiler`` and prints the number of
  kernels, the device's busy time in the span from the first kernel's
  start to the last one's end, the share of that span in which no kernel
  runs (the idle share), the host time of the call, and the device time
  and launches of the kernels by name (the largest first).

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import rowelim as kr

    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    print(f"profile: gauss_tpu_torch from {Path(kr.__file__).parents[2]}")
    _build.build_all()
    rng = np.random.default_rng(258458)
    dev = torch.device("cuda")
    a = torch.as_tensor(rng.standard_normal((args.n, args.n)),
                        dtype=torch.float32, device=dev)
    b = torch.as_tensor(rng.standard_normal(args.n), dtype=torch.float32,
                        device=dev)

    def solve():
        return kr.gauss_solve_rowelim_batched(a, b, device=dev)

    for _ in range(2):
        solve()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        solve()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    print(f"profile: n={args.n} batched solve: median "
          f"{statistics.median(times):.4f} ms, least {min(times):.4f} ms "
          f"over {args.reps} calls (CUDA events)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: the trace holds no device events")
        return 1
    by_name: dict[str, list] = {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += ms
        entry[1] += 1
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3
    span = (spans[-1][1] - spans[0][0]) / 1e3
    print(f"profile: traced call: {len(kernels)} kernels, device busy "
          f"{busy:.4f} ms of a {span:.4f} ms span (idle share "
          f"{1.0 - busy / span:.3f}); host {host_ms:.4f} ms")
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:args.top]:
        print(f"profile:   {ms:9.4f} ms {count:4d} x {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The batched fused kernel's phase-A routes on the card: build, registers,
bit for bit checks, a sweep of the grid route's groups beside the cluster
waves and the one-block route, and the batched LU.

    python3 scripts/probe_batched.py [--reps 20] [--parts check,sweep,factor]
        [--sweep B:H:W:PANEL:DTYPE:K.G,K.G;...]

Builds the port's fused kernels, prints ``nvcc -Xptxas -v``'s registers and
spills of the batched kernels, then, on random stacks seeded 258458:

- ``check``: ``panel_trailing_fused_batched`` by the rule on stacks whose
  members are tall (above a cluster's reach), outnumber the clusters the
  card holds at once, or neither, in float32 and bfloat16: the C
  launcher's geometry equal to ``fused_batched_geometry``'s, every member
  bit for bit kernel 2 on it alone, member 0's pivots equal to the plain
  version's; then the same stack on every other route the strip has
  (``panel_trailing_fused_batched_at``: the cluster route, the one-block
  route, the grid route at other K and G), bit for bit the rule's;
- ``sweep``: at the serving lane's shapes (the first panel step of each
  bucket's factor, and the tall steps of the 4096 bucket: (8, h, 4096)
  with the panel at column 4096 - h), median ms of ``--reps`` calls by
  CUDA events of the rule's launch, of each (K, G) of ``--sweep`` (default:
  SWEEP), of the cluster waves where a cluster holds the strip, of the
  one-block route, and of kernel 2 looped over the members;
- ``factor``: ``lu_factor_blocked_batched`` on (8, n, n) dominant stacks
  at n = 1024, 2048 and 4096 in float32 and 2048 in bfloat16, median of 5
  by CUDA events, beside ``torch.linalg.lu_factor`` on the float32 stack.

Every line ends with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
SEED = 258458
# (B, h, wtot, panel, dtype) -> (K, G) values the grid route is timed at;
# the panel sits at column wtot - h.
SWEEP = {
    (8, 4096, 4096, 256, "float32"): ((4, 33), (4, 28), (4, 24), (6, 22),
                                      (3, 44)),
    (8, 3840, 4096, 256, "float32"): ((4, 33), (4, 28), (6, 22)),
    (8, 3584, 4096, 256, "float32"): ((7, 18), (6, 22), (4, 33), (4, 28)),
    (8, 2048, 2048, 256, "float32"): ((8, 16), (8, 14), (8, 12), (8, 10),
                                      (4, 33)),
    (8, 1024, 1024, 256, "float32"): ((8, 16), (8, 12), (8, 8), (8, 5)),
    (8, 512, 512, 128, "float32"): ((8, 8), (8, 16), (8, 4), (8, 2)),
    (8, 2048, 2048, 256, "bfloat16"): ((8, 16), (8, 12), (8, 8)),
}
# (B, h, wtot, panel, dtype) of the checks.
CHECKS = ((8, 4096, 4096, 256, "float32"), (8, 2048, 2048, 256, "float32"),
          (8, 512, 512, 128, "float32"), (8, 2048, 2048, 256, "bfloat16"),
          (2, 4096, 768, 256, "float32"), (4, 1024, 1024, 256, "float32"),
          (8, 4096, 4096, 256, "bfloat16"), (3, 8192, 1024, 256, "float32"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parts", default="check,sweep,factor")
    ap.add_argument("--sweep", default=None,
                    help="B:H:W:PANEL:DTYPE:K.G,K.G;... (default: SWEEP)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("probe_batched: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel_fused as kf
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    card = c.smi_line()
    parts = set(args.parts.split(","))
    built = _build.build_all(("panel_fused", "panel_fused_batched",
                              "panel_cluster", "panel_grid",
                              "panel_batched"))
    print(f"built {built} [{card}]")
    for k, (regs, spill, smem) in sorted(
            c.ptxas_usage("panel_fused_batched").items()):
        print(f"ptxas -v csrc/panel_fused_batched.cu {k}: {regs} registers, "
              f"{spill} bytes of spill stores, {smem} bytes of static "
              f"shared memory")
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def stack(bsz, h, w, dtype):
        return torch.as_tensor(rng.standard_normal((bsz, h, w)),
                               dtype=torch.float32,
                               device=dev).to(getattr(torch, dtype))

    def run(orig, col0, panel, route=None, k=0, g=0):
        work = orig.clone()
        if route is None:
            out = kf.panel_trailing_fused_batched(work, col0, 0, panel=panel)
        else:
            out = kf.panel_trailing_fused_batched_at(
                work, col0, 0, panel=panel, route=route, groups=k, group=g)
        return out[:4], work

    def same(a, b):
        return c.same_outputs(a[0], b[0]) and torch.equal(a[1], b[1])

    if "check" in parts:
        for bsz, h, w, panel, dt in CHECKS:
            orig = stack(bsz, h, w, dt)
            col0 = w - h if w >= h else 0
            isz = orig.element_size()
            info = kf.fused_batched_launch_info(bsz, h, w, panel, col0,
                                                itemsize=isz)
            geom = kf.fused_batched_geometry(bsz, h, w, panel, col0, sms=sms,
                                             clusters=info["fit"] if
                                             info["route"] == "cluster"
                                             else None, itemsize=isz)
            key = "panel_trailing_fused_batched" + ("_bf16" if isz == 2
                                                    else "")
            before = _build.LAUNCHES[key]
            by_route = dict(_build.ROUTE_LAUNCHES)
            rule = run(orig, col0, panel)
            torch.cuda.synchronize()
            c.require(_build.LAUNCHES[key] == before + 1, "one launch")
            taken = _build.ROUTE_LAUNCHES.get(f"{key}/{geom.route}", 0)
            c.require(taken == by_route.get(f"{key}/{geom.route}", 0) + 1,
                      f"the launch took the rule's route {geom.route}: "
                      f"{_build.ROUTE_LAUNCHES}")
            alone = True
            for i in range(bsz):
                single = orig[i].clone()
                one = kf.panel_trailing_fused(single, col0, 0, panel=panel)
                alone = alone and c.same_outputs(
                    one[:4], [f[i] for f in rule[0]]) and torch.equal(
                    single, rule[1][i])
            plain = kf.panel_trailing_fused_plain(orig[0].clone(), col0, 0,
                                                  panel=panel)
            piv = torch.equal(plain[1], rule[0][1][0])
            where = f"({bsz}, {h}, {w}) panel {panel} {dt}"
            print(f"check {where}: C info {info}; rule {tuple(geom)}; "
                  f"members == kernel 2 alone bit for bit: {alone}; member "
                  f"0's pivots == plain: {piv} [{card}]")
            c.require(alone and piv and info["route"] == geom.route
                      and info["groups"] == geom.groups
                      and info["group"] == geom.group
                      and info["grid"] == geom.grid, f"check {where}")
            others = [("block", 0, 0)]
            if kf.panel_geometry(h, panel, isz).route == "cluster":
                others.append(("cluster", 0, 0))
            k, g = kf.group_size(bsz, h, panel, isz, sms)
            if g:
                others += [("grid", k, max(1, g // 2)),
                           ("grid", max(1, k // 2), g)]
            for route, k2, g2 in others:
                if ((route, k2, g2) == (geom.route, geom.groups, geom.group)
                        or (route == "grid" and kf.cluster_smem_bytes(
                            -(-h // g2), panel, isz) > kf.PANEL_SMEM_MAX)):
                    continue
                got = run(orig, col0, panel, route, k2, g2)
                torch.cuda.synchronize()
                ok = same(got, rule)
                print(f"check {where} on {route} K={k2} G={g2}: == the "
                      f"rule's launch bit for bit: {ok} [{card}]")
                c.require(ok, f"check {where} on {route} {k2} {g2}")
            del orig, rule

    if "sweep" in parts:
        sweep = SWEEP
        if args.sweep:
            sweep = {}
            for item in args.sweep.split(";"):
                b, h, w, p, dt, kgs = item.split(":")
                sweep[(int(b), int(h), int(w), int(p), dt)] = tuple(
                    tuple(int(x) for x in kg.split(".")) for kg in
                    kgs.split(","))
        for (bsz, h, w, panel, dt), kgs in sweep.items():
            orig = stack(bsz, h, w, dt)
            col0 = w - h
            isz = orig.element_size()
            work = orig.clone()
            geom = kf.fused_batched_geometry(bsz, h, w, panel, col0, sms=sms,
                                             itemsize=isz)
            reset = lambda: work.copy_(orig)  # noqa: E731
            times = {"rule": cuda_event_ms(
                lambda: kf.panel_trailing_fused_batched(
                    work, col0, 0, panel=panel), args.reps, setup=reset)}
            forms = [("grid", k, g) for k, g in kgs]
            if kf.panel_geometry(h, panel, isz).route == "cluster":
                forms.append(("cluster", 0, 0))
            forms.append(("block", 0, 0))
            for route, k, g in forms:
                reps = args.reps if route != "block" else max(3,
                                                              args.reps // 4)
                times[f"{route} K={k} G={g}" if route == "grid"
                      else route] = cuda_event_ms(
                    lambda: kf.panel_trailing_fused_batched_at(
                        work, col0, 0, panel=panel, route=route, groups=k,
                        group=g), reps, setup=reset)
            times["kernel 2 looped"] = cuda_event_ms(
                lambda: [kf.panel_trailing_fused(work[i], col0, 0,
                                                 panel=panel)
                         for i in range(bsz)], max(3, args.reps // 4),
                setup=reset)
            best = min(times, key=times.get)
            print(f"sweep ({bsz}, {h}, {w}) panel {panel} col0 {col0} {dt}: "
                  f"rule {geom.route} K={geom.groups} G={geom.group}; ms: "
                  + ", ".join(f"{k} {t:.4f}" for k, t in times.items())
                  + f"; fastest {best} [{card}]")
            del orig, work

    if "factor" in parts:
        from gauss_tpu_torch.core import blocked

        for n, dt in ((1024, "float32"), (2048, "float32"),
                      (4096, "float32"), (2048, "bfloat16")):
            a = np.random.default_rng(SEED + n).standard_normal((8, n, n))
            a[:, np.arange(n), np.arange(n)] += float(n)
            x = torch.as_tensor(a, dtype=torch.float32, device=dev)
            s = x.to(getattr(torch, dt))
            ms = cuda_event_ms(lambda: blocked.lu_factor_blocked_batched(
                s, device="cuda"), 5, warmup=1)
            with c.quiet_fd1():
                lib = cuda_event_ms(lambda: torch.linalg.lu_factor(x), 5,
                                    warmup=1)
            print(f"factor lu_factor_blocked_batched (8, {n}, {n}) {dt}: "
                  f"{ms:.3f} ms (median of 5); lu_factor on the float32 "
                  f"stack {lib:.3f} [{card}]")
            del a, x, s
    return 0


if __name__ == "__main__":
    sys.exit(main())

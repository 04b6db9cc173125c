#!/usr/bin/env python3
"""The grid route of kernels 1 and 2 on the card: build, registers, bit for
bit checks, a sweep of G, and times beside the one-block route.

    python3 scripts/probe_grid.py [--reps 20]
        [--parts check,sweep,fused,factor] [--sweep H:PANEL:G,G,...;...]

Builds the port's panel kernels, prints ``nvcc -Xptxas -v``'s registers and
spills of the grid kernels, then, on random inputs seeded 258458:

- ``check``: kernel 1's grid route bit for bit against
  ``panel_factor_plain`` at (4096, 256), (7424, 256) and (12800, 128) in
  float32 and (7424, 256) in bfloat16, on a min matrix (ties in every
  column), with a NaN, with an all-zero column, and at kb > 0; kernel 2's
  route at (4096, 4096) and (8192, 1024), both dtypes (the grid route but
  at bfloat16 (4096, 4096), which a cluster holds): its panel,
  pivots and min |pivot| bit for bit the plain version's, its block bit
  for bit the unfused pair's (kernel 1 + reconstruction + kernel 3);
- ``sweep``: kernel 1 at each G of ``--sweep`` (default: SWEEP), the
  rule's G among them, beside the one-block kernel
  (``panel_factor_one_block``) and ``torch.linalg.lu_factor`` on the same
  strip: median ms of ``--reps`` calls by CUDA events, and us per pivot
  step;
- ``fused``: kernel 2 at (4096, 4096) and (8192, 1024), both dtypes,
  median ms, beside its one-block route on the same block
  (``panel_trailing_fused_one_block``);
- ``factor``: one chunked factorization at n=8192 (panel 256, chunk 4)
  and n=12,800 (panel 128, chunk 8) in float32 and at n=8192 in bfloat16,
  median of 3, beside ``torch.linalg.lu_factor`` on the same float32
  matrix.

Every line ends with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
SEED = 258458
# (h, panel) -> G values kernel 1's grid route is timed at.
SWEEP = {(4096, 256): (32, 48, 64, 96, 128),
         (7424, 256): (36, 58, 87, 116, 132),
         (12800, 128): (67, 100, 132)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parts", default="check,sweep,fused,factor")
    ap.add_argument("--sweep", default=None,
                    help="H:PANEL:G,G,...;... (default: SWEEP)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("probe_grid: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.kernels import panel_fused as kf
    from gauss_tpu_torch.utils.timing import cuda_event_ms

    card = c.smi_line()
    parts = set(args.parts.split(","))
    built = _build.build_all(("panel_grid", "panel_fused", "panel_factor",
                              "panel_cluster"))
    print(f"built {built} [{card}]")
    for src in ("panel_grid", "panel_fused"):
        for k, (regs, spill, smem) in sorted(c.ptxas_usage(src).items()):
            if "grid" in k:
                print(f"ptxas -v csrc/{src}.cu {k}: {regs} registers, "
                      f"{spill} bytes of spill stores, {smem} bytes of "
                      f"static shared memory")
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")

    def strip(kind, h, panel, dt):
        x = rng.standard_normal((h, panel))
        if kind == "ties":
            from gauss_tpu_torch.io import synthetic
            x = synthetic.internal_matrix(h)[:, :panel]
        elif kind == "nan":
            x[h // 3, 7] = np.nan
        elif kind == "zero":
            x[:, 5] = 0.0
        return torch.as_tensor(x, dtype=torch.float32, device=dev).to(dt)

    if "check" in parts:
        f32, bf16 = torch.float32, torch.bfloat16
        for h, panel, kb, kind, dt in (
                (4096, 256, 0, "random", f32), (7424, 256, 0, "random", f32),
                (12800, 128, 0, "random", f32), (7424, 256, 0, "random", bf16),
                (4096, 256, 0, "ties", f32), (4096, 256, 0, "nan", f32),
                (4096, 256, 0, "zero", f32), (4096, 256, 300, "random", f32),
                (6912, 256, 0, "random", bf16)):
            x = strip(kind, h, panel, dt)
            geom = kp.panel_geometry(h, panel, x.element_size())
            key = "panel_factor_grid" + kp.launch_suffix(dt)
            before = _build.LAUNCHES[key]
            got = kp.panel_factor(x, kb)
            torch.cuda.synchronize()
            want = kp.panel_factor_plain(x, kb)
            same = all(torch.equal(torch.isnan(g), torch.isnan(w)) and
                       torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
                       if g.is_floating_point() else torch.equal(g, w)
                       for g, w in zip(got, want))
            info = kp.panel_grid_info(h, panel, 0, x.element_size())
            print(f"check kernel 1 ({h}, {panel}) kb={kb} {kind} {dt}: "
                  f"route {geom.route}, G {geom.blocks}, C info {info}, "
                  f"launches +{_build.LAUNCHES[key] - before}, bit for bit "
                  f"{same} [{card}]")
            c.require(same and geom.route == "grid"
                      and info["grid"] == geom.blocks
                      and info["rows_per_block"] == geom.rows_per_block
                      and info["smem_bytes"] == geom.smem_bytes
                      and _build.LAUNCHES[key] == before + 1,
                      f"kernel 1 grid at ({h}, {panel})")
        for h, w in ((4096, 4096), (8192, 1024)):
            for dt in (torch.float32, torch.bfloat16):
                orig = strip("random", h, w, dt)
                work = orig.clone()
                got = kf.panel_trailing_fused(work, 0, 0, panel=256)
                want = kf.panel_trailing_fused_plain(orig.clone(), 0, 0,
                                                     panel=256)
                pair = orig.clone()
                p2, i2, q2, m2 = kp.panel_factor(pair[:, :256], 0)
                mult, onehot = kf.reconstruct_mult_pt(p2, i2, q2, 0, 256)
                kf.trailing_update(pair, mult, onehot, 0)
                torch.cuda.synchronize()
                info = kf.fused_launch_info(h, w, 256, 0,
                                            itemsize=orig.element_size())
                geom = kf.fused_geometry(h, w, 256, 0,
                                         itemsize=orig.element_size())
                ok = (c.same_outputs(got[:4], want[:4])
                      and torch.equal(pair, work))
                err = float((work.float() - want[4].float()).abs().max())
                print(f"check kernel 2 ({h}, {w}) {dt}: C info {info}, "
                      f"rule {tuple(geom)}; panel and pivots == plain and "
                      f"block == pair: {ok}; block max |kernel - plain| "
                      f"{err:g} [{card}]")
                c.require(ok and info["route"] == geom.route
                          and info["group"] == geom.group
                          and info["grid"] == geom.grid,
                          f"kernel 2 grid at ({h}, {w})")

    if "sweep" in parts:
        sweep = SWEEP
        if args.sweep:
            sweep = {}
            for item in args.sweep.split(";"):
                h, panel, gs = item.split(":")
                sweep[(int(h), int(panel))] = tuple(
                    int(g) for g in gs.split(","))
        for (h, panel), gs in sweep.items():
            x = strip("random", h, panel, torch.float32)
            want = kp.panel_factor_plain(x, 0)
            rule = kp.panel_geometry(h, panel)
            times = {}
            for g in sorted(set(gs) | {rule.blocks}):
                got = kp.panel_factor_grid(x, 0, g)
                c.require(c.same_outputs(got, want),
                          f"G={g} at ({h}, {panel}) differs")
                times[g] = cuda_event_ms(
                    lambda: kp.panel_factor_grid(x, 0, g), args.reps)
            one = cuda_event_ms(lambda: kp.panel_factor_one_block(x, 0),
                                max(3, args.reps // 4))
            with c.quiet_fd1():
                lib = cuda_event_ms(lambda: torch.linalg.lu_factor(x),
                                    args.reps)
            best = min(times, key=times.get)
            print(f"sweep kernel 1 ({h}, {panel}) ms: "
                  + ", ".join(f"G={g} {t:.4f} ({1e3 * t / panel:.2f} us a "
                              f"step)" for g, t in times.items())
                  + f"; fastest G={best}, the rule's G={rule.blocks}; "
                  f"one-block {one:.4f}; lu_factor {lib:.4f} [{card}]")

    if "fused" in parts:
        for h, w in ((4096, 4096), (8192, 1024)):
            for dt in (torch.float32, torch.bfloat16):
                orig = strip("random", h, w, dt)
                work = orig.clone()
                ms = cuda_event_ms(
                    lambda: kf.panel_trailing_fused(work, 0, 0, panel=256),
                    args.reps, setup=lambda: work.copy_(orig))
                one = cuda_event_ms(
                    lambda: kf.panel_trailing_fused_one_block(
                        work, 0, 0, panel=256), max(3, args.reps // 4),
                    setup=lambda: work.copy_(orig))
                print(f"fused kernel 2 ({h}, {w}) {dt}: {ms:.4f} ms; the "
                      f"one-block route {one:.4f} [{card}]")

    if "factor" in parts:
        from gauss_tpu_torch.core import blocked

        for n, panel, chunk, dt in ((8192, 256, 4, torch.float32),
                                    (12800, 128, 8, torch.float32),
                                    (8192, 256, 4, torch.bfloat16)):
            a32 = torch.as_tensor(np.random.default_rng(SEED + n)
                                  .standard_normal((n, n)),
                                  dtype=torch.float32, device=dev)
            if dt == torch.bfloat16:
                a = torch.as_tensor(c.dominant_system(n, SEED + n)[0],
                                    dtype=dt, device=dev)
            else:
                a = a32
            ms = cuda_event_ms(lambda: blocked.lu_factor_blocked_chunked(
                a, panel=panel, chunk=chunk, device="cuda"), 3, warmup=1)
            with c.quiet_fd1():
                lib = cuda_event_ms(lambda: torch.linalg.lu_factor(a32), 3,
                                    warmup=1)
            print(f"factor n={n} panel {panel} chunk {chunk} {dt}: {ms:.3f} "
                  f"ms (median of 3); lu_factor (float32) {lib:.3f} "
                  f"[{card}]")
            del a, a32
    return 0


if __name__ == "__main__":
    sys.exit(main())

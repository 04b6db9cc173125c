#!/usr/bin/env python3
"""Whether chip_smoke's limits for the bfloat16 fused and trailing kernels
catch a kernel that breaks the precision contract, on the card.

    python3 scripts/probe_bf16_faults.py [--n 2048]

Builds ``csrc/panel_fused.cu`` once per form into
``build/bf16_faults/<form>/`` (all builds in parallel, as
``scripts/probe_fused.py`` does), loads each in place of the built library,
and on one random (n, n) bfloat16 block seeded 258458, panel 256 at column
0, holds the fused kernel and the trailing kernel (on the panel kernel's
eliminations) against their plain versions, as phase 7 of
``chip_smoke.py`` does. ``full`` is the kernel as it is; each other form
plants one fault in phase B's bfloat16 arithmetic:

- ``no-ulow``: a segment's U is applied in float32, not rounded to
  bfloat16 first;
- ``per-panel``: the trailing elements are rounded once at the end of the
  panel, not once per ``fseg`` segment;
- ``bf16-acc``: the segment's sum of products is rounded to bfloat16 after
  every term.

Prints, per form and kernel, max |kernel - plain| in bfloat16 ulps of the
block's largest value (``TOL_BF16`` allows 4) and the share of the
trailing elements that differ (``TOL_BF16_SHARE``), and which limit trips.
Exits 0 when ``full`` passes both limits and every fault trips one.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
PANEL = 256
ULP = 2.0 ** -7
# form -> [(text in csrc/panel_fused.cu or .cuh, its replacement)]
FAULTS = {
    "full": [],
    "no-ulow": [("      const float ulow = gtt_r<T>(v[jj]);",
                 "      const float ulow = v[jj];"),
                ("        const float ulow = gtt_r<T>(v[j][hh]);",
                 "        const float ulow = v[j][hh];")],
    "per-panel": [(f"          t[ra].{x} = gtt_r<T>(__fsub_rn(t[ra].{x}, "
                   f"acc[ra][{i}]));",
                   f"          t[ra].{x} = __fsub_rn(t[ra].{x}, "
                   f"acc[ra][{i}]);") for i, x in enumerate("xyzw")]
    + [("          t[ra][b] = gtt_r<T>(__fsub_rn(t[ra][b], acc[ra][b]));",
        "          t[ra][b] = __fsub_rn(t[ra][b], acc[ra][b]);")],
    "bf16-acc": [("      for (int b = 0; b < 4; ++b) acc[a][b] = "
                  "fmaf(mv[a], uv[b], acc[a][b]);",
                  "      for (int b = 0; b < 4; ++b) acc[a][b] = "
                  "gtt_r<gtt_bf16>(fmaf(mv[a], uv[b], acc[a][b]));")],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "scripts"))
    import torch

    from chip_smoke import (TOL_BF16, TOL_BF16_SHARE, bf16_block_stats,
                            smi_line)
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.kernels import panel_fused as kf
    from probe_fused import build_forms, load_form

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    print(f"probe: {smi_line()}")
    built = build_forms(list(FAULTS), _build.find_nvcc(), _build.NVCC_FLAGS,
                        edits=FAULTS, out="bf16_faults")
    n = args.n
    dev = torch.device("cuda")
    orig = torch.as_tensor(np.random.default_rng(258458).standard_normal(
        (n, n)), dtype=torch.float32, device=dev).to(torch.bfloat16)
    ref = kf.panel_trailing_fused_plain(orig.clone(), 0, 0, panel=PANEL)[4]
    p, ipiv, perm, _ = kp.panel_factor(orig[:, :PANEL].clone(), 0)
    mult, onehot = kf.reconstruct_mult_pt(p, ipiv, perm, 0, PANEL)
    ref3 = kf.trailing_update_plain(orig.clone(), mult, ipiv, 0,
                                    kf.FUSED_FSEG_SEED)
    ok = True
    for form in FAULTS:
        load_form(built[form])
        got = orig.clone()
        kf.panel_trailing_fused(got, 0, 0, panel=PANEL)
        got3 = orig.clone()
        kf.trailing_update(got3, mult, onehot, 0)
        torch.cuda.synchronize()
        line = []
        for kernel, g, r in (("fused", got, ref), ("trailing", got3, ref3)):
            err, scale, share = bf16_block_stats(g, r, PANEL)
            trips = [name for name, hit in (
                ("TOL_BF16", err > TOL_BF16 * scale),
                ("TOL_BF16_SHARE", share > TOL_BF16_SHARE)) if hit]
            ok &= bool(trips) != (form == "full")
            line.append(f"{kernel} {err / scale / ULP:.3f} ulps of max, "
                        f"{share:.5f} of the trailing elements differ, trips "
                        f"{' and '.join(trips) or 'nothing'}")
        print(f"probe: form {form} at ({n}, {n}): " + "; ".join(line))
    print(f"probe: {'every fault caught' if ok else 'NOT every fault caught'}"
          f" (TOL_BF16 {TOL_BF16 / ULP:g} ulps of max, TOL_BF16_SHARE "
          f"{TOL_BF16_SHARE})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

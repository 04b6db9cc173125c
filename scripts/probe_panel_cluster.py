#!/usr/bin/env python3
"""Where a pivot step of the cluster panel-factor kernel spends its cycles.

    python3 scripts/probe_panel_cluster.py [--shapes 256:16,2048:16]

Builds an instrumented copy of ``gauss_tpu_torch/kernels/csrc/
panel_cluster.{cu,cuh}`` into ``build/panel_probe/``: threads 0 (warp 0,
which owns the pivot-column work) and 32 (warp 1, one of the warps of the
bulk rank-1 update) of every block sum ``clock64()`` cycles per phase of
the step loop. Then, for each ``h:C`` of ``--shapes`` (panel 256), it
launches the copy on a random strip, checks the pivots against the plain
version, times 20 queued launches by CUDA events (the raw kernel, no
wrapper work), and prints the cycles per pivot step of each phase, block
0's and the largest over the blocks. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
# (anchor in panel_cluster.cuh, replacement with the phase marks).
MARKS = [
    ("    cluster.barrier_wait();\n    unsigned key = 0;",
     "    PT(0)\n    cluster.barrier_wait();\n    PT(1)\n    unsigned key = 0;"),
    ("    // 3. Warp 0 computes", "    PT(2)\n    // 3. Warp 0 computes"),
    ("    __syncthreads();  // u and m;", "    PT(3)\n    __syncthreads();  // u and m;"),
    ("    // 4. Step j + 1's candidate", "    PT(4)\n    // 4. Step j + 1's candidate"),
    ("    __syncthreads();\n    // 5.", "    PT(5)\n    __syncthreads();\n    PT(6)\n    // 5."),
    ("    gtt_cluster_update(s, j, j + 2, u, m);\n  }",
     "    PT(7)\n    gtt_cluster_update(s, j, j + 2, u, m);\n    PT(8)\n  }"),
]
PHASES = ["loop", "wait", "pivot", "mult|pull", "syncA", "candidate",
          "syncB", "arrive", "update"]


def instrumented(out: Path) -> Path:
    src = REPO / "gauss_tpu_torch" / "kernels" / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    (out / "panel_common.cuh").write_text((src / "panel_common.cuh").read_text())
    h = (src / "panel_cluster.cuh").read_text()
    for anchor, marked in MARKS:
        if anchor not in h:
            raise SystemExit(f"probe: anchor not found in panel_cluster.cuh: "
                             f"{anchor!r}")
        h = h.replace(anchor, marked, 1)
    h = h.replace(
        "namespace gtt_cg = cooperative_groups;",
        "namespace gtt_cg = cooperative_groups;\n"
        "__device__ unsigned long long g_probe[320];")
    h = h.replace(
        "  float minp = INFINITY;\n",
        "  float minp = INFINITY;\n"
        "  unsigned long long acc[9] = {0}, last = clock64();\n"
        "#define PT(k) if (tid == 0 || tid == 32) { const unsigned long long "
        "now = clock64(); acc[k] += now - last; last = now; }\n", 1)
    h = h.replace(
        "  cluster.sync();\n  return minp;\n}",
        "  cluster.sync();\n  if (tid == 0 || tid == 32) for (int k = 0; "
        "k < 9; ++k) g_probe[(rank * 2 + (tid == 32)) * 10 + k] = acc[k];\n"
        "  return minp;\n}")
    (out / "panel_cluster.cuh").write_text(h)
    c = (src / "panel_cluster.cu").read_text() + (
        '\nextern "C" int gtt_probe_read(unsigned long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_probe, "
        "sizeof(unsigned long long) * 320);\n}\n")
    (out / "panel_cluster.cu").write_text(c)
    return out / "panel_cluster.cu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="256:2,256:16,1024:16,2048:16",
                    help="comma-separated h:C (panel 256)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel as kp

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    work = REPO / "build" / "panel_probe"
    source = instrumented(work)
    so = work / f"libprobe-{os.getpid()}.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(so), str(source)], capture_output=True, text=True)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gtt_panel_factor_cluster_at.argtypes = [P, I, I, I, I, P, P, P, P,
                                                P, I, P]
    lib.gtt_probe_read.argtypes = [P]
    rng = np.random.default_rng(258458)
    panel = 256
    for shape in args.shapes.split(","):
        h, c = (int(v) for v in shape.split(":"))
        dev = torch.device("cuda")
        x = torch.as_tensor(rng.standard_normal((h, panel)),
                            dtype=torch.float32, device=dev)
        pt = torch.empty((panel, h), device=dev)
        ipiv = torch.empty(panel, dtype=torch.int32, device=dev)
        inv = torch.empty(h, dtype=torch.int32, device=dev)
        chosen = torch.empty_like(inv)
        minpiv = torch.empty(1, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            _build.check(lib, lib.gtt_panel_factor_cluster_at(
                x.data_ptr(), panel, h, panel, 0, pt.data_ptr(),
                ipiv.data_ptr(), inv.data_ptr(), chosen.data_ptr(),
                minpiv.data_ptr(), c, stream), "probe")

        launch()
        torch.cuda.synchronize()
        same = torch.equal(ipiv, kp.panel_factor_plain(x, 0)[1])
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(20):
            launch()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 20
        buf = (ctypes.c_ulonglong * 320)()
        lib.gtt_probe_read(buf)
        acc = np.array(buf[:c * 20], dtype=np.float64).reshape(c, 2, 10)
        acc = acc[:, :, :len(PHASES)] / panel
        print(f"({h}, {panel}) C={c}: raw kernel {ms:.4f} ms "
              f"({1e3 * ms / panel:.2f} us per pivot step), pivots equal to "
              f"the plain version: {same}")
        for label, row in (("warp 0, block 0", acc[0, 0]),
                           ("warp 0, max", acc[:, 0].max(0)),
                           ("warp 1, block 0", acc[0, 1])):
            print(f"  {label}: cycles per step "
                  + ", ".join(f"{n} {v:.0f}" for n, v in zip(PHASES, row)))
    so.unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The batched panel kernel (``csrc/panel_batched.cu``) on the card: its
step loops' registers, bit for bit checks, and times at the shapes the
service and the block-diagonal lane launch; the register loop's other
mappings as source edits.

    python3 scripts/probe_panel_batched.py [--root DIR] [--reps 20]
        [--parts ptxas,check,time] [--shapes B:H:PANEL:DTYPE,...]
        [--forms base,r4c4,r8c8x2,x-no-bulk,...]
    python3 scripts/probe_panel_batched.py --compare PARENT_DIR [...]

Imports ``gauss_tpu_torch`` from the checkout at ``--root`` (default: this
one) and builds its kernels. Random stacks from seed 258458, one per
shape:

- ``ptxas``: ``nvcc -Xptxas -v``'s registers, spill stores and static
  shared memory of every kernel of ``csrc/panel_batched.cu``;
- ``check``: at every shape, one launch, the route the launcher took
  equal to ``panel_batched_geometry``'s, every output equal to the plain
  version's and every member's to kernel 1 on it alone (NaN where NaN);
  also on a stack whose first member has a zero column (a zero pivot, inf
  and NaN multipliers) and one with a NaN entry;
- ``time``: device ms of ``--reps`` queued launches (``chip_smoke.
  device_ms``) at each shape, beside the bound
  (``chip_smoke.batched_bound``) and ``torch.linalg.lu_factor`` on the
  float32 stack;
- ``others``: the kernels beside it that must not move: kernel 1 at
  (256, 256) and (4096, 256), kernel 2 at (2048, 2048) and the batched
  fused kernel at (8, 2048, 2048) (each on a fresh copy, the copy timed
  too).

``--forms a,b``: each named text edit of the source (:data:`FORMS`: the
register loop's other mappings, and ablations) built beside it, checked
against the plain version and timed at every shape (the wrapper's call
and the C launch alone).

``--compare PARENT_DIR`` runs ``--parts time,others`` four times, each in its own
process, parent / this checkout / this checkout / parent (``--root``), and
prints every shape's four times on one line: two trees on one card, in
turns. One JSON line per run ends with the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
SEED = 258458
# (B, h, panel, dtype): the service's last panels (batches of 1, 2, 4 and
# 8 at panel 128 and 256, both lanes), the block-diagonal lane's stack,
# the route edges and a member just past them, and a tall member.
SHAPES = ((1, 128, 128, "float32"), (2, 128, 128, "float32"),
          (4, 128, 128, "float32"), (8, 128, 128, "float32"),
          (64, 128, 128, "float32"), (1, 256, 256, "float32"),
          (2, 256, 256, "float32"), (4, 256, 256, "float32"),
          (8, 256, 256, "float32"), (1, 128, 128, "bfloat16"),
          (4, 128, 128, "bfloat16"), (8, 128, 128, "bfloat16"),
          (1, 256, 256, "bfloat16"), (2, 256, 256, "bfloat16"),
          (8, 256, 256, "bfloat16"), (64, 128, 128, "bfloat16"),
          (64, 32, 32, "float32"))
CHECK_EXTRA = ((3, 129, 128, "float32"), (2, 257, 256, "float32"),
               (5, 100, 16, "float32"), (3, 512, 128, "float32"),
               (2, 200, 64, "bfloat16"))


# Text edits of csrc/panel_batched.cu timed beside it (``--forms``).
_REGS = "#define GTT_REGS_MAP 4, 8, 512 "
_CLUSTER = "#define GTT_CLUSTER_MAP 8, 8, 4, 256 "
FORMS = {
    "base": [],
    # The register loop's other mappings of the same reach (RI, CK, NT on
    # one block; RI, CK, CS, NT on a cluster): (128, 128) on 32 or 8
    # warps; (256, 256) on a cluster of 2 x 16 warps, 4 x 16, 2 x 8, and
    # one block of 32 warps (registers alone: it spills).
    "r4c4": [(_REGS, "#define GTT_REGS_MAP 4, 4, 1024 ")],
    "r4c16": [(_REGS, "#define GTT_REGS_MAP 4, 16, 256 ")],
    "r8c8x2": [(_CLUSTER, "#define GTT_CLUSTER_MAP 8, 8, 2, 512 ")],
    "r8c4x4": [(_CLUSTER, "#define GTT_CLUSTER_MAP 8, 4, 4, 512 ")],
    "r8c16x2": [(_CLUSTER, "#define GTT_CLUSTER_MAP 8, 16, 2, 256 ")],
    "r8c8x1": [(_CLUSTER, "#define GTT_CLUSTER_MAP 8, 8, 1, 1024 ")],
    # Ablations, timed only (their factors are wrong): no rank-1 update but
    # the publishing warp's column; a product for the division.
    "x-no-bulk": [("      if (c > jj && c < panel && k != skip) update(k, m, "
                   "pi, ps);", "")],
    "x-no-div": [("gtt_r<T>(__fdiv_rn(v[i], piv))",
                  "gtt_r<T>(__fmul_rn(v[i], piv))")],
}


def build_forms(forms) -> dict:
    """csrc/panel_batched.cu built once per form of :data:`FORMS` into
    ``build/batched_probe/<form>/``, in parallel: the libraries by form."""
    import shutil

    from gauss_tpu_torch.kernels import _build

    csrc = _build.CSRC
    base = (csrc / "panel_batched.cu").read_text()
    jobs = {}
    for form in forms:
        text = base
        for old, new in FORMS[form]:
            if text.count(old) != 1:
                raise SystemExit(f"probe: form {form}: {old!r} not found once")
            text = text.replace(old, new)
        d = HERE / "build" / "batched_probe" / form
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        (d / "panel_batched.cu").write_text(text)
        so = d / "libgtt_panel_batched.so"
        jobs[form] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(d / "panel_batched.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for form, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: nvcc {form} failed:\n{log[-3000:]}")
    return {form: so for form, (so, _) in jobs.items()}


def load_form(so) -> None:
    """A built form in place of the library ``_build`` built."""
    import ctypes

    from gauss_tpu_torch.kernels import _build

    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build._SIGNATURES["panel_batched"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.gtt_error_string.argtypes = [ctypes.c_int]
    lib.gtt_error_string.restype = ctypes.c_char_p
    _build._libs["panel_batched"] = lib


def raw_launch(_build, x):
    """The C launch alone on preallocated outputs (no wrapper: no
    allocation, permutation or gather), for the kernel's own time."""
    import ctypes

    import torch

    bsz, h, panel = x.shape
    pt = torch.empty((bsz, panel, h), dtype=x.dtype, device=x.device)
    out = torch.empty((bsz, h, panel), dtype=x.dtype, device=x.device)
    perm = torch.empty((bsz, h), dtype=torch.int64, device=x.device)
    ints = torch.empty((bsz, panel + 2 * h), dtype=torch.int32,
                       device=x.device)
    minpiv = torch.empty(bsz, dtype=x.dtype, device=x.device)
    taken = (ctypes.c_int * 1)()
    lib = _build.library("panel_batched")
    fn = getattr(lib, "gtt_panel_factor_batched"
                 + ("_bf16" if x.element_size() == 2 else ""))
    ip, iv, ch = (ints[:, :panel], ints[:, panel:panel + h],
                  ints[:, panel + h:])

    def go():
        rc = fn(x.data_ptr(), x.stride(0), x.stride(1), bsz, h, panel, 0,
                pt.data_ptr(), ip.data_ptr(), iv.data_ptr(), ch.data_ptr(),
                minpiv.data_ptr(), out.data_ptr(), perm.data_ptr(), taken,
                torch.cuda.current_stream().cuda_stream)
        _build.check(lib, rc, "raw panel_factor_batched")
    return go


def part_forms(c, kp, _build, forms, shapes, reps: int) -> dict:
    """Each form of :data:`FORMS` checked (random stacks, == the plain
    version; the ``x-`` ablations are not) and timed at every shape: the
    wrapper's call and the C launch alone."""
    out = {}
    for form, so in build_forms(forms).items():
        load_form(so)
        for n, shape in enumerate(shapes):
            x = stack(shape, SEED + n)
            want = kp.panel_factor_batched_plain(x.clone())
            ok = form.startswith("x-") or all(
                same(g, w) for g, w in zip(kp.panel_factor_batched(x.clone()),
                                           want))
            ms = c.device_ms(lambda: kp.panel_factor_batched(x), reps)
            kms = c.device_ms(raw_launch(_build, x), reps)
            out[f"{form} {shape}"] = {"ms": ms, "kernel_ms": kms, "ok": ok}
            print(f"form {form} {shape}: {ms:.4f} ms, kernel {kms:.4f} ms, "
                  f"{'ok' if ok else 'DIFFERS'}", flush=True)
    return out


def _smoke():
    """This checkout's ``chip_smoke.py`` (its timing and bound helpers),
    loaded by path whichever checkout ``--root`` names."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse_shapes(text: str):
    out = []
    for tok in text.split(","):
        b, h, p, dt = tok.split(":")
        out.append((int(b), int(h), int(p), dt))
    return tuple(out)


def stack(shape, seed: int):
    import torch

    b, h, p, dt = shape
    x = np.random.default_rng(seed).standard_normal((b, h, p))
    return torch.as_tensor(x, dtype=torch.float32,
                           device="cuda").to(getattr(torch, dt))


def same(g, w) -> bool:
    """Equal values (torch.equal) with NaN equal to NaN."""
    import torch

    if g.shape != w.shape or g.dtype != w.dtype:
        return False
    if g.is_floating_point():
        gn, wn = g.isnan(), w.isnan()
        return torch.equal(gn, wn) and torch.equal(g.masked_fill(gn, 0),
                                                   w.masked_fill(wn, 0))
    return torch.equal(g, w)


def part_check(kp, _build, shapes) -> dict:
    import torch

    out = {}
    for n, shape in enumerate(shapes):
        base = stack(shape, SEED + n)
        cases = {"random": base}
        z = base.clone()
        z[0, :, 0] = 0
        cases["zero_pivot"] = z
        q = base.clone()
        q[-1, shape[1] // 2, 1] = float("nan")
        cases["nan"] = q
        isz = base.element_size()
        key = "panel_factor_batched" + ("_bf16" if isz == 2 else "")
        for case, x in cases.items():
            want = kp.panel_factor_batched_plain(x.clone())
            ones = [kp.panel_factor(x[i].clone()) for i in range(shape[0])]
            before = _build.LAUNCHES[key]
            by_route = dict(getattr(_build, "ROUTE_LAUNCHES", {}))
            got = kp.panel_factor_batched(x.clone())
            torch.cuda.synchronize()
            ok = _build.LAUNCHES[key] == before + 1
            route = None
            if hasattr(kp, "panel_batched_geometry"):
                route = kp.panel_batched_geometry(shape[1], shape[2],
                                                  isz).route
                ok &= _build.ROUTE_LAUNCHES.get(f"{key}/{route}", 0) \
                    == by_route.get(f"{key}/{route}", 0) + 1
            ok &= all(same(g, w) for g, w in zip(got, want))
            for i, one in enumerate(ones):
                ok &= all(same(g[i], w) for g, w in zip(got, one))
            out[f"{shape} {case}"] = {"route": route, "ok": bool(ok)}
            print(f"check {shape} ({route}) {case}: "
                  f"{'ok' if ok else 'DIFFERS'}", flush=True)
    return out


def part_time(c, kp, shapes, reps: int) -> dict:
    import torch

    out = {}
    for n, shape in enumerate(shapes):
        x = stack(shape, SEED + n)
        isz = x.element_size()
        bms, by = c.batched_bound(shape[:3], itemsize=isz)
        rec = {"bound_ms": bms, "bound_by": by}
        rec["ms"] = c.device_ms(lambda: kp.panel_factor_batched(x), reps)
        f32 = x.float()
        with c.quiet_fd1():
            rec["lu_factor_ms"] = c.device_ms(
                lambda: torch.linalg.lu_factor(f32), reps)
        if hasattr(kp, "panel_batched_geometry"):
            rec["route"] = kp.panel_batched_geometry(shape[1], shape[2],
                                                     isz).route
        out[str(shape)] = rec
        print(f"time {shape}: {rec}", flush=True)
    return out


def part_others(c, reps: int) -> dict:
    """The kernels that share the one-block step loop's header, which this
    kernel's change must leave as they were: kernel 1 on its cluster and
    grid routes, kernel 2 and the batched fused kernel (each on a fresh
    copy of a dominant block, the copy included), device ms."""
    import torch

    from gauss_tpu_torch.kernels import panel as kp
    from gauss_tpu_torch.kernels import panel_fused as kf

    rng = np.random.default_rng(SEED)
    out = {}
    for h in (256, 4096):
        x = torch.as_tensor(rng.standard_normal((h, 256)),
                            dtype=torch.float32, device="cuda")
        out[f"kernel 1 ({h}, 256)"] = c.device_ms(lambda: kp.panel_factor(x),
                                                  reps)
    a = rng.standard_normal((8, 2048, 2048))
    a[:, np.arange(2048), np.arange(2048)] += 2048.0
    st = torch.as_tensor(a, dtype=torch.float32, device="cuda")
    out["kernel 2 (2048, 2048)"] = c.device_ms(
        lambda: kf.panel_trailing_fused(st[0].clone(), 0, 0, panel=256), reps)
    out["batched fused (8, 2048, 2048)"] = c.device_ms(
        lambda: kf.panel_trailing_fused_batched(st.clone(), 0, 0, panel=256),
        reps)
    for k, v in out.items():
        print(f"others {k}: {v:.4f} ms", flush=True)
    return out


def compare(args) -> int:
    runs = []
    for root in (args.compare, str(HERE), str(HERE), args.compare):
        cmd = [sys.executable, __file__, "--root", root, "--parts",
               "time,others",
               "--reps", str(args.reps)]
        if args.shapes:
            cmd += ["--shapes", args.shapes]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode:
            print(r.stdout[-3000:] + r.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    labels = ("parent", "change", "change", "parent")
    for shape in runs[0]["time"]:
        row = [runs[i]["time"][shape] for i in range(4)]
        print(f"{shape}: " + ", ".join(
            f"{lab} {r['ms']:.4f}" for lab, r in zip(labels, row))
            + f"; route {row[1].get('route')}; bound "
            f"{row[1]['bound_ms']:.5f} ({row[1]['bound_by']}); lu_factor "
            f"{min(r['lu_factor_ms'] for r in row):.4f}-"
            f"{max(r['lu_factor_ms'] for r in row):.4f}")
    for name in runs[0]["others"]:
        print(f"{name}: " + ", ".join(
            f"{lab} {r['others'][name]:.4f}" for lab, r in zip(labels, runs)))
    print(json.dumps({"compare": {"parent": args.compare, "runs": runs,
                                  "card": runs[0]["card"]}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--compare", default=None, metavar="PARENT_DIR")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parts", default="ptxas,check,time")
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--forms", default=None,
                    help=f"comma list of {tuple(FORMS)}: build and time "
                         f"each text edit of csrc/panel_batched.cu")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(args)
    c = _smoke()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    from gauss_tpu_torch.kernels import _build
    from gauss_tpu_torch.kernels import panel as kp

    _build.build_all(("panel_batched", "panel_cluster", "panel_grid",
                      "panel_factor", "panel_fused", "panel_fused_batched"))
    shapes = parse_shapes(args.shapes) if args.shapes else SHAPES
    parts = args.parts.split(",")
    res = {"root": str(root), "card": c.smi_line()}
    if "ptxas" in parts:
        res["ptxas"] = {k: v for k, v in c.ptxas_usage(
            "panel_batched").items() if "batched" in k}
        for k, v in res["ptxas"].items():
            print(f"ptxas {k}: {v[0]} registers, {v[1]} bytes spill "
                  f"stores, {v[2]} bytes smem", flush=True)
    if "check" in parts:
        res["check"] = part_check(kp, _build, shapes + CHECK_EXTRA)
    if "time" in parts:
        res["time"] = part_time(c, kp, shapes, args.reps)
    if "others" in parts:
        res["others"] = part_others(c, args.reps)
    if args.forms:
        res["forms"] = part_forms(c, kp, _build, args.forms.split(","),
                                  shapes, args.reps)
    print(json.dumps(res))
    bad = [k for part in ("check", "forms")
           for k, v in res.get(part, {}).items() if not v["ok"]]
    if bad:
        print(f"probe: {len(bad)} checks differ: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

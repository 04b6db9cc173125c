"""The port's CLIs (same stdout line shapes and exit codes as the JAX
package's), its import isolation from JAX, the no-CUDA device contract,
and chip_smoke.py's refusal to run without a card."""

import ast
import io
import os
import re
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from gauss_tpu_torch.io import datfile, synthetic

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "gauss_tpu_torch"


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _shape(text):
    """Output lines with numbers, paths and backend names abstracted."""
    out = []
    for line in text.strip().splitlines():
        line = re.sub(r"\S+\.dat", "<file>", line)
        line = re.sub(r"backend (tpu|cuda)", "backend <b>", line)
        out.append(re.sub(r"[-+]?\d[\d.]*(e[-+]\d+)?", "<num>", line))
    return out


def test_internal_cli_matches_jax_line_shapes():
    from gauss_tpu.cli import gauss_internal as jcli
    from gauss_tpu_torch.cli import gauss_internal as tcli

    rc_t, out_t = _run(tcli.main, ["-s", "64", "--verify", "--device",
                                   "cpu"])
    rc_j, out_j = _run(jcli.main, ["-s", "64", "--verify"])
    assert rc_t == rc_j == 0
    assert _shape(out_t) == _shape(out_j)
    assert "Verification: solution pattern (-0.5, 0...0, 0.5) OK" in out_t
    res = float(re.search(r"Residual \|\|Ax-b\|\|: (\S+)", out_t).group(1))
    assert res < 1e-4


@pytest.mark.parametrize("argv", [["--refine", "8"],
                                  ["--backend", "cuda-unblocked"]])
def test_internal_cli_routes(argv):
    from gauss_tpu_torch.cli import gauss_internal as tcli

    rc, out = _run(tcli.main, ["-s", "520", "--verify", "--device", "cpu",
                               *argv])
    assert rc == 0 and "OK" in out


def test_internal_cli_bad_size_falls_back_with_notice():
    from gauss_tpu_torch.cli import gauss_internal as tcli

    p = tcli.build_parser().parse_args(["-s", "-3"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        n = tcli.positive_int_or_default(p.s, tcli.DEFAULT_N, "matrix size")
    assert n == tcli.DEFAULT_N and "Invalid matrix size" in buf.getvalue()


def test_external_cli_matches_jax_line_shapes(tmp_path):
    from gauss_tpu.cli import gauss_external as jcli
    from gauss_tpu_torch.cli import gauss_external as tcli

    path = tmp_path / "gen.dat"
    datfile.write_dat(path, synthetic.generator_matrix(48))
    rc_t, out_t = _run(tcli.main, [str(path), "--device", "cpu"])
    rc_j, out_j = _run(jcli.main, [str(path)])
    assert rc_t == rc_j == 0
    assert _shape(out_t) == _shape(out_j)
    err = float(re.search(r"Error: (\S+)", out_t).group(1))
    assert err <= 1e-4


def test_external_cli_unreadable_file_exit_code(tmp_path):
    from gauss_tpu_torch.cli import gauss_external as tcli

    bad = tmp_path / "bad.dat"
    bad.write_text("2 2 1\n1 1 nan\n0 0 0\n")
    assert _run(tcli.main, [str(bad), "--device", "cpu"])[0] == 1
    assert _run(tcli.main, [str(tmp_path / "missing.dat"), "--device",
                            "cpu"])[0] == 1


def _modules():
    mods = []
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_leaves_jax_and_reference_out():
    """Importing every module of the port loads neither jax nor the JAX
    package (a fresh interpreter, so this test process's imports do not
    count)."""
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'gauss_tpu' or "
            "k.startswith('gauss_tpu.'))\n"
            "assert not bad, bad\n"
            "print('isolated', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "isolated" in r.stdout


def test_no_source_imports_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "gauss_tpu"), (f, name)


def test_entry_points_without_device_raise_on_cudaless_machine(monkeypatch):
    """No device argument and no CUDA: RuntimeError, never a CPU run."""
    from gauss_tpu_torch.cli import gauss_internal as tcli
    from gauss_tpu_torch.core import dsfloat, gauss

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(tcli.main, ["-s", "16"])
    with pytest.raises(RuntimeError, match="CUDA"):
        dsfloat.solve_ds(np.eye(4), np.ones(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        gauss.gauss_solve(np.eye(4), np.ones(4))


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No result and a non-zero exit without a card — in the repository,
    and alone in a directory without the package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    env = dict(os.environ, PYTHONPATH="")
    for cwd in (REPO, alone):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           capture_output=True, text=True, timeout=120,
                           env=env)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_chip_smoke_kernel_phase_rehearsal(monkeypatch):
    """chip_smoke.py's kernel phase on the CPU at a small size, plain
    versions on both sides: its checks (pivots, tolerances, fused == pair)
    and its bound arithmetic run end to end."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from gauss_tpu_torch.utils import timing

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "N", 192)
    monkeypatch.setattr(chip_smoke, "PANEL", 64)
    monkeypatch.setattr(timing, "cuda_event_ms",
                        lambda fn, reps=1, warmup=0, setup=None: 1.0)
    k1, k2, k3 = chip_smoke.phase_kernels(1)
    assert k1["err"] == 0.0 and k1["bound_by"] in ("bytes", "operations")
    assert k2["ms"] == 2.0 and k3["ms"] == 2.0  # two fused shapes
    assert 0 < k2["bound_ms"] and k2["err"] == 0.0


def test_chip_smoke_elim_matmul_phase_rehearsal(monkeypatch):
    """chip_smoke.py's row-elimination and matmul kernel phase on the CPU
    at a small size, plain versions on both sides: its checks, its shapes
    (the batched solve's augmented matrix) and its bounds run end to end;
    the n=2048 bounds are the issue's figures."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from gauss_tpu_torch.utils import timing

    assert chip_smoke.rowelim_shape(2048) == (2048, 2304, 256)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "N", 200)
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, reps: 1.0)
    monkeypatch.setattr(timing, "cuda_event_ms",
                        lambda fn, reps=1, warmup=0, setup=None: 1.0)
    out = chip_smoke.phase_elim_matmul_kernels(1)
    for name in ("matmul_tiled", "matmul_stripe"):
        assert out[name]["high"]["err"] == out[name]["highest"]["err"] == 0.0
    assert out["matmul_stripe"]["default"]["err"] == 0.0
    assert out["eliminate_step"]["bound_by"] == "bytes"
    assert out["rankk_update"]["err"] == 0.0
    assert out["panel_batched_ms"] == 1.0  # one 256-row strip at n=200
    # The bounds at n=2048, as the kernel sources state them.
    assert round(chip_smoke.bound(3.0 * 2048 ** 2 * 4, 2.0 * 2048 ** 3)[0],
                 3) == 0.256
    assert round(chip_smoke.bound(3.0 * 2048 ** 2 * 4, 6.0 * 2048 ** 3,
                                  chip_smoke.PEAK_BF16_FLOP_S)[0], 3) == 0.052
    assert chip_smoke.bound(2.0 * 2048 * 2304 * 4,
                            2.0 * 2048 * 2304) == pytest.approx(
        (0.01127, "bytes"), rel=1e-3)

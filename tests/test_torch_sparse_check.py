"""The sparse plane as a whole on the CPU: ``python -m
gauss_tpu_torch.sparse.check`` (exit codes, lines, summary), its giant leg's
budget arithmetic, and chip_smoke.py's sparse phases rehearsed at a small
size with the kernel's plain version on both sides."""

import io
import json
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.sparse import check

REPO = Path(__file__).resolve().parent.parent


def _run(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = check.main(argv)
    return rc, buf.getvalue()


def test_check_smoke_leg_lines_and_summary(tmp_path):
    summary = tmp_path / "out" / "summary.json"
    rc, out = _run(["--skip-giant", "--device", "cpu", "--repeats", "2",
                    "--summary-json", str(summary)])
    assert rc == 0
    lines = out.strip().splitlines()
    assert lines[0].startswith("sparse-check [routed   ] n=   640 "
                               "detected=sparse ")
    assert lines[0].endswith("OK")
    for line, method in zip(lines[1:4], ("cg", "gmres", "bicgstab")):
        assert line.startswith(f"sparse-check [{method:9s}] n=   640 "
                               f"precond=jacobi ")
        assert "rel_residual=" in line and line.endswith("OK")
    assert "4 leg(s)" in lines[4] and "all verified at the 1e-04 gate" in (
        lines[4])
    assert lines[5] == f"summary: {summary}"
    data = json.loads(summary.read_text())
    assert data["kind"] == "sparse_solve" and data["ok"] is True
    assert data["giant"] is None and data["device"] == "cpu"
    assert data["routed"]["detected"] == "sparse"
    assert data["routed"]["certified_spd"] is True
    # The iteration counts of the seeded smoke system, as the JAX cores
    # give them (tests/test_torch_sparse_krylov.py holds the cores equal).
    assert {m: r["iterations"] for m, r in data["methods"].items()} == {
        "cg": 9, "gmres": 32, "bicgstab": 6}
    assert all(r["verified"] and r["rel_residual"] <= 1e-4
               for r in data["methods"].values())


def test_check_fails_with_exit_2_when_a_leg_misses_the_gate():
    # An unreachable gate: the routed leg (first) sees every rung of the
    # sparse ladder miss it, and the ladder's typed error reaches the
    # caller, which the check does not swallow.
    from gauss_tpu_torch.resilience.recover import (UnrecoverableSolveError,
                                                    structured_rungs)

    with pytest.raises(UnrecoverableSolveError) as ei:
        _run(["--skip-giant", "--device", "cpu", "--gate", "1e-300",
              "--repeats", "1"])
    assert ei.value.attempts == [(r, "residual")
                                 for r in structured_rungs("sparse")]
    # The methods' legs: each stagnates typed inside solve_sparse.
    from gauss_tpu_torch.io import synthetic
    from gauss_tpu_torch.sparse import IterativeStagnationError, solve_sparse
    from gauss_tpu_torch.sparse.csr import CsrMatrix

    a = CsrMatrix.from_coords(640, *synthetic.sparse_coords(640, 8,
                                                            seed=258458))
    for method in ("cg", "gmres", "bicgstab"):
        with pytest.raises(IterativeStagnationError):
            solve_sparse(a, np.ones(640), method=method, gate=1e-300,
                         device="cpu")
    # A system too dense to classify sparse: the routed leg fails, exit 2.
    rc, out = _run(["--skip-giant", "--device", "cpu", "--smoke-n", "64",
                    "--repeats", "1"])
    assert rc == 2 and "FAILED: ['routed']" in out
    assert "FAIL" in out.splitlines()[0]


def test_check_giant_leg_small_order_fails_the_budget_margin():
    """The giant leg asserts the dense operand would exceed the budget
    tenfold: at a small order that margin is missing and the leg says so
    (the solve itself verifies)."""
    row = check.run_giant(2000, 8, 258458, 1e-4, device="cpu")
    assert row["verified"] and row["rel_residual"] <= 1e-4
    assert row["method"] == "cg" and row["precond"] == "jacobi"
    assert row["device_peak_bytes"] is None  # no card: host budget only
    assert row["dense_bytes"] == 8 * 2000 * 2000
    assert row["no_densify_ok"] is False
    assert row["ell_shape"][0] == 2000 and row["assembly_s"] >= 0


def test_check_giant_leg_line(monkeypatch):
    monkeypatch.setattr(check, "PEAK_BUDGET_BYTES", 1 << 29)
    rc, out = _run(["--device", "cpu", "--giant-n", "30000",
                    "--giant-nnz-per-row", "8", "--repeats", "1"])
    giant = [ln for ln in out.splitlines() if "[giant    ]" in ln]
    assert len(giant) == 1 and "n= 30000" in giant[0]
    assert "peak_rss=" in giant[0] and "(budget 0 GiB, dense would be 7 GiB)" \
        in giant[0]
    assert "device_peak" not in giant[0] and "over the leg's start" in (
        giant[0])
    assert "5 leg(s)" in out
    # The budget is held on what the leg adds, so what this process held
    # before the leg does not decide it.
    assert rc == 0 and giant[0].endswith("OK")


def test_leg_rss_sees_what_the_block_adds():
    with check._LegRss(interval=0.001) as rss:
        block = np.ones(40_000_000)  # 320 MB, touched
        assert block.sum() == 40_000_000
        del block
    assert rss.peak - rss.start >= 250 << 20
    with check._LegRss() as idle:
        pass
    assert idle.peak - idle.start < 50 << 20
    # A leg that adds more than the budget fails it, whatever it solves.
    # The leg runs in a fresh interpreter: in a worker whose heap already
    # holds pages that earlier tests freed, the leg's allocations reuse
    # them and its RSS growth does not show.
    code = ("import json\n"
            "from gauss_tpu_torch.sparse import check\n"
            "check.PEAK_BUDGET_BYTES = 1 << 20\n"
            "row = check.run_giant(60_000, 20, 258458, 1e-4, device='cpu')\n"
            "print(json.dumps({k: row[k] for k in ('verified', "
            "'host_added_bytes', 'no_densify_ok', 'peak_budget_bytes')}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    row = json.loads(r.stdout.strip().splitlines()[-1])
    assert row["peak_budget_bytes"] == 1 << 20
    assert row["verified"] and row["host_added_bytes"] > 1 << 20
    assert row["no_densify_ok"] is False


def test_check_runs_as_a_module_and_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would run")
    r = subprocess.run(
        [sys.executable, "-m", "gauss_tpu_torch.sparse.check",
         "--skip-giant", "--repeats", "1"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0 and "CUDA" in r.stderr
    assert "sparse-check" not in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "gauss_tpu_torch.sparse.check",
         "--skip-giant", "--repeats", "1", "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "all verified at the 1e-04 gate" in r.stdout


def test_check_help_names_the_device_option():
    text = check.build_parser().format_help()
    for flag in ("--smoke-n", "--giant-n", "--nnz-per-row",
                 "--giant-nnz-per-row", "--skip-giant", "--repeats", "--seed",
                 "--gate", "--summary-json", "--device"):
        assert flag in text
    with pytest.raises(SystemExit):
        check.build_parser().parse_args(["--device", "tpu"])


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def test_chip_smoke_sparse_arithmetic():
    """The bounds and launch counts chip_smoke.py holds the sparse path
    to, at the shapes it names."""
    cs = _chip_smoke()
    assert cs.SPARSE_ELL_K == {100_000: 36, 1_000_000: 37}
    assert cs.spmv_bytes(100_000, 36, 8) == 44.8e6
    assert cs.spmv_bytes(1_000_000, 37, 8) == 460e6
    b_small = cs.bound(44.8e6, 2.0 * 100_000 * 36, cs.PEAK_F64_FLOP_S)
    b_big = cs.bound(460e6, 2.0 * 1_000_000 * 37, cs.PEAK_F64_FLOP_S)
    assert b_small == pytest.approx((0.013373, "bytes"), rel=1e-3)
    assert b_big == pytest.approx((0.137313, "bytes"), rel=1e-3)
    assert cs.krylov_launches("cg", 9) == 10
    assert cs.krylov_launches("bicgstab", 6) == 13
    assert cs.krylov_launches("gmres", 64) == 1 + 2 * 34
    a, b = cs.sparse_system(100_000, cs.SPARSE_NNZ)
    assert (a.n, a.max_row_nnz) == (100_000, 36) and b.shape == (100_000,)
    assert a.gershgorin_spd()


def test_chip_smoke_sparse_phases_rehearsal(monkeypatch, capsys, tmp_path):
    """chip_smoke.py's phase 3c and its sparse main path on the CPU, the
    kernel's plain version on both sides: the checks, the summaries it
    reads, its launch arithmetic and the breakdown run end to end. (On CPU
    tensors no kernel launches, so the counts stay 0 and the exact-count
    check, which is for the card, is skipped by the script itself.)"""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "SPARSE_NS", (75_000,))
    monkeypatch.setattr(cs, "SPARSE_NNZ", 8)
    monkeypatch.setattr(cs, "REPO", str(tmp_path))  # its work files
    monkeypatch.setattr(cs, "device_ms", lambda fn, reps: (fn(), 1.0)[1])
    spmv, systems = cs.phase_spmv_kernel(1)
    assert set(spmv) == {(75_000, "f64"), (75_000, "f32")}
    row = spmv[(75_000, "f64")]
    k = row["shape"][1]
    assert row["bound_by"] == "bytes" and row["err"] == 0.0
    assert row["bytes"] == 75_000 * k * 12 + 2 * 75_000 * 8
    assert row["bound_ms"] == pytest.approx(row["bytes"] / 3.35e12 * 1e3)
    launches = cs.phase_sparse_path(spmv, systems)
    assert launches == {name: 0 for name in _build.LAUNCHES}
    out = capsys.readouterr().out
    assert "sparse-check [giant    ] n= 75000" in out
    for kind in ("none", "block_jacobi", "tridiag", "ilu0", "ic0"):
        assert f"phase 4: sparse precond {kind}: cg/{kind} n=640" in out
    assert "phase 4: sparse .dat round trip: cg/jacobi n=640" in out
    assert "phase 4: sparse breakdown n=75000: certificate" in out
    assert "bit for bit" in out and "FAILED" not in out
    assert np.isfinite(row["ms"])

"""The out-of-core stream on the card (``cuda``-marked; skips without a
CUDA device): the pinned host matrix's strided copies through the copy
streams, and the streamed factor against the CPU path and the in-core
chunked factor on the same input, held to the float64 factor on their
pivots as tests/test_torch_chunked.py holds the in-core form. Run on the
card with ``python -m pytest -m cuda tests/test_torch_outofcore_card.py``.
No JAX here: the JAX package is compared on the CPU in
tests/test_torch_outofcore.py."""

import numpy as np
import pytest
import torch

from gauss_tpu_torch import outofcore as toc
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.outofcore import stream as tstream

CPU = "cpu"


def _chip_smoke():
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stream's pinned host memory, "
                    "copy streams and kernels (run `python -m pytest -m "
                    "cuda tests/test_torch_outofcore_card.py` or `python3 "
                    "chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_pinned_copies_round_trip(cuda_device):
    """A strided window of the pinned host matrix goes to the card and
    back through the copy streams bit for bit."""
    host = tstream.pinned_empty((300, 500), torch.float32)
    host.copy_(torch.randn(300, 500))
    pipe = tstream._Pipe(cuda_device)
    dev, ready = pipe.h2d(host[37:, 120:250])
    pipe.sync(ready)
    assert torch.equal(dev.cpu(), host[37:, 120:250])
    back = tstream.pinned_empty((300, 500), torch.float32)
    back.zero_()
    pipe.sync(pipe.d2h(back[37:, 120:250], dev * 2))
    assert torch.equal(back[37:, 120:250], host[37:, 120:250] * 2)
    assert back[:37].abs().sum() == 0 and back[:, :120].abs().sum() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("abft", [False, True])
def test_card_stream_matches_cpu(cuda_device, abft):
    """The pipeline on the card against the CPU path on the same input
    (n=1000, panel 128): the same pivots as the CPU's streamed factor and
    the in-core chunked factor on the card; and, held to the float64
    factor with those pivots (chip_smoke.lu_f64) as
    tests/test_torch_chunked.py holds the in-core form, no further from it
    than chip_smoke.F64_RATIO times the in-core factor on the same card
    and than chip_smoke.F64_CAP (TOL_FACTOR lies below float32 rounding at
    this size, and the card's kernels round in another order than the
    CPU's plain versions); the ledger back at 0, tiles streamed, the
    copies timed."""
    cs = _chip_smoke()
    rng = np.random.default_rng(5)
    n = 1000
    a = rng.standard_normal((n, n)).astype(np.float32)
    kw = dict(panel=128, chunk=2, ct=256, abft=abft)
    fg = toc.lu_factor_outofcore(a, device=cuda_device, **kw)
    s = toc.last_stream_stats()
    assert s.live_device_bytes == 0 and s.tiles >= 2
    assert s.h2d_device_s > 0 and s.d2h_device_s > 0
    fc = toc.lu_factor_outofcore(a, device=CPU, **kw)
    ref = tb.lu_factor_blocked_chunked(a, panel=128, chunk=2, abft=abft,
                                       device=cuda_device)
    assert torch.equal(fg.perm, fc.perm)
    assert torch.equal(ref.perm.cpu(), fc.perm)
    f64 = cs.lu_f64(a, fc.perm, 128)
    err, err_incore = cs.factor_err(fg, f64), cs.factor_err(ref, f64)
    assert err <= min(cs.F64_RATIO * err_incore, cs.F64_CAP), (
        err, err_incore, cs.factor_err(fc, f64))
    if abft:
        assert fg.abft_err.max() < tb.abft_default_tol(
            1024, torch.float32, float(np.abs(a).sum(0).max()))
    b = rng.standard_normal(n)
    x = toc.solve_outofcore(a, b, device=cuda_device, **kw)
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-4


@pytest.mark.cuda
def test_card_caller_peak_kept_unless_asked(cuda_device):
    """A streamed call leaves the allocator's peak statistics alone
    unless ``alloc_peak=True`` asks it to read them (which resets them)."""
    a = np.random.default_rng(7).standard_normal((600, 600)).astype(
        np.float32)
    kw = dict(panel=128, chunk=2, ct=256, device=cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    big = torch.empty(64 * 2**20, device=cuda_device)
    del big
    peak = torch.cuda.max_memory_allocated(cuda_device)
    toc.lu_factor_outofcore(a, **kw)
    assert toc.last_stream_stats().alloc_peak_device_bytes == 0
    assert torch.cuda.max_memory_allocated(cuda_device) >= peak
    toc.lu_factor_outofcore(a, alloc_peak=True, **kw)
    assert toc.last_stream_stats().alloc_peak_device_bytes > 0

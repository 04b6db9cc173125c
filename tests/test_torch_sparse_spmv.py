"""The port's sparse matrix-vector products against the JAX package's: the
ELL kernel's plain version and ``spmv_ell`` against ``spmv_ell_pallas`` in
interpret mode and the XLA forms, the COO form, the host routing, and (on
the card) the CUDA kernel against its plain version bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.sparse import spmv as jspmv
from gauss_tpu_torch.core import convert
from gauss_tpu_torch.io import synthetic
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.sparse import spmv as tspmv
from gauss_tpu_torch.sparse.csr import CsrMatrix

# Port vs JAX, relative to max |y|: both sum each row's k <= 12 products in
# the working type, in another association (XLA's row reduction against
# the kernel's left-to-right chain).
RTOL = {np.float32: 1e-6, np.float64: 1e-13}


def _system(n, nnz_per_row=5, seed=1, empty_row=None):
    rows, cols, vals = synthetic.sparse_coords(n, nnz_per_row, seed=seed)
    if empty_row is not None:
        keep = rows != empty_row
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    a = CsrMatrix.from_coords(n, rows, cols, vals)
    x = np.random.default_rng(seed + n).standard_normal(n)
    return a, x


def _close(got, want, dtype):
    return np.abs(got - want).max() <= RTOL[dtype] * np.abs(want).max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,empty_row", [(130, None), (130, 17), (64, None),
                                         (33, 0)])
def test_ell_plain_matches_pallas_interpret(dtype, n, empty_row):
    a, x = _system(n, empty_row=empty_row)
    cols, vals = a.ell()
    vals, x = vals.astype(dtype), x.astype(dtype)
    want = np.asarray(jspmv.spmv_ell_pallas(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x), bm=32,
        interpret=True))
    assert want.dtype == dtype
    tc, tv = convert.ell_from_numpy(cols, vals, "cpu", torch.from_numpy(
        vals).dtype)
    tx = torch.from_numpy(x)
    plain = tspmv.spmv_ell_plain(tc, tv, tx).numpy()
    routed = tspmv.spmv_ell(tc, tv, tx).numpy()
    assert plain.dtype == dtype and plain.shape == (n,)
    assert np.array_equal(plain, routed)  # CPU tensors run the plain version
    assert _close(plain, want, dtype)
    assert _close(plain, a.to_dense().astype(dtype) @ x, dtype)
    if empty_row is not None:
        assert plain[empty_row] == 0.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [None, 3])
def test_ell_and_coo_match_jax_forms(dtype, m):
    a, x = _system(150)
    if m is not None:
        x = np.random.default_rng(9).standard_normal((150, m))
    x = x.astype(dtype)
    cols, vals = a.ell()
    vals = vals.astype(dtype)
    rows, ccols, cvals = a.coo()
    cvals = cvals.astype(dtype)
    want_ell = np.asarray(jspmv.spmv_ell(jnp.asarray(cols), jnp.asarray(vals),
                                         jnp.asarray(x)))
    want_coo = np.asarray(jspmv.spmv_coo(
        jnp.asarray(rows), jnp.asarray(ccols), jnp.asarray(cvals),
        jnp.asarray(x), n=150))
    got_ell = tspmv.spmv_ell(torch.from_numpy(cols), torch.from_numpy(vals),
                             torch.from_numpy(x)).numpy()
    got_coo = tspmv.spmv_coo(torch.from_numpy(rows), torch.from_numpy(ccols),
                             torch.from_numpy(cvals), torch.from_numpy(x),
                             n=150).numpy()
    assert got_ell.shape == got_coo.shape == x.shape
    assert got_ell.dtype == got_coo.dtype == dtype
    assert _close(got_ell, want_ell, dtype)
    assert _close(got_coo, want_coo, dtype)
    assert _close(got_ell, a.matvec(x).astype(dtype), dtype)


def test_plain_sums_slots_in_order():
    """The stated order: one running sum per row, slot 0 first, each
    product and each sum rounded on its own (float32 makes the order
    visible)."""
    rng = np.random.default_rng(4)
    cols = rng.integers(0, 50, (50, 7)).astype(np.int32)
    vals = rng.standard_normal((50, 7)).astype(np.float32)
    x = rng.standard_normal(50).astype(np.float32)
    want = np.zeros(50, np.float32)
    for j in range(7):
        want = (want + (vals[:, j] * x[cols[:, j]]).astype(np.float32)
                ).astype(np.float32)
    got = tspmv.spmv_ell_plain(torch.from_numpy(cols), torch.from_numpy(vals),
                               torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("impl", ["auto", "coo"])
@pytest.mark.parametrize("m", [None, 2])
def test_host_spmv_routing(impl, m):
    a, x = _system(130)
    if m is not None:
        x = np.random.default_rng(2).standard_normal((130, m))
    before = dict(_build.LAUNCHES)
    got = tspmv.spmv(a, x, impl=impl, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert _close(got, a.matvec(x), np.float64)
    assert _close(got, jspmv.spmv(a, x, impl=impl), np.float64)
    assert _build.LAUNCHES == before  # CPU tensors launch nothing


def test_kernel_wrapper_refuses_what_it_does_not_take(monkeypatch):
    a, x = _system(40)
    cols, vals = (torch.from_numpy(v) for v in a.ell())
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="CUDA device"):
        tspmv.spmv_ell_kernel(cols, vals, xt)  # CPU tensors: no fallback
    with pytest.raises(ValueError, match="CUDA device"):
        tspmv.spmv(a, x, impl="kernel", device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        tspmv.spmv_ell_kernel(cols, vals, xt[:, None])
    with pytest.raises(ValueError, match="float32 or both float64"):
        tspmv.spmv_ell_plain(cols, vals, xt.float())
    with pytest.raises(ValueError, match="one \\(n, k\\) shape"):
        tspmv.spmv_ell_plain(cols[:, :2], vals, xt)
    with pytest.raises(ValueError, match="unknown spmv impl"):
        tspmv.spmv(a, x, impl="pallas", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tspmv.spmv(a, x)  # no device argument and no card: never the CPU


def test_spmv_source_is_registered_and_states_its_order():
    assert "spmv" in _build.SOURCES and "spmv_ell" in _build.LAUNCHES
    assert set(_build._SIGNATURES["spmv"]) == {"gtt_spmv_ell_f32",
                                               "gtt_spmv_ell_f64"}
    src = (_build.CSRC / "spmv.cu").read_text()
    for word in ("__dmul_rn", "__dadd_rn", "__fmul_rn", "__fadd_rn", "__ldg",
                 "gtt_error_string", "spmv_ell_pallas", "long long"):
        assert word in src, word


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode "
                    "(run `python -m pytest -m cuda tests/` or "
                    "`python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    """Kernel 8 against its plain version, bit for bit: an odd n, an empty
    row, one more row than a block's 32, k larger than the block's 128
    threads, and k at and past the widest single pass (190 slots in
    float64, 382 in float32), where the row is walked in several passes."""
    rng = np.random.default_rng(12)
    for n, k in ((130, 5), (1, 1), (33, 32), (64, 129), (300, 190),
                 (300, 191), (257, 382), (257, 400), (100, 800),
                 (4097, 37)):
        cols = rng.integers(0, n, (n, k)).astype(np.int32)
        vals = rng.standard_normal((n, k))
        vals[n // 2] = 0.0
        cols[n // 2] = 0  # an empty row: padding only
        x = rng.standard_normal(n)
        tc, tv = convert.ell_from_numpy(cols, vals, cuda_device, dtype)
        tx = torch.as_tensor(x, dtype=dtype, device=cuda_device)
        before = _build.LAUNCHES["spmv_ell"]
        got = tspmv.spmv_ell(tc, tv, tx)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["spmv_ell"] == before + 1
        want = tspmv.spmv_ell_plain(tc, tv, tx)
        assert torch.equal(got, want), (n, k)
        assert float(got[n // 2]) == 0.0
        cpu = tspmv.spmv_ell_plain(tc.cpu(), tv.cpu(), tx.cpu())
        assert torch.equal(got.cpu(), cpu), (n, k)
    with pytest.raises(ValueError, match="contiguous"):
        tspmv.spmv_ell_kernel(tc[:, ::2], tv[:, ::2], tx)
    with pytest.raises(ValueError, match="int32"):
        tspmv.spmv_ell_kernel(tc.long(), tv, tx)


@pytest.mark.cuda
def test_solvers_launch_the_kernel_on_card(cuda_device):
    from gauss_tpu_torch.sparse import solve_sparse

    a, _ = _system(640, nnz_per_row=6, seed=258458)
    b = np.random.default_rng(0).standard_normal(640)
    for method, per_iter in (("cg", 1), ("bicgstab", 2)):
        _build.reset_launches()
        res = solve_sparse(a, b, method=method, device=cuda_device)
        assert res.converged
        assert _build.LAUNCHES["spmv_ell"] == per_iter * res.iterations + 1
        want = solve_sparse(a, b, method=method, device="cpu")
        assert res.iterations == want.iterations
        np.testing.assert_allclose(res.x, want.x, rtol=1e-9, atol=1e-12)
    _build.reset_launches()
    res = solve_sparse(a, b, method="gmres", device=cuda_device)
    assert _build.LAUNCHES["spmv_ell"] == 1 + (res.iterations // 32) * 34
    # The host routing launches the kernel at every n: no size gate.
    _build.reset_launches()
    y = tspmv.spmv(a, b, impl="kernel")
    assert _build.LAUNCHES["spmv_ell"] == 1
    np.testing.assert_allclose(y, a.matvec(b), rtol=1e-13, atol=1e-13)

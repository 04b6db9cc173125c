"""The port's tiled and row-stripe matmul (kernels 4 and 5) against the JAX
package's ``matmul_pallas`` / ``matmul_pallas_stripe`` (interpret mode on
the CPU), the port's matmul CLI, and the CUDA kernels against their plain
version on the card."""

import importlib
import io
import re
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu_torch.cli import matmul as mm_cli
from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.kernels import matmul as tmm

# The package's __init__ re-exports functions under the module's name.
jmm = importlib.import_module("gauss_tpu.kernels.matmul_pallas")

SHAPES = [(64, 128, 96), (100, 200, 130), (256, 256, 256)]
# max |port - JAX| / max |C|. "highest" and "high" differ only in f32
# summation order (whole-K dots on one side, bk-deep partial sums on the
# other): measured <= 6e-7 here. "default" is held to JAX on bf16-rounded
# operands (see _jax), which is the same product: measured <= 6e-7.
TOL = 2e-6
KERNELS = {"tiled": (tmm.matmul_tiled, lambda a, b, p: jmm.matmul_pallas(
               a, b, bm=64, bn=128, bk=128, precision=p)),
           "stripe": (tmm.matmul_stripe, lambda a, b, p: jmm.matmul_pallas_stripe(
               a, b, bm=64, bk=128, precision=p))}
# Kernel vs plain on the card, relative to max |C|: FMA chains over all of
# K against cuBLAS's blocked sums; K = 2048 terms at f32 rounding.
CARD_TOL = 1e-5


def _operands(m, k, n, seed=258458):
    rng = np.random.default_rng(seed + m + k + n)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _jax(fn, a, b, precision):
    """The JAX kernel's product. XLA:CPU ignores the precision of an f32
    dot, so interpret mode runs "default" in true f32; a TPU's DEFAULT pass
    rounds the operands to bf16 first, so that is done here by hand."""
    if precision == "default":
        a = np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
        b = np.asarray(jnp.asarray(b).astype(jnp.bfloat16).astype(jnp.float32))
        precision = "highest"
    return np.asarray(fn(jnp.asarray(a), jnp.asarray(b), precision))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_jax(kernel, precision, m, k, n):
    port, jax_fn = KERNELS[kernel]
    a, b = _operands(m, k, n)
    want = _jax(jax_fn, a, b, precision)
    got = port(torch.from_numpy(a), torch.from_numpy(b), precision).numpy()
    assert got.shape == want.shape == (m, n)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_high_is_closer_to_f64_than_default():
    """bf16x3 keeps ~16 mantissa bits, one bf16 pass ~8: the split is
    really computed, not collapsed into either end."""
    a, b = _operands(100, 200, 130)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    err = {p: np.abs(tmm.matmul_plain(at, bt, p).numpy() - ref).max()
           / np.abs(ref).max() for p in ("highest", "high", "default")}
    # Measured: 5.4e-7, 4.8e-6 and 2.4e-3 of max |C|.
    assert err["highest"] < 2e-6 and err["high"] < 2e-5
    assert err["default"] > 100 * err["high"]


def test_non_f32_high_is_full_precision():
    a, b = _operands(32, 48, 40)
    a64, b64 = torch.from_numpy(a).double(), torch.from_numpy(b).double()
    for fn in (tmm.matmul_tiled, tmm.matmul_stripe):
        assert torch.equal(fn(a64, b64, "high"), a64 @ b64)


@pytest.mark.parametrize("fn", [tmm.matmul_tiled, tmm.matmul_stripe])
def test_bad_shapes_and_precision_raise(fn):
    with pytest.raises(ValueError, match="bad matmul shapes"):
        fn(torch.ones(4, 5), torch.ones(4, 5))
    with pytest.raises(ValueError, match="bad matmul shapes"):
        fn(torch.ones(4), torch.ones(4, 5))
    with pytest.raises(ValueError, match="precision"):
        fn(torch.ones(4, 5), torch.ones(5, 3), "fastest")


def test_cpu_tensors_run_plain_without_launch():
    _build.reset_launches()
    a, b = _operands(16, 24, 8)
    tmm.matmul_tiled(torch.from_numpy(a), torch.from_numpy(b))
    tmm.matmul_stripe(torch.from_numpy(a), torch.from_numpy(b))
    assert _build.LAUNCHES["matmul_tiled"] == 0
    assert _build.LAUNCHES["matmul_stripe"] == 0


def _run(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = mm_cli.main(argv)
    return rc, buf.getvalue()


LINE = re.compile(r"^(\S+) time: \d+\.\d{6} seconds \(\d+\.\d GFLOP/s\) "
                  r"verify: (OK|MISMATCH)$")


@pytest.mark.parametrize("extra", [[], ["--precision", "highest"]])
def test_cli_three_engines_verify(extra):
    rc, out = _run(["64", "--engines", "cuda,cuda-kernel,cuda-kernel-v1",
                    "--device", "cpu", *extra])
    lines = out.strip().splitlines()
    assert rc == 0 and len(lines) == 3
    got = [LINE.match(line).groups() for line in lines]
    assert got == [("CUDA", "OK"), ("CUDA-Kernel", "OK"),
                   ("CUDA-Kernel-V1", "OK")]


def test_cli_line_shape_matches_jax():
    from gauss_tpu.cli import matmul as jcli

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc_j = jcli.main(["48", "--engines", "tpu-pallas"])
    rc_t, out_t = _run(["48", "--engines", "cuda-kernel", "--device", "cpu"])
    assert rc_j == rc_t == 0
    assert LINE.match(buf.getvalue().strip()).group(2) == "OK"
    assert LINE.match(out_t.strip()).group(2) == "OK"


def test_cli_default_precision_mismatch_exit_code():
    """One bf16 pass fails the reference's epsilon comparator on these
    inputs at n=256 (as on the TPU), and the exit code says so."""
    rc, out = _run(["256", "--engines", "cuda-kernel", "--precision",
                    "default", "--device", "cpu"])
    assert rc == 1 and "verify: MISMATCH" in out


@pytest.mark.parametrize("argv", [["0", "--device", "cpu"],
                                  ["8", "--engines", "seq", "--device", "cpu"],
                                  ["8", "--engines", "", "--device", "cpu"]])
def test_cli_rejects_bad_input(argv):
    assert _run(argv)[0] == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode "
                    "(run `python -m pytest -m cuda tests/` or "
                    "`python3 chip_smoke.py` on the card)")
    return torch.device("cuda")


# The stripe kernel's ragged shapes: one row, ragged rows, columns and K
# with 4-byte copies (lda = 777), and a K under one ring stage.
STRIPE_SHAPES = [(1, 2048, 2048), (2049, 777, 1000), (130, 17, 130)]


def _sliced(x: np.ndarray, dev, off: int = 1):
    """``x`` as a column slice of a wider matrix: row stride
    ``cols + off + 2`` and a base pointer ``off`` floats past an aligned
    allocation, so no row starts on a 16-byte boundary."""
    rows, cols = x.shape
    wide = torch.zeros((rows, cols + off + 2), dtype=torch.float32,
                       device=dev)
    wide[:, off:off + cols] = torch.as_tensor(x, device=dev)
    return wide[:, off:off + cols]


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES + [(2048, 2048, 2048)]
                         + STRIPE_SHAPES)
def test_kernels_match_plain_on_card(cuda_device, m, k, n, strided):
    x, y = _operands(m, k, n)
    if strided:
        a, b = _sliced(x, cuda_device), _sliced(y, cuda_device, off=3)
        assert a.stride(0) == k + 3 and a.data_ptr() % 16 == 4
    else:
        a, b = (torch.as_tensor(v, device=cuda_device) for v in (x, y))
    geom = tmm.stripe_geometry(m, n, k, a.stride(0), b.stride(0),
                               a.data_ptr(), b.data_ptr())
    if strided:
        assert geom.vec == 1
    for precision in ("highest", "high", "default"):
        want = tmm.matmul_plain(a, b, precision)
        scale = float(want.abs().max())
        for fn in (tmm.matmul_tiled, tmm.matmul_stripe):
            _build.reset_launches()
            got = fn(a, b, precision)
            torch.cuda.synchronize()
            assert _build.LAUNCHES[fn.__name__] == 1, fn.__name__
            assert sum(_build.LAUNCHES.values()) == 1
            assert got.shape == (m, n) and bool(torch.isfinite(got).all())
            assert float((got - want).abs().max()) <= CARD_TOL * scale, (
                fn.__name__, precision, geom)
    with pytest.raises(TypeError):
        tmm.matmul_tiled(a.double(), b.double())


@pytest.mark.cuda
def test_stripe_launch_info_on_card(cuda_device):
    """The ring's shared memory is what the geometry says, and the card
    holds every cluster of the stripe grid at m = 2048 at once: one
    wave."""
    geom = tmm.stripe_geometry(2048, 2048, 2048, 2048, 2048)
    for precision in ("highest", "high", "default"):
        for vec in (4, 1):
            info = tmm.stripe_launch_info(precision, vec)
            assert info["smem_bytes"] == geom.smem_bytes > 48 * 1024
            assert info["cluster"] == geom.cl
            assert info["threads"] == geom.threads
            assert info["max_active_clusters"] >= geom.stripes
            assert info["tensor_cores"] == (precision != "highest")


def test_tile_constants_match_jax_seed_and_cuda_sources():
    """The port's copy of the JAX package's tile seed, and its own CUDA
    tile constants against the defines compiled into csrc/."""
    from gauss_tpu.tune.space import MM_TILE_SEED
    from gauss_tpu_torch.kernels import rowelim as tre

    assert tmm.MM_TILE_SEED == MM_TILE_SEED
    src = {f: (_build.CSRC / f).read_text() for f in ("matmul.cu",
                                                      "rowelim.cu")}

    def define(f, name):
        return int(re.search(rf"#define {name} (\d+)", src[f]).group(1))

    assert tmm.CUDA_TILE == (define("matmul.cu", "GTT_TILED_BM"),
                             define("matmul.cu", "GTT_TILED_BN"))
    stripe = "stripe_common.cuh"
    src[stripe] = (_build.CSRC / stripe).read_text()
    assert tmm.CUDA_STRIPE_TILE == (define(stripe, "GTT_STRIPE_BM"),
                                    define(stripe, "GTT_STRIPE_BN"))
    assert (tmm.STRIPE_CLUSTER, tmm.STRIPE_BK, tmm.STRIPE_STAGES,
            tmm.STRIPE_THREADS) == tuple(
        define(stripe, f"GTT_STRIPE_{x}")
        for x in ("CL", "BK", "STAGES", "THREADS"))
    assert tmm.STRIPE_PAD == (define(stripe, "GTT_STRIPE_APAD"),
                              define(stripe, "GTT_STRIPE_BPAD"))
    assert tre.CUDA_ELIM_TILE == (define("rowelim.cu", "GTT_ELIM_ROWS"),
                                  define("rowelim.cu", "GTT_ELIM_THREADS"))
    assert tre.CUDA_RANKK_TILE == (define("rowelim.cu", "GTT_RANKK_BM"),
                                   define("rowelim.cu", "GTT_RANKK_BN"))


@pytest.mark.parametrize("m,k,n", SHAPES + STRIPE_SHAPES
                         + [(2048, 2048, 2048), (64, 1, 1), (65, 16, 1025)])
def test_stripe_geometry_covers_every_element_once(m, k, n):
    """Every (row, column) of C lies in exactly one tile of exactly one
    block, and every block belongs to one cluster of a stripe."""
    geom = tmm.stripe_geometry(m, n, k, k, n)
    assert geom.blocks == geom.stripes * geom.cl
    assert geom.stripes * geom.bm >= m > (geom.stripes - 1) * geom.bm
    assert geom.k_tiles * tmm.STRIPE_BK >= k > (geom.k_tiles - 1) * tmm.STRIPE_BK
    hits = np.zeros((geom.stripes * geom.bm, -(-n // geom.bn) * geom.bn),
                    dtype=np.int32)
    for block in range(geom.blocks):
        for row0, col0 in tmm.stripe_block_tiles(geom, n, block):
            assert row0 == (block // geom.cl) * geom.bm
            assert (col0 // geom.bn) % geom.cl == block % geom.cl
            hits[row0:row0 + geom.bm, col0:col0 + geom.bn] += 1
    assert (hits[:m, :n] == 1).all()
    assert hits.max() == 1


def test_stripe_geometry_fills_the_card_at_2048():
    geom = tmm.stripe_geometry(2048, 2048, 2048, 2048, 2048)
    assert geom.blocks >= tmm.H100_SMS and geom.blocks % geom.cl == 0
    assert geom.vec == 4
    # Each block of a cluster takes 2 of the 16 column tiles.
    assert {len(tmm.stripe_block_tiles(geom, 2048, b))
            for b in range(geom.blocks)} == {2}
    # The ring is dynamic shared memory above the 48 KB static limit, and
    # several blocks still fit in an SM's 227 KB.
    assert 48 * 1024 < geom.smem_bytes <= 227 * 1024 // 2


@pytest.mark.parametrize("lda,ldb,a_off,b_off,vec", [
    (2048, 2048, 0, 0, 4),
    (200, 130, 0, 0, 1),     # ldb = 130, the (100, 200, 130) shape
    (2048, 2048, 4, 0, 1),   # A's base one float past a 16-byte boundary
    (2048, 2048, 0, 8, 1),   # B's base two floats past it
    (2048, 2048, 16, 32, 4),  # whole 16-byte offsets keep the 16-byte copy
    (777, 1000, 0, 0, 1),
    (132, 1000, 0, 0, 4),
])
def test_stripe_geometry_copy_width(lda, ldb, a_off, b_off, vec):
    base = 0x7f0000000000  # an allocation's alignment (256 bytes)
    geom = tmm.stripe_geometry(100, 130, 200, lda, ldb, base + a_off,
                               base + b_off)
    assert geom.vec == vec


def test_stripe_geometry_of_sliced_tensors():
    """The addresses a column slice hands the kernel (the card test's
    strided operands, here on CPU tensors) take the 4-byte copy."""
    wide = torch.zeros(100, 204)
    a = wide[:, 1:201]
    geom = tmm.stripe_geometry(100, 130, 200, a.stride(0), 132,
                               a.data_ptr(), wide.data_ptr())
    assert a.stride(0) == 204 and a.data_ptr() % 16 == 4 and geom.vec == 1

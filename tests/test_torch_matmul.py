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


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SHAPES + [(2048, 2048, 2048)])
def test_kernels_match_plain_on_card(cuda_device, m, k, n):
    a, b = (torch.as_tensor(x, device=cuda_device) for x in _operands(m, k, n))
    for precision in ("highest", "high", "default"):
        want = tmm.matmul_plain(a, b, precision)
        scale = float(want.abs().max())
        for fn in (tmm.matmul_tiled, tmm.matmul_stripe):
            got = fn(a, b, precision)
            torch.cuda.synchronize()
            assert float((got - want).abs().max()) <= CARD_TOL * scale, (
                fn.__name__, precision)
    with pytest.raises(TypeError):
        tmm.matmul_tiled(a.double(), b.double())


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
    assert tmm.CUDA_STRIPE_TILE == (define("matmul.cu", "GTT_STRIPE_BM"),
                                    define("matmul.cu", "GTT_STRIPE_BN"))
    assert tre.CUDA_ELIM_TILE == (define("rowelim.cu", "GTT_ELIM_ROWS"),
                                  define("rowelim.cu", "GTT_ELIM_THREADS"))
    assert tre.CUDA_RANKK_TILE == (define("rowelim.cu", "GTT_RANKK_BM"),
                                   define("rowelim.cu", "GTT_RANKK_BN"))

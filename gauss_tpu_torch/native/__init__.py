"""ctypes bindings to the native C++ runtime, built with ``make`` at first use.

The host-side components the reference keeps in C/C++ (SURVEY.md §2 C7/C9
and the CPU baseline engines): a fast ``.dat`` parser, the ``matrix_gen``
tool, and the seq / OpenMP / std::thread Gaussian-elimination and matmul
engines. The sources in ``src/`` are the JAX package's, built with the same
flags (``-O3 -std=c++20 -fopenmp -pthread``), so every engine returns the
same bits as the JAX package's library.

The build goes into :func:`build_dir` (``build/native/<hash of the
sources>/`` under the repository root, or ``$GAUSS_TPU_TORCH_NATIVE_DIR``),
never into the source tree, under the kernels' build-dir lock so ranks
started together build once.

Deviation from the JAX package, which reports ``available() == False``
and lets its callers take a Python path when the build fails: here a
failed build raises :class:`NativeBuildError` carrying ``make``'s stderr,
and no caller quietly takes another engine. ``GAUSS_TPU_NO_NATIVE=1`` is
an explicit refusal: every entry point raises :class:`NativeRefusedError`
and :func:`available` returns False.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "src"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

GAUSS_ENGINES = ("seq", "omp", "threads", "forkjoin", "tiled")
MATMUL_ENGINES = ("seq", "omp")

#: Seconds the last build in this process took (0.0 when loaded as built).
BUILD_SECONDS: dict = {}


class NativeBuildError(RuntimeError):
    """``make`` failed (or is missing); the message carries its stderr."""


class NativeRefusedError(RuntimeError):
    """``GAUSS_TPU_NO_NATIVE`` is set: the native engines are refused."""


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(SRC_DIR.iterdir()):
        if f.suffix in (".cc", "") and f.is_file():
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    env = os.environ.get("GAUSS_TPU_TORCH_NATIVE_DIR")
    if env:
        return Path(env)
    return SRC_DIR.parents[2] / "build" / "native" / _source_hash()


def _lib_path() -> Path:
    return build_dir() / "libgauss_native.so"


def _gen_path() -> Path:
    return build_dir() / "matrix_gen"


def _refuse() -> None:
    if os.environ.get("GAUSS_TPU_NO_NATIVE"):
        raise NativeRefusedError(
            "the native engines are refused: GAUSS_TPU_NO_NATIVE is set")


def build(out_dir=None) -> float:
    """Run ``make`` into ``out_dir`` (default :func:`build_dir`) and return
    its seconds. Raises :class:`NativeBuildError` with make's stderr."""
    from gauss_tpu_torch.kernels._build import dir_lock

    out = Path(out_dir) if out_dir is not None else build_dir()
    with dir_lock(out):
        t0 = time.perf_counter()
        try:
            r = subprocess.run(["make", "-C", str(SRC_DIR), f"O={out}"],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"native build could not run make: "
                                   f"{e}") from e
        if r.returncode != 0:
            raise NativeBuildError(
                f"native build failed (make rc {r.returncode}):\n"
                f"{r.stderr}")
        secs = time.perf_counter() - t0
    BUILD_SECONDS[str(out)] = secs
    return secs


def ensure_built(force: bool = False) -> bool:
    """Build the library and ``matrix_gen`` if missing (or ``force``).
    Returns True; raises :class:`NativeBuildError` or
    :class:`NativeRefusedError`."""
    _refuse()
    with _lock:
        if force or not (_lib_path().is_file() and _gen_path().is_file()):
            build()
    return True


def _load() -> ctypes.CDLL:
    global _lib
    _refuse()
    if _lib is not None:
        return _lib
    ensure_built()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_lib_path()))
            dp = ctypes.POINTER(ctypes.c_double)
            lib.gt_gauss_solve_seq.argtypes = [dp, dp, dp, ctypes.c_long]
            for name in ("omp", "threads", "forkjoin", "tiled"):
                getattr(lib, f"gt_gauss_solve_{name}").argtypes = [
                    dp, dp, dp, ctypes.c_long, ctypes.c_int]
            for name in GAUSS_ENGINES:
                getattr(lib, f"gt_gauss_solve_{name}").restype = ctypes.c_int
            lib.gt_matmul_seq.argtypes = [dp, dp, dp, ctypes.c_long]
            lib.gt_matmul_seq.restype = None
            lib.gt_matmul_omp.argtypes = [dp, dp, dp, ctypes.c_long,
                                          ctypes.c_int]
            lib.gt_matmul_omp.restype = None
            lib.gt_dat_read_header.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long)]
            lib.gt_dat_read_header.restype = ctypes.c_int
            lib.gt_dat_read_dense.argtypes = [ctypes.c_char_p, dp,
                                              ctypes.c_long]
            lib.gt_dat_read_dense.restype = ctypes.c_int
            _lib = lib
    return _lib


def available() -> bool:
    """True once the library is built and loaded; False only under
    ``GAUSS_TPU_NO_NATIVE``. A failed build raises."""
    if os.environ.get("GAUSS_TPU_NO_NATIVE"):
        return False
    return _load() is not None


def _as_c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def gauss_solve(a, b, engine: str = "seq", nthreads: int = 0) -> np.ndarray:
    """Solve A x = b with a native CPU engine. A/b are not modified."""
    lib = _load()
    if engine not in GAUSS_ENGINES:
        raise ValueError(f"unknown native gauss engine {engine!r}; "
                         f"options: {GAUSS_ENGINES}")
    a = _as_c(a).copy()
    b = _as_c(b).copy()
    n = a.shape[0]
    if a.shape != (n, n) or b.shape != (n,):
        raise ValueError(f"expected square a and matching b; got {a.shape} "
                         f"and {b.shape}")
    x = np.empty(n, dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    pa, pb, px = (arr.ctypes.data_as(dp) for arr in (a, b, x))
    nt = nthreads or (os.cpu_count() or 2)
    if engine == "seq":
        rc = lib.gt_gauss_solve_seq(pa, pb, px, n)
    elif engine == "omp":
        rc = lib.gt_gauss_solve_omp(pa, pb, px, n, nthreads)
    else:
        rc = getattr(lib, f"gt_gauss_solve_{engine}")(pa, pb, px, n, nt)
    if rc == -1:
        raise np.linalg.LinAlgError("matrix is singular")
    if rc != 0:
        raise RuntimeError(f"native gauss engine failed with code {rc}")
    return x


def matmul(a, b, engine: str = "seq", nthreads: int = 0) -> np.ndarray:
    """C = A @ B (square, float64) with a native CPU engine."""
    lib = _load()
    if engine not in MATMUL_ENGINES:
        raise ValueError(f"unknown native matmul engine {engine!r}; "
                         f"options: {MATMUL_ENGINES}")
    a = _as_c(a)
    b = _as_c(b)
    n = a.shape[0]
    if a.shape != (n, n) or b.shape != (n, n):
        raise ValueError("native matmul expects square same-size matrices")
    c = np.empty((n, n), dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    pa, pb, pc = (arr.ctypes.data_as(dp) for arr in (a, b, c))
    if engine == "seq":
        lib.gt_matmul_seq(pa, pb, pc, n)
    else:
        lib.gt_matmul_omp(pa, pb, pc, n, nthreads)
    return c


def read_dat_header(path: str) -> tuple:
    lib = _load()
    n = ctypes.c_long()
    nnz = ctypes.c_long()
    rc = lib.gt_dat_read_header(os.fsencode(path), ctypes.byref(n),
                                ctypes.byref(nnz))
    if rc != 0:
        raise ValueError(f"failed to parse .dat header of {path} (code {rc})")
    return n.value, nnz.value


def read_dat_dense(path: str) -> np.ndarray:
    """The native .dat parse + densify; the python parser's semantics with
    ``strict=False``."""
    n, _ = read_dat_header(path)
    out = np.empty((n, n), dtype=np.float64)
    rc = _load().gt_dat_read_dense(
        os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n)
    if rc != 0:
        raise ValueError(f"failed to parse .dat body of {path} (code {rc})")
    return out


def matrix_gen_path() -> str:
    """Path to the built ``matrix_gen`` binary (building if needed)."""
    ensure_built()
    return str(_gen_path())

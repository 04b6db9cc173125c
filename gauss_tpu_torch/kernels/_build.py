"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``csrc/hostcopy.cu`` holds no kernel: it is the out-of-core stream's
pinned host allocation and strided copy (``cudaMemcpy2DAsync``), built
and loaded the same way.

Each ``.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``; every
pointer and the stream pass as ``c_void_p``, every integer as ``c_int``.
A library's file name carries a hash of all the sources, so an edited
kernel is rebuilt and an unchanged one is loaded as built. Builds start
at the first CUDA use of a kernel (or all at once, in parallel, through
:func:`build_all`) into ``build/kernels/`` under the repository root, or
into ``$GAUSS_TPU_TORCH_BUILD_DIR``.

There is no fallback: a missing ``nvcc`` or a failed build raises
:class:`KernelBuildError`, and a C entry point that returns a CUDA error
code raises :class:`KernelLaunchError` (both subclasses of RuntimeError,
so that a recovery ladder can tell a broken kernel from a bad system and
re-raise it; :func:`is_kernel_fault` also names the CUDA error torch raises
at the next sync after a kernel that faults while it runs). Importing this
module compiles nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("panel_factor", "panel_cluster", "panel_grid", "panel_batched",
           "panel_fused", "panel_fused_batched", "matmul", "rowelim", "spmv",
           "hostcopy")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: Launches per kernel wrapper, counted where the wrapper launches its
#: kernel and nowhere else (plain-version calls on CPU tensors do not
#: count). The bfloat16 forms of the panel, fused and trailing kernels
#: count under their own ``_bf16`` keys; the batched kernels count one
#: launch per stack. Reset with
#: :func:`reset_launches`.
LAUNCHES = {"panel_factor": 0, "panel_factor_cluster": 0,
            "panel_factor_grid": 0, "panel_factor_grid_bf16": 0,
            "panel_factor_batched": 0, "panel_factor_batched_bf16": 0,
            "panel_trailing_fused_batched": 0,
            "panel_trailing_fused_batched_bf16": 0,
            "panel_trailing_fused": 0, "trailing_update": 0,
            "panel_factor_bf16": 0, "panel_factor_cluster_bf16": 0,
            "panel_trailing_fused_bf16": 0, "trailing_update_bf16": 0,
            "matmul_tiled": 0, "matmul_stripe": 0, "eliminate_step": 0,
            "rankk_update": 0, "spmv_ell": 0}

#: Launches of the kernels whose :data:`LAUNCHES` key does not name the
#: route, counted by route beside it at the launch (:func:`count_route`):
#: the batched fused kernel by the phase-A route the C launcher reports it
#: took, keyed ``panel_trailing_fused_batched[_bf16]/<route>``
#: (``cluster``, ``grid`` or ``block``); the batched panel kernel by step
#: loop, ``panel_factor_batched[_bf16]/<route>`` (``regs``, ``cluster``,
#: ``smem`` or ``global``); and the fused kernel by the phase-A route of
#: ``fused_geometry`` that its launch took,
#: ``panel_trailing_fused[_bf16]/<route>``. The single-strip panel
#: kernel's keys name its route already. Reset with
#: :func:`reset_launches`.
ROUTE_LAUNCHES: dict[str, int] = {}

#: Seconds each source took to build in this process (0.0 when loaded
#: from an existing build).
BUILD_SECONDS: dict[str, float] = {}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PANEL = [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]
_CLUSTER_AT = [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P]
_GRID = [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P]
_FUSED = [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
          _P, _P]
_TRAILING = [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
_BATCHED = [_P, _L, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P]
_FUSED_BATCHED = [_P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                  _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P]
_SIGNATURES = {
    "panel_factor": {
        "gtt_panel_factor": _PANEL,
        "gtt_panel_factor_bf16": _PANEL,
    },
    "panel_cluster": {
        "gtt_panel_factor_cluster": _PANEL,
        "gtt_panel_factor_cluster_bf16": _PANEL,
        "gtt_panel_factor_cluster_at": _CLUSTER_AT,
        "gtt_panel_factor_cluster_at_bf16": _CLUSTER_AT,
        "gtt_panel_cluster_info": [_I, _I, _I, _I, _P],
    },
    "panel_grid": {
        "gtt_panel_factor_grid": _GRID,
        "gtt_panel_factor_grid_bf16": _GRID,
        "gtt_panel_grid_info": [_I, _I, _I, _I, _P],
    },
    "panel_batched": {
        "gtt_panel_factor_batched": _BATCHED,
        "gtt_panel_factor_batched_bf16": _BATCHED,
        "gtt_panel_batched_info": [_I, _I, _I, _P],
    },
    "panel_fused": {
        "gtt_panel_fused_info": [_I, _I, _I, _I, _I, _I, _P],
        "gtt_panel_fused": _FUSED,
        "gtt_panel_fused_bf16": _FUSED,
        "gtt_trailing_update": _TRAILING,
        "gtt_trailing_update_bf16": _TRAILING,
    },
    "panel_fused_batched": {
        "gtt_panel_fused_batched_info": [_I, _I, _I, _I, _I, _I, _I, _P],
        "gtt_panel_fused_batched": _FUSED_BATCHED,
        "gtt_panel_fused_batched_bf16": _FUSED_BATCHED,
    },
    "matmul": {
        "gtt_matmul_tiled": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P],
        "gtt_matmul_stripe": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P],
        "gtt_matmul_stripe_info": [_I, _I, _P],
        "gtt_matmul_tiled_info": [_I, _I, _P],
    },
    "rowelim": {
        "gtt_eliminate_step": [_P, _I, _P, _I, _I, _I, _I, _P],
        "gtt_rankk_update": [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I,
                             _P],
        "gtt_rankk_update_info": [_I, _P],
    },
    "spmv": {
        "gtt_spmv_ell_f32": [_P, _P, _P, _P, _I, _I, _P],
        "gtt_spmv_ell_f64": [_P, _P, _P, _P, _I, _I, _P],
    },
    "hostcopy": {
        "gtt_host_alloc": [ctypes.POINTER(_P), _L],
        "gtt_host_free": [_P],
        "gtt_copy2d": [_P, _L, _P, _L, _L, _L, _I, _P],
    },
}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or failed to build a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry point returned a CUDA error code."""


def is_kernel_fault(exc: BaseException) -> bool:
    """Whether ``exc`` says a kernel failed to build, launch or run.

    A launch-configuration error comes back from the C entry point as
    :class:`KernelLaunchError`. A kernel that traps or reads out of bounds
    surfaces later, at the next sync, as torch's CUDA error: a
    ``torch.AcceleratorError``, or a ``RuntimeError`` whose message starts
    with "CUDA error" where torch has no such class. The error is sticky,
    so every later use of the card fails the same way. An out-of-memory
    error is not a fault of a kernel and is not counted here."""
    if isinstance(exc, (KernelBuildError, KernelLaunchError)):
        return True
    import torch
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and str(exc).startswith("CUDA error")


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def count_route(key: str, route: str) -> None:
    """Count one launch of ``key`` in :data:`LAUNCHES` and, under
    ``key/route``, in :data:`ROUTE_LAUNCHES`."""
    LAUNCHES[key] += 1
    by_route = f"{key}/{route}"
    ROUTE_LAUNCHES[by_route] = ROUTE_LAUNCHES.get(by_route, 0) + 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ROUTE_LAUNCHES.clear()


def build_dir() -> Path:
    env = os.environ.get("GAUSS_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "kernels"


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda/bin``;
    raises :class:`KernelBuildError` when none has it."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(Path(home) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels of gauss_tpu_torch are "
        "built from source at first use and need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"libgtt_{name}-{_source_hash()}.so"


def _start_build(name: str, nvcc: str):
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp: Path, out: Path, t0: float) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed building csrc/{name}.cu "
                           f"(rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0


@contextlib.contextmanager
def dir_lock(path: Path):
    """An exclusive ``flock`` on a build dir: processes that start
    together (a router's replicas, a launcher's ranks) build each library
    once, one after another, instead of each running every compiler."""
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build_dir_lock():
    return dir_lock(build_dir())


def build_all(names=SOURCES) -> dict[str, float]:
    """Build every missing library at once — one ``nvcc`` per source, all
    started together — and load them. Returns the seconds per source.
    Builds run under a file lock on the build dir, so a second process
    waits for the first and loads what it built."""
    with _lock:
        todo = [n for n in names if n not in _libs
                and not _lib_path(n).is_file()]
        with _build_dir_lock() if todo else contextlib.nullcontext():
            todo = [n for n in todo if not _lib_path(n).is_file()]
            _build_locked(todo)
        for n in names:
            BUILD_SECONDS.setdefault(n, 0.0)
            _load_locked(n)
    return {n: BUILD_SECONDS[n] for n in names}


def _build_locked(todo) -> None:
    """One ``nvcc`` per source of ``todo``, all started together."""
    if not todo:
        return
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    jobs = [(n, *_start_build(n, nvcc)) for n in todo]
    errors = []
    for n, proc, tmp, out in jobs:
        try:
            _finish_build(n, proc, tmp, out, t0)
        except KernelBuildError as e:
            errors.append(str(e))
    if errors:
        raise KernelBuildError("\n".join(errors))


def _load_locked(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.gtt_error_string.argtypes = [ctypes.c_int]
        lib.gtt_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise :class:`KernelLaunchError` on a CUDA error code returned by a
    C entry point of ``lib``."""
    if rc != 0:
        msg = lib.gtt_error_string(rc).decode(errors="replace")
        raise KernelLaunchError(f"{what}: CUDA error {rc} ({msg})")

"""Host-streamed blocked LU: solves for n beyond the card's memory.

Port of ``gauss_tpu/outofcore/stream.py``. The single-card blocked path
holds ~3 matrix copies on the device (``core.blocked.fits_single_chip``);
past that the matrix lives, and is updated, in HOST memory, and only

- the active panel GROUP's (gh, w) column block, and
- a bounded WINDOW of trailing (gh, ct) column tiles (a fixed number of
  pipeline buffers, sized by :func:`outofcore_window` from
  ``device_memory_budget()``)

are ever on the card. The transfers overlap the updates: tile t+1's H2D
and tile t-1's D2H run on their own CUDA streams while tile t's update
runs on the compute stream, ordered by events (the D2H of a tile starts
only after its update's event; a tile's update only after its H2D's
event). Every exposed host wait is an obs SPAN: ``outofcore.compute_wait``
(the host waits for an update), ``outofcore.h2d`` and ``outofcore.d2h``
(it waits for a copy), and the engine keeps a byte LEDGER of every device
buffer it holds (``peak_device_bytes``) and, when the caller asks for it
(``alloc_peak=True``), the allocator's own peak over the call
(``alloc_peak_device_bytes``: it also holds cuBLAS's workspace and the
updates' transients; reading it resets the device's peak statistics). The copies' and updates' device
milliseconds come from CUDA events (``h2d_device_s``, ``d2h_device_s``,
``compute_device_s``).

**Shared math, cannot drift.** The per-group step IS
:func:`gauss_tpu_torch.core.blocked._factor_group`, called on the group's
own RECTANGULAR (gh, w) block (``g0=0``, no columns right of it), with
``crow=`` under the checksum rider. The tile update is ``_factor_group``'s
right-of-group math operation for operation, restricted to one (gh, ct)
tile: gather the rows by the group permutation, the blockwise U12 solve
through the group's ``linvs`` (``_gdot``), then the rank-w GEMM. On the
CPU the streamed factor is bit for bit the port's
``lu_factor_blocked_chunked`` at the same panel and chunk.

**The host side.** On the card the host matrix is page-locked, allocated
so by ``csrc/hostcopy.cu`` when it is staged (never pinned after), and a
tile, a column of a row-major matrix, moves with one strided
``cudaMemcpy2DAsync`` on a copy stream. There is no fallback: if pinned
memory cannot be had, or a copy fails, the call raises; it never carries
on pageable or synchronous. ``device="cpu"`` runs the same code with plain
copies, only when asked. The JAX package realigns the retired L columns
left of each group with a host gather per group (``n^3 / (6 w)``
elements in all); the port gathers each retired block once, by the
composed permutation, when the factor ends or a checkpoint is written
(row gathers compose exactly, so the bits are the JAX layout's).

**Riders.** ``abft=True`` carries the Huang-Abraham checksum row on the
host and checks the group-column identity inside the shared group step
and the trailing column-sum identity per streamed tile; a mismatch raises
a typed :class:`SDCDetectedError` naming the group and the global column
(the JAX package names the group only). ``checkpoint_path`` saves the host
carry ``(m, perm, min_piv, linvs, uinvs, next_group)`` every K groups
through :func:`gauss_tpu_torch.resilience.checkpoint.save_state` in the
JAX package's format and meta, so a checkpoint crosses between the
packages both ways.

Fault hooks: ``outofcore.group`` (kill or raise between groups),
``outofcore.tile`` (corrupt a trailing tile on its way to the card).

Deliberate deviations from the JAX package: :class:`OutOfCoreLU` holds
CPU tensors (numpy has no bfloat16) and the device it was factored on;
the JAX package's attribution plane (``obs.attr``) is not ported, so the
stats feed none.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import time
import weakref
from contextlib import contextmanager
from typing import NamedTuple, Optional

import numpy as np
import torch

from gauss_tpu_torch import obs
from gauss_tpu_torch.resilience import inject as _inject
from gauss_tpu_torch.tune import space as _tspace

#: device buffers the tile pipeline keeps live at once: the in-flight
#: input tile, its output, the prefetched next input and the previous
#: output draining back to the host.
PIPELINE_TILE_BUFFERS = 4

#: share of the device budget the streamed working set (group block +
#: window tiles) may claim, well under the 50%-of-the-working-set bar so
#: the updates' transients cannot close the gap (tune.space seed).
OUTOFCORE_DEVICE_FRAC = _tspace.OUTOFCORE_DEVICE_FRAC_SEED

#: host working set ~ the factor copy updated in place + the caller's
#: operand + refinement and transfer transients.
OUTOFCORE_HOST_FACTOR = 2.25

#: usable host bytes when the OS cannot report them.
DEFAULT_HOST_BYTES = 32 * 2**30

#: row-block size of the chunked float64 residual (refinement never makes
#: a full float64 copy of a giant operand).
RESIDUAL_ROW_BLOCK = 4096


class SDCDetectedError(RuntimeError):
    """The checksum rider found silent data corruption in the streamed
    factorization, localized to the panel group (``group``, its first
    panel) and the global column (``col``) that produced it. Under the
    recovery ladder the rung escalates."""

    def __init__(self, msg: str, group: int = -1, col: int = -1,
                 err: float = float("inf")):
        super().__init__(msg)
        self.group = group
        self.col = col
        self.err = err


class OutOfCoreLU(NamedTuple):
    """The host-resident factorization: ``core.blocked.BlockedLU``'s
    layout (getrf, rows permuted) as CPU tensors."""

    m: torch.Tensor          # (npad, npad) factored; rows permuted
    perm: torch.Tensor       # (npad,) int64 gather indices
    min_abs_pivot: float
    linv: torch.Tensor       # (nb, panel, panel) accumulate-dtype inverses
    uinv: torch.Tensor
    n: int
    panel: int
    abft_err: Optional[np.ndarray] = None  # per-group max mismatch
    device: str = "cuda"     # where it was factored (and solves stream)


@dataclasses.dataclass
class StreamStats:
    """The accounting of one streamed factor or solve: the host's waits on
    copies and updates (mirrored by the obs spans), the bytes each way,
    the device-byte ledger's peak, the allocator's peak (when asked for),
    and the device milliseconds of the copies and the updates (CUDA
    events; 0 on the CPU)."""

    n: int = 0
    npad: int = 0
    panel: int = 0
    chunk: int = 0
    ct: int = 0
    groups: int = 0
    tiles: int = 0
    solves: int = 0
    h2d_s: float = 0.0
    d2h_s: float = 0.0
    compute_wait_s: float = 0.0
    wall_s: float = 0.0
    bytes_h2d: int = 0
    bytes_d2h: int = 0
    live_device_bytes: int = 0
    peak_device_bytes: int = 0
    alloc_peak_device_bytes: int = 0
    h2d_device_s: float = 0.0
    d2h_device_s: float = 0.0
    compute_device_s: float = 0.0
    stage_s: float = 0.0
    realign_s: float = 0.0

    # -- device ledger -----------------------------------------------------
    def add_dev(self, nbytes: int) -> None:
        self.live_device_bytes += int(nbytes)
        if self.live_device_bytes > self.peak_device_bytes:
            self.peak_device_bytes = self.live_device_bytes

    def sub_dev(self, nbytes: int) -> None:
        self.live_device_bytes -= int(nbytes)

    # -- derived -----------------------------------------------------------
    @property
    def transfer_s(self) -> float:
        return self.h2d_s + self.d2h_s

    @property
    def overlap_fraction(self) -> float:
        """Of the host's blocking time, the share spent on the stream
        (copies) against stalls on the device with nothing left to stream
        (``compute_wait``). 1.0: the pipeline hid the device behind the
        stream; toward 0: every copy ran against an idle device."""
        denom = self.transfer_s + self.compute_wait_s
        return (self.transfer_s / denom) if denom > 0 else 0.0

    @property
    def stall_fraction(self) -> float:
        """1 - overlap_fraction."""
        return 1.0 - self.overlap_fraction

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("live_device_bytes", None)
        d["overlap_fraction"] = round(self.overlap_fraction, 4)
        d["stall_fraction"] = round(self.stall_fraction, 4)
        for k in ("h2d_s", "d2h_s", "compute_wait_s", "wall_s",
                  "h2d_device_s", "d2h_device_s", "compute_device_s",
                  "stage_s", "realign_s"):
            d[k] = round(d[k], 6)
        return d


#: the stats scope: solve_outofcore opens one so that the factor and every
#: sweep accumulate into one record; bare factor/solve calls open their
#: own. The finished record is kept (last_stream_stats) and emitted as an
#: ``outofcore`` obs event.
_ACTIVE: Optional[StreamStats] = None
_LAST: Optional[StreamStats] = None


def last_stream_stats() -> Optional[StreamStats]:
    """The most recent completed streamed operation's accounting."""
    return _LAST


@contextmanager
def _stats_scope(dev: torch.device, alloc_peak: bool = False, **fields):
    """Enter (or join) the active StreamStats scope. With ``alloc_peak``,
    on the card, the scope reads the allocator's peak over its span, less
    what was allocated when it opened: this resets the device's peak
    statistics, so a peak the caller measures around the call is lost;
    else ``alloc_peak_device_bytes`` stays 0."""
    global _ACTIVE, _LAST
    if _ACTIVE is not None:
        yield _ACTIVE
        return
    stats = StreamStats(**fields)
    card = dev.type == "cuda"
    peak = card and alloc_peak
    if card:
        torch.cuda.synchronize(dev)
    if peak:
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    _ACTIVE = stats
    t0 = time.perf_counter()
    try:
        yield stats
    finally:
        stats.wall_s += time.perf_counter() - t0
        if peak:
            stats.alloc_peak_device_bytes = max(
                0, torch.cuda.max_memory_allocated(dev) - base)
        _ACTIVE = None
        _LAST = stats


@contextmanager
def _timed(stats: StreamStats, key: str, name: str, **attrs):
    """One accounted obs span: its wall adds to ``stats.<key>`` and lands
    on the recorder as a ``span`` event (none without a recorder; the
    stats still measure)."""
    t0 = time.perf_counter()
    try:
        with obs.span(name, **attrs):
            yield
    finally:
        setattr(stats, key, getattr(stats, key) + time.perf_counter() - t0)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# -- admission + window sizing ----------------------------------------------


def host_memory_budget() -> int:
    """Usable host bytes: 0.8 of the OS-reported physical memory, a
    conservative constant when unreadable (a seam for the admission
    tests)."""
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        psz = os.sysconf("SC_PAGE_SIZE")
        if pages > 0 and psz > 0:
            return int(0.8 * pages * psz)
    except (AttributeError, OSError, ValueError):
        pass
    return DEFAULT_HOST_BYTES


def _group_width(n: int, panel: Optional[int], chunk: Optional[int],
                 itemsize: int):
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.tune import apply as _tune

    panel = blocked._resolve_panel(n, panel, itemsize)
    if chunk is None:
        chunk = int(_tune.override("outofcore", n, "chunk")
                    or _tspace.OUTOFCORE_CHUNK_SEED)
    return panel, int(chunk)


def outofcore_window(n: int, panel: Optional[int] = None,
                     chunk: Optional[int] = None, itemsize: int = 4,
                     budget: Optional[int] = None, device=None) -> int:
    """The trailing tile width ``ct`` (a panel multiple): what fits the
    device-budget fraction beside the tallest (first) group block, with
    ``PIPELINE_TILE_BUFFERS`` tiles live. A tuned store (op ``outofcore``)
    short-circuits the formula per (n-bucket, dtype). ``budget`` defaults
    to ``device_memory_budget(device)``."""
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.tune import apply as _tune

    panel, chunk = _group_width(n, panel, chunk, itemsize)
    npad = -(-n // panel) * panel
    tuned = _tune.override("outofcore", n, "ct")
    if tuned:
        ct = max(panel, (int(tuned) // panel) * panel)
    else:
        budget = (blocked.device_memory_budget(device) if budget is None
                  else int(budget))
        group_bytes = npad * chunk * panel * itemsize
        avail = OUTOFCORE_DEVICE_FRAC * budget - group_bytes
        ct = int(avail // (PIPELINE_TILE_BUFFERS * npad * itemsize))
        ct = max(panel, (ct // panel) * panel)
    ct = min(ct, npad)
    obs.emit("vmem_estimate", label="outofcore_window", n=n, panel=panel,
             chunk=chunk, ct=ct, itemsize=itemsize,
             bytes=npad * (chunk * panel + PIPELINE_TILE_BUFFERS * ct)
             * itemsize)
    return ct


def outofcore_fits(n: int, itemsize: int = 4,
                   host_budget: Optional[int] = None,
                   budget: Optional[int] = None,
                   panel: Optional[int] = None,
                   chunk: Optional[int] = None, device=None) -> bool:
    """Whether a host-streamed solve can ADMIT an (n, n) system: the host
    must hold ~``OUTOFCORE_HOST_FACTOR`` matrix copies, and the
    device-budget fraction must fit the first group block beside at least
    a one-panel tile window. Emitted as a ``vmem_estimate`` obs event."""
    from gauss_tpu_torch.core import blocked

    panel, chunk = _group_width(n, panel, chunk, itemsize)
    npad = -(-n // panel) * panel
    host_budget = (host_memory_budget() if host_budget is None
                   else int(host_budget))
    dev_budget = (blocked.device_memory_budget(device) if budget is None
                  else int(budget))
    host_est = int(OUTOFCORE_HOST_FACTOR * npad * npad * itemsize)
    dev_est = npad * (chunk * panel
                      + PIPELINE_TILE_BUFFERS * panel) * itemsize
    fits = (host_est <= host_budget
            and dev_est <= OUTOFCORE_DEVICE_FRAC * dev_budget)
    obs.emit("vmem_estimate", label="outofcore_hbm", n=n, panel=panel,
             chunk=chunk, itemsize=itemsize, bytes=dev_est,
             budget=dev_budget, host_bytes=host_est,
             host_budget=host_budget, fits=fits)
    return fits


# -- the host matrix and the copies ------------------------------------------


def pinned_empty(shape, dtype: torch.dtype) -> torch.Tensor:
    """An uninitialized CPU tensor in page-locked memory, allocated by
    ``cudaHostAlloc`` (``csrc/hostcopy.cu``) at exactly its size and
    freed when the last tensor or array on it goes. Raises when the
    memory cannot be had."""
    from gauss_tpu_torch.kernels import _build

    lib = _build.library("hostcopy")
    count = int(np.prod(shape))
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = max(1, count * itemsize)
    ptr = ctypes.c_void_p()
    _build.check(lib, lib.gtt_host_alloc(ctypes.byref(ptr), nbytes),
                 f"cudaHostAlloc of {nbytes} bytes")
    raw = (ctypes.c_uint8 * nbytes).from_address(ptr.value)
    weakref.finalize(raw, lib.gtt_host_free, ptr.value)
    flat = torch.from_numpy(np.frombuffer(raw, dtype=np.uint8))
    return flat[:count * itemsize].view(dtype).view(*shape)


class _Pipe:
    """The copies between the host matrix and the card: on the card a
    strided ``cudaMemcpy2DAsync`` on the H2D or D2H stream, each
    bracketed by timing events, against the compute stream (the current
    one, where the kernels and GEMMs run); on the CPU plain copies."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.card = dev.type == "cuda"
        self._timers: list = []
        if self.card:
            from gauss_tpu_torch.kernels import _build

            self._build = _build
            self.lib = _build.library("hostcopy")
            self.cs = torch.cuda.current_stream(dev)
            self.hs = torch.cuda.Stream(dev)
            self.ds = torch.cuda.Stream(dev)

    def _event(self):
        return torch.cuda.Event(enable_timing=True)

    def _copy2d(self, dst: torch.Tensor, src: torch.Tensor, kind: int,
                stream) -> None:
        for t in (dst, src):
            if t.stride(1) != 1:
                raise ValueError(f"a strided copy needs unit column stride, "
                                 f"got strides {t.stride()}")
        rows, cols = src.shape
        if rows == 0 or cols == 0:
            return
        es = src.element_size()
        rc = self.lib.gtt_copy2d(dst.data_ptr(), dst.stride(0) * es,
                                 src.data_ptr(), src.stride(0) * es,
                                 cols * es, rows, kind, stream.cuda_stream)
        self._build.check(self.lib, rc, f"cudaMemcpy2DAsync {rows}x{cols}")

    def h2d(self, host: torch.Tensor):
        """Start copying the (rows, cols) window ``host`` (unit column
        stride) of the host matrix into a new device tensor. Returns
        ``(tensor, ready event)``; the event is None on the CPU."""
        if not self.card:
            return host.clone(), None
        with torch.cuda.stream(self.hs):
            dst = torch.empty(host.shape, dtype=host.dtype, device=self.dev)
        start, end = self._event(), self._event()
        start.record(self.hs)
        self._copy2d(dst, host, 1, self.hs)
        end.record(self.hs)
        dst.record_stream(self.cs)
        self._timers.append(("h2d_device_s", start, end))
        return dst, end

    def d2h(self, host: torch.Tensor, src: torch.Tensor, after=None):
        """Start copying the device tensor ``src`` into the host window
        ``host``, after the compute event ``after``. Returns the done
        event (None on the CPU, where the copy is done)."""
        if not self.card:
            host.copy_(src)
            return None
        if after is not None:
            self.ds.wait_event(after)
        start, end = self._event(), self._event()
        start.record(self.ds)
        self._copy2d(host, src, 2, self.ds)
        end.record(self.ds)
        src.record_stream(self.ds)
        self._timers.append(("d2h_device_s", start, end))
        return end

    def wait_ready(self, event) -> None:
        """The compute stream waits for a copy's event."""
        if event is not None:
            self.cs.wait_event(event)

    def mark(self):
        """A timing event on the compute stream (None on the CPU)."""
        if not self.card:
            return None
        e = self._event()
        e.record(self.cs)
        return e

    def computed(self, start, end) -> None:
        if start is not None:
            self._timers.append(("compute_device_s", start, end))

    @staticmethod
    def sync(event) -> None:
        if event is not None:
            event.synchronize()

    def settle(self, stats: StreamStats) -> None:
        """Add the device seconds of the finished copies and updates to
        ``stats`` (their events have completed)."""
        for key, start, end in self._timers:
            end.synchronize()
            setattr(stats, key,
                    getattr(stats, key) + start.elapsed_time(end) / 1e3)
        self._timers.clear()


def _stage_host(a_np: np.ndarray, npad: int, dtype: torch.dtype,
                card: bool) -> torch.Tensor:
    """The host working copy: ``_pad_to_panel``'s identity-padded layout,
    page-locked on the card, written on the host so that the full matrix
    never touches the device."""
    n = a_np.shape[0]
    m = (pinned_empty((npad, npad), dtype) if card
         else torch.empty((npad, npad), dtype=dtype))
    m[:n, :n].copy_(_host_rows(a_np))
    if npad > n:
        m[:n, n:] = 0
        m[n:] = 0
        idx = torch.arange(n, npad)
        m[idx, idx] = 1
    return m


def _host_rows(a: np.ndarray) -> torch.Tensor:
    """A numpy block as a CPU tensor without a copy where torch reads its
    dtype (a numpy bfloat16 block goes through float32, exactly)."""
    if str(a.dtype) == "bfloat16":
        a = np.asarray(a, np.float32)
    return torch.from_numpy(np.asarray(a))


def _as_host_array(a) -> np.ndarray:
    """The caller's operand as a host numpy array (a bfloat16 tensor as
    float32, exactly)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.numpy()
    return np.asarray(a)


# -- the per-group and per-tile steps ----------------------------------------


def _group_step(grp, gperm, min_piv, panel: int, gpanels: int,
                panel_impl: str, mode: str, crow=None):
    """The shared per-group step: ``_factor_group`` on the group's own
    (gh, w) block, ``g0=0``, with the checksum row under the rider."""
    from gauss_tpu_torch.core import blocked

    return blocked._factor_group(grp, gperm, min_piv, 0, panel, gpanels,
                                 panel_impl, mode, crow=crow)


def _tile_step(grp, linvs, gperm, tile, panel: int, gpanels: int,
               mode: str, ctile=None, lc=None):
    """One (gh, ct) trailing tile's update: ``_factor_group``'s
    right-of-group math (its gathered form) on the tile's columns: the
    rows gathered by the group permutation, U12 = L_group^-1 top through
    the stored ``linvs``, then A22 -= L21 @ U12. Returns the updated tile
    (rows in the group's order) and, with the rider, the checksum slice's
    update and the tile's column-sum mismatch and its column."""
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.core.matmul import gdot

    dt = tile.dtype
    w = gpanels * panel
    tp = tile[gperm]
    u12 = torch.empty((w, tile.shape[1]), dtype=dt, device=tile.device)
    for i in range(gpanels):
        s = slice(i * panel, (i + 1) * panel)
        r = tp[s]
        if i:
            r = r - blocked._gdot(grp[s, :i * panel], u12[:i * panel], mode,
                                  dt)
        u12[s] = blocked._gdot(linvs[i], r, mode, dt)
    fresh = tp[w:]
    fresh -= blocked._gdot(grp[w:], u12, mode, dt)
    tp[:w] = u12
    if ctile is None:
        return tp, None, None, None
    cnew = ctile - gdot(lc, u12, mode)
    diff = blocked._nan_inf_abs(fresh.sum(0) - cnew[0])
    return tp, cnew, diff.max(), diff.argmax()


# -- the streamed factorization ----------------------------------------------


def lu_factor_outofcore(a, *, panel: Optional[int] = None,
                        chunk: Optional[int] = None,
                        ct: Optional[int] = None,
                        panel_impl: str = "auto",
                        gemm_precision: str = "highest",
                        dtype=None, abft: bool = False,
                        checkpoint_path=None,
                        checkpoint_every_groups: int = 1,
                        resume: bool = True,
                        keep: bool = False, device=None,
                        alloc_peak: bool = False) -> OutOfCoreLU:
    """Host-streamed blocked LU with partial pivoting.

    The math of ``lu_factor_blocked_chunked`` (the per-group step is the
    shared ``_factor_group``) with the matrix held and updated in host
    memory and only the active group and a ``ct``-wide tile window on the
    device. ``ct`` defaults to :func:`outofcore_window`; ``chunk`` (panels
    per group) consults the tuned store (op ``outofcore``), seed 16.
    ``dtype``: float32 (default) or bfloat16 storage.

    ``abft=True`` checks the checksum identities per group and per tile
    (typed :class:`SDCDetectedError` on a mismatch, ``abft_err`` on the
    result otherwise). ``checkpoint_path`` saves the host carry every
    ``checkpoint_every_groups`` groups (atomic, previous generation kept,
    digest-guarded resume, the JAX package's format); on success the files
    go unless ``keep``. ``device``: where the groups and tiles run
    (default ``cuda``; ``"cpu"`` runs the same steps on the CPU).
    ``alloc_peak``: read the allocator's peak into the StreamStats
    (``_stats_scope``; it resets the device's peak statistics)."""
    from gauss_tpu_torch.core import blocked
    from gauss_tpu_torch.core.matmul import resolve_precision
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    a_np = _as_host_array(a)
    n = a_np.shape[0]
    if a_np.shape != (n, n):
        raise ValueError(f"expected square matrix, got {a_np.shape}")
    dt = blocked._torch_dtype(torch.float32 if dtype is None else dtype)
    itemsize = torch.empty((), dtype=dt).element_size()
    mode = resolve_precision(gemm_precision, allow_split=True)
    if panel_impl not in blocked.PANEL_IMPLS:
        raise ValueError(f"unknown panel_impl {panel_impl!r}; options: "
                         f"{blocked.PANEL_IMPLS}")
    blocked._check_lowered_support(dt, mode, abft)
    panel, chunk = _group_width(n, panel, chunk, itemsize)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    npad = -(-n // panel) * panel
    nb = npad // panel
    if ct is None:
        ct = outofcore_window(n, panel, chunk, itemsize, device=dev)
    ct = max(panel, (int(ct) // panel) * panel)
    dtype_name = str(dt).replace("torch.", "")

    with _stats_scope(dev, alloc_peak, n=n, panel=panel, chunk=chunk,
                      ct=ct) as stats:
        stats.n, stats.npad = n, npad
        stats.panel, stats.chunk, stats.ct = panel, chunk, ct
        pipe = _Pipe(dev)
        t_stage = time.perf_counter()
        m_host = _stage_host(a_np, npad, dt, pipe.card)
        stats.stage_s += time.perf_counter() - t_stage
        perm_host = torch.arange(npad)
        min_piv = torch.full((), float("inf"), dtype=dt, device=dev)
        stats.add_dev(_nbytes(min_piv))
        linv_parts, uinv_parts = [], []
        abft_errs: list = []
        crow_host = tol = None
        if abft:
            crow_host = m_host.sum(0, keepdim=True)
            tol = blocked.abft_default_tol(
                npad, dt, float(crow_host.abs().max()))
        #: retired group blocks whose rows left of later groups still
        #: wait for the later groups' permutations: (first column, width,
        #: the row order when the block retired).
        pending: list = []

        # -- checkpoint/resume (the resilience.checkpoint carry) ----------
        start_group = 0
        ckpt = None
        if checkpoint_path is not None:
            from gauss_tpu_torch.resilience import checkpoint as ckpt

            meta = {"schema": ckpt.SCHEMA, "n": n, "panel": panel,
                    "chunk": chunk, "panel_impl": panel_impl,
                    "gemm_precision": gemm_precision, "dtype": dtype_name,
                    "digest": ckpt._digest(a_np), "outofcore": True,
                    "abft": bool(abft)}
            state = (ckpt._load_resume_state(os.fspath(checkpoint_path),
                                             meta) if resume else None)
            if state is not None:
                m_host.copy_(_host_rows(state["m"]))
                perm_host = torch.as_tensor(
                    np.asarray(state["perm"], dtype=np.int64))
                min_piv = torch.full((), float(state["min_piv"].item()),
                                     dtype=dt, device=dev)
                if state["linvs"].size:
                    linv_parts = [torch.as_tensor(state["linvs"])]
                    uinv_parts = [torch.as_tensor(state["uinvs"])]
                start_group = int(state["meta"]["next_group"])
                # The retired blocks stand in the saved order; the groups
                # still to come permute their rows on.
                saved = perm_host.clone()
                pending = [(g * panel, min(chunk, nb - g) * panel, saved)
                           for g in range(0, start_group, chunk)]
                if abft:
                    crow_host = _resume_crow(m_host, a_np, dt,
                                             start_group * panel)
                obs.counter("outofcore.resumes")
                obs.emit("outofcore", event="resume",
                         next_group=start_group)

        groups_done = 0
        for g0 in range(start_group, nb, chunk):
            _inject.maybe_kill("outofcore.group")
            gs = g0 * panel
            gh = npad - gs
            gpanels = min(chunk, nb - g0)
            w = gpanels * panel

            # H2D the group's own column block (+ the checksum slice).
            with _timed(stats, "h2d_s", "outofcore.h2d", what="group",
                        group=g0, bytes=gh * w * itemsize):
                grp, ready = pipe.h2d(m_host[gs:, gs:gs + w])
                pipe.sync(ready)
                pipe.wait_ready(ready)
                gperm = torch.arange(gh, device=dev)
                stats.add_dev(_nbytes(grp) + _nbytes(gperm))
                stats.bytes_h2d += _nbytes(grp)
                crow_dev = None
                if abft:
                    crow_dev = crow_host[:, gs:gs + w].to(dev)
                    stats.add_dev(_nbytes(crow_dev))
                    stats.bytes_h2d += _nbytes(crow_dev)

            t0 = pipe.mark()
            in_bytes = _nbytes(min_piv)
            gerr = gcol = None
            if abft:
                (grp, gperm, min_piv, linvs, uinvs, crow_dev, gerr,
                 gcol) = _group_step(grp, gperm, min_piv, panel, gpanels,
                                     panel_impl, mode, crow=crow_dev)
            else:
                grp, gperm, min_piv, linvs, uinvs = _group_step(
                    grp, gperm, min_piv, panel, gpanels, panel_impl, mode)
            pipe.computed(t0, pipe.mark())
            stats.sub_dev(in_bytes)
            stats.add_dev(_nbytes(min_piv) + _nbytes(linvs)
                          + _nbytes(uinvs))

            # -- the double-buffered trailing-tile pipeline ----------------
            tile_errs = _stream_group_tiles(
                pipe, stats, m_host, crow_host, gs, gh, w, ct, panel,
                gpanels, mode, grp, linvs, uinvs, gperm, crow_dev, itemsize)

            # Drain the group's own results back to the host.
            done = pipe.mark()
            with _timed(stats, "compute_wait_s", "outofcore.compute_wait",
                        what="group", group=g0):
                pipe.sync(done)
            with _timed(stats, "d2h_s", "outofcore.d2h", what="group",
                        group=g0, bytes=_nbytes(grp)):
                pipe.sync(pipe.d2h(m_host[gs:, gs:gs + w], grp))
                gperm_host = gperm.cpu()
                linv_parts.append(linvs.cpu())
                uinv_parts.append(uinvs.cpu())
                stats.bytes_d2h += _nbytes(grp)
            # The left columns' realignment waits (see _realign); the
            # columns right of the group were permuted inside each tile.
            perm_host[gs:] = perm_host[gs:][gperm_host]
            if gs + w < npad:
                pending.append((gs, w, perm_host.clone()))

            if abft:
                gerr_v, gcol_v = float(gerr), gs + int(gcol)
                worst = max(tile_errs, default=(0.0, -1))
                err, col = ((gerr_v, gcol_v) if gerr_v >= worst[0]
                            else worst)
                abft_errs.append(err)
                if err > tol:
                    obs.counter("outofcore.sdc_detected")
                    obs.emit("outofcore", event="sdc_detected", group=g0,
                             col=col, err=err, tol=tol)
                    raise SDCDetectedError(
                        f"ABFT checksum mismatch {err:.3e} (tol {tol:.3e}) "
                        f"in panel group {g0}, column {col}, of the "
                        f"streamed factorization", group=g0, col=col,
                        err=err)
                crow_host[:, gs:gs + w] = crow_dev.cpu()

            for buf in (grp, gperm, linvs, uinvs, crow_dev):
                if buf is not None:
                    stats.sub_dev(_nbytes(buf))
            del grp, gperm, linvs, uinvs, crow_dev
            pipe.settle(stats)
            groups_done += 1
            stats.groups += 1
            obs.counter("outofcore.groups")

            if (ckpt is not None and groups_done % checkpoint_every_groups
                    == 0 and g0 + chunk < nb):
                _realign(stats, m_host, perm_host, pending, final=False)
                nbytes = ckpt.save_state(
                    checkpoint_path,
                    meta={**meta, "next_group": g0 + chunk,
                          "panels_done": g0 + chunk},
                    m=_savable(m_host), perm=perm_host,
                    min_piv=min_piv.cpu(),
                    linvs=torch.cat(linv_parts), uinvs=torch.cat(uinv_parts))
                obs.counter("outofcore.checkpoint_saves")
                obs.emit("outofcore", event="checkpoint",
                         next_group=g0 + chunk, bytes=int(nbytes))

        _realign(stats, m_host, perm_host, pending, final=True)
        if ckpt is not None and not keep:
            for stale in (os.fspath(checkpoint_path),
                          ckpt.prev_path(checkpoint_path)):
                try:
                    os.unlink(stale)
                except OSError:
                    pass

        mp = float(min_piv)
        stats.sub_dev(_nbytes(min_piv))
        obs.emit("outofcore", event="factor_complete", **stats.to_dict())
        return OutOfCoreLU(
            m=m_host, perm=perm_host, min_abs_pivot=mp,
            linv=torch.cat(linv_parts), uinv=torch.cat(uinv_parts), n=n,
            panel=panel,
            abft_err=(np.asarray(abft_errs, dtype=np.float64)
                      if abft else None),
            device=str(dev))


def _savable(m: torch.Tensor) -> np.ndarray:
    """The host matrix as numpy for a checkpoint (bfloat16 as float32,
    exactly: the JAX package reads it back into its storage dtype)."""
    return (m.float() if m.dtype == torch.bfloat16 else m).numpy()


def _realign(stats: StreamStats, m_host: torch.Tensor,
             perm_host: torch.Tensor, pending: list, final: bool) -> None:
    """Gather each retired group block's rows below it into the current
    row order: the block's rows stand in the order ``order`` they had when
    it was last gathered and belong in ``perm_host``'s, the composition of
    the later groups' permutations, which the JAX package applies one
    group at a time. ``final``: no group follows, so ``pending`` is
    cleared; else (a checkpoint) each block waits on from the current
    order."""
    t0 = time.perf_counter()
    npad = m_host.shape[0]
    inv = torch.empty(npad, dtype=torch.int64)
    for c0, w, order in pending:
        r0 = c0 + w
        inv[order[r0:]] = torch.arange(r0, npad)
        rows = inv[perm_host[r0:]]
        m_host[r0:, c0:c0 + w] = m_host[rows, c0:c0 + w]
    if final:
        pending.clear()
    else:
        now = perm_host.clone()
        pending[:] = [(c0, w, now) for c0, w, _ in pending]
    stats.realign_s += time.perf_counter() - t0


def _resume_crow(m_host, a_np, dt, gs):
    """The checksum row after a resume: retired columns keep their
    original sums, the active trailing columns carry the sums of the
    current (partially updated) trailing block, which the per-tile
    identities check against."""
    npad = m_host.shape[0]
    n = a_np.shape[0]
    crow = torch.zeros((1, npad), dtype=dt)
    crow[0, :n] = _host_rows(a_np).to(dt).sum(0)
    crow[0, n:] = 1.0
    if gs:
        crow[0, gs:] = m_host[gs:, gs:].sum(0)
    return crow


def _stream_group_tiles(pipe, stats, m_host, crow_host, gs, gh, w, ct,
                        panel, gpanels, mode, grp, linvs, uinvs, gperm,
                        crow_dev, itemsize):
    """The per-group tile pipeline: tile t+1's H2D and tile t-1's D2H run
    while tile t's update runs. Returns each tile's checksum mismatch and
    its global column (empty without the rider)."""
    from gauss_tpu_torch.core import blocked

    npad = m_host.shape[0]
    cols = [(c0, min(c0 + ct, npad)) for c0 in range(gs + w, npad, ct)]
    if not cols:
        return []
    abft = crow_dev is not None
    lc = None
    if abft:
        lc = blocked._csum_group_solve(crow_dev, grp, uinvs, gpanels, panel,
                                       mode)
        stats.add_dev(_nbytes(lc))
    errs: list = []

    def start_h2d(c0, c1):
        host = m_host[gs:, c0:c1]
        if _inject.enabled():
            # Fault hook "outofcore.tile": corrupt the tile on its way to
            # the device, the surface the rider's per-tile identity
            # checks.
            copy = host.clone()
            blk = _inject.corrupt_operand("outofcore.tile", copy)
            if blk is not copy:
                host = blk
        tdev, ready = pipe.h2d(host)
        cdev = None
        if abft:
            cdev = crow_host[:, c0:c1].to(pipe.dev)
            stats.add_dev(_nbytes(cdev))
            stats.bytes_h2d += _nbytes(cdev)
        stats.add_dev(_nbytes(tdev))
        stats.bytes_h2d += _nbytes(tdev)
        return tdev, cdev, ready

    with _timed(stats, "h2d_s", "outofcore.h2d", what="tile",
                bytes=gh * (cols[0][1] - cols[0][0]) * itemsize):
        pending = start_h2d(*cols[0])
        pipe.sync(pending[2])
    prev = None  # (out, cout, err, col, (c0, c1), done event)
    for idx, (c0, c1) in enumerate(cols):
        tdev, cdev, ready = pending
        pipe.wait_ready(ready)
        t0 = pipe.mark()
        out, cout, err, col = _tile_step(grp, linvs, gperm, tdev, panel,
                                         gpanels, mode, cdev, lc)
        done = pipe.mark()
        pipe.computed(t0, done)
        stats.sub_dev(_nbytes(tdev) + (_nbytes(cdev) if abft else 0))
        stats.add_dev(_nbytes(out) + (_nbytes(cout) if abft else 0))
        del tdev, cdev
        # Start the NEXT tile's H2D and the PREVIOUS tile's D2H while this
        # one computes; then wait for the previous update, the H2D and
        # the D2H in turn.
        nxt = None
        if idx + 1 < len(cols):
            nxt = start_h2d(*cols[idx + 1])
        drained = None
        if prev is not None:
            drained = pipe.d2h(m_host[gs:, prev[4][0]:prev[4][1]], prev[0],
                               after=prev[5])
            with _timed(stats, "compute_wait_s", "outofcore.compute_wait",
                        what="tile"):
                pipe.sync(prev[5])
        if nxt is not None:
            with _timed(stats, "h2d_s", "outofcore.h2d", what="tile",
                        bytes=_nbytes(nxt[0])):
                pipe.sync(nxt[2])
        if prev is not None:
            _drain_tile(pipe, stats, crow_host, prev, drained, errs)
        pending = nxt
        prev = (out, cout, err, col, (c0, c1), done)
        stats.tiles += 1
        obs.counter("outofcore.tiles")
    drained = pipe.d2h(m_host[gs:, prev[4][0]:prev[4][1]], prev[0],
                       after=prev[5])
    with _timed(stats, "compute_wait_s", "outofcore.compute_wait",
                what="tile"):
        pipe.sync(prev[5])
    _drain_tile(pipe, stats, crow_host, prev, drained, errs)
    if lc is not None:
        stats.sub_dev(_nbytes(lc))
    return errs


def _drain_tile(pipe, stats, crow_host, prev, drained, errs):
    out, cout, err, col, (c0, c1), _ = prev
    with _timed(stats, "d2h_s", "outofcore.d2h", what="tile",
                bytes=_nbytes(out)):
        pipe.sync(drained)
        stats.bytes_d2h += _nbytes(out)
        if cout is not None:
            crow_host[:, c0:c1] = cout.cpu()
            errs.append((float(err), c0 + int(col)))
    stats.sub_dev(_nbytes(out) + (_nbytes(cout) if cout is not None else 0))


# -- streamed triangular solves ---------------------------------------------


def lu_solve_outofcore(fac: OutOfCoreLU, b, device=None,
                       alloc_peak: bool = False) -> np.ndarray:
    """Solve against a host-resident streamed factor: permute, then the
    two blockwise substitutions of ``core.blocked.lu_solve`` with the
    factor's (panel, npad) block rows STREAMED to the device one ahead
    (the solution and the diagonal-block inverses stay there: O(n k) and
    O(nb panel^2)). ``device`` defaults to the one the factor ran on;
    ``alloc_peak`` as for :func:`lu_factor_outofcore`. Returns float64,
    shaped like ``b``."""
    from gauss_tpu_torch.kernels.panel import accum_dtype
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(fac.device if device is None else device)
    m_host, perm = fac.m, fac.perm
    npad = m_host.shape[0]
    nb, panel = fac.linv.shape[0], fac.panel
    cdt = accum_dtype(m_host.dtype)
    b = np.asarray(b)
    was_vector = b.ndim == 1
    b2 = b[:, None] if was_vector else b
    n, k = b2.shape
    bp = torch.zeros((npad, k), dtype=cdt)
    bp[:n] = torch.from_numpy(np.asarray(b2, dtype=np.float64)).to(cdt)
    bp = bp[perm]

    with _stats_scope(dev, alloc_peak, n=fac.n, panel=panel) as stats:
        stats.solves += 1
        pipe = _Pipe(dev)
        rhs = bp.to(dev)
        linv_dev = fac.linv.to(dev)
        uinv_dev = fac.uinv.to(dev)
        x = torch.zeros((npad, k), dtype=cdt, device=dev)
        for buf in (rhs, linv_dev, uinv_dev, x):
            stats.add_dev(_nbytes(buf))
        x = _stream_substitution(pipe, stats, m_host, linv_dev, rhs, x,
                                 panel, nb, lower=True)
        # Backward sweep: the forward result becomes the rhs.
        stats.sub_dev(_nbytes(rhs))
        rhs = x
        x = torch.zeros((npad, k), dtype=cdt, device=dev)
        stats.add_dev(_nbytes(x))
        x = _stream_substitution(pipe, stats, m_host, uinv_dev, rhs, x,
                                 panel, nb, lower=False)
        with _timed(stats, "d2h_s", "outofcore.d2h", what="solution",
                    bytes=_nbytes(x)):
            out = x.cpu().double().numpy()[:n]
            stats.bytes_d2h += _nbytes(x)
        for buf in (rhs, linv_dev, uinv_dev, x):
            stats.sub_dev(_nbytes(buf))
        pipe.settle(stats)
    return out[:, 0] if was_vector else out


def _subst_step(strip, inv_i, rhs, x, i: int) -> None:
    """One block row of a substitution sweep (``lu_solve``'s blockwise
    body) with the block row ``strip`` streamed in; ``x`` in place."""
    p = strip.shape[0]
    s = slice(i * p, (i + 1) * p)
    r = rhs[s] - strip.to(x.dtype) @ x
    x[s] = inv_i @ r


def _stream_substitution(pipe, stats, m_host, invs_dev, rhs, x, panel, nb,
                         lower: bool):
    """One streamed substitution sweep: block rows arrive from the host,
    prefetched one ahead of the step that reads them."""
    order = list(range(nb)) if lower else list(range(nb - 1, -1, -1))

    def start(i):
        s, ready = pipe.h2d(m_host[i * panel:(i + 1) * panel])
        stats.add_dev(_nbytes(s))
        stats.bytes_h2d += _nbytes(s)
        return s, ready

    with _timed(stats, "h2d_s", "outofcore.h2d", what="strip",
                bytes=panel * m_host.shape[1] * m_host.element_size()):
        pending = start(order[0])
        pipe.sync(pending[1])
    for pos, i in enumerate(order):
        strip, ready = pending
        pipe.wait_ready(ready)
        t0 = pipe.mark()
        _subst_step(strip, invs_dev[i], rhs, x, i)
        pipe.computed(t0, pipe.mark())
        stats.sub_dev(_nbytes(strip))
        del strip
        pending = None
        if pos + 1 < len(order):
            with _timed(stats, "h2d_s", "outofcore.h2d", what="strip",
                        bytes=panel * m_host.shape[1]
                        * m_host.element_size()):
                pending = start(order[pos + 1])
                pipe.sync(pending[1])
    done = pipe.mark()
    with _timed(stats, "compute_wait_s", "outofcore.compute_wait",
                what="substitution"):
        pipe.sync(done)
    return x


# -- the refined giant solve -------------------------------------------------


def _residual_chunked(a_np: np.ndarray, x: np.ndarray,
                      b64: np.ndarray) -> np.ndarray:
    """``b - A @ x`` in float64 without a full float64 copy of a giant
    operand: row blocks are upcast on the fly."""
    r = np.empty_like(b64)
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))
    n = a_np.shape[0]
    # One float64 block buffer for every row block: a fresh one per block
    # would take its page faults again each time.
    buf = torch.empty((min(RESIDUAL_ROW_BLOCK, n), a_np.shape[1]),
                      dtype=torch.float64)
    for r0 in range(0, n, RESIDUAL_ROW_BLOCK):
        r1 = min(r0 + RESIDUAL_ROW_BLOCK, n)
        blk = buf[:r1 - r0]
        blk.copy_(_host_rows(a_np[r0:r1]))
        r[r0:r1] = b64[r0:r1] - (blk @ xt).numpy()
    return r


def solve_outofcore(a, b, *, panel: Optional[int] = None,
                    chunk: Optional[int] = None, ct: Optional[int] = None,
                    iters: int = 3, tol: float = 0.0, dtype=None,
                    abft: bool = False, checkpoint_path=None,
                    checkpoint_every_groups: int = 1,
                    gemm_precision: str = "highest",
                    device=None, alloc_peak: bool = False) -> np.ndarray:
    """Solve ``a @ x = b`` for systems beyond the card's memory: streamed
    factorization, streamed triangular solves and host float64 iterative
    refinement (chunked residuals: no full float64 copy of the operand).
    Returns x float64, shaped like ``b``. One :class:`StreamStats` record
    covers the whole solve (``last_stream_stats()``; also emitted as an
    ``outofcore`` obs event). ``device`` and ``alloc_peak`` as for
    :func:`lu_factor_outofcore`."""
    from gauss_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    a_np = _as_host_array(a)
    n = a_np.shape[0]
    b64 = np.asarray(b, dtype=np.float64)
    with _stats_scope(dev, alloc_peak, n=n) as stats:
        with obs.span("outofcore.solve", n=n):
            fac = lu_factor_outofcore(
                a_np, panel=panel, chunk=chunk, ct=ct, dtype=dtype,
                abft=abft, checkpoint_path=checkpoint_path,
                checkpoint_every_groups=checkpoint_every_groups,
                gemm_precision=gemm_precision, device=dev)
            x = lu_solve_outofcore(fac, b64)
            x2 = x[:, None] if x.ndim == 1 else x
            b2 = b64[:, None] if b64.ndim == 1 else b64
            tol_eff = (tol * min(1.0, float(np.linalg.norm(b64)))
                       if tol > 0.0 else 0.0)
            for _ in range(iters):
                r = _residual_chunked(a_np, x2, b2)
                if tol > 0.0 and float(np.linalg.norm(r)) <= tol_eff:
                    break
                d = lu_solve_outofcore(fac, r)
                x2 = x2 + (d[:, None] if d.ndim == 1 else d)
            x = x2[:, 0] if b64.ndim == 1 else x2
        obs.emit("outofcore", event="solve_complete", **stats.to_dict())
    return x

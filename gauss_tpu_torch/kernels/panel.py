"""Panel factorization: partial-pivot LU of one (h, panel) column block.

Port of ``gauss_tpu/kernels/panel_pallas.py::panel_factor_pallas`` (the
classic per-step rank-1 form). Two CUDA kernels compute it, chosen by
shape alone (:func:`panel_geometry`): ``csrc/panel_cluster.cu``, one
thread-block cluster of up to 16 blocks holding the strip in shared
memory, for every strip such a cluster holds (at panel 256, up to 3,392
rows); and ``csrc/panel_factor.cu``, one block over a global scratch, for
taller strips. Both are bit for bit equal to :func:`panel_factor_plain`,
the same step loop in plain PyTorch, in the same order, which is what a
CPU tensor runs.

The scheme (kept from the JAX package): the panel is held TRANSPOSED,
(panel, h), so column j is one contiguous row; rows are never swapped — a
``done`` mask retires rows above the diagonal block (``r < kb``) and chosen
pivots, and the permutation is emitted as an inverse-position vector
(``inv``: row -> new position, pivots at ``kb + j`` in choice order,
unchosen rows after them in original order) that the wrapper turns into
gather indices. Pivot choice is ``argmax |column|`` over live rows with
``jnp.argmax``'s order: a NaN beats every number (the first NaN wins),
ties go to the lowest ORIGINAL row index. A NaN pivot counts as 0 in
``min_abs_pivot``.

Storage is float32 or bfloat16 (the lowered factor of ``core.lowered``).
At bfloat16 every operation of the step loop is done in float32 and
rounded to bfloat16 right after it, in the plain version's order: the
division ``col / piv``, the product ``u * mult`` (exact in float32, so one
rounding) and the subtraction. That is what PyTorch's bfloat16 arithmetic
does op by op, and what the JAX package's kernel computes at bfloat16
(bit for bit in interpret mode with ``seg=panel``); pivots are chosen on
the rounded values. The cluster kernel's strip is bfloat16 in shared
memory, so a cluster holds about twice the rows: up to 6,848 at panel
256, against 3,392 at float32 (:func:`panel_geometry`). The CUDA entry
points of the two dtypes are separate symbols and count their launches
under separate keys (``panel_factor_bf16``, ``panel_factor_cluster_bf16``).

Deviation from the JAX package: the two-level deferred form (``defer``)
and the ``seg`` segmentation exist there for VMEM and MXU limits; the port
runs the classic single-segment form only (``seg`` is accepted for API
parity and ignored). On finite inputs segmentation never changes a value
at float32; at bfloat16 the JAX package's ``defer`` form rounds
differently, so its tests pass ``seg=panel``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gauss_tpu_torch.kernels import _build

#: Sub-panel segment width seed of the JAX package's classic form (its
#: tuner seed); the port keeps the name for the fused tile resolution.
PANEL_SEG_SEED = 64
DEFAULT_SEG = PANEL_SEG_SEED

#: The routing rule of the panel-factor kernels, as compiled into
#: ``csrc/panel_cluster.cuh``: the widest panel either kernel takes, the
#: widest cluster, the rows a cluster block aims to hold (measured on the
#: H100, ``PERF.md``), and the dynamic shared memory of one sm_90 block.
PANEL_MAX = 1024
PANEL_CLUSTER_MAX = 16
PANEL_CLUSTER_ROWS = 16
PANEL_SMEM_MAX = 232448
#: The storage dtypes the panel kernels take.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class PanelGeometry(NamedTuple):
    route: str           # "cluster" (csrc/panel_cluster.cu) or "block"
    cluster: int         # blocks in the cluster (1 on the one-block route)
    rows_per_block: int
    smem_bytes: int      # dynamic shared memory per block (0 for "block")


def cluster_smem_bytes(rows: int, panel: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of a cluster block holding ``rows`` rows of a
    ``panel``-wide strip of ``itemsize``-byte words: the strip at a column
    stride of ``r4 | 4`` words (rows rounded up to 4), its bytes rounded
    up to 16; then two candidate slots and two pivot rows of ``panel``
    floats, two multiplier columns of ``r4`` floats, the step records, and
    two parities of 16 pushed candidates of 4 words."""
    r4 = -(-rows // 4) * 4
    strip = -(-(itemsize * panel * (r4 | 4)) // 16) * 16
    return strip + 4 * (4 * panel + 2 * r4 + rows + 2 * 16 * 4)


def panel_geometry(h: int, panel: int, itemsize: int = 4) -> PanelGeometry:
    """The kernel an (h, panel) strip of ``itemsize``-byte words takes on
    the card, by the C launcher's rule: a cluster of C blocks, C from
    ``ceil(h / PANEL_CLUSTER_ROWS)`` (at most ``PANEL_CLUSTER_MAX``) up to
    the first whose blocks' rows fit their shared memory; the one-block
    kernel when no C up to ``PANEL_CLUSTER_MAX`` fits (at panel 256, above
    3,392 rows at float32 and above 6,848 at bfloat16)."""
    if 1 <= panel <= PANEL_MAX and h >= 1:
        first = min(PANEL_CLUSTER_MAX, max(1, -(-h // PANEL_CLUSTER_ROWS)))
        for c in range(first, PANEL_CLUSTER_MAX + 1):
            rows = -(-h // c)
            smem = cluster_smem_bytes(rows, panel, itemsize)
            if smem <= PANEL_SMEM_MAX:
                return PanelGeometry("cluster", c, rows, smem)
    return PanelGeometry("block", 1, h, 0)


def argmax_nan_first(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` order on a 1-D tensor without a host sync: the first
    NaN if any, else the first maximal value."""
    nan = torch.isnan(x)
    best = torch.argmax(torch.where(nan, torch.full_like(x, float("-inf")),
                                    x))
    return torch.where(nan.any(), torch.argmax(nan.to(torch.int32)), best)


def factor_steps_plain(t: torch.Tensor, kb: int, record: bool = False):
    """The pivot-step loop on a transposed (panel, h) panel ``t`` (not
    modified). Returns ``(t_factored, ipiv, inv, chosen, min_abs_pivot,
    mult)``; ``mult`` is the (panel, h) record of each step's multiplier
    row (0 on done rows) when ``record`` else None."""
    panel, h = t.shape
    dev, dt = t.device, t.dtype
    rows = torch.arange(h, device=dev)
    cols = torch.arange(panel, device=dev)
    inv = rows.to(torch.int32)
    chosen = torch.zeros(h, dtype=torch.int32, device=dev)
    ipiv = torch.zeros(panel, dtype=torch.int32, device=dev)
    done = rows < kb
    zero = torch.zeros((), dtype=dt, device=dev)
    ninf = torch.full((), float("-inf"), dtype=dt, device=dev)
    minpiv = torch.full((), float("inf"), dtype=dt, device=dev)
    mult_rec = (torch.zeros((panel, h), dtype=dt, device=dev) if record
                else None)
    for j in range(panel):
        col = t[j].clone()
        p = argmax_nan_first(torch.where(done, ninf, col.abs())).view(1)
        ipiv[j:j + 1] = p.to(torch.int32)
        inv.index_fill_(0, p, kb + j)
        chosen.index_fill_(0, p, 1)
        u = t.index_select(1, p)[:, 0]  # the pivot row, (panel,)
        piv = u[j]
        apiv = piv.abs()
        minpiv = torch.minimum(minpiv,
                               torch.where(torch.isnan(apiv), zero, apiv))
        done = done.index_fill(0, p, True)
        q = col / piv
        mult = torch.where(done, zero, q)
        if record:
            mult_rec[j] = mult
        row_j_new = torch.where(done, col, q)
        upd = torch.where(cols > j, u, zero)
        t = torch.where((cols == j)[:, None], row_j_new[None, :],
                        t - upd[:, None] * mult[None, :])
    return t, ipiv, inv, chosen, minpiv, mult_rec


def perm_from_inv(inv: torch.Tensor, chosen: torch.Tensor, kb: int,
                  panel: int) -> torch.Tensor:
    """Gather indices (int64) from the inverse-position vector: unchosen
    rows at or below ``kb`` keep their original relative order after the
    ``panel`` chosen pivots."""
    h = inv.shape[0]
    rows = torch.arange(h, device=inv.device)
    unch = (rows >= kb) & (chosen == 0)
    rank = torch.cumsum(unch.to(torch.int64), 0)
    full = torch.where(unch, kb + panel - 1 + rank, inv.to(torch.int64))
    return torch.empty_like(rows).scatter_(0, full, rows)


def panel_factor_plain(p: torch.Tensor, kb: int = 0):
    """The plain PyTorch version of :func:`panel_factor`."""
    h, panel = p.shape
    t, ipiv, inv, chosen, minpiv, _ = factor_steps_plain(p.T, kb)
    perm_local = perm_from_inv(inv, chosen, kb, panel)
    return t.T[perm_local], ipiv, perm_local, minpiv


def _check_row_major(x: torch.Tensor, what: str) -> None:
    if x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"{what}: expected a 2-D row-major tensor "
                         f"(unit column stride), got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")


def check_cuda_f32(x: torch.Tensor, what: str) -> None:
    """A float32 2-D row-major tensor, for the kernels that take float32
    only (matmul, rowelim)."""
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes float32, got "
                        f"{x.dtype}")
    _check_row_major(x, what)


def check_cuda_storage(x: torch.Tensor, what: str) -> None:
    """A 2-D row-major tensor in one of :data:`KERNEL_DTYPES` (float32 or
    bfloat16), for the panel, fused and trailing kernels."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what}: the CUDA kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    _check_row_major(x, what)


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulate dtype: float32 for bfloat16 storage, else the
    storage dtype itself."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def launch_suffix(dtype: torch.dtype) -> str:
    """The suffix of a bfloat16 kernel's C symbol and launch key."""
    return "_bf16" if dtype == torch.bfloat16 else ""


def _panel_factor_cuda(p: torch.Tensor, kb: int, cluster: int | None):
    """Launch a panel-factor kernel: the cluster kernel at ``cluster``
    blocks, at the rule's size when ``cluster`` is 0, or the one-block
    kernel when ``cluster`` is None."""
    if p.stride(1) != 1:
        p = p.contiguous()
    check_cuda_storage(p, "panel_factor")
    h, panel = p.shape
    dev = p.device
    pt = torch.empty((panel, h), dtype=p.dtype, device=dev)
    ipiv = torch.empty(panel, dtype=torch.int32, device=dev)
    inv = torch.empty(h, dtype=torch.int32, device=dev)
    chosen = torch.empty(h, dtype=torch.int32, device=dev)
    minpiv = torch.empty(1, dtype=p.dtype, device=dev)
    args = (p.data_ptr(), p.stride(0), h, panel, int(kb), pt.data_ptr(),
            ipiv.data_ptr(), inv.data_ptr(), chosen.data_ptr(),
            minpiv.data_ptr())
    sfx = launch_suffix(p.dtype)
    name = ("panel_factor" if cluster is None
            else "panel_factor_cluster") + sfx
    lib = _build.library("panel_factor" if cluster is None
                         else "panel_cluster")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cluster is None:
            rc = getattr(lib, "gtt_panel_factor" + sfx)(*args, stream)
        elif cluster == 0:
            rc = getattr(lib, "gtt_panel_factor_cluster" + sfx)(*args,
                                                               stream)
        else:
            rc = getattr(lib, "gtt_panel_factor_cluster_at" + sfx)(
                *args, int(cluster), stream)
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    perm_local = perm_from_inv(inv, chosen, kb, panel)
    return pt.T[perm_local], ipiv, perm_local, minpiv[0]


def _check_panel_args(p: torch.Tensor, kb: int, what: str) -> None:
    if p.dim() != 2 or p.shape[0] - kb < p.shape[1] or kb < 0:
        raise ValueError(f"{what} expects (h, panel) with at least "
                         f"panel rows at or below kb={kb}, got "
                         f"{tuple(p.shape)}")


def panel_factor_cluster(p: torch.Tensor, kb: int = 0,
                         cluster: int | None = None):
    """:func:`panel_factor` through the cluster kernel at ``cluster``
    blocks (None: the rule's, even for a strip the rule sends to the
    one-block kernel, which then raises). For measuring cluster sizes and
    for the tests; needs a CUDA tensor. A cluster that does not fit on the
    card raises RuntimeError."""
    _check_panel_args(p, kb, "panel_factor_cluster")
    if p.device.type != "cuda":
        raise ValueError(f"panel_factor_cluster: the kernel needs a CUDA "
                         f"tensor, got one on {p.device}")
    return _panel_factor_cuda(p, kb, 0 if cluster is None else cluster)


def panel_cluster_info(h: int, panel: int, cluster: int = 0,
                       itemsize: int = 4) -> dict:
    """What the C launcher reports for an (h, panel) strip of
    ``itemsize``-byte words (4: float32, 2: bfloat16) at ``cluster``
    blocks (0: its rule's): the cluster size (0 on the one-block route),
    rows per block, dynamic shared memory bytes and the clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``). Builds
    ``csrc/panel_cluster.cu``; needs a CUDA device."""
    lib = _build.library("panel_cluster")
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.gtt_panel_cluster_info(h, panel, cluster,
                                                 itemsize, out),
                 "panel_cluster_info")
    return {"cluster": out[0], "rows_per_block": out[1],
            "smem_bytes": out[2], "max_active_clusters": out[3]}


def panel_factor(p: torch.Tensor, kb: int = 0, seg: int | None = None):
    """Factor one (h, panel) column block whose diagonal sits at row ``kb``.

    Returns ``(p_perm, ipiv, perm_local, min_abs_pivot)``: the factored
    panel already row-permuted (getrf layout: multipliers below the
    diagonal, U on and above it), the pivot rows per step (int32, indices
    into ``p``), the permutation as int64 gather indices, and min |pivot|
    (0 for singular input). ``p`` is not modified.

    ``p`` is float32 or bfloat16 (the factored panel and min |pivot|
    come back in its dtype). A CUDA tensor launches the kernel
    :func:`panel_geometry` names for its shape and itemsize
    (``csrc/panel_cluster.cu`` or ``csrc/panel_factor.cu``) or raises; a
    CPU tensor runs :func:`panel_factor_plain`. ``seg`` is
    accepted for parity with the JAX package and ignored."""
    del seg
    _check_panel_args(p, kb, "panel_factor")
    if p.device.type == "cpu":
        return panel_factor_plain(p, kb)
    if p.device.type != "cuda":
        raise ValueError(f"panel_factor: unsupported device {p.device}")
    route = panel_geometry(*p.shape, p.element_size()).route
    return _panel_factor_cuda(p, kb, 0 if route == "cluster" else None)

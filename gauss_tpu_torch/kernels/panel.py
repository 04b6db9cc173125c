"""Panel factorization: partial-pivot LU of one (h, panel) column block.

Port of ``gauss_tpu/kernels/panel_pallas.py::panel_factor_pallas`` (the
classic per-step rank-1 form). Three CUDA kernels compute it, chosen by
shape alone (:func:`panel_geometry`), one per route:

- ``"cluster"``: ``csrc/panel_cluster.cu``, one thread-block cluster of
  up to 16 blocks holding the strip in shared memory, for every strip
  such a cluster holds (at panel 256, up to 3,392 rows);
- ``"grid"``: ``csrc/panel_grid.cu``, G co-resident blocks (G <= 132,
  one launch of exactly G, cooperative) holding the strip in shared
  memory and exchanging each pivot step through L2, for the taller strips
  such a group holds (at panel 256 up to 27,984 rows; :func:`grid_size`);
- ``"block"``: ``csrc/panel_factor.cu``, one block over a global scratch,
  for strips beyond the grid's reach (e.g. panel 1024 above 6,864 rows).
  :func:`panel_factor_one_block` reaches it on any strip, to time it.

All are bit for bit equal to :func:`panel_factor_plain`, the same step
loop in plain PyTorch, in the same order, which is what a CPU tensor
runs.

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
under separate keys (``panel_factor_bf16``, ``panel_factor_cluster_bf16``,
``panel_factor_grid_bf16``).

:func:`panel_factor_batched` factors a (B, h, panel) stack of strips in
one launch (``csrc/panel_batched.cu``: members of up to 256 rows and
columns on a step loop that keeps each member in the registers of one
block, or of a cluster of 4 above 128, every thread working every step;
taller members on the one-block step loop; :func:`panel_batched_geometry`
names the route; launch key ``panel_factor_batched``, and
``panel_factor_batched_bf16`` at bfloat16 storage, with the rounding
above): the form the serving lanes run on a one-panel bucket and on the
last panel of a wider one, where the JAX package vmaps
``panel_factor_pallas`` over a stack of buckets. Its plain version is
:func:`panel_factor_plain` per member.

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
#: The grid route's rule, as compiled into ``csrc/panel_grid.cuh``: the
#: most blocks (the H100's SMs), the rows a block aims to hold and the
#: most blocks the rule starts from (both measured on the H100,
#: ``PERF.md``), and the tallest strip a step record names.
PANEL_GRID_MAX = 132
PANEL_GRID_ROWS = 64
PANEL_GRID_START_MAX = 100
PANEL_GRID_H_MAX = 0xffffe
#: The storage dtypes the panel kernels take.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class PanelGeometry(NamedTuple):
    route: str           # "cluster" (csrc/panel_cluster.cu), "grid"
                         # (csrc/panel_grid.cu) or "block"
    cluster: int         # blocks in the cluster (1 off the cluster route)
    rows_per_block: int
    smem_bytes: int      # dynamic shared memory per block (0 for "block")
    blocks: int          # blocks that hold the strip: C, G or 1


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


def grid_size(h: int, panel: int, itemsize: int = 4) -> int:
    """The grid route's G for an (h, panel) strip of ``itemsize``-byte
    words, by the C launcher's rule (``gtt_grid_size``): from
    ``ceil(h / PANEL_GRID_ROWS)``, at most ``PANEL_GRID_START_MAX``, up to the
    first G whose blocks' rows fit their shared memory (a cluster block's
    layout, :func:`cluster_smem_bytes`); 0 when none up to
    ``PANEL_GRID_MAX`` does, or the strip is taller than a step record
    names."""
    if not (1 <= panel <= PANEL_MAX and 1 <= h <= PANEL_GRID_H_MAX):
        return 0
    for g in range(min(PANEL_GRID_START_MAX, -(-h // PANEL_GRID_ROWS)),
                   PANEL_GRID_MAX + 1):
        if cluster_smem_bytes(-(-h // g), panel, itemsize) <= PANEL_SMEM_MAX:
            return g
    return 0


def panel_geometry(h: int, panel: int, itemsize: int = 4) -> PanelGeometry:
    """The kernel an (h, panel) strip of ``itemsize``-byte words takes on
    the card, by the C launchers' rule: a cluster of C blocks, C from
    ``ceil(h / PANEL_CLUSTER_ROWS)`` (at most ``PANEL_CLUSTER_MAX``) up to
    the first whose blocks' rows fit their shared memory; where no C up to
    ``PANEL_CLUSTER_MAX`` fits (at panel 256, above 3,392 rows at float32
    and above 6,848 at bfloat16), a grid of :func:`grid_size` blocks; the
    one-block kernel where neither does."""
    if 1 <= panel <= PANEL_MAX and h >= 1:
        first = min(PANEL_CLUSTER_MAX, max(1, -(-h // PANEL_CLUSTER_ROWS)))
        for c in range(first, PANEL_CLUSTER_MAX + 1):
            rows = -(-h // c)
            smem = cluster_smem_bytes(rows, panel, itemsize)
            if smem <= PANEL_SMEM_MAX:
                return PanelGeometry("cluster", c, rows, smem, c)
    g = grid_size(h, panel, itemsize)
    if g:
        rows = -(-h // g)
        return PanelGeometry("grid", 1, rows,
                             cluster_smem_bytes(rows, panel, itemsize), g)
    return PanelGeometry("block", 1, h, 0, 1)


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
    """Gather indices (int64) from the inverse-position vector, over its
    last axis (an (h,) vector or a (B, h) stack): unchosen rows at or below
    ``kb`` keep their original relative order after the ``panel`` chosen
    pivots."""
    h = inv.shape[-1]
    rows = torch.arange(h, device=inv.device).expand_as(inv)
    unch = (rows >= kb) & (chosen == 0)
    rank = torch.cumsum(unch.to(torch.int64), -1)
    full = torch.where(unch, kb + panel - 1 + rank, inv.to(torch.int64))
    return torch.empty_like(rows).scatter_(-1, full, rows)


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


def _panel_factor_cuda(p: torch.Tensor, kb: int, route: str,
                       blocks: int = 0):
    """Launch the panel-factor kernel of ``route``: the cluster kernel or
    the grid kernel at ``blocks`` blocks (0: the rule's size), or the
    one-block kernel."""
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
    name = {"cluster": "panel_factor_cluster", "grid": "panel_factor_grid",
            "block": "panel_factor"}[route] + sfx
    lib = _build.library({"cluster": "panel_cluster", "grid": "panel_grid",
                          "block": "panel_factor"}[route])
    if route == "grid":
        # The exchange: 2 x G step records (zeroed) and pivot-row slots; G
        # 0 lets the launcher take the rule's, which is grid_size's where
        # the rule gives the grid route (elsewhere the launcher refuses).
        g = blocks or grid_size(h, panel, p.element_size())
        rec = torch.zeros(2 * max(g, 1), dtype=torch.int64, device=dev)
        slot = torch.empty((2 * max(g, 1), panel), dtype=torch.float32,
                           device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "block":
            rc = getattr(lib, "gtt_panel_factor" + sfx)(*args, stream)
        elif route == "grid":
            rc = getattr(lib, "gtt_panel_factor_grid" + sfx)(
                *args, rec.data_ptr(), slot.data_ptr(), blocks, stream)
        elif blocks == 0:
            rc = getattr(lib, "gtt_panel_factor_cluster" + sfx)(*args,
                                                               stream)
        else:
            rc = getattr(lib, "gtt_panel_factor_cluster_at" + sfx)(
                *args, blocks, stream)
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    perm_local = perm_from_inv(inv, chosen, kb, panel)
    return pt.T[perm_local], ipiv, perm_local, minpiv[0]


def _check_panel_args(p: torch.Tensor, kb: int, what: str) -> None:
    if p.dim() != 2 or p.shape[0] - kb < p.shape[1] or kb < 0:
        raise ValueError(f"{what} expects (h, panel) with at least "
                         f"panel rows at or below kb={kb}, got "
                         f"{tuple(p.shape)}")


def _check_card(p: torch.Tensor, what: str) -> None:
    if p.device.type != "cuda":
        raise ValueError(f"{what}: the kernel needs a CUDA tensor, got one "
                         f"on {p.device}")


def panel_factor_cluster(p: torch.Tensor, kb: int = 0,
                         cluster: int | None = None):
    """:func:`panel_factor` through the cluster kernel at ``cluster``
    blocks (None: the rule's, even for a strip the rule sends to another
    route, which then raises). For measuring cluster sizes and for the
    tests; needs a CUDA tensor. A cluster that does not fit on the card
    raises RuntimeError."""
    _check_panel_args(p, kb, "panel_factor_cluster")
    _check_card(p, "panel_factor_cluster")
    return _panel_factor_cuda(p, kb, "cluster", int(cluster or 0))


def panel_factor_grid(p: torch.Tensor, kb: int = 0, grid: int | None = None):
    """:func:`panel_factor` through the grid kernel at ``grid`` blocks
    (None: the rule's G; a strip the rule sends to another route then
    raises). For measuring G and for the tests; needs a CUDA tensor. A G
    above 132, one the card cannot hold at once, or one whose blocks' rows
    do not fit their shared memory raises RuntimeError."""
    _check_panel_args(p, kb, "panel_factor_grid")
    _check_card(p, "panel_factor_grid")
    return _panel_factor_cuda(p, kb, "grid", int(grid or 0))


def panel_factor_one_block(p: torch.Tensor, kb: int = 0):
    """:func:`panel_factor` through the one-block kernel
    (``csrc/panel_factor.cu``) on any strip: the route the rule takes only
    beyond the grid's reach, kept reachable to time it beside the others.
    Needs a CUDA tensor."""
    _check_panel_args(p, kb, "panel_factor_one_block")
    _check_card(p, "panel_factor_one_block")
    return _panel_factor_cuda(p, kb, "block")


def panel_cluster_info(h: int, panel: int, cluster: int = 0,
                       itemsize: int = 4) -> dict:
    """What the C launcher reports for an (h, panel) strip of
    ``itemsize``-byte words (4: float32, 2: bfloat16) at ``cluster``
    blocks (0: its rule's): the cluster size (0 off the cluster route),
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


def panel_grid_info(h: int, panel: int, grid: int = 0,
                    itemsize: int = 4) -> dict:
    """What the grid kernel's C launcher reports for an (h, panel) strip of
    ``itemsize``-byte words at ``grid`` blocks (0: its rule's): G (0 when
    the rule sends the strip to another route), rows per block, dynamic
    shared memory bytes and the blocks the card holds at once at that
    shared memory (blocks an SM times SMs: the largest G a cooperative
    launch takes). Builds ``csrc/panel_grid.cu``; needs a CUDA device."""
    lib = _build.library("panel_grid")
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.gtt_panel_grid_info(h, panel, grid, itemsize, out),
                 "panel_grid_info")
    return {"grid": out[0], "rows_per_block": out[1], "smem_bytes": out[2],
            "max_resident_blocks": out[3]}


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
    (``csrc/panel_cluster.cu``, ``csrc/panel_grid.cu`` or
    ``csrc/panel_factor.cu``) or raises; a CPU tensor runs
    :func:`panel_factor_plain`. ``seg`` is accepted for parity with the
    JAX package and ignored."""
    del seg
    _check_panel_args(p, kb, "panel_factor")
    if p.device.type == "cpu":
        return panel_factor_plain(p, kb)
    if p.device.type != "cuda":
        raise ValueError(f"panel_factor: unsupported device {p.device}")
    geom = panel_geometry(*p.shape, p.element_size())
    return _panel_factor_cuda(p, kb, geom.route,
                              geom.blocks if geom.route == "grid" else 0)


class BatchedGeometry(NamedTuple):
    route: str     # "regs", "cluster" (the register loop), "smem" or
                   # "global" (the one-block loop)
    blocks: int    # blocks a member
    threads: int   # threads a block


#: The batched panel kernel's routes, by the C launcher's route codes.
BATCHED_ROUTES = ("global", "smem", "regs", "cluster")
BATCHED_SMEM_MAX = 227 * 1024 - 8 * 1024


def panel_batched_geometry(h: int, panel: int,
                           itemsize: int = 4) -> BatchedGeometry:
    """The step loop an (h, panel) member of ``itemsize``-byte words takes
    in the batched kernel: a mirror of the C launcher's rule
    (``gtt_batched_rule``, which alone decides a launch), for the tests and
    the plans of ``chip_smoke.py``. The register loop on one block of 512
    threads (``"regs"``) up to 128 rows and columns, on a cluster of 4
    blocks of 256 (``"cluster"``) up to 256; beyond, the one-block loop, in
    shared memory (``"smem"``) where the transposed member fits there, else
    in place in global memory (``"global"``)."""
    if not (1 <= panel <= PANEL_MAX and h >= 1):
        raise ValueError(f"no batched route for an ({h}, {panel}) member")
    if h <= 128 and panel <= 128:
        return BatchedGeometry("regs", 1, 512)
    if h <= 256 and panel <= 256:
        return BatchedGeometry("cluster", 4, 256)
    fits = panel * h * itemsize <= BATCHED_SMEM_MAX
    return BatchedGeometry("smem" if fits else "global", 1, 512)


def panel_batched_info(h: int, panel: int, itemsize: int = 4) -> dict:
    """What the batched kernel's C launcher does with an (h, panel) member
    of ``itemsize``-byte words (4: float32, 2: bfloat16): ``route`` (as
    :func:`panel_batched_geometry` names it), ``blocks`` a member,
    ``threads`` a block and the dynamic shared memory bytes a block.
    Builds ``csrc/panel_batched.cu``; needs a CUDA device."""
    lib = _build.library("panel_batched")
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.gtt_panel_batched_info(h, panel, itemsize, out),
                 "panel_batched_info")
    return {"route": BATCHED_ROUTES[out[0]], "blocks": out[1],
            "threads": out[2], "smem_bytes": out[3]}


def _check_batched_args(p: torch.Tensor, kb: int) -> None:
    if p.dim() != 3 or p.shape[0] < 1 or p.shape[1] - kb < p.shape[2] \
            or kb < 0:
        raise ValueError(f"panel_factor_batched expects (B, h, panel) with "
                         f"B >= 1 and at least panel rows at or below "
                         f"kb={kb}, got {tuple(p.shape)}")


def panel_factor_batched_plain(p: torch.Tensor, kb: int = 0):
    """The plain version of :func:`panel_factor_batched`:
    :func:`panel_factor_plain` on each member, stacked."""
    _check_batched_args(p, kb)
    outs = [panel_factor_plain(p[i], kb) for i in range(p.shape[0])]
    return tuple(torch.stack(list(f)) for f in zip(*outs))


def _panel_factor_batched_cuda(p: torch.Tensor, kb: int):
    if p.dtype not in KERNEL_DTYPES:
        raise TypeError(f"panel_factor_batched: the CUDA kernel takes "
                        f"float32 or bfloat16, got {p.dtype}")
    if p.stride(2) != 1:
        p = p.contiguous()
    bsz, h, panel = p.shape
    dev = p.device
    key = "panel_factor_batched" + launch_suffix(p.dtype)
    lib = _build.library("panel_batched")
    # The launcher's own rule names the route, and so the outputs to give
    # it; it refuses a launch whose route's outputs are missing.
    geo = (ctypes.c_int * 4)()
    _build.check(lib, lib.gtt_panel_batched_info(h, panel, p.element_size(),
                                                 geo), key)
    regs = BATCHED_ROUTES[geo[0]] in ("regs", "cluster")
    ipiv = torch.empty((bsz, panel), dtype=torch.int32, device=dev)
    minpiv = torch.empty(bsz, dtype=p.dtype, device=dev)
    if regs:  # the kernel writes the row-permuted panel and its indices
        out = torch.empty((bsz, h, panel), dtype=p.dtype, device=dev)
        perm = torch.empty((bsz, h), dtype=torch.int64, device=dev)
        ptrs = (0, ipiv.data_ptr(), 0, 0, minpiv.data_ptr(), out.data_ptr(),
                perm.data_ptr())
    else:  # the transposed panel and the inverse positions
        pt = torch.empty((bsz, panel, h), dtype=p.dtype, device=dev)
        inv = torch.empty((bsz, h), dtype=torch.int32, device=dev)
        chosen = torch.empty((bsz, h), dtype=torch.int32, device=dev)
        ptrs = (pt.data_ptr(), ipiv.data_ptr(), inv.data_ptr(),
                chosen.data_ptr(), minpiv.data_ptr(), 0, 0)
    taken = (ctypes.c_int * 1)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, "gtt_" + key)(
            p.data_ptr(), p.stride(0), p.stride(1), bsz, h, panel, int(kb),
            *ptrs, taken, stream)
    _build.check(lib, rc, key)
    _build.count_route(key, BATCHED_ROUTES[taken[0]])
    if not regs:
        perm = perm_from_inv(inv, chosen, kb, panel)
        out = torch.gather(pt.transpose(1, 2), 1,
                           perm[:, :, None].expand(bsz, h, panel))
    return out, ipiv, perm, minpiv


def panel_factor_batched(p: torch.Tensor, kb: int = 0):
    """Factor every member of a (B, h, panel) stack of column blocks whose
    diagonals sit at row ``kb``: :func:`panel_factor` per member, stacked.

    Returns ``(p_perm (B, h, panel), ipiv (B, panel), perm_local (B, h),
    min_abs_pivot (B,))``; ``p`` is not modified. A CUDA tensor launches
    ``csrc/panel_batched.cu`` once for the whole stack on the step loop its
    launcher's rule names (:func:`panel_batched_geometry` mirrors it;
    float32 or bfloat16, launch keys ``panel_factor_batched`` and
    ``panel_factor_batched_bf16``, and by the route taken in
    ``_build.ROUTE_LAUNCHES``) or raises; a CPU tensor runs
    :func:`panel_factor_batched_plain`."""
    _check_batched_args(p, kb)
    if p.device.type == "cpu":
        return panel_factor_batched_plain(p, kb)
    if p.device.type != "cuda":
        raise ValueError(f"panel_factor_batched: unsupported device "
                         f"{p.device}")
    return _panel_factor_batched_cuda(p, kb)

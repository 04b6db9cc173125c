"""Fused panel-factor + trailing-update, and the unfused pair's trailing leg.

Port of ``gauss_tpu/kernels/panel_fused_pallas.py``:

- :func:`panel_trailing_fused` (``panel_trailing_fused_pallas``): ONE
  launch factors the (h, panel) column block of ``block`` at ``col0`` and
  applies its eliminations to every column right of the panel. Pivot
  rows come out holding U12 and live rows A22 - L21 @ U12, in the block's
  ORIGINAL row order; columns at or left of ``col0 + panel`` are not
  written. CUDA kernel: ``csrc/panel_fused.cu``. Phase A (the factor)
  takes one of three routes (:func:`fused_geometry` states the rule):
  the first thread-block cluster that starts runs the cluster step loop
  of ``csrc/panel_cluster.cuh`` on every strip such a cluster holds; on
  taller strips the launch is cooperative and its first G blocks to start
  run the grid step loop of ``csrc/panel_grid.cuh``, each block's rows in
  its shared memory, each pivot step exchanged through L2; one block runs
  the one-block loop on strips beyond the grid's reach. Phase A derives
  the multiplier record by the rule of :func:`reconstruct_mult_pt`. Phase B
  (the trailing update) is split into jobs that every block of the grid
  takes by ticket: per 64-column chunk the pivot rows alone (B1, which
  writes each segment's U rows), then (256, 64) tiles of the whole block
  (B2), each after its chunk's B1.
- :func:`trailing_update` (``trailing_update_pallas``): the same trailing
  jobs as their own launch, from multipliers and pivots that
  :func:`reconstruct_mult_pt` rebuilds exactly (gathers and selects only)
  from a factored panel.
- :func:`panel_trailing_fused_batched` (``panel_trailing_fused_pallas``
  under ``jax.vmap``): kernel 2 on every member of a (B, h, w) stack in
  one launch (``csrc/panel_fused_batched.cu``), each member bit for bit
  kernel 2 on it alone — the panel step of the serving lane's batched
  blocked LU (``core.blocked.lu_factor_blocked_batched``). Its tall
  members keep the one-block phase A at every B (an (8, 4096, 4096)
  stack's members cannot each take a group of G blocks at once). No batched
  form of :func:`trailing_update` exists: no serving route runs the
  unfused pair's trailing kernel.

The contract, as in the JAX package: fused == panel + reconstruct +
trailing, bit for bit, at matching ``fseg`` — on the card the kernels
share one step loop per route and one trailing routine, on the CPU the
plain versions share their Python functions.

Trailing math per ``fseg``-wide segment of steps [s0, s1): U0 = the
segment's pivot rows; U = the forward substitution of U0 through the unit
lower coupling L[j, i] = mult[s0+i, p_j] (i < j) — the JAX package
inverts the same coupling by a factored Neumann series, equal up to
rounding; every row takes T - mult[s0:s1].T @ U (zero multipliers leave
done rows as they are); the pivot rows take U.

At bfloat16 storage, the JAX kernel's precision contract
(``panel_fused_pallas.py``'s ``_trailing_tile_update``): per segment, U0
and the coupling are taken in float32 and U stays float32 through the
forward substitution; U is rounded to bfloat16 (``ulow``) before it is
applied; every row takes ``T - M^T @ ulow`` in float32, rounded ONCE to
bfloat16 on store; the pivot rows take ``ulow``. Phase A is the panel
kernel's bfloat16 step loop (:mod:`.panel`). The CUDA kernels keep the
multiplier record and the U rows in float32 (exact for bfloat16 values)
and count their launches under ``panel_trailing_fused_bf16`` and
``trailing_update_bf16``. The float32 path is unchanged.

``ct`` (the trailing tile width) is accepted for API parity and changes
no value: every output column depends on its own column alone, so the
card's 64-column chunks give the same bits at any ``ct``. ``seg`` is
ignored (see :mod:`.panel`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gauss_tpu_torch.kernels import _build
from gauss_tpu_torch.kernels.panel import (DEFAULT_SEG, PANEL_MAX,
                                           accum_dtype, check_cuda_storage,
                                           cluster_smem_bytes,
                                           factor_steps_plain, launch_suffix,
                                           panel_geometry, perm_from_inv)

#: Phase A's routes by the C launcher's code (``GTT_ROUTE_*``).
ROUTES = ("block", "cluster", "grid")

#: The JAX package's tuner seeds for the fused kernel's trailing tile width
#: and trailing-apply segment width.
FUSED_CT_SEED = 256
FUSED_FSEG_SEED = 32
#: Widest fseg the CUDA tile routine stages (csrc GTT_FSEG_MAX).
FSEG_MAX_CUDA = 64
#: The trailing jobs' shape, as compiled into ``csrc/panel_fused.cu``: rows
#: of a B2 tile (and of a B1 pivot-row pass) and columns of a chunk.
TRAIL_TILE_ROWS = 256
TRAIL_CHUNK_COLS = 64
#: The grid rule's card facts, as measured on the H100 SXM (the C launcher
#: reads the card's own): its SMs, and the clusters of 16 blocks of 512
#: threads at one block an SM that it holds at once
#: (``cudaOccupancyMaxActiveClusters``).
H100_SMS = 132
H100_CLUSTERS_OF_16 = 7


class FusedGeometry(NamedTuple):
    route: str           # phase A: "cluster" (the cluster step loop),
                         # "grid" (the grid step loop) or "block" (the
                         # one-block loop)
    cluster: int         # blocks in a cluster (1 off the cluster route)
    rows_per_block: int  # strip rows a phase-A block holds
    grid: int            # blocks launched
    smem_bytes: int      # dynamic shared memory per block
    chunks: int          # 64-column chunks right of the panel (B1 jobs)
    row_tiles: int       # 256-row tiles of the block (B2 jobs per chunk)
    group: int           # phase A's blocks: C, G or 1


def trailing_smem_bytes(panel: int, fseg: int) -> int:
    """Dynamic shared memory of the trailing jobs: a ticket, the pivot rows
    and a tile's row steps (padded to 4 words), then two stages of
    (fseg, 256) multipliers and (fseg, 64) U rows."""
    head = (4 + panel + TRAIL_TILE_ROWS + 3) // 4 * 4
    return 4 * (head + 2 * fseg * (TRAIL_TILE_ROWS + TRAIL_CHUNK_COLS))


def fused_geometry(h: int, wtot: int, panel: int, col0: int = 0,
                   fseg: int = FUSED_FSEG_SEED, sms: int = H100_SMS,
                   clusters: int | None = None,
                   itemsize: int = 4) -> FusedGeometry:
    """The launch of :func:`panel_trailing_fused` on an (h, wtot) block of
    ``itemsize``-byte words with the panel at ``col0``, by the C
    launcher's rule. Phase A takes the route
    :func:`~gauss_tpu_torch.kernels.panel.panel_geometry` gives the strip:
    the cluster route (at panel 256 up to 3,392 rows at float32 and 6,848
    at bfloat16, C = 16 from 256 rows on), the grid route on a group of G
    blocks above that (G = ``panel_geometry(...).blocks``), else the
    one-block route. Jobs: ``chunks`` B1 jobs plus ``chunks * row_tiles``
    B2 tiles. Grid: on the cluster route ``C * min(1 + ceil(jobs / C),
    clusters)`` (phase A's cluster, then a block per job, no more clusters
    than the card holds at once: ``clusters``, by default the H100's 7 for
    C = 16 and ``sms // C`` otherwise), on the grid route ``min(G + jobs,
    sms)``, on the one-block route ``min(1 + jobs, sms)``. Dynamic shared
    memory: the larger of phase A's strip and the trailing jobs'
    (:func:`trailing_smem_bytes`)."""
    if (h < 1 or not 1 <= panel <= PANEL_MAX or col0 < 0
            or col0 + panel > wtot):
        raise ValueError(f"fused_geometry: no launch for h={h}, wtot={wtot}, "
                         f"panel={panel}, col0={col0}")
    if not 1 <= fseg <= FSEG_MAX_CUDA:
        raise ValueError(f"fused_geometry: fseg {fseg} outside [1, "
                         f"{FSEG_MAX_CUDA}]")
    chunks = -(-(wtot - col0 - panel) // TRAIL_CHUNK_COLS)
    row_tiles = -(-h // TRAIL_TILE_ROWS)
    jobs = chunks * (1 + row_tiles)
    trail = trailing_smem_bytes(panel, fseg)
    strip = panel_geometry(h, panel, itemsize)
    if strip.route == "cluster":
        c = strip.cluster
        if clusters is None:
            clusters = H100_CLUSTERS_OF_16 if c == 16 else max(1, sms // c)
        grid = c * min(1 + -(-jobs // c), clusters)
    elif strip.route == "grid":
        grid = min(strip.blocks + jobs, sms)
    else:
        return FusedGeometry("block", 1, h, min(1 + jobs, sms), trail,
                             chunks, row_tiles, 1)
    return FusedGeometry(strip.route, strip.cluster, strip.rows_per_block,
                         grid, max(strip.smem_bytes, trail), chunks,
                         row_tiles, strip.blocks)


def fused_launch_info(h: int, wtot: int, panel: int, col0: int = 0,
                      fseg: int = FUSED_FSEG_SEED, itemsize: int = 4) -> dict:
    """What the C launcher reports for a fused call on a block of
    ``itemsize``-byte words (4: float32, 2: bfloat16): its geometry (the
    fields of :class:`FusedGeometry`) and ``fit``, the clusters the card
    holds at once on the cluster route, or the blocks an SM holds on the
    others. Builds ``csrc/panel_fused.cu``; needs a CUDA device."""
    lib = _build.library("panel_fused")
    out = (ctypes.c_int * 9)()
    _build.check(lib, lib.gtt_panel_fused_info(h, wtot, col0, panel, fseg,
                                               itemsize, out),
                 "fused_launch_info")
    return _info_dict(out)


def _info_dict(out) -> dict:
    """The C launcher's nine launch facts (``gtt_fused_info``) by name."""
    return {"cluster": out[0] or 1, "rows_per_block": out[1],
            "grid": out[2], "smem_bytes": out[3], "chunks": out[4],
            "row_tiles": out[5], "fit": out[6], "group": out[7],
            "route": ROUTES[out[8]]}


def resolve_tiles(h: int, wtot: int, panel: int, ct=None, seg=None,
                  fseg=None):
    """``(ct, seg, fseg)`` as the JAX package resolves them without a tuned
    store: seeds for None, ``ct`` clamped to a panel multiple dividing the
    block width, ``seg``/``fseg`` clamped to [1, panel]."""
    del h
    ct = FUSED_CT_SEED if ct is None else int(ct)
    seg = DEFAULT_SEG if seg is None else int(seg)
    fseg = FUSED_FSEG_SEED if fseg is None else int(fseg)
    ct = max(panel, (min(ct, wtot) // panel) * panel)
    if wtot % ct:
        ct = panel
    return ct, min(max(1, seg), panel), min(max(1, fseg), panel)


def trailing_update_plain(block: torch.Tensor, mult: torch.Tensor,
                          ipiv: torch.Tensor, col0: int,
                          fseg: int) -> torch.Tensor:
    """The plain PyTorch trailing leg; updates ``block`` IN PLACE right of
    ``col0 + panel`` (panel = ``mult.shape[0]``) and returns it. A
    bfloat16 block takes the precision contract (module docstring)."""
    panel = mult.shape[0]
    c1 = col0 + panel
    if c1 >= block.shape[1]:
        return block
    trail = block[:, c1:]
    piv_all = ipiv.to(torch.int64)
    acc = accum_dtype(block.dtype)
    for s0 in range(0, panel, fseg):
        s1 = min(s0 + fseg, panel)
        piv = piv_all[s0:s1]
        m = mult[s0:s1].to(acc)                 # (w, h)
        u = trail.index_select(0, piv).to(acc)  # U0 (w, nc)
        lc = m.index_select(1, piv)             # lc[i, j] = mult[s0+i, p_j]
        for j in range(1, s1 - s0):
            u[j] -= lc[:j, j] @ u[:j]
        ulow = u.to(block.dtype)
        trail.copy_(trail.to(acc) - m.T @ ulow.to(acc))
        trail.index_copy_(0, piv, ulow)
    return block


def panel_trailing_fused_plain(block: torch.Tensor, col0: int, kbrow: int,
                               *, panel: int, fseg: int = FUSED_FSEG_SEED):
    """The plain PyTorch version of :func:`panel_trailing_fused` (same
    return value; ``block`` updated in place)."""
    t = block[:, col0:col0 + panel].T
    t, ipiv, inv, chosen, minpiv, mult = factor_steps_plain(t, kbrow,
                                                            record=True)
    perm_local = perm_from_inv(inv, chosen, kbrow, panel)
    trailing_update_plain(block, mult, ipiv, col0, fseg)
    return t.T[perm_local], ipiv, perm_local, minpiv, block


def _trailing_scratch(panel: int, chunks: int, dev, group: int = 0):
    """The trailing jobs' scratch: each chunk's U rows, and the counters
    (job tickets, phase A's arrivals, one flag per chunk), zeroed; with
    ``group`` G > 0 (the grid route) also the exchange of the grid step
    loop: 2 x G step records, zeroed in the counters' buffer after them
    (8-byte aligned), and 2 x G pivot-row slots."""
    u = torch.empty((panel, chunks * TRAIL_CHUNK_COLS), dtype=torch.float32,
                    device=dev)
    head = 3 + chunks + (3 + chunks) % 2
    ctr = torch.zeros(head + 4 * group, dtype=torch.int32, device=dev)
    if not group:
        return u, ctr, None, None
    slot = torch.empty((2 * group, panel), dtype=torch.float32, device=dev)
    return u, ctr, ctr[head:], slot


def _fused_cuda(block, col0: int, kbrow: int, panel: int, fseg: int):
    check_cuda_storage(block, "panel_trailing_fused")
    if fseg > FSEG_MAX_CUDA:
        raise ValueError(f"panel_trailing_fused: fseg {fseg} exceeds the "
                         f"CUDA tile routine's {FSEG_MAX_CUDA}")
    h, wtot = block.shape
    dev = block.device
    sfx = launch_suffix(block.dtype)
    geom = fused_geometry(h, wtot, panel, col0, fseg,
                          itemsize=block.element_size())
    pt = torch.empty((panel, h), dtype=block.dtype, device=dev)
    # The multiplier record is float32 at either storage (exact for
    # bfloat16 values).
    mult = torch.empty((panel, h), dtype=torch.float32, device=dev)
    ipiv = torch.empty(panel, dtype=torch.int32, device=dev)
    inv = torch.empty(h, dtype=torch.int32, device=dev)
    chosen = torch.empty(h, dtype=torch.int32, device=dev)
    minpiv = torch.empty(1, dtype=block.dtype, device=dev)
    grid_route = geom.route == "grid"
    u, ctr, rec, slot = _trailing_scratch(panel, geom.chunks, dev,
                                          geom.group if grid_route else 0)
    lib = _build.library("panel_fused")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, "gtt_panel_fused" + sfx)(
            block.data_ptr(), block.stride(0), h, wtot, col0, kbrow, panel,
            fseg, pt.data_ptr(), mult.data_ptr(), ipiv.data_ptr(),
            inv.data_ptr(), chosen.data_ptr(), minpiv.data_ptr(),
            u.data_ptr(), ctr.data_ptr(),
            rec.data_ptr() if grid_route else None,
            slot.data_ptr() if grid_route else None, stream)
    _build.check(lib, rc, "panel_trailing_fused" + sfx)
    _build.LAUNCHES["panel_trailing_fused" + sfx] += 1
    perm_local = perm_from_inv(inv, chosen, kbrow, panel)
    return pt.T[perm_local], ipiv, perm_local, minpiv[0], block


def panel_trailing_fused(block: torch.Tensor, col0: int, kbrow: int, *,
                         panel: int, ct: int | None = None,
                         seg: int | None = None, fseg: int | None = None):
    """Factor the (h, panel) column block of ``block`` at column ``col0``
    (diagonal at row ``kbrow``) AND apply its eliminations to every column
    right of it, in one launch.

    Returns ``(p, ipiv, perm_local, min_abs_pivot, block_upd)``: the
    factored panel row-permuted (getrf layout), the pivot rows per step
    (int32), the permutation as int64 gather indices, min |pivot|, and the
    updated block in ORIGINAL row order (apply ``perm_local`` as one
    gather, then install ``p``). ``block`` is updated IN PLACE (as the JAX
    kernel aliases its operand) and ``block_upd`` is that same tensor;
    columns at or left of ``col0 + panel`` are not written.

    ``block`` is float32 or bfloat16 (module docstring). A CUDA tensor
    launches the kernel or raises; a CPU tensor runs the plain version."""
    if block.dim() != 2:
        raise ValueError(f"expected a 2-D block, got {tuple(block.shape)}")
    h, wtot = block.shape
    if panel > wtot or col0 < 0 or col0 + panel > wtot:
        raise ValueError(f"panel ({panel}) at column {col0} exceeds the "
                         f"block width ({wtot})")
    if kbrow < 0 or h - kbrow < panel:
        raise ValueError(f"need at least panel ({panel}) rows at or below "
                         f"kbrow={kbrow}, block has {h}")
    _, _, fseg = resolve_tiles(h, wtot, panel, ct, seg, fseg)
    col0, kbrow = int(col0), int(kbrow)
    if block.device.type == "cpu":
        return panel_trailing_fused_plain(block, col0, kbrow, panel=panel,
                                          fseg=fseg)
    if block.device.type != "cuda":
        raise ValueError(f"unsupported device {block.device}")
    return _fused_cuda(block, col0, kbrow, panel, fseg)


def reconstruct_mult_pt(p_perm: torch.Tensor, ipiv: torch.Tensor,
                        perm_local: torch.Tensor, kbrow: int, panel: int):
    """The (panel, h) multiplier rows and pivot one-hots of a factored
    panel, rebuilt EXACTLY (gathers, comparisons and selects only) from
    :func:`gauss_tpu_torch.kernels.panel.panel_factor` outputs: row r's
    stored value in column j is the step-j multiplier exactly when r was
    still live there (``inv[r] > kbrow + j``), and 0 otherwise."""
    h = p_perm.shape[0]
    dev = p_perm.device
    rows = torch.arange(h, device=dev)
    perm = perm_local.to(torch.int64)
    inv = torch.empty_like(rows).scatter_(0, perm, rows)
    p_raw = p_perm[inv]
    steps = int(kbrow) + torch.arange(panel, device=dev)
    live = inv[None, :] > steps[:, None]
    mult = torch.where(live, p_raw.T, torch.zeros((), dtype=p_perm.dtype,
                                                  device=dev))
    pt = (ipiv.to(torch.int64)[:, None] == rows[None, :]).to(p_perm.dtype)
    return mult.contiguous(), pt


def trailing_update(block: torch.Tensor, mult: torch.Tensor,
                    ipiv_or_pt: torch.Tensor, col0: int, *,
                    ct: int | None = None,
                    fseg: int | None = None) -> torch.Tensor:
    """Apply recorded eliminations — ``mult`` (panel, h) and the pivots as
    int ``ipiv`` (panel,) or the (panel, h) one-hots of
    :func:`reconstruct_mult_pt` — to every column of ``block`` right of
    ``col0 + panel``, IN PLACE; returns ``block``. The same tile math as
    the fused kernel's trailing phase.

    A CUDA tensor launches ``csrc/panel_fused.cu``'s trailing kernel, the
    fused kernel's phase B on its own (no launch when nothing lies right of
    the panel), or raises; a CPU tensor runs :func:`trailing_update_plain`."""
    panel = mult.shape[0]
    h, wtot = block.shape
    if col0 < 0 or col0 + panel > wtot:
        raise ValueError(f"panel ({panel}) at column {col0} exceeds the "
                         f"block width ({wtot})")
    ipiv = (ipiv_or_pt.argmax(dim=1) if ipiv_or_pt.dim() == 2
            else ipiv_or_pt)
    if mult.shape != (panel, h) or ipiv.shape != (panel,):
        raise ValueError(f"expected mult ({panel}, {h}) and {panel} pivots "
                         f"for a block of {h} rows, got mult "
                         f"{tuple(mult.shape)} and pivots "
                         f"{tuple(ipiv.shape)}")
    if mult.device != block.device or ipiv.device != block.device:
        raise ValueError(f"mult ({mult.device}) and pivots ({ipiv.device}) "
                         f"must lie on the block's device ({block.device})")
    _, _, fseg = resolve_tiles(h, wtot, panel, ct, 1, fseg)
    col0 = int(col0)
    if block.device.type == "cpu":
        return trailing_update_plain(block, mult, ipiv, col0, fseg)
    if block.device.type != "cuda":
        raise ValueError(f"unsupported device {block.device}")
    check_cuda_storage(block, "trailing_update")
    if fseg > FSEG_MAX_CUDA:
        raise ValueError(f"trailing_update: fseg {fseg} exceeds the CUDA "
                         f"tile routine's {FSEG_MAX_CUDA}")
    if col0 + panel >= wtot:
        return block
    sfx = launch_suffix(block.dtype)
    mult = mult.to(torch.float32).contiguous()
    ipiv = ipiv.to(torch.int32).contiguous()
    u, ctr, _, _ = _trailing_scratch(
        panel, fused_geometry(h, wtot, panel, col0, fseg).chunks,
        block.device)
    lib = _build.library("panel_fused")
    with torch.cuda.device(block.device):
        stream = torch.cuda.current_stream(block.device).cuda_stream
        rc = getattr(lib, "gtt_trailing_update" + sfx)(
            block.data_ptr(), block.stride(0), h, wtot, col0, panel, fseg,
            mult.data_ptr(), ipiv.data_ptr(), u.data_ptr(), ctr.data_ptr(),
            stream)
    _build.check(lib, rc, "trailing_update" + sfx)
    _build.LAUNCHES["trailing_update" + sfx] += 1
    return block


# --- the batched form ---------------------------------------------------------

def _check_batched_block(stack: torch.Tensor, col0: int, kbrow: int,
                         panel: int) -> None:
    if stack.dim() != 3 or stack.shape[0] < 1:
        raise ValueError(f"panel_trailing_fused_batched expects a (B, h, "
                         f"w) stack with B >= 1, got {tuple(stack.shape)}")
    _, h, wtot = stack.shape
    if panel > wtot or col0 < 0 or col0 + panel > wtot:
        raise ValueError(f"panel ({panel}) at column {col0} exceeds the "
                         f"block width ({wtot})")
    if kbrow < 0 or h - kbrow < panel:
        raise ValueError(f"need at least panel ({panel}) rows at or below "
                         f"kbrow={kbrow}, block has {h}")


def panel_trailing_fused_batched_plain(stack: torch.Tensor, col0: int,
                                       kbrow: int, *, panel: int,
                                       fseg: int = FUSED_FSEG_SEED):
    """The plain version of :func:`panel_trailing_fused_batched`:
    :func:`panel_trailing_fused_plain` on each member (each updated in
    place), the outputs stacked."""
    _check_batched_block(stack, col0, kbrow, panel)
    outs = [panel_trailing_fused_plain(stack[i], col0, kbrow, panel=panel,
                                       fseg=fseg)[:4]
            for i in range(stack.shape[0])]
    return (*(torch.stack(list(f)) for f in zip(*outs)), stack)


def fused_batched_launch_info(batch: int, h: int, wtot: int, panel: int,
                              col0: int = 0, fseg: int = FUSED_FSEG_SEED,
                              itemsize: int = 4) -> dict:
    """What the batched kernel's C launcher reports for a ``(batch, h,
    wtot)`` stack, in :func:`fused_launch_info`'s fields: phase A's route
    per member (kernel 2's cluster route by the strip's height and
    ``itemsize``, else the one-block route: the batched launch has no grid
    route), the grid over the whole stack and ``fit``. Builds
    ``csrc/panel_fused_batched.cu``; needs a CUDA device."""
    lib = _build.library("panel_fused_batched")
    out = (ctypes.c_int * 9)()
    _build.check(lib, lib.gtt_panel_fused_batched_info(
        batch, h, wtot, col0, panel, fseg, itemsize, out),
        "fused_batched_launch_info")
    return _info_dict(out)


def _fused_batched_cuda(stack, col0: int, kbrow: int, panel: int,
                        fseg: int):
    if stack.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"panel_trailing_fused_batched: the CUDA kernel "
                        f"takes float32 or bfloat16, got {stack.dtype}")
    if stack.stride(2) != 1:
        raise ValueError(f"panel_trailing_fused_batched: the stack is "
                         f"updated in place and needs unit column stride, "
                         f"got strides {stack.stride()}")
    if fseg > FSEG_MAX_CUDA:
        raise ValueError(f"panel_trailing_fused_batched: fseg {fseg} "
                         f"exceeds the CUDA tile routine's {FSEG_MAX_CUDA}")
    bsz, h, wtot = stack.shape
    dev = stack.device
    sfx = launch_suffix(stack.dtype)
    chunks = -(-(wtot - col0 - panel) // TRAIL_CHUNK_COLS)
    pt = torch.empty((bsz, panel, h), dtype=stack.dtype, device=dev)
    mult = torch.empty((bsz, panel, h), dtype=torch.float32, device=dev)
    ipiv = torch.empty((bsz, panel), dtype=torch.int32, device=dev)
    inv = torch.empty((bsz, h), dtype=torch.int32, device=dev)
    chosen = torch.empty((bsz, h), dtype=torch.int32, device=dev)
    minpiv = torch.empty(bsz, dtype=stack.dtype, device=dev)
    u = torch.empty((bsz, panel, max(chunks, 1) * TRAIL_CHUNK_COLS),
                    dtype=torch.float32, device=dev)
    # Each member's counters (kernel 2's), then the stack's two tickets.
    ctr = torch.zeros(bsz * (3 + chunks) + 2, dtype=torch.int32, device=dev)
    lib = _build.library("panel_fused_batched")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, "gtt_panel_fused_batched" + sfx)(
            stack.data_ptr(), stack.stride(0), stack.stride(1), bsz, h, wtot,
            col0, kbrow, panel, fseg, pt.data_ptr(), mult.data_ptr(),
            ipiv.data_ptr(), inv.data_ptr(), chosen.data_ptr(),
            minpiv.data_ptr(), u.data_ptr(), ctr.data_ptr(),
            ctr[bsz * (3 + chunks):].data_ptr(), stream)
    _build.check(lib, rc, "panel_trailing_fused_batched" + sfx)
    _build.LAUNCHES["panel_trailing_fused_batched" + sfx] += 1
    perm = perm_from_inv(inv, chosen, kbrow, panel)
    p = torch.gather(pt.transpose(1, 2), 1,
                     perm[:, :, None].expand(bsz, h, panel))
    return p, ipiv, perm, minpiv, stack


def panel_trailing_fused_batched(stack: torch.Tensor, col0: int, kbrow: int,
                                 *, panel: int, ct: int | None = None,
                                 seg: int | None = None,
                                 fseg: int | None = None):
    """:func:`panel_trailing_fused` on every member of a ``(B, h, w)``
    stack — the JAX package's ``jax.vmap(panel_trailing_fused_pallas)`` —
    in ONE launch for the whole stack.

    Returns kernel 2's outputs with a leading batch axis: ``(p (B, h,
    panel), ipiv (B, panel), perm_local (B, h), min_abs_pivot (B,),
    stack)``; each member is updated IN PLACE as kernel 2 updates its
    block. ``stack`` may be a strided view (unit column stride; any row
    and member strides), float32 or bfloat16. A CUDA tensor launches
    ``csrc/panel_fused_batched.cu`` (launch keys
    ``panel_trailing_fused_batched`` and ``..._bf16``), whose every member
    is bit for bit kernel 2 on that member, or raises; a CPU tensor runs
    :func:`panel_trailing_fused_batched_plain`."""
    _check_batched_block(stack, col0, kbrow, panel)
    _, h, wtot = stack.shape
    _, _, fseg = resolve_tiles(h, wtot, panel, ct, seg, fseg)
    col0, kbrow = int(col0), int(kbrow)
    if stack.device.type == "cpu":
        return panel_trailing_fused_batched_plain(stack, col0, kbrow,
                                                  panel=panel, fseg=fseg)
    if stack.device.type != "cuda":
        raise ValueError(f"unsupported device {stack.device}")
    return _fused_batched_cuda(stack, col0, kbrow, panel, fseg)

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
  blocked LU (``core.blocked.lu_factor_blocked_batched``). Phase A takes
  the route the C launcher's rule gives the stack (mirrored by
  :func:`fused_batched_geometry` for the tests and the chip checks):
  clusters where one holds the strip and the card holds the stack's
  clusters at once, else K groups of G co-resident blocks that take the
  members in turn on the grid step loop (:func:`group_size`), else one
  block. Kernel 2 is the
  same launch at B = 1. No batched form of :func:`trailing_update` exists:
  no serving route runs the unfused pair's trailing kernel.
- :func:`panel_trailing_fused_one_block`: kernel 2's one-block route on a
  block or a stack, whatever the rule says, to time it beside the others;
  no main path calls it.

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
from gauss_tpu_torch.kernels.panel import (DEFAULT_SEG, PANEL_GRID_MAX,
                                           PANEL_MAX, PANEL_SMEM_MAX,
                                           accum_dtype,
                                           check_cuda_storage,
                                           cluster_smem_bytes,
                                           factor_steps_plain, grid_size,
                                           launch_suffix, panel_geometry,
                                           perm_from_inv)

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
    groups: int = 0      # the grid route's groups K (0 off it)


def trailing_smem_bytes(panel: int, fseg: int) -> int:
    """Dynamic shared memory of the trailing jobs: a ticket, the pivot rows
    and a tile's row steps (padded to 4 words), then two stages of
    (fseg, 256) multipliers and (fseg, 64) U rows."""
    head = (4 + panel + TRAIL_TILE_ROWS + 3) // 4 * 4
    return 4 * (head + 2 * fseg * (TRAIL_TILE_ROWS + TRAIL_CHUNK_COLS))


def group_size(batch: int, h: int, panel: int, itemsize: int = 4,
               sms: int = H100_SMS) -> tuple[int, int]:
    """The grid route's ``(K, G)`` for ``batch`` members of (h, panel)
    strips of ``itemsize``-byte words on a card of ``sms`` SMs, by the C
    launcher's rule (``gtt_group_size``): as many groups as the card holds
    of the smallest G whose blocks' rows fit their shared memory, at most
    one a member (``K = min(batch, sms // G)``), then the widest G that K
    groups leave (``sms // K``), at most the single strip's G
    (:func:`~gauss_tpu_torch.kernels.panel.grid_size`, about 64 rows a
    block), so one call takes kernel 2's G. Where the members take more
    than one round, the groups the last round leaves idle take the first
    members' trailing jobs (measured on the H100: ``PERF.md``,
    ``scripts/probe_batched.py``). ``(0, 0)`` where no group holds the
    strip."""
    g1 = grid_size(h, panel, itemsize)
    if not g1 or batch < 1:
        return 0, 0
    gmin = 1
    while cluster_smem_bytes(-(-h // gmin), panel, itemsize) > PANEL_SMEM_MAX:
        gmin += 1
    if gmin > sms:
        return 0, 0
    k = min(batch, sms // gmin)
    return k, min(sms // k, g1)


def fused_batched_geometry(batch: int, h: int, wtot: int, panel: int,
                           col0: int = 0, fseg: int = FUSED_FSEG_SEED,
                           sms: int = H100_SMS, clusters: int | None = None,
                           itemsize: int = 4) -> FusedGeometry:
    """The launch of :func:`panel_trailing_fused_batched` on a ``(batch, h,
    wtot)`` stack of ``itemsize``-byte words with the panel at ``col0``, by
    the C launcher's rule (``gtt_fused_plan``). Phase A:

    - the cluster route where a cluster holds the strip
      (:func:`~gauss_tpu_torch.kernels.panel.panel_geometry`: at panel 256
      up to 3,392 rows at float32 and 6,848 at bfloat16) and ``batch`` is
      at most ``clusters``, the clusters the card holds at once (by default
      the H100's 7 for C = 16, ``sms // C`` otherwise): one wave;
    - else the grid route where a group holds it: ``groups`` K groups of
      ``group`` G blocks (:func:`group_size`), group k taking members k,
      k + K, ... in turn;
    - else the cluster route where a cluster holds it, else one block.

    Jobs: ``batch * chunks * (1 + row_tiles)``. Grid: ``C * min(batch +
    ceil(jobs / C), clusters)`` on the cluster route, ``min(K * G + jobs,
    sms)`` on the grid route, ``min(batch + jobs, sms)`` on the one-block
    route. Dynamic shared memory: the larger of phase A's strip and the
    trailing jobs' (:func:`trailing_smem_bytes`). At ``batch`` 1 this is
    kernel 2's launch (:func:`fused_geometry`)."""
    if (batch < 1 or h < 1 or not 1 <= panel <= PANEL_MAX or col0 < 0
            or col0 + panel > wtot):
        raise ValueError(f"fused_batched_geometry: no launch for batch="
                         f"{batch}, h={h}, wtot={wtot}, panel={panel}, "
                         f"col0={col0}")
    if not 1 <= fseg <= FSEG_MAX_CUDA:
        raise ValueError(f"fused_batched_geometry: fseg {fseg} outside [1, "
                         f"{FSEG_MAX_CUDA}]")
    chunks = -(-(wtot - col0 - panel) // TRAIL_CHUNK_COLS)
    row_tiles = -(-h // TRAIL_TILE_ROWS)
    jobs = batch * chunks * (1 + row_tiles)
    trail = trailing_smem_bytes(panel, fseg)
    strip = panel_geometry(h, panel, itemsize)
    k, g = group_size(batch, h, panel, itemsize, sms)
    if strip.route == "cluster":
        c = strip.cluster
        if clusters is None:
            clusters = H100_CLUSTERS_OF_16 if c == 16 else max(1, sms // c)
        if not g or batch <= clusters:
            return FusedGeometry("cluster", c, strip.rows_per_block,
                                 c * min(batch + -(-jobs // c), clusters),
                                 max(strip.smem_bytes, trail), chunks,
                                 row_tiles, c)
    if g:
        rows = -(-h // g)
        return FusedGeometry("grid", 1, rows, min(k * g + jobs, sms),
                             max(cluster_smem_bytes(rows, panel, itemsize),
                                 trail), chunks, row_tiles, g, k)
    return FusedGeometry("block", 1, h, min(batch + jobs, sms), trail,
                         chunks, row_tiles, 1)


def fused_geometry(h: int, wtot: int, panel: int, col0: int = 0,
                   fseg: int = FUSED_FSEG_SEED, sms: int = H100_SMS,
                   clusters: int | None = None,
                   itemsize: int = 4) -> FusedGeometry:
    """The launch of :func:`panel_trailing_fused` on an (h, wtot) block of
    ``itemsize``-byte words with the panel at ``col0``: the batched launch's
    rule at one member (:func:`fused_batched_geometry`). Phase A takes the
    route :func:`~gauss_tpu_torch.kernels.panel.panel_geometry` gives the
    strip: the cluster route (C = 16 from 256 rows on), the grid route on
    one group of G = ``panel_geometry(...).blocks`` blocks above that (K =
    1), else the one-block route. Grid: ``C * min(1 + ceil(jobs / C),
    clusters)``, ``min(G + jobs, sms)`` or ``min(1 + jobs, sms)``."""
    return fused_batched_geometry(1, h, wtot, panel, col0, fseg, sms,
                                  clusters, itemsize)


def fused_launch_info(h: int, wtot: int, panel: int, col0: int = 0,
                      fseg: int = FUSED_FSEG_SEED, itemsize: int = 4) -> dict:
    """What the C launcher reports for a fused call on a block of
    ``itemsize``-byte words (4: float32, 2: bfloat16): its geometry (the
    fields of :class:`FusedGeometry`) and ``fit``, the clusters the card
    holds at once on the cluster route, or the blocks an SM holds on the
    others. Builds ``csrc/panel_fused.cu``; needs a CUDA device."""
    lib = _build.library("panel_fused")
    out = (ctypes.c_int * 10)()
    _build.check(lib, lib.gtt_panel_fused_info(h, wtot, col0, panel, fseg,
                                               itemsize, out),
                 "fused_launch_info")
    return _info_dict(out)


def _info_dict(out) -> dict:
    """The C launcher's ten launch facts (``gtt_fused_info``) by name."""
    return {"cluster": out[0] or 1, "rows_per_block": out[1],
            "grid": out[2], "smem_bytes": out[3], "chunks": out[4],
            "row_tiles": out[5], "fit": out[6], "group": out[7],
            "route": ROUTES[out[8]], "groups": out[9]}


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
    _build.count_route("panel_trailing_fused" + sfx, geom.route)
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
    wtot)`` stack by its rule, in :func:`fused_launch_info`'s fields: phase
    A's route, its blocks (``group``: C, G or 1) and the grid route's
    ``groups`` K, the grid over the whole stack and ``fit``. Builds
    ``csrc/panel_fused_batched.cu``; needs a CUDA device."""
    lib = _build.library("panel_fused_batched")
    out = (ctypes.c_int * 10)()
    _build.check(lib, lib.gtt_panel_fused_batched_info(
        batch, h, wtot, col0, panel, fseg, itemsize, out),
        "fused_batched_launch_info")
    return _info_dict(out)


def _batched_scratch(bsz: int, panel: int, chunks: int, dev):
    """The batched launch's scratch: each member's U rows; each member's
    counters (kernel 2's), then the stack's two tickets, zeroed; and each
    member's exchange of the grid step loop, room for any G the C launcher
    may take (up to ``PANEL_GRID_MAX``; members lie 2 x G apart): 2 x G
    step records, zeroed in the counters' buffer after the tickets (8-byte
    aligned), and 2 x G pivot-row slots. Returns ``(u, ctr, gctr, rec,
    slot)``."""
    u = torch.empty((bsz, panel, max(chunks, 1) * TRAIL_CHUNK_COLS),
                    dtype=torch.float32, device=dev)
    gctr0 = bsz * (3 + chunks)
    head = gctr0 + 2 + gctr0 % 2
    ctr = torch.zeros(head + 4 * PANEL_GRID_MAX * bsz, dtype=torch.int32,
                      device=dev)
    slot = torch.empty((bsz, 2 * PANEL_GRID_MAX, panel), dtype=torch.float32,
                       device=dev)
    return u, ctr, ctr[gctr0:], ctr[head:], slot


def _fused_batched_cuda(stack, col0: int, kbrow: int, panel: int, fseg: int,
                        route: str | None = None, groups: int = 0,
                        group: int = 0):
    """Launch the batched kernel on ``route`` (None: the C launcher's rule,
    which :func:`fused_batched_geometry` mirrors; on the grid route
    ``groups`` K and ``group`` G, 0 for the rule's). The launcher takes a
    given geometry as given and refuses one the card cannot run. Counts
    the launch under its key in ``_build.LAUNCHES`` and under
    ``<key>/<route>``, the route the launcher reports it took, in
    ``_build.ROUTE_LAUNCHES``."""
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
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; routes: {ROUTES}")
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
    u, ctr, gctr, rec, slot = _batched_scratch(bsz, panel, chunks, dev)
    taken = (ctypes.c_int * 3)()
    lib = _build.library("panel_fused_batched")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, "gtt_panel_fused_batched" + sfx)(
            stack.data_ptr(), stack.stride(0), stack.stride(1), bsz, h, wtot,
            col0, kbrow, panel, fseg, pt.data_ptr(), mult.data_ptr(),
            ipiv.data_ptr(), inv.data_ptr(), chosen.data_ptr(),
            minpiv.data_ptr(), u.data_ptr(), ctr.data_ptr(),
            gctr.data_ptr(), rec.data_ptr(), slot.data_ptr(),
            -1 if route is None else ROUTES.index(route),
            groups if route == "grid" else 0,
            group if route == "grid" else 0, taken, stream)
    key = "panel_trailing_fused_batched" + sfx
    _build.check(lib, rc, key)
    _build.count_route(key, ROUTES[taken[0]])
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
    ``csrc/panel_fused_batched.cu`` on the route its C launcher's rule
    gives (:func:`fused_batched_geometry` states it in Python; launch keys
    ``panel_trailing_fused_batched`` and ``..._bf16``, and by the route
    taken in ``_build.ROUTE_LAUNCHES``), whose every member is bit for bit
    kernel 2 on that member, or raises (a route the card
    cannot run raises :class:`~gauss_tpu_torch.kernels._build.KernelLaunchError`;
    no other route is tried); a CPU tensor runs
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


def panel_trailing_fused_batched_at(stack: torch.Tensor, col0: int,
                                    kbrow: int, *, panel: int, route: str,
                                    groups: int = 0, group: int = 0,
                                    fseg: int | None = None):
    """:func:`panel_trailing_fused_batched` on phase-A route ``route``
    (``"cluster"``, ``"grid"`` or ``"block"``) whatever the rule says; on
    the grid route at ``groups`` K groups of ``group`` G blocks (0: the
    C launcher's rule's, as :func:`group_size`). For measuring routes and
    K and G, and for
    the tests; needs a CUDA tensor. A route that does not hold the strip,
    K above the batch, or K x G blocks the card cannot hold at once raise
    :class:`~gauss_tpu_torch.kernels._build.KernelLaunchError`."""
    _check_batched_block(stack, col0, kbrow, panel)
    if stack.device.type != "cuda":
        raise ValueError(f"panel_trailing_fused_batched_at: the kernel "
                         f"needs a CUDA tensor, got one on {stack.device}")
    _, h, wtot = stack.shape
    _, _, fseg = resolve_tiles(h, wtot, panel, None, None, fseg)
    return _fused_batched_cuda(stack, int(col0), int(kbrow), panel, fseg,
                               route, int(groups), int(group))


def panel_trailing_fused_one_block(block: torch.Tensor, col0: int,
                                   kbrow: int, *, panel: int,
                                   fseg: int | None = None):
    """Kernel 2 with phase A on the one-block loop, on an (h, w) block or
    on every member of a (B, h, w) stack in one launch, whatever the rule
    says: the route the rule takes only beyond the grid's reach (and that
    tall members of a batched launch took before the grid route), kept
    reachable to time it beside the others. Returns what
    :func:`panel_trailing_fused` (a block) or
    :func:`panel_trailing_fused_batched` (a stack) returns. A CUDA tensor
    launches the batched kernel on its one-block route (launch key
    ``panel_trailing_fused_batched[_bf16]``); a CPU tensor runs the plain
    version. No main path calls it."""
    if block.dim() == 2:
        out = panel_trailing_fused_one_block(block[None], col0, kbrow,
                                             panel=panel, fseg=fseg)
        return (*(f[0] for f in out[:4]), block)
    _check_batched_block(block, col0, kbrow, panel)
    if block.device.type == "cpu":
        _, h, wtot = block.shape
        _, _, fseg = resolve_tiles(h, wtot, panel, None, None, fseg)
        return panel_trailing_fused_batched_plain(block, int(col0),
                                                  int(kbrow), panel=panel,
                                                  fseg=fseg)
    return panel_trailing_fused_batched_at(block, col0, kbrow, panel=panel,
                                           route="block", fseg=fseg)

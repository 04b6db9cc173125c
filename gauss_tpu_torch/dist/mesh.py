"""Device meshes over the world of processes.

The counterpart of a ``jax.sharding.Mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names
(``rows``, ``cols``; ``batch`` for the lane meshes): its entries are the
ranks of the processes (one card, or one CPU process, each), and its
per-axis process groups carry the engines' collectives. Where the JAX
functions take a sequence of devices, these take a sequence of ranks.

Building a mesh is a collective over the whole world (each axis group is a
``new_group``), so every rank calls the same constructors in the same
order; a rank outside the mesh gets the mesh back all the same and sits
the mesh's collectives out (:func:`in_mesh`). Meshes are cached per world
by shape, axis names and ranks.

With no process group started, the constructors start a world of one on
``device`` (``cuda`` by default; ``cpu`` on request).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

ROWS_AXIS = "rows"
BATCH_AXIS = "batch"

_CACHE: dict = {}


def _world(device=None) -> int:
    import torch.distributed as dist

    from gauss_tpu_torch.dist import multihost

    multihost.ensure_world(device)
    return dist.get_world_size()


def _build(ranks: Sequence[int], shape: tuple, axes: tuple, device=None):
    """The (cached) DeviceMesh of ``ranks`` laid out row-major over
    ``shape`` with axis names ``axes``."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from gauss_tpu_torch.dist import multihost

    _world(device)
    key = (multihost.epoch(), tuple(ranks), tuple(shape), tuple(axes))
    mesh = _CACHE.get(key)
    if mesh is None:
        grid = torch.tensor(list(ranks), dtype=torch.int64).reshape(shape)
        mesh = DeviceMesh(multihost.device().type, grid,
                          mesh_dim_names=tuple(axes))
        if len(_CACHE) > 64:
            _CACHE.clear()
        _CACHE[key] = mesh
    return mesh


def _ranks(devices, device) -> list:
    world = _world(device)
    return list(devices) if devices is not None else list(range(world))


def make_mesh(n_shards: Optional[int] = None, axis: str = ROWS_AXIS,
              devices: Optional[Sequence[int]] = None, device=None):
    """A 1-D mesh over the first ``n_shards`` ranks (default: all).

    The reference pins its distributed size with ``mpirun -np N`` and a
    hostfile (OpenMP_and_MPI/README.txt:39-48); here the mesh is the
    cluster and the axis name is the address space collectives run over.
    """
    ranks = _ranks(devices, device)
    if n_shards is not None:
        if n_shards > len(ranks):
            raise ValueError(f"requested {n_shards} shards but only "
                             f"{len(ranks)} devices are visible")
        ranks = ranks[:n_shards]
    return _build(ranks, (len(ranks),), (axis,), device)


def make_mesh_2d(rows: int, cols: int, axes=("rows", "cols"),
                 devices: Optional[Sequence[int]] = None, device=None):
    """A rows x cols 2-D mesh (for the 2-D-sharded gauss / matmul variants)."""
    ranks = _ranks(devices, device)
    if rows * cols > len(ranks):
        raise ValueError(f"requested {rows}x{cols} mesh but only "
                         f"{len(ranks)} devices are visible")
    return _build(ranks[:rows * cols], (rows, cols), tuple(axes), device)


def squarest_factors(n: int) -> tuple[int, int]:
    """Factor n into the squarest (rows, cols) grid with rows >= cols."""
    cols = max(d for d in range(1, int(math.isqrt(n)) + 1) if n % d == 0)
    return n // cols, cols


def make_mesh_2d_auto(n_devices: Optional[int] = None,
                      devices: Optional[Sequence[int]] = None, device=None):
    """A 2-D mesh over n_devices (default: all ranks), squarest grid."""
    ranks = _ranks(devices, device)
    total = n_devices if n_devices is not None else len(ranks)
    rows, cols = squarest_factors(total)
    return make_mesh_2d(rows, cols, devices=ranks, device=device)


def lane_slices(devices: Optional[Sequence[int]] = None,
                width: int = 1) -> list:
    """Partition the ranks into contiguous ``width``-rank slices, one
    serving lane each; tail ranks that do not fill a whole slice are left
    unused rather than forming a ragged lane."""
    ranks = _ranks(devices, None) if devices is None else list(devices)
    width = max(1, int(width))
    if width > len(ranks):
        raise ValueError(f"lane width {width} exceeds the {len(ranks)} "
                         f"visible devices")
    return [tuple(ranks[i:i + width])
            for i in range(0, len(ranks) - width + 1, width)]


def lane_mesh(devices: Sequence[int], axis: str = BATCH_AXIS):
    """A 1-D mesh over one lane's rank slice, axis-named for batch
    sharding."""
    ranks = list(devices)
    return _build(ranks, (len(ranks),), (axis,))


# --- helpers the engines share --------------------------------------------

def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(axis_names(mesh).index(axis))


def in_mesh(mesh) -> bool:
    """Whether this rank is one of the mesh's."""
    return mesh.get_coordinate() is not None


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (the JAX ``lax.axis_index``)."""
    return mesh.get_coordinate()[axis_names(mesh).index(axis)]


def describe(mesh) -> dict:
    """A mesh as plain data: its shape, axis names, ranks (row-major) and
    this rank's coordinate (None outside it)."""
    coord = mesh.get_coordinate()
    return {"shape": tuple(mesh.shape), "axes": axis_names(mesh),
            "ranks": mesh.mesh.flatten().tolist(),
            "coord": None if coord is None else tuple(coord)}


def mesh_device(mesh):
    """The torch.device this rank computes on for ``mesh``."""
    from gauss_tpu_torch.dist import multihost

    return multihost.device()

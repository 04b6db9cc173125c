"""The one collective wrapper every distributed engine issues through.

Each function runs one ``torch.distributed`` collective over one axis
group of a DeviceMesh and counts it (:func:`gauss_tpu_torch.obs.collectives
.tally`) under the JAX primitive's kind name: :func:`psum` is an
all_reduce sum, :func:`pmin` an all_reduce min, :func:`all_gather` stacks
every member's tensor along a new leading axis in axis order (the JAX
``lax.all_gather`` layout). A member's input is never modified.

The group of a mesh of one rank still issues the collective (NCCL or gloo
on a group of one), so a world of one runs the same protocol as a world of
many.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gauss_tpu_torch.obs.collectives import tally


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _reduce(t: torch.Tensor, mesh, axis: str, op, kind: str) -> torch.Tensor:
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=mesh.get_group(axis))
    tally(kind, _nbytes(out))
    return out


def psum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over the members of ``axis`` (``lax.psum``)."""
    return _reduce(t, mesh, axis, dist.ReduceOp.SUM, "psum")


def pmin(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise minimum of ``t`` over ``axis`` (``lax.pmin``)."""
    return _reduce(t, mesh, axis, dist.ReduceOp.MIN, "pmin")


def all_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every member's ``t`` stacked along a new leading axis, in axis order
    (``lax.all_gather``): shape ``(size, *t.shape)``."""
    group = mesh.get_group(axis)
    t = t.contiguous()
    size = dist.get_world_size(group)
    if t.is_cuda:
        # NCCL gathers into one tensor, rank blocks in group order.
        out = torch.empty((size, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
    else:
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        out = torch.stack(parts)
    tally("all_gather", _nbytes(out))
    return out

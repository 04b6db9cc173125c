"""Meshfile: declarative device-mesh configuration (reference C10 analog).

The reference pins its distributed runs with an MPI hostfile naming six
cluster nodes plus ``mpirun -np N -hostfile hosts`` (reference
OpenMP_and_MPI/gauss_mpi/hosts:1-6, OpenMP_and_MPI/README.txt:39-48). The
port's equivalent of "which machines, how many ranks" is "which mesh axes,
how many ranks (one card each) per axis" — captured in a meshfile, the JAX
package's format::

    # comments and blank lines ignored
    axis rows 4
    axis cols 2

Axes are laid out over the ranks in declaration order (row-major).
A single axis gives a 1-D mesh; two axes give the 2-D meshes the 2-D-sharded
engines use. Device count must not exceed the visible pool, mirroring
mpirun's rank check.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def parse_meshfile(text: str) -> List[Tuple[str, int]]:
    axes: List[Tuple[str, int]] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) != 3 or parts[0] != "axis":
            raise ValueError(f"meshfile line {lineno}: expected 'axis NAME SIZE', "
                             f"got {raw.rstrip()!r}")
        name, size_s = parts[1], parts[2]
        try:
            size = int(size_s)
        except ValueError:
            raise ValueError(f"meshfile line {lineno}: size {size_s!r} is not an int")
        if size <= 0:
            raise ValueError(f"meshfile line {lineno}: axis size must be positive")
        if any(n == name for n, _ in axes):
            raise ValueError(f"meshfile line {lineno}: duplicate axis {name!r}")
        axes.append((name, size))
    if not axes:
        raise ValueError("meshfile defines no axes")
    return axes


def load_meshfile(path: os.PathLike, devices: Optional[Sequence[int]] = None,
                  device=None):
    """Build a DeviceMesh from a meshfile over the world's (or the given)
    ranks."""
    from gauss_tpu_torch.dist.mesh import _build, _ranks

    with open(path) as f:
        axes = parse_meshfile(f.read())
    ranks = _ranks(devices, device)
    total = int(np.prod([s for _, s in axes]))
    if total > len(ranks):
        raise ValueError(f"meshfile requests {total} devices "
                         f"({'x'.join(str(s) for _, s in axes)}) but only "
                         f"{len(ranks)} are visible")
    return _build(ranks[:total], tuple(s for _, s in axes),
                  tuple(n for n, _ in axes), device)

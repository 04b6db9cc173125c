"""Multi-card execution engines over a DeviceMesh (the port of
``gauss_tpu/dist``).

The reference's only distributed path is the MPI master–worker gauss
(reference OpenMP_and_MPI/gauss_mpi/gauss_internal_input.c:124-255): rank 0
owns the matrix and, per pivot step, broadcasts the pivot row and ships row
blocks out and back over the network. The port keeps the JAX package's
re-expression: the matrix lives sharded on the cards for the whole solve,
and the pivot row rides a psum (an all_reduce over NCCL on the cards, gloo
on the CPU) instead of MPI_Bcast + Isend/Irecv. Every engine is SPMD: one
process per card, each calling the same entry point with the same host
operands (:mod:`.multihost` joins them; :mod:`.launch` starts P local
ranks), every collective going through :mod:`.comm`.

Engines: :mod:`.gauss_dist` (row-cyclic, per pivot step),
:mod:`.gauss_dist2d` (2-D cyclic), :mod:`.gauss_dist_blocked` (panel-
blocked, kernel 1 on each panel strip), :mod:`.gauss_dist_blocked2d`
(2-D panel-blocked, tournament pivoting), :mod:`.matmul_dist`.
"""

from gauss_tpu_torch.dist.mesh import make_mesh, make_mesh_2d  # noqa: F401
from gauss_tpu_torch.dist.gauss_dist import (  # noqa: F401
    eliminate_dist, gauss_solve_dist)
from gauss_tpu_torch.dist.gauss_dist2d import gauss_solve_dist2d  # noqa: F401
from gauss_tpu_torch.dist.gauss_dist_blocked import (  # noqa: F401
    gauss_solve_dist_blocked, gauss_solve_dist_blocked_refined)
from gauss_tpu_torch.dist.gauss_dist_blocked2d import (  # noqa: F401
    gauss_solve_dist_blocked2d, gauss_solve_dist_blocked2d_refined)
from gauss_tpu_torch.dist.matmul_dist import matmul_dist  # noqa: F401

# The JAX package measured this crossover on its own hardware: the 2-D
# tournament engine's fixed per-step cost loses below it and its strip
# traffic, which shrinks with both mesh axes, wins at and above it. The
# port keeps the rule as it is; the crossover has not been measured on the
# card.
DIST_2D_CROSSOVER_N = 1024

__all__ = ["DIST_2D_CROSSOVER_N", "eliminate_dist", "gauss_solve_dist",
           "gauss_solve_dist2d", "gauss_solve_dist_blocked",
           "gauss_solve_dist_blocked2d", "gauss_solve_dist_blocked2d_refined",
           "gauss_solve_dist_blocked_refined", "make_mesh", "make_mesh_2d",
           "matmul_dist", "recommend_engine"]


def recommend_engine(n: int, ndev: int | None = None):
    """The distributed gauss engine for a size: the 1-D panel-blocked
    engine below DIST_2D_CROSSOVER_N, the 2-D tournament-pivoting engine
    at or above it. ``ndev`` is accepted for symmetry and does not change
    the answer; both engines' refined entries share one contract."""
    if n < DIST_2D_CROSSOVER_N:
        return gauss_solve_dist_blocked_refined
    return gauss_solve_dist_blocked2d_refined

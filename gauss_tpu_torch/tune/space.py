"""The seeds of the JAX package's ``tune/space.py`` that the sparse plane
reads. The tuner's axes and sweeps are not ported yet; these are the
values its "sparse" op starts from."""

#: GMRES restart length — the resident Krylov basis, i.e. the
#: O(nnz + n*restart) peak-memory bound of the sparse plane.
SPARSE_RESTART_SEED = 32
#: Block size the block-Jacobi / blocked incomplete (ILU0/IC0)
#: preconditioners partition on.
SPARSE_BLOCK_SEED = 16

#: Density at or below which the structure tagger classifies "sparse"
#: (structure.detect.SPARSE_MAX_DENSITY re-exports it). A routing-policy
#: bound, not a timing knob.
SPARSE_DENSITY_SEED = 1.0 / 32.0

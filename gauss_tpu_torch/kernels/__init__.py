"""Hand-written CUDA kernels, each beside its plain PyTorch version.

- :mod:`.panel` — ``panel_factor``: the cluster-resident kernel
  (``csrc/panel_cluster.cu`` on ``csrc/panel_cluster.cuh``) for strips a
  cluster of up to 16 blocks holds, the grid kernel
  (``csrc/panel_grid.cu`` on ``csrc/panel_grid.cuh``: up to 132
  co-resident blocks, each pivot step exchanged through L2) for taller
  ones, the one-block kernel (``csrc/panel_factor.cu``) beyond the grid's
  reach (``panel_geometry``); and
  ``panel_factor_batched``, a (B, h, panel) stack in one launch
  (``csrc/panel_batched.cu``: each member of up to 256 rows in the
  registers of one block or a cluster of 4, taller ones on the one-block
  step loop; ``panel_batched_geometry``);
- :mod:`.panel_fused` — ``panel_trailing_fused`` and ``trailing_update``
  (``csrc/panel_fused.cu``);
- :mod:`.matmul` — ``matmul_tiled`` and ``matmul_stripe``
  (``csrc/matmul.cu``);
- :mod:`.rowelim` — ``eliminate_step`` and ``rankk_update``
  (``csrc/rowelim.cu``) and the row-elimination solve drivers;
  ``csrc/sgemm_common.cuh`` holds the f32 tile routine of the tiled
  matmul's "highest" and the rank-k update, ``csrc/stripe_common.cuh``
  the stripe's routine (whose tensor-core modes the tiled matmul also
  runs), ``csrc/gemm_common.cuh`` what they share;
- ``csrc/spmv.cu`` — the ELL sparse matrix-vector product, whose wrapper
  ``spmv_ell_kernel`` lives with the sparse plane
  (:mod:`gauss_tpu_torch.sparse.spmv`);
- :mod:`._build` — ``nvcc`` build at first use, ``ctypes`` binding, and
  the per-wrapper launch counts (``LAUNCHES``).
"""

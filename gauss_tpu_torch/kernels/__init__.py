"""Hand-written CUDA kernels, each beside its plain PyTorch version.

- :mod:`.panel` — ``panel_factor`` (``csrc/panel_factor.cu``);
- :mod:`.panel_fused` — ``panel_trailing_fused`` and ``trailing_update``
  (``csrc/panel_fused.cu``);
- :mod:`.matmul` — ``matmul_tiled`` and ``matmul_stripe``
  (``csrc/matmul.cu``);
- :mod:`.rowelim` — ``eliminate_step`` and ``rankk_update``
  (``csrc/rowelim.cu``) and the row-elimination solve drivers;
  ``csrc/gemm_common.cuh`` holds the f32 tile routine of the GEMM-shaped
  kernels;
- ``csrc/spmv.cu`` — the ELL sparse matrix-vector product, whose wrapper
  ``spmv_ell_kernel`` lives with the sparse plane
  (:mod:`gauss_tpu_torch.sparse.spmv`);
- :mod:`._build` — ``nvcc`` build at first use, ``ctypes`` binding, and
  the per-wrapper launch counts (``LAUNCHES``).
"""

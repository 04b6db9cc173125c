"""Hand-written CUDA kernels of the blocked LU, each beside its plain
PyTorch version.

- :mod:`.panel` — ``panel_factor`` (``csrc/panel_factor.cu``);
- :mod:`.panel_fused` — ``panel_trailing_fused`` and ``trailing_update``
  (``csrc/panel_fused.cu``);
- :mod:`._build` — ``nvcc`` build at first use, ``ctypes`` binding, and
  the per-wrapper launch counts (``LAUNCHES``).
"""

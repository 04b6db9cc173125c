"""Correctness checks computed in float64 on the host."""

from gauss_tpu_torch.verify.checks import (  # noqa: F401
    EPSILON, elementwise_match, internal_pattern_ok, max_rel_error,
    residual_norm)

"""The lowered residual grid (tests/test_lowered.py's
``test_lowered_residual_grid`` shapes): every factor form (flat,
unrolled, chunked) and panel route (``fused``, ``auto``, ``pallas``) at
both lowered dtypes, each factor held against the JAX package's same
call (interpret-mode kernels on the CPU) and refined under 1e-4 through
the port's double-single refinement."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gauss_tpu.core import blocked as jb
from gauss_tpu.verify import checks
from gauss_tpu_torch.core import blocked as tb
from gauss_tpu_torch.core import dsfloat as td

#: ``m`` against the JAX package's, relative to max |m|: two bfloat16 ulps
#: at that scale. The chunked form's deferred GEMMs sum in float32 in
#: another order before their one rounding, and the JAX package's panel
#: may take its two-level form, which rounds differently.
M_TOL = 2 * 2.0 ** -7

FORMS = {"flat": (tb.lu_factor_blocked, jb.lu_factor_blocked),
         "unrolled": (tb.lu_factor_blocked_unrolled,
                      jb.lu_factor_blocked_unrolled),
         "chunked": (tb.lu_factor_blocked_chunked,
                     jb.lu_factor_blocked_chunked)}


@pytest.mark.parametrize("dtype", ["bfloat16", "bf16x3"])
@pytest.mark.parametrize("n,panel,chunk", [(96, 16, 2), (100, 16, 2),
                                           (64, 32, 1), (96, 48, 2)])
@pytest.mark.parametrize("impl", ["fused", "auto", "pallas"])
def test_lowered_residual_grid(rng, dtype, n, panel, chunk, impl):
    a = rng.standard_normal((n, n))
    a[np.arange(n), np.arange(n)] += float(n)
    b = rng.standard_normal(n)
    gp = "bf16x3" if dtype == "bf16x3" else "highest"
    a_in = (a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16"
            else a.astype(np.float32))
    at, bd = td.to_ds(a.T, "cpu"), td.to_ds(b, "cpu")
    for form, (port, ref) in FORMS.items():
        kw = {"chunk": chunk} if form == "chunked" else {}
        fac = port(a_in, panel=panel, panel_impl=impl, gemm_precision=gp,
                   device="cpu", **kw)
        jfac = ref(jnp.asarray(a_in), panel=panel, panel_impl=impl,
                   gemm_precision=gp, **kw)
        where = (dtype, impl, form, n, panel, chunk)
        assert fac.m.dtype == (torch.bfloat16 if dtype == "bfloat16"
                               else torch.float32), where
        assert fac.linv.dtype == fac.uinv.dtype == torch.float32, where
        np.testing.assert_array_equal(fac.perm.numpy(),
                                      np.asarray(jfac.perm), err_msg=str(where))
        jm = np.asarray(jfac.m, np.float32)
        err = np.abs(fac.m.float().numpy() - jm).max()
        assert err <= M_TOL * np.abs(jm).max(), (where, err)
        x0 = tb.lu_solve(fac, bd.hi)
        x = td.refine_ds(fac, at, bd, x0, iters=6)
        rel = checks.residual_norm(a, td.ds_to_f64(x), b, relative=True)
        assert rel < 1e-4, (where, rel)

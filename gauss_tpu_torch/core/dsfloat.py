"""Double-single (two-float32) arithmetic for on-device residuals.

A value is an unevaluated pair ``hi + lo`` of float32s (~48 mantissa
bits), built from error-free transformations — Knuth's TwoSum and an
exact-partial-product TwoProd — that need only IEEE add/sub/mul. The one
consumer-facing op is :func:`ds_residual`, ``r = b - A @ x`` with A, b and
x all double-single, accurate to ~2^-47 relative: it lets refinement reach
the 1e-4 gate on ill-conditioned systems without a host round trip.

As in the JAX package, the primitives are REWRITE-IMMUNE: the operand
split runs in the integer domain (:func:`_split`, through
``.view(torch.int32)``), and every float multiply in :func:`_two_prod` is
exact by construction, so a contracted (FMA) or duplicated copy of any
product has the same value. Each torch op here is its own kernel, so
nothing is contracted across ops in the first place.

The reduction over the contraction axis is a pairwise tree of
double-single adds over row strips (the JAX package's 8-row tree plus a
compensated sequential fold, reshaped for eager execution: log-depth
instead of a per-group loop). The card has native float64, but the
double-single route is kept as the JAX package defines it, so the two
packages refine the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gauss_tpu_torch.utils.device import resolve_device

# Integer-domain split: round the low 12 fraction bits away (half-up via
# the integer add, the carry riding into the exponent) and mask them off,
# keeping 12 significant bits in hi so all hi/lo cross products are exact.
_ROUND_HALF = 0x800
_TRUNC_MASK = -4096  # 0xFFFFF000 as int32
_STRIP = 512  # rows per product strip: bounds the live temporaries to
              # O(_STRIP * m) instead of O(n * m)


class DS(NamedTuple):
    """A double-single tensor: value = hi + lo, |lo| <= ulp(hi)/2."""

    hi: torch.Tensor
    lo: torch.Tensor


def to_ds(a, device=None) -> DS:
    """Split a float64 host array into a double-single pair on ``device``
    (default ``cuda``): hi = f32(a), lo = f32(a - hi). Raises for
    |a| >= 1.7e38, where hi would overflow and NaN-poison residuals."""
    dev = resolve_device(device)
    a = np.asarray(a, np.float64)
    if a.size and float(np.max(np.abs(a))) >= 1.7e38:
        raise ValueError(
            "to_ds operand exceeds the double-single representable range "
            f"(max |a| = {float(np.max(np.abs(a))):.3e} >= 1.7e38); the f32 "
            "hi part would overflow to inf and NaN-poison residuals")
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return DS(torch.as_tensor(hi, device=dev),
              torch.as_tensor(lo, device=dev))


def ds_to_f64(x: DS) -> np.ndarray:
    """Exact host read-back: hi and lo are both representable in f64."""
    return (x.hi.cpu().numpy().astype(np.float64)
            + x.lo.cpu().numpy().astype(np.float64))


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    """Fast TwoSum, valid when |a| >= |b| (renormalization step)."""
    s = a + b
    return s, b - (s - a)


def _split(a: torch.Tensor):
    """Round-to-12-significant-bits split in the integer domain:
    a == hi + lo exactly, products of any two hi/lo parts exact in f32."""
    bits = a.contiguous().view(torch.int32)
    hi = ((bits + _ROUND_HALF) & _TRUNC_MASK).view(torch.float32)
    return hi, a - hi


def _two_prod(a, b):
    """TwoProd from exact partial products: p + e == a * b to ~2^-58."""
    ah, al = _split(a)
    bh, bl = _split(b)
    s1, e1 = _two_sum(ah * bh, ah * bl)
    s2, e2 = _two_sum(s1, al * bh)
    return s2, e1 + e2 + al * bl


def ds_add(x: DS, y: DS) -> DS:
    """Double-single addition with renormalization."""
    s, e = _two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return DS(*_quick_two_sum(s, e))


def ds_neg(x: DS) -> DS:
    return DS(-x.hi, -x.lo)


def ds_from_f32(a: torch.Tensor) -> DS:
    return DS(a, torch.zeros_like(a))


def _tree_sum_rows(p: torch.Tensor, e: torch.Tensor) -> DS:
    """Pairwise double-single sum over axis 0 of (S, m) pairs."""
    x = DS(p, e)
    while x.hi.shape[0] > 1:
        rows = x.hi.shape[0]
        if rows % 2:
            pad = torch.zeros((1, x.hi.shape[1]), dtype=x.hi.dtype,
                              device=x.hi.device)
            x = DS(torch.cat([x.hi, pad]), torch.cat([x.lo, pad]))
            rows += 1
        h = rows // 2
        x = ds_add(DS(x.hi[:h], x.lo[:h]), DS(x.hi[h:], x.lo[h:]))
    return DS(x.hi[0], x.lo[0])


def ds_matvec(at: DS, x: DS) -> DS:
    """Double-single ``A @ x`` where ``at`` is A TRANSPOSED, shape (n, m):
    result[i] = sum_j at[j, i] * x[j]. Per strip of rows, exact TwoProd
    products (hi*lo cross terms in the error channel; lo*lo, below 2^-48,
    dropped), a pairwise tree over the strip, strips folded in order."""
    n, m = at.hi.shape
    acc = DS(torch.zeros(m, dtype=at.hi.dtype, device=at.hi.device),
             torch.zeros(m, dtype=at.hi.dtype, device=at.hi.device))
    for s in range(0, n, _STRIP):
        rh, rl = at.hi[s:s + _STRIP], at.lo[s:s + _STRIP]
        xh, xl = x.hi[s:s + _STRIP, None], x.lo[s:s + _STRIP, None]
        p, e = _two_prod(rh, xh.expand_as(rh))
        e = e + (rh * xl + rl * xh)
        acc = ds_add(acc, _tree_sum_rows(p, e))
    return acc


def ds_residual(at: DS, x: DS, b: DS) -> DS:
    """``b - A @ x`` in double-single (``at`` = A transposed)."""
    return ds_add(b, ds_neg(ds_matvec(at, x)))


def refine_ds(fac, at: DS, b: DS, x0: torch.Tensor, iters: int = 3,
              solve_fn=None, tol: float = 0.0, return_iters: bool = False):
    """On-device iterative refinement with double-single residuals.

    ``fac``: a blocked factor of A, float32 or lowered (bfloat16 storage
    or the bf16x3 update): the correction solve runs in the factor's
    accumulate dtype (``blocked.lu_solve``), so one refinement serves
    every rung of ``core.lowered``'s ladder. Each iteration: r = b - A x
    (double-single), d = solve_fn(fac, r.hi + r.lo) — the correction only
    needs f32 relative accuracy — and a double-single update of x.

    ``tol`` > 0: an iteration whose residual already satisfies
    ``||r||_2 <= tol * ||b.hi||_2`` applies no update, and neither does
    any later one (the JAX package's masked early exit: every iteration
    still runs, a converged x stops changing). ``return_iters=True``
    returns ``(x, used)``, ``used`` a 0-d int32 tensor counting the
    iterations that updated. With the defaults the loop and its result
    are the plain one's. Nothing syncs with the host in either form."""
    if solve_fn is None:
        from gauss_tpu_torch.core.blocked import lu_solve as solve_fn

    x = ds_from_f32(x0)
    if tol <= 0.0 and not return_iters:
        for _ in range(iters):
            r = ds_residual(at, x, b)
            d = solve_fn(fac, r.hi + r.lo)
            x = ds_add(x, ds_from_f32(d))
        return x

    dev = b.hi.device
    thresh = tol * torch.sqrt(torch.sum(torch.square(b.hi.float())))
    used = torch.zeros((), dtype=torch.int32, device=dev)
    active = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        r = ds_residual(at, x, b)
        rc = r.hi + r.lo
        if tol > 0.0:
            rnorm = torch.sqrt(torch.sum(torch.square(rc.float())))
            step = active & (rnorm > thresh)
        else:
            step = active
        xn = ds_add(x, ds_from_f32(solve_fn(fac, rc)))
        x = DS(torch.where(step, xn.hi, x.hi), torch.where(step, xn.lo, x.lo))
        used = used + step.to(torch.int32)
        active = step
    return (x, used) if return_iters else x


#: Default refinement step count (the JAX package's DS_REFINE_STEPS).
DS_REFINE_STEPS = 6


def solve_once_ds(a: torch.Tensor, at_ds: DS, b_ds: DS, panel: int | None,
                  iters: int = DS_REFINE_STEPS, unroll="auto",
                  gemm_precision: str = "highest", donate: bool = False):
    """One f32 factor + solve + double-single refinement pass on ``a``'s
    device. ``a`` is the f32 matrix tensor (factor operand); ``at_ds`` /
    ``b_ds`` the double-single transposed matrix and RHS. ``donate``: the
    factorization may take ``a`` in place (a caller that owns it; see
    :func:`gauss_tpu_torch.core.blocked.resolve_factor`). Returns
    ``(x_ds, factors)``."""
    from gauss_tpu_torch.core import blocked

    factor = blocked.resolve_factor(a.shape[0], unroll, donate=donate,
                                    device=a.device)
    fac = factor(a, panel=panel, gemm_precision=gemm_precision,
                 device=a.device)
    x0 = blocked.lu_solve(fac, b_ds.hi)
    return refine_ds(fac, at_ds, b_ds, x0, iters=iters), fac


def solve_ds(a, b, iters: int = DS_REFINE_STEPS, panel: int | None = None,
             unroll="auto", device=None):
    """Fully on-device mixed-precision solve: f32 blocked factorization +
    double-single refinement; returns ``(x_float64, factors)``."""
    dev = resolve_device(device)
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    if b64.ndim != 1:
        # The double-single matvec takes one right-hand side; the JAX
        # package fails the same shape with a ValueError from broadcasting.
        raise ValueError(f"solve_ds takes one right-hand side of shape "
                         f"(n,), got {b64.shape}")
    # The f32 factor operand is staged here and dead after the factor:
    # donate it (factored in place where it needs no padding), as the JAX
    # package does.
    x, fac = solve_once_ds(torch.as_tensor(a64, dtype=torch.float32,
                                           device=dev),
                           to_ds(a64.T, dev), to_ds(b64, dev), panel,
                           iters=iters, unroll=unroll, donate=True)
    return ds_to_f64(x), fac

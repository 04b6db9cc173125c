"""The tridiagonal solve of the JAX package's ``structure/banded.py``.

Only :func:`solve_tridiag` is here (the ``tridiag`` preconditioner of the
sparse plane applies it); the blocked band LU and ``solve_banded`` are not
ported yet.

The three Thomas recurrences (the pivot recurrence ``d'_i = d_i - l_i
u_{i-1}``, the forward sweep, the back sweep) are each first-order linear,
so each runs as a log-depth scan in tensor operations instead of an n-step
chain of tiny launches. The pivot recurrence is rational; it linearizes
through the continuant trick (``d'_i = p_i / p_{i-1}`` with ``p`` a 3-term
linear recurrence, a cumulative product of 2x2 matrices), each product
normalized by its max-|entry| so it never over- or underflows: the
recurrence consumes only RATIOS of a product's entries, which the scale
leaves alone.

The scans are the step-doubling form (log2(n) passes, each one batched
operation over the whole array) where the JAX package's
``lax.associative_scan`` recurses over odd and even halves: the same
products in another association, so values agree to rounding, not bit for
bit.
"""

from __future__ import annotations

import torch


def _scan(combine, state):
    """Inclusive scan by step doubling: after the pass at distance ``d``
    entry ``i`` holds the combination of entries ``i-2d+1 .. i``.
    ``combine(earlier, later)`` takes and returns tuples of tensors
    indexed along dim 0."""
    n = state[0].shape[0]
    d = 1
    while d < n:
        head = tuple(s[:d] for s in state)
        tail = combine(tuple(s[:-d] for s in state),
                       tuple(s[d:] for s in state))
        state = tuple(torch.cat([h, t]) for h, t in zip(head, tail))
        d *= 2
    return state


def _affine_scan(coef: torch.Tensor, const: torch.Tensor,
                 reverse: bool = False) -> torch.Tensor:
    """Solve ``y_i = coef_i * y_{i-1} + const_i`` (``y_{-1} = 0``) for all
    i: ``coef`` is (n, 1), ``const`` (n, k); ``reverse`` runs the
    recurrence from the far end."""
    if reverse:
        coef, const = coef.flip(0), const.flip(0)

    def combine(f, g):
        # g after f: x -> g.a * (f.a * x + f.c) + g.c
        (fa, fc), (ga, gc) = f, g
        return ga * fa, ga * fc + gc

    _, c = _scan(combine, (coef, const))
    return c.flip(0) if reverse else c


def solve_tridiag(dl, d, du, b) -> torch.Tensor:
    """Thomas via log-depth scans: ``dl``/``d``/``du`` are the sub/main/
    super diagonals (``dl[0]`` and ``du[-1]`` ignored), ``b`` is (n,) or
    (n, k); all tensors on one device, computed in ``d``'s dtype.
    Unpivoted — meant for diagonally dominant tridiagonal systems."""
    dtype = d.dtype
    dl, du, b = dl.to(dtype), du.to(dtype), b.to(dtype)
    n = d.shape[0]
    was_vector = b.dim() == 1
    b2 = b[:, None] if was_vector else b
    if n == 1:
        x = b2 / d[0]
        return x[:, 0] if was_vector else x

    # Pivot recurrence d'_i = d_i - dl_i * du_{i-1} / d'_{i-1} linearized:
    # p_i = d_i p_{i-1} - (dl_i du_{i-1}) p_{i-2}, d'_i = p_i / p_{i-1}.
    sub = dl[1:] * du[:-1]                      # (n-1,)
    mats = torch.zeros((n - 1, 2, 2), dtype=dtype, device=d.device)
    mats[:, 0, 0] = d[1:]
    mats[:, 0, 1] = -sub
    mats[:, 1, 0] = 1.0
    floor = torch.full((), 1e-30, dtype=dtype, device=d.device)

    def mcombine(x, y):
        # y AFTER x (cumulative product from the left): P = y @ x, then
        # normalized by its max entry (see the module docstring).
        out = torch.matmul(y[0], x[0])
        scale = out.abs().amax(dim=(-2, -1), keepdim=True)
        return (out / torch.maximum(scale, floor),)

    (prods,) = _scan(mcombine, (mats,))
    p_i = prods[:, 0, 0] * d[0] + prods[:, 0, 1]
    p_im1 = prods[:, 1, 0] * d[0] + prods[:, 1, 1]
    dp = torch.cat([d[:1], p_i / p_im1])  # d'_i, i = 0..n-1

    zero = torch.zeros(1, dtype=dtype, device=d.device)
    # Forward sweep y_i = b_i - (dl_i / d'_{i-1}) y_{i-1}.
    l = torch.cat([zero, dl[1:] / dp[:-1]])
    y = _affine_scan(-l[:, None], b2)
    # Back sweep x_i = y_i / d'_i - (du_i / d'_i) x_{i+1}.
    u = torch.cat([du[:-1] / dp[:-1], zero])
    x = _affine_scan(-u[:, None], y / dp[:, None], reverse=True)
    return x[:, 0] if was_vector else x

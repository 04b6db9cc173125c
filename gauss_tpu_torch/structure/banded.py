"""Banded solvers: O(n * b^2) where the dense path pays O(n^3). Port of
``gauss_tpu/structure/banded.py``.

Two engines behind one entry point (:func:`solve_banded`):

- **b == 1 (tridiagonal):** :func:`solve_tridiag`, Thomas by log-depth
  scans (below; the ``tridiag`` preconditioner of the sparse plane applies
  it too).
- **b > 1:** :func:`solve_band_blocklu`, block Gaussian elimination over
  the block-tridiagonal form in (b, b) blocks: one loop over the ``n / b``
  block rows each way, small torch products and inverses per block (the
  JAX package's two ``lax.scan``s), O(n * b^2) in all.

Neither engine pivots (pivoting would destroy the band): correct for
diagonally dominant or SPD bands, and for everything else the router's
1e-4 gate demotes to general LU. A bandwidth over the caller's promise or
over ``n // BANDED_MAX_DIVISOR`` raises the typed
:class:`~gauss_tpu_torch.structure.detect.StructureMismatchError`.

The engines contain no Pallas kernel in the JAX package, so stock torch
operations do the work here.

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

import numpy as np
import torch

from gauss_tpu_torch.structure.detect import (BANDED_MAX_DIVISOR,
                                              StructureMismatchError)
from gauss_tpu_torch.utils.device import as_tensor, resolve_device


def bandwidth_of(a) -> int:
    """max |i - j| over nonzeros (0 for diagonal/empty)."""
    a = np.asarray(a)
    rows, cols = np.nonzero(a)
    return int(np.abs(rows - cols).max()) if rows.size else 0


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


def _block_diagonals(a, s: int):
    """Identity-pad ``a`` (numpy) to a multiple of ``s`` and return the
    block-tridiagonal diagonals as numpy stacks: D (nb, s, s), E = sub
    (nb, s, s; E[0] zero), F = super (nb, s, s; F[-1] zero), and npad."""
    a = np.asarray(a)
    n = a.shape[0]
    nb = -(-n // s)
    npad = nb * s
    ap = np.zeros((npad, npad), dtype=a.dtype)
    ap[:n, :n] = a
    ap[np.arange(n, npad), np.arange(n, npad)] = 1.0
    blocks = ap.reshape(nb, s, nb, s)
    idx = np.arange(nb)
    D = blocks[idx, :, idx].copy()
    E = np.zeros_like(D)
    F = np.zeros_like(D)
    if nb > 1:
        E[1:] = blocks[idx[1:], :, idx[:-1]]
        F[:-1] = blocks[idx[:-1], :, idx[1:]]
    return D, E, F, npad


def solve_band_blocklu(a, b, bandwidth: int, device=None) -> torch.Tensor:
    """Blocked band LU: block-tridiagonal elimination with (b, b) blocks,
    one loop over the block rows each way — O(n * b^2), no pivoting (the
    band's deal; see the module docstring). ``a``/``b`` are host arrays;
    returns x on ``device`` (default ``cuda``) in ``a``'s float dtype."""
    dev = resolve_device(device)
    a = np.asarray(a)
    n = a.shape[0]
    s = max(1, int(bandwidth))
    dt = torch.float64 if a.dtype == np.float64 else torch.float32
    D, E, F, npad = _block_diagonals(a, s)
    D, E, F = (as_tensor(x, dev, dt) for x in (D, E, F))
    nb = D.shape[0]
    b = np.asarray(b)
    was_vector = b.ndim == 1
    b2 = b[:, None] if was_vector else b
    k = b2.shape[1]
    bp = np.zeros((npad, k), dtype=b2.dtype)
    bp[:n] = b2
    B = as_tensor(bp.reshape(nb, s, k), dev, dt)

    dpinvs, ys = [], []
    dpinv = torch.zeros((s, s), dtype=dt, device=dev)
    y = torch.zeros((s, k), dtype=dt, device=dev)
    for i in range(nb):
        fprev = F[i - 1] if i else torch.zeros_like(dpinv)
        lo = E[i] @ dpinv
        dp = D[i] - lo @ fprev
        y = B[i] - lo @ y
        dpinv = torch.linalg.inv_ex(dp).inverse
        dpinvs.append(dpinv)
        ys.append(y)
    xs = [None] * nb
    x = torch.zeros((s, k), dtype=dt, device=dev)
    for i in range(nb - 1, -1, -1):
        x = dpinvs[i] @ (ys[i] - F[i] @ x)
        xs[i] = x
    x = torch.cat(xs)[:n]
    return x[:, 0] if was_vector else x


def solve_banded(a, b, bandwidth: int | None = None,
                 max_bandwidth: int | None = None, device=None):
    """Route a banded system to the right engine by bandwidth.

    ``bandwidth=None`` measures it; a caller-supplied value is CHECKED
    against the operand and a lie raises :class:`StructureMismatchError`,
    as does a true bandwidth over ``max_bandwidth`` (default ``n //
    BANDED_MAX_DIVISOR``). ``a``/``b`` are host arrays; the diagonal case
    returns a numpy array, the others a tensor on ``device`` (default
    ``cuda``), all in ``a``'s float dtype."""
    a = np.asarray(a)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"expected square matrix, got {a.shape}")
    bw = bandwidth_of(a)
    if bandwidth is not None and bw > bandwidth:
        raise StructureMismatchError(
            f"matrix bandwidth {bw} exceeds the promised {bandwidth}")
    limit = (max(1, n // BANDED_MAX_DIVISOR) if max_bandwidth is None
             else max_bandwidth)
    if bw > limit:
        raise StructureMismatchError(
            f"bandwidth {bw} of this {n} x {n} matrix exceeds the band "
            f"engine's limit {limit}; route to general LU")
    if bw == 0:
        d = np.diagonal(a)
        if not np.all(d != 0):
            raise StructureMismatchError(
                "diagonal matrix with zero diagonal entries is singular")
        return (np.asarray(b).T / d).T
    if bw == 1:
        dev = resolve_device(device)
        dt = torch.float64 if a.dtype == np.float64 else torch.float32
        zero = np.zeros(1, a.dtype)
        return solve_tridiag(
            as_tensor(np.concatenate([zero, np.diagonal(a, -1)]), dev, dt),
            as_tensor(np.diagonal(a).copy(), dev, dt),
            as_tensor(np.concatenate([np.diagonal(a, 1), zero]), dev, dt),
            as_tensor(b, dev, dt))
    return solve_band_blocklu(a, b, bw, device=device)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def solve_banded_refined(a, b, bandwidth: int | None = None, iters: int = 2,
                         dtype=np.float32, device=None) -> np.ndarray:
    """f32 band solve on the device + host-f64 iterative refinement
    (re-solving the O(n * b^2) band system per correction is cheap), the
    same mixed-precision contract as ``blocked.solve_refined``. Returns x
    float64."""
    a64 = np.asarray(a, dtype=np.float64)
    b64 = np.asarray(b, dtype=np.float64)
    a32 = a64.astype(dtype)
    x = _host(solve_banded(a32, b64.astype(dtype), bandwidth, device=device))
    for _ in range(iters):
        r = b64 - a64 @ x
        x = x + _host(solve_banded(a32, r.astype(dtype), bandwidth,
                                   device=device))
    return x

"""Not-a-knot cubic spline: the host operator builder and a torch
evaluation.

Counterpart of vega_tpu/ops/spline.py. `notaknot_second_derivative_matrix`
is a copy (numpy only); `spline_eval` is the same gather + cubic Hermite
evaluation on tensors, with the same interval choice, including the
round-off guard of the uniform-knot branch (vega_tpu/ops/spline.py:88-92).
Only uniform knots are taken: the transform's knots are uniform in log r.
"""

from __future__ import annotations

import numpy as np
import torch


def notaknot_second_derivative_matrix(x_knots: np.ndarray) -> np.ndarray:
    """Dense (n, n) matrix S with M = S @ y giving the spline second
    derivatives of the not-a-knot cubic interpolant through (x, y)."""
    x = np.asarray(x_knots, dtype=np.float64)
    n = len(x)
    if n < 4:
        raise ValueError('Need at least 4 knots for a not-a-knot cubic spline')
    h = np.diff(x)

    a_mat = np.zeros((n, n))
    b_mat = np.zeros((n, n))

    # Interior C1 continuity conditions
    for i in range(1, n - 1):
        a_mat[i, i - 1] = h[i - 1] / 6.0
        a_mat[i, i] = (h[i - 1] + h[i]) / 3.0
        a_mat[i, i + 1] = h[i] / 6.0
        b_mat[i, i - 1] = 1.0 / h[i - 1]
        b_mat[i, i] = -1.0 / h[i - 1] - 1.0 / h[i]
        b_mat[i, i + 1] = 1.0 / h[i]

    # Not-a-knot: third derivative continuous at x[1] and x[n-2]
    a_mat[0, 0] = h[1]
    a_mat[0, 1] = -(h[0] + h[1])
    a_mat[0, 2] = h[0]
    a_mat[n - 1, n - 3] = h[n - 2]
    a_mat[n - 1, n - 2] = -(h[n - 3] + h[n - 2])
    a_mat[n - 1, n - 1] = h[n - 3]

    return np.linalg.solve(a_mat, b_mat)


def uniform_step(x_knots_np):
    """The step of a uniform knot grid (the test of
    vega_tpu/ops/spline.py:77-78); raises for other grids, which the
    transform never makes (its knots are uniform in log r)."""
    x = np.asarray(x_knots_np, dtype=np.float64)
    spacing = np.diff(x)
    if not np.allclose(spacing, spacing[0], rtol=1e-12, atol=1e-14):
        raise ValueError('spline knots must be uniform')
    return (x[-1] - x[0]) / (len(x) - 1)


def interval_index(x_knots_np, knots, xq):
    """Interval index j (int64) of each clamped query, as spline_eval
    picks it on a uniform grid: arithmetic, then the round-off guard."""
    n = knots.shape[0]
    step = uniform_step(x_knots_np)
    # truncation toward zero, as astype(int32) in the JAX package
    j = torch.clamp(((xq - knots[0]) / step).to(torch.int64), 0, n - 2)
    # guard against float roundoff landing one interval high/low
    j = torch.where(xq < knots[j], j - 1, j)
    j = torch.where(xq >= knots[torch.clamp(j + 1, max=n - 1)], j + 1, j)
    return torch.clamp(j, 0, n - 2)


def spline_eval(x_knots_np, y, second_derivs, x_query, knots=None):
    """Evaluate the cubic spline at x_query (leading batch dims of y /
    second_derivs broadcast against x_query).

    x_knots_np : (n,) host knot positions (ascending)
    y, second_derivs : (..., n) tensors
    x_query : (..., m) tensor
    knots : optional device copy of x_knots_np (made here when absent)

    Returns (values (..., m), oob (..., m) bool), values computed at the
    clamped coordinates (vega_tpu/ops/spline.py:56-117).
    """
    if knots is None:
        knots = torch.as_tensor(np.asarray(x_knots_np, dtype=np.float64),
                                dtype=y.dtype, device=y.device)
    oob = (x_query < knots[0]) | (x_query > knots[-1])
    xq = torch.clamp(x_query, knots[0], knots[-1])
    j = interval_index(x_knots_np, knots, xq)
    x_lo = knots[j]
    x_hi = knots[j + 1]
    h = x_hi - x_lo

    batch = torch.broadcast_shapes(y.shape[:-1], j.shape[:-1])
    y_b = y.expand(batch + y.shape[-1:])
    m_b = second_derivs.expand(batch + second_derivs.shape[-1:])
    j_b = j.expand(batch + j.shape[-1:])
    y_lo = torch.gather(y_b, -1, j_b)
    y_hi = torch.gather(y_b, -1, j_b + 1)
    m_lo = torch.gather(m_b, -1, j_b)
    m_hi = torch.gather(m_b, -1, j_b + 1)

    t_hi = (x_hi - xq) / h
    t_lo = (xq - x_lo) / h
    h2 = h * h / 6.0
    vals = (
        y_lo * t_hi + y_hi * t_lo
        + m_lo * h2 * (t_hi * t_hi * t_hi - t_hi)
        + m_hi * h2 * (t_lo * t_lo * t_lo - t_lo)
    )
    return vals, oob

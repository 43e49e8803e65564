"""The spline + Legendre combine: the CUDA kernel's wrapper and its plain
PyTorch version.

    out[b, q] = sum_l S_{b,l}(clamp(x[b / G, q])) * leg[b / G, l, q]

Rows come in groups of G that share one coordinate row (G = 1: a
coordinate row per row; G = T in the grid sweep). Counterpart of
vega_tpu/ops/pallas_spline.py (the JAX package's only Pallas kernel).
The kernel is csrc/spline_legendre_combine.cu; the plain version is
`spline_legendre_combine_reference`, built on the torch `spline_eval`.
The wrapper takes the plain version only for tensors on the CPU: on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .spline import spline_eval, uniform_step


@dataclass(frozen=True)
class KnotGrid:
    """Uniform knot positions on the host and on the device, and the
    step."""
    values: np.ndarray
    tensor: torch.Tensor
    step: float

    @classmethod
    def build(cls, x_knots, device):
        values = np.asarray(x_knots, dtype=np.float64)
        return cls(values,
                   torch.as_tensor(values, dtype=torch.float64,
                                   device=device),
                   uniform_step(values))

    def __len__(self):
        return len(self.values)


def spline_legendre_combine_reference(grid, y, m, x, leg, group=1):
    """Plain PyTorch version: torch spline_eval per multipole, then the
    Legendre-weighted sum over multipoles. Same arguments as
    `spline_legendre_combine`."""
    n_b, n_ell, n_knots = y.shape
    n_x, n_q = x.shape
    # (B / G, G, L, N) tables against one coordinate row per group
    y = y.reshape(n_x, group, n_ell, n_knots)
    m = m.reshape(n_x, group, n_ell, n_knots)
    vals, _ = spline_eval(grid.values, y, m, x[:, None, None, :],
                          knots=grid.tensor)            # (B / G, G, L, M)
    return torch.sum(vals * leg[:, None], dim=2).reshape(n_b, n_q)


def _check(grid, y, m, x, leg, group):
    """Shapes, dtypes, devices and layouts the kernel takes; raises on
    anything else. Returns (B, L, N, M, x_row_stride, leg_row_stride)."""
    tensors = {'y': y, 'm': m, 'x': x, 'leg': leg}
    for name, t in tensors.items():
        if t.dtype != torch.float64:
            raise TypeError(f'{name} must be float64, got {t.dtype}')
        if t.device != grid.tensor.device:
            raise ValueError(f'{name} is on {t.device}, the knot grid on '
                             f'{grid.tensor.device}')
    if y.dim() != 3 or y.shape != m.shape:
        raise ValueError(f'y and m must be (B, L, N) of one shape, got '
                         f'{tuple(y.shape)} and {tuple(m.shape)}')
    n_b, n_ell, n_knots = y.shape
    if n_knots != len(grid) or n_knots < 4:
        raise ValueError(f'{n_knots} knot values for a grid of '
                         f'{len(grid)} knots (at least 4 needed)')
    if not (y.is_contiguous() and m.is_contiguous()):
        raise ValueError('y and m must be contiguous')
    if not isinstance(group, int) or group < 1 or n_b % group:
        raise ValueError(f'the row group {group!r} must be a positive int '
                         f'dividing B = {n_b}')
    n_x = n_b // group
    if x.dim() != 2 or x.shape[0] != n_x:
        raise ValueError(f'x must be (B / G, M) with B / G = {n_x}, got '
                         f'{tuple(x.shape)}')
    n_q = x.shape[1]
    if leg.shape != (n_x, n_ell, n_q):
        raise ValueError(f'leg must be (B / G, L, M) = '
                         f'{(n_x, n_ell, n_q)}, got {tuple(leg.shape)}')
    # rows contiguous; a row stride of 0 shares one row across the batch
    x_rs = 0 if n_x > 1 and x.stride(0) == 0 else n_q
    leg_rs = 0 if n_x > 1 and leg.stride(0) == 0 else n_ell * n_q
    if (n_q > 1 and x.stride(1) != 1) or (n_x > 1 and x.stride(0) != x_rs):
        raise ValueError(f'x must have row stride M or 0 and unit column '
                         f'stride, got strides {x.stride()}')
    if ((n_q > 1 and leg.stride(2) != 1)
            or (n_ell > 1 and leg.stride(1) != n_q)
            or (n_x > 1 and leg.stride(0) != leg_rs)):
        raise ValueError(f'leg must have strides (L*M or 0, M, 1), got '
                         f'{leg.stride()}')
    return n_b, n_ell, n_knots, n_q, x_rs, leg_rs


def spline_legendre_combine(grid, y, m, x, leg, *, group=1,
                            use_kernel=True):
    """Fused evaluate-and-combine for B rows.

    grid : KnotGrid of N knots (log r), on the tensors' device
    y, m : (B, L, N) f64 contiguous knot values / second derivatives
    x : (B / G, M) f64 queries, rows contiguous or one row broadcast
        (row stride 0, e.g. `x.expand(B / G, M)`)
    leg : (B / G, L, M) f64 Legendre weights, row stride L*M or 0
    group : G, the number of consecutive rows that share one row of x
        and leg (the grid sweep's T basis terms of one node)

    Returns a new (B, M) f64 tensor. Out-of-range queries are clamped;
    the caller tracks the out-of-range flag. On CPU tensors this is the
    plain version; on CUDA tensors it launches the kernel (use_kernel=
    False takes the plain version there, for comparing the two).
    """
    n_b, n_ell, n_knots, n_q, x_rs, leg_rs = _check(grid, y, m, x, leg,
                                                    group)
    device = y.device
    if device.type == 'cpu' or (device.type == 'cuda' and not use_kernel):
        return spline_legendre_combine_reference(grid, y, m, x, leg, group)
    if device.type != 'cuda':
        raise ValueError(f'no spline_legendre_combine for {device}')

    from ._build import load_library
    lib = load_library().lib
    out = torch.empty((n_b, n_q), dtype=torch.float64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vega_spline_legendre_combine_f64(
        grid.tensor.data_ptr(), y.data_ptr(), m.data_ptr(), x.data_ptr(),
        leg.data_ptr(), out.data_ptr(), n_b, n_ell, n_knots, n_q, group,
        x_rs, leg_rs, grid.step, stream)
    if err != 0:
        # refused launches (e.g. too much shared memory) land here
        raise RuntimeError(
            'spline_legendre_combine launch failed: '
            f'{lib.vega_cuda_error_string(err).decode()} ({err})')
    spline_legendre_combine.launches += 1
    return out


spline_legendre_combine.launches = 0

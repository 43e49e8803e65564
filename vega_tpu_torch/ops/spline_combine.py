"""The spline + Legendre combine, its derivatives and its transpose: the
CUDA kernels' wrappers with their launch plan and cost model, their plain
PyTorch versions, and the autograd Functions that make the combine
differentiable twice.

    F_d[b, q]    = sum_l S^(d)_{b,l}(clamp(x[b / G, q])) * leg[b / G, l, q]
    P_d[b, l, q] = S^(d)_{b,l}(clamp(x[b / G, q]))
    Ft_d(g, x, leg) = (Ybar, Mbar): the adjoint of (y, m) -> F_d

S^(d) is the d-th x-derivative (d = 0..3) of the cubic spline of row b,
multipole l; F_0 is the forward. Rows come in groups of G that share one
coordinate row (G = 1: a coordinate row per row; G = T in the grid
sweep, G = 3 or the batch in the metal stack; under a gradient a combine
with G > 1 runs group by group, `spline_legendre_combine`).

Counterpart of vega_tpu/ops/pallas_spline.py: the Pallas kernels (F_0)
and the backward of `make_vmappable_combine` (:233, the XLA VJP of
`spline_eval`, which vega_tpu differentiates twice for its Hessian). The
kernels are csrc/spline_legendre_combine.cu, each in f64 (the parity
mode) and in f32 (vega_tpu's throughput mode, VEGA_TPU_X64=0, the Pallas
kernels' only dtype): the knot grid's dtype picks them, and every tensor
of a call must have it. The plain versions are built on the torch
`spline_eval` and compute in the tensors' dtype. Each wrapper (`combine_forward`,
`combine_points`, `combine_transpose`) takes the plain version only for
tensors on the CPU: on a CUDA tensor it launches its kernel or raises.
The wrappers build no autograd graph and raise when handed a tensor that
requires grad with grad mode on; `spline_legendre_combine`, the public
entry point, goes through the autograd Functions then, whose backwards
call the same Functions, so a backward is itself differentiable:

    dF_d:  to (y, m) Ft_d(gbar, x, leg); to x gbar c(x) F_d+1(y, m, x, leg);
           to leg gbar P_d(y, m, x)
    dFt_d (cotangent (U, V)):  to g F_d(U, V, x, leg);
           to x g c(x) F_d+1(U, V, x, leg); to leg g P_d(U, V, x)
    dP_d (cotangent Gbar):  to (y, m) Ft_d(1, x, Gbar);
           to x c(x) F_d+1(y, m, x, Gbar)

with F_4 = 0 and c(x) the clamp's derivative in vega_tpu's convention
(jnp.clip): 1 inside the knot range, 1/2 on its ends, 0 outside.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .spline import piece_weights, spline_eval, spline_pieces, uniform_step

MAX_ORDER = 3       # S^(4) = 0
MAX_MULTIPOLES = 8  # L a kernel launch takes (csrc kMaxL)

# Kernel launches since the last reset, {(primitive, d): count} for the
# f64 kernels and {(primitive, d, 'f32'): count} for the f32 ones,
# primitive 'F' (F_d), 'P' (P_d) or 'Ft' (Ft_d). Only launches count: the
# plain version on CPU tensors launches nothing, and a launch captured into
# a CUDA graph counts at each replay of the graph, not at the capture.
# REPLAYED holds the part of LAUNCHES that came from replays.
LAUNCHES = Counter()
REPLAYED = Counter()
_recorders = []
_captures = []


DTYPES = {torch.float64: 'f64', torch.float32: 'f32'}


@dataclass(frozen=True)
class KnotGrid:
    """Uniform knot positions on the host (f64) and on the device in the
    kernels' dtype (f64 or f32), and the step."""
    values: np.ndarray
    tensor: torch.Tensor
    step: float

    @classmethod
    def build(cls, x_knots, device, dtype=torch.float64):
        if dtype not in DTYPES:
            raise TypeError(f'the kernels take float64 or float32, not '
                            f'{dtype}')
        values = np.asarray(x_knots, dtype=np.float64)
        return cls(values,
                   torch.as_tensor(values, dtype=dtype, device=device),
                   uniform_step(values))

    @property
    def dtype(self):
        return self.tensor.dtype

    def __len__(self):
        return len(self.values)


@dataclass
class RecordedLayout:
    """A launch layout seen while recording: its knot grid and how many
    launches it took."""
    grid: KnotGrid
    launches: int = 0


@contextlib.contextmanager
def recorded_launches():
    """While open, record every kernel launch as {(primitive, d, B, L, N,
    G, coordinate rows, M, x shared, leg shared): RecordedLayout}; x /
    leg shared means a row stride of 0. An f32 launch's key ends in one
    more entry, 'f32'."""
    layouts = {}
    _recorders.append(layouts)
    try:
        yield layouts
    finally:
        # by identity: a nested recorder may hold the same launches, and
        # list.remove would take the first equal dict
        del _recorders[next(i for i, r in enumerate(_recorders)
                            if r is layouts)]


class CapturedLaunches:
    """The kernel launches captured into one CUDA graph, as
    `recorded_launches` keys them. `replay` is the only way to count
    them: it replays the graph and counts in one call."""

    def __init__(self):
        self.layouts = {}

    def __len__(self):
        return sum(record.launches for record in self.layouts.values())

    def replay(self, graph):
        """Replay `graph` (the torch.cuda.CUDAGraph captured while this
        was open) and count its kernel launches."""
        graph.replay()
        for key, record in self.layouts.items():
            _count(key, record.grid, record.launches, replayed=True)


@contextlib.contextmanager
def captured_launches():
    """While open (around the capture of a CUDA graph), a kernel launch
    is a node of the graph and runs nothing: it is recorded in the
    CapturedLaunches this yields alone, and counted when the graph is
    replayed through it."""
    captured = CapturedLaunches()
    _captures.append(captured.layouts)
    try:
        yield captured
    finally:
        _captures.remove(captured.layouts)


def _count(key, grid, launches, replayed=False):
    kernel = key[:2] + key[10:]         # (primitive, d[, 'f32'])
    LAUNCHES[kernel] += launches
    if replayed:
        REPLAYED[kernel] += launches
    for layouts in _recorders:
        layouts.setdefault(key, RecordedLayout(grid)).launches += launches


def _launched(primitive, order, layout, grid):
    key = (primitive, order, *layout)
    if grid.dtype == torch.float32:
        key += ('f32',)
    if _captures:
        for layouts in _captures:
            layouts.setdefault(key, RecordedLayout(grid)).launches += 1
    else:
        _count(key, grid, 1)


def clamp_derivative(grid, x):
    """c(x): 1 inside the knot range, 1/2 on its ends, 0 outside (the
    derivative of jnp.clip, vega_tpu/ops/spline.py:82). A constant: it
    has no gradient of its own."""
    lo, hi = grid.values[0], grid.values[-1]
    inside = ((x > lo) & (x < hi)).to(x.dtype)
    return inside + 0.5 * ((x == lo) | (x == hi)).to(x.dtype)


# ----------------------------------------------------------------------
# Launch plan and cost
# ----------------------------------------------------------------------
THREADS = 256               # a block's threads (csrc kThreads)
H100_SMS = 132
BLOCK_TARGET = 2 * H100_SMS
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA's data sheet)
# H100 SXM outside the tensor cores (NVIDIA's data sheet): f64 and f32
FLOPS_PER_S = {'f64': 34e12, 'f32': 67e12}
WORD_BYTES = {'f64': 8, 'f32': 4}
# flops per query: the interval and weights, then per multipole the
# gathered combination (F_d: times the Legendre weight; Ft_d: g * leg
# times the four weights)
PIECE_FLOPS = 20
MULTIPOLE_FLOPS = {'F': 9, 'P': 7, 'Ft': 9}


def launch_plan(n_b, n_q):
    """(tiles, tile_q): each row's M queries in `tiles` tiles of tile_q
    queries (whole chunks of THREADS), one block per (row, tile). Rows
    are split until B x tiles reaches BLOCK_TARGET (two blocks per SM) or
    a tile is one chunk: one tile per row at B >= 264, 20 tiles of 256
    queries at B = 1, M = 5000. Every tile holds at least one query."""
    chunks = max(1, -(-n_q // THREADS))
    wanted = -(-BLOCK_TARGET // max(n_b, 1))
    tile_q = THREADS * max(1, chunks // wanted)
    return max(1, -(-n_q // tile_q)), tile_q


def launch_bytes(primitive, order, n_b, n_ell, n_knots, group, n_x, n_q,
                 x_shared, leg_shared, dtype='f64'):
    """Bytes one launch must move (a recorded layout: B, L, N, G,
    coordinate rows, M, x / leg shared, and 'f32' for an f32 launch),
    each input read once and each output written once: the knots, the
    tables (m alone for d >= 2: S'' and S''' do not read y), x and leg per
    coordinate row (once when shared), g and out per row. The transpose
    writes both tables. 8 bytes a word in f64, 4 in f32."""
    x_words = (1 if x_shared else n_x) * n_q
    leg_words = (1 if leg_shared else n_x) * n_ell * n_q
    table = n_ell * n_knots
    if primitive == 'Ft':
        words = n_b * n_q + x_words + leg_words + 2 * n_b * table
    else:
        words = (1 if order >= 2 else 2) * n_b * table + x_words
        words += leg_words + n_b * n_q if primitive == 'F' else (
            n_b * n_ell * n_q)
    return WORD_BYTES[dtype] * (n_knots + words)


def launch_bound(primitive, order, *layout):
    """(bound_ms, bound_by): the least time the card could take for one
    launch, the larger of its bytes over the HBM rate and its flops over
    the rate of its dtype; layout as `launch_bytes` takes it."""
    n_b, n_ell, n_q = layout[0], layout[1], layout[5]
    dtype = layout[8] if len(layout) > 8 else 'f64'
    bytes_s = launch_bytes(primitive, order, *layout) / HBM_BYTES_PER_S
    flops = n_b * n_q * (PIECE_FLOPS + n_ell * MULTIPOLE_FLOPS[primitive])
    flops_s = flops / FLOPS_PER_S[dtype]
    return (1e3 * max(bytes_s, flops_s),
            'bytes' if bytes_s >= flops_s else 'operations')


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------
def _spline_values(grid, y, m, x, group, order):
    """S^(d) at the clamped queries, (B / G, G, L, M)."""
    n_b, n_ell, n_knots = y.shape
    n_x = x.shape[0]
    y = y.reshape(n_x, group, n_ell, n_knots)
    m = m.reshape(n_x, group, n_ell, n_knots)
    vals, _ = spline_eval(grid.values, y, m, x[:, None, None, :],
                          knots=grid.tensor, order=order)
    return vals


def spline_legendre_combine_reference(grid, y, m, x, leg, group=1,
                                      order=0):
    """Plain F_d: torch spline_eval per multipole, then the
    Legendre-weighted sum over multipoles. Same arguments as
    `combine_forward`."""
    n_b, n_q = y.shape[0], x.shape[1]
    vals = _spline_values(grid, y, m, x, group, order)   # (B/G, G, L, M)
    return torch.sum(vals * leg[:, None], dim=2).reshape(n_b, n_q)


def spline_legendre_points_reference(grid, y, m, x, group=1, order=0):
    """Plain P_d, (B, L, M)."""
    return _spline_values(grid, y, m, x, group, order).reshape(
        y.shape[0], y.shape[1], x.shape[1])


def spline_legendre_transpose_reference(grid, g, x, leg, order=0):
    """Plain Ft_d: each query's weighted contributions scattered into the
    knot tables (torch scatter_add_). Returns (Ybar, Mbar), (B, L, N)."""
    n_b, n_q = g.shape
    n_ell = leg.shape[1]
    j, h, t_hi, t_lo = spline_pieces(grid.values, grid.tensor, x)
    weights = piece_weights(t_hi, t_lo, h, order)
    coef = g[:, None, :] * leg                             # (B, L, M)
    idx = j[:, None, :].expand(n_b, n_ell, n_q)
    tables = []
    for w_lo, w_hi in (weights[:2], weights[2:]):
        table = torch.zeros((n_b, n_ell, len(grid)), dtype=g.dtype,
                            device=g.device)
        table.scatter_add_(2, idx, coef * w_lo[:, None, :])
        table.scatter_add_(2, idx + 1, coef * w_hi[:, None, :])
        tables.append(table)
    return tuple(tables)


# ----------------------------------------------------------------------
# Checks
# ----------------------------------------------------------------------
def _check_tensors(grid, **tensors):
    for name, t in tensors.items():
        if t.dtype != grid.dtype:
            raise TypeError(f'{name} must be {grid.dtype} as the knot grid, '
                            f'got {t.dtype}')
        if t.device != grid.tensor.device:
            raise ValueError(f'{name} is on {t.device}, the knot grid on '
                             f'{grid.tensor.device}')


def _check_coords(x, leg, n_x, n_ell):
    """Shapes and strides of x (B / G, M) and leg (B / G, L, M) or None:
    rows contiguous, or a row stride of 0 that shares one row across the
    batch. Returns (M, x_row_stride, leg_row_stride)."""
    if x.dim() != 2 or x.shape[0] != n_x:
        raise ValueError(f'x must be (B / G, M) with B / G = {n_x}, got '
                         f'{tuple(x.shape)}')
    n_q = x.shape[1]
    x_rs = 0 if n_x > 1 and x.stride(0) == 0 else n_q
    if (n_q > 1 and x.stride(1) != 1) or (n_x > 1 and x.stride(0) != x_rs):
        raise ValueError(f'x must have row stride M or 0 and unit column '
                         f'stride, got strides {x.stride()}')
    if leg is None:
        return n_q, x_rs, 0
    if leg.shape != (n_x, n_ell, n_q):
        raise ValueError(f'leg must be (B / G, L, M) = '
                         f'{(n_x, n_ell, n_q)}, got {tuple(leg.shape)}')
    leg_rs = 0 if n_x > 1 and leg.stride(0) == 0 else n_ell * n_q
    if ((n_q > 1 and leg.stride(2) != 1)
            or (n_ell > 1 and leg.stride(1) != n_q)
            or (n_x > 1 and leg.stride(0) != leg_rs)):
        raise ValueError(f'leg must have strides (L*M or 0, M, 1), got '
                         f'{leg.stride()}')
    return n_q, x_rs, leg_rs


def _check_order(order):
    if order not in range(MAX_ORDER + 1):
        raise ValueError(f'derivative order {order!r} not in 0..{MAX_ORDER}')


def _check(grid, y, m, x, leg, group):
    """Shapes, dtypes, devices and layouts the forward kernels take (leg
    None for P_d); raises on anything else. Returns (B, L, N, M,
    x_row_stride, leg_row_stride)."""
    tensors = {'y': y, 'm': m, 'x': x}
    if leg is not None:
        tensors['leg'] = leg
    _check_tensors(grid, **tensors)
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
    n_q, x_rs, leg_rs = _check_coords(x, leg, n_b // group, n_ell)
    return n_b, n_ell, n_knots, n_q, x_rs, leg_rs


def _check_transpose(grid, g, x, leg):
    """Ft_d takes g (B, M) contiguous, x (B, M) and leg (B, L, M) as the
    forward takes them with G = 1. Returns (B, L, M, x_row_stride,
    leg_row_stride)."""
    _check_tensors(grid, g=g, x=x, leg=leg)
    if g.dim() != 2 or not g.is_contiguous():
        raise ValueError(f'g must be a contiguous (B, M), got '
                         f'{tuple(g.shape)} with strides {g.stride()}')
    if leg.dim() != 3:
        raise ValueError(f'leg must be (B, L, M), got {tuple(leg.shape)}')
    if len(grid) < 4:
        raise ValueError('at least 4 knots needed')
    n_b, n_q = g.shape
    n_ell = leg.shape[1]
    n_q_x, x_rs, leg_rs = _check_coords(x, leg, n_b, n_ell)
    if n_q_x != n_q:
        raise ValueError(f'g has {n_q} queries, x {n_q_x}')
    return n_b, n_ell, n_q, x_rs, leg_rs


def _refuse_graph(name, *tensors):
    """The wrappers' outputs carry no autograd graph: refuse a tensor
    whose gradient would be dropped silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f'{name} got a tensor that requires grad with grad mode on: its '
            'output would be cut off from autograd. Call '
            'spline_legendre_combine, which differentiates through the '
            'kernels, or run under torch.no_grad().')


def _kernel_route(device, use_kernel):
    """True to launch the kernel, False for the plain version (CPU
    tensors; CUDA tensors with use_kernel=False, for comparisons)."""
    if device.type == 'cpu':
        return False
    if device.type == 'cuda':
        return use_kernel
    raise ValueError(f'no spline_legendre_combine for {device}')


def _check_multipoles(n_ell):
    if not 1 <= n_ell <= MAX_MULTIPOLES:
        raise ValueError(f'the kernels take 1..{MAX_MULTIPOLES} multipoles, '
                         f'got L = {n_ell}')


# ----------------------------------------------------------------------
# Kernel launches (ctypes; csrc/spline_legendre_combine.cu)
# ----------------------------------------------------------------------
def _launch(entry, grid, device, *args):
    """Launch `entry`'s f64 or f32 symbol, by the knot grid's dtype."""
    from ._build import load_library
    lib = load_library().lib
    entry = f'{entry}_{DTYPES[grid.dtype]}'
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, entry)(*args, stream)
    if err != 0:
        # refused launches (e.g. too much shared memory) land here
        raise RuntimeError(
            f'{entry} launch failed: '
            f'{lib.vega_cuda_error_string(err).decode()} ({err})')


def _forward_kernel(grid, y, m, x, leg, out, order, group, x_rs, leg_rs,
                    plan):
    n_b, n_ell, n_knots = y.shape
    _launch('vega_spline_legendre_combine', grid, y.device,
            grid.tensor.data_ptr(), y.data_ptr(), m.data_ptr(),
            x.data_ptr(), leg.data_ptr(), out.data_ptr(), n_b, n_ell,
            n_knots, x.shape[1], group, *plan, x_rs, leg_rs, grid.step,
            order)


def _points_kernel(grid, y, m, x, out, order, group, x_rs, plan):
    n_b, n_ell, n_knots = y.shape
    _launch('vega_spline_legendre_points', grid, y.device,
            grid.tensor.data_ptr(), y.data_ptr(), m.data_ptr(),
            x.data_ptr(), out.data_ptr(), n_b, n_ell, n_knots, x.shape[1],
            group, *plan, x_rs, grid.step, order)


def _transpose_kernel(grid, g, x, leg, out_y, out_m, scratch, order, x_rs,
                      leg_rs, plan):
    n_b, n_ell, n_knots = out_y.shape
    _launch('vega_spline_legendre_transpose', grid, g.device,
            grid.tensor.data_ptr(), g.data_ptr(), x.data_ptr(),
            leg.data_ptr(), out_y.data_ptr(), out_m.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n_b, n_ell,
            n_knots, g.shape[1], *plan, x_rs, leg_rs, grid.step, order)


# ----------------------------------------------------------------------
# The wrappers: kernel on CUDA tensors, plain version on CPU tensors
# ----------------------------------------------------------------------
def combine_forward(grid, y, m, x, leg, *, order=0, group=1,
                    use_kernel=True):
    """F_d for B rows, a new (B, M) tensor in the grid's dtype (f64 or
    f32: the f64 or the f32 kernel).

    grid : KnotGrid of N knots (log r), on the tensors' device
    y, m : (B, L, N) contiguous knot values / second derivatives
    x : (B / G, M) queries, rows contiguous or one row broadcast
        (row stride 0, e.g. `x.expand(B / G, M)`)
    leg : (B / G, L, M) Legendre weights, row stride L*M or 0
    order : d, the x-derivative of the spline, 0..3
    group : G, the number of consecutive rows that share one row of x
        and leg (the grid sweep's T basis terms of one node)

    Out-of-range queries are clamped; the caller tracks the out-of-range
    flag. use_kernel=False takes the plain version on a CUDA device too
    (for comparing the two)."""
    _check_order(order)
    n_b, n_ell, n_knots, n_q, x_rs, leg_rs = _check(grid, y, m, x, leg,
                                                    group)
    _refuse_graph('combine_forward', y, m, x, leg)
    if not _kernel_route(y.device, use_kernel):
        return spline_legendre_combine_reference(grid, y, m, x, leg, group,
                                                 order)
    _check_multipoles(n_ell)
    out = torch.empty((n_b, n_q), dtype=y.dtype, device=y.device)
    _forward_kernel(grid, y, m, x, leg, out, order, group, x_rs, leg_rs,
                    launch_plan(n_b, n_q))
    _launched('F', order, (n_b, n_ell, n_knots, group, x.shape[0], n_q,
                           x_rs == 0 and x.shape[0] > 1,
                           leg_rs == 0 and x.shape[0] > 1), grid)
    return out


def combine_points(grid, y, m, x, *, order=0, group=1, use_kernel=True):
    """P_d, a new (B, L, M) tensor; arguments as `combine_forward`
    without leg."""
    _check_order(order)
    n_b, n_ell, n_knots, n_q, x_rs, _ = _check(grid, y, m, x, None, group)
    _refuse_graph('combine_points', y, m, x)
    if not _kernel_route(y.device, use_kernel):
        return spline_legendre_points_reference(grid, y, m, x, group, order)
    _check_multipoles(n_ell)
    out = torch.empty((n_b, n_ell, n_q), dtype=y.dtype, device=y.device)
    _points_kernel(grid, y, m, x, out, order, group, x_rs,
                   launch_plan(n_b, n_q))
    _launched('P', order, (n_b, n_ell, n_knots, group, x.shape[0], n_q,
                           x_rs == 0 and x.shape[0] > 1, False), grid)
    return out


def combine_transpose(grid, g, x, leg, *, order=0, use_kernel=True):
    """Ft_d(g, x, leg): new (Ybar, Mbar), each (B, L, N), with
    Ybar[b, l, i] = sum_q g[b, q] leg[b, l, q] dS^(d)_{b,l}(x_q)/dy[b, l, i]
    and Mbar the same for m. g (B, M) contiguous; x and leg as in
    `combine_forward` with G = 1. The kernel sums in a fixed order (no
    atomics): its result is the same bit for bit from run to run. With
    more than one tile per row it takes (B, tiles, 2, L, N) scratch for
    the tiles' partial tables."""
    _check_order(order)
    n_b, n_ell, n_q, x_rs, leg_rs = _check_transpose(grid, g, x, leg)
    _refuse_graph('combine_transpose', g, x, leg)
    if not _kernel_route(g.device, use_kernel):
        return spline_legendre_transpose_reference(grid, g, x, leg, order)
    _check_multipoles(n_ell)
    shape = (n_b, n_ell, len(grid))
    out_y = torch.empty(shape, dtype=g.dtype, device=g.device)
    out_m = torch.empty(shape, dtype=g.dtype, device=g.device)
    plan = launch_plan(n_b, n_q)
    scratch = None if plan[0] == 1 else torch.empty(
        (n_b, plan[0], 2, *shape[1:]), dtype=g.dtype, device=g.device)
    _transpose_kernel(grid, g, x, leg, out_y, out_m, scratch, order, x_rs,
                      leg_rs, plan)
    _launched('Ft', order, (n_b, n_ell, len(grid), 1, n_b, n_q,
                            x_rs == 0 and n_b > 1, leg_rs == 0 and n_b > 1),
              grid)
    return out_y, out_m


# ----------------------------------------------------------------------
# Autograd
# ----------------------------------------------------------------------
def _x_gradient(grid, x, g, higher):
    """g c(x) F_d+1, where `higher` computes F_d+1 (None for d = 3, where
    F_4 = 0)."""
    if higher is None:
        return torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    return clamp_derivative(grid, x) * g * higher()


class _Combine(torch.autograd.Function):
    """F_d(y, m, x, leg), G = 1."""

    @staticmethod
    def forward(y, m, x, leg, grid, order, use_kernel):
        return combine_forward(grid, y, m, x, leg, order=order,
                               use_kernel=use_kernel)

    @staticmethod
    def setup_context(ctx, inputs, output):
        y, m, x, leg, grid, order, use_kernel = inputs
        ctx.save_for_backward(y, m, x, leg)
        ctx.grid, ctx.order, ctx.use_kernel = grid, order, use_kernel

    @staticmethod
    def backward(ctx, gbar):
        y, m, x, leg = ctx.saved_tensors
        grid, d, use_kernel = ctx.grid, ctx.order, ctx.use_kernel
        need_y, need_m, need_x, need_leg = ctx.needs_input_grad[:4]
        gbar = gbar.contiguous()
        gy = gm = gx = gleg = None
        if need_y or need_m:
            gy, gm = _Transpose.apply(gbar, x, leg, grid, d, use_kernel)
        if need_x:
            gx = _x_gradient(grid, x, gbar, None if d == MAX_ORDER else (
                lambda: _Combine.apply(y, m, x, leg, grid, d + 1,
                                       use_kernel)))
        if need_leg:
            gleg = gbar[:, None, :] * _Points.apply(y, m, x, grid, d,
                                                    use_kernel)
        return (gy if need_y else None, gm if need_m else None, gx, gleg,
                None, None, None)


class _Transpose(torch.autograd.Function):
    """Ft_d(g, x, leg) -> (Ybar, Mbar)."""

    @staticmethod
    def forward(g, x, leg, grid, order, use_kernel):
        return combine_transpose(grid, g, x, leg, order=order,
                                 use_kernel=use_kernel)

    @staticmethod
    def setup_context(ctx, inputs, output):
        g, x, leg, grid, order, use_kernel = inputs
        ctx.save_for_backward(g, x, leg)
        ctx.grid, ctx.order, ctx.use_kernel = grid, order, use_kernel

    @staticmethod
    def backward(ctx, u, v):
        g, x, leg = ctx.saved_tensors
        grid, d, use_kernel = ctx.grid, ctx.order, ctx.use_kernel
        need_g, need_x, need_leg = ctx.needs_input_grad[:3]
        u, v = u.contiguous(), v.contiguous()
        gg = gx = gleg = None
        if need_g:
            gg = _Combine.apply(u, v, x, leg, grid, d, use_kernel)
        if need_x:
            gx = _x_gradient(grid, x, g, None if d == MAX_ORDER else (
                lambda: _Combine.apply(u, v, x, leg, grid, d + 1,
                                       use_kernel)))
        if need_leg:
            gleg = g[:, None, :] * _Points.apply(u, v, x, grid, d,
                                                 use_kernel)
        return gg, gx, gleg, None, None, None


class _Points(torch.autograd.Function):
    """P_d(y, m, x), G = 1."""

    @staticmethod
    def forward(y, m, x, grid, order, use_kernel):
        return combine_points(grid, y, m, x, order=order,
                              use_kernel=use_kernel)

    @staticmethod
    def setup_context(ctx, inputs, output):
        y, m, x, grid, order, use_kernel = inputs
        ctx.save_for_backward(y, m, x)
        ctx.grid, ctx.order, ctx.use_kernel = grid, order, use_kernel

    @staticmethod
    def backward(ctx, gbar):
        y, m, x = ctx.saved_tensors
        grid, d, use_kernel = ctx.grid, ctx.order, ctx.use_kernel
        need_y, need_m, need_x = ctx.needs_input_grad[:3]
        gbar = gbar.contiguous()
        gy = gm = gx = None
        if need_y or need_m:
            ones = torch.ones(x.shape, dtype=x.dtype, device=x.device)
            gy, gm = _Transpose.apply(ones, x, gbar, grid, d, use_kernel)
        if need_x:
            gx = _x_gradient(grid, x, 1.0, None if d == MAX_ORDER else (
                lambda: _Combine.apply(y, m, x, gbar, grid, d + 1,
                                       use_kernel)))
        return (gy if need_y else None, gm if need_m else None, gx,
                None, None, None)


def spline_legendre_combine(grid, y, m, x, leg, *, group=1,
                            use_kernel=True):
    """Fused evaluate-and-combine F_0 for B rows (arguments as
    `combine_forward`), differentiable: when grad mode is on and an input
    requires grad it goes through the autograd Functions, whose forward
    and backwards are the kernels on CUDA tensors. The Functions take
    G = 1 only, so a combine with row groups (G > 1) that needs a gradient
    runs as one Function call per coordinate row, its G rows reading that
    row with stride 0: B / G launches of each kernel instead of one, and
    the gradients to x and leg summed over each group by autograd."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (y, m, x, leg)):
        if group == 1:
            return _Combine.apply(y, m, x, leg, grid, 0, use_kernel)
        _check(grid, y, m, x, leg, group)
        n_ell, n_q = y.shape[1], x.shape[1]
        return torch.cat([
            _Combine.apply(y[i * group:(i + 1) * group],
                           m[i * group:(i + 1) * group],
                           x[i:i + 1].expand(group, n_q),
                           leg[i:i + 1].expand(group, n_ell, n_q),
                           grid, 0, use_kernel)
            for i in range(x.shape[0])])
    return combine_forward(grid, y, m, x, leg, group=group,
                           use_kernel=use_kernel)

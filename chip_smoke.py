#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (vega_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port end to end at the full width of the synthetic auto+cross
configuration, with no JAX:

1. requires CUDA and prints the card's name and power limit;
2. builds the CUDA kernel from the checkout's sources (nvcc);
3. the dense path: make_synthetic_dataset(cross=True, size='full') with
   the port, then VegaInterface(..., device='cuda') built with
   VEGA_TPU_FACTORED=0: chi^2 at the defaults (< 1e-6), chi2_batch on
   8192 rows of (ap, at, bias_LYA, beta_LYA) drawn as bench.py draws them
   (finite; the kernel launched), the kernel path against use_kernel=False
   (1e-10 relative), the JAX goldens of tests/data/torch_port_goldens.json
   (1e-8 relative), and evals/s;
4. the grid path, bench.py's regime: the same configuration with the
   defaults (32 x 32 Chebyshev nodes over ap, at in [0.75, 1.25]): the
   collapse (device node sweep through the kernel, host payload build;
   both timed), chi2_batch on the 8192 drawn rows (finite, no penalty),
   the JAX grid goldens of tests/data/torch_port_grid_goldens.json
   (|d chi2| <= 2e-4 + 1e-9 |chi2| against the JAX grid chi^2, and within
   the JAX package's own max |grid - dense| + 2e-4 of its dense chi^2),
   evals/s at batch 8192 and 32768 (median of 5 rounds, each fetching the
   result to the host, as bench.py:207-221; each round's host issue time
   beside its total), printed in bench.py's JSON shape, and a
   torch.profiler breakdown of one chi2_batch(8192);
5. the fit, on the same configuration with (ap, at, bias_LYA, beta_LYA)
   sampled from the start of tests/data/torch_port_fit_goldens.json:
   - the grid regime (the defaults): chi2_value_and_gradient and
     chi2_hessian at the goldens' points against the JAX grid goldens,
     and minimize() against the JAX grid fit;
   - the dense regime (VEGA_TPU_FACTORED=0): the same against the JAX
     dense goldens, the same calls with use_kernel=True against
     use_kernel=False (1e-10 relative in gradients, 1e-9 in Hessians),
     and minimize() against the JAX dense fit; it fails unless the dense
     fit launched the transpose kernel and a kernel of order d >= 1.

Each path runs with the kernels' launch counts set to 0 just before it,
and fails if the forward kernel was not launched. Every kernel launch a
path makes (the forward F_d, the no-sum mode P_d and the transpose Ft_d
of csrc/spline_legendre_combine.cu, with d its derivative order) is
recorded with its layout (B, G, coordinate rows, M, shared coordinates)
and counted as it runs (ops.spline_combine.recorded_launches); right
after, each kernel is held against its plain PyTorch version at each of
those layouts (random tables, about 5% of the queries outside the knot
range), max|diff| <= 1e-12 max|ref|, the transpose also bit for bit
against a second launch. Each layout is timed: the kernel's device time
(launches queued behind a spin kernel), one wrapper call and the plain
version (CUDA events), beside the layout's bytes and bound (HBM bytes at
3.35 TB/s) and its launches in the path's run. After the dense path,
every kernel (d = 0..3) is held the same way at edge layouts: every
query on a knot, every query in one interval, M not a multiple of the
tile, B = 1 with M = 1, a row with every query out of range. Any failure
exits non-zero.
tests/tools/compare_combine_designs.py reads the layouts off the kernels'
JSON record to time another checkout's kernels against these in turns.
The last three lines of standard output are the kernels' JSON record,
the nvidia-smi line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_goldens.json'
GRID_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_grid_goldens.json'
FIT_GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_fit_goldens.json'

KERNEL_TOL = 1e-12      # max|kernel - plain| <= KERNEL_TOL * max|plain|
CALL_REPEATS = 7        # a wrapper call's time: median of 7 means of 20
PLAIN_RTOL = 1e-10      # chi2_batch, kernel path vs plain path
GOLDEN_RTOL = 1e-8      # chi2_batch vs the JAX package's dense chi^2
DEFAULT_CHI2_MAX = 1e-6
BATCH = 8192
TIMED_ROUNDS = 3
# grid chi^2 vs the JAX grid chi^2: vega_tpu's default per-correlation
# mode budget, plus round-off of the chi^2 itself
GRID_ABS_TOL = 2e-4
GRID_REL_TOL = 1e-9
GRID_BATCHES = (8192, 32768)
GRID_ROUNDS = 5          # bench.py's median of 5
# the fit phase, against the JAX fit goldens (relative to the largest
# entry of each chi^2, gradient or Hessian). The grid path serves the
# port's own payload, held to the JAX one within the 2e-4 chi^2 mode
# budget; the dense path differs from the JAX package's by round-off.
FIT_GRID_RTOL = 1e-6
FIT_DENSE_RTOL = 1e-8
KERNEL_GRAD_RTOL = 1e-10     # use_kernel=True vs False, gradients
KERNEL_HESS_RTOL = 1e-9      # and Hessians
# best fits: |d value| <= FIT_VALUE_SIGMA x the JAX error, errors within
# FIT_ERROR_RTOL, |d fval| <= FIT_FVAL_ABS
FIT_VALUE_SIGMA = {'grid': 1e-2, 'dense': 1e-3}
FIT_ERROR_RTOL = {'grid': 1e-3, 'dense': 1e-5}
FIT_FVAL_ABS = {'grid': GRID_ABS_TOL, 'dense': 1e-8}


def fail(message):
    raise SystemExit(f'chip_smoke FAILED: {message}')


def log(message):
    print(message, flush=True)


def card_line():
    """`nvidia-smi --query-gpu=name,power.limit` for the card in use."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    lines = [line.strip() for line in out.splitlines() if line.strip()]
    index = torch.cuda.current_device()
    return lines[index] if index < len(lines) else lines[0]


def cuda_time_ms(fn, iters, repeats=1):
    """Time per call of fn() in ms, from CUDA events around `iters` calls
    after one warm call (the host's issue time included where it is the
    longer); the median of `repeats` such means."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(stop) / iters)
    return float(np.median(means))


# ----------------------------------------------------------------------
def build_kernels():
    from vega_tpu_torch.ops._build import load_library
    t0 = time.perf_counter()
    built = load_library()
    log(f'build: {built.path.name} '
        f'({"compiled" if built.built else "found on disk"}) in '
        f'{time.perf_counter() - t0:.2f} s')
    for line in built.log.splitlines():
        if ('registers' in line or 'smem' in line or 'spill' in line
                or 'Compiling entry' in line):
            log(f'  ptxas: {line.strip()}')
    return built


def random_case(rng, device, grid, layout):
    """Random inputs of one recorded launch layout: tables with their
    not-a-knot second derivatives, queries with about 5% outside the
    knot range, Legendre weights (or the transpose's g) in [-1, 1];
    shared rows with row stride 0."""
    from vega_tpu_torch.ops.spline import notaknot_second_derivative_matrix
    n_b, n_ell, n_knots, group, n_x, n_q, x_shared, leg_shared = layout
    logr = grid.values
    span = logr[-1] - logr[0]

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    y_np = rng.normal(size=(n_b, n_ell, n_knots))
    y = tensor(y_np)
    m = tensor(y_np @ notaknot_second_derivative_matrix(logr).T)
    x = tensor(rng.uniform(logr[0] - 0.025 * span, logr[-1] + 0.025 * span,
                           (1 if x_shared else n_x, n_q))).expand(n_x, n_q)
    leg = tensor(rng.uniform(-1, 1, (1 if leg_shared else n_x, n_ell,
                                     n_q))).expand(n_x, n_ell, n_q)
    g = tensor(rng.uniform(-1, 1, (n_b, n_q)))
    return y, m, x, leg, g


def device_ms(fn, iters, spin_cycles=50_000_000):
    """Mean device time per call of fn() in ms: CUDA events around
    `iters` calls queued behind a spin kernel (torch.cuda._sleep) that
    holds the stream while the host queues them, so they run back to back
    on the device with no host time between them (one warm call first).
    The spin doubles until it outlasts the host's queueing."""
    fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(6):
        torch.cuda.synchronize()
        events[0].record()
        torch.cuda._sleep(spin_cycles)
        events[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        events[2].record()
        torch.cuda.synchronize()
        if events[0].elapsed_time(events[1]) > host_ms:
            break
        spin_cycles *= 2
    return events[1].elapsed_time(events[2]) / iters


def kernel_call(primitive, order, grid, group, y, m, x, leg, g):
    """run(use_kernel) -> the outputs of one primitive, as a tuple."""
    from vega_tpu_torch.ops import spline_combine as sc
    if primitive == 'F':
        return lambda use_kernel: (sc.combine_forward(
            grid, y, m, x, leg, order=order, group=group,
            use_kernel=use_kernel),)
    if primitive == 'P':
        return lambda use_kernel: (sc.combine_points(
            grid, y, m, x, order=order, group=group,
            use_kernel=use_kernel),)
    return lambda use_kernel: sc.combine_transpose(
        grid, g, x, leg, order=order, use_kernel=use_kernel)


def hold(run, primitive, label):
    """The kernel against its plain version, max|diff| <= KERNEL_TOL
    max|ref|; the transpose also bit for bit against a second launch.
    Returns (max|diff|, max|ref|)."""
    out, ref = run(True), run(False)
    torch.cuda.synchronize()
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    scale = max(float(r.abs().max()) for r in ref)
    if not err <= KERNEL_TOL * scale:
        fail(f'kernel disagrees with its plain version ({label}): '
             f'max|diff| {err:.3e} > {KERNEL_TOL:g} x {scale:.3e}')
    if primitive == 'Ft':
        again = run(True)
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            fail(f'two launches of the transpose differ ({label}): it is '
                 'meant to be bitwise reproducible')
    return err, scale


def layout_label(primitive, order, layout):
    n_b, n_ell, n_knots, group, n_x, n_q, x_shared, leg_shared = layout
    return (f'{primitive}_{order} B={n_b} L={n_ell} N={n_knots} G={group} '
            f'M={n_q}, {n_x} coordinate row(s)'
            f'{" (x stride 0)" if x_shared else ""}'
            f'{" (leg stride 0)" if leg_shared else ""}')


def check_launches(device, path, layouts):
    """Hold each kernel against its plain version at every launch layout
    a path recorded, on the path's knot grid (random inputs,
    `random_case`; `hold`), and time it: `ms` its device time per launch
    (`device_ms`), `call_ms` one wrapper call on CUDA events with the
    host's issue time (median of CALL_REPEATS means of 20 calls),
    `plain_ms` the plain version (a mean of 5 calls). Beside them
    the layout's launches in the path's run, its bytes and bound
    (spline_combine.launch_bound: HBM bytes at 3.35 TB/s bound every
    layout) and the share of the bound the kernel reaches. Returns one
    record per layout, largest B * M first, with its knot range (the grid
    is uniform: first and last knot and N give it)."""
    from vega_tpu_torch.ops.spline_combine import launch_bound, launch_bytes

    rng = np.random.default_rng(0)
    records = []
    for key in sorted(layouts, key=lambda k: (k[0], k[1], -k[2] * k[7])):
        primitive, order, *layout = key
        grid, launches = layouts[key].grid, layouts[key].launches
        y, m, x, leg, g = random_case(rng, device, grid, layout)
        group = layout[3]
        run = kernel_call(primitive, order, grid, group, y, m, x, leg, g)
        label = f'{path} {layout_label(primitive, order, layout)}'
        err, scale = hold(run, primitive, label)
        plain_ms = cuda_time_ms(lambda: run(False), 5)
        call_ms = cuda_time_ms(lambda: run(True), 20, CALL_REPEATS)
        ms = device_ms(lambda: run(True), 20)
        bound_ms, bound_by = launch_bound(primitive, order, *layout)
        n_b, _, _, _, n_x, n_q, x_shared, leg_shared = layout
        log(f'kernel check {label}: max|diff| {err:.3e} (max|ref| '
            f'{scale:.3e}); kernel {ms:.4f} ms on the device (a call '
            f'{call_ms:.4f} ms), plain {plain_ms:.4f} ms, bound '
            f'{bound_ms:.5f} ms ({bound_by}, {bound_ms / ms:.1%}), '
            f'{launches} launches in the run')
        records.append({'path': path, 'primitive': primitive,
                        'order': order, 'B': n_b, 'G': group,
                        'coordinate_rows': n_x, 'M': n_q,
                        'x_shared': x_shared, 'leg_shared': leg_shared,
                        'layout': list(layout),
                        'knots': [float(grid.values[0]),
                                  float(grid.values[-1])],
                        'launches': launches,
                        'max_abs_err': err, 'max_abs_ref': scale,
                        'ms': ms, 'call_ms': call_ms,
                        'plain_ms': plain_ms,
                        'bytes': launch_bytes(primitive, order, *layout),
                        'bound_ms': bound_ms, 'bound_by': bound_by,
                        'share_of_bound': bound_ms / ms})
    return records


def edge_cases(rng, device, grid, n_ell):
    """Layouts that corner the kernels, on `grid`, as [(label, layout,
    (y, m, x, leg, g))] with per-row coordinates: every query on a knot
    (both ends included), every query in one interval (the transpose's
    longest run), M not a multiple of the tile (odd and even M), B = 1
    with M = 1, and a row with every query out of range (half below,
    half above)."""
    knots = grid.values
    n_knots = len(knots)
    span = knots[-1] - knots[0]

    def uniform(n_b, n_q):
        return rng.uniform(knots[0], knots[-1], (n_b, n_q))

    on_knots = knots[rng.integers(0, n_knots, (2, 3000))]
    on_knots[:, :2] = knots[0], knots[-1]
    mid = n_knots // 2
    out_of_range = uniform(3, 2000)
    out_of_range[1] = np.where(
        rng.random(2000) < 0.5,
        knots[0] - rng.uniform(1e-3, 0.1, 2000) * span,
        knots[-1] + rng.uniform(1e-3, 0.1, 2000) * span)
    coords = [('every query on a knot', on_knots),
              ('every query in one interval',
               rng.uniform(knots[mid], knots[mid + 1], (2, 3000))),
              ('M not a multiple of the tile (odd M)', uniform(3, 5001)),
              ('M not a multiple of the tile (even M)',
               uniform(150, 2000)),
              ('B = 1, M = 1', uniform(1, 1)),
              ('a row with every query out of range', out_of_range)]
    cases = []
    for label, x_np in coords:
        n_b, n_q = x_np.shape
        layout = (n_b, n_ell, n_knots, 1, n_b, n_q, False, False)
        y, m, _, leg, g = random_case(rng, device, grid, layout)
        x = torch.as_tensor(x_np, dtype=torch.float64, device=device)
        cases.append((label, layout, (y, m, x, leg, g)))
    return cases


def check_edge_layouts(device, grid, n_ell):
    """Every kernel (F_d, P_d, Ft_d, d = 0..3) against its plain version
    at each of `edge_cases`; the transpose also bit for bit against a
    second launch. Returns one record per kernel and case."""
    rng = np.random.default_rng(1)
    records = []
    for label, layout, inputs in edge_cases(rng, device, grid, n_ell):
        worst = 0.0
        for primitive in ('F', 'P', 'Ft'):
            for order in range(4):
                run = kernel_call(primitive, order, grid, 1, *inputs)
                err, scale = hold(run, primitive, f'edge layout {label}, '
                                  f'{layout_label(primitive, order, layout)}')
                worst = max(worst, err / scale if scale else err)
                records.append({'path': 'edge', 'case': label,
                                'primitive': primitive, 'order': order,
                                'layout': list(layout), 'max_abs_err': err,
                                'max_abs_ref': scale})
        log(f'edge layout {label} (B={layout[0]}, M={layout[5]}): F_d, P_d, '
            f'Ft_d (d = 0..3) agree with their plain versions, worst '
            f'max|diff| / max|ref| {worst:.3e}; Ft_d bitwise reproducible')
    return records


@contextlib.contextmanager
def switch(name, value):
    """Set (or with None, unset) an environment switch the interface reads
    at construction, restoring it afterwards."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def draw_batch(n_rows):
    """(bias_LYA, beta_LYA, ap, at) rows as bench.py:186-192 draws them."""
    sampled = {'bias_LYA': -0.117, 'beta_LYA': 1.67, 'ap': 1.0, 'at': 1.0}
    rng = np.random.default_rng(0)
    return {name: val + 0.01 * np.abs(val) * rng.normal(size=n_rows)
            for name, val in sampled.items()}


def run_dense_path(device, main_ini):
    """The dense path (VEGA_TPU_FACTORED=0) on the full configuration;
    returns the kernel launches of its run, the kernel checks at its
    layouts and its knot grid."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.vega_interface import CHUNK_ROWS, VegaInterface

    t0 = time.perf_counter()
    with switch('VEGA_TPU_FACTORED', '0'):
        vega = VegaInterface(main_ini, device=device)
    log(f'dense path: interface in {time.perf_counter() - t0:.2f} s; bins '
        + ', '.join(f'{n} {d.full_data_size} ({d.data_size} unmasked)'
                    for n, d in vega.data.items()))
    batches = draw_batch(BATCH)

    # the dense path's run: counts from zero
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        chi2_default = vega.chi2()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        chi2 = vega.chi2_batch(batches)
        torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    records = check_launches(device, 'dense', layouts)

    log(f'chi2 at the defaults: {chi2_default!r}')
    if not abs(chi2_default) < DEFAULT_CHI2_MAX:
        fail(f'chi2 at the defaults {chi2_default!r} >= {DEFAULT_CHI2_MAX}')
    chi2_np = chi2.cpu().numpy()
    if chi2_np.shape != (BATCH,) or not np.all(np.isfinite(chi2_np)):
        fail('chi2_batch is not finite of shape (8192,)')
    if np.any(chi2_np >= 1e100):
        fail(f'{int(np.sum(chi2_np >= 1e100))} rows took the penalty')
    expected = len(vega.models) * 2 * (-(-BATCH // CHUNK_ROWS) + 1)
    log(f'chi2_batch({BATCH}): first call {first_s:.3f} s, peak device '
        f'memory {peak_gb:.2f} GB, chi2 in [{chi2_np.min():.6g}, '
        f'{chi2_np.max():.6g}], kernel launches {launches} '
        f'(expected {expected} of F_0)')
    if not launches.get(('F', 0)):
        fail('the dense path launched no spline_legendre_combine kernel')

    plain = vega.chi2_batch(batches, use_kernel=False).cpu().numpy()
    rel = float(np.max(np.abs(plain - chi2_np) / np.abs(plain)))
    log(f'kernel path vs plain path: max relative diff {rel:.3e}')
    if not rel <= PLAIN_RTOL:
        fail(f'kernel path vs plain path differ by {rel:.3e} > {PLAIN_RTOL}')

    goldens = json.loads(GOLDENS.read_text())
    got = vega.chi2_batch(goldens['params']).cpu().numpy()
    want = np.asarray(goldens['chi2'])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    log(f'vs JAX goldens ({len(want)} points): max relative diff {rel:.3e}')
    if not rel <= GOLDEN_RTOL:
        fail(f'chi2 vs the JAX goldens differ by {rel:.3e} > {GOLDEN_RTOL}')

    for use_kernel in (True, False):
        times = []
        for _ in range(TIMED_ROUNDS):
            for name in batches:
                batches[name] = batches[name] + 1e-6
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            vega.chi2_batch(batches, use_kernel=use_kernel)
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        log(f'chi2_batch({BATCH}) {"kernel" if use_kernel else "plain"} '
            f'path: {BATCH / np.median(times):.1f} evals/s '
            f'(median of {TIMED_ROUNDS}, s per call '
            f'{", ".join(f"{t:.4f}" for t in times)})')
    return launches, records, next(iter(layouts.values())).grid


def profile_chi2(vega, batches, device):
    """torch.profiler over one warm chi2_batch: device kernel time, the
    span from the first kernel's start to the last one's end, and the
    top kernels by time."""
    from torch.profiler import ProfilerActivity, profile
    vega.chi2_batch(batches)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vega.chi2_batch(batches).cpu()
        torch.cuda.synchronize(device)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log('profile: no device events recorded (not measured)')
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span_ms = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) / 1e3
    log(f'profile chi2_batch({len(next(iter(batches.values())))}): '
        f'{len(kernels)} kernels, {busy_ms:.4f} ms of kernel time in a '
        f'{span_ms:.4f} ms span')
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, [0, 0.0])
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    for name, (count, ms) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:8]:
        log(f'  {ms:9.4f} ms  x{count:<4d} {name[:90]}')


def run_grid_path(device, main_ini, card):
    """bench.py's regime: the grid collapse on the full configuration
    with its defaults; returns the kernel launches of its run and the
    kernel checks at its layouts."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(GRID_GOLDENS.read_text())
    names = frozenset(['ap', 'at', 'bias_LYA', 'beta_LYA'])
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        vega = VegaInterface(main_ini, device=device)
    batches = draw_batch(BATCH)

    # the grid path's run: counts from zero
    LAUNCHES.clear()
    with recorded_launches() as layouts:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        payload = vega.get_collapsed(names)
        torch.cuda.synchronize(device)
        collapse_s = time.perf_counter() - t0
        sweep_launches = LAUNCHES[('F', 0)]
        chi2 = vega.chi2_batch(batches).cpu().numpy()
    launches = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    records = check_launches(device, 'grid', layouts)

    spec = payload['__grid__']
    stats = vega.grid_stats
    log(f'grid collapse: {spec}, {stats["nodes"]} nodes; chi^2 constants '
        f'(host inverse covariances) {stats["constants_s"]:.3f} s, device '
        f'sweep {stats["sweep_s"]:.3f} s, host payload build '
        f'{stats["host_s"]:.3f} s, total {collapse_s:.3f} s; kernel '
        f'launches {sweep_launches} in the sweep, {launches} in the run; '
        f'peak device memory {peak_gb:.3f} GB')
    for name in vega.corr_items:
        if name not in payload:
            fail(f'{name} is not served by the grid payload')
        p = payload[name]
        want = goldens['payload'][name]
        log(f'  {name}: T = {p["cref"].shape[0]}, retained modes '
            f'A {p["modes_A"].shape[1]} / sy {p["modes_sy"].shape[1]}, '
            f'SVD rank A {p["B_A"].shape[1]} / sy {p["B_sy"].shape[1]} '
            f'(JAX package: modes {want["modes_A"]} / {want["modes_sy"]}, '
            f'rank {want["rank_A"]} / {want["rank_sy"]}), dc_max '
            f'{float(p["dc_max"]):.6g}')
    if sweep_launches == 0:
        fail('the grid sweep launched no spline_legendre_combine kernel')
    if chi2.shape != (BATCH,) or not np.all(np.isfinite(chi2)):
        fail(f'grid chi2_batch is not finite of shape ({BATCH},)')
    if np.any(chi2 >= 1e100):
        fail(f'{int(np.sum(chi2 >= 1e100))} grid rows took the penalty')
    log(f'grid chi2_batch({BATCH}): chi2 in [{chi2.min():.6g}, '
        f'{chi2.max():.6g}]')

    got = vega.chi2_batch(goldens['params']).cpu().numpy()
    want_grid = np.asarray(goldens['chi2_grid'])
    want_dense = np.asarray(goldens['chi2_dense'])
    d_grid = np.abs(got - want_grid)
    bound = GRID_ABS_TOL + GRID_REL_TOL * np.abs(want_grid)
    log(f'vs JAX grid goldens ({len(got)} points): max |d chi2| '
        f'{d_grid.max():.3e} (bound {bound.min():.3e} .. {bound.max():.3e})')
    if not np.all(d_grid <= bound):
        fail(f'grid chi2 vs the JAX grid chi2: |d| {d_grid.max():.3e} '
             'over the bound')
    dense_bound = goldens['max_abs_grid_minus_dense'] + GRID_ABS_TOL
    d_dense = float(np.max(np.abs(got - want_dense)))
    log(f'vs JAX dense chi2: max |d chi2| {d_dense:.6g} (bound '
        f'{dense_bound:.6g}: the JAX grid path\'s own + {GRID_ABS_TOL:g})')
    if not d_dense <= dense_bound:
        fail(f'grid chi2 vs the JAX dense chi2: {d_dense:.6g} > '
             f'{dense_bound:.6g}')

    rates = {}
    for n_rows in GRID_BATCHES:
        rows = draw_batch(n_rows)
        vega.chi2_batch(rows).cpu()
        per_round, host_ms, total_ms = [], [], []
        for _ in range(GRID_ROUNDS):
            for name in rows:
                rows[name] = rows[name] + 1e-6     # as bench.py
            t0 = time.perf_counter()
            out = vega.chi2_batch(rows)
            t1 = time.perf_counter()       # the host has issued the call
            out.cpu()
            t2 = time.perf_counter()
            per_round.append(n_rows / (t2 - t0))
            host_ms.append(1e3 * (t1 - t0))
            total_ms.append(1e3 * (t2 - t0))
        rates[n_rows] = float(np.median(per_round))
        log(f'grid chi2_batch({n_rows}): {rates[n_rows]:.1f} evals/s '
            f'(median of {GRID_ROUNDS}; per round '
            f'{", ".join(f"{r:.1f}" for r in per_round)}); ms per round, '
            f'host issue / with the result fetched: '
            + ', '.join(f'{h:.3f} / {t:.3f}'
                        for h, t in zip(host_ms, total_ms)))
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(f'grid path peak device memory (collapse and both batches): '
        f'{peak_gb:.3f} GB')
    log(json.dumps({
        'metric': 'likelihood evals/sec/chip',
        'value': round(rates[BATCH], 3),
        'unit': f'evals/s/chip (batch={BATCH}, f64, 1 chip(s), {card}, '
                f'vega_tpu_torch, collapse={collapse_s:.1f}s; batch '
                f'{GRID_BATCHES[1]}: {rates[GRID_BATCHES[1]]:.1f})'}))
    profile_chi2(vega, draw_batch(BATCH), device)
    return launches, records


def rel_err(got, want):
    """max|got - want| / max|want|."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def derivatives_at(device, vega, points, names, label, use_kernel=True):
    """chi^2, gradient and Hessian at each point, laid out as the fit
    goldens keep them; logs the wall time of each call (synchronised),
    the first one's included."""
    out = {'chi2': [], 'gradient': [], 'hessian': []}
    times = {'value+gradient': [], 'Hessian': []}
    for point in points:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        value, grad = vega.chi2_value_and_gradient(point,
                                                   use_kernel=use_kernel)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        hess = vega.chi2_hessian(point, names, use_kernel=use_kernel)
        torch.cuda.synchronize(device)
        times['value+gradient'].append(t1 - t0)
        times['Hessian'].append(time.perf_counter() - t1)
        out['chi2'].append(value)
        out['gradient'].append([grad[n] for n in names])
        out['hessian'].append([[hess[a][b] for b in names] for a in names])
    log(f'{label}: derivatives at {len(points)} points, s per call: '
        + '; '.join(f'{kind} ' + ', '.join(f'{t:.4f}' for t in ts)
                    for kind, ts in times.items()))
    return out


def compare_derivatives(label, got, want, rtols):
    """Worst relative difference of each part over the points; fails
    above its bound. rtols: {part: bound}."""
    worst = {part: max(rel_err(g, w) for g, w in zip(got[part], want[part]))
             for part in rtols}
    log(f'{label}: max relative diff '
        + ', '.join(f'{part} {worst[part]:.3e} (bound {rtols[part]:g})'
                    for part in rtols))
    for part, bound in rtols.items():
        if not worst[part] <= bound:
            fail(f'{label}: {part} differs by {worst[part]:.3e} > {bound:g}')


def counted(fn, counts, key):
    def wrapper(*args, **kwargs):
        counts[key] += 1
        return fn(*args, **kwargs)
    return wrapper


def timed_fit(device, vega, label):
    """minimize() with its value+gradient and Hessian calls counted;
    returns the wall time in s and the counts."""
    counts = {'value_and_gradient': 0, 'hessian': 0, 'chi2': 0}
    mini = vega.minimizer
    mini.valgrad_func = counted(mini.valgrad_func, counts,
                                'value_and_gradient')
    mini.hess_func = counted(mini.hess_func, counts, 'hessian')
    mini.chi2_func = counted(mini.chi2_func, counts, 'chi2')
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    vega.minimize()
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    log(f'{label} fit: {seconds:.3f} s wall, {counts["value_and_gradient"]} '
        f'value+gradient calls (L-BFGS-B, Newton polish, EDM), '
        f'{counts["hessian"]} Hessians, {counts["chi2"]} chi^2 calls')
    return seconds, counts


def check_fit(label, regime, vega, names, want):
    """The port's fit against the JAX package's from the same start."""
    best = vega.bestfit
    d_sigma = max(abs(best.values[n] - v) / e for n, v, e in
                  zip(names, want['values'], want['errors']))
    d_err = max(abs(best.errors[n] / e - 1) for n, e in
                zip(names, want['errors']))
    d_fval = abs(best.fmin.fval - want['fval'])
    log(f'{label} fit vs JAX: values {[best.values[n] for n in names]} '
        f'(JAX {want["values"]}), max |d value| / error {d_sigma:.3e}, '
        f'errors max relative diff {d_err:.3e}, fval {best.fmin.fval!r} '
        f'(JAX {want["fval"]!r}), edm {best.fmin.edm:.3e}')
    if not (best.fmin.is_valid and not best.fmin.hesse_failed):
        fail(f'{label} fit is not valid')
    if not d_sigma <= FIT_VALUE_SIGMA[regime]:
        fail(f'{label} best fit differs from the JAX fit by {d_sigma:.3e} '
             f'errors > {FIT_VALUE_SIGMA[regime]:g}')
    if not d_err <= FIT_ERROR_RTOL[regime]:
        fail(f'{label} errors differ by {d_err:.3e} relative > '
             f'{FIT_ERROR_RTOL[regime]:g}')
    if not d_fval <= FIT_FVAL_ABS[regime]:
        fail(f'{label} fval differs by {d_fval:.3e} > '
             f'{FIT_FVAL_ABS[regime]:g}')


def run_fit_path(device, work):
    """The fit on the full configuration with (ap, at, bias_LYA,
    beta_LYA) sampled, in the grid regime (the defaults) and the dense
    regime (VEGA_TPU_FACTORED=0), against the JAX fit goldens; returns
    the kernel launches of each regime's run and the kernel checks at
    their layouts."""
    from vega_tpu_torch.ops.spline_combine import (LAUNCHES,
                                                   recorded_launches)
    from vega_tpu_torch.testing import make_synthetic_dataset
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(FIT_GOLDENS.read_text())
    names, points = goldens['names'], goldens['points']
    t0 = time.perf_counter()
    fit_ini = make_synthetic_dataset(Path(work) / 'fit', cross=True,
                                     size='full', device=device,
                                     sample=goldens['sample'])
    log(f'fit: configuration sampling {goldens["sample"]} in '
        f'{time.perf_counter() - t0:.2f} s')
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        grid_vega = VegaInterface(fit_ini, device=device)
    with switch('VEGA_TPU_FACTORED', '0'):
        dense_vega = VegaInterface(fit_ini, device=device)

    launches = {}
    # each regime's run: counts from zero, layouts of its own
    LAUNCHES.clear()
    with recorded_launches() as grid_layouts:
        grid = derivatives_at(device, grid_vega, points, names,
                              'fit grid regime (the first call builds '
                              'the payload)')
        compare_derivatives(
            'fit grid regime vs JAX grid goldens', grid, goldens['grid'],
            dict.fromkeys(('chi2', 'gradient', 'hessian'), FIT_GRID_RTOL))
        timed_fit(device, grid_vega, 'grid')
        check_fit('grid', 'grid', grid_vega, names, goldens['fit_grid'])
    launches['fit_grid'] = dict(LAUNCHES)

    LAUNCHES.clear()
    with recorded_launches() as dense_layouts:
        dense = derivatives_at(device, dense_vega, points, names,
                               'fit dense regime')
        compare_derivatives(
            'fit dense regime vs JAX dense goldens', dense, goldens['dense'],
            dict.fromkeys(('chi2', 'gradient', 'hessian'), FIT_DENSE_RTOL))
        timed_fit(device, dense_vega, 'dense')
        check_fit('dense', 'dense', dense_vega, names, goldens['fit_dense'])
    launches['fit_dense'] = dict(LAUNCHES)
    # the plain route, for comparison: it launches nothing
    plain = derivatives_at(device, dense_vega, points, names,
                           'fit dense regime, plain combine',
                           use_kernel=False)
    compare_derivatives('fit dense regime, kernels vs plain combine', dense,
                        plain, {'chi2': KERNEL_GRAD_RTOL,
                                'gradient': KERNEL_GRAD_RTOL,
                                'hessian': KERNEL_HESS_RTOL})

    log(f'fit kernel launches: {launches}')
    dense_run = launches['fit_dense']
    if not any(n for (primitive, _), n in dense_run.items()
               if primitive == 'Ft'):
        fail('the dense fit launched no transpose kernel (Ft_d)')
    if not any(n for (_, order), n in dense_run.items() if order >= 1):
        fail('the dense fit launched no kernel of order d >= 1')
    return launches, (check_launches(device, 'fit_grid', grid_layouts)
                      + check_launches(device, 'fit_dense', dense_layouts))


# (name, primitive, orders, the TPU code it replaces: file:line, and
# which part of it)
FORWARD = ('vega_tpu/ops/pallas_spline.py:186',
           'spline_legendre_combine_batched (and :123)')
BACKWARD = ('vega_tpu/ops/pallas_spline.py:233',
            'the backward of make_vmappable_combine (custom_vjp :278-290)')
KERNELS = (
    ('spline_legendre_combine F_0', 'F', (0,), FORWARD),
    ('spline_legendre_combine F_d, d = 1..3', 'F', (1, 2, 3), BACKWARD),
    ('spline_legendre_combine P_d (no-sum mode)', 'P', (0, 1, 2, 3),
     BACKWARD),
    ('spline_legendre_combine_transpose Ft_d', 'Ft', (0, 1, 2, 3),
     BACKWARD),
)


def kernel_records(launches, checks, edge_checks):
    """The kernels' JSON record: per kernel its launches by path and by
    order, its worst error against its plain version (recorded and edge
    layouts), ms / plain_ms / bound_ms at its largest checked layout
    (B x M) and every checked layout. No single PyTorch call computes
    the combine or its transpose: library_ms is null."""
    out = []
    for name, primitive, orders, (replaces, part) in KERNELS:
        def mine(key):
            return key[0] == primitive and key[1] in orders
        by_path = {path: sum(n for key, n in counts.items() if mine(key))
                   for path, counts in launches.items()}
        by_order = {}
        for counts in launches.values():
            for key, n in counts.items():
                if mine(key):
                    by_order[key[1]] = by_order.get(key[1], 0) + n
        records = [r for r in checks
                   if mine((r['primitive'], r['order']))]
        edges = [r for r in edge_checks
                 if mine((r['primitive'], r['order']))]
        if not sum(by_path.values()) or not records:
            fail(f'{name}: no launch in any path')
        largest = max(records, key=lambda r: r['B'] * r['M'])
        out.append({
            'name': name, 'route': 'cuda',
            'source': 'vega_tpu_torch/csrc/spline_legendre_combine.cu',
            'replaces': replaces, 'replaces_part': part,
            'launches': sum(by_path.values()),
            'launches_by_path': by_path,
            'launches_by_order': {str(k): v
                                  for k, v in sorted(by_order.items())},
            'max_abs_err': max(r['max_abs_err'] for r in records + edges),
            'ms': largest['ms'], 'plain_ms': largest['plain_ms'],
            'bound_ms': largest['bound_ms'], 'bound_by': largest['bound_by'],
            'library_ms': None,
            'edge_layouts_checked': len(edges),
            'layouts': records})
    return out


def main():
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke test needs '
             'a GPU')
    import vega_tpu_torch  # noqa: F401  (fails outside a checkout)
    device = torch.device('cuda', torch.cuda.current_device())
    card = card_line()
    log(f'card: {card}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}, python {sys.version.split()[0]}')

    build_kernels()
    with tempfile.TemporaryDirectory() as work:
        from vega_tpu_torch.testing import make_synthetic_dataset
        t0 = time.perf_counter()
        main_ini = make_synthetic_dataset(work, cross=True, size='full',
                                          device=device)
        log(f'setup: synthetic full configuration in '
            f'{time.perf_counter() - t0:.2f} s')
        dense_launches, dense_checks, knot_grid = run_dense_path(
            device, main_ini)
        edge_checks = check_edge_layouts(device, knot_grid,
                                         dense_checks[0]['layout'][1])
        grid_launches, grid_checks = run_grid_path(device, main_ini, card)
        fit_launches, fit_checks = run_fit_path(device, work)

    checks = dense_checks + grid_checks + fit_checks
    kernels = kernel_records(
        {'dense': dense_launches, 'grid': grid_launches, **fit_launches},
        checks, edge_checks)
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()

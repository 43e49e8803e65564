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
   torch.profiler breakdown of one chi2_batch(8192).

Each path runs with the kernel's launch count set to 0 just before it,
and fails if the kernel was not launched. The layout of every call the
path makes to the spline + Legendre wrapper (B, G, coordinate rows, M,
shared coordinates) is recorded as it runs; right after, the kernel is
held against its plain PyTorch version at each of those layouts (random
tables, about 5% of the queries outside the knot range), max|diff| <=
1e-12 max|ref|, and both are timed with CUDA events. Any failure exits
non-zero.
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

KERNEL_TOL = 1e-12      # max|kernel - plain| <= KERNEL_TOL * max|plain|
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


def cuda_time_ms(fn, iters):
    """Mean device time of fn() in ms, from CUDA events around `iters`
    calls after one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ----------------------------------------------------------------------
def build_kernels():
    from vega_tpu_torch.ops._build import load_library
    t0 = time.perf_counter()
    built = load_library()
    log(f'build: {built.path.name} '
        f'({"compiled" if built.built else "found on disk"}) in '
        f'{time.perf_counter() - t0:.2f} s')
    for line in built.log.splitlines():
        if 'registers' in line or 'smem' in line or 'spill' in line:
            log(f'  ptxas: {line.strip()}')
    return built


@contextlib.contextmanager
def recorded_layouts():
    """While open, record the layout of every spline_legendre_combine
    call the port's PktoXi makes, as {(B, L, N, G, coordinate rows, M,
    coordinates shared): its knot grid}; each call then goes on to the
    wrapper unchanged, and the wrapper keeps the launch count."""
    from vega_tpu_torch import pktoxi
    combine, layouts = pktoxi.spline_legendre_combine, {}

    def recording(grid, y, m, x, leg, **kwargs):
        layouts.setdefault((*y.shape, kwargs.get('group', 1), *x.shape,
                            x.shape[0] > 1 and x.stride(0) == 0), grid)
        return combine(grid, y, m, x, leg, **kwargs)

    pktoxi.spline_legendre_combine = recording
    try:
        yield layouts
    finally:
        pktoxi.spline_legendre_combine = combine


def check_layouts(device, path, layouts):
    """Hold the kernel against its plain version at every layout a path
    gave it, on the path's knot grid (random tables; about 5% of the
    queries outside the knot range), max|diff| <= KERNEL_TOL max|ref|,
    and time both with CUDA events. Returns one record per layout,
    largest B * M first."""
    from vega_tpu_torch.ops.spline import notaknot_second_derivative_matrix
    from vega_tpu_torch.ops.spline_combine import spline_legendre_combine

    rng = np.random.default_rng(0)
    records = []
    for layout in sorted(layouts, key=lambda lay: -lay[0] * lay[5]):
        n_b, n_ell, n_knots, group, n_x, n_q, shared = layout
        grid = layouts[layout]
        logr = grid.values
        s_mat = notaknot_second_derivative_matrix(logr)
        span = logr[-1] - logr[0]
        y_np = rng.normal(size=(n_b, n_ell, n_knots))
        y = torch.as_tensor(y_np, dtype=torch.float64, device=device)
        m = torch.as_tensor(y_np @ s_mat.T, dtype=torch.float64,
                            device=device)
        rows = 1 if shared else n_x
        x = torch.as_tensor(rng.uniform(logr[0] - 0.025 * span,
                                        logr[-1] + 0.025 * span,
                                        (rows, n_q)),
                            dtype=torch.float64, device=device)
        leg = torch.as_tensor(rng.uniform(-1, 1, (rows, n_ell, n_q)),
                              dtype=torch.float64, device=device)
        x, leg = x.expand(n_x, n_q), leg.expand(n_x, n_ell, n_q)

        def run(use_kernel):
            return spline_legendre_combine(grid, y, m, x, leg, group=group,
                                           use_kernel=use_kernel)

        out, ref = run(True), run(False)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        label = (f'{path} path B={n_b} L={n_ell} N={n_knots} G={group} '
                 f'M={n_q}, {n_x} coordinate row(s)'
                 f'{" (stride 0)" if shared else ""}')
        if not err <= KERNEL_TOL * scale:
            fail(f'kernel disagrees with its plain version ({label}): '
                 f'max|diff| {err:.3e} > {KERNEL_TOL:g} x {scale:.3e}')
        plain_ms = cuda_time_ms(lambda: run(False), 5)
        kernel_ms = cuda_time_ms(lambda: run(True), 20)
        log(f'kernel check {label}: max|diff| {err:.3e} (max|ref| '
            f'{scale:.3e}); kernel {kernel_ms:.4f} ms, plain '
            f'{plain_ms:.4f} ms')
        records.append({'path': path, 'B': n_b, 'G': group,
                        'coordinate_rows': n_x, 'M': n_q, 'shared': shared,
                        'max_abs_err': err, 'ms': kernel_ms,
                        'plain_ms': plain_ms})
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
    returns the kernel launches of its run and the kernel checks at its
    layouts."""
    from vega_tpu_torch.ops.spline_combine import spline_legendre_combine
    from vega_tpu_torch.vega_interface import CHUNK_ROWS, VegaInterface

    t0 = time.perf_counter()
    with switch('VEGA_TPU_FACTORED', '0'):
        vega = VegaInterface(main_ini, device=device)
    log(f'dense path: interface in {time.perf_counter() - t0:.2f} s; bins '
        + ', '.join(f'{n} {d.full_data_size} ({d.data_size} unmasked)'
                    for n, d in vega.data.items()))
    batches = draw_batch(BATCH)

    # the dense path's run: counts from zero
    spline_legendre_combine.launches = 0
    with recorded_layouts() as layouts:
        chi2_default = vega.chi2()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        chi2 = vega.chi2_batch(batches)
        torch.cuda.synchronize(device)
        first_s = time.perf_counter() - t0
    launches = spline_legendre_combine.launches
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    records = check_layouts(device, 'dense', layouts)

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
        f'(expected {expected})')
    if launches == 0:
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
    return launches, records


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
    from vega_tpu_torch.ops.spline_combine import spline_legendre_combine
    from vega_tpu_torch.vega_interface import VegaInterface

    goldens = json.loads(GRID_GOLDENS.read_text())
    names = frozenset(['ap', 'at', 'bias_LYA', 'beta_LYA'])
    with switch('VEGA_TPU_FACTORED', None), \
            switch('VEGA_TPU_GRID_COLLAPSE', None):
        vega = VegaInterface(main_ini, device=device)
    batches = draw_batch(BATCH)

    # the grid path's run: counts from zero
    spline_legendre_combine.launches = 0
    with recorded_layouts() as layouts:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        payload = vega.get_collapsed(names)
        torch.cuda.synchronize(device)
        collapse_s = time.perf_counter() - t0
        sweep_launches = spline_legendre_combine.launches
        chi2 = vega.chi2_batch(batches).cpu().numpy()
    launches = spline_legendre_combine.launches
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    records = check_layouts(device, 'grid', layouts)

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
        dense_launches, dense_checks = run_dense_path(device, main_ini)
        grid_launches, grid_checks = run_grid_path(device, main_ini, card)

    # ms / plain_ms: the largest layout (B x M) of the dense path
    print(json.dumps({'kernels': [{
        'name': 'spline_legendre_combine', 'route': 'cuda',
        'source': 'vega_tpu_torch/csrc/spline_legendre_combine.cu',
        'replaces': 'vega_tpu/ops/pallas_spline.py:186',
        'launches': dense_launches + grid_launches,
        'launches_by_path': {'dense': dense_launches,
                             'grid': grid_launches},
        'max_abs_err': max(r['max_abs_err']
                           for r in dense_checks + grid_checks),
        'ms': dense_checks[0]['ms'], 'plain_ms': dense_checks[0]['plain_ms'],
        'layouts': dense_checks + grid_checks}]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()

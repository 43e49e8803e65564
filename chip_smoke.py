#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (vega_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's dense batched likelihood end to end at the full width
of the synthetic auto+cross configuration, with no JAX:

1. requires CUDA and prints the card's name and power limit;
2. builds the CUDA kernel from the checkout's sources (nvcc);
3. holds the spline + Legendre kernel against its plain PyTorch version
   at the main path's shapes (B = 256, L = 4, N = 814, M = 2500 and 5000;
   per-row and shared coordinates; queries outside the knot range),
   max|diff| <= 1e-12 max|ref|, and times both with CUDA events;
4. builds make_synthetic_dataset(cross=True, size='full') with the port,
   then on VegaInterface(..., device='cuda'): chi^2 at the defaults
   (< 1e-6), chi2_batch on 8192 rows of (ap, at, bias_LYA, beta_LYA)
   drawn as bench.py draws them (finite; the kernel launched), the kernel
   path against use_kernel=False (1e-10 relative), the JAX goldens of
   tests/data/torch_port_goldens.json (1e-8 relative), and evals/s.

Any failure exits non-zero. The last three lines of standard output are
the kernels' JSON record, the nvidia-smi line and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDENS = ROOT / 'tests' / 'data' / 'torch_port_goldens.json'

KERNEL_TOL = 1e-12      # max|kernel - plain| <= KERNEL_TOL * max|plain|
PLAIN_RTOL = 1e-10      # chi2_batch, kernel path vs plain path
GOLDEN_RTOL = 1e-8      # chi2_batch vs the JAX package's dense chi^2
DEFAULT_CHI2_MAX = 1e-6
BATCH = 8192
TIMED_ROUNDS = 3


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


def check_kernel(device):
    """Kernel vs plain version at the main path's shapes. Returns
    (max_abs_err, kernel_ms, plain_ms) at B = 256, M = 5000, per-row."""
    from vega_tpu_torch.ops.fftlog import FFTLogP2Xi
    from vega_tpu_torch.ops.spline import notaknot_second_derivative_matrix
    from vega_tpu_torch.ops.spline_combine import (KnotGrid,
                                                   spline_legendre_combine)

    rng = np.random.default_rng(0)
    n_b, n_ell = 256, 4
    # the transform's own knots: log r of the FFTLog output grid for the
    # 814-point template k grid
    k = np.logspace(-4, np.log10(1152.5), 814)
    logr = np.log(FFTLogP2Xi(k, 0).r_grid)
    grid = KnotGrid.build(logr, device)
    s_mat = notaknot_second_derivative_matrix(logr)
    y_np = rng.normal(size=(n_b, n_ell, len(logr)))
    y = torch.as_tensor(y_np, dtype=torch.float64, device=device)
    m = torch.as_tensor(y_np @ s_mat.T, dtype=torch.float64, device=device)

    worst = 0.0
    timed = None
    for n_q in (2500, 5000):
        for shared in (False, True):
            rows = 1 if shared else n_b
            # about 5% of the queries fall outside the knot range
            span = logr[-1] - logr[0]
            x_np = rng.uniform(logr[0] - 0.025 * span,
                               logr[-1] + 0.025 * span, (rows, n_q))
            x = torch.as_tensor(x_np, dtype=torch.float64,
                                device=device).expand(n_b, n_q)
            leg = torch.as_tensor(rng.uniform(-1, 1, (rows, n_ell, n_q)),
                                  dtype=torch.float64,
                                  device=device).expand(n_b, n_ell, n_q)
            out = spline_legendre_combine(grid, y, m, x, leg)
            ref = spline_legendre_combine(grid, y, m, x, leg,
                                          use_kernel=False)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            label = f'B={n_b} L={n_ell} N={len(logr)} M={n_q} ' \
                    f'{"shared" if shared else "per-row"} coordinates'
            if not err <= KERNEL_TOL * scale:
                fail(f'kernel disagrees with its plain version ({label}): '
                     f'max|diff| {err:.3e} > {KERNEL_TOL:g} x {scale:.3e}')
            worst = max(worst, err)
            plain_ms = cuda_time_ms(lambda: spline_legendre_combine(
                grid, y, m, x, leg, use_kernel=False), 5)
            kernel_ms = cuda_time_ms(lambda: spline_legendre_combine(
                grid, y, m, x, leg), 20)
            log(f'kernel check {label}: max|diff| {err:.3e} '
                f'(max|ref| {scale:.3e}); kernel {kernel_ms:.4f} ms, '
                f'plain {plain_ms:.4f} ms')
            if n_q == 5000 and not shared:
                timed = (kernel_ms, plain_ms)
    return worst, timed[0], timed[1]


def draw_batch(n_rows):
    """(bias_LYA, beta_LYA, ap, at) rows as bench.py:186-192 draws them."""
    sampled = {'bias_LYA': -0.117, 'beta_LYA': 1.67, 'ap': 1.0, 'at': 1.0}
    rng = np.random.default_rng(0)
    return {name: val + 0.01 * np.abs(val) * rng.normal(size=n_rows)
            for name, val in sampled.items()}


def run_main_path(device, work):
    """Build the configuration and drive the likelihood; returns the
    kernel launches of the main-path run."""
    from vega_tpu_torch.ops.spline_combine import spline_legendre_combine
    from vega_tpu_torch.testing import make_synthetic_dataset
    from vega_tpu_torch.vega_interface import CHUNK_ROWS, VegaInterface

    t0 = time.perf_counter()
    main_ini = make_synthetic_dataset(work, cross=True, size='full',
                                      device=device)
    vega = VegaInterface(main_ini, device=device)
    log(f'setup: synthetic full configuration + interface in '
        f'{time.perf_counter() - t0:.2f} s; bins '
        + ', '.join(f'{n} {d.full_data_size} ({d.data_size} unmasked)'
                    for n, d in vega.data.items()))
    batches = draw_batch(BATCH)

    # the main path's run: counts from zero
    spline_legendre_combine.launches = 0
    chi2_default = vega.chi2()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    chi2 = vega.chi2_batch(batches)
    torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    launches = spline_legendre_combine.launches
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

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
        fail('the main path launched no spline_legendre_combine kernel')

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
    return launches


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
    max_abs_err, kernel_ms, plain_ms = check_kernel(device)
    with tempfile.TemporaryDirectory() as work:
        launches = run_main_path(device, work)

    print(json.dumps({'kernels': [{
        'name': 'spline_legendre_combine', 'route': 'cuda',
        'source': 'vega_tpu_torch/csrc/spline_legendre_combine.cu',
        'replaces': 'vega_tpu/ops/pallas_spline.py:186',
        'launches': launches, 'max_abs_err': max_abs_err,
        'ms': kernel_ms, 'plain_ms': plain_ms}]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()

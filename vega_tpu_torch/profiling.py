"""Timing and profiling hooks of the port.

Counterpart of vega_tpu/profiling.py on torch:

- `timed(label, device)`: a context manager printing the wall time of its
  block, the card synchronised first when `device` is a CUDA device (the
  launches queued in the block are then counted in); the card unless the
  caller names the CPU.
- `time_likelihood(vega, n_evals)`: the first `chi2` call's time (on the
  card the kernels' build and load happen there) and the steady rate of
  the next `n_evals` calls.
- `trace(log_dir, device)`: a torch.profiler trace of the block, with the
  card's activity when `device` is CUDA (the default), written as a
  Chrome trace (`trace.json` in `log_dir`, for Perfetto or
  chrome://tracing).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch


def synchronize(device):
    """Wait for the card's queued work when `device` (a torch.device or a
    string) is CUDA."""
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


@contextmanager
def timed(label, device='cuda'):
    """Print `TIMING <label>: <s>` for the block, synchronising `device`
    first when it is CUDA."""
    start = time.perf_counter()
    yield
    synchronize(device)
    print(f'TIMING {label}: {time.perf_counter() - start:.4f}s')


def time_likelihood(vega, n_evals=50, params=None):
    """The first call's time and the steady rate of `vega.chi2(params)`
    (each call returns a host float, so each is synchronised). Returns
    {'first_call_s', 'evals_per_sec', 'chi2'}."""
    params = params or {}
    start = time.perf_counter()
    chi2 = vega.chi2(params)
    first_call_s = time.perf_counter() - start

    start = time.perf_counter()
    for _ in range(n_evals):
        chi2 = vega.chi2(params)
    elapsed = time.perf_counter() - start
    rate = n_evals / elapsed
    print(f'TIMING chi2: first call {first_call_s:.2f}s, steady '
          f'{1e3 / rate:.2f} ms/eval ({rate:.1f} evals/s), '
          f'chi2 = {chi2:.6f}')
    return {'first_call_s': first_call_s, 'evals_per_sec': rate,
            'chi2': chi2}


@contextmanager
def trace(log_dir, device='cuda'):
    """A torch.profiler trace of the block into `log_dir`/trace.json:
    CPU activity, and the card's when `device` is CUDA. Yields the
    profiler (its `key_averages()` tabulates the block)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        synchronize(device)
    path = os.path.join(log_dir, 'trace.json')
    prof.export_chrome_trace(path)
    print(f'Profiler trace written to {path}')

"""Time the port's pair histograms (vega_tpu_torch/native/pair_hist.cpp)
on the inputs that the DESI DR1 baseline's new-metals matrices give them
at full size, against other sources of the same C interface.

The script writes the desi phase's dataset of chip_smoke.py
(make_synthetic_dataset(cross=True, size='full', DESI_METALS,
new_metals=True, desi_extra_model())), records every pair_histograms
call that one VegaInterface makes while it builds its new-metals
matrices (the forest stack against itself for the auto, the QSO
catalogue against it for the cross), and replays those calls through
each source's library: all calls once per round, the sources in the
order given and then reversed (a, b, b, a), `--rounds` times. It prints
one JSON object: the host's CPU and OpenMP thread count, the calls'
shapes, each source's seconds per round (median, min, all), whether a
source gave the same bits in every round, and the largest difference of
each source from the first, of each output's largest entry.

Run from the repo root, on a host with a CUDA device (the dataset's
model is evaluated there) or with --device cpu:

    python tests/tools/time_pair_histograms.py \\
        --source parent=build/pair_hist_parent.cpp [--rounds 5]

The port's own source is always timed, under the name 'port'; the
thread count is OpenMP's default unless OMP_NUM_THREADS is set.
"""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from vega_tpu_torch.native import pair_hist  # noqa: E402
from vega_tpu_torch.testing import (DESI_METALS,  # noqa: E402
                                    desi_extra_model,
                                    make_synthetic_dataset)
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402


def record_calls(device, work, size):
    """The argument tuples of every pair_histograms call that one
    interface on the DESI dataset makes."""
    main_ini = make_synthetic_dataset(
        work, cross=True, size=size, device=device,
        extra_model=desi_extra_model(), metals=list(DESI_METALS),
        new_metals=True)
    calls = []
    original = pair_hist.pair_histograms

    def recorder(*args, **kwargs):
        calls.append((args, kwargs))
        return original(*args, **kwargs)

    pair_hist.pair_histograms = recorder
    try:
        VegaInterface(main_ini, device=device)
    finally:
        pair_hist.pair_histograms = original
    return calls


def replay(lib, calls):
    """Seconds for one pass over `calls` through `lib`, and the outputs."""
    load = pair_hist.load_library
    pair_hist.load_library = lambda: lib
    try:
        t0 = time.perf_counter()
        outs = [pair_hist.pair_histograms(*a, **k) for a, k in calls]
        seconds = time.perf_counter() - t0
    finally:
        pair_hist.load_library = load
    return seconds, outs


def max_diff(got, want):
    """The largest difference over the calls' outputs, of each output's
    largest entry."""
    worst = 0.
    for outs_g, outs_w in zip(got, want):
        for g, w in zip(outs_g, outs_w):
            if w is None:
                continue
            scale = float(np.max(np.abs(w))) or 1.
            worst = max(worst, float(np.max(np.abs(g - w))) / scale)
    return worst


def cpu_model():
    with open('/proc/cpuinfo') as fh:
        for line in fh:
            if line.startswith('model name'):
                return line.split(':', 1)[1].strip()
    return 'unknown'


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--source', action='append', default=[],
                        metavar='NAME=PATH',
                        help='another pair_hist.cpp to time beside the '
                             "port's")
    parser.add_argument('--rounds', type=int, default=5)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--size', default='full',
                        help="the dataset's size ('tiny' to try the "
                             'script)')
    args = parser.parse_args(argv)

    sources = {'port': pair_hist.SOURCE}
    for item in args.source:
        name, path = item.split('=', 1)
        sources[name] = Path(path)
    libs = {name: pair_hist.load_source(path, f'libtime_pair_hist_{name}')
            for name, path in sources.items()}

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        calls = record_calls(args.device, work, args.size)
        setup_s = time.perf_counter() - t0
    shapes = [{'n1': len(a[0]), 'n2': len(a[5]), 'n_rp': len(a[13]) - 1,
               'n_ratio': 0 if a[14] is None else len(a[14]) - 1}
              for a, _ in calls]

    order = list(libs) + list(libs)[::-1]
    seconds = {name: [] for name in libs}
    outputs = {name: [] for name in libs}
    for _ in range(args.rounds):
        for name in order:
            s, outs = replay(libs[name], calls)
            seconds[name].append(s)
            outputs[name].append(outs)
    first = next(iter(libs))
    result = {
        'cpu': cpu_model(), 'threads': os.environ.get(
            'OMP_NUM_THREADS', f'default ({len(os.sched_getaffinity(0))} '
                               'cpus)'),
        'calls': len(calls), 'shapes': sorted(
            {json.dumps(s, sort_keys=True) for s in shapes}),
        'size': args.size, 'setup_s': setup_s, 'order': order, 'rounds': args.rounds,
        'sources': {name: str(path) for name, path in sources.items()},
        'seconds': {name: {'median': float(np.median(v)),
                           'min': float(np.min(v)), 'all': v}
                    for name, v in seconds.items()},
        'same_bits_every_round': {
            name: all(max_diff(o, outs[0]) == 0. for o in outs)
            for name, outs in outputs.items()},
        f'max_diff_from_{first}': {
            name: max_diff(outs[0], outputs[first][0])
            for name, outs in outputs.items()},
    }
    print(json.dumps(result))


if __name__ == '__main__':
    main()

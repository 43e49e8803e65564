#!/usr/bin/env python3
"""Peak device memory of the dense mock fits against the fit chunk, up to
the largest chunk that fits on one card.

    python3 tests/tools/measure_fit_chunk_memory.py [--out chunks.json]

Builds chip_smoke.py's Monte-Carlo configuration (the full synthetic
auto+cross configuration with the [monte carlo] and [mc parameters] of
tests/data/torch_port_mc_goldens.json), draws mocks with
MonteCarloEngine.generate_mocks (seed 0) and fits campaigns of (ap, at,
bias_LYA, beta_LYA), the dense path, each campaign in one chunk
(VEGA_TPU_FIT_CHUNK_PER_DEVICE = its number of mocks): first at the
default chunk (8) and at 1024, then doubling until a campaign runs out of
device memory, then bisecting between the largest chunk that fitted and
the smallest that did not, to RESOLUTION rows. For each campaign it
prints the wall time, s per fit, Newton iterations, share valid, and the
peak device memory allocated and reserved (torch.cuda.max_memory_*), or
that it ran out of memory; the last line is one JSON object with every
campaign, the largest chunk that fitted and the card's name and power
limit. Running out of device memory is this tool's measurement, not a
failure: it catches only that. Needs one card, no JAX.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
SEED = 0
FIRST = (8, 1024)
RESOLUTION = 512
MAX_CHUNK = 1 << 17


def chip_smoke():
    """This checkout's chip_smoke.py as a module; it imports
    vega_tpu_torch only inside its functions, from sys.path."""
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def out_of_memory(error):
    """Whether `error` is the card running out of memory (the caching
    allocator's error, or a library's failed workspace allocation)."""
    if isinstance(error, torch.cuda.OutOfMemoryError):
        return True
    text = str(error)
    return 'out of memory' in text or 'ALLOC_FAILED' in text


def campaign(cs, device, engine, fiducial, sample, n_mocks):
    """One campaign of n_mocks dense fits in one chunk: its record."""
    stats = {}
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        mocks = engine.generate_mocks(fiducial, n_mocks, seed=SEED)
        with cs.switch('VEGA_TPU_FIT_CHUNK_PER_DEVICE', str(n_mocks)):
            fits = engine.fit_mocks(mocks, sample, stats=stats)
        torch.cuda.synchronize(device)
    except (torch.cuda.OutOfMemoryError, RuntimeError) as error:
        if not out_of_memory(error):
            raise
        record = {'chunk': n_mocks, 'fits': False,
                  'error': str(error).splitlines()[0][:200]}
    else:
        seconds = time.perf_counter() - t0
        record = {'chunk': n_mocks, 'fits': True, 'wall_s': seconds,
                  's_per_fit': seconds / n_mocks,
                  'iterations': stats['iterations'],
                  'valid_share': float(np.mean(fits['valid'])),
                  'peak_allocated_gb':
                      torch.cuda.max_memory_allocated(device) / 1e9,
                  'peak_reserved_gb':
                      torch.cuda.max_memory_reserved(device) / 1e9}
    mocks = fits = None
    gc.collect()
    torch.cuda.empty_cache()
    cs.log(json.dumps(record))
    return record


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--out', help='also write the JSON record here')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('torch.cuda.is_available() is false: this tool '
                         'needs a GPU')
    sys.path.insert(0, str(ROOT))
    cs = chip_smoke()
    from vega_tpu_torch.parallel import MonteCarloEngine
    from vega_tpu_torch.testing import make_synthetic_dataset
    from vega_tpu_torch.vega_interface import VegaInterface

    device = torch.device('cuda', torch.cuda.current_device())
    card = cs.card_line()
    cs.log(f'card: {card}; torch {torch.__version__}, CUDA '
           f'{torch.version.cuda}; total device memory '
           f'{torch.cuda.get_device_properties(device).total_memory / 1e9:.3f}'
           ' GB')
    cs.build_kernels()
    goldens = json.loads(cs.MC_GOLDENS.read_text())
    names = goldens['mc']['dense']['names']
    with tempfile.TemporaryDirectory() as work:
        mc_ini = make_synthetic_dataset(Path(work) / 'mc', cross=True,
                                        size='full', device=device,
                                        sample=goldens['sample'],
                                        extra_control=goldens['mc_control'])
        with cs.switch('VEGA_TPU_FACTORED', None), \
                cs.switch('VEGA_TPU_GRID_COLLAPSE', None):
            vega = VegaInterface(mc_ini, device=device)
    fiducial = vega.compute_model(vega.mc_config['params'],
                                  run_init=False)
    engine = MonteCarloEngine(vega)
    sample = {key: {n: vega.mc_config['sample'][key][n] for n in names}
              for key in ('limits', 'values', 'errors', 'fix')}

    records = [campaign(cs, device, engine, fiducial, sample, n)
               for n in FIRST]
    if not all(r['fits'] for r in records):
        raise SystemExit(f'a campaign of {FIRST} mocks ran out of memory')
    fits, fails = FIRST[-1], None
    while fails is None and fits < MAX_CHUNK:
        record = campaign(cs, device, engine, fiducial, sample, 2 * fits)
        records.append(record)
        if record['fits']:
            fits *= 2
        else:
            fails = 2 * fits
    while fails is not None and fails - fits > RESOLUTION:
        middle = (fits + fails) // 2 // RESOLUTION * RESOLUTION
        record = campaign(cs, device, engine, fiducial, sample, middle)
        records.append(record)
        if record['fits']:
            fits = middle
        else:
            fails = middle
    for record in records:
        if record['fits'] and record['valid_share'] < 0.9:
            raise SystemExit(f'only {record["valid_share"]:.3f} of the '
                             f'{record["chunk"]} fits are valid')
    result = {'card': card, 'names': names, 'seed': SEED,
              'resolution': RESOLUTION, 'largest_fitting_chunk': fits,
              'smallest_failing_chunk': fails, 'campaigns': records}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1) + '\n')
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()

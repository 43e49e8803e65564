"""Write tests/data/torch_port_sampler_goldens.json: the JAX package's
(vega_tpu) native nested sampler on the CPU, on the full synthetic
auto+cross configuration with (ap, at, bias_LYA, beta_LYA) sampled,
make_synthetic_dataset(cross=True, size='full', sample=SAMPLE), served by
the grid payload at its defaults with the exact f64 payload contractions
(VEGA_TPU_DS_MATMUL=0):

- NestedSampler with SETTINGS and the host-driven slice loop
  (device_loop = False, numpy random numbers): logZ and its bootstrap
  error, the weighted mean and standard deviation of each parameter, the
  iterations, the likelihood evaluations and the wall time.

The PyTorch port's samplers are held against these numbers on the GPU by
chip_smoke.py (its sampler phase), statistically: the port's device loop
draws its random numbers from a torch generator.

Usage (from the repo root):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_sampler_goldens.py
"""

from __future__ import annotations

import configparser
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_sampler_goldens.json'

NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')
# [sample] entries: lower, upper, start, error (the fit goldens' section)
SAMPLE = {'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
          'bias_LYA': '-1.0 0.0 -0.12 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1'}
# the [NestedJax] section: the sampler's defaults for four parameters
# (num_live = 25 ndim, num_repeats = 5 ndim, batch_size = num_live / 4,
# max_shrink = 12) written out, and the precision
SETTINGS = {'num_live': 100, 'num_repeats': 20, 'batch_size': 25,
            'max_shrink': 12, 'precision': 0.01, 'seed': 0,
            'resume': False}


def weighted_moments(samples, weights):
    mean = np.average(samples, axis=0, weights=weights)
    var = np.average((samples - mean) ** 2, axis=0, weights=weights)
    return mean, np.sqrt(var)


def main():
    t_start = time.perf_counter()
    os.environ['VEGA_TPU_DS_MATMUL'] = '0'
    os.environ['VEGA_TPU_GRID_CACHE'] = '0'
    os.environ.pop('VEGA_TPU_FACTORED', None)
    os.environ.pop('VEGA_TPU_GRID_COLLAPSE', None)
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from vega_tpu.parallel import BatchedLikelihood
    from vega_tpu.samplers.nested import NestedSampler
    from vega_tpu.testing import make_synthetic_dataset
    from vega_tpu.vega_interface import VegaInterface

    with tempfile.TemporaryDirectory() as work:
        main_ini = make_synthetic_dataset(work, cross=True, size='full',
                                          sample=SAMPLE)
        vega = VegaInterface(main_ini)
        out_dir = Path(work) / 'sampler'
        out_dir.mkdir()
        config = configparser.ConfigParser()
        config.optionxform = lambda option: option
        config['NestedJax'] = {'path': str(out_dir), 'name': 'golden',
                               'device_loop': 'False',
                               **{k: str(v) for k, v in SETTINGS.items()}}
        sampler = NestedSampler(config['NestedJax'],
                                vega.sample_params['limits'],
                                BatchedLikelihood(vega))
        t0 = time.perf_counter()
        result = sampler.run()
        seconds = time.perf_counter() - t0
        stats = dict(line.split(' = ') for line in
                     (out_dir / 'golden.stats').read_text().splitlines())
    mean, std = weighted_moments(result['samples'], result['weights'])
    OUT.write_text(json.dumps({
        'config': "make_synthetic_dataset(workdir, cross=True, "
                  "size='full', sample=SAMPLE)",
        'names': list(NAMES), 'sample': SAMPLE, 'settings': SETTINGS,
        'path': 'vega_tpu NestedSampler, host slice loop '
                '(device_loop = False), BatchedLikelihood on the grid '
                'payload, CPU, f64, VEGA_TPU_DS_MATMUL=0',
        'made_by': 'tests/tools/make_torch_port_sampler_goldens.py',
        'nested': {'logz': float(result['logz']),
                   'logz_err': float(result['logz_err']),
                   'mean': mean.tolist(), 'std': std.tolist(),
                   'iterations': int(stats['num_iterations']),
                   'num_like_evals': int(stats['num_like_evals']),
                   'seconds': seconds},
        'seconds_on_the_cpu': time.perf_counter() - t_start,
    }, indent=1) + '\n')
    print(f'wrote {OUT}: logZ {result["logz"]:.4f} +/- '
          f'{result["logz_err"]:.4f}, mean {mean.tolist()}, std '
          f'{std.tolist()}, {stats["num_iterations"]} iterations in '
          f'{seconds:.1f} s')


if __name__ == '__main__':
    main()

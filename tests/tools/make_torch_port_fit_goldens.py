"""Write tests/data/torch_port_fit_goldens.json: the JAX package's
(vega_tpu) exact derivatives and fits on the CPU, on the full synthetic
auto+cross configuration with (ap, at, bias_LYA, beta_LYA) sampled,
make_synthetic_dataset(cross=True, size='full', sample=SAMPLE), and the
exact f64 payload contractions (VEGA_TPU_DS_MATMUL=0):

- chi2_value_and_gradient and chi2_hessian at POINTS, on the grid path
  (the defaults: 32 x 32 Chebyshev nodes over ap, at in [0.75, 1.25])
  and on the dense path (VEGA_TPU_FACTORED=0); the last point has ap on
  the node domain's end;
- minimize() from the [sample] start on both paths: best-fit values,
  errors, covariance, fval, EDM, validity and wall time;
- the tool's own run time.

The PyTorch port is held against these numbers on the GPU by
chip_smoke.py (its fit phase).

Usage (from the repo root):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_fit_goldens.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_fit_goldens.json'

NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')
# [sample] entries: lower, upper, start, error
SAMPLE = {'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
          'bias_LYA': '-1.0 0.0 -0.12 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1'}
POINTS = [
    {'ap': 1.03, 'at': 0.97, 'bias_LYA': -0.12, 'beta_LYA': 1.6},
    {'ap': 0.9, 'at': 1.1, 'bias_LYA': -0.11, 'beta_LYA': 1.75},
    {'ap': 1.18, 'at': 0.85, 'bias_LYA': -0.125, 'beta_LYA': 1.52},
    {'ap': 1.25, 'at': 1.0, 'bias_LYA': -0.118, 'beta_LYA': 1.66},
]


def derivatives(vega):
    out = {'chi2': [], 'gradient': [], 'hessian': []}
    for point in POINTS:
        value, grad = vega.chi2_value_and_gradient(point)
        hess = vega.chi2_hessian(point, list(NAMES))
        out['chi2'].append(value)
        out['gradient'].append([grad[n] for n in NAMES])
        out['hessian'].append([[hess[a][b] for b in NAMES] for a in NAMES])
    return out


def fit(vega):
    t0 = time.perf_counter()
    vega.minimize()
    seconds = time.perf_counter() - t0
    best = vega.bestfit
    cov = best.covariance
    return {'values': [best.values[n] for n in NAMES],
            'errors': [best.errors[n] for n in NAMES],
            'covariance': [[float(cov[a, b]) for b in NAMES] for a in NAMES],
            'fval': float(best.fmin.fval), 'edm': float(best.fmin.edm),
            'is_valid': bool(best.fmin.is_valid), 'seconds': seconds}


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
    from vega_tpu.testing import make_synthetic_dataset
    from vega_tpu.vega_interface import VegaInterface

    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        main_ini = make_synthetic_dataset(work, cross=True, size='full',
                                          sample=SAMPLE)
        t0 = time.perf_counter()
        grid_vega = VegaInterface(main_ini)
        grid = derivatives(grid_vega)
        seconds['grid_derivatives'] = time.perf_counter() - t0
        fit_grid = fit(grid_vega)
        os.environ['VEGA_TPU_FACTORED'] = '0'
        t0 = time.perf_counter()
        dense_vega = VegaInterface(main_ini)
        dense = derivatives(dense_vega)
        seconds['dense_derivatives'] = time.perf_counter() - t0
        fit_dense = fit(dense_vega)
    seconds['tool'] = time.perf_counter() - t_start
    OUT.write_text(json.dumps({
        'config': "make_synthetic_dataset(workdir, cross=True, "
                  "size='full', sample=SAMPLE)",
        'names': list(NAMES), 'sample': SAMPLE, 'points': POINTS,
        'path': 'vega_tpu chi2_value_and_gradient / chi2_hessian / '
                'minimize(), CPU, f64, VEGA_TPU_DS_MATMUL=0',
        'grid_path': 'defaults (grid collapse, 32 x 32 nodes)',
        'dense_path': 'VEGA_TPU_FACTORED=0',
        'made_by': 'tests/tools/make_torch_port_fit_goldens.py',
        'grid': grid, 'dense': dense,
        'fit_grid': fit_grid, 'fit_dense': fit_dense,
        'seconds_on_the_cpu': seconds,
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s: grid fit '
          f'{fit_grid["values"]} ({fit_grid["seconds"]:.1f} s), dense fit '
          f'{fit_dense["values"]} ({fit_dense["seconds"]:.1f} s)')


if __name__ == '__main__':
    main()

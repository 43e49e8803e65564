"""Write tests/data/torch_port_dr16_goldens.json: the JAX package's
(vega_tpu) numbers on the CPU for the configuration synthetic-dr16-full,
the full synthetic auto+cross dataset with the DR16-shaped model
(Rogers HCD, Arinyo small-scale NL, the metals SiII(1190), SiII(1193),
SiII(1260), SiIII(1207) in every LYA tracer with identity metal
matrices; tests/tools/jax_metal_dataset.py with
vega_tpu_torch.testing.dr16_extra_model() and DR16_METALS), with (ap, at,
bias_LYA, beta_LYA, bias_hcd, beta_hcd, bias_SiII(1260),
bias_SiIII(1207)) sampled and the exact f64 payload contractions
(VEGA_TPU_DS_MATMUL=0):

- chi2_batch at 8 points drawn around the truth, on the dense path
  (VEGA_TPU_FACTORED=0) and on the grid path (the defaults: 32 x 32
  Chebyshev nodes over ap, at in [0.75, 1.25], mode budget 2e-4), with
  the payload's terms, retained modes and SVD ranks;
- chi2_value_and_gradient and chi2_hessian at DERIVATIVE_POINTS on both
  paths;
- minimize() from the [sample] start on both paths: best-fit values,
  errors, fval, EDM, validity and wall time;
- the tool's own run time, by part.

The PyTorch port is held against these numbers on the GPU by
chip_smoke.py (its dr16 phase).

Usage (from the repo root; about 3 minutes on 8 CPU cores):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_dr16_goldens.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_dr16_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))

NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA', 'bias_hcd', 'beta_hcd',
         'bias_SiII(1260)', 'bias_SiIII(1207)')
# [sample] entries: lower, upper, start, error (the limits and errors of
# vega_tpu/parameters/default_values.txt; ap, at, bias_LYA and beta_LYA
# as tests/tools/make_torch_port_fit_goldens.py)
SAMPLE = {'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
          'bias_LYA': '-1.0 0.0 -0.12 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1',
          'bias_hcd': '-0.5 0.0 -0.05 0.01', 'beta_hcd': '0.0 5.0 0.7 0.1',
          'bias_SiII(1260)': '-0.5 0.0 -0.0025 0.001',
          'bias_SiIII(1207)': '-0.5 0.0 -0.0035 0.001'}
TRUTH = {'ap': 1.0, 'at': 1.0, 'bias_LYA': -0.117, 'beta_LYA': 1.67,
         'bias_hcd': -0.052, 'beta_hcd': 0.65, 'bias_SiII(1260)': -0.002,
         'bias_SiIII(1207)': -0.004}
N_POINTS = 8
DERIVATIVE_POINTS = [
    {'ap': 1.03, 'at': 0.97, 'bias_LYA': -0.12, 'beta_LYA': 1.6,
     'bias_hcd': -0.05, 'beta_hcd': 0.7, 'bias_SiII(1260)': -0.0025,
     'bias_SiIII(1207)': -0.0035},
    {'ap': 0.9, 'at': 1.1, 'bias_LYA': -0.11, 'beta_LYA': 1.75,
     'bias_hcd': -0.06, 'beta_hcd': 0.55, 'bias_SiII(1260)': -0.0015,
     'bias_SiIII(1207)': -0.0045},
]


def draw_points(n_rows):
    """Rows 1% around the truth, as bench.py draws its batch."""
    import numpy as np
    rng = np.random.default_rng(0)
    return {name: (val + 0.01 * abs(val) * rng.normal(size=n_rows)).tolist()
            for name, val in TRUTH.items()}


def derivatives(vega):
    out = {'chi2': [], 'gradient': [], 'hessian': []}
    for point in DERIVATIVE_POINTS:
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
    return {'values': [best.values[n] for n in NAMES],
            'errors': [best.errors[n] for n in NAMES],
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
    import numpy as np
    from jax_metal_dataset import make_jax_metal_dataset
    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu_torch.testing import DR16_METALS, dr16_extra_model

    points = draw_points(N_POINTS)
    batch = {k: np.asarray(v) for k, v in points.items()}
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        main_ini = make_jax_metal_dataset(
            work, list(DR16_METALS), cross=True, size='full', sample=SAMPLE,
            extra_model=dr16_extra_model())
        seconds['dataset'] = time.perf_counter() - t_start
        grid_vega = VegaInterface(main_ini)
        t0 = time.perf_counter()
        payload = grid_vega.get_collapsed(tuple(sorted(NAMES)))
        seconds['collapse'] = time.perf_counter() - t0
        chi2_grid = np.asarray(grid_vega.chi2_batch(batch))
        t0 = time.perf_counter()
        grid = derivatives(grid_vega)
        seconds['grid_derivatives'] = time.perf_counter() - t0
        fit_grid = fit(grid_vega)
        os.environ['VEGA_TPU_FACTORED'] = '0'
        dense_vega = VegaInterface(main_ini)
        t0 = time.perf_counter()
        chi2_dense = np.asarray(dense_vega.chi2_batch(batch))
        seconds['dense_chi2_batch'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = derivatives(dense_vega)
        seconds['dense_derivatives'] = time.perf_counter() - t0
        fit_dense = fit(dense_vega)
    for name, values in (('grid', chi2_grid), ('dense', chi2_dense)):
        if not np.all(np.isfinite(values)) or np.any(values >= 1e100):
            raise SystemExit(f'unexpected {name} chi2: {values}')
    seconds['tool'] = time.perf_counter() - t_start
    spec = payload['__grid__']
    OUT.write_text(json.dumps({
        'config': 'synthetic-dr16-full: make_jax_metal_dataset(work, '
                  "DR16_METALS, cross=True, size='full', sample=SAMPLE, "
                  'extra_model=dr16_extra_model())',
        'names': list(NAMES), 'sample': SAMPLE,
        'path': 'vega_tpu chi2_batch / chi2_value_and_gradient / '
                'chi2_hessian / minimize(), CPU, f64, VEGA_TPU_DS_MATMUL=0',
        'grid_path': 'defaults (grid collapse, 32 x 32 nodes)',
        'dense_path': 'VEGA_TPU_FACTORED=0',
        'made_by': 'tests/tools/make_torch_port_dr16_goldens.py',
        'grid_spec': {'names': list(spec.names), 'lo': list(spec.lo),
                      'hi': list(spec.hi), 'degrees': list(spec.degrees),
                      'ref': list(spec.ref)},
        'payload': {
            name: {'modes_A': int(p['modes_A'].shape[1]),
                   'rank_A': int(p['B_A'].shape[1]),
                   'modes_sy': int(p['modes_sy'].shape[1]),
                   'rank_sy': int(p['B_sy'].shape[1]),
                   'terms': int(p['cref'].shape[0]),
                   'dc_max': float(p['dc_max'])}
            for name, p in payload.items() if name != '__grid__'},
        'params': points,
        'chi2_grid': [float(c) for c in chi2_grid],
        'chi2_dense': [float(c) for c in chi2_dense],
        'max_abs_grid_minus_dense':
            float(np.max(np.abs(chi2_grid - chi2_dense))),
        'derivative_points': DERIVATIVE_POINTS,
        'grid': grid, 'dense': dense,
        'fit_grid': fit_grid, 'fit_dense': fit_dense,
        'seconds_on_the_cpu': seconds,
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s: {seconds}; grid fit '
          f'{fit_grid["values"]}, dense fit {fit_dense["values"]}')


if __name__ == '__main__':
    main()

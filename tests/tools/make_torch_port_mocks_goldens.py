"""Write tests/data/torch_port_mocks_goldens.json: the JAX package's
(vega_tpu) numbers on the CPU for the two mock configurations at full
size, with the exact f64 payload contractions (VEGA_TPU_DS_MATMUL=0):

- synthetic-desi-mock-full: DESI DR1's baseline as run on mocks
  (tests/tools/jax_mocks_dataset.py make_jax_desi_mock_dataset, the
  arguments of vega_tpu_torch.testing.make_desi_mock_dataset:
  full-shape smoothing in [model] and [metals], new-metals matrices of
  four Si lines, per-correlation covariances) with DESI_MOCK_FIT_SAMPLE's
  15 names:
  - dense regime (VEGA_TPU_FACTORED=0): chi^2 at the defaults,
    chi2_batch at 8 points drawn around the truth, chi2_value_and_gradient
    at two points;
  - grid regime, 32 x 32 Chebyshev nodes over (ap, at), on a copy of the
    main ini sampling DESI_MOCK_GRID_NAMES: the payload's terms, retained
    modes and SVD ranks, chi2_batch at the same points and the dense
    chi^2 there, and minimize() from the [sample] start;
- synthetic-lyacolore-full: the LyaCoLoRe raw-mock auto
  (make_jax_lyacolore_dataset, the DR9LyaMocks template, old_fftlog) with
  LYACOLORE_FIT_SAMPLE's six names, dense (vega_tpu's route for them: its
  sweep finds nothing factored): chi^2 at the defaults, chi2_batch at 8
  points, chi2_value_and_gradient at two points and minimize();
- the tool's own run time, by part.

The PyTorch port is held against these numbers on the GPU by
chip_smoke.py (its desi_mock and lyacolore phases).

Usage (from the repo root; a few minutes on 8 CPU cores):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_mocks_goldens.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_mocks_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(REPO))

N_POINTS = 8


def draw_points(values, n_rows, seed):
    """Rows 1% around the truth (0.001 around a zero value)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return {name: (val + 0.01 * (abs(val) or 0.1)
                   * rng.normal(size=n_rows)).tolist()
            for name, val in values.items()}


def derivative_points(values):
    """Two points off the truth in every sampled name."""
    return [{n: v + 0.02 * (abs(v) or 0.1) for n, v in values.items()},
            {n: v - 0.03 * (abs(v) or 0.1) for n, v in values.items()}]


def value_and_gradient(vega, points, names):
    out = {'chi2': [], 'gradient': []}
    for point in points:
        value, grad = vega.chi2_value_and_gradient(point)
        out['chi2'].append(float(value))
        out['gradient'].append([float(grad[n]) for n in names])
    return out


def fit(vega, names):
    t0 = time.perf_counter()
    vega.minimize()
    seconds = time.perf_counter() - t0
    best = vega.bestfit
    return {'values': [best.values[n] for n in names],
            'errors': [best.errors[n] for n in names],
            'fval': float(best.fmin.fval), 'edm': float(best.fmin.edm),
            'is_valid': bool(best.fmin.is_valid), 'seconds': seconds}


class dense_regime:
    """VEGA_TPU_FACTORED=0 while open: vega_tpu reads it when it traces a
    call, so every dense call runs inside."""

    def __enter__(self):
        os.environ['VEGA_TPU_FACTORED'] = '0'

    def __exit__(self, *exc):
        del os.environ['VEGA_TPU_FACTORED']


def desi_mock_goldens(work, seconds):
    import numpy as np
    from jax_mocks_dataset import make_jax_desi_mock_dataset
    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu_torch.testing import (DESI_MOCK_FIT_SAMPLE,
                                        DESI_MOCK_GRID_NAMES,
                                        DESI_MOCK_PARAMETERS, DEFAULT_PARAMS,
                                        with_sample)
    t0 = time.perf_counter()
    names = list(DESI_MOCK_FIT_SAMPLE)
    truth = {**DEFAULT_PARAMS, **DESI_MOCK_PARAMETERS}
    points = draw_points({n: truth[n] for n in names}, N_POINTS, 0)
    batch = {k: np.asarray(v) for k, v in points.items()}
    grid_batch = {k: batch[k] for k in DESI_MOCK_GRID_NAMES}
    d_points = derivative_points({n: truth[n] for n in names})
    main_ini = make_jax_desi_mock_dataset(
        Path(work) / 'desi_mock', size='full', sample=DESI_MOCK_FIT_SAMPLE)
    seconds['desi_mock_dataset'] = time.perf_counter() - t0

    with dense_regime():
        dense = VegaInterface(main_ini)
        t0 = time.perf_counter()
        chi2_default = float(dense.chi2())
        chi2_dense = np.asarray(dense.chi2_batch(batch))
        seconds['desi_mock_dense_chi2_batch'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        derivs = value_and_gradient(dense, d_points, names)
        seconds['desi_mock_dense_gradient'] = time.perf_counter() - t0

    grid_main = with_sample(main_ini, {n: DESI_MOCK_FIT_SAMPLE[n]
                                       for n in DESI_MOCK_GRID_NAMES},
                            Path(main_ini).parent / 'main_grid.ini')
    grid = VegaInterface(grid_main)
    t0 = time.perf_counter()
    payload = grid.get_collapsed(tuple(sorted(DESI_MOCK_GRID_NAMES)))
    seconds['desi_mock_collapse'] = time.perf_counter() - t0
    chi2_grid = np.asarray(grid.chi2_batch(grid_batch))
    fit_grid = fit(grid, list(DESI_MOCK_GRID_NAMES))
    with dense_regime():
        chi2_grid_dense = np.asarray(
            VegaInterface(grid_main).chi2_batch(grid_batch))
    for label, values in (('dense', chi2_dense), ('grid', chi2_grid),
                          ('grid dense', chi2_grid_dense)):
        if not np.all(np.isfinite(values)) or np.any(values >= 1e100):
            raise SystemExit(f'unexpected desi mock {label} chi2: {values}')
    spec = payload['__grid__']
    return {
        'config': 'synthetic-desi-mock-full: make_jax_desi_mock_dataset('
                  "work, size='full', sample=DESI_MOCK_FIT_SAMPLE)",
        'names': names, 'grid_names': list(DESI_MOCK_GRID_NAMES),
        'dense_path': 'VEGA_TPU_FACTORED=0, per-correlation covariances',
        'grid_path': 'main_grid.ini (DESI_MOCK_GRID_NAMES sampled), '
                     'defaults (grid collapse, 32 x 32 nodes)',
        'chi2_default': chi2_default, 'params': points,
        'chi2_dense': [float(c) for c in chi2_dense],
        'derivative_points': d_points, 'dense': derivs,
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
        'chi2_grid': [float(c) for c in chi2_grid],
        'chi2_grid_dense': [float(c) for c in chi2_grid_dense],
        'max_abs_grid_minus_dense':
            float(np.max(np.abs(chi2_grid - chi2_grid_dense))),
        'fit_grid': fit_grid,
    }


def lyacolore_goldens(work, seconds):
    import numpy as np
    from jax_mocks_dataset import make_jax_lyacolore_dataset
    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu_torch.testing import (LYACOLORE_FIT_SAMPLE,
                                        lyacolore_parameters)
    t0 = time.perf_counter()
    names = list(LYACOLORE_FIT_SAMPLE)
    truth = {k: float(v) for k, v in lyacolore_parameters().items()}
    points = draw_points({n: truth[n] for n in names}, N_POINTS, 1)
    batch = {k: np.asarray(v) for k, v in points.items()}
    d_points = derivative_points({n: truth[n] for n in names})
    with dense_regime():
        main_ini = make_jax_lyacolore_dataset(
            Path(work) / 'lyacolore', size='full',
            sample=LYACOLORE_FIT_SAMPLE)
        seconds['lyacolore_dataset'] = time.perf_counter() - t0
        dense = VegaInterface(main_ini)
        t0 = time.perf_counter()
        chi2_default = float(dense.chi2())
        chi2_dense = np.asarray(dense.chi2_batch(batch))
        seconds['lyacolore_dense_chi2_batch'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        derivs = value_and_gradient(dense, d_points, names)
        seconds['lyacolore_dense_gradient'] = time.perf_counter() - t0
        fit_dense = fit(dense, names)
    if not np.all(np.isfinite(chi2_dense)) or np.any(chi2_dense >= 1e100):
        raise SystemExit(f'unexpected lyacolore chi2: {chi2_dense}')
    return {
        'config': 'synthetic-lyacolore-full: make_jax_lyacolore_dataset('
                  "work, size='full', sample=LYACOLORE_FIT_SAMPLE)",
        'names': names,
        'dense_path': 'VEGA_TPU_FACTORED=0 (vega_tpu\'s route for the six '
                      'names: its sweep finds nothing factored)',
        'chi2_default': chi2_default, 'params': points,
        'chi2_dense': [float(c) for c in chi2_dense],
        'derivative_points': d_points, 'dense': derivs,
        'fit_dense': fit_dense,
    }


def main():
    t_start = time.perf_counter()
    os.environ['VEGA_TPU_DS_MATMUL'] = '0'
    os.environ['VEGA_TPU_GRID_CACHE'] = '0'
    os.environ.pop('VEGA_TPU_FACTORED', None)
    os.environ.pop('VEGA_TPU_GRID_COLLAPSE', None)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        desi_mock = desi_mock_goldens(work, seconds)
        lyacolore = lyacolore_goldens(work, seconds)
    seconds['tool'] = time.perf_counter() - t_start
    OUT.write_text(json.dumps({
        'path': 'vega_tpu chi2_batch / chi2_value_and_gradient / '
                'minimize(), CPU, f64, VEGA_TPU_DS_MATMUL=0',
        'made_by': 'tests/tools/make_torch_port_mocks_goldens.py',
        'desi_mock': desi_mock, 'lyacolore': lyacolore,
        'seconds_on_the_cpu': seconds,
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s: {seconds}; desi mock '
          f'grid fit {desi_mock["fit_grid"]["values"]}, lyacolore fit '
          f'{lyacolore["fit_dense"]["values"]}')


if __name__ == '__main__':
    main()

"""Write tests/data/torch_port_marg_goldens.json: the JAX package's
(vega_tpu) numbers on the CPU for the configuration synthetic-desi-marg-full,
the DESI DR1 baseline model of synthetic-desi-full (new-metals matrices
of five lines, Rogers HCD, Arinyo NL, QSO radiation, DESI instrumental
systematics) on the full synthetic auto + cross dataset with a distortion
matrix and per-correlation covariances, and in both [model]s BuildConfig's
small-scale marginalization (vega_tpu_torch.testing.MARG_MODEL: all-rmin,
a prior of 10, fit-marginalized-scales, marginalize-match-data-bins);
tests/tools/jax_metal_dataset.py with marg_extra_model(desi_extra_model()),
DESI_METALS, new_metals=True, with_distortion=True, noise 1 (seed 0) and
DESI_MARG_SAMPLE's five names:

- 'cov', the templates in the covariance (VEGA_TPU_FACTORED=0): the
  templates and modes per correlation, chi^2 at the defaults, chi2_batch
  at 8 points drawn around the truth, chi^2, gradient and the
  coefficients at two points off it, minimize() from the [sample] start
  with its best-fit coefficients; and on the grid route (the defaults:
  32 x 32 nodes over (ap, at), the linear names in the coefficient
  program) the payload's terms and modes and chi2_batch at the same
  points;
- 'in_fit', the same files with [control] marginalize-in-fit = True: the
  same dense numbers, the coefficients the chi^2 fits, and minimize();
- the tool's own run time, by part.

The pair histograms of the new-metals matrices run on one OpenMP thread
(OMP_NUM_THREADS=1, set here before any library loads, so numpy's BLAS
takes one thread too), where vega_tpu's sums do not move from run to
run. The PyTorch port is held against these
numbers on the GPU by chip_smoke.py (its marg phase).

Usage (from the repo root; several minutes on 8 CPU cores):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_marg_goldens.py
"""

from __future__ import annotations

import os

os.environ['OMP_NUM_THREADS'] = '1'

import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_marg_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(REPO))

N_POINTS = 8
# Gaussian noise in units of each bin's sigma (seed 0): the best fit then
# leaves a residual for the templates, whose coefficients are round-off
# on noise-free data
MARG_NOISE = 1.0


def truth(names):
    """The configuration's values of the sampled names."""
    from vega_tpu_torch.testing import DEFAULT_PARAMS, DESI_PARAMETERS
    values = {**DEFAULT_PARAMS, **DESI_PARAMETERS}
    return {name: values[name] for name in names}


def draw_points(names, n_rows):
    """Rows 1% around the truth, as bench.py draws its batch."""
    import numpy as np
    rng = np.random.default_rng(0)
    return {name: (val + 0.01 * abs(val) * rng.normal(size=n_rows)).tolist()
            for name, val in truth(names).items()}


def derivative_points(names):
    """Two points off the truth in every sampled name."""
    t = truth(names)
    return [{n: v + 0.02 * abs(v) for n, v in t.items()},
            {n: v - 0.03 * abs(v) for n, v in t.items()}]


def value_gradients(vega, points, names):
    out = {'chi2': [], 'gradient': []}
    for point in points:
        value, grad = vega.chi2_value_and_gradient(point)
        out['chi2'].append(float(value))
        out['gradient'].append([float(grad[n]) for n in names])
    return out


def coefficients(vega, point):
    """{name: the template coefficients of the model at `point`}."""
    _, coeffs = vega.chi2(point, return_marg_coeff=True)
    return {n: [float(c) for c in v] for n, v in coeffs.items()}


def fit(vega, names):
    t0 = time.perf_counter()
    vega.minimize()
    seconds = time.perf_counter() - t0
    best = vega.bestfit
    return {'values': [best.values[n] for n in names],
            'errors': [best.errors[n] for n in names],
            'fval': float(best.fmin.fval), 'edm': float(best.fmin.edm),
            'is_valid': bool(best.fmin.is_valid), 'seconds': seconds,
            'bestfit_marg_coeff': {
                n: [float(c) for c in s['bestfit_marg_coeff']]
                for n, s in vega.bestfit_corr_stats.items()},
            'masked_size': {n: int(s['masked_size'])
                            for n, s in vega.bestfit_corr_stats.items()}}


def dense_record(vega, names, batch, d_points):
    import numpy as np
    return {
        'templates': {n: int(d.marg_templates.shape[1])
                      for n, d in vega.data.items()},
        'modes': {n: int(d.num_marg_modes) for n, d in vega.data.items()},
        'chi2_default': float(vega.chi2()),
        'chi2_dense': [float(c) for c in np.asarray(vega.chi2_batch(batch))],
        'dense': value_gradients(vega, d_points, names),
        'coeff': coefficients(vega, d_points[0]),
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
    import numpy as np
    from jax_metal_dataset import make_jax_metal_dataset
    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu_torch.testing import (DESI_MARG_SAMPLE, DESI_METALS,
                                        desi_extra_model, marg_extra_model,
                                        with_control)

    sample = DESI_MARG_SAMPLE
    names = list(sample)
    points = draw_points(names, N_POINTS)
    batch = {k: np.asarray(v) for k, v in points.items()}
    d_points = derivative_points(names)
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        main_ini = make_jax_metal_dataset(
            work, list(DESI_METALS), cross=True, size='full', sample=sample,
            extra_model=marg_extra_model(desi_extra_model()),
            new_metals=True, with_distortion=True, noise=MARG_NOISE)
        seconds['dataset'] = time.perf_counter() - t_start

        # vega_tpu reads VEGA_TPU_FACTORED when it traces a call
        os.environ['VEGA_TPU_FACTORED'] = '0'
        t0 = time.perf_counter()
        vega = VegaInterface(main_ini)
        cov = dense_record(vega, names, batch, d_points)
        cov['fit_dense'] = fit(vega, names)
        seconds['cov_dense'] = time.perf_counter() - t0
        os.environ.pop('VEGA_TPU_FACTORED')

        t0 = time.perf_counter()
        grid_vega = VegaInterface(main_ini)
        payload = grid_vega.get_collapsed(tuple(sorted(names)))
        chi2_grid = np.asarray(grid_vega.chi2_batch(batch))
        seconds['cov_grid'] = time.perf_counter() - t0

        t0 = time.perf_counter()
        in_fit_main = with_control(main_ini, 'marginalize-in-fit = True',
                                   Path(work) / 'main_in_fit.ini')
        vega = VegaInterface(in_fit_main)
        if vega.get_collapsed(tuple(sorted(names))):
            raise SystemExit('marginalize-in-fit served a collapse')
        in_fit = dense_record(vega, names, batch, d_points)
        in_fit['fit_dense'] = fit(vega, names)
        seconds['in_fit'] = time.perf_counter() - t0
    chi2_dense = np.asarray(cov['chi2_dense'])
    for label, values in (('dense', chi2_dense), ('grid', chi2_grid),
                          ('in_fit', np.asarray(in_fit['chi2_dense']))):
        if not np.all(np.isfinite(values)) or np.any(values >= 1e100):
            raise SystemExit(f'unexpected {label} chi2: {values}')
    seconds['tool'] = time.perf_counter() - t_start
    spec = payload['__grid__']
    cov.update({
        'names': names, 'params': points, 'derivative_points': d_points,
        'grid_spec': {'names': list(spec.names), 'lo': list(spec.lo),
                      'hi': list(spec.hi), 'degrees': list(spec.degrees)},
        'payload': {
            name: {'modes_A': int(p['modes_A'].shape[1]),
                   'rank_A': int(p['B_A'].shape[1]),
                   'modes_sy': int(p['modes_sy'].shape[1]),
                   'rank_sy': int(p['B_sy'].shape[1]),
                   'terms': int(p['cref'].shape[0])}
            for name, p in payload.items() if name != '__grid__'},
        'chi2_grid': [float(c) for c in chi2_grid],
        'chi2_grid_dense': cov['chi2_dense'],
        'max_abs_grid_minus_dense':
            float(np.max(np.abs(chi2_grid - chi2_dense)))})
    in_fit.update({'names': names, 'params': points,
                   'derivative_points': d_points})
    OUT.write_text(json.dumps({
        'config': 'synthetic-desi-marg-full: make_jax_metal_dataset(work, '
                  "DESI_METALS, cross=True, size='full', "
                  'sample=DESI_MARG_SAMPLE, extra_model=marg_extra_model('
                  'desi_extra_model()), new_metals=True, '
                  'with_distortion=True, noise=MARG_NOISE)',
        'noise': MARG_NOISE,
        'names': names, 'sample': sample,
        'path': 'vega_tpu chi2 / chi2_batch / chi2_value_and_gradient / '
                'minimize(), CPU, f64, VEGA_TPU_DS_MATMUL=0, '
                'OMP_NUM_THREADS=1',
        'cov_path': 'templates in the covariance: VEGA_TPU_FACTORED=0 '
                    '(dense) and the defaults (grid route)',
        'in_fit_path': 'main_in_fit.ini: [control] marginalize-in-fit = '
                       'True (every call dense)',
        'made_by': 'tests/tools/make_torch_port_marg_goldens.py',
        'cov': cov, 'in_fit': in_fit,
        'seconds_on_the_cpu': seconds,
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s: {seconds}; dense fit '
          f'{cov["fit_dense"]["values"]}, in-fit fit '
          f'{in_fit["fit_dense"]["values"]}')


if __name__ == '__main__':
    main()

"""Write tests/data/torch_port_desi_goldens.json: the JAX package's
(vega_tpu) numbers on the CPU for the configuration synthetic-desi-full,
the full synthetic auto+cross dataset with the DESI DR1 baseline model
(Rogers HCD, Arinyo small-scale NL, QSO radiation on the cross, DESI
instrumental systematics on the auto, the metals SiII(1190), SiII(1193),
SiIII(1207), SiII(1260), CIV(eff) in every LYA tracer with new-metals
matrices from stacked-delta weights rebinned by 3, and the joint
covariance; tests/tools/jax_metal_dataset.py with
vega_tpu_torch.testing.desi_extra_model(), DESI_METALS, new_metals=True,
global_cov=True), DESI's 17 sampled names and Gaussian priors, and the
exact f64 payload contractions (VEGA_TPU_DS_MATMUL=0):

- dense regime, joint covariance (every call is dense there): chi2_batch
  at 8 points drawn around the truth, chi2_value_and_gradient and
  chi2_hessian at DERIVATIVE_POINTS, minimize() from the [sample] start,
  then one seeded global mock through initialize_monte_carlo (its
  initial fit taken as the fit above: `minimize` is not run again) and
  minimize() on it;
- grid regime, per-correlation covariances (the same files without the
  global-cov-file line), 32 x 32 Chebyshev nodes over (ap, at), with
  GRID_NAMES sampled (L0_hcd and the QSO nuisances fixed): chi2_batch at
  the same points, the payload's terms, retained modes and SVD ranks, and
  the dense per-correlation chi^2 there (VEGA_TPU_FACTORED=0);
- the tool's own run time, by part.

The PyTorch port is held against these numbers on the GPU by
chip_smoke.py (its desi phase).

Usage (from the repo root; several minutes on 8 CPU cores):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_desi_goldens.py
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_desi_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(REPO))

# [sample] entries of DESI's 17 names: lower, upper, start, error (the
# limits and errors of vega_tpu/parameters/default_values.txt; L0_hcd's
# upper limit raised from 10, where its value sits, to 30)
SAMPLE = {
    'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
    'bias_LYA': '-1.0 0.0 -0.12 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1',
    'bias_QSO': '0.0 6.0 3.6 0.1',
    'sigma_velo_disp_lorentz_QSO': '0.0 15.0 6.5 0.5',
    'drp_QSO': '-3.0 3.0 0.1 0.1', 'qso_rad_strength': '0.0 2.0 0.7 0.1',
    'bias_hcd': '-0.5 0.0 -0.055 0.01', 'beta_hcd': '0.0 5.0 0.65 0.1',
    'L0_hcd': '0.0 30.0 9.0 1.0',
    'bias_SiII(1190)': '-0.5 0.0 -0.005 0.001',
    'bias_SiII(1193)': '-0.5 0.0 -0.0025 0.001',
    'bias_SiIII(1207)': '-0.5 0.0 -0.007 0.001',
    'bias_SiII(1260)': '-0.5 0.0 -0.0045 0.001',
    'bias_CIV(eff)': '-0.5 0.0 -0.012 0.001',
    'desi_inst_sys_amp': '0.0 0.01 0.0003 0.00005',
}
MC_SEED = 7
# the grid regime's names: (ap, at) on the grid, the linear ones in the
# coefficient program; L0_hcd and the QSO nuisances stay fixed
GRID_NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA', 'bias_QSO', 'bias_hcd',
              'beta_hcd', 'bias_SiII(1190)', 'bias_SiII(1193)',
              'bias_SiIII(1207)', 'bias_SiII(1260)', 'bias_CIV(eff)',
              'qso_rad_strength', 'desi_inst_sys_amp')
N_POINTS = 8


def extra_control():
    """[control] lines, then the [priors], [monte carlo] (the same
    entries as [sample]) and an empty [mc parameters] section."""
    from vega_tpu_torch.testing import DESI_PRIORS, priors_section
    return (f'mc_seed = {MC_SEED}\n' + priors_section(DESI_PRIORS)
            + '\n[monte carlo]\n'
            + '\n'.join(f'{k} = {v}' for k, v in SAMPLE.items())
            + '\n\n[mc parameters]\n')


def truth():
    """The configuration's values of the sampled names."""
    from vega_tpu_torch.testing import DEFAULT_PARAMS, DESI_PARAMETERS
    values = {**DEFAULT_PARAMS, **DESI_PARAMETERS}
    return {name: values[name] for name in SAMPLE}


def draw_points(n_rows):
    """Rows 1% around the truth (0.001 around a zero value), as bench.py
    draws its batch."""
    import numpy as np
    rng = np.random.default_rng(0)
    return {name: (val + 0.01 * (abs(val) or 0.1)
                   * rng.normal(size=n_rows)).tolist()
            for name, val in truth().items()}


def derivative_points():
    """Two points off the truth in every sampled name."""
    t = truth()
    return [{n: v + 0.02 * (abs(v) or 0.1) for n, v in t.items()},
            {n: v - 0.03 * (abs(v) or 0.1) for n, v in t.items()}]


def grid_ini(main_ini):
    """The main ini without its global-cov-file line, beside it."""
    main_ini = Path(main_ini)
    path = main_ini.parent / 'main_grid.ini'
    path.write_text(re.sub(r'global-cov-file = .*\n', '\n',
                           main_ini.read_text()))
    return path


def derivatives(vega, points, names):
    out = {'chi2': [], 'gradient': [], 'hessian': []}
    for point in points:
        value, grad = vega.chi2_value_and_gradient(point)
        hess = vega.chi2_hessian(point, list(names))
        out['chi2'].append(value)
        out['gradient'].append([grad[n] for n in names])
        out['hessian'].append([[hess[a][b] for b in names] for a in names])
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
    from vega_tpu_torch.testing import DESI_METALS, desi_extra_model

    names = list(SAMPLE)
    points = draw_points(N_POINTS)
    batch = {k: np.asarray(v) for k, v in points.items()}
    grid_batch = {k: batch[k] for k in GRID_NAMES}
    d_points = derivative_points()
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        main_ini = make_jax_metal_dataset(
            work, list(DESI_METALS), cross=True, size='full', sample=SAMPLE,
            extra_model=desi_extra_model(), new_metals=True,
            global_cov=True, extra_control=extra_control())
        seconds['dataset'] = time.perf_counter() - t_start

        vega = VegaInterface(main_ini)
        t0 = time.perf_counter()
        chi2_default = float(vega.chi2())
        chi2_dense = np.asarray(vega.chi2_batch(batch))
        seconds['dense_chi2_batch'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = derivatives(vega, d_points, names)
        seconds['dense_derivatives'] = time.perf_counter() - t0
        fit_dense = fit(vega, names)
        # one seeded global mock around the best fit above, and its fit
        vega.minimize = lambda: None
        t0 = time.perf_counter()
        mock = np.asarray(vega.initialize_monte_carlo())
        seconds['mock'] = time.perf_counter() - t0
        del vega.minimize
        fit_mock = fit(vega, names)

        grid_main = grid_ini(main_ini)
        grid_vega = VegaInterface(grid_main)
        t0 = time.perf_counter()
        payload = grid_vega.get_collapsed(tuple(sorted(GRID_NAMES)))
        seconds['collapse'] = time.perf_counter() - t0
        chi2_grid = np.asarray(grid_vega.chi2_batch(grid_batch))
        os.environ['VEGA_TPU_FACTORED'] = '0'
        chi2_grid_dense = np.asarray(
            VegaInterface(grid_main).chi2_batch(grid_batch))
    for label, values in (('dense', chi2_dense), ('grid', chi2_grid),
                          ('grid dense', chi2_grid_dense)):
        if not np.all(np.isfinite(values)) or np.any(values >= 1e100):
            raise SystemExit(f'unexpected {label} chi2: {values}')
    seconds['tool'] = time.perf_counter() - t_start
    spec = payload['__grid__']
    OUT.write_text(json.dumps({
        'config': 'synthetic-desi-full: make_jax_metal_dataset(work, '
                  "DESI_METALS, cross=True, size='full', sample=SAMPLE, "
                  'extra_model=desi_extra_model(), new_metals=True, '
                  'global_cov=True, extra_control=extra_control)',
        'names': names, 'sample': SAMPLE,
        'extra_control': extra_control(), 'mc_seed': MC_SEED,
        'grid_names': list(GRID_NAMES),
        'path': 'vega_tpu chi2_batch / chi2_value_and_gradient / '
                'chi2_hessian / minimize() / initialize_monte_carlo(), CPU, '
                'f64, VEGA_TPU_DS_MATMUL=0',
        'dense_path': 'the joint covariance (always dense)',
        'grid_path': 'main_grid.ini (no global-cov-file), defaults (grid '
                     'collapse, 32 x 32 nodes), GRID_NAMES sampled',
        'made_by': 'tests/tools/make_torch_port_desi_goldens.py',
        'chi2_default': chi2_default,
        'params': points,
        'chi2_dense': [float(c) for c in chi2_dense],
        'derivative_points': d_points, 'dense': dense,
        'fit_dense': fit_dense,
        'mock': {'size': int(mock.size), 'sum': float(mock.sum()),
                 'first': [float(v) for v in mock[:8]]},
        'fit_mock': fit_mock,
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
        'seconds_on_the_cpu': seconds,
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s: {seconds}; dense fit '
          f'{fit_dense["values"]}, mock fit {fit_mock["values"]}')


if __name__ == '__main__':
    main()

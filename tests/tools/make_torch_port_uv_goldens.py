"""Write tests/data/torch_port_uv_goldens.json: the JAX package's
(vega_tpu) numbers on the CPU for the configuration synthetic-dr16-uv,
the full synthetic auto + cross dataset with the DR16-shaped model and
the reference's own model terms (UV fluctuations and shotnoise in both
correlations; the relativistic correction, the standard asymmetry and
Croom's QSO evolution on the cross; tests/tools/jax_metal_dataset.py
with vega_tpu_torch.testing.dr16_uv_extra_model(), DR16_METALS and
DR16_UV_SAMPLE's twelve names), with the exact f64 payload contractions
(VEGA_TPU_DS_MATMUL=0):

- chi2_batch at 8 points drawn around the truth on the dense path
  (VEGA_TPU_FACTORED=0) and on vega_tpu's route (the defaults: the auto
  from the 32 x 32 grid payload, the cross dense), with the correlations
  the payload holds and each one's terms;
- chi2_value_and_gradient at DERIVATIVE_POINTS on both;
- minimize() on the dense path from the [sample] start;
- one dense chi^2 of each variant the configuration cannot carry
  (VARIANTS, at VARIANT_POINT): HeII reionization, the split bias
  evolution with OMEGAM in the cross's header, single_multipole = 0 and
  fht_extrap on the auto without its metals, each a copy of the files
  made by vega_tpu_torch.testing.dataset_variant.

Model vectors are not stored. The PyTorch port is held against these
numbers on the GPU by chip_smoke.py (its uv phase).

Usage (from the repo root; about 6 minutes on 8 CPU cores):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_uv_goldens.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_uv_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))

TRUTH = {'ap': 1.0, 'at': 1.0, 'bias_LYA': -0.117, 'beta_LYA': 1.67,
         'bias_hcd': -0.052, 'beta_hcd': 0.65, 'bias_SiII(1260)': -0.002,
         'bias_SiIII(1207)': -0.004, 'bias_gamma': 0.1125,
         'uv_shotnoise_amp': 0.0, 'Arel1': -13.5, 'Aasy0': 1.0}
# the rows' spread: 1% of each value, 1e-4 for the shotnoise amplitude,
# whose truth is 0
SPREAD = {name: 0.01 * abs(val) for name, val in TRUTH.items()}
SPREAD['uv_shotnoise_amp'] = 1e-4
N_POINTS = 8
DERIVATIVE_POINTS = [
    {'ap': 1.03, 'at': 0.97, 'bias_LYA': -0.12, 'beta_LYA': 1.6,
     'bias_hcd': -0.05, 'beta_hcd': 0.7, 'bias_SiII(1260)': -0.0025,
     'bias_SiIII(1207)': -0.0035, 'bias_gamma': 0.1, 'uv_shotnoise_amp':
     2e-4, 'Arel1': -12.0, 'Aasy0': 1.3},
    {'ap': 0.96, 'at': 1.04, 'bias_LYA': -0.11, 'beta_LYA': 1.75,
     'bias_hcd': -0.06, 'beta_hcd': 0.55, 'bias_SiII(1260)': -0.0015,
     'bias_SiIII(1207)': -0.0045, 'bias_gamma': 0.13, 'uv_shotnoise_amp':
     -1e-4, 'Arel1': -15.0, 'Aasy0': 0.8},
]
# each variant: dataset_variant's arguments
VARIANTS = {
    'heii': {'auto': 'HeII-reionization = True\n',
             'cross': 'HeII-reionization = True\n',
             'parameters': 'bias_gamma_e = 0.01\nlambda_HeII = 30.\n'},
    'new_bias_evolution': {'cross': 'new-bias-evolution = True\n',
                           'omega_m': 0.315,
                           'qso_z_evol': 'bias_vs_z_std'},
    'single_multipole': {'auto': 'single_multipole = 0\n'},
    'fht_extrap': {'auto': 'fht_extrap = True\n', 'auto_metals': False},
}
VARIANT_POINT = DERIVATIVE_POINTS[0]


def draw_points(n_rows):
    """Rows around the truth (SPREAD), as bench.py draws its batch."""
    import numpy as np
    rng = np.random.default_rng(0)
    return {name: (val + SPREAD[name] * rng.normal(size=n_rows)).tolist()
            for name, val in TRUTH.items()}


def derivatives(vega, names):
    out = {'chi2': [], 'gradient': []}
    for point in DERIVATIVE_POINTS:
        value, grad = vega.chi2_value_and_gradient(point)
        out['chi2'].append(value)
        out['gradient'].append([grad[n] for n in names])
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
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import numpy as np
    from jax_metal_dataset import make_jax_metal_dataset
    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu_torch.testing import (DR16_METALS, DR16_UV_SAMPLE,
                                        DR16_UV_SAMPLED, dataset_variant,
                                        dr16_uv_extra_model)

    names = list(DR16_UV_SAMPLED)
    points = draw_points(N_POINTS)
    batch = {k: np.asarray(v) for k, v in points.items()}
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        main_ini = make_jax_metal_dataset(
            Path(work) / 'uv', list(DR16_METALS), cross=True, size='full',
            sample=DR16_UV_SAMPLE, extra_model=dr16_uv_extra_model(),
            qso_z_evol='croom')
        seconds['dataset'] = time.perf_counter() - t_start
        route_vega = VegaInterface(main_ini)
        t0 = time.perf_counter()
        payload = route_vega.get_collapsed(tuple(sorted(names)))
        seconds['collapse'] = time.perf_counter() - t0
        chi2_route = np.asarray(route_vega.chi2_batch(batch))
        t0 = time.perf_counter()
        route = derivatives(route_vega, names)
        seconds['route_derivatives'] = time.perf_counter() - t0
        os.environ['VEGA_TPU_FACTORED'] = '0'
        dense_vega = VegaInterface(main_ini)
        t0 = time.perf_counter()
        chi2_dense = np.asarray(dense_vega.chi2_batch(batch))
        seconds['dense_chi2_batch'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = derivatives(dense_vega, names)
        seconds['dense_derivatives'] = time.perf_counter() - t0
        fit_dense = fit(dense_vega, names)
        variants = {}
        for label, changes in VARIANTS.items():
            t0 = time.perf_counter()
            variant = VegaInterface(dataset_variant(
                main_ini, Path(work) / label, **changes))
            value = float(np.asarray(variant.chi2_batch(
                {k: np.asarray([v]) for k, v in VARIANT_POINT.items()}))[0])
            variants[label] = {'changes': changes, 'chi2_dense': value}
            seconds[f'variant_{label}'] = time.perf_counter() - t0
    for name, values in (('route', chi2_route), ('dense', chi2_dense)):
        if not np.all(np.isfinite(values)) or np.any(values >= 1e100):
            raise SystemExit(f'unexpected {name} chi2: {values}')
    seconds['tool'] = time.perf_counter() - t_start
    spec = payload['__grid__']
    OUT.write_text(json.dumps({
        'config': 'synthetic-dr16-uv: make_jax_metal_dataset(work, '
                  "DR16_METALS, cross=True, size='full', "
                  'sample=DR16_UV_SAMPLE, extra_model=dr16_uv_extra_model(), '
                  "qso_z_evol='croom')",
        'names': names, 'sample': DR16_UV_SAMPLE,
        'path': 'vega_tpu chi2_batch / chi2_value_and_gradient / '
                'minimize(), CPU, f64, VEGA_TPU_DS_MATMUL=0',
        'route_path': 'defaults (grid collapse, 32 x 32 nodes, where the '
                      'model stays factored)',
        'dense_path': 'VEGA_TPU_FACTORED=0',
        'made_by': 'tests/tools/make_torch_port_uv_goldens.py',
        'grid_spec': {'names': list(spec.names), 'lo': list(spec.lo),
                      'hi': list(spec.hi), 'degrees': list(spec.degrees),
                      'ref': list(spec.ref)},
        'route_keys': sorted(payload),
        'payload': {
            name: {'modes_A': int(p['modes_A'].shape[1]),
                   'rank_A': int(p['B_A'].shape[1]),
                   'modes_sy': int(p['modes_sy'].shape[1]),
                   'rank_sy': int(p['B_sy'].shape[1]),
                   'terms': int(p['cref'].shape[0]),
                   'dc_max': float(p['dc_max'])}
            for name, p in payload.items() if name != '__grid__'},
        'params': points,
        'chi2_route': [float(c) for c in chi2_route],
        'chi2_dense': [float(c) for c in chi2_dense],
        'max_abs_route_minus_dense':
            float(np.max(np.abs(chi2_route - chi2_dense))),
        'derivative_points': DERIVATIVE_POINTS,
        'route': route, 'dense': dense, 'fit_dense': fit_dense,
        'variant_point': VARIANT_POINT, 'variants': variants,
        'seconds_on_the_cpu': seconds,
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s: {seconds}; dense fit '
          f'{fit_dense["values"]}; variants {variants}')


if __name__ == '__main__':
    main()

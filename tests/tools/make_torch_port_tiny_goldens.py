"""Write tests/data/torch_port_tiny_goldens.json: the JAX package's
(vega_tpu) numbers on the CPU for tiny configurations the CPU tests
build, so that the tests hold the port against them without tracing
vega_tpu's likelihood again:

- 'uv': synthetic-dr16-uv at size='tiny' (tests/test_torch_model_terms.py's
  `uv_main`): the dense chi^2 at DENSE_ROWS, chi^2 and gradient at POINT
  on the dense path and on vega_tpu's route, the correlations the route
  collapses (for the twelve names, the nuisance names and with lambda_uv
  sampled), the auto's reference coefficients and the route's chi^2 at
  ROUTE_ROWS;
- 'variants': each of tests/test_torch_model_terms.py's VARIANTS, chi^2
  and gradient at VARIANT_POINT, the correlations collapsed, and for heii
  the route's chi^2 at VARIANT_ROWS; 'croom_new_bias': the error of
  Croom's evolution beside the split one;
- 'dr16_terms': tests/test_torch_metals.py's TERM_CASES on its 'dr16'
  configuration, the dense chi^2 of TERM_ROWS;
- 'fht_extrap_published': tests/test_torch_mocks.py's `fht_extrap`
  configuration (the tiny published DR16 with fht_extrap), each model at
  the defaults and chi^2;
- 'dr16pub_fit': tests/test_torch_dr16_published_fit.py's configuration
  (the tiny published DR16, 18 names): the dense chi^2 of DENSE_ROWS,
  chi^2 and gradient at two points; on vega_tpu's route the correlations
  of the payload, their reference coefficients, chi^2 of ROUTE_ROWS,
  chi^2, gradient and Hessian at ROUTE_POINT, and minimize() from the
  [sample] start;
- 'mocks_fit': tests/test_torch_mocks_fit.py's DESI mock and LyaCoLoRe
  configurations, each record of that module's `dense_record`,
  `grid_record` and `fit_record` on vega_tpu's interfaces;
- 'marginalization': tests/test_torch_marginalization.py's
  configurations (its `make_base` files with `with_marg`'s options): on
  the covariance route the dense chi^2 of ROWS, chi^2, coefficients and
  log-likelihood at the defaults, value and gradient at POINT dense and
  on the grid route, the route's chi^2 of ROWS, minimize() with the
  best-fit coefficients; under marginalize-in-fit chi^2 of ROWS, value,
  gradient and Hessian at POINT, chi2 / log_lik with return_marg_coeff,
  minimize() with the best-fit coefficients and the results file's
  marg_coeff header keys; a Monte-Carlo mock and its coefficients at
  MC_POINT; the joint covariance's chi^2 of ROWS and log-likelihood.

Each configuration is written with the tests' own builders and
arguments, so the files are the tests' own: vega_tpu's, except for
'marginalization', whose module builds its files with the port's
make_synthetic_dataset on the CPU (vega_tpu's numbers are taken on those
files here). The points are stored beside the numbers and the tests read
them from here.

Usage (from the repo root; about 6 minutes on 8 CPU cores):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_tiny_goldens.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_tiny_goldens.json'
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(REPO / 'tests'))


def rows_of(rows):
    return {k: [float(x) for x in v] for k, v in rows.items()}


def value_gradient(vega, point):
    value, grad = vega.chi2_value_and_gradient(point)
    return {'chi2': float(value),
            'gradient': [float(grad[n]) for n in point]}


def uv_goldens(work, mt, JaxInterface):
    import numpy as np
    from jax_metal_dataset import make_jax_metal_dataset
    from vega_tpu_torch.testing import (DR16_METALS, DR16_UV_SAMPLE,
                                        dataset_variant,
                                        dr16_uv_extra_model)
    main = make_jax_metal_dataset(
        Path(work) / 'uv', list(DR16_METALS), cross=True, size='tiny',
        sample=DR16_UV_SAMPLE, extra_control=mt.CONTROL,
        extra_model=dr16_uv_extra_model(), qso_z_evol='croom')
    dense_rows = mt.draw_rows(5, 1)
    route_rows = mt.draw_rows(8, 3)
    point = {n: float(v[0]) for n, v in mt.draw_rows(1, 5).items()}
    route = JaxInterface(main)
    keys = {}
    for label, names in (('names', mt.NAMES), ('nuisance', mt.NUISANCE),
                         ('lambda', mt.LAMBDA_NAMES)):
        payload = route.get_collapsed(tuple(sorted(names)))
        keys[label] = sorted(payload)
        if 'lyaxlya' in payload:
            ref = payload['lyaxlya']['cref' if '__grid__' in payload
                                     else 'c0']
            keys[f'{label}_ref'] = [float(x) for x in ref]
    out = {'dense_rows': rows_of(dense_rows),
           'route_rows': rows_of(route_rows), 'point': point,
           'keys': keys,
           'chi2_route': [float(c) for c in np.asarray(route.chi2_batch(
               {k: np.asarray(v) for k, v in route_rows.items()}))],
           'route': value_gradient(route, point)}
    os.environ['VEGA_TPU_FACTORED'] = '0'
    dense = JaxInterface(main)
    out['chi2_dense'] = [float(c) for c in np.asarray(dense.chi2_batch(
        {k: np.asarray(v) for k, v in dense_rows.items()}))]
    out['dense'] = value_gradient(dense, point)
    os.environ.pop('VEGA_TPU_FACTORED')

    variants = {}
    for label, changes in mt.VARIANTS.items():
        vmain = dataset_variant(main, Path(work) / label, **changes)
        entry = {}
        if label in ('heii', 'new_bias_evolution'):
            os.environ['VEGA_TPU_FACTORED'] = '0'
        vega = JaxInterface(vmain)
        entry['keys'] = sorted(vega.get_collapsed(
            tuple(sorted(mt.VARIANT_POINT))))
        entry.update(value_gradient(vega, mt.VARIANT_POINT))
        os.environ.pop('VEGA_TPU_FACTORED', None)
        if label == 'heii':
            vega = JaxInterface(vmain)
            entry['route_keys'] = sorted(vega.get_collapsed(
                tuple(sorted(mt.VARIANT_POINT))))
            entry['chi2_route'] = [float(c) for c in np.asarray(
                vega.chi2_batch({k: np.asarray(v) for k, v in
                                 mt.VARIANT_ROWS.items()}))]
        variants[label] = entry
    out['variants'] = variants
    os.environ['VEGA_TPU_FACTORED'] = '0'
    vmain = dataset_variant(main, Path(work) / 'croom', omega_m=0.315,
                            cross='new-bias-evolution = True\n')
    try:
        JaxInterface(vmain).chi2()
        out['croom_new_bias'] = None
    except AssertionError as err:
        out['croom_new_bias'] = f'AssertionError: {err}'
    os.environ.pop('VEGA_TPU_FACTORED')
    return out


def dr16_terms_goldens(work, tm, JaxInterface):
    import numpy as np
    from jax_metal_dataset import make_jax_metal_dataset
    metals, model, params, _ = tm.VARIANTS['dr16']
    main = make_jax_metal_dataset(
        Path(work) / 'dr16', list(metals), cross=True, size='tiny',
        extra_control=tm.CONTROL,
        extra_model=model + tm.dr16_extra_model(
            parameters={**tm.DR16_PARAMETERS, **params}))
    rows = {k: v for k, v in tm.draw_rows(2, 6).items()
            if k in tm.NAMES[:4]}
    out = {'rows': rows_of(rows), 'chi2': {}}
    os.environ['VEGA_TPU_FACTORED'] = '0'
    for case, (corr, line) in {**tm.TERM_CASES,
                               'marginalization': tm.MARG_CASE}.items():
        case_dir = Path(work) / f'dr16_{case}'
        case_dir.mkdir()
        case_main = tm.with_option(main, case_dir, corr, line,
                                   drop_metals=case == 'fht_extrap')
        out['chi2'][case] = [float(c) for c in np.asarray(
            JaxInterface(case_main).chi2_batch(
                {k: np.asarray(v) for k, v in rows.items()}))]
    os.environ.pop('VEGA_TPU_FACTORED')
    return out


def fht_extrap_published_goldens(work, mocks, JaxInterface):
    from jax_dr16pub_dataset import make_jax_dr16_published_dataset
    main = make_jax_dr16_published_dataset(
        Path(work) / 'fht_extrap', size='tiny',
        extra_control=mocks.DR16PUB_CONTROL)
    for ini in Path(main).parent.glob('ly*.ini'):
        ini.write_text(ini.read_text().replace(
            '[model]\n', '[model]\nfht_extrap = True\n'))
    os.environ['VEGA_TPU_FACTORED'] = '0'
    ref = JaxInterface(main)
    models = ref.compute_model(run_init=False)
    out = {'models': {name: [float(x) for x in models[name]]
                      for name in ref.corr_items},
           'chi2': float(ref.chi2())}
    os.environ.pop('VEGA_TPU_FACTORED')
    return out


def dr16pub_fit_goldens(work, pf, JaxInterface):
    import numpy as np
    from jax_dr16pub_dataset import make_jax_dr16_published_dataset
    main = make_jax_dr16_published_dataset(
        Path(work) / 'dr16pub_fit', size='tiny', extra_control=pf.CONTROL)
    names = list(pf.NAMES)
    ref = JaxInterface(main)
    route_rows = pf.draw_rows(ref.params, 6, 3)
    point = {n: float(ref.sample_params['values'][n]) for n in names}
    point['ap'], point['at'] = 1.01, 0.99
    payload = ref.get_collapsed(tuple(names))
    value, grad = ref.chi2_value_and_gradient(point)
    hess = ref.chi2_hessian(point, names)
    out = {'route_rows': rows_of(route_rows), 'route_point': point,
           'route_keys': sorted(payload),
           'cref': {c: [float(x) for x in payload[c]['cref']]
                    for c in payload if c != '__grid__'},
           'chi2_route': [float(c) for c in np.asarray(ref.chi2_batch(
               {k: np.asarray(v) for k, v in route_rows.items()}))],
           'route': {'chi2': float(value),
                     'gradient': [float(grad[n]) for n in names],
                     'hessian': [[float(hess[a][b]) for b in names]
                                 for a in names]}}
    ref.minimize()
    best = ref.bestfit
    out['fit'] = {'values': [float(best.values[n]) for n in names],
                  'errors': [float(best.errors[n]) for n in names],
                  'fval': float(best.fmin.fval)}
    os.environ['VEGA_TPU_FACTORED'] = '0'
    dense = JaxInterface(main)
    dense_rows = pf.draw_rows(dense.params, 5, 1)
    points = pf.draw_rows(dense.params, 2, 2)
    out['dense_rows'] = rows_of(dense_rows)
    out['chi2_dense'] = [float(c) for c in np.asarray(dense.chi2_batch(
        {k: np.asarray(v) for k, v in dense_rows.items()}))]
    out['dense_points'] = []
    for i in range(2):
        point = {n: float(v[i]) for n, v in points.items()}
        out['dense_points'].append(dict(value_gradient(dense, point),
                                        point=point))
    os.environ.pop('VEGA_TPU_FACTORED')
    return out


def mocks_fit_goldens(work, mf, JaxInterface):
    from jax_mocks_dataset import (make_jax_desi_mock_dataset,
                                   make_jax_lyacolore_dataset)
    from vega_tpu_torch.testing import (DESI_MOCK_FIT_SAMPLE,
                                        DESI_MOCK_GRID_NAMES,
                                        LYACOLORE_FIT_SAMPLE, with_sample)
    main = make_jax_desi_mock_dataset(
        Path(work) / 'desi_mock_fit', size='tiny',
        sample=DESI_MOCK_FIT_SAMPLE, extra_control=mf.CONTROL)
    grid_main = with_sample(main, {n: DESI_MOCK_FIT_SAMPLE[n]
                                   for n in DESI_MOCK_GRID_NAMES},
                            Path(main).parent / 'main_grid.ini')
    out = {}
    grid = JaxInterface(grid_main)
    out['desi_mock_grid'] = mf.grid_record(grid, DESI_MOCK_GRID_NAMES)
    out['desi_mock_fit'] = mf.fit_record(grid)
    lyacolore = make_jax_lyacolore_dataset(
        Path(work) / 'lyacolore_fit', size='tiny',
        sample=LYACOLORE_FIT_SAMPLE, extra_control=mf.LYACOLORE_CONTROL)
    vega = JaxInterface(lyacolore)
    out['lyacolore_dense'] = mf.dense_record(
        vega, list(LYACOLORE_FIT_SAMPLE), seed=3)
    out['lyacolore_fit'] = mf.fit_record(vega)
    os.environ['VEGA_TPU_FACTORED'] = '0'
    out['desi_mock_dense'] = mf.dense_record(
        JaxInterface(main), list(DESI_MOCK_FIT_SAMPLE), seed=1)
    os.environ.pop('VEGA_TPU_FACTORED')
    return out


def marginalization_goldens(work, tm, JaxInterface):
    import numpy as np
    from vega_tpu.io.fits import read_fits
    names = list(tm.SAMPLE)
    rows = {k: np.asarray(v) for k, v in tm.ROWS.items()}

    def marg_fit(vega):
        record = fit_record(vega)
        stats = vega.bestfit_corr_stats
        record['bestfit_marg_coeff'] = {
            n: [float(c) for c in s['bestfit_marg_coeff']]
            for n, s in stats.items()
            if s['bestfit_marg_coeff'] is not None}
        record['masked_size'] = {n: int(s['masked_size'])
                                 for n, s in stats.items()}
        return record

    def coeffs(marg_coeff):
        return {n: [float(c) for c in v] for n, v in marg_coeff.items()}

    work = Path(work)
    base = tm.make_base(work / 'marg_base')
    cov_main = tm.with_marg(base, work / 'marg_cov', tm.BUILD_CONFIG_MARG)
    out = {'cov': {}}
    os.environ['VEGA_TPU_FACTORED'] = '0'
    dense = JaxInterface(cov_main)
    cov = out['cov']
    cov['chi2_dense'] = [float(c) for c in
                         np.asarray(dense.chi2_batch(rows))]
    chi2, marg_coeff = dense.chi2(return_marg_coeff=True)
    cov['chi2_default'] = float(chi2)
    cov['coeff_default'] = coeffs(marg_coeff)
    cov['log_lik_default'] = float(dense.log_lik())
    cov['corr_num_marg_modes'] = {n: int(m) for n, m in
                                  dense.corr_num_marg_modes.items()}
    cov['value_gradient_dense'] = value_gradient(dense, tm.POINT)
    cov['fit'] = marg_fit(dense)
    os.environ.pop('VEGA_TPU_FACTORED')
    route = JaxInterface(cov_main)
    cov['route_keys'] = sorted(route.get_collapsed(tuple(sorted(names))))
    cov['chi2_route'] = [float(c) for c in
                         np.asarray(route.chi2_batch(rows))]
    cov['value_gradient_route'] = value_gradient(route, tm.POINT)

    in_fit_main = tm.with_marg(base, work / 'marg_in_fit', tm.IN_FIT_MARG,
                               control='marginalize-in-fit = True')
    vega = JaxInterface(in_fit_main)
    in_fit = out['in_fit'] = {}
    in_fit['chi2_batch'] = [float(c) for c in
                            np.asarray(vega.chi2_batch(rows))]
    in_fit.update(value_gradient(vega, tm.POINT))
    hess = vega.chi2_hessian(tm.POINT, names)
    in_fit['hessian'] = [[float(hess[a][b]) for b in names] for a in names]
    _, marg_coeff = vega.chi2(tm.POINT, return_marg_coeff=True)
    in_fit['coeff'] = coeffs(marg_coeff)
    log_lik, marg_list = vega.log_lik(tm.POINT, return_marg_coeff=True)
    in_fit['log_lik'] = float(log_lik)
    in_fit['marg_list'] = [float(c) for c in marg_list]
    in_fit['fit'] = marg_fit(vega)
    vega.output.write_results(vega.bestfit_model, vega.params,
                              vega.minimizer, vega.bestfit_corr_stats)
    hdul = read_fits(Path(vega.output.outfile + '.fits'))
    in_fit['fit']['header_marg_keys'] = {
        h.name[len('MODEL_'):]: sorted(k for k in h.header
                                       if 'MARG' in k.upper())
        for h in hdul if h.name.startswith('MODEL_')}

    mc_main = tm.with_marg(base, work / 'marg_mc', tm.IN_FIT_MARG,
                           control=tm.MC_CONTROL, sample={},
                           sections=tm.MC_SECTIONS)
    vega = JaxInterface(mc_main)
    vega.initialize_monte_carlo()
    chi2, marg_coeff = vega.chi2(tm.MC_POINT, return_marg_coeff=True)
    out['mc'] = {'mock_sum': {n: float(d.masked_mc_mock.sum())
                              for n, d in vega.data.items()},
                 'chi2': float(chi2), 'coeff': coeffs(marg_coeff)}

    joint_base = tm.make_base(work / 'marg_joint_base', global_cov=True)
    vega = JaxInterface(tm.with_marg(joint_base, work / 'marg_joint',
                                     tm.BUILD_CONFIG_MARG))
    out['joint'] = {'chi2': [float(c) for c in
                             np.asarray(vega.chi2_batch(rows))],
                    'log_lik_default': float(vega.log_lik())}
    out['rows'] = rows_of(rows)
    out['point'] = tm.POINT
    return out


def fit_record(vega):
    """minimize() from the [sample] start: values, errors, fval."""
    vega.minimize()
    best = vega.bestfit
    return {'values': {n: float(best.values[n]) for n in best.values},
            'errors': {n: float(best.errors[n]) for n in best.values},
            'fval': float(best.fmin.fval),
            'is_valid': bool(best.fmin.is_valid)}


def main():
    t_start = time.perf_counter()
    os.environ['VEGA_TPU_DS_MATMUL'] = '0'
    os.environ['VEGA_TPU_GRID_CACHE'] = '0'
    os.environ['VEGA_TPU_COMP_CACHE'] = '0'
    for name in ('VEGA_TPU_FACTORED', 'VEGA_TPU_GRID_COLLAPSE'):
        os.environ.pop(name, None)
    sys.path.insert(0, str(REPO))
    import conftest  # noqa: F401  (jax on the CPU, x64; as the tests run)
    import test_torch_dr16_published_fit as pf
    import test_torch_marginalization as marg
    import test_torch_metals as tm
    import test_torch_mocks as mocks
    import test_torch_mocks_fit as mf
    import test_torch_model_terms as mt
    from vega_tpu.vega_interface import VegaInterface as JaxInterface

    seconds = {}
    out = {'made_by': 'tests/tools/make_torch_port_tiny_goldens.py',
           'path': 'vega_tpu, CPU, f64, VEGA_TPU_DS_MATMUL=0'}
    with tempfile.TemporaryDirectory() as work:
        for key, build, module in (
                ('uv', uv_goldens, mt),
                ('dr16_terms', dr16_terms_goldens, tm),
                ('fht_extrap_published', fht_extrap_published_goldens,
                 mocks),
                ('dr16pub_fit', dr16pub_fit_goldens, pf),
                ('mocks_fit', mocks_fit_goldens, mf),
                ('marginalization', marginalization_goldens, marg)):
            t0 = time.perf_counter()
            out[key] = build(work, module, JaxInterface)
            seconds[key] = time.perf_counter() - t0
    seconds['tool'] = time.perf_counter() - t_start
    out['seconds_on_the_cpu'] = seconds
    OUT.write_text(json.dumps(out, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s: {seconds}')


if __name__ == '__main__':
    main()

"""The scale parametrisations of [cosmo-fit type] in the PyTorch port
against the JAX package's, on one tiny synthetic auto+cross dataset made
by vega_tpu: aiso_epsilon, phi_alpha, smooth-scaling, full-shape,
full-shape-alpha and two-alpha-smooth, each with its two scale names
sampled beside bias_LYA and beta_LYA at the points of
tests/tools/variant_configs.py. The dense chi^2 (VEGA_TPU_FACTORED=0) of
the port against vega_tpu's dense chi^2, and chi2_batch on vega_tpu's
route (the two scale names on an 8 x 8 grid payload, the linear names in
its coefficient program, the exact f64 contractions) against vega_tpu's
route."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser

import numpy as np
import pytest

from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch.vega_interface import VegaInterface

DENSE_RTOL = 1e-13      # dense chi^2, port vs vega_tpu, relative
# the route's chi^2, port vs vega_tpu: |d chi2| <= ROUTE_ABS, the upper
# figure ROADMAP.md section 3 recorded for these cases (4.9e-11 to 1.2e-8
# at 32 x 32 nodes; 0 to 7.6e-11 here at 8 x 8); the two payloads are
# swept from the same nodes in f64
ROUTE_ABS = 1.2e-8

# [cosmo-fit type] options, [parameters] values and the two scale names
# of each case (tests/tools/variant_configs.py); 'full_shape' is
# phi_alpha with full-shape, whose peak reads phi_full and alpha
CASES = {
    'aiso_epsilon': ({'cosmo fit func': 'aiso_epsilon'},
                     {'aiso': 1.0, 'epsilon': 0.0},
                     [{'aiso': 1.02, 'epsilon': 0.015},
                      {'aiso': 0.96, 'epsilon': -0.03, 'beta_LYA': 1.5}]),
    'phi_alpha': ({'cosmo fit func': 'phi_alpha'},
                  {'phi': 1.0, 'alpha': 1.0},
                  [{'phi': 1.04, 'alpha': 0.97},
                   {'phi': 0.93, 'alpha': 1.05, 'bias_LYA': -0.13}]),
    'smooth_scaling': ({'cosmo fit func': 'phi_alpha',
                        'smooth-scaling': 'True'},
                       {'phi': 1.03, 'alpha': 0.98, 'phi_smooth': 1.0,
                        'alpha_smooth': 1.0},
                       [{'phi_smooth': 1.06, 'alpha_smooth': 0.95},
                        {'phi_smooth': 0.92, 'alpha_smooth': 1.04}]),
    'full_shape': ({'cosmo fit func': 'phi_alpha', 'full-shape': 'True'},
                   {'phi_full': 1.0, 'alpha': 1.0, 'alpha_smooth': 1.0,
                    'phi': 1.0},
                   [{'phi_full': 1.04, 'alpha': 0.97},
                    {'phi_full': 0.95, 'alpha': 1.06, 'beta_LYA': 1.8}]),
    'full_shape_alpha': ({'full-shape': 'True', 'full-shape-alpha': 'True'},
                         {'ap_full': 1.0, 'at_full': 1.0},
                         [{'ap_full': 1.04, 'at_full': 0.96},
                          {'ap_full': 0.95, 'at_full': 1.07,
                           'beta_LYA': 1.8}]),
    # the cross's tracer pair is QSOxLYA in the synthetic files
    'two_alpha_smooth': ({'cosmo fit func': 'phi_alpha',
                          'smooth-scaling': 'True',
                          'two-alpha-smooth': 'True'},
                         {'phi': 1.02, 'alpha': 0.99, 'phi_smooth': 1.0,
                          'alpha_smooth_LYAxLYA': 1.0,
                          'alpha_smooth_QSOxLYA': 1.0},
                         [{'alpha_smooth_LYAxLYA': 1.04,
                           'alpha_smooth_QSOxLYA': 0.95},
                          {'alpha_smooth_LYAxLYA': 1.06,
                           'alpha_smooth_QSOxLYA': 0.93}]),
}
SCALE_NAMES = {case: [n for n in params if n in {k for p in points
                                                 for k in p}]
               for case, (_, params, points) in CASES.items()}


@pytest.fixture(scope='module')
def base(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_FACTORED', '0')
        return jax_make_dataset(tmp_path_factory.mktemp('base'), cross=True,
                                size='tiny', noise=1.0)


def case_main(base, tmp_path, case):
    """The base main.ini with the case's options, values and [sample]:
    its two scale names in [0.8, 1.2] (start at the value, error 0.01) on
    8 nodes each, bias_LYA and beta_LYA; bias_LYA = -0.12."""
    cosmo, params, _ = CASES[case]
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config.read(base)
    config['cosmo-fit type'].update(cosmo)
    config['parameters'].update({k: str(v) for k, v in params.items()})
    config['parameters']['bias_LYA'] = '-0.12'
    names = SCALE_NAMES[case]
    config['sample'] = {n: f'0.8 1.2 {params[n]} 0.01' for n in names}
    config['sample'].update({'bias_LYA': 'True', 'beta_LYA': 'True'})
    config['control'].update({f'grid-nodes-{n}': '8' for n in names})
    config['control']['ds-matmul'] = 'False'
    path = tmp_path / 'main.ini'
    with open(path, 'w') as fh:
        config.write(fh)
    return path


def batch(case, vega):
    """The case's points over the interface's stored values of its
    sampled names, as (P,) columns."""
    names = SCALE_NAMES[case] + ['bias_LYA', 'beta_LYA']
    points = CASES[case][2]
    return {n: np.array([p.get(n, vega.params[n]) for p in points])
            for n in names}


@pytest.mark.parametrize('case', list(CASES))
def test_dense_chi2_matches_jax(base, tmp_path, monkeypatch, case):
    monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
    main = case_main(base, tmp_path, case)
    jax_vega = JaxInterface(main)
    port = VegaInterface(main, device='cpu')
    rows = batch(case, port)
    got = port.chi2_batch(rows).numpy()
    want = np.asarray(jax_vega.chi2_batch(rows))
    assert np.all(np.abs(got - want) <= DENSE_RTOL * np.abs(want))
    # the scale names move the chi^2: the parametrisation is read
    assert np.abs(got[0] - got[1]) > 1e-3


@pytest.mark.parametrize('case', list(CASES))
def test_route_chi2_matches_jax(base, tmp_path, monkeypatch, case):
    """Both packages serve the names from a payload over the case's two
    scale names, and agree within ROUTE_ABS."""
    monkeypatch.delenv('VEGA_TPU_FACTORED', raising=False)
    monkeypatch.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
    monkeypatch.setenv('VEGA_TPU_DS_MATMUL', '0')
    monkeypatch.setenv('VEGA_TPU_GRID_CACHE', '0')
    main = case_main(base, tmp_path, case)
    jax_vega = JaxInterface(main)
    port = VegaInterface(main, device='cpu')
    rows = batch(case, port)
    got = port.chi2_batch(rows).numpy()
    want = np.asarray(jax_vega.chi2_batch(rows))
    payload = port.get_collapsed(frozenset(rows))
    assert set(payload['__grid__'].names) == set(SCALE_NAMES[case])
    assert np.all(np.abs(got - want) <= ROUTE_ABS)

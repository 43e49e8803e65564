"""The two mock configurations as a whole in the PyTorch port against the
JAX package (vega_tpu) on the CPU, at size='tiny': DESI DR1's baseline as
run on mocks (make_desi_mock_dataset: full-shape smoothing in [model] and
[metals], new-metals matrices of four Si lines) and the LyaCoLoRe
raw-mock auto (make_lyacolore_dataset: the DR9LyaMocks template, the
smoothing widths sampled). Each configuration's dense chi2_batch, value
and gradient, and one minimize() by the route vega_tpu takes: the DESI
mock's linear names and (ap, at) on the grid payload, LyaCoLoRe's six
names densely. The JAX side of the datasets is
tests/tools/jax_mocks_dataset.py, and vega_tpu's numbers on them are
tests/data/torch_port_tiny_goldens.json ('mocks_fit', made by
tests/tools/make_torch_port_tiny_goldens.py with this module's
configurations and points, which it stores). Each tolerance stands
beside its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from jax_mocks_dataset import (make_jax_desi_mock_dataset,  # noqa: E402
                               make_jax_lyacolore_dataset)
from vega_tpu_torch.testing import (DESI_MOCK_FIT_SAMPLE,  # noqa: E402
                                    DESI_MOCK_GRID_NAMES,
                                    LYACOLORE_FIT_SAMPLE, with_sample)
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

CHI2_RTOL = 1e-12       # chi^2, relative, on the dense path
DERIV_RTOL = 1e-9       # a gradient, of its largest entry
GRID_ABS, GRID_REL = 2e-4, 1e-9     # vega_tpu's default mode budget
# a fit: best-fit values within FIT_VALUE_SIGMA of the JAX errors, errors
# within FIT_ERROR_RTOL, fval within 1e-8 + 1e-10 fval
FIT_VALUE_SIGMA, FIT_ERROR_RTOL = 1e-3, 1e-5
CONTROL = 'grid-nodes-ap = 8\ngrid-nodes-at = 8\nds-matmul = False\n'
GOLDENS = Path(__file__).resolve().parent / 'data' / \
    'torch_port_tiny_goldens.json'


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def draw_rows(params, names, n_rows, seed):
    rng = np.random.default_rng(seed)
    return {n: params[n] + 0.01 * (abs(params[n]) or 0.1)
            * rng.normal(size=n_rows) for n in names}


def as_rows(rows):
    return {k: np.asarray(v) for k, v in rows.items()}


@pytest.fixture(scope='module')
def goldens():
    return json.loads(GOLDENS.read_text())['mocks_fit']


@pytest.fixture(scope='module')
def env():
    """The exact f64 payload contractions and no payload disk cache, for
    the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        yield mp


def port(env, main, dense):
    """The port's interface on `main`, with VEGA_TPU_FACTORED=0 when
    `dense`."""
    if dense:
        env.setenv('VEGA_TPU_FACTORED', '0')
    try:
        return VegaInterface(main, device='cpu')
    finally:
        env.delenv('VEGA_TPU_FACTORED', raising=False)


@pytest.fixture(scope='module')
def desi_mock(env, tmp_path_factory):
    """The tiny DESI mock written by vega_tpu with DESI_MOCK_FIT_SAMPLE's
    15 names: {'dense': the port with VEGA_TPU_FACTORED=0, 'grid': the
    port on a copy of main.ini sampling DESI_MOCK_GRID_NAMES}."""
    main = make_jax_desi_mock_dataset(
        tmp_path_factory.mktemp('desi_mock_fit'), size='tiny',
        sample=DESI_MOCK_FIT_SAMPLE, extra_control=CONTROL)
    grid_main = with_sample(main, {n: DESI_MOCK_FIT_SAMPLE[n]
                                   for n in DESI_MOCK_GRID_NAMES},
                            Path(main).parent / 'main_grid.ini')
    return {'dense': port(env, main, True),
            'grid': port(env, grid_main, False)}


LYACOLORE_CONTROL = {'grid-nodes-ap': '6', 'grid-nodes-at': '6',
                     'ds-matmul': 'False'}


@pytest.fixture(scope='module')
def lyacolore(env, tmp_path_factory):
    """The tiny LyaCoLoRe configuration written by vega_tpu (BuildConfig)
    with LYACOLORE_FIT_SAMPLE: the port with the defaults (it routes the
    six names densely, as vega_tpu)."""
    main = make_jax_lyacolore_dataset(
        tmp_path_factory.mktemp('lyacolore_fit'), size='tiny',
        sample=LYACOLORE_FIT_SAMPLE, extra_control=LYACOLORE_CONTROL)
    return port(env, main, False)


def dense_record(vega, names, seed):
    """chi2_batch at 4 rows, and chi^2 and gradient at the first."""
    rows = draw_rows(vega.params, names, 4, seed)
    point = {n: float(v[0]) for n, v in rows.items()}
    value, grad = vega.chi2_value_and_gradient(point)
    return {'chi2': [float(c) for c in np.asarray(vega.chi2_batch(rows))],
            'value': float(value),
            'gradient': [float(grad[n]) for n in names]}


def grid_record(vega, names):
    """The correlations the route collapses, and chi2_batch at 4 rows."""
    rows = draw_rows(vega.params, names, 4, seed=2)
    return {'keys': sorted(vega.get_collapsed(tuple(sorted(names)))),
            'chi2': [float(c) for c in np.asarray(vega.chi2_batch(rows))]}


def fit_record(vega):
    """minimize() from the [sample] start."""
    vega.minimize()
    best = vega.bestfit
    return {'values': {n: float(best.values[n]) for n in best.values},
            'errors': {n: float(best.errors[n]) for n in best.values},
            'fval': float(best.fmin.fval),
            'is_valid': bool(best.fmin.is_valid)}


def check_fit(vega, want):
    """minimize() against vega_tpu's (FIT_VALUE_SIGMA, FIT_ERROR_RTOL,
    fval)."""
    got = fit_record(vega)
    assert sorted(got['values']) == sorted(want['values'])
    for name, value in want['values'].items():
        error = want['errors'][name]
        assert abs(got['values'][name] - value) <= FIT_VALUE_SIGMA * error, \
            name
        assert got['errors'][name] == pytest.approx(
            error, rel=FIT_ERROR_RTOL), name
    assert abs(got['fval'] - want['fval']) <= 1e-8 + 1e-10 * abs(want['fval'])
    assert got['is_valid'] and want['is_valid']


def check_dense(vega, want, names, seed):
    """chi2_batch at 4 rows (CHI2_RTOL), value and gradient at one point
    (CHI2_RTOL, DERIV_RTOL) against vega_tpu's."""
    got = dense_record(vega, names, seed)
    assert np.max(np.abs(np.subtract(got['chi2'], want['chi2']))
                  / np.asarray(want['chi2'])) <= CHI2_RTOL
    assert abs(got['value'] - want['value']) <= CHI2_RTOL * want['value']
    assert max_rel(got['gradient'], want['gradient']) <= DERIV_RTOL


def test_desi_mock_dense_matches_jax(desi_mock, goldens):
    """The DESI mock's 15 names on the dense path."""
    check_dense(desi_mock['dense'], goldens['desi_mock_dense'],
                list(DESI_MOCK_FIT_SAMPLE), seed=1)


def test_desi_mock_grid_route_matches_jax(desi_mock, goldens):
    """The grid names with the widths fixed: both packages serve them from
    a payload over (ap, at) holding both correlations, whose chi^2 agree
    within the mode budget, then minimize() on it."""
    vega = desi_mock['grid']
    got = grid_record(vega, DESI_MOCK_GRID_NAMES)
    want = goldens['desi_mock_grid']
    assert got['keys'] == want['keys'] == ['__grid__', 'lyaxlya', 'qsoxlya']
    want_chi2 = np.asarray(want['chi2'])
    assert np.all(np.abs(np.subtract(got['chi2'], want_chi2))
                  <= GRID_ABS + GRID_REL * want_chi2)
    check_fit(vega, goldens['desi_mock_fit'])


def test_lyacolore_dense_matches_jax(lyacolore, goldens):
    """LyaCoLoRe's six names (the widths among them) on the dense path,
    which is vega_tpu's route for them."""
    assert lyacolore.get_collapsed(frozenset(LYACOLORE_FIT_SAMPLE)) == {}
    check_dense(lyacolore, goldens['lyacolore_dense'],
                list(LYACOLORE_FIT_SAMPLE), seed=3)


def test_lyacolore_fit_matches_jax(lyacolore, goldens):
    """minimize() over the six names against vega_tpu's."""
    check_fit(lyacolore, goldens['lyacolore_fit'])

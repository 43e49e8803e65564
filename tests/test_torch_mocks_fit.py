"""The two mock configurations as a whole in the PyTorch port against the
JAX package (vega_tpu) on the CPU, at size='tiny': DESI DR1's baseline as
run on mocks (make_desi_mock_dataset: full-shape smoothing in [model] and
[metals], new-metals matrices of four Si lines) and the LyaCoLoRe
raw-mock auto (make_lyacolore_dataset: the DR9LyaMocks template, the
smoothing widths sampled). Each configuration's dense chi2_batch, value
and gradient, and one minimize() by the route vega_tpu takes: the DESI
mock's linear names and (ap, at) on the grid payload, LyaCoLoRe's six
names densely. The JAX side of the datasets is
tests/tools/jax_mocks_dataset.py. Each tolerance stands beside its use."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from jax_mocks_dataset import (make_jax_desi_mock_dataset,  # noqa: E402
                               make_jax_lyacolore_dataset)
from vega_tpu.vega_interface import VegaInterface as JaxInterface  # noqa: E402
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


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def draw_rows(params, names, n_rows, seed):
    rng = np.random.default_rng(seed)
    return {n: params[n] + 0.01 * (abs(params[n]) or 0.1)
            * rng.normal(size=n_rows) for n in names}


def jax_rows(rows):
    return {k: jnp.asarray(v) for k, v in rows.items()}


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


def interfaces(env, main, dense):
    """(vega_tpu, port) interfaces on `main`, with VEGA_TPU_FACTORED=0
    when `dense`."""
    if dense:
        env.setenv('VEGA_TPU_FACTORED', '0')
    try:
        return JaxInterface(main), VegaInterface(main, device='cpu')
    finally:
        env.delenv('VEGA_TPU_FACTORED', raising=False)


@pytest.fixture(scope='module')
def desi_mock(env, tmp_path_factory):
    """The tiny DESI mock written by vega_tpu with DESI_MOCK_FIT_SAMPLE's
    15 names: {'dense': the interfaces with VEGA_TPU_FACTORED=0, 'grid':
    the interfaces on a copy of main.ini sampling DESI_MOCK_GRID_NAMES}."""
    main = make_jax_desi_mock_dataset(
        tmp_path_factory.mktemp('desi_mock_fit'), size='tiny',
        sample=DESI_MOCK_FIT_SAMPLE, extra_control=CONTROL)
    grid_main = with_sample(main, {n: DESI_MOCK_FIT_SAMPLE[n]
                                   for n in DESI_MOCK_GRID_NAMES},
                            Path(main).parent / 'main_grid.ini')
    return {'dense': interfaces(env, main, True),
            'grid': interfaces(env, grid_main, False)}


@pytest.fixture(scope='module')
def lyacolore(env, tmp_path_factory):
    """The tiny LyaCoLoRe configuration written by vega_tpu (BuildConfig)
    with LYACOLORE_FIT_SAMPLE: (vega_tpu, port) interfaces with the
    defaults (both route the six names densely)."""
    main = make_jax_lyacolore_dataset(
        tmp_path_factory.mktemp('lyacolore_fit'), size='tiny',
        sample=LYACOLORE_FIT_SAMPLE,
        extra_control={'grid-nodes-ap': '6', 'grid-nodes-at': '6',
                       'ds-matmul': 'False'})
    return interfaces(env, main, False)


def check_fit(ref, vega):
    """minimize() of both against each other (FIT_VALUE_SIGMA,
    FIT_ERROR_RTOL, fval)."""
    vega.minimize()
    ref.minimize()
    got, want = vega.bestfit, ref.bestfit
    for name in want.values:
        assert abs(got.values[name] - want.values[name]) <= \
            FIT_VALUE_SIGMA * want.errors[name], name
        assert got.errors[name] == pytest.approx(want.errors[name],
                                                 rel=FIT_ERROR_RTOL), name
    assert abs(got.fmin.fval - want.fmin.fval) <= \
        1e-8 + 1e-10 * abs(want.fmin.fval)
    assert got.fmin.is_valid


def check_dense(ref, vega, names, seed):
    """chi2_batch at 4 rows (CHI2_RTOL), value and gradient at one point
    (CHI2_RTOL, DERIV_RTOL) against vega_tpu's."""
    rows = draw_rows(vega.params, names, 4, seed)
    got = vega.chi2_batch(rows).numpy()
    want = np.asarray(ref.chi2_batch(jax_rows(rows)))
    assert np.max(np.abs(got - want) / want) <= CHI2_RTOL
    point = {n: float(v[0]) for n, v in rows.items()}
    value, grad = vega.chi2_value_and_gradient(point)
    value_j, grad_j = ref.chi2_value_and_gradient(point)
    assert abs(value - value_j) <= CHI2_RTOL * value_j
    assert max_rel([grad[n] for n in names],
                   [grad_j[n] for n in names]) <= DERIV_RTOL


def test_desi_mock_dense_matches_jax(desi_mock):
    """The DESI mock's 15 names on the dense path."""
    ref, vega = desi_mock['dense']
    check_dense(ref, vega, list(DESI_MOCK_FIT_SAMPLE), seed=1)


def test_desi_mock_grid_route_matches_jax(desi_mock):
    """The grid names with the widths fixed: both packages serve them from
    a payload over (ap, at) holding both correlations, whose chi^2 agree
    within the mode budget, then minimize() on it."""
    ref, vega = desi_mock['grid']
    names = DESI_MOCK_GRID_NAMES
    payload = vega.get_collapsed(frozenset(names))
    assert set(payload) == {'__grid__', 'lyaxlya', 'qsoxlya'}
    assert set(ref.get_collapsed(tuple(sorted(names)))) == set(payload)
    rows = draw_rows(vega.params, names, 4, seed=2)
    got = vega.chi2_batch(rows).numpy()
    want = np.asarray(ref.chi2_batch(jax_rows(rows)))
    assert np.all(np.abs(got - want) <= GRID_ABS + GRID_REL * want)
    check_fit(ref, vega)


def test_lyacolore_dense_matches_jax(lyacolore):
    """LyaCoLoRe's six names (the widths among them) on the dense path,
    which is vega_tpu's route for them."""
    ref, vega = lyacolore
    assert vega.get_collapsed(frozenset(LYACOLORE_FIT_SAMPLE)) == {}
    check_dense(ref, vega, list(LYACOLORE_FIT_SAMPLE), seed=3)


def test_lyacolore_fit_matches_jax(lyacolore):
    """minimize() over the six names against vega_tpu's."""
    check_fit(*lyacolore)

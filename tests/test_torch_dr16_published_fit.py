"""eBOSS DR16 as published (examples/eBOSS_DR16/make_configs.py) in the
PyTorch port against the JAX package (vega_tpu) on the CPU, the
configuration as a whole at size='tiny': four correlations, the
sky-residual broadband in both autos, old_fftlog, old_growth_func,
binsize, five metals with CIV(eff) and the 18 sampled names of the
combined fit: dense chi2_batch, value and gradient; vega_tpu's route for
the names (the crosses from the grid payload, the autos densely): value,
gradient and Hessian, chi2_batch, minimize(). The pieces are
tests/test_torch_dr16_published.py; the JAX side of the dataset is
tests/tools/jax_dr16pub_dataset.py. Each tolerance stands beside its
use."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from jax_dr16pub_dataset import make_jax_dr16_published_dataset  # noqa: E402
from vega_tpu.vega_interface import VegaInterface as JaxInterface  # noqa: E402
from vega_tpu_torch.testing import (DR16PUB_CORRELATIONS,  # noqa: E402
                                    DR16PUB_SAMPLE)
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

CHI2_RTOL = 1e-10       # chi^2 on the dense path and by the route
DERIV_RTOL = 1e-9       # gradient and Hessian, of their largest entry
GRID_ABS, GRID_REL = 2e-4, 1e-9     # vega_tpu's default mode budget
NAMES = tuple(DR16PUB_SAMPLE)
GRID_NAMES = ('ap', 'at', 'drp_QSO', 'sigma_velo_disp_lorentz_QSO')
# a small node grid (6 x 6 x 4 x 4, one full tensor of 576 nodes): the
# tests hold the port's payload to vega_tpu's, not to the dense chi^2
CONTROL = {'grid-nodes-ap': '6', 'grid-nodes-at': '6',
           'grid-nodes-drp_QSO': '4',
           'grid-nodes-sigma_velo_disp_lorentz_QSO': '4',
           'ds-matmul': 'False'}


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


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


@pytest.fixture(scope='module')
def published(env, tmp_path_factory):
    """The tiny published configuration made by vega_tpu (BuildConfig):
    {'ref', 'vega' (the interfaces, the route vega_tpu takes for the 18
    names), 'ref_dense', 'vega_dense' (built with VEGA_TPU_FACTORED=0)}."""
    main = make_jax_dr16_published_dataset(
        tmp_path_factory.mktemp('dr16pub_fit'), size='tiny',
        extra_control=CONTROL)
    out = {'ref': JaxInterface(main),
           'vega': VegaInterface(main, device='cpu')}
    env.setenv('VEGA_TPU_FACTORED', '0')
    out['ref_dense'] = JaxInterface(main)
    out['vega_dense'] = VegaInterface(main, device='cpu')
    env.delenv('VEGA_TPU_FACTORED')
    return out


def draw_rows(params, n_rows, seed):
    rng = np.random.default_rng(seed)
    return {n: params[n] + 0.01 * (abs(params[n]) or 0.1)
            * rng.normal(size=n_rows) for n in NAMES}


def test_dense_chi2_batch_matches_jax(published, env):
    """chi2_batch over the 18 names on the dense path (four correlations,
    the legacy transform, the sky term densely, the metals' stacks)."""
    vega, ref = published['vega_dense'], published['ref_dense']
    env.setenv('VEGA_TPU_FACTORED', '0')
    rows = draw_rows(vega.params, 5, 1)
    assert vega.get_collapsed(NAMES) == {}
    got = vega.chi2_batch(rows).numpy()
    want = np.asarray(ref.chi2_batch({k: jnp.asarray(v)
                                      for k, v in rows.items()}))
    env.delenv('VEGA_TPU_FACTORED')
    assert np.all(got < 1e99)
    assert max_rel(got, want) <= CHI2_RTOL
    assert np.max(np.abs(got - want) / want) <= CHI2_RTOL


def test_dense_value_and_gradient_match_jax(published, env):
    """chi^2 and its gradient over the 18 names on the dense path at two
    points."""
    vega, ref = published['vega_dense'], published['ref_dense']
    env.setenv('VEGA_TPU_FACTORED', '0')
    rows = draw_rows(vega.params, 2, 2)
    for i in range(2):
        point = {n: float(v[i]) for n, v in rows.items()}
        value, grad = vega.chi2_value_and_gradient(point)
        value_j, grad_j = ref.chi2_value_and_gradient(point)
        assert max_rel(value, value_j) <= CHI2_RTOL
        assert max_rel([grad[n] for n in NAMES],
                       [grad_j[n] for n in NAMES]) <= DERIV_RTOL
    env.delenv('VEGA_TPU_FACTORED')


def test_route_value_gradient_hessian_match_jax(published):
    """chi^2, its gradient and Hessian over the 18 names by vega_tpu's
    route (the crosses from the payload, the autos densely, through the
    combine's backward): the payloads agree to round-off, so DERIV_RTOL
    holds (vega_tpu's Hessian graph is compiled once here and reused by
    its minimize() below)."""
    vega, ref = published['vega'], published['ref']
    point = {n: vega.sample_params['values'][n] for n in NAMES}
    point['ap'], point['at'] = 1.01, 0.99
    value, grad = vega.chi2_value_and_gradient(point)
    hess = vega.chi2_hessian(point, NAMES)
    value_j, grad_j = ref.chi2_value_and_gradient(point)
    hess_j = ref.chi2_hessian(point, list(NAMES))
    assert max_rel(value, value_j) <= CHI2_RTOL
    assert max_rel([grad[n] for n in NAMES],
                   [grad_j[n] for n in NAMES]) <= DERIV_RTOL
    assert max_rel([[hess[a][b] for b in NAMES] for a in NAMES],
                   [[hess_j[a][b] for b in NAMES] for a in NAMES]) \
        <= DERIV_RTOL


def test_grid_route_matches_jax(published):
    """vega_tpu's route for the 18 names: its sweep over (ap, at, drp_QSO,
    sigma_velo_disp_lorentz_QSO) keeps the crosses factored and finds the
    autos dense (their sky terms read sampled names), so the payload
    holds the crosses and the autos are evaluated densely at the true
    values. The port's payload and chi2_batch against vega_tpu's (the
    mode budget); the grid-vs-dense gap is vega_tpu's own and is
    reported."""
    vega, ref = published['vega'], published['ref']
    payload, ref_payload = vega.get_collapsed(NAMES), ref.get_collapsed(NAMES)
    assert set(payload) == set(ref_payload) == {'__grid__', 'lyaxqso',
                                                'lybxqso'}
    assert payload['__grid__'].names == GRID_NAMES
    for corr in ('lyaxqso', 'lybxqso'):
        assert max_rel(payload[corr]['cref'], ref_payload[corr]['cref']) \
            <= 1e-12
    rows = draw_rows(vega.params, 6, 3)
    got = vega.chi2_batch(rows).numpy()
    want = np.asarray(ref.chi2_batch({k: jnp.asarray(v)
                                      for k, v in rows.items()}))
    assert np.all(np.abs(got - want) <= GRID_ABS + GRID_REL * want)
    dense = published['vega_dense'].chi2_batch(rows).numpy()
    print('grid - dense chi^2 (the port; vega_tpu\'s within the budget):',
          got - dense)


def test_minimize_matches_jax(published, capsys):
    """minimize() on the 18 names by vega_tpu's route from the [sample]
    start against vega_tpu's: best-fit values within 1e-3 of their
    errors, errors within 1e-5 relative, fval within 1e-8 + 1e-10 fval."""
    vega, ref = published['vega'], published['ref']
    vega.minimize()
    ref.minimize()
    got, want = vega.bestfit, ref.bestfit
    for name in NAMES:
        assert abs(got.values[name] - want.values[name]) <= \
            1e-3 * want.errors[name]
        assert got.errors[name] == pytest.approx(want.errors[name],
                                                 rel=1e-5)
    assert abs(got.fmin.fval - want.fmin.fval) <= \
        1e-8 + 1e-10 * abs(want.fmin.fval)
    assert got.fmin.is_valid
    assert set(vega.bestfit_corr_stats) == set(DR16PUB_CORRELATIONS)
    assert 'Total chi^2/(ndata-nparam)' in capsys.readouterr().out

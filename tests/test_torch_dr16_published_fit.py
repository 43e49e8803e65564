"""eBOSS DR16 as published (examples/eBOSS_DR16/make_configs.py) in the
PyTorch port against the JAX package (vega_tpu) on the CPU, the
configuration as a whole at size='tiny': four correlations, the
sky-residual broadband in both autos, old_fftlog, old_growth_func,
binsize, five metals with CIV(eff) and the 18 sampled names of the
combined fit: dense chi2_batch, value and gradient; vega_tpu's route for
the names (the crosses from the grid payload, the autos densely): value,
gradient and Hessian, chi2_batch, minimize(). The pieces are
tests/test_torch_dr16_published.py; the JAX side of the dataset is
tests/tools/jax_dr16pub_dataset.py, and vega_tpu's numbers on it are
tests/data/torch_port_tiny_goldens.json ('dr16pub_fit', made by
tests/tools/make_torch_port_tiny_goldens.py with this module's
configuration and points, which it stores). Each tolerance stands beside
its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from jax_dr16pub_dataset import make_jax_dr16_published_dataset  # noqa: E402
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
GOLDENS = Path(__file__).resolve().parent / 'data' / \
    'torch_port_tiny_goldens.json'


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
    {'vega' (the port on the route vega_tpu takes for the 18 names),
    'vega_dense' (built with VEGA_TPU_FACTORED=0), 'golden' (vega_tpu's
    numbers on these files)}."""
    main = make_jax_dr16_published_dataset(
        tmp_path_factory.mktemp('dr16pub_fit'), size='tiny',
        extra_control=CONTROL)
    out = {'vega': VegaInterface(main, device='cpu'),
           'golden': json.loads(GOLDENS.read_text())['dr16pub_fit']}
    env.setenv('VEGA_TPU_FACTORED', '0')
    out['vega_dense'] = VegaInterface(main, device='cpu')
    env.delenv('VEGA_TPU_FACTORED')
    return out


def draw_rows(params, n_rows, seed):
    rng = np.random.default_rng(seed)
    return {n: params[n] + 0.01 * (abs(params[n]) or 0.1)
            * rng.normal(size=n_rows) for n in NAMES}


def as_rows(rows):
    return {k: np.asarray(v) for k, v in rows.items()}


def test_dense_chi2_batch_matches_jax(published, env):
    """chi2_batch over the 18 names on the dense path (four correlations,
    the legacy transform, the sky term densely, the metals' stacks)."""
    vega, golden = published['vega_dense'], published['golden']
    rows = as_rows(golden['dense_rows'])
    assert sorted(rows) == sorted(NAMES)
    env.setenv('VEGA_TPU_FACTORED', '0')
    assert vega.get_collapsed(NAMES) == {}
    got = vega.chi2_batch(rows).numpy()
    env.delenv('VEGA_TPU_FACTORED')
    want = np.asarray(golden['chi2_dense'])
    assert np.all(got < 1e99)
    assert max_rel(got, want) <= CHI2_RTOL
    assert np.max(np.abs(got - want) / want) <= CHI2_RTOL


def test_dense_value_and_gradient_match_jax(published, env):
    """chi^2 and its gradient over the 18 names on the dense path at two
    points."""
    vega, golden = published['vega_dense'], published['golden']
    env.setenv('VEGA_TPU_FACTORED', '0')
    for want in golden['dense_points']:
        value, grad = vega.chi2_value_and_gradient(want['point'])
        assert max_rel(value, want['chi2']) <= CHI2_RTOL
        assert max_rel([grad[n] for n in want['point']],
                       want['gradient']) <= DERIV_RTOL
    env.delenv('VEGA_TPU_FACTORED')


def test_route_value_gradient_hessian_match_jax(published):
    """chi^2, its gradient and Hessian over the 18 names by vega_tpu's
    route (the crosses from the payload, the autos densely, through the
    combine's backward): the payloads agree to round-off, so DERIV_RTOL
    holds."""
    vega, golden = published['vega'], published['golden']
    point = golden['route_point']
    assert point == {**{n: vega.sample_params['values'][n] for n in NAMES},
                     'ap': 1.01, 'at': 0.99}
    value, grad = vega.chi2_value_and_gradient(point)
    hess = vega.chi2_hessian(point, NAMES)
    want = golden['route']
    assert max_rel(value, want['chi2']) <= CHI2_RTOL
    assert max_rel([grad[n] for n in NAMES], want['gradient']) <= DERIV_RTOL
    assert max_rel([[hess[a][b] for b in NAMES] for a in NAMES],
                   want['hessian']) <= DERIV_RTOL


def test_grid_route_matches_jax(published):
    """vega_tpu's route for the 18 names: its sweep over (ap, at, drp_QSO,
    sigma_velo_disp_lorentz_QSO) keeps the crosses factored and finds the
    autos dense (their sky terms read sampled names), so the payload
    holds the crosses and the autos are evaluated densely at the true
    values. The port's payload and chi2_batch against vega_tpu's (the
    mode budget); the grid-vs-dense gap is vega_tpu's own and is
    reported."""
    vega, golden = published['vega'], published['golden']
    payload = vega.get_collapsed(NAMES)
    assert sorted(payload) == golden['route_keys'] == [
        '__grid__', 'lyaxqso', 'lybxqso']
    assert payload['__grid__'].names == GRID_NAMES
    for corr in ('lyaxqso', 'lybxqso'):
        assert max_rel(payload[corr]['cref'], golden['cref'][corr]) <= 1e-12
    rows = as_rows(golden['route_rows'])
    got = vega.chi2_batch(rows).numpy()
    want = np.asarray(golden['chi2_route'])
    assert np.all(np.abs(got - want) <= GRID_ABS + GRID_REL * want)
    dense = published['vega_dense'].chi2_batch(rows).numpy()
    print('grid - dense chi^2 (the port; vega_tpu\'s within the budget):',
          got - dense)


def test_minimize_matches_jax(published, capsys):
    """minimize() on the 18 names by vega_tpu's route from the [sample]
    start against vega_tpu's: best-fit values within 1e-3 of their
    errors, errors within 1e-5 relative, fval within 1e-8 + 1e-10 fval."""
    vega, want = published['vega'], published['golden']['fit']
    vega.minimize()
    got = vega.bestfit
    for name, value, error in zip(NAMES, want['values'], want['errors']):
        assert abs(got.values[name] - value) <= 1e-3 * error
        assert got.errors[name] == pytest.approx(error, rel=1e-5)
    assert abs(got.fmin.fval - want['fval']) <= \
        1e-8 + 1e-10 * abs(want['fval'])
    assert got.fmin.is_valid
    assert set(vega.bestfit_corr_stats) == set(DR16PUB_CORRELATIONS)
    assert 'Total chi^2/(ndata-nparam)' in capsys.readouterr().out

"""Per-component xi of the PyTorch port's Model.compute against the JAX
package's, on the tiny synthetic auto+cross dataset, at the default and
perturbed (ap, at); the port runs on the JAX package's host constants
(vega_tpu_torch.state.load_constants), unbatched and batched."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
import torch

from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch import state
from vega_tpu_torch.vega_interface import VegaInterface

from test_torch_host import jax_constants

XI_RTOL = 1e-10
POINTS = {'default': {},
          'perturbed': {'ap': 1.04, 'at': 0.97},
          'shifted': {'ap': 0.93, 'at': 1.06, 'bias_LYA': -0.125,
                      'beta_LYA': 1.6, 'drp_QSO': 0.4}}


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    main = jax_make_dataset(tmp_path_factory.mktemp('tiny'), cross=True,
                            size='tiny')
    jax_vega = JaxInterface(main)
    port = VegaInterface(main, device='cpu')
    state.load_constants(port, jax_constants(jax_vega))
    return jax_vega, port


def jax_components(jax_vega, name, point):
    """(xi_peak, xi_smooth, xi_full) of the JAX package, eager (dense)."""
    model = jax_vega.models[name]
    pars = dict(jax_vega.params, **point)
    pk_full = jax_vega.fiducial['pk_full']
    pk_smooth = jax_vega.fiducial['pk_smooth']
    pars['peak'] = True
    pk_peak, pk_smooth_grid, _ = model.Pk_core.compute_peak_smooth(
        pars, pk_full - pk_smooth, pk_smooth)
    xi_peak, _ = model._compute_model(pars, pk_full - pk_smooth, 'peak',
                                      pk_model=pk_peak)
    pars['peak'] = False
    xi_smooth, _ = model._compute_model(pars, pk_smooth, 'smooth',
                                        pk_model=pk_smooth_grid)
    xi_full, bad = model.compute(dict(jax_vega.params, **point), pk_full,
                                 pk_smooth)
    assert not bool(bad)
    return [np.asarray(x) for x in (xi_peak, xi_smooth, xi_full)]


def port_components(port, name, params):
    model = port.models[name]
    pars, _ = port._batch_params(params)
    pk_full, pk_smooth = port._pk_full, port._pk_smooth
    pars['peak'] = True
    pk_peak, pk_smooth_grid, _ = model.Pk_core.compute_peak_smooth(
        pars, pk_full - pk_smooth, pk_smooth)
    xi_peak, _ = model._compute_model(pars, pk_peak, use_kernel=True)
    pars['peak'] = False
    xi_smooth, _ = model._compute_model(pars, pk_smooth_grid,
                                        use_kernel=True)
    pars.pop('peak')
    xi_full, bad = model.compute(pars, pk_full, pk_smooth)
    assert not bool(bad.any())
    return [x.numpy() for x in (xi_peak, xi_smooth, xi_full)]


def assert_close(got, want):
    assert np.max(np.abs(got - want)) <= XI_RTOL * np.max(np.abs(want))


@pytest.mark.parametrize('point', list(POINTS))
@pytest.mark.parametrize('name', ['lyaxlya', 'qsoxlya'])
def test_components_match_jax(pair, name, point):
    jax_vega, port = pair
    want = jax_components(jax_vega, name, POINTS[point])
    got = port_components(port, name, POINTS[point])
    for component, g, w in zip(('peak', 'smooth', 'full'), got, want):
        assert g.shape == (1,) + w.shape, component
        assert_close(g[0], w)


@pytest.mark.parametrize('name', ['lyaxlya', 'qsoxlya'])
def test_batched_rows_match_jax(pair, name):
    """Three rows at once: each row equals the JAX package's model at
    that row's parameters."""
    jax_vega, port = pair
    rows = [POINTS['default'], POINTS['perturbed'],
            {'ap': 0.93, 'at': 1.06, 'bias_LYA': -0.125, 'beta_LYA': 1.6}]
    keys = ('ap', 'at', 'bias_LYA', 'beta_LYA')
    batch = {k: torch.tensor([r.get(k, jax_vega.params[k]) for r in rows],
                             dtype=torch.float64) for k in keys}
    got = port_components(port, name, batch)
    for b, row in enumerate(rows):
        want = jax_components(jax_vega, name, row)
        for g, w in zip(got, want):
            assert_close(g[b], w)


def test_out_of_range_row_is_flagged(pair):
    jax_vega, port = pair
    pars, _ = port._batch_params({'ap': [1.0, 100.0]})
    _, bad = port.models['qsoxlya'].compute(pars, port._pk_full,
                                            port._pk_smooth)
    assert bad.tolist() == [False, True]
    _, jax_bad = jax_vega.models['qsoxlya'].compute(
        dict(jax_vega.params, ap=100.0), jax_vega.fiducial['pk_full'],
        jax_vega.fiducial['pk_smooth'])
    assert bool(jax_bad)

"""The factored model of the PyTorch port (vega_tpu_torch.factored, the
FactoredPk branch of power_spectrum, the FactoredXi branches of pktoxi,
correlation_func and model, the nuisance-only collapse) against the JAX
package's, on the tiny synthetic auto+cross dataset."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vega_tpu.factored import FactoredXi as JaxFactoredXi
from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch.factored import (FactoredXi, RecordingParams, Sampling,
                                     densify)
from vega_tpu_torch.power_spectrum import FactoredPk
from vega_tpu_torch.vega_interface import VegaInterface

RTOL = 1e-12        # same arithmetic up to summation order
CORRS = ('lyaxlya', 'qsoxlya')
NUISANCE = ('beta_LYA', 'bias_LYA')
ROWS = {'bias_LYA': [-0.117, -0.13, -0.105, -0.121, -0.112],
        'beta_LYA': [1.67, 1.55, 1.8, 1.62, 1.71]}


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    """(JAX interface, port interface) on one tiny dataset, with the JAX
    package's exact f64 payload contractions and no disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        main = jax_make_dataset(
            tmp_path_factory.mktemp('factored'), cross=True, size='tiny',
            extra_control='grid-nodes-ap = 8\ngrid-nodes-at = 8\n'
                          'ds-matmul = False')
        yield JaxInterface(main), VegaInterface(main, device='cpu'), main


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))


# ----------------------------------------------------------------------
def _xi_pair(rng):
    coeffs = [0.7, -1.3, 2.1]
    basis = rng.normal(size=(3, 12))
    return (JaxFactoredXi(coeffs, jnp.asarray(basis)),
            FactoredXi(coeffs, torch.as_tensor(basis)))


OPS = {
    'coeff_vector': lambda x, a: x,
    'scale': lambda x, a: x.scale(1.7),
    'mul_vec': lambda x, a: x.mul_vec(a(np.linspace(0.5, 2.0, 12))),
    'add_vec': lambda x, a: x.add_vec(a(np.arange(12.0)), coeff=0.3),
    'add_terms': lambda x, a: x.add_terms([(0.2, a(np.ones(12))),
                                           (-0.4, a(np.arange(12.0)))]),
    'add': lambda x, a: x + x.scale(-0.5),
    'matmul': lambda x, a: x.matmul(a(np.tri(9, 12))),
    'mask': lambda x, a: x.mask(a(np.arange(12) % 3 != 1)),
}


@pytest.mark.parametrize('op', list(OPS))
def test_factored_xi_ops_match_jax(op):
    jax_xi, port_xi = _xi_pair(np.random.default_rng(1))
    want = OPS[op](jax_xi, jnp.asarray)
    got = OPS[op](port_xi, torch.as_tensor)
    assert got.n_terms == want.n_terms
    assert_close(got.coeff_vector().numpy(), want.coeff_vector())
    assert_close(got.V.numpy(), want.V)
    assert_close(got.dense().numpy(), want.dense())
    assert torch.equal(densify(got), got.dense())


def test_batched_coefficients_and_node_batched_basis():
    """(B,) coefficients against a (T, n) basis give (B, n); float
    coefficients against a (C, T, n) node batch give (C, n)."""
    rng = np.random.default_rng(2)
    basis = torch.as_tensor(rng.normal(size=(2, 5)))
    rows = torch.as_tensor([1.0, 2.0, 3.0])
    xi = FactoredXi([rows, 0.5], basis)
    want = rows[:, None] * basis[0] + 0.5 * basis[1]
    assert torch.allclose(xi.dense(), want, rtol=1e-15, atol=0)
    nodes = torch.as_tensor(rng.normal(size=(4, 2, 5)))
    node_xi = FactoredXi([2.0, -1.0], nodes) + FactoredXi([3.0], basis[:1])
    assert node_xi.V.shape == (4, 3, 5)
    assert torch.allclose(node_xi.dense(),
                          2 * nodes[:, 0] - nodes[:, 1] + 3 * basis[0],
                          rtol=1e-15, atol=1e-15)


def test_recording_params_classify_by_name():
    params = {'ap': 1.0, 'bias_LYA': -0.1, 'alpha_LYA': 2.9}
    sampling = Sampling(frozenset({'ap', 'bias_LYA'}), frozenset({'ap'}))
    rec = RecordingParams(params, sampling)
    rec['ap']
    rec.get('alpha_LYA')
    assert not rec.traced()         # a grid name and an unsampled name
    rec['bias_LYA']
    assert rec.traced()
    rec = RecordingParams(params)   # no sampling: nothing is traced
    rec['bias_LYA']
    assert not rec.traced() and rec.accessed == ['bias_LYA']


# ----------------------------------------------------------------------
@pytest.mark.parametrize('name', CORRS)
def test_kaiser_product_terms_match_jax(pair, name):
    """Same merged terms, in the same order, with the same coefficients
    and mu_k^2n grids as vega_tpu's _kaiser_product_terms."""
    jax_vega, port, _ = pair
    params = dict(jax_vega.params, bias_LYA=-0.121, beta_LYA=1.61)
    want = jax_vega.models[name].Pk_core._kaiser_product_terms(params)
    pk_core = port.models[name].Pk_core
    got = pk_core._kaiser_product_terms(params)
    assert [c for c, _ in got] == [c for c, _ in want]
    grids = pk_core._kaiser_basis_grids([key for _, key in got], params)
    for (_, key), mine, (_, grid) in zip(got, grids, want):
        assert key[:2] == ('one', 'one')        # no HCD in this config
        np.testing.assert_array_equal(mine.numpy(), np.asarray(grid))
        assert mine is pk_core._mu_pow_grids[key[2]]
    assert pk_core.kaiser_coefficients(params) == [c for c, _ in want]


@pytest.mark.parametrize('name', CORRS)
def test_factored_pk_matches_jax_dense_pk(pair, name):
    """FactoredPk.dense() of the port against the JAX package's dense
    P(k, mu_k), both components, at batched (bias_LYA, beta_LYA)."""
    jax_vega, port, _ = pair
    pars, n_b = port._batch_params(ROWS)
    pars['peak'] = True
    pk_full, pk_smooth = port._pk_full, port._pk_smooth
    pk_peak, pk_sm, _ = port.models[name].Pk_core.compute_peak_smooth(
        pars, pk_full - pk_smooth, pk_smooth,
        Sampling(frozenset(NUISANCE)))
    assert isinstance(pk_peak, FactoredPk) and isinstance(pk_sm, FactoredPk)
    jax_pk = jax_vega.models[name].Pk_core
    for b in range(n_b):
        point = dict(jax_vega.params, peak=True,
                     **{k: v[b] for k, v in ROWS.items()})
        want = jax_pk.compute_peak_smooth(
            point, jax_vega.fiducial['pk_full'] - jax_vega.fiducial[
                'pk_smooth'], jax_vega.fiducial['pk_smooth'])
        assert_close(pk_peak.dense()[b].numpy(), want[0])
        assert_close(pk_sm.dense()[b].numpy(), want[1])


@pytest.mark.parametrize('part', ['V', 'c0', 'A', 'W', 'm0'])
@pytest.mark.parametrize('name', CORRS)
def test_nuisance_collapse_matches_jax(pair, name, part):
    """The port's basis-collapse pass against vega_tpu's _collapsed_graph
    (through get_collapsed, nuisance-only names)."""
    jax_vega, port, _ = pair
    want = jax_vega.get_collapsed(NUISANCE, with_data_terms=False)[name]
    got = port.get_collapsed(NUISANCE, with_data_terms=False)[name]
    assert_close(got[part], want[part])


@pytest.mark.parametrize('name', CORRS)
def test_collapse_data_terms_match_jax(pair, name):
    """y = W r and s = r' Ci r with r = d - m0. The data are the model at
    the defaults, so r is round-off and the tolerance is relative to the
    uncentered terms W d and d' Ci d."""
    jax_vega, port, _ = pair
    want = jax_vega.get_collapsed(NUISANCE)[name]
    got = port.get_collapsed(NUISANCE)[name]
    d = port.data[name].masked_data_vec
    inv_cov = port.data[name].inv_masked_cov
    assert np.max(np.abs(got['y'] - want['y'])) <= RTOL * np.max(
        np.abs(got['W'] @ d))
    assert abs(got['s'] - want['s']) <= RTOL * float(d @ inv_cov @ d)


@pytest.mark.parametrize('name', CORRS)
def test_coefficients_times_basis_is_the_dense_model(pair, name):
    """The coefficient program (per evaluation, no grids) times the basis
    (once per sampled set) equals the port's dense model row by row."""
    _, port, _ = pair
    model = port.models[name]
    pars, n_b = port._batch_params(ROWS)
    basis = torch.as_tensor(port.get_collapsed(NUISANCE)[name]['V'])
    got = model.coefficients(pars, n_b) @ basis
    want, bad = model.compute(pars, port._pk_full, port._pk_smooth)
    assert not bad.any()
    assert_close(got.numpy(), want.numpy())
    # the factored model itself, with (B,) coefficients, densifies to it
    fxi, _ = model.compute(pars, port._pk_full, port._pk_smooth,
                           sampling=Sampling(frozenset(NUISANCE)))
    assert isinstance(fxi, FactoredXi)
    assert_close(fxi.dense().numpy(), want.numpy())


def test_nuisance_chi2_batch_matches_jax(pair):
    """Sampled (bias_LYA, beta_LYA) only: both packages serve the rows
    from the nuisance-only collapse."""
    jax_vega, port, _ = pair
    want = np.asarray(jax_vega.chi2_batch(
        {k: np.asarray(v) for k, v in ROWS.items()}))
    got = port.chi2_batch(ROWS).numpy()
    assert '__grid__' not in port.get_collapsed(frozenset(ROWS))
    keep = np.abs(want) > 1.0               # row 0 is the truth: chi2 ~ 0
    assert keep.sum() == 4 and abs(got[0]) < 1e-9
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-10)


def test_coefficients_contracted_into_knots_match_jax(pair, monkeypatch):
    """VEGA_TPU_GRID_COLLAPSE=0 with (ap, at) sampled: the rescaled
    coordinates depend on sampled names, so the FactoredPk coefficients
    are contracted into the knot tables and the combine is dense."""
    jax_vega, _, main = pair
    monkeypatch.setenv('VEGA_TPU_GRID_COLLAPSE', '0')
    port = VegaInterface(main, device='cpu')
    rows = dict(ROWS, ap=[1.0, 1.04, 0.97, 1.02, 0.95],
                at=[1.0, 0.98, 1.03, 1.05, 0.99])
    assert port.get_collapsed(frozenset(rows)) == {}
    want = np.asarray(jax_vega.chi2_batch(
        {k: np.asarray(v) for k, v in rows.items()}))
    got = port.chi2_batch(rows).numpy()
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-9)
    assert abs(got[0]) < 1e-9

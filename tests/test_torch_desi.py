"""The DESI DR1 baseline model of the PyTorch port against the JAX
package (vega_tpu) on the CPU, at size='tiny': the new-metals matrices
and effective coordinates inside the model, the QSO radiation and the
DESI instrumental systematics (dense and factored), the coefficient
program with both new linear names sampled, the joint covariance (chi^2,
log-likelihood, batched derivatives, the global mock, the Monte-Carlo
switch) and the slice as a whole: DESI's 17 sampled names on the dense
path under the joint covariance, and the grid regime under
per-correlation covariances. The JAX side of the dataset is
tests/tools/jax_metal_dataset.py. Each tolerance stands beside its
use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from jax_metal_dataset import make_jax_metal_dataset  # noqa: E402
from vega_tpu.factored import densify as densify_jax  # noqa: E402
from vega_tpu.statics import resolve  # noqa: E402
from vega_tpu.vega_interface import VegaInterface as JaxInterface  # noqa: E402
from vega_tpu_torch.factored import FactoredXi, Sampling  # noqa: E402
from vega_tpu_torch.parallel import MonteCarloEngine  # noqa: E402
from vega_tpu_torch.testing import (DESI_METALS, DESI_PRIORS,  # noqa: E402
                                    DESI_SAMPLED, desi_extra_model,
                                    make_synthetic_dataset, priors_section)
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

from test_torch_host import assert_same_files  # noqa: E402

MATRIX_RTOL = 1e-8      # both packages' C++ pair histograms (OpenMP sums)
XI_RTOL = 1e-12         # a model or a term, of its largest entry
CHI2_RTOL = 1e-10       # chi^2, log-likelihood
DERIV_RTOL = 1e-9       # gradient and Hessian, of their largest entry
GRID_ABS, GRID_REL = 2e-4, 1e-9     # vega_tpu's default mode budget
GRID_NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA', 'bias_QSO', 'bias_hcd',
              'beta_hcd', 'bias_SiII(1190)', 'bias_SiII(1193)',
              'bias_SiIII(1207)', 'bias_SiII(1260)', 'bias_CIV(eff)',
              'qso_rad_strength', 'desi_inst_sys_amp')
NUISANCE = GRID_NAMES[2:]
CONTROL = ('grid-nodes-ap = 8\ngrid-nodes-at = 8\nds-matmul = False\n'
           'mc_seed = 3\n' + priors_section(DESI_PRIORS))


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def dataset_args():
    return dict(cross=True, size='tiny',
                sample={n: 'True' for n in DESI_SAMPLED},
                extra_model=desi_extra_model(), new_metals=True,
                global_cov=True, extra_control=CONTROL)


def rows(params, names, n_rows, seed):
    """Rows 1% around the configuration's values (0.001 around zero)."""
    rng = np.random.default_rng(seed)
    return {n: params[n] + 0.01 * (abs(params[n]) or 0.1)
            * rng.normal(size=n_rows) for n in names}


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
def desi(env, tmp_path_factory):
    """The tiny DESI-shaped dataset made by vega_tpu: {'dir', 'joint'
    (main.ini, global covariance), 'per_corr' (the same without it),
    'jax' / 'port' interfaces on each}."""
    work = tmp_path_factory.mktemp('desi_jax')
    joint = make_jax_metal_dataset(work, list(DESI_METALS), **dataset_args())
    per_corr = work / 'main_per_corr.ini'
    per_corr.write_text(re.sub(r'global-cov-file = .*\n', '\n',
                               joint.read_text()))
    return {'dir': work, 'joint': joint, 'per_corr': per_corr,
            'jax': {'joint': JaxInterface(joint),
                    'per_corr': JaxInterface(per_corr)},
            'port': {'joint': VegaInterface(joint, device='cpu'),
                     'per_corr': VegaInterface(per_corr, device='cpu')}}


def test_desi_files_match_jax(desi, tmp_path):
    """The port's make_synthetic_dataset writes the JAX helper's files:
    the weights files, the data files (with OMEGAM), the joint
    covariance and the ini texts with their new-metals, radiation and
    instrumental-systematics lines."""
    make_synthetic_dataset(tmp_path, device='cpu', metals=list(DESI_METALS),
                           **dataset_args())
    assert_same_files(desi['dir'], tmp_path, n_fits=6)
    auto = (tmp_path / 'lyaxlya.ini').read_text()
    cross = (tmp_path / 'qsoxlya.ini').read_text()
    assert 'desi-instrumental-systematics = True' in auto
    assert 'radiation effects' not in auto
    assert 'radiation effects = True' in cross
    for text in (auto, cross):
        assert 'new_metals = True' in text and '[metal-matrix]' in text
        assert 'rebin_factor = 3' in text and 'test = True' not in text
    assert 'global-cov-file' in (tmp_path / 'main.ini').read_text()


def test_new_metals_in_the_model_match_jax(desi):
    """Each pair's matrix on the device, in the order of vega_tpu's
    pairs, and each pair's effective coordinates (the metal correlation
    function's r, mu and z) equal vega_tpu's: 15 auto pairs and 4 cross
    pairs (CIV(eff) pairs only with itself)."""
    ref, port = desi['jax']['joint'], desi['port']['joint']
    counts = {}
    for name, model in port.models.items():
        jax_metals = ref.models[name].metals
        assert (list(model.metals._metal_mats)
                == list(jax_metals.rp_metal_dmats)
                == list(desi['port']['joint'].corr_items[name]
                        .metal_correlations))
        counts[name] = len(model.metals._metal_mats)
        for pair, dmat in model.metals._metal_mats.items():
            want = np.asarray(resolve(jax_metals.rp_metal_dmats[pair]))
            assert dmat.dtype == torch.float64
            np.testing.assert_allclose(dmat.numpy(), want, rtol=MATRIX_RTOL,
                                       atol=1e-10)
            xi_port = model.metals.Xi_metal[pair]
            xi_jax = jax_metals.Xi_metal[pair]
            for got, want in ((xi_port._r, xi_jax._r),
                              (xi_port._mu, xi_jax._mu)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=MATRIX_RTOL, atol=1e-10)
            np.testing.assert_allclose(xi_port._z, xi_jax._z,
                                       rtol=MATRIX_RTOL)
        assert model.metals.matrix_build_s > 0
    assert counts == {'lyaxlya': 15, 'qsoxlya': 4}


def test_radiation_and_instrumental_terms_match_jax(desi):
    """The QSO radiation at the data coordinates and at rescaled ones
    (rescale-coords-systematics), one row and a batch of rows, and the
    instrumental-systematics template times its amplitude, against
    vega_tpu's functions."""
    ref, port = desi['jax']['joint'], desi['port']['joint']
    xi_port = port.models['qsoxlya'].Xi_core
    xi_jax = ref.models['qsoxlya'].Xi_core
    batch = rows(port.params, ('qso_rad_strength', 'drp_QSO'), 3, 0)
    r, mu = xi_port._r * 1.01, xi_port._mu * 0.99
    for rescale in (False, True):
        xi_port._rescale_coords_systematics = rescale
        xi_jax._rescale_coords_systematics = rescale
        for i in range(3):
            pars = dict(port.params, **{k: float(v[i])
                                        for k, v in batch.items()})
            want = np.asarray(xi_jax.compute_qso_radiation(
                pars, jnp.asarray(r.numpy()), jnp.asarray(mu.numpy())))
            got = xi_port.compute_qso_radiation(pars, r, mu)
            assert max_rel(got, want) <= XI_RTOL
            batched = xi_port.compute_qso_radiation(
                dict(port.params, **{k: torch.as_tensor(v)
                                     for k, v in batch.items()}), r, mu)
            assert max_rel(batched[i], want) <= XI_RTOL
    xi_port._rescale_coords_systematics = False
    xi_jax._rescale_coords_systematics = False

    model = port.models['lyaxlya']
    bin_size = port.corr_items['lyaxlya'].data_coordinates.rp_binsize
    want = np.asarray(ref.models['lyaxlya'].Xi_core
                      .compute_desi_instrumental_systematics(
                          port.params, bin_size))
    assert np.count_nonzero(want) > 0
    coeff, vec = model._inst_sys_term(port.params)
    assert max_rel(coeff * vec, want) <= XI_RTOL
    with pytest.raises(ValueError, match='auto-correlation'):
        port.models['qsoxlya'].Xi_core.desi_instrumental_systematics_template(
            bin_size)


@pytest.fixture(scope='module')
def model_rows(desi):
    """(batch over the nuisance names, {correlation: vega_tpu's
    Model.compute at each row}), vmapped and jitted as vega_tpu's batched
    likelihood runs it."""
    jax_vega = desi['jax']['per_corr']
    batch = rows(jax_vega.params, NUISANCE, 2, 1)
    want = {}
    for name, model in jax_vega.models.items():
        def compute(p, model=model):
            return densify_jax(model.compute(
                dict(jax_vega.params, **p), jax_vega.fiducial['pk_full'],
                jax_vega.fiducial['pk_smooth'])[0])
        want[name] = np.asarray(jax.jit(jax.vmap(compute))(
            {k: jnp.asarray(v) for k, v in batch.items()}))
    return batch, want


@pytest.mark.parametrize('factored', [False, True],
                         ids=['dense', 'factored'])
def test_models_match_jax(desi, model_rows, factored):
    """Model.compute of both correlations (radiation on the cross,
    instrumental systematics on the auto, new-metals matrices on both) at
    a batch of points over the nuisance names, dense and, with a
    Sampling of those names, as a FactoredXi (which the radiation and
    the systematics join as terms of their own), against vega_tpu's
    Model.compute row by row."""
    port = desi['port']['per_corr']
    batch, want = model_rows
    pars = dict(port.params, **{k: torch.as_tensor(v)
                                for k, v in batch.items()})
    sampling = Sampling(frozenset(NUISANCE)) if factored else None
    for name, model in port.models.items():
        got, bad = model.compute(pars, port._pk_full, port._pk_smooth,
                                 sampling=sampling)
        assert isinstance(got, FactoredXi) == factored
        got = got.dense() if factored else got
        assert not bool(bad.any())
        for i in range(2):
            assert max_rel(got[i], want[name][i]) <= XI_RTOL


def test_coefficient_program_with_the_new_names(desi):
    """With qso_rad_strength and desi_inst_sys_amp sampled, the nuisance
    collapse of both correlations has vega_tpu's terms (T and c0), and
    Model.coefficients gives the factored model's coefficients at a batch
    of rows (the radiation's strength after the cross's Kaiser terms, the
    amplitude last on the auto); _check_coefficient_program passed when
    the collapse was built."""
    ref, port = desi['jax']['per_corr'], desi['port']['per_corr']
    collapsed = port.get_collapsed(frozenset(NUISANCE))
    want = ref.get_collapsed(tuple(sorted(NUISANCE)))
    assert set(collapsed) == set(want) == {'lyaxlya', 'qsoxlya'}
    for name, tensors in collapsed.items():
        c0 = np.asarray(want[name]['c0'])
        assert tensors['c0'].shape == c0.shape
        assert max_rel(tensors['c0'], c0) <= XI_RTOL
    batch = rows(port.params, NUISANCE, 4, 2)
    pars = dict(port.params, **{k: torch.as_tensor(v)
                                for k, v in batch.items()})
    sampling = Sampling(frozenset(NUISANCE))
    for name, model in port.models.items():
        cf, _ = model.compute(pars, port._pk_full, port._pk_smooth,
                              sampling=sampling)
        coeffs = model.coefficients(pars, 4)
        assert max_rel(coeffs, cf.coeff_vector()) <= 1e-14
    auto = port.models['lyaxlya'].coefficients(pars, 4)
    assert torch.equal(auto[:, -1], pars['desi_inst_sys_amp'])


def test_joint_covariance_matches_the_per_correlation_sum(desi):
    """Under the block-diagonal joint covariance the joint chi^2 and
    log-likelihood equal the per-correlation sums
    (tests/test_global_cov_and_marg.py:10-25), on the dense path."""
    joint, per_corr = desi['port']['joint'], desi['port']['per_corr']
    assert joint._use_global_cov and not per_corr._use_global_cov
    assert joint.get_collapsed(frozenset(NUISANCE)) == {}
    batch = rows(joint.params, DESI_SAMPLED, 3, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_FACTORED', '0')
        dense = VegaInterface(desi['per_corr'], device='cpu')
    got, want = joint.chi2_batch(batch), dense.chi2_batch(batch)
    assert max_rel(got, want) <= CHI2_RTOL
    got, want = joint.log_lik_batch(batch), dense.log_lik_batch(batch)
    assert max_rel(got, want) <= CHI2_RTOL


def test_joint_chi2_and_derivatives_match_jax(desi):
    """chi2, log_lik, chi2_batch over DESI's 17 names and
    chi2_batch_derivatives over four of them (the others fixed per row)
    under the joint covariance against vega_tpu's."""
    ref, port = desi['jax']['joint'], desi['port']['joint']
    assert port.chi2() == pytest.approx(ref.chi2(), rel=CHI2_RTOL)
    assert port.log_lik() == pytest.approx(ref.log_lik(), rel=CHI2_RTOL)
    batch = rows(port.params, DESI_SAMPLED, 2, 4)
    want = np.asarray(ref.chi2_batch({k: jnp.asarray(v)
                                      for k, v in batch.items()}))
    assert max_rel(port.chi2_batch(batch), want) <= CHI2_RTOL
    free = ['ap', 'bias_QSO', 'qso_rad_strength', 'desi_inst_sys_amp']
    values = np.stack([batch[n] for n in free], axis=-1)
    fixed = {n: v for n, v in batch.items() if n not in free}
    got = port.chi2_batch_derivatives(free, values, fixed=fixed)
    for i in range(values.shape[0]):
        point = {n: float(v[i]) for n, v in batch.items()}
        value, grad = ref.chi2_value_and_gradient(point)
        assert float(got[0][i]) == pytest.approx(value, rel=CHI2_RTOL)
        assert max_rel(got[1][i], [grad[n] for n in free]) <= DERIV_RTOL
    # the Hessian of the last row (vega_tpu's takes seconds per point)
    hess = ref.chi2_hessian(point, free)
    assert max_rel(got[2][-1], [[hess[a][b] for b in free]
                                for a in free]) <= DERIV_RTOL


def test_global_mock_matches_jax(desi):
    """A seeded global mock (numpy's legacy draw around the same
    fiducial) equals vega_tpu's; after the Monte-Carlo switch both chi^2
    read it; the port's MonteCarloEngine refuses the joint covariance."""
    ref, port = desi['jax']['joint'], desi['port']['joint']
    fiducial = ref.compute_model(run_init=False)
    want = np.asarray(ref.analysis.create_global_monte_carlo(fiducial,
                                                             seed=5))
    got = port.analysis.create_global_monte_carlo(fiducial, seed=5)
    assert got.shape == (port.full_data_mask.sum(),)
    assert max_rel(got, want) <= 1e-14
    got_forecast = port.analysis.create_global_monte_carlo(
        fiducial, seed=5, forecast=True)
    assert max_rel(got_forecast, np.concatenate(
        [port.data[n].masked_data_vec for n in port.corr_items])) <= 1e-6
    port.analysis.current_mc_mock = got
    ref.analysis.current_mc_mock = want
    port.monte_carlo = ref.monte_carlo = True
    try:
        point = {'bias_LYA': -0.12, 'beta_LYA': 1.6}
        assert port.chi2(point) == pytest.approx(ref.chi2(point),
                                                 rel=CHI2_RTOL)
        assert port.log_lik(point) == pytest.approx(ref.log_lik(point),
                                                    rel=CHI2_RTOL)
    finally:
        port.monte_carlo = ref.monte_carlo = False
    with pytest.raises(ValueError, match='global covariance'):
        MonteCarloEngine(port)


def test_initialize_monte_carlo_draws_the_global_mock(desi):
    """initialize_monte_carlo on the joint covariance (its initial fit
    replaced by the values at hand) draws the joint mock of [control]
    mc_seed, as vega_tpu's does, and the chi^2 reads it. A mock is each
    package's own fiducial model plus the draw L @ N(0, 1): the draw is
    numpy's on both sides (the same seed, Cholesky factor and product)
    and is held to 1e-14 of its largest entry; the fiducials are two
    implementations' models, held to XI_RTOL as every model here, and so
    is the mock."""
    port, ref = desi['port']['joint'], desi['jax']['joint']
    saved = [(v, v.mc_config, v.minimizer) for v in (port, ref)]
    try:
        for vega in (port, ref):
            vega.mc_config = {'params': {}, 'sample': vega.sample_params}
            vega.minimize = lambda: None
            vega.minimizer = type('Fit', (), {'values': {}})()
        got = port.initialize_monte_carlo()
        want = np.asarray(ref.initialize_monte_carlo())
        assert port.monte_carlo
        mask, fid_got = port.analysis._global_mock_pieces(
            port.compute_model({}, run_init=False))
        mask_want, fid_want = ref.analysis._global_mock_pieces(
            ref.compute_model({}, run_init=False))
        assert np.array_equal(mask, mask_want)
        fid_got, fid_want = fid_got[mask], fid_want[mask]
        assert max_rel(fid_got, fid_want) <= XI_RTOL
        assert max_rel(got - fid_got, want - fid_want) <= 1e-14
        assert max_rel(got, want) <= XI_RTOL
        assert port.chi2() == pytest.approx(ref.chi2(), rel=CHI2_RTOL)
    finally:
        for vega, mc_config, minimizer in saved:
            del vega.minimize
            vega.mc_config, vega.minimizer = mc_config, minimizer
            vega.monte_carlo = False


def test_rp_only_metal_matrices_match_jax(desi, tmp_path):
    """With rp_only_metal_mats the matrices are (rp, rp), the stacking
    plan refuses the configuration (the unrolled loop, as vega_tpu's
    `_plan_stacking`), and chi2_batch over the 17 names agrees."""
    source = desi['dir']
    text = desi['joint'].read_text()
    for ini in ('lyaxlya.ini', 'qsoxlya.ini'):
        (tmp_path / ini).write_text((source / ini).read_text().replace(
            'rp_only_metal_mats = False', 'rp_only_metal_mats = True'))
        text = text.replace(str(source / ini), str(tmp_path / ini))
    (tmp_path / 'main.ini').write_text(text)
    port = VegaInterface(tmp_path / 'main.ini', device='cpu')
    ref = JaxInterface(tmp_path / 'main.ini')
    for model in port.models.values():
        assert model.metals._stacked_plans is None
        n_rp = model.metals.rp_nbins
        assert all(d.shape == (n_rp, n_rp)
                   for d in model.metals._metal_mats.values())
    batch = rows(port.params, DESI_SAMPLED, 3, 6)
    want = np.asarray(ref.chi2_batch({k: jnp.asarray(v)
                                      for k, v in batch.items()}))
    assert max_rel(port.chi2_batch(batch), want) <= CHI2_RTOL


def test_grid_regime_matches_jax(desi):
    """The grid regime under per-correlation covariances with the 14 grid
    names (8 x 8 nodes): both correlations served by the payload with
    vega_tpu's terms, and the served chi^2 within vega_tpu's mode budget
    of its own."""
    ref, port = desi['jax']['per_corr'], desi['port']['per_corr']
    payload = port.get_collapsed(frozenset(GRID_NAMES))
    want_payload = ref.get_collapsed(tuple(sorted(GRID_NAMES)))
    for name in port.corr_items:
        assert (payload[name]['cref'].shape
                == np.asarray(want_payload[name]['cref']).shape)
    batch = rows(port.params, GRID_NAMES, 6, 7)
    got = port.chi2_batch(batch).numpy()
    want = np.asarray(ref.chi2_batch({k: jnp.asarray(v)
                                      for k, v in batch.items()}))
    assert np.all(np.abs(got - want) <= GRID_ABS + GRID_REL * np.abs(want))

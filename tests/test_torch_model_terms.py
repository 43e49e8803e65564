"""The reference's own model terms in the PyTorch port against the JAX
package (vega_tpu) on the CPU: UV background fluctuations and HeII
reionization (the Kaiser bias shift, dense and as basis grids keyed on
(lambda, b_prim)), the UV shotnoise (its A(tau) table and its factored
term), the relativistic and standard-asymmetry terms of the cross (two
odd-ell tables through the combine on the legacy knot grid), Croom's QSO
bias evolution, the split ("new") bias evolution with the data file's
cosmology, single_multipole and fht_extrap on the mcfit path.

The configuration is synthetic-dr16-uv at size='tiny' (the DR16-shaped
model with UV fluctuations and shotnoise in both correlations, the
relativistic, asymmetry and Croom terms on the cross), written by
vega_tpu (tests/tools/jax_metal_dataset.py); the variants copy its files
with one option changed. The factors and terms are held against vega_tpu's
objects live; the chi^2, gradients and routes against vega_tpu's numbers
on the same files, tests/data/torch_port_tiny_goldens.json ('uv'; made by
tests/tools/make_torch_port_tiny_goldens.py, which reads this module's
points). Each tolerance stands beside its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from jax_metal_dataset import make_jax_metal_dataset  # noqa: E402
from vega_tpu import utils as jax_utils  # noqa: E402
from vega_tpu.correlation_func import (  # noqa: E402
    CorrelationFunction as JaxCorrelationFunction)
from vega_tpu.io.fits import read_fits as jax_read_fits  # noqa: E402
from vega_tpu.power_spectrum import (  # noqa: E402
    PowerSpectrum as JaxPowerSpectrum)
from vega_tpu.vega_interface import VegaInterface as JaxInterface  # noqa: E402
from vega_tpu_torch import correlation_func as corr_func  # noqa: E402
from vega_tpu_torch.factored import FactoredXi, Sampling  # noqa: E402
from vega_tpu_torch.power_spectrum import PowerSpectrum  # noqa: E402
from vega_tpu_torch.testing import (DR16_METALS, DR16_UV_SAMPLE,  # noqa: E402
                                    DR16_UV_SAMPLED, dataset_variant,
                                    dr16_uv_extra_model,
                                    make_synthetic_dataset)
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

FACTOR_RTOL = 1e-12     # a factor or term, of its largest entry
COEFF_RTOL = 1e-12      # the coefficient program against the factored c0
CHI2_RTOL = 1e-10       # dense chi^2, f64 both sides
DERIV_RTOL = 1e-9       # value and gradient, of the largest entry
GRID_ABS, GRID_REL = 2e-4, 1e-9     # vega_tpu's default mode budget
CONTROL = 'grid-nodes-ap = 8\ngrid-nodes-at = 8\nds-matmul = False'
NAMES = DR16_UV_SAMPLED
NUISANCE = NAMES[2:]
LAMBDA_NAMES = ('bias_LYA', 'bias_gamma', 'lambda_uv')
GOLDENS = Path(__file__).resolve().parent / 'data' / \
    'torch_port_tiny_goldens.json'
TRUTH = {'ap': 1., 'at': 1., 'bias_LYA': -0.117, 'beta_LYA': 1.67,
         'bias_hcd': -0.052, 'beta_hcd': 0.65, 'bias_SiII(1260)': -0.002,
         'bias_SiIII(1207)': -0.004, 'bias_gamma': 0.1125,
         'uv_shotnoise_amp': 0.001, 'Arel1': -13.5, 'Aasy0': 1.}


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def draw_rows(n, seed):
    rng = np.random.default_rng(seed)
    return {name: val + 0.03 * abs(val) * rng.normal(size=n)
            for name, val in TRUTH.items()}


@pytest.fixture(scope='module')
def env():
    """Exact f64 payload contractions and no payload disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        yield mp


@pytest.fixture(scope='module')
def uv_main(env, tmp_path_factory):
    """main.ini of synthetic-dr16-uv at size='tiny', written by vega_tpu."""
    return make_jax_metal_dataset(
        tmp_path_factory.mktemp('uv'), list(DR16_METALS), cross=True,
        size='tiny', sample=DR16_UV_SAMPLE, extra_control=CONTROL,
        extra_model=dr16_uv_extra_model(), qso_z_evol='croom')


@pytest.fixture(scope='module')
def golden():
    """vega_tpu's numbers on these files ('uv')."""
    return json.loads(GOLDENS.read_text())['uv']


@pytest.fixture(scope='module')
def uv(uv_main):
    """(vega_tpu interface, port interface) on the factored route; the
    vega_tpu one for its objects, not evaluated."""
    return JaxInterface(uv_main), VegaInterface(uv_main, device='cpu')


@pytest.fixture(scope='module')
def uv_dense(uv_main, env):
    """The port built for the dense path (VEGA_TPU_FACTORED=0)."""
    env.setenv('VEGA_TPU_FACTORED', '0')
    port = VegaInterface(uv_main, device='cpu')
    env.delenv('VEGA_TPU_FACTORED')
    return port


def as_rows(rows):
    return {k: np.asarray(v) for k, v in rows.items()}


# ----------------------------------------------------------------------
# 1. UV fluctuations and HeII reionization in the power spectrum
# ----------------------------------------------------------------------
LYA = {'name': 'LYA', 'type': 'continuous'}
QSO = {'name': 'QSO', 'type': 'discrete'}
SI2 = {'name': 'SiII(1260)', 'type': 'continuous'}
PK_PARAMS = {'bias_LYA': -0.12, 'beta_LYA': 1.6, 'bias_QSO': 3.7,
             'beta_QSO': 0.26, 'bias_SiII(1260)': -0.002,
             'beta_SiII(1260)': 0.5, 'bias_hcd': -0.05, 'beta_hcd': 0.5,
             'L0_hcd': 10, 'sigmaNL_par': 6.37, 'sigmaNL_per': 3.24,
             'sigma_velo_disp_lorentz_QSO': 6.86, 'growth_rate': 0.97,
             'bias_gamma': 0.1125, 'bias_gamma_e': 0.08, 'bias_prim': -0.66,
             'lambda_uv': 300., 'lambda_HeII': 100.}
UV = {'UVB-fluctuations': 'True'}
HEII = {'HeII-reionization': 'True'}
PK_CASES = {
    'uv_auto': (LYA, LYA, UV),
    'uv_cross': (QSO, LYA, dict(UV, **{'velocity dispersion': 'lorentz'})),
    'heii_auto': (LYA, LYA, HEII),
    'uv_heii_hcd_auto': (LYA, LYA, dict(UV, **HEII,
                                        **{'model-hcd': 'Rogers2018'})),
    'uv_heii_hcd_cross': (LYA, QSO, dict(UV, **HEII,
                                         **{'model-hcd': 'Rogers2018'})),
    'uv_metal': (LYA, SI2, UV),
}


@pytest.fixture(scope='module')
def fiducial():
    hdul = jax_read_fits(jax_utils.find_file('PlanckDR16/PlanckDR16.fits'))
    return {'z_eff': 2.25, 'k': hdul[1]['K'], 'pk_full': hdul[1]['PK'],
            'pk_smooth': hdul[1]['PKSB'],
            'z_fiducial': hdul[1].header['ZREF']}


def model_config(**options):
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config['model'] = {'bin_size_rp': '4', 'bin_size_rt': '4',
                       'num_bins_muk': '96', **options}
    return config['model']


@pytest.mark.parametrize('case', list(PK_CASES))
def test_uv_heii_power_spectrum_matches_jax(fiducial, case):
    """The shifted bias of a LYA tracer: both components of
    compute_peak_smooth (the division-free polynomial), the single
    component compute of the unrolled metals (with and without the bias
    product), the effective biases, and the factored Kaiser terms (each
    coefficient and basis grid) against vega_tpu's."""
    tracer1, tracer2, options = PK_CASES[case]
    pk = PowerSpectrum(model_config(**options), fiducial, tracer1, tracer2,
                       'corr', device='cpu')
    jax_pk = JaxPowerSpectrum(model_config(**options), fiducial, tracer1,
                              tracer2, 'corr')
    pk_full = np.asarray(fiducial['pk_full'], float)
    pk_smooth = np.asarray(fiducial['pk_smooth'], float)
    t_full, t_smooth = torch.as_tensor(pk_full), torch.as_tensor(pk_smooth)
    params = dict(PK_PARAMS, peak=True)
    got = pk.compute_peak_smooth(params, t_full - t_smooth, t_smooth)
    want = jax_pk.compute_peak_smooth(params, pk_full - pk_smooth, pk_smooth)
    assert max_rel(got[0], want[0]) <= FACTOR_RTOL
    assert max_rel(got[1], want[1]) <= FACTOR_RTOL
    for fast_metals in (False, True):
        one, _ = pk.compute(t_smooth, params, fast_metals=fast_metals)
        ref, _ = jax_pk.compute(pk_smooth, params, fast_metals=fast_metals)
        assert max_rel(one, ref) <= FACTOR_RTOL
    bias_eff, beta_eff = pk.compute_bias_beta_uv_heii(-0.12, 1.6, params)
    want_eff = jax_pk.compute_bias_beta_uv_heii(-0.12, 1.6, params)
    assert max_rel(bias_eff[0], want_eff[0]) <= FACTOR_RTOL
    assert max_rel(beta_eff[0], want_eff[1]) <= FACTOR_RTOL

    terms = pk._kaiser_product_terms(params)
    jax_terms = jax_pk._kaiser_product_terms(params)
    assert len(terms) == len(jax_terms)
    grids = pk._kaiser_basis_grids([key for _, key in terms], params)
    for (c, _), grid, (jc, jgrid) in zip(terms, grids, jax_terms):
        assert max_rel(c, jc) <= FACTOR_RTOL
        assert max_rel(grid, jgrid) <= FACTOR_RTOL


def test_uv_batched_rows_equal_each_row(fiducial):
    """A batch of (bias_gamma, lambda_uv, bias_prim) rows against each
    row alone, and a sampled lambda_uv or bias_prim leaves the Kaiser
    term without a factored form, as vega_tpu's `_has_tracer` does."""
    tracer1, tracer2, options = PK_CASES['uv_heii_hcd_auto']
    pk = PowerSpectrum(model_config(**options), fiducial, tracer1, tracer2,
                       'corr', device='cpu')
    t_full = torch.as_tensor(np.asarray(fiducial['pk_full'], float))
    t_smooth = torch.as_tensor(np.asarray(fiducial['pk_smooth'], float))
    rows = {'bias_gamma': [0.1125, 0.05], 'lambda_uv': [300., 150.],
            'bias_prim': [-0.66, -0.3], 'lambda_HeII': [100., 60.]}
    batch = dict(PK_PARAMS, peak=True, **{
        k: torch.tensor(v, dtype=torch.float64) for k, v in rows.items()})
    batched = pk.compute_peak_smooth(batch, t_full - t_smooth, t_smooth)
    for b in range(2):
        row = dict(PK_PARAMS, peak=True, **{k: v[b] for k, v in rows.items()})
        alone = pk.compute_peak_smooth(row, t_full - t_smooth, t_smooth)
        for part in (0, 1):
            assert max_rel(batched[part][b], alone[part]) <= 1e-15
    params = dict(PK_PARAMS, peak=True)
    for name in ('lambda_uv', 'bias_prim', 'lambda_HeII'):
        assert pk._kaiser_product_terms(
            params, Sampling(frozenset({'bias_LYA', name}))) is None
    assert pk._kaiser_product_terms(
        params, Sampling(frozenset({'bias_LYA', 'bias_gamma'}))) is not None


# ----------------------------------------------------------------------
# 2. The correlation-function terms
# ----------------------------------------------------------------------
def test_shotnoise_table_equals_jax():
    """A(tau) on the host: the same numpy code, bit for bit."""
    tau, a_vals = corr_func.compute_shotnoise_A()
    want = JaxCorrelationFunction.compute_shotnoise_A()
    assert np.array_equal(tau, want[0]) and np.array_equal(a_vals, want[1])


def rescaled(port_xi, jax_xi, ap, at):
    """The AP-rescaled (r, mu) of both packages' CorrelationFunction."""
    got = port_xi._rescale_coords(port_xi._r, port_xi._mu, ap, at, 0.)
    want = jax_xi._rescale_coords(jax_xi._r, jax_xi._mu, ap, at, 0.)
    return got, want


TERM_PARAMS = {'Arel1': -13.5, 'Arel3': 1.2, 'Aasy0': 1.3, 'Aasy2': 0.9,
               'Aasy3': 1.1, 'bias_gamma': 0.1125, 'lambda_uv': 300.,
               'uv_shotnoise_amp': 0.4, 'croom_par0': 0.53,
               'croom_par1': 0.289, 'alpha_LYA': 2.9, 'alpha_QSO': 1.44}


@pytest.mark.parametrize('term', ['relativistic', 'asymmetry'])
def test_legacy_terms_match_jax(uv, term):
    """The relativistic (P_1, P_3 tables) and asymmetry (r P_1, r P_3,
    Aasy0 S_0 - Aasy2 S_2 in the first table) terms of the cross through
    the plain combine on the legacy knot grid, against vega_tpu's
    `spline_eval` of the legacy operators, at odd ell; a batch of
    amplitude rows against each row alone."""
    jax_vega, port = uv
    model, jax_model = port.models['qsoxlya'], jax_vega.models['qsoxlya']
    (r, mu), (jr, jmu) = rescaled(model.Xi_core, jax_model.Xi_core,
                                  1.03, 0.97)
    pk = port._pk_full
    fn = getattr(model.PktoXi, f'pk_to_xi_{term}')
    jfn = getattr(jax_model.PktoXi, f'pk_to_xi_{term}')
    got = fn(r, mu, pk, TERM_PARAMS)
    want = jfn(jr, jmu, np.asarray(pk), TERM_PARAMS)
    assert got.shape == (1, len(jr))
    assert max_rel(got[0], want) <= FACTOR_RTOL
    grid = model.PktoXi.legacy_operators(
        (1, 3) if term == 'relativistic' else (0, 2),
        1 if term == 'relativistic' else 2)[0]
    assert np.array_equal(grid.values, jax_model.PktoXi._get_rel_ops()[1])
    name = 'Arel1' if term == 'relativistic' else 'Aasy2'
    values = [TERM_PARAMS[name], 0.5 * TERM_PARAMS[name]]
    batched = fn(r, mu, pk, dict(TERM_PARAMS, **{
        name: torch.tensor(values, dtype=torch.float64)}))
    for b, value in enumerate(values):
        alone = fn(r, mu, pk, dict(TERM_PARAMS, **{name: value}))
        assert max_rel(batched[b], alone[0]) <= 1e-15


def test_shotnoise_and_croom_match_jax(uv):
    """The UV shotnoise term, its factored shape times its coefficient,
    and the Croom x standard bias evolution of the cross."""
    jax_vega, port = uv
    xi, jax_xi = (port.models['qsoxlya'].Xi_core,
                  jax_vega.models['qsoxlya'].Xi_core)
    (r, mu), (jr, jmu) = rescaled(xi, jax_xi, 1.03, 0.97)
    got = xi.compute_uv_shotnoise(TERM_PARAMS, r, mu)
    want = jax_xi.compute_uv_shotnoise(TERM_PARAMS, jr, jmu)
    assert max_rel(got, want) <= FACTOR_RTOL
    shape = xi._uv_shotnoise_shape(TERM_PARAMS['lambda_uv'], r, mu)
    coeff, = xi.shotnoise_coefficients(TERM_PARAMS)
    assert max_rel(coeff * shape, want) <= FACTOR_RTOL
    assert xi._croom == {'QSO': True, 'LYA': False}
    assert max_rel(xi.compute_bias_evol(TERM_PARAMS),
                   jax_xi.compute_bias_evol(TERM_PARAMS)) <= FACTOR_RTOL


# ----------------------------------------------------------------------
# 3. synthetic-dr16-uv as a whole
# ----------------------------------------------------------------------
def test_uv_dense_chi2_batch_matches_jax(uv_dense, golden):
    rows = as_rows(golden['dense_rows'])
    assert uv_dense.get_collapsed(NAMES) == {}
    got = uv_dense.chi2_batch(rows).numpy()
    want = np.asarray(golden['chi2_dense'])
    assert np.all(got < 1e99)
    assert np.max(np.abs(got - want) / np.abs(want)) <= CHI2_RTOL


@pytest.mark.parametrize('regime', ['dense', 'route'])
def test_uv_value_gradient_match_jax(uv, uv_dense, golden, regime):
    """chi^2 and its gradient over the twelve names: dense (the legacy
    terms' combine under autograd), and on vega_tpu's route (the auto
    from the grid payload with the UV terms in its basis, the cross
    dense), the payload held only within the mode budget (1e-6)."""
    port = uv_dense if regime == 'dense' else uv[1]
    tol = DERIV_RTOL if regime == 'dense' else 1e-6
    point = golden['point']
    value, grad = port.chi2_value_and_gradient(point)
    want = golden[regime]
    assert max_rel(value, want['chi2']) <= tol
    assert max_rel([grad[n] for n in point], want['gradient']) <= tol


def test_uv_route_serves_the_auto_as_jax(uv, golden):
    """vega_tpu's route: the auto from the grid payload (its UV Kaiser
    grid and shotnoise term in the basis), the cross dense (the legacy
    terms densify it); the same correlations in the payload, the same
    reference coefficients, and chi^2 within the mode budget. With
    nuisance names alone the auto's collapse has the same keys."""
    _, port = uv
    for label, names in (('names', NAMES), ('nuisance', NUISANCE)):
        payload = port.get_collapsed(names)
        assert sorted(payload) == golden['keys'][label]
        assert 'qsoxlya' not in payload
        ref = 'cref' if '__grid__' in payload else 'c0'
        assert max_rel(payload['lyaxlya'][ref],
                       golden['keys'][f'{label}_ref']) <= 1e-12
    got = port.chi2_batch(as_rows(golden['route_rows'])).numpy()
    want = np.asarray(golden['chi2_route'])
    assert np.all(np.abs(got - want) <= GRID_ABS + GRID_REL * np.abs(want))


def test_uv_sampled_lambda_densifies_as_jax(uv, golden):
    """lambda_uv sampled: no basis grid for the UV term and no factored
    shotnoise, so neither package collapses the auto."""
    _, port = uv
    assert sorted(port.get_collapsed(LAMBDA_NAMES)) == \
        golden['keys']['lambda'] == []


@pytest.mark.parametrize('corr', ['lyaxlya', 'qsoxlya'])
def test_uv_coefficient_program_matches_factored_c0(uv, corr):
    """Model.coefficients restates the auto's factored coefficients: per
    component the UV-merged Kaiser terms (bias_gamma among them) and the
    shotnoise's bias_gamma^2 amplitude, then the metals'; the cross's
    legacy terms leave it dense. The factored model's dense view equals
    the dense model."""
    _, port = uv
    model = port.models[corr]
    pars, _ = port._batch_params({n: v[:1] for n, v in
                                  draw_rows(1, 2).items()})
    factored, _ = model.compute(pars, port._pk_full, port._pk_smooth,
                                sampling=Sampling(frozenset(NUISANCE)))
    dense, _ = model.compute(pars, port._pk_full, port._pk_smooth)
    if corr == 'qsoxlya':
        assert not isinstance(factored, FactoredXi)
        assert max_rel(factored, dense) <= 1e-12
        return
    assert isinstance(factored, FactoredXi)
    c0 = factored.coeff_vector().reshape(-1).numpy()
    got = model.coefficients(pars, 1)[0].numpy()
    assert got.shape == c0.shape
    assert np.max(np.abs(got - c0)) <= COEFF_RTOL * np.max(np.abs(c0))
    assert max_rel(factored.dense(), dense[0]) <= 1e-12


def test_uv_in_model_alone_keeps_the_metals_stacked(uv):
    """UV in [model] and not in [metals]: both packages stack the
    metals (vega_tpu/metals.py:150-172)."""
    jax_vega, port = uv
    for corr in ('lyaxlya', 'qsoxlya'):
        assert port.models[corr].metals._stacked_plans is not None
        assert jax_vega.models[corr].metals._stacked_plans is not None


# ----------------------------------------------------------------------
# 4. The variants synthetic-dr16-uv cannot carry
# ----------------------------------------------------------------------
VARIANTS = {
    'heii': dict(auto='HeII-reionization = True\n',
                 cross='HeII-reionization = True\n',
                 parameters='bias_gamma_e = 0.08\nlambda_HeII = 100.\n'),
    'single_multipole': dict(auto='single_multipole = 0\n'),
    'fht_extrap': dict(auto='fht_extrap = True\n', auto_metals=False),
    'new_bias_evolution': dict(cross='new-bias-evolution = True\n',
                               omega_m=0.315, qso_z_evol='bias_vs_z_std'),
}
VARIANT_POINT = {'ap': 1.03, 'at': 0.97, 'bias_LYA': -0.121,
                 'bias_gamma': 0.1}
VARIANT_ROWS = {'ap': np.array([1.0, 1.03]), 'at': np.array([1.0, 0.97]),
                'bias_LYA': np.array([-0.117, -0.121]),
                'bias_gamma': np.array([0.1125, 0.1])}


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_variant_matches_jax(uv_main, golden, tmp_path, monkeypatch,
                             variant):
    """Each variant's chi^2 and gradient at a point (DERIV_RTOL) and the
    correlations each package's route collapses for (ap, at, bias_LYA,
    bias_gamma). single_multipole and fht_extrap leave the auto dense and
    the legacy terms the cross, so nothing collapses and the route is the
    dense path; new-bias-evolution changes the cross alone, dense by its
    legacy terms (its split relative evolutions equal vega_tpu's); heii
    keeps the auto's HeII grid in the basis: the dense path, then the
    grid payload and its chi^2 within the mode budget."""
    main = dataset_variant(uv_main, tmp_path / variant, **VARIANTS[variant])
    want = golden['variants'][variant]
    if variant in ('heii', 'new_bias_evolution'):
        monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
    port = VegaInterface(main, device='cpu')
    assert sorted(port.get_collapsed(list(VARIANT_POINT))) == want['keys']
    value, grad = port.chi2_value_and_gradient(VARIANT_POINT)
    assert max_rel(value, want['chi2']) <= DERIV_RTOL
    assert max_rel([grad[n] for n in VARIANT_POINT],
                   want['gradient']) <= DERIV_RTOL
    if variant in ('single_multipole', 'fht_extrap'):
        assert want['keys'] == []
    if variant == 'new_bias_evolution':
        xi = port.models['qsoxlya'].Xi_core
        jax_xi = JaxInterface(main).models['qsoxlya'].Xi_core
        assert xi._split_evol is not None and jax_xi._use_new_bias_evol
        assert max_rel(xi._split_evol[0], jax_xi._rel_z_evol_1) <= 1e-15
        assert max_rel(xi._split_evol[1], jax_xi._rel_z_evol_2) <= 1e-15
    if variant == 'heii':
        monkeypatch.delenv('VEGA_TPU_FACTORED')
        port = VegaInterface(main, device='cpu')
        assert sorted(port.get_collapsed(list(VARIANT_POINT))) == \
            want['route_keys'] == ['__grid__', 'lyaxlya']
        got = port.chi2_batch(VARIANT_ROWS).numpy()
        want = np.asarray(want['chi2_route'])
        assert np.all(np.abs(got - want)
                      <= GRID_ABS + GRID_REL * np.abs(want))


def test_croom_with_new_bias_evolution_raises_as_jax(uv_main, golden,
                                                     tmp_path, monkeypatch,
                                                     capsys):
    """Croom's evolution beside the split one: both packages raise
    AssertionError at the first evaluation (vega_tpu/correlation_func.py:
    267-268); without a cosmology both warn and keep the mean evolution."""
    main = dataset_variant(uv_main, tmp_path / 'croom',
                           cross='new-bias-evolution = True\n',
                           omega_m=0.315)
    monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
    assert golden['croom_new_bias'].startswith('AssertionError: Croom')
    with pytest.raises(AssertionError, match='Croom'):
        VegaInterface(main, device='cpu').chi2()
    main = dataset_variant(uv_main, tmp_path / 'mean',
                           cross='new-bias-evolution = True\n')
    capsys.readouterr()
    port = VegaInterface(main, device='cpu')
    assert 'No cosmology found' in capsys.readouterr().out
    assert port.models['qsoxlya'].Xi_core._split_evol is None


# ----------------------------------------------------------------------
# 5. The f32 mode carries each option
# ----------------------------------------------------------------------
F32_CASES = {
    'UVB-fluctuations': ('lyaxlya', 'UVB-fluctuations = True\n'),
    'HeII-reionization': ('lyaxlya', 'HeII-reionization = True\n'),
    'UVB-shotnoise': ('lyaxlya', 'UVB-shotnoise = True\n'),
    'relativistic correction': ('qsoxlya',
                                'relativistic correction = True\n'),
    'standard asymmetry': ('qsoxlya', 'standard asymmetry = True\n'),
    'Croom bias evolution': ('qsoxlya', None),
    'new-bias-evolution': ('qsoxlya', 'new-bias-evolution = True\n'),
    'single_multipole': ('lyaxlya', 'single_multipole = 0\n'),
    'fht_extrap': ('lyaxlya', 'fht_extrap = True\n'),
}
# the parameters of the options (parameter_defaults.ini's, as
# DR16_UV_PARAMETERS), added to the main ini's [parameters]
F32_PARAMETERS = ('bias_gamma = 0.1125\nbias_prim = -0.66\n'
                  'lambda_uv = 300.\nbias_gamma_e = 0.08\n'
                  'lambda_HeII = 100.\nuv_shotnoise_amp = 0.001\n'
                  'Arel1 = -13.5\nArel3 = 1.\nAasy0 = 1.\nAasy2 = 1.\n'
                  'Aasy3 = 1.\ncroom_par0 = 0.53\ncroom_par1 = 0.289\n')
F32_ROWS = {'bias_LYA': [-0.117, -0.12], 'beta_LYA': [1.67, 1.6]}
F32_LADDER_ABS, F32_LADDER_REL = 0.3, 3e-4


@pytest.fixture(scope='module')
def f32_main(tmp_path_factory):
    """synthetic-full's configuration at size='tiny', the f32 mode's."""
    return make_synthetic_dataset(tmp_path_factory.mktemp('f32'),
                                  cross=True, size='tiny', device='cpu')


@pytest.mark.parametrize('option', list(F32_CASES))
def test_f32_mode_refuses_each_option(f32_main, tmp_path, option):
    """On the f32 mode's own configuration, each option, which the f32
    mode refused until it carried the reference's own terms, builds in
    f32: chi2_batch gives a finite float32 batch within vega_tpu's f32
    ladder (|d chi2| <= max(0.3, 3e-4 |chi2|)) of the f64 interface's on
    the same files (tests/test_torch_f32_terms.py holds each against
    vega_tpu's f32 and f64)."""
    corr, line = F32_CASES[option]
    lines = {'auto' if corr == 'lyaxlya' else 'cross': line or ''}
    main = dataset_variant(f32_main, tmp_path / 'w', **lines,
                           qso_z_evol='croom' if line is None else None)
    main.write_text(main.read_text().replace(
        '[parameters]\n', '[parameters]\n' + F32_PARAMETERS, 1))
    chi2 = {dtype: VegaInterface(main, device='cpu', dtype=dtype)
            .chi2_batch(F32_ROWS) for dtype in (torch.float32, torch.float64)}
    assert chi2[torch.float32].dtype == torch.float32
    chi2 = {dtype: c.double().numpy() for dtype, c in chi2.items()}
    assert np.all(np.isfinite(chi2[torch.float32]))
    assert np.all(np.abs(chi2[torch.float32] - chi2[torch.float64])
                  <= np.maximum(F32_LADDER_ABS,
                                F32_LADDER_REL * np.abs(chi2[torch.float64])))

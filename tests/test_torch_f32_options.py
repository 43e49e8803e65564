"""The f32 throughput mode of the PyTorch port (VegaInterface(..., dtype=
torch.float32) or VEGA_TPU_X64=0) on the likelihood options, on the CPU
at size='tiny' (tests/tools/make_torch_port_f32_options_goldens.py's
`make_tiny`, the port's own dataset functions):

- small-scale marginalization on synthetic-desi-marg, in the covariance
  (the dense chi^2, value and gradient, vega_tpu's grid route) and in
  the fit (marginalize-in-fit: the dense chi^2, value and gradient, no
  collapse); the template coefficients of chi2(return_marg_coeff=True)
  and of compute_marg_coeff; corr_num_marg_modes, log_lik with the
  coefficients at a few rows and the nested and SMC samplers'
  .paramnames (the samplers' derived columns);
- save-components: `cli fit` under VEGA_TPU_X64=0 writing PK_ / Xi_
  (column names, dtypes and values), and compute_model's saved
  components, the metal pairs' among them, on synthetic-dr16-published;
- model_pk's multipoles (and its chi^2's IndexError);
- use_full_pk_for_mc's fiducial and one mock fit;
- correlations without a data file: each evaluation raises vega_tpu's
  exception type.

vega_tpu's numbers on the same files, in f32 (VEGA_TPU_X64=0, in a
process of their own) and in f64, are committed in
tests/data/torch_port_f32_options_goldens.json ('tiny'). A chi^2 is held
to the ladder of vega_tpu's f32 (tests/test_f32_mode.py:106-109):
|d chi2| <= max(0.3, 3e-4 |chi2|), against vega_tpu's f64 and, where
vega_tpu's own f32 is within the ladder of its f64, against its f32; a
gradient entry to max(0.3, 3e-4 max|gradient|). Arrays are held to the
tolerances beside their use, of the largest entry of vega_tpu's f64.
The full-size records feed chip_smoke.py's f32_options phase.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from make_torch_port_f32_options_goldens import (  # noqa: E402
    DATA_FREE_CALLS, DIRECT_MOCK_NAMES, MOCK_SEED, make_tiny,
    saved_components)
from make_torch_port_mc_goldens import numpy_mocks, sample_subset  # noqa: E402
from test_torch_f32_models import gradient_within, within_ladder  # noqa: E402
from vega_tpu.io.fits import read_fits as jax_read_fits  # noqa: E402
from vega_tpu.samplers.nested import NestedSampler as JaxNestedSampler  # noqa: E402
from vega_tpu.samplers.smc import SMCSampler as JaxSMCSampler  # noqa: E402
from vega_tpu_torch import cli  # noqa: E402
from vega_tpu_torch.io.fits import read_fits  # noqa: E402
from vega_tpu_torch.parallel import MonteCarloEngine  # noqa: E402
from vega_tpu_torch.samplers.nested import NestedSampler  # noqa: E402
from vega_tpu_torch.samplers.smc import SMCSampler  # noqa: E402
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

GOLDENS = (Path(__file__).parent / 'data'
           / 'torch_port_f32_options_goldens.json')
MARG = ('marg', 'marg_in_fit')
# a model array in f32 (multipoles, the Monte-Carlo fiducial, a saved
# component at the same point) against vega_tpu's, of max|f64|
# (measured: 3.5e-6 on the saved components, 2.3e-7 on the multipoles)
ARRAY_RTOL = 1e-5
# the template coefficients, of their largest f64 entry: a difference of
# the data and an f32 model times the coefficient matrix (measured 3.5e-6)
COEFF_RTOL = 1e-4
# PK_ / Xi_ of two f32 fits, each at its own best fit: of max|column|
# (measured 2.0e-6)
FIT_COMPONENT_RTOL = 1e-4
# one f32 mock fit against vega_tpu's f64 fit of the same mock: values
# within a fraction of vega_tpu's errors (measured 8.8e-5)
MOCK_FIT_SIGMA = 1e-3


@pytest.fixture(scope='module', autouse=True)
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('MPLBACKEND', 'Agg')
        mp.delenv('VEGA_TPU_X64', raising=False)
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        yield mp


@pytest.fixture(scope='module')
def goldens():
    return json.loads(GOLDENS.read_text())['tiny']


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """files(name): main.ini of a tiny configuration, written once."""
    work = tmp_path_factory.mktemp('f32_options')
    made = {}

    def get(name):
        if name not in made:
            made[name] = make_tiny(name, work / name)
        return made[name]
    return get


@pytest.fixture(scope='module')
def port(env, files):
    """port(name, regime, dtype=torch.float32): the port's interface,
    built once (dense: VEGA_TPU_FACTORED=0; grid: the defaults)."""
    built = {}

    def get(name, regime='dense', dtype=torch.float32):
        key = (name, regime, dtype)
        if key not in built:
            if regime == 'dense':
                env.setenv('VEGA_TPU_FACTORED', '0')
            built[key] = VegaInterface(files(name), device='cpu',
                                       dtype=dtype)
            env.delenv('VEGA_TPU_FACTORED', raising=False)
        return built[key]
    return get


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def jax_within(record):
    """Whether vega_tpu's own f32 chi^2 is within the ladder of its f64."""
    return within_ladder(record['f32']['chi2'], record['f64']['chi2'])


def held_chi2(got, record):
    assert got.dtype == torch.float32
    got = got.numpy()
    assert np.all(np.isfinite(got)) and np.all(got < 1e30)
    assert within_ladder(got, record['f64']['chi2'])
    if jax_within(record):
        assert within_ladder(got, record['f32']['chi2'])


# ----------------------------------------------------------------------
# Small-scale marginalization
# ----------------------------------------------------------------------
@pytest.mark.parametrize('name', MARG)
def test_marg_dense_chi2_matches_jax(port, goldens, name):
    """The dense chi^2 at 4 points, the templates in the covariance or
    fitted per row, within the ladder of vega_tpu's f64 and f32."""
    record = goldens[f'{name}/dense']
    held_chi2(port(name).chi2_batch(record['job']['points']), record)


@pytest.mark.parametrize('name', MARG)
def test_marg_value_and_gradient_match(port, goldens, name):
    """chi2_value_and_gradient at the first point: the value within the
    ladder, each gradient entry within max(0.3, 3e-4 max|gradient|) of
    vega_tpu's f64, and of its f32 where that is within the ladder."""
    record = goldens[f'{name}/dense']
    point = record['job']['derivative_points']['0']
    value, grad = port(name).chi2_value_and_gradient(point)
    names = list(point)
    records = [record['f64']] + ([record['f32']] if jax_within(record)
                                 else [])
    for want in records:
        assert within_ladder([value], [want['value/0']])
        assert gradient_within([grad[n] for n in names],
                               [want['gradient/0'][n] for n in names])


def test_marg_grid_route_matches_jax(port, goldens):
    """vega_tpu's grid route on the updated covariance (8 x 8 (ap, at)
    nodes, the linear names in the coefficient program) serves both
    correlations, its chi^2 within the ladder of vega_tpu's f64 and f32
    grid route; marginalize-in-fit serves no collapse, as vega_tpu."""
    record = goldens['marg/grid']
    grid = port('marg', 'grid')
    names = frozenset(record['job']['points'])
    assert set(grid.get_collapsed(names)) == {'__grid__', 'lyaxlya',
                                              'qsoxlya'}
    held_chi2(grid.chi2_batch(record['job']['points']), record)
    assert port('marg_in_fit', 'grid').get_collapsed(names) == {}


@pytest.mark.parametrize('name', MARG)
def test_marg_coefficients_match_jax(port, goldens, name):
    """chi2(return_marg_coeff=True) and compute_marg_coeff of the model at
    the first point: vega_tpu's dtypes (under marginalize-in-fit the
    coefficients the f32 chi^2 fitted, float32; else the host product of
    the f64 coefficient matrix, float64) and values within COEFF_RTOL of
    vega_tpu's f64 and f32 (measured: see the assertion's bound)."""
    record = goldens[f'{name}/dense']
    vega = port(name)
    point = record['job']['coeff_point']
    chi2, coeffs = vega.chi2(point, return_marg_coeff=True)
    assert within_ladder([chi2], [record['f64']['coeff_chi2']])
    direct = vega.compute_marg_coeff(vega.compute_model(point,
                                                        run_init=False))
    for got, key in ((coeffs, 'coeff'), (direct, 'compute_marg_coeff')):
        want32, want64 = record['f32'][key], record['f64'][key]
        assert sorted(got) == sorted(want32) == sorted(want64)
        for corr, values in got.items():
            assert str(np.asarray(values).dtype) == want32[corr]['dtype']
            for want in (want64, want32):
                assert max_rel(values, want[corr]['values']) <= COEFF_RTOL


@pytest.mark.parametrize('name', MARG)
def test_sampler_derived_columns_match_jax(port, goldens, tmp_path, name):
    """The samplers' derived columns in f32: corr_num_marg_modes as
    vega_tpu's f32 interface's, the nested and SMC samplers' .paramnames
    written from it as vega_tpu's samplers write them, and log_lik with
    the coefficients (what a chain's rows carry once post-processed) at
    3 rows: log_lik within half the ladder, the coefficients in
    vega_tpu's dtype within COEFF_RTOL."""
    record = goldens[f'{name}/dense']
    vega = port(name)
    modes = vega.corr_num_marg_modes
    assert modes == record['f32']['corr_num_marg_modes']
    assert all(modes.values())
    limits = {'bias_LYA': (-0.2, -0.05), 'beta_LYA': (1.0, 2.5)}
    for label, cls in (('ns', NestedSampler), ('jax_ns', JaxNestedSampler),
                       ('smc', SMCSampler), ('jax_smc', JaxSMCSampler)):
        config = configparser.ConfigParser()
        config['s'] = {'path': str(tmp_path / label), 'name': 'marg'}
        (tmp_path / label).mkdir()
        cls(config['s'], limits, lambda params: 0.0, modes)
    for kind in ('ns', 'smc'):
        assert (tmp_path / kind / 'marg.paramnames').read_text() == \
            (tmp_path / f'jax_{kind}' / 'marg.paramnames').read_text()
    for row, want32, want64 in zip(record['job']['derived_rows'],
                                   record['f32']['derived'],
                                   record['f64']['derived']):
        log_lik, marg = vega.log_lik(row, return_marg_coeff=True)
        assert within_ladder([-2 * log_lik], [-2 * want64['log_lik']])
        assert str(marg.dtype) == want32['dtype']
        assert max_rel(marg, want64['marg_coeff']) <= COEFF_RTOL
        assert max_rel(marg, want32['marg_coeff']) <= COEFF_RTOL


# ----------------------------------------------------------------------
# save-components
# ----------------------------------------------------------------------
def hdus(path, reader):
    return {h.name: h for h in reader(path) if getattr(h, 'name', '')}


def test_components_fit_matches_jax(env, files, goldens):
    """`cli fit --device cpu` under VEGA_TPU_X64=0 writes the results file
    with PK_lyaxlya and Xi_lyaxlya: the HDUs, the columns and their
    dtypes (float32) of vega_tpu's f32 run_vega; each column within
    FIT_COMPONENT_RTOL of max|column| of vega_tpu's f32 and f64 files (two
    f32 fits, each at its own best fit), read by both packages'
    readers."""
    want32, want64 = (goldens['components_fit'][d] for d in ('f32', 'f64'))
    main = files('components_fit')
    env.setenv('VEGA_TPU_X64', '0')
    try:
        assert cli.main(['fit', str(main), '--device', 'cpu']) == 0
    finally:
        env.delenv('VEGA_TPU_X64')
    path = main.parent / 'results.fits'
    for reader in (read_fits, jax_read_fits):
        got = hdus(path, reader)
        assert sorted(got) == want32['hdus']
        for hdu in ('PK_lyaxlya', 'Xi_lyaxlya'):
            assert set(got[hdu].columns) == set(want32[hdu])
            for col, want in want32[hdu].items():
                values = np.asarray(got[hdu][col])
                assert str(values.dtype) == want['dtype'] == 'float32'
                for ref in (want, want64[hdu][col]):
                    assert max_rel(values.ravel(), ref['values']) <= \
                        FIT_COMPONENT_RTOL


def test_saved_components_match_jax(port, goldens):
    """compute_model at the configuration's values on tiny
    synthetic-dr16-published with the components written: every saved
    component (peak and smooth, the core's and each metal pair's, the
    metals' own) as vega_tpu's f32 keeps it (keys, float32), within
    ARRAY_RTOL of max|f64| at vega_tpu's 64 indices; the returned model
    likewise."""
    record = goldens['components']
    vega = port('components')
    model = vega.compute_model(record['job']['point'], run_init=False)
    saved = saved_components(vega)
    assert sorted(saved) == sorted(record['f32']['components'])
    for corr, parts in saved.items():
        want32 = record['f32']['components'][corr]
        want64 = record['f64']['components'][corr]
        assert sorted(parts) == sorted(want32) == sorted(want64)
        checks = [(value, want32[key], want64[key])
                  for key, value in parts.items()]
        checks.append((model[corr], record['f32']['model'][corr],
                       record['f64']['model'][corr]))
        for value, w32, w64 in checks:
            value = np.asarray(value)
            assert str(value.dtype) == w32['dtype'] == 'float32'
            assert value.size == w64['size']
            picked = value.ravel()[w64['index']]
            assert np.max(np.abs(picked - w64['values'])) <= \
                ARRAY_RTOL * w64['max_abs']


# ----------------------------------------------------------------------
# model_pk, use_full_pk_for_mc, data-free correlations
# ----------------------------------------------------------------------
def test_model_pk_multipoles_match_jax(port, goldens):
    """compute_model's P(k) multipoles in f32 (dtype, shape) within
    ARRAY_RTOL of max|f64| of vega_tpu's f64 and f32; the chi^2 raises
    IndexError, as in f64 (vega_tpu fails on the data mask)."""
    record = goldens['model_pk']
    vega = port('model_pk')
    model = vega.compute_model(run_init=False)
    assert sorted(model) == sorted(record['f32']['multipoles'])
    for corr, value in model.items():
        value = np.asarray(value)
        for want in (record['f32']['multipoles'][corr],
                     record['f64']['multipoles'][corr]):
            assert list(value.shape) == want['shape']
            assert max_rel(value.ravel(), want['values']) <= ARRAY_RTOL
        assert str(value.dtype) == \
            record['f32']['multipoles'][corr]['dtype'] == 'float32'
    with pytest.raises(IndexError):
        vega.chi2()


def test_use_full_pk_for_mc_matches_jax(port, goldens):
    """use_full_pk_for_mc with an empty [sample]: the fiducial of
    get_fiducial_for_monte_carlo (compute_direct at [mc parameters]) in
    vega_tpu's f32 dtype within ARRAY_RTOL of max|f64|; one numpy mock
    around it fitted by MonteCarloEngine.fit_mocks over the mc goldens'
    four names: values within MOCK_FIT_SIGMA of vega_tpu's f64 errors,
    chi^2 within the ladder; initialize_monte_carlo's mock
    (Analysis.create_monte_carlo_sim around the fiducial) in vega_tpu's
    f32 dtype within ARRAY_RTOL of max|mock|."""
    record = goldens['direct']
    vega = port('direct')
    fiducial = vega.get_fiducial_for_monte_carlo()
    for corr, value in fiducial.items():
        value = np.asarray(value)
        assert str(value.dtype) == record['f32']['fiducial'][corr]['dtype']
        for dtype in ('f32', 'f64'):
            assert max_rel(value, record[dtype]['fiducial'][corr]['values']
                           ) <= ARRAY_RTOL
    mocks = numpy_mocks(vega, fiducial, 1, MOCK_SEED)
    fits = MonteCarloEngine(vega).fit_mocks(
        mocks, sample_subset(vega.mc_config['sample'], DIRECT_MOCK_NAMES))
    want = record['f64']['mocks']
    assert list(fits['names']) == want['names']
    errors = np.asarray(want['errors'])
    assert np.all(np.abs(np.asarray(fits['values']) - want['values'])
                  <= MOCK_FIT_SIGMA * errors)
    assert within_ladder(np.asarray(fits['chisq'], float), want['chisq'])
    # Analysis.create_monte_carlo_sim's mock around the fiducial, drawn
    # from [control] mc_seed: vega_tpu's f32 dtype and values
    sim = vega.initialize_monte_carlo(print_func=lambda *args: None)
    assert vega.monte_carlo
    for corr, mock in sim.items():
        mock = np.asarray(mock)
        assert str(mock.dtype) == record['f32']['mc_sim'][corr]['dtype']
        for dtype in ('f32', 'f64'):
            # NaN outside the data mask, as vega_tpu's
            want = np.asarray(record[dtype]['mc_sim'][corr]['values'])
            finite = np.isfinite(want)
            assert np.array_equal(np.isfinite(mock), finite)
            assert max_rel(mock[finite], want[finite]) <= ARRAY_RTOL


@pytest.mark.parametrize('call', DATA_FREE_CALLS)
def test_data_free_evaluations_raise_as_jax(port, goldens, call):
    """Each evaluation of an f32 interface without data files raises the
    exception type vega_tpu's f32 interface raises."""
    vega = port('data_free')
    assert vega._has_data is False and vega.models == {}
    calls = {
        'compute_model': lambda: vega.compute_model({'bias_LYA': -0.11}),
        'compute_model_no_init': lambda: vega.compute_model(
            {'bias_LYA': -0.11}, run_init=False),
        'chi2': lambda: vega.chi2({'bias_LYA': -0.11}),
        'chi2_batch': lambda: vega.chi2_batch(
            {'bias_LYA': np.array([-0.11, -0.12])}),
    }
    want = goldens['data_free']['f32']['raises'][call]
    assert want == goldens['data_free']['f64']['raises'][call]
    with pytest.raises(Exception) as raised:
        calls[call]()
    assert type(raised.value).__name__ == want

"""Small-scale marginalization in the PyTorch port against the JAX package
(vega_tpu) on the CPU, at size='tiny' on synthetic auto + cross files
with a distortion matrix (the port's make_synthetic_dataset, noise 1):

- the host layer of both packages on the same files: the templates, the
  widened masks, the covariance update, the coefficient matrix, the modes
  kept and the effective size, for each box option, all-rmin and
  fit-marginalized-scales / marginalize-match-data-bins on and off; and
  the refusals (no distortion matrix, no common indices, masks that
  differ after the scale cuts);
- the covariance route (BuildConfig's marginalization: all-rmin, a prior
  of 10, both switches on): the dense chi^2, vega_tpu's grid route,
  value and gradient on both, minimize(), the log-likelihood on the
  updated covariance, the coefficients, and the payload fingerprint
  telling the configurations with and without marginalization apart;
- marginalize-in-fit (two boxes): chi2_batch, value, gradient and
  Hessian, minimize() with the best-fit coefficients and their headers
  in the results file, chi2 / log_lik with return_marg_coeff, and no
  collapse;
- a Monte-Carlo mock's coefficients, the joint covariance with the
  update, corr_num_marg_modes and the nested sampler's .paramnames, and
  both routes in the f32 mode against the f64 interface.

vega_tpu's likelihood numbers on these files are
tests/data/torch_port_tiny_goldens.json ('marginalization', made by
tests/tools/make_torch_port_tiny_goldens.py from this module's
configurations and points); the host layer is compared live. Each
tolerance stands beside its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vega_tpu.correlation_item import CorrelationItem as JaxCorrelationItem
from vega_tpu.data import Data as JaxData
from vega_tpu.io.fits import read_fits, write_fits
from vega_tpu.samplers.nested import NestedSampler as JaxNestedSampler
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch.correlation_item import CorrelationItem
from vega_tpu_torch.data import Data
from vega_tpu_torch.output import Output
from vega_tpu_torch.samplers.nested import NestedSampler
from vega_tpu_torch.testing import make_synthetic_dataset, with_control
from vega_tpu_torch.vega_interface import VegaInterface

CHI2_RTOL = 1e-12       # dense chi^2 and log-likelihood, relative
DERIV_RTOL = 1e-9       # a gradient or Hessian, of its largest entry
GRID_ABS, GRID_REL = 2e-4, 1e-9     # vega_tpu's default mode budget
GRID_DERIV_RTOL = 1e-6  # a gradient on the grid route, of its largest
COEFF_RTOL = 1e-10      # template coefficients, of their largest entry
# a fit: best-fit values within FIT_VALUE_SIGMA of the JAX errors, errors
# within FIT_ERROR_RTOL, fval within 1e-8 + 1e-10 fval
FIT_VALUE_SIGMA, FIT_ERROR_RTOL = 1e-3, 1e-5
GOLDENS = Path(__file__).resolve().parent / 'data' / \
    'torch_port_tiny_goldens.json'

SAMPLE = {'ap': 'True', 'at': 'True', 'bias_LYA': 'True',
          'beta_LYA': 'True'}
CONTROL = 'grid-nodes-ap = 8\ngrid-nodes-at = 8\nds-matmul = False\n'
# BuildConfig's marginalization once switched on
# (vega_tpu/build_config.py:105-115,325-341)
BUILD_CONFIG_MARG = ('marginalize-all-rmin-cuts = True\n'
                     'marginalize-prior-sigma = 10.0\n'
                     'fit-marginalized-scales = True\n'
                     'marginalize-match-data-bins = True\n')
IN_FIT_MARG = ('marginalize-below-rtmax = 30.\n'
               'marginalize-below-rpmax = 30.\n')
# all-rmin marginalizes the bins the r-min cut leaves out: at size='tiny'
# (20 Mpc/h bins) the default cut of 10 leaves none out, so those cases
# cut at ALL_RMIN_CUT (3 bins of the auto, 6 of the cross)
ALL_RMIN_CUT = 40.
HOST_CASES = {
    'rtmax': 'marginalize-below-rtmax = 30.',
    'rtmin': 'marginalize-above-rtmin = 150.',
    'rpmax': 'marginalize-below-rpmax = 30.',
    'rpmin': 'marginalize-above-rpmin = 150.',
    'rtmax_rpmax': IN_FIT_MARG,
    'rtmax_prior': 'marginalize-below-rtmax = 50.\n'
                   'marginalize-prior-sigma = 3.0',
    'rtmax_fit_scales_match_bins': 'marginalize-below-rtmax = 30.\n'
                                   'fit-marginalized-scales = True\n'
                                   'marginalize-match-data-bins = True',
    'all_rmin': 'marginalize-all-rmin-cuts = True',
    'all_rmin_fit_scales': 'marginalize-all-rmin-cuts = True\n'
                           'fit-marginalized-scales = True',
    'all_rmin_match_bins': 'marginalize-all-rmin-cuts = True\n'
                           'marginalize-match-data-bins = True',
    'build_config': BUILD_CONFIG_MARG,
}
MC_CONTROL = 'marginalize-in-fit = True\nmc_seed = 5'
MC_SECTIONS = ('[monte carlo]\nbias_LYA = True\nbeta_LYA = True\n\n'
               '[mc parameters]\n')
MC_POINT = {'bias_LYA': -0.121, 'beta_LYA': 1.62}


def draw_rows(n_rows, seed):
    """Rows 1% around the defaults of SAMPLE's names."""
    from vega_tpu_torch.testing import DEFAULT_PARAMS
    rng = np.random.default_rng(seed)
    return {n: DEFAULT_PARAMS[n] + 0.01 * abs(DEFAULT_PARAMS[n])
            * rng.normal(size=n_rows) for n in SAMPLE}


ROWS = draw_rows(4, 1)
POINT = {n: float(v[0]) for n, v in draw_rows(1, 2).items()}


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def parse(path):
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config.read(path)
    return config


def make_base(work, global_cov=False):
    """The tiny auto + cross files with a distortion matrix, noise 1 and
    SAMPLE, without marginalization: main.ini."""
    return make_synthetic_dataset(
        work, cross=True, size='tiny', device='cpu', noise=1.0, seed=3,
        with_distortion=True, sample=SAMPLE, extra_control=CONTROL,
        global_cov=global_cov)


def with_marg(main, dest, lines, control='', sample=None, sections=''):
    """A copy of `main`'s inis in `dest` with `lines` in every
    correlation's [model] (and the r-min cut at ALL_RMIN_CUT with
    all-rmin), `control` under [control], when given `sample` ({name:
    entry}) as [sample], and `sections` at the end: main.ini."""
    main, dest = Path(main), Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    text = main.read_text()
    for ini in ('lyaxlya.ini', 'qsoxlya.ini'):
        corr = (main.parent / ini).read_text().replace(
            '[model]\n', f'[model]\n{lines}\n', 1)
        if 'marginalize-all-rmin-cuts' in lines:
            corr = corr.replace('r-min = 10.', f'r-min = {ALL_RMIN_CUT}', 1)
        (dest / ini).write_text(corr)
        text = text.replace(str(main.parent / ini), str(dest / ini))
    text = text.replace(f'filename = {main.parent / "output"}',
                        f'filename = {dest / "output"}')
    if sample is not None:
        block = '\n'.join(f'{k} = {v}' for k, v in sample.items())
        text = re.sub(r'\[sample\]\n(.*?\n)\n', f'[sample]\n{block}\n\n',
                      text, count=1, flags=re.S)
    (dest / 'main.ini').write_text(text)
    return with_control(dest / 'main.ini', control, dest / 'main.ini',
                        sections)


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
def base(tmp_path_factory):
    return make_base(tmp_path_factory.mktemp('marg_base'))


@pytest.fixture(scope='module')
def goldens():
    return json.loads(GOLDENS.read_text())['marginalization']


def port(env, main, dense):
    """The port's interface on `main`, with VEGA_TPU_FACTORED=0 when
    `dense`."""
    if dense:
        env.setenv('VEGA_TPU_FACTORED', '0')
    try:
        return VegaInterface(main, device='cpu')
    finally:
        env.delenv('VEGA_TPU_FACTORED', raising=False)


# ----------------------------------------------------------------------
# 1. The host layer, both packages on the same files
# ----------------------------------------------------------------------
def data_pair(ini, marginalize_in_fit=False):
    """(port Data, vega_tpu Data) of one correlation ini."""
    got = Data(CorrelationItem(parse(ini)),
               marginalize_in_fit=marginalize_in_fit)
    want = JaxData(JaxCorrelationItem(parse(ini)),
                   marginalize_in_fit=marginalize_in_fit)
    return got, want


def assert_same_marginalization(got, want):
    """Every array of the marginalization bit for bit (the same numpy
    arithmetic in both packages)."""
    for attr in ('marg_templates', 'cov_marg_update',
                 'marg_diff2coeff_matrix', 'data_mask', 'model_mask',
                 'masked_data_vec', 'cov_mat', 'cov_mat_org',
                 'inv_masked_cov'):
        a, b = getattr(got, attr), getattr(want, attr)
        if b is None:
            assert a is None, attr
        else:
            assert a.shape == b.shape and np.array_equal(a, b), attr
    assert got.num_marg_modes == want.num_marg_modes > 0
    assert got.effective_data_size == want.effective_data_size
    assert got.effective_data_size == got.data_size - got.num_marg_modes
    assert got.log_cov_det == want.log_cov_det


@pytest.mark.parametrize('case', list(HOST_CASES))
def test_templates_and_matrices_match_jax(base, tmp_path, case):
    """Each option set on both correlations: the undistorted and
    distorted templates, the masks, the covariance update and the
    updated covariance (its copy as read kept), the coefficient matrix
    from the inverse before the update, the modes and the effective
    size."""
    main = with_marg(base, tmp_path, HOST_CASES[case])
    for ini in ('lyaxlya.ini', 'qsoxlya.ini'):
        got, want = data_pair(main.parent / ini)
        assert np.array_equal(
            got.corr_item.get_undist_xi_marg_templates(),
            want.corr_item.get_undist_xi_marg_templates()), ini
        assert_same_marginalization(got, want)
        # the update lands on the data-mask block of a copy
        assert got.cov_mat_org is not got.cov_mat
        block = np.ix_(got.data_mask, got.data_mask)
        assert np.array_equal(got.cov_mat_org[block] + got.cov_marg_update,
                              got.cov_mat[block])


def test_marginalize_in_fit_leaves_the_covariance(base, tmp_path):
    """With marginalize-in-fit the covariance stays as read (no update,
    no copy) and the coefficient matrix is the same."""
    main = with_marg(base, tmp_path, IN_FIT_MARG)
    for ini in ('lyaxlya.ini', 'qsoxlya.ini'):
        got, want = data_pair(main.parent / ini, marginalize_in_fit=True)
        assert_same_marginalization(got, want)
        assert got.cov_marg_update is None
        assert got.cov_mat_org is got.cov_mat


def test_refusals_match_jax(base, tmp_path):
    """No distortion matrix, no options, and no common indices: each
    package raises the same ValueError."""
    main = with_marg(base, tmp_path / 'rtmax', HOST_CASES['rtmax'])
    got, want = data_pair(main.parent / 'lyaxlya.ini')
    for data in (got, want):
        data._distortion_mat = None
        with pytest.raises(ValueError, match='Distortion matrix required'):
            data.get_dist_xi_marg_templates()
    got, want = data_pair(Path(base).parent / 'lyaxlya.ini')
    for data in (got, want):
        with pytest.raises(ValueError, match='Marginalization not'):
            data.get_dist_xi_marg_templates()
    main = with_marg(base, tmp_path / 'none', 'marginalize-below-rtmax = 30.'
                     '\nmarginalize-above-rtmin = 50.')
    for cls in (lambda ini: Data(CorrelationItem(parse(ini))),
                lambda ini: JaxData(JaxCorrelationItem(parse(ini)))):
        with pytest.raises(ValueError, match='No common indices'):
            cls(main.parent / 'lyaxlya.ini')


def test_masks_that_differ_are_refused_as_jax(base, tmp_path):
    """The cross's distortion in a distortion-file whose header puts the
    model grid's rt edges at 180 Mpc/h where the data's are at 200: with
    fit-marginalized-scales the widened data mask takes one rt column
    below 30 Mpc/h and the model mask two, and both packages refuse."""
    main = with_marg(base, tmp_path, 'marginalize-below-rtmax = 30.\n'
                     'fit-marginalized-scales = True')
    hdul = read_fits(Path(base).parent / 'xcf_synthetic.fits')
    header = hdul[1].header
    dmat = tmp_path / 'dmat_qsoxlya.fits'
    write_fits(dmat, [
        {'name': 'DMAT', 'header': {
            'RPMIN': header['RPMIN'], 'RPMAX': header['RPMAX'],
            'RTMAX': 180., 'NP': header['NP'], 'NT': header['NT'],
            'COEFMOD': 1},
         'columns': {'DM': hdul[1]['DM']}},
        {'name': 'ATTRI', 'columns': {
            'RP': hdul[2]['DMRP'], 'RT': hdul[2]['DMRT'],
            'Z': hdul[2]['DMZ']}}])
    ini = tmp_path / 'qsoxlya.ini'
    ini.write_text(ini.read_text().replace(
        '[data]\n', f'[data]\ndistortion-file = {dmat}\n', 1))
    for cls in (lambda: Data(CorrelationItem(parse(ini))),
                lambda: JaxData(JaxCorrelationItem(parse(ini)))):
        with pytest.raises(ValueError, match='masks should be the same'):
            cls()


# ----------------------------------------------------------------------
# 2. The covariance route: templates in the covariance
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def cov(env, base, tmp_path_factory):
    """BuildConfig's marginalization on both correlations: {'main', 'dense'
    (VEGA_TPU_FACTORED=0), 'route' (the defaults: the grid payload)}."""
    main = with_marg(base, tmp_path_factory.mktemp('marg_cov'),
                     BUILD_CONFIG_MARG)
    return {'main': main, 'dense': port(env, main, True),
            'route': port(env, main, False)}


def test_cov_route_dense_matches_jax(cov, goldens):
    """Dense chi2_batch at ROWS, chi^2 and its coefficients at the
    defaults, the log-likelihood on the updated covariance."""
    want = goldens['cov']
    vega = cov['dense']
    got = vega.chi2_batch(ROWS).numpy()
    assert max_rel(got, want['chi2_dense']) <= CHI2_RTOL
    chi2, coeffs = vega.chi2(return_marg_coeff=True)
    assert abs(chi2 - want['chi2_default']) <= CHI2_RTOL * want['chi2_default']
    assert sorted(coeffs) == sorted(want['coeff_default'])
    for name, value in want['coeff_default'].items():
        assert max_rel(coeffs[name], value) <= COEFF_RTOL, name
    log_lik = vega.log_lik()
    assert abs(log_lik - want['log_lik_default']) <= \
        CHI2_RTOL * abs(want['log_lik_default'])
    assert vega.corr_num_marg_modes == want['corr_num_marg_modes']


def test_cov_route_grid_matches_jax(cov, goldens):
    """vega_tpu's route for SAMPLE: the grid payload serves both
    correlations on the updated covariance, chi^2 within the mode
    budget."""
    want = goldens['cov']
    vega = cov['route']
    assert sorted(vega.get_collapsed(frozenset(SAMPLE))) == \
        want['route_keys'] == ['__grid__', 'lyaxlya', 'qsoxlya']
    got = vega.chi2_batch(ROWS).numpy()
    assert np.all(np.abs(got - want['chi2_route'])
                  <= GRID_ABS + GRID_REL * np.abs(want['chi2_route']))


@pytest.mark.parametrize('path', ['dense', 'route'])
def test_cov_route_value_gradient_match_jax(cov, goldens, path):
    """chi^2 and its gradient at POINT on each path."""
    want = goldens['cov'][f'value_gradient_{path}']
    value, grad = cov[path].chi2_value_and_gradient(POINT)
    if path == 'dense':
        assert abs(value - want['chi2']) <= CHI2_RTOL * want['chi2']
        rtol = DERIV_RTOL
    else:
        assert abs(value - want['chi2']) <= GRID_ABS + GRID_REL * want['chi2']
        rtol = GRID_DERIV_RTOL
    assert max_rel([grad[n] for n in POINT], want['gradient']) <= rtol


def check_fit(vega, want):
    """minimize() against vega_tpu's (FIT_VALUE_SIGMA, FIT_ERROR_RTOL,
    fval)."""
    vega.minimize()
    best = vega.bestfit
    assert sorted(best.values) == sorted(want['values'])
    for name, value in want['values'].items():
        error = want['errors'][name]
        assert abs(best.values[name] - value) <= FIT_VALUE_SIGMA * error, \
            name
        assert best.errors[name] == pytest.approx(error, rel=FIT_ERROR_RTOL)
    assert abs(best.fmin.fval - want['fval']) <= \
        1e-8 + 1e-10 * abs(want['fval'])
    assert best.fmin.is_valid and want['is_valid']


def test_cov_route_fit_matches_jax(cov, goldens):
    """minimize() on the dense path, and the best-fit coefficients of
    each correlation at vega_tpu's best fit."""
    vega = cov['dense']
    want = goldens['cov']['fit']
    check_fit(vega, want)
    # the best-fit model carries the templates at the best-fit
    # coefficients, which compute_model adds as vega_tpu's does
    stats = vega.bestfit_corr_stats
    with_templates = vega.compute_model(
        vega.bestfit.values, run_init=False,
        marg_coeff={n: s['bestfit_marg_coeff'] for n, s in stats.items()})
    for name, model in vega.bestfit_model.items():
        assert np.array_equal(with_templates[name], model), name
    at_jax = vega.compute_marg_coeff(
        vega.compute_model(want['values'], run_init=False))
    for name, value in want['bestfit_marg_coeff'].items():
        assert max_rel(at_jax[name], value) <= COEFF_RTOL, name
        assert vega.bestfit_corr_stats[name]['masked_size'] == \
            want['masked_size'][name]


def test_fingerprint_tells_marginalization_apart(env, base, cov, tmp_path):
    """With the payload disk cache on, the configuration with
    marginalization never loads the payload of the one without, nor the
    reverse: each sweeps first, under its own fingerprint, and then loads
    its own (the same chi^2 bit for bit)."""
    env.setenv('VEGA_TPU_GRID_CACHE', '1')
    env.setenv('VEGA_TPU_GRID_CACHE_DIR', str(tmp_path / 'cache'))
    try:
        key = frozenset(SAMPLE)
        seen = {}
        for label, main in (('plain', base), ('marg', cov['main']),
                            ('plain', base), ('marg', cov['main'])):
            vega = port(env, main, False)
            vega.get_collapsed(key)
            stats = vega.grid_stats
            chi2 = vega.chi2_batch(ROWS).numpy()
            if label not in seen:
                assert stats['source'] == 'sweep', label
                seen[label] = (stats['cache_path'], chi2)
            else:
                assert stats['source'] == 'disk', label
                assert stats['cache_path'] == seen[label][0]
                assert np.array_equal(chi2, seen[label][1])
        assert seen['plain'][0] != seen['marg'][0]
    finally:
        env.setenv('VEGA_TPU_GRID_CACHE', '0')
        env.delenv('VEGA_TPU_GRID_CACHE_DIR')


# ----------------------------------------------------------------------
# 3. marginalize-in-fit: templates fitted per evaluation
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def in_fit(env, base, tmp_path_factory):
    """Two boxes on both correlations with marginalize-in-fit = True: the
    port with the defaults (every call is dense)."""
    main = with_marg(base, tmp_path_factory.mktemp('marg_in_fit'),
                     IN_FIT_MARG, control='marginalize-in-fit = True')
    return port(env, main, False)


def test_in_fit_chi2_batch_matches_jax(in_fit, goldens):
    """No collapse for any name set (vega_tpu :305, :576-579), and
    chi2_batch at ROWS."""
    want = goldens['in_fit']
    assert in_fit.marginalize_in_fit
    assert in_fit.get_collapsed(frozenset(SAMPLE)) == {}
    assert in_fit.get_collapsed(frozenset(('bias_LYA',))) == {}
    got = in_fit.chi2_batch(ROWS).numpy()
    assert max_rel(got, want['chi2_batch']) <= CHI2_RTOL


def test_in_fit_derivatives_match_jax(in_fit, goldens):
    """chi^2, gradient and Hessian at POINT: autograd through the
    projection."""
    want = goldens['in_fit']
    value, grad = in_fit.chi2_value_and_gradient(POINT)
    assert abs(value - want['chi2']) <= CHI2_RTOL * want['chi2']
    assert max_rel([grad[n] for n in POINT], want['gradient']) <= DERIV_RTOL
    hess = in_fit.chi2_hessian(POINT, list(POINT))
    assert max_rel([[hess[a][b] for b in POINT] for a in POINT],
                   want['hessian']) <= DERIV_RTOL


def test_in_fit_coefficients_match_jax(in_fit, goldens):
    """chi2 and log_lik with return_marg_coeff=True at POINT: the
    coefficients per correlation, and in one array, correlations
    sorted."""
    want = goldens['in_fit']
    chi2, coeffs = in_fit.chi2(POINT, return_marg_coeff=True)
    assert abs(chi2 - want['chi2']) <= CHI2_RTOL * want['chi2']
    assert sorted(coeffs) == sorted(want['coeff'])
    for name, value in want['coeff'].items():
        assert max_rel(coeffs[name], value) <= COEFF_RTOL, name
    log_lik, marg_list = in_fit.log_lik(POINT, return_marg_coeff=True)
    assert abs(log_lik - want['log_lik']) <= CHI2_RTOL * abs(want['log_lik'])
    assert marg_list.shape == (len(want['marg_list']),)
    assert max_rel(marg_list, want['marg_list']) <= COEFF_RTOL


def test_in_fit_fit_and_results_file_match_jax(in_fit, goldens):
    """minimize() through the batched derivatives of the projection, the
    best-fit coefficients of each correlation (the port's at its best
    fit, vega_tpu's at vega_tpu's), the effective sizes, and the
    marg_coeff_i headers of the results file: vega_tpu's keys, the
    port's values. Both writers cut a key to 8 characters
    (output.py `_short_key`), so every marg_coeff_i lands on one key,
    which keeps the last coefficient, in both packages."""
    want = goldens['in_fit']['fit']
    check_fit(in_fit, want)
    stats = in_fit.bestfit_corr_stats
    own = in_fit.compute_marg_coeff(
        in_fit.compute_model(in_fit.bestfit.values, run_init=False))
    at_jax = in_fit.compute_marg_coeff(
        in_fit.compute_model(want['values'], run_init=False))
    for name, value in want['bestfit_marg_coeff'].items():
        assert max_rel(stats[name]['bestfit_marg_coeff'], own[name]) <= 1e-14
        assert max_rel(at_jax[name], value) <= COEFF_RTOL, name
        assert stats[name]['masked_size'] == want['masked_size'][name]
    in_fit.output.write_results(in_fit.bestfit_model, in_fit.params,
                                in_fit.minimizer, stats)
    hdul = read_fits(Path(in_fit.output.outfile + '.fits'))
    for name, keys in want['header_marg_keys'].items():
        header = next(h.header for h in hdul
                      if h.name == f'MODEL_{name}')
        got = {k: v for k, v in header.items() if 'MARG' in k.upper()}
        assert sorted(got) == keys, name
        written = {}
        for i, v in enumerate(stats[name]['bestfit_marg_coeff']):
            written[Output._short_key(f'marg_coeff_{i}').upper()] = float(v)
        assert got == written, name


def test_monte_carlo_mock_coefficients_match_jax(env, base, tmp_path,
                                                 goldens):
    """marginalize-in-fit on a seeded Monte-Carlo mock (an empty [sample]:
    the mock at the defaults, no fit first): the mock, then chi^2 and
    the coefficients at MC_POINT, taken against the mock."""
    want = goldens['mc']
    main = with_marg(base, tmp_path, IN_FIT_MARG, control=MC_CONTROL,
                     sample={}, sections=MC_SECTIONS)
    vega = port(env, main, False)
    mocks = vega.initialize_monte_carlo()
    for name, value in want['mock_sum'].items():
        mock = vega.data[name].masked_mc_mock
        assert abs(mock.sum() - value) <= 1e-12 * np.abs(mock).sum(), name
    chi2, coeffs = vega.chi2(MC_POINT, return_marg_coeff=True)
    assert abs(chi2 - want['chi2']) <= CHI2_RTOL * want['chi2']
    for name, value in want['coeff'].items():
        assert max_rel(coeffs[name], value) <= COEFF_RTOL, name
    assert mocks is not None


def test_joint_covariance_with_marginalization_matches_jax(env, tmp_path,
                                                           goldens):
    """The joint covariance takes each correlation's update on its block
    before its inverse (vega_tpu :1844-1857): the masked inverse as
    vega_tpu's bit for bit, dense chi2_batch at ROWS and the
    log-likelihood at the defaults."""
    want = goldens['joint']
    base = make_base(tmp_path / 'base', global_cov=True)
    main = with_marg(base, tmp_path / 'marg', BUILD_CONFIG_MARG)
    vega = port(env, main, False)
    ref = JaxInterface(main)
    assert np.array_equal(vega.masked_global_invcov,
                          ref.masked_global_invcov)
    assert vega.masked_global_log_cov_det == ref.masked_global_log_cov_det
    assert vega.get_collapsed(frozenset(SAMPLE)) == {}
    assert max_rel(vega.chi2_batch(ROWS).numpy(), want['chi2']) <= CHI2_RTOL
    assert abs(vega.log_lik() - want['log_lik_default']) <= \
        CHI2_RTOL * abs(want['log_lik_default'])


def test_in_fit_beside_joint_covariance_raises_as_jax(env, tmp_path):
    """marginalize-in-fit beside a joint covariance: vega_tpu's
    `_marg_coeff_graph` reads per-correlation data vectors, which the
    joint covariance does not keep, and raises KeyError at the first
    chi^2; the port raises the same."""
    base = make_base(tmp_path / 'base', global_cov=True)
    main = with_marg(base, tmp_path / 'marg', IN_FIT_MARG,
                     control='marginalize-in-fit = True')
    for vega in (port(env, main, False), JaxInterface(main)):
        with pytest.raises(KeyError, match='lyaxlya'):
            vega.chi2()


def test_sampler_derived_columns_match_jax(cov, tmp_path):
    """corr_num_marg_modes as vega_tpu's dict, and the nested sampler's
    .paramnames written from it as vega_tpu writes them."""
    ref = JaxInterface(cov['main'])
    modes = cov['dense'].corr_num_marg_modes
    assert modes == ref.corr_num_marg_modes and all(modes.values())
    limits = {'bias_LYA': (-0.2, -0.05), 'beta_LYA': (1.0, 2.5)}
    for label, cls, derived in (('port', NestedSampler, modes),
                                ('jax', JaxNestedSampler,
                                 ref.corr_num_marg_modes)):
        config = configparser.ConfigParser()
        config['ns'] = {'path': str(tmp_path / label), 'name': 'marg'}
        (tmp_path / label).mkdir()
        cls(config['ns'], limits, lambda params: 0.0, derived)
    assert (tmp_path / 'port' / 'marg.paramnames').read_text() == \
        (tmp_path / 'jax' / 'marg.paramnames').read_text()


@pytest.mark.parametrize('case', ['cov', 'in_fit'])
def test_f32_mode_refuses_marginalization(base, tmp_path, case):
    """The f32 mode, which refused both routes until the likelihood
    options joined it, builds them in f32 rather than in f64: the dense
    and the default route's chi^2 at ROWS are finite float32 batches
    within vega_tpu's f32 ladder (|d chi2| <= max(0.3, 3e-4 |chi2|)) of
    the f64 interface's on the same files (tests/test_torch_f32_options.py
    holds them against vega_tpu's f32)."""
    main = (with_marg(base, tmp_path, BUILD_CONFIG_MARG) if case == 'cov'
            else with_marg(base, tmp_path, IN_FIT_MARG,
                           control='marginalize-in-fit = True'))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        for dense in (True, False):
            if dense:
                mp.setenv('VEGA_TPU_FACTORED', '0')
            chi2 = [VegaInterface(main, device='cpu', dtype=dtype)
                    .chi2_batch(ROWS) for dtype in (torch.float32,
                                                    torch.float64)]
            mp.delenv('VEGA_TPU_FACTORED', raising=False)
            assert chi2[0].dtype == torch.float32
            got, want = chi2[0].numpy(), chi2[1].numpy()
            assert np.all(np.isfinite(got))
            assert np.all(np.abs(got - want)
                          <= np.maximum(0.3, 3e-4 * np.abs(want)))

"""The mock configurations' model pieces in the PyTorch port against the
JAX package (vega_tpu) on the CPU: full-shape smoothing (every parameter
route, gauss_iso, exp), the mock binning window (each
`mock-los-smoothing`), the Gaussian and `lorentz_gauss` velocity
dispersions, Pk damping and `skip-nl-model-in-peak`, factor by factor;
the stacked metal path with the [metals] section's own smoothing and
binning (Pk damping sends the pairs unrolled); the stacking guards
(fht_extrap beside old_fftlog, metal-scaling); the factored / dense
classification of fixed and sampled widths; the coefficient program with
the smoothing on; and the two builders' ini files against BuildConfig's
and against vega_tpu's own. tests/test_torch_mocks_fit.py holds each
configuration as a whole. The JAX side of the datasets is
tests/tools/jax_mocks_dataset.py. Each tolerance stands beside its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from jax_dr16pub_dataset import make_jax_dr16_published_dataset  # noqa: E402
from jax_metal_dataset import make_jax_metal_dataset  # noqa: E402
from jax_mocks_dataset import (build_lyacolore_inis,  # noqa: E402
                               example_module, make_jax_desi_mock_dataset,
                               make_jax_lyacolore_dataset)
from vega_tpu import utils as jax_utils  # noqa: E402
from vega_tpu.io.fits import read_fits as jax_read_fits  # noqa: E402
from vega_tpu.power_spectrum import (  # noqa: E402
    PowerSpectrum as JaxPowerSpectrum)
from vega_tpu.vega_interface import VegaInterface as JaxInterface  # noqa: E402
from vega_tpu_torch.factored import FactoredXi, Sampling  # noqa: E402
from vega_tpu_torch.power_spectrum import PowerSpectrum  # noqa: E402
from vega_tpu_torch.testing import (DESI_MOCK_GRID_NAMES,  # noqa: E402
                                    DESI_MOCK_SAMPLED,
                                    DESI_MOCK_SMOOTHING, DR16_METALS,
                                    DR16_PARAMETERS, LYACOLORE_SAMPLED,
                                    dr16_extra_model, lyacolore_correlation,
                                    lyacolore_main, make_desi_mock_dataset,
                                    make_lyacolore_dataset)
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

FACTOR_RTOL = 1e-13     # one power spectrum, f64 both sides
XI_RTOL = 1e-12         # a metal stack or a model, of its largest entry
CHI2_RTOL = 1e-12       # chi^2, relative
COEFF_RTOL = 1e-12      # a factored coefficient vector, of its largest
GRID_ABS, GRID_REL = 2e-4, 1e-9     # vega_tpu's default mode budget
CONTROL = 'grid-nodes-ap = 8\ngrid-nodes-at = 8\nds-matmul = False\n'
TINY_GOLDENS = Path(__file__).resolve().parent / 'data' / \
    'torch_port_tiny_goldens.json'
# the published configuration's small node grid (its test modules')
DR16PUB_CONTROL = {'grid-nodes-ap': '6', 'grid-nodes-at': '6',
                   'grid-nodes-drp_QSO': '4',
                   'grid-nodes-sigma_velo_disp_lorentz_QSO': '4',
                   'ds-matmul': 'False'}


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def parse(path):
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config.read(path)
    return config


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


# ----------------------------------------------------------------------
# 1. The power-spectrum factors
# ----------------------------------------------------------------------
LYA = {'name': 'LYA', 'type': 'continuous'}
QSO = {'name': 'QSO', 'type': 'discrete'}
SI2 = {'name': 'SiII(1260)', 'type': 'continuous'}
PK_PARAMS = {'bias_LYA': -0.12, 'beta_LYA': 1.6, 'bias_QSO': 3.7,
             'beta_QSO': 0.26, 'bias_SiII(1260)': -0.002,
             'beta_SiII(1260)': 0.5, 'sigmaNL_par': 6.37,
             'sigmaNL_per': 3.24, 'growth_rate': 0.97,
             'sigma_velo_disp_lorentz_QSO': 6.86,
             'sigma_velo_disp_gauss_QSO': 3.1,
             'dnl_arinyo_q1': 0.8558, 'dnl_arinyo_kv': 1.11454,
             'dnl_arinyo_av': 0.5378, 'dnl_arinyo_bv': 1.607,
             'dnl_arinyo_kp': 19.47, 'los_smooth_amp': 0.4,
             'par_exp_smooth': 0.9, 'per_exp_smooth': 0.7}
GLOBAL = {'par_sigma_smooth': 2.4, 'per_sigma_smooth': 1.9}
TRACERS = {'par_sigma_smooth_LYA': 2.1, 'per_sigma_smooth_LYA': 1.7,
           'par_sigma_smooth_QSO': 3.3, 'per_sigma_smooth_QSO': 2.9}
METALS = {'par_sigma_smooth_metals': 1.3, 'per_sigma_smooth_metals': 2.2}
# (tracer1, tracer2, [model] options, smoothing parameters)
FACTOR_CASES = {
    'gauss_global': (LYA, LYA, {'fullshape smoothing': 'gauss'}, GLOBAL),
    'gauss_par_only': (LYA, LYA, {'fullshape smoothing': 'gauss'},
                       {'par_sigma_smooth': 2.4}),
    'gauss_per_only': (LYA, QSO, {'fullshape smoothing': 'gauss',
                                  'velocity dispersion': 'lorentz'},
                       {'per_sigma_smooth': 1.9}),
    'gauss_iso': (LYA, LYA, {'fullshape smoothing': 'gauss_iso'},
                  {'par_sigma_smooth': 2.4}),
    'gauss_metals': (LYA, SI2, {'fullshape smoothing': 'gauss'},
                     dict(TRACERS, **METALS)),
    'gauss_tracers': (LYA, QSO, {'fullshape smoothing': 'gauss',
                                 'velocity dispersion': 'lorentz'},
                      dict(TRACERS, **METALS)),
    'exp': (LYA, LYA, {'fullshape smoothing': 'exp'}, GLOBAL),
    'mock_bin': (LYA, LYA, {'mock-bin-size': '3.2'}, {}),
    'mock_bin_growth': (LYA, QSO, {'mock-bin-size': '3.2',
                                   'mock-los-smoothing': 'growth',
                                   'velocity dispersion': 'lorentz'}, {}),
    'mock_bin_amplitude': (LYA, LYA, {'mock-bin-size': '3.2',
                                      'mock-los-smoothing': 'amplitude'},
                           {}),
    'mock_bin_only_los': (LYA, LYA, {'mock-bin-size': '3.2',
                                     'mock-los-smoothing': 'only-los'},
                          {}),
    'velocity_gauss': (LYA, QSO, {'velocity dispersion': 'gauss'}, {}),
    'velocity_lorentz_gauss': (QSO, LYA, {
        'velocity dispersion': 'lorentz_gauss'}, {}),
    'pk_damping': (LYA, LYA, {'pk-damping-scale': '2.5'}, {}),
    'pk_damping_power': (LYA, QSO, {'pk-damping-scale': '1.5',
                                    'pk-damping-power': '4',
                                    'velocity dispersion': 'lorentz'}, {}),
    'skip_nl_in_peak': (LYA, LYA, {'small scale nl': 'dnl_arinyo',
                                   'fullshape smoothing': 'gauss',
                                   'skip-nl-model-in-peak': 'True'},
                        GLOBAL),
    'everything': (QSO, LYA, {'small scale nl': 'dnl_arinyo',
                              'fullshape smoothing': 'gauss',
                              'mock-bin-size': '2.0',
                              'mock-los-smoothing': 'growth',
                              'velocity dispersion': 'lorentz_gauss',
                              'pk-damping-scale': '1.0',
                              'skip-nl-model-in-peak': 'True'},
                   dict(TRACERS, **METALS)),
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


def both_pk(fiducial, tracer1, tracer2, **options):
    return (PowerSpectrum(model_config(**options), fiducial, tracer1,
                          tracer2, 'lyaxlya', device='cpu'),
            JaxPowerSpectrum(model_config(**options), fiducial, tracer1,
                             tracer2, 'lyaxlya'))


@pytest.mark.parametrize('case', list(FACTOR_CASES))
def test_mock_factors_match_jax(fiducial, case):
    """Both components of compute_peak_smooth and the single-component
    compute of each peak flag (the unrolled metal path's) against
    vega_tpu's (FACTOR_RTOL of the largest entry), and a batch of two
    rows of the widths and sigmas against each row alone."""
    tracer1, tracer2, options, widths = FACTOR_CASES[case]
    pk, jax_pk = both_pk(fiducial, tracer1, tracer2, **options)
    pk_full = np.asarray(fiducial['pk_full'], float)
    pk_smooth = np.asarray(fiducial['pk_smooth'], float)
    t_full, t_smooth = torch.as_tensor(pk_full), torch.as_tensor(pk_smooth)
    params = dict(PK_PARAMS, peak=True, **widths)
    got = pk.compute_peak_smooth(params, t_full - t_smooth, t_smooth)
    want = jax_pk.compute_peak_smooth(params, pk_full - pk_smooth, pk_smooth)
    assert max_rel(got[0], want[0]) <= FACTOR_RTOL
    assert max_rel(got[1], want[1]) <= FACTOR_RTOL
    for peak in (True, False):
        one, _ = pk.compute(t_full, dict(params, peak=peak))
        ref, _ = jax_pk.compute(pk_full, dict(params, peak=peak))
        assert max_rel(one, ref) <= FACTOR_RTOL
    varied = [k for k in params if 'sigma' in k or k in (
        'growth_rate', 'los_smooth_amp', 'par_exp_smooth')]
    rows = [params, {k: params[k] * (1.2 if k in varied else 1)
                     for k in params}]
    batch = dict(params, **{k: torch.tensor([r[k] for r in rows],
                                            dtype=torch.float64)
                            for k in varied})
    batched = pk.compute_peak_smooth(batch, t_full - t_smooth, t_smooth)
    for b, row in enumerate(rows):
        alone = pk.compute_peak_smooth(row, t_full - t_smooth, t_smooth)
        for part in (0, 1):
            rows_of = batched[part].expand((len(rows),)
                                           + alone[part].shape[-2:])
            assert max_rel(rows_of[b], alone[part]) <= 1e-15


def test_skip_nl_leaves_the_smooth_component_its_nl(fiducial):
    """skip-nl-model-in-peak drops the NL term and the smoothing from the
    peak alone: the smooth component equals the one without the option,
    the peak differs (vega_tpu/power_spectrum.py:291-295)."""
    options = {'small scale nl': 'dnl_arinyo',
               'fullshape smoothing': 'gauss'}
    skip, _ = both_pk(fiducial, LYA, LYA, **options,
                      **{'skip-nl-model-in-peak': 'True'})
    keep, _ = both_pk(fiducial, LYA, LYA, **options)
    pk_full = torch.as_tensor(np.asarray(fiducial['pk_full'], float))
    pk_smooth = torch.as_tensor(np.asarray(fiducial['pk_smooth'], float))
    params = dict(PK_PARAMS, peak=True, **GLOBAL)
    a = skip.compute_peak_smooth(params, pk_full - pk_smooth, pk_smooth)
    b = keep.compute_peak_smooth(params, pk_full - pk_smooth, pk_smooth)
    assert torch.equal(a[1], b[1])
    assert max_rel(a[0], b[0]) > 1e-3


@pytest.mark.parametrize('options,params,error', [
    ({'mock-bin-size': '3.2', 'mock-los-smoothing': 'wiggle'}, {},
     'Unknown mock LOS smoothing option wiggle'),
    ({'fullshape smoothing': 'tophat'}, GLOBAL,
     '"fullshape smoothing" must be "gauss" or "exp"'),
    ({'velocity dispersion': 'voigt'}, {},
     '"velocity dispersion" must be "gauss" or "lorentz"'),
    ({'fullshape smoothing': 'gauss'}, {'par_sigma_smooth': None},
     'Fullshape gaussian smoothing requested without'),
])
def test_unknown_factor_options_raise_as_jax(fiducial, options, params,
                                             error):
    """An unknown option value raises ValueError in both packages at the
    first evaluation, with vega_tpu's message."""
    pk, jax_pk = both_pk(fiducial, LYA, QSO, **options)
    pk_full = np.asarray(fiducial['pk_full'], float)
    params = dict(PK_PARAMS, peak=False, **params)
    with pytest.raises(ValueError, match=error):
        jax_pk.compute(pk_full, params)
    with pytest.raises(ValueError, match=error):
        pk.compute(torch.as_tensor(pk_full), params)


def test_missing_width_raises_keyerror_as_jax(fiducial):
    """Gauss smoothing without any width parameter reads the per-tracer
    one and raises KeyError in both packages."""
    pk, jax_pk = both_pk(fiducial, LYA, QSO, **{'fullshape smoothing':
                                                 'gauss'})
    pk_full = np.asarray(fiducial['pk_full'], float)
    params = dict(PK_PARAMS, peak=False)
    with pytest.raises(KeyError, match='par_sigma_smooth_LYA'):
        jax_pk.compute(pk_full, params)
    with pytest.raises(KeyError, match='par_sigma_smooth_LYA'):
        pk.compute(torch.as_tensor(pk_full), params)


# ----------------------------------------------------------------------
# 2. The metal stack with the [metals] section's own options
# ----------------------------------------------------------------------
SMOOTH_METALS = 'fullshape smoothing = gauss\nmock-bin-size = 3.0\n'
# (auto [metals] lines, cross [metals] lines, the cross's velocity
# dispersion, [parameters] lines of both correlations)
METAL_VARIANTS = {
    'gauss_binned': (SMOOTH_METALS + 'mock-los-smoothing = growth\n',
                     SMOOTH_METALS + 'mock-los-smoothing = growth\n',
                     'lorentz_gauss', ''),
    'exp_gauss_velocity': ('fullshape smoothing = exp\n',
                           'fullshape smoothing = exp\n', 'gauss',
                           'par_sigma_smooth = 2.4\nper_sigma_smooth = 1.9\n'),
    'pk_damping': ('pk-damping-scale = 2.0\n' + SMOOTH_METALS,
                   'pk-damping-scale = 2.0\n' + SMOOTH_METALS, 'lorentz',
                   ''),
}
# the `_metals` and per-tracer widths (no global pair: the Si pairs take
# the `_metals` route) and the other factors' parameters
METAL_PARAMS = dict(DR16_PARAMETERS, **METALS, **TRACERS,
                    par_exp_smooth=0.9, per_exp_smooth=0.7,
                    sigma_velo_disp_gauss_QSO=3.1)


@pytest.fixture(scope='module')
def metal_dataset(env, tmp_path_factory):
    """main.ini of the tiny legacy metal dataset (four Si lines, identity
    metal matrices) written by vega_tpu, with METAL_PARAMS."""
    return make_jax_metal_dataset(
        tmp_path_factory.mktemp('mock_metals'), list(DR16_METALS),
        cross=True, size='tiny', extra_model=dr16_extra_model(METAL_PARAMS))


def variant_main(main, work, edit):
    """main.ini in `work` over copies of the correlation inis of `main`,
    each passed through edit(ini name, text)."""
    source = Path(main).parent
    text = Path(main).read_text()
    for ini in ('lyaxlya.ini', 'qsoxlya.ini'):
        (work / ini).write_text(edit(ini, (source / ini).read_text()))
        text = text.replace(str(source / ini), str(work / ini))
    (work / 'main.ini').write_text(text)
    return work / 'main.ini'


@pytest.fixture(scope='module')
def metal_variants(env, metal_dataset, tmp_path_factory):
    """{variant: (vega_tpu interface, port interface)}: the metal dataset
    with each variant's [metals] options and the cross's velocity
    dispersion, built with VEGA_TPU_FACTORED=0."""
    out = {}
    env.setenv('VEGA_TPU_FACTORED', '0')
    for variant, (auto, cross, velocity, pars) in METAL_VARIANTS.items():
        def edit(ini, text):
            extra = auto if ini == 'lyaxlya.ini' else cross
            text = text.replace('velocity dispersion = lorentz',
                                f'velocity dispersion = {velocity}')
            text = text.replace('[parameters]\n', '[parameters]\n' + pars)
            return text.replace('[metals]\n', '[metals]\n' + extra)

        main = variant_main(metal_dataset,
                            tmp_path_factory.mktemp(f'metals_{variant}'),
                            edit)
        out[variant] = (JaxInterface(main), VegaInterface(main,
                                                          device='cpu'))
    env.delenv('VEGA_TPU_FACTORED')
    return out


@pytest.mark.parametrize('variant', list(METAL_VARIANTS))
@pytest.mark.parametrize('corr', ['lyaxlya', 'qsoxlya'])
def test_metal_stack_with_section_options_matches_jax(metal_variants,
                                                      variant, corr):
    """The metal stack, stacked and unrolled, against vega_tpu's stacked
    and unrolled (XI_RTOL of the largest entry): full-shape smoothing
    (the `_metals` widths), the mock binning window and the Gaussian
    velocity dispersion in [metals]. Pk damping in [metals] sends both
    packages' pairs unrolled (vega_tpu/metals.py:155-159)."""
    ref, vega = metal_variants[variant]
    metals, jax_metals = vega.models[corr].metals, ref.models[corr].metals
    damped = variant == 'pk_damping'
    assert (metals._stacked_plans is None) == damped
    assert (jax_metals._stacked_plans is None) == damped
    pars = dict(vega.params, peak=False)
    jax_pars = dict(ref.params, peak=False)
    want, _ = jax_metals.compute(jax_pars, ref.fiducial['pk_full'], 'full')
    got, _ = metals.compute(pars, vega._pk_full)
    assert max_rel(got[0], want) <= XI_RTOL
    if damped:
        return
    plans, jax_metals._stacked_plans = jax_metals._stacked_plans, None
    try:
        want_unrolled, _ = jax_metals.compute(jax_pars,
                                              ref.fiducial['pk_full'],
                                              'full')
    finally:
        jax_metals._stacked_plans = plans
    unrolled, _ = metals.compute_unrolled(pars, vega._pk_full)
    assert max_rel(unrolled[0], want_unrolled) <= XI_RTOL


# ----------------------------------------------------------------------
# 3. The stacking guards: fht_extrap beside old_fftlog, metal-scaling
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def fht_extrap(env, tmp_path_factory):
    """The tiny published configuration written by vega_tpu (BuildConfig)
    with `fht_extrap = True` in every correlation's [model]: (vega_tpu,
    port) interfaces built with VEGA_TPU_FACTORED=0, vega_tpu's for its
    objects, not evaluated."""
    main = make_jax_dr16_published_dataset(
        tmp_path_factory.mktemp('fht_extrap'), size='tiny',
        extra_control=DR16PUB_CONTROL)
    for ini in Path(main).parent.glob('ly*.ini'):
        ini.write_text(ini.read_text().replace(
            '[model]\n', '[model]\nfht_extrap = True\n'))
    env.setenv('VEGA_TPU_FACTORED', '0')
    out = JaxInterface(main), VegaInterface(main, device='cpu')
    env.delenv('VEGA_TPU_FACTORED')
    return out


def test_fht_extrap_beside_old_fftlog_matches_jax(fht_extrap):
    """With fht_extrap beside old_fftlog both packages unroll the metals
    (vega_tpu/metals.py:160-164): every model to XI_RTOL of its largest
    entry and chi^2 to CHI2_RTOL at the defaults (vega_tpu 2,645.59; the
    port stacked them before and read 2.6375), against vega_tpu's models
    and chi^2 on the same files (tests/data/torch_port_tiny_goldens.json,
    'fht_extrap_published', made by
    tests/tools/make_torch_port_tiny_goldens.py with this fixture's
    configuration)."""
    ref, vega = fht_extrap
    golden = json.loads(TINY_GOLDENS.read_text())['fht_extrap_published']
    for name in ref.corr_items:
        assert ref.models[name].metals._stacked_plans is None
        assert vega.models[name].metals._stacked_plans is None
    got = vega.compute_model(run_init=False)
    assert sorted(got) == sorted(golden['models']) == sorted(ref.corr_items)
    for name, want in golden['models'].items():
        assert max_rel(got[name], want) <= XI_RTOL
    chi2, want_chi2 = vega.chi2(), golden['chi2']
    assert want_chi2 == pytest.approx(2645.59, abs=0.01)
    assert abs(chi2 - want_chi2) <= CHI2_RTOL * want_chi2


@pytest.mark.parametrize('metal_scaling', [False, True])
def test_metal_scaling_guard_matches_jax(metal_dataset, tmp_path,
                                         metal_scaling):
    """The port's guard reads the correlation's scale parameters, vega_tpu
    the first metal pair's (`_scale_params_like_metal_scaling`); they are
    one object, so both refuse the stacking plan exactly when
    `metal-scaling` is on."""
    main = variant_main(metal_dataset, tmp_path, lambda ini, text: text)
    main.write_text(main.read_text().replace(
        'cosmo fit func = ap_at',
        f'cosmo fit func = ap_at\nmetal-scaling = {metal_scaling}'))
    ref, vega = JaxInterface(main), VegaInterface(main, device='cpu')
    for name in ref.corr_items:
        jax_metals = ref.models[name].metals
        metals = vega.models[name].metals
        assert jax_metals._scale_params_like_metal_scaling() is metal_scaling
        assert metals._scale_params.metal_scaling is metal_scaling
        assert (metals._stacked_plans is None) == metal_scaling
        assert (jax_metals._stacked_plans is None) == metal_scaling


# ----------------------------------------------------------------------
# 4. The DESI mock: fixed widths keep it factored
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def desi_mock(env, tmp_path_factory):
    """The tiny DESI mock configuration written by vega_tpu and by the
    port: {'jax', 'port' (main.ini paths), 'ref', 'vega' (the interfaces
    on vega_tpu's files)}."""
    jax_main = make_jax_desi_mock_dataset(
        tmp_path_factory.mktemp('desi_mock_jax'), size='tiny',
        extra_control=CONTROL)
    port_main = make_desi_mock_dataset(
        tmp_path_factory.mktemp('desi_mock_port'), size='tiny',
        device='cpu', extra_control=CONTROL)
    return {'jax': jax_main, 'port': port_main,
            'ref': JaxInterface(jax_main),
            'vega': VegaInterface(jax_main, device='cpu')}


def test_desi_mock_files_match_jax(desi_mock):
    """The port's make_desi_mock_dataset writes vega_tpu's files: every
    ini section for section (paths aside), the [metals] sections with
    the smoothing option, the data vectors each package's own model
    (XI_RTOL of their largest entry)."""
    jax_dir, port_dir = desi_mock['jax'].parent, desi_mock['port'].parent
    for ini in ('main.ini', 'lyaxlya.ini', 'qsoxlya.ini'):
        want, got = parse(jax_dir / ini), parse(port_dir / ini)
        assert got.sections() == want.sections()
        for section in want.sections():
            assert ({k: v.replace(str(port_dir), '@')
                     for k, v in got[section].items()}
                    == {k: v.replace(str(jax_dir), '@')
                        for k, v in want[section].items()}), (ini, section)
        if ini != 'main.ini':
            assert got['metals']['fullshape smoothing'] == 'gauss'
            assert got['model']['fullshape smoothing'] == 'gauss'
    for stem in ('cf_synthetic', 'xcf_synthetic'):
        got = jax_read_fits(port_dir / f'{stem}.fits')[1]['DA']
        want = jax_read_fits(jax_dir / f'{stem}.fits')[1]['DA']
        assert max_rel(got, want) <= XI_RTOL


# the [model] and [metals] options that make up the DESI model
MODEL_KEYS = ('small scale nl', 'desi-instrumental-systematics',
              'fullshape smoothing', 'model-hcd', 'radiation effects',
              'velocity dispersion', 'new_metals', 'rp_only_metal_mats',
              'mock-bin-size', 'mock-los-smoothing', 'pk-damping-scale',
              'skip-nl-model-in-peak')


def test_desi_mock_sections_follow_the_example(tmp_path):
    """BuildConfig's inis of examples/DESI_mock_setup (MOCK_OPTIONS over
    DESI_data_setup's) against make_desi_mock_dataset's, option for option
    over the model's options (MODEL_KEYS) in each correlation's [model]
    and [metals], the metal lines and the [sample] names (DESI's without
    bias_CIV(eff) and desi_inst_sys_amp)."""
    data = example_module('DESI_data_setup')
    mock = example_module('DESI_mock_setup')
    args = ['--correlations-dir', str(tmp_path / 'c'), '--weights-lya',
            'lya.fits', '--weights-lyb', 'lyb.fits', '--qso-cat', 'qso.fits',
            '--out-dir', str(tmp_path / 'built')]
    sampled = data.SAMPLED
    data.SAMPLED = [p for p in sampled
                    if p not in ('bias_CIV(eff)', 'desi_inst_sys_amp')]
    try:
        built_main = data.main(extra_options=mock.MOCK_OPTIONS, argv=args)
    finally:
        data.SAMPLED = sampled
    assert list(parse(built_main)['sample']) == list(DESI_MOCK_SAMPLED)
    port_main = make_desi_mock_dataset(tmp_path / 'port', size='tiny',
                                       device='cpu')
    assert list(parse(port_main)['sample']) == list(DESI_MOCK_SAMPLED)
    for corr, ini in (('lyaxlya', 'lyaxlya.ini'), ('lyaxqso', 'qsoxlya.ini')):
        built = parse(Path(built_main).parent
                      / f'{corr}-baseline_combined.ini')
        port = parse(Path(port_main).parent / ini)
        for section in ('model', 'metals'):
            assert ({k: built[section].get(k) for k in MODEL_KEYS}
                    == {k: port[section].get(k) for k in MODEL_KEYS}), \
                (corr, section)
        assert (built['metals']['in tracer1'].split()
                == port['metals']['in tracer2'].split())


def test_desi_mock_example_without_widths_raises_as_jax(desi_mock,
                                                        tmp_path):
    """As the example writes it, the DESI mock has no smoothing width
    (BuildConfig writes none unless given): both packages construct and
    then raise KeyError at the first evaluation, on the per-tracer width
    of LYA (ROADMAP.md §3: make_desi_mock_dataset passes the widths a user
    of the example must)."""
    source = desi_mock['jax'].parent
    for ini in ('lyaxlya.ini', 'qsoxlya.ini'):
        text = (source / ini).read_text()
        for name in DESI_MOCK_SMOOTHING:
            text = text.replace(f'{name} = 2.0\n', '')
        (tmp_path / ini).write_text(text)
    main = (source / 'main.ini').read_text()
    for ini in ('lyaxlya.ini', 'qsoxlya.ini'):
        main = main.replace(str(source / ini), str(tmp_path / ini))
    (tmp_path / 'main.ini').write_text(main)
    with pytest.raises(KeyError, match='par_sigma_smooth_LYA'):
        JaxInterface(tmp_path / 'main.ini').compute_model(run_init=False)
    with pytest.raises(KeyError, match='par_sigma_smooth_LYA'):
        VegaInterface(tmp_path / 'main.ini',
                      device='cpu').compute_model(run_init=False)


def test_fixed_widths_stay_factored(desi_mock):
    """The DESI mock's widths are fixed: with its grid names sampled every
    correlation stays factored (a FactoredXi at the reference), as in
    vega_tpu, whose payload holds both correlations; the payload's c0 and
    chi2_batch agree with vega_tpu's."""
    import jax.numpy as jnp
    ref, vega = desi_mock['ref'], desi_mock['vega']
    names = frozenset(DESI_MOCK_GRID_NAMES)
    for name, model in vega.models.items():
        cf, _ = model.compute(vega.params, vega._pk_full, vega._pk_smooth,
                              sampling=Sampling(names,
                                                frozenset({'ap', 'at'})))
        assert isinstance(cf, FactoredXi), name
    payload = vega.get_collapsed(names)
    want = ref.get_collapsed(tuple(sorted(names)))
    assert set(payload) == set(want) == {'__grid__', 'lyaxlya', 'qsoxlya'}
    for name in ('lyaxlya', 'qsoxlya'):
        assert max_rel(payload[name]['cref'], want[name]['cref']) <= \
            COEFF_RTOL
    rng = np.random.default_rng(3)
    batch = {n: vega.params[n] + 0.01 * abs(vega.params[n])
             * rng.normal(size=4) for n in names}
    got = vega.chi2_batch(batch).numpy()
    ref_chi2 = np.asarray(ref.chi2_batch({k: jnp.asarray(v)
                                          for k, v in batch.items()}))
    assert np.all(np.abs(got - ref_chi2) <= GRID_ABS + GRID_REL * ref_chi2)


def test_coefficient_program_with_smoothing(desi_mock):
    """The nuisance collapse of the DESI mock's linear names builds (its
    `_check_coefficient_program` holds Model.coefficients to the factored
    c0 within COEFF_RTOL), its c0 equals vega_tpu's (COEFF_RTOL) and so
    does its chi^2 (CHI2_RTOL)."""
    import jax.numpy as jnp
    ref, vega = desi_mock['ref'], desi_mock['vega']
    names = DESI_MOCK_GRID_NAMES[2:]
    got, want = vega.get_collapsed(names), ref.get_collapsed(names)
    assert set(got) == set(want) == {'lyaxlya', 'qsoxlya'}
    for name in got:
        assert max_rel(got[name]['c0'], want[name]['c0']) <= COEFF_RTOL
        coeffs = vega.models[name].coefficients(vega.params, 1)[0].numpy()
        assert max_rel(coeffs, got[name]['c0']) <= COEFF_RTOL
    rng = np.random.default_rng(5)
    batch = {n: vega.params[n] + 0.01 * abs(vega.params[n])
             * rng.normal(size=4) for n in names}
    chi2 = vega.chi2_batch(batch).numpy()
    ref_chi2 = np.asarray(ref.chi2_batch({k: jnp.asarray(v)
                                          for k, v in batch.items()}))
    assert np.max(np.abs(chi2 - ref_chi2) / ref_chi2) <= CHI2_RTOL


# ----------------------------------------------------------------------
# 5. LyaCoLoRe: sampled widths go dense
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def lyacolore(env, tmp_path_factory):
    """The tiny LyaCoLoRe configuration written by vega_tpu (BuildConfig)
    and by the port: {'jax', 'port', 'ref', 'vega'}."""
    control = {'grid-nodes-ap': '6', 'grid-nodes-at': '6',
               'ds-matmul': 'False'}
    jax_main = make_jax_lyacolore_dataset(
        tmp_path_factory.mktemp('lyacolore_jax'), size='tiny',
        extra_control=control)
    port_main = make_lyacolore_dataset(
        tmp_path_factory.mktemp('lyacolore_port'), size='tiny',
        device='cpu', extra_control=control)
    return {'jax': jax_main, 'port': port_main,
            'ref': JaxInterface(jax_main),
            'vega': VegaInterface(jax_main, device='cpu')}


def test_lyacolore_files_match_jax(lyacolore):
    """make_lyacolore_dataset writes vega_tpu's files: the inis section
    for section (paths aside), the DR9LyaMocks template by name, the data
    vector each package's own model (XI_RTOL)."""
    jax_dir, port_dir = lyacolore['jax'].parent, lyacolore['port'].parent
    for ini in ('main.ini', 'lyaxlya.ini'):
        want, got = parse(jax_dir / ini), parse(port_dir / ini)
        assert got.sections() == want.sections()
        for section in want.sections():
            assert ({k: v.replace(str(port_dir), '@')
                     for k, v in got[section].items()}
                    == {k: v.replace(str(jax_dir), '@')
                        for k, v in want[section].items()}), (ini, section)
    assert parse(port_dir / 'main.ini')['fiducial']['filename'] == \
        'DR9LyaMocks/DR9LyaMocks.fits'
    got = jax_read_fits(port_dir / 'cf_lyaxlya.fits')[1]['DA']
    want = jax_read_fits(jax_dir / 'cf_lyaxlya.fits')[1]['DA']
    assert max_rel(got, want) <= XI_RTOL


def test_lyacolore_full_size_sections_equal_build_config(tmp_path):
    """At size='full' the port's inis equal BuildConfig's output for the
    example's OPTIONS, cuts, sampled names and widths, section for
    section, with LYACOLORE_EXTRA_MODEL in [model]."""
    data_file = tmp_path / 'cf_lyaxlya.fits'
    main = build_lyacolore_inis(tmp_path, data_file, size='full')
    got = {'main.ini': lyacolore_main(
        tmp_path / 'lyaxlya.ini', tmp_path / 'output_fitter' / 'lyaxlya'),
        'lyaxlya.ini': lyacolore_correlation(data_file)}
    for ini, config in got.items():
        want = parse(Path(main).parent / ini)
        assert config.sections() == want.sections()
        for section in want.sections():
            assert dict(config[section]) == dict(want[section]), \
                (ini, section)
    assert list(got['main.ini']['sample']) == list(LYACOLORE_SAMPLED)


def test_lyacolore_example_template_refused_as_jax(tmp_path):
    """As the example writes it (no old_fftlog), the DR9LyaMocks
    template's k grid is log-spaced to 0.8% only: both packages refuse it
    at construction with the FFTLog operator's ValueError."""
    data_file = tmp_path / 'cf_lyaxlya.fits'
    make_lyacolore_dataset(tmp_path / 'files', size='tiny', device='cpu')
    data_file.write_bytes((tmp_path / 'files' / 'cf_lyaxlya.fits')
                          .read_bytes())
    main = build_lyacolore_inis(tmp_path, data_file, size='tiny',
                                extra_model=False)
    assert 'old_fftlog' not in parse(tmp_path / 'lyaxlya.ini')['model']
    with pytest.raises(ValueError, match='log-spaced k grid'):
        JaxInterface(main)
    with pytest.raises(ValueError, match='log-spaced k grid'):
        VegaInterface(main, device='cpu')


def test_sampled_widths_go_dense_as_jax(lyacolore):
    """LyaCoLoRe samples the smoothing widths beside (ap, at): the
    Gaussian smoothing reads a sampled name, so the model is not factored
    (a dense tensor under the Sampling), vega_tpu's sweep finds nothing
    factored and both packages serve every call densely ({} payload);
    chi2_batch equals vega_tpu's (CHI2_RTOL)."""
    import jax.numpy as jnp
    ref, vega = lyacolore['ref'], lyacolore['vega']
    names = frozenset(LYACOLORE_SAMPLED)
    model = vega.models['lyaxlya']
    cf, _ = model.compute(vega.params, vega._pk_full, vega._pk_smooth,
                          sampling=Sampling(names, frozenset({'ap', 'at'})))
    assert not isinstance(cf, FactoredXi)
    fixed = frozenset({'ap', 'at', 'bias_LYA', 'beta_LYA'})
    cf, _ = model.compute(vega.params, vega._pk_full, vega._pk_smooth,
                          sampling=Sampling(fixed, frozenset({'ap', 'at'})))
    assert isinstance(cf, FactoredXi)
    assert vega.get_collapsed(names) == {}
    assert ref.get_collapsed(tuple(sorted(names))) == {}
    rng = np.random.default_rng(4)
    batch = {n: vega.params[n] + 0.02 * abs(vega.params[n])
             * rng.normal(size=4) for n in names}
    got = vega.chi2_batch(batch).numpy()
    want = np.asarray(ref.chi2_batch({k: jnp.asarray(v)
                                      for k, v in batch.items()}))
    assert np.max(np.abs(got - want) / want) <= CHI2_RTOL

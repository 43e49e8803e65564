"""The f32 throughput mode of the PyTorch port (VegaInterface(..., dtype=
torch.float32) or VEGA_TPU_X64=0) on every model term, on the CPU at
size='tiny': synthetic-desi-mock (full-shape smoothing beside the
new-metals stacks), synthetic-lyacolore (per-row smoothing with sampled
widths on old_fftlog's legacy grid), synthetic-dr16-uv (UV fluctuations
and shotnoise, the relativistic and asymmetry pair, Croom) and a
4-dimension table6 payload; the variants uv's HeII, split evolution,
single_multipole and fht_extrap, desi's rescale-coords-systematics and
the mock options (the Gaussian and lorentz_gauss velocity dispersions,
Pk damping, mock binning, mock-los-smoothing), each written by the
port's own dataset functions (tests/tools/make_torch_port_f32_terms_
goldens.py's `make_tiny`).

vega_tpu's numbers on the same files, in f32 (VEGA_TPU_X64=0, in a
process of their own) and in f64, are committed in
tests/data/torch_port_f32_terms_goldens.json ('tiny', made by that
tool). The ladder is vega_tpu's f32 one (tests/test_f32_mode.py:106-109):
|d chi2| <= max(0.3, 3e-4 |chi2|). Held:

- the dense chi^2 against vega_tpu's f64, and against vega_tpu's f32
  where vega_tpu's own f32 is within the ladder of its f64; the value and
  gradient at a point likewise;
- the grid or route chi^2 at the same points (table6: the 4-dimension
  payload) against vega_tpu's f32 and f64 grid or route;
- each new term in f32 against the port's f64 on the same inputs,
  within TERM_RTOL of max|f64|;
- no float64 tensor on the path (`F64Ops`);
- the likelihood options the f32 mode refused until it carried them
  build in f32, each within the ladder (or TERM_RTOL) of the f64
  interface on the same files.

The configurations at full size run on the card (chip_smoke.py's
f32_terms phase).
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from make_torch_port_f32_options_goldens import with_rmin_cut  # noqa: E402
from make_torch_port_f32_terms_goldens import (CONFIGS,  # noqa: E402
                                               VARIANTS, make_tiny)
from test_torch_f32_models import (gradient_within,  # noqa: E402
                                   local_params, max_rel, within_ladder)
from test_torch_f32_path import F64Ops  # noqa: E402
from vega_tpu_torch import utils  # noqa: E402
from vega_tpu_torch.io.fits import read_fits  # noqa: E402
from vega_tpu_torch.power_spectrum import PowerSpectrum  # noqa: E402
from vega_tpu_torch.testing import dataset_variant, with_control  # noqa: E402
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

GOLDENS = Path(__file__).parent / 'data' / 'torch_port_f32_terms_goldens.json'
NAMES = (*CONFIGS, *VARIANTS)
# an f32 term against the f64 one on the same inputs, of max|f64| (the
# f32 kernels' gate against their f32 plain versions, chip_smoke.py)
TERM_RTOL = 1e-5


@pytest.fixture(scope='module', autouse=True)
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.delenv('VEGA_TPU_X64', raising=False)
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        yield mp


@pytest.fixture(scope='module')
def goldens():
    return json.loads(GOLDENS.read_text())['tiny']


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """files(name): (main ini, grid ini or None) of a tiny configuration
    or variant, written once."""
    work = tmp_path_factory.mktemp('f32_terms')
    made, bases = {}, {}

    def get(name):
        if name not in made:
            made[name] = make_tiny(name, work / name, bases=bases)
            if name in CONFIGS:
                bases[name] = made[name][0]
        return made[name]
    return get


@pytest.fixture(scope='module')
def port(env, files):
    """port(name, regime, dtype): the port's interface, built once
    (dense: VEGA_TPU_FACTORED=0; grid: the defaults on the grid ini)."""
    built = {}

    def get(name, regime, dtype):
        key = (name, regime, dtype)
        if key not in built:
            main, grid_main = files(name)
            if regime == 'dense':
                env.setenv('VEGA_TPU_FACTORED', '0')
            built[key] = VegaInterface(
                main if regime == 'dense' else grid_main, device='cpu',
                dtype=dtype)
            env.delenv('VEGA_TPU_FACTORED', raising=False)
        return built[key]
    return get


def jax_within(record):
    """Whether vega_tpu's own f32 chi^2 is within the ladder of its f64."""
    return within_ladder(record['f32']['chi2'], record['f64']['chi2'])


@pytest.mark.parametrize('name', NAMES)
def test_dense_chi2_matches_jax(port, goldens, name):
    """Dense chi^2 at 4 points within the ladder of vega_tpu's f64, and
    of its f32 wherever vega_tpu's own f32 is within the ladder of its
    f64, which it is for every configuration and variant here (measured:
    at most 0.0117 from vega_tpu's f32 and 0.0209 from its f64, on
    uv_single_multipole's chi^2 of 2.2e4-6.2e4; at most 0.0070 on the
    mocks')."""
    want = goldens[f'{name}/dense']
    got = port(name, 'dense', torch.float32).chi2_batch(want['points'])
    assert got.dtype == torch.float32
    assert np.all(np.isfinite(got.numpy()))
    assert within_ladder(got.numpy(), want['f64']['chi2'])
    if jax_within(want):
        assert within_ladder(got.numpy(), want['f32']['chi2'])


@pytest.mark.parametrize('name', NAMES)
def test_value_and_gradient_match(port, goldens, name):
    """chi2_value_and_gradient at one point: the value within the ladder
    and each gradient entry within max(0.3, 3e-4 max|gradient|) of
    vega_tpu's f64, and of its f32 where that is within the ladder
    (measured against the f64: values within 0.0111, gradients within
    3.5e-8-1.2e-4 of max|gradient|)."""
    want = goldens[f'{name}/dense']
    value, grad = port(name, 'dense', torch.float32).chi2_value_and_gradient(
        want['point'])
    names = list(want['point'])
    grad = [grad[n] for n in names]
    records = [want['f64']] + ([want['f32']] if jax_within(want) else [])
    for record in records:
        assert within_ladder([value], [record['value']])
        assert gradient_within(grad, [record['gradient'][n] for n in names])


@pytest.mark.parametrize('name', CONFIGS)
def test_grid_chi2_matches(port, goldens, name):
    """The grid chi^2 (desi_mock: 8 x 8 nodes, its 12 grid names; uv and
    lyacolore: vega_tpu's route; table6: the 4-dimension payload of 6 x
    6 x 4 x 4 nodes through the combination schedule) within the ladder
    of vega_tpu's f32 and f64 grid or route (measured: at most 0.0688
    from the f32 and 0.0155 from the f64, table6's on chi^2 of -180 to
    246: its coarse payload misses the dense chi^2, both packages
    alike)."""
    want = goldens[f'{name}/grid']
    got = port(name, 'grid', torch.float32).chi2_batch(want['points'])
    assert got.dtype == torch.float32
    assert np.all(np.isfinite(got.numpy()))
    assert within_ladder(got.numpy(), want['f64']['chi2'])
    assert within_ladder(got.numpy(), want['f32']['chi2'])


# ----------------------------------------------------------------------
# Each new term in f32 against the port's f64
# ----------------------------------------------------------------------
def pk_parts(vega, corr):
    model = vega.models[corr]
    pars = local_params(vega)
    return model, pars, model.Pk_core.compute(vega._pk_full, pars)[0]


def term_desi_mock_pk(vega):
    """Both components of the auto's P(k, mu_k): the full-shape smoothing
    beside Rogers HCD."""
    model = vega.models['lyaxlya']
    peak, smooth, _ = model.Pk_core.compute_peak_smooth(
        local_params(vega), vega._pk_full - vega._pk_smooth,
        vega._pk_smooth)
    return torch.stack([peak, smooth])


def term_desi_mock_metals(vega):
    """The cross's new-metals stack under the full-shape smoothing."""
    model = vega.models['qsoxlya']
    assert model.metals.new_metals
    assert model.Pk_core.fullshape_smoothing is not None
    return model.metals.compute(local_params(vega), vega._pk_full)[0]


def term_lyacolore_smoothing(vega):
    """The per-row Gaussian smoothing of three rows of widths."""
    pars = local_params(vega)
    for name in ('par_sigma_smooth', 'per_sigma_smooth'):
        pars[name] = torch.tensor([2.2, 2.4, 3.1], dtype=vega.dtype)
    return vega.models['lyaxlya'].Pk_core.compute_fullshape_gauss_smoothing(
        pars)


def term_lyacolore_xi(vega):
    """The smoothed auto through old_fftlog's legacy transform."""
    model, pars, pk = pk_parts(vega, 'lyaxlya')
    assert model.PktoXi.old_fftlog
    return model.Xi_core.compute_core(pk, model.PktoXi, pars)[0]


def term_uv_bias(vega):
    """The UV (and HeII) effective bias and beta of the forest, (1, k)."""
    pk = vega.models['lyaxlya'].Pk_core
    pars = local_params(vega)
    bias, beta = pk.compute_bias_beta_uv_heii(pars['bias_LYA'],
                                              pars['beta_LYA'], pars)
    return torch.stack([bias, beta])


def term_uv_basis(vega):
    """The factored route's UV basis grid w / (1 + b_prim w)."""
    pars = local_params(vega)
    return vega.models['lyaxlya'].Pk_core._uv_basis_grid(pars['lambda_uv'],
                                                         pars['bias_prim'])


def term_uv_shotnoise(vega):
    """The UV shotnoise at an amplitude of 1e-3 (the configuration's is
    0)."""
    xi = vega.models['lyaxlya'].Xi_core
    pars = dict(local_params(vega), uv_shotnoise_amp=1e-3)
    return xi.compute_uv_shotnoise(pars, xi._r, xi._mu)


def legacy_term(vega, kind):
    """The cross's relativistic or asymmetry term: two tables through the
    combine on the legacy knot grid."""
    model = vega.models['qsoxlya']
    xi = model.Xi_core
    term = getattr(model.PktoXi, f'pk_to_xi_{kind}')
    return term(xi._r, xi._mu, vega._pk_full, local_params(vega))


def term_croom(vega):
    xi = vega.models['qsoxlya'].Xi_core
    assert xi._croom['QSO']
    return xi.compute_bias_evol(local_params(vega))


def term_split_evolution(vega):
    xi = vega.models['qsoxlya'].Xi_core
    assert xi._split_evol is not None
    return xi.compute_bias_evol(local_params(vega))


def term_transform(vega):
    """The auto's transform (single_multipole or fht_extrap)."""
    model, pars, pk = pk_parts(vega, 'lyaxlya')
    return model.Xi_core.compute_core(pk, model.PktoXi, pars)[0]


def term_fht_extrap(vega):
    assert vega.models['lyaxlya'].PktoXi._extrap_geom is not None
    return term_transform(vega)


def term_rescaled_radiation(vega):
    """The QSO radiation at the AP-rescaled coordinates."""
    model, pars, pk = pk_parts(vega, 'qsoxlya')
    pars.update(ap=1.04, at=0.97)
    xi = model.Xi_core
    assert xi._rescale_coords_systematics
    _, r, mu, _ = xi.compute_core(pk, model.PktoXi, pars)
    return xi.compute_qso_radiation(pars, r, mu)


TERMS = {
    'desi_mock_pk': ('desi_mock', term_desi_mock_pk),
    'desi_mock_metals': ('desi_mock', term_desi_mock_metals),
    'lyacolore_smoothing': ('lyacolore', term_lyacolore_smoothing),
    'lyacolore_xi': ('lyacolore', term_lyacolore_xi),
    'uv_bias': ('uv', term_uv_bias),
    'uv_basis': ('uv', term_uv_basis),
    'heii_bias': ('uv_heii', term_uv_bias),
    'uv_shotnoise': ('uv', term_uv_shotnoise),
    'relativistic': ('uv', lambda v: legacy_term(v, 'relativistic')),
    'asymmetry': ('uv', lambda v: legacy_term(v, 'asymmetry')),
    'croom': ('uv', term_croom),
    'split_evolution': ('uv_new_bias_evolution', term_split_evolution),
    'single_multipole': ('uv_single_multipole', term_transform),
    'fht_extrap': ('uv_fht_extrap', term_fht_extrap),
    'rescaled_radiation': ('desi_rescale', term_rescaled_radiation),
}


@pytest.mark.parametrize('term', TERMS)
def test_term_matches_f64(port, term):
    """Each term in f32 against the port's f64 on the same inputs, within
    TERM_RTOL of max|f64|, and f32 itself."""
    name, fn = TERMS[term]
    with torch.no_grad():
        got = fn(port(name, 'dense', torch.float32))
        want = fn(port(name, 'dense', torch.float64))
    assert got.dtype == torch.float32 and want.dtype == torch.float64
    assert got.shape == want.shape
    assert max_rel(got, want) <= TERM_RTOL


LYA = {'name': 'LYA', 'type': 'continuous'}
QSO = {'name': 'QSO', 'type': 'discrete'}
PK_PARAMS = {'bias_LYA': -0.12, 'beta_LYA': 1.6, 'bias_QSO': 3.7,
             'beta_QSO': 0.26, 'sigmaNL_par': 6.37, 'sigmaNL_per': 3.24,
             'growth_rate': 0.97, 'sigma_velo_disp_lorentz_QSO': 6.86,
             'sigma_velo_disp_gauss_QSO': 3.1, 'los_smooth_amp': 0.4}
# (tracer1, tracer2, [model] options): the mock options of
# tests/test_torch_mocks.py's FACTOR_CASES
FACTOR_CASES = {
    'velocity_gauss': (LYA, QSO, {'velocity dispersion': 'gauss'}),
    'velocity_lorentz_gauss': (QSO, LYA,
                               {'velocity dispersion': 'lorentz_gauss'}),
    'pk_damping': (LYA, LYA, {'pk-damping-scale': '10.0',
                              'pk-damping-power': '4',
                              'model binning': 'False'}),
    'mock_binning': (LYA, QSO, {'mock-bin-size': '3.2',
                                'mock-los-smoothing': 'growth',
                                'velocity dispersion': 'lorentz'}),
    'mock_los_amplitude': (LYA, LYA, {'mock-bin-size': '3.2',
                                      'mock-los-smoothing': 'amplitude'}),
    'mock_los_only_los': (LYA, LYA, {'mock-bin-size': '3.2',
                                     'mock-los-smoothing': 'only-los'}),
}


@pytest.fixture(scope='module')
def fiducial():
    hdul = read_fits(utils.find_file('PlanckDR16/PlanckDR16.fits'))
    return {'z_eff': 2.25, 'k': hdul[1]['K'], 'pk_full': hdul[1]['PK'],
            'pk_smooth': hdul[1]['PKSB'],
            'z_fiducial': hdul[1].header['ZREF']}


def model_config(**options):
    import configparser
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config['model'] = {'bin_size_rp': '4', 'bin_size_rt': '4',
                       'num_bins_muk': '96', **options}
    return config['model']


@pytest.mark.parametrize('case', FACTOR_CASES)
def test_mock_factor_matches_f64(fiducial, case):
    """Both components of compute_peak_smooth of a PowerSpectrum with a
    mock option, built in f32 against the same in f64 (TERM_RTOL of
    max|f64|): the factors carry the interface's dtype."""
    tracer1, tracer2, options = FACTOR_CASES[case]
    out = {}
    for dtype in (torch.float32, torch.float64):
        pk = PowerSpectrum(model_config(**options), fiducial, tracer1,
                           tracer2, 'lyaxlya', device='cpu', dtype=dtype)
        full = utils.to_tensor(fiducial['pk_full'], 'cpu', dtype)
        smooth = utils.to_tensor(fiducial['pk_smooth'], 'cpu', dtype)
        out[dtype] = torch.stack(pk.compute_peak_smooth(
            dict(PK_PARAMS, peak=True), full - smooth, smooth)[:2])
    assert out[torch.float32].dtype == torch.float32
    assert max_rel(out[torch.float32], out[torch.float64]) <= TERM_RTOL


# ----------------------------------------------------------------------
# No f64 on the path; the refusals that remain
# ----------------------------------------------------------------------
@pytest.mark.parametrize('name', NAMES)
def test_no_f64_tensor_on_the_path(port, goldens, name):
    """chi2_batch on the dense path (and the grid or route path of the
    four configurations) and the dense value and gradient of an f32
    interface make no float64 tensor (each called once before)."""
    dense = port(name, 'dense', torch.float32)
    want = goldens[f'{name}/dense']
    calls = [lambda: dense.chi2_batch(want['points']),
             lambda: dense.chi2_value_and_gradient(want['point'])]
    if name in CONFIGS:
        grid = port(name, 'grid', torch.float32)
        calls.append(lambda: grid.chi2_batch(
            goldens[f'{name}/grid']['points']))
    for call in calls:
        call()
    with F64Ops() as ops:
        for call in calls:
            call()
    assert ops.seen == {}


def edited(main, workdir, edits):
    """A copy of a tiny dataset with each ini's text edited: edits maps
    an ini's stem to (old, new), replaced once."""
    out = dataset_variant(main, workdir)
    for stem, (old, new) in edits.items():
        path = Path(out).parent / f'{stem}.ini'
        text = path.read_text()
        assert old in text
        path.write_text(text.replace(old, new, 1))
    return out


REFUSED = {
    'save_components': {'main': ('[output]\n', '[output]\nwrite_cf = True\n')},
    'marginalization': {'lyaxlya': ('[model]\n', '[model]\n'
                                    'marginalize-all-rmin-cuts = True\n')},
    'marginalize_in_fit': 'marginalize-in-fit = True',
    'model_pk': 'model_pk = True',
    'use_full_pk_for_mc': 'use_full_pk_for_mc = True',
    'data_free': {corr: ('[data]\n', '[data]\nhas_datafile = False\n')
                  for corr in ('lyaxlya', 'qsoxlya')},
}


@pytest.mark.parametrize('case', REFUSED)
def test_remaining_refusals_name_item_10(files, tmp_path, case):
    """What the f32 mode refused until the likelihood options joined it
    (save-components, small-scale marginalization with or without
    marginalize-in-fit, model_pk, use_full_pk_for_mc, correlations
    without a data file) builds in f32 on the DESI mock's files, never
    an f64 run: the chi^2 is a finite float32 batch within the ladder of
    the f64 interface's on the same files; model_pk's multipoles and
    use_full_pk_for_mc's compute_direct model within TERM_RTOL of
    max|f64|; without data files both dtypes raise the same exception at
    the chi^2 (tests/test_torch_f32_options.py holds each option against
    vega_tpu)."""
    main = files('desi_mock')[0]
    change = REFUSED[case]
    if isinstance(change, str):
        main = with_control(main, change, tmp_path / 'main.ini')
    else:
        main = edited(main, tmp_path / 'w', change)
    if case == 'marginalization':
        # all-rmin marginalizes the bins the r-min cut leaves out: at
        # size='tiny' none lies below the default cut of 10
        with_rmin_cut(Path(main).parent / 'lyaxlya.ini')
    vegas = {dtype: VegaInterface(main, device='cpu', dtype=dtype)
             for dtype in (torch.float32, torch.float64)}
    points = {n: [-0.11, -0.12] if n.startswith('bias') else [1.6, 1.7]
              for n in ('bias_LYA', 'beta_LYA')}
    if case == 'data_free':
        raised = []
        for vega in vegas.values():
            with pytest.raises(Exception) as error:
                vega.chi2_batch(points)
            raised.append(type(error.value))
        assert raised[0] is raised[1]
        return
    if case == 'model_pk':
        models = {dtype: vega.compute_model(run_init=False)
                  for dtype, vega in vegas.items()}
    else:
        chi2 = {dtype: vega.chi2_batch(points)
                for dtype, vega in vegas.items()}
        assert chi2[torch.float32].dtype == torch.float32
        assert np.all(np.isfinite(chi2[torch.float32].numpy()))
        assert within_ladder(chi2[torch.float32].numpy(),
                             chi2[torch.float64].numpy())
        models = ({dtype: vega.compute_model(
            run_init=False, direct_pk=vega.fiducial['pk_full'])
            for dtype, vega in vegas.items()}
            if case == 'use_full_pk_for_mc' else {})
    for name, got in models.get(torch.float32, {}).items():
        assert got.dtype == np.float32 and np.all(np.isfinite(got))
        assert max_rel(got, models[torch.float64][name]) <= TERM_RTOL

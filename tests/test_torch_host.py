"""The PyTorch port's host layer against the JAX package (vega_tpu): the
init-time constants, the synthetic dataset files, the data-file lookup
and the rule that the port never imports JAX."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from jax_metal_dataset import make_jax_metal_dataset  # noqa: E402
import vega_tpu.testing as jax_testing  # noqa: E402
from vega_tpu.coordinates import Coordinates as JaxCoordinates  # noqa: E402

import vega_tpu.mocks as jax_mocks
from vega_tpu.io.fits import read_fits as jax_read_fits
from vega_tpu.parameters import param_utils as jax_param_utils
from vega_tpu.parameters.param_utils import get_default_values as jax_defaults
from vega_tpu.statics import resolve
from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch import mocks, state
from vega_tpu_torch.broadband_poly import BroadbandPolynomials
from vega_tpu_torch.correlation_func import CorrelationFunction
from vega_tpu_torch.model import Model
from vega_tpu_torch.pktoxi import PktoXi
from vega_tpu_torch.power_spectrum import PowerSpectrum
from vega_tpu_torch.io.fits import read_fits
from vega_tpu_torch.metals import PLAN_CONSTANTS
from vega_tpu_torch.parameters import param_utils
from vega_tpu_torch.parameters.param_utils import get_default_values
from vega_tpu_torch import testing as port_testing
from vega_tpu_torch.coordinates import Coordinates
from vega_tpu_torch.testing import (DR16_METALS, dr16_extra_model,
                                    make_synthetic_dataset)
from vega_tpu_torch.utils import JAX_PACKAGE_DIR, find_file
from vega_tpu_torch.vega_interface import VegaInterface

REPO = Path(__file__).resolve().parents[1]
CONST_RTOL = 1e-14
CORRS = ('lyaxlya', 'qsoxlya')


def jax_constants(vega):
    """The dict `vega_tpu_torch.state.load_constants` takes, read from a
    vega_tpu.VegaInterface (StaticRefs through statics.resolve)."""
    out = {name: np.asarray(vega.fiducial[name])
           for name in state.FIDUCIAL}
    for corr, model in vega.models.items():
        owners = {'pktoxi': model.PktoXi, 'power_spectrum': model.Pk_core,
                  'correlation_func': model.Xi_core,
                  'data': vega.data[corr]}
        for attr, owner in state.PER_CORRELATION.items():
            out[f'{corr}/{attr}'] = np.asarray(
                resolve(getattr(owners[owner], attr)))
        # the stacked metal classes: plan arrays and the representative
        # pair's constants
        plans = getattr(model.metals, '_stacked_plans', None) or []
        for i, plan in enumerate(plans):
            for name in PLAN_CONSTANTS:
                out[f'{corr}/metals/{i}/{name}'] = np.asarray(
                    resolve(plan[name]))
            for attr, owner in state.METAL_REPRESENTATIVE.items():
                out[f'{corr}/metals/{i}/{attr}'] = np.asarray(
                    resolve(getattr(plan[owner], attr)))
    return out


@pytest.fixture(scope='module')
def tiny_main(tmp_path_factory):
    """main.ini of one tiny synthetic dataset (made by the JAX package)."""
    return jax_make_dataset(tmp_path_factory.mktemp('tiny'), cross=True,
                            size='tiny')


@pytest.fixture(scope='module')
def constants(tiny_main):
    """(JAX constants, the port's own constants) on the tiny dataset."""
    return (jax_constants(JaxInterface(tiny_main)),
            state.export_constants(VegaInterface(tiny_main, device='cpu')))


@pytest.mark.parametrize('key', list(state.FIDUCIAL) + [
    f'{corr}/{attr}' for corr in CORRS for attr in state.PER_CORRELATION])
def test_port_init_constants_match_jax(constants, key):
    want, got = constants[0][key], constants[1][key]
    assert got.shape == want.shape
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
        return
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= CONST_RTOL * scale, key


def test_load_constants_round_trip(tiny_main, constants):
    port = VegaInterface(tiny_main, device='cpu')
    state.load_constants(port, constants[0])
    again = state.export_constants(port)
    for key, value in constants[0].items():
        np.testing.assert_array_equal(again[key], value)
    with pytest.raises(KeyError, match='missing constants'):
        state.load_constants(port, {'pk_full': constants[0]['pk_full']})


def test_synthetic_files_match_jax(tiny_main, tmp_path):
    """The port's make_synthetic_dataset writes the JAX package's files:
    same layout and headers, data vectors from the port's model."""
    make_synthetic_dataset(tmp_path / 'port', cross=True, size='tiny',
                           device='cpu')
    assert_same_files(Path(tiny_main).parent, tmp_path / 'port')


def test_synthetic_files_with_options_match_jax(tmp_path):
    """With a seed, noise and extra [control] text (here opening the
    [monte carlo] sections) the files are the JAX package's too."""
    options = dict(
        cross=True, size='tiny', seed=3, noise=1.0, with_distortion=True,
        extra_model='model-hcd = Rogers2018\n\n[parameters]\n'
                    'bias_hcd = -0.05\nbeta_hcd = 0.65\nL0_hcd = 10.\n',
        sample={'ap': '0.5 1.5 1.02 0.02', 'bias_LYA': 'True'},
        extra_control='mc_seed = 7\n\n[monte carlo]\nbias_LYA = True\n'
                      '\n[mc parameters]\nbias_LYA = -0.117\n')
    jax_make_dataset(tmp_path / 'jax', **options)
    make_synthetic_dataset(tmp_path / 'port', device='cpu', **options)
    assert_same_files(tmp_path / 'jax', tmp_path / 'port')


def test_synthetic_files_with_metals_match_jax(tmp_path):
    """The DR16-shaped dataset (HCD, Arinyo, four metals with their metal
    files, [metals] sections and `test = True`): the port's `metals=`
    option writes what vega_tpu's own functions write when driven by
    hand, data vectors from each package's model."""
    options = dict(cross=True, size='tiny', seed=5, noise=0.5,
                   extra_model=dr16_extra_model())
    make_jax_metal_dataset(tmp_path / 'jax', list(DR16_METALS), **options)
    make_synthetic_dataset(tmp_path / 'port', device='cpu',
                           metals=list(DR16_METALS), **options)
    assert_same_files(tmp_path / 'jax', tmp_path / 'port', n_fits=5)
    text = (tmp_path / 'port' / 'qsoxlya.ini').read_text()
    assert 'test = True' in text and '[metals]' in text
    assert 'in tracer1' not in text and 'in tracer2 = SiII(1190)' in text


def test_metal_helpers_match_jax(tmp_path):
    """metal_rp_shifts and write_metal_file, copies of vega_tpu's: equal
    numbers, equal files byte for byte."""
    metals = ['SiII(1260)', 'SiIII(1207)', 'CIV(eff)']
    shifts = port_testing.metal_rp_shifts(metals, 2.33)
    assert shifts == jax_testing.metal_rp_shifts(metals, 2.33)
    assert shifts != port_testing.metal_rp_shifts(metals, 2.33,
                                                  omega_m=0.3)
    for mod, coords, name in (
            (port_testing, Coordinates(-200., 200., 200., 20, 10), 'port'),
            (jax_testing, JaxCoordinates(-200., 200., 200., 20, 10), 'jax')):
        mod.write_metal_file(tmp_path / f'{name}.fits', coords, 2.33, 'QSO',
                             'LYA', metals_in2=metals, rp_shifts=shifts)
        mod.write_metal_file(tmp_path / f'{name}_auto.fits', coords, 2.33,
                             'LYA', 'LYA', metals_in1=metals[:2],
                             metals_in2=metals[:2])
    for stem in ('', '_auto'):
        assert (tmp_path / f'port{stem}.fits').read_bytes() == \
            (tmp_path / f'jax{stem}.fits').read_bytes()


@pytest.fixture(scope='module')
def metal_pair(tmp_path_factory):
    """(vega_tpu interface, port interface) on a tiny dataset with four
    metals, `use_metal_autos = False` in the auto-correlation."""
    main = make_jax_metal_dataset(
        tmp_path_factory.mktemp('metals'), list(DR16_METALS), cross=True,
        size='tiny', extra_model=dr16_extra_model())
    ini = Path(main).parent / 'lyaxlya.ini'
    ini.write_text(ini.read_text().replace(
        '[model]\n', '[model]\nuse_metal_autos = False\n'))
    return JaxInterface(main), VegaInterface(main, device='cpu')


@pytest.mark.parametrize('corr', CORRS)
def test_metal_readers_match_jax(metal_pair, corr):
    """data.py's metal readers and correlation_item.init_metals, copies
    of vega_tpu's: the same pairs in the same order, tracer catalog,
    coordinate grids and (identity: None) matrices."""
    jax_vega, port = metal_pair
    want_item, got_item = jax_vega.corr_items[corr], port.corr_items[corr]
    assert got_item.has_metals and got_item.test_flag
    assert got_item.metal_correlations == want_item.metal_correlations
    assert got_item.tracer_catalog == want_item.tracer_catalog
    # no metal x metal pair: 'SiII' is in every one of these names
    n_pairs = 4
    assert len(got_item.metal_correlations) == n_pairs
    want, got = jax_vega.data[corr], port.data[corr]
    assert list(got.metal_coordinates) == list(want.metal_coordinates)
    assert got.metal_mats == want.metal_mats
    assert set(got.metal_mats.values()) == {None}
    for pair, coords in want.metal_coordinates.items():
        for grid in ('rp_grid', 'rt_grid', 'z_grid', 'r_grid', 'mu_grid'):
            np.testing.assert_array_equal(
                getattr(got.metal_coordinates[pair], grid),
                getattr(coords, grid))
    config = got_item.config['metals']
    assert got._metal_lists(config) == want._metal_lists(config)
    for names in (('CIV(eff)', 'CIV(eff)'), ('CIV(eff)', 'LYA'),
                  ('SiII(1190)', 'SiII(1260)'), ('SiII(1190)', 'LYA')):
        assert got._use_correlation(*names) == want._use_correlation(*names)


def test_metal_readers_refuse_what_is_not_ported(metal_pair, tmp_path):
    """A metal file without matrices needs `test = True`; the new-metals
    mode needs its [metal-matrix] section (and the data file's
    cosmology, which this file lacks: the section is checked first)."""
    _, port = metal_pair
    source = Path(port.main_config['data sets'].get('ini files').split()[0])
    for old, new, error, match in (
            ('test = True\n', '', ValueError, 'metal matrices'),
            ('[model]\n', '[model]\nnew_metals = True\n',
             ValueError, 'metal-matrix')):
        (tmp_path / 'lyaxlya.ini').write_text(
            source.read_text().replace(old, new))
        main = (source.parent / 'main.ini').read_text().replace(
            str(source), str(tmp_path / 'lyaxlya.ini'))
        (tmp_path / 'main.ini').write_text(main)
        with pytest.raises(error, match=match):
            VegaInterface(tmp_path / 'main.ini', device='cpu')


def assert_same_files(jax_dir, port_dir, n_fits=3):
    """Same FITS layouts, headers and columns (DA within 1e-12 of its
    largest entry: each package's own model), same ini texts."""
    fits_files = sorted(p.name for p in jax_dir.glob('*.fits'))
    assert fits_files == sorted(p.name for p in port_dir.glob('*.fits'))
    assert len(fits_files) == n_fits
    for name in fits_files:
        want, got = jax_read_fits(jax_dir / name), read_fits(port_dir / name)
        assert len(want) == len(got)
        for hdu_w, hdu_g in zip(want, got):
            assert dict(hdu_w.header) == dict(hdu_g.header)
            if not hasattr(hdu_w, 'columns'):
                continue
            assert list(hdu_w.columns) == list(hdu_g.columns)
            for col in hdu_w.columns:
                if col == 'DA':
                    scale = np.max(np.abs(hdu_w[col]))
                    assert np.max(np.abs(hdu_g[col] - hdu_w[col])) \
                        <= 1e-12 * scale
                elif col in ('CO', 'COV'):
                    np.testing.assert_allclose(hdu_g[col], hdu_w[col],
                                               rtol=1e-11, atol=0)
                else:
                    np.testing.assert_array_equal(hdu_g[col], hdu_w[col])
    for ini in ('main.ini', 'lyaxlya.ini', 'qsoxlya.ini'):
        text_w = (jax_dir / ini).read_text().replace(str(jax_dir), '@')
        text_g = (port_dir / ini).read_text().replace(str(port_dir), '@')
        assert text_w == text_g


def test_default_values_match_jax():
    assert get_default_values() == jax_defaults()


@pytest.mark.parametrize('names', [
    ['ap', 'at', 'sigmaNL_par', 'bao_amp', 'growth_rate'],       # full names
    ['bias_LYA', 'beta_LYA', 'bias_eta_QSO', 'alpha_SiII(1190)',
     'beta_hcd', 'par_sigma_smooth_QSO'],                         # composites
    ['bias_nosuchtracer', 'beta_X', 'alpha_'],      # a composite, no tracer
    ['no_such_parameter', 'drp_QSO', 'x'],                        # unknown
    [],
], ids=['full', 'composite', 'composite_no_tracer', 'unknown', 'empty'])
def test_build_names_match_jax(names):
    """The .paramnames labels: a copy of vega_tpu's build_names, reading
    its latex files by path."""
    got = param_utils.build_names(names)
    assert got == jax_param_utils.build_names(names)
    assert list(got) == list(jax_param_utils.build_names(names))
    assert param_utils.COMPOSITES == jax_param_utils.COMPOSITES
    for path in (param_utils.LATEX_NAMES_FILE,
                 param_utils.LATEX_COMPOSITE_FILE):
        assert path.parent == JAX_PACKAGE_DIR / 'parameters'
        assert param_utils.get_latex(path) == jax_param_utils.get_latex(path)


def test_find_file_reads_jax_models_by_path():
    path = find_file('PlanckDR16/PlanckDR16.fits')
    assert path == JAX_PACKAGE_DIR / 'models' / 'PlanckDR16' / \
        'PlanckDR16.fits'
    with pytest.raises(RuntimeError, match='does not exist'):
        find_file('no/such/file.fits')


def test_cuda_without_gpu_raises(tiny_main):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        VegaInterface(tiny_main, device='cuda')


def test_synthetic_dataset_defaults_to_the_card(tmp_path):
    """Without a device, make_synthetic_dataset runs on the card: with no
    CUDA device it raises before writing a file, and never carries on on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        make_synthetic_dataset(tmp_path / 'out', cross=True, size='tiny')
    assert not (tmp_path / 'out').exists()


@pytest.mark.parametrize('cls', [Model, PowerSpectrum, CorrelationFunction,
                                 PktoXi, BroadbandPolynomials])
def test_model_constructors_require_a_device(cls):
    """Nothing under VegaInterface picks a device of its own."""
    device = inspect.signature(cls).parameters['device']
    assert device.default is inspect.Parameter.empty


def test_port_never_imports_jax():
    """Every module of the port imports with `jax` unimportable, and
    leaves no vega_tpu module behind."""
    code = '''
import importlib, pkgutil, sys
sys.modules['jax'] = None
import vega_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vega_tpu_torch.__path__,
                                               'vega_tpu_torch.')]
for name in names:
    importlib.import_module(name)
leaked = [m for m in sys.modules
          if m == 'vega_tpu' or m.startswith('vega_tpu.')]
assert not leaked, leaked
assert len(names) >= 20, names
new = {'vega_tpu_torch.factored', 'vega_tpu_torch.gridcollapse',
       'vega_tpu_torch.parallel', 'vega_tpu_torch.parallel.batch',
       'vega_tpu_torch.analysis', 'vega_tpu_torch.mocks',
       'vega_tpu_torch.samplers.sampler_interface',
       'vega_tpu_torch.samplers.nested', 'vega_tpu_torch.samplers.smc',
       'vega_tpu_torch.samplers.hmc', 'vega_tpu_torch.samplers.polychord',
       'vega_tpu_torch.samplers.pocomc',
       'vega_tpu_torch.scripts.run_vega_sampler', 'vega_tpu_torch.metals',
       'vega_tpu_torch.native', 'vega_tpu_torch.native.pair_hist',
       'vega_tpu_torch.output', 'vega_tpu_torch.postprocess',
       'vega_tpu_torch.postprocess.fit_results',
       'vega_tpu_torch.scripts.run_vega_mc',
       'vega_tpu_torch.scripts.run_vega_mc_fits',
       'vega_tpu_torch.broadband_poly'}
assert new <= set(names), sorted(new - set(names))
print('ok', len(names))
'''
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')


# ----------------------------------------------------------------------
# mocks.py, a copy of vega_tpu/mocks.py
# ----------------------------------------------------------------------
def _mock_case(case, mod, vega):
    data = vega.data['qsoxlya']
    rng = np.random.default_rng(4)
    if case == 'match_to_data_grid':
        n_model = data.dist_model_coordinates.rp_grid.size
        out = [mod.match_to_data_grid(rng.normal(size=data.full_data_size),
                                      data),
               mod.match_to_data_grid(rng.normal(size=n_model), data)]
        with pytest.raises(ValueError, match='Could not match'):
            mod.match_to_data_grid(np.zeros(7), data)
        return out
    cov = np.cov(rng.normal(size=(12, 40)))
    if case == 'scaled_cholesky':
        mask = rng.random(12) < 0.7
        return [mod.scaled_cholesky(cov), mod.scaled_cholesky(cov, 2.5),
                mod.scaled_cholesky(cov, 0.5, mask=mask)]
    if case == 'gaussian_draw':
        chol = np.linalg.cholesky(cov)
        np.random.seed(11)
        return [mod.gaussian_draw(np.arange(12.0), chol),
                mod.gaussian_draw(np.arange(12.0), chol,
                                  rng=np.random.default_rng(2))]
    assert case == 'resolve_scale'
    item = vega.corr_items['qsoxlya']
    return [mod.resolve_scale({'qsoxlya': 3.0}, item, 'qsoxlya'),
            mod.resolve_scale({'other': 3.0}, item, 'qsoxlya'),
            mod.resolve_scale(2.0, item), mod.resolve_scale(None, item),
            mod.resolve_scale(None)]


@pytest.mark.parametrize('case', ['match_to_data_grid', 'scaled_cholesky',
                                  'gaussian_draw', 'resolve_scale'])
def test_mocks_match_jax(tiny_main, case):
    """Each function of the port's mocks.py gives vega_tpu's output,
    bit for bit, on the same inputs (the numpy global RNG seeded alike)."""
    want = _mock_case(case, jax_mocks, JaxInterface(tiny_main))
    got = _mock_case(case, mocks, VegaInterface(tiny_main, device='cpu'))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

"""The PyTorch port's host layer against the JAX package (vega_tpu): the
init-time constants, the synthetic dataset files, the data-file lookup
and the rule that the port never imports JAX."""

import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vega_tpu.io.fits import read_fits as jax_read_fits
from vega_tpu.parameters.param_utils import get_default_values as jax_defaults
from vega_tpu.statics import resolve
from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch import state
from vega_tpu_torch.correlation_func import CorrelationFunction
from vega_tpu_torch.model import Model
from vega_tpu_torch.pktoxi import PktoXi
from vega_tpu_torch.power_spectrum import PowerSpectrum
from vega_tpu_torch.io.fits import read_fits
from vega_tpu_torch.parameters.param_utils import get_default_values
from vega_tpu_torch.testing import make_synthetic_dataset
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
    jax_dir, port_dir = Path(tiny_main).parent, tmp_path / 'port'
    make_synthetic_dataset(port_dir, cross=True, size='tiny', device='cpu')
    fits_files = sorted(p.name for p in jax_dir.glob('*.fits'))
    assert fits_files == sorted(p.name for p in port_dir.glob('*.fits'))
    assert len(fits_files) == 3
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
                elif col == 'CO':
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
                                 PktoXi])
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
assert len(names) >= 19, names
new = {'vega_tpu_torch.factored', 'vega_tpu_torch.gridcollapse',
       'vega_tpu_torch.parallel', 'vega_tpu_torch.parallel.batch'}
assert new <= set(names), sorted(new - set(names))
print('ok', len(names))
'''
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')

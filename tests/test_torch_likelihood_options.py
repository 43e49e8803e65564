"""The likelihood options of [control] and [data] that the PyTorch port
took over last, against the JAX package's on tiny synthetic files made
by vega_tpu: model_pk (the models' power-spectrum multipoles),
compute_direct (the model on one given linear spectrum) with
use_full_pk_for_mc (the Monte-Carlo fiducial and a fit of its mock), the
metals of compute_direct, a configuration whose correlations have no data
file, and the same options in the f32 mode."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

from jax_metal_dataset import make_jax_metal_dataset  # noqa: E402
from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset  # noqa: E402
from vega_tpu.vega_interface import VegaInterface as JaxInterface  # noqa: E402
from vega_tpu_torch.testing import (DR16_METALS, DR16_PARAMETERS,  # noqa: E402
                                    dr16_extra_model, make_synthetic_dataset,
                                    with_control, with_sample)
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

MODEL_RTOL = 1e-12      # a model vector: max|port - vega_tpu| / max|vega_tpu|
F32_MODEL_RTOL = 1e-5   # an f32 model vector against the f64 interface's
MOCK_RTOL = 1e-12       # a mock, the same numpy draw around each fiducial
FIT_VALUE_SIGMA = 1e-3  # fit values within 1e-3 of vega_tpu's errors
FIT_ERROR_RTOL = 1e-5   # fit errors, relative
POINT = {'bias_LYA': -0.11, 'beta_LYA': 1.7, 'ap': 1.02}
MC_SECTIONS = ('\n[monte carlo]\nbias_LYA = -1.0 0.0 -0.12 0.01\n'
               'beta_LYA = 0.0 3.0 1.6 0.1\n'
               '\n[mc parameters]\nbias_LYA = -0.115\nbeta_LYA = 1.65\n')


@pytest.fixture(autouse=True)
def dense_env(monkeypatch):
    """Both packages on the dense path (vega_tpu reads the switch when it
    traces, the port at construction)."""
    monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
    monkeypatch.setenv('VEGA_TPU_GRID_CACHE', '0')


def max_rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))
                 / np.max(np.abs(np.asarray(want))))


@pytest.fixture(scope='module')
def plain(tmp_path_factory):
    """A tiny auto+cross dataset (vega_tpu's files)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_FACTORED', '0')
        return jax_make_dataset(tmp_path_factory.mktemp('plain'),
                                cross=True, size='tiny', noise=1.0)


# ----------------------------------------------------------------------
# model_pk
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def model_pk(tmp_path_factory):
    """(vega_tpu's interface, the port's) with model_pk = True; vega_tpu's
    make_synthetic_dataset returns before writing a data-space model."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_FACTORED', '0')
        main = jax_make_dataset(tmp_path_factory.mktemp('model_pk'),
                                cross=True, size='tiny',
                                extra_control='model_pk = True')
        return JaxInterface(main), VegaInterface(main, device='cpu')


@pytest.mark.parametrize('call', ['defaults', 'point', 'run_init', 'direct'])
def test_model_pk_multipoles_match_jax(model_pk, call):
    """compute_model under model_pk: each correlation's multipoles
    (n_ell, n_k) = (4, 128) at size='tiny', bao_amp x peak + smooth (or
    compute_direct's on the full spectrum), within 1e-12 of max|vega_tpu|."""
    jax_vega, port = model_pk
    assert port.model_pk and jax_vega.model_pk
    kwargs = {'defaults': dict(run_init=False),
              'point': dict(params=POINT, run_init=False),
              'run_init': dict(params=POINT, run_init=True),
              'direct': dict(params=POINT, run_init=False,
                             direct_pk=jax_vega.fiducial['pk_full'])}[call]
    want = jax_vega.compute_model(**kwargs)
    got = port.compute_model(**kwargs)
    assert set(got) == set(want) == {'lyaxlya', 'qsoxlya'}
    for name in want:
        assert got[name].shape == want[name].shape == (4, 128)
        assert max_rel(got[name], want[name]) <= MODEL_RTOL


def test_model_pk_has_no_chi2_as_jax(model_pk):
    """No chi^2 compares multipoles with the data: vega_tpu fails on the
    data mask with IndexError, and the port raises IndexError."""
    jax_vega, port = model_pk
    for vega in (jax_vega, port):
        with pytest.raises(IndexError):
            vega.chi2()
    with pytest.raises(IndexError):
        port.chi2_batch({'bias_LYA': np.array([-0.1, -0.12])})


def test_make_synthetic_dataset_returns_early_under_model_pk(tmp_path):
    """The port's make_synthetic_dataset, as vega_tpu's (testing.py:
    285-287), writes no data-space model under model_pk: its files are
    the placeholder first pass, the same bytes as vega_tpu's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_FACTORED', '0')
        jax_main = jax_make_dataset(tmp_path / 'jax', cross=True,
                                    size='tiny',
                                    extra_control='model_pk = True')
    main = make_synthetic_dataset(tmp_path / 'port', cross=True, size='tiny',
                                  device='cpu',
                                  extra_control='model_pk = True')
    for stem in ('cf_synthetic', 'xcf_synthetic'):
        assert ((Path(main).parent / f'{stem}.fits').read_bytes()
                == (Path(jax_main).parent / f'{stem}.fits').read_bytes())


# ----------------------------------------------------------------------
# compute_direct and use_full_pk_for_mc
# ----------------------------------------------------------------------
def test_compute_direct_matches_jax(plain):
    """compute_model(direct_pk=pk_full): Model.compute_direct, one
    component on the full linear spectrum with no peak broadening,
    within 1e-12 of max|vega_tpu|, and not the peak / smooth model."""
    jax_vega = JaxInterface(plain)
    port = VegaInterface(plain, device='cpu')
    want = jax_vega.compute_model(POINT, run_init=False,
                                  direct_pk=jax_vega.fiducial['pk_full'])
    got = port.compute_model(POINT, run_init=False,
                             direct_pk=port.fiducial['pk_full'])
    standard = port.compute_model(POINT, run_init=False)
    for name in want:
        assert max_rel(got[name], want[name]) <= MODEL_RTOL
        assert max_rel(got[name], standard[name]) > 1e-3


@pytest.mark.parametrize('full_pk', [True, False])
def test_use_full_pk_for_mc_matches_jax(plain, tmp_path, full_pk):
    """With [monte carlo] and nothing in [sample] (so no initial fit), the
    fiducial of get_fiducial_for_monte_carlo (compute_direct's with
    use_full_pk_for_mc, else the peak / smooth model) at [mc parameters]
    within 1e-12 of max|vega_tpu|, the seeded mock the same draw (1e-12),
    and minimize() on the mock against vega_tpu's (values 1e-3 of its
    errors, errors 1e-5 relative)."""
    main = with_sample(plain, {}, tmp_path / 'main.ini')
    main = with_control(main, f'use_full_pk_for_mc = {full_pk}\nmc_seed = 3',
                        main, sections=MC_SECTIONS)
    jax_vega = JaxInterface(main)
    port = VegaInterface(main, device='cpu')
    want = jax_vega.get_fiducial_for_monte_carlo()
    got = port.get_fiducial_for_monte_carlo()
    direct = port.compute_model(port.mc_config['params'], run_init=False,
                                direct_pk=port.fiducial['pk_full'])
    for name in want:
        assert max_rel(got[name], want[name]) <= MODEL_RTOL
        assert np.array_equal(got[name], direct[name]) == full_pk
    mocks_want = jax_vega.initialize_monte_carlo()
    mocks_got = port.initialize_monte_carlo()
    for name in mocks_want:
        mask = port.data[name].data_mask
        assert max_rel(mocks_got[name][mask],
                       np.asarray(mocks_want[name])[mask]) <= MOCK_RTOL
    jax_vega.minimize()
    port.minimize()
    for name, value in jax_vega.bestfit.values.items():
        error = jax_vega.bestfit.errors[name]
        assert abs(port.bestfit.values[name] - value) <= \
            FIT_VALUE_SIGMA * error
        assert abs(port.bestfit.errors[name] - error) <= \
            FIT_ERROR_RTOL * error


@pytest.fixture(scope='module')
def metal_main(tmp_path_factory):
    """A tiny DR16-shaped dataset (Rogers HCD, Arinyo NL, four Si lines
    through identity metal matrices), made by vega_tpu."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_FACTORED', '0')
        return make_jax_metal_dataset(
            tmp_path_factory.mktemp('metals'), list(DR16_METALS), cross=True,
            size='tiny', extra_model=dr16_extra_model(
                parameters=DR16_PARAMETERS))


@pytest.mark.parametrize('decomp', ['no-metal-decomp', 'metal-decomp'])
def test_compute_direct_metals_as_jax(metal_main, tmp_path, decomp):
    """compute_direct beside metals equals vega_tpu's (1e-12 of max|ref|).
    With no-metal-decomp (the default) vega_tpu adds no metal there
    (model.py:124-126: only `compute` passes the metals in), and neither
    does the port: a metal bias leaves the direct model as it is. With
    no-metal-decomp = False each pair is computed on the full spectrum
    and the bias moves it."""
    main = metal_main
    if decomp == 'metal-decomp':
        work = Path(metal_main).parent
        for corr in ('lyaxlya', 'qsoxlya'):
            text = (work / f'{corr}.ini').read_text()
            (tmp_path / f'{corr}.ini').write_text(text.replace(
                '[model]\n', '[model]\nno-metal-decomp = False\n', 1))
        main = tmp_path / 'main.ini'
        main.write_text(Path(metal_main).read_text().replace(
            str(work / 'lyaxlya.ini'), str(tmp_path / 'lyaxlya.ini')).replace(
            str(work / 'qsoxlya.ini'), str(tmp_path / 'qsoxlya.ini')))
    jax_vega = JaxInterface(main)
    port = VegaInterface(main, device='cpu')
    pk = jax_vega.fiducial['pk_full']
    moved = dict(POINT, **{'bias_SiII(1260)': -0.02})
    for params in (POINT, moved):
        want = jax_vega.compute_model(params, run_init=False, direct_pk=pk)
        got = port.compute_model(params, run_init=False, direct_pk=pk)
        for name in want:
            assert max_rel(got[name], want[name]) <= MODEL_RTOL
    base = port.compute_model(POINT, run_init=False, direct_pk=pk)
    shifted = port.compute_model(moved, run_init=False, direct_pk=pk)
    for name in base:
        same = np.array_equal(base[name], shifted[name])
        assert same == (decomp == 'no-metal-decomp')


# ----------------------------------------------------------------------
# Correlations without a data file
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def data_free(plain, tmp_path_factory):
    """(vega_tpu's interface, the port's) on the plain dataset's configs
    with has_datafile = False in every correlation."""
    work = tmp_path_factory.mktemp('data_free')
    source = Path(plain).parent
    text = Path(plain).read_text()
    for corr in ('lyaxlya', 'qsoxlya'):
        ini = (source / f'{corr}.ini').read_text()
        (work / f'{corr}.ini').write_text(
            ini.replace('[data]\n', '[data]\nhas_datafile = False\n', 1))
        text = text.replace(str(source / f'{corr}.ini'),
                            str(work / f'{corr}.ini'))
    (work / 'main.ini').write_text(text)
    return (JaxInterface(work / 'main.ini'),
            VegaInterface(work / 'main.ini', device='cpu'))


def test_data_free_interface_constructs_as_jax(data_free):
    """Both construct with no Data, no blinding, no models, no plots and
    no marginalization modes (vega_interface.py:136-153,202,228)."""
    jax_vega, port = data_free
    for vega in (jax_vega, port):
        assert vega._has_data is False
        assert all(vega.data[name] is None for name in vega.corr_items)
        assert vega.models == {} and vega.plots is None
        assert vega.corr_num_marg_modes == {}
        assert vega._blind is False and vega._rnsps is None
    assert set(port.corr_items) == set(jax_vega.corr_items)
    assert port.sample_params['limits'] == jax_vega.sample_params['limits']


@pytest.mark.parametrize('call', ['compute_model', 'compute_model_no_init',
                                  'chi2', 'log_lik', 'chi2_batch'])
def test_data_free_evaluations_raise_as_jax(data_free, call):
    """Every evaluation raises what vega_tpu's raises: its Model asserts
    the data's coordinates (compute_model rebuilds the models), its chi^2
    asserts the data, and its compiled paths read the absent data's
    inverse covariances (AttributeError)."""
    jax_vega, port = data_free
    calls = {
        'compute_model': lambda v: v.compute_model(POINT),
        'compute_model_no_init': lambda v: v.compute_model(POINT,
                                                           run_init=False),
        'chi2': lambda v: v.chi2(POINT),
        'log_lik': lambda v: v.log_lik(POINT),
        'chi2_batch': lambda v: v.chi2_batch(
            {'bias_LYA': np.array([-0.11, -0.12])}),
    }
    with pytest.raises(Exception) as want:
        calls[call](jax_vega)
    with pytest.raises(type(want.value)):
        calls[call](port)


# ----------------------------------------------------------------------
# The f32 mode
# ----------------------------------------------------------------------
@pytest.mark.parametrize('case', ['model_pk', 'use_full_pk_for_mc',
                                  'data_free'])
def test_f32_mode_refuses_the_options(plain, data_free, tmp_path, case):
    """The f32 mode, which refused each option until the likelihood
    options joined it (ROADMAP.md item 10), builds it in f32 rather than
    running it in f64: model_pk's multipoles and use_full_pk_for_mc's
    fiducial model (compute_direct on the full linear spectrum at
    [mc parameters]) in float32 within F32_MODEL_RTOL of the f64
    interface's; without data files every evaluation raises what the f64
    interface raises (tests/test_torch_f32_options.py holds each against
    vega_tpu's f32)."""
    if case == 'data_free':
        main = Path(data_free[1].main_config['data sets']['ini files']
                    .split()[0]).parent / 'main.ini'
    else:
        main = with_control(plain, f'{case} = True', tmp_path / 'main.ini')
        if case == 'use_full_pk_for_mc':
            main.write_text(main.read_text() + MC_SECTIONS)
    vegas = [VegaInterface(main, device='cpu', dtype=dtype)
             for dtype in (torch.float32, torch.float64)]
    assert vegas[0].dtype == torch.float32
    if case == 'data_free':
        for call in (lambda v: v.compute_model(POINT),
                     lambda v: v.chi2(POINT),
                     lambda v: v.chi2_batch(
                         {'bias_LYA': np.array([-0.11, -0.12])})):
            raised = []
            for vega in vegas:
                with pytest.raises(Exception) as error:
                    call(vega)
                raised.append(type(error.value))
            assert raised[0] is raised[1]
        return
    if case == 'model_pk':
        models = [vega.compute_model(POINT, run_init=False)
                  for vega in vegas]
    else:
        models = [vega.get_fiducial_for_monte_carlo() for vega in vegas]
    for name, got in models[0].items():
        assert got.dtype == np.float32 and np.all(np.isfinite(got))
        assert max_rel(got, models[1][name]) <= F32_MODEL_RTOL

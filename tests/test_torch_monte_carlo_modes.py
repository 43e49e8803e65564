"""The six cases of tests/test_monte_carlo_modes.py on the PyTorch port,
each held against the JAX package on the same tiny synthetic files
(vega_tpu's make_synthetic_dataset): initialize_monte_carlo, the
forecast mode, run_monte_carlo's seeded mocks, the HDF5 results file,
low_mem_mode under a joint covariance (with and without the data files'
own covariances) and mc_start_from_fit."""

import torch_threads  # noqa: F401  (one torch thread per test process)

import numpy as np
import pytest

from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch.vega_interface import VegaInterface

CHI2_RTOL = 1e-12       # a chi^2, port vs vega_tpu
MOCK_RTOL = 1e-12       # a mock: max|port - vega_tpu| / max|vega_tpu|
FIT_VALUE_SIGMA = 1e-3  # fit values within 1e-3 of vega_tpu's errors
FIT_ERROR_RTOL = 1e-5   # fit errors, relative


@pytest.fixture(autouse=True)
def dense_env(monkeypatch):
    """Both packages on the dense path (vega_tpu reads the switch when it
    traces, the port at construction)."""
    monkeypatch.setenv('VEGA_TPU_FACTORED', '0')


def _with_mc_sections(main_path):
    text = main_path.read_text()
    text += ('\n[monte carlo]\nbias_LYA = True\nbeta_LYA = True\n'
             '\n[mc parameters]\nbias_LYA = -0.117\nbeta_LYA = 1.67\n')
    main_path.write_text(text)
    return main_path


def both(main):
    return JaxInterface(main), VegaInterface(main, device='cpu')


def max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def check_fit(port, jax_vega):
    for name, value in jax_vega.minimizer.values.items():
        error = jax_vega.minimizer.errors[name]
        assert abs(port.minimizer.values[name] - value) <= \
            FIT_VALUE_SIGMA * error
        assert abs(port.minimizer.errors[name] - error) <= \
            FIT_ERROR_RTOL * error


def test_initialize_monte_carlo(tmp_path):
    """The mock (1e-12 of max|vega_tpu|) and the chi^2 against it
    (1e-12 relative, within 0.2 n .. 5 n), seed 7 (vega_interface.py:
    1404-1428)."""
    main_path = _with_mc_sections(jax_make_dataset(
        tmp_path, cross=False, size='tiny', noise=1.0,
        extra_control='run_montecarlo = True\nmc_seed = 7'))
    jax_vega, port = both(main_path)
    want = jax_vega.initialize_monte_carlo()
    mocks = port.initialize_monte_carlo()
    assert port.monte_carlo
    name = next(iter(port.corr_items))
    mask = port.data[name].data_mask
    assert np.isfinite(mocks[name][mask]).all()
    assert max_rel(mocks[name][mask], np.asarray(want[name])[mask]) \
        <= MOCK_RTOL
    chi2 = port.chi2()
    n = port.data[name].data_size
    assert 0.2 * n < chi2 < 5 * n
    assert abs(chi2 - jax_vega.chi2()) <= CHI2_RTOL * chi2


def test_forecast_mode(tmp_path):
    """forecast = True: the mock is the fiducial, so the chi^2 at the
    truth is 0 (1e-10) in both packages."""
    main_path = _with_mc_sections(jax_make_dataset(
        tmp_path, cross=False, size='tiny', noise=0.0,
        extra_control='run_montecarlo = True\nforecast = True'))
    jax_vega, port = both(main_path)
    jax_vega.initialize_monte_carlo()
    port.initialize_monte_carlo()
    truth = {'bias_LYA': -0.117, 'beta_LYA': 1.67}
    assert port.chi2(truth) == pytest.approx(0.0, abs=1e-10)
    assert jax_vega.chi2(truth) == pytest.approx(0.0, abs=1e-10)


def test_mc_run_and_seed_reproducibility(tmp_path):
    """run_monte_carlo without fits: the same seed gives the same mocks
    twice, and the mocks of vega_tpu (1e-12 of max|ref|)."""
    main_path = _with_mc_sections(jax_make_dataset(
        tmp_path, cross=False, size='tiny', noise=1.0,
        extra_control='run_montecarlo = True'))
    jax_vega, port = both(main_path)
    fiducial = port.compute_model(run_init=False)
    port.monte_carlo = True
    port.analysis.run_monte_carlo(fiducial, num_mocks=2, seed=11,
                                  run_mc_fits=False)
    mocks_a = {k: np.array(v) for k, v in port.analysis.mc_mocks.items()}
    port.analysis.run_monte_carlo(fiducial, num_mocks=2, seed=11,
                                  run_mc_fits=False)
    jax_fiducial = jax_vega.compute_model(run_init=False)
    jax_vega.monte_carlo = True
    jax_vega.analysis.run_monte_carlo(jax_fiducial, num_mocks=2, seed=11,
                                      run_mc_fits=False)
    for name in mocks_a:
        np.testing.assert_array_equal(
            mocks_a[name], np.array(port.analysis.mc_mocks[name]))
        want = np.array(jax_vega.analysis.mc_mocks[name])
        finite = np.isfinite(want)
        assert np.array_equal(finite, np.isfinite(mocks_a[name]))
        assert max_rel(mocks_a[name][finite], want[finite]) <= MOCK_RTOL


def test_hdf_output(tmp_path):
    """The fit's HDF5 results file: each best-fit value and error as the
    interface holds them, and the fit against vega_tpu's (values 1e-3 of
    its errors, errors 1e-5 relative)."""
    import h5py

    jax_vega, port = both(jax_make_dataset(
        tmp_path, cross=False, size='tiny', noise=1.0))
    port.minimize()
    jax_vega.minimize()
    check_fit(port, jax_vega)
    port.output.type = 'hdf'
    port.output.outfile = str(tmp_path / 'results.h5')
    port.output.write_results(port.bestfit_model, port.params,
                              port.minimizer, port.bestfit_corr_stats)
    with h5py.File(tmp_path / 'results.h5') as f:
        assert 'best fit' in f
        bf = f['best fit']
        for name, value in port.minimizer.values.items():
            assert bf.attrs[name][0] == value
            assert bf.attrs[name][1] == port.minimizer.errors[name]


def test_low_mem_global_cov(tmp_path):
    """low_mem_mode under a joint covariance: the joint covariance is
    dropped after masking, the per-correlation ones kept as vega_tpu keeps
    them, and the chi^2 is vega_tpu's (1e-12 relative)."""
    jax_vega, port = both(jax_make_dataset(
        tmp_path, cross=True, size='tiny', noise=1.0, global_cov=True,
        extra_control='low_mem_mode = True'))
    assert port.low_mem_mode
    assert port.global_cov is None
    assert jax_vega.global_cov is None
    assert ([d.cov_mat is None for d in port.data.values()]
            == [d.cov_mat is None for d in jax_vega.data.values()])
    assert ([d.has_cov_mat for d in port.data.values()]
            == [d.has_cov_mat for d in jax_vega.data.values()])
    chi2 = port.chi2()
    assert np.isfinite(chi2)
    assert abs(chi2 - jax_vega.chi2()) <= CHI2_RTOL * chi2


def _without_covariance(main_path):
    """Rewrite each correlation's data file of `main_path` without its
    CO column: the global covariance is then the only one."""
    import configparser
    from vega_tpu_torch.io.fits import read_fits, write_fits
    config = configparser.ConfigParser()
    config.read(main_path)
    for ini in config['data sets']['ini files'].split():
        corr = configparser.ConfigParser()
        corr.read(ini)
        path = corr['data']['filename']
        hdul = read_fits(path)
        structural = ('XTENSION', 'BITPIX', 'NAXIS', 'PCOUNT', 'GCOUNT',
                      'TFIELDS', 'TTYPE', 'TFORM', 'TUNIT', 'TDIM',
                      'EXTNAME')
        hdus = [{'name': hdu.name,
                 'header': {k: v for k, v in hdu.header.items()
                            if not k.startswith(structural)},
                 'columns': {k: v for k, v in hdu.columns.items()
                             if k != 'CO'}}
                for hdu in hdul[1:]]
        assert 'CO' in hdul[1].columns
        write_fits(path, hdus)
    return main_path


def test_low_mem_global_cov_without_covariances(tmp_path):
    """low_mem_mode beside a joint covariance, the data files holding no
    covariance of their own: Data.cov_mat raises vega_tpu's
    AttributeError ('No covariance matrix found. ...', vega_tpu/data.py:
    145-159), has_cov_mat is False in both packages, and
    Data.create_monte_carlo, which factors the covariance, raises
    AttributeError too; the chi^2 on the joint covariance is vega_tpu's
    (1e-12 relative)."""
    jax_vega, port = both(_without_covariance(jax_make_dataset(
        tmp_path, cross=True, size='tiny', noise=1.0, global_cov=True,
        extra_control='low_mem_mode = True')))
    assert port.low_mem_mode
    for name, data in port.data.items():
        ref = jax_vega.data[name]
        assert data.has_cov_mat is ref.has_cov_mat is False
        for vega_data in (data, ref):
            with pytest.raises(AttributeError,
                               match='No covariance matrix found'):
                vega_data.cov_mat
        fiducial = np.zeros(data.full_data_size)
        for vega_data in (data, ref):
            with pytest.raises(AttributeError):
                vega_data.create_monte_carlo(fiducial, seed=1)
    chi2 = port.chi2()
    assert np.isfinite(chi2)
    assert abs(chi2 - jax_vega.chi2()) <= CHI2_RTOL * chi2


def test_mc_start_from_fit(tmp_path):
    """mc_start_from_fit: the fiducial at a saved fit's values under [mc
    parameters] (vega_interface.py:1381-1385), in the port equal to its
    model at those values and within 1e-12 of max|vega_tpu|'s, both
    reading the port's results file."""
    main_path = _with_mc_sections(jax_make_dataset(
        tmp_path, cross=False, size='tiny', noise=1.0,
        extra_control='run_montecarlo = True'))
    port = VegaInterface(main_path, device='cpu')
    port.minimize()
    port.output.write_results(port.bestfit_model, port.params,
                              port.minimizer, port.bestfit_corr_stats)
    fit_file = port.output.outfile + '.fits'

    jax_vega, port2 = both(main_path)
    for vega in (jax_vega, port2):
        vega.main_config['control']['mc_start_from_fit'] = fit_file
    fiducial = port2.get_fiducial_for_monte_carlo()
    want = jax_vega.get_fiducial_for_monte_carlo()
    name = next(iter(port2.corr_items))
    assert np.isfinite(fiducial[name]).all()
    expected_params = dict(port.minimizer.values)
    expected_params.update(port2.mc_config['params'])
    expected = port2.compute_model(expected_params, run_init=False)
    assert np.array_equal(fiducial[name], expected[name])
    assert max_rel(fiducial[name], want[name]) <= MOCK_RTOL

"""A fit's results written and read back in the PyTorch port
(vega_tpu_torch.output.Output, postprocess.fit_results.FitResults,
VegaInterface.compute_prior_chi2, mc_start_from_fit, and the scripts
run_vega_mc / run_vega_mc_fits) against the JAX package (vega_tpu),
mirroring tests/test_output_roundtrip.py, test_monte_carlo_modes.py:90
and test_scripts.py:32, on the CPU at size='tiny'. Each package's file is
read with the other's reader; each tolerance stands beside its use."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser

import numpy as np
import pytest

from vega_tpu.io.fits import read_fits as jax_read_fits
from vega_tpu.postprocess.fit_results import FitResults as JaxFitResults
from vega_tpu.scripts import run_vega_mc as jax_run_vega_mc
from vega_tpu.scripts import run_vega_mc_fits as jax_run_vega_mc_fits
from vega_tpu.testing import make_synthetic_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch.io.fits import Header, TableHDU, read_fits
from vega_tpu_torch.postprocess.fit_results import FitResults
from vega_tpu_torch.scripts import run_vega_mc, run_vega_mc_fits
from vega_tpu_torch.testing import priors_section
from vega_tpu_torch.vega_interface import VegaInterface

MC_SECTIONS = ('\n[monte carlo]\nbias_LYA = True\nbeta_LYA = True\n'
               '\n[mc parameters]\nbias_LYA = -0.117\nbeta_LYA = 1.67\n')
PRIOR_RTOL = 1e-14      # two Gaussian priors' chi^2, relative
MODEL_RTOL = 1e-12      # a fiducial model, of its largest entry
# the two packages' fits of the same mocks: values and errors relative
# to the largest of their column (the minimizers are copies, their chi^2
# agree to ~1e-13)
MC_RTOL = 1e-7


@pytest.fixture(scope='module', autouse=True)
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        yield


@pytest.fixture(scope='module')
def fits(tmp_path_factory):
    """The same tiny fit by each package, each written to its own file."""
    workdir = tmp_path_factory.mktemp('fit')
    main = make_synthetic_dataset(workdir, cross=False, size='tiny',
                                  noise=1.0)
    out = {}
    for writer, cls, kwargs in (('port', VegaInterface, {'device': 'cpu'}),
                                ('jax', JaxInterface, {})):
        vega = cls(main, **kwargs)
        vega.minimize()
        vega.output.outfile = str(workdir / f'{writer}_fit')
        vega.output.write_results(vega.bestfit_model, vega.params,
                                  vega.minimizer, vega.bestfit_corr_stats)
        out[writer] = vega
    return out


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_results_read_back_by_both_readers(fits, writer):
    """One package's file read with the other's FitResults (and with its
    own): names, values, errors, covariance and FVAL equal to the
    writer's minimizer, and the MODEL / DATA / MASK / RP / RT columns to
    its model and data, exactly."""
    vega = fits[writer]
    path = vega.output.outfile + '.fits'
    best = vega.minimizer
    readers = {'port': FitResults(path, no_chain=True),
               'jax': JaxFitResults(path, no_chain=True)}
    name = next(iter(vega.corr_items))
    coords = vega.corr_items[name].dist_model_coordinates
    for results in readers.values():
        assert [str(n) for n in results.names] == list(best.values)
        assert results.chisq == best.fmin.fval
        assert results.valid == best.minuit.valid
        for par in best.values:
            assert results.params[par] == best.values[par]
            assert results.sigmas[par] == best.errors[par]
        assert np.array_equal(results.cov, np.array(best.covariance))
        corr = results.correlations[name.lower()]
        assert np.array_equal(corr.model, vega.bestfit_model[name])
        assert np.array_equal(corr.data, vega.data[name].data_vec)
        assert np.array_equal(corr.data_mask, vega.data[name].data_mask)
        assert np.array_equal(corr.model_mask, vega.data[name].model_mask)
        assert np.array_equal(corr.rp, coords.rp_grid)
        assert np.array_equal(corr.rt, coords.rt_grid)
        assert corr.chisq == vega.bestfit_corr_stats[name]['chisq']
    assert readers['port'].p_value == readers['jax'].p_value


def test_gaussian_chain(fits):
    """The Gaussian-approximation chain (getdist when present, else the
    internal GaussianChain) reproduces the written mean."""
    results = FitResults(fits['port'].output.outfile + '.fits')
    samples = results.chain.samples
    assert samples.shape[1] == len(results.names)
    std = samples.std(axis=0)
    np.testing.assert_allclose(samples.mean(axis=0), results.mean,
                               atol=5 * np.max(std) / np.sqrt(len(samples)))


def test_scan_hdu(fits, tmp_path):
    """A profile scan's SCAN HDU: the port's rows, read by vega_tpu's
    FITS reader."""
    vega = VegaInterface(fits['port'].output.outfile.rsplit('/', 1)[0]
                         + '/main.ini', device='cpu')
    vega.main_config.add_section('chi2 scan')
    vega.main_config['chi2 scan']['bias_LYA'] = '-0.125 -0.11 3'
    scan = vega.analysis.chi2_scan()
    best = fits['port']
    vega.output.outfile = str(tmp_path / 'with_scan.fits')
    vega.output.write_results(best.bestfit_model, best.params,
                              best.minimizer, best.bestfit_corr_stats,
                              scan_results=scan)
    hdus = {h.name: h for h in jax_read_fits(vega.output.outfile)
            if getattr(h, 'name', '')}
    assert [str(n) for n in hdus['SCAN']['names']] == list(scan[0])
    for col in scan[0]:
        assert np.array_equal(hdus['SCAN'][col],
                              [row[col] for row in scan])


def test_legacy_single_hdu_model_format():
    """The legacy single-HDU 'MODEL' output (9 flat columns per
    correlation) goes to old_read_correlations, as in vega_tpu."""
    rng = np.random.default_rng(5)
    columns = {}
    n = 20
    for corr in ('lyaxlya', 'qsoxlya'):
        columns[corr + '_MODEL'] = rng.normal(size=n)
        columns[corr + '_MODEL_MASK'] = np.ones(n, dtype=bool)
        columns[corr + '_DATA'] = rng.normal(size=n)
        columns[corr + '_MASK'] = np.arange(n) % 2 == 0
        columns[corr + '_VAR'] = np.ones(n)
        columns[corr + '_RP'] = np.linspace(0, 200, n)
        columns[corr + '_RT'] = np.linspace(0, 200, n)
        columns[corr + '_Z'] = np.full(n, 2.3)
        columns[corr + '_CHI2'] = np.array([1.0])
    got, want = FitResults.__new__(FitResults), \
        JaxFitResults.__new__(JaxFitResults)
    for results in (got, want):
        results.num_pars = 2
        results.marg_coeff = {}
        results.read_correlations([TableHDU(Header(), columns,
                                            name='MODEL')])
    assert set(got.correlations) == {'lyaxlya', 'qsoxlya'}
    assert got.num_data_points == want.num_data_points == 20
    for corr in got.correlations:
        for field in ('model', 'model_mask', 'data', 'data_mask',
                      'variance', 'rp', 'rt', 'z'):
            assert np.array_equal(getattr(got.correlations[corr], field),
                                  getattr(want.correlations[corr], field))
    assert got.correlations['qsoxlya'].chisq is None


def test_hdf_output(fits, tmp_path):
    """write_results_hdf: the best-fit group's attributes are the
    minimizer's values and errors, its covariance and fmin."""
    h5py = pytest.importorskip('h5py')
    vega = fits['port']
    out = vega.output
    saved = out.type, out.outfile
    out.type, out.outfile = 'hdf', str(tmp_path / 'results.h5')
    try:
        out.write_results(vega.bestfit_model, vega.params, vega.minimizer,
                          vega.bestfit_corr_stats)
    finally:
        out.type, out.outfile = saved
    with h5py.File(tmp_path / 'results.h5') as f:
        attrs = f['best fit'].attrs
        for name, value in vega.minimizer.values.items():
            assert tuple(attrs[name]) == (value, vega.minimizer.errors[name])
        assert attrs['fval'] == vega.minimizer.fmin.fval
        assert attrs['cov[bias_LYA, beta_LYA]'] == \
            vega.minimizer.covariance[('bias_LYA', 'beta_LYA')]


def test_components_output_is_not_ported(tmp_path):
    """[output] write_cf / write_pk, not ported before the model's
    save-components (ROADMAP.md section 1 item 4b), now as vega_tpu writes
    them: each package writes the tiny auto's results with its models'
    saved components; PK_ and Xi_ read by either package's FITS reader
    hold the same columns, within MODEL_RTOL of each other."""
    main = make_synthetic_dataset(tmp_path, cross=False, size='tiny')
    config = configparser.ConfigParser()
    config.optionxform = str
    config.read(main)
    config['output'].update(write_cf='True', write_pk='True')
    with open(main, 'w') as fh:
        config.write(fh)
    files = {}
    for writer, vega in (('port', VegaInterface(main, device='cpu')),
                         ('jax', JaxInterface(main))):
        model = vega.compute_model(run_init=False)
        vega.output.outfile = str(tmp_path / f'{writer}_components')
        vega.output.write_results(model, vega.params, models=vega.models)
        files[writer] = vega.output.outfile + '.fits'
    tables = {(writer, reader): {h.name: h for h in read(path)
                                 if getattr(h, 'name', '')}
              for writer, path in files.items()
              for reader, read in (('port', read_fits),
                                   ('jax', jax_read_fits))}
    want = tables['jax', 'jax']
    assert {'PK_lyaxlya', 'Xi_lyaxlya'} <= set(want)
    for hdus in tables.values():
        assert set(hdus) == set(want)
        for name in ('PK_lyaxlya', 'Xi_lyaxlya'):
            assert set(hdus[name].columns) == set(want[name].columns)
            for col in want[name].columns:
                ref = np.asarray(want[name][col])
                assert np.max(np.abs(np.asarray(hdus[name][col]) - ref)) \
                    <= MODEL_RTOL * np.max(np.abs(ref))


def test_compute_prior_chi2_matches_jax(tmp_path):
    """Two Gaussian priors at the defaults and at a point: the port's
    compute_prior_chi2 equals vega_tpu's within PRIOR_RTOL."""
    main = make_synthetic_dataset(
        tmp_path, cross=False, size='tiny',
        extra_control=priors_section({'bias_LYA': 'gaussian -0.12 0.01',
                                      'beta_LYA': 'gaussian 1.6 0.2'}))
    port, jax_vega = VegaInterface(main, device='cpu'), JaxInterface(main)
    for point in (None, {'bias_LYA': -0.13, 'beta_LYA': 1.9}):
        want = jax_vega.compute_prior_chi2(point)
        assert want > 0
        assert abs(port.compute_prior_chi2(point) - want) <= \
            PRIOR_RTOL * want


@pytest.fixture(scope='module')
def mc_ini(tmp_path_factory):
    """A tiny auto config with run_montecarlo, 4 mocks, and [monte carlo]
    over bias_LYA, beta_LYA."""
    workdir = tmp_path_factory.mktemp('mc')
    main = make_synthetic_dataset(
        workdir, cross=False, size='tiny', noise=1.0,
        extra_control='run_montecarlo = True\nnum_mc_mocks = 4\n'
                      'mc_seed = 1\nrun_mc_fits = True')
    main.write_text(main.read_text() + MC_SECTIONS)
    return main


def with_output(main, stem, **control):
    """A copy of `main` writing to <dir>/<stem> with `control` set."""
    config = configparser.ConfigParser()
    config.optionxform = str
    config.read(main)
    config['output']['filename'] = str(main.parent / stem / 'output')
    config['control'].update(control)
    path = main.parent / f'{stem}.ini'
    with open(path, 'w') as fh:
        config.write(fh)
    return path


def test_mc_start_from_fit_matches_jax(fits, mc_ini):
    """mc_start_from_fit: both packages read the port's results file and
    seed the same fiducial model (MODEL_RTOL)."""
    ini = with_output(mc_ini, 'start', mc_start_from_fit=(
        fits['port'].output.outfile + '.fits'))
    port, jax_vega = VegaInterface(ini, device='cpu'), JaxInterface(ini)
    got = port.get_fiducial_for_monte_carlo()
    want = jax_vega.get_fiducial_for_monte_carlo()
    for name in port.corr_items:
        w = np.asarray(want[name])
        assert np.max(np.abs(got[name] - w)) <= MODEL_RTOL * np.max(
            np.abs(w))


def bestfit_table(path):
    hdus = {h.name: h for h in read_fits(path) if getattr(h, 'name', '')}
    return hdus['Bestfit'], hdus['Mocks']


def close(got, want, rtol):
    """Equal shapes and NaN (unmasked bins of a full-grid mock) in the
    same places; elsewhere within rtol of max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    assert np.max(np.abs(got - want)[finite]) <= rtol * np.max(
        np.abs(want[finite]))


def test_mc_scripts_match_jax(mc_ini, monkeypatch):
    """run_vega_mc --sequential against vega_tpu's on the same seed (the
    same numpy mocks, each package's fit); then the port's batched
    run_vega_mc, and each package's run_vega_mc_fits on the MOCKS it
    wrote: values and errors within MC_RTOL.

    vega_tpu keys the data terms of its collapse on id() of the current
    data vectors (vega_tpu/vega_interface.py:642-644): a mock freed and
    its address given to a later mock serves the earlier mock's terms,
    so whether its fit of a mock is right depends on the process's
    allocations (ROADMAP.md §3). Every vector vega_tpu reads is kept
    alive here, so no two mocks share an id."""
    alive = []
    current_data_vecs = JaxInterface._current_data_vecs

    def keep_alive(self):
        vecs = current_data_vecs(self)
        alive.extend(vecs.values())
        return vecs

    monkeypatch.setattr(JaxInterface, '_current_data_vecs', keep_alive)
    port_seq = with_output(mc_ini, 'port_seq')
    jax_seq = with_output(mc_ini, 'jax_seq')
    assert run_vega_mc.main([str(port_seq), '--sequential',
                             '--device', 'cpu']) == 0
    assert jax_run_vega_mc.main([str(jax_seq), '--sequential']) == 0
    got, got_mocks = bestfit_table(
        mc_ini.parent / 'port_seq' / 'monte_carlo' / 'monte_carlo.fits')
    want, want_mocks = bestfit_table(
        mc_ini.parent / 'jax_seq' / 'monte_carlo' / 'monte_carlo.fits')
    assert np.asarray(got['values']).shape == (2, 4)
    for col in ('values', 'errors'):
        close(got[col], want[col], MC_RTOL)
    close(got_mocks['lyaxlya'], want_mocks['lyaxlya'], MODEL_RTOL)

    batched = with_output(mc_ini, 'batched')
    assert run_vega_mc.main([str(batched), '--device', 'cpu']) == 0
    mocks_file = mc_ini.parent / 'batched' / 'monte_carlo' / \
        'monte_carlo.fits'
    first, mocks = bestfit_table(mocks_file)
    assert np.asarray(mocks['lyaxlya']).shape[0] == 4
    tables = {}
    for package, main in (('port', run_vega_mc_fits.main),
                          ('jax', jax_run_vega_mc_fits.main)):
        ini = with_output(mc_ini, f'refit_{package}',
                          mc_mocks=str(mocks_file))
        argv = [str(ini)] + (['--device', 'cpu'] if package == 'port'
                             else [])
        assert main(argv) == 0
        tables[package], _ = bestfit_table(
            mc_ini.parent / f'refit_{package}' / 'monte_carlo' /
            'monte_carlo.fits')
    for col in ('values', 'errors'):
        assert np.array_equal(tables['port'][col], first[col])
        close(tables['port'][col], tables['jax'][col], MC_RTOL)


def test_scripts_shard_over_several_devices(mc_ini, monkeypatch):
    """--n-devices 2 --device cpu (the mock fits over the CPU listed
    twice): run_vega_mc's fits equal its run on one device (MC_RTOL; the
    same seed draws the same mocks), and run_vega_mc_fits of each package
    with --n-devices 2 (vega_tpu's over two of its eight CPU devices) on
    those mocks gives the same fits (MC_RTOL)."""
    monkeypatch.setenv('VEGA_TPU_FIT_CHUNK_PER_DEVICE', '1')
    runs = {}
    for n_devices in ('2', '1'):
        ini = with_output(mc_ini, f'devices_{n_devices}')
        assert run_vega_mc.main([str(ini), '--n-devices', n_devices,
                                 '--device', 'cpu']) == 0
        runs[n_devices] = bestfit_table(
            mc_ini.parent / f'devices_{n_devices}' / 'monte_carlo' /
            'monte_carlo.fits')
    (sharded, mocks), (single, single_mocks) = runs['2'], runs['1']
    assert np.array_equal(mocks['lyaxlya'], single_mocks['lyaxlya'])
    assert np.asarray(mocks['lyaxlya']).shape[0] == 4
    for col in ('values', 'errors'):
        close(sharded[col], single[col], MC_RTOL)
    mocks_file = mc_ini.parent / 'devices_2' / 'monte_carlo' / \
        'monte_carlo.fits'
    for package, main in (('port', run_vega_mc_fits.main),
                          ('jax', jax_run_vega_mc_fits.main)):
        ini = with_output(mc_ini, f'devices_refit_{package}',
                          mc_mocks=str(mocks_file))
        argv = [str(ini), '--n-devices', '2'] + (
            ['--device', 'cpu'] if package == 'port' else [])
        assert main(argv) == 0
        table, _ = bestfit_table(
            mc_ini.parent / f'devices_refit_{package}' / 'monte_carlo' /
            'monte_carlo.fits')
        for col in ('values', 'errors'):
            close(table[col], sharded[col], MC_RTOL)

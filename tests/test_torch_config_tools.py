"""The port's config generator and tools against the JAX package's:
BuildConfig and make_correlation_template (vega_tpu_torch/build_config.py),
the scripts make_configs, make_template and
write_desi_instrumental_syst_table, the template side of the FFTLog
(FFTLogXi2P, extrapolated_transform), and profiling on the CPU. The same
arguments must write the same files, apart from each ini file's date and
git-hash lines; DESI DR1's baseline configs written by the port's
BuildConfig on blinded tiny files must give vega_tpu's chi^2."""

import torch_threads  # noqa: F401  (one torch thread per test process)
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

import vega_tpu.build_config as jax_bc  # noqa: E402
import vega_tpu.ops.fftlog as jax_fftlog  # noqa: E402
from jax_metal_dataset import make_jax_metal_dataset  # noqa: E402
from vega_tpu.io.fits import read_fits  # noqa: E402
from vega_tpu.scripts import make_configs as jax_make_configs  # noqa: E402
from vega_tpu.scripts import make_template as jax_make_template  # noqa: E402
from vega_tpu.scripts import (  # noqa: E402
    write_desi_instrumental_syst_table as jax_syst_table)
from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset  # noqa: E402
from vega_tpu.vega_interface import VegaInterface as JaxInterface  # noqa: E402
from vega_tpu_torch import build_config as bc  # noqa: E402
from vega_tpu_torch import profiling  # noqa: E402
from vega_tpu_torch.ops import fftlog  # noqa: E402
from vega_tpu_torch.scripts import make_configs, make_template  # noqa: E402
from vega_tpu_torch.scripts import write_desi_instrumental_syst_table  # noqa: E402
from vega_tpu_torch.testing import (DESI_METALS, desi_extra_model,  # noqa: E402
                                    with_blinding, write_desi_example_configs)
from vega_tpu_torch.vega_interface import VegaInterface  # noqa: E402

CHI2_RTOL = 1e-12       # a chi^2, port vs vega_tpu, relative
# the lines of a written ini file that differ between the packages
HEADER = re.compile(r'^# (File written on|vega_tpu(_torch)? git hash:) .*$',
                    re.MULTILINE)


def ini_texts(out_dir):
    """{file name: text} of the ini files in `out_dir`, with the date and
    git-hash lines and the directory itself blanked."""
    return {p.name: HEADER.sub('#', p.read_text()).replace(str(out_dir),
                                                           '<out>')
            for p in sorted(Path(out_dir).glob('*.ini'))}


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    """A tiny auto+cross dataset made by vega_tpu."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_FACTORED', '0')
        return jax_make_dataset(tmp_path_factory.mktemp('tiny'), cross=True,
                                size='tiny', noise=1.0)


def test_correlation_templates_match_jax():
    """Every recognised correlation's template, section by section, and
    the refusal of an unknown one."""
    assert bc.BuildConfig.recognised_correlations == \
        jax_bc.BuildConfig.recognised_correlations
    assert bc.TRACERS == jax_bc.TRACERS
    assert bc.DEFAULT_METALS == jax_bc.DEFAULT_METALS
    for name in bc.BuildConfig.recognised_correlations:
        got = bc.make_correlation_template(name)
        want = jax_bc.make_correlation_template(name)
        assert ({s: dict(got[s]) for s in got.sections()}
                == {s: dict(want[s]) for s in want.sections()})
    for module in (bc, jax_bc):
        with pytest.raises(ValueError):
            module.make_correlation_template('fooxbar')


def test_default_helpers_match_jax():
    for z in (2.0, 2.334, 3.1):
        assert bc.BuildConfig.get_lya_bias(z) == \
            jax_bc.BuildConfig.get_lya_bias(z)
        assert bc.BuildConfig.get_qso_bias(z) == \
            jax_bc.BuildConfig.get_qso_bias(z)
        assert bc.BuildConfig.get_growth_rate(z) == \
            jax_bc.BuildConfig.get_growth_rate(z)


@pytest.mark.parametrize('case', ['lyaxlya', 'desi'])
def test_build_config_writes_jax_files(tiny, tmp_path, case):
    """The same arguments write the same main and correlation files:
    lyaxlya with tests/test_build_config.py's options and its effective
    redshift read from the data (get_zeff), and DESI DR1's baseline
    (examples/DESI_data_setup/make_configs.py's options, 17 names,
    priors, new metals, fast metals)."""
    source = Path(tiny).parent
    written = {}
    for label, module in (('port', bc), ('jax', jax_bc)):
        out = tmp_path / label
        out.mkdir()
        if case == 'lyaxlya':
            builder = module.BuildConfig(options={
                'template': str(source / 'fiducial_eh98.fits'),
                'bao_broadening': True, 'test': True}, overwrite=True)
            main = builder.build(
                correlations={'lyaxlya': {
                    'corr_path': str(source / 'cf_synthetic.fits'),
                    'r-min': 10, 'r-max': 180}},
                fit_type='lyaxlya',
                fit_info={'sample_params': ['bias_LYA', 'beta_LYA'],
                          'bias_beta_config': {'LYA': 'bias_beta'}},
                out_path=str(out),
                parameters={'bias_LYA': -0.117, 'beta_LYA': 1.67})
            assert builder.zeff_in == pytest.approx(2.33)
        else:
            main = write_desi_example_configs(
                module.BuildConfig, out,
                {'auto': '/data/cf.fits', 'cross': '/data/xcf.fits',
                 'stack': '/data/stack.fits', 'catalog': '/data/qso.fits',
                 'template': '/data/template.fits'})
        assert Path(main).parent == out
        written[label] = ini_texts(out)
    assert written['port'] == written['jax']
    assert len(written['port']) == (2 if case == 'lyaxlya' else 3)


def test_make_configs_script_writes_jax_files(tiny, tmp_path):
    """vega_make_configs_torch against vega_tpu's make_configs."""
    source = Path(tiny).parent
    written = {}
    for label, script in (('port', make_configs), ('jax', jax_make_configs)):
        out = tmp_path / label
        out.mkdir()
        assert script.main([
            '--fit-name', 'lyaxlya_lyaxqso',
            '--corr-paths', str(source / 'cf_synthetic.fits'),
            str(source / 'xcf_synthetic.fits'),
            '--out-path', str(out), '--sample-params', 'ap', 'at',
            'bias_LYA', 'beta_LYA', '--metals', 'SiII(1260)',
            '--hcd-model', 'Rogers2018', '--small-scale-nl',
            '--template', str(source / 'fiducial_eh98.fits')]) == 0
        written[label] = ini_texts(out)
    assert written['port'] == written['jax'] and len(written['port']) == 3


def test_fftlog_template_transforms_match_jax():
    """FFTLogXi2P and extrapolated_transform bit for bit."""
    k = np.logspace(-4, 2, 256)
    pk = 1e4 * k / (1 + (k / 0.02) ** 2.6)
    r, xi = fftlog.extrapolated_transform(fftlog.FFTLogP2Xi, k, pk,
                                          pad_factor=4, keep='all')
    r_j, xi_j = jax_fftlog.extrapolated_transform(
        jax_fftlog.FFTLogP2Xi, k, pk, pad_factor=4, keep='all')
    assert np.array_equal(r, r_j) and np.array_equal(xi, xi_j)
    for ell in (0, 2):
        got = fftlog.FFTLogXi2P(r, ell)
        want = jax_fftlog.FFTLogXi2P(r, ell)
        assert np.array_equal(got.k_grid, want.k_grid)
        assert np.array_equal(got.transform(xi), want.transform(xi))
    got = fftlog.extrapolated_transform(fftlog.FFTLogXi2P, r, xi)
    want = jax_fftlog.extrapolated_transform(jax_fftlog.FFTLogXi2P, r, xi)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_make_template_writes_jax_file(tmp_path):
    """The Eisenstein-Hu template with the side-band split: the same K,
    PK, PKSB columns and header."""
    paths = {}
    for label, script in (('port', make_template),
                          ('jax', jax_make_template)):
        paths[label] = tmp_path / f'{label}.fits'
        assert script.main(['-o', str(paths[label]), '--z-ref', '2.33']) == 0
    got, want = read_fits(paths['port'])[1], read_fits(paths['jax'])[1]
    for column in ('K', 'PK', 'PKSB'):
        assert np.array_equal(got[column], want[column]), column
    assert dict(got.header) == dict(want.header)


def test_instrumental_syst_table_writes_jax_file(tmp_path):
    """write_desi_instrumental_syst_table on DESI's positioner table
    (read by path) with a seed: the same CSV."""
    texts = {}
    for label, script in (('port', write_desi_instrumental_syst_table),
                          ('jax', jax_syst_table)):
        out = tmp_path / f'{label}.csv'
        assert script.main(['-o', str(out), '--n-randoms', '3000',
                            '--seed', '4']) == 0
        texts[label] = out.read_text()
    assert texts['port'] == texts['jax']
    assert texts['port'].startswith('RT,XI\n0.0,')


@pytest.fixture(scope='module')
def desi_blinded(tmp_path_factory):
    """DESI DR1's baseline configs written by each package's BuildConfig
    on a tiny DESI-shaped dataset (vega_tpu's files: new metals from
    stacked-delta weights), its correlation files copied with BLINDING =
    desi_dr3 and a seeded DA_BLIND column, the cross's line of sight
    reversed for BuildConfig's lyaxqso: the CPU rehearsal of the options
    phase of chip_smoke.py."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_FACTORED', '0')
        work = tmp_path_factory.mktemp('desi')
        make_jax_metal_dataset(work, list(DESI_METALS), cross=True,
                               size='tiny', new_metals=True,
                               extra_model=desi_extra_model())
    files = {
        'auto': with_blinding(work / 'cf_synthetic.fits', 'desi_dr3',
                              work / 'cf_blind.fits', seed=0),
        'cross': with_blinding(work / 'xcf_synthetic.fits', 'desi_dr3',
                               work / 'xcf_blind.fits', seed=1,
                               flip_rp=True),
        'stack': work / 'delta_stack.fits',
        'catalog': work / 'qso_catalog.fits',
        'template': work / 'fiducial_eh98.fits'}
    mains = {}
    for label, module in (('port', bc), ('jax', jax_bc)):
        (work / label).mkdir()
        mains[label] = write_desi_example_configs(module.BuildConfig,
                                                  work / label, files)
    return mains, files


def test_desi_blinded_configs_give_jax_chi2(desi_blinded, monkeypatch):
    """vega_tpu on its configs and the port on its own give the same
    chi^2 on DA_BLIND (1e-12 relative), at the defaults and at three
    points 1% around them, and the blinded cross is the unblinded one's
    DA_BLIND with rp reversed."""
    monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
    mains, files = desi_blinded
    jax_vega = JaxInterface(mains['jax'])
    port = VegaInterface(mains['port'], device='cpu')
    assert port._blind and port._rnsps is None
    assert set(port.sample_params['limits']) == \
        set(jax_vega.sample_params['limits'])
    assert len(port.sample_params['limits']) == 17
    assert abs(port.chi2() - jax_vega.chi2()) <= CHI2_RTOL * jax_vega.chi2()
    rng = np.random.default_rng(0)
    rows = {n: port.params[n] + 0.01 * (abs(port.params[n]) or 0.1)
            * rng.normal(size=3) for n in port.sample_params['limits']}
    got = port.chi2_batch(rows).numpy()
    want = np.asarray(jax_vega.chi2_batch(rows))
    assert np.all(np.abs(got - want) <= CHI2_RTOL * np.abs(want))
    cross = read_fits(files['cross'])[1]
    source = read_fits(Path(files['cross']).parent / 'xcf_synthetic.fits')[1]
    order = np.lexsort((source['RT'], -source['RP']))
    assert np.array_equal(cross['DA'][np.lexsort((cross['RT'],
                                                   cross['RP']))],
                          source['DA'][order])


def test_profiling_on_the_cpu(tiny, tmp_path, capsys):
    """timed prints its block's time; time_likelihood gives the chi^2 of
    the interface with a first-call time and a rate; trace writes a
    Chrome trace of the block's ops."""
    vega = VegaInterface(tiny, device='cpu')
    with profiling.timed('block', device='cpu'):
        vega.chi2()
    assert re.search(r'TIMING block: \d+\.\d{4}s', capsys.readouterr().out)
    stats = profiling.time_likelihood(vega, n_evals=3)
    assert stats['chi2'] == vega.chi2()
    assert stats['first_call_s'] > 0 and stats['evals_per_sec'] > 0
    with profiling.trace(tmp_path / 'trace', device='cpu') as prof:
        vega.chi2_batch({'bias_LYA': np.array([-0.11, -0.12])})
    assert (tmp_path / 'trace' / 'trace.json').stat().st_size > 0
    assert any('matmul' in e.key or 'mm' in e.key
               for e in prof.key_averages())
    shutil.rmtree(tmp_path / 'trace')

"""The f32 throughput mode (VEGA_TPU_X64=0 or dtype=torch.float32) of the
PyTorch port in the profile scans and Monte-Carlo campaigns
(parallel.batch: TraceableLogLik, the batched Newton, batched_chi2_scan,
MonteCarloEngine; Analysis; VegaInterface.initialize_monte_carlo;
scripts/run_vega_mc.py, run_vega_mc_fits.py and `cli mc`), on the CPU,
against the JAX package's f32 and f64 (vega_tpu under VEGA_TPU_X64=0 is
process-wide, so its numbers are committed:
tests/data/torch_port_f32_campaign_goldens.json, written by
tests/tools/make_torch_port_f32_campaign_goldens.py) and the port's own
f64.

One tiny synthetic auto+cross dataset with noise (the tool's TINY: seed 3,
(ap, at, bias_LYA, beta_LYA) sampled, 8 x 8 grid nodes, [monte carlo]
over (bias_LYA, beta_LYA)), written by the port's make_synthetic_dataset.
The f32 ladder is vega_tpu's (tests/test_f32_mode.py:106-109): |d chi2|
<= max(0.3, 3e-4 |chi2|), half of it for a log-likelihood; fitted values
within 1e-2 of the JAX errors.

The Newton's tests are vega_tpu's constants in f32, in both packages: an
f32 gradient of chi^2 never falls to the stopping test's 1e-6, so every
row runs to max_iterations, and few pass the validity test |g| < 1e-3
(ROADMAP.md section 3). The dense mock fits here stop at the tool's
DENSE_ITERATIONS (30) in both packages to keep the file short; the
collapse's at the default 200.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import configparser
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vega_tpu_torch import cli
from vega_tpu_torch.io.fits import read_fits
from vega_tpu_torch.parallel import (BatchedLikelihood, MonteCarloEngine,
                                     batched_chi2_scan)
from vega_tpu_torch.scripts import run_vega_mc, run_vega_mc_fits
from vega_tpu_torch.testing import make_synthetic_dataset, with_control
from vega_tpu_torch.vega_interface import VegaInterface

from test_torch_f32_path import F64Ops

sys.path.insert(0, str(Path(__file__).resolve().parent / 'tools'))

import make_torch_port_f32_campaign_goldens as tool  # noqa: E402

GOLDENS = json.loads((Path(__file__).parent / 'data'
                      / 'torch_port_f32_campaign_goldens.json').read_text())
TINY32, TINY64 = GOLDENS['tiny']['f32'], GOLDENS['tiny']['f64']
LADDER_ABS, LADDER_REL = 0.3, 3e-4
FIT_SIGMA = 1e-2
NAMES, NUISANCE = tool.NAMES, tool.NUISANCE


def within_ladder(got, want, scale=1.0):
    """|got - want| <= scale max(0.3, 3e-4 |want|) everywhere; scale 0.5
    for log-likelihoods."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    return bool(np.all(np.abs(got - want) <= scale * np.maximum(
        LADDER_ABS, LADDER_REL * np.abs(want))))


def sigma_off(values, want_values, want_errors):
    """max |values - want| / error."""
    return float(np.max(np.abs(np.asarray(values) - np.asarray(want_values))
                        / np.asarray(want_errors)))


@pytest.fixture(scope='module', autouse=True)
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_X64', raising=False)
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        mp.delenv('VEGA_TPU_FIT_CHUNK_PER_DEVICE', raising=False)
        yield mp


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    return make_synthetic_dataset(tmp_path_factory.mktemp('f32_campaigns'),
                                  device='cpu', **tool.TINY)


@pytest.fixture(scope='module')
def interfaces(tiny, env):
    """{(regime, dtype): interface}: 'grid' (the defaults: the payload
    for the four names, the nuisance collapse for two) and 'dense'
    (VEGA_TPU_FACTORED=0). The f32 ones are built under VEGA_TPU_X64=0,
    as vega_tpu selects its f32 mode."""
    out = {}
    for regime, factored in (('grid', None), ('dense', '0')):
        if factored is not None:
            env.setenv('VEGA_TPU_FACTORED', factored)
        env.setenv('VEGA_TPU_X64', '0')
        out[regime, torch.float32] = VegaInterface(tiny, device='cpu')
        env.delenv('VEGA_TPU_X64')
        out[regime, torch.float64] = VegaInterface(tiny, device='cpu')
        env.delenv('VEGA_TPU_FACTORED', raising=False)
    assert out['grid', torch.float32].dtype == torch.float32
    return out


# ----------------------------------------------------------------------
# What the f32 mode now builds
# ----------------------------------------------------------------------
@pytest.mark.parametrize('case', ['sampler', 'monte_carlo'])
def test_sampler_and_monte_carlo_configs_build_in_f32(tiny, tmp_path, case):
    """The two configurations tests/test_torch_f32_path.py refused until
    this mode covered them: run_sampler = True, and a [monte carlo]
    section (the tiny dataset has one) with run_montecarlo."""
    control = ('run_sampler = True\nsampler = NestedJax\n' if case == 'sampler'
               else 'run_montecarlo = True\n')
    sections = (f'\n[NestedJax]\npath = {tmp_path}\nname = x\n'
                if case == 'sampler' else '')
    main = with_control(tiny, control, tmp_path / 'main.ini', sections)
    vega = VegaInterface(main, device='cpu', dtype=torch.float32)
    assert vega.dtype == torch.float32 and vega.mc_config is not None
    assert vega.run_sampler is (case == 'sampler')
    assert MonteCarloEngine(vega).vega is vega


# ----------------------------------------------------------------------
# The traceable log-likelihood
# ----------------------------------------------------------------------
@pytest.mark.parametrize('regime', ['grid', 'dense'])
def test_traceable_log_lik_matches_jax_f32(interfaces, regime):
    """TraceableLogLik of an f32 interface on 7 rows: f32, equal to the
    port's own f32 log_lik_batch on the same rows (to 2 f32 ulps: the
    normalisation and -chi^2 / 2 are added in another order), within
    half the ladder of vega_tpu's f32 traceable log-likelihood and of its
    f64 one."""
    vega = interfaces[regime, torch.float32]
    theta = np.asarray(GOLDENS['tiny']['f32']['traceable']['theta'])
    log_lik = BatchedLikelihood(vega).traceable_log_lik(NAMES)
    got = log_lik(torch.as_tensor(theta, dtype=torch.float32))
    assert got.dtype == torch.float32
    own = vega.log_lik_batch(dict(zip(NAMES, theta.T)))
    assert torch.allclose(got, own, rtol=2.4e-7, atol=0)
    for goldens in (TINY32, TINY64):
        want = goldens['traceable'][regime]['log_lik']
        assert within_ladder(got.numpy(), want, 0.5), (
            goldens['traceable'][regime]['dtype'], got, want)


# ----------------------------------------------------------------------
# The profile scan
# ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def scans(interfaces):
    """The 8 x 8 (ap, at) scan of the goldens on the payload, by the
    port's f32 and f64 interfaces: {dtype: (rows, stats)}."""
    axis = np.linspace(*tool.SCAN_AXIS)
    out = {}
    for dtype in (torch.float32, torch.float64):
        stats = {}
        rows = batched_chi2_scan(interfaces['grid', dtype],
                                 {'ap': axis, 'at': axis}, stats=stats)
        out[dtype] = rows, stats
    return out


def test_scan_matches_jax_f32_and_f64(scans):
    """fval within the ladder of vega_tpu's f32 scan and of the port's f64
    scan; the free values within FIT_SIGMA of the JAX f64 errors of both
    (vega_tpu's f32 and f64 values, the port's f64). Iterations and
    valid rows are printed beside vega_tpu's: both f32 runs take every
    row to max_iterations (vega_tpu's stopping test last read max
    |projected gradient| of 1e-3-1e-1 there, above its 1e-6), and both
    f64 runs stop early with every row valid."""
    rows32, stats32 = scans[torch.float32]
    rows64, stats64 = scans[torch.float64]
    errors = np.asarray(TINY64['scan']['errors'])
    fval = np.array([r['fval'] for r in rows32])
    values = np.array([[r[n] for n in NUISANCE] for r in rows32])
    for label, want_fval, want_values in (
            ('vega_tpu f32', TINY32['scan']['fval'], TINY32['scan']['values']),
            ('vega_tpu f64', TINY64['scan']['fval'], TINY64['scan']['values']),
            ('port f64', [r['fval'] for r in rows64],
             [[r[n] for n in NUISANCE] for r in rows64])):
        assert within_ladder(fval, want_fval), label
        assert sigma_off(values, want_values, errors) <= FIT_SIGMA, label
    last = TINY32['scan']['last_gradient']
    print(f'f32 scan: iterations per chunk {stats32["iterations"]}, valid '
          f'rows {stats32["valid_rows"]} of {len(rows32)} (vega_tpu f32: '
          f'{sum(TINY32["scan"]["valid"])} valid, '
          f'{sum(TINY32["scan"]["ran_to_max_iterations"])} rows to '
          f'max_iterations, its last max |g| {min(last):.3g}-'
          f'{max(last):.3g}); f64: {stats64["iterations"]}, '
          f'{stats64["valid_rows"]} valid (vega_tpu f64: '
          f'{sum(TINY64["scan"]["valid"])})')
    assert set(stats32['iterations']) == {tool.SCAN_ITERATIONS}
    assert all(TINY32['scan']['ran_to_max_iterations'])
    assert not any(TINY64['scan']['ran_to_max_iterations'])
    assert stats64['valid_rows'] == len(rows64) == sum(TINY64['scan']['valid'])
    assert max(stats64['iterations']) < tool.SCAN_ITERATIONS


def test_analysis_chi2_scan_in_f32(interfaces):
    """Analysis.chi2_scan ([chi2 scan] bias_LYA, 3 points) of the f32
    interface, batched and serial: the same points within the ladder of
    each other and of the f64 interface's batched scan."""
    results = {}
    for dtype in (torch.float32, torch.float64):
        vega = interfaces['grid', dtype]
        vega.main_config['chi2 scan'] = {'bias_LYA': '-0.121 -0.115 3'}
        for batched in (('True', 'False') if dtype == torch.float32
                        else ('True',)):
            vega.main_config['control']['batched_scan'] = batched
            results[dtype, batched] = vega.analysis.chi2_scan()
        vega.main_config.remove_section('chi2 scan')
        vega.main_config['control']['batched_scan'] = 'True'
    want = [r['fval'] for r in results[torch.float64, 'True']]
    for key in ((torch.float32, 'True'), (torch.float32, 'False')):
        assert [r['bias_LYA'] for r in results[key]] == pytest.approx(
            [-0.121, -0.118, -0.115])
        assert within_ladder([r['fval'] for r in results[key]], want), key


# ----------------------------------------------------------------------
# Monte-Carlo mock fits
# ----------------------------------------------------------------------
@pytest.mark.parametrize('kind', ['dense', 'collapse'])
def test_fit_mocks_match_jax_f32(interfaces, kind):
    """MonteCarloEngine.fit_mocks of the f32 interface on the goldens' 4
    numpy mocks against vega_tpu's f32 fits of the same mocks at the same
    max_iterations: values within FIT_SIGMA of its errors, chi^2 within
    the ladder, `valid` equal (an f32 gradient stays above 1e-3 here, in
    both packages); the same against the port's f64 fits, whose rows are
    all valid; the f32 rows ran to the cap."""
    vega = interfaces['grid', torch.float32]
    want = TINY32['mocks'][kind]
    fiducial = vega.compute_model(tool.MC_PARAMS, run_init=False)
    mocks = tool.numpy_mocks(vega, fiducial, tool.N_MOCKS, tool.MOCK_SEED)
    sample = tool.sample_subset(vega.sample_params, want['names'])
    stats = {}
    got = MonteCarloEngine(vega).fit_mocks(
        mocks, sample, max_iterations=want['max_iterations'], stats=stats)
    assert got['chisq'].dtype == np.float32
    assert sigma_off(got['values'], want['values'], want['errors']) \
        <= FIT_SIGMA
    assert within_ladder(got['chisq'], want['chisq'])
    np.testing.assert_array_equal(got['valid'], want['valid'])
    assert stats['iterations'] == [want['max_iterations']]
    ref = MonteCarloEngine(interfaces['grid', torch.float64]).fit_mocks(
        mocks, sample, max_iterations=want['max_iterations'])
    assert ref['valid'].all()
    assert sigma_off(got['values'], ref['values'], ref['errors']) \
        <= FIT_SIGMA
    assert within_ladder(got['chisq'], ref['chisq'])
    print(f'{kind}: valid {got["valid"].tolist()} (vega_tpu f32 '
          f'{want["valid"]}, max |g| at its fits {want["max_abs_gradient"]}'
          f'; vega_tpu f64 {TINY64["mocks"][kind]["valid"]})')


def test_generate_mocks_draw_in_f32(interfaces):
    """generate_mocks of an f32 interface: f32 mocks, fiducial + z L^T
    with z drawn in f32 (as vega_tpu draws jax.random.normal(...,
    jnp.float64), f32 under VEGA_TPU_X64=0), within f32 round-off of the
    same draw in f64 arithmetic."""
    vega = interfaces['grid', torch.float32]
    fiducial = vega.compute_model(tool.MC_PARAMS, run_init=False)
    got = MonteCarloEngine(vega).generate_mocks(fiducial, 3, seed=4)
    gen = torch.Generator().manual_seed(4)
    for name, data in vega.data.items():
        mask = data.data_mask
        chol = np.linalg.cholesky(data.cov_mat[np.ix_(mask, mask)])
        z = torch.randn((3, int(mask.sum())), generator=gen,
                        dtype=torch.float32).double().numpy()
        want = fiducial[name][mask][None] + z @ chol.T
        assert got[name].dtype == torch.float32
        assert np.max(np.abs(got[name].numpy() - want)) <= 1e-5 * np.max(
            np.abs(want))


def test_run_monte_carlo_matches_jax_f32(tiny, env):
    """The serial loop (seed 11, 2 mocks, [monte carlo]'s two names) on a
    fresh f32 interface against vega_tpu's f32: values within FIT_SIGMA
    of its errors, chi^2 within the ladder, valid equal."""
    env.setenv('VEGA_TPU_X64', '0')
    vega = VegaInterface(tiny, device='cpu')
    env.delenv('VEGA_TPU_X64')
    vega.monte_carlo = True
    vega.analysis.run_monte_carlo(vega.compute_model(run_init=False),
                                  num_mocks=tool.MC_MOCKS, seed=tool.MC_SEED)
    want = TINY32['run_monte_carlo']
    for param in NUISANCE:
        got = vega.analysis.mc_bestfits[param]
        ref = np.asarray(want['bestfits'][param])
        assert sigma_off(got[:, 0], ref[:, 0], ref[:, 1]) <= FIT_SIGMA
    assert within_ladder(vega.analysis.mc_chisq, want['chisq'])
    assert vega.analysis.mc_valid_minima == want['valid']


def test_initialize_monte_carlo_matches_jax_f32(tiny, env):
    """initialize_monte_carlo of an f32 interface (an initial f32 fit on
    its f32 payload, then one mock per correlation, mc_seed = 7): the
    masked mocks within 1e-2 of a bin's sigma of vega_tpu's f32 ones (the
    two initial fits agree to FIT_SIGMA), chi^2 against the mock at a
    point within the ladder, on the payload and on the nuisance collapse."""
    vega = VegaInterface(tiny, device='cpu', dtype=torch.float32)
    got = vega.initialize_monte_carlo()
    want = TINY32['initialize_monte_carlo']
    assert vega.monte_carlo
    for name, data in vega.data.items():
        mask = data.data_mask
        sigma = np.sqrt(np.diag(data.cov_mat))[mask]
        assert np.max(np.abs(got[name][mask] - want['mocks'][name])
                      / sigma) <= 1e-2
    assert within_ladder([vega.chi2(tool.POINT)], [want['chi2_point']])
    assert within_ladder([vega.chi2({n: tool.POINT[n] for n in NUISANCE})],
                         [want['chi2_nuisance']])


def test_no_f64_tensor_on_the_campaign_paths(interfaces):
    """The scan, the mock fits (dense and the collapse), the mocks' draw
    and the traceable log-likelihood of an f32 interface make no float64
    tensor (payloads and collapses built before, as
    tests/test_torch_f32_path.py holds the chi^2 itself)."""
    vega = interfaces['grid', torch.float32]
    fiducial = vega.compute_model(tool.MC_PARAMS, run_init=False)
    mocks = tool.numpy_mocks(vega, fiducial, 2, 1)
    axis = np.linspace(*tool.SCAN_AXIS)[:2]
    log_lik = BatchedLikelihood(vega).traceable_log_lik(NAMES)
    theta = torch.tensor([[1.0, 1.0, -0.117, 1.67]] * 3)
    samples = {names: tool.sample_subset(vega.sample_params, names)
               for names in (NAMES, NUISANCE)}
    for names in samples:
        vega.get_collapsed(names, with_data_terms=False)
    with F64Ops() as ops:
        batched_chi2_scan(vega, {'ap': axis, 'at': axis}, max_iterations=3)
        engine = MonteCarloEngine(vega)
        for sample in samples.values():
            engine.fit_mocks(mocks, sample, max_iterations=3)
        engine.generate_mocks(fiducial, 2, seed=1)
        log_lik(theta)
    assert ops.seen == {}


# ----------------------------------------------------------------------
# The Monte-Carlo scripts under VEGA_TPU_X64=0
# ----------------------------------------------------------------------
def monte_carlo_tables(path):
    return {hdu.name: hdu for hdu in read_fits(path)
            if getattr(hdu, 'name', '') and hasattr(hdu, 'columns')}


def test_mc_scripts_in_f32(tmp_path, env):
    """run_vega_mc (batched), run_vega_mc_fits on the mocks it wrote and
    `cli mc --sequential`, each under VEGA_TPU_X64=0 --device cpu on
    tests/test_torch_output.py's tiny Monte-Carlo configuration: each
    ends, its monte_carlo.fits reads back with the columns vega_tpu's f32
    run_vega_mc writes (names and dtypes), and the refit of the saved
    mocks gives the first fits (the same f32 mocks, the same fits)."""
    env.setenv('VEGA_TPU_X64', '0')
    main = tool.mc_script_config(tmp_path / 'mc', 'cpu')
    out = tmp_path / 'mc' / 'mc_out' / 'monte_carlo' / 'monte_carlo.fits'
    assert run_vega_mc.main([str(main), '--device', 'cpu']) == 0
    first = monte_carlo_tables(out)
    want = GOLDENS['tiny']['f32']['mc_script']
    assert {name: {c: str(np.asarray(hdu[c]).dtype) for c in hdu.columns}
            for name, hdu in first.items()} == want
    refit = with_control(main, f'mc_mocks = {out}', tmp_path / 'refit.ini')
    config = configparser.ConfigParser()
    config.optionxform = str
    config.read(refit)
    config['output']['filename'] = str(tmp_path / 'refit' / 'output')
    with open(refit, 'w') as fh:
        config.write(fh)
    assert run_vega_mc_fits.main([str(refit), '--device', 'cpu']) == 0
    again = monte_carlo_tables(tmp_path / 'refit' / 'monte_carlo' /
                               'monte_carlo.fits')
    for col in ('values', 'errors'):
        np.testing.assert_array_equal(again['Bestfit'][col],
                                      first['Bestfit'][col])
    assert cli.main(['mc', str(main), '--sequential', '--device', 'cpu']) == 0
    sequential = monte_carlo_tables(out)
    assert np.asarray(sequential['Bestfit']['values']).shape == \
        np.asarray(first['Bestfit']['values']).shape
    assert np.isfinite(np.asarray(sequential['Bestfit']['values'])).all()
    env.delenv('VEGA_TPU_X64')

"""Profile scans and Monte-Carlo mock fits of the PyTorch port (batched
exact derivatives, the batched Newton of vega_tpu_torch.parallel.batch,
batched_chi2_scan, MonteCarloEngine, Analysis, the Monte-Carlo half of
VegaInterface and Data) against the JAX package (vega_tpu), on the CPU.

One tiny synthetic auto+cross dataset with noise (seed 3), (ap, at,
bias_LYA, beta_LYA) sampled, 8 x 8 grid nodes, the exact f64 payload
contractions (ds-matmul = False) and a [monte carlo] section sampling
(bias_LYA, beta_LYA), made by vega_tpu; no payload disk cache.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vega_tpu.gridcollapse as jgc
from vega_tpu.parallel import batch as jbatch
from vega_tpu.statics import STATICS
from vega_tpu.testing import make_synthetic_dataset as jax_make_dataset
from vega_tpu.vega_interface import VegaInterface as JaxInterface
from vega_tpu_torch import gridcollapse as gc
from vega_tpu_torch.analysis import Analysis
from vega_tpu_torch.parallel import MonteCarloEngine, batched_chi2_scan
from vega_tpu_torch.parallel import batch as tbatch
from vega_tpu_torch.vega_interface import VegaInterface

NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')
NUISANCE = ('bias_LYA', 'beta_LYA')
SAMPLE = {'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
          'bias_LYA': '-1.0 0.0 -0.12 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1'}
MC_PARAMS = {'bias_LYA': -0.117, 'beta_LYA': 1.67}
CONTROL = ('grid-nodes-ap = 8\ngrid-nodes-at = 8\nds-matmul = False\n'
           'mc_seed = 7\n\n[monte carlo]\n'
           'bias_LYA = -1.0 0.0 -0.12 0.01\nbeta_LYA = 0.0 3.0 1.6 0.1\n\n'
           '[mc parameters]\n'
           + ''.join(f'{k} = {v}\n' for k, v in MC_PARAMS.items()))
# rows of the batched derivatives: inside the 8 x 8 node domain
ROWS = np.array([[1.03, 0.97, -0.12, 1.6], [0.9, 1.1, -0.11, 1.75],
                 [1.18, 0.85, -0.125, 1.52], [1.0, 1.0, -0.117, 1.67],
                 [0.95, 1.05, -0.119, 1.7]])

# chi^2, gradient and Hessian, relative to the largest entry of each
# (f64 both sides, sums ordered differently): as tests/
# test_torch_derivatives.py holds the single-point derivatives
RTOL = {'grid_payload': 1e-10, 'nuisance': 1e-10, 'dense': 1e-9}
SELF_RTOL = 1e-12       # the batch against the port's batch of one
ROW_RTOL = 1e-13        # a row against itself beside other rows
# fits (scan points, mocks) against vega_tpu's from the same start:
# values within FIT_SIGMA of their errors, errors within FIT_ERR_RTOL,
# chi^2 within FIT_CHI2_ABS (the goldens' tolerances in chip_smoke.py)
FIT_SIGMA, FIT_ERR_RTOL, FIT_CHI2_ABS = 1e-3, 1e-5, 1e-8


def max_rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_DS_MATMUL', '0')
        mp.setenv('VEGA_TPU_GRID_CACHE', '0')
        mp.delenv('VEGA_TPU_FACTORED', raising=False)
        mp.delenv('VEGA_TPU_GRID_COLLAPSE', raising=False)
        mp.delenv('VEGA_TPU_FIT_CHUNK_PER_DEVICE', raising=False)
        tmp = tmp_path_factory.mktemp('analysis')
        main = jax_make_dataset(tmp, cross=True, size='tiny', sample=SAMPLE,
                                seed=3, noise=1.0, extra_control=CONTROL)
        jax_vega = JaxInterface(main)
        jgc.save_payload(tmp / 'payload.npz', jax_vega.get_collapsed(NAMES))
        port = VegaInterface(main, device='cpu')
        port.use_grid_payload(NAMES, gc.load_payload(tmp / 'payload.npz'))
        with pytest.MonkeyPatch.context() as dense_mp:
            dense_mp.setenv('VEGA_TPU_FACTORED', '0')
            dense = VegaInterface(main, device='cpu')
        yield {'main': main, 'jax': jax_vega, 'port': port, 'dense': dense,
               'tmp': tmp}


def fresh_pair(main):
    """A new (vega_tpu, port) pair for tests that change an interface."""
    return JaxInterface(main), VegaInterface(main, device='cpu')


# ----------------------------------------------------------------------
# SPD helpers
# ----------------------------------------------------------------------
def test_spd_helpers_match_jax():
    """_spd_solve / _spd_inv against vega_tpu's unrolled Cholesky on a
    seeded batch of SPD matrices (1e-12 relative) and of indefinite ones
    (NaN in the same places, never an exception)."""
    rng = np.random.default_rng(0)
    m = rng.normal(size=(6, 4, 4))
    spd = m @ m.transpose(0, 2, 1) + 0.5 * np.eye(4)
    indefinite = spd.copy()
    indefinite[:3] -= 3.0 * np.eye(4) * np.linalg.eigvalsh(spd[:3])[:, -1:,
                                                                  None]
    b = rng.normal(size=(6, 4))
    for a in (spd, indefinite):
        got_x = tbatch._spd_solve(torch.as_tensor(a), torch.as_tensor(b))
        got_inv = tbatch._spd_inv(torch.as_tensor(a))
        # vega_tpu's helpers take one system (its Newton vmaps them)
        want_x = np.asarray(jax.vmap(jbatch._spd_solve)(jnp.asarray(a),
                                                        jnp.asarray(b)))
        want_inv = np.asarray(jax.vmap(jbatch._spd_inv)(jnp.asarray(a)))
        for got, want in ((got_x.numpy(), want_x),
                          (got_inv.numpy(), want_inv)):
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            ok = ~np.isnan(want)
            assert np.max(np.abs(got[ok] - want[ok])) <= 1e-12 * np.max(
                np.abs(want[ok]))
    assert np.isnan(got_x.numpy()[:3]).all()
    assert not np.isnan(got_x.numpy()[3:]).any()


def test_newton_ragged_last_chunk():
    """5 rows in chunks of 2 (the last padded with a copy of row 4): each
    row's fit equals its fit in one chunk (exactly), and stats count the
    real rows only. chi^2 = sum a (x - c)^2 per row; row 1 has a = 0 (a
    singular Hessian: not valid)."""
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.uniform(0.5, 2.0, size=(5, 2)))
    a[1] = 0.0
    c = torch.as_tensor(rng.normal(size=(5, 2)))

    def derivatives(x, chunk):
        d = x - chunk['c']
        return ((chunk['a'] * d ** 2).sum(-1), 2 * chunk['a'] * d,
                torch.diag_embed(2 * chunk['a']))

    x0 = torch.zeros(2, dtype=torch.float64)
    lo, hi = torch.full_like(x0, -np.inf), torch.full_like(x0, np.inf)
    runs = {}
    for chunk in (2, 5):
        stats = {}
        runs[chunk] = tbatch._newton_minimize_batched(
            derivatives, x0, lo, hi, {'a': a, 'c': c}, 20,
            chunk_per_device=chunk, stats=stats)
        assert len(stats['iterations']) == -(-5 // chunk)
        assert stats['valid_rows'] == 4
    for ragged, whole in zip(runs[2], runs[5]):
        np.testing.assert_array_equal(ragged.numpy(), whole.numpy())
    assert runs[2][4].tolist() == [True, False, True, True, True]
    np.testing.assert_allclose(runs[2][0][[0, 2, 3, 4]].numpy(),
                               c[[0, 2, 3, 4]].numpy(), rtol=0, atol=1e-12)


# ----------------------------------------------------------------------
# Batched exact derivatives
# ----------------------------------------------------------------------
def jax_batched(jax_vega, names, rows):
    """chi^2, gradient and Hessian of each row: jax.vmap of jax.grad /
    jax.hessian of vega_tpu's _chi2_graph_bound, as its batched Newton
    takes them."""
    jax_vega._ensure_static_refs()
    data_vecs = {k: jnp.asarray(v)
                 for k, v in jax_vega._current_data_vecs().items()}
    cov_scales = jax_vega._current_cov_scales()
    collapsed = jax_vega._device_collapsed(jax_vega.get_collapsed(names))
    statics = STATICS.device_tree()

    def f(x):
        return jax_vega._chi2_graph_bound(
            dict(zip(names, x)), data_vecs, cov_scales, statics,
            collapsed)[0]

    x = jnp.asarray(rows)
    return [np.asarray(jax.jit(jax.vmap(fn))(x))
            for fn in (f, jax.grad(f), jax.hessian(f))]


def regime_setup(setup, regime, monkeypatch):
    names = NUISANCE if regime == 'nuisance' else NAMES
    rows = ROWS[:, 2:] if regime == 'nuisance' else ROWS
    port = setup['dense' if regime == 'dense' else 'port']
    jax_vega = setup['jax']
    if regime == 'dense':
        monkeypatch.setenv('VEGA_TPU_FACTORED', '0')   # vega_tpu: at trace
        jax_vega = JaxInterface(setup['main'])
    return port, jax_vega, list(names), rows


@pytest.mark.parametrize('regime', list(RTOL))
def test_batched_derivatives_match_jax(setup, monkeypatch, regime):
    """chi2_batch_derivatives at B = 5 against vega_tpu's vmapped
    jax.grad / jax.hessian (RTOL) and against the port's own batch of
    one, chi2_value_and_gradient and chi2_hessian (SELF_RTOL)."""
    port, jax_vega, names, rows = regime_setup(setup, regime, monkeypatch)
    expected = {'grid_payload': {'__grid__', 'lyaxlya', 'qsoxlya'},
                'nuisance': {'lyaxlya', 'qsoxlya'}, 'dense': set()}[regime]
    assert set(port.get_collapsed(names)) == expected
    got = [t.numpy() for t in port.chi2_batch_derivatives(names, rows)]
    want = jax_batched(jax_vega, names, rows)
    assert [g.shape for g in got] == [(5,), (5, len(names)),
                                      (5, len(names), len(names))]
    for part, (g, w) in enumerate(zip(got, want)):
        for i in range(len(rows)):
            assert max_rel(g[i], w[i]) <= RTOL[regime], (part, i)
    for i, row in enumerate(rows):
        point = dict(zip(names, row))
        value, grad = port.chi2_value_and_gradient(point)
        hess = port.chi2_hessian(point, names)
        assert max_rel(got[0][i], value) <= SELF_RTOL
        assert max_rel(got[1][i], [grad[n] for n in names]) <= SELF_RTOL
        assert max_rel(got[2][i], [[hess[a][b] for b in names]
                                   for a in names]) <= SELF_RTOL


@pytest.mark.parametrize('regime', list(RTOL))
def test_rows_are_independent(setup, monkeypatch, regime):
    """A row's value, gradient and Hessian do not depend on the other
    rows of its batch (ROW_RTOL)."""
    port, _, names, rows = regime_setup(setup, regime, monkeypatch)
    base = port.chi2_batch_derivatives(names, rows)
    other = rows.copy()
    other[[0, 1, 3, 4]] = rows[[4, 3, 1, 0]] * (1 + 1e-3)
    moved = port.chi2_batch_derivatives(names, other)
    for b, m in zip(base, moved):
        assert max_rel(m[2].numpy(), b[2].numpy()) <= ROW_RTOL
    # and alone, in a batch of one
    alone = port.chi2_batch_derivatives(names, rows[2:3])
    for b, a in zip(base, alone):
        assert max_rel(a[0].numpy(), b[2].numpy()) <= ROW_RTOL


# ----------------------------------------------------------------------
# Scans
# ----------------------------------------------------------------------
def nuisance_sample(vega, beta_bounds=None):
    """vega's sample_params restricted to (bias_LYA, beta_LYA)."""
    sample = {key: {n: vega.sample_params[key][n] for n in NUISANCE}
              for key in ('limits', 'values', 'errors', 'fix')}
    if beta_bounds is not None:
        sample['limits']['beta_LYA'] = beta_bounds
    return sample


def assert_rows_match(got, want, scale=1.0):
    assert len(got) == len(want)
    for row_g, row_w in zip(got, want):
        assert set(row_g) == set(row_w)
        for name, value in row_w.items():
            tol = FIT_CHI2_ABS if name == 'fval' else 1e-6 * scale
            assert abs(row_g[name] - value) <= tol, (name, row_g, row_w)


SCAN_CASES = {
    # tests/test_batched_scan.py's cases, (bias_LYA, beta_LYA) sampled
    'bias_1d': lambda b0, beta0: {'bias_LYA': np.linspace(b0 * 1.02,
                                                          b0 * 0.98, 4)},
    'bias_1d_beta_pinned': lambda b0, beta0: {
        'bias_LYA': np.linspace(b0 * 1.02, b0 * 0.98, 4)},
    'bias_beta_2d': lambda b0, beta0: {
        'bias_LYA': np.linspace(b0 * 1.02, b0 * 0.98, 4)[:2],
        'beta_LYA': np.array([beta0 * 0.99, beta0 * 1.01])},
}


@pytest.mark.parametrize('case', list(SCAN_CASES))
def test_batched_scan_matches_jax(setup, case):
    """batched_chi2_scan against vega_tpu's on the same grids: fval
    within FIT_CHI2_ABS, free values within 1e-6 (their errors are
    ~1e-2); the pinned bound holds to 1e-9."""
    port, jax_vega = setup['port'], setup['jax']
    b0 = float(port.sample_params['values']['bias_LYA'])
    beta0 = float(port.sample_params['values']['beta_LYA'])
    bounds = ((0.5 * beta0, 0.9 * beta0) if case == 'bias_1d_beta_pinned'
              else None)
    grids = SCAN_CASES[case](b0, beta0)
    stats = {}
    got = batched_chi2_scan(port, grids, nuisance_sample(port, bounds),
                            max_iterations=30, stats=stats)
    want = jbatch.batched_chi2_scan(jax_vega, grids,
                                    nuisance_sample(jax_vega, bounds),
                                    max_iterations=30)
    assert_rows_match(got, want)
    assert len(stats['iterations']) == 1 and stats['sync_s'] >= 0
    if case == 'bias_1d_beta_pinned':
        assert all(row['beta_LYA'] == pytest.approx(0.9 * beta0, rel=1e-9)
                   for row in got)
    if case == 'bias_beta_2d':
        # C order, and pure evaluation: nothing is free
        assert got[0]['bias_LYA'] == got[1]['bias_LYA']
        assert got[0]['beta_LYA'] != got[1]['beta_LYA']
        assert stats['iterations'] == [0]
        for row in got:
            assert row['fval'] == pytest.approx(port.chi2(
                {n: row[n] for n in NUISANCE}), rel=1e-12)


def test_ap_at_scan_on_the_payload(setup):
    """A 2 x 2 (ap, at) scan, the nuisance re-minimised at each point
    on the grid payload, against vega_tpu's on the same payload."""
    grids = {'ap': np.array([0.98, 1.02]), 'at': np.array([0.97, 1.03])}
    got = batched_chi2_scan(setup['port'], grids, max_iterations=30)
    want = jbatch.batched_chi2_scan(setup['jax'], grids, max_iterations=30)
    assert_rows_match(got, want)


def test_analysis_scan_batched_serial_and_jax(setup):
    """Analysis.chi2_scan ([chi2 scan] bias_LYA, 3 points, ap, at and
    beta_LYA free on the payload): batched against serial (fval 1e-5
    relative, beta_LYA 1e-3, test_batched_scan.py's bounds) and against
    vega_tpu's batched scan."""
    port, jax_vega = setup['port'], setup['jax']
    b0 = float(port.sample_params['values']['bias_LYA'])
    scan = {'bias_LYA': f'{b0 * 1.01} {b0 * 0.99} 3'}
    for vega in (port, jax_vega):
        vega.main_config['chi2 scan'] = scan
        vega.main_config['control']['batched_scan'] = 'True'
    assert isinstance(port.analysis, Analysis)
    batched = port.analysis.chi2_scan()
    want = jax_vega.analysis.chi2_scan()
    port.main_config['control']['batched_scan'] = 'False'
    serial = port.analysis.chi2_scan()
    port.main_config['control']['batched_scan'] = 'True'
    assert_rows_match(batched, want)
    for row_b, row_s in zip(batched, serial):
        assert row_b['bias_LYA'] == row_s['bias_LYA']
        np.testing.assert_allclose(row_b['fval'], row_s['fval'],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(row_b['beta_LYA'], row_s['beta_LYA'],
                                   rtol=1e-3)


# ----------------------------------------------------------------------
# Monte Carlo
# ----------------------------------------------------------------------
def numpy_mocks(vega, fiducial, n_mocks, seed):
    """fid_masked + z @ L.T per correlation, z from
    np.random.default_rng(seed) in corr_items order (the goldens tool's
    draw)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, data in vega.data.items():
        mask = data.data_mask
        chol = np.linalg.cholesky(data.cov_mat[np.ix_(mask, mask)])
        z = rng.standard_normal((n_mocks, int(mask.sum())))
        out[name] = np.asarray(fiducial[name])[mask] + z @ chol.T
    return out


def assert_fits_match(got, want):
    assert list(got['names']) == list(want['names'])
    d_sigma = np.abs(got['values'] - want['values']) / want['errors']
    assert np.max(d_sigma) <= FIT_SIGMA
    assert np.max(np.abs(got['errors'] / want['errors'] - 1)) <= FIT_ERR_RTOL
    assert np.max(np.abs(got['chisq'] - want['chisq'])) <= FIT_CHI2_ABS
    np.testing.assert_array_equal(got['valid'], want['valid'])
    assert got['valid'].all()


@pytest.mark.parametrize('sampled', ['collapse', 'dense'])
def test_fit_mocks_match_jax(setup, sampled):
    """MonteCarloEngine.fit_mocks on 3 identical numpy mocks against
    vega_tpu's: (bias_LYA, beta_LYA) through the nuisance collapse
    without data terms, (ap, at, bias_LYA, beta_LYA) on the dense
    path."""
    port, jax_vega = setup['port'], setup['jax']
    fiducial = jax_vega.compute_model(MC_PARAMS, run_init=False)
    mocks = numpy_mocks(port, fiducial, 3, seed=5)
    sample = (nuisance_sample(port) if sampled == 'collapse'
              else port.sample_params)
    names = list(sample['limits'])
    assert set(port.get_collapsed(names, with_data_terms=False)) == (
        {'lyaxlya', 'qsoxlya'} if sampled == 'collapse' else set())
    stats = {}
    got = MonteCarloEngine(port).fit_mocks(mocks, sample, stats=stats)
    want = jbatch.MonteCarloEngine(jax_vega).fit_mocks(
        mocks, copy.deepcopy(sample))
    assert_fits_match(got, want)
    assert stats['iterations'][0] > 0


def test_generate_mocks_is_fid_plus_z_lt(setup):
    """generate_mocks: fiducial + z L^T per correlation, z drawn in
    corr_items order from a generator seeded with `seed`."""
    port = setup['port']
    fiducial = port.compute_model(MC_PARAMS, run_init=False)
    got = MonteCarloEngine(port).generate_mocks(fiducial, 4, seed=21)
    gen = torch.Generator().manual_seed(21)
    for name, data in port.data.items():
        mask = data.data_mask
        chol = np.linalg.cholesky(data.cov_mat[np.ix_(mask, mask)])
        z = torch.randn((4, int(mask.sum())), generator=gen,
                        dtype=torch.float64)
        want = fiducial[name][mask][None] + z.numpy() @ chol.T
        assert got[name].shape == (4, mask.sum())
        np.testing.assert_allclose(got[name].numpy(), want, rtol=1e-14,
                                   atol=1e-14 * np.max(np.abs(want)))


def test_run_monte_carlo_matches_jax(setup):
    """The serial loop, seed 11, fitting [monte carlo]'s (bias_LYA,
    beta_LYA) on each mock: the mocks equal vega_tpu's (both draw from
    the numpy global RNG; 1e-12 relative, the fiducials' round-off) and
    so do the fits."""
    jax_vega, port = fresh_pair(setup['main'])
    results = []
    for vega in (jax_vega, port):
        fiducial = (vega.compute_model(run_init=False) if vega is jax_vega
                    else vega.compute_model(run_init=False))
        vega.monte_carlo = True
        vega.analysis.run_monte_carlo(fiducial, num_mocks=2, seed=11)
        results.append(vega.analysis)
    want, got = results
    for name in port.corr_items:
        w, g = np.array(want.mc_mocks[name]), np.array(got.mc_mocks[name])
        assert g.shape == w.shape == (2, port.data[name].full_data_size)
        ok = ~np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), ~ok)
        assert max_rel(g[ok], w[ok]) <= 1e-12
    for param in NUISANCE:
        g, w = got.mc_bestfits[param], want.mc_bestfits[param]
        assert np.all(np.abs(g[:, 0] - w[:, 0]) <= FIT_SIGMA * w[:, 1])
        np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=FIT_ERR_RTOL)
    np.testing.assert_allclose(got.mc_chisq, want.mc_chisq, rtol=1e-6)
    assert got.mc_valid_minima == want.mc_valid_minima == [True, True]


def test_initialize_monte_carlo_matches_jax(setup):
    """initialize_monte_carlo (an initial fit on the payload, then one
    mock per correlation with mc_seed = 7): the mocks agree with
    vega_tpu's (to the fits' agreement, 1e-3 of an error), and so does
    chi^2 at a point on the payload, rebuilt for the mock (within the
    2e-4 mode budget) and on the nuisance collapse (1e-6 relative); the
    log-likelihood's normalisation is the same."""
    jax_vega, port = fresh_pair(setup['main'])
    want_mocks = jax_vega.initialize_monte_carlo()
    got_mocks = port.initialize_monte_carlo()
    assert port.monte_carlo and port.minimizer._names == list(NUISANCE)
    for name, data in port.data.items():
        mask = data.data_mask
        assert np.isnan(got_mocks[name][~mask]).all()
        scale = np.sqrt(np.diag(data.cov_mat))[mask]
        assert np.max(np.abs(got_mocks[name][mask] - want_mocks[name][mask])
                      / scale) <= 1e-3
    point = {'ap': 1.01, 'at': 0.99, 'bias_LYA': -0.118, 'beta_LYA': 1.65}
    assert abs(port.chi2(point) - jax_vega.chi2(point)) <= 2e-4 + 1e-9 * abs(
        jax_vega.chi2(point))
    nuisance = {n: point[n] for n in NUISANCE}
    assert max_rel(port.chi2(nuisance), jax_vega.chi2(nuisance)) <= 1e-6
    assert port._log_norm() == pytest.approx(jax_vega._log_norm(),
                                             rel=1e-12)


def test_forecast_mock_is_the_fiducial(setup, monkeypatch):
    """forecast = True: the mock is the fiducial, so chi^2 at the
    fiducial's parameters is 0 (dense path)."""
    monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
    port = VegaInterface(setup['main'], device='cpu')
    port.main_config['control']['forecast'] = 'True'
    fits = []
    initial_fit = port.minimize

    def minimize():
        initial_fit()
        fits.append(port.bestfit.values)

    port.minimize = minimize
    port.initialize_monte_carlo()
    assert port.chi2(fits[0] | MC_PARAMS) == pytest.approx(0.0, abs=1e-10)


def test_mc_start_from_fit_is_not_ported(setup):
    """mc_start_from_fit is ported: the fiducial is the model at a saved
    fit's values under [mc parameters] (its parity with vega_tpu is in
    tests/test_torch_output.py); with use_full_pk_for_mc it is
    compute_direct's at the best fit's values (its parity with vega_tpu
    is in tests/test_torch_likelihood_options.py)."""
    port = VegaInterface(setup['main'], device='cpu')
    port.use_grid_payload(NAMES, gc.load_payload(setup['tmp']
                                                 / 'payload.npz'))
    port.minimize()
    port.output.outfile = str(setup['tmp'] / 'start_fit')
    port.output.write_results(port.bestfit_model, port.params,
                              port.minimizer, port.bestfit_corr_stats)
    port.main_config['control']['mc_start_from_fit'] = \
        port.output.outfile + '.fits'
    fiducial = port.get_fiducial_for_monte_carlo()
    want = port.compute_model(port.minimizer.values | MC_PARAMS,
                              run_init=False)
    for name in port.corr_items:
        assert np.array_equal(fiducial[name], want[name])
    port.main_config.remove_option('control', 'mc_start_from_fit')
    port.main_config['control']['use_full_pk_for_mc'] = 'True'
    fiducial = port.get_fiducial_for_monte_carlo()
    want = port.compute_model(port.bestfit.values | MC_PARAMS,
                              run_init=False,
                              direct_pk=port.fiducial['pk_full'])
    for name in port.corr_items:
        assert np.array_equal(fiducial[name], want[name])
    # the global mock is ported; it needs a global covariance
    with pytest.raises(ValueError, match='global covariance'):
        port.analysis.create_global_monte_carlo({})


# ----------------------------------------------------------------------
# What a new data vector must reach: the collapse caches, the grid
# payload, the dense path's device copy; the no-data-terms collapse on
# the device; the [monte carlo] limits of a grid dimension
# ----------------------------------------------------------------------
@pytest.mark.parametrize('regime', ['grid', 'nuisance', 'dense'])
def test_chi2_follows_the_data_vector(setup, monkeypatch, regime):
    """chi^2 after the data vector is replaced differs from before and
    equals vega_tpu's with the same vector: on the grid payload (rebuilt
    by both; the 2e-4 mode budget), the nuisance collapse (1e-10
    relative) and the dense path (1e-9)."""
    if regime == 'dense':
        monkeypatch.setenv('VEGA_TPU_FACTORED', '0')
    jax_vega, port = fresh_pair(setup['main'])
    point = dict(zip(NAMES, ROWS[1]))
    if regime == 'nuisance':
        point = {n: point[n] for n in NUISANCE}
    before = port.chi2(point)
    rng = np.random.default_rng(8)
    for name in port.corr_items:
        d = port.data[name]
        new = d.masked_data_vec + 0.3 * np.sqrt(np.diag(d.inv_masked_cov)
                                                ) ** -1 * rng.normal(
            size=d.data_size)
        d.masked_data_vec = new
        jax_vega.data[name]._masked_data_vec = new.copy()
    after, want = port.chi2(point), jax_vega.chi2(point)
    assert abs(after - before) > 1.0
    if regime == 'grid':
        assert abs(after - want) <= 2e-4 + 1e-9 * abs(want)
    else:
        assert max_rel(after, want) <= RTOL[regime]


def test_no_data_terms_collapse_reaches_the_device(setup):
    """The nuisance collapse without its data terms (W, m0: the data
    vector enters per evaluation) gives the chi^2 of the collapse with
    them, for the current data vector and for per-row vectors."""
    port = setup['port']
    names = frozenset(NUISANCE)
    raw = port.get_collapsed(names, with_data_terms=False)
    assert set(raw) == {'lyaxlya', 'qsoxlya'} and 'y' not in raw['lyaxlya']
    local, n_b = port._batch_params(
        {'bias_LYA': ROWS[:, 2], 'beta_LYA': ROWS[:, 3]})
    with torch.no_grad():
        got = port._chi2_rows(local, n_b, names=names, collapsed=raw)
        rows = {n: v.expand(n_b, -1)
                for n, v in port._device_data_vecs().items()}
        per_row = port._chi2_rows(local, n_b, names=names, collapsed=raw,
                                  data_vecs=rows)
    want = port.chi2_batch({'bias_LYA': ROWS[:, 2],
                            'beta_LYA': ROWS[:, 3]}).numpy()
    assert max_rel(got.numpy(), want) <= 1e-10
    assert max_rel(per_row.numpy(), want) <= 1e-10
    with pytest.raises(ValueError, match='per-row data vectors'):
        port._chi2_rows(local, n_b, names=names,
                        collapsed=port.get_collapsed(names), data_vecs=rows)


def test_grid_domain_falls_back_to_monte_carlo_limits(setup):
    """A grid parameter sampled only under [monte carlo] takes its domain
    from there, as vega_tpu's does."""
    jax_vega, port = fresh_pair(setup['main'])
    for vega in (jax_vega, port):
        del vega.sample_params['limits']['ap']
        vega.mc_config['sample']['limits']['ap'] = (0.9, 1.1)
    assert port._grid_dim_setup('ap') == jax_vega._grid_dim_setup('ap')
    assert port._grid_dim_setup('ap')[:2] == (0.9, 1.1)

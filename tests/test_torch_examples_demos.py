"""The port's counterparts of tutorials 03-06, the Monte-Carlo demo and
the synthetic end-to-end tutorial (examples/tutorials_torch/,
examples/Monte_carlo_sims/run_mc_demo_torch.py,
examples/synthetic_tutorial_torch.py) run with --device cpu against the
JAX package's numbers, committed in
tests/data/torch_port_examples_goldens.json by
tests/tools/make_torch_port_examples_goldens.py. Deterministic numbers
(chi^2, fits, scans, model sensitivities) are held at the port's f64
gates; the samplers' and the Monte-Carlo campaigns' draws differ between
the packages (torch's generators are not jax.random), so those are held
at statistical gates, and the demo at its own pull gate (|mean pull| <
0.5, asserted by the script). Tutorial 06 runs with fewer live points,
chains, samples and mocks than its own (its arguments), to stay within
the CPU tests' time.
"""

import torch_threads  # noqa: F401  (one torch thread per test process)
import json
from pathlib import Path

import numpy as np

from test_torch_examples import (CHI2_RTOL, FIT_CHI2_ABS, FIT_ERR_RTOL,
                                 FIT_SIGMA, rel, run_example)

REPO = Path(__file__).resolve().parents[1]
GOLDENS = json.loads((REPO / 'tests' / 'data'
                      / 'torch_port_examples_goldens.json').read_text())
SENSITIVITY_RTOL = 1e-9  # exact partials, tests/test_torch_sensitivity.py
WEDGE_RTOL = 1e-8        # wedge means of the data and of the fitted model
# Hessian errors of mock fits, averaged over a campaign: each mock's
# error depends on its draw only through the curvature at its minimum
# (through the Kaiser term, on its fitted beta), a few parts in 1e3 over
# campaigns of the same size, and a few percent between tutorial 06's
# 16 mocks here and vega_tpu's 32
MOCK_ERROR_RTOL = 1e-2
CAMPAIGN_ERROR_RTOL = 5e-2


def test_tutorial_03_wedges():
    got = run_example('tutorials_torch/03_plots.py', '--size', 'tiny')
    want = GOLDENS['tutorial_03']
    for key in want:
        assert rel(got[key], want[key]) <= WEDGE_RTOL, key


def test_tutorial_04_fit_results():
    """The results file read back: the best fit at vega_tpu's (abs
    FIT_CHI2_ABS of the noiseless truth) and its chi^2 and PTE."""
    got = run_example('tutorials_torch/04_fit_results_and_output.py',
                      '--size', 'tiny')
    want = GOLDENS['tutorial_04']
    assert got['params'].keys() == want['params'].keys()
    for name, value in want['params'].items():
        assert abs(got['params'][name] - value) <= 1e-6 * abs(value)
    assert abs(got['chisq'] - want['chisq']) <= FIT_CHI2_ABS
    assert abs(got['p_value'] - want['p_value']) <= 1e-12
    assert got['model_shape'] == want['model_shape']


def test_tutorial_05_sensitivity_and_scan():
    got = run_example('tutorials_torch/05_sensitivity_and_scans.py')
    want = GOLDENS['tutorial_05']
    assert got['partial_shape'] == want['partial_shape']
    assert got['fisher_shape'] == want['fisher_shape']
    assert rel(got['partial_norm'], want['partial_norm']) <= \
        SENSITIVITY_RTOL
    assert rel(got['fisher_sum'], want['fisher_sum']) <= SENSITIVITY_RTOL
    assert len(got['scan']) == len(want['scan'])
    for row_g, row_w in zip(got['scan'], want['scan']):
        assert row_g['bias_LYA'] == row_w['bias_LYA']
        assert abs(row_g['fval'] - row_w['fval']) <= FIT_CHI2_ABS
        assert abs(row_g['beta_LYA'] - row_w['beta_LYA']) <= 1e-6
    assert got['best_bias'] == want['best_bias']


def test_tutorial_06_samplers_and_batching():
    """The 64 sharded chi^2 values as vega_tpu's (CHI2_RTOL); NS's
    evidence within 3 of the two runs' errors combined and its posterior
    mean within half of vega_tpu's HMC posterior width; HMC's mean
    within half that width and its width within 30%; every mock fit
    valid, the campaign's mean within 3 standard errors of the truth and
    its mean Hessian errors within CAMPAIGN_ERROR_RTOL of vega_tpu's."""
    got = run_example('tutorials_torch/06_samplers_and_batching.py',
                      '--num-live', '50', '--hmc-chains', '8',
                      '--hmc-samples', '150', '--hmc-warmup', '100',
                      '--mocks', '16')
    want = GOLDENS['tutorial_06']
    assert np.max(np.abs(np.subtract(got['chi2'], want['chi2']))
                  / np.abs(want['chi2'])) <= CHI2_RTOL
    width = np.asarray(want['hmc_std'])
    assert abs(got['ns_logz'] - want['ns_logz']) <= 3 * np.hypot(
        got['ns_logz_err'], want['ns_logz_err'])
    assert np.all(np.abs(np.subtract(got['ns_mean'], want['ns_mean']))
                  <= 0.5 * width)
    assert np.all(np.abs(np.subtract(got['hmc_mean'], want['hmc_mean']))
                  <= 0.5 * width)
    assert np.all(np.abs(np.asarray(got['hmc_std']) / width - 1) <= 0.3)
    assert got['hmc_accept'] > 0.5 and got['hmc_r_hat'] < 1.1
    assert got['mc_valid'] == 16
    errors = np.asarray(got['mc_errors'])
    assert np.all(np.abs(np.subtract(got['mc_mean'], got['truth']))
                  <= 3 * errors / np.sqrt(16))
    assert np.all(np.abs(errors / want['mc_errors'] - 1)
                  <= CAMPAIGN_ERROR_RTOL)


def test_mc_demo(capsys):
    """The demo at its own settings: 'MC demo OK' (its pull gate), every
    fit valid, the mean errors within MOCK_ERROR_RTOL of vega_tpu's."""
    got = run_example('Monte_carlo_sims/run_mc_demo_torch.py')
    want = GOLDENS['mc_demo']
    assert 'MC demo OK' in capsys.readouterr().out
    assert got['valid'] == want['valid'] == 32
    assert abs(got['pull_mean']) < 0.5
    assert np.all(np.abs(np.asarray(got['errors']) / want['errors'] - 1)
                  <= MOCK_ERROR_RTOL)


def test_synthetic_tutorial(tmp_path):
    """log L at the truth and the grid's chi^2 (CHI2_RTOL), the fit
    (FIT_SIGMA, FIT_ERR_RTOL) as vega_tpu's on the same noisy dataset;
    the mock fits' mean errors within MOCK_ERROR_RTOL."""
    got = run_example('synthetic_tutorial_torch.py', str(tmp_path))
    want = GOLDENS['synthetic_tutorial']
    assert rel(got['log_lik'], want['log_lik']) <= CHI2_RTOL
    assert np.max(np.abs(np.subtract(got['chi2_grid'], want['chi2_grid']))
                  / np.abs(want['chi2_grid'])) <= CHI2_RTOL
    for name, value in want['values'].items():
        error = want['errors'][name]
        assert abs(got['values'][name] - value) <= FIT_SIGMA * error
        assert rel(got['errors'][name], error) <= FIT_ERR_RTOL
    assert np.all(np.abs(np.asarray(got['mock_errors'])
                         / want['mock_errors'] - 1) <= MOCK_ERROR_RTOL)
    assert (tmp_path / 'output.fits').is_file()

"""Write tests/data/torch_port_examples_goldens.json: the numbers of the
JAX package's (vega_tpu) examples and tutorials on the CPU (8 virtual
devices, as tests/conftest.py sets them), which
tests/test_torch_examples.py and tests/test_torch_examples_demos.py hold
the port's counterparts (examples/**/*_torch.py) against.

- tutorials 01, 02 and 04: examples/tutorials/0*.py run as they are,
  with vega_tpu.testing.make_synthetic_dataset made to write the tiny
  dataset (their own is the full one, too slow for the CPU tests; the
  port's scripts take --size tiny);
- tutorial 03: its wedge at the tiny dataset's 10 x 10 bins (the
  original's 50 x 50 binning does not fit the tiny grid), after its fit;
- tutorials 05, 06 and 07, run_mc_demo.py: run as they are, at their own
  settings;
- synthetic_tutorial.py: its steps, as its main() runs them (main keeps
  its numbers to itself);
- eBOSS_DR16/run_synthetic.py: its functions at nt = 12, as
  tests/test_dr16_example.py calls them (the combined fit and its
  global-covariance variant).
The values are read from the scripts' globals (runpy) or returned by the
functions; the tool's own run time is kept too.

Usage (from the repo root):
    JAX_PLATFORMS=cpu python tests/tools/make_torch_port_examples_goldens.py
"""

from __future__ import annotations

import importlib.util
import json
import os
import runpy
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_examples_goldens.json'
EXAMPLES = REPO / 'examples'
DR16_NT = 12

os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                           + ' --xla_force_host_platform_device_count=8')
os.environ['VEGA_TPU_COMP_CACHE'] = '0'
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

import matplotlib  # noqa: E402
import numpy as np  # noqa: E402

matplotlib.use('Agg')


def floats(mapping):
    return {str(k): float(v) for k, v in mapping.items()}


def minimizer(best):
    return {'values': floats(best.values), 'errors': floats(best.errors),
            'fval': float(best.fmin.fval), 'valid': bool(best.fmin.is_valid)}


def run_tutorial(name, tiny=False):
    """Globals of examples/tutorials/<name> run as __main__."""
    import vega_tpu.testing as testing
    original = testing.make_synthetic_dataset

    def tiny_dataset(*args, **kwargs):
        kwargs['size'] = 'tiny'
        return original(*args, **kwargs)
    if tiny:
        testing.make_synthetic_dataset = tiny_dataset
    try:
        sys.argv = [name]
        return runpy.run_path(str(EXAMPLES / 'tutorials' / name),
                              run_name='__main__')
    finally:
        testing.make_synthetic_dataset = original


def tutorial_01():
    g = run_tutorial('01_getting_started.py', tiny=True)
    return {'chi2': float(g['chi2']), 'log_lik': float(g['loglik']),
            'model_mean': {n: float(np.mean(cf))
                           for n, cf in g['model_cf'].items()},
            **minimizer(g['best']),
            'covariance': float(g['best'].covariance[('bias_LYA',
                                                      'beta_LYA')])}


def tutorial_02():
    g = run_tutorial('02_model_components.py', tiny=True)
    model = g['model']
    return {'pk_stages': sorted(model.pk['peak'].keys()),
            'xi_stages': sorted(model.xi['smooth'].keys()),
            'pk_peak_mean': float(np.mean(g['pk_peak'])),
            'xi_dist_mean': float(np.mean(g['xi_dist'])),
            'peak_plus_smooth_is_full': bool(np.allclose(g['recon'],
                                                         g['full'])),
            'direct_mean': float(np.mean(g['direct']['lyaxlya']))}


def tutorial_03():
    from vega_tpu.plots.wedges import Wedge
    from vega_tpu.testing import make_synthetic_dataset
    from vega_tpu.vega_interface import VegaInterface
    with tempfile.TemporaryDirectory() as work:
        vega = VegaInterface(make_synthetic_dataset(work, cross=False,
                                                    size='tiny'))
        vega.minimize()
        model = vega.compute_model(vega.bestfit.values, run_init=False)
        data = vega.data['lyaxlya']
        wedge = Wedge(mu=(0.5, 1.0), rp=(0., 200., 10), rt=(0., 200., 10),
                      r=(0., 180., 9))
        r, xi_w, cov_w = wedge(data.data_vec, data.cov_mat)
        r_m, xi_m, _ = wedge(np.asarray(model['lyaxlya']), data.cov_mat)
        return {'wedge_data_mean': float((xi_w * r ** 2).mean()),
                'wedge_model_mean': float((xi_m * r_m ** 2).mean()),
                'wedge_sigma_mean': float((cov_w.diagonal() ** 0.5).mean())}


def tutorial_04():
    g = run_tutorial('04_fit_results_and_output.py', tiny=True)
    results = g['results']
    return {'params': floats(results.params),
            'chisq': float(results.chisq),
            'p_value': float(results.p_value),
            'model_shape': list(g['corr'].model.shape)}


def tutorial_05():
    g = run_tutorial('05_sensitivity_and_scans.py')
    return {'partial_shape': list(np.shape(g['part'])),
            'partial_norm': float(np.linalg.norm(g['part'])),
            'fisher_shape': list(np.shape(g['fisher'])),
            'fisher_sum': float(np.nansum(g['fisher'])),
            'scan': [floats(row) for row in g['results']],
            'best_bias': float(g['best']['bias_LYA'])}


def tutorial_06():
    g = run_tutorial('06_samplers_and_batching.py')
    hmc = g['hmc_results']
    fits = g['fits']
    return {'chi2': np.asarray(g['chi2']).tolist(),
            'ns_logz': float(g['ns_results']['logz']),
            'ns_logz_err': float(g['ns_results']['logz_err']),
            'ns_mean': np.asarray(g['mean']).tolist(),
            'hmc_accept': float(hmc['accept_rate']),
            'hmc_r_hat': float(np.max(hmc['r_hat'])),
            'hmc_mean': np.asarray(hmc['samples']).mean(0).tolist(),
            'hmc_std': np.asarray(hmc['samples']).std(0).tolist(),
            'mc_valid': int(np.sum(fits['valid'])),
            'mc_mean': np.asarray(fits['values']).mean(0).tolist(),
            'mc_std': np.asarray(fits['values']).std(0).tolist(),
            'mc_errors': np.asarray(fits['errors']).mean(0).tolist()}


def mc_demo():
    sys.argv = ['run_mc_demo.py']
    g = runpy.run_path(str(EXAMPLES / 'Monte_carlo_sims' / 'run_mc_demo.py'),
                       run_name='__main__')
    results, valid = g['results'], g['results']['valid']
    truth = [g['vega'].params[n] for n in results['names']]
    return {'valid': int(valid.sum()),
            'pull_mean': float(np.mean((results['values'][valid] - truth)
                                       / results['errors'][valid])),
            'errors': np.asarray(results['errors']).mean(0).tolist(),
            'truth': [float(t) for t in truth]}


def synthetic_tutorial():
    """examples/synthetic_tutorial.py's steps (its main keeps its
    numbers), its plots left out."""
    from vega_tpu.parallel import BatchedLikelihood, MonteCarloEngine
    from vega_tpu.testing import make_synthetic_dataset
    from vega_tpu.vega_interface import VegaInterface
    with tempfile.TemporaryDirectory() as work:
        main_path = make_synthetic_dataset(work, cross=True, noise=1.0,
                                           size='tiny', seed=12)
        vega = VegaInterface(main_path)
        log_lik = vega.log_lik({'bias_LYA': -0.117, 'beta_LYA': 1.67})
        vega.minimize()
        bias_grid = np.linspace(-0.14, -0.10, 16)
        chi2_grid = BatchedLikelihood(vega).chi2(
            {'bias_LYA': bias_grid, 'beta_LYA': np.full(16, 1.67)})
        engine = MonteCarloEngine(vega)
        fiducial = vega.compute_model(vega.bestfit.values, run_init=False)
        mocks = engine.generate_mocks(fiducial, num_mocks=8, seed=0)
        results = engine.fit_mocks(mocks, sample_params={
            'limits': {'bias_LYA': (-1.0, 0.0), 'beta_LYA': (0.5, 3.0)},
            'values': dict(vega.bestfit.values),
            'errors': {'bias_LYA': 0.01, 'beta_LYA': 0.1},
            'fix': {'bias_LYA': False, 'beta_LYA': False},
        }, max_iterations=10)
        return {'log_lik': float(log_lik),
                'values': floats(vega.bestfit.values),
                'errors': floats(vega.bestfit.errors),
                'chi2_grid': np.asarray(chi2_grid).tolist(),
                'mock_scatter': float(results['values'][:, 0].std()),
                'mock_errors': np.asarray(results['errors']).mean(0).tolist()}


def run_synthetic():
    spec = importlib.util.spec_from_file_location(
        'dr16_run_synthetic', EXAMPLES / 'eBOSS_DR16' / 'run_synthetic.py')
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        mains = ex.build_configs(work, DR16_NT)
        ex.regenerate_from_truth(work, mains['combined'], DR16_NT)
        out = {}
        values, errors = ex.run_fit('combined', mains['combined'])
        out['combined'] = {'values': floats(values), 'errors': floats(errors)}
        gcov = ex.make_global_cov(work, mains['combined'])
        gmains = ex.build_configs(
            work, DR16_NT, extension='gcov', global_cov_file=gcov,
            fit_types={'combined': ex.FIT_TYPES['combined']})
        values, errors = ex.run_fit('combined-globalcov', gmains['combined'])
        out['combined-globalcov'] = {'values': floats(values),
                                     'errors': floats(errors)}
        return out


def main():
    t_start = time.perf_counter()
    out = {}
    for name, fn in (('tutorial_01', tutorial_01),
                     ('tutorial_02', tutorial_02),
                     ('tutorial_03', tutorial_03),
                     ('tutorial_04', tutorial_04),
                     ('tutorial_05', tutorial_05),
                     ('tutorial_06', tutorial_06),
                     ('tutorial_07', lambda: {'chi2': float(run_tutorial(
                         '07_config_creation.py')['chi2'])}),
                     ('mc_demo', mc_demo),
                     ('synthetic_tutorial', synthetic_tutorial),
                     ('run_synthetic', run_synthetic)):
        t0 = time.perf_counter()
        out[name] = fn()
        print(f'{name}: {time.perf_counter() - t0:.1f} s', flush=True)
    out['dr16_nt'] = DR16_NT
    out['tool_seconds'] = time.perf_counter() - t_start
    OUT.write_text(json.dumps(out, indent=1) + '\n')
    print(f'wrote {OUT} in {out["tool_seconds"]:.1f} s')


if __name__ == '__main__':
    main()

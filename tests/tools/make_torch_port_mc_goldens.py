"""Write tests/data/torch_port_mc_goldens.json: the JAX package's
(vega_tpu) profile scan and Monte-Carlo mock fits on the CPU, on the full
synthetic auto+cross configuration with (ap, at, bias_LYA, beta_LYA)
sampled and the exact f64 payload contractions (VEGA_TPU_DS_MATMUL=0):

- scan: parallel.batched_chi2_scan over (ap, at) at the 16 points
  AXIS[{0, 13, 26, 39}]^2 of the 40 x 40 grid AXIS = linspace(0.95, 1.05,
  40) (passed as the grids themselves), bias_LYA and beta_LYA
  re-minimised at each on the grid payload (the defaults: 32 x 32
  nodes); with each point's errors of the free parameters, from the
  Hessian there (cov = 2 H^-1), for the tolerances;
- mc: parallel.MonteCarloEngine.fit_mocks on N_MOCKS mocks per sample
  set, the configuration with [monte carlo] (the four names, as [sample])
  and [mc parameters] (the defaults): (ap, at, bias_LYA, beta_LYA) on the
  dense path and (bias_LYA, beta_LYA) on the nuisance collapse. The mocks
  are drawn with numpy, np.random.default_rng(seed) per correlation in
  corr_items order, as fid_masked + z @ L.T (L the Cholesky factor of the
  masked covariance, fid the JAX compute_model at [mc parameters]); the
  file keeps the seed and the fits, not the mocks;
- the tool's own run time.

The PyTorch port is held against these numbers on the GPU by
chip_smoke.py (its scan and MC phases), which builds the same
configuration (SAMPLE, MC_CONTROL) and draws the same z from each seed.

Usage (from the repo root; rows are independent, so any fit chunk):
    JAX_PLATFORMS=cpu VEGA_TPU_FIT_CHUNK_PER_DEVICE=1 \\
        python tests/tools/make_torch_port_mc_goldens.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / 'tests' / 'data' / 'torch_port_mc_goldens.json'

NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')
NUISANCE = ('bias_LYA', 'beta_LYA')
# [sample] entries: lower, upper, start, error (the fit goldens' own)
SAMPLE = {'ap': '0.5 1.5 1.02 0.02', 'at': '0.5 1.5 0.98 0.03',
          'bias_LYA': '-1.0 0.0 -0.12 0.01', 'beta_LYA': '0.0 3.0 1.6 0.1'}
MC_PARAMS = {'ap': 1.0, 'at': 1.0, 'bias_LYA': -0.117, 'beta_LYA': 1.67}
MC_CONTROL = ('\n[monte carlo]\n'
              + ''.join(f'{k} = {v}\n' for k, v in SAMPLE.items())
              + '\n[mc parameters]\n'
              + ''.join(f'{k} = {v}\n' for k, v in MC_PARAMS.items()))
AXIS_POINTS, AXIS_LO, AXIS_HI = 40, 0.95, 1.05
SCAN_INDICES = (0, 13, 26, 39)
N_MOCKS = 4
SEEDS = {'dense': 20261016, 'collapse': 20261017}


def numpy_mocks(vega, fiducial, n_mocks, seed):
    """{name: (n_mocks, n_masked)}: fid_masked + z @ L.T, z from
    np.random.default_rng(seed) in corr_items order."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, data in vega.data.items():
        mask = data.data_mask
        chol = np.linalg.cholesky(data.cov_mat[np.ix_(mask, mask)])
        z = rng.standard_normal((n_mocks, int(mask.sum())))
        out[name] = np.asarray(fiducial[name])[mask] + z @ chol.T
    return out


def sample_subset(sample_params, names):
    return {key: {n: sample_params[key][n] for n in names}
            for key in ('limits', 'values', 'errors', 'fix')}


def main():
    t_start = time.perf_counter()
    os.environ['VEGA_TPU_DS_MATMUL'] = '0'
    os.environ['VEGA_TPU_GRID_CACHE'] = '0'
    os.environ.pop('VEGA_TPU_FACTORED', None)
    os.environ.pop('VEGA_TPU_GRID_COLLAPSE', None)
    sys.path.insert(0, str(REPO))
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from vega_tpu.parallel import MonteCarloEngine, batched_chi2_scan
    from vega_tpu.testing import make_synthetic_dataset
    from vega_tpu.vega_interface import VegaInterface

    axis = np.linspace(AXIS_LO, AXIS_HI, AXIS_POINTS)
    values = axis[list(SCAN_INDICES)]
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        fit_ini = make_synthetic_dataset(Path(work) / 'fit', cross=True,
                                         size='full', sample=SAMPLE)
        vega = VegaInterface(fit_ini)
        t0 = time.perf_counter()
        rows = batched_chi2_scan(vega, {'ap': values, 'at': values})
        seconds['scan'] = time.perf_counter() - t0
        for row in rows:
            hess = vega.chi2_hessian({n: row[n] for n in NAMES},
                                     list(NUISANCE))
            h = np.array([[hess[a][b] for b in NUISANCE] for a in NUISANCE])
            row['errors'] = dict(zip(NUISANCE, np.sqrt(np.diag(
                2.0 * np.linalg.inv(h))).tolist()))
        seconds['scan_with_errors'] = time.perf_counter() - t0

        mc_ini = make_synthetic_dataset(Path(work) / 'mc', cross=True,
                                        size='full', sample=SAMPLE,
                                        extra_control=MC_CONTROL)
        mc_vega = VegaInterface(mc_ini)
        fiducial = mc_vega.compute_model(mc_vega.mc_config['params'],
                                         run_init=False)
        engine = MonteCarloEngine(mc_vega)
        mc = {}
        for kind, names in (('dense', NAMES), ('collapse', NUISANCE)):
            mocks = numpy_mocks(mc_vega, fiducial, N_MOCKS, SEEDS[kind])
            t0 = time.perf_counter()
            fits = engine.fit_mocks(mocks, sample_subset(
                mc_vega.mc_config['sample'], names))
            seconds[f'mc_{kind}'] = time.perf_counter() - t0
            mc[kind] = {'seed': SEEDS[kind], 'n_mocks': N_MOCKS,
                        'names': list(fits['names']),
                        **{key: np.asarray(fits[key]).tolist()
                           for key in ('values', 'errors', 'chisq',
                                       'valid')}}
    seconds['tool'] = time.perf_counter() - t_start
    OUT.write_text(json.dumps({
        'config': "make_synthetic_dataset(workdir, cross=True, "
                  "size='full', sample=SAMPLE), and for the MC phase "
                  "extra_control=MC_CONTROL",
        'sample': SAMPLE, 'mc_control': MC_CONTROL,
        'path': 'vega_tpu batched_chi2_scan / MonteCarloEngine.fit_mocks, '
                'CPU, f64, VEGA_TPU_DS_MATMUL=0',
        'made_by': 'tests/tools/make_torch_port_mc_goldens.py',
        'scan': {'axis': [AXIS_LO, AXIS_HI, AXIS_POINTS],
                 'indices': list(SCAN_INDICES),
                 'free': list(NUISANCE), 'rows': rows},
        'mc': mc,
        'seconds_on_the_cpu': seconds,
    }, indent=1) + '\n')
    print(f'wrote {OUT} in {seconds["tool"]:.1f} s: {seconds}')


if __name__ == '__main__':
    main()
